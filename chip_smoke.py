"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. the card (``nvidia-smi`` name and power limit, torch and CUDA
   versions), then the build of the kernels from
   ``autodist_tpu_torch/kernels/csrc`` (flash attention, the fused
   conv + BatchNorm and the LM head's cross-entropy pair), one ``nvcc``
   each, all at once, for ``sm_90a``,
   with each kernel's registers and spills (``ptxas``) and the dynamic
   shared memory of the warp-specialised ones;
2. each flash kernel (fwd, dQ, dK/dV) held against its plain PyTorch
   version on the card, causal and not, f32 (TF32 off) and bf16, at
   gpt_small's attention shape (B4 H12 S4096 D64, causal) and
   bert_large's (B8 H16 S512 D64, full), with times: the kernel, its
   plain version, PyTorch's fused attention as a yardstick (never used by
   the port) and the least time the card could take (the bound), with
   TFLOP/s and the bound's share of the time; a second launch of each
   kernel must give the same bits; dQ and dK/dV are also timed together
   against the fused attention's backward, which computes both; the
   same at gpt_small(n_heads=3)'s [4, 3, 4096, 256] and at
   gpt_small(n_heads=2)'s [4, 2, 4096, 384] (bf16, causal, timed), the
   shapes the head-dim-256 and -384 steps of phase 5 give the kernels;
2b. ``flash_head_dims``: K1-K3 through the wrapper at [2, 8, 1024, D]
   for head dims 80 and 96 (zero-padded to 128), 160 (to 256), 256 and
   384 (as they are), bf16 and f32, causal and not: forward and the
   three gradients against the plain versions at the true D, one launch
   of each kernel, the CUDA kernel the dispatch named, and each kernel's
   time beside the same B·H·S at D = 64;
2c. ``dkv_head_dims``: bf16 dK/dV at [2, 4, 1000, D] for D = 256, 320
   and 384 (the wgmma kernels with 64-row kv tiles; 320 leaves a last
   chunk of one 64-column slab), causal and full, against the plain
   version, with a bitwise repeat;
2d. ``ulysses_kernels``: K1-K3 at [4, 3, 4096, 64] bf16 causal, the
   shape gpt_small (seq 4096, batch 4) at sp 4 gives each rank after
   Ulysses' all-to-all, held against their plain versions and timed
   beside ``scaled_dot_product_attention`` and the bound, then
   ``ulysses_attention`` on one rank at that shape, forward and
   backward, one launch of each; ``ring_blocks``: each of 4 ranks'
   block-and-merge (``ring_attention.merge_blocks``) over the 4 blocks
   of gpt_small's [4, 12, 4096, 64] bf16 in its visit order, against
   ``local_flash_attention`` over the whole sequence, with one hop's
   compute time;
2e. ``grid_trainers``, with two or more cards (else a line saying it
   did not run on one card): min(4, cards) NCCL processes, one a card
   (``chip_smoke.py --grid-worker``), train gpt_small at seq 4096,
   batch 4, bf16, remat at sp = N under ring and under Ulysses, and at
   seq 1024, batch 4 a card, dp = N under zero 1, 2, 3 and
   PartitionedPS, 3 adamw steps each: losses within 1e-2 relative of
   the same steps on one card, tokens/s, memory a card after a step
   against the predicted state bytes, and the peak;
2f. ``tp_ep_grid``, with two or more cards (else a line saying it did
   not run on one card): over the same N processes, gpt_small at seq
   4096, batch 4, bf16, remat at tp = N (each rank launches K1-K3 at
   [4, 12 / N, 4096, 64], 24 / 12 / 12 a step) and its MoE arm (8
   experts, top 2) at ep = N; with four cards also the MoE arm at ep 2 x
   tp 2 and gpt_small at seq 1024, batch 4 a data rank, tp 2 x dp 2
   under zero 3; 3 adamw steps each from the one-card init: losses
   within 1e-2 relative of one card, tokens/s, memory a card after a
   step against the predicted state bytes (the model and expert shards
   counted): the bytes the tensors ask for within the step's inputs of
   it and not growing from the first step to the last, the bytes held
   within the inputs and the caching allocator's slack; and the peak.
2g. ``pipeline_kernels``: K1-K3 at [2, 12, 4096, 64] bf16 causal, the
   microbatch shape gpt_small (seq 4096, batch 8, 4 microbatches) gives
   every stage of the pipeline, held against their plain versions and
   timed beside ``scaled_dot_product_attention`` and the bound, then the
   3 layers a stage holds at pp 4 on one microbatch through
   ``pipeline.run_stack`` (remat), forward and backward: 6 / 3 / 3
   launches;
2h. ``pp_grid``, with two or more cards (else a line saying it did not
   run on one card): over the same N processes, gpt_small at seq 4096,
   batch 8, 4 microbatches, bf16, remat, at pp = N under GPipe, 1F1B
   stash and 1F1B remat; with four cards also pp 2 x tp 2 (1F1B auto)
   and the memory pair at seq 1024, batch 32, 16 microbatches, pp 4:
   GPipe and 1F1B remat; 3 adamw steps each from the one-card init:
   losses within 1e-2 relative of one card, every rank's K1-K3 launches
   exactly as its stage's layers, the microbatches and the schedule's
   recomputes ask (``pp_launches``), tokens/s and the peak memory a
   card; 1F1B remat's peak below GPipe's on every card;
3. the fused conv + BatchNorm kernel (K4) held against its plain version
   at each of ResNet-101's main-path shapes (batch 256) in bf16, and in
   f32 at two of them and at a stage-1 shape (802,816 rows), with times:
   the kernel, its plain version, ``torch.matmul`` of the same operands
   ("product only": no prologue, no stats; never used by the port) and
   the bound, with TFLOP/s and the bound's share of the time;
3b. ``xent_check``: the cross-entropy pair (``xent_fwd``, ``xent_bwd``)
   through its custom operators at the LM head shapes the TransformerLM
   phases give it (``XE_SHAPES``: [16384, 32000], [4096, 32000] and
   [4096, 30522] bf16) against the plain f32 versions (nll and lse
   within 1e-5 relative, the gradient within one bf16 ulp), one launch
   each, a bitwise repeat, and times: the operator, the plain version
   and the byte bound. Every TransformerLM phase on the card (4, 5, 5a,
   5b, the options arms, bert_large, the bert example) sets
   ``cross_entropy.LAUNCHES`` to 0 before its steps and must read one
   forward and one backward launch a loss (a chunked loss: a forward
   more a chunk, its recompute) and no plain call;
4. small models through the kernels on the card against the same models
   on the CPU (the plain versions), as the reference on a small input: a
   Transformer at S = 512 (head dim 64, and one layer at head dim 384,
   the column-chunked kernels), the same with MoE blocks
   (``small_moe_reference``: 4 experts, aux weight 1.0) and
   ``ResNet((1, 1))`` with ``AUTODIST_FUSED_CONV=1`` (loss, every
   gradient, every EMA update);
5. gpt_small at full width through ``Trainer`` at bench_longctx's
   configuration (seq 4096, batch 4, bf16, remat), 3 adamw steps; the
   launch counts must read 24 fwd (12 blocks plus 12 remat recomputes),
   12 dQ and 12 dK/dV per step, each by the CUDA kernel the head dim
   routes to; then the same at 3 heads (``gpt_small_head_dim_256``: head
   dim 256, the same attention work) and at 2 heads
   (``gpt_small_head_dim_384``), printed beside it;
5a. ``auto_strategy``, this slice's path: gpt_small at the same
   configuration placed by ``AutoStrategy`` (the default candidates on a
   one-card spec naming the device, the card's memory as the budget)
   through ``trainer_from_strategy``: the ranked table (at least 9
   feasible, in order of predicted step), 3 steps at 24/12/12 launches,
   the memory estimate at most the measured peak
   (``roofline.memory_drift``), the step's MFU in (0, 1] and its regime
   against the ``h100`` peak row (``roofline.cost_of``), and one
   profiled step calibrated at one rank, which must give the analytic
   constants back;
5b. ``gpt_small_moe8``, the MoE path: gpt_small with an MoE MLP in
   every block (8 experts, top 2, capacity factor 2.0: Switch-Base's
   width with GShard's routing) at the same seq, batch and remat, 3 adamw
   steps through ``Trainer``: the first loss's cross-entropy near
   ln(vocab) and aux about one a layer, launches 24/12/12 a step on the
   D-64 kernels, tokens/s and peak memory (``--profile``: device ms in
   the ``autodist.moe/dispatch`` / ``/experts`` / ``/combine`` ranges);
   ``moe_einsums`` times each of its einsums alone at those shapes and
   gives the dense dispatch's share of the step;
5c. ``transformer_options``: gpt_small dense at the same shapes, 2 steps
   from one init in each of remat=True, 'save_attn', 'dots',
   'dots_no_batch', remat=False and loss_chunk=4096 under remat: first
   losses within 1e-3 of the remat arm's, tokens/s and peak memory;
6. bert_large at full width, seq 128, batch 32, 2 steps through
   ``trainer_from_strategy(..., AllReduce())``: the plain-attention arm,
   so every launch count stays 0;
7. ResNet-101 at full width (bf16, batch 256, 224 px, sgd 0.1 momentum
   0.9) through ``trainer_from_strategy(..., AllReduce())``, 3 steps with
   ``AUTODIST_FUSED_CONV=1`` (53 K4 launches per step) and 3 with the
   gate off (none), each from the same init; the first losses of the two
   runs must agree; then the two arms' step times in turns;
8. DenseNet-121 and InceptionV3 (299 px), which launch K4 under the
   gate, and VGG16, one step each at full width, batch 16;
8b. ``batch_norm``: ``kernels/batch_norm.batch_norm_train`` against the
   vision BatchNorm's training formulation at ResNet-101's four BN
   shapes (batch 256, bf16): y and the three gradients within 2e-2 of
   the largest, each side's forward and forward + backward timed;
9. the reference DSL path (``AutoDist.scope()`` ->
   ``create_distributed_session()`` -> ``sess.run``) in a one-process
   NCCL group: the c0 linear regression of
   ``tests/integration/test_linear_regression.py`` under its 13 builder
   entries and ``AutoStrategy`` (b after one step within 1e-5 of 0.01 *
   4.17503, 2e-3 on the bfloat16 wires); NCF at
   ``bench.py:bench_sparse``'s full width (138,493 users, 26,744 items,
   GMF 64, MLP 256-128-64, batch 4096, Adam 1e-3) written in DSL ops, 20
   steps under PSLoadBalancing and 20 under AllReduce: finite losses, the
   first within 0.05 of ln 2, the
   sparse (ids, rows) path engaged on the four tables, step time,
   examples/s and peak memory; and a small NCF on the card against the
   CPU (first 3 losses within 1e-4). The path runs no kernel of its
   own;
10. ``bench.py:bench_sparse``'s models through the functional Trainer
   (no kernel on this path): ``ncf_trainer``, NCF at full width under
   ``trainer_from_strategy(..., optim.adam(1e-3), PSLoadBalancing())``,
   ``fit`` for 20 steps of batch 4096 with prefetch 2, eval and
   checkpoints every 10 steps (finite losses, the first within 0.05 of
   ln 2, step time, examples/s, peak memory), the checkpoint restored
   into a fresh trainer bitwise, ``profile`` leaving the params bitwise,
   and one step at grad_accum=4 against one at 1; ``lm1b_trainer``,
   LSTMLM(100000, 512, 1024, 2) at batch 128 x 32 in f32 under
   PartitionedPS, 5 steps at remat='none' and 5 at remat='full' from
   the same init (losses within 1e-5 relative, the first within 0.5 of
   ln(vocab)); and both at tiny width on the card against the CPU (3
   Adam steps, losses within 1e-4);
10b. this slice's paths. ``serve_gpt_small``: gpt_small at
   bench_longctx's width (seq 4096, bf16) from a seeded init,
   ``model.apply`` exported (``checkpoint/export.py``, tokens [None,
   4096]), reloaded in a fresh process that imports torch, numpy and
   ``autodist_tpu_torch.kernels`` (never jax) and served at batch 4 and
   1: logits within 1e-2 of the eager logits' largest magnitude, K1
   through its custom operator 12 times a request on
   ``fwd_wgmma_kernel<bf16,64>``, ms a request and tokens/s served and
   eager; ``serve_resnet101_fused``: ResNet-101 in eval under
   ``AUTODIST_FUSED_CONV=1`` exported at a static batch of 256 (224 px,
   bf16) and served the same way, K4 through its custom operator as
   often as the eager forward launches it; ``imagenet_records``: two
   batches of ResNet-101 records written with ``write_records``,
   streamed by ``examples_torch/imagenet.py``'s ``record_stream``
   through the native reader into 3 fused steps at bench_resnet101's
   width (finite losses, images/s beside the synthetic arm's, the
   stream's ``next`` timed, the files removed); ``functional_model``:
   ``examples_torch/image_classifier.py``'s CNN through
   ``FunctionalModel`` under the 8 builders, 5 steps each (losses equal
   across builders within 1e-6, the first 3 within 1e-4 of the CPU);
   ``dsl_saved_model``: ``examples_torch/serving.py`` on the card (the
   served predictions within 0.1 of the ground truth);
10c. this slice's path, the loose PS plane: NCF at the same full width
   under ``PS(staleness=2)`` with LazyAdam (whose untouched rows stay
   put, so the tables' pushes are row-sparse), the variables on the
   native coord service built from the checkout. ``loose_single``: one
   worker (``single_process_loose_env``) 6 steps at pipeline depth 1 and
   6 at depth 2 on the f32 wire: depth 2's losses and tables equal
   depth 1's bit for bit, depth 1's losses within 1e-5 of the lock-step
   DSL run's (PSLoadBalancing, the same seeds). ``loose_pair``: two
   worker processes (``chip_smoke.py --loose-worker``) on the card
   sharing the service and two PS endpoints, 20 steps each at depth 2
   on the f32 wire and again on the i8 push wire, each on a new batch
   every step and again on one batch a worker: examples/s, median
   step, bytes pulled a step and pushed a push, the sparse plane's
   counters, overlap, the seconds at the gate, the largest lag, and
   the idle share of two profiled steps, per worker; finite losses, the
   first within 0.05 of ln 2, no lag beyond 2, every table on the PS
   equal to each worker's fresh pull after both pushed their last; on
   one batch the last 5 losses below the first and every table the
   initial values plus both workers' decoded pushes; i8's first push
   3.5-4.1x below f32's at the same bytes a pull; ``loose_elastic``:
   the membership half (a join, an exclusion, a restart, a swap,
   serving readers);
10d. this slice's path, the chief's launch and the cohort telemetry
   plane (``loose_launch``): the same NCF, every process on the card,
   each on one batch of its own. (a) The chief of a spec of two nodes
   launches the other through ``Coordinator`` over ``ssh`` / ``scp``
   exec shims (the shim log shows the strategy's ``scp`` and ``mv -f``
   and the worker's identity); p1's pushes are delayed by twice its
   median step (0.5 s at least) from its 8th, or later, once the chief's
   monitor has refit the link constants and holds no verdict for p1 (the
   CPU twin holds them instead, see ``LAUNCH_HOLD_FROM``); at step 12
   (or once that refit holds and every member published it) the chief
   calls ``scale_up(1)``:
   from p1's first delayed push on the monitor issues a ``slowdown``
   verdict for p1 on ``push``, and none that accuses p0 or p2 (a
   verdict for p1 before it, the host's, recovered before it), the
   re-rank for world 3 prices with measured link constants, the chief's
   Chrome trace has the three workers' rows with the four phase spans,
   the telemetry namespace is empty after close,
   every worker's last 5 losses are below its first; the launch
   seconds, examples/s before, during and after, the detection latency,
   the fitted α and β against the analytic, and the span bytes a step.
   (b) ``python -m autodist_tpu_torch.launch`` over the same two nodes:
   rc 0, both records, the launcher's coord service gone;
10e. ``analysis``: ``python -m autodist_tpu_torch.analysis --all
   --json`` in a process of its own (exit 0, every analyzer clean), then
   every worker's flight events of ``loose_elastic`` (all five runs)
   and ``loose_launch`` replayed through the port's control-plane and
   epoch-swap conformance checkers: every trace conformant, none empty,
   the events a trace replayed printed;
10f. ``examples``: ``examples_torch/bert.py --config bert_large
   --optimizer lamb`` (seq 512, batch 8, bf16, remat: K1-K3 non-causal
   at [8, 16, 512, 64], launches read a step and required of the checked
   kernels), ``lm1b.py`` and ``ncf.py`` at their default widths, a
   warm-up and 3 steps each (finite, falling losses), and
   ``sentiment_classifier.py`` and ``linear_regression.py`` at theirs on
   the card and on the CPU (W and b within 1e-4, the logged losses and
   the embedding's norm within 1e-4 relative);
11. the card's line, the ``kernels`` line (K1-K4 of the main paths:
   K1-K3 at head dim 64, at 256 and at 384, at the Ulysses shape (its
   launches: the one-rank local attention's, or with four cards the
   grid's Ulysses run's), at the pipeline's microbatch shape (the
   stage's launches, or with two or more cards ``pp_grid``'s GPipe
   run's) and at bert_large's non-causal shape (the bert example's
   launches a step), each row with the CUDA kernel that ran and its
   launches in its own phase; the cross-entropy pair at each of
   ``XE_SHAPES`` with the launches of every phase that gives it that
   shape), and last
   ``{"ok": true, "device": {...}}``.

Kernel times are device time (CUDA events around back-to-back launches
through the wrapper, queued while a spin kernel holds the device).

``python3 chip_smoke.py --profile`` adds one profiled step after each
model's timed steps (the DSL's NCF, the Trainer's NCF and both LM1B arms
included): device-busy time, idle share and the top kernels.

Without a card, or without the rest of the repository beside it, it
fails before printing any result.
"""
import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

import autodist_tpu_torch as ad
from autodist_tpu_torch import optim
from autodist_tpu_torch.api import Trainer
from autodist_tpu_torch.checkpoint.saver import CheckpointManager
from autodist_tpu_torch.kernels import build
from autodist_tpu_torch.kernels import conv_bn as cb
from autodist_tpu_torch.kernels import cross_entropy as xe
from autodist_tpu_torch.kernels import flash_attention as fa
from autodist_tpu_torch.kernels.work import attention as attention_work
from autodist_tpu_torch.kernels.work import conv_bn as conv_bn_work
from autodist_tpu_torch.models import core, vision
from autodist_tpu_torch.models.ncf import NCF
from autodist_tpu_torch.models.rnn import LSTMLM
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from autodist_tpu_torch.parallel.axes import ParallelSpec
from autodist_tpu_torch.strategy import (AllReduce, AutoStrategy,
                                         PartitionedPS, PSLoadBalancing,
                                         trainer_from_strategy)

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 on the tensor cores,
# f32 outside them (the kernels' f32 path), and device memory.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# clock cycles of the spin that holds the device while the host queues
# timed runs: about 25 ms at the H100's 1.98 GHz boost clock, longer than
# the host takes to queue 20 wrapper calls
SPIN_CYCLES = 50_000_000
SOURCE = 'autodist_tpu_torch/kernels/csrc/flash_attention.cu'
CB_SOURCE = 'autodist_tpu_torch/kernels/csrc/conv_bn.cu'
XE_SOURCE = 'autodist_tpu_torch/kernels/csrc/cross_entropy.cu'
CB_REPLACES = 'autodist_tpu/kernels/conv_bn.py:70'
# the JAX model's token NLL (logsumexp - gather, fused by XLA), which the
# cross-entropy pair computes on the card
XE_REPLACES = 'autodist_tpu/models/transformer.py:336'
# the LM head's [rows, vocab] bf16 logits as the TransformerLM phases give
# them to the cross-entropy pair: gpt_small's 4 x 4096 tokens at vocab
# 32000 (its arms, auto_strategy, MoE, the options arms), the loss_chunk
# arm's chunks of 4 x 1024, and bert_large's 32 x 128 (and the bert
# example's 8 x 512) at vocab 30522
XE_SHAPES = {'gpt_small': (4 * 4096, 32000),
             'gpt_small_loss_chunk': (4 * 1024, 32000),
             'bert_large': (32 * 128, 30522)}
# the pair against its plain f32 version: nll and lse within 1e-5
# relative (f32 sums of the same exps in another order); the bf16
# gradient within one bf16 spacing of the plain one, rounded once from
# f32 on both sides (an exp's last f32 bit can tip the rounding)
XE_REL, XE_GRAD_ULPS = 1e-5, 1.0
REPLACES = {'fwd': 'autodist_tpu/kernels/flash_attention.py:99',
            'dq': 'autodist_tpu/kernels/flash_attention.py:183',
            'dkv': 'autodist_tpu/kernels/flash_attention.py:224'}
GPT_SHAPE, BERT_SHAPE = (4, 12, 4096, 64), (8, 16, 512, 64)
# gpt_small at 3 heads (head dim 256, the same attention work as
# GPT_SHAPE) and at 2 heads (head dim 384)
GPT_D256_SHAPE, GPT_D384_SHAPE = (4, 3, 4096, 256), (4, 2, 4096, 384)
# max |kernel - plain| <= atol + rtol * |plain|, per output.
# f32 (TF32 off): the same products summed in another order over up to
# 4096 terms. bf16: O may differ by two bf16 ulps (P is rounded at the
# online softmax's running max, the plain version at the row max); dQ,
# dK, dV round the same P and dS and may differ by one ulp of the output;
# LSE is f32 from f32 scores in both.
TOL = {torch.float32: {'o': (1e-4, 1e-4), 'lse': (1e-4, 1e-5),
                       'grad': (1e-4, 1e-4)},
       torch.bfloat16: {'o': (2e-2, 2e-2), 'lse': (1e-4, 1e-5),
                        'grad': (1e-2, 2e-2)}}

# K4 on ResNet-101's main path (batch 256, 224 px, AUTODIST_FUSED_CONV=1):
# (x rows after the stride subsample, Cin, Cout, prologue ReLU, calls
# per forward, the conv's NHWC input and stride). 53 calls per forward,
# as a shape trace of the JAX model gives
# (tests/test_torch_vision.py::test_resnet101_fused_calls_per_forward).
RESNET_BATCH = 256
RESNET_K4 = [(50176, 512, 1024, False, 1, (256, 28, 28, 512), 2),
             (50176, 256, 1024, False, 1, (256, 14, 14, 256), 1),
             (50176, 1024, 256, False, 22, (256, 14, 14, 1024), 1),
             (50176, 256, 1024, True, 22, (256, 14, 14, 256), 1),
             (50176, 1024, 512, False, 1, (256, 14, 14, 1024), 1),
             (12544, 512, 2048, True, 3, (256, 7, 7, 512), 1),
             (12544, 1024, 2048, False, 1, (256, 14, 14, 1024), 2),
             (12544, 2048, 512, False, 2, (256, 7, 7, 2048), 1)]
RESNET_K4_PER_STEP = sum(shape[4] for shape in RESNET_K4)
# f32 (TF32 off) at two main-path shapes and at stage 1's conv-c (x
# 256x56x56x64 -> 256 with bn2's prologue), which the row ceiling keeps
# off the main path
K4_F32 = [RESNET_K4[2], RESNET_K4[5], (802816, 64, 256, True, 0,
                                       (256, 56, 56, 64), 1)]
# |kernel - plain| <= rel * max|plain|, per output. y: f32 sums in
# another order (f32); in bf16 one bf16 ulp of y, rounded from such sums.
# s1, s2: f32 sums of the same f32 products over the rows in another
# order, in both dtypes.
K4_TOL = {torch.float32: {'y': 1e-5, 's': 1e-5},
          torch.bfloat16: {'y': 1e-2, 's': 1e-5}}
# ResNet-101's training FLOP per image (bench.py's figure for the JAX
# model: forward + backward at 224 px)
RESNET_FLOP_PER_IMAGE = 46.8e9
# the first losses of the fused and unfused runs (same weights, same
# batch) in bf16: 100 BatchNorm'd layers rounded to bf16 at other points
# (the fused arm keeps conv outputs raw and folds the normalize into the
# next op) move the loss by well under 1 %
FIRST_LOSS_REL = 1e-2


def emit(**obj):
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError('chip_smoke: ' + what)


def cuda_ms(fn, reps):
    """Mean device ms of ``fn`` over ``reps`` back-to-back runs, after one
    warm-up. A spin kernel holds the device while the host queues the
    runs, so a launch shorter than the wrapper's host work is timed by
    the device's pace, not the host's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(kernel, shape, dtype, causal):
    """(ms, 'bytes' | 'operations'): the least time the card could take
    for this call (``attention_work`` at the card's peaks)."""
    flops, nbytes = attention_work(kernel, shape, dtype, causal)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        'operations' if t_ops >= t_bytes else 'bytes'


def bound_conv_bn(n, c_in, c_out, dtype, prologue, want_stats=True):
    """(ms, 'bytes' | 'operations'): the least time the card could take
    for one K4 call (``conv_bn_work`` at the card's peaks)."""
    flops, nbytes = conv_bn_work(n, c_in, c_out, dtype, prologue, want_stats)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        'operations' if t_ops >= t_bytes else 'bytes'


def rates_conv_bn(n, c_in, c_out, dtype, prologue, ms):
    """Achieved TFLOP/s and the share of the bound reached in ``ms``, for
    one K4 call."""
    flops, _ = conv_bn_work(n, c_in, c_out, dtype, prologue)
    return {'tflops': flops / ms / 1e9,
            'bound_share': bound_conv_bn(n, c_in, c_out, dtype,
                                         prologue)[0] / ms}


def _cb_name(kernel, args):
    """K4's kernel name with its template arguments as ptxas mangles them
    (``Li128E`` a tile width, ``13__nv_bfloat16`` or ``f`` the output
    type, ``Lb1E`` the prologue)."""
    if not args:
        return kernel
    parts = re.findall(r'Li(\d+)E', args)
    out = re.sub(r'L[ib]\d+E', '', args)
    parts.append('out ' + ('f32' if out == 'f' else 'bf16'))
    pro = re.search(r'Lb([01])E', args)
    if pro:
        parts.append('prologue' if pro.group(1) == '1' else 'no prologue')
    return '%s<%s>' % (kernel, ','.join(parts))


def ptxas_summary(log):
    """{kernel<dtype, D>: 'R regs, S B spilled'} from nvcc's -Xptxas -v
    report (flash attention's kernels, K4's and the cross-entropy
    pair's)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '\w*?\d+((?:fwd|dq|dkv)"
                      r"(?:_(?:wg)?mma|_cols|_wgmma_cols)?_kernel)"
                      r"I(f|13__nv_bfloat16)?Li(\d+)E", line)
        c = re.search(r"entry function '\w*?\d+(cb_\w+?_kernel)"
                      r"(?:I((?:Li\d+E|Lb[01]E|13__nv_bfloat16|f)+)E)?",
                      line)
        x = re.search(r"entry function '\w*?\d+(xent_(?:fwd|bwd)_kernel)"
                      r"I(f|13__nv_bfloat16)E", line)
        if x:
            name = '%s<%s>' % (x.group(1), 'f32' if x.group(2) == 'f'
                               else 'bf16')
            spill = 0
        elif m:
            name = '%s<%s,%s>' % (m.group(1), 'f32' if m.group(2) == 'f'
                                  else 'bf16', m.group(3))
            spill = 0
        elif c:
            name = _cb_name(c.group(1), c.group(2))
            spill = 0
        m = re.search(r'(\d+) bytes spill stores', line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            out[name] = '%s regs, %d B spilled' % (m.group(1), spill)
            name = None
    return out


def wgmma_smem(lib, cblib):
    """{kernel<dtype, width>: dynamic shared-memory bytes} of the
    warp-specialised kernels, named as ``ptxas_summary`` names them: the
    flash kernels at head dims 64, 128 and 256, the chunk kernels (by
    their 256-column chunk, read at head dim 320) and K4 at ResNet-101's
    output widths."""
    smem = {}
    for i, name in enumerate(('fwd', 'dq', 'dkv')):
        for d in (64, 128, 256):
            if lib.fa_wgmma_smem(i, d):
                smem['%s_wgmma_kernel<bf16,%d>' % (name, d)] = \
                    lib.fa_wgmma_smem(i, d)
        if lib.fa_wgmma_smem(i, 320):
            smem['%s_wgmma_cols_kernel<bf16,256>' % name] = \
                lib.fa_wgmma_smem(i, 320)
    smem.update({'cb_wgmma_kernel<%d>' % cblib.cb_block_n(shape[2]):
                 cblib.cb_wgmma_smem(shape[2]) for shape in RESNET_K4})
    return smem


def max_err(got, want, tol):
    """(max abs error, passes atol + rtol * |want|)."""
    diff = (got.float() - want.float()).abs()
    atol, rtol = tol
    return float(diff.max()), \
        bool((diff <= atol + rtol * want.float().abs()).all())


def check_kernels(shape, causal, dtype, timed, smi):
    """Phase 2 for one (shape, mask, dtype): errors, and times if
    ``timed``. Returns {kernel: record}."""
    gen = torch.Generator(device='cuda').manual_seed(1)
    q, k, v, do = (torch.randn(shape, generator=gen, device='cuda',
                               dtype=torch.float32).to(dtype)
                   for _ in range(4))
    scale = shape[-1] ** -0.5
    args = (q, k, v, causal, scale)
    # the forward through its custom operator, as the main paths call it
    o, lse = fa.flash_fwd(*args)
    delta = fa._delta(do, o)
    bwd_args = (q, k, v, do, lse, delta, causal, scale)
    runs = {'fwd': (lambda: fa.flash_fwd(*args),
                    lambda: fa._fwd_plain(*args)),
            'dq': (lambda: fa._dq_cuda(*bwd_args),
                   lambda: fa._dq_plain(*bwd_args)),
            'dkv': (lambda: fa._dkv_cuda(*bwd_args),
                    lambda: fa._dkv_plain(*bwd_args))}
    dq, (dk, dv) = runs['dq'][0](), runs['dkv'][0]()
    o2, lse2 = runs['fwd'][1]()
    dq2, (dk2, dv2) = runs['dq'][1](), runs['dkv'][1]()
    torch.cuda.synchronize()
    tol = TOL[dtype]
    checks = {'fwd': [max_err(o, o2, tol['o']), max_err(lse, lse2,
                                                         tol['lse'])],
              'dq': [max_err(dq, dq2, tol['grad'])],
              'dkv': [max_err(dk, dk2, tol['grad']),
                      max_err(dv, dv2, tol['grad'])]}
    del o2, lse2, dq2, dk2, dv2
    # each CTA owns its output tile (no atomics): a second launch on the
    # same inputs must give the same bits
    first = {'fwd': (o, lse), 'dq': (dq,), 'dkv': (dk, dv)}
    again = {'fwd': runs['fwd'][0](), 'dq': (runs['dq'][0](),),
             'dkv': runs['dkv'][0]()}
    out = {}
    for name, results in checks.items():
        err = max(e for e, _ in results)
        ok = all(p for _, p in results)
        repeat = all(bool(torch.equal(a, b))
                     for a, b in zip(first[name], again[name]))
        rec = {'max_abs_err': err, 'bitwise_repeat': repeat,
               'cuda_kernel': fa.kernel_name(name, dtype, shape[-1])}
        if timed:
            rec.update(_times(name, *runs[name], q, k, v, do, causal,
                              scale))
            if name == 'fwd':   # the launch without the operator around it
                rec['direct_ms'] = cuda_ms(lambda: fa._fwd_cuda(*args), 10)
        rec['bound_ms'], rec['bound_by'] = bound(name, shape, dtype, causal)
        if timed:
            rec.update(rates(name, shape, dtype, causal, rec['ms']))
        emit(phase='kernel_check', kernel=name, shape=list(shape),
             dtype=str(dtype).replace('torch.', ''), causal=causal, ok=ok,
             tol={k: list(v) for k, v in tol.items()}, card=smi, **rec)
        require(ok, '%s kernel disagrees with its plain version at %s %s '
                'causal=%s' % (name, shape, dtype, causal))
        require(repeat, '%s kernel: two launches on the same inputs differ '
                'at %s %s causal=%s' % (name, shape, dtype, causal))
        out[name] = rec
    if timed:
        # dQ and dK/dV together against the one library call that computes
        # all three gradients; 'with_delta_ms' adds the rowsum(dO * O) that
        # the backward computes before them, as that call does inside
        rec = {'ms': cuda_ms(lambda: (runs['dq'][0](), runs['dkv'][0]()), 10),
               'with_delta_ms': cuda_ms(lambda: fa._bwd(
                   q, k, v, o, lse, do, causal, scale), 10),
               'library_ms': out['dkv']['library_ms'],
               'library': out['dkv']['library']}
        rec['bound_ms'], rec['bound_by'] = bound('bwd', shape, dtype, causal)
        rec.update(rates('bwd', shape, dtype, causal, rec['ms']))
        emit(phase='kernel_pair', kernels=['dq', 'dkv'], shape=list(shape),
             dtype=str(dtype).replace('torch.', ''), causal=causal,
             card=smi, **rec)
    return out


def rates(name, shape, dtype, causal, ms):
    """Achieved TFLOP/s and the share of the bound reached in ``ms``."""
    flops, _ = attention_work(name, shape, dtype, causal)
    return {'tflops': flops / ms / 1e9,
            'bound_share': bound(name, shape, dtype, causal)[0] / ms}


def _times(name, kernel, plain, q, k, v, do, causal, scale):
    """Device ms of the kernel (through its wrapper, which allocates the
    outputs), its plain version, and PyTorch's fused attention (forward,
    or its backward, which yields dQ, dK and dV in one call) as a
    yardstick."""
    rec = {'ms': cuda_ms(kernel, 10), 'plain_ms': cuda_ms(plain, 3)}
    if name == 'fwd':
        rec['library_ms'] = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale), 10)
        rec['library'] = 'torch scaled_dot_product_attention'
    else:
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        ref = F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal,
                                             scale=scale)
        rec['library_ms'] = cuda_ms(lambda: torch.autograd.grad(
            ref, (qq, kk, vv), do, retain_graph=True), 10)
        rec['library'] = ('torch scaled_dot_product_attention backward '
                          '(dQ, dK, dV in one call)')
    return rec


def bf16_ulps(got, want):
    """Largest |got - want| in bf16 spacings of the larger magnitude."""
    a, b = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return float(((a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8))
                 .max())


def max_rel(got, want):
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def xent_bytes(kernel, rows, vocab):
    """Bytes a cross-entropy kernel moves at [rows, vocab] bf16 logits:
    the logits read once ('bwd' also writes the gradient once), the int64
    targets and two f32 values a row (nll and lse out; lse and g in)."""
    return (1 if kernel == 'fwd' else 2) * rows * vocab * 2 + \
        rows * (8 + 4 + 4)


def check_cross_entropy(rows, vocab, smi, reps=10):
    """The cross-entropy pair at one head shape ([rows, vocab] bf16
    logits at 4 x N(0, 1), a per-row g with zeros): ``xe.xent_fwd`` and
    ``xe.xent_bwd``, the custom operators the model calls, against the
    plain f32 versions (``XE_REL``, ``XE_GRAD_ULPS``), one launch each
    and no plain call, the same bits from a second launch; then each
    operator's ms and the plain version's against the kernel's byte
    bound. Returns {'fwd' | 'bwd': record}."""
    gen = torch.Generator(device='cuda').manual_seed(11)
    x = (torch.randn((rows, vocab), generator=gen, device='cuda') * 4).to(
        torch.bfloat16)
    t = torch.randint(0, vocab, (rows,), generator=gen, device='cuda')
    g = torch.rand(rows, generator=gen, device='cuda') * (torch.rand(
        rows, generator=gen, device='cuda') > 0.25) / rows
    xe.reset_launches()
    nll, lse = xe.xent_fwd(x, t)
    dx = xe.xent_bwd(x, t, lse, g)
    launches = dict(xe.LAUNCHES)
    want_nll, want_lse = xe._fwd_plain(x, t)
    errors = {'fwd': {'nll_rel': max_rel(nll, want_nll),
                      'lse_rel': max_rel(lse, want_lse)},
              'bwd': {'grad_bf16_ulps': bf16_ulps(
                  dx, xe._bwd_plain(x, t, want_lse, g))}}
    del want_nll, want_lse
    again = xe.xent_fwd(x, t)
    repeat = {'fwd': torch.equal(nll, again[0]) and
              torch.equal(lse, again[1]),
              'bwd': torch.equal(dx, xe.xent_bwd(x, t, lse, g))}
    del again, dx
    runs = {'fwd': (lambda: xe.xent_fwd(x, t), lambda: xe._fwd_plain(x, t)),
            'bwd': (lambda: xe.xent_bwd(x, t, lse, g),
                    lambda: xe._bwd_plain(x, t, lse, g))}
    out = {}
    for name, (kernel, plain) in runs.items():
        ok = launches == {'fwd': 1, 'bwd': 1, 'plain': 0} and all(
            v <= (XE_GRAD_ULPS if k == 'grad_bf16_ulps' else XE_REL)
            for k, v in errors[name].items())
        rec = {'cuda_kernel': 'xent_%s_kernel<bf16>' % name,
               'errors': errors[name], 'bitwise_repeat': repeat[name],
               'ms': cuda_ms(kernel, reps), 'plain_ms': cuda_ms(plain, 3),
               'bound_ms': 1e3 * xent_bytes(name, rows, vocab) / PEAK_BYTES,
               'bound_by': 'bytes'}
        rec['bound_share'] = rec['bound_ms'] / rec['ms']
        emit(phase='xent_check', kernel=name, shape=[rows, vocab],
             dtype='bfloat16', ok=ok, launches=launches,
             tol={'rel': XE_REL, 'grad_bf16_ulps': XE_GRAD_ULPS}, card=smi,
             **rec)
        require(ok, 'cross-entropy %s kernel disagrees with its plain '
                'version at [%d, %d] (%r, launches %r)'
                % (name, rows, vocab, errors[name], launches))
        require(repeat[name], 'cross-entropy %s kernel: two launches on '
                'the same inputs differ at [%d, %d]' % (name, rows, vocab))
        out[name] = rec
    return out


def xent_want(model, batch, seq, steps, device):
    """``xe.LAUNCHES`` after ``steps`` training steps of ``model`` (a
    TransformerLM) at [batch, seq]: a step's loss runs in
    ``model._ce_chunks`` chunks, each once forward and once backward, and
    with more than one chunk each forward again in the backward's
    recompute. On the card the kernels launch; on the CPU the plain
    versions run, counted together."""
    n = model._ce_chunks(seq, batch * seq)
    fwd, bwd = steps * n * (2 if n > 1 else 1), steps * n
    if torch.device(device).type == 'cuda':
        return {'fwd': fwd, 'bwd': bwd, 'plain': 0}
    return {'fwd': 0, 'bwd': 0, 'plain': fwd + bwd}


def check_xent_launches(phase, got, want):
    """``got``, ``xe.LAUNCHES`` of ``phase``'s run (the counts set to 0
    just before it), must be ``want``."""
    require(got == want, '%s: cross-entropy launches %s, expected %s'
            % (phase, got, want))


def xent_rows(recs, by_shape):
    """The cross-entropy pair's rows of the ``kernels`` line: ``recs``
    {shape name: ``check_cross_entropy``'s records at that shape},
    ``by_shape`` {shape name: {phase: its xe.LAUNCHES}}."""
    rows = []
    for shape_name, paths in by_shape.items():
        for name in ('fwd', 'bwd'):
            rec = recs[shape_name][name]
            by_path = {p: n[name] for p, n in paths.items()}
            rows.append(dict(
                {k: rec[k] for k in ('cuda_kernel', 'errors', 'ms',
                                     'plain_ms', 'bound_ms', 'bound_by',
                                     'bound_share')},
                name='cross_entropy_%s_%s' % (name, shape_name),
                route='cuda', source=XE_SOURCE, replaces=XE_REPLACES,
                launches=next(iter(by_path.values())),
                launches_by_path=by_path, shape=list(XE_SHAPES[shape_name]),
                dtype='bfloat16'))
    return rows


def check_conv_bn(shape, dtype, smi):
    """Phase 3 for one K4 shape: the kernel (through its custom operator,
    as the main paths call it) against its plain version on the same
    inputs, then times: the operator, the direct launch, plain, product
    only, and the bound. Returns the record."""
    n, c_in, c_out, relu, calls, x_shape, stride = shape
    gen = torch.Generator(device='cuda').manual_seed(3)
    x = torch.randn((n, c_in), generator=gen, device='cuda').to(dtype)
    w = torch.randn((c_in, c_out), generator=gen, device='cuda') * \
        c_in ** -0.5
    a = b = None
    if relu:
        a = torch.rand(c_in, generator=gen, device='cuda') + 0.5
        b = torch.randn(c_in, generator=gen, device='cuda')
    args = (x, w, a, b, relu, True, dtype)
    y, s = cb.conv_bn_fwd(*args)
    py, ps = cb._fwd_plain(*args)
    torch.cuda.synchronize()
    tol = K4_TOL[dtype]
    errs, ok = [], True
    for got, want, rel in ((y, py, tol['y']), (s[0], ps[0], tol['s']),
                           (s[1], ps[1], tol['s'])):
        diff = float((got.float() - want.float()).abs().max())
        errs.append(diff)
        ok = ok and diff <= rel * float(want.float().abs().max())
    del y, s, py, ps
    wc = w.to(dtype)
    rec = {'max_abs_err': errs[0], 'max_abs_err_s1': errs[1],
           'max_abs_err_s2': errs[2],
           'ms': cuda_ms(lambda: cb.conv_bn_fwd(*args), 10),
           'direct_ms': cuda_ms(lambda: cb._fwd_cuda(*args), 10),
           'plain_ms': cuda_ms(lambda: cb._fwd_plain(*args), 3),
           'product_only_ms': cuda_ms(lambda: torch.matmul(x, wc), 10),
           'library_ms': None}
    rec['bound_ms'], rec['bound_by'] = bound_conv_bn(n, c_in, c_out, dtype,
                                                     relu)
    rec.update(rates_conv_bn(n, c_in, c_out, dtype, relu, rec['ms']))
    if dtype == torch.bfloat16:
        rec['block_n'] = cb.load_library().cb_block_n(c_out)
    emit(phase='conv_bn_check', rows=n, c_in=c_in, c_out=c_out,
         prologue_relu=relu, calls_per_step=calls, x=list(x_shape),
         stride=stride, dtype=str(dtype).replace('torch.', ''), ok=ok,
         tol=tol, card=smi, **rec)
    require(ok, 'conv_bn kernel disagrees with its plain version at %d x %d '
            '-> %d %s' % (n, c_in, c_out, dtype))
    return rec


def make_images(batch, hw, classes, seed=0):
    rng = np.random.RandomState(seed)
    return {'images': rng.randn(batch, hw, hw, 3).astype(np.float32),
            'labels': rng.randint(0, classes, (batch,)).astype(np.int32)}


def small_resnet_reference():
    """K4 on the card against its plain version on the CPU, inside
    ``ResNet((1, 1))`` at 32 px, batch 4, f32, with the gate on: loss,
    every gradient and every EMA update of one training forward."""
    set_fused_gate(True)
    batch = make_images(4, 32, 10, seed=2)
    out = {}
    for device in ('cuda', 'cpu'):
        model = vision.ResNet((1, 1), num_classes=10, device=device, seed=0)
        core.assign_state_paths(model)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        cb.reset_launches()
        with core.model_mode(training=True) as mm:
            loss = model.loss(model.params(), tb)
        loss.backward()
        out[device] = (float(loss.detach()),
                       {n: p.grad.cpu() for n, p in model.named_parameters()},
                       {k: v.cpu() for k, v in mm.updates.items()},
                       cb.LAUNCHES['conv_bn'])
    (l_gpu, g_gpu, u_gpu, launches), (l_cpu, g_cpu, u_cpu, _) = \
        out['cuda'], out['cpu']
    # f32, TF32 off on both sides: sums in other orders; as in the CPU
    # parity tests, a gradient is held to 2e-5 of its own largest entry
    # plus 1e-6 of the model's largest (BatchNorm scales that feed another
    # batch-statistics BatchNorm have gradients that nearly cancel)
    top = max(float(g.abs().max()) for g in g_cpu.values())
    grad_ok = all(float((g_gpu[n] - g).abs().max()) <=
                  2e-5 * float(g.abs().max()) + 1e-6 * top
                  for n, g in g_cpu.items())
    grad_err = max(float((g_gpu[n] - g).abs().max())
                   for n, g in g_cpu.items())
    upd_err = max(float((u_gpu[k] - v).abs().max()) for k, v in u_cpu.items())
    ok = abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu) and grad_ok and \
        upd_err <= 1e-5 and len(u_gpu) == len(u_cpu) and launches == 5
    emit(phase='small_resnet_reference', loss_cuda=l_gpu, loss_cpu=l_cpu,
         max_grad_err=grad_err, max_ema_update_err=upd_err,
         ema_updates=len(u_gpu), launches=launches, ok=ok)
    require(ok, 'the small ResNet on the card disagrees with the CPU '
            'reference')


def set_fused_gate(fused):
    os.environ['AUTODIST_FUSED_CONV'] = '1' if fused else '0'


def resnet101_run(trainer, batch, fused, smi, profiling):
    """3 sgd steps of ResNet-101 from a fresh init (seed 0) with the
    fused gate on or off. Returns (state, first loss, K4 launches,
    images/s)."""
    set_fused_gate(fused)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cb.reset_launches()
    state, losses, seconds = train_steps(trainer, batch, 3)
    launches = cb.LAUNCHES['conv_bn']
    img_s = RESNET_BATCH / float(np.median(seconds[1:]))
    emit(phase='resnet101', fused_conv=fused, batch=RESNET_BATCH, px=224,
         steps=3, losses=losses, step_seconds=seconds, images_per_s=img_s,
         bf16_peak_share=img_s * RESNET_FLOP_PER_IMAGE /
         PEAK_FLOPS[torch.bfloat16],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         k4_launches=launches, k4_launches_per_step=launches / 3,
         strategy_nodes=len(trainer.strategy.node_config), card=smi)
    require(all(math.isfinite(x) for x in losses),
            'ResNet-101 loss not finite')
    want = 3 * RESNET_K4_PER_STEP if fused else 0
    require(launches == want, 'ResNet-101 (fused=%s) launched K4 %d times '
            'in 3 steps, expected %d' % (fused, launches, want))
    if profiling:
        state, top = profile_step('resnet101_%s' % ('fused' if fused else
                                                    'unfused'),
                                  trainer, state, batch, smi)
        layout = [k for k in top if 'nchwToNhwc' in k or
                  'nhwcToNchw' in k]
        require(not layout, 'layout-conversion kernels among the top '
                'kernels: %s' % layout)
    return state, losses[0], launches, img_s


def resnet101_ab(trainer, state, batch, smi, steps=4):
    """Step time of the two arms on one trainer, in turns (unfused,
    fused, fused, unfused; ``steps`` fenced steps each): a host-bound
    step on a shared host varies from call to call, so the arms are
    compared only inside one call and interleaved."""
    step = trainer.compile_step(state, batch)
    local = trainer.shard_batch(batch)
    seconds = {False: [], True: []}
    for fused in (False, True, True, False):
        set_fused_gate(fused)
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = step(state, local)
            float(metrics['loss'])
            seconds[fused].append(time.perf_counter() - t0)
    med = {fused: float(np.median(v)) for fused, v in seconds.items()}
    emit(phase='resnet101_ab', order='unfused fused fused unfused',
         steps_each=steps, unfused_step_seconds=seconds[False],
         fused_step_seconds=seconds[True], unfused_median_s=med[False],
         fused_median_s=med[True],
         unfused_images_per_s=RESNET_BATCH / med[False],
         fused_images_per_s=RESNET_BATCH / med[True],
         fused_over_unfused=med[True] / med[False], card=smi)


def family_step(name, model, hw, launches_expected, smi):
    """One training step of a vision model at full width, batch 16, with
    the fused gate on: K4 must launch iff ``launches_expected`` (the
    gate admits DenseNet's conv1s and transitions and InceptionV3's
    1x1 convs with 128 or 384 outputs; VGG has no BatchNorm)."""
    trainer = trainer_from_strategy(model, optim.sgd(0.1, momentum=0.9),
                                    AllReduce())
    cb.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    _, losses, seconds = train_steps(trainer, make_images(16, hw, 1000), 1)
    launches = cb.LAUNCHES['conv_bn']
    emit(phase='family', model=name, px=hw, batch=16, loss=losses[0],
         step_seconds=seconds[0], k4_launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi)
    require(math.isfinite(losses[0]), '%s loss not finite' % name)
    require((launches > 0) == launches_expected,
            '%s launched K4 %d times' % (name, launches))
    del trainer
    torch.cuda.empty_cache()


# gpt_small's attention at three head dims, and the CUDA kernels each must
# run on: (heads, batch, steps, kernels by wrapper kernel)
GPT_ARMS = {
    'gpt_small': (12, 4, 3, {'fwd': 'fwd_wgmma_kernel',
                             'dq': 'dq_wgmma_kernel',
                             'dkv': 'dkv_wgmma_kernel'}),
    'gpt_small_head_dim_256': (3, 4, 3, {'fwd': 'fwd_wgmma_kernel',
                                         'dq': 'dq_wgmma_kernel',
                                         'dkv': 'dkv_wgmma_kernel'}),
    'gpt_small_head_dim_384': (2, 4, 3, {'fwd': 'fwd_wgmma_cols_kernel',
                                         'dq': 'dq_wgmma_cols_kernel',
                                         'dkv': 'dkv_wgmma_cols_kernel'})}


def gpt_small_phase(name, smi, profiling):
    """gpt_small at full width (dim 768, 12 layers, vocab 32000) at
    bench_longctx's seq 4096, bf16, remat, through ``Trainer``, with the
    heads, batch and steps of ``GPT_ARMS[name]``, on one batch. The
    launches must read 24 fwd (12 blocks plus 12 remat recomputes), 12 dQ
    and 12 dK/dV per step, every one by the CUDA kernel the arm names.
    Returns the phase's record."""
    n_heads, batch, steps, kernels = GPT_ARMS[name]
    cfg = TransformerConfig.gpt_small(n_heads=n_heads, dtype=torch.bfloat16,
                                      remat=True, max_len=4096)
    d = cfg.dim // n_heads
    model = TransformerLM(cfg, seed=0)
    trainer = Trainer(model, optim.adamw(1e-4), spec=ParallelSpec(dp=1))
    data = make_batch(cfg.vocab, batch, 4096)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    xe.reset_launches()
    state, losses, seconds = train_steps(trainer, data, steps)
    launches, by_kernel = dict(fa.LAUNCHES), dict(fa.KERNEL_LAUNCHES)
    xent = dict(xe.LAUNCHES)
    step_s = float(np.median(seconds[1:]))   # the steps after the first
    rec = dict(phase=name, head_dim=d, n_heads=n_heads, seq=4096,
               batch=batch, steps=steps, losses=losses,
               step_seconds=seconds, tokens_per_s=batch * 4096 / step_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, kernel_launches=by_kernel,
               launches_per_step={k: n / steps for k, n in launches.items()},
               xent_launches=xent, card=smi)
    emit(**rec)
    require(all(math.isfinite(x) for x in losses), '%s loss not finite'
            % name)
    check_xent_launches(name, xent, xent_want(model, batch, 4096, steps,
                                              'cuda'))
    require(abs(losses[0] - math.log(cfg.vocab)) < 0.5,
            '%s initial loss %.4f is not near ln(vocab)' % (name, losses[0]))
    per_step = {'fwd': 2 * cfg.n_layers, 'dq': cfg.n_layers,
                'dkv': cfg.n_layers}
    require(launches == {k: steps * n for k, n in per_step.items()},
            '%s launch counts %s, expected %s per step'
            % (name, launches, per_step))
    want = {'%s<bf16,%d>' % (kernels[k], d): steps * n
            for k, n in per_step.items()}
    require(by_kernel == want, '%s ran the CUDA kernels %s, expected %s'
            % (name, by_kernel, want))
    if profiling:
        profile_step(name, trainer, state, data, smi)
    del trainer, state, model
    torch.cuda.empty_cache()
    return rec


def one_card_spec(kind):
    """A one-node spec of this process's card(s), its topology naming the
    device ``kind`` (``torch.cuda.get_device_name()``; 'NVIDIA H100 80GB
    HBM3' resolves to the 'h100' row of the peak and link tables)."""
    from autodist_tpu_torch.resource_spec import ResourceSpec
    return ResourceSpec(resource_info={
        'nodes': [{'address': 'localhost', 'chief': True, 'cpus': [0],
                   'gpus': [0], 'network_bandwidth': 100}],
        'topology': {'device_kind': kind}})


def ranked_rows(builder):
    """The ranked table of an ``AutoStrategy`` build: one row a
    candidate, feasible ones in rank order, then the pruned."""
    rows = [{'rank': c.rank, 'name': c.name, 'feasible': True,
             'predicted_step_s': c.predicted_step_time_s,
             'predicted_peak_bytes': c.predicted_peak_bytes}
            for c in builder.last_ranked]
    return rows + [{'rank': None, 'name': c.name, 'feasible': False,
                    'predicted_step_s': c.predicted_step_time_s,
                    'predicted_peak_bytes': c.predicted_peak_bytes,
                    'error': c.error} for c in builder.last_infeasible]


def auto_strategy_phase(cfg, batch, seq, steps, device, kind, smi=None):
    """``AutoStrategy`` over the default candidates, on a one-card spec
    of ``kind`` with the card's memory as the budget, placing ``cfg``'s
    TransformerLM through ``trainer_from_strategy`` (adamw 1e-4); then
    ``steps`` steps on one batch. Checks: at least 9 feasible candidates,
    sorted by predicted step; finite losses; the flash launches (on the
    card, 2 forward and 1 dQ, 1 dK/dV a layer a step); the memory
    estimate at most the measured peak (it leaves out activations); the
    step's MFU in (0, 1] against the peak table's row for ``kind``
    (``cost_of`` counts one more step); and one profiled step calibrated
    at one rank, which must give the analytic constants back. Returns
    the phase's record."""
    from autodist_tpu_torch.simulator.calibrate import calibrate_from_trace
    from autodist_tpu_torch.simulator.cost_model import CostModelParams
    from autodist_tpu_torch.telemetry import roofline as rl
    spec = one_card_spec(kind)
    cuda = torch.device(device).type == 'cuda'
    budget = torch.cuda.get_device_properties(0).total_memory if cuda \
        else None
    builder = AutoStrategy(memory_budget_bytes=budget)
    model = TransformerLM(cfg, device=device, seed=0)
    trainer = trainer_from_strategy(model, optim.adamw(1e-4), builder,
                                    resource_spec=spec)
    rows = ranked_rows(builder)
    feasible = [r['predicted_step_s'] for r in rows if r['feasible']]
    best = builder.last_ranked[0]
    emit(phase='auto_strategy_ranked', device_kind=kind,
         memory_budget_bytes=budget, picked=best.name, candidates=rows,
         card=smi)
    require(len(feasible) >= 9 and feasible == sorted(feasible),
            'AutoStrategy ranked %d feasible candidates, expected at least '
            '9 in order of predicted step: %s' % (len(feasible), feasible))
    require(trainer.strategy is best.strategy and
            trainer.strategy.cost['rank'] == 0,
            'the trainer is not placed by the ranked pick %s' % best.name)

    data = make_batch(cfg.vocab, batch, seq)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    xe.reset_launches()
    state, losses, seconds = train_steps(trainer, data, steps)
    launches, by_kernel = dict(fa.LAUNCHES), dict(fa.KERNEL_LAUNCHES)
    xent = dict(xe.LAUNCHES)
    measured = rl.memory_of(device)
    memory = rl.memory_drift(measured, best.report.memory)
    require(all(math.isfinite(x) for x in losses),
            'auto_strategy loss not finite: %s' % losses)
    per_step = {'fwd': 2 * cfg.n_layers, 'dq': cfg.n_layers,
                'dkv': cfg.n_layers} if cuda else \
        {'fwd': 0, 'dq': 0, 'dkv': 0}
    require(launches == {k: steps * n for k, n in per_step.items()},
            'auto_strategy launch counts %s, expected %s per step'
            % (launches, per_step))
    check_xent_launches('auto_strategy', xent,
                        xent_want(model, batch, seq, steps, device))
    if cuda:
        require(memory['estimated_total_bytes'] <=
                memory['measured_total_bytes'],
                'memory estimate %d B above the measured peak %d B'
                % (memory['estimated_total_bytes'],
                   memory['measured_total_bytes']))

    step_s = float(np.median(seconds[1:])) if steps > 1 else seconds[0]
    local = trainer.shard_batch(data)
    cost = rl.cost_of(trainer.compile_step(state, local), state, local)
    peak_flops, peak_hbm = spec.topology.peaks()
    roof, share = check_mfu(cost, step_s, peak_flops, peak_hbm, kind)

    params = CostModelParams.from_topology(spec.topology)
    with tempfile.TemporaryDirectory() as tmp:
        trainer.profile(state, data, tmp, steps=1)
        fitted = calibrate_from_trace(params, tmp, 1)
    require(fitted == params and not fitted.calibrated,
            'calibration at one rank changed the analytic constants: %s'
            % fitted)
    rec = dict(phase='auto_strategy', picked=best.name, seq=seq,
               batch=batch, steps=steps, losses=losses,
               step_seconds=seconds, tokens_per_s=batch * seq / step_s,
               launches=launches, kernel_launches=by_kernel,
               xent_launches=xent,
               predicted_step_s=best.predicted_step_time_s,
               predicted_peak_bytes=best.predicted_peak_bytes,
               memory=memory, cost=cost, peaks=[peak_flops, peak_hbm],
               mfu=roof['mfu'], mfu_share=share, hbm_frac=roof['hbm_frac'],
               roofline_regime=roof['roofline_regime'],
               calibrated=fitted.calibrated,
               alpha_beta={'ici': params.link(cross_node=False),
                           'dcn': params.link(cross_node=True)},
               card=smi)
    emit(**rec)
    del trainer, state, model
    return rec


def check_mfu(cost, step_s, peak_flops, peak_hbm, kind):
    """``roofline.classify_regime``'s record for one step of ``cost``
    taking ``step_s``, and the step's unrounded share of the peak
    (flops / peak / seconds), which must lie in (0, 1]. The record keeps
    ``classify_regime``'s ``mfu``, rounded to 6 places: a CPU step of
    seconds against the card's peak rounds to 0 there."""
    from autodist_tpu_torch.telemetry import roofline as rl
    roof = rl.classify_regime(cost['flops'], cost['bytes_accessed'], step_s,
                              peak_flops, peak_hbm)
    share = None
    if cost['flops'] is not None and peak_flops and step_s > 0:
        share = cost['flops'] / peak_flops / step_s
    require(share is not None and 0 < share <= 1,
            'auto_strategy MFU %r against %s is not in (0, 1]'
            % (share, kind))
    return roof, share


# gpt_small at bench_longctx's seq with an MoE MLP in every block, as the
# JAX Block builds it: Switch-Base's width (d 768, d_ff 3072, 12 layers)
# with 8 experts and GShard's top-2 routing at capacity factor 2.0 (the
# JAX defaults), batch 4, 3 steps, remat (the [b, s, e, cap] dispatch
# tensors are 0.54 GB each a block)
MOE_ARM = dict(moe_experts=8, moe_top_k=2, remat=True)
MOE_BATCH, MOE_STEPS = 4, 3
# the aux loss a layer at init: e * sum_e f_e * P_e is 1 at balanced
# routing (P_e = 1/e); a random router sends more first choices to the
# experts it favours on average, which raises it (1.89 a layer at
# gpt_small_moe8's init and batch on one H100 80GB HBM3)
MOE_AUX_PER_LAYER = (0.9, 3.0)
MOE_RANGES = ('autodist.moe/dispatch', 'autodist.moe/experts',
              'autodist.moe/combine')


def moe_phase(cfg, batch, seq, steps, device, smi=None, profiling=False):
    """The MoE TransformerLM through ``Trainer`` (adamw 1e-4), ``steps``
    steps on one batch. Before them, the loss's parts on that batch: the
    cross-entropy within 0.5 of ln(vocab), the aux (summed over the
    layers) within ``MOE_AUX_PER_LAYER`` a layer, and the first step's
    loss their sum, ce + coef * aux, to 1e-3 relative. On the card at S
    >= 512 the launches must read 2 forwards (block and remat), one dQ
    and one dK/dV a layer a step, by the wgmma kernels at the head dim.
    Returns the record."""
    cuda = torch.device(device).type == 'cuda'
    model = TransformerLM(cfg, device=device, seed=0)
    trainer = Trainer(model, optim.adamw(1e-4), spec=ParallelSpec(dp=1))
    data = make_batch(cfg.vocab, batch, seq, seed=8)
    with torch.no_grad():
        nll, aux = model.per_token_loss_with_aux(
            model.params(), trainer.shard_batch(data))
        ce, aux = float(nll.mean()), float(aux)
    del nll
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    xe.reset_launches()
    state, losses, seconds = train_steps(trainer, data, steps)
    launches, by_kernel = dict(fa.LAUNCHES), dict(fa.KERNEL_LAUNCHES)
    xent = dict(xe.LAUNCHES)
    step_s = float(np.median(seconds[1:]))
    d = cfg.dim // cfg.n_heads
    rec = dict(phase='gpt_small_moe8', experts=cfg.moe_experts,
               top_k=cfg.moe_top_k, capacity=model.blocks.mlp.capacity(seq)
               if cfg.scan_layers else None, dim=cfg.dim,
               n_layers=cfg.n_layers, head_dim=d, seq=seq, batch=batch,
               steps=steps, first_ce=ce, first_aux=aux,
               aux_coef=cfg.moe_aux_coef, losses=losses,
               step_seconds=seconds, median_step_s=step_s,
               tokens_per_s=batch * seq / step_s, launches=launches,
               kernel_launches=by_kernel, xent_launches=xent,
               launches_per_step={k: n / steps for k, n in launches.items()})
    if cuda:
        rec['peak_mem_gb'] = torch.cuda.max_memory_allocated() / 1e9
    if smi is not None:
        emit(card=smi, **rec)
    require(all(math.isfinite(x) for x in losses), 'MoE loss not finite')
    check_xent_launches('gpt_small_moe8', xent,
                        xent_want(model, batch, seq, steps, device))
    require(abs(ce - math.log(cfg.vocab)) < 0.5,
            'MoE first cross-entropy %.4f is not near ln(vocab)' % ce)
    lo, hi = MOE_AUX_PER_LAYER
    require(lo * cfg.n_layers <= aux <= hi * cfg.n_layers,
            'MoE aux %.4f at init is not near one a layer' % aux)
    first = ce + cfg.moe_aux_coef * aux
    require(abs(losses[0] - first) <= 1e-3 * abs(first),
            'MoE first loss %.5f is not ce + coef * aux = %.5f'
            % (losses[0], first))
    if cuda and fa.preferred((batch, cfg.n_heads, seq, d)):
        per_step = {'fwd': 2 * cfg.n_layers, 'dq': cfg.n_layers,
                    'dkv': cfg.n_layers}
        require(launches == {k: steps * n for k, n in per_step.items()},
                'MoE launch counts %s, expected %s per step'
                % (launches, per_step))
        want = {fa.kernel_name(k, cfg.dtype, d): steps * n
                for k, n in per_step.items()}
        require(by_kernel == want, 'MoE ran the CUDA kernels %s, expected '
                '%s' % (by_kernel, want))
    if profiling:
        profile_step('gpt_small_moe8', trainer, state, data, smi,
                     ranges=MOE_RANGES)
    del trainer, state, model
    if cuda:
        torch.cuda.empty_cache()
    return rec


def moe_einsum_ms(cfg, batch, seq, step_s, smi):
    """Device ms of each of the MoE block's einsums at the main path's
    shapes in bf16 (random operands; the time of a product does not
    depend on its values), forward and forward + backward, and their
    share of a step: each runs forward twice a step (the block and its
    remat recompute) and backward once, in every layer; the two that
    build dispatch and combine run forward twice each. Dispatch =
    building the tensors, dispatching and combining; experts = the two
    expert products."""
    e, k, d = cfg.moe_experts, cfg.moe_top_k, cfg.dim
    hid = cfg.dim * cfg.mlp_ratio
    cap = max(1, int(2.0 * seq * k / e))
    gen = torch.Generator(device='cuda').manual_seed(9)

    def rnd(*shape, grad=True):
        return torch.randn(shape, generator=gen, device='cuda',
                           dtype=torch.bfloat16).requires_grad_(grad)
    cases = {
        'build': ('bske,bskc->bsec', rnd(batch, seq, k, e),
                  rnd(batch, seq, k, cap, grad=False), 'dispatch', 2),
        'dispatch': ('bsec,bsd->becd', rnd(batch, seq, e, cap, grad=False),
                     rnd(batch, seq, d), 'dispatch', 1),
        'expert_up': ('becd,edh->bech', rnd(batch, e, cap, d),
                      rnd(e, d, hid), 'experts', 1),
        'expert_down': ('bech,ehd->becd', rnd(batch, e, cap, hid),
                        rnd(e, hid, d), 'experts', 1),
        'combine': ('bsec,becd->bsd', rnd(batch, seq, e, cap),
                    rnd(batch, e, cap, d), 'dispatch', 1)}
    out, per_step = {}, {'dispatch': 0.0, 'experts': 0.0}
    for name, (eq, a, b, group, builds) in cases.items():
        grad = torch.ones_like(torch.einsum(eq, a, b))
        fwd = cuda_ms(lambda: torch.einsum(eq, a, b), 3)
        both = cuda_ms(lambda: torch.einsum(eq, a, b).backward(grad), 3)
        ins = eq.split('->')[0].split(',')
        sizes = dict(zip(ins[0], a.shape))
        sizes.update(zip(ins[1], b.shape))
        flop = 2 * math.prod(sizes.values())
        ms_step = cfg.n_layers * (fwd * builds + both)
        per_step[group] += ms_step
        out[name] = {'equation': eq, 'fwd_ms': fwd, 'fwd_bwd_ms': both,
                     'fwd_tflops': flop / fwd / 1e9, 'ms_per_step': ms_step}
        del a, b, grad
        torch.cuda.empty_cache()
    rec = dict(phase='moe_einsums', capacity=cap, einsums=out,
               ms_per_step=per_step, step_ms=step_s * 1e3,
               share_of_step={g: ms / (step_s * 1e3)
                              for g, ms in per_step.items()}, card=smi)
    emit(**rec)
    return rec


def option_arms(loss_chunk):
    """The ``transformer_options`` arms: each remat policy, no remat, and
    chunked cross-entropy under remat (``loss_chunk`` rows a chunk)."""
    return {'remat': dict(remat=True), 'save_attn': dict(remat='save_attn'),
            'dots': dict(remat='dots'),
            'dots_no_batch': dict(remat='dots_no_batch'),
            'no_remat': dict(remat=False),
            'loss_chunk': dict(remat=True, loss_chunk=loss_chunk)}


# first losses of the option arms against the remat arm's (one init, one
# batch): the same forward in all but the chunked arm, whose head runs on
# row slices (other GEMM tilings, bf16)
OPTIONS_FIRST_LOSS_REL = 1e-3


def transformer_options_phase(cfg, batch, seq, device, loss_chunk, steps=2,
                              smi=None):
    """``cfg`` (dense) through ``Trainer`` (adamw 1e-4) in each arm of
    :func:`option_arms`, ``steps`` steps each from one init on one batch:
    losses, step time, tokens/s and (on the card) peak memory and flash
    launches. Each arm's first loss within ``OPTIONS_FIRST_LOSS_REL`` of
    the remat arm's. Returns {arm: record}."""
    cuda = torch.device(device).type == 'cuda'
    data = make_batch(cfg.vocab, batch, seq, seed=10)
    arms = {}
    for name, kw in option_arms(loss_chunk).items():
        arm_cfg = dataclasses.replace(cfg, **kw)
        model = TransformerLM(arm_cfg, device=device, seed=0)
        trainer = Trainer(model, optim.adamw(1e-4), spec=ParallelSpec(dp=1))
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        xe.reset_launches()
        state, losses, seconds = train_steps(trainer, data, steps)
        step_s = float(np.median(seconds[1:]))
        rec = {'losses': losses, 'step_seconds': seconds,
               'tokens_per_s': batch * seq / step_s,
               'launches': dict(fa.LAUNCHES),
               'xent_launches': dict(xe.LAUNCHES), **{
                   k: v for k, v in kw.items()}}
        if cuda:
            rec['peak_mem_gb'] = torch.cuda.max_memory_allocated() / 1e9
        want = xent_want(model, batch, seq, steps, device)
        del trainer, state, model
        require(all(math.isfinite(x) for x in losses),
                'options arm %s loss not finite' % name)
        check_xent_launches('options arm ' + name, rec['xent_launches'],
                            want)
        arms[name] = rec
    ref = arms['remat']['losses'][0]
    for name, rec in arms.items():
        rec['first_loss_rel'] = abs(rec['losses'][0] - ref) / abs(ref)
    if smi is not None:
        emit(phase='transformer_options', dim=cfg.dim, n_layers=cfg.n_layers,
             seq=seq, batch=batch, steps=steps, arms=arms, card=smi)
    for name, rec in arms.items():
        require(rec['first_loss_rel'] <= OPTIONS_FIRST_LOSS_REL,
                'options arm %s first loss %.6f against remat %.6f'
                % (name, rec['losses'][0], ref))
    return arms


# ResNet-101's BatchNorm activations at batch 256 (one per stage, the
# widest: the 1x1 expansions' outputs)
BN_SHAPES = [(256, 56, 56, 256), (256, 28, 28, 512), (256, 14, 14, 1024),
             (256, 7, 7, 2048)]
# |got - want| <= 2e-2 * max|want| for y, dx, d_gamma, d_beta in bf16: a
# bf16 ulp of each (vision.BatchNorm's autograd takes d_gamma and d_beta
# as bf16 sums, batch_norm_train as f32 sums of the same products)
BN_TOL = 2e-2


def batch_norm_phase(shapes, dtype, device, smi=None, reps=5):
    """``kernels/batch_norm.batch_norm_train`` against ``vision.BatchNorm``
    in training mode (moments through autograd) on the same input, scale
    and bias: y, dx, d_gamma and d_beta within ``BN_TOL``; on the card
    each side's forward and forward + backward timed (device ms). No
    default changes from it. Returns [record]."""
    from autodist_tpu_torch.kernels.batch_norm import batch_norm_train
    cuda = torch.device(device).type == 'cuda'
    out = []
    for shape in shapes:
        c = shape[-1]
        gen = torch.Generator(device=device).manual_seed(c)
        x = torch.randn(shape, generator=gen, device=device).to(dtype)
        ct = torch.randn(shape, generator=gen, device=device).to(dtype)
        bn = vision.BatchNorm(c, dtype=dtype, device=device)
        with torch.no_grad():
            bn.scale.copy_(torch.rand(c, generator=gen, device=device) + 0.5)
            bn.bias.copy_(torch.randn(c, generator=gen, device=device))
        scale = bn.scale.detach().clone().requires_grad_(True)
        bias = bn.bias.detach().clone().requires_grad_(True)
        xa = x.clone().requires_grad_(True)
        xb = x.clone().requires_grad_(True)

        def plain_fwd():
            return bn(xa)

        def fused_fwd():
            return batch_norm_train(xb, scale, bias, bn.eps)[0]
        y_plain, y = plain_fwd(), fused_fwd()
        y_plain.backward(ct)
        y.backward(ct)

        def err(got, want):
            got, want = got.detach().float(), want.detach().float()
            return float((got - want).abs().max()) / float(want.abs().max())
        errs = {'y': err(y, y_plain), 'dx': err(xb.grad, xa.grad),
                'd_gamma': err(scale.grad, bn.scale.grad),
                'd_beta': err(bias.grad, bn.bias.grad)}
        rec = {'shape': list(shape), 'dtype': str(dtype).replace('torch.',
                                                                 ''),
               'rel_err': errs, 'tol': BN_TOL}
        del y, y_plain
        if cuda:
            rec.update(
                batch_norm_train_fwd_ms=cuda_ms(fused_fwd, reps),
                vision_bn_fwd_ms=cuda_ms(plain_fwd, reps),
                batch_norm_train_fwd_bwd_ms=cuda_ms(
                    lambda: fused_fwd().backward(ct), reps),
                vision_bn_fwd_bwd_ms=cuda_ms(
                    lambda: plain_fwd().backward(ct), reps))
            rec['fwd_bwd_ratio'] = rec['batch_norm_train_fwd_bwd_ms'] / \
                rec['vision_bn_fwd_bwd_ms']
        if smi is not None:
            emit(phase='batch_norm', card=smi, **rec)
        require(all(v <= BN_TOL for v in errs.values()),
                'batch_norm_train disagrees with vision.BatchNorm at %s: %s'
                % (shape, errs))
        out.append(rec)
        del x, ct, xa, xb, bn
        if cuda:
            torch.cuda.empty_cache()
    return out


def flash_row(name, rec, launches, shape, suffix=''):
    """A flash kernel's entry of the ``kernels`` line: ``rec`` from
    ``check_kernels`` at ``shape`` (bf16, causal, timed), ``launches``
    from the main-path phase that gives the kernels that shape."""
    return {'name': 'flash_attention_' + name + suffix, 'route': 'cuda',
            'source': SOURCE, 'replaces': REPLACES[name],
            'launches': launches, 'max_abs_err': rec['max_abs_err'],
            'ms': rec['ms'], 'plain_ms': rec['plain_ms'],
            'bound_ms': rec['bound_ms'], 'bound_by': rec['bound_by'],
            'library_ms': rec['library_ms'], 'library': rec['library'],
            'tflops': rec['tflops'], 'bound_share': rec['bound_share'],
            'cuda_kernel': rec['cuda_kernel'], 'shape': list(shape),
            'dtype': 'bfloat16', 'causal': True}


def make_batch(vocab, batch, seq, seed=0):
    rng = np.random.RandomState(seed)
    return {'tokens': rng.randint(0, vocab, (batch, seq), dtype=np.int32),
            'targets': rng.randint(0, vocab, (batch, seq), dtype=np.int32)}


def train_steps(trainer, batch, steps, after_step=None):
    """Run ``steps`` steps on ``batch``; returns (state, losses, step
    seconds each), each step fenced by a device sync. ``after_step()``,
    when given, runs after each step, outside its time."""
    state = trainer.init(seed=0)
    step = trainer.compile_step(state, batch)
    local = trainer.shard_batch(batch)
    losses, seconds = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, local)
        losses.append(float(metrics['loss']))   # host read fences the step
        seconds.append(time.perf_counter() - t0)
        if after_step is not None:
            after_step()
    return state, losses, seconds


# device time by class of kernel, first match wins (cuDNN spreads the
# convolutions over many kernel names, so no single one reaches the top)
KERNEL_CLASSES = (
    ('k4_conv_bn', ('::cb_',)),
    ('flash_attention', ('::fwd_', '::dq_', '::dkv_')),
    ('cudnn_conv', ('fprop', 'dgrad', 'wgrad', 'conv', 'cudnn',
                    'implicit')),
    ('gemm', ('gemm', 'nvjet', 'cutlass')),
    ('optimizer_foreach', ('multi_tensor_apply',)),
    ('reductions', ('reduce_kernel',)),
    ('copies_and_casts', ('copy',)),
    ('elementwise', ('elementwise',)))


def kernel_class(name):
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return 'other'


def _profiled(fn, ranges=None):
    """Run ``fn`` once under torch.profiler: (host seconds, device ms by
    kernel name). With a dict ``ranges`` of ``record_function`` names,
    fill it with the device ms of the kernels launched inside each named
    range (the host-side ranges: a range's backward, which autograd runs
    outside it, is not included)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, 'is_user_annotation', False):
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
        elif ranges is not None and e.name in ranges and \
                e.device_type == torch.autograd.DeviceType.CPU:
            ranges[e.name] += (e.device_time_total
                               if hasattr(e, 'device_time_total')
                               else e.cuda_time_total) / 1e3
    return out, wall, by_name


def emit_profile(name, wall, by_name, smi, ranges=None):
    """The profile line: host seconds, device-busy seconds (kernel time
    summed), idle share and the kernels that take the most device time
    (and the device ms inside each named range, when given). The
    profiler's own cost inflates the host time, so the idle share is an
    upper bound. Returns the top kernels' names."""
    busy = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    by_class = {}
    for n, ms in by_name.items():
        by_class[kernel_class(n)] = by_class.get(kernel_class(n), 0.0) + ms
    extra = {} if ranges is None else {'device_ms_in_ranges': ranges}
    emit(phase='profile', model=name, host_s=wall, device_busy_s=busy,
         idle_share=1 - busy / wall,
         device_ms_by_class=dict(sorted(by_class.items(),
                                        key=lambda kv: -kv[1])),
         top_kernels_ms=dict(top), card=smi, **extra)
    require(busy > 0, 'the profiler saw no device time')
    return [n for n, _ in top]


def profile_step(name, trainer, state, batch, smi, ranges=()):
    """One more training step under torch.profiler (see
    :func:`emit_profile`), with the device time inside the named
    ``record_function`` ranges. Returns (state, the top kernels'
    names)."""
    step = trainer.compile_step(state, batch)
    local = trainer.shard_batch(batch)

    def run():
        out = step(state, local)
        float(out[1]['loss'])
        return out
    named = {r: 0.0 for r in ranges} if ranges else None
    (state, _), wall, by_name = _profiled(run, named)
    return state, emit_profile(name, wall, by_name, smi, named)


def small_reference(dim=128, n_heads=2, n_layers=2, phase='small_reference',
                    devices=('cuda', 'cpu'), **cfg_kw):
    """The kernels on the card against the plain versions on the CPU, on
    a small model whose attention takes the kernel branch (S = 512):
    loss and every gradient. ``cfg_kw`` adds config options (the MoE
    blocks of ``small_moe_reference``); ``devices`` names the two sides
    (the first must launch the kernels when it is the card)."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, max_len=512, dim=dim,
                                 n_heads=n_heads, n_layers=n_layers,
                                 remat=True, **cfg_kw)
    batch = make_batch(cfg.vocab, 2, 512, seed=2)
    out = []
    for device in devices:
        model = TransformerLM(cfg, device=device, seed=0)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        fa.reset_launches()
        xe.reset_launches()
        loss = model.loss(model.params(), tb)
        loss.backward()
        out.append((float(loss.detach()), {n: p.grad.float().cpu()
                                           for n, p in
                                           model.named_parameters()},
                    dict(fa.LAUNCHES), dict(xe.LAUNCHES),
                    xent_want(model, 2, 512, 1, device)))
    (l_gpu, g_gpu, launches, xent, xent_wanted), (l_cpu, g_cpu, *_) = out
    grad_err = max(float((g_gpu[n] - g_cpu[n]).abs().max()) for n in g_cpu)
    # f32 with TF32 off on both sides: sums in other orders through two
    # blocks; 1e-4 on gradients as in the CPU parity tests
    want = {'fwd': 2 * cfg.n_layers, 'dq': cfg.n_layers, 'dkv': cfg.n_layers}
    if torch.device(devices[0]).type != 'cuda':
        want = {k: 0 for k in want}
    ok = abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu) and grad_err <= 1e-4 and \
        launches == want and xent == xent_wanted
    emit(phase=phase, head_dim=dim // n_heads, loss_cuda=l_gpu,
         loss_cpu=l_cpu, max_grad_err=grad_err, launches=launches,
         xent_launches=xent, ok=ok, devices=list(devices), **cfg_kw)
    require(ok, 'the model on the card disagrees with the CPU reference')
    return {'loss': (l_gpu, l_cpu), 'max_grad_err': grad_err}


def small_moe_reference(devices=('cuda', 'cpu')):
    """``small_reference`` with MoE blocks: ``TransformerConfig.tiny(
    moe_experts=4, moe_aux_coef=1.0, dim=128, n_heads=2, max_len=512)``,
    f32, S = 512 (the kernel branch), loss and every gradient."""
    return small_reference(phase='small_moe_reference', devices=devices,
                           moe_experts=4, moe_aux_coef=1.0)


# -- the reference DSL path --------------------------------------------------
# tests/integration/test_linear_regression.py's c0 program and its 13
# builder entries, and AutoStrategy: np seed 123, lr 0.01, W=5, b=0; after
# ONE SGD step b == 0.01 * 4.17503 (1e-5, 2e-3 on the bf16-wire entries)
EXPECTED_B = 0.01 * 4.17503
C0_STRATEGIES = [
    ('AllReduce', lambda: ad.AllReduce(chunk_size=128)),
    ('AllReduce_chunk1', lambda: ad.AllReduce(chunk_size=1)),
    ('AllReduce_ring', lambda: ad.AllReduce(chunk_size=128,
                                            all_reduce_spec='RING')),
    ('AllReduce_hvd', lambda: ad.AllReduce(
        chunk_size=128, compressor='HorovodCompressor')),
    ('AllReduce_hvd_ef', lambda: ad.AllReduce(
        chunk_size=128, compressor='HorovodCompressorEF')),
    ('PS', lambda: ad.PS()),
    ('PS_proxy', lambda: ad.PS(local_proxy_variable=True)),
    ('PSLoadBalancing', lambda: ad.PSLoadBalancing()),
    ('PartitionedPS', lambda: ad.PartitionedPS()),
    ('UnevenPartitionedPS', lambda: ad.UnevenPartitionedPS()),
    ('PartitionedAR', lambda: ad.PartitionedAR()),
    ('RandomAxisPartitionAR', lambda: ad.RandomAxisPartitionAR(seed=1)),
    ('Parallax', lambda: ad.Parallax()),
    ('AutoStrategy', lambda: AutoStrategy()),
]
# NCF at bench.py:bench_sparse's configuration (autodist_tpu/models/ncf.py
# at ml-20m scale): 138,493 users, 26,744 items, GMF width 64, MLP
# 256 -> 128 -> 64 (each MLP embedding 128 wide), head 128 -> 1, batch
# 4096, Adam(1e-3)
NCF_FULL = {'users': 138493, 'items': 26744, 'mf_dim': 64,
            'mlp': (256, 128, 64), 'batch': 4096}
NCF_SMALL = {'users': 64, 'items': 48, 'mf_dim': 8, 'mlp': (16, 8, 4),
             'batch': 32}
NCF_STEPS = 20


def c0_tol(name):
    return 2e-3 if 'hvd' in name else 1e-5


def local_slice(x, rank, world):
    """This process's contiguous share of a global batch, as the JAX
    package splits a feed over its replicas; the whole batch when it
    does not divide (the JAX package then replicates the feed)."""
    if world == 1 or len(x) % world:
        return x
    n = len(x) // world
    return x[rank * n:(rank + 1) * n]


def fresh_autodist(builder, device, n_gpus=1, **kw):
    """An AutoDist over a one-node spec of ``n_gpus`` devices, this
    process's earlier instance (one per process) released."""
    from autodist_tpu_torch import autodist as ad_mod
    ad_mod._DEFAULT_AUTODIST.clear()
    return ad.AutoDist(resource_info={'nodes': [{
        'address': 'localhost', 'gpus': list(range(n_gpus)), 'chief': True,
        'network_bandwidth': 100}]}, strategy_builder=builder,
        device=device, **kw)


def run_linear_regression(autodist, rank=0, world=1):
    """The c0 program (one SGD step), this process feeding its share of
    the batch. Returns (loss, W, b) after the step."""
    np.random.seed(123)
    inputs = np.random.randn(1000)
    noises = np.random.randn(1000)
    outputs = inputs * 3.0 + 2.0 + noises
    with autodist.scope():
        x = ad.placeholder(shape=[None], dtype=np.float32, name='x')
        y = ad.placeholder(shape=[None], dtype=np.float32, name='y')
        W = ad.Variable(5.0, name='W')
        b = ad.Variable(0.0, name='b')
        loss = ad.ops.reduce_mean(ad.ops.square(W * x + b - y))
        train_op = ad.optimizers.SGD(0.01).minimize(loss, [W, b])
        sess = autodist.create_distributed_session()
        loss_val, _ = sess.run([loss, train_op],
                               {x: local_slice(inputs, rank, world),
                                y: local_slice(outputs, rank, world)})
        W_val, b_val = sess.run([W, b])
    return float(loss_val), float(W_val), float(b_val)


def c0_matrix(device, rank=0, world=1):
    """The c0 program under every builder entry: {name: (loss, W, b)};
    raises when b misses its ground truth."""
    out = {}
    for name, builder in C0_STRATEGIES:
        out[name] = run_linear_regression(
            fresh_autodist(builder(), device, world), rank, world)
        b = out[name][2]
        require(abs(b - EXPECTED_B) <= c0_tol(name),
                'c0 %s: b=%r, expected %r' % (name, b, EXPECTED_B))
    return out


def ncf_init(cfg, seed=0):
    """NCF's variables from numpy at ``models/core.py``'s scales:
    embedding tables normal 0.02, Dense kernels normal / sqrt(fan_in),
    biases zero."""
    rng = np.random.RandomState(seed)
    users, items, mf, mlp = (cfg['users'], cfg['items'], cfg['mf_dim'],
                             cfg['mlp'])
    init = {}
    for name, rows, dim in (('mf_user', users, mf), ('mf_item', items, mf),
                            ('mlp_user', users, mlp[0] // 2),
                            ('mlp_item', items, mlp[0] // 2)):
        init[name] = (rng.standard_normal((rows, dim)) * 0.02).astype(
            np.float32)
    dims = list(mlp) + [None]
    for i in range(1, len(mlp)):
        init['mlp_%d/kernel' % (i - 1)] = (rng.standard_normal(
            (dims[i - 1], dims[i])) / math.sqrt(dims[i - 1])).astype(
                np.float32)
        init['mlp_%d/bias' % (i - 1)] = np.zeros(dims[i], np.float32)
    head_in = mf + mlp[-1]
    init['head/kernel'] = (rng.standard_normal((head_in, 1)) /
                           math.sqrt(head_in)).astype(np.float32)
    init['head/bias'] = np.zeros(1, np.float32)
    return init


def ncf_batch(cfg, seed):
    rng = np.random.RandomState(seed)
    n = cfg['batch']
    return (rng.randint(0, cfg['users'], (n,)).astype(np.int32),
            rng.randint(0, cfg['items'], (n,)).astype(np.int32),
            rng.randint(0, 2, (n,)).astype(np.float32))


def ncf_graph(autodist, init, lr=1e-3, optimizer=None):
    """NCF written in DSL ops (``autodist_tpu/models/ncf.py``'s GMF and
    MLP towers, stable sigmoid BCE) under ``autodist``'s scope, trained
    by ``optimizer(lr)`` (Adam by default; LazyAdam keeps the loose
    plane's table pushes row-sparse). Returns (feeds (users, items,
    labels), loss, train_op)."""
    with autodist.scope():
        users = ad.placeholder(shape=[None], dtype=np.int32, name='users')
        items = ad.placeholder(shape=[None], dtype=np.int32, name='items')
        labels = ad.placeholder(shape=[None], dtype=np.float32,
                                name='labels')
        v = {name: ad.Variable(val, name=name) for name, val in init.items()}
        gmf = ad.ops.embedding_lookup(v['mf_user'], users) * \
            ad.ops.embedding_lookup(v['mf_item'], items)
        y = ad.ops.concat([ad.ops.embedding_lookup(v['mlp_user'], users),
                           ad.ops.embedding_lookup(v['mlp_item'], items)],
                          axis=-1)
        i = 0
        while 'mlp_%d/kernel' % i in v:
            y = ad.ops.relu(ad.ops.matmul(y, v['mlp_%d/kernel' % i]) +
                            v['mlp_%d/bias' % i])
            i += 1
        both = ad.ops.concat([gmf, y], axis=-1)
        logits = ad.ops.reshape(
            ad.ops.matmul(both, v['head/kernel']) + v['head/bias'], (-1,))
        loss = ad.ops.reduce_mean(ad.ops.sigmoid_cross_entropy_with_logits(
            labels=labels, logits=logits))
        train_op = (optimizer or ad.optimizers.Adam)(lr).minimize(loss)
    return (users, items, labels), loss, train_op


def ncf_program(autodist, init, lr=1e-3, optimizer=None):
    """:func:`ncf_graph` and its session: (session, feeds, loss,
    train_op)."""
    feeds, loss, train_op = ncf_graph(autodist, init, lr, optimizer)
    return autodist.create_distributed_session(), feeds, loss, train_op


NCF_TABLES = ('mf_user', 'mf_item', 'mlp_user', 'mlp_item')


def sparse_route_marked(plan):
    """{table: whether its gradient would ship as (ids, rows) at more
    than one replica}: the table is read only through recorded lookups.
    At one replica every collective is the identity and
    ``sync_gradients`` returns the gradients as they are, as the JAX
    package does, so the route itself runs only at dp > 1."""
    return {t: bool(plan.var_plans[t].var.sparse_read and
                    plan._purely_sparse(plan.var_plans[t].var))
            for t in NCF_TABLES}


def ncf_train(builder, device, cfg, steps, seed=0, rank=0, world=1,
              optimizer=None):
    """``steps`` NCF steps through the DSL: (losses, step seconds, the
    execution plan, ``step(batch_seed)`` running one more). Each step's
    batch is this process's share of batch ``seed + 1 + step``; the loss
    is fetched (a host read) every step."""
    autodist = fresh_autodist(builder, device, world)
    sess, feeds, loss, train_op = ncf_program(autodist, ncf_init(cfg, seed),
                                              optimizer=optimizer)

    def step(batch_seed):
        batch = [local_slice(x, rank, world)
                 for x in ncf_batch(cfg, batch_seed)]
        return float(sess.run([loss, train_op], dict(zip(feeds, batch)))[0])

    losses, seconds = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(step(seed + 1 + i))
        seconds.append(time.perf_counter() - t0)
    return losses, seconds, autodist._transformed[2], step


def dsl_phase(smi, profiling):
    """The reference DSL path on the card, in a one-process NCCL group:
    the c0 matrix, NCF at full width under PSLoadBalancing and
    AllReduce, and a small NCF on the card against the CPU."""
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    dist.init_process_group('nccl', init_method='tcp://127.0.0.1:%d' % port,
                            world_size=1, rank=0)
    try:
        t0 = time.time()
        c0 = c0_matrix('cuda')
        emit(phase='dsl_c0', seconds=time.time() - t0, expected_b=EXPECTED_B,
             b={name: rec[2] for name, rec in c0.items()},
             max_abs_err={name: abs(rec[2] - EXPECTED_B)
                          for name, rec in c0.items()}, card=smi)
        for name, builder in (('PSLoadBalancing', ad.PSLoadBalancing),
                              ('AllReduce', ad.AllReduce)):
            torch.cuda.reset_peak_memory_stats()
            losses, seconds, plan, step = ncf_train(
                builder(), 'cuda', NCF_FULL, NCF_STEPS)
            step_s = float(np.median(seconds[1:]))
            marked = sparse_route_marked(plan)
            synced = {t: plan.var_plans[t].sparse_synced
                      for t in NCF_TABLES}
            emit(phase='dsl_ncf', strategy=name, steps=NCF_STEPS,
                 batch=NCF_FULL['batch'], losses=losses,
                 step_seconds=seconds, median_step_s=step_s,
                 examples_per_s=NCF_FULL['batch'] / step_s,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 sparse_route_marked=marked, sparse_synced=synced,
                 sparse_route='not taken at one replica: every collective '
                 'is the identity', card=smi)
            require(all(math.isfinite(x) for x in losses),
                    'NCF %s loss not finite' % name)
            require(abs(losses[0] - math.log(2)) < 0.05,
                    'NCF %s first loss %.4f is not near ln 2'
                    % (name, losses[0]))
            require(all(marked.values()),
                    'NCF %s: the tables are not all marked for the '
                    '(ids, rows) route: %s' % (name, marked))
            require(not any(synced.values()),
                    'NCF %s: the (ids, rows) route ran at one replica: %s'
                    % (name, synced))
            if profiling:
                _, wall, by_name = _profiled(lambda: step(NCF_STEPS + 1))
                emit_profile('ncf_dsl_%s' % name, wall, by_name, smi)
            del plan, step
            torch.cuda.empty_cache()
        small = {}
        for device in ('cuda', 'cpu'):
            small[device] = ncf_train(ad.PSLoadBalancing(), device,
                                      NCF_SMALL, 3)[0]
        err = max(abs(a - b) for a, b in zip(small['cuda'], small['cpu']))
        emit(phase='dsl_ncf_small_reference', losses_cuda=small['cuda'],
             losses_cpu=small['cpu'], max_abs_err=err, tol=1e-4)
        require(err <= 1e-4, 'the small NCF on the card disagrees with '
                'the CPU: %r vs %r' % (small['cuda'], small['cpu']))
    finally:
        dist.destroy_process_group()


# -- the loose PS plane ------------------------------------------------------
# NCF at NCF_FULL under PS(staleness=2), each worker its own process with
# its own program, the variables on the coord service's PS; LazyAdam keeps
# the tables' pushes row-sparse (plain Adam moves every row)
LOOSE_STALENESS = 2
LOOSE_SINGLE_STEPS = 6
LOOSE_PAIR_STEPS = 20
# the pair's two kinds of run, each on both wires. 'fresh': worker pid
# takes batch 1000 * (pid + 1) + step, a new batch every step, as training
# does; its times, bytes and the growth of its pushes are the phase's
# readings. 'one_batch': every step on the fresh run's first batch.
# ncf_batch's labels are random, so only a batch seen before can be
# fitted: this run holds the losses to falling. It also adds up what each
# worker pushed and holds the PS's tables to the initial values plus both
# workers' sums.
LOOSE_PAIR_KINDS = ('fresh', 'one_batch')
LOOSE_PROFILED = (16, 17)   # fresh pair steps run under the profiler
LOOSE_REL = 1e-5            # loose depth 1 against the lock-step run
# f32's first push over i8's. The first push carries no error-feedback
# residual, so this is the wire's own compression; a later i8 push also
# carries every row whose residual is not zero, and on new batches these
# rows add up (PERF.md, Open questions)
I8_PUSH_RATIO = (3.5, 4.1)


def start_services(n):
    """``n`` coord services of this run's own on free local ports
    (``loose_harness.start_service``, built from the checkout's
    ``native/coord_service.cc``): [(port, process)]."""
    from autodist_tpu_torch.utils.loose_harness import start_service
    services = []
    try:
        for _ in range(n):
            services.append(start_service())
    except BaseException:
        stop_services(services)
        raise
    return services


def stop_services(services):
    from autodist_tpu_torch.utils.loose_harness import stop_service
    for port, proc in services:
        stop_service(port, proc)


def loose_single_run(cfg, steps, device, port, depth):
    """One loose worker alone (``single_process_loose_env``): ``steps``
    NCF steps on batches ``1..steps`` at pipeline ``depth``, f32 wire.
    Returns (losses, step seconds, {variable: its PS value}, ps_stats)."""
    from autodist_tpu_torch.utils.loose_harness import \
        single_process_loose_env
    with single_process_loose_env(port, depth) as session_sees_one:
        autodist = fresh_autodist(ad.PS(staleness=LOOSE_STALENESS), device)
        feeds, loss, train_op = ncf_graph(autodist, ncf_init(cfg),
                                          optimizer=ad.optimizers.LazyAdam)
        autodist._build()
        session_sees_one()
        sess = autodist.create_distributed_session()
        require(type(sess).__name__ == 'LooseSession',
                'the single worker is not in loose mode')
        losses, seconds = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            losses.append(float(sess.run(
                [loss, train_op], dict(zip(feeds, ncf_batch(cfg, i + 1))))[0]))
            seconds.append(time.perf_counter() - t0)
        tables = {name: sess.get_variable_value(name)
                  for name in sorted(autodist._original_graph_item.graph
                                     .variables)}
        stats = sess.ps_stats
        sess.close()
    return losses, seconds, tables, stats


def loose_single_phase(cfg, steps, device, smi=None):
    """``loose_single``: depth 2's losses and final tables equal depth
    1's bit for bit, and depth 1's losses are the lock-step DSL run's
    (PSLoadBalancing, the same seeds and optimizer) within LOOSE_REL."""
    services = start_services(1)
    try:
        runs = {depth: loose_single_run(cfg, steps, device, services[0][0],
                                        depth) for depth in (1, 2)}
    finally:
        stop_services(services)
    lock, lock_s, _, _ = ncf_train(ad.PSLoadBalancing(), device, cfg, steps,
                                   optimizer=ad.optimizers.LazyAdam)
    (l1, s1, t1, st1), (l2, s2, t2, st2) = runs[1], runs[2]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l1, lock))
    same_tables = all(np.array_equal(t1[n], t2[n]) for n in t1)
    emit(phase='loose_single', steps=steps, batch=cfg['batch'],
         staleness=LOOSE_STALENESS, losses_depth1=l1, losses_depth2=l2,
         losses_lockstep=lock, max_rel_vs_lockstep=rel, tol=LOOSE_REL,
         depth2_bitwise=l1 == l2 and same_tables,
         median_step_s={'depth1': float(np.median(s1[1:])),
                        'depth2': float(np.median(s2[1:])),
                        'lockstep': float(np.median(lock_s[1:]))},
         pipeline={'depth1': st1['pipeline'], 'depth2': st2['pipeline']},
         pull_bytes_per_step=st1['pull_bytes'] / steps,
         push_bytes_per_step=st1['push_bytes'] / steps, card=smi)
    require(l1 == l2, 'loose depth 2 losses differ from depth 1: %r vs %r'
            % (l2, l1))
    require(same_tables, 'loose depth 2 tables differ from depth 1')
    require(rel <= LOOSE_REL, 'loose depth 1 is %.3g from the lock-step '
            'run: %r vs %r' % (rel, l1, lock))
    return runs


def _tap_pushes(sess, shapes=None):
    """Record what this worker pushes. Each push of the session (one at
    a time, on the pipeline thread at depth 2) leaves its wire bytes and
    the rows it pushed row-sparse in ``pushes``. With ``shapes`` ({PS
    key: the variable's shape}), every frame the client sends is decoded
    as the service decodes it (``wire_roundtrip`` / ``rows_roundtrip``)
    and added up per key in ``totals``: [sum (f64), sum of magnitudes
    (f64), adds, the rows touched]. Returns (pushes, totals, [the count
    of optimizer steps sent to the PS, which would move it past what
    the totals hold])."""
    import threading

    from autodist_tpu_torch.runtime import coord_client as cc
    pushes, totals, vsteps, lock = [], {}, [0], threading.Lock()
    push = sess._push_ps_deltas

    def push_logged(*args, **kwargs):
        b0, r0 = sess._ps_push_bytes, sess._sparse_stats['rows_pushed']
        out = push(*args, **kwargs)
        pushes.append({'bytes': sess._ps_push_bytes - b0,
                       'rows': sess._sparse_stats['rows_pushed'] - r0})
        return out

    sess._push_ps_deltas = push_logged
    if shapes is None:
        return pushes, totals, vsteps

    def add(key, idx, values):
        with lock:
            require(key in shapes, 'a push to %s, no variable of the '
                    'program' % key)
            shape = shapes[key]
            if key not in totals:
                totals[key] = [np.zeros(shape, np.float64),
                               np.zeros(shape, np.float64), 0,
                               np.zeros(shape[0], bool)]
            t = totals[key]
            if idx is None:
                values = values.reshape(shape)
                t[0] += values
                t[1] += np.abs(values)
                t[3][:] = True
            else:
                np.add.at(t[0], idx, values)
                np.add.at(t[1], idx, np.abs(values))
                t[3][idx] = True
            t[2] += 1

    vmadd, vmsadd, vstep = (cc.CoordClient.vmadd, cc.CoordClient.vmsadd,
                            cc.CoordClient.vstep)

    def vmadd_tapped(client, items, wire=None):
        for key, delta in items:
            add(key, None, cc.wire_roundtrip(delta, wire))
        return vmadd(client, items, wire=wire)

    def vmsadd_tapped(client, items, wire=None):
        for key, idx, rows in items:
            add(key, np.asarray(idx, np.int64), cc.rows_roundtrip(rows, wire))
        return vmsadd(client, items, wire=wire)

    def vstep_tapped(client, *args, **kwargs):
        vsteps[0] += 1
        return vstep(client, *args, **kwargs)

    cc.CoordClient.vmadd = vmadd_tapped
    cc.CoordClient.vmsadd = vmsadd_tapped
    cc.CoordClient.vstep = vstep_tapped
    return pushes, totals, vsteps


def loose_worker(args):
    """One worker of ``loose_pair`` (``chip_smoke.py --loose-worker
    JSON``), started with the launcher's environment: NCF under
    PS(staleness=2) with LazyAdam, on a new batch every step (``fresh``,
    the steps in LOOSE_PROFILED under the profiler) or on one batch
    (``one_batch``, adding up what it pushes into ``<out>/<pid>.sums.*``);
    then, between the launcher's barriers, a fresh pull of every table
    into ``<out>/<pid>.npz``; its record in ``<out>/<pid>.json``."""
    from autodist_tpu_torch.runtime import coord_client as cc
    pid = int(os.environ['AUTODIST_PROCESS_ID'])
    cfg, device, out = args['cfg'], args['device'], args['out']
    fresh = args['kind'] == 'fresh'
    init = ncf_init(cfg)
    autodist = fresh_autodist(ad.PS(staleness=LOOSE_STALENESS), device)
    sess, feeds, loss, train_op = ncf_program(
        autodist, init, optimizer=ad.optimizers.LazyAdam)
    require(type(sess).__name__ == 'LooseSession',
            'pair worker %d is not in loose mode' % pid)
    names = sorted(autodist._original_graph_item.graph.variables)
    keys = {name: sess._key('var/%s' % name) for name in names}
    pushes, totals, vsteps = _tap_pushes(
        sess, None if fresh else {keys[n]: init[n].shape for n in names})
    cuda = torch.device(device).type == 'cuda'

    def step(i):
        seed = 1000 * (pid + 1) + (i if fresh else 0)
        feed = dict(zip(feeds, ncf_batch(cfg, seed)))
        return float(sess.run([loss, train_op], feed)[0])

    losses, seconds, busy, wall = [], [], 0.0, 0.0
    for i in range(args['steps']):
        if cuda and fresh and i in LOOSE_PROFILED:
            value, w, by_name = _profiled(lambda: step(i))
            busy += sum(by_name.values()) / 1e3
            wall += w
        else:
            t0 = time.perf_counter()
            value = step(i)
            seconds.append(time.perf_counter() - t0)
        losses.append(value)
    # a read lands this worker's last push (depth 2 keeps it in flight),
    # so the stats and the totals hold every push, and the barrier below
    # says every push has landed
    sess.get_variable_value(names[0])
    stats = sess.ps_stats
    sums = {}
    for i, (key, (total, mag, adds, touched)) in enumerate(totals.items()):
        idx = np.flatnonzero(touched)
        sums[key] = [i, adds]
        np.savez(os.path.join(out, '%d.sums.%d.npz' % (pid, i)), idx=idx,
                 total=total[idx], mag=mag[idx])
    with open(os.path.join(out, '%d.meta.json' % pid), 'w') as f:
        json.dump({name: [list(sess._ps_addrs[
            sess._shard_endpoints(name, 1)[0]]), keys[name]]
            for name in names}, f)
    coord = cc.connect_with_retry(autodist._coord.address)
    coord.barrier(args['trained'], args['parties'], timeout_s=300.0)
    np.savez(os.path.join(out, '%d.npz' % pid),
             **{name: sess.get_variable_value(name) for name in names})
    coord.barrier(args['read'], args['parties'], timeout_s=300.0)
    sess.close()
    with open(os.path.join(out, '%d.json' % pid), 'w') as f:
        json.dump({'losses': losses, 'step_seconds': seconds,
                   'ps_stats': stats, 'pushes': pushes, 'sums': sums,
                   'ps_optimizer_steps': vsteps[0],
                   'profiled_busy_s': busy, 'profiled_wall_s': wall}, f)
    return 0


def _composed_share(cfg, out, workers, placement, on_ps):
    """Hold every variable on the PS to its initial value plus what the
    workers pushed (their ``sums``): elementwise within (adds + 1) f32
    roundings of the magnitudes summed, the service adding in its own
    order. Returns the largest error as a share of its bound."""
    init = ncf_init(cfg)
    sums = []
    for pid in range(workers):
        with open(os.path.join(out, '%d.json' % pid)) as f:
            rec = json.load(f)
        require(rec['ps_optimizer_steps'] == 0, 'worker %d stepped an '
                'optimizer on the PS' % pid)
        sums.append(rec['sums'])
    worst = 0.0
    for name, (_, key) in placement.items():
        want = init[name].astype(np.float64)
        mag, adds = np.abs(want), 0
        for pid, worker in enumerate(sums):
            if key not in worker:
                continue
            i, n = worker[key]
            part = np.load(os.path.join(out, '%d.sums.%d.npz' % (pid, i)))
            want[part['idx']] += part['total']
            mag[part['idx']] += part['mag']
            adds += n
        require(adds > 0, 'no worker pushed %s' % name)
        bound = (adds + 1) * 2.0 ** -24 * mag
        share = np.abs(on_ps[name].reshape(want.shape) - want) / \
            np.maximum(bound, 1e-45)
        require(share.max() <= 1.0, '%s on the PS is not its initial '
                'value plus the workers\' pushes: %.3g of the bound off'
                % (name, share.max()))
        worst = max(worst, float(share.max()))
    return worst


def loose_pair_run(cfg, steps, device, services, wire, kind, tmp,
                   workers=2):
    """``workers`` loose workers (``loose_worker``; worker r on card r
    modulo the cards) of ``kind`` sharing the coord service and two PS
    endpoints, at pipeline depth 2 on ``wire``. The launcher reads every
    table straight off the PS between the workers' barriers and holds it
    against each worker's fresh pull and, after a one-batch run, against
    the initial values plus what the workers pushed. Returns (the
    workers' records, that check's largest error as a share of its
    bound, or None)."""
    from autodist_tpu_torch.runtime import coord_client as cc
    run = 'loose-%s-%s-%d' % (kind, wire, os.getpid())
    out = os.path.join(tmp, run)
    os.makedirs(out)
    args = {'cfg': cfg, 'device': device, 'steps': steps, 'out': out,
            'kind': kind, 'trained': 'smoke/%s/trained' % run,
            'read': 'smoke/%s/read' % run, 'parties': workers + 1}
    env = dict(os.environ, AUTODIST_NUM_PROCESSES=str(workers),
               AUTODIST_COORD_SERVICE_ADDR='127.0.0.1:%d' % services[0][0],
               AUTODIST_PS_ENDPOINTS=','.join(
                   '127.0.0.1:%d' % port for port, _ in services[1:]),
               AUTODIST_PS_PIPELINE_DEPTH='2', AUTODIST_PS_WIRE_DTYPE=wire,
               AUTODIST_RUN_ID=run,
               # the workers split the host's cores: torch's threads of
               # several processes on all of them spin against each other
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2) //
                                       workers)))
    logs = [open(os.path.join(out, '%d.log' % pid), 'w')
            for pid in range(workers)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--loose-worker',
         json.dumps(args)], env=dict(env, AUTODIST_PROCESS_ID=str(pid)),
        stdout=logs[pid], stderr=subprocess.STDOUT)
        for pid in range(workers)]
    try:
        coord = cc.connect_with_retry(('127.0.0.1', services[0][0]))
        coord.barrier(args['trained'], workers + 1, timeout_s=600.0)
        with open(os.path.join(out, '0.meta.json')) as f:
            placement = json.load(f)
        on_ps = {}
        for name, (addr, key) in placement.items():
            client = cc.CoordClient(tuple(addr))
            on_ps[name] = client.vget(key)
            client.close()
        coord.barrier(args['read'], workers + 1, timeout_s=600.0)
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    recs = []
    for pid, p in enumerate(procs):
        with open(os.path.join(out, '%d.log' % pid)) as f:
            log = f.read()
        require(p.returncode == 0, 'loose pair worker %d (%s, %s wire) '
                'exited %s:\n%s' % (pid, kind, wire, p.returncode,
                                     log[-3000:]))
        with open(os.path.join(out, '%d.json' % pid)) as f:
            recs.append(json.load(f))
        pulled = np.load(os.path.join(out, '%d.npz' % pid))
        for name, value in on_ps.items():
            require(np.array_equal(pulled[name].reshape(-1), value),
                    'worker %d pulled %s unlike the PS holds it (%s, %s '
                    'wire)' % (pid, name, kind, wire))
    composed = None if kind == 'fresh' else \
        _composed_share(cfg, out, workers, placement, on_ps)
    return recs, composed


def _pair_record(cfg, steps, pid, rec):
    st, pipe = rec['ps_stats'], rec['ps_stats']['pipeline']
    step_s = float(np.median(rec['step_seconds']))
    pulls = pipe['train_steps'] + pipe['discarded_prefetches']
    return {
        'pid': pid, 'losses': rec['losses'],
        'examples_per_s': cfg['batch'] / step_s, 'median_step_s': step_s,
        'pull_bytes_per_step': st['pull_bytes'] / steps,
        'push_bytes_per_step': st['push_bytes'] / steps,
        'pull_bytes_per_pull': st['pull_bytes'] / pulls,
        'push_bytes_by_push': [p['bytes'] for p in rec['pushes']],
        'rows_by_push': [p['rows'] for p in rec['pushes']],
        'bytes_per_endpoint': st['bytes_per_endpoint'],
        'sparse_pushes': st['sparse']['sparse_pushes'],
        'zero_push_skips': st['sparse']['zero_push_skips'],
        'overlap_frac': pipe['overlap_frac'],
        'pull_s': pipe['pull_s'], 'push_s': pipe['push_s'],
        'step_s': pipe['step_s'], 'exposed_wait_s': pipe['exposed_wait_s'],
        'gate_s': pipe['gate_s'], 'max_lag': pipe['max_lag'],
        'discarded_prefetches': pipe['discarded_prefetches'],
        'idle_share': 1 - rec['profiled_busy_s'] / rec['profiled_wall_s']
        if rec['profiled_wall_s'] else None}


def loose_pair_phase(cfg, steps, device, smi=None, wires=('f32', 'i8'),
                     workers=2):
    """``loose_pair``: two workers on one card (or ``workers``, one a
    card where there are as many cards), each ``steps`` steps at depth
    2, of each kind on each wire. Per worker: examples/s, step time,
    bytes a step and a push, the sparse plane's counters, overlap, gate
    wait, the largest lag and the profiled steps' idle share. Every run:
    finite losses, the first near ln 2, no lag beyond the staleness, the
    PS's tables equal to a fresh pull. One batch: the last 5 losses
    below the first, and the PS's tables the initial values plus what
    both workers pushed. Fresh: i8's first push 3.5-4.1x smaller than
    f32's at the same bytes a pull. Returns {kind: {wire: [record]},
    'push_ratio_*': ...}."""
    services = start_services(3)
    runs = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for kind in LOOSE_PAIR_KINDS:
                for wire in wires:
                    runs[kind, wire] = loose_pair_run(
                        cfg, steps, device, services, wire, kind, tmp,
                        workers)
    finally:
        stop_services(services)
    summary = {kind: {} for kind in LOOSE_PAIR_KINDS}
    for (kind, wire), (recs, composed) in runs.items():
        records = summary[kind][wire] = [
            _pair_record(cfg, steps, pid, rec) for pid, rec in enumerate(recs)]
        for r in records:
            pid, losses = r['pid'], r['losses']
            require(all(math.isfinite(x) for x in losses),
                    'loose pair worker %d (%s) loss not finite' % (pid, kind))
            require(abs(losses[0] - math.log(2)) < 0.05,
                    'loose pair worker %d (%s) first loss %.4f is not near '
                    'ln 2' % (pid, kind, losses[0]))
            require(r['max_lag'] <= LOOSE_STALENESS,
                    'loose pair worker %d (%s) ran %d steps ahead of the '
                    'slowest' % (pid, kind, r['max_lag']))
            require(len(r['push_bytes_by_push']) == steps,
                    'loose pair worker %d (%s) pushed %d times in %d steps'
                    % (pid, kind, len(r['push_bytes_by_push']), steps))
            if kind == 'one_batch':
                require(np.mean(losses[-5:]) < losses[0],
                        'loose pair worker %d: the last 5 losses %r on its '
                        'one batch are not below the first %.4f'
                        % (pid, losses[-5:], losses[0]))
        if kind == 'fresh':
            emit(phase='loose_pair', wire=wire, batches='a new batch a step',
                 steps=steps, batch=cfg['batch'], staleness=LOOSE_STALENESS,
                 depth=2, workers=records, tables_equal_fresh_pull=True,
                 card=smi)
        else:
            emit(phase='loose_pair_one_batch', wire=wire,
                 batches='one batch a worker, every step', steps=steps,
                 batch=cfg['batch'], workers=[
                     {k: r[k] for k in ('pid', 'losses', 'max_lag',
                                        'push_bytes_per_step',
                                        'push_bytes_by_push')}
                     for r in records],
                 tables_equal_fresh_pull=True,
                 composed_err_share_of_bound=composed, card=smi)
    if 'f32' in wires and 'i8' in wires:
        f32, i8 = summary['fresh']['f32'], summary['fresh']['i8']
        first = [f['push_bytes_by_push'][0] / q['push_bytes_by_push'][0]
                 for f, q in zip(f32, i8)]
        by_push = [[a / b for a, b in zip(f['push_bytes_by_push'],
                                          q['push_bytes_by_push'])]
                   for f, q in zip(f32, i8)]
        whole = {kind: [sum(f['push_bytes_by_push']) /
                        sum(q['push_bytes_by_push'])
                        for f, q in zip(summary[kind]['f32'],
                                        summary[kind]['i8'])]
                 for kind in LOOSE_PAIR_KINDS}
        emit(phase='loose_pair_wires', push_ratio_first=first,
             bounds=I8_PUSH_RATIO, push_ratio_by_push_fresh=by_push,
             push_ratio_whole_run=whole, card=smi)
        for f, q, ratio in zip(f32, i8, first):
            require(I8_PUSH_RATIO[0] <= ratio <= I8_PUSH_RATIO[1],
                    'the first i8 push is %.3fx below f32\'s, not within %r'
                    % (ratio, I8_PUSH_RATIO))
            require(f['pull_bytes_per_pull'] == q['pull_bytes_per_pull'],
                    'the i8 wire changed the bytes a pull')
        summary['push_ratio_first'] = first
        summary['push_ratio_by_push_fresh'] = by_push
        summary['push_ratio_whole_run'] = whole
    return summary


# -- the loose plane's membership half ------------------------------------------
# NCF at the pair's width under PS(staleness=2) with LazyAdam, a new batch a
# step, f32 wire, depth 2, every worker a process of its own
# (``chip_smoke.py --elastic-worker``) on one card. Five runs:
#   grow     two workers; a third is admitted once both published
#            ELASTIC_JOIN_AT (they wait for it there); with
#            AUTODIST_EXECUTE_REPLAN the chief re-ranks for world 3 and
#            the three apply the staged migration at one armed boundary
#   exclude  three workers; a FaultPlan kills p2 at its publish of
#            ELASTIC_KILL_AT; policy exclude; the survivors finish
#   restart  two workers under WorkerSupervisor; p1 is killed at its
#            publish of ELASTIC_KILL_AT and respawned (no fault plan)
#   swap     two workers; the chief requests a swap to
#            UnevenPartitionedPS(staleness=2) after ELASTIC_SWAP_AT steps
#            (PartitionedPS would split ml-20m's 138493 users, a prime,
#            into 138493 shards), so every table changes geometry
#   serve    two workers train while a ServingFleet of two readers in the
#            launcher answers ELASTIC_SERVE_ROWS-row lookups and forwards
ELASTIC_STEPS = 15
ELASTIC_JOIN_AT = 5
ELASTIC_KILL_AT = 6
ELASTIC_SWAP_AT = 5
ELASTIC_SWAP_TRAIN = 10     # steps the swap run trains past its boundary
ELASTIC_SERVE_ROWS = 4096
ELASTIC_ENV = {'AUTODIST_HEARTBEAT_TIMEOUT': '2',
               'AUTODIST_PS_PIPELINE_DEPTH': '2',
               'AUTODIST_PS_WIRE_DTYPE': 'f32'}
ELASTIC_RUNS = ('grow', 'exclude', 'restart', 'swap', 'serve')


def _elastic_kill_hook():
    """Arm ``AUTODIST_FAULT_PLAN`` (a kill_worker of mode ``raise``) so
    that the process dies hard (``os._exit(137)``, no cleanup, no done
    marker) on whichever thread publishes the planned step, after it
    wrote the kill's wall time beside its record."""
    from autodist_tpu_torch.runtime.coord_client import CoordClient
    from autodist_tpu_torch.utils.faultline import FaultLine, InjectedFault
    fl = FaultLine.from_env(worker='p%s' % os.environ['AUTODIST_PROCESS_ID'])
    if not fl.plan.faults:
        return None
    fl.install()
    hook = CoordClient.fault_hook

    def dying_hook(client, line, payload):
        try:
            return hook(client, line, payload)
        except InjectedFault:
            path = os.environ['CHIP_SMOKE_KILL_FILE']
            with open(path, 'w') as f:
                json.dump({'killed_at': fl.events[-1]['time'],
                           'line': fl.events[-1]['line']}, f)
            os._exit(137)

    CoordClient.fault_hook = dying_hook
    return fl


def swap_strategy(graph_item):
    """UnevenPartitionedPS(staleness=2) over a spec of two PS hosts (a
    one-host spec leaves every variable whole)."""
    from autodist_tpu_torch.resource_spec import ResourceSpec
    spec = ResourceSpec(resource_info={'nodes': [
        {'address': 'localhost', 'gpus': [0], 'chief': True,
         'network_bandwidth': 100},
        {'address': '127.0.0.1', 'gpus': [0], 'network_bandwidth': 100}]})
    return ad.UnevenPartitionedPS(staleness=LOOSE_STALENESS).build(
        graph_item, spec)


def _tap_rekey(sess, rec):
    """Wrap the chief's re-key: right after it stores the old keys'
    values under the new keys, read both key sets back and record
    whether they agree with each other and with what was stored, bit
    for bit (every member's pushes before the boundary landed first,
    and none after it can land before the ready marker)."""
    real = sess._store_var_parts

    def store(values):
        real(values)
        new, _ = sess._fetch_var_parts(list(values))
        same_new = all(np.array_equal(sess._merged(n, new[n]),
                                      np.asarray(v))
                       for n, v in values.items())
        same_old = all(np.array_equal(sess._coord.vget(
            sess._key('var/%s' % n), shape=np.asarray(v).shape),
            np.asarray(v)) for n, v in values.items())
        rec['rekey'] = {'vars': sorted(values), 'bytes': int(sum(
            np.asarray(v).nbytes for v in values.values())),
            'new_keys_equal': same_new, 'old_keys_equal': same_old,
            'shards': {n: len(sess._shard_info(n)[1]) for n in values}}

    sess._store_var_parts = store


def elastic_worker(args):
    """One worker of a ``loose_elastic`` run (``chip_smoke.py
    --elastic-worker JSON``): NCF at ``args['cfg']``, batch
    ``1000 * (pid + 1) + step`` at each step, until its step count
    reaches ``args['steps']``; its record (steps with wall times,
    health, swap events) in ``<out>/<name>.g<generation>.json``."""
    from autodist_tpu_torch.runtime import coord_client as cc
    pid = int(os.environ['AUTODIST_PROCESS_ID'])
    run, cfg, out = args['run'], args['cfg'], args['out']
    joiner = os.environ.get('AUTODIST_ELASTIC_JOIN') == '1'
    _elastic_kill_hook()
    addr = os.environ['AUTODIST_COORD_SERVICE_ADDR'].rsplit(':', 1)
    ctl = cc.connect_with_retry((addr[0], int(addr[1])))
    run_id = os.environ['AUTODIST_RUN_ID']
    if joiner:
        # joins once every cohort member published ELASTIC_JOIN_AT
        ctl.wait_key('strategy/%s/id' % run_id, timeout_s=300.0)
        ns = ctl.get('strategy/%s/id' % run_id)
        deadline = time.time() + 300.0
        while min(ctl.incr('%s/step/p%d' % (ns, i), 0)
                  for i in range(args['cohort'])) < args['join_at']:
            require(time.time() < deadline, 'the cohort never reached '
                    'step %d' % args['join_at'])
            time.sleep(0.05)
    autodist = fresh_autodist(ad.PS(staleness=LOOSE_STALENESS),
                              args['device'])
    sess, feeds, loss, train_op = ncf_program(
        autodist, ncf_init(cfg), optimizer=ad.optimizers.LazyAdam)
    require(type(sess).__name__ == 'LooseSession',
            'elastic worker %d is not in loose mode' % pid)
    name = sess._worker_name
    rec = {'pid': pid, 'worker': name, 'generation': sess._generation,
           'start_step': sess.step_count, 'steps': []}
    if run == 'swap' and sess._is_chief:
        _tap_rekey(sess, rec)
    entry = None

    def migrated():
        return any(e.get('migrated') for e in sess._health['replans'])

    # the grow and swap runs train on until their migration applied (the
    # re-rank and the handshake take their own time, longer on a loaded
    # host, which can arm the boundary past the last step), and the swap
    # run ELASTIC_SWAP_TRAIN steps past it
    applied = None
    while sess.step_count < args['steps'] or (
            run in ('grow', 'swap') and not migrated() and
            sess.step_count < 4 * args['steps']) or (
            run == 'swap' and applied is not None and
            sess.step_count < applied + ELASTIC_SWAP_TRAIN):
        s = sess.step_count + 1
        if run == 'swap' and sess._is_chief and entry is None and \
                s > args['swap_at']:
            entry = sess.request_strategy_swap(swap_strategy(
                autodist._original_graph_item))
        feed = dict(zip(feeds, ncf_batch(cfg, 1000 * (pid + 1) + s)))
        t0 = time.time()
        value = float(sess.run([loss, train_op], feed)[0])
        rec['steps'].append({'step': s, 't0': t0, 't1': time.time(),
                             'loss': value,
                             'parties': sess._active_workers()})
        if applied is None and migrated():
            applied = s
        if run == 'grow' and not joiner and s == args['join_at']:
            deadline = time.time() + 300.0
            while ctl.incr(sess._key('join/world'), 0) <= args['cohort']:
                require(time.time() < deadline, 'no worker joined')
                time.sleep(0.02)
    sess.get_variable_value(sorted(sess._graph_item.graph.variables)[0])
    if entry is not None:
        rec['swap_entry'] = dict(entry)
    rec['health'] = sess.health_stats
    rec['flight'] = [e for e in sess._flight.events()
                     if e['kind'].startswith('swap_')]
    if args.get('barrier'):
        # the launcher reads the plane while it is quiet
        ctl.barrier(args['barrier'] + '/trained', args['parties'],
                    timeout_s=300.0)
        ctl.barrier(args['barrier'] + '/read', args['parties'],
                    timeout_s=300.0)
    sess.close()
    ctl.close()
    # every control-plane event of the run, for the analysis phase's replay
    rec['flight_events'] = sess._flight.events()
    with open(os.path.join(out, '%s.g%d.json' % (name, rec['generation'])),
              'w') as f:
        json.dump(rec, f, default=lambda o: o.item() if hasattr(o, 'item')
                  else repr(o))
    return 0


def _elastic_env(services, run_id, workers, extra=None):
    return dict(os.environ, AUTODIST_NUM_PROCESSES=str(workers),
                AUTODIST_COORD_SERVICE_ADDR='127.0.0.1:%d' % services[0][0],
                AUTODIST_RUN_ID=run_id,
                OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2) // 3)),
                **ELASTIC_ENV, **(extra or {}))


class _ElasticRun:
    """The launcher of one ``loose_elastic`` run: its coord service, the
    worker processes it started (each logging to ``<out>/<tag>.log``),
    and the records they left."""

    def __init__(self, run, cfg, device, tmp, steps, **args):
        self.run = run
        self.run_id = 'elastic-%s-%d' % (run, os.getpid())
        self.out = os.path.join(tmp, self.run_id)
        os.makedirs(self.out)
        self.args = dict(args, run=run, cfg=cfg, device=device,
                         out=self.out, steps=steps)
        self.services = start_services(1)
        self.procs = []
        self.logs = []

    def spawn(self, pid, env, tag=None):
        tag = tag or 'p%d' % pid
        log = open(os.path.join(self.out, '%s.log' % tag), 'a')
        self.logs.append(log)
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--elastic-worker',
             json.dumps(self.args)],
            env=dict(env, AUTODIST_PROCESS_ID=str(pid),
                     CHIP_SMOKE_KILL_FILE=os.path.join(
                         self.out, '%s.kill.json' % tag)),
            stdout=log, stderr=subprocess.STDOUT)
        self.procs.append((tag, proc))
        return proc

    def client(self):
        from autodist_tpu_torch.runtime import coord_client as cc
        return cc.connect_with_retry(('127.0.0.1', self.services[0][0]))

    def ns(self, client, timeout_s=300.0):
        client.wait_key('strategy/%s/id' % self.run_id, timeout_s=timeout_s)
        return client.get('strategy/%s/id' % self.run_id)

    def wait(self, timeout=600):
        for tag, p in self.procs:
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                pass

    def log(self, tag):
        with open(os.path.join(self.out, '%s.log' % tag)) as f:
            return f.read()

    def require_exit(self, tag, proc, code=0):
        require(proc.returncode == code, 'loose_elastic %s: %s exited %s, '
                'not %s:\n%s' % (self.run, tag, proc.returncode, code,
                                 self.log(tag)[-3000:]))

    def record(self, worker, generation=0):
        with open(os.path.join(self.out, '%s.g%d.json'
                               % (worker, generation))) as f:
            rec = json.load(f)
        FLIGHT_TRACES['loose_elastic/%s/%s.g%d' % (
            self.run, worker, generation)] = rec['flight_events']
        return rec

    def kill_time(self, tag):
        with open(os.path.join(self.out, '%s.kill.json' % tag)) as f:
            return json.load(f)['killed_at']

    def close(self):
        for _, p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()
        stop_services(self.services)


def _examples_per_s(cfg, steps):
    walls = [s['t1'] - s['t0'] for s in steps]
    return cfg['batch'] / float(np.median(walls)) if walls else None


def _kill_plan(worker, step):
    from autodist_tpu_torch.utils.faultline import FaultPlan
    return FaultPlan([{'kind': 'kill_worker', 'worker': worker,
                       'step': step, 'mode': 'raise'}], seed=13).to_json()


def elastic_grow(cfg, device, tmp, steps, smi=None, workers=2):
    """``workers`` start, one more joins (see above)."""
    r = _ElasticRun('grow', cfg, device, tmp, steps,
                    join_at=ELASTIC_JOIN_AT, cohort=workers)
    world = workers + 1
    try:
        env = _elastic_env(r.services, r.run_id, workers,
                           {'AUTODIST_EXECUTE_REPLAN': '1',
                            'AUTODIST_PEER_FAILURE_POLICY': 'exclude'})
        for pid in range(workers):
            r.spawn(pid, env)
        r.spawn(workers, dict(env, AUTODIST_ELASTIC_JOIN='1'),
                tag='joiner')
        r.wait()
        for tag, p in r.procs:
            r.require_exit(tag, p)
        recs = [r.record('p%d' % i) for i in range(world)]
    finally:
        r.close()
    joiner = recs[-1]
    require(joiner['health']['joining'] and joiner['start_step'] ==
            joiner['health']['admitted']['adopted_step'] >= ELASTIC_JOIN_AT,
            'the joiner did not start at the published step: %r'
            % joiner['health'].get('admitted'))
    boundaries, applied = set(), set()
    per_worker = []
    for rec in recs:
        h = rec['health']
        require(h['world'] == world and h['active_workers'] == world,
                '%s ended with world %d, %d active' % (
                    rec['worker'], h['world'], h['active_workers']))
        after = [s for s in rec['steps']
                 if s['step'] > joiner['start_step'] + 1]
        require(after and all(s['parties'] == world for s in after),
                '%s gated on fewer than %d parties after the join'
                % (rec['worker'], world))
        migrated = [e for e in h['replans'] if e.get('migrated')]
        require(len(migrated) == 1, '%s applied %d migrations: %r' % (
            rec['worker'], len(migrated), h['replans']))
        boundaries.add(migrated[0]['swap']['boundary'])
        applied.update(e['step'] for e in rec['flight']
                       if e['kind'] == 'swap_apply')
        before = [s for s in rec['steps'] if s['step'] <= ELASTIC_JOIN_AT
                  and s['step'] > rec['start_step'] + 1]
        per_worker.append({
            'worker': rec['worker'], 'start_step': rec['start_step'],
            'examples_per_s_before_join': _examples_per_s(cfg, before),
            'examples_per_s_after_join': _examples_per_s(cfg, after),
            'losses': [s['loss'] for s in rec['steps']]})
    chief = recs[0]['health']['replans']
    require(len(chief) == 1 and chief[0]['world'] == world and
            chief[0].get('predicted') and not chief[0].get('error'),
            'the chief recorded no re-rank for world %d: %r'
            % (world, chief))
    require(len(boundaries) == 1 and applied == boundaries,
            'the members applied at %r, boundaries %r' % (applied,
                                                          boundaries))
    for rec in recs:
        require(all(math.isfinite(s['loss']) for s in rec['steps']),
                '%s: a loss is not finite' % rec['worker'])
    out = dict(phase='loose_elastic', run='grow', steps=steps,
               batch=cfg['batch'], cohort=[workers, world],
               join_at=ELASTIC_JOIN_AT,
               admit_wall_s=joiner['health']['admitted']['admit_wall_s'],
               replan={k: chief[0].get(k) for k in (
                   'world', 'kept', 'predicted', 'predicted_step_time_s',
                   'migration_staged', 'cost_constants')},
               boundary=boundaries.pop(), migration_wall_s=[
                   [e for e in rec['health']['replans']
                    if e.get('migrated')][0]['migration']['wall_s']
                   for rec in recs],
               workers=per_worker)
    emit(card=smi, **out)
    return out


def elastic_exclude(cfg, device, tmp, steps, smi=None, workers=3):
    """``workers`` start, the last is killed (see above)."""
    from autodist_tpu_torch.runtime import coord_client as cc
    r = _ElasticRun('exclude', cfg, device, tmp, steps)
    last = workers - 1
    victim_name = 'p%d' % last
    try:
        env = _elastic_env(r.services, r.run_id, workers,
                           {'AUTODIST_PEER_FAILURE_POLICY': 'exclude'})
        for pid in range(last):
            r.spawn(pid, env)
        victim = r.spawn(last, dict(env, AUTODIST_FAULT_PLAN=_kill_plan(
            victim_name, ELASTIC_KILL_AT)))
        # the victim's writer connection, bound to its generation before
        # the kill: the connection a zombie would keep
        zombie = r.client()
        ns = r.ns(zombie)
        deadline = time.time() + 300.0
        while zombie.incr('%s/step/%s' % (ns, victim_name), 0) == 0:
            require(time.time() < deadline, 'the victim never started')
            time.sleep(0.05)
        zombie.fence('fence/%s/%s' % (ns, victim_name), 0)
        r.wait()
        r.require_exit(victim_name, victim, 137)
        for tag, p in r.procs[:last]:
            r.require_exit(tag, p)
        try:
            zombie.vadd('%s/var/head/bias' % ns, np.ones(1, np.float32))
            fenced = False
        except cc.FencedWriteError:
            fenced = True
        zombie.close()
        killed_at = r.kill_time(victim_name)
        recs = [r.record('p%d' % i) for i in range(last)]
    finally:
        r.close()
    require(fenced, 'a write through %s\'s kept connection was accepted'
            % victim_name)
    survivors = []
    for rec in recs:
        h = rec['health']
        require(len(rec['steps']) == steps and h['active_workers'] == last,
                '%s: %d steps, %d active' % (
                    rec['worker'], len(rec['steps']), h['active_workers']))
        require(h['excluded'] == [victim_name], '%s excluded %r'
                % (rec['worker'], h['excluded']))
        after = [s for s in rec['steps'] if s['t1'] > killed_at]
        require(after, '%s took no step after the kill' % rec['worker'])
        stalled = max(after, key=lambda s: s['t1'] - s['t0'])
        survivors.append({
            'worker': rec['worker'],
            'kill_to_next_step_s': after[0]['t1'] - killed_at,
            # the step the gate held until p2's exclusion
            'kill_to_unblocked_s': stalled['t1'] - killed_at,
            'longest_step_after_kill_s': stalled['t1'] - stalled['t0'],
            'examples_per_s_before_kill': _examples_per_s(cfg, [
                s for s in rec['steps'] if s['t1'] < killed_at][1:]),
            'examples_per_s_after_exclusion': _examples_per_s(
                cfg, after[2:]),
            'epoch': h['epoch']})
    out = dict(phase='loose_elastic', run='exclude', steps=steps,
               batch=cfg['batch'], workers=workers, victim=victim_name,
               kill_at=ELASTIC_KILL_AT,
               heartbeat_timeout_s=float(ELASTIC_ENV[
                   'AUTODIST_HEARTBEAT_TIMEOUT']),
               zombie_write_refused=fenced,
               kill_to_survivors_next_step_s=min(
                   w['kill_to_next_step_s'] for w in survivors),
               kill_to_survivors_unblocked_s=max(
                   w['kill_to_unblocked_s'] for w in survivors),
               survivors=survivors)
    emit(card=smi, **out)
    return out


def elastic_restart(cfg, device, tmp, steps, smi=None):
    from autodist_tpu_torch.runtime.coordinator import WorkerSupervisor
    r = _ElasticRun('restart', cfg, device, tmp, steps)
    sup = None
    try:
        env = _elastic_env(r.services, r.run_id, 2,
                           {'AUTODIST_PEER_FAILURE_POLICY': 'restart'})
        r.spawn(0, env)
        incarnations = []

        def spawn():
            # a CUDA context does not survive fork: a fresh interpreter;
            # the replacement carries no fault plan
            extra = {} if incarnations else {
                'AUTODIST_FAULT_PLAN': _kill_plan('p1', ELASTIC_KILL_AT)}
            incarnations.append(len(incarnations))
            return r.spawn(1, dict(env, **extra),
                           tag='p1.%d' % (len(incarnations) - 1))

        fence_client = r.client()
        gave_up = []

        def fence():
            fence_client.incr('fence/%s/p1' % r.ns(fence_client), 1)

        sup = WorkerSupervisor('p1', spawn, policy='restart',
                               max_restarts=1, fence=fence,
                               on_give_up=gave_up.append).start()
        r.wait()
        sup.join(timeout=300.0)
        fence_client.close()
        require(not gave_up and sup.restarts == 1,
                'the supervisor gave up (%r) after %d restarts'
                % (gave_up, sup.restarts))
        r.require_exit('p1.0', r.procs[1][1], 137)
        r.require_exit('p0', r.procs[0][1])
        r.require_exit('p1.1', r.procs[2][1])
        killed_at = r.kill_time('p1.0')
        chief, reborn = r.record('p0'), r.record('p1', 1)
    finally:
        if sup is not None:
            sup.terminate()
        r.close()
    h = chief['health']
    require(reborn['generation'] == 1 and reborn['health']['rejoining'],
            'the replacement did not rejoin under generation 1')
    require(reborn['start_step'] == ELASTIC_KILL_AT - 1,
            'the replacement resumed at %d, not at the published %d'
            % (reborn['start_step'], ELASTIC_KILL_AT - 1))
    require(len(chief['steps']) == steps and h['rejoins'] == ['p1'] and
            len(h['recovery_wall_s']) == 1,
            'the chief: %d steps, rejoins %r' % (len(chief['steps']),
                                                 h['rejoins']))
    out = dict(phase='loose_elastic', run='restart', steps=steps,
               batch=cfg['batch'], kill_at=ELASTIC_KILL_AT,
               recovery_wall_s=h['recovery_wall_s'][0],
               kill_to_chief_next_step_s=[
                   s['t1'] for s in chief['steps'] if s['t1'] > killed_at][0]
               - killed_at,
               replacement={'generation': reborn['generation'],
                            'start_step': reborn['start_step'],
                            'steps': len(reborn['steps'])},
               chief_losses=[s['loss'] for s in chief['steps']])
    emit(card=smi, **out)
    return out


def elastic_swap(cfg, device, tmp, steps, smi=None):
    r = _ElasticRun('swap', cfg, device, tmp, steps,
                    swap_at=ELASTIC_SWAP_AT)
    try:
        env = _elastic_env(r.services, r.run_id, 2,
                           {'AUTODIST_EXECUTE_REPLAN': '1'})
        for pid in range(2):
            r.spawn(pid, env)
        r.wait()
        for tag, p in r.procs:
            r.require_exit(tag, p)
        recs = [r.record('p%d' % i) for i in range(2)]
    finally:
        r.close()
    chief = recs[0]
    entry = chief['swap_entry']
    require(entry.get('migrated'), 'the swap was not applied: %r' % entry)
    boundary = entry['swap']['boundary']
    applied = []
    for rec in recs:
        mig = [e for e in rec['health']['replans'] if e.get('migrated')]
        require(len(mig) == 1, '%s applied %d swaps' % (rec['worker'],
                                                       len(mig)))
        applied.extend(e['step'] for e in rec['flight']
                       if e['kind'] == 'swap_apply')
        past = [s for s in rec['steps'] if s['step'] >= boundary]
        require(len(past) >= steps - boundary and all(
            math.isfinite(s['loss']) for s in rec['steps']),
                '%s: %d steps past the boundary' % (rec['worker'],
                                                    len(past)))
    require(applied == [boundary, boundary], 'applied at %r, boundary %d'
            % (applied, boundary))
    rekey = chief.get('rekey') or {}
    require(rekey.get('new_keys_equal') and rekey.get('old_keys_equal'),
            'the re-keyed tables differ from the old keys: %r' % rekey)
    require(all(rekey['shards'][t] > 1 for t in NCF_TABLES),
            'a table kept its geometry: %r' % rekey.get('shards'))
    walls = {e['kind']: e['wall'] for e in chief['flight']}
    out = dict(phase='loose_elastic', run='swap', steps=steps,
               batch=cfg['batch'], swap_at=ELASTIC_SWAP_AT,
               builder='UnevenPartitionedPS(staleness=%d)'
               % LOOSE_STALENESS, boundary=boundary,
               stage_to_arm_s=walls['swap_arm'] - walls['swap_stage'],
               stage_to_ready_s=walls['swap_apply'] - walls['swap_stage'],
               apply_wall_s=[
                   [e for e in rec['health']['replans']
                    if e.get('migrated')][0]['migration']['wall_s']
                   for rec in recs],
               rekeyed_bytes=rekey['bytes'], rekeyed_vars=len(rekey['vars']),
               table_shards={t: rekey['shards'][t] for t in NCF_TABLES},
               losses={rec['worker']: [s['loss'] for s in rec['steps']]
                       for rec in recs})
    emit(card=smi, **out)
    return out


def ncf_forward(values, users, items, rows):
    """NCF's logits (``ncf_graph``'s towers) from a serving snapshot's
    dense variables and the looked-up embedding rows."""
    dev = values['head/bias'].device
    t = {k: torch.as_tensor(v, device=dev) for k, v in rows.items()}
    gmf = t['mf_user'] * t['mf_item']
    y = torch.cat([t['mlp_user'], t['mlp_item']], dim=-1)
    i = 0
    while 'mlp_%d/kernel' % i in values:
        y = torch.relu(y @ values['mlp_%d/kernel' % i] +
                       values['mlp_%d/bias' % i])
        i += 1
    both = torch.cat([gmf, y], dim=-1)
    return (both @ values['head/kernel'] + values['head/bias']).reshape(-1)


def elastic_serve(cfg, device, tmp, steps, smi=None):
    from autodist_tpu_torch.runtime.loose_session import \
        live_members_on_plane
    from autodist_tpu_torch.serving import ServingFleet
    init = ncf_init(cfg)
    dense = {n: v.shape for n, v in init.items() if n not in NCF_TABLES}
    sparse = {n: init[n].shape for n in NCF_TABLES}
    r = _ElasticRun('serve', cfg, device, tmp, steps, barrier=None,
                    parties=3)
    r.args['barrier'] = 'smoke/%s' % r.run_id
    fleet = None
    try:
        env = _elastic_env(r.services, r.run_id, 2)
        for pid in range(2):
            r.spawn(pid, env)
        ctl = r.client()
        ns = r.ns(ctl)
        fleet = ServingFleet(ns, address=('127.0.0.1', r.services[0][0]),
                             dense_vars=dense, sparse_vars=sparse,
                             device=device, poll_s=0.05)
        fleet.add_replica(connect_deadline_s=300.0)
        killed = fleet.add_replica(connect_deadline_s=300.0)
        rng = np.random.RandomState(7)
        n = min(ELASTIC_SERVE_ROWS, cfg['users'], cfg['items'])
        forwards = 0
        members_before = None
        # serve while the cohort trains: until both pass the kill point,
        # one reader is closed mid-run, then until they finish and a
        # forward was served (a cohort may finish before the readers'
        # first snapshot: it then waits at the launcher's barrier)
        deadline = time.time() + 300.0
        while True:
            steps_now = [ctl.incr('%s/step/p%d' % (ns, i), 0)
                         for i in range(2)]
            if members_before is None and min(steps_now) >= 1:
                members_before = live_members_on_plane(ctl, ns)
            if min(steps_now) >= steps and forwards:
                break
            require(time.time() < deadline, 'no forward was served')
            users = rng.randint(0, cfg['users'], n).astype(np.int32)
            items = rng.randint(0, cfg['items'], n).astype(np.int32)
            rows = {t: fleet.lookup(t, users if 'user' in t else items)
                    for t in NCF_TABLES}
            snap = fleet.replicas[forwards % len(fleet.replicas)]
            if snap.snapshot is not None and snap._data is not None:
                logits = snap.forward(ncf_forward, users, items, rows)
                require(bool(torch.isfinite(logits).all()),
                        'a served forward is not finite')
                forwards += 1
            if killed in fleet.replicas and min(steps_now) >= steps // 2:
                # a reader dies mid-run
                fleet._stops[fleet.replicas.index(killed)].set()
                killed.close()
                fleet.replicas.remove(killed)
        members_after = live_members_on_plane(ctl, ns)
        ctl.barrier(r.args['barrier'] + '/trained', 3, timeout_s=300.0)
        # the plane is quiet: pin, look up, and hold both to the PS
        live = fleet.replicas[0]
        live.refresh()
        with live._lock:
            # the replica's serve thread polls on the same connection
            floor = live.published_floor()
        require(live.snapshot.step == floor, 'the pinned step %d is not '
                'the floor %d' % (live.snapshot.step, floor))
        users = rng.randint(0, cfg['users'], n).astype(np.int32)
        items = rng.randint(0, cfg['items'], n).astype(np.int32)
        exact = True
        for t in NCF_TABLES:
            ids = users if 'user' in t else items
            got = live.lookup(t, ids)
            table = ctl.vget('%s/var/%s' % (ns, t), shape=sparse[t])
            exact = exact and np.array_equal(got, table[ids])
        for name, shape in dense.items():
            exact = exact and np.array_equal(
                live.snapshot.values[name].cpu().numpy(),
                ctl.vget('%s/var/%s' % (ns, name), shape=shape))
        stats = fleet.stats()
        ctl.barrier(r.args['barrier'] + '/read', 3, timeout_s=300.0)
        ctl.close()
        r.wait()
        for tag, p in r.procs:
            r.require_exit(tag, p)
        recs = [r.record('p%d' % i) for i in range(2)]
    finally:
        if fleet is not None:
            fleet.stop()
        r.close()
    require(exact, 'served rows or dense values differ from the PS')
    require(members_before == members_after == (2, 2, 0),
            'membership moved with the readers: %r -> %r'
            % (members_before, members_after))
    for rec in recs:
        require(len(rec['steps']) == steps and
                rec['health']['active_workers'] == 2,
                '%s took %d steps' % (rec['worker'], len(rec['steps'])))
    require(forwards > 0, 'no forward was served')
    out = dict(phase='loose_elastic', run='serve', steps=steps,
               batch=cfg['batch'], rows_per_lookup=n, readers=2,
               lookups=stats['lookups'], forwards=forwards,
               lookup_p50_ms=stats['lookup_p50_ms'],
               lookup_p99_ms=stats['lookup_p99_ms'],
               row_cache_hit_rate=stats['row_cache_hit_rate'],
               staleness_steps=stats['staleness_steps'],
               staleness_max_steps=stats['staleness_max_steps'],
               snapshot_pulls=stats['snapshot_pulls'],
               rows_equal_pinned_step=exact,
               membership=list(members_after),
               worker_steps=[len(rec['steps']) for rec in recs],
               examples_per_s=[_examples_per_s(cfg, rec['steps'][1:])
                               for rec in recs])
    emit(card=smi, **out)
    return out


def loose_elastic_phase(cfg, steps, device, smi=None, runs=ELASTIC_RUNS,
                        workers=None):
    """``loose_elastic``: the membership half of the loose plane, one
    run of each of ``runs`` (see above); ``workers`` (grow's cohort, the
    exclude run's start) resizes the grow and exclude runs. Returns
    {run: its record}."""
    fns = {'grow': elastic_grow, 'exclude': elastic_exclude,
           'restart': elastic_restart, 'swap': elastic_swap,
           'serve': elastic_serve}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for run in runs:
            n = steps if run != 'swap' else \
                ELASTIC_SWAP_AT + LOOSE_STALENESS + 2 + ELASTIC_SWAP_TRAIN
            kw = {'workers': workers[run]} if workers and run in workers \
                else {}
            t0 = time.time()
            out[run] = fns[run](cfg, device, tmp, n, smi, **kw)
            out[run]['seconds'] = time.time() - t0
    return out


# -- the chief's launch and the cohort telemetry plane -----------------------
# loose_launch: NCF at NCF_FULL under PS(staleness=2), LazyAdam 1e-3, f32,
# depth 2, every process on the one card. Run (a): the chief of a spec of
# two nodes (127.0.0.1, 127.0.0.2) launches the other through Coordinator
# over ssh and scp exec shims; from its LAUNCH_DELAY_FROM-th push on, each
# of p1's pushes is delayed (a faultline delay_conn on the push frame of
# head/bias, one a push) by LAUNCH_DELAY_RATIO times p1's median step
# before the delay, LAUNCH_DELAY_S at least: a fixed delay on a host whose
# steps other processes slow falls under the monitor's 1.5 ratio, so the
# delay follows the step it is held against, twice over (at once p1's
# median step, the verdict read 1.54 and 1.75 on the card: the others'
# work grows by a third once the delay and the join load the card's
# host). At depth 2 a push overlaps
# the next step's compute, so a delay that a loaded host's compute reaches
# hides in it: the floor is twice the CPU twin's undisturbed step under
# load (0.25 s hid behind 0.3 s steps). Every delayed push is a link
# sample of a few bytes and a long wait, which turns the fit of the link
# constants' slope negative, so the delay starts only once the chief's
# monitor has refit them from clean traffic: on a loaded host the first
# fits (one every 4 steps until one holds) can find the timings too noisy.
# The chief also waits until its monitor holds no verdict for p1: a host
# hiccup can flag p1 before the delay (on pull or compute), and a verdict
# stays until its worker recovers, so the delay would only prolong it and
# never show as a verdict on push. The chief publishes the step once both
# hold; p1's delay starts two pushes after it has seen it, and the verdict
# held to the delay is p1's first issued from its first delayed push on
# (one before it is the host's, and the record lists it). At step
# LAUNCH_JOIN_AT, or once that refit holds
# (at most LAUNCH_JOIN_WAIT steps later), the chief calls scale_up(1) and
# waits for the joiner's claim, and the re-rank for the grown world
# prices with the measured constants; the cohort trains as many steps
# past a late join as past one at LAUNCH_JOIN_AT. Run (b): python -m
# autodist_tpu_torch.launch over the same two local nodes, no delay and
# no join. Each worker trains on one batch of its own (seed 1000 * (pid +
# 1)), the batch it is held to fit: its last LAUNCH_FALLING steps below its
# first. The cohort takes LAUNCH_STEPS steps: the join's aftermath (the
# chief's re-rank, the migration at its boundary) disturbs every worker's
# step for a few steps past the join, and the monitor needs two clean
# polls (every 4 steps) after it to confirm a verdict it could not
# confirm across the join. When the first refit holds late, p1's delay
# starts after the join, so the cohort trains on (LAUNCH_VERDICT_WAIT
# steps at most) until the chief's monitor has issued a verdict for p1
# from its first delayed push on (p1 publishes that push, the chief the
# verdict's step). That is the card's run, timed by clocks. Off the card
# (the CPU twin, on a host other loads share) no requirement rests on a
# delay outweighing the host's noise: from p1's LAUNCH_HOLD_FROM-th push
# (the first the monitor's window keeps) each push is held until the chief
# has published the verdict, longer at each hold (the push's share grows
# until the verdict comes), then for the bound the verdict found, so p1 is
# the cohort's slowest worker by far from the monitor's first window to
# the run's end and no noise in the others' steps can accuse them; the
# hold runs outside the push's RPC spans, so it needs no refit first; the
# chief
# starts it only while its monitor holds no verdict for p1 and none
# pending, joins the third worker once its refit holds and every member
# has published LAUNCH_JOIN_AT (the step the joiner adopts), and the
# cohort trains on until the verdict and the migration have come.
LAUNCH_STEPS = 32
LAUNCH_EXTRA = 16          # steps past LAUNCH_STEPS while a migration lands
LAUNCH_VERDICT_WAIT = 16   # and while no verdict for p1's delay has come
LAUNCH_DELAY_FROM = 8
LAUNCH_DELAY_S = 0.5
LAUNCH_DELAY_RATIO = 2.0
LAUNCH_JOIN_AT = 12
LAUNCH_JOIN_WAIT = 32
# Off the card the run's events gate it, not clocks: p1's k-th held push
# waits for the chief's published verdict on p1 for at most
# LAUNCH_HOLD_GROWTH ** (k - 1) (LAUNCH_HOLD_MAX at most) times its first
# hold; the join and the run's end wait for their events,
# LAUNCH_EVENT_STEPS steps at most (a bound on a broken run, not a
# timing).
LAUNCH_HOLD_FROM = 4       # the first push the monitor's window keeps
LAUNCH_HOLD_GROWTH = 2.0
LAUNCH_HOLD_MAX = 4.0
LAUNCH_EVENT_STEPS = 160
LAUNCH_CLI_STEPS = 8
LAUNCH_FALLING = 5
LAUNCH_ENV = {'AUTODIST_TELEMETRY': '1',
              'AUTODIST_TELEMETRY_PUSH_EVERY': '4',
              'AUTODIST_RECALIBRATE_EVERY': '4',
              'AUTODIST_STRAGGLER_POLICY': 'advise',
              'AUTODIST_EXECUTE_REPLAN': '1',
              'AUTODIST_PEER_FAILURE_POLICY': 'exclude',
              'AUTODIST_PS_PIPELINE_DEPTH': '2',
              'AUTODIST_PS_WIRE_DTYPE': 'f32'}
LAUNCH_PHASES = ('staleness_gate', 'pull_vars', 'push_deltas',
                 'pipeline_wait')
SSH_SHIM = """#!/bin/bash
# ssh exec shim: strip option flags, run the remote command on this host.
echo "ssh $@" >> "$SHIM_LOG"
args=()
while [[ $# -gt 0 ]]; do
  case "$1" in
    -o|-i|-p) shift 2 ;;
    *) args+=("$1"); shift ;;
  esac
done
exec bash -c "${args[*]:1}"
"""
SCP_SHIM = """#!/bin/bash
# scp exec shim: strip flags, copy src to the host-stripped destination.
echo "scp $@" >> "$SHIM_LOG"
args=()
while [[ $# -gt 0 ]]; do
  case "$1" in
    -o|-i|-P) shift 2 ;;
    *) args+=("$1"); shift ;;
  esac
done
src="${args[0]}"
dest="${args[1]#*:}"
[[ "$src" == "$dest" ]] && exit 0
exec cp "$src" "$dest"
"""


def write_shims(bindir):
    """``ssh`` and ``scp`` exec shims in ``bindir`` (each logs its command
    line to ``$SHIM_LOG``); returns ``bindir``, for the front of
    ``PATH``."""
    os.makedirs(bindir, exist_ok=True)
    for name, body in (('ssh', SSH_SHIM), ('scp', SCP_SHIM)):
        path = os.path.join(bindir, name)
        with open(path, 'w') as f:
            f.write(body)
        os.chmod(path, 0o755)
    return bindir


def _push_delay_plan(key, first, last, seconds):
    """delay_conn faults on the ``first``-th to ``last``-th push frame of
    ``key`` (a dense variable: one BADD frame a push)."""
    from autodist_tpu_torch.utils.faultline import FaultPlan
    return FaultPlan([{'kind': 'delay_conn', 'match': 'BADD %s ' % key,
                       'at': at, 'seconds': seconds}
                      for at in range(first, last + 1)], seed=14)


def _hold_pushes(sess, fault, address, verdict_key):
    """Off the card, hold each of the session's pushes in which ``fault``
    fired (its sleep set to 0) until the chief has published the
    monitor's verdict on p1 (``verdict_key``), for at most the hold's
    bound: the first hold's (``holds['first_s']``, set when the delay
    starts) times LAUNCH_HOLD_GROWTH for each earlier hold,
    LAUNCH_HOLD_MAX times at most. Once the verdict has come, each later
    push is held for the bound the verdict found, so p1 stays the
    cohort's slowest worker by far and no host noise in the others'
    steps reads as theirs against a baseline that holds p1's. The hold
    runs in the push's proxy refresh, inside its ``push_deltas`` span and
    outside every RPC's, so no link sample of the monitor's refit carries
    it. The wait polls the key over a connection of its own. Returns the
    holds' record: ``{'first_s', 'after_s', 'waits': [seconds held]}``."""
    from autodist_tpu_torch.runtime import coord_client as cc
    holds = {'first_s': None, 'after_s': None, 'waits': [], 'fired': 0}
    ctl = cc.connect_with_retry(address)
    refresh = sess._refresh_proxies

    def held(*args, **kw):
        fired, holds['fired'] = holds['fired'], len(fault.events)
        if holds['first_s'] is not None and len(fault.events) > fired:
            t0 = time.perf_counter()
            if holds['after_s'] is None:
                bound = holds['first_s'] * min(
                    LAUNCH_HOLD_GROWTH ** len(holds['waits']),
                    LAUNCH_HOLD_MAX)
                while not ctl.incr(verdict_key, 0) and \
                        time.perf_counter() - t0 < bound:
                    time.sleep(0.02)
                if ctl.incr(verdict_key, 0):
                    holds['after_s'] = bound
            else:
                time.sleep(holds['after_s'])
            holds['waits'].append(time.perf_counter() - t0)
        return refresh(*args, **kw)

    sess._refresh_proxies = held
    return holds


def launch_worker(args):
    """One process of a ``loose_launch`` run (``chip_smoke.py
    --launch-run JSON``), the same script on every node: the chief when
    no ``AUTODIST_WORKER`` is set, else a worker the chief (run 'ssh') or
    the launcher (run 'cli') started. Writes ``<out>/<worker>.json``."""
    from autodist_tpu_torch.utils.faultline import FaultLine
    run, cfg, out = args['run'], args['cfg'], args['out']
    started = time.time()
    autodist = ad.AutoDist(resource_spec_file=args['spec'],
                           strategy_builder=ad.PS(staleness=LOOSE_STALENESS),
                           device=args['device'])
    sess, feeds, loss, train_op = ncf_program(
        autodist, ncf_init(cfg), optimizer=ad.optimizers.LazyAdam)
    require(type(sess).__name__ == 'LooseSession',
            'loose_launch %s: not in loose mode' % run)
    name, coord = sess._worker_name, autodist._coord
    pid = int(name[1:])
    # on the card clocks time the scenario; elsewhere its events do
    clocked = torch.device(args['device']).type == 'cuda'
    delay_from = LAUNCH_DELAY_FROM if clocked else LAUNCH_HOLD_FROM
    join_wait = LAUNCH_JOIN_WAIT if clocked else LAUNCH_EVENT_STEPS
    extra = (LAUNCH_EXTRA, LAUNCH_VERDICT_WAIT) if clocked else \
        (LAUNCH_EVENT_STEPS, LAUNCH_EVENT_STEPS)
    join_key = sess._key('launch/join_step')
    delay_key = sess._key('launch/delay_step')
    delay_from_key = sess._key('launch/delay_from')
    verdict_key = sess._key('launch/verdict_step')
    fault = None
    if run == 'ssh' and name == 'p1':
        fault = FaultLine(_push_delay_plan(
            sess._key('var/head/bias'), delay_from,
            LAUNCH_STEPS + join_wait + sum(extra), LAUNCH_DELAY_S))
        fault.install()
        if not clocked:
            holds = _hold_pushes(sess, fault, coord.address, verdict_key)
    feed = dict(zip(feeds, ncf_batch(cfg, 1000 * (pid + 1))))
    rec = {'worker': name, 'pid': pid, 'started': started,
           'joining': sess._joining, 'start_step': sess.step_count,
           'steps': []}

    def migrated():
        return any(e.get('migrated') for e in sess._health['replans'])

    def last_step():
        """Run (a) trains as many steps past the join as past one at
        LAUNCH_JOIN_AT (the latest join bounds it until the chief has
        published its step), and on while its staged migration has not
        applied yet and while the monitor has issued no verdict for p1
        since its delay started (the chief publishes its step)."""
        if run != 'ssh':
            return args['steps']
        join = coord.incr(join_key, 0) or LAUNCH_JOIN_AT + join_wait
        end = args['steps'] + join - LAUNCH_JOIN_AT
        if not migrated():
            end += extra[0]
        if not coord.incr(verdict_key, 0):
            end += extra[1]
        return end

    while sess.step_count < args['steps'] or \
            sess.step_count < last_step():
        s = sess.step_count + 1
        t0 = time.time()
        value = float(sess.run([loss, train_op], feed)[0])
        rec['steps'].append({'step': s, 't0': t0, 't1': time.time(),
                             'loss': value,
                             'parties': sess._active_workers()})
        if fault is not None and 'delay_s' not in rec and \
                s >= delay_from - 2:
            if coord.incr(delay_key, 0):
                # two steps before the first delayed push: the delay
                # follows p1's own median step (its first step, the
                # warm-up, left out)
                walls = [r['t1'] - r['t0'] for r in rec['steps'][1:]]
                rec['delay_s'] = max(LAUNCH_DELAY_S, LAUNCH_DELAY_RATIO *
                                     float(np.median(walls)))
                rec['delay_from'] = fault.plan.faults[0]['at']
                coord.incr(delay_from_key, rec['delay_from'])
                for f in fault.plan.faults:
                    # off the card the hold waits instead of the sleep
                    f['seconds'] = rec['delay_s'] if clocked else 0.0
                if not clocked:
                    holds['first_s'] = rec['delay_s']
            else:
                # not cleared yet: the first delayed push moves a step on
                for f in fault.plan.faults:
                    f['at'] += 1
        if run == 'ssh' and sess._is_chief and sess.monitor is not None \
                and sess.monitor.calibrated_params() is not None:
            rec.setdefault('refit_at', s)
        # the card's delay waits for the refit (its delayed frames are
        # link samples); the hold off the card is in none and need not.
        # Both wait while the monitor holds a verdict for p1 or one
        # pending confirmation: the host's noise must not ride into them
        if run == 'ssh' and sess._is_chief and 'delay_cleared_at' not in rec \
                and sess.monitor is not None and \
                ('refit_at' in rec or not clocked) and \
                not any(v['worker'] == 'p1'
                        for v in sess.monitor.verdicts()) and \
                'p1' not in sess.monitor._pending:
            rec['delay_cleared_at'] = s
            coord.incr(delay_key, s)
        if run == 'ssh' and sess._is_chief and 'verdict_at' not in rec and \
                sess.monitor is not None and coord.incr(delay_from_key, 0):
            start = coord.incr(delay_from_key, 0)
            if any(e['kind'] == 'slowdown' and e['worker'] == 'p1' and
                   e['step'] >= start for e in sess.monitor.events):
                rec['verdict_at'] = s
                coord.incr(verdict_key, s)
        if sess.monitor is not None:
            rec['steps'][-1]['slowdowns'] = sum(
                1 for e in sess.monitor.events if e['kind'] == 'slowdown')
        if run == 'ssh' and sess._is_chief and 'scaled_up' not in rec and \
                s >= LAUNCH_JOIN_AT and (
                    s >= LAUNCH_JOIN_AT + join_wait or (
                        sess.monitor is not None and
                        sess.monitor.calibrated_params() is not None and
                        # the joiner adopts the members' least published
                        # step: every member at the join step or past it
                        min(sess.peer_step(i) for i in
                            sess._live_members()) >= LAUNCH_JOIN_AT)):
            rec['scaled_up_at'] = s
            coord.incr(join_key, s)
            t_join = time.time()
            rec['scaled_up'] = len(autodist._coordinator.scale_up(1))
            deadline = time.time() + 300.0
            while coord.incr(sess._key('join/world'), 0) <= 2:
                require(time.time() < deadline, 'no worker joined')
                time.sleep(0.05)
            rec['join_claim_s'] = time.time() - t_join
    # a read lands this worker's last push
    sess.get_variable_value(sorted(sess._graph_item.graph.variables)[0])
    if fault is not None and not clocked:
        rec['holds'] = holds
    rec['migrated'] = migrated()
    rec['ps_stats'] = sess.ps_stats
    tag = args['tag']
    coord.barrier(tag + '/trained', args['parties'], timeout_s=300.0)
    if not sess._is_chief:
        sess.close()
        coord.barrier(tag + '/closed', args['parties'], timeout_s=300.0)
    else:
        # the chief closes last: its cohort trace holds every final batch
        coord.barrier(tag + '/closed', args['parties'], timeout_s=300.0)
        sess.close()
        rec['telemetry_left'] = coord.delete_namespace(
            sess._key('telemetry/'))
        rec['trace_path'] = sess.trace_path
    rec['health'] = sess.health_stats
    rec['flight_events'] = sess._flight.events()
    rec['telemetry_pushed_bytes'] = sess.telemetry_pushed_bytes
    rec['faults_fired'] = len(fault.events) if fault is not None else 0
    if sess._is_chief and autodist._coordinator is not None:
        for sup in autodist._coordinator.supervisors:
            sup.join(timeout=120.0)
        rec['worker_exit_codes'] = [
            sup.proc.poll() for sup in autodist._coordinator.supervisors]
    with open(os.path.join(out, '%s.json' % name), 'w') as f:
        json.dump(rec, f, default=lambda o: o.item() if hasattr(o, 'item')
                  else repr(o))
    return 0


def _launch_spec(out):
    path = os.path.join(out, 'resources.yml')
    with open(path, 'w') as f:
        json.dump({'nodes': [
            {'address': '127.0.0.1', 'gpus': [0], 'chief': True,
             'network_bandwidth': 100},
            {'address': '127.0.0.2', 'gpus': [0],
             'network_bandwidth': 100}]}, f)   # JSON is valid YAML
    return path


def _free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _launch_env(out, spec, shims):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('AUTODIST_')}
    env.update(LAUNCH_ENV, SYS_RESOURCE_PATH=spec,
               AUTODIST_COORD_SERVICE_ADDR='127.0.0.1:%d' % _free_port(),
               AUTODIST_COORDINATOR_ADDR='127.0.0.1:%d' % _free_port(),
               AUTODIST_TELEMETRY_DIR=out,
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2) // 3)),
               SHIM_LOG=os.path.join(out, 'shim.log'))
    if shims:
        env['PATH'] = write_shims(os.path.join(out, 'bin')) + os.pathsep + \
            env.get('PATH', '')
    return env


def _launch_run(cmd, env, out, timeout):
    """Run ``cmd`` (the chief, or the launcher) in a session of its own,
    its output in ``<out>/run.log``; whatever it started and left is
    killed with its process group. Returns (exit code, seconds, log)."""
    import signal
    t0 = time.time()
    with open(os.path.join(out, 'run.log'), 'w') as log:
        proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            code = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            code = None
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    with open(os.path.join(out, 'run.log')) as f:
        return code, time.time() - t0, f.read()


def _launch_record(out, worker, log):
    path = os.path.join(out, '%s.json' % worker)
    require(os.path.exists(path), 'loose_launch: %s left no record:\n%s'
            % (worker, log[-4000:]))
    with open(path) as f:
        rec = json.load(f)
    FLIGHT_TRACES['loose_launch/%s/%s' % (os.path.basename(out),
                                          worker)] = rec['flight_events']
    return rec


def _eps(cfg, steps, lo, hi):
    """Examples/s over the steps with ids in (lo, hi]."""
    return _examples_per_s(cfg, [s for s in steps if lo < s['step'] <= hi])


def _losses_fall(rec):
    losses = [s['loss'] for s in rec['steps']]
    return all(math.isfinite(x) for x in losses) and \
        len(losses) > LAUNCH_FALLING and \
        all(x < losses[0] for x in losses[-LAUNCH_FALLING:])


def launch_ssh_run(cfg, device, tmp, smi=None):
    """Run (a): the chief's ssh launch with p1's slowdown and the join."""
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.simulator.cost_model import CostModelParams
    out = os.path.join(tmp, 'ssh')
    os.makedirs(out)
    spec = _launch_spec(out)
    env = _launch_env(out, spec, shims=True)
    emit(phase='loose_launch', run='ssh', ssh='exec shims: ssh and scp on '
         'PATH run the remote command on this host (no sshd); the spec '
         'names 127.0.0.1 (chief) and 127.0.0.2, both on GPU 0')
    args = dict(run='ssh', cfg=cfg, device=device, out=out, spec=spec,
                steps=LAUNCH_STEPS, parties=3, tag='launch-ssh-%d'
                % os.getpid())
    t_launch = time.time()
    code, seconds, log = _launch_run(
        [sys.executable, os.path.abspath(__file__), '--launch-run',
         json.dumps(args)], env, out, timeout=400)
    require(code == 0, 'loose_launch ssh: the chief exited %s:\n%s'
            % (code, log[-6000:]))
    p0, p1, p2 = (_launch_record(out, w, log) for w in ('p0', 'p1', 'p2'))
    with open(env['SHIM_LOG']) as f:
        shim = f.read()
    require('scp ' in shim and 'mv -f' in shim and
            'AUTODIST_WORKER=127.0.0.2' in shim,
            'loose_launch ssh: the shim log lacks the strategy shipping or '
            'the worker identity:\n%s' % shim[-3000:])
    require(p0['worker_exit_codes'] == [0, 0],
            'loose_launch ssh: workers exited %r' % p0['worker_exit_codes'])
    require(p2['joining'] and p0.get('scaled_up') == 1,
            'loose_launch ssh: the scale-up joined no worker')
    require(p1['faults_fired'] > 0, 'loose_launch ssh: no push was delayed')
    perf = p0['health']['perf']
    events = [e for e in perf['events'] if e['kind'] == 'slowdown']
    slow_p1 = [e for e in events if e['worker'] == 'p1' and
               e['step'] >= p1['delay_from']]
    # a verdict for p1 before its delay is the host's (the chief starts
    # the delay only once its monitor holds none for p1): each must have
    # recovered before the delay's first push
    pre_open = []
    for e in perf['events']:
        if e['worker'] == 'p1' and e['step'] < p1['delay_from']:
            if e['kind'] == 'slowdown':
                pre_open.append(e)
            elif e['kind'] == 'recovered':
                pre_open = []
    require(not pre_open, 'loose_launch ssh: p1\'s verdict before its '
            'delay (from push %d) did not recover before it: %r'
            % (p1['delay_from'], perf['events']))
    require(slow_p1 and slow_p1[0]['attributed_phase'] == 'push' and
            slow_p1[0]['classification'] == 'link_or_host',
            'loose_launch ssh: no slowdown verdict for p1 on push: %r'
            % perf['events'])
    culprits = [e for e in events if e['worker'] != 'p1' and
                e['classification'] != 'upstream_victim']
    require(not culprits, 'loose_launch ssh: culprit verdicts for %r'
            % culprits)
    grown = [e for e in p0['health']['replans'] if e.get('world') == 3]
    require(grown and grown[0].get('cost_constants') == 'measured' and
            all(math.isfinite(v) for v in
                grown[0].get('cost_alpha_beta', {'-': float('nan')})
                .values()),
            'loose_launch ssh: the re-rank for world 3 was not priced '
            'with measured constants: %r' % p0['health']['replans'])
    with open(p0['trace_path']) as f:
        trace = json.load(f)['traceEvents']
    rows = {e['pid']: e['args']['name'] for e in trace if e['ph'] == 'M'}
    spans = {name: {e['name'] for e in trace
                    if e['pid'] == pid and e['ph'] == 'X'}
             for pid, name in rows.items()}
    require(set(rows.values()) >= {'worker p0', 'worker p1', 'worker p2'}
            and all(set(LAUNCH_PHASES) <= spans['worker p%d' % i]
                    for i in range(3)),
            'loose_launch ssh: the cohort trace lacks a row or a phase: %r'
            % {k: sorted(v) for k, v in spans.items()})
    require(p0['telemetry_left'] == 0, 'loose_launch ssh: %d telemetry '
            'entries left after close' % p0['telemetry_left'])
    for rec in (p0, p1, p2):
        require(_losses_fall(rec), 'loose_launch ssh: %s losses do not fall:'
                ' %r' % (rec['worker'], [s['loss'] for s in rec['steps']]))
    rs = ResourceSpec(resource_file=spec)
    alpha0, beta0 = CostModelParams.from_topology(rs.topology).link(
        cross_node=rs.topology.multi_node)
    fit = perf['recalibrations'][-1] if perf['recalibrations'] else {}
    join_step = p2['start_step']
    res = dict(
        phase='loose_launch', run='ssh', steps=LAUNCH_STEPS,
        batch=cfg['batch'], seconds=seconds,
        launch_s=p1['steps'][0]['t0'] - t_launch,
        launch_to_p1_started_s=p1['started'] - t_launch,
        join_claim_s=p0.get('join_claim_s'), join_step=join_step,
        scaled_up_at=p0['scaled_up_at'],
        joiner_first_step_s=p2['steps'][0]['t0'] - p0['steps'][
            p0['scaled_up_at'] - 1]['t1'],
        examples_per_s={rec['worker']: {
            'before_delay': _eps(cfg, rec['steps'], 2, p1['delay_from']),
            'during_delay': _eps(cfg, rec['steps'], p1['delay_from'],
                                 p0['scaled_up_at']),
            'after_join': _eps(cfg, rec['steps'], join_step + 1, 10 ** 6)}
            for rec in (p0, p1, p2)},
        verdict={k: slow_p1[0].get(k) for k in (
            'step', 'statistic', 'stat_s', 'baseline_s', 'ratio',
            'mad_score', 'attributed_phase', 'classification',
            'phase_shares', 'exclude_candidate')},
        detection_latency_steps=slow_p1[0]['step'] - p1['delay_from'],
        issued_at_chief_step=next(
            (s['step'] for s in p0['steps'] if s.get('slowdowns')), 'close'),
        verdicts=[{k: e.get(k) for k in ('kind', 'worker', 'step',
                                          'classification')}
                  for e in perf['events']],
        pre_delay_open=pre_open,
        rerank={k: grown[0].get(k) for k in (
            'world', 'kept', 'predicted', 'cost_constants',
            'cost_alpha_beta', 'migration_staged', 'migrated')},
        migrated={rec['worker']: rec['migrated'] for rec in (p0, p1, p2)},
        fitted={'alpha_s': fit.get('alpha_s'),
                'beta_s_per_byte': fit.get('beta_s_per_byte'),
                'samples': fit.get('samples'), 'tier': fit.get('tier'),
                'step': fit.get('step')},
        analytic={'alpha_s': alpha0, 'beta_s_per_byte': beta0},
        fitted_over_analytic={'alpha': fit.get('alpha_vs_analytic'),
                              'beta': fit.get('beta_vs_analytic')},
        recalibrations=len(perf['recalibrations']),
        telemetry_bytes_per_step={
            rec['worker']: rec['telemetry_pushed_bytes'] /
            max(1, len(rec['steps'])) for rec in (p0, p1, p2)},
        monitor={'polls': perf['polls'], 'poll_s': perf['poll_s'],
                 'records_ingested': perf['records_ingested'],
                 'step_time_s': perf['step_time_s']},
        trace_rows=sorted(rows.values()),
        telemetry_left=p0['telemetry_left'],
        losses={rec['worker']: [s['loss'] for s in rec['steps']]
                for rec in (p0, p1, p2)},
        refit_at=p0['refit_at'], delay_cleared_at=p0['delay_cleared_at'],
        verdict_published_at=p0.get('verdict_at'),
        delay={'from_push': p1['delay_from'], 'seconds': p1['delay_s'],
               'floor_s': LAUNCH_DELAY_S, 'ratio': LAUNCH_DELAY_RATIO,
               'fired': p1['faults_fired'],
               # off the card: each push's hold (until the verdict came,
               # then the bound it found)
               'holds_s': (p1.get('holds') or {}).get('waits'),
               'hold_after_s': (p1.get('holds') or {}).get('after_s')})
    emit(card=smi, **res)
    return res


def launch_cli_run(cfg, device, tmp, smi=None):
    """Run (b): ``python -m autodist_tpu_torch.launch`` over two local
    nodes."""
    out = os.path.join(tmp, 'cli')
    os.makedirs(out)
    spec = _launch_spec(out)
    env = _launch_env(out, spec, shims=False)
    args = dict(run='cli', cfg=cfg, device=device, out=out, spec=spec,
                steps=LAUNCH_CLI_STEPS, parties=2,
                tag='launch-cli-%d' % os.getpid())
    code, seconds, log = _launch_run(
        [sys.executable, '-m', 'autodist_tpu_torch.launch', '--spec', spec,
         os.path.abspath(__file__), '--launch-run', json.dumps(args)], env,
        out, timeout=300)
    require(code == 0, 'loose_launch cli: the launcher exited %s:\n%s'
            % (code, log[-6000:]))
    recs = [_launch_record(out, w, log) for w in ('p0', 'p1')]
    host, port = env['AUTODIST_COORD_SERVICE_ADDR'].rsplit(':', 1)
    try:
        socket.create_connection((host, int(port)), timeout=2.0).close()
        service_gone = False
    except OSError:
        service_gone = True
    require(service_gone, 'loose_launch cli: the coord service outlived '
            'the launcher')
    for rec in recs:
        require(_losses_fall(rec), 'loose_launch cli: %s losses do not fall:'
                ' %r' % (rec['worker'], [s['loss'] for s in rec['steps']]))
    res = dict(phase='loose_launch', run='cli', steps=LAUNCH_CLI_STEPS,
               batch=cfg['batch'], rc=code, seconds=seconds,
               service_gone=service_gone,
               examples_per_s={rec['worker']: _eps(cfg, rec['steps'], 1,
                                                   10 ** 6) for rec in recs},
               losses={rec['worker']: [s['loss'] for s in rec['steps']]
                       for rec in recs})
    emit(card=smi, **res)
    return res


def loose_launch_phase(cfg, device, smi=None):
    """``loose_launch``: runs (a) and (b) (see above)."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        out = {'ssh': launch_ssh_run(cfg, device, tmp, smi),
               'cli': launch_cli_run(cfg, device, tmp, smi)}
    out['seconds'] = time.time() - t0
    emit(phase='loose_launch', seconds=out['seconds'], card=smi)
    return out


# -- the analysis subsystem ---------------------------------------------------
# analysis: the port's analyzers as a user runs them (python -m
# autodist_tpu_torch.analysis --all --json, a process of its own: the
# model checkers, the lints over the port's sources), then the flight
# events the loose phases' workers recorded on the card, each worker's
# trace replayed through the port's control-plane and epoch-swap
# conformance checkers. The loose phases fill FLIGHT_TRACES as they read
# their workers' records.
ANALYZERS = ('protocol', 'data-plane', 'epoch-swap', 'swap-conformance',
             'fence', 'env', 'schedule')
FLIGHT_TRACES = {}


def replay_traces(traces):
    """{trace name: its events' count} after each trace replayed clean
    through ``conformance.check_events`` and
    ``swap_conformance.check_swap_events``; an empty trace, or none at
    all, fails."""
    from autodist_tpu_torch.analysis import conformance, swap_conformance
    require(traces, 'analysis: no flight trace to replay')
    counts = {}
    for name, events in sorted(traces.items()):
        require(events, 'analysis: the trace of %s is empty' % name)
        findings = conformance.check_events(events) + \
            swap_conformance.check_swap_events(events)
        require(not findings, 'analysis: the trace of %s does not conform:'
                ' %s' % (name, findings[:5]))
        counts[name] = len(events)
    return counts


def analysis_phase(traces, smi=None, analyzers=ANALYZERS):
    """``analysis`` (see above); ``analyzers`` narrows the CLI's run to
    those (the CPU twin runs the lints). Returns the record."""
    flags = ['--all'] if set(analyzers) == set(ANALYZERS) else \
        ['--' + name for name in analyzers]
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, '-m', 'autodist_tpu_torch.analysis', '--json'] +
        flags, cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.time() - t0
    require(proc.returncode == 0, 'analysis: python -m '
            'autodist_tpu_torch.analysis --all exited %d:\n%s\n%s'
            % (proc.returncode, proc.stdout[-4000:], proc.stderr[-3000:]))
    report = json.loads(proc.stdout)
    require(report['clean'] and set(report['analyzers']) == set(analyzers)
            and not any(r['findings']
                        for r in report['analyzers'].values()),
            'analysis: an analyzer has findings: %r' % {
                k: r['findings'] for k, r in report['analyzers'].items()})
    t0 = time.time()
    counts = replay_traces(traces)
    rec = dict(phase='analysis', cli=flags, cli_s=cli_s,
               cli_rc=proc.returncode,
               analyzers={k: {'elapsed_s': r['elapsed_s'],
                              'states_explored': r.get('states_explored')}
                          for k, r in report['analyzers'].items()},
               traces=len(counts), events_replayed=counts,
               replay_s=time.time() - t0)
    emit(card=smi, **rec)
    return rec


# -- the last five examples ----------------------------------------------------
# examples: examples_torch/bert.py (bert_large at seq 512, batch 8, LAMB: the
# flash kernels, non-causal, at [8, 16, 512, 64]), lm1b.py, ncf.py,
# sentiment_classifier.py and linear_regression.py at their default widths,
# each through its run() as its main() calls it; the trainers' examples
# take a warm-up and EXAMPLE_STEPS steps, each step's loss read. The two
# DSL examples are seeded from numpy whole: their values on the card are
# held to the same run on the CPU.
EXAMPLE_STEPS = 3
EXAMPLE_TINY = {'bert': ['--config', 'tiny'], 'lm1b': ['--tiny'],
                'ncf': ['--tiny']}
EXAMPLE_DSL_TOL = 1e-4


def _falls(losses):
    return len(losses) > 1 and all(math.isfinite(x) for x in losses) and \
        losses[-1] < losses[0]


def examples_phase(device, smi=None, tiny=False):
    """``examples`` (see above); ``tiny`` runs the trainers' examples at
    their tiny widths (the CPU twin). Returns the record."""
    from autodist_tpu_torch import autodist as ad_mod
    cuda = torch.device(device).type == 'cuda'
    rec = {'phase': 'examples', 'device': str(device)}
    for name in ('bert', 'lm1b', 'ncf'):
        example = _example(name)
        argv = ['--steps', str(EXAMPLE_STEPS), '--device', str(device)]
        if name == 'bert':
            argv += ['--config', 'bert_large', '--optimizer', 'lamb']
        if tiny:
            argv += EXAMPLE_TINY[name]
        args = example.parse(argv)
        losses = []
        t0 = time.time()
        fa.reset_launches()
        xe.reset_launches()
        rate = example.run(args, losses)[0]
        launches, by_kernel = dict(fa.LAUNCHES), dict(fa.KERNEL_LAUNCHES)
        xent = dict(xe.LAUNCHES)
        rec[name] = {'argv': argv, 'losses': losses, 'rate': rate,
                     'seconds': time.time() - t0}
        require(_falls(losses), 'examples %s: the losses do not fall: %r'
                % (name, losses))
        if name == 'bert':
            steps = EXAMPLE_STEPS + 1    # the warm-up and the timed steps
            rec[name].update(seq=args.seq or (
                512 if args.config == 'bert_large' else 64),
                batch=args.batch, launches=launches,
                kernel_launches=by_kernel, xent_launches=xent,
                launches_a_step={k: n // steps
                                 for k, n in launches.items()})
            # one unchunked loss a step (the example sets no loss_chunk)
            check_xent_launches('examples bert', xent, {
                'fwd': steps, 'bwd': steps, 'plain': 0} if cuda else {
                'fwd': 0, 'bwd': 0, 'plain': 2 * steps})
            if cuda and not tiny:
                require(all(n > 0 and n % steps == 0
                            for n in launches.values()),
                        'examples bert: K1-K3 launched %r over %d steps'
                        % (launches, steps))
        if cuda:
            torch.cuda.empty_cache()
    dsl = {}
    for name in ('linear_regression', 'sentiment_classifier'):
        example = _example(name)
        dsl[name] = {}
        for dev in (str(device), 'cpu'):
            ad_mod._DEFAULT_AUTODIST.clear()
            dsl[name][dev] = example.run(device=dev, log=lambda line: None)
        if cuda:
            torch.cuda.empty_cache()
    lin, senti = dsl['linear_regression'], dsl['sentiment_classifier']
    ondev, cpu = lin[str(device)], lin['cpu']
    lin_err = {'W': abs(ondev['W'] - cpu['W']), 'b': abs(ondev['b'] - cpu['b']),
               'losses_rel': max(abs(a - b) / abs(b) for a, b in zip(
                   ondev['losses'], cpu['losses']))}
    ondev, cpu = senti[str(device)], senti['cpu']
    senti_err = {'losses_rel': max(
        abs(ondev['losses'][k] - cpu['losses'][k]) / abs(cpu['losses'][k])
        for k in cpu['losses']),
        'emb_norm_rel': abs(ondev['emb_norm'] - cpu['emb_norm']) /
        cpu['emb_norm']}
    rec['linear_regression'] = dict(lin[str(device)], cpu=lin['cpu'],
                                    err=lin_err, tol=EXAMPLE_DSL_TOL)
    rec['sentiment_classifier'] = dict(
        senti[str(device)], cpu=senti['cpu'], err=senti_err,
        tol=EXAMPLE_DSL_TOL)
    emit(card=smi, **rec)
    require(_falls(lin[str(device)]['losses']) and
            _falls(list(senti[str(device)]['losses'].values())),
            'examples: a DSL example\'s losses do not fall')
    require(max(lin_err.values()) <= EXAMPLE_DSL_TOL,
            'examples linear_regression on %s differs from the CPU: %r'
            % (device, lin_err))
    require(max(senti_err.values()) <= EXAMPLE_DSL_TOL,
            'examples sentiment_classifier on %s differs from the CPU: %r'
            % (device, senti_err))
    return rec


def bert_rows(rec, launches, steps=EXAMPLE_STEPS + 1):
    """K1-K3's rows of the ``kernels`` line at bert_large's non-causal
    shape: ``rec`` from ``check_kernels(BERT_SHAPE, False, bf16,
    timed=True)``, ``launches`` the bert example's run's (its warm-up and
    timed ``steps``), also given a step."""
    rows = []
    for name in ('fwd', 'dq', 'dkv'):
        row = flash_row(name, rec[name], launches[name], BERT_SHAPE,
                        '_bert_large')
        row['causal'] = False
        row['launches_a_step'] = launches[name] // steps
        row['launches_by_path'] = {'examples_bert': launches[name]}
        rows.append(row)
    return rows


# -- head dims beside 64 ------------------------------------------------------
# B, H, S of the flash_head_dims phase, and the head dims it runs: 80 and
# 96 run padded to 128 (the wgmma kernels in bf16), 160 padded to 256 and
# 256 as it is (bf16: the wgmma kernels; f32: the CUDA-core ones with a
# 32-row query tile), 384 as it is (the column-chunked kernels, both
# dtypes)
HEAD_DIM_BHS = (2, 8, 1024)
HEAD_DIM_CASES = (80, 96, 160, 256, 384)


def check_head_dim(d, causal, dtype, smi):
    """flash_head_dims for one (head dim, mask, dtype). Through the
    wrapper, which zero-pads to ``fa.padded_head_dim(d)``: the forward and
    the three gradients against the plain versions at the true head dim,
    one launch of each kernel, by the CUDA kernel that the dispatch names
    (``fa.kernel_name``). Then each kernel's time at the padded
    width (``flash_fwd``, ``_dq_cuda`` etc., as the wrapper launches
    them), its plain
    version's and the library's at the true head dim, and the bound of
    the work at the true head dim; and the wrapper's whole forward (the
    pad copies and the slice included). Returns {kernel: record}."""
    shape = HEAD_DIM_BHS + (d,)
    width = fa.padded_head_dim(d)
    gen = torch.Generator(device='cuda').manual_seed(5)
    q, k, v, do = (torch.randn(shape, generator=gen, device='cuda',
                               dtype=torch.float32).to(dtype)
                   for _ in range(4))
    scale = d ** -0.5
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    fa.reset_launches()
    o = fa.flash_attention(qq, kk, vv, causal=causal)
    dq, dk, dv = torch.autograd.grad(o, (qq, kk, vv), do)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    by_kernel = dict(fa.KERNEL_LAUNCHES)
    o2, lse2 = fa._fwd_plain(q, k, v, causal, scale)
    delta = fa._delta(do, o2)
    dq2 = fa._dq_plain(q, k, v, do, lse2, delta, causal, scale)
    dk2, dv2 = fa._dkv_plain(q, k, v, do, lse2, delta, causal, scale)
    tol = TOL[dtype]
    checks = {'fwd': [max_err(o, o2, tol['o'])],
              'dq': [max_err(dq, dq2, tol['grad'])],
              'dkv': [max_err(dk, dk2, tol['grad']),
                      max_err(dv, dv2, tol['grad'])]}
    del o, dq, dk, dv, o2, dq2, dk2, dv2, qq, kk, vv

    def pad(t):
        return F.pad(t, (0, width - d)).contiguous()
    qp, kp, vp, dop = (pad(t) for t in (q, k, v, do))
    op, lsep = fa.flash_fwd(qp, kp, vp, causal, scale)
    bwd = (qp, kp, vp, dop, lsep, fa._delta(dop, op), causal, scale)
    plain_bwd = (q, k, v, do, lse2, delta, causal, scale)
    runs = {'fwd': (lambda: fa.flash_fwd(qp, kp, vp, causal, scale),
                    lambda: fa._fwd_plain(q, k, v, causal, scale)),
            'dq': (lambda: fa._dq_cuda(*bwd),
                   lambda: fa._dq_plain(*plain_bwd)),
            'dkv': (lambda: fa._dkv_cuda(*bwd),
                    lambda: fa._dkv_plain(*plain_bwd))}
    out = {}
    for name, results in checks.items():
        ok = all(p for _, p in results)
        kernel = fa.kernel_name(name, dtype, width)
        rec = {'max_abs_err': max(e for e, _ in results),
               'launches': launches[name], 'cuda_kernel': kernel,
               'cuda_kernel_launches': by_kernel.get(kernel, 0)}
        rec.update(_times(name, *runs[name], q, k, v, do, causal, scale))
        if name == 'fwd':
            with torch.no_grad():
                rec['wrapper_ms'] = cuda_ms(lambda: fa.flash_attention(
                    q, k, v, causal=causal), 10)
        rec['bound_ms'], rec['bound_by'] = bound(name, shape, dtype, causal)
        rec.update(rates(name, shape, dtype, causal, rec['ms']))
        emit(phase='flash_head_dims', kernel=name, head_dim=d,
             padded_to=width, shape=list(shape),
             dtype=str(dtype).replace('torch.', ''), causal=causal, ok=ok,
             tol={k: list(v) for k, v in tol.items()}, card=smi, **rec)
        require(ok, '%s kernel at head dim %d (padded to %d) disagrees with '
                'its plain version, %s causal=%s' % (name, d, width, dtype,
                                                     causal))
        require(launches[name] == 1 and by_kernel.get(kernel) == 1,
                'the wrapper at head dim %d launched %s %d times (%s), '
                'expected once by %s' % (d, name, launches[name], by_kernel,
                                         kernel))
        out[name] = rec
    return out


def flash_head_dims(smi):
    """The head dims beside 64, each beside the kernels at head dim 64 on
    the same B·H·S. Returns the records by (d, causal, dtype)."""
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            records[(64, causal, dtype)] = check_kernels(
                HEAD_DIM_BHS + (64,), causal, dtype, True, smi)
            for d in HEAD_DIM_CASES:
                records[(d, causal, dtype)] = check_head_dim(d, causal,
                                                             dtype, smi)
            torch.cuda.empty_cache()
    emit(phase='flash_head_dims_summary', bhs=list(HEAD_DIM_BHS),
         ms={'%s d%d %s %s' % (name, d, str(dt).replace('torch.', ''),
                               'causal' if c else 'full'): rec[name]['ms']
             for (d, c, dt), rec in sorted(records.items(), key=str)
             for name in ('fwd', 'dq', 'dkv')}, card=smi)
    return records


# bf16 dK/dV from head dim 256 on (dkv_wgmma_kernel at 256,
# dkv_wgmma_cols_kernel above), at an S ragged for their 64-row tiles
DKV_WIDE_BHS = (2, 4, 1000)
DKV_WIDE_DIMS = (256, 320, 384)


def dkv_head_dims(smi):
    """bf16 dK/dV at [2, 4, 1000, D] for each of ``DKV_WIDE_DIMS``,
    causal and full, called directly: against the plain version within
    ``TOL``, and a second launch on the same inputs bitwise equal."""
    dtype, tol = torch.bfloat16, TOL[torch.bfloat16]['grad']
    for d in DKV_WIDE_DIMS:
        shape = DKV_WIDE_BHS + (d,)
        gen = torch.Generator(device='cuda').manual_seed(6)
        q, k, v, do = (torch.randn(shape, generator=gen, device='cuda',
                                   dtype=torch.float32).to(dtype)
                       for _ in range(4))
        scale = d ** -0.5
        for causal in (True, False):
            o, lse = fa._fwd_cuda(q, k, v, causal, scale)
            args = (q, k, v, do, lse, fa._delta(do, o), causal, scale)
            got, again = fa._dkv_cuda(*args), fa._dkv_cuda(*args)
            want = fa._dkv_plain(*args)
            torch.cuda.synchronize()
            errs = [max_err(g, w, tol) for g, w in zip(got, want)]
            rec = dict(phase='dkv_head_dims', head_dim=d, shape=list(shape),
                       dtype='bfloat16', causal=causal,
                       ok=all(p for _, p in errs),
                       max_abs_err=max(e for e, _ in errs), tol=list(tol),
                       bitwise_repeat=all(bool(torch.equal(a, b))
                                          for a, b in zip(got, again)),
                       cuda_kernel=fa.kernel_name('dkv', dtype, d), card=smi)
            emit(**rec)
            require(rec['ok'], 'dK/dV at head dim %d causal=%s disagrees '
                    'with its plain version' % (d, causal))
            require(rec['bitwise_repeat'], 'dK/dV at head dim %d causal=%s: '
                    'two launches differ' % (d, causal))


# -- bench_sparse's models through the functional Trainer ---------------------
# LSTMLM at bench.py:bench_sparse's LM1B configuration: vocab 100,000,
# embedding 512, 2 LSTM layers of 1024, batch 128 x 32 tokens
LM1B = {'vocab': 100000, 'dim': 512, 'hidden': 1024, 'layers': 2,
        'batch': 128, 'seq': 32}
LM1B_SMALL = {'vocab': 64, 'dim': 16, 'hidden': 24, 'layers': 2,
              'batch': 4, 'seq': 6}
LM1B_STEPS = 5
# one step at grad_accum=4 against one at 1: the loss agrees to 1e-5
# relative (a mean of 4 chunk means of equal size is the batch mean, up
# to rounding), each gradient to 1e-5 of the largest gradient (the
# chunks' f32 sums in another order)
ACCUM_LOSS_REL, ACCUM_GRAD_REL = 1e-5, 1e-5


def ncf_model(cfg, device, seed=0):
    return NCF(cfg['users'], cfg['items'], mf_dim=cfg['mf_dim'],
               mlp_dims=cfg['mlp'], device=device, seed=seed)


def ncf_batch_dict(cfg, seed):
    users, items, labels = ncf_batch(cfg, seed)
    return {'users': users, 'items': items, 'labels': labels}


def host_state(trainer, state):
    """{leaf name: host array} of the state as ``save_state`` writes it."""
    from autodist_tpu_torch.checkpoint.saver import _leaf_paths
    return dict(_leaf_paths(trainer._state_tree(state)))


def grad_accum_check(trainer, state, batch, accum):
    """One step at ``grad_accum=accum`` and one at 1, each from the same
    state (put back after each). Returns (|loss difference| / |loss|,
    max |gradient difference| / max |gradient|)."""
    model, opt = trainer.model, state.opt_state
    params = list(model.parameters())
    saved = ([p.detach().clone() for p in params],
             copy.deepcopy(opt.state_dict()), state.step)
    out = []
    for a in (1, accum):
        t = Trainer(model, trainer.optimizer, spec=ParallelSpec(grad_accum=a))
        _, m = t.step(state, batch)
        out.append((float(m['loss']), [p.grad.clone() for p in params]))
        with torch.no_grad():
            for p, v in zip(params, saved[0]):
                p.copy_(v)
        opt.load_state_dict(copy.deepcopy(saved[1]))
        state.step = saved[2]
    (l1, g1), (la, ga) = out
    top = max(float(g.abs().max()) for g in g1)
    return abs(la - l1) / abs(l1), \
        max(float((a - b).abs().max()) for a, b in zip(g1, ga)) / top


def ncf_trainer_phase(cfg, device, tmp, steps=NCF_STEPS, smi=None,
                      profiling=False):
    """bench_sparse's NCF through ``trainer_from_strategy(...,
    optim.adam(1e-3), PSLoadBalancing())`` and ``fit`` (prefetch 2, eval
    of 2 batches and a checkpoint every 10 steps); then the checkpoint
    restored into a fresh trainer (params and Adam slots bitwise), a
    profile (trace written, params bitwise unchanged) and one step at
    grad_accum=4 against one at 1. A step's time is the time between
    two pulls from the source: with prefetch 2, fit pulls batch k + 2 as
    step k starts. Returns the record."""
    cuda = torch.device(device).type == 'cuda'
    trainer = trainer_from_strategy(ncf_model(cfg, device), optim.adam(1e-3),
                                    PSLoadBalancing())
    data = [ncf_batch_dict(cfg, 100 + i) for i in range(steps + 2)]
    eval_data = [ncf_batch_dict(cfg, 900 + i) for i in range(2)]
    pulls = []

    def source():
        for b in data:
            pulls.append(time.perf_counter())
            yield b

    mgr = CheckpointManager(os.path.join(tmp, 'ncf_ckpt'))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = trainer.init(seed=0)
    state, hist = trainer.fit(state, source(), steps=steps,
                              eval_data=eval_data, eval_every=10,
                              checkpoint_manager=mgr, save_every=10,
                              prefetch=2)
    seconds = np.diff(pulls[2:]).tolist()      # steps 1 .. steps - 1
    step_s = float(np.median(seconds[1:]))
    losses = hist['loss']
    rec = {'steps': steps, 'batch': cfg['batch'], 'losses': losses,
           'eval_loss': hist['eval_loss'], 'checkpoints': mgr.all_steps(),
           'step_seconds': seconds, 'median_step_s': step_s,
           'examples_per_s': cfg['batch'] / step_s}
    if cuda:
        rec['peak_mem_gb'] = torch.cuda.max_memory_allocated() / 1e9
    require(all(math.isfinite(x) for x in losses), 'NCF trainer loss not '
            'finite')
    require(abs(losses[0] - math.log(2)) < 0.05, 'NCF trainer first loss '
            '%.4f is not near ln 2' % losses[0])
    require(len(losses) == steps and [s for s, _ in hist['eval_loss']] ==
            [10, 20][:steps // 10] and mgr.all_steps()[-1] == steps,
            'NCF fit: %d losses, evals %s, checkpoints %s'
            % (len(losses), hist['eval_loss'], mgr.all_steps()))

    fresh = trainer_from_strategy(ncf_model(cfg, device, seed=1),
                                  optim.adam(1e-3), PSLoadBalancing())
    fstate, got = fresh.restore_state(mgr, fresh.init(seed=1))
    saved, restored = host_state(trainer, state), host_state(fresh, fstate)
    rec['restored_step'] = got
    rec['restore_bitwise'] = saved.keys() == restored.keys() and all(
        np.array_equal(saved[k], restored[k]) for k in saved)
    require(got == steps and rec['restore_bitwise'], 'NCF restore_state: '
            'step %s, params and Adam slots bitwise %s'
            % (got, rec['restore_bitwise']))
    del fresh, fstate, saved, restored

    before = [p.detach().clone() for p in trainer.model.parameters()]
    trace_dir = os.path.join(tmp, 'ncf_trace')
    trainer.profile(state, data[0], trace_dir, steps=2)
    rec['trace_files'] = sorted(os.listdir(trace_dir))
    rec['profile_left_params'] = all(
        torch.equal(a, b) for a, b in zip(before, trainer.model.parameters()))
    require(rec['trace_files'] and rec['profile_left_params'],
            'NCF profile: trace %s, params unchanged %s'
            % (rec['trace_files'], rec['profile_left_params']))
    del before

    loss_rel, grad_rel = grad_accum_check(trainer, state, data[0], 4)
    rec.update(accum_loss_rel=loss_rel, accum_grad_rel=grad_rel,
               accum_tol={'loss_rel': ACCUM_LOSS_REL,
                          'grad_rel_to_max': ACCUM_GRAD_REL})
    require(loss_rel <= ACCUM_LOSS_REL and grad_rel <= ACCUM_GRAD_REL,
            'NCF grad_accum=4 against 1: loss %.3g, gradients %.3g'
            % (loss_rel, grad_rel))
    if smi is not None:
        emit(phase='ncf_trainer', strategy='PSLoadBalancing', card=smi,
             **rec)
    if profiling:
        profile_step('ncf_trainer', trainer, state, data[0], smi)
    return rec


def lm1b_phase(cfg, device, steps=LM1B_STEPS, smi=None, profiling=False):
    """LSTMLM through ``trainer_from_strategy(..., optim.adam(1e-3),
    PartitionedPS())`` (a no-op partition at dp = 1): ``steps`` steps at
    remat='none', then as many at remat='full' from the same init; the
    losses agree to 1e-5 relative and the first is near ln(vocab).
    Returns {remat: record}."""
    cuda = torch.device(device).type == 'cuda'
    model = LSTMLM(cfg['vocab'], cfg['dim'], cfg['hidden'], cfg['layers'],
                   device=device)
    batch = make_batch(cfg['vocab'], cfg['batch'], cfg['seq'], seed=6)
    tokens = cfg['batch'] * cfg['seq']
    arms = {}
    for remat in ('none', 'full'):
        trainer = trainer_from_strategy(model, optim.adam(1e-3),
                                        PartitionedPS(),
                                        spec=ParallelSpec(remat=remat))
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        state, losses, seconds = train_steps(trainer, batch, steps)
        step_s = float(np.median(seconds[1:]))
        rec = {'remat': remat, 'steps': steps, 'losses': losses,
               'step_seconds': seconds, 'median_step_s': step_s,
               'tokens_per_s': tokens / step_s}
        if cuda:
            rec['peak_mem_gb'] = torch.cuda.max_memory_allocated() / 1e9
        require(all(math.isfinite(x) for x in losses), 'LM1B loss not finite')
        require(abs(losses[0] - math.log(cfg['vocab'])) < 0.5,
                'LM1B first loss %.4f is not near ln(vocab)' % losses[0])
        if smi is not None:
            emit(phase='lm1b_trainer', strategy='PartitionedPS',
                 batch=cfg['batch'], seq=cfg['seq'], card=smi, **rec)
        if profiling:
            profile_step('lm1b_%s' % remat, trainer, state, batch, smi)
        arms[remat] = rec
    rel = max(abs(a - b) / abs(b) for a, b in zip(arms['full']['losses'],
                                                  arms['none']['losses']))
    arms['remat_loss_rel'] = rel
    require(rel <= 1e-5, 'LM1B remat=full losses %s against %s'
            % (arms['full']['losses'], arms['none']['losses']))
    return arms


def small_sparse_reference():
    """NCF and LSTMLM at tiny width through the Trainer, 3 Adam steps on
    the card and on the CPU from the same init (the port's own init from
    a seed): the losses agree to 1e-4."""
    runs = {'ncf': (lambda dev: ncf_model(NCF_SMALL, dev),
                    [ncf_batch_dict(NCF_SMALL, i) for i in range(3)]),
            'lstm': (lambda dev: LSTMLM(LM1B_SMALL['vocab'],
                                        LM1B_SMALL['dim'],
                                        LM1B_SMALL['hidden'],
                                        LM1B_SMALL['layers'], device=dev),
                     [make_batch(LM1B_SMALL['vocab'], LM1B_SMALL['batch'],
                                 LM1B_SMALL['seq'], seed=i)
                      for i in range(3)])}
    for name, (make, batches) in runs.items():
        losses = {}
        for device in ('cuda', 'cpu'):
            trainer = Trainer(make(device), optim.adam(1e-3))
            state = trainer.init(seed=0)
            losses[device] = [float(trainer.step(state, b)[1]['loss'])
                              for b in batches]
        err = max(abs(a - b) for a, b in zip(losses['cuda'], losses['cpu']))
        emit(phase='small_sparse_reference', model=name,
             losses_cuda=losses['cuda'], losses_cpu=losses['cpu'],
             max_abs_err=err, tol=1e-4)
        require(err <= 1e-4, 'the small %s on the card disagrees with the '
                'CPU: %r vs %r' % (name, losses['cuda'], losses['cpu']))


# ---------------------------------------------------------------------------
# servable export, the record loader and the zero-touch adapter
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(ROOT, 'examples_torch')
# served outputs against eager ones: |served - eager| <= SERVE_REL *
# max|eager| (bf16: the same kernels and products, but a program traced by
# torch.export may fuse or order the elementwise passes otherwise)
SERVE_REL = 1e-2
SERVE_REPS = 3
# image_classifier's CNN: losses across the 8 builders at dp = 1, and the
# card against the CPU (f32, TF32 off: sums in another order)
FUNCTIONAL_STEPS, FUNCTIONAL_CPU_STEPS = 5, 3
FUNCTIONAL_BUILDER_REL, FUNCTIONAL_CPU_REL = 1e-6, 1e-4

# The serving process: the port's ``load_servable`` (which imports
# ``autodist_tpu_torch.kernels`` when the bundle's program calls them),
# with torch and numpy and no jax; it serves each input file, counting
# the kernels' launches a request.
_SERVE = r'''
import json, os, sys, time
import numpy as np
import torch
from autodist_tpu_torch.checkpoint.export import load_servable
from autodist_tpu_torch.kernels import conv_bn, flash_attention

bundle, out_dir, device, reps = sys.argv[1], sys.argv[2], sys.argv[3], \
    int(sys.argv[4])
names = sys.argv[5:]
serve = load_servable(bundle, device=device)


def sync():
    if device != 'cpu':
        torch.cuda.synchronize()


report = {}
for name in names:
    x = torch.from_numpy(np.load(os.path.join(out_dir, name + '.npy')))
    x = x.to(device)
    for c in (flash_attention, conv_bn):
        c.reset_launches()
    out = serve(x)
    sync()
    rec = {'flash_fwd': dict(flash_attention.KERNEL_LAUNCHES),
           'conv_bn': conv_bn.LAUNCHES['conv_bn']}
    torch.save(out.cpu(), os.path.join(out_dir, name + '.served.pt'))
    del out
    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        serve(x)
        sync()
        seconds.append(time.perf_counter() - t0)
    rec['seconds'] = seconds
    report[name] = rec
if 'jax' in sys.modules:
    raise SystemExit('the serving process imported jax')
report['port_modules'] = sum(1 for m in sys.modules
                             if m.split('.')[0] == 'autodist_tpu_torch')
print(json.dumps(report))
'''


def serve_fresh(bundle, inputs, device, tmp, reps=SERVE_REPS):
    """Serve ``bundle`` on each of ``inputs`` ({name: numpy array}) in a
    fresh process on ``device``. Returns (its report, {name: served
    output as a CPU tensor})."""
    for name, x in inputs.items():
        np.save(os.path.join(tmp, name + '.npy'), x)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, '-c', _SERVE, bundle, tmp, device, str(reps),
         *inputs], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=600)
    require(proc.returncode == 0, 'the serving process failed:\n%s'
            % proc.stderr[-4000:])
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    outs = {name: torch.load(os.path.join(tmp, name + '.served.pt'))
            for name in inputs}
    for name in inputs:
        os.remove(os.path.join(tmp, name + '.served.pt'))
    return report, outs


def eager_serve(fn, params, x, reps, device):
    """(output, seconds of each timed request) of ``fn(params, x)`` in
    this process, without grad."""
    def sync():
        if torch.device(device).type == 'cuda':
            torch.cuda.synchronize()
    with torch.no_grad():
        out = fn(params, x)
        sync()
        seconds = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(params, x)
            sync()
            seconds.append(time.perf_counter() - t0)
    return out, seconds


def compare_served(served, eager):
    """(max |served - eager|, max |eager|, bitwise equal)."""
    served = served.to(eager.device)
    return (float((served.float() - eager.float()).abs().max()),
            float(eager.float().abs().max()), bool(torch.equal(served, eager)))


def serve_gpt_small_phase(cfg, batches, device, tmp, smi=None):
    """``cfg`` (gpt_small at bench_longctx's width on the card) from a
    seeded init: ``model.apply`` exported with tokens [None, S], reloaded
    in a fresh process and served at each batch in ``batches`` (the
    symbolic batch). The served logits within ``SERVE_REL`` of the eager
    logits' largest magnitude; on the card each request runs K1 through
    its custom operator, once a layer, on the wgmma kernel. Returns the
    record."""
    from autodist_tpu_torch.checkpoint.export import export_servable
    cuda = torch.device(device).type == 'cuda'
    seq = cfg.max_len
    model = TransformerLM(cfg, device=device, seed=0)
    params = model.params()
    bundle = os.path.join(tmp, 'gpt_small')
    t0 = time.perf_counter()
    export_servable(model.apply, params, [((None, seq), np.int32)], bundle)
    export_s = time.perf_counter() - t0
    inputs = {'b%d' % b: make_batch(cfg.vocab, b, seq, seed=9)['tokens']
              for b in batches}
    report, served = serve_fresh(bundle, inputs, device, tmp)
    d = cfg.dim // cfg.n_heads
    want_kernel = {fa.kernel_name('fwd', cfg.dtype, d): cfg.n_layers} \
        if cuda else None
    rec = dict(phase='serve_gpt_small', dim=cfg.dim, n_layers=cfg.n_layers,
               n_heads=cfg.n_heads, seq=seq, vocab=cfg.vocab,
               dtype=str(cfg.dtype).replace('torch.', ''),
               export_seconds=export_s, port_modules=report['port_modules'],
               requests={})
    for name, tokens in inputs.items():
        b = tokens.shape[0]
        fa.reset_launches()
        eager, eager_s = eager_serve(
            model.apply, params, torch.from_numpy(tokens).to(device),
            SERVE_REPS, device)
        eager_launches = {k: n // (SERVE_REPS + 1)
                          for k, n in fa.KERNEL_LAUNCHES.items()}
        err, scale, bitwise = compare_served(served.pop(name), eager)
        del eager
        served_ms = 1e3 * float(np.median(report[name]['seconds']))
        eager_ms = 1e3 * float(np.median(eager_s))
        rec['requests'][name] = dict(
            batch=b, max_abs_err=err, max_abs_logit=scale, bitwise=bitwise,
            served_ms=served_ms, eager_ms=eager_ms,
            served_tokens_per_s=b * seq / served_ms * 1e3,
            eager_tokens_per_s=b * seq / eager_ms * 1e3,
            served_launches=report[name]['flash_fwd'],
            eager_launches=eager_launches)
        require(err <= SERVE_REL * scale, 'served gpt_small logits at batch '
                '%d are %.4g from eager (largest %.4g)' % (b, err, scale))
        if cuda:
            require(report[name]['flash_fwd'] == want_kernel,
                    'served gpt_small ran %s a request, expected %s'
                    % (report[name]['flash_fwd'], want_kernel))
    if smi is not None:
        emit(card=smi, **rec)
    del model, params
    if cuda:
        torch.cuda.empty_cache()
    return rec


def serve_resnet_phase(model, batch, hw, device, tmp, train_launches=None,
                       smi=None):
    """``model`` in eval under ``AUTODIST_FUSED_CONV=1``, exported at a
    static batch (the fused gate branches on the row count, which a
    symbolic batch would meet as a guard), reloaded in a fresh process
    and served on one batch: the outputs within ``SERVE_REL`` of eager;
    on the card K4 runs through its custom operator, as many times a
    request as the eager forward launches it (``train_launches``: a
    training step's, for the record). Returns the record."""
    from autodist_tpu_torch.checkpoint.export import export_servable
    cuda = torch.device(device).type == 'cuda'
    set_fused_gate(True)

    def infer(params, images):
        with core.model_mode(training=False):
            return model.apply(params, images)
    params = model.params()
    bundle = os.path.join(tmp, 'resnet')
    t0 = time.perf_counter()
    export_servable(infer, params, [((batch, hw, hw, 3), np.float32)],
                    bundle)
    export_s = time.perf_counter() - t0
    images = make_images(batch, hw, 1000, seed=5)['images']
    report, served = serve_fresh(bundle, {'images': images}, device, tmp)
    cb.reset_launches()
    eager, eager_s = eager_serve(infer, params,
                                 torch.from_numpy(images).to(device),
                                 SERVE_REPS, device)
    eager_launches = cb.LAUNCHES['conv_bn'] // (SERVE_REPS + 1)
    set_fused_gate(False)
    err, scale, bitwise = compare_served(served['images'], eager)
    served_ms = 1e3 * float(np.median(report['images']['seconds']))
    eager_ms = 1e3 * float(np.median(eager_s))
    rec = dict(phase='serve_resnet101_fused', batch=batch, px=hw,
               static_batch=True, export_seconds=export_s,
               max_abs_err=err, max_abs_logit=scale, bitwise=bitwise,
               served_ms=served_ms, eager_ms=eager_ms,
               served_images_per_s=batch / served_ms * 1e3,
               eager_images_per_s=batch / eager_ms * 1e3,
               served_k4_launches=report['images']['conv_bn'],
               eager_k4_launches=eager_launches,
               train_step_k4_launches=train_launches,
               port_modules=report['port_modules'])
    if smi is not None:
        emit(card=smi, **rec)
    require(err <= SERVE_REL * scale, 'served ResNet logits are %.4g from '
            'eager (largest %.4g)' % (err, scale))
    if cuda:
        require(eager_launches > 0 and
                report['images']['conv_bn'] == eager_launches,
                'served ResNet launched K4 %s times a request, eager %d'
                % (report['images']['conv_bn'], eager_launches))
    del eager, served
    if cuda:
        torch.cuda.empty_cache()
    return rec


def _example(name):
    """``examples_torch/<name>.py`` as a module."""
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    return __import__(name)


def imagenet_records_phase(model, batch, hw, n_batches, steps, device, tmp,
                           synthetic_images_per_s=None, smi=None):
    """``n_batches`` batches of records (f32 NHWC images, int32 labels)
    written with ``write_records``, streamed by ``examples_torch/
    imagenet.py``'s ``record_stream`` through the native reader
    (``native=True``: a failed build fails the phase) into ``steps``
    fused training steps of ``model`` (sgd 0.1 momentum 0.9 under
    ``trainer_from_strategy(..., AllReduce())``): finite losses, images/s
    beside the synthetic arm's, each ``next`` of the stream timed; on the
    card K4 launches as in the synthetic arm. The files are removed at
    the end. Returns the record."""
    from autodist_tpu_torch.data.loader import write_records
    example = _example('imagenet')
    cuda = torch.device(device).type == 'cuda'
    data = tempfile.mkdtemp(dir=tmp)
    try:
        rng = np.random.RandomState(6)
        n = batch * n_batches
        t0 = time.perf_counter()
        write_records(os.path.join(data, 'images.records'),
                      rng.rand(n, hw, hw, 3).astype(np.float32))
        write_records(os.path.join(data, 'labels.records'),
                      rng.randint(0, model.head.out_dim, (n,))
                      .astype(np.int32))
        write_s = time.perf_counter() - t0
        set_fused_gate(True)
        trainer = trainer_from_strategy(model, optim.sgd(0.1, momentum=0.9),
                                        AllReduce())
        stream = example.record_stream(data, batch, hw, native=True)
        require(stream is not None, 'record_stream found no records')
        state = trainer.init(seed=0)
        cb.reset_launches()
        losses, waits, seconds = [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            b = next(stream)
            waits.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            state, m = trainer.step(state, b)
            losses.append(float(m['loss']))
            seconds.append(time.perf_counter() - t0)
        stream.close()
        launches = cb.LAUNCHES['conv_bn']
        set_fused_gate(False)
    finally:
        shutil.rmtree(data)
    step_s = float(np.median(seconds[1:]))
    wall_s = float(np.median(np.add(seconds, waits)[1:]))
    rec = dict(phase='imagenet_records', batch=batch, px=hw,
               record_bytes=hw * hw * 3 * 4, batches_written=n_batches,
               write_seconds=write_s, steps=steps, losses=losses,
               step_seconds=seconds, next_batch_ms=[1e3 * w for w in waits],
               images_per_s=batch / wall_s,
               images_per_s_step_only=batch / step_s,
               synthetic_images_per_s=synthetic_images_per_s,
               k4_launches=launches, files_removed=not os.path.exists(data))
    if smi is not None:
        emit(card=smi, **rec)
    require(all(math.isfinite(x) for x in losses),
            'ResNet loss from records not finite')
    require(rec['files_removed'], 'the record files were left behind')
    if cuda:
        require(launches == steps * RESNET_K4_PER_STEP,
                'ResNet-101 from records launched K4 %d times in %d steps'
                % (launches, steps))
    del trainer, state
    if cuda:
        torch.cuda.empty_cache()
    return rec


def functional_model_phase(device, smi=None):
    """``examples_torch/image_classifier.py``'s CNN (an unmodified
    ``torch.nn`` module through ``FunctionalModel`` and
    ``torch.func.functional_call``) under every builder through
    ``trainer_from_strategy`` on ``device``, ``FUNCTIONAL_STEPS`` Adam
    steps each from one init: the losses agree across the builders
    (one replica: the same step), and the first
    ``FUNCTIONAL_CPU_STEPS`` match the same run on the CPU. Returns the
    record."""
    example = _example('image_classifier')
    losses = {b: example.train(b, FUNCTIONAL_STEPS, device)
              for b in example.BUILDERS}
    cpu = example.train('AllReduce', FUNCTIONAL_CPU_STEPS, 'cpu')
    ref = losses['AllReduce']
    spread = max(abs(x - y) / abs(y) for run in losses.values()
                 for x, y in zip(run, ref))
    cpu_err = max(abs(x - y) / abs(y) for x, y in zip(ref, cpu))
    rec = dict(phase='functional_model', device=str(device),
               builders=list(losses), steps=FUNCTIONAL_STEPS,
               losses=losses, cpu_losses=cpu, builder_rel_spread=spread,
               cpu_rel_err=cpu_err)
    if smi is not None:
        emit(card=smi, **rec)
    require(all(math.isfinite(x) for run in losses.values() for x in run),
            'FunctionalModel loss not finite')
    require(spread <= FUNCTIONAL_BUILDER_REL, 'FunctionalModel losses differ '
            'across builders by %.3g relative' % spread)
    require(cpu_err <= FUNCTIONAL_CPU_REL, 'FunctionalModel on %s differs '
            'from the CPU by %.3g relative' % (device, cpu_err))
    return rec


def dsl_saved_model_phase(device, tmp, smi=None):
    """``examples_torch/serving.py`` end to end on ``device``: the DSL
    linear model under PSLoadBalancing, ``SavedModelBuilder``,
    ``load_servable``, three served predictions within the example's
    tolerance of the ground truth. Returns the record."""
    example = _example('serving')
    from autodist_tpu_torch import autodist as ad_mod
    ad_mod._DEFAULT_AUTODIST.clear()
    loss, out, want = example.run(os.path.join(tmp, 'dsl_saved_model'),
                                  device=device)
    err = float(np.abs(out - want).max())
    rec = dict(phase='dsl_saved_model', device=str(device), final_loss=loss,
               served=out[:, 0].tolist(), truth=want[:, 0].tolist(),
               max_abs_err=err, tol=example.TOLERANCE)
    if smi is not None:
        emit(card=smi, **rec)
    require(err < example.TOLERANCE, 'the served DSL model is %.4f from the '
            'ground truth' % err)
    return rec


# ---------------------------------------------------------------------------
# this slice's paths: sequence parallelism (ring and Ulysses) and sharded
# training state (ZeRO 2/3, strategy-partitioned variables)
# ---------------------------------------------------------------------------
# gpt_small at seq 4096, batch 4, sp 4 under Ulysses: a rank's q, k, v
# after the all-to-all are [b, h / sp, s, d]
ULYSSES_SHAPE = (4, 3, 4096, 64)
# the ring at the same width: each of 4 ranks holds a [4, 12, 1024, 64]
# slice of gpt_small's [4, 12, 4096, 64]
RING_SHAPE, RING_RANKS = (4, 12, 4096, 64), 4
# a rank's losses against the same steps on one card, bf16 (relative):
# the grid sums its tokens, gradients and attention in other orders
GRID_LOSS_REL = 1e-2
GRID_STEPS = 3
# the pipeline runs' limit (``pp_grid``): a stage splits no product, so
# a rank's losses follow one card's far closer than the grid's. Four
# cards read 8.2e-6 at most (pp 2 x tp 2), the same in three calls; a
# backward with one stage's block gradients dropped read 1.1e-4 at pp 4
# and 1.2e-3 at pp 2 x tp 2, one that left the shared leaves unsummed
# over the pipe group 1.5e-3 (PERF.md §6)
PP_LOSS_REL = 1e-4
# adamw's f32 state a trainable element holds after a step: the param,
# its gradient and the two slots (bytes)
STATE_BYTES = {'param': 4, 'grad': 4, 'slots': 8}


def ulysses_kernels_phase(smi):
    """K1-K3 at the shape Ulysses gives them (``ULYSSES_SHAPE``, bf16,
    causal) held against their plain versions and timed, then the
    Ulysses local attention at that shape through
    ``ulysses.ulysses_attention`` on one rank (a seq group of one: what
    each rank runs after the all-to-all), forward and backward, the
    counts set to 0 just before it. Returns (check_kernels' records,
    {kernel: launches})."""
    from autodist_tpu_torch.parallel import ulysses
    from autodist_tpu_torch.parallel.mesh import ReplicaGroup
    recs = check_kernels(ULYSSES_SHAPE, True, torch.bfloat16, True, smi)
    torch.cuda.empty_cache()
    gen = torch.Generator(device='cuda').manual_seed(3)
    q, k, v, do = (torch.randn(ULYSSES_SHAPE, generator=gen, device='cuda')
                   .to(torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fa.reset_launches()
    o = ulysses.ulysses_attention(q, k, v, ReplicaGroup(1, 0,
                                                        device='cuda'))
    o.backward(do)
    torch.cuda.synchronize()
    launches = {name: fa.KERNEL_LAUNCHES.get(recs[name]['cuda_kernel'], 0)
                for name in ('fwd', 'dq', 'dkv')}
    emit(phase='ulysses_kernels', shape=list(ULYSSES_SHAPE),
         dtype='bfloat16', causal=True, launches=launches,
         kernel_launches=dict(fa.KERNEL_LAUNCHES), card=smi,
         **{name: {key: recs[name][key] for key in (
             'cuda_kernel', 'max_abs_err', 'ms', 'plain_ms', 'library_ms',
             'bound_ms', 'bound_by')} for name in recs})
    require(launches == {'fwd': 1, 'dq': 1, 'dkv': 1},
            'the Ulysses local attention at %s launched %s'
            % (ULYSSES_SHAPE, launches))
    del q, k, v, do, o
    torch.cuda.empty_cache()
    return recs, launches


def ring_visits(my, n):
    """The owners of the K/V blocks rank ``my`` merges, in the order the
    ring brings them."""
    return [(my - step) % n for step in range(n)]


def ring_blocks(q, k, v, n, causal=True):
    """Each of ``n`` ranks' output slice by the ring's block-and-merge
    (``ring_attention.merge_blocks``) over the ``n`` blocks of the full
    q, k, v [B, H, S, D], in that rank's visit order; concatenated."""
    from autodist_tpu_torch.parallel.ring_attention import merge_blocks
    qs, ks, vs = (t.chunk(n, dim=2) for t in (q, k, v))
    return torch.cat([merge_blocks(qs[my], [(o, ks[o], vs[o])
                                            for o in ring_visits(my, n)],
                                   my, causal)
                      for my in range(n)], dim=2)


def ring_blocks_phase(smi, shape=RING_SHAPE, n=RING_RANKS,
                      dtype=torch.bfloat16, device='cuda'):
    """The ring's block-and-merge for each of ``n`` ranks over the blocks
    of ``shape`` (gpt_small's attention at seq 4096, bf16, causal), held
    against ``local_flash_attention`` over the whole sequence (bf16
    output: within two bf16 ulps of the largest output, as the flash
    kernels' O is held), with the device time of one hop's block and
    merge on the card. Returns the record."""
    from autodist_tpu_torch.parallel.ring_attention import (
        _block_attn, _merge, causal_mask, local_flash_attention)
    gen = torch.Generator(device=device).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=device)
               .to(dtype) for _ in range(3))
    got = ring_blocks(q, k, v, n)
    want = local_flash_attention(q, k, v, causal=True)
    err, ok = max_err(got, want, TOL[dtype]['o'])
    rec = {'phase': 'ring_blocks', 'shape': list(shape), 'ranks': n,
           'block_shape': [shape[0], shape[1], shape[2] // n, shape[3]],
           'dtype': str(dtype).replace('torch.', ''), 'causal': True,
           'max_abs_err': err, 'tol': list(TOL[dtype]['o']), 'ok': ok,
           'visits': {my: ring_visits(my, n) for my in range(n)},
           'hop_bytes': 2 * q.numel() // n * q.element_size(),
           'card': smi}
    if device == 'cuda':
        c = shape[2] // n
        qs, ks, vs = (t[:, :, c:2 * c] for t in (q, k, v))
        mask = causal_mask(1, 0, c, device)
        acc, m, l = _block_attn(qs, ks, vs, mask, shape[3] ** -0.5)
        rec['hop_compute_ms'] = cuda_ms(lambda: _merge(
            acc, m, l, *_block_attn(qs, ks, vs, mask, shape[3] ** -0.5)), 5)
    emit(**rec)
    require(ok, 'ring block-and-merge disagrees with local attention over '
            'the whole sequence: %g' % err)
    return rec


def grid_state_bytes(dims, numels, n, sizes=None):
    """Predicted adamw state bytes a rank holds after a step (params,
    gradients, slots) from each leaf's element count and shard dims
    (``Trainer.state_sharding``): a leaf the model or expert group
    splits (``dims['groups']``, over the grid's ``sizes``) counts its
    shard; then a leaf the data group leaves replicated holds them
    whole; a zero-2 leaf its param plus a slice's param, gradient and
    slots; a held leaf (zero 3, partitioned) a slice of all four."""
    per = sum(STATE_BYTES.values())
    total = 0
    for name, count in numels.items():
        for axis in dims.get('groups', {}).get(name, {}):
            count //= sizes[axis]
        param_dim, slot_dim = dims['params'][name], dims['opt_state'][name]
        if slot_dim is None:
            total += per * count
        elif param_dim is None:
            total += STATE_BYTES['param'] * count + per * count // n
        else:
            total += per * count // n
    return total


def settled_bytes(device):
    """Device bytes allocated once a step's deferred frees have landed:
    a buffer a collective used is released only after its stream's work
    completes (the allocator frees it at a later call, the NCCL watchdog
    when it next polls), so synchronize, collect, and read until two
    readings 0.2 s apart agree (at most 2 s)."""
    torch.cuda.synchronize(device)
    gc.collect()
    last = None
    for _ in range(10):
        torch.empty(1, device=device)   # the allocator processes events
        now = torch.cuda.memory_allocated(device)
        if now == last:
            break
        last = now
        time.sleep(0.2)
    return now


def requested_bytes(device):
    """The bytes the live tensors on ``device`` asked the caching
    allocator for (``memory_allocated`` counts the blocks it handed
    out, which may be larger)."""
    return torch.cuda.memory_stats(device)['requested_bytes.all.current']


# what a rank may hold after a step beyond its predicted state: the step's
# batch on the card (tokens and targets, int32), its scalars (the loss and
# its metrics, the optimizer's step counts; STEP_SCALAR_BYTES), and the
# caching allocator's slack: a block of its large pool (over 1 MiB) is
# handed out whole when a split would leave less than 1 MiB, so each live
# large block may hold up to LARGE_SLACK_BYTES beyond what its tensor
# asked for, and the small pool rounds each request up to 512 bytes
STEP_SCALAR_BYTES = 64 << 10
LARGE_SLACK_BYTES = 1 << 20
SMALL_SLACK_BYTES = 512


def step_input_bytes(batch):
    """Bytes a step's tensors may ask for beyond the state: ``batch``
    (host arrays) whole on the card, and the scalars."""
    return sum(v.nbytes for v in batch.values()) + STEP_SCALAR_BYTES


def check_state_bytes(name, rec):
    """A rank's memory after a step (``grid_run``'s record ``rec``): the
    bytes its tensors asked for do not grow from the first step to the
    last and exceed the predicted state by the step's inputs at most;
    the bytes the card holds exceed it by the inputs and the
    allocator's slack (``state_margin_bytes``) at most."""
    asked = rec['state_requested_by_step']
    want = rec['predicted_state_bytes']
    require(asked[-1] <= asked[0], '%s: the step\'s tensors grew from %d to '
            '%d bytes between the first and the last step'
            % (name, asked[0], asked[-1]))
    require(asked[-1] <= want + rec['step_input_bytes'],
            '%s: the tensors asked for %d bytes after a step, predicted %d '
            '+ the inputs %d' % (name, asked[-1], want,
                                 rec['step_input_bytes']))
    require(rec['state_bytes'] <= want + rec['state_margin_bytes'],
            '%s: %d bytes a card after a step, predicted %d + a margin of '
            '%d' % (name, rec['state_bytes'], want,
                    rec['state_margin_bytes']))


def grid_run(run, device, world=1):
    """One configuration of ``grid_trainers`` on this rank: a
    ``TransformerLM`` of ``run['cfg']`` from seed 0 through ``Trainer``
    (or ``trainer_from_strategy(PartitionedPS())`` over a spec of one PS
    device per rank, so it partitions), ``run['steps']`` adamw steps on
    one batch. Returns losses, step seconds, tokens/s of the grid, peak
    memory, the settled memory after each step (held, and asked for by
    the tensors), what the cuBLAS set-up added, the predicted state
    bytes and the launches."""
    cfg = TransformerConfig(**dict(run['cfg'], dtype=getattr(
        torch, run['cfg']['dtype'])))
    cuda = device.startswith('cuda')
    if cuda:
        # cuBLAS keeps a workspace for each handle (one a thread) and
        # stream from its first product on, and the backward runs on the
        # autograd engine's thread: a product forward and backward sets up
        # both, so they count in the base and not as the first run's state
        before = settled_bytes(device)
        a = torch.ones(8, 8, device=device, requires_grad=True)
        (a @ a).sum().backward()
        del a
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = settled_bytes(device)
        base_asked = requested_bytes(device)
    model = TransformerLM(cfg, device=device, seed=0)
    numels = {'/'.join(p): t.numel() for p, t in _flat_leaves(model)
              if isinstance(t, torch.nn.Parameter)}
    spec = ParallelSpec(**run['spec'])
    opt = optim.adamw(run['lr'])
    if run.get('builder'):
        from autodist_tpu_torch.resource_spec import ResourceSpec
        rs = ResourceSpec(resource_info={'nodes': [{
            'address': 'localhost', 'chief': True,
            'cpus': list(range(world)), 'gpus': list(range(world)),
            'network_bandwidth': 100}]})
        trainer = trainer_from_strategy(model, opt, PartitionedPS(),
                                        resource_spec=rs, spec=spec)
    else:
        trainer = Trainer(model, opt, spec=spec)
    batch = make_batch(cfg.vocab, run['batch'], run['seq'], seed=1)
    by_step = []

    def read():
        if cuda:
            end = torch.cuda.memory_allocated(device) - base
            held = settled_bytes(device) - base
            stats = torch.cuda.memory_stats(device)
            by_step.append((end, held, requested_bytes(device) - base_asked,
                            stats['active.large_pool.current'],
                            stats['active.small_pool.current']))
    fa.reset_launches()
    state, losses, seconds = train_steps(trainer, batch, run['steps'],
                                         after_step=read)
    launches = dict(fa.KERNEL_LAUNCHES)
    dims = trainer.state_sharding()
    step_s = float(np.median(seconds[1:])) if len(seconds) > 1 \
        else seconds[0]
    rec = {'losses': losses, 'step_seconds': seconds,
           'tokens_per_s': run['batch'] * run['seq'] / step_s,
           'launches': launches,
           'sharded_leaves': sum(d is not None
                                 for d in dims['opt_state'].values()),
           'predicted_state_bytes': grid_state_bytes(
               dims, numels, trainer.dp, trainer.grid.shape)}
    if cuda:
        end, held, asked, large, small = by_step[-1]
        rec.update(cublas_setup_bytes=base - before,
                   state_bytes_at_step_end=end, state_bytes=held,
                   state_requested_bytes=asked, state_blocks=[large, small],
                   state_requested_by_step=[r[2] for r in by_step],
                   step_input_bytes=step_input_bytes(batch),
                   state_margin_bytes=step_input_bytes(batch) +
                   LARGE_SLACK_BYTES * large + SMALL_SLACK_BYTES * small,
                   peak_mem_bytes=torch.cuda.max_memory_allocated() - base)
    if run.get('params'):
        rec['params'] = {k: v.tolist() for k, v in _flat_params(
            trainer.get_params(state)).items()}
    del trainer, state, model
    return rec


def _flat_leaves(model):
    from autodist_tpu_torch.models.weights import flatten_tree
    return flatten_tree(model.params())


def _flat_params(tree):
    from autodist_tpu_torch.models.weights import flatten_tree
    return {'/'.join(p): np.asarray(v) for p, v in flatten_tree(tree)}


def grid_worker(args):
    """One rank of ``grid_trainers`` (``chip_smoke.py --grid-worker
    JSON``): joins the group (NCCL on the card, gloo on the CPU), runs
    every configuration of ``args['runs']`` and writes its records to
    ``<out>/rank<r>.json``."""
    import torch.distributed as dist
    rank, world = int(args['rank']), int(args['world'])
    device = args['device']
    if device == 'cuda':
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = 'cuda:%d' % rank
    dist.init_process_group('nccl' if device.startswith('cuda') else 'gloo',
                            init_method='tcp://127.0.0.1:%d' % args['port'],
                            world_size=world, rank=rank)
    try:
        out = {run['name']: grid_run(run, device, world)
               for run in args['runs']}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(args['out'], 'rank%d.json' % rank), 'w') as f:
        json.dump(out, f)
    return 0


def launch_grid(runs, world, device, out, timeout=900):
    """Run ``runs`` on a grid of ``world`` worker processes (one a card
    on the card); returns each rank's records."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--grid-worker',
         json.dumps({'rank': r, 'world': world, 'port': port,
                     'device': device, 'out': out, 'runs': runs})],
        env=dict(os.environ, OMP_NUM_THREADS='1'))
        for r in range(world)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    require(rcs == [0] * world, 'grid workers exited %s' % rcs)
    recs = []
    for r in range(world):
        with open(os.path.join(out, 'rank%d.json' % r)) as f:
            recs.append(json.load(f))
    return recs


def grid_configs(n, seq=4096, batch=4, zero_seq=1024, dim=768, layers=12,
                 heads=12, vocab=32000, steps=GRID_STEPS):
    """The ``grid_trainers`` runs over ``n`` ranks and their one-card
    references: gpt_small (bf16, remat) at seq 4096, batch 4 under ring
    and under Ulysses at sp = n; zero 1, 2, 3 and PartitionedPS at
    dp = n, batch 4 a rank at seq 1024 (gpt_small's own max_len).
    Returns (runs, {run name: its reference run})."""
    def cfg(max_len):
        return dict(vocab=vocab, dim=dim, n_layers=layers, n_heads=heads,
                    max_len=max_len, causal=True, dtype='bfloat16',
                    remat=True)
    seq_run = dict(cfg=cfg(seq), seq=seq, batch=batch, lr=1e-4,
                   steps=steps)
    dp_run = dict(cfg=cfg(zero_seq), seq=zero_seq, batch=batch * n, lr=1e-4,
                  steps=steps)
    runs = [dict(seq_run, name=mode, spec=dict(sp=n, sp_mode=mode))
            for mode in ('ring', 'ulysses')]
    runs += [dict(dp_run, name='zero%d' % z, spec=dict(dp=n, zero=z))
             for z in (1, 2, 3)]
    runs.append(dict(dp_run, name='partitioned_ps', spec=dict(dp=n),
                     builder='PartitionedPS'))
    refs = {'ring': 'one_card_seq', 'ulysses': 'one_card_seq'}
    refs.update({r['name']: 'one_card_dp' for r in runs[2:]})
    one = [dict(seq_run, name='one_card_seq', spec={}),
           dict(dp_run, name='one_card_dp', spec={})]
    return runs, refs, one


def grid_report(runs, refs, ranks, single, n, smi, phase='grid_trainers',
                tol=GRID_LOSS_REL):
    """One JSON line a grid run: its tokens/s, peak and after-step memory
    per card, the predicted state bytes, and each rank's losses against
    its one-card reference's (relative, within ``tol``). Returns the
    records."""
    out = {}
    for run in runs:
        name = run['name']
        want = single[refs[name]]['losses']
        recs = [r[name] for r in ranks]
        rel = max(abs(a - b) / abs(b) for rec in recs
                  for a, b in zip(rec['losses'], want))
        rec = {'phase': phase, 'run': name, 'cards': n,
               'spec': run['spec'], 'seq': run['seq'],
               'batch': run['batch'], 'losses': recs[0]['losses'],
               'one_card_losses': want, 'max_rel_loss_diff': rel,
               'tol': tol,
               'tokens_per_s': recs[0]['tokens_per_s'],
               'one_card_tokens_per_s': single[refs[name]]['tokens_per_s'],
               'launches': recs[0]['launches'],
               'sharded_leaves': recs[0]['sharded_leaves'],
               'predicted_state_bytes': recs[0]['predicted_state_bytes'],
               'card': smi}
        for key in ('cublas_setup_bytes', 'state_bytes',
                    'state_requested_bytes', 'state_margin_bytes',
                    'peak_mem_bytes'):
            if key in recs[0]:
                rec[key] = max(r[key] for r in recs)
        emit(**rec)
        require(all(math.isfinite(x) for r in recs for x in r['losses']),
                'grid run %s: a loss is not finite' % name)
        require(rel <= tol, 'grid run %s: losses %s against one card %s'
                % (name, recs[0]['losses'], want))
        out[name] = rec
    return out


def grid_trainers_phase(smi, device='cuda', n=None, tmp=None, **sizes):
    """The (data, seq) grid through ``Trainer`` over min(4, cards) NCCL
    processes, one a card (``grid_configs``), each run's losses against
    the same steps on one card. Prints that it did not run on fewer than
    two cards. Returns {run: record}, or None when it did not run."""
    if n is None:
        count = torch.cuda.device_count()
        if count < 2:
            emit(phase='grid_trainers', ran=False, cards=count,
                 reason='needs two or more cards; did not run on one card',
                 card=smi)
            return None
        n = min(4, count)
    runs, refs, one = grid_configs(n, **sizes)
    single = {}
    for run in one:
        dev = 'cuda:0' if device == 'cuda' else device
        single[run['name']] = grid_run(run, dev)
        if device == 'cuda':
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=tmp) as out:
        ranks = launch_grid(runs, n, device, out)
    emit(phase='grid_trainers', ran=True, cards=n, card=smi)
    return grid_report(runs, refs, ranks, single, n, smi)


# tensor and expert parallelism over the cards: gpt_small at seq 4096,
# batch 4 (bf16, remat) at tp = n, where each rank runs 12 / n heads; the
# MoE arm (8 experts, top 2, capacity factor 2.0) at the same seq, batch
# and remat at ep = n; and with four cards the MoE arm at ep 2 x tp 2 and
# gpt_small at seq 1024, batch 4 a data rank, tp 2 x dp 2 under zero 3.
# A rank's K1-K3 launches a step under remat: two forwards (the block and
# its recompute), one dQ and one dK/dV a layer.
TP_LAUNCHES_PER_LAYER = {'fwd': 2, 'dq': 1, 'dkv': 1}


def tp_ep_configs(n, seq=4096, batch=4, dp_seq=1024, dim=768, layers=12,
                  heads=12, vocab=32000, experts=8, steps=GRID_STEPS):
    """The ``tp_ep_grid`` runs over ``n`` ranks and their one-card
    references (see above). Returns (runs, {run name: its reference},
    the one-card runs)."""
    def cfg(max_len, **kw):
        return dict(vocab=vocab, dim=dim, n_layers=layers, n_heads=heads,
                    max_len=max_len, causal=True, dtype='bfloat16',
                    remat=True, **kw)
    moe = dict(moe_experts=experts, moe_top_k=2)
    seq_run = dict(cfg=cfg(seq), seq=seq, batch=batch, lr=1e-4, steps=steps)
    moe_run = dict(seq_run, cfg=cfg(seq, **moe))
    runs = [dict(seq_run, name='tp', spec=dict(tp=n)),
            dict(moe_run, name='ep', spec=dict(ep=n))]
    refs = {'tp': 'one_card_seq', 'ep': 'one_card_moe'}
    one = [dict(seq_run, name='one_card_seq', spec={}),
           dict(moe_run, name='one_card_moe', spec={})]
    if n == 4:
        dp_run = dict(cfg=cfg(dp_seq), seq=dp_seq, batch=batch * 2, lr=1e-4,
                      steps=steps)
        runs += [dict(moe_run, name='ep_tp', spec=dict(ep=2, tp=2)),
                 dict(dp_run, name='tp_dp', spec=dict(tp=2, dp=2, zero=3))]
        refs.update(ep_tp='one_card_moe', tp_dp='one_card_tp_dp')
        one.append(dict(dp_run, name='one_card_tp_dp', spec={}))
    return runs, refs, one


def tp_ep_grid_phase(smi, device='cuda', n=None, tmp=None, single=None,
                     **sizes):
    """Tensor and expert parallelism through ``Trainer`` over min(4,
    cards) NCCL processes, one a card (``tp_ep_configs``): each run's
    losses within ``GRID_LOSS_REL`` of the same steps on one card
    (``single`` may hold one-card runs already made, by name), its
    tokens/s, and its memory a card after a step and at peak against the
    predicted state bytes. On the card every rank of the ``tp`` run must
    launch K1-K3 at [b, h / n, s, d] as many times as the layers ask, by
    the CUDA kernel the head dim routes to, and every rank's memory
    after each step must pass ``check_state_bytes``. Prints that it did not run on fewer than two cards. Returns
    {run: record}, or None when it did not run."""
    if n is None:
        count = torch.cuda.device_count()
        if count < 2:
            emit(phase='tp_ep_grid', ran=False, cards=count,
                 reason='needs two or more cards; did not run on one card',
                 card=smi)
            return None
        n = min(4, count)
    runs, refs, one = tp_ep_configs(n, **sizes)
    single = dict(single or {})
    for run in one:
        if run['name'] in single:
            continue
        dev = 'cuda:0' if device == 'cuda' else device
        single[run['name']] = grid_run(run, dev)
        if device == 'cuda':
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=tmp) as out:
        ranks = launch_grid(runs, n, device, out)
    emit(phase='tp_ep_grid', ran=True, cards=n, card=smi)
    out = grid_report(runs, refs, ranks, single, n, smi, phase='tp_ep_grid')
    for run in runs:
        for r, rank in enumerate(ranks):
            if 'state_bytes' in rank[run['name']]:
                check_state_bytes('tp_ep_grid run %s rank %d'
                                  % (run['name'], r), rank[run['name']])
    cfg = runs[0]['cfg']
    d = cfg['dim'] // cfg['n_heads']
    local = (runs[0]['batch'], cfg['n_heads'] // n, runs[0]['seq'], d)
    if device == 'cuda' and fa.preferred(local):
        want = {fa.kernel_name(k, torch.bfloat16, d):
                runs[0]['steps'] * cfg['n_layers'] * c
                for k, c in TP_LAUNCHES_PER_LAYER.items()}
        got = [r['tp']['launches'] for r in ranks]
        require(all(g == want for g in got),
                'tp_ep_grid tp: the ranks launched %s, expected %s at %s'
                % (got, want, local))
    return out


def grid_phases(smi):
    """``grid_trainers``, then ``tp_ep_grid`` (its ``tp`` run's one-card
    reference is grid_trainers' seq run: the same configuration, init and
    batch), then ``pp_grid``. Returns the three results (None where a
    phase did not run)."""
    grid = grid_trainers_phase(smi)
    torch.cuda.empty_cache()
    single = None
    if grid is not None:
        single = {'one_card_seq': {
            'losses': grid['ring']['one_card_losses'],
            'tokens_per_s': grid['ring']['one_card_tokens_per_s']}}
    tp = tp_ep_grid_phase(smi, single=single)
    torch.cuda.empty_cache()
    pp = pp_grid_phase(smi)
    torch.cuda.empty_cache()
    return grid, tp, pp


def ulysses_rows(uly_recs, uly_launches, grid, tp):
    """K1-K3's rows of the ``kernels`` line at the Ulysses shape: the
    one-rank local attention's launches, and with four cards the grid's
    Ulysses run's and ``tp_ep_grid``'s tp run's, whose ranks run 3 heads
    each at that shape (three steps each)."""
    rows = []
    for name in ('fwd', 'dq', 'dkv'):
        rec = uly_recs[name]
        by_path = {'ulysses_local_attention': uly_launches[name]}
        if grid is not None and grid['ulysses']['cards'] == RING_RANKS:
            by_path['grid_trainers_ulysses'] = grid['ulysses'][
                'launches'].get(rec['cuda_kernel'], 0)
        if tp is not None and tp['tp']['cards'] == RING_RANKS:
            by_path['tp_ep_grid_tp'] = tp['tp']['launches'].get(
                rec['cuda_kernel'], 0)
        row = flash_row(name, rec, by_path.get('grid_trainers_ulysses',
                                                uly_launches[name]),
                        ULYSSES_SHAPE, '_ulysses')
        row['launches_by_path'] = by_path
        rows.append(row)
    return rows


# the pipeline's microbatch: gpt_small at seq 4096, batch 8 in 4
# microbatches gives every stage K1-K3 at [2, 12, 4096, 64]; a stage at
# pp 4 holds 3 of the 12 layers
PIPELINE_SHAPE = (2, 12, 4096, 64)
PIPELINE_STAGE_LAYERS = 3


def pipeline_kernels_phase(smi, device='cuda', shape=PIPELINE_SHAPE,
                           layers=PIPELINE_STAGE_LAYERS):
    """K1-K3 at the pipeline's microbatch shape (``shape``, bf16, causal)
    held against their plain versions and timed (on the card), then the
    ``layers`` one stage holds (gpt_small's width at ``shape``, remat) on
    one microbatch through ``pipeline.run_stack``, forward and backward,
    the counts set to 0 just before it: on the card each layer launches
    K1-K3 2 / 1 / 1 times, on the CPU (the plain versions) none. Returns
    (check_kernels' records or None, {kernel: launches})."""
    from autodist_tpu_torch.parallel import pipeline
    cuda = device == 'cuda'
    recs = check_kernels(shape, True, torch.bfloat16, True, smi) \
        if cuda else None
    b, h, s, d = shape
    model = TransformerLM(TransformerConfig.gpt_small(
        dtype=torch.bfloat16, remat=True, max_len=s, dim=h * d, n_heads=h,
        n_layers=layers), device=device, seed=0)
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn((b, s, h * d), generator=gen, device=device).to(
        torch.bfloat16).requires_grad_()
    fa.reset_launches()
    with core.model_mode():
        y, _ = pipeline.run_stack(model._block_fn, model.params()['blocks'],
                                  x)
        y.float().square().mean().backward()
    if cuda:
        torch.cuda.synchronize()
    if cuda:
        launches = {name: fa.KERNEL_LAUNCHES.get(recs[name]['cuda_kernel'],
                                                 0)
                    for name in ('fwd', 'dq', 'dkv')}
    else:
        launches = {name: fa.LAUNCHES.get(name, 0)
                    for name in ('fwd', 'dq', 'dkv')}
    want = {k: layers * c if cuda else 0
            for k, c in TP_LAUNCHES_PER_LAYER.items()}
    finite = bool(torch.isfinite(x.grad).all())
    emit(phase='pipeline_kernels', shape=list(shape), dtype='bfloat16',
         causal=True, stage_layers=layers, launches=launches,
         kernel_launches=dict(fa.KERNEL_LAUNCHES), finite=finite, card=smi,
         **{name: {key: recs[name][key] for key in (
             'cuda_kernel', 'max_abs_err', 'ms', 'plain_ms', 'library_ms',
             'bound_ms', 'bound_by')} for name in recs or {}})
    require(launches == want, 'the stage at %s launched %s, expected %s'
            % (shape, launches, want))
    require(finite, 'the stage\'s input gradient is not finite')
    del model, x, y
    if cuda:
        torch.cuda.empty_cache()
    return recs, launches


# K1-K3 launches a microbatch a layer on a rank under a remat
# configuration (each block checkpointed): GPipe runs the block forward,
# then recomputes it in the backward before dQ and dK/dV; each 1F1B
# variant runs one forward without a graph first and the stage again
# with its graph in the backward (the remat variant's chain forward, the
# stash variant's recompute from the stash), so one forward more
PP_LAUNCHES_PER_LAYER = {'gpipe': {'fwd': 2, 'dq': 1, 'dkv': 1},
                         '1f1b': {'fwd': 3, 'dq': 1, 'dkv': 1}}


def pp_launches(run):
    """{kernel: launches} a rank of ``run`` (a ``pp_configs`` run) makes
    over its steps: its stage's layers (n_layers / pp) x microbatches x
    ``PP_LAUNCHES_PER_LAYER`` of its schedule x steps."""
    spec, cfg = run['spec'], run['cfg']
    per = PP_LAUNCHES_PER_LAYER[spec.get('pp_schedule', 'gpipe')]
    n = cfg['n_layers'] // spec['pp'] * spec['microbatches'] * run['steps']
    return {k: n * c for k, c in per.items()}


def pp_configs(n, seq=4096, batch=8, microbatches=4, mem_seq=1024,
               mem_batch=32, mem_microbatches=16, dim=768, layers=12,
               heads=12, vocab=32000, steps=GRID_STEPS):
    """The ``pp_grid`` runs over ``n`` ranks and their one-card
    references: gpt_small (bf16, remat) at seq 4096, batch 8, 4
    microbatches at pp = n under GPipe, 1F1B stash and 1F1B remat; with
    four cards also pp 2 x tp 2 (1F1B auto) and the memory pair (seq
    1024, batch 32, 16 microbatches, pp 4, GPipe and 1F1B remat).
    Returns (runs, {run name: its reference}, the one-card runs)."""
    def cfg(max_len):
        return dict(vocab=vocab, dim=dim, n_layers=layers, n_heads=heads,
                    max_len=max_len, causal=True, dtype='bfloat16',
                    remat=True)

    def pp(size, m, schedule, variant='auto', **kw):
        return dict(pp=size, microbatches=m, pp_schedule=schedule,
                    pp_variant=variant, **kw)
    seq_run = dict(cfg=cfg(seq), seq=seq, batch=batch, lr=1e-4, steps=steps)
    runs = [dict(seq_run, name='gpipe', spec=pp(n, microbatches, 'gpipe')),
            dict(seq_run, name='1f1b_stash',
                 spec=pp(n, microbatches, '1f1b', 'stash')),
            dict(seq_run, name='1f1b_remat',
                 spec=pp(n, microbatches, '1f1b', 'remat'))]
    refs = {r['name']: 'one_card_pp' for r in runs}
    one = [dict(seq_run, name='one_card_pp', spec={})]
    if n == 4:
        mem_run = dict(cfg=cfg(mem_seq), seq=mem_seq, batch=mem_batch,
                       lr=1e-4, steps=steps)
        runs += [dict(seq_run, name='pp2_tp2',
                      spec=pp(2, microbatches, '1f1b', tp=2)),
                 dict(mem_run, name='mem_gpipe',
                      spec=pp(4, mem_microbatches, 'gpipe')),
                 dict(mem_run, name='mem_1f1b_remat',
                      spec=pp(4, mem_microbatches, '1f1b', 'remat'))]
        refs.update(pp2_tp2='one_card_pp', mem_gpipe='one_card_mem',
                    mem_1f1b_remat='one_card_mem')
        one.append(dict(mem_run, name='one_card_mem', spec={}))
    return runs, refs, one


def pp_grid_phase(smi, device='cuda', n=None, tmp=None, **sizes):
    """Pipeline parallelism through ``Trainer`` over min(4, cards) NCCL
    processes, one a card (``pp_configs``): each run's losses within
    ``PP_LOSS_REL`` of the same steps on one card, its tokens/s and the
    peak memory a card. On the card every rank of every run must launch
    K1-K3 exactly ``pp_launches(run)`` times by the CUDA kernel its
    microbatch's head dim routes to, and with four cards the memory
    pair's 1F1B remat must peak below GPipe on every card. Prints that it
    did not run on fewer than two cards. Returns {run: record}, or None
    when it did not run."""
    if n is None:
        count = torch.cuda.device_count()
        if count < 2:
            emit(phase='pp_grid', ran=False, cards=count,
                 reason='needs two or more cards; did not run on one card',
                 card=smi)
            return None
        n = min(4, count)
    runs, refs, one = pp_configs(n, **sizes)
    single = {}
    for run in one:
        dev = 'cuda:0' if device == 'cuda' else device
        single[run['name']] = grid_run(run, dev)
        if device == 'cuda':
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=tmp) as out:
        ranks = launch_grid(runs, n, device, out)
    emit(phase='pp_grid', ran=True, cards=n, card=smi)
    out = grid_report(runs, refs, ranks, single, n, smi, phase='pp_grid',
                      tol=PP_LOSS_REL)
    for run in runs:
        name, cfg = run['name'], run['cfg']
        per_rank = [rank[name] for rank in ranks]
        out[name]['launches_by_rank'] = [r['launches'] for r in per_rank]
        out[name]['launches_expected'] = pp_launches(run)
        if 'peak_mem_bytes' in per_rank[0]:
            out[name]['peak_mem_bytes_by_rank'] = [r['peak_mem_bytes']
                                                   for r in per_rank]
        d = cfg['dim'] // cfg['n_heads']
        local = (run['batch'] // run['spec']['microbatches'],
                 cfg['n_heads'] // run['spec'].get('tp', 1), run['seq'], d)
        if device == 'cuda' and fa.preferred(local):
            want = {fa.kernel_name(k, torch.bfloat16, d): c
                    for k, c in pp_launches(run).items()}
            got = [r['launches'] for r in per_rank]
            require(all(g == want for g in got),
                    'pp_grid %s: the ranks launched %s, expected %s at %s'
                    % (name, got, want, local))
    if 'mem_gpipe' in out and 'peak_mem_bytes_by_rank' in out['mem_gpipe']:
        gpipe = out['mem_gpipe']['peak_mem_bytes_by_rank']
        remat = out['mem_1f1b_remat']['peak_mem_bytes_by_rank']
        emit(phase='pp_grid', run='memory_pair', cards=n,
             gpipe_peak_bytes=gpipe, remat_peak_bytes=remat,
             ratio=[r / g for r, g in zip(remat, gpipe)], card=smi)
        require(all(r < g for r, g in zip(remat, gpipe)),
                'pp_grid: 1F1B remat peaked at %s bytes a card, GPipe at %s'
                % (remat, gpipe))
    return out


def pipeline_rows(pk_recs, pk_launches, pp):
    """K1-K3's rows of the ``kernels`` line at the pipeline's microbatch
    shape: the stage's launches, and with two or more cards each
    ``pp_grid`` run's at that shape (rank 0's, over its steps)."""
    rows = []
    for name in ('fwd', 'dq', 'dkv'):
        rec = pk_recs[name]
        by_path = {'pipeline_stage': pk_launches[name]}
        for run in ('gpipe', '1f1b_stash', '1f1b_remat'):
            if pp is not None:
                by_path['pp_grid_' + run] = pp[run]['launches'].get(
                    rec['cuda_kernel'], 0)
        row = flash_row(name, rec, by_path.get('pp_grid_gpipe',
                                                pk_launches[name]),
                        PIPELINE_SHAPE, '_pipeline')
        row['launches_by_path'] = by_path
        rows.append(row)
    return rows


def main(argv):
    if argv[:1] == ['--loose-worker']:
        return loose_worker(json.loads(argv[1]))
    if argv[:1] == ['--elastic-worker']:
        return elastic_worker(json.loads(argv[1]))
    if argv[:1] == ['--launch-run']:
        return launch_worker(json.loads(argv[1]))
    if argv[:1] == ['--grid-worker']:
        return grid_worker(json.loads(argv[1]))
    profiling = '--profile' in argv
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit(phase='device', nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=False)

    t0 = time.time()
    build.build_all([fa.SOURCE, cb.SOURCE, xe.SOURCE])
    emit(phase='build', sources=[SOURCE, CB_SOURCE, XE_SOURCE],
         seconds=time.time() - t0,
         ptxas=dict(ptxas_summary(build.build_log(fa.SOURCE)),
                    **ptxas_summary(build.build_log(cb.SOURCE)),
                    **ptxas_summary(build.build_log(xe.SOURCE))),
         dynamic_smem_bytes=wgmma_smem(fa.load_library(),
                                       cb.load_library()))

    results = {}
    for shape, causal in ((GPT_SHAPE, True), (BERT_SHAPE, False)):
        for dtype in (torch.float32, torch.bfloat16):
            rec = check_kernels(shape, causal, dtype, dtype == torch.bfloat16,
                                smi)
            results[(shape, causal, dtype)] = rec
            torch.cuda.empty_cache()
    for shape, causal in ((GPT_SHAPE, False), (BERT_SHAPE, True)):
        check_kernels(shape, causal, torch.bfloat16, False, smi)
        torch.cuda.empty_cache()
    for shape in (GPT_D256_SHAPE, GPT_D384_SHAPE):
        results[(shape, True, torch.bfloat16)] = check_kernels(
            shape, True, torch.bfloat16, True, smi)
        torch.cuda.empty_cache()
    flash_head_dims(smi)
    dkv_head_dims(smi)

    # this slice's paths: K1-K3 at the shape Ulysses gives them, the
    # ring's block-and-merge, and the (data, seq) grid across the cards
    uly_recs, uly_launches = ulysses_kernels_phase(smi)
    ring_blocks_phase(smi)
    torch.cuda.empty_cache()
    # this slice's path: K1-K3 at the pipeline's microbatch shape, and the
    # pipeline's schedules across the cards (in grid_phases)
    pk_recs, pk_launches = pipeline_kernels_phase(smi)
    grid, tp, pp = grid_phases(smi)

    k4 = [check_conv_bn(shape, torch.bfloat16, smi) for shape in RESNET_K4]
    for shape in K4_F32:
        check_conv_bn(shape, torch.float32, smi)
    torch.cuda.empty_cache()

    # the LM head's cross-entropy pair at the TransformerLM phases' shapes
    xe_recs = {}
    for shape_name, (rows, vocab) in XE_SHAPES.items():
        xe_recs[shape_name] = check_cross_entropy(rows, vocab, smi)
        torch.cuda.empty_cache()

    small_reference()
    small_reference(dim=768, n_heads=2, n_layers=1)   # head dim 384
    small_moe_reference()
    small_resnet_reference()

    # gpt_small at bench_longctx's configuration (the kernel arm), and the
    # same width at head dims 256 and 384
    gpt = {name: gpt_small_phase(name, smi, profiling) for name in GPT_ARMS}
    emit(phase='head_dim_comparison', card=smi, **{
        name: {k: rec[k] for k in ('head_dim', 'batch', 'tokens_per_s',
                                   'step_seconds', 'peak_mem_gb')}
        for name, rec in gpt.items()})

    # this slice's path: the simulator picks gpt_small's placement
    auto = auto_strategy_phase(
        TransformerConfig.gpt_small(dtype=torch.bfloat16, remat=True,
                                    max_len=4096), 4, 4096, 3, 'cuda', kind,
        smi)
    torch.cuda.empty_cache()

    # this slice's path: gpt_small with MoE blocks, then the share of its
    # step the dense dispatch takes, then the rest of TransformerConfig's
    # options on the dense model
    moe_cfg = TransformerConfig.gpt_small(dtype=torch.bfloat16, max_len=4096,
                                          **MOE_ARM)
    moe = moe_phase(moe_cfg, MOE_BATCH, 4096, MOE_STEPS, 'cuda', smi,
                    profiling)
    moe_einsum_ms(moe_cfg, MOE_BATCH, 4096, moe['median_step_s'], smi)
    torch.cuda.empty_cache()
    options = transformer_options_phase(
        TransformerConfig.gpt_small(dtype=torch.bfloat16, max_len=4096), 4,
        4096, 'cuda', loss_chunk=4096, smi=smi)
    torch.cuda.empty_cache()

    # bert_large at bench_bert's seq 128: the plain-attention arm
    cfg = TransformerConfig.bert_large(dtype=torch.bfloat16, remat=True)
    trainer = trainer_from_strategy(TransformerLM(cfg, seed=0),
                                    optim.adamw(1e-4), AllReduce())
    batch = make_batch(cfg.vocab, 32, 128, seed=1)
    fa.reset_launches()
    xe.reset_launches()
    state, losses, seconds = train_steps(trainer, batch, 2)
    bert_launches, bert_xent = dict(fa.LAUNCHES), dict(xe.LAUNCHES)
    emit(phase='bert_large', seq=128, batch=32, steps=2, losses=losses,
         step_seconds=seconds, tokens_per_s=32 * 128 / seconds[-1],
         strategy_nodes=len(trainer.strategy.node_config),
         launches=bert_launches, xent_launches=bert_xent, card=smi)
    require(all(math.isfinite(x) for x in losses), 'bert_large loss not finite')
    check_xent_launches('bert_large', bert_xent, xent_want(
        trainer.model, 32, 128, 2, 'cuda'))
    require(all(n == 0 for n in bert_launches.values()),
            'bert_large at seq 128 launched a flash kernel')
    if profiling:
        profile_step('bert_large', trainer, state, batch, smi)
    del trainer, state
    torch.cuda.empty_cache()

    # ResNet-101 at full width, the slice's main path: fused, then not
    trainer = trainer_from_strategy(
        vision.ResNet.resnet101(dtype=torch.bfloat16, seed=0),
        optim.sgd(0.1, momentum=0.9), AllReduce())
    batch = make_images(RESNET_BATCH, 224, 1000, seed=4)
    _, first_fused, k4_launches, fused_img_s = resnet101_run(
        trainer, batch, True, smi, profiling)
    state, first_plain, _, _ = resnet101_run(trainer, batch, False, smi,
                                             profiling)
    resnet101_ab(trainer, state, batch, smi)
    del trainer, state
    torch.cuda.empty_cache()
    rel = abs(first_fused - first_plain) / abs(first_plain)
    emit(phase='resnet101_first_loss', fused=first_fused,
         unfused=first_plain, rel_diff=rel, tol=FIRST_LOSS_REL)
    require(rel <= FIRST_LOSS_REL, 'ResNet-101 first loss fused %.5f vs '
            'unfused %.5f' % (first_fused, first_plain))

    set_fused_gate(True)
    family_step('densenet121', vision.DenseNet.densenet121(
        dtype=torch.bfloat16), 224, True, smi)
    family_step('inception_v3', vision.InceptionV3(dtype=torch.bfloat16),
                299, True, smi)
    family_step('vgg16', vision.VGG.vgg16(dtype=torch.bfloat16), 224, False,
                smi)
    set_fused_gate(False)
    batch_norm_phase(BN_SHAPES, torch.bfloat16, 'cuda', smi)
    torch.cuda.empty_cache()

    dsl_phase(smi, profiling)

    # bench_sparse's models through the functional Trainer (no kernel)
    with tempfile.TemporaryDirectory() as tmp:
        ncf_trainer_phase(NCF_FULL, 'cuda', tmp, smi=smi, profiling=profiling)
    torch.cuda.empty_cache()
    lm1b_phase(LM1B, 'cuda', smi=smi, profiling=profiling)
    torch.cuda.empty_cache()
    small_sparse_reference()

    # this slice's paths: serving (train, export, reload in a fresh
    # process, serve), records through the native reader into training,
    # the zero-touch adapter, and the DSL's servable bundle
    with tempfile.TemporaryDirectory() as tmp:
        served = serve_gpt_small_phase(
            TransformerConfig.gpt_small(dtype=torch.bfloat16, max_len=4096),
            (4, 1), 'cuda', tmp, smi)
        served_resnet = serve_resnet_phase(
            vision.ResNet.resnet101(dtype=torch.bfloat16, seed=0),
            RESNET_BATCH, 224, 'cuda', tmp, RESNET_K4_PER_STEP, smi)
        records = imagenet_records_phase(
            vision.ResNet.resnet101(dtype=torch.bfloat16, seed=0),
            RESNET_BATCH, 224, 2, 3, 'cuda', tmp, fused_img_s, smi)
        functional_model_phase('cuda', smi)
        dsl_saved_model_phase('cuda', tmp, smi)
    torch.cuda.empty_cache()

    # this slice's path: the loose PS plane, one worker alone, then two
    # worker processes on the card
    loose_single_phase(NCF_FULL, LOOSE_SINGLE_STEPS, 'cuda', smi)
    torch.cuda.empty_cache()
    loose_pair_phase(NCF_FULL, LOOSE_PAIR_STEPS, 'cuda', smi)
    # this slice's path: the membership half of the loose plane (joins,
    # exclusion, supervised restart, the epoch swap, serving readers)
    loose_elastic_phase(NCF_FULL, ELASTIC_STEPS, 'cuda', smi)
    # this slice's path: the chief's ssh launch, the launcher, and the
    # cohort telemetry plane (span push, the monitor's verdicts, the
    # re-rank on measured link constants)
    loose_launch_phase(NCF_FULL, 'cuda', smi)
    # this slice's paths: the analysis subsystem (its CLI, then the loose
    # phases' traces from the card replayed), and the last five examples,
    # bert_large at seq 512 through K1-K3 (non-causal)
    analysis_phase(FLIGHT_TRACES, smi)
    torch.cuda.empty_cache()
    examples = examples_phase('cuda', smi)
    bert_rec = results[(BERT_SHAPE, False, torch.bfloat16)]
    ran = examples['bert']['kernel_launches']
    require(all(ran.get(bert_rec[name]['cuda_kernel'], 0) ==
                examples['bert']['launches'][name]
                for name in ('fwd', 'dq', 'dkv')),
            'examples bert: the launches were not all of the checked '
            'kernels: %r' % ran)
    torch.cuda.empty_cache()

    # K1-K3 at each head dim's main-path shape, with the launches of the
    # phase that gives the kernels that shape
    kernels = []
    for arm, shape, suffix in (('gpt_small', GPT_SHAPE, ''),
                               ('gpt_small_head_dim_256', GPT_D256_SHAPE,
                                '_head_dim_256'),
                               ('gpt_small_head_dim_384', GPT_D384_SHAPE,
                                '_head_dim_384')):
        main_path = results[(shape, True, torch.bfloat16)]
        # gpt_small_moe8 gives the kernels gpt_small's shape: at head dim
        # 64 its launches (this slice's path) are the row's, both listed
        paths = {arm: gpt[arm]}
        if arm == 'gpt_small':
            paths = {'auto_strategy': auto, 'gpt_small_moe8': moe, **paths}
        for name in ('fwd', 'dq', 'dkv'):
            rec = main_path[name]
            by_path = {p: r['kernel_launches'].get(rec['cuda_kernel'], 0)
                       for p, r in paths.items()}
            if arm == 'gpt_small' and name == 'fwd':
                # the served gpt_small (forward only): launches of its
                # first request (batch 4), as the serving process read them
                first = next(iter(served['requests'].values()))
                by_path['serve_gpt_small'] = first['served_launches'].get(
                    rec['cuda_kernel'], 0)
            row = flash_row(name, rec, next(iter(by_path.values())), shape,
                            suffix)
            row['launches_by_path'] = by_path
            kernels.append(row)
    kernels += ulysses_rows(uly_recs, uly_launches, grid, tp)
    kernels += pipeline_rows(pk_recs, pk_launches, pp)
    kernels += bert_rows(bert_rec, examples['bert']['launches'])
    option_xent = {name: rec['xent_launches']
                   for name, rec in options.items()}
    kernels += xent_rows(xe_recs, {
        'gpt_small': dict(
            {arm: gpt[arm]['xent_launches'] for arm in GPT_ARMS},
            auto_strategy=auto['xent_launches'],
            gpt_small_moe8=moe['xent_launches'],
            **{'transformer_options_' + name: n
               for name, n in option_xent.items() if name != 'loss_chunk'}),
        'gpt_small_loss_chunk': {
            'transformer_options_loss_chunk': option_xent['loss_chunk']},
        'bert_large': {'bert_large': bert_xent,
                       'examples_bert': examples['bert']['xent_launches']}})
    # K4: launch-weighted means over ResNet-101's main-path shapes
    weights = [shape[4] / RESNET_K4_PER_STEP for shape in RESNET_K4]

    def mean(key):
        return sum(wt * rec[key] for wt, rec in zip(weights, k4))
    kernels.append({
        'name': 'conv_bn', 'route': 'cuda', 'source': CB_SOURCE,
        'replaces': CB_REPLACES, 'launches': k4_launches,
        'max_abs_err': max(rec['max_abs_err'] for rec in k4),
        'ms': mean('ms'), 'plain_ms': mean('plain_ms'),
        'bound_ms': mean('bound_ms'),
        'bound_by': max(('bytes', 'operations'), key=lambda by: sum(
            wt for wt, rec in zip(weights, k4) if rec['bound_by'] == by)),
        'library_ms': None, 'product_only_ms': mean('product_only_ms'),
        'tflops': mean('tflops'), 'bound_share': mean('bound_share'),
        'shape': 'launch-weighted mean per launch over the %d ResNet-101 '
                 'main-path shapes (batch %d)' % (len(RESNET_K4),
                                                  RESNET_BATCH),
        'dtype': 'bfloat16',
        'launches_by_path': {
            'resnet101': k4_launches,
            'imagenet_records': records['k4_launches'],
            'serve_resnet101_fused': served_resnet['served_k4_launches']}})
    print(smi, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
