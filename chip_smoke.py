"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. the card (``nvidia-smi`` name and power limit, torch and CUDA
   versions), then the build of the kernels from
   ``autodist_tpu_torch/kernels/csrc`` (flash attention and the fused
   conv + BatchNorm), one ``nvcc`` each, all at once, for ``sm_90a``,
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
3. the fused conv + BatchNorm kernel (K4) held against its plain version
   at each of ResNet-101's main-path shapes (batch 256) in bf16, and in
   f32 at two of them and at a stage-1 shape (802,816 rows), with times:
   the kernel, its plain version, ``torch.matmul`` of the same operands
   ("product only": no prologue, no stats; never used by the port) and
   the bound, with TFLOP/s and the bound's share of the time;
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
   the ``moe_dispatch`` / ``moe_experts`` / ``moe_combine`` ranges);
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
11. the card's line, the ``kernels`` line (K1-K4 of the main paths:
   K1-K3 at head dim 64, at 256 and at 384, each row with the CUDA
   kernel that ran and its launches in its own phase), and last
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
import json
import math
import os
import re
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
CB_REPLACES = 'autodist_tpu/kernels/conv_bn.py:70'
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
    report (flash attention's kernels and K4's)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '\w*?\d+((?:fwd|dq|dkv)"
                      r"(?:_(?:wg)?mma|_cols|_wgmma_cols)?_kernel)"
                      r"I(f|13__nv_bfloat16)?Li(\d+)E", line)
        c = re.search(r"entry function '\w*?\d+(cb_\w+?_kernel)"
                      r"(?:I((?:Li\d+E|Lb[01]E|13__nv_bfloat16|f)+)E)?",
                      line)
        if m:
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
    o, lse = fa._fwd_cuda(*args)
    delta = fa._delta(do, o)
    bwd_args = (q, k, v, do, lse, delta, causal, scale)
    runs = {'fwd': (lambda: fa._fwd_cuda(*args),
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


def check_conv_bn(shape, dtype, smi):
    """Phase 3 for one K4 shape: the kernel (through its wrapper) against
    its plain version on the same inputs, then times: kernel, plain,
    product only, and the bound. Returns the record."""
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
    y, s1, s2 = cb._fwd_cuda(*args)
    py, p1, p2 = cb._fwd_plain(*args)
    torch.cuda.synchronize()
    tol = K4_TOL[dtype]
    errs, ok = [], True
    for got, want, rel in ((y, py, tol['y']), (s1, p1, tol['s']),
                           (s2, p2, tol['s'])):
        diff = float((got.float() - want.float()).abs().max())
        errs.append(diff)
        ok = ok and diff <= rel * float(want.float().abs().max())
    del y, s1, s2, py, p1, p2
    wc = w.to(dtype)
    rec = {'max_abs_err': errs[0], 'max_abs_err_s1': errs[1],
           'max_abs_err_s2': errs[2],
           'ms': cuda_ms(lambda: cb._fwd_cuda(*args), 10),
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
    fused gate on or off. Returns (state, first loss, K4 launches)."""
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
    return state, losses[0], launches


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
    trainer = Trainer(TransformerLM(cfg, seed=0), optim.adamw(1e-4),
                      spec=ParallelSpec(dp=1))
    data = make_batch(cfg.vocab, batch, 4096)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    state, losses, seconds = train_steps(trainer, data, steps)
    launches, by_kernel = dict(fa.LAUNCHES), dict(fa.KERNEL_LAUNCHES)
    step_s = float(np.median(seconds[1:]))   # the steps after the first
    rec = dict(phase=name, head_dim=d, n_heads=n_heads, seq=4096,
               batch=batch, steps=steps, losses=losses,
               step_seconds=seconds, tokens_per_s=batch * 4096 / step_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, kernel_launches=by_kernel,
               launches_per_step={k: n / steps for k, n in launches.items()},
               card=smi)
    emit(**rec)
    require(all(math.isfinite(x) for x in losses), '%s loss not finite'
            % name)
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
    del trainer, state
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
    trainer = trainer_from_strategy(
        TransformerLM(cfg, device=device, seed=0), optim.adamw(1e-4),
        builder, resource_spec=spec)
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
    state, losses, seconds = train_steps(trainer, data, steps)
    launches, by_kernel = dict(fa.LAUNCHES), dict(fa.KERNEL_LAUNCHES)
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
    roof = rl.classify_regime(cost['flops'], cost['bytes_accessed'], step_s,
                              peak_flops, peak_hbm)
    require(roof['mfu'] is not None and 0 < roof['mfu'] <= 1,
            'auto_strategy MFU %r against %s is not in (0, 1]'
            % (roof['mfu'], kind))

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
               predicted_step_s=best.predicted_step_time_s,
               predicted_peak_bytes=best.predicted_peak_bytes,
               memory=memory, cost=cost, peaks=[peak_flops, peak_hbm],
               mfu=roof['mfu'], hbm_frac=roof['hbm_frac'],
               roofline_regime=roof['roofline_regime'],
               calibrated=fitted.calibrated,
               alpha_beta={'ici': params.link(cross_node=False),
                           'dcn': params.link(cross_node=True)},
               card=smi)
    emit(**rec)
    del trainer, state
    return rec


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
MOE_RANGES = ('moe_dispatch', 'moe_experts', 'moe_combine')


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
    state, losses, seconds = train_steps(trainer, data, steps)
    launches, by_kernel = dict(fa.LAUNCHES), dict(fa.KERNEL_LAUNCHES)
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
               kernel_launches=by_kernel,
               launches_per_step={k: n / steps for k, n in launches.items()})
    if cuda:
        rec['peak_mem_gb'] = torch.cuda.max_memory_allocated() / 1e9
    if smi is not None:
        emit(card=smi, **rec)
    require(all(math.isfinite(x) for x in losses), 'MoE loss not finite')
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
        trainer = Trainer(TransformerLM(arm_cfg, device=device, seed=0),
                          optim.adamw(1e-4), spec=ParallelSpec(dp=1))
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        state, losses, seconds = train_steps(trainer, data, steps)
        step_s = float(np.median(seconds[1:]))
        rec = {'losses': losses, 'step_seconds': seconds,
               'tokens_per_s': batch * seq / step_s,
               'launches': dict(fa.LAUNCHES), **{
                   k: v for k, v in kw.items()}}
        if cuda:
            rec['peak_mem_gb'] = torch.cuda.max_memory_allocated() / 1e9
        del trainer, state
        require(all(math.isfinite(x) for x in losses),
                'options arm %s loss not finite' % name)
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


def train_steps(trainer, batch, steps):
    """Run ``steps`` steps on ``batch``; returns (state, losses, step
    seconds each), each step fenced by a device sync."""
    state = trainer.init(seed=0)
    step = trainer.compile_step(state, batch)
    local = trainer.shard_batch(batch)
    losses, seconds = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, local)
        losses.append(float(metrics['loss']))   # host read fences the step
        seconds.append(time.perf_counter() - t0)
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
        loss = model.loss(model.params(), tb)
        loss.backward()
        out.append((float(loss.detach()), {n: p.grad.float().cpu()
                                           for n, p in
                                           model.named_parameters()},
                    dict(fa.LAUNCHES)))
    (l_gpu, g_gpu, launches), (l_cpu, g_cpu, _) = out
    grad_err = max(float((g_gpu[n] - g_cpu[n]).abs().max()) for n in g_cpu)
    # f32 with TF32 off on both sides: sums in other orders through two
    # blocks; 1e-4 on gradients as in the CPU parity tests
    want = {'fwd': 2 * cfg.n_layers, 'dq': cfg.n_layers, 'dkv': cfg.n_layers}
    if torch.device(devices[0]).type != 'cuda':
        want = {k: 0 for k in want}
    ok = abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu) and grad_err <= 1e-4 and \
        launches == want
    emit(phase=phase, head_dim=dim // n_heads, loss_cuda=l_gpu,
         loss_cpu=l_cpu, max_grad_err=grad_err, launches=launches, ok=ok,
         devices=list(devices), **cfg_kw)
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


def ncf_program(autodist, init, lr=1e-3):
    """NCF written in DSL ops (``autodist_tpu/models/ncf.py``'s GMF and
    MLP towers, stable sigmoid BCE) under ``autodist``'s scope, trained
    by Adam. Returns (session, feeds (users, items, labels), loss,
    train_op)."""
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
        train_op = ad.optimizers.Adam(lr).minimize(loss)
        sess = autodist.create_distributed_session()
    return sess, (users, items, labels), loss, train_op


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


def ncf_train(builder, device, cfg, steps, seed=0, rank=0, world=1):
    """``steps`` NCF steps through the DSL: (losses, step seconds, the
    execution plan, ``step(batch_seed)`` running one more). Each step's
    batch is this process's share of batch ``seed + 1 + step``; the loss
    is fetched (a host read) every step."""
    autodist = fresh_autodist(builder, device, world)
    sess, feeds, loss, train_op = ncf_program(autodist, ncf_init(cfg, seed))

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
    width (``_fwd_cuda`` etc., as the wrapper launches them), its plain
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
    op, lsep = fa._fwd_cuda(qp, kp, vp, causal, scale)
    bwd = (qp, kp, vp, dop, lsep, fa._delta(dop, op), causal, scale)
    plain_bwd = (q, k, v, do, lse2, delta, causal, scale)
    runs = {'fwd': (lambda: fa._fwd_cuda(qp, kp, vp, causal, scale),
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


def main(argv):
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
    build.build_all([fa.SOURCE, cb.SOURCE])
    emit(phase='build', sources=[SOURCE, CB_SOURCE],
         seconds=time.time() - t0,
         ptxas=dict(ptxas_summary(build.build_log(fa.SOURCE)),
                    **ptxas_summary(build.build_log(cb.SOURCE))),
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

    k4 = [check_conv_bn(shape, torch.bfloat16, smi) for shape in RESNET_K4]
    for shape in K4_F32:
        check_conv_bn(shape, torch.float32, smi)
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
    transformer_options_phase(
        TransformerConfig.gpt_small(dtype=torch.bfloat16, max_len=4096), 4,
        4096, 'cuda', loss_chunk=4096, smi=smi)
    torch.cuda.empty_cache()

    # bert_large at bench_bert's seq 128: the plain-attention arm
    cfg = TransformerConfig.bert_large(dtype=torch.bfloat16, remat=True)
    trainer = trainer_from_strategy(TransformerLM(cfg, seed=0),
                                    optim.adamw(1e-4), AllReduce())
    batch = make_batch(cfg.vocab, 32, 128, seed=1)
    fa.reset_launches()
    state, losses, seconds = train_steps(trainer, batch, 2)
    bert_launches = dict(fa.LAUNCHES)
    emit(phase='bert_large', seq=128, batch=32, steps=2, losses=losses,
         step_seconds=seconds, tokens_per_s=32 * 128 / seconds[-1],
         strategy_nodes=len(trainer.strategy.node_config),
         launches=bert_launches, card=smi)
    require(all(math.isfinite(x) for x in losses), 'bert_large loss not finite')
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
    _, first_fused, k4_launches = resnet101_run(trainer, batch, True, smi,
                                                profiling)
    state, first_plain, _ = resnet101_run(trainer, batch, False, smi,
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
            row = flash_row(name, rec, next(iter(by_path.values())), shape,
                            suffix)
            row['launches_by_path'] = by_path
            kernels.append(row)
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
        'dtype': 'bfloat16'})
    print(smi, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
