"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. the card (``nvidia-smi`` name and power limit, torch and CUDA
   versions), then the build of the flash-attention kernels from
   ``autodist_tpu_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a``;
2. each kernel (fwd, dQ, dK/dV) held against its plain PyTorch version on
   the card, causal and not, f32 (TF32 off) and bf16, at gpt_small's
   attention shape (B4 H12 S4096 D64, causal) and bert_large's
   (B8 H16 S512 D64, full), with times: the kernel, its plain version,
   PyTorch's fused attention as a yardstick (never used by the port) and
   the least time the card could take (the bound);
3. a small model through the kernels on the card against the same model
   on the CPU (the plain versions), as the reference on a small input;
4. gpt_small at full width through ``Trainer`` at bench_longctx's
   configuration (seq 4096, batch 4, bf16, remat), 3 adamw steps; the
   launch counts must read 24 fwd (12 blocks plus 12 remat recomputes),
   12 dQ and 12 dK/dV per step;
5. bert_large at full width, seq 128, batch 32, 2 steps through
   ``trainer_from_strategy(..., AllReduce())``: the plain-attention arm,
   so every launch count stays 0;
6. the card's line, the ``kernels`` line, and last
   ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile`` adds one profiled step after each
model's timed steps: device-busy time, idle share and the top kernels.

Without a card, or without the rest of the repository beside it, it
fails before printing any result.
"""
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from autodist_tpu_torch import optim
from autodist_tpu_torch.api import Trainer
from autodist_tpu_torch.kernels import build
from autodist_tpu_torch.kernels import flash_attention as fa
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from autodist_tpu_torch.parallel.axes import ParallelSpec
from autodist_tpu_torch.strategy import AllReduce, trainer_from_strategy

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 on the tensor cores,
# f32 outside them (the kernels' f32 path), and device memory.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
SOURCE = 'autodist_tpu_torch/kernels/csrc/flash_attention.cu'
REPLACES = {'fwd': 'autodist_tpu/kernels/flash_attention.py:99',
            'dq': 'autodist_tpu/kernels/flash_attention.py:183',
            'dkv': 'autodist_tpu/kernels/flash_attention.py:224'}
GPT_SHAPE, BERT_SHAPE = (4, 12, 4096, 64), (8, 16, 512, 64)
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


def emit(**obj):
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError('chip_smoke: ' + what)


def cuda_ms(fn, reps):
    """Mean device ms of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(kernel, shape, dtype, causal):
    """(ms, 'bytes' | 'operations'): the least time the card could take
    for this call, from the work these inputs need: each input read
    once, each output written once; causal work counts only the kept
    (q, k) pairs."""
    b, h, s, d = shape
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    per_pair = {'fwd': 2, 'dq': 3, 'dkv': 4}[kernel]   # products of 2*D
    flops = 2 * d * pairs * per_pair
    el = torch.tensor([], dtype=dtype).element_size()
    tensors_in, rows_in, tensors_out, rows_out = {
        'fwd': (3, 0, 1, 1), 'dq': (4, 2, 1, 0), 'dkv': (4, 2, 2, 0)}[kernel]
    nbytes = (b * h * s * d * el * (tensors_in + tensors_out) +
              b * h * s * 4 * (rows_in + rows_out))
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        'operations' if t_ops >= t_bytes else 'bytes'


def ptxas_summary(log):
    """{kernel<dtype, D>: 'R regs, S B spilled'} from nvcc's -Xptxas -v
    report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '\w*?\d+((?:fwd|dq|dkv)(?:_mma)?_kernel)"
                      r"I(f)?Li(\d+)E", line)
        if m:
            name = '%s<%s,%s>' % (m.group(1), 'f32' if m.group(2) else 'bf16',
                                  m.group(3))
            spill = 0
        m = re.search(r'(\d+) bytes spill stores', line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            out[name] = '%s regs, %d B spilled' % (m.group(1), spill)
            name = None
    return out


def max_err(got, want, tol):
    """(max abs error, passes atol + rtol * |want|)."""
    diff = (got.float() - want.float()).abs()
    atol, rtol = tol
    return float(diff.max()), \
        bool((diff <= atol + rtol * want.float().abs()).all())


def check_kernels(shape, causal, dtype, timed):
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
    out = {}
    for name, results in checks.items():
        err = max(e for e, _ in results)
        ok = all(p for _, p in results)
        rec = {'max_abs_err': err}
        if timed:
            rec.update(_times(name, *runs[name], q, k, v, do, causal,
                              scale))
        rec['bound_ms'], rec['bound_by'] = bound(name, shape, dtype, causal)
        emit(phase='kernel_check', kernel=name, shape=list(shape),
             dtype=str(dtype).replace('torch.', ''), causal=causal, ok=ok,
             tol={k: list(v) for k, v in tol.items()}, **rec)
        require(ok, '%s kernel disagrees with its plain version at %s %s '
                'causal=%s' % (name, shape, dtype, causal))
        out[name] = rec
    return out


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


def profile_step(name, trainer, state, batch):
    """One more step under torch.profiler: host seconds, device-busy
    seconds (kernel time summed), idle share, and the kernels that take
    the most device time. The profiler's own cost inflates the host
    time, so the idle share here is an upper bound."""
    from torch.profiler import ProfilerActivity, profile
    step = trainer.compile_step(state, batch)
    local = trainer.shard_batch(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, local)
        float(metrics['loss'])
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, 'is_user_annotation', False):
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit(phase='profile', model=name, host_s=wall, device_busy_s=busy,
         idle_share=1 - busy / wall,
         top_kernels_ms={n[:90]: ms for n, ms in top})
    require(busy > 0, 'the profiler saw no device time')
    return state


def small_reference():
    """The kernels on the card against the plain versions on the CPU, on
    a small model whose attention takes the kernel branch (S = 512):
    loss and every gradient."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, max_len=512, dim=128,
                                 n_heads=2, remat=True)
    batch = make_batch(cfg.vocab, 2, 512, seed=2)
    out = {}
    for device in ('cuda', 'cpu'):
        model = TransformerLM(cfg, device=device, seed=0)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        fa.reset_launches()
        loss = model.loss(model.params(), tb)
        loss.backward()
        out[device] = (float(loss.detach()), {n: p.grad.float().cpu()
                                     for n, p in model.named_parameters()},
                       dict(fa.LAUNCHES))
    (l_gpu, g_gpu, launches), (l_cpu, g_cpu, _) = out['cuda'], out['cpu']
    grad_err = max(float((g_gpu[n] - g_cpu[n]).abs().max()) for n in g_cpu)
    # f32 with TF32 off on both sides: sums in other orders through two
    # blocks; 1e-4 on gradients as in the CPU parity tests
    ok = abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu) and grad_err <= 1e-4 and \
        launches == {'fwd': 2 * cfg.n_layers, 'dq': cfg.n_layers,
                     'dkv': cfg.n_layers}
    emit(phase='small_reference', loss_cuda=l_gpu, loss_cpu=l_cpu,
         max_grad_err=grad_err, launches=launches, ok=ok)
    require(ok, 'the model on the card disagrees with the CPU reference')


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
    build.build_all([fa.SOURCE])
    fa.load_library()
    emit(phase='build', source=SOURCE, seconds=time.time() - t0,
         ptxas=ptxas_summary(build.build_log(fa.SOURCE)))

    results = {}
    for shape, causal in ((GPT_SHAPE, True), (BERT_SHAPE, False)):
        for dtype in (torch.float32, torch.bfloat16):
            rec = check_kernels(shape, causal, dtype, timed=dtype ==
                                torch.bfloat16)
            results[(shape, causal, dtype)] = rec
            torch.cuda.empty_cache()
    for shape, causal in ((GPT_SHAPE, False), (BERT_SHAPE, True)):
        check_kernels(shape, causal, torch.bfloat16, timed=False)
        torch.cuda.empty_cache()

    small_reference()

    # gpt_small at bench_longctx's configuration: the kernel arm
    cfg = TransformerConfig.gpt_small(dtype=torch.bfloat16, remat=True,
                                      max_len=4096)
    trainer = Trainer(TransformerLM(cfg, seed=0), optim.adamw(1e-4),
                      spec=ParallelSpec(dp=1))
    batch = make_batch(cfg.vocab, 4, 4096)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    state, losses, seconds = train_steps(trainer, batch, 3)
    launches = dict(fa.LAUNCHES)
    step_s = float(np.median(seconds[1:]))
    emit(phase='gpt_small', seq=4096, batch=4, steps=3, losses=losses,
         step_seconds=seconds, tokens_per_s=4 * 4096 / step_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches)
    require(all(math.isfinite(x) for x in losses), 'gpt_small loss not finite')
    require(abs(losses[0] - math.log(cfg.vocab)) < 0.5,
            'gpt_small initial loss %.4f is not near ln(vocab)' % losses[0])
    per_step = {'fwd': 2 * cfg.n_layers, 'dq': cfg.n_layers,
                'dkv': cfg.n_layers}
    require(launches == {k: 3 * n for k, n in per_step.items()},
            'gpt_small launch counts %s, expected %s per step'
            % (launches, per_step))
    if profiling:
        profile_step('gpt_small', trainer, state, batch)
    del trainer, state
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
         launches=bert_launches)
    require(all(math.isfinite(x) for x in losses), 'bert_large loss not finite')
    require(all(n == 0 for n in bert_launches.values()),
            'bert_large at seq 128 launched a flash kernel')
    if profiling:
        profile_step('bert_large', trainer, state, batch)

    main_path = results[(GPT_SHAPE, True, torch.bfloat16)]
    kernels = []
    for name in ('fwd', 'dq', 'dkv'):
        rec = main_path[name]
        kernels.append({
            'name': 'flash_attention_' + name, 'route': 'cuda',
            'source': SOURCE, 'replaces': REPLACES[name],
            'launches': launches[name], 'max_abs_err': rec['max_abs_err'],
            'ms': rec['ms'], 'plain_ms': rec['plain_ms'],
            'bound_ms': rec['bound_ms'], 'bound_by': rec['bound_by'],
            'library_ms': rec['library_ms'], 'library': rec['library'],
            'shape': list(GPT_SHAPE), 'dtype': 'bfloat16', 'causal': True})
    print(smi, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
