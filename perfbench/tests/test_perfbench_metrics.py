"""Each metric reader on a recorded, synthetic trace; the union of
intervals and the exposed collective time by hand."""
import pytest

from perfbench import harness, trace, work

CORR = 'correlation'


def X(cat, name, ts, dur, corr=None):
    e = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}
    if corr is not None:
        e['args'] = {CORR: corr}
    return e


# window [0, 200] us: feed [0, 10], step [10, 100], loss_read [100, 200],
# the optimizer's range [120, 160]
EVENTS = [
    X('user_annotation', 'perfbench.feed', 0, 10),
    X('user_annotation', 'perfbench.step', 10, 90),
    X('user_annotation', 'perfbench.loss_read', 100, 100),
    X('user_annotation', 'perfbench.optimizer', 120, 40),
    X('cpu_op', 'aten::copy_', 0, 8),
    X('cuda_runtime', 'cudaLaunchKernel', 15, 2, 1),
    X('cuda_runtime', 'cudaLaunchKernel', 40, 2, 2),
    X('cuda_runtime', 'cudaLaunchKernel', 110, 2, 3),
    X('cuda_runtime', 'cudaLaunchKernel', 130, 2, 4),
    X('kernel', 'sm90_xmma_gemm_bf16bf16_bf16f32', 20, 40, 1),
    X('kernel', 'ncclDevKernel_AllReduce_Sum_f32_RING_LL', 50, 70, 2),
    X('kernel', 'void (anonymous namespace)::fwd_wgmma_kernel<64>(Params)',
      130, 20, 3),
    X('kernel', 'void at::native::vectorized_elementwise_kernel<4>()',
      160, 10, 4),
    X('gpu_memcpy', 'Memcpy HtoD (Pinned -> Device)', 180, 10),
    X('kernel', 'outside_the_window', 300, 10),
]


@pytest.fixture
def rec():
    s = harness.load_spec('gpt2-small.s4096.b4')
    r = trace.reduce(EVENTS, steps=1,
                     flash_launches={'fwd': 1, 'dq': 0, 'dkv': 0})
    return {'ranks': [r], 'model': s['config']['model'],
            'traffic': s['traffic'], 'chips': 1,
            'window': {'steps': 10, 'seconds': 2.0,
                       'dispatch_s': [0.010, 0.020]}}


def read(name, rec):
    return harness.reader(harness.BENCH, name)(rec)


def test_union_and_idle_by_hand(rec):
    r = rec['ranks'][0]
    assert r['window_us'] == [0, 200]
    assert len(r['kernels']) == 5
    # busy: [20, 120] + [130, 150] + [160, 170] + [180, 190] = 140 us
    assert trace.busy_us(r) == 140
    # compute busy, the NCCL kernel left out: [20, 60] + [130, 150] +
    # [160, 170] + [180, 190] = 80 us; the untraced window's step: 0.002 s
    # over 8 steps = 250 us
    rec['window'].update(steps=8, seconds=0.002)
    assert read('device_idle_frac', rec) == pytest.approx(1 - 80 / 250)
    assert trace.union([[5, 9], [1, 3], [2, 4]]) == [[1, 4], [5, 9]]


def test_exposed_collective_by_hand(rec):
    # NCCL [50, 120]; other work [20, 60], [130, 150], ...: [60, 120]
    assert read('allreduce_ms', rec) == pytest.approx(0.070)
    assert read('allreduce_exposed_ms', rec) == pytest.approx(0.060)
    # [0, 10] less [2, 4] and [5, 10]: 2 + 1; [20, 30] less [20, 25]: 5
    assert trace.minus([[0, 10], [20, 30]], [[2, 4], [5, 25]]) == 8


def test_kernel_classes(rec):
    assert read('gemm_ms', rec) == pytest.approx(0.040)
    assert read('flash_ms', rec) == pytest.approx(0.020)
    assert read('optimizer_ms', rec) == pytest.approx(0.010)
    # the memcpy; the elementwise kernel was launched by the optimizer
    assert read('elementwise_ms', rec) == pytest.approx(0.010)
    assert read('host_dispatch_ms', rec) == pytest.approx(15.0)


def test_flash_roofline_and_its_launch_check(rec):
    m = rec['model']
    shape = (4, m['n_heads'], 4096, m['dim'] // m['n_heads'])
    bound = work.bound_s(*work.attention('fwd', shape, 'bfloat16', True))
    assert read('flash_roofline', rec) == pytest.approx(100 * bound / 20e-6)
    rec['ranks'][0]['flash_launches'] = {'fwd': 2, 'dq': 0, 'dkv': 0}
    assert read('flash_roofline', rec) is None


def test_step_mfu(rec):
    flops = work.step_flops(rec['model'], 4096, 4)
    assert read('step_mfu', rec) == pytest.approx(
        100 * 10 * flops / 2.0 / work.PEAK_BF16_FLOPS)


def test_readers_find_nothing_where_nothing_ran(rec):
    r = rec['ranks'][0]
    r['kernels'] = [k for k in r['kernels']
                    if trace.kind(k[0]) not in ('flash', 'nccl')]
    r['flash_launches'] = {'fwd': 0, 'dq': 0, 'dkv': 0}
    for name in ('flash_ms', 'flash_roofline', 'allreduce_ms',
                 'allreduce_exposed_ms'):
        assert read(name, rec) is None


def test_idle_gaps_are_named_by_the_host_span(rec):
    gaps = rec['ranks'][0]['idle_gaps']
    assert gaps == {'feed/aten::copy_': 20, 'optimizer': 20,
                    'loss_read': 20}
    b = trace.breakdown(rec['ranks'][0])
    assert b['device_ops'][0] == ['ncclDevKernel_AllReduce_Sum_f32_RING_LL',
                                  70e-6]
    assert len(b['idle_gaps']) == 3
