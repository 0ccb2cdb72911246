"""``chip_smoke.py``'s report helpers, on the CPU.

The script runs only on the card, but how it reads the compiler's report
and how it sorts the profiler's kernel names is plain Python: these hold
both to sample inputs with the kernels' real (mangled and demangled)
names, and check the work and bound arithmetic behind its rates.
"""
import pytest
import torch

import chip_smoke

# nvcc -Xptxas -v, as it reports the flash-attention kernels (one of each
# generation) and K4's (each generation, and the wgmma kernel's template
# arguments: tile width, output type, prologue)
PTXAS_LOG = '''\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116fwd_wgmma_kernelILi64ELi128ELi3EEEv14CUtensorMap_stS1_S1_S1_Pfifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116fwd_wgmma_kernelILi64ELi128ELi3EEEv14CUtensorMap_stS1_S1_S1_Pfifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116dkv_wgmma_kernelILi128ELi3EEEv14CUtensorMap_stS1_S1_S1_S1_S1_S1_S1_ifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116dkv_wgmma_kernelILi128ELi3EEEv14CUtensorMap_stS1_S1_S1_S1_S1_S1_S1_ifi
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1408 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113dq_mma_kernelILi64EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_ifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113dq_mma_kernelILi64EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_ifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 24576 bytes smem, 412 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110fwd_kernelIfLi32EEEvPKT_S3_S3_PS1_Pfifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110fwd_kernelIfLi32EEEvPKT_S3_S3_PS1_Pfifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113cb_mma_kernelEPK13__nv_bfloat16S2_PKfS4_PS0_Pfiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113cb_mma_kernelEPK13__nv_bfloat16S2_PKfS4_PS0_Pfiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 1 barriers, 24576 bytes smem, 424 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115dq_wgmma_kernelILi128ELi3EEEv14CUtensorMap_stS1_S1_S1_S1_S1_S1_ifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115dq_wgmma_kernelILi128ELi3EEEv14CUtensorMap_stS1_S1_S1_S1_S1_S1_ifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1280 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115cb_wgmma_kernelILi128E13__nv_bfloat16Lb1EEEv14CUtensorMap_stS2_S2_S2_S2_Pfiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115cb_wgmma_kernelILi128E13__nv_bfloat16Lb1EEEv14CUtensorMap_stS2_S2_S2_S2_Pfiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115cb_wgmma_kernelILi256EfLb0EEEv14CUtensorMap_stS1_S1_S1_S1_Pfiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115cb_wgmma_kernelILi256EfLb0EEEv14CUtensorMap_stS1_S1_S1_S1_Pfiiiii
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113cb_f32_kernelIfEEvPKfS2_S2_S2_iiPT_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113cb_f32_kernelIfEEvPKfS2_S2_S2_iiPT_Pfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 33280 bytes smem, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115cb_stats_kernelEPKfPfii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115cb_stats_kernelEPKfPfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, used 1 barriers, 1056 bytes smem, 376 bytes cmem[0]
'''


def test_ptxas_summary_reads_every_generation_of_kernel():
    got = chip_smoke.ptxas_summary(PTXAS_LOG)
    assert got == {
        'fwd_wgmma_kernel<bf16,64>': '168 regs, 0 B spilled',
        'dkv_wgmma_kernel<bf16,128>': '168 regs, 8 B spilled',
        'dq_mma_kernel<bf16,64>': '128 regs, 0 B spilled',
        'fwd_kernel<f32,32>': '90 regs, 0 B spilled',
        'cb_mma_kernel': '122 regs, 0 B spilled',
        'dq_wgmma_kernel<bf16,128>': '168 regs, 0 B spilled',
        'cb_wgmma_kernel<128,out bf16,prologue>': '168 regs, 0 B spilled',
        'cb_wgmma_kernel<256,out f32,no prologue>': '168 regs, 4 B spilled',
        'cb_f32_kernel<out f32>': '128 regs, 0 B spilled',
        'cb_stats_kernel': '16 regs, 0 B spilled'}


@pytest.mark.parametrize('name,cls', [
    ('void (anonymous namespace)::fwd_wgmma_kernel<64, 128, 3>('
     'CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, '
     'float*, int, float, int)', 'flash_attention'),
    ('void (anonymous namespace)::dkv_wgmma_kernel<128, 3>(CUtensorMap_st, '
     'CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, '
     'CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, int, float, int)',
     'flash_attention'),
    ('void (anonymous namespace)::dq_mma_kernel<64>(__nv_bfloat16 const*, '
     '__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, '
     'float const*, float const*, __nv_bfloat16*, int, float, int)',
     'flash_attention'),
    ('void (anonymous namespace)::cb_mma_kernel(__nv_bfloat16 const*, '
     '__nv_bfloat16 const*, float const*, float const*, __nv_bfloat16*, '
     'float*, int, int, int, int, int)', 'k4_conv_bn'),
    ('void (anonymous namespace)::dq_wgmma_kernel<64, 3>(CUtensorMap_st, '
     'CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, '
     'CUtensorMap_st, CUtensorMap_st, int, float, int)', 'flash_attention'),
    ('void (anonymous namespace)::cb_wgmma_kernel<128, __nv_bfloat16, '
     'true>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, '
     'CUtensorMap_st, float*, int, int, int, int, int)', 'k4_conv_bn'),
    ('void (anonymous namespace)::cb_stats_kernel(float const*, float*, '
     'int, int)', 'k4_conv_bn'),
    ('void at::native::elementwise_kernel<128, 2>(int)', 'elementwise'),
    ('nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN', 'gemm'),
    ('void at::native::(anonymous namespace)::multi_tensor_apply_kernel<'
     'at::native::(anonymous namespace)::TensorListMetadata<4>>(int)',
     'optimizer_foreach'),
    ('some_unknown_kernel', 'other')])
def test_kernel_class_sorts_the_kernels(name, cls):
    assert chip_smoke.kernel_class(name) == cls


def test_rates_follow_the_work_and_the_bound():
    shape = (4, 12, 4096, 64)
    flops, nbytes = chip_smoke.attention_work('fwd', shape, torch.bfloat16,
                                              True)
    # 2 products of 2*D per kept (q, k) pair: S (S + 1) / 2 pairs causal
    assert flops == 2 * 64 * 2 * 48 * 4096 * 4097 // 2
    assert nbytes == 48 * 4096 * 64 * 2 * 4 + 48 * 4096 * 4
    ms, by = chip_smoke.bound('fwd', shape, torch.bfloat16, True)
    assert by == 'operations'
    assert ms == pytest.approx(1e3 * flops / 989e12)
    r = chip_smoke.rates('fwd', shape, torch.bfloat16, True, 2 * ms)
    assert r['bound_share'] == pytest.approx(0.5)
    assert r['tflops'] == pytest.approx(989 / 2)
    # dQ and dK/dV together: the work of both, the bytes of one backward
    pair = chip_smoke.attention_work('bwd', shape, torch.bfloat16, True)
    dq = chip_smoke.attention_work('dq', shape, torch.bfloat16, True)
    dkv = chip_smoke.attention_work('dkv', shape, torch.bfloat16, True)
    assert pair[0] == dq[0] + dkv[0]
    assert pair[1] == dkv[1] + 48 * 4096 * 64 * 2


@pytest.mark.parametrize('prologue,want_stats', [(False, True), (True, True),
                                                 (True, False)])
def test_conv_bn_rates_follow_the_work_and_the_bound(prologue, want_stats):
    n, c_in, c_out = 50176, 1024, 256
    flops, nbytes = chip_smoke.conv_bn_work(n, c_in, c_out, torch.bfloat16,
                                            prologue, want_stats)
    assert flops == 2 * n * c_in * c_out
    # x, W and y once each in bf16; a, b (f32 [Cin]) with the prologue; s1,
    # s2 (f32 [Cout]) with stats
    assert nbytes == (n * c_in + c_in * c_out + n * c_out) * 2 + \
        (8 * c_in if prologue else 0) + (8 * c_out if want_stats else 0)
    ms, by = chip_smoke.bound_conv_bn(n, c_in, c_out, torch.bfloat16,
                                      prologue, want_stats)
    # this shape moves more bytes than the tensor cores need time for
    assert by == 'bytes'
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12)
    r = chip_smoke.rates_conv_bn(n, c_in, c_out, torch.bfloat16, prologue,
                                 4 * ms)
    if want_stats:
        assert r['bound_share'] == pytest.approx(0.25)
    assert r['tflops'] == pytest.approx(flops / (4 * ms) / 1e9)
    # at Cin = Cout = 2048 the product outweighs the bytes
    assert chip_smoke.bound_conv_bn(12544, 2048, 2048, torch.bfloat16,
                                    prologue)[1] == 'operations'


# -- the DSL phase's helpers, at tiny width on the CPU -----------------------
def test_dsl_c0_matrix_runs_on_the_cpu():
    out = chip_smoke.c0_matrix('cpu')
    assert [name for name, _ in chip_smoke.C0_STRATEGIES] == list(out)
    for name, (loss, W, b) in out.items():
        assert abs(b - chip_smoke.EXPECTED_B) <= chip_smoke.c0_tol(name)
        assert loss > 0 and W < 5.0


def test_dsl_ncf_program_at_tiny_width():
    """The NCF DSL program trains, starts near ln 2, marks its four
    tables (and no other variable) for the sparse (ids, rows) route,
    returns the gradients as they are at one replica, and its variables
    have the widths the configuration names."""
    import math
    cfg = chip_smoke.NCF_SMALL
    init = chip_smoke.ncf_init(cfg)
    assert init['mlp_user'].shape == (cfg['users'], cfg['mlp'][0] // 2)
    assert init['head/kernel'].shape == (cfg['mf_dim'] + cfg['mlp'][-1], 1)
    losses, seconds, plan, step = chip_smoke.ncf_train(
        chip_smoke.ad.PSLoadBalancing(), 'cpu', cfg, 3)
    assert len(seconds) == 3 and all(math.isfinite(x) for x in losses)
    assert abs(losses[0] - math.log(2)) < 0.05
    assert chip_smoke.sparse_route_marked(plan) == dict.fromkeys(
        chip_smoke.NCF_TABLES, True)
    assert not any(p.var.sparse_read for name, p in plan.var_plans.items()
                   if name not in chip_smoke.NCF_TABLES)
    assert not any(p.sparse_synced for p in plan.var_plans.values())
    assert plan.last_bucket_stats == []
    assert math.isfinite(step(7))


def test_local_slice_splits_like_the_jax_package():
    import numpy as np
    x = np.arange(8)
    assert list(chip_smoke.local_slice(x, 1, 2)) == [4, 5, 6, 7]
    assert list(chip_smoke.local_slice(x, 1, 3)) == list(x)   # replicated


def test_ptxas_summary_reads_the_head_dim_256_kernels():
    """The CUDA-core kernels take a query-tile argument, and at head dim
    256 run bf16 too (T = __nv_bfloat16)."""
    log = '''\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110dkv_kernelI13__nv_bfloat16Li256ELi32EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_ifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110dkv_kernelI13__nv_bfloat16Li256ELi32EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_ifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 204 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110fwd_kernelIfLi256ELi32EEEvPKT_S3_S3_PS1_Pfifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110fwd_kernelIfLi256ELi32EEEvPKT_S3_S3_PS1_Pfifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 400 bytes cmem[0]
'''
    assert chip_smoke.ptxas_summary(log) == {
        'dkv_kernel<bf16,256>': '204 regs, 0 B spilled',
        'fwd_kernel<f32,256>': '96 regs, 0 B spilled'}


def test_ptxas_summary_reads_the_head_dim_256_and_column_chunked_kernels():
    """The bf16 wgmma forward and dQ at head dim 256 (their first
    template argument) and the column-chunked kernels above 256 (the
    dtype, then the chunk width; the wgmma ones' chunk width first), as
    nvcc 12.8 names them in a file-specific anonymous namespace."""
    ns = '_ZN49_GLOBAL__N__f013377b_18_flash_attention_cu_fa_fwd'
    log = '\n'.join(
        "ptxas info    : Compiling entry function '%s%s' for 'sm_90a'\n"
        "    0 bytes stack frame, %d bytes spill stores, 0 bytes spill "
        "loads\nptxas info    : Used %d registers, used 1 barriers"
        % (ns, name, spill, regs) for name, spill, regs in (
            ('16fwd_wgmma_kernelILi256ELi64ELi2EEEv14CUtensorMap_stS1_S1_S1_'
             'Pfifi', 0, 168),
            ('15dq_wgmma_kernelILi256ELi32ELi3EEEv14CUtensorMap_stS1_S1_S1_S1_'
             'S1_S1_ifi', 0, 168),
            ('15fwd_cols_kernelIfLi128ELi64EEEvPKT_S3_S3_PS1_Pfiifi', 0, 114),
            ('14dq_cols_kernelIfLi128ELi64EEEvPKT_S3_S3_S3_PKfS5_PS1_iifi', 0,
             124),
            ('15dkv_cols_kernelI13__nv_bfloat16Li128ELi32EEEvPKT_S4_S4_S4_'
             'PKfS6_PS2_S7_iifi', 8, 170),
            ('21fwd_wgmma_cols_kernelILi256ELi64ELi6ELi2EEEv14CUtensorMap_st'
             'S1_S1_S1_Pfiifi', 0, 168)))
    assert chip_smoke.ptxas_summary(log) == {
        'fwd_wgmma_kernel<bf16,256>': '168 regs, 0 B spilled',
        'dq_wgmma_kernel<bf16,256>': '168 regs, 0 B spilled',
        'fwd_cols_kernel<f32,128>': '114 regs, 0 B spilled',
        'dq_cols_kernel<f32,128>': '124 regs, 0 B spilled',
        'dkv_cols_kernel<bf16,128>': '170 regs, 8 B spilled',
        'fwd_wgmma_cols_kernel<bf16,256>': '168 regs, 0 B spilled'}


@pytest.mark.parametrize('name', ['fwd', 'dq', 'dkv'])
def test_flash_rows_carry_every_key_of_the_kernels_line(name):
    """A flash row of the ``kernels`` line: every key the line promises,
    the numbers of the record it came from, and the CUDA kernel that
    ran."""
    rec = {'max_abs_err': 0.01, 'bitwise_repeat': True,
           'cuda_kernel': '%s_wgmma_kernel<bf16,256>' % name, 'ms': 0.3,
           'plain_ms': 20.0, 'library_ms': 0.25, 'library': 'sdpa',
           'bound_ms': 0.1, 'bound_by': 'operations', 'tflops': 330.0,
           'bound_share': 0.33}
    row = chip_smoke.flash_row(name, rec, 72, chip_smoke.GPT_D256_SHAPE,
                               '_head_dim_256')
    for key in ('name', 'route', 'source', 'replaces', 'launches',
                'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                'library_ms'):
        assert key in row, key
    assert row['name'] == 'flash_attention_%s_head_dim_256' % name
    assert row['replaces'] == chip_smoke.REPLACES[name]
    assert row['launches'] == 72 and row['route'] == 'cuda'
    assert row['cuda_kernel'] == rec['cuda_kernel']
    assert row['shape'] == [4, 3, 4096, 256]
    for key in ('ms', 'plain_ms', 'bound_ms', 'library_ms', 'max_abs_err'):
        assert row[key] == rec[key]


def test_gpt_arms_share_the_width_and_name_their_kernels():
    """The three gpt_small arms: one width (768), head dims 64, 256 and
    384, each at batch 4 for 3 steps, and for each the kernels the
    dispatch must run: the wgmma kernels at 64 and 256 (dK/dV with
    64-row kv tiles at 256), the wgmma column-chunked kernels at 384."""
    from autodist_tpu_torch.models.transformer import TransformerConfig
    dims = {}
    for name, (heads, batch, steps, kernels) in chip_smoke.GPT_ARMS.items():
        cfg = TransformerConfig.gpt_small(n_heads=heads)
        dims[name] = cfg.dim // heads
        assert set(kernels) == {'fwd', 'dq', 'dkv'}
        assert (batch, steps) == (4, 3)
    assert dims == {'gpt_small': 64, 'gpt_small_head_dim_256': 256,
                    'gpt_small_head_dim_384': 384}
    arms = chip_smoke.GPT_ARMS
    assert arms['gpt_small_head_dim_256'][3]['dkv'] == 'dkv_wgmma_kernel'
    assert arms['gpt_small_head_dim_384'][3] == {
        'fwd': 'fwd_wgmma_cols_kernel', 'dq': 'dq_wgmma_cols_kernel',
        'dkv': 'dkv_wgmma_cols_kernel'}
    for shape, arm in ((chip_smoke.GPT_D256_SHAPE, 'gpt_small_head_dim_256'),
                       (chip_smoke.GPT_D384_SHAPE, 'gpt_small_head_dim_384')):
        heads, batch = arms[arm][:2]
        assert shape == (batch, heads, 4096, dims[arm])
        assert shape[1] * shape[3] == \
            chip_smoke.GPT_SHAPE[1] * chip_smoke.GPT_SHAPE[3]


def test_ptxas_summary_reads_the_dkv_wgmma_kernels_from_head_dim_256():
    """The bf16 dK/dV kernels from head dim 256 on, as nvcc 12.8 names
    them: dkv_wgmma_kernel<256, 2 stages> beside the 64- and 128-wide
    instances of the same template, and dkv_wgmma_cols_kernel<256-column
    chunk, 2 and 2 stages>; the spill count of each is its own."""
    ns = '_ZN49_GLOBAL__N__f013377b_18_flash_attention_cu_fa_fwd'
    log = '\n'.join(
        "ptxas info    : Compiling entry function '%s%s' for 'sm_90a'\n"
        "ptxas info    : Function properties for %s%s\n"
        "    0 bytes stack frame, %d bytes spill stores, 0 bytes spill "
        "loads\nptxas info    : Used %d registers, used 16 barriers"
        % (ns, name, ns, name, spill, regs) for name, spill, regs in (
            ('16dkv_wgmma_kernelILi256ELi2EEEv14CUtensorMap_stS1_S1_S1_S1_'
             'S1_S1_S1_ifi', 0, 168),
            ('16dkv_wgmma_kernelILi64ELi3EEEv14CUtensorMap_stS1_S1_S1_S1_'
             'S1_S1_S1_ifi', 4, 168),
            ('21dkv_wgmma_cols_kernelILi256ELi2ELi2EEEv14CUtensorMap_stS1_'
             'S1_S1_S1_S1_S1_S1_iifi', 0, 168)))
    assert chip_smoke.ptxas_summary(log) == {
        'dkv_wgmma_kernel<bf16,256>': '168 regs, 0 B spilled',
        'dkv_wgmma_kernel<bf16,64>': '168 regs, 4 B spilled',
        'dkv_wgmma_cols_kernel<bf16,256>': '168 regs, 0 B spilled'}


def test_ptxas_summary_reads_the_cross_entropy_kernels():
    """The LM head's NLL pair as nvcc 12.8 names it: the source's
    anonymous namespace carries its first entry's name (``xent_fwd``),
    which must not make the backward read as the forward."""
    ns = '_ZN49_GLOBAL__N__0c125aea_16_cross_entropy_cu_xent_fwd'
    log = '\n'.join(
        "ptxas info    : Compiling entry function '%s%s' for 'sm_90a'\n"
        "ptxas info    : Function properties for %s%s\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\nptxas info    : Used %d registers, used 1 barriers"
        % (ns, name, ns, name, regs) for name, regs in (
            ('15xent_bwd_kernelIfEEvPKT_xPKxPKfS7_PS1_i', 40),
            ('15xent_bwd_kernelI13__nv_bfloat16EEvPKT_xPKxPKfS8_PS2_i', 40),
            ('15xent_fwd_kernelIfEEvPKT_xPKxiPfS6_', 32),
            ('15xent_fwd_kernelI13__nv_bfloat16EEvPKT_xPKxiPfS7_', 40)))
    assert chip_smoke.ptxas_summary(log) == {
        'xent_bwd_kernel<f32>': '40 regs, 0 B spilled',
        'xent_bwd_kernel<bf16>': '40 regs, 0 B spilled',
        'xent_fwd_kernel<f32>': '32 regs, 0 B spilled',
        'xent_fwd_kernel<bf16>': '40 regs, 0 B spilled'}


@pytest.mark.parametrize('loss_chunk,want', [
    (None, {'fwd': 3, 'bwd': 3, 'plain': 0}),
    (128, {'fwd': 3, 'bwd': 3, 'plain': 0}),    # all 128 rows in one chunk
    (32, {'fwd': 24, 'bwd': 12, 'plain': 0}),   # 4 chunks, recomputed
])
def test_xent_want_counts_chunks_and_their_recompute(loss_chunk, want):
    from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)
    model = TransformerLM(TransformerConfig.tiny(
        dtype=torch.float32, loss_chunk=loss_chunk), device='cpu', seed=0)
    assert chip_smoke.xent_want(model, 2, 64, 3, 'cuda') == want
    assert chip_smoke.xent_want(model, 2, 64, 3, 'cpu') == {
        'fwd': 0, 'bwd': 0, 'plain': want['fwd'] + want['bwd']}


def test_xent_want_is_what_a_training_run_counts_on_the_cpu():
    """Two steps of the chunked head through ``Trainer``: the plain
    versions run as often as ``xent_want`` says, and a count that is off
    fails ``check_xent_launches``."""
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.api import Trainer
    from autodist_tpu_torch.kernels import cross_entropy as xe
    from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)
    from autodist_tpu_torch.parallel.axes import ParallelSpec
    model = TransformerLM(TransformerConfig.tiny(
        dtype=torch.float32, loss_chunk=32), device='cpu', seed=0)
    trainer = Trainer(model, optim.adamw(1e-4), spec=ParallelSpec(dp=1))
    xe.reset_launches()
    chip_smoke.train_steps(trainer, chip_smoke.make_batch(256, 2, 64), 2)
    got = dict(xe.LAUNCHES)
    assert got == {'fwd': 0, 'bwd': 0, 'plain': 24}
    chip_smoke.check_xent_launches('tiny', got, chip_smoke.xent_want(
        model, 2, 64, 2, 'cpu'))
    with pytest.raises(RuntimeError, match='cross-entropy launches'):
        chip_smoke.check_xent_launches('tiny', got, chip_smoke.xent_want(
            model, 2, 64, 3, 'cpu'))


def test_bf16_ulps_and_max_rel():
    a = torch.tensor([1.0, -3.0, 0.0, 1e-3])
    up = torch.tensor([1.0 + 2 ** -7, -3.0, 0.0, 1e-3])
    assert chip_smoke.bf16_ulps(up, a) == 1.0
    assert chip_smoke.bf16_ulps(a, a) == 0.0
    assert chip_smoke.bf16_ulps(a * 1.1, a) > 1.0
    assert chip_smoke.max_rel(torch.tensor([2.0, 1.0]),
                              torch.tensor([2.0, 0.5])) == 1.0


def test_xent_bytes_and_rows():
    """The byte bound of each kernel at gpt_small's head, and the rows of
    the ``kernels`` line: a row per kernel and shape, its launches those
    of the first path that gives that shape."""
    r, v = chip_smoke.XE_SHAPES['gpt_small']
    assert (r, v) == (16384, 32000)
    assert chip_smoke.xent_bytes('fwd', r, v) == r * v * 2 + r * 16
    assert chip_smoke.xent_bytes('bwd', r, v) == 2 * r * v * 2 + r * 16
    recs = {name: {k: {'cuda_kernel': 'xent_%s_kernel<bf16>' % k,
                       'errors': {}, 'ms': 1.0, 'plain_ms': 9.0,
                       'bound_ms': 0.9, 'bound_by': 'bytes',
                       'bound_share': 0.9} for k in ('fwd', 'bwd')}
            for name in chip_smoke.XE_SHAPES}
    rows = chip_smoke.xent_rows(recs, {
        'gpt_small': {'gpt_small': {'fwd': 3, 'bwd': 3, 'plain': 0},
                      'auto_strategy': {'fwd': 2, 'bwd': 2, 'plain': 0}},
        'bert_large': {'bert_large': {'fwd': 2, 'bwd': 2, 'plain': 0}}})
    assert [(row['name'], row['launches'], row['shape']) for row in rows] \
        == [('cross_entropy_fwd_gpt_small', 3, [16384, 32000]),
            ('cross_entropy_bwd_gpt_small', 3, [16384, 32000]),
            ('cross_entropy_fwd_bert_large', 2, [4096, 30522]),
            ('cross_entropy_bwd_bert_large', 2, [4096, 30522])]
    assert rows[0]['launches_by_path'] == {'gpt_small': 3,
                                           'auto_strategy': 2}
    assert rows[1]['cuda_kernel'] == 'xent_bwd_kernel<bf16>'
    assert rows[0]['source'] == chip_smoke.XE_SOURCE


class _SmemLib:
    """fa_wgmma_smem / cb_* as the built libraries answer them: bytes by
    (kernel, head dim), 0 where the head dim takes no wgmma kernel."""

    def __init__(self, table):
        self.table = table

    def fa_wgmma_smem(self, kernel, d):
        return self.table.get((kernel, d), 0)

    def cb_block_n(self, c_out):
        return 128 if c_out == 512 else 256

    def cb_wgmma_smem(self, c_out):
        return 1000 * self.cb_block_n(c_out)


def test_wgmma_smem_names_every_warp_specialised_kernel():
    """The build phase's shared memory, under the names ptxas_summary
    gives: the three wgmma kernels at 64, 128 and 256, the three chunk
    kernels by their 256-column chunk (read at head dim 320), K4 by its
    tile width."""
    table = {(k, d): 100 * k + d for k in range(3) for d in (64, 128, 256,
                                                             320)}
    smem = chip_smoke.wgmma_smem(_SmemLib(table), _SmemLib({}))
    for i, name in enumerate(('fwd', 'dq', 'dkv')):
        for d in (64, 128, 256):
            assert smem['%s_wgmma_kernel<bf16,%d>' % (name, d)] == 100 * i + d
        assert smem['%s_wgmma_cols_kernel<bf16,256>' % name] == 100 * i + 320
    assert smem['cb_wgmma_kernel<256>'] == 256000
    assert smem['cb_wgmma_kernel<128>'] == 128000
    assert len(smem) == 12 + 2


# -- the functional Trainer phases' helpers, at tiny width on the CPU --------
def test_ncf_trainer_phase_at_tiny_width(tmp_path):
    """fit with prefetch, eval and checkpoints every 10 steps; the
    restore bitwise; profile leaving the params; grad_accum=4 against 1
    within its stated tolerance."""
    rec = chip_smoke.ncf_trainer_phase(chip_smoke.NCF_SMALL, 'cpu',
                                       str(tmp_path))
    assert len(rec['losses']) == 20 and rec['checkpoints'] == [10, 20]
    assert [s for s, _ in rec['eval_loss']] == [10, 20]
    assert len(rec['step_seconds']) == 19 and rec['examples_per_s'] > 0
    assert rec['restore_bitwise'] and rec['profile_left_params']
    assert rec['accum_loss_rel'] <= chip_smoke.ACCUM_LOSS_REL


def test_lm1b_phase_at_tiny_width():
    arms = chip_smoke.lm1b_phase(chip_smoke.LM1B_SMALL, 'cpu', steps=2)
    assert arms['none']['losses'] == arms['full']['losses']
    assert arms['remat_loss_rel'] == 0.0


# -- the MoE slice's phases, at tiny width on the CPU -------------------------
def test_moe_arm_is_switch_base_width_with_gshard_routing():
    """gpt_small_moe8: d 768, d_ff 3072, 12 layers, 8 experts, top 2,
    capacity factor 2.0 (capacity 2048 at seq 4096), remat, head dim 64
    (the D-64 wgmma kernels of the gpt_small arm)."""
    from autodist_tpu_torch.models.moe import MoeMlp
    from autodist_tpu_torch.models.transformer import TransformerConfig
    cfg = TransformerConfig.gpt_small(max_len=4096, **chip_smoke.MOE_ARM)
    assert (cfg.dim, cfg.dim * cfg.mlp_ratio, cfg.n_layers) == \
        (768, 3072, 12)
    assert (cfg.moe_experts, cfg.moe_top_k, cfg.remat) == (8, 2, True)
    assert cfg.dim // cfg.n_heads == 64 and cfg.moe_aux_coef == 0.01
    mlp = MoeMlp(768, 3072, 8, top_k=2, device='meta')
    assert mlp.capacity(4096) == 2048
    assert (chip_smoke.MOE_BATCH, chip_smoke.MOE_STEPS) == (4, 3)


def test_moe_phase_at_tiny_width():
    """The MoE phase's checks on the CPU (no kernel launches there): the
    first loss is ce + coef * aux, ce near ln(vocab), aux about one a
    layer."""
    from autodist_tpu_torch.models.transformer import TransformerConfig
    cfg = TransformerConfig.tiny(dtype=torch.float32, moe_experts=4,
                                 remat=True)
    rec = chip_smoke.moe_phase(cfg, 2, 64, 2, 'cpu')
    assert len(rec['losses']) == 2 and rec['capacity'] == 64
    assert rec['launches'] == {'fwd': 0, 'dq': 0, 'dkv': 0}
    assert 0.9 * 2 <= rec['first_aux'] <= 2.0 * 2
    assert rec['tokens_per_s'] > 0


def test_small_moe_reference_runs_both_sides():
    """small_moe_reference's comparison, with the CPU on both sides."""
    out = chip_smoke.small_moe_reference(devices=('cpu', 'cpu'))
    assert out['loss'][0] == out['loss'][1] and out['max_grad_err'] == 0.0


def test_transformer_options_phase_at_tiny_width():
    """Every remat policy gives the remat arm's losses bit for bit on the
    CPU; the chunked head (4 chunks of 32 rows) to the stated bound."""
    from autodist_tpu_torch.models.transformer import TransformerConfig
    arms = chip_smoke.transformer_options_phase(
        TransformerConfig.tiny(dtype=torch.float32), 2, 64, 'cpu',
        loss_chunk=32)
    assert set(arms) == {'remat', 'save_attn', 'dots', 'dots_no_batch',
                         'no_remat', 'loss_chunk'}
    for name, rec in arms.items():
        assert len(rec['losses']) == 2
        if name != 'loss_chunk':
            assert rec['losses'] == arms['remat']['losses'], name
    assert arms['loss_chunk']['first_loss_rel'] <= \
        chip_smoke.OPTIONS_FIRST_LOSS_REL
    assert set(chip_smoke.option_arms(4096)['loss_chunk'].items()) == \
        {('remat', True), ('loss_chunk', 4096)}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_batch_norm_phase_at_tiny_width(dtype):
    recs = chip_smoke.batch_norm_phase([(2, 4, 4, 8), (4, 2, 2, 16)], dtype,
                                       'cpu')
    assert [r['shape'] for r in recs] == [[2, 4, 4, 8], [4, 2, 2, 16]]
    for r in recs:
        assert set(r['rel_err']) == {'y', 'dx', 'd_gamma', 'd_beta'}
        assert max(r['rel_err'].values()) <= chip_smoke.BN_TOL
    assert [s[-1] for s in chip_smoke.BN_SHAPES] == [256, 512, 1024, 2048]


def test_auto_strategy_phase_at_tiny_width():
    """The auto_strategy phase's checks at tiny width on the CPU, against
    the H100 row: the ranked table, the trained pick, an MFU in (0, 1]
    (tiny here: the CPU is not the card the peak describes) and the
    one-rank calibration that gives the analytic constants back."""
    from autodist_tpu_torch.models.transformer import TransformerConfig
    cfg = TransformerConfig.tiny(dtype=torch.float32, max_len=512)
    rec = chip_smoke.auto_strategy_phase(cfg, 2, 512, 2, 'cpu',
                                         'NVIDIA H100 80GB HBM3')
    assert rec['peaks'] == [989e12, 3.35e12]
    assert rec['picked'] == 'AllReduce(RING)'   # the name breaks the tie
    assert rec['calibrated'] is False
    assert rec['memory']['available'] is False
    assert rec['cost']['flops'] > 0 and rec['cost']['kernel_launches'] == 0


# -- this slice's phases: servable export, records, the adapter ---------------
NEW_PHASES = ('serve_gpt_small_phase', 'serve_resnet_phase',
              'imagenet_records_phase', 'functional_model_phase',
              'dsl_saved_model_phase')


def _main_call_lines():
    """{function name: first line main() calls it on}, and the line of
    the card's line (``print(smi, ...)``)."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(chip_smoke))
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == 'main')
    calls, card_line = {}, None
    for node in ast.walk(main):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            calls.setdefault(node.func.id, node.lineno)
            if node.func.id == 'print' and node.args and \
                    isinstance(node.args[0], ast.Name) and \
                    node.args[0].id == 'smi':
                card_line = node.lineno
    return calls, card_line


def test_new_phases_run_in_main_after_phase_10_and_before_the_card_line():
    calls, card_line = _main_call_lines()
    assert card_line is not None
    for name in NEW_PHASES:
        assert name in calls, name
        assert calls['small_sparse_reference'] < calls[name] < card_line, \
            name


def test_new_phases_name_their_kernels():
    """The serving phases check K1 and K4 by the launch counters of the
    serving process, the records phase K4 by the training step's count,
    and the kernels line carries each path's launches."""
    import inspect
    src = {name: inspect.getsource(getattr(chip_smoke, name))
           for name in NEW_PHASES}
    assert "fa.kernel_name('fwd'" in src['serve_gpt_small_phase']
    assert "['flash_fwd']" in src['serve_gpt_small_phase']
    assert "['conv_bn']" in src['serve_resnet_phase']
    assert 'RESNET_K4_PER_STEP' in src['imagenet_records_phase']
    assert 'native=True' in src['imagenet_records_phase']
    main = inspect.getsource(chip_smoke.main)
    for path in ('serve_gpt_small', 'imagenet_records',
                 'serve_resnet101_fused'):
        assert "'%s'" % path in main, path
    assert 'flash_attention.reset_launches' not in chip_smoke._SERVE
    assert 'c.reset_launches()' in chip_smoke._SERVE


def _imports(source, path='<string>'):
    import ast
    for node in ast.walk(ast.parse(source, path)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_chip_smoke_and_examples_import_no_jax():
    import glob
    import os
    files = [chip_smoke.__file__] + sorted(glob.glob(os.path.join(
        os.path.dirname(chip_smoke.__file__), 'examples_torch', '*.py')))
    assert len(files) == 10
    for path in files:
        with open(path) as f:
            mods = set(_imports(f.read(), path))
        assert not {m.split('.')[0] for m in mods} & \
            {'jax', 'jaxlib', 'autodist_tpu'}, (path, mods)
    # the serving process: torch, numpy, the port's load_servable and its
    # kernels' launch counters
    served = {m.split('.')[0] for m in _imports(chip_smoke._SERVE)}
    assert served == {'json', 'os', 'sys', 'time', 'numpy', 'torch',
                      'autodist_tpu_torch'}
    assert {m for m in _imports(chip_smoke._SERVE)
            if m.startswith('autodist_tpu_torch')} == \
        {'autodist_tpu_torch.checkpoint.export', 'autodist_tpu_torch.kernels'}
    assert 'load_servable(bundle, device=device)' in chip_smoke._SERVE
    assert 'torch.export.load' not in chip_smoke._SERVE


def test_serve_gpt_small_phase_at_tiny_width(tmp_path):
    """The flash arm (S 512) of a tiny LM exported, served in a fresh
    process at batches 2 and 1, and held to eager (the CPU's plain
    versions: the same bits)."""
    from autodist_tpu_torch.models.transformer import TransformerConfig
    rec = chip_smoke.serve_gpt_small_phase(
        TransformerConfig.tiny(dtype=torch.float32, max_len=512), (2, 1),
        'cpu', str(tmp_path))
    assert set(rec['requests']) == {'b2', 'b1'}
    for req in rec['requests'].values():
        assert req['max_abs_err'] <= chip_smoke.SERVE_REL * \
            req['max_abs_logit']
        assert req['served_tokens_per_s'] > 0


def test_serve_resnet_phase_at_tiny_width(tmp_path):
    from autodist_tpu_torch.models import vision
    rec = chip_smoke.serve_resnet_phase(
        vision.ResNet((1, 1), num_classes=10, device='cpu'), 4, 32, 'cpu',
        str(tmp_path))
    assert rec['static_batch'] and rec['max_abs_err'] <= \
        chip_smoke.SERVE_REL * rec['max_abs_logit']


def test_imagenet_records_phase_at_tiny_width(tmp_path):
    from autodist_tpu_torch.models import vision
    rec = chip_smoke.imagenet_records_phase(
        vision.ResNet((1, 1), num_classes=10, device='cpu'), 4, 32, 2, 3,
        'cpu', str(tmp_path))
    assert len(rec['losses']) == 3 and rec['files_removed']
    assert len(rec['next_batch_ms']) == 3
    assert list(tmp_path.iterdir()) == []


def test_functional_model_and_dsl_saved_model_phases_on_the_cpu(tmp_path):
    rec = chip_smoke.functional_model_phase('cpu')
    assert len(rec['losses']) == 8 and rec['builder_rel_spread'] == 0.0
    rec = chip_smoke.dsl_saved_model_phase('cpu', str(tmp_path))
    assert rec['max_abs_err'] < rec['tol']


# -- the loose PS plane ----------------------------------------------------
# a width at which the i8 wire's headers are small beside the rows (the
# phase holds its push 3.5-4.1x below f32's, as at NCF_FULL)
LOOSE_TWIN = {'users': 4096, 'items': 2048, 'mf_dim': 64,
              'mlp': (128, 64, 32), 'batch': 256}


def test_loose_phases_run_in_main_before_the_card_line():
    calls, card_line = _main_call_lines()
    assert calls['dsl_saved_model_phase'] < calls['loose_single_phase'] \
        < calls['loose_pair_phase'] < card_line


def test_loose_single_phase_at_tiny_width():
    """One loose worker at depths 1 and 2 and the lock-step run: depth 2
    bitwise equal to depth 1, depth 1's losses the lock-step run's."""
    runs = chip_smoke.loose_single_phase(chip_smoke.NCF_SMALL, 3, 'cpu')
    assert runs[1][0] == runs[2][0]
    assert runs[2][3]['pipeline']['depth'] == 2
    assert runs[1][3]['pull_bytes'] == 3 * sum(
        v.size * 4 for v in runs[1][2].values())


def test_loose_pair_phase_at_small_width():
    """Two loose worker processes (``chip_smoke.py --loose-worker``) of
    each kind on each wire: the phase's requirements hold (the one-batch
    runs' tables on the PS are the initial values plus both workers'
    pushes), its records carry what it emits, and on new batches the
    i8 pushes grow (rows whose error-feedback residual is not zero ride
    every later push) while f32's stay near the first."""
    summary = chip_smoke.loose_pair_phase(LOOSE_TWIN, 10, 'cpu')
    for kind in chip_smoke.LOOSE_PAIR_KINDS:
        for wire in ('f32', 'i8'):
            assert [r['pid'] for r in summary[kind][wire]] == [0, 1]
            for r in summary[kind][wire]:
                assert r['max_lag'] <= chip_smoke.LOOSE_STALENESS
                assert len(r['push_bytes_by_push']) == 10
                assert r['idle_share'] is None
                assert r['pull_bytes_per_pull'] == \
                    summary['fresh']['f32'][r['pid']]['pull_bytes_per_pull']
    # every table pushes row-sparse every step, and the last push landed
    # before the stats were read; on new batches f32 still does
    for r in summary['one_batch']['f32'] + summary['one_batch']['i8'] + \
            summary['fresh']['f32']:
        assert r['sparse_pushes'] == 4 * 10
    for r in summary['fresh']['f32']:
        sizes = r['push_bytes_by_push']
        assert max(sizes) < 1.2 * min(sizes)
    for r in summary['fresh']['i8']:
        sizes = r['push_bytes_by_push']
        assert sizes[-1] > 2 * sizes[0] and r['rows_by_push'][1] > \
            r['rows_by_push'][0]
    lo, hi = chip_smoke.I8_PUSH_RATIO
    assert all(lo <= x <= hi for x in summary['push_ratio_first'])
    assert all(x < lo for x in summary['push_ratio_whole_run']['fresh'])


# -- the loose plane's membership half -----------------------------------
def test_loose_elastic_runs_in_main_after_the_pair_before_the_card_line():
    calls, card_line = _main_call_lines()
    assert calls['loose_pair_phase'] < calls['loose_elastic_phase'] \
        < card_line


def test_loose_elastic_phase_at_tiny_width():
    """The five runs of ``loose_elastic`` (grow, exclude, restart, swap,
    serve), each in worker processes of ``chip_smoke.py
    --elastic-worker``, at NCF_SMALL on the CPU: their requirements hold
    (three parties after the join and one armed boundary for all three
    members, p2 excluded and its kept connection fenced, the replacement
    under generation 1 at the published step, every table re-keyed bit
    for bit at the swap's boundary, the served rows and dense values
    equal to the PS at the pinned step), and their records carry what
    the card's run prints."""
    out = chip_smoke.loose_elastic_phase(chip_smoke.NCF_SMALL,
                                         chip_smoke.ELASTIC_STEPS, 'cpu')
    assert list(out) == list(chip_smoke.ELASTIC_RUNS)
    # every worker's flight events replay clean (the analysis phase's
    # replay of the card's traces)
    traces = {k: v for k, v in chip_smoke.FLIGHT_TRACES.items()
              if k.startswith('loose_elastic/')}
    assert {k.split('/')[1] for k in traces} == set(chip_smoke.ELASTIC_RUNS)
    assert all(n > 0 for n in chip_smoke.replay_traces(traces).values())
    grow = out['grow']
    assert grow['replan']['world'] == 3 and grow['replan']['predicted']
    assert [w['start_step'] for w in grow['workers']] == \
        [0, 0, grow['workers'][2]['start_step']]
    assert grow['workers'][2]['start_step'] >= chip_smoke.ELASTIC_JOIN_AT
    assert all(w['examples_per_s_after_join'] > 0 for w in grow['workers'])
    exc = out['exclude']
    assert exc['zombie_write_refused'] is True
    # the survivors' gate held until the exclusion: a heartbeat window
    assert exc['kill_to_survivors_unblocked_s'] >= \
        exc['heartbeat_timeout_s'] * 0.5
    rst = out['restart']
    assert rst['replacement']['generation'] == 1
    assert rst['replacement']['start_step'] == chip_smoke.ELASTIC_KILL_AT - 1
    assert rst['recovery_wall_s'] > 0
    swap = out['swap']
    init = chip_smoke.ncf_init(chip_smoke.NCF_SMALL)
    assert swap['rekeyed_vars'] >= len(chip_smoke.NCF_TABLES)
    assert swap['rekeyed_bytes'] >= sum(init[t].nbytes
                                        for t in chip_smoke.NCF_TABLES)
    assert min(swap['table_shards'].values()) > 1
    assert 0 < swap['stage_to_arm_s'] <= swap['stage_to_ready_s']
    srv = out['serve']
    assert srv['rows_equal_pinned_step'] and srv['membership'] == [2, 2, 0]
    assert srv['worker_steps'] == [chip_smoke.ELASTIC_STEPS] * 2
    assert srv['lookups'] > 0 and srv['forwards'] > 0
    assert 0 <= srv['row_cache_hit_rate'] <= 1



# -- the chief's launch and the cohort telemetry plane ----------------------
NCF_LAUNCH_CPU = {'users': 20000, 'items': 5000, 'mf_dim': 16,
                  'mlp': (16, 8, 4), 'batch': 32}


def test_loose_launch_runs_in_main_after_the_elastic_phase():
    calls, card_line = _main_call_lines()
    assert calls['loose_elastic_phase'] < calls['loose_launch_phase'] \
        < card_line


def test_loose_launch_phase_at_tiny_width():
    """Both runs of ``loose_launch`` at NCF_SMALL on the CPU, each in
    processes of ``chip_smoke.py --launch-run``: (a) the chief launches
    p1 through the ssh and scp shims, the monitor names p1 slow on push
    once its pushes are delayed (any verdict for p1 before the delay
    recovered before it), the scale-up's joiner is re-ranked for
    with measured constants, the trace has the three workers' rows and
    the telemetry namespace is empty after close; (b) the launcher's run
    exits 0 and its coord service is gone. The requirements are the
    card's; the records carry what the card's run prints. The tables are
    20,000 and 5,000 rows (NCF_SMALL's are too small for a pull to
    weigh against an RPC's latency, and the link fit needs both). Off
    the card the run's events gate it, not clocks: p1's pushes are held
    until the chief has published the verdict (each hold may last
    longer than the one before), the join waits for the refit and for
    every member at the join step, and the run for the verdict and the
    migration; so no requirement rests on a delay outweighing a loaded
    host's noise. Every worker's flight events replay clean."""
    out = chip_smoke.loose_launch_phase(NCF_LAUNCH_CPU, 'cpu')
    ssh, cli = out['ssh'], out['cli']

    def part(rec, *keys):
        return {k: rec.get(k) for k in keys}
    assert ssh['verdict']['attributed_phase'] == 'push', \
        part(ssh, 'verdict', 'verdicts', 'delay', 'refit_at',
             'delay_cleared_at', 'verdict_published_at', 'monitor')
    assert ssh['detection_latency_steps'] >= 0, \
        part(ssh, 'detection_latency_steps', 'verdict', 'delay')
    assert ssh['rerank']['cost_constants'] == 'measured', \
        part(ssh, 'rerank', 'fitted', 'recalibrations', 'scaled_up_at',
             'refit_at')
    assert ssh['trace_rows'] == ['worker p0', 'worker p1', 'worker p2'], \
        part(ssh, 'trace_rows')
    assert ssh['telemetry_left'] == 0 and ssh['delay']['fired'] > 0, \
        part(ssh, 'telemetry_left', 'delay')
    assert ssh['launch_s'] > 0 and ssh['join_step'] >= \
        chip_smoke.LAUNCH_JOIN_AT, \
        part(ssh, 'launch_s', 'join_step', 'scaled_up_at', 'join_claim_s')
    assert all(v > 0 for v in ssh['telemetry_bytes_per_step'].values()), \
        part(ssh, 'telemetry_bytes_per_step')
    assert ssh['fitted']['beta_s_per_byte'] > 0, \
        part(ssh, 'fitted', 'analytic', 'recalibrations')
    assert cli['rc'] == 0 and cli['service_gone'], \
        part(cli, 'rc', 'service_gone', 'seconds', 'losses')
    # p1's pushes were held until the verdict came, each hold no longer
    # than its bound, and each after it for the bound the verdict found
    holds, first = ssh['delay']['holds_s'], ssh['delay']['seconds']
    assert holds and ssh['delay']['hold_after_s'] and all(
        w <= first * min(chip_smoke.LAUNCH_HOLD_GROWTH ** i,
                         chip_smoke.LAUNCH_HOLD_MAX) + 0.5
        for i, w in enumerate(holds)), part(ssh, 'delay')
    traces = {k: v for k, v in chip_smoke.FLIGHT_TRACES.items()
              if k.startswith('loose_launch/')}
    assert len(traces) == 5, sorted(traces)
    assert all(n > 0 for n in chip_smoke.replay_traces(traces).values())


# -- the ring's blocks, the grid and its report ------------------------------
@pytest.mark.parametrize('causal', [True, False])
def test_ring_blocks_merge_equals_local_attention(causal):
    """``ring_blocks`` (each rank's block-and-merge in its visit order) at
    a tiny width equals attention over the whole sequence (f32: the same
    products, merged in another order)."""
    from autodist_tpu_torch.parallel.ring_attention import \
        local_flash_attention
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 32, 8, generator=gen) for _ in range(3))
    got = chip_smoke.ring_blocks(q, k, v, 4, causal)
    want = local_flash_attention(q, k, v, causal=causal)
    assert (got - want).abs().max() < 1e-5
    assert chip_smoke.ring_visits(1, 4) == [1, 0, 3, 2]


def test_ring_blocks_phase_on_the_cpu():
    rec = chip_smoke.ring_blocks_phase('cpu', shape=(1, 2, 64, 8), n=4,
                                       dtype=torch.float32, device='cpu')
    assert rec['ok'] and rec['block_shape'] == [1, 2, 16, 8]
    assert rec['hop_bytes'] == 2 * 1 * 2 * 16 * 8 * 4
    assert 'hop_compute_ms' not in rec    # a device time only on the card


def test_grid_state_bytes_predicts_each_layout():
    numels = {'a': 8, 'b': 6}
    dims = {'params': {'a': None, 'b': None},
            'opt_state': {'a': None, 'b': None}}
    assert chip_smoke.grid_state_bytes(dims, numels, 2) == 16 * 14
    dims['opt_state']['a'] = 0                            # zero 2
    assert chip_smoke.grid_state_bytes(dims, numels, 2) == \
        4 * 8 + 16 * 8 // 2 + 16 * 6
    dims['params']['a'] = 0                               # zero 3
    assert chip_smoke.grid_state_bytes(dims, numels, 2) == \
        16 * 8 // 2 + 16 * 6


def test_grid_trainers_phase_on_a_gloo_pair(capsys):
    """``grid_trainers`` at a tiny width over two gloo processes on the
    CPU: every run's losses within ``GRID_LOSS_REL`` of one process's,
    ZeRO 2 and 3 predicted to hold less state than zero 1, and one line
    a run."""
    out = chip_smoke.grid_trainers_phase(
        'cpu', device='cpu', n=2, seq=32, batch=2, zero_seq=32, dim=32,
        layers=2, heads=2, vocab=64, steps=2)
    assert set(out) == {'ring', 'ulysses', 'zero1', 'zero2', 'zero3',
                        'partitioned_ps'}
    for name, rec in out.items():
        assert rec['max_rel_loss_diff'] <= chip_smoke.GRID_LOSS_REL, name
        assert 'state_bytes' not in rec    # device memory only on the card
    state = {k: out[k]['predicted_state_bytes']
             for k in ('zero1', 'zero2', 'zero3')}
    assert state['zero3'] < state['zero2'] < state['zero1']
    assert out['zero1']['sharded_leaves'] == 0
    assert out['zero3']['sharded_leaves'] == \
        out['partitioned_ps']['sharded_leaves'] > 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if '"grid_trainers"' in l]
    assert len(lines) == 7


def test_grid_state_bytes_counts_the_model_and_expert_shards():
    numels = {'a': 8, 'b': 6}
    dims = {'params': {'a': None, 'b': None},
            'opt_state': {'a': None, 'b': None},
            'groups': {'a': {'model': 1}, 'b': {}}}
    sizes = {'data': 1, 'model': 2, 'expert': 1}
    assert chip_smoke.grid_state_bytes(dims, numels, 1, sizes) == \
        16 * 8 // 2 + 16 * 6
    dims['groups']['a'] = {'model': 1, 'expert': 0}      # two groups
    assert chip_smoke.grid_state_bytes(dims, numels, 1, dict(
        sizes, expert=2)) == 16 * 8 // 4 + 16 * 6


def test_tp_ep_grid_phase_on_a_gloo_world_of_4(capsys):
    """``tp_ep_grid`` at a tiny width over four gloo processes on the
    CPU: the tp, ep, ep x tp and tp x dp (zero 3) runs, each run's
    losses within ``GRID_LOSS_REL`` of one process's, every run
    predicted to hold less state a rank than one process, and one line
    a run."""
    out = chip_smoke.tp_ep_grid_phase(
        'cpu', device='cpu', n=4, seq=32, batch=2, dp_seq=32, dim=32,
        layers=2, heads=4, vocab=64, experts=4, steps=2)
    assert set(out) == {'tp', 'ep', 'ep_tp', 'tp_dp'}
    for name, rec in out.items():
        assert rec['max_rel_loss_diff'] <= chip_smoke.GRID_LOSS_REL, name
        assert rec['cards'] == 4 and 'state_bytes' not in rec
    assert out['tp']['spec'] == {'tp': 4} and \
        out['tp_dp']['spec'] == {'tp': 2, 'dp': 2, 'zero': 3}
    for name, moe in (('tp', {}), ('ep', {'moe_experts': 4}),
                      ('ep_tp', {'moe_experts': 4}), ('tp_dp', {})):
        model = chip_smoke.TransformerLM(chip_smoke.TransformerConfig(
            vocab=64, dim=32, n_layers=2, n_heads=4, max_len=32, **moe),
            device='cpu')
        whole = sum(p.numel() for p in model.parameters()) * \
            sum(chip_smoke.STATE_BYTES.values())
        assert out[name]['predicted_state_bytes'] < whole, name
    lines = [l for l in capsys.readouterr().out.splitlines()
             if '"tp_ep_grid"' in l]
    assert len(lines) == 5


def test_check_state_bytes_holds_growth_and_each_margin():
    """``check_state_bytes`` passes a record within its prediction and
    refuses growth from the first step to the last, tensors that asked
    for more than the state and the inputs, and a card that holds more
    than those and the allocator's slack."""
    rec = {'predicted_state_bytes': 1000, 'step_input_bytes': 100,
           'state_margin_bytes': 300, 'state_requested_by_step': [1050] * 3,
           'state_requested_bytes': 1050, 'state_bytes': 1250}
    chip_smoke.check_state_bytes('run', rec)
    for change, words in (
            ({'state_requested_by_step': [1050, 1060, 1070]}, 'grew'),
            ({'state_requested_by_step': [1101] * 3}, 'asked for'),
            ({'state_bytes': 1301}, 'a card after a step')):
        with pytest.raises(RuntimeError, match=words):
            chip_smoke.check_state_bytes('run', dict(rec, **change))


def test_tp_ep_grid_phase_reports_one_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    assert chip_smoke.tp_ep_grid_phase('card') is None
    assert 'did not run on one card' in capsys.readouterr().out


def test_grid_phases_run_in_main_after_the_ulysses_kernels():
    calls, card_line = _main_call_lines()
    assert calls['ulysses_kernels_phase'] < calls['grid_phases'] < \
        calls['check_conv_bn'] < card_line


def test_grid_trainers_phase_reports_one_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    assert chip_smoke.grid_trainers_phase('card') is None
    assert 'did not run on one card' in capsys.readouterr().out


# -- the pipeline: its microbatch's kernels and the pp grid ------------------
def test_check_mfu_holds_the_unrounded_share():
    """A CPU step of seconds against the H100's peak: ``classify_regime``
    rounds its MFU to 6 places, to 0.0, and the requirement reads the
    unrounded share (flops / peak / seconds), which stays in (0, 1]; a
    share above 1 still fails."""
    cost = {'flops': 2.0e6, 'bytes_accessed': 1.0e6}
    roof, share = chip_smoke.check_mfu(cost, 30.0, 989e12, 3.35e12, 'H100')
    assert roof['mfu'] == 0.0
    assert share == pytest.approx(2.0e6 / 989e12 / 30.0) and share > 0
    with pytest.raises(RuntimeError, match='MFU'):
        chip_smoke.check_mfu({'flops': 1e16, 'bytes_accessed': 1.0}, 1.0,
                             989e12, 3.35e12, 'H100')


def test_pipeline_kernels_phase_at_tiny_width():
    """The stage of ``pipeline_kernels`` on the CPU at a tiny width: two
    layers on one microbatch through ``pipeline.run_stack``, forward and
    backward, the plain versions (no launch), a finite input gradient;
    the kernel checks run only on the card."""
    recs, launches = chip_smoke.pipeline_kernels_phase(
        'cpu', device='cpu', shape=(2, 2, 32, 16), layers=2)
    assert recs is None
    assert launches == {'fwd': 0, 'dq': 0, 'dkv': 0}


def test_pp_launches_follow_the_stage_the_microbatches_and_the_schedule():
    """gpt_small at pp 4, 4 microbatches, 3 steps: a stage holds 3
    layers, so GPipe launches 3 x 4 x 3 x (2, 1, 1) and each 1F1B
    variant one forward more a layer a microbatch; pp 2 x tp 2 holds 6
    layers a stage; the memory pair 3 layers x 16 microbatches."""
    runs, refs, one = chip_smoke.pp_configs(4)
    by = {r['name']: r for r in runs}
    assert chip_smoke.pp_launches(by['gpipe']) == \
        {'fwd': 72, 'dq': 36, 'dkv': 36}
    for name in ('1f1b_stash', '1f1b_remat'):
        assert chip_smoke.pp_launches(by[name]) == \
            {'fwd': 108, 'dq': 36, 'dkv': 36}
    assert chip_smoke.pp_launches(by['pp2_tp2']) == \
        {'fwd': 216, 'dq': 72, 'dkv': 72}
    assert chip_smoke.pp_launches(by['mem_gpipe']) == \
        {'fwd': 288, 'dq': 144, 'dkv': 144}
    assert set(refs.values()) == {r['name'] for r in one}
    assert by['gpipe']['batch'] // by['gpipe']['spec']['microbatches'] == \
        chip_smoke.PIPELINE_SHAPE[0]
    assert [r['name'] for r in chip_smoke.pp_configs(2)[0]] == \
        ['gpipe', '1f1b_stash', '1f1b_remat']


def test_pp_grid_phase_on_a_gloo_world_of_4(capsys):
    """``pp_grid`` at a tiny width over four gloo processes on the CPU:
    GPipe, 1F1B stash and remat at pp 4, pp 2 x tp 2 and the memory pair,
    each run's losses within ``PP_LOSS_REL`` of one process's, one line
    a run (device memory and launches only on the card)."""
    out = chip_smoke.pp_grid_phase(
        'cpu', device='cpu', n=4, seq=32, batch=8, microbatches=4,
        mem_seq=32, mem_batch=16, mem_microbatches=8, dim=32, layers=4,
        heads=2, vocab=64, steps=2)
    assert set(out) == {'gpipe', '1f1b_stash', '1f1b_remat', 'pp2_tp2',
                        'mem_gpipe', 'mem_1f1b_remat'}
    for name, rec in out.items():
        assert rec['max_rel_loss_diff'] <= chip_smoke.PP_LOSS_REL, name
        assert rec['tol'] == chip_smoke.PP_LOSS_REL, name
        assert rec['cards'] == 4 and 'peak_mem_bytes' not in rec
        assert rec['launches_by_rank'] == [{}] * 4
    assert out['pp2_tp2']['spec']['tp'] == 2
    lines = [l for l in capsys.readouterr().out.splitlines()
             if '"pp_grid"' in l]
    assert len(lines) == 7


def test_pp_grid_phase_reports_one_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    assert chip_smoke.pp_grid_phase('card') is None
    assert 'did not run on one card' in capsys.readouterr().out


def test_pipeline_phases_run_in_main_before_the_card_line():
    """``pipeline_kernels`` runs after the Ulysses and ring phases and
    before the grid phases, ``grid_phases`` runs ``pp_grid`` last, and
    the kernels line carries the pipeline rows."""
    import inspect
    calls, card_line = _main_call_lines()
    assert calls['ring_blocks_phase'] < calls['pipeline_kernels_phase'] < \
        calls['grid_phases'] < card_line
    assert calls['pipeline_rows'] < card_line
    src = inspect.getsource(chip_smoke.grid_phases)
    assert src.index('tp_ep_grid_phase(') < src.index('pp_grid_phase(')


@pytest.mark.parametrize('name', ['fwd', 'dq', 'dkv'])
def test_pipeline_rows_carry_the_stage_and_the_grid_launches(name):
    rec = {'max_abs_err': 0.01, 'bitwise_repeat': True,
           'cuda_kernel': '%s_wgmma_kernel<bf16,64>' % name, 'ms': 0.15,
           'plain_ms': 9.0, 'library_ms': 0.13, 'library': 'sdpa',
           'bound_ms': 0.05, 'bound_by': 'operations', 'tflops': 300.0,
           'bound_share': 0.33}
    recs = {n: dict(rec, cuda_kernel='%s_wgmma_kernel<bf16,64>' % n)
            for n in ('fwd', 'dq', 'dkv')}
    stage = {'fwd': 6, 'dq': 3, 'dkv': 3}
    row = {r['name']: r for r in chip_smoke.pipeline_rows(
        recs, stage, None)}['flash_attention_%s_pipeline' % name]
    assert row['launches'] == stage[name]
    assert row['shape'] == list(chip_smoke.PIPELINE_SHAPE)
    assert row['launches_by_path'] == {'pipeline_stage': stage[name]}
    pp = {run: {'launches': {recs[name]['cuda_kernel']: 72 + i}}
          for i, run in enumerate(('gpipe', '1f1b_stash', '1f1b_remat'))}
    row = {r['name']: r for r in chip_smoke.pipeline_rows(
        recs, stage, pp)}['flash_attention_%s_pipeline' % name]
    assert row['launches'] == 72
    assert row['launches_by_path']['pp_grid_1f1b_remat'] == 74


# -- the analysis subsystem and the last five examples ---------------------
def test_analysis_and_examples_run_in_main_after_the_loose_launch():
    calls, card_line = _main_call_lines()
    assert calls['loose_launch_phase'] < calls['analysis_phase'] < \
        calls['examples_phase'] < calls['bert_rows'] < card_line


def _loose_trace():
    """The flight events of a loose worker's two steps in this process
    (from its session's ``run_start`` on)."""
    from autodist_tpu_torch.telemetry import flight
    services = chip_smoke.start_services(1)
    try:
        chip_smoke.loose_single_run(chip_smoke.NCF_SMALL, 2, 'cpu',
                                    services[0][0], 2)
    finally:
        chip_smoke.stop_services(services)
    events = flight.recorder().events()
    start = max(i for i, e in enumerate(events) if e['kind'] == 'run_start')
    return events[start:]


def test_analysis_phase_on_the_cpu():
    """The CLI runs the lints in a process of its own (exit 0, clean) and
    a loose worker's trace replays clean; an empty trace and one that
    does not conform (a publish after the worker's exclusion) fail."""
    trace = _loose_trace()
    assert {'run_start', 'step_publish'} <= {e['kind'] for e in trace}
    lints = ('fence', 'env', 'swap-conformance', 'schedule')
    rec = chip_smoke.analysis_phase({'loose_single': trace},
                                    analyzers=lints)
    assert rec['cli_rc'] == 0 and set(rec['analyzers']) == set(lints)
    assert rec['events_replayed'] == {'loose_single': len(trace)}
    with pytest.raises(RuntimeError, match='empty'):
        chip_smoke.replay_traces({'none': []})
    seq = trace[-1]['seq']
    zombie = trace + [
        {'seq': seq + 1, 'kind': 'fence_bump', 'worker': 'p7'},
        {'seq': seq + 2, 'kind': 'exclude_claim', 'worker': 'p7'},
        {'seq': seq + 3, 'kind': 'step_publish', 'worker': 'p7', 'step': 9}]
    with pytest.raises(RuntimeError, match='fenced-write-commit'):
        chip_smoke.replay_traces({'zombie': zombie})


def test_examples_phase_at_tiny_width():
    """The bert, lm1b and ncf examples at their tiny widths (3 steps after
    a warm-up, falling losses) and the two DSL examples at theirs, on
    the CPU twice (the card's run against the CPU's, here the CPU's
    against itself): the same record the card's run prints."""
    rec = chip_smoke.examples_phase('cpu', tiny=True)
    for name in ('bert', 'lm1b', 'ncf'):
        losses = rec[name]['losses']
        assert len(losses) == chip_smoke.EXAMPLE_STEPS + 1, name
        assert losses[-1] < losses[0], (name, losses)
    # seq 64: the plain attention, no kernel
    assert rec['bert']['seq'] == 64 and rec['bert']['launches'] == {
        'fwd': 0, 'dq': 0, 'dkv': 0}
    assert rec['linear_regression']['err'] == {'W': 0.0, 'b': 0.0,
                                               'losses_rel': 0.0}
    assert rec['sentiment_classifier']['err']['emb_norm_rel'] == 0.0
    assert rec['sentiment_classifier']['emb_shape'] == (10000, 16)


def test_bert_rows_are_the_non_causal_bert_large_kernels():
    rec = {name: {'max_abs_err': 0.01, 'cuda_kernel': '%s_wgmma_kernel'
                  '<bf16,64>' % name, 'ms': 0.1, 'plain_ms': 2.0,
                  'library_ms': 0.1, 'library': 'sdpa', 'bound_ms': 0.05,
                  'bound_by': 'operations', 'tflops': 300.0,
                  'bound_share': 0.5} for name in ('fwd', 'dq', 'dkv')}
    rows = chip_smoke.bert_rows(rec, {'fwd': 192, 'dq': 96, 'dkv': 96})
    assert [r['name'] for r in rows] == [
        'flash_attention_%s_bert_large' % n for n in ('fwd', 'dq', 'dkv')]
    assert [r['launches'] for r in rows] == [192, 96, 96]
    assert [r['launches_a_step'] for r in rows] == [48, 24, 24]
    for row in rows:
        assert row['causal'] is False and row['shape'] == [8, 16, 512, 64]
        for key in ('route', 'source', 'replaces', 'max_abs_err', 'ms',
                    'plain_ms', 'bound_ms', 'bound_by', 'library_ms'):
            assert key in row, key
