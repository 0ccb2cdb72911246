"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA card (the kernels have no CPU mode) and skip without
one. The file imports no jax, so it runs on the machine with the card:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX.) Shapes include
ragged tile edges (S = 40, 96, 200 against 64-row tiles) and every head
dim the kernels take.
"""
import numpy as np
import pytest
import torch

from autodist_tpu_torch.kernels import flash_attention as fa


def _inputs(shape, seed, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('shape', [(2, 3, 128, 64), (1, 2, 200, 128),
                                   (1, 1, 40, 16), (2, 2, 96, 32)])
def test_kernels_match_plain_on_card(shape, causal, dtype):
    """Each CUDA kernel against its plain version on the card (ragged
    edges included). Tolerance: f32 with TF32 off sums in another order
    (1e-5); bf16 rounds P before P.V at another running max in the
    online softmax, so O may move by 2 bf16 ulps (2e-2); dQ/dK/dV see
    the same P and dS roundings as the plain version (1e-2)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x).to('cuda', dt)
                   for x in _inputs(shape, 3))
    scale = shape[-1] ** -0.5
    o, lse = fa._fwd_cuda(q, k, v, causal, scale)
    o2, lse2 = fa._fwd_plain(q, k, v, causal, scale)
    delta = fa._delta(do, o)
    dq = fa._dq_cuda(q, k, v, do, lse, delta, causal, scale)
    dk, dv = fa._dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    dq2 = fa._dq_plain(q, k, v, do, lse, delta, causal, scale)
    dk2, dv2 = fa._dkv_plain(q, k, v, do, lse, delta, causal, scale)
    tol = {'float32': (1e-5, 1e-5, 1e-5), 'bfloat16': (2e-2, 1e-5, 1e-2)}
    t_o, t_lse, t_g = tol[dtype]
    torch.testing.assert_close(o.float(), o2.float(), atol=t_o, rtol=t_o)
    torch.testing.assert_close(lse, lse2, atol=t_lse, rtol=t_lse)
    for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)):
        torch.testing.assert_close(a.float(), b.float(), atol=t_g, rtol=t_g)
