"""The port's side of the functional-Trainer parity tests: a model
trained through ``autodist_tpu_torch``'s ``Trainer`` on the CPU, in this
process (world 1) or on every rank of a gloo group
(``torch_dsl_worlds.run_group``).

:func:`train` is called as ``train(rank, world, **kwargs)`` and returns
numpy values. Every rank is handed the GLOBAL batch: ``Trainer.step``
takes this rank's share itself (``shard_batch``), as the JAX Trainer
places a global batch over its mesh. This module imports no jax.
"""
import numpy as np
import torch

from autodist_tpu_torch import optim, strategy
from autodist_tpu_torch.api import Trainer
from autodist_tpu_torch.models import vision
from autodist_tpu_torch.models.ncf import NCF
from autodist_tpu_torch.models.rnn import LSTMLM
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM)
from autodist_tpu_torch.models.weights import flatten_tree
from autodist_tpu_torch.parallel.axes import ParallelSpec

# tiny widths of the sparse family, shared with the JAX side of the tests
NCF_TINY = dict(num_users=64, num_items=48, mf_dim=8, mlp_dims=(16, 8, 4))
LSTM_TINY = dict(vocab=64, dim=16, hidden=24, n_layers=2)


def lm_batch(b=4, s=32, seed=0, mask=None):
    """Tokens and targets of ``TransformerConfig.tiny`` (vocab 256) from
    ``RandomState(seed)``. ``mask='uneven'`` zeroes rows 0-1 from column
    4 (so at dp = 2 rank 0 holds 8 counted tokens, rank 1 holds 64);
    ``mask='ones'`` is the all-ones control."""
    rng = np.random.RandomState(seed)
    batch = {'tokens': rng.randint(0, 256, (b, s), dtype=np.int32),
             'targets': rng.randint(0, 256, (b, s), dtype=np.int32)}
    if mask is not None:
        m = np.ones((b, s), np.float32)
        if mask == 'uneven':
            m[:2, 4:] = 0
        batch['mask'] = m
    return batch


def ncf_batch(b=32, seed=0):
    rng = np.random.RandomState(seed)
    return {'users': rng.randint(0, NCF_TINY['num_users'], (b,))
            .astype(np.int32),
            'items': rng.randint(0, NCF_TINY['num_items'], (b,))
            .astype(np.int32),
            'labels': rng.randint(0, 2, (b,)).astype(np.float32)}


def lstm_batch(b=4, s=6, seed=0, mask=False):
    rng = np.random.RandomState(seed)
    v = LSTM_TINY['vocab']
    batch = {'tokens': rng.randint(0, v, (b, s), dtype=np.int32),
             'targets': rng.randint(0, v, (b, s), dtype=np.int32)}
    if mask:
        batch['mask'] = (rng.rand(b, s) > 0.4).astype(np.float32)
    return batch


def images_batch(b=4, seed=0):
    rng = np.random.RandomState(seed)
    return {'images': rng.randn(b, 32, 32, 3).astype(np.float32),
            'labels': rng.randint(0, 10, (b,)).astype(np.int32)}


# the MoE LM of the JAX package's tests (tests/test_functional_api.py):
# aux weight 1.0, so a wrong aux shows above the tolerances
MOE_TINY = dict(moe_experts=4, moe_aux_coef=1.0)


def lm_config(kind):
    """``TransformerConfig.tiny`` keywords of an LM kind: 'lm', 'moe', or
    'moe_remat' (the MoE model under per-block remat)."""
    return {'lm': {}, 'moe': MOE_TINY,
            'moe_remat': dict(MOE_TINY, remat=True)}[kind]


def make_model(kind, tied=False):
    if kind in ('lm', 'moe', 'moe_remat'):
        return TransformerLM(TransformerConfig.tiny(dtype=torch.float32,
                                                    **lm_config(kind)),
                             device='cpu')
    if kind == 'ncf':
        return NCF(**NCF_TINY, device='cpu')
    if kind == 'lstm':
        return LSTMLM(**LSTM_TINY, tied=tied, device='cpu')
    if kind == 'resnet':
        return vision.ResNet((1, 1), num_classes=10, device='cpu')
    raise ValueError(kind)


def flat(tree):
    return {'/'.join(p): v for p, v in flatten_tree(tree)}


def masked_loss(model, form):
    """A user ``loss_fn`` of the masked mean ``sum(nll * mask) /
    max(sum(mask), 1)`` over ``model.per_token_loss``: ``form='pair'``
    returns ``(sum, count)`` (the Trainer takes the global mean),
    ``'scalar'`` the rank's own masked mean."""
    def loss_fn(params, batch):
        nll = model.per_token_loss(params, batch)
        mask = batch['mask'].to(nll.dtype)
        if form == 'pair':
            return (nll * mask).sum(), mask.sum()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return loss_fn


def masked_metric(model):
    """``metrics_fn`` with the pair form: the masked NLL's (sum, count)."""
    def metrics_fn(params, batch):
        nll = model.per_token_loss(params, batch)
        mask = batch['mask'].to(nll.dtype)
        return {'masked_nll': ((nll * mask).sum(), mask.sum())}
    return metrics_fn


def make_trainer(kind, opt=('adam', 1e-3), spec=None, builder=None,
                 tied=False, momentum=None, loss=None):
    model = make_model(kind, tied)
    kw = {} if momentum is None else {'momentum': momentum}
    optimizer = getattr(optim, opt[0])(opt[1], **kw)
    spec = ParallelSpec(**(spec or {}))
    loss_fn = None if loss is None else masked_loss(model, loss)
    if builder is None:
        return Trainer(model, optimizer, spec=spec, loss_fn=loss_fn)
    return strategy.trainer_from_strategy(
        model, optimizer, getattr(strategy, builder)(), spec=spec)


def train(rank, world, kind, init, batches, eval_batches=None, **kw):
    """Steps over the global ``batches`` from the JAX-layout ``init``:
    {'losses', 'params' (flat, JAX paths), 'eval' (when asked; with a
    ``loss`` form, ``evaluate``'s dict with the pair ``masked_nll``
    metric), 'warned' (the scalar-loss warning was logged)}."""
    trainer = make_trainer(kind, **kw)
    state = trainer.init(params=init)
    losses = [float(trainer.step(state, b)[1]['loss']) for b in batches]
    out = {'losses': losses, 'params': flat(trainer.get_params(state)),
           'warned': trainer._warned_scalar}
    if eval_batches is not None:
        metrics = None if kw.get('loss') is None else \
            masked_metric(trainer.model)
        out['eval'] = trainer.evaluate(state, eval_batches,
                                       metrics_fn=metrics)
    return out
