"""Neural Collaborative Filtering for the port: GMF and MLP towers over
user and item embeddings, binary log-loss.

The counterpart of ``autodist_tpu/models/ncf.py``, with the same
parameter paths (``mf_user/table``, ``mlp_0/kernel``, ``head/bias``,
...), so weights cross between the packages by name. The four tables
carry the ``vocab`` logical axis, which marks them sparse for the
strategy builders through ``PytreeGraphItem``. ``F.embedding`` gives
each table a dense gradient, as the JAX package's gather does.
"""
import torch
import torch.nn.functional as F

from autodist_tpu_torch.models.core import Dense, Embedding, Module
from autodist_tpu_torch.utils.device import resolve_device


class NCF(Module):
    """``device`` defaults to the card; ``seed`` seeds the port's own
    init."""

    def __init__(self, num_users, num_items, mf_dim=64,
                 mlp_dims=(256, 128, 64), dtype=torch.float32, device=None,
                 seed=0):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.num_users, self.num_items = num_users, num_items
        self.mf_dim = mf_dim
        self.dtype = dtype
        self.mf_user = Embedding(num_users, mf_dim, **kw)
        self.mf_item = Embedding(num_items, mf_dim, **kw)
        mlp_in = mlp_dims[0]
        self.mlp_user = Embedding(num_users, mlp_in // 2, **kw)
        self.mlp_item = Embedding(num_items, mlp_in // 2, **kw)
        self.mlp = [Dense(mlp_dims[i - 1], mlp_dims[i], 'embed', 'mlp', **kw)
                    for i in range(1, len(mlp_dims))]
        self.head = Dense(mf_dim + mlp_dims[-1], 1, 'embed', None, **kw)
        self._register(device)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    def param_defs(self):
        d = {'mf_user': self.mf_user, 'mf_item': self.mf_item,
             'mlp_user': self.mlp_user, 'mlp_item': self.mlp_item,
             'head': self.head}
        for i, m in enumerate(self.mlp):
            d['mlp_%d' % i] = m
        return d

    def apply(self, params, users, items):
        """[batch] f32 logits."""
        gmf = self.mf_user.apply(params['mf_user'], users) * \
            self.mf_item.apply(params['mf_item'], items)
        y = torch.cat([self.mlp_user.apply(params['mlp_user'], users),
                       self.mlp_item.apply(params['mlp_item'], items)],
                      dim=-1)
        for i, m in enumerate(self.mlp):
            y = F.relu(m.apply(params['mlp_%d' % i], y))
        both = torch.cat([gmf, y], dim=-1)
        return self.head.apply(params['head'], both)[..., 0].float()

    def loss(self, params, batch):
        """Mean stable sigmoid cross-entropy; expects {'users', 'items',
        'labels'}."""
        logits = self.apply(params, batch['users'], batch['items'])
        labels = batch['labels'].float()
        return (torch.clamp(logits, min=0) - logits * labels +
                torch.log1p(torch.exp(-logits.abs()))).mean()
