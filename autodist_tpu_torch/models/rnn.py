"""LSTM language model for the port (the reference's lm1b example role).

The counterpart of ``autodist_tpu/models/rnn.py``, with the same
parameter paths (``embed/table``, ``lstm_0/kernel``, ``proj/bias``,
``head/kernel``). The cell's gates are one fused ``[x, h] @ W`` product
split into (i, f, g, o), with +1.0 on the forget gate inside the
sigmoid. The JAX package's ``lax.scan`` over time is a Python loop over
the time-major sequence here: PyTorch runs eagerly, so there is no
compiled cell to reuse.
"""
import torch

from autodist_tpu_torch.models.core import (Dense, Embedding, Module,
                                            ParamDef, live_spec)
from autodist_tpu_torch.utils.device import resolve_device


class LSTMCell(Module):
    """Fused-gate LSTM cell: [x, h] @ W -> (i, f, g, o)."""

    def __init__(self, in_dim, hidden, dtype=torch.float32, device=None):
        super().__init__()
        self.in_dim, self.hidden, self.dtype = in_dim, hidden, dtype
        self._register(resolve_device(device))

    def param_defs(self):
        return {
            'kernel': ParamDef((self.in_dim + self.hidden,
                                4 * self.hidden),
                               ('embed', 'mlp'), 'fan_in'),
            'bias': ParamDef((4 * self.hidden,), ('mlp',), 'zeros'),
        }

    def apply(self, params, carry, x):
        """((h, c), h) after one time step of ``x`` [batch, in_dim]."""
        if live_spec(('embed', 'mlp'))[1] is not None:
            raise NotImplementedError(
                'LSTMCell: its fused gates under a live mlp axis (tensor '
                'parallelism) are not ported; run LSTMLM at tp = 1')
        h, c = carry
        z = torch.cat([x, h], dim=-1).to(self.dtype)
        gates = z @ params['kernel'].to(self.dtype) + \
            params['bias'].to(self.dtype)
        i, f, g, o = torch.split(gates, self.hidden, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h

    def init_carry(self, batch, device):
        z = torch.zeros((batch, self.hidden), dtype=self.dtype,
                        device=device)
        return (z, z)


class LSTMLM(Module):
    """Embedding -> n_layers LSTM (a loop over time) -> proj -> logits
    (f32). ``device`` defaults to the card; ``seed`` seeds the port's
    own init."""

    def __init__(self, vocab=10000, dim=512, hidden=1024, n_layers=2,
                 tied=False, dtype=torch.float32, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.vocab, self.dim, self.hidden = vocab, dim, hidden
        self.n_layers = n_layers
        self.dtype = dtype
        self.embed = Embedding(vocab, dim, **kw)
        self.cells = [LSTMCell(dim if i == 0 else hidden, hidden, **kw)
                      for i in range(n_layers)]
        self.proj = Dense(hidden, dim, 'mlp', 'embed', **kw)
        self.tied = tied
        if not tied:
            self.head = Dense(dim, vocab, 'embed', 'vocab', use_bias=False,
                              **kw)
        self._register(device)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    def param_defs(self):
        d = {'embed': self.embed, 'proj': self.proj}
        for i, c in enumerate(self.cells):
            d['lstm_%d' % i] = c
        if not self.tied:
            d['head'] = self.head
        return d

    def apply(self, params, tokens):
        """[batch, seq] tokens -> [batch, seq, vocab] f32 logits."""
        b = tokens.shape[0]
        x = self.embed.apply(params['embed'], tokens)   # [b, s, d]
        ys = x.transpose(0, 1).unbind(0)                 # time-major
        for i, cell in enumerate(self.cells):
            p = params['lstm_%d' % i]
            carry = cell.init_carry(b, tokens.device)
            out = []
            for xt in ys:
                carry, h = cell.apply(p, carry, xt)
                out.append(h)
            ys = out
        y = torch.stack(ys, dim=1)                       # [b, s, hidden]
        y = self.proj.apply(params['proj'], y)
        if self.tied:
            logits = self.embed.attend(params['embed'], y)
        else:
            logits = self.head.apply(params['head'], y)
        return logits.float()

    def per_token_loss_with_aux(self, params, batch):
        """([batch, seq] token NLL, zero aux); the gold logit is taken
        with ``gather``, which equals the JAX package's one-hot sum."""
        logits = self.apply(params, batch['tokens'])
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            batch['targets'].long()[..., None])[..., 0]
        return logz - gold, torch.zeros((), device=logits.device)

    def per_token_loss(self, params, batch):
        return self.per_token_loss_with_aux(params, batch)[0]

    def loss(self, params, batch):
        """Mean token cross-entropy, optional mask."""
        nll, _ = self.per_token_loss_with_aux(params, batch)
        mask = batch.get('mask')
        if mask is not None:
            mask = mask.to(nll.dtype)
            return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
        return nll.mean()
