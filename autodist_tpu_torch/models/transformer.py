"""Transformer language model for the port.

The counterpart of ``autodist_tpu/models/transformer.py``: the same
``TransformerConfig`` presets and parameter paths, a pre-LN ``Block``
and ``TransformerLM`` with a tied head, f32 logits and a mean-NLL loss.

- ``scan_layers=True`` keeps the block params stacked on a leading
  ``[n_layers]`` axis under ``blocks/...`` (the JAX layout); the blocks
  run in a Python loop over the stack.
- ``remat=True`` checkpoints each block
  (``torch.utils.checkpoint``, non-reentrant): the backward recomputes
  the block's forward, flash kernel included.

``loss_chunk``, MoE, the selective remat policies and the pipeline are
not ported yet; a config that asks for them raises.
"""
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from autodist_tpu_torch.models.attention import MultiHeadAttention
from autodist_tpu_torch.models.core import (Dense, Embedding, LayerNorm, Mlp,
                                            Module)
from autodist_tpu_torch.utils.device import resolve_device


@dataclass
class TransformerConfig:
    vocab: int = 32000
    dim: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    mlp_ratio: int = 4
    max_len: int = 2048
    causal: bool = True
    tied_embeddings: bool = True
    dtype: object = torch.bfloat16
    remat: object = False        # False | True (checkpoint each block)
    scan_layers: bool = True     # stacked block params, looped in Python
    loss_chunk: int = 0          # chunked cross-entropy: not ported yet
    moe_experts: int = 0         # MoE blocks: not ported yet

    @classmethod
    def bert_large(cls, **kw):
        """BERT-large class config (24L/1024d/16h)."""
        d = dict(vocab=30522, dim=1024, n_layers=24, n_heads=16,
                 causal=False, max_len=512)
        d.update(kw)
        return cls(**d)

    @classmethod
    def gpt_small(cls, **kw):
        d = dict(vocab=32000, dim=768, n_layers=12, n_heads=12,
                 causal=True, max_len=1024)
        d.update(kw)
        return cls(**d)

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab=256, dim=64, n_layers=2, n_heads=4, max_len=128)
        d.update(kw)
        return cls(**d)

    def check_ported(self):
        """Raise for the options this slice of the port lacks."""
        if self.remat not in (False, True):
            raise NotImplementedError('remat=%r: only False and True are '
                                      'ported' % (self.remat,))
        for name in ('loss_chunk', 'moe_experts'):
            if getattr(self, name):
                raise NotImplementedError('%s=%r is not ported yet'
                                          % (name, getattr(self, name)))


class Block(Module):
    """Pre-LN transformer block."""

    def __init__(self, cfg, device=None, stack=()):
        super().__init__(stack)
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device, stack=stack)
        self.ln1 = LayerNorm(cfg.dim, **kw)
        self.attn = MultiHeadAttention(cfg.dim, cfg.n_heads,
                                       causal=cfg.causal, **kw)
        self.ln2 = LayerNorm(cfg.dim, **kw)
        self.mlp = Mlp(cfg.dim, cfg.dim * cfg.mlp_ratio, **kw)

    def param_defs(self):
        return {'ln1': self.ln1, 'attn': self.attn,
                'ln2': self.ln2, 'mlp': self.mlp}

    def apply(self, params, x):
        x = x + self.attn.apply(params['attn'],
                                self.ln1.apply(params['ln1'], x))
        return x + self.mlp.apply(params['mlp'],
                                  self.ln2.apply(params['ln2'], x))


class TransformerLM(Module):
    """Embedding -> N blocks -> final LN -> logits (f32).

    ``device`` defaults to the card; ``seed`` seeds the port's own init.
    """

    def __init__(self, cfg, device=None, seed=0):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        device = resolve_device(device)
        kw = dict(dtype=cfg.dtype, device=device)
        self.embed = Embedding(cfg.vocab, cfg.dim, **kw)
        self.pos_embed = Embedding(cfg.max_len, cfg.dim, vocab_axis='pos',
                                   **kw)
        self.ln_f = LayerNorm(cfg.dim, **kw)
        if not cfg.tied_embeddings:
            self.lm_head = Dense(cfg.dim, cfg.vocab, 'embed', 'vocab',
                                 use_bias=False, **kw)
        if cfg.scan_layers:
            self.blocks = Block(cfg, device=device, stack=(cfg.n_layers,))
        else:
            for i in range(cfg.n_layers):
                self.add_module('block_%03d' % i, Block(cfg, device=device))
        self.reset_parameters(torch.Generator().manual_seed(seed))

    def param_defs(self):
        d = {'embed': self.embed, 'pos_embed': self.pos_embed,
             'ln_f': self.ln_f}
        if not self.cfg.tied_embeddings:
            d['lm_head'] = self.lm_head
        if self.cfg.scan_layers:
            d['blocks'] = self.blocks
        else:
            for i in range(self.cfg.n_layers):
                d['block_%03d' % i] = getattr(self, 'block_%03d' % i)
        return d

    def apply(self, params, tokens):
        x = self.hidden(params, tokens)
        return self._head_logits(params, x).float()

    def _head_logits(self, params, x):
        if self.cfg.tied_embeddings:
            return self.embed.attend(params['embed'], x)
        return self.lm_head.apply(params['lm_head'], x)

    def _layers(self, params):
        """(block module, its params) per layer, in order."""
        cfg = self.cfg
        if not cfg.scan_layers:
            return [(getattr(self, 'block_%03d' % i),
                     params['block_%03d' % i]) for i in range(cfg.n_layers)]
        return [(self.blocks, p) for p in _unstack(params['blocks'])]

    def hidden(self, params, tokens):
        """Final hidden states (post ln_f)."""
        s = tokens.shape[1]
        x = self.embed.apply(params['embed'], tokens)
        pos = torch.arange(s, device=tokens.device)
        x = x + self.pos_embed.apply(params['pos_embed'], pos)[None]
        for block, p in self._layers(params):
            if self.cfg.remat:
                x = checkpoint(block.apply, p, x, use_reentrant=False)
            else:
                x = block.apply(p, x)
        return self.ln_f.apply(params['ln_f'], x)

    def per_token_loss(self, params, batch):
        """[batch, seq] token NLL; expects {'tokens', 'targets'}."""
        logits = self.apply(params, batch['tokens'])
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            batch['targets'].long()[..., None])[..., 0]
        return logz - gold

    def loss(self, params, batch):
        """Mean token cross-entropy, optional mask."""
        nll = self.per_token_loss(params, batch)
        mask = batch.get('mask')
        if mask is not None:
            mask = mask.to(nll.dtype)
            return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
        return nll.mean()


def _unstack(tree):
    """Per-layer trees of views into stacked params. One ``unbind`` per
    leaf: its backward stacks the layers' grads in one op, where taking
    one layer at a time would add a zero-padded full-size grad per layer
    (O(L^2) memory traffic)."""
    leaves = {k: _unstack(v) if isinstance(v, dict) else v.unbind(0)
              for k, v in tree.items()}
    n = len(next(iter(leaves.values())))
    return [{k: v[i] for k, v in leaves.items()} for i in range(n)]
