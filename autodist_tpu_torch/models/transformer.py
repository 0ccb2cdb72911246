"""Transformer language model for the port.

The counterpart of ``autodist_tpu/models/transformer.py``: the same
``TransformerConfig`` presets, options and parameter paths, a pre-LN
``Block`` (MoE MLP when ``moe_experts`` is set) and ``TransformerLM``
with f32 logits from ``apply``, a mean-NLL loss and the MoE
load-balance loss. The loss takes the head's logits in the model's
dtype: its token NLL is :func:`kernels.cross_entropy.token_nll`, the
cross-entropy kernels on the card (the plain f32 ``logsumexp - gather``
elsewhere), so no f32 copy of the logits is made or saved.

- ``scan_layers=True`` keeps the block params stacked on a leading
  ``[n_layers]`` axis under ``blocks/...`` (the JAX layout); the blocks
  run in a Python loop over the stack.
- ``remat`` (``torch.utils.checkpoint``, non-reentrant, through
  :func:`core.checkpoint` so the data-parallel group of the step is
  there in the recompute): ``True`` checkpoints each block, and the
  backward recomputes its forward. The selective policies keep more:
  ``'save_attn'`` runs each block as two checkpoint regions, attention
  then MLP, so the post-attention residual is saved and the backward
  recomputes each half from its own input; ``'dots'`` saves the output
  of every matmul op (``mm``, ``addmm``, ``bmm``, ``baddbmm``) and
  ``'dots_no_batch'`` only those without batch dims (``mm``,
  ``addmm``: the Dense products and the MoE router, not the
  expert and dispatch einsums or the plain attention's ``bmm``), both
  through ``create_selective_checkpoint_contexts``, and recompute the
  rest. The flash kernels run inside an ``autograd.Function``, not as
  matmul ops, so every policy recomputes them. Every policy gives the
  numbers of ``remat=False``.
- ``loss_chunk`` splits the lm-head and NLL into sequence chunks of at
  least ``loss_chunk`` rows (the largest count that divides the
  sequence), each checkpointed, so the backward holds one
  ``[b, s/n, vocab]`` slab of logits at a time.

Under sequence parallelism (a live ``core.seq_group()``) each rank
runs the model on its slice of the sequence: positions are offset by
``seq_rank · s_local``, attention runs over the seq group, and
``per_token_loss_with_aux`` returns the slice's token NLL, which the
Trainer reduces. MoE routing groups are then the local slices (GShard
grouping: capacity and dropping per slice), as in the JAX package.

Under tensor parallelism the blocks run on their shards (see
``models/attention.py``, ``models/moe.py`` and ``core.Dense``), and
under a live ``'vocab'`` axis the embedding table (tied) or the
``lm_head`` (untied) is vocab-sharded, so the head gives each rank its
vocab slice of the logits and the NLL is :func:`vocab_parallel_nll`,
which never gathers them (the JAX package's GSPMD partitions its
logsumexp and one-hot contraction the same way). ``apply`` then returns
the rank's vocab slice of the logits.

Under pipeline parallelism (a live ``core.pipe_group()``) each rank holds
its stage's slice of the stacked blocks, ``n_layers / pp`` layers, and
the model runs through :mod:`autodist_tpu_torch.parallel.pipeline` with
the step's options (``core.step_option``: ``microbatches``,
``pp_schedule``, ``pp_variant``). ``hidden_with_aux`` embeds on the
first stage and runs the GPipe schedule (also the 1F1B ``'legacy'``
variant, which gives its numbers); ``per_token_loss_with_aux`` then runs
ln_f, the head and the NLL on the last stage. Under ``pp_schedule='1f1b'``
with a fused variant it is :meth:`TransformerLM._loss_1f1b`: the
embedding folds into the first stage and ln_f, the head and the NLL into
the last, each microbatch a head chunk (``loss_chunk`` is subsumed).
What comes back are per-rank partials, as the pipeline's: the last
stage's NLL (and hidden states) and zeros of their shape on the other
stages, and each stage's share of the aux; the Trainer sums both over
the pipe group. Pipeline parallelism needs ``scan_layers=True``.
"""
import functools
from dataclasses import dataclass

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from autodist_tpu_torch.kernels import cross_entropy
from autodist_tpu_torch.models.attention import MultiHeadAttention
from autodist_tpu_torch.models.core import (Dense, Embedding, LayerNorm, Mlp,
                                            Module, checkpoint, live_spec,
                                            mesh_group, pipe_group, seq_group,
                                            step_option)
from autodist_tpu_torch.models.moe import MoeMlp
from autodist_tpu_torch.parallel import pipeline
from autodist_tpu_torch.parallel.mesh import all_gather, reduce_from
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
    # False | True (checkpoint each block) | 'save_attn' | 'dots' |
    # 'dots_no_batch' (see the module docstring)
    remat: object = False
    scan_layers: bool = True     # stacked block params, looped in Python
    loss_chunk: int = 0          # rows per chunk of the lm-head + NLL
    moe_experts: int = 0         # >0: MoE MLP with this many experts
    moe_top_k: int = 2
    moe_aux_coef: float = 0.01   # load-balance loss weight

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


class Block(Module):
    """Pre-LN transformer block; MoE MLP when ``cfg.moe_experts`` > 0.

    ``apply`` returns ``(x, aux)``, aux the router load-balance loss
    (None for dense blocks, which add no term)."""

    def __init__(self, cfg, device=None, stack=()):
        super().__init__(stack)
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device, stack=stack)
        self.ln1 = LayerNorm(cfg.dim, **kw)
        self.attn = MultiHeadAttention(cfg.dim, cfg.n_heads,
                                       causal=cfg.causal, **kw)
        self.ln2 = LayerNorm(cfg.dim, **kw)
        if cfg.moe_experts:
            self.mlp = MoeMlp(cfg.dim, cfg.dim * cfg.mlp_ratio,
                              cfg.moe_experts, top_k=cfg.moe_top_k, **kw)
        else:
            self.mlp = Mlp(cfg.dim, cfg.dim * cfg.mlp_ratio, **kw)

    def param_defs(self):
        return {'ln1': self.ln1, 'attn': self.attn,
                'ln2': self.ln2, 'mlp': self.mlp}

    def attn_half(self, params, x):
        """The residual after attention (the JAX package's ``attn_out``)."""
        return x + self.attn.apply(params['attn'],
                                   self.ln1.apply(params['ln1'], x))

    def mlp_half(self, params, x):
        h = self.mlp.apply(params['mlp'], self.ln2.apply(params['ln2'], x))
        aux = None
        if self.cfg.moe_experts:
            h, aux = h
        return x + h, aux

    def apply(self, params, x):
        return self.mlp_half(params, self.attn_half(params, x))


# matmul ops each selective policy saves (the aten ops the Dense products,
# einsums and the plain attention lower to)
_MATMULS = {'dots': (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                     torch.ops.aten.bmm.default,
                     torch.ops.aten.baddbmm.default),
            'dots_no_batch': (torch.ops.aten.mm.default,
                              torch.ops.aten.addmm.default)}
REMAT_POLICIES = ('dots', 'dots_no_batch', 'save_attn')


def _save_ops(ops):
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return functools.partial(create_selective_checkpoint_contexts, policy)


class TransformerLM(Module):
    """Embedding -> N blocks -> final LN -> logits (f32).

    ``device`` defaults to the card; ``seed`` seeds the port's own init.
    """

    def __init__(self, cfg, device=None, seed=0):
        super().__init__()
        if isinstance(cfg.remat, str) and cfg.remat not in REMAT_POLICIES:
            raise ValueError(
                'unknown remat mode %r (expected False, True, or one of %s)'
                % (cfg.remat, sorted(REMAT_POLICIES)))
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
        return self.apply_with_aux(params, tokens)[0]

    def apply_with_aux(self, params, tokens):
        """(logits f32, aux): aux the summed MoE router load-balance loss
        (0.0 for dense configs). Under a live vocab axis the logits are
        gathered over it: every rank gets the whole vocab, as the JAX
        ``apply`` hands it out."""
        x, aux = self.hidden_with_aux(params, tokens)
        logits = self._head_logits(params, x).float()
        axis = live_spec(('vocab',))[0]
        if axis is not None:
            logits = all_gather(mesh_group(axis), logits, logits.dim() - 1)
        return logits, aux

    def _head_logits(self, params, x):
        if self.cfg.tied_embeddings:
            return self.embed.attend(params['embed'], x)
        return self.lm_head.apply(params['lm_head'], x)

    def _layers(self, params):
        """(block module, its params) per layer, in order: the layers of
        the stacked params this rank holds (under pipeline parallelism,
        its stage's)."""
        cfg = self.cfg
        if not cfg.scan_layers:
            return [(getattr(self, 'block_%03d' % i),
                     params['block_%03d' % i]) for i in range(cfg.n_layers)]
        return [(self.blocks, p) for p in pipeline.unstack(params['blocks'])]

    def _block_fn(self, p, x):
        """One stacked layer under the remat policy: (x, aux)."""
        return self._run_block(self.blocks, p, x)

    def _run_block(self, block, p, x):
        """One block under the remat policy: (x, aux)."""
        remat = self.cfg.remat
        if remat is False:
            return block.apply(p, x)
        if remat == 'save_attn':
            x = checkpoint(block.attn_half, p, x)
            return checkpoint(block.mlp_half, p, x)
        if remat is True:
            return checkpoint(block.apply, p, x)
        return checkpoint(block.apply, p, x,
                          context_fn=_save_ops(_MATMULS[remat]))

    def _embedded(self, params, tokens):
        """Embedding + positions (the pipeline's head)."""
        s = tokens.shape[1]
        x = self.embed.apply(params['embed'], tokens)
        pos = torch.arange(s, device=tokens.device)
        seq = seq_group()
        if seq is not None:
            # global positions: this rank holds seq slice ``seq.rank``
            pos = pos + seq.rank * s
        return x + self.pos_embed.apply(params['pos_embed'], pos)[None]

    def _pipe(self):
        """The live pipe group, after the JAX check of the layout."""
        pipe = pipe_group()
        if pipe is not None and not self.cfg.scan_layers:
            raise ValueError(
                'pipeline parallelism requires scan_layers=True '
                '(blocks must be stage-stacked to shard over pipe)')
        return pipe

    def hidden_with_aux(self, params, tokens):
        """Final hidden states (post ln_f) and the MoE aux loss summed
        over the layers: everything but the lm-head, so the loss can
        chunk the head. Under a live pipe group, the GPipe schedule over
        the stages: per-rank partials (see the module docstring)."""
        pipe = self._pipe()
        if pipe is not None:
            x = self._embedded(params, tokens) if pipe.rank == 0 else tokens
            x, aux = pipeline.gpipe(
                self._block_fn, params['blocks'], x, pipe,
                step_option('microbatches', 1),
                remat=step_option('remat') == 'full')
            if pipe.rank != pipe.size - 1:
                return x, aux
            return self.ln_f.apply(params['ln_f'], x), aux
        x = self._embedded(params, tokens)
        aux_total = torch.zeros((), device=x.device)
        for block, p in self._layers(params):
            x, aux = self._run_block(block, p, x)
            if aux is not None:
                aux_total = aux_total + aux
        return self.ln_f.apply(params['ln_f'], x), aux_total

    @property
    def aux_loss_weight(self):
        return self.cfg.moe_aux_coef if self.cfg.moe_experts else 0.0

    def per_token_loss(self, params, batch):
        return self.per_token_loss_with_aux(params, batch)[0]

    def per_token_loss_with_aux(self, params, batch):
        """([batch, seq] token NLL, aux loss); expects {'tokens',
        'targets'}. With ``loss_chunk`` the head and NLL run per sequence
        chunk, each checkpointed. Under a live pipe group: per-rank
        partials (see the module docstring)."""
        targets = batch['targets']
        pipe = self._pipe()
        if pipe is not None and step_option('pp_schedule') == '1f1b' and \
                step_option('pp_variant', 'auto') != 'legacy':
            return self._loss_1f1b(params, batch, pipe)
        x, aux = self.hidden_with_aux(params, batch['tokens'])
        if pipe is not None and pipe.rank != pipe.size - 1:
            # zeros of the NLL's shape that the schedule's backward hangs on
            return x[..., 0].float() * 0, aux
        if pipe is not None and step_option('remat') == 'full':
            return checkpoint(self._token_nll, params, x, targets), aux
        return self._token_nll(params, x, targets), aux

    def _token_nll(self, params, x, targets):
        b, s = targets.shape
        n = self._ce_chunks(s, b * s)
        if n == 1:
            return self._chunk_nll(params, x, targets)
        c = s // n
        nll = [checkpoint(self._chunk_nll, params, x[:, i * c:(i + 1) * c],
                          targets[:, i * c:(i + 1) * c]) for i in range(n)]
        return torch.cat(nll, dim=1)

    def _loss_1f1b(self, params, batch, pipe):
        """Pipelined NLL by the fused 1F1B schedule: the embedding folds
        into the first stage (``head_fn``) and ln_f + the head + the NLL
        into the last (``tail_fn``), so what crosses the schedule is
        token-sized. Only the subtrees the head and tail touch are handed
        to them: a tied embedding rides both, and its gradient is the
        sum of both uses."""
        cfg = self.cfg

        def head(p, tok_mb):
            return self._embedded(p, tok_mb)

        def tail(p, h, tgt):
            return self._chunk_nll(p, self.ln_f.apply(p['ln_f'], h), tgt)

        head_params = {k: params[k] for k in ('embed', 'pos_embed')}
        tail_params = {k: params[k] for k in (
            'ln_f', 'embed' if cfg.tied_embeddings else 'lm_head')}
        return pipeline.one_f_one_b(
            self._block_fn, params['blocks'], batch['tokens'], pipe,
            step_option('microbatches', 1), tail_fn=tail,
            extra=batch['targets'], tail_params=tail_params, head_fn=head,
            head_params=head_params,
            variant=step_option('pp_variant', 'auto'))

    def _chunk_nll(self, params, x, targets):
        logits = self._head_logits(params, x)
        axis = live_spec(('vocab',))[0]
        if axis is not None:
            return vocab_parallel_nll(logits.float(), targets,
                                      mesh_group(axis))
        return cross_entropy.token_nll(logits, targets)

    def _ce_chunks(self, s, rows):
        """Number of sequence chunks for chunked CE: the largest chunk
        count that divides ``s`` while keeping >= loss_chunk rows per
        chunk (0 or rows <= loss_chunk -> 1 = unchunked)."""
        chunk = self.cfg.loss_chunk
        if not chunk or rows <= chunk:
            return 1
        n = max(1, min(s, rows // chunk))
        while s % n:
            n -= 1
        return n

    def loss(self, params, batch):
        """Mean token cross-entropy (+ MoE balance loss), optional mask."""
        nll, aux = self.per_token_loss_with_aux(params, batch)
        mask = batch.get('mask')
        if mask is not None:
            mask = mask.to(nll.dtype)
            ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
        else:
            ce = nll.mean()
        if not self.cfg.moe_experts:
            return ce
        return ce + self.cfg.moe_aux_coef * aux


def vocab_parallel_nll(logits, targets, group):
    """Token NLL ``logsumexp(logits) - logits[target]`` of logits whose
    vocab dim is sharded over ``group`` (this rank holds columns
    ``[rank · n, (rank + 1) · n)``), without gathering them: the max and
    the sum of exps are all-reduced over the group, and the gold logit
    comes from the rank that owns it. The sums go through
    :func:`mesh.reduce_from`, so the backward hands each rank the
    softmax minus the one-hot on its own columns; the max is a constant
    shift."""
    n = logits.shape[-1]
    m = group.all_reduce(logits.detach().amax(-1),
                         op=torch.distributed.ReduceOp.MAX)
    z = reduce_from(group, torch.exp(logits - m[..., None]).sum(-1))
    local = targets.long() - group.rank * n
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])
    gold = reduce_from(group, gold[..., 0] * inside.to(logits.dtype))
    return torch.log(z) + m - gold

