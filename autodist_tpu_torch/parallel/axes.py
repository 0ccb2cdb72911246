"""``ParallelSpec``: the user-facing parallelism knob, and the logical
axis rules.

The counterpart of ``autodist_tpu/parallel/axes.py``. The spec carries
every field of the JAX spec and serializes as it does (``to_dict`` /
``from_dict``, with the same tolerance of version skew), so either
package reads the other's dict. This port runs the axes that live on a
(data, seq, expert, model) grid of ``torch.distributed`` ranks: data
parallelism with ZeRO stages 1-3 (``zero``) and a multi-slice data axis
(``dcn_dp``), sequence parallelism (``sp``, ring or Ulysses attention by
``sp_mode``), tensor parallelism (``tp``: parameters sharded by their
``'heads'``, ``'mlp'`` and ``'vocab'`` axes over the model group) and
expert parallelism (``ep``: the ``'expert'`` axis over the expert
group), pipeline parallelism (``pp``: the ``'stage'`` axis of the
stacked blocks over the pipe group, run by the GPipe or 1F1B schedule of
:mod:`autodist_tpu_torch.parallel.pipeline` with ``microbatches``,
``pp_schedule`` and ``pp_variant``), gradient accumulation and full
rematerialization.

The JAX package binds logical axes to a ``jax.sharding.Mesh``; the port
has no mesh object, so :func:`mesh_axis_for` and :func:`spec_for_axes`
take the grid's axis sizes (a ``{axis: size}`` dict, or anything with
such a ``shape``, as :class:`~autodist_tpu_torch.parallel.mesh.RankGrid`
has) and return a tuple of mesh-axis names where JAX returns a
``PartitionSpec``. The step that is running keeps its grid and rules in
``STEP_CTX`` (:func:`autodist_tpu_torch.models.core.model_mode` puts them
there); :func:`live_mesh_axis` and :func:`live_spec` read them.
"""
import threading
from dataclasses import asdict, dataclass, field, fields

from autodist_tpu_torch.const import (AXIS_DATA, AXIS_EXPERT, AXIS_MODEL,
                                      AXIS_PIPELINE, AXIS_SEQUENCE)
from autodist_tpu_torch.utils import logging

REMAT_POLICIES = ('none', 'full')
SP_MODES = ('ring', 'ulysses')
PP_SCHEDULES = ('gpipe', '1f1b')
PP_VARIANTS = ('auto', 'remat', 'stash', 'legacy')

# Default logical-axis -> mesh-axis rules (the JAX package's table).
# First match wins; a logical axis absent from the table is unsharded.
DEFAULT_RULES = (
    ('batch', AXIS_DATA),
    ('seq', AXIS_SEQUENCE),
    ('embed', None),
    ('mlp', AXIS_MODEL),
    ('heads', AXIS_MODEL),
    ('kv', None),
    ('vocab', AXIS_MODEL),
    ('expert', AXIS_EXPERT),
    ('stage', AXIS_PIPELINE),
    ('classes', None),
)


@dataclass
class ParallelSpec:
    """Grid sizes and execution options, field for field the JAX spec's.

    dp / tp / pp / sp / ep: data / tensor / pipeline / sequence / expert
    degrees; ``dp=0`` means "every rank the other axes leave". ``zero``:
    1 replicates the training state, 2 shards the optimizer slots over
    the data axis, 3 the parameters too. ``sp_mode``: 'ring' | 'ulysses'
    (the attention that runs over the seq axis). ``remat``: 'none' |
    'full' (the whole loss recomputed in the backward). ``grad_accum``:
    gradient-accumulation chunks of the global batch. ``dcn_dp``: the
    data axis is that many contiguous blocks of ranks, one a slice or
    node. ``microbatches``: the pipeline's microbatch count (pp > 1);
    ``pp_schedule``: 'gpipe' | '1f1b'; ``pp_variant``: the 1F1B
    backward, 'remat' | 'stash' | 'auto' (stash while it fits
    ``AUTODIST_PP_STASH_LIMIT_MB``) | 'legacy' (the un-fused schedule),
    see :mod:`autodist_tpu_torch.parallel.pipeline`. ``rules``: the
    logical-axis table."""
    dp: int = 0
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    dcn_dp: int = 1
    zero: int = 1
    remat: str = 'none'
    microbatches: int = 1
    pp_schedule: str = 'gpipe'
    pp_variant: str = 'auto'
    sp_mode: str = 'ring'
    grad_accum: int = 1
    rules: list = field(default_factory=lambda: [list(r)
                                                 for r in DEFAULT_RULES])

    def __post_init__(self):
        if self.pp_schedule not in PP_SCHEDULES:
            raise ValueError('ParallelSpec(pp_schedule=%r): expected one of '
                             '%s' % (self.pp_schedule, PP_SCHEDULES))
        if self.pp_variant not in PP_VARIANTS:
            raise ValueError('ParallelSpec(pp_variant=%r): expected one of '
                             '%s' % (self.pp_variant, PP_VARIANTS))
        if int(self.microbatches) < 1:
            raise ValueError('ParallelSpec(microbatches=%r): expected 1 or '
                             'more' % (self.microbatches,))
        if self.remat not in REMAT_POLICIES:
            raise ValueError('ParallelSpec(remat=%r): the port takes %s'
                             % (self.remat, REMAT_POLICIES))
        if self.sp_mode not in SP_MODES:
            raise ValueError('ParallelSpec(sp_mode=%r): expected one of %s'
                             % (self.sp_mode, SP_MODES))
        if self.zero not in (1, 2, 3):
            raise ValueError('ParallelSpec(zero=%r): expected 1, 2 or 3'
                             % (self.zero,))

    # -- serialization (parity with Strategy JSON round-trip) -------------
    def to_dict(self):
        return asdict(self)

    @classmethod
    def from_dict(cls, d):
        """Tolerates version skew in BOTH directions: missing fields
        take their defaults (old dict, new code) and unknown fields are
        dropped with a warning (new dict, old code)."""
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            logging.warning('ParallelSpec.from_dict: dropping unknown '
                            'fields %s (newer peer?)', sorted(unknown))
        return cls(**{k: v for k, v in d.items() if k in known})

    def resolve_dp(self, world_size):
        """The data-parallel degree over ``world_size`` ranks: the world
        over tp·pp·sp·ep, as the JAX package divides its devices. The
        port runs one rank per device, so the grid must take every
        rank."""
        fixed = self.tp * self.pp * self.sp * self.ep
        if world_size % fixed:
            raise ValueError(
                'tp*pp*sp*ep=%d does not divide the %d ranks of the '
                'process group' % (fixed, world_size))
        dp = world_size // fixed
        if self.dp and self.dp != dp:
            raise ValueError('ParallelSpec(dp=%d) needs %d ranks, the '
                             'process group has %d'
                             % (self.dp, self.dp * fixed, world_size))
        return dp


def _sizes(mesh):
    return getattr(mesh, 'shape', mesh)


def mesh_axis_for(logical, rules, mesh):
    """Resolve one logical axis to a live mesh axis name (or None): the
    first rule naming it, when that axis is on the grid with size > 1."""
    sizes = _sizes(mesh)
    for name, target in rules:
        if name == logical:
            if target is None or target not in sizes:
                return None
            if sizes[target] == 1:
                return None  # size-1 axis: sharding is a no-op
            return target
    return None


# The running step's context, a stack a thread: ``models.core.model_mode``
# pushes its collector, whose ``mesh`` and ``rules`` are the step's
# ``RankGrid`` and logical-axis table.
STEP_CTX = threading.local()


def step_context():
    """The running step's collector (the top of ``STEP_CTX``), or None."""
    stack = getattr(STEP_CTX, 'stack', None)
    return stack[-1] if stack else None


class resumed_step:
    """Context: make ``ctx`` (a :func:`step_context`) the running step's
    again (a backward, or a checkpoint's recompute, runs on autograd's
    thread, and after the forward's context has closed)."""

    def __init__(self, ctx):
        self.col = ctx

    def __enter__(self):
        stack = getattr(STEP_CTX, 'stack', None)
        if stack is None:
            stack = STEP_CTX.stack = []
        stack.append(self.col)

    def __exit__(self, *exc):
        STEP_CTX.stack.pop()


def step_mesh():
    """(the step's grid, its rules), or (None, None) outside a step."""
    ctx = step_context()
    if ctx is None or ctx.mesh is None:
        return None, None
    return ctx.mesh, ctx.rules or DEFAULT_RULES


def live_mesh_axis(logical):
    """The grid axis ``logical`` is bound to in the step that is running
    (a size above 1), or None: outside a step, or when the rules leave
    it unsharded. The JAX function reads the active ``sharding_ctx``."""
    mesh, rules = step_mesh()
    return None if mesh is None else mesh_axis_for(logical, rules, mesh)


def live_spec(axes):
    """The model or expert axis each of ``axes`` (logical names) is bound
    to in the running step, one entry a dim (None: not sharded over
    either), as ``spec_for_axes`` binds them; all None outside a step.
    (The Trainer shards parameters over those two axes alone.)"""
    mesh, rules = step_mesh()
    if mesh is None or (mesh.shape[AXIS_MODEL] == 1 and
                        mesh.shape[AXIS_EXPERT] == 1):
        return (None,) * len(axes)   # asked by every Dense of a step
    spec = tuple(a if a in (AXIS_MODEL, AXIS_EXPERT) else None
                 for a in spec_for_axes(axes, rules, mesh))
    return spec + (None,) * (len(axes) - len(spec))


def spec_for_axes(axes, rules, mesh):
    """The per-dim mesh axes (trailing Nones dropped) of a tuple of
    logical axis names: the JAX ``PartitionSpec`` as a tuple."""
    if axes is None:
        return ()
    used = set()
    out = []
    for logical in axes:
        target = mesh_axis_for(logical, rules, mesh)
        if target in used:
            target = None  # a mesh axis may shard only one tensor dim
        if target is not None:
            used.add(target)
        out.append(target)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)
