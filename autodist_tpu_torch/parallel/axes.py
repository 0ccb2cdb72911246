"""``ParallelSpec``: the user-facing parallelism knob, data-parallel only.

The counterpart of ``ParallelSpec`` in ``autodist_tpu/parallel/axes.py``.
This slice of the port runs data parallelism over ``torch.distributed``
ranks, with gradient accumulation and full rematerialization, and
nothing else: a spec that asks for tensor, pipeline, sequence or expert
parallelism, or for ZeRO, raises ``NotImplementedError`` until the slice
that ports it. It serializes as the JAX spec does (``to_dict`` /
``from_dict``), with the same tolerance of version skew.
"""
from dataclasses import asdict, dataclass, fields

from autodist_tpu_torch.utils import logging

REMAT_POLICIES = ('none', 'full')


@dataclass
class ParallelSpec:
    """dp: data-parallel degree; 0 means "every rank of the process
    group". tp / pp / sp / ep (tensor, pipeline, sequence, expert
    degrees) and zero (optimizer-state sharding stage) must stay 1.
    ``remat``: 'none' | 'full' (the whole loss recomputed in the
    backward). ``grad_accum``: gradient-accumulation chunks of the
    global batch."""
    dp: int = 0
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    zero: int = 1
    remat: str = 'none'
    grad_accum: int = 1

    def __post_init__(self):
        for name in ('tp', 'pp', 'sp', 'ep', 'zero'):
            if getattr(self, name) > 1:
                raise NotImplementedError(
                    'ParallelSpec(%s=%d): the PyTorch port runs data '
                    'parallelism only so far' % (name, getattr(self, name)))
        if self.remat not in REMAT_POLICIES:
            raise ValueError('ParallelSpec(remat=%r): the port takes %s'
                             % (self.remat, REMAT_POLICIES))

    # -- serialization (parity with Strategy JSON round-trip) -------------
    def to_dict(self):
        return asdict(self)

    @classmethod
    def from_dict(cls, d):
        """Tolerates version skew in BOTH directions: missing fields
        take their defaults (old dict, new code) and unknown fields are
        dropped with a warning (new dict, old code, or a JAX spec's
        fields the port lacks)."""
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            logging.warning('ParallelSpec.from_dict: dropping unknown '
                            'fields %s (newer peer?)', sorted(unknown))
        return cls(**{k: v for k, v in d.items() if k in known})

    def resolve_dp(self, world_size):
        """The data-parallel degree over ``world_size`` ranks."""
        if self.dp and self.dp != world_size:
            raise ValueError('ParallelSpec(dp=%d) needs %d ranks, the '
                             'process group has %d'
                             % (self.dp, self.dp, world_size))
        return world_size
