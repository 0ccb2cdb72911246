"""``ParallelSpec``: the user-facing parallelism knob, data-parallel only.

The counterpart of ``ParallelSpec`` in ``autodist_tpu/parallel/axes.py``.
This slice of the port runs data parallelism over ``torch.distributed``
ranks and nothing else: a spec that asks for tensor, pipeline, sequence
or expert parallelism, or for ZeRO, raises ``NotImplementedError`` until
the slice that ports it.
"""
from dataclasses import dataclass


@dataclass
class ParallelSpec:
    """dp: data-parallel degree; 0 means "every rank of the process
    group". tp / pp / sp / ep (tensor, pipeline, sequence, expert
    degrees) and zero (optimizer-state sharding stage) must stay 1."""
    dp: int = 0
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    zero: int = 1

    def __post_init__(self):
        for name in ('tp', 'pp', 'sp', 'ep', 'zero'):
            if getattr(self, name) > 1:
                raise NotImplementedError(
                    'ParallelSpec(%s=%d): the PyTorch port runs data '
                    'parallelism only so far' % (name, getattr(self, name)))

    def resolve_dp(self, world_size):
        """The data-parallel degree over ``world_size`` ranks."""
        if self.dp and self.dp != world_size:
            raise ValueError('ParallelSpec(dp=%d) needs %d ranks, the '
                             'process group has %d'
                             % (self.dp, self.dp, world_size))
        return world_size
