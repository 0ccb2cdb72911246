"""Strategy layer: representation + builders (reference autodist/strategy/)."""
from autodist_tpu_torch.strategy.base import (  # noqa: F401
    AllReduceSynchronizer, GraphConfig, PSSynchronizer, Strategy,
    StrategyBuilder, StrategyCompiler, StrategyNode, byte_size_load_fn)
from autodist_tpu_torch.strategy.builders import (  # noqa: F401
    PS, AllReduce, AutoStrategy, Parallax, PartitionedAR, PartitionedPS,
    PSLoadBalancing, RandomAxisPartitionAR, UnevenPartitionedPS)
from autodist_tpu_torch.strategy.adapter import (  # noqa: F401
    PytreeGraphItem, grad_bucket_layout, trainer_from_strategy)
