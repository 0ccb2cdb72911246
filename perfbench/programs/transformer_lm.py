"""The port's dense transformer language model, placed data-parallel by
AllReduce: ``trainer_from_strategy(TransformerLM(cfg), optimizer,
AllReduce(), spec=ParallelSpec(**cell['spec']))``."""
import torch


def build(spec, optimizer, device):
    from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                       TransformerLM)
    from autodist_tpu_torch.parallel.axes import ParallelSpec
    from autodist_tpu_torch.strategy.adapter import trainer_from_strategy
    from autodist_tpu_torch.strategy.builders import AllReduce
    m = dict(spec['config']['model'], dtype=getattr(
        torch, spec['config']['model']['dtype']))
    model = TransformerLM(TransformerConfig(**m), device=device)
    return trainer_from_strategy(model, optimizer, AllReduce(),
                                 spec=ParallelSpec(**spec['cell']['spec']))
