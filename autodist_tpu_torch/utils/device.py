"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for another device
(``device='cpu'``, as the tests do). Without a card they raise: they
never carry on quietly on the CPU.
"""
import torch


def resolve_device(device=None):
    """``torch.device`` for ``device``, ``cuda`` when it is None."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass device="cpu" to '
                           'run on the CPU')
    return dev
