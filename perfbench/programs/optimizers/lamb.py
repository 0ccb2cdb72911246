"""The port's LAMB (``optim.lamb``); its slots are Adam's, so the first
gradient is read as AdamW's is."""
from perfbench.programs.optimizers.adamw import first_gradient  # noqa: F401


def build(o):
    from autodist_tpu_torch import optim
    return optim.lamb(o['learning_rate'], b1=o['b1'], b2=o['b2'],
                      eps=o['eps'], weight_decay=o['weight_decay'])
