"""The port's AdamW (``optim.adamw``)."""


def build(o):
    from autodist_tpu_torch import optim
    return optim.adamw(o['learning_rate'], b1=o['b1'], b2=o['b2'],
                       eps=o['eps'], weight_decay=o['weight_decay'])


def first_gradient(slot, o):
    """The first moment after one step over 1 - b1."""
    return slot['exp_avg'] / (1 - o['b1'])
