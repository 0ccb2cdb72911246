"""``Saver``: checkpointing is not ported yet.

The JAX package's ``checkpoint/saver.py`` writes logical-layout
checkpoints; its port is ROADMAP.md Queue 1 item 11. Until then the
port's ``Saver`` refuses to be built, so a program that checkpoints
fails at once instead of training without its checkpoints.
"""


class Saver:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            'Saver: checkpointing is not ported yet (ROADMAP.md Queue 1 '
            'item 11)')
