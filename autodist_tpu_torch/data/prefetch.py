"""Device prefetch: overlap host-to-device copies with device compute.

The counterpart of ``autodist_tpu/data/prefetch.py``. ``place_fn``
(``Trainer.shard_batch``) copies a host batch to the card from pinned
memory with ``non_blocking=True``, which returns once the copy is queued
on the current stream; keeping ``size`` placed batches in flight lets
the copy of batch N+1 run while the host queues the step on batch N.
"""
import collections


def prefetch_to_device(iterator, place_fn, size=2):
    """Yield device-placed batches with ``size`` batches in flight.

    Args:
        iterator: iterable of host batches.
        place_fn: host batch -> placed batch (e.g.
            ``Trainer.shard_batch``; must not block on the copy).
        size: number of placed batches to keep in flight (>= 1).

    Yields:
        placed batches, in order. An error from the source or from
        ``place_fn`` is raised only after the batches placed before it
        have been consumed.
    """
    if size < 1:
        raise ValueError('prefetch size must be >= 1, got %d' % size)
    buf = collections.deque()
    it = iter(iterator)
    pending = []   # a source/placement error, deferred until buf drains

    def fill():
        if pending:
            return False
        try:
            buf.append(place_fn(next(it)))
        except StopIteration:
            return False
        except Exception as e:   # noqa: BLE001 - re-raised after drain
            pending.append(e)
            return False
        return True

    for _ in range(size):
        if not fill():
            break
    while buf:
        out = buf.popleft()
        fill()
        yield out
    if pending:
        raise pending[0]
