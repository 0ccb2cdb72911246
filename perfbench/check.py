"""The comparison that decides ``correct`` for a training cell.

Three numbers, each against the limit the cell file states:

- ``loss``: the largest relative gap of a step's loss from the
  reference's, over the compared steps;
- ``grad1``: the first gradient as the optimizer got it, by leaf: the
  gap between the two norms over the reference's norm of that leaf or
  of the median leaf, whichever is larger; the worst leaf;
- ``change``: the same of each leaf's change over the compared steps,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (round-off alone moves them under Adam).
"""
import math
import statistics

NUMBERS = ('loss', 'grad1', 'change')
QUIET_LEAF = 1e-3


def worst_leaf(got, want, leaves):
    floor = statistics.median(want[k] for k in leaves)
    gaps = [abs(got[k] - want[k]) / max(want[k], floor, 1e-30)
            for k in leaves]
    return max(gaps) if all(map(math.isfinite, gaps)) else math.inf


def numbers(got, want):
    """The three numbers of readings ``got`` against ``want`` (both as
    ``reference.run.readings`` gives them; leaves by '/'-path)."""
    gaps = [abs(g - w) / abs(w) for g, w in zip(got['losses'],
                                                want['losses'])]
    loss = max(gaps) if all(map(math.isfinite, gaps)) else math.inf
    leaves = sorted(want['grad1'])
    floor = statistics.median(want['grad1'][k] for k in leaves)
    moving = [k for k in leaves if want['grad1'][k] >= QUIET_LEAF * floor]
    return {'loss': loss,
            'grad1': worst_leaf(got['grad1'], want['grad1'], leaves),
            'change': worst_leaf(got['change'], want['change'], moving)}


def verdict(nums, limits):
    """(correct, {name: {'value', 'limit'}}): every number finite and
    within its limit."""
    checks = {k: {'value': nums[k], 'limit': limits[k]} for k in NUMBERS}
    ok = all(math.isfinite(c['value']) and c['value'] <= c['limit']
             for c in checks.values())
    return ok, checks
