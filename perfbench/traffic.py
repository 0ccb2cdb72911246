"""The one traffic generator: a ring of distinct global batches from a
traffic file's parameters and the run's seed.

Token ids follow a Zipf law over the vocabulary (rank k has weight
k^-s, id k - 1), as natural-language token frequencies do; uniform ids
would flatter the embedding's scatter-add in the backward. Targets are
the next token of the same draw (``"next"``, a causal language model)
or a second draw of the same law (``"independent"``, a target the
input does not hold). Every seed gives the same sizes; only the ids
differ.
"""
import numpy as np

SEED_SPACE = 2 ** 64


def zipf_cdf(vocab, exponent):
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -exponent
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def draw(rng, cdf, shape):
    """Ids of ``shape`` by the law whose CDF is ``cdf``."""
    ids = np.searchsorted(cdf, rng.random(shape), side='right')
    return np.minimum(ids, len(cdf) - 1).astype(np.int32)


def ring(traffic, vocab, seed):
    """``traffic['ring']`` global batches ``{'tokens', 'targets'}``, int32
    [batch, seq] each, all rows distinct draws."""
    rng = np.random.default_rng([seed % SEED_SPACE, 0x7AF1C])
    cdf = zipf_cdf(vocab, traffic['zipf_exponent'])
    b, s = traffic['batch'], traffic['seq']
    out = []
    for _ in range(traffic['ring']):
        if traffic['targets'] == 'next':
            ids = draw(rng, cdf, (b, s + 1))
            out.append({'tokens': ids[:, :-1].copy(),
                        'targets': ids[:, 1:].copy()})
        elif traffic['targets'] == 'independent':
            out.append({'tokens': draw(rng, cdf, (b, s)),
                        'targets': draw(rng, cdf, (b, s))})
        else:
            raise ValueError('traffic targets %r: expected "next" or '
                             '"independent"' % (traffic['targets'],))
    return out
