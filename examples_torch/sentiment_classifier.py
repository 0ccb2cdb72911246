"""Minimal sentiment classifier through the reference-shaped DSL API, on
the PyTorch port.

The counterpart of ``examples/sentiment_classifier.py``: an
embedding-bag + 2-layer MLP under ``autodist.scope()`` with
``PartitionedPS`` by default. The embedding table is the interesting
variable: its gradient is sparse, and the table is partitioned over the
PS destinations.

As in the JAX example the demo trains on synthetic token sequences
whose label is planted on a few indicator words (no dataset download):
enough signal for the loss to fall. Every value comes from one numpy
seed, so a run prints the numbers the JAX example prints.

    python examples_torch/sentiment_classifier.py
    python examples_torch/sentiment_classifier.py --device cpu \
        --strategy Parallax
"""
import argparse
import time

import _common
import numpy as np

import autodist_tpu_torch as ad
from autodist_tpu_torch import strategy as strategies

VOCAB, EMBED, HIDDEN, SEQ = 10000, 16, 16, 256
EXAMPLES = 4096


def synthetic_reviews(n, rng):
    """Token sequences with a planted sentiment signal: ids < 50 are
    'positive' words, 50..99 'negative'; the label is which side
    dominates."""
    tokens = rng.randint(100, VOCAB, size=(n, SEQ))
    pos = rng.randint(0, 8, size=n)
    neg = rng.randint(0, 8, size=n)
    for i in range(n):
        tokens[i, :pos[i]] = rng.randint(0, 50, size=pos[i])
        tokens[i, pos[i]:pos[i] + neg[i]] = \
            rng.randint(50, 100, size=neg[i])
    return tokens.astype(np.int32), (pos > neg).astype(np.float32)


def run(strategy='PartitionedPS', steps=20, batch_size=128,
        log_frequency=10, device=None, log=print):
    """Train ``steps`` Adam steps; ``log`` gets every ``log_frequency``-th
    step's line. Returns ``{'losses': {step: loss}, 'emb_shape': ...,
    'emb_norm': ...}`` (the logged steps' losses)."""
    rng = np.random.RandomState(0)
    tokens, labels = synthetic_reviews(EXAMPLES, rng)

    autodist = ad.AutoDist(
        strategy_builder=getattr(strategies, strategy)(), device=device)
    losses = {}
    with autodist.scope():
        x = ad.placeholder(shape=[None, SEQ], dtype=np.int32, name='x')
        y = ad.placeholder(shape=[None], dtype=np.float32, name='y')
        emb = ad.Variable(
            rng.rand(VOCAB, EMBED).astype(np.float32), name='emb')
        w1 = ad.Variable(
            rng.rand(EMBED, HIDDEN).astype(np.float32), name='w1')
        b1 = ad.Variable(np.zeros(HIDDEN, np.float32), name='b1')
        w2 = ad.Variable(
            rng.rand(HIDDEN, 1).astype(np.float32), name='w2')
        b2 = ad.Variable(np.zeros(1, np.float32), name='b2')

        h = ad.ops.reduce_mean(ad.ops.embedding_lookup(emb, x), axis=1)
        h = ad.ops.relu(ad.ops.matmul(h, w1) + b1)
        logits = ad.ops.squeeze(ad.ops.matmul(h, w2) + b2, axis=-1)
        loss = ad.ops.reduce_mean(
            ad.ops.sigmoid_cross_entropy_with_logits(labels=y,
                                                     logits=logits))
        train_op = ad.optimizers.Adam(0.02).minimize(loss)

        sess = autodist.create_distributed_session()
        prev = time.time()
        for step in range(steps):
            lo = (step * batch_size) % (EXAMPLES - batch_size)
            lv, _ = sess.run(
                [loss, train_op],
                {x: tokens[lo:lo + batch_size],
                 y: labels[lo:lo + batch_size]})
            if step % log_frequency == 0:
                now = time.time()
                wps = batch_size * log_frequency / (now - prev)
                losses[step] = float(lv)
                log('Iteration %d, time = %.2fs, wps = %.0f, '
                    'train loss = %.4f' % (step, now - prev, wps, float(lv)))
                prev = now
        emb_val, = sess.run([emb])
    sess.close()
    return {'losses': losses, 'emb_shape': tuple(emb_val.shape),
            'emb_norm': float(np.linalg.norm(emb_val))}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--strategy', default='PartitionedPS')
    p.add_argument('--steps', type=int, default=20)
    p.add_argument('--batch-size', type=int, default=128)
    p.add_argument('--log-frequency', type=int, default=10)
    _common.add_device_flag(p)
    args = p.parse_args(argv)
    out = run(args.strategy, args.steps, args.batch_size,
              args.log_frequency, args.device)
    print('emb table: shape %s, norm %.4f' % (out['emb_shape'],
                                              out['emb_norm']))


if __name__ == '__main__':
    main()
