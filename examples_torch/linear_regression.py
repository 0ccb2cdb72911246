"""Linear regression through the reference-shaped DSL API, on the
PyTorch port.

The counterpart of ``examples/linear_regression.py``: build the model
under ``autodist.scope()``, create a distributed session, feed numpy
batches, under any of the eight strategy builders. One process per
device (``torchrun`` or ``AUTODIST_PROCESS_ID`` / ``AUTODIST_NUM_PROCESSES``
for more than one):

    python examples_torch/linear_regression.py --strategy PS --epochs 10
    python examples_torch/linear_regression.py --device cpu \
        --strategy PartitionedPS
"""
import argparse

import _common
import numpy as np

import autodist_tpu_torch as ad
from autodist_tpu_torch import strategy as strategies

STRATEGIES = {
    'PS': lambda: strategies.PS(),
    'PSLoadBalancing': lambda: strategies.PSLoadBalancing(),
    'PartitionedPS': lambda: strategies.PartitionedPS(),
    'UnevenPartitionedPS': lambda: strategies.UnevenPartitionedPS(),
    'AllReduce': lambda: strategies.AllReduce(chunk_size=128),
    'PartitionedAR': lambda: strategies.PartitionedAR(),
    'RandomAxisPartitionAR': lambda: strategies.RandomAxisPartitionAR(),
    'Parallax': lambda: strategies.Parallax(),
}
TRUE_W, TRUE_B, NUM_EXAMPLES = 3.0, 2.0, 1000


def run(strategy='AllReduce', epochs=10, lr=0.01, resource_spec=None,
        device=None, log=print):
    """Train ``epochs`` full-batch SGD steps; ``log`` gets each epoch's
    line. Returns ``{'losses': [...], 'W': float, 'b': float}``."""
    np.random.seed(123)
    inputs = np.random.randn(NUM_EXAMPLES).astype(np.float32)
    noises = np.random.randn(NUM_EXAMPLES).astype(np.float32)
    outputs = inputs * TRUE_W + TRUE_B + noises

    autodist = ad.AutoDist(resource_spec_file=resource_spec,
                           strategy_builder=STRATEGIES[strategy](),
                           device=device)
    losses = []
    with autodist.scope():
        x = ad.placeholder(shape=[None], dtype=np.float32, name='x')
        y = ad.placeholder(shape=[None], dtype=np.float32, name='y')
        W = ad.Variable(5.0, name='W')
        b = ad.Variable(0.0, name='b')
        loss = ad.ops.reduce_mean(ad.ops.square(W * x + b - y))
        train_op = ad.optimizers.SGD(lr).minimize(loss, [W, b])
        sess = autodist.create_distributed_session()
        for epoch in range(epochs):
            lv, _ = sess.run([loss, train_op], {x: inputs, y: outputs})
            losses.append(float(lv))
            log('epoch %d: loss=%.5f' % (epoch, float(lv)))
        W_val, b_val = sess.run([W, b])
    sess.close()
    return {'losses': losses, 'W': float(np.ravel(W_val)[0]),
            'b': float(np.ravel(b_val)[0])}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--strategy', default='AllReduce',
                   choices=sorted(STRATEGIES))
    p.add_argument('--resource-spec', default=None,
                   help='resource spec YAML (default: the local devices)')
    p.add_argument('--epochs', type=int, default=10)
    p.add_argument('--lr', type=float, default=0.01)
    _common.add_device_flag(p)
    args = p.parse_args(argv)
    out = run(args.strategy, args.epochs, args.lr, args.resource_spec,
              args.device)
    print('W=%.5f (true %.1f)  b=%.5f (true %.1f)' %
          (out['W'], TRUE_W, out['b'], TRUE_B))


if __name__ == '__main__':
    main()
