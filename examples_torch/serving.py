"""Train, export a servable bundle, reload it, and serve, through the
PyTorch port.

The reference's SavedModel flow, as ``examples/serving.py`` runs it on
the JAX package: a linear model written in the DSL trains under
``PSLoadBalancing``; ``SavedModelBuilder`` exports its forward subgraph
(``torch.export``) beside the weights; ``load_servable`` reloads the
bundle and serves it. A fresh process serves the same bundle with torch
+ numpy alone (see ``autodist_tpu_torch/checkpoint/export.py``).

    python examples_torch/serving.py                  # on the card
    python examples_torch/serving.py --device cpu --export-dir /tmp/served
"""
import argparse
import os
import tempfile

import _common
import numpy as np

import autodist_tpu_torch as ad
from autodist_tpu_torch.checkpoint.export import load_servable
from autodist_tpu_torch.checkpoint.saver import SavedModelBuilder
from autodist_tpu_torch.strategy import PSLoadBalancing

#: the largest error against the ground truth the served model may show
TOLERANCE = 0.1


def run(export_dir, epochs=20, device=None):
    """Train, export to ``export_dir``, reload and serve three queries.
    Returns (final training loss, served [3, 1], ground truth [3, 1])."""
    np.random.seed(0)
    xs = np.random.randn(256, 4).astype(np.float32)
    true_w = np.array([[1.0], [-2.0], [3.0], [0.5]], np.float32)
    ys = xs @ true_w + 0.01 * np.random.randn(256, 1).astype(np.float32)

    autodist = ad.AutoDist(strategy_builder=PSLoadBalancing(), device=device)
    with autodist.scope():
        x = ad.placeholder(shape=[None, 4], dtype=np.float32, name='x')
        y = ad.placeholder(shape=[None, 1], dtype=np.float32, name='y')
        W = ad.Variable(np.zeros((4, 1), np.float32), name='W')
        b = ad.Variable(np.zeros((1,), np.float32), name='b')
        pred = x @ W + b
        loss = ad.ops.reduce_mean(ad.ops.square(pred - y))
        train_op = ad.optimizers.SGD(0.1).minimize(loss)
        sess = autodist.create_distributed_session()
        for _ in range(epochs):
            lv, _ = sess.run([loss, train_op], {x: xs, y: ys})
        # export: the forward subgraph + weights become a bundle
        builder = SavedModelBuilder(export_dir)
        builder.add_meta_graph_and_variables(
            sess, tags=['serve'],
            signature_def_map={'serving_default': (pred, [x])})
        builder.save()
    sess.close()

    serve = load_servable(export_dir, device=device)
    queries = np.random.randn(3, 4).astype(np.float32)
    out = serve(queries)[0].cpu().numpy()
    return float(lv), out, queries @ true_w


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--export-dir', default=None,
                        help='bundle directory (default: a temporary one)')
    parser.add_argument('--epochs', type=int, default=20)
    _common.add_device_flag(parser)
    ns = parser.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        export_dir = ns.export_dir or os.path.join(tmp, 'served-model')
        loss, out, want = run(export_dir, ns.epochs, ns.device)
        print('final training loss: %.5f' % loss)
        print('served predictions vs ground truth:')
        for got, expect in zip(out[:, 0], want[:, 0]):
            print('  %8.4f  (true %8.4f)' % (got, expect))
        err = float(np.abs(out - want).max())
        assert err < TOLERANCE, \
            'served model diverges from ground truth: %f' % err
        print('export dir: %s (servable with torch + numpy only)'
              % export_dir)


if __name__ == '__main__':
    main()
