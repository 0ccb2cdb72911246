"""A minimal image classifier on the zero-touch adapter, through the
PyTorch port.

The counterpart of ``examples/image_classifier.py``: the user's code is
an unmodified ``torch.nn`` CNN (the reference example's keras
Sequential: conv 3x3 x 32, relu, 2x2 max-pool, dense 10), with nothing
framework-specific in it. Its parameters become a nested dict of tensors
(``init_fn``), ``torch.func.functional_call`` runs it on them inside the
user's own ``loss_fn``, and :class:`FunctionalModel` makes the pair a
model that any strategy builder distributes.

As in the JAX example the data is a synthetic stand-in with
Fashion-MNIST's shapes (28x28x1, 10 classes): class k is noise around
brightness k/10.

    python examples_torch/image_classifier.py                # on the card
    python examples_torch/image_classifier.py --device cpu --strategy PartitionedPS
"""
import argparse
import math

import _common
import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch import optim
from autodist_tpu_torch import strategy as strategies
from autodist_tpu_torch.models.weights import flatten_tree
from autodist_tpu_torch.strategy.adapter import (FunctionalModel,
                                                 trainer_from_strategy)

BATCH_SIZE = 64
BUILDERS = ('AllReduce', 'PS', 'PSLoadBalancing', 'PartitionedPS',
            'UnevenPartitionedPS', 'PartitionedAR', 'RandomAxisPartitionAR',
            'Parallax')


class CNN(nn.Module):
    """The reference example's keras Sequential, as a torch module on
    NCHW images (SAME padding, as flax's ``nn.Conv``)."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(1, 32, 3, padding=1)
        self.dense = nn.Linear(32 * 14 * 14, 10)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv(x)), 2)
        return self.dense(x.flatten(1))


def data(n=512, seed=0):
    """(images [n, 28, 28, 1] f32 in NHWC, as the JAX example's, labels)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=(n,))
    images = (labels[:, None, None, None] / 10.0 +
              0.1 * rng.rand(n, 28, 28, 1)).astype(np.float32) - 0.5
    return images, labels.astype(np.int64)


def functional(net):
    """(init_fn, loss_fn, apply_fn) of an unmodified module: its
    parameters as a nested dict (``conv/weight``, ...), run through
    ``torch.func.functional_call``."""
    names = dict(net.named_parameters())

    def init_fn(generator):
        tree = {}
        for name, p in names.items():
            fan_in = math.prod(p.shape[1:]) if p.dim() > 1 else 0
            value = (torch.randn(p.shape, generator=generator) /
                     math.sqrt(fan_in)) if fan_in else torch.zeros(p.shape)
            head, leaf = name.rsplit('.', 1)
            tree.setdefault(head, {})[leaf] = value
        return tree

    def apply_fn(params, images):
        flat = {'.'.join(path): v for path, v in flatten_tree(params)}
        x = images.permute(0, 3, 1, 2)             # NHWC -> NCHW
        return torch.func.functional_call(net, flat, (x,))

    def loss_fn(params, batch):
        # (sum, count): the Trainer takes the global mean at dp > 1
        logits = apply_fn(params, batch['image'])
        labels = batch['label'].long()
        return F.cross_entropy(logits, labels, reduction='sum'), \
            labels.numel()
    return init_fn, loss_fn, apply_fn


def train(builder, steps, device=None, seed=0):
    """``steps`` Adam steps of the CNN placed by ``builder`` (a name in
    ``BUILDERS``). Returns the losses."""
    net = CNN().to(device or 'cuda')
    init_fn, loss_fn, apply_fn = functional(net)
    model = FunctionalModel(init_fn, loss_fn, apply_fn=apply_fn,
                            device=device)
    trainer = trainer_from_strategy(model, optim.adam(2e-3),
                                    getattr(strategies, builder)())
    state = trainer.init(seed=seed)
    images, labels = data()
    losses = []
    for step in range(steps):
        lo = (step * BATCH_SIZE) % (len(images) - BATCH_SIZE)
        batch = {'image': images[lo:lo + BATCH_SIZE],
                 'label': labels[lo:lo + BATCH_SIZE]}
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics['loss']))
    return losses


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--strategy', default='PS', choices=BUILDERS)
    p.add_argument('--steps', type=int, default=15)
    _common.add_device_flag(p)
    args = p.parse_args()
    for loss in train(args.strategy, args.steps, args.device):
        print('train_loss: %.4f' % loss)


if __name__ == '__main__':
    main()
