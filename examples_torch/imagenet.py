"""ImageNet CNN training through the PyTorch port (the reference's
``examples/benchmark/imagenet.py`` role): ResNet-50/101/152, VGG16,
DenseNet-121 and InceptionV3 through the functional ``Trainer``, or
through ``trainer_from_strategy`` with a reference-style strategy
builder.

Data: when ``--data`` (or ``SYS_DATA_PATH``) holds ``images.records``
and ``labels.records`` (ADTR1 files written with
``autodist_tpu_torch.data.loader.write_records``: f32 NHWC images, int32
labels), batches stream through the native C++ reader; otherwise one
synthetic batch is reused, as the reference's synthetic mode does.

    python examples_torch/imagenet.py --model resnet101 --batch 256 --steps 20
    AUTODIST_FUSED_CONV=1 python examples_torch/imagenet.py --data /data/records
    python examples_torch/imagenet.py --device cpu --model resnet50 --tiny --steps 3
"""
import argparse
import os
import time

import _common
import numpy as np
import torch

MODELS = ('resnet50', 'resnet101', 'resnet152', 'vgg16', 'densenet121',
          'inception')


def build_model(name, tiny, dtype, device=None, seed=0):
    """(model, image side). ``tiny``: the CPU-smoke configs of the JAX
    example (small stacks, 32 px, 10 classes; InceptionV3 needs 80)."""
    from autodist_tpu_torch.models import vision
    kw = dict(dtype=dtype, device=device, seed=seed)
    if tiny:
        builders = {
            'resnet50': lambda: vision.ResNet((1, 1), num_classes=10, **kw),
            'resnet101': lambda: vision.ResNet((1, 2), num_classes=10, **kw),
            'resnet152': lambda: vision.ResNet((2, 2), num_classes=10, **kw),
            'vgg16': lambda: vision.VGG((16, 'M', 32, 'M'), num_classes=10,
                                        fc_spatial=8, **kw),
            'densenet121': lambda: vision.DenseNet((2, 2), num_classes=10,
                                                   **kw),
            'inception': lambda: vision.InceptionV3(num_classes=10, **kw),
        }
        return builders[name](), (80 if name == 'inception' else 32)
    builders = {
        'resnet50': vision.ResNet.resnet50,
        'resnet101': vision.ResNet.resnet101,
        'resnet152': vision.ResNet.resnet152,
        'vgg16': vision.VGG.vgg16,
        'densenet121': vision.DenseNet.densenet121,
        'inception': vision.InceptionV3,
    }
    return builders[name](**kw), (299 if name == 'inception' else 224)


def record_stream(data_dir, batch, hw, native=True):
    """Batches {'images', 'labels'} from ``data_dir``'s
    ``images.records`` and ``labels.records`` through the native reader
    (``native=True``: a failed build raises, no Python fallback), or
    None when the files are not there. The reader thread prefetches, so
    host IO overlaps the steps; shuffle stays off to keep the two files
    aligned record for record."""
    img = os.path.join(data_dir or '', 'images.records')
    lab = os.path.join(data_dir or '', 'labels.records')
    if not (data_dir and os.path.exists(img) and os.path.exists(lab)):
        return None
    from autodist_tpu_torch.data.loader import DataLoader
    images = DataLoader([img], batch, (hw, hw, 3), 'float32', shuffle=False,
                        native=native)
    labels = DataLoader([lab], batch, (), 'int32', shuffle=False,
                        native=native)

    def gen():
        try:
            while True:
                yield {'images': images.next_batch(),
                       'labels': labels.next_batch()}
        finally:
            images.close()
            labels.close()
    return gen()


def synthetic_batch(batch, hw, num_classes, seed=0):
    rng = np.random.RandomState(seed)
    return {'images': rng.rand(batch, hw, hw, 3).astype('f4'),
            'labels': rng.randint(0, num_classes, (batch,), dtype=np.int32)}


def make_trainer(model, lr, strategy=None):
    from autodist_tpu_torch import optim
    from autodist_tpu_torch.api import Trainer
    from autodist_tpu_torch.parallel.axes import ParallelSpec
    opt = optim.sgd(lr, momentum=0.9)
    if strategy:
        from autodist_tpu_torch import strategy as strategies
        from autodist_tpu_torch.strategy.adapter import trainer_from_strategy
        return trainer_from_strategy(model, opt,
                                     getattr(strategies, strategy)())
    return Trainer(model, opt, spec=ParallelSpec())


def stream_steps(trainer, state, stream, steps):
    """One warm-up step, then ``steps`` steps on fresh batches from
    ``stream``. Returns (state, last loss, elapsed s, seconds spent
    waiting on the stream per step)."""
    state, m = trainer.step(state, next(stream))
    float(m['loss'])
    waits = []
    t0 = time.perf_counter()
    for _ in range(steps):
        t1 = time.perf_counter()
        batch = next(stream)
        waits.append(time.perf_counter() - t1)
        state, m = trainer.step(state, batch)
    loss = float(m['loss'])
    return state, loss, time.perf_counter() - t0, waits


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--model', default='resnet101', choices=MODELS)
    p.add_argument('--batch', type=int, default=64)
    p.add_argument('--steps', type=int, default=20)
    p.add_argument('--lr', type=float, default=0.1)
    p.add_argument('--tiny', action='store_true',
                   help='small config for CPU smoke runs')
    p.add_argument('--fp32', action='store_true')
    p.add_argument('--strategy', default=None,
                   help='optional reference strategy builder (PS, '
                        'PSLoadBalancing, PartitionedPS, AllReduce, ...)')
    p.add_argument('--data', default=None)
    p.add_argument('--eval', action='store_true',
                   help='after training, evaluate loss and accuracy in '
                        'eval mode (BatchNorm running statistics)')
    _common.add_device_flag(p)
    args = p.parse_args()

    dtype = torch.float32 if (args.fp32 or args.tiny) else torch.bfloat16
    model, hw = build_model(args.model, args.tiny, dtype, args.device)
    num_classes = 10 if args.tiny else 1000
    trainer = make_trainer(model, args.lr, args.strategy)
    state = trainer.init(seed=0)
    stream = record_stream(args.data or os.environ.get('SYS_DATA_PATH'),
                           args.batch, hw)
    if stream is not None:   # records: a fresh batch every step
        state, loss, dt, _ = stream_steps(trainer, state, stream, args.steps)
    else:
        batch = synthetic_batch(args.batch, hw, num_classes)
        state, loss, dt = _common.timed_steps(trainer, state, batch,
                                              args.steps)
    print('%s: %.1f img/s, loss=%.4f (%s)' % (
        args.model, args.steps * args.batch / dt, loss, args.device))
    if args.eval:
        def accuracy(params, b):
            logits = model.apply(params, b['images'])
            return {'acc': (logits.argmax(-1) == b['labels']).float().mean()}
        eval_batch = batch if stream is None else next(stream)
        metrics = trainer.evaluate(state, [eval_batch], metrics_fn=accuracy)
        print('eval (running stats): loss=%.4f acc=%.3f'
              % (metrics['loss'], metrics['acc']))


if __name__ == '__main__':
    main()
