"""MNIST end to end on the card: Parquet → make_torch_loader → normalize
kernel → CNN SGD steps.

Counterpart of ``examples/mnist/{schema,jax_example}.py``. Images come off
disk as uint8, are staged to the device and normalized there by the
hand-written kernel (:func:`petastorm_tpu_torch.ops.normalize.normalize_images`).

    python -m petastorm_tpu_torch.examples.mnist --generate --steps 50
"""

import argparse
import time

import numpy as np
import pyarrow as pa
import torch

from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

MnistSchema = Unischema('MnistSchema', [
    UnischemaField('idx', np.int64, (), ScalarCodec(pa.int64()), False),
    UnischemaField('digit', np.int64, (), ScalarCodec(pa.int64()), False),
    UnischemaField('image', np.uint8, (28, 28), NdarrayCodec(), False),
])

MNIST_MEAN = (0.1307,)
MNIST_STD = (0.3081,)


def generate_synthetic_mnist(url, num_rows=2048, seed=0, rowgroup_size_rows=256):
    """Synthetic stand-in for the MNIST download: blobs whose intensity
    encodes the label, learnable and offline (the same rows as the JAX
    example's generator for the same seed)."""
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(num_rows):
        digit = int(i % 10)
        image = (rng.rand(28, 28) * 64 + digit * 19).astype(np.uint8)
        rows.append({'idx': i, 'digit': digit, 'image': image})
    write_dataset(url, MnistSchema, rows, rowgroup_size_rows=rowgroup_size_rows)


def train(dataset_url, batch_size=64, steps=50, learning_rate=0.05, seed=0,
          device=None, workers_count=None):
    """``steps`` SGD steps over an infinite shuffled loader; returns
    ``{'losses': [...], 'rows_per_s': r, 'steps_per_s': s,
    'batch_devices': [...]}``. The rates
    are timed from the first step's start to the last loss on the host."""
    from petastorm_tpu_torch.device.loader import make_torch_loader, resolve_device
    from petastorm_tpu_torch.models.mnist import init_mnist, mnist_train_step
    from petastorm_tpu_torch.ops.normalize import normalize_images

    device = resolve_device(device)
    model = init_mnist(seed, device)
    optimizer = torch.optim.SGD(model.parameters(), lr=learning_rate)
    step = mnist_train_step(model, optimizer)
    losses = []
    devices = set()
    with make_torch_loader(dataset_url, batch_size=batch_size,
                           fields=['^digit$', '^image$'], num_epochs=None,
                           shuffle_rows=True, seed=seed, device=device,
                           workers_count=workers_count) as loader:
        start = time.perf_counter()
        for batch in loader.iter_steps(steps):
            devices.update(str(t.device) for t in batch.values())
            images = normalize_images(batch['image'][..., None],
                                      mean=MNIST_MEAN, std=MNIST_STD)
            losses.append(step(images.float(), batch['digit']))
        losses = [float(loss) for loss in losses]
        elapsed = time.perf_counter() - start
    return {'losses': losses, 'rows_per_s': steps * batch_size / elapsed,
            'steps_per_s': steps / elapsed, 'batch_devices': sorted(devices)}


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--dataset-url', default='file:///tmp/mnist_petastorm_torch')
    parser.add_argument('--generate', action='store_true')
    parser.add_argument('--steps', type=int, default=50)
    parser.add_argument('--device', default=None)
    args = parser.parse_args()
    if args.generate:
        generate_synthetic_mnist(args.dataset_url)
    result = train(args.dataset_url, steps=args.steps, device=args.device)
    print('final loss %.4f, %.1f rows/s' % (result['losses'][-1], result['rows_per_s']))
