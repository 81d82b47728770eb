"""MNIST training with PyTorch from a petastorm dataset, on the card.

Counterpart of ``examples/mnist/pytorch_example.py``: ``make_reader``
streams decoded rows, :class:`petastorm_tpu_torch.pytorch.DataLoader`
collates them into tensors and moves them to the card, the normalize
kernel (:func:`petastorm_tpu_torch.ops.normalize.normalize_images`)
computes ``(x/255 - 0.1307)/0.3081``, and the example's small CNN trains
with SGD. ``evaluate`` scores it.

    python -m petastorm_tpu_torch.examples.mnist_pytorch --generate \\
        --dataset-url file:///tmp/mnist_petastorm_torch
"""

import argparse
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from petastorm_tpu_torch.examples.mnist import MNIST_MEAN, MNIST_STD
from petastorm_tpu_torch.ops.normalize import normalize_images


class Net(nn.Module):
    """The reference example's CNN: conv 1→10 k5, conv 10→20 k5, fc
    320→50→10, log-softmax output."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 10, kernel_size=5)
        self.conv2 = nn.Conv2d(10, 20, kernel_size=5)
        self.fc1 = nn.Linear(320, 50)
        self.fc2 = nn.Linear(50, 10)

    def forward(self, x):
        x = F.relu(F.max_pool2d(self.conv1(x), 2))
        x = F.relu(F.max_pool2d(self.conv2(x), 2))
        x = x.view(-1, 320)
        x = F.relu(self.fc1(x))
        return F.log_softmax(self.fc2(x), dim=1)


def load_reference_state(numpy_state_dict):
    """A :class:`Net` on the CPU holding the reference example's ``Net``
    weights, given as ``{name: numpy array}``; the names must match this
    module tree's one for one."""
    model = Net()
    model.load_state_dict({name: torch.from_numpy(np.array(value))
                           for name, value in numpy_state_dict.items()}, strict=True)
    return model


def normalized_images(images, normalize=normalize_images):
    """uint8 ``(B, 28, 28)`` images → f32 ``(B, 1, 28, 28)`` NCHW, through
    ``normalize`` (the kernel on a CUDA tensor, its plain version on the
    CPU)."""
    out = normalize(images[..., None], mean=MNIST_MEAN, std=MNIST_STD,
                    out_dtype=torch.float32)
    # with one channel the permuted strides also read as channels-last,
    # which the convolutions would keep and Net's view(-1, 320) refuses
    return out.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)


def _batches(dataset_url, batch_size, epochs, shuffle_buffer, device, seed,
             reader_pool_type):
    from petastorm_tpu_torch.pytorch import DataLoader
    from petastorm_tpu_torch.reader import make_reader

    reader = make_reader(dataset_url, num_epochs=epochs, reader_pool_type=reader_pool_type,
                         schema_fields=['^digit$', '^image$'])
    return DataLoader(reader, batch_size=batch_size,
                      shuffling_queue_capacity=shuffle_buffer, seed=seed, device=device)


def train(dataset_url, batch_size=32, epochs=1, lr=0.01, momentum=0.5,
          log_interval=20, shuffle_buffer=256, device=None, model=None, seed=None,
          max_steps=None, reader_pool_type='thread', normalize=normalize_images):
    """SGD over ``epochs`` of the dataset (or its first ``max_steps``
    batches); returns ``{'loss': last, 'losses': [...], 'model': net,
    'rows_per_s': r, 'steps_per_s': s, 'batch_devices': [...]}``, the rates
    timed from the first batch to the last loss on the host.

    :param model: the :class:`Net` to train (moved to ``device``); None
        builds one from torch's global generator, as the reference does.
    :param seed: the row shuffling buffer's seed (None: unseeded).
    :param normalize: the function that normalizes the uint8 NHWC batch.
    """
    from petastorm_tpu_torch.device.loader import resolve_device
    device = resolve_device(device)
    model = (Net() if model is None else model).to(device)
    optimizer = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum)
    model.train()
    losses = []
    devices = set()
    with _batches(dataset_url, batch_size, epochs, shuffle_buffer, device, seed,
                  reader_pool_type) as loader:
        start = time.perf_counter()
        for batch in loader:
            devices.update(str(t.device) for t in batch.values())
            images = normalized_images(batch['image'], normalize)
            labels = batch['digit'].long()
            optimizer.zero_grad()
            loss = F.nll_loss(model(images), labels)
            loss.backward()
            optimizer.step()
            if log_interval and len(losses) % log_interval == 0:
                print('step %d loss %.4f' % (len(losses), loss.item()))
            losses.append(loss.detach())
            if max_steps is not None and len(losses) >= max_steps:
                break
        losses = [float(loss) for loss in losses]
        elapsed = time.perf_counter() - start
    return {'loss': losses[-1], 'losses': losses, 'model': model,
            'rows_per_s': len(losses) * batch_size / elapsed,
            'steps_per_s': len(losses) / elapsed, 'batch_devices': sorted(devices)}


def evaluate(dataset_url, model, batch_size=64, device=None, reader_pool_type='thread'):
    """Accuracy of ``model`` over one pass of the dataset."""
    from petastorm_tpu_torch.device.loader import resolve_device
    device = resolve_device(device)
    model.eval()
    correct = total = 0
    with torch.no_grad():
        with _batches(dataset_url, batch_size, 1, 0, device, None,
                      reader_pool_type) as loader:
            for batch in loader:
                pred = model(normalized_images(batch['image'])).argmax(dim=1)
                correct += int((pred == batch['digit'].long()).sum())
                total += len(pred)
    return correct / max(total, 1)


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--dataset-url', default='file:///tmp/mnist_petastorm_torch')
    parser.add_argument('--generate', action='store_true',
                        help='write a synthetic MNIST dataset first')
    parser.add_argument('--rows', type=int, default=2048, help='rows to generate')
    parser.add_argument('--batch-size', type=int, default=32)
    parser.add_argument('--epochs', type=int, default=1)
    parser.add_argument('--device', default=None)
    args = parser.parse_args()
    if args.generate:
        from petastorm_tpu_torch.examples.mnist import generate_synthetic_mnist
        generate_synthetic_mnist(args.dataset_url, num_rows=args.rows)
    result = train(args.dataset_url, batch_size=args.batch_size, epochs=args.epochs,
                   device=args.device)
    print('final loss %.4f, accuracy %.4f' % (
        result['loss'], evaluate(args.dataset_url, result['model'], device=args.device)))
