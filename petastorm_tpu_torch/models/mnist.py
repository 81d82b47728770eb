"""MNIST CNN: the port's hello-world training consumer.

Counterpart of ``petastorm_tpu/models/mnist.py``: two 3×3 convolutions
('SAME' padding, ReLU, 2×2 average pooling), a 256-wide dense layer and
f32 logits, trained with plain SGD on ``{'image': (B,28,28,1), 'digit':
(B,)}`` batches. The public layout stays NHWC like the JAX model's; the
activations flatten in NHWC ``(h, w, c)`` order, so the first dense
layer's weights carry across from Flax with a transpose only
(:func:`params_from_jax`). Parameters are f32; with ``dtype=bfloat16`` the
convolutions and the hidden dense layer compute in bf16 and the last
dense layer in f32, as in the Flax module.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class MnistCNN(nn.Module):
    def __init__(self, num_classes=10, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, 32, 3, padding=1)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1)
        self.fc1 = nn.Linear(7 * 7 * 64, 256)
        self.fc2 = nn.Linear(256, num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Uniform ``±1/sqrt(fan_in)`` init drawn from ``generator``."""
        for layer in (self.conv1, self.conv2, self.fc1, self.fc2):
            fan_in = layer.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            layer.weight.uniform_(-bound, bound, generator=generator)
            layer.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        """``x``: ``(B, 28, 28, 1)`` NHWC; returns f32 logits ``(B, classes)``."""
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.conv2d(x, self.conv1.weight.to(dt), self.conv1.bias.to(dt), padding=1)
        x = F.avg_pool2d(F.relu(x), 2, 2)
        x = F.conv2d(x, self.conv2.weight.to(dt), self.conv2.bias.to(dt), padding=1)
        x = F.avg_pool2d(F.relu(x), 2, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)
        x = F.relu(F.linear(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt)))
        # logits in f32 for a numerically stable softmax
        return F.linear(x.float(), self.fc2.weight, self.fc2.bias)


def init_mnist(seed=0, device=None, dtype=torch.bfloat16):
    """A :class:`MnistCNN` with weights drawn from ``torch.Generator``
    seeded ``seed``, on ``device`` (``None`` means the card)."""
    device = torch.device('cuda' if device is None else device)
    model = MnistCNN(dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def mnist_loss(model, images, labels):
    """Mean softmax cross-entropy of the model's logits."""
    return F.cross_entropy(model(images), labels)


def mnist_train_step(model, optimizer):
    """A ``(images, labels) -> loss`` step: one forward, backward and
    optimizer update."""

    def step(images, labels):
        optimizer.zero_grad(set_to_none=True)
        loss = mnist_loss(model, images, labels)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def params_from_jax(flax_params):
    """A :class:`MnistCNN` ``state_dict`` from the JAX model's Flax params
    (numpy arrays, with or without the outer ``'params'`` level): conv
    kernels HWIO → OIHW, dense kernels ``(in, out)`` → ``(out, in)``."""
    p = flax_params.get('params', flax_params)

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float32))

    state = {}
    for name, key in (('conv1', 'Conv_0'), ('conv2', 'Conv_1')):
        state[name + '.weight'] = tensor(np.transpose(p[key]['kernel'], (3, 2, 0, 1)))
        state[name + '.bias'] = tensor(p[key]['bias'])
    for name, key in (('fc1', 'Dense_0'), ('fc2', 'Dense_1')):
        state[name + '.weight'] = tensor(np.transpose(p[key]['kernel']))
        state[name + '.bias'] = tensor(p[key]['bias'])
    return state
