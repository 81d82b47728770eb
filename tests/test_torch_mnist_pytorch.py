"""petastorm_tpu_torch.examples.mnist_pytorch against the reference
example ``examples/mnist/pytorch_example.py``, on the CPU.

Both start from the same ``Net`` weights (the reference's, carried across
by ``load_reference_state``) and read the same rows in the same order
(dummy pool, row buffer seeded 0): the reference example's loop through
the JAX package's ``DataLoader`` with its inline normalization, and the
port's ``train`` through its ``DataLoader`` and ``normalize_images``. The
normalized batches agree within 2e-6 absolute (the kernel's formula is
``x * (1/(255*std)) + (-mean/std)``, the example's ``(x/255 - mean)/std``:
a few f32 ulps apart) and the 20 losses within 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from examples.mnist import pytorch_example as reference
from petastorm_tpu.pytorch import DataLoader as JaxDataLoader
from petastorm_tpu.reader import make_reader as jax_make_reader
from petastorm_tpu_torch.examples import mnist_pytorch
from petastorm_tpu_torch.examples.mnist import generate_synthetic_mnist
from petastorm_tpu_torch.ops.normalize import normalize_images
from tests.torch_cpu_threads import few_torch_threads  # noqa: F401 - autouse
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

STEPS = 20
NORMALIZE_ATOL = 2e-6
LOSS_RTOL = 1e-5


@pytest.fixture(scope='module')
def mnist_url(tmp_path_factory):
    url = 'file://%s/mnist' % tmp_path_factory.mktemp('mnist_pytorch')
    generate_synthetic_mnist(url, num_rows=768, rowgroup_size_rows=128)
    return url


def _reference_weights(seed):
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        return {name: value.numpy().copy() for name, value in reference.Net().state_dict().items()}


def _reference_images(batch):
    """The reference example's inline normalization (its ``train`` and
    ``evaluate``)."""
    images = batch['image'].float().unsqueeze(1) / 255.0
    return (images - 0.1307) / 0.3081


def _reference_train(url, weights, steps):
    """The reference example's ``train`` loop, on the dummy pool with the
    row buffer seeded 0: per-step losses and normalized batches."""
    model = reference.Net()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.5)
    model.train()
    losses, images_seen = [], []
    reader = jax_make_reader(url, num_epochs=1, schema_fields=['^digit$', '^image$'],
                             reader_pool_type='dummy')
    with JaxDataLoader(reader, batch_size=32, shuffling_queue_capacity=256, seed=0) as loader:
        for batch in loader:
            images = _reference_images(batch)
            images_seen.append(images)
            optimizer.zero_grad()
            loss = torch.nn.functional.nll_loss(model(images), batch['digit'].long())
            loss.backward()
            optimizer.step()
            losses.append(loss.item())
            if len(losses) == steps:
                break
    return losses, images_seen


def test_module_trees_match_name_for_name():
    weights = _reference_weights(0)
    model = mnist_pytorch.load_reference_state(weights)
    assert list(model.state_dict()) == list(weights)
    for name, value in model.state_dict().items():
        assert np.array_equal(value.numpy(), weights[name]), name
    with pytest.raises(RuntimeError):
        mnist_pytorch.load_reference_state({k: v for k, v in weights.items() if k != 'fc2.bias'})


@pytest.mark.parametrize('seed', [0, 1])
def test_twenty_steps_match_the_reference_example(mnist_url, seed):
    weights = _reference_weights(seed)
    want_losses, want_images = _reference_train(mnist_url, weights, STEPS)
    got_images = []

    def recording_normalize(images, **kw):
        out = normalize_images(images, **kw)
        got_images.append(out.permute(0, 3, 1, 2).clone())
        return out

    result = mnist_pytorch.train(mnist_url, device='cpu', seed=0, max_steps=STEPS,
                                 reader_pool_type='dummy', log_interval=0,
                                 model=mnist_pytorch.load_reference_state(weights),
                                 normalize=recording_normalize)
    assert len(result['losses']) == len(want_losses) == STEPS
    assert result['batch_devices'] == ['cpu']
    for want, got in zip(want_images, got_images):
        assert got.shape == want.shape == (32, 1, 28, 28) and got.dtype == torch.float32
        assert float((got - want).abs().max()) <= NORMALIZE_ATOL
    gaps = [abs(g - w) / abs(w) for w, g in zip(want_losses, result['losses'])]
    assert max(gaps) <= LOSS_RTOL, gaps
    assert result['loss'] == result['losses'][-1]


def test_normalization_matches_the_inline_formula():
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.randint(0, 256, (16, 28, 28)).astype(np.uint8))
    got = mnist_pytorch.normalized_images(images)
    want = _reference_images({'image': images})
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float((got - want).abs().max()) <= NORMALIZE_ATOL


def test_evaluate_scores_as_the_reference(mnist_url):
    weights = _reference_weights(2)
    want_model = reference.Net()
    want_model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    want = reference.evaluate(mnist_url, want_model)
    got = mnist_pytorch.evaluate(mnist_url, mnist_pytorch.load_reference_state(weights),
                                 device='cpu', reader_pool_type='dummy')
    assert got == want


def test_train_learns_and_reports_rates(mnist_url):
    result = mnist_pytorch.train(mnist_url, device='cpu', seed=0, log_interval=0, epochs=2,
                                 reader_pool_type='dummy',
                                 model=mnist_pytorch.load_reference_state(_reference_weights(0)))
    losses = result['losses']
    assert len(losses) == 2 * 768 // 32
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert result['rows_per_s'] > 0 and result['steps_per_s'] > 0
    # a score over every row, whatever the batch size
    scores = {mnist_pytorch.evaluate(mnist_url, result['model'], batch_size=size, device='cpu')
              for size in (64, 50)}
    assert len(scores) == 1 and 0.0 <= scores.pop() <= 1.0


def test_default_device_is_the_card(mnist_url, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        mnist_pytorch.train(mnist_url, max_steps=1)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        mnist_pytorch.evaluate(mnist_url, mnist_pytorch.Net())
