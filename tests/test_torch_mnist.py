"""petastorm_tpu_torch MNIST model and the slice end to end, against JAX.

Weights carry across with ``params_from_jax``. Tolerances: f32 logits
``rtol 1e-5, atol 1e-5`` (both sides compute in f32 on the CPU; sums run
in another order); bf16 logits ``atol 1e-2, rtol 1e-2`` (the two
frameworks round the bf16 activations at different places; the gap
measured at this size is about 2e-3 on logits of magnitude 0.4, one bf16
ulp there); f32 parameters after SGD steps ``atol 1e-5``.
"""

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from petastorm_tpu.models.mnist import MnistCNN as JaxMnistCNN
from petastorm_tpu.models.mnist import mnist_train_step as jax_train_step
from petastorm_tpu_torch.models.mnist import (
    MnistCNN, init_mnist, mnist_loss, mnist_train_step, params_from_jax,
)
from tests.torch_cpu_threads import few_torch_threads  # noqa: F401 - autouse
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse


def _jax_model(dtype):
    model = JaxMnistCNN(dtype=dtype)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 28, 28, 1), jnp.float32))
    return model, params


def _torch_model(params, dtype):
    model = MnistCNN(dtype=dtype)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


def _images(n, seed):
    return np.random.RandomState(seed).rand(n, 28, 28, 1).astype(np.float32) * 2 - 1


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_logits_match_jax(dtype):
    jax_dtype, torch_dtype = ((jnp.float32, torch.float32) if dtype == 'f32'
                              else (jnp.bfloat16, torch.bfloat16))
    jax_model, params = _jax_model(jax_dtype)
    model = _torch_model(params, torch_dtype)
    x = _images(8, seed=1)
    want = np.asarray(jax_model.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    tol = 1e-5 if dtype == 'f32' else 1e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def _sgd_steps(batches, torch_batches=None, lr=0.05):
    """SGD steps of both models from the same weights: the JAX model on
    ``batches``, the port's on ``torch_batches`` (default: the same)."""
    jax_model, params = _jax_model(jnp.float32)
    model = _torch_model(params, torch.float32)
    optimizer = optax.sgd(lr)
    opt_state = optimizer.init(params)
    step = jax.jit(jax_train_step(jax_model, optimizer))
    torch_step = mnist_train_step(model, torch.optim.SGD(model.parameters(), lr=lr))
    losses = []
    for (images, labels), (t_images, t_labels) in zip(batches, torch_batches or batches):
        params, opt_state, jax_loss = step(params, opt_state, jnp.asarray(images),
                                           jnp.asarray(labels))
        torch_loss = torch_step(torch.from_numpy(np.asarray(t_images)),
                                torch.from_numpy(np.asarray(t_labels)).long())
        losses.append((float(jax_loss), float(torch_loss)))
    return params, model, losses


def _assert_params_match(params, model):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    got = model.state_dict()
    assert sorted(want) == sorted(got)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_three_sgd_steps_match_jax():
    rng = np.random.RandomState(3)
    batches = [(_images(16, seed=10 + i), rng.randint(0, 10, 16)) for i in range(3)]
    params, model, losses = _sgd_steps(batches)
    for jax_loss, torch_loss in losses:
        np.testing.assert_allclose(torch_loss, jax_loss, rtol=1e-5)
    _assert_params_match(params, model)


def test_loss_and_init_are_well_formed():
    model = init_mnist(seed=0, device='cpu', dtype=torch.float32)
    again = init_mnist(seed=0, device='cpu', dtype=torch.float32)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    loss = mnist_loss(model, torch.from_numpy(_images(4, seed=0)), torch.tensor([0, 1, 2, 3]))
    assert loss.shape == () and torch.isfinite(loss)


@pytest.fixture(scope='module')
def mnist_datasets(tmp_path_factory):
    """The same 512 synthetic MNIST rows written by the JAX example and by
    the port's copy of it."""
    from examples.mnist.jax_example import generate_synthetic_mnist as jax_generate
    from petastorm_tpu_torch.examples.mnist import generate_synthetic_mnist
    root = tmp_path_factory.mktemp('mnist')
    jax_url, torch_url = 'file://%s/jax' % root, 'file://%s/torch' % root
    jax_generate(jax_url, num_rows=512)
    generate_synthetic_mnist(torch_url, num_rows=512)
    return jax_url, torch_url


def test_port_mnist_writer_matches_jax_example(mnist_datasets):
    jax_url, torch_url = (u[len('file://'):] for u in mnist_datasets)
    a = pq.read_table('%s/part-00000.parquet' % jax_url)
    b = pq.read_table('%s/part-00000.parquet' % torch_url)
    assert a.equals(b)


@pytest.mark.parametrize('written_by', ['jax', 'torch'])
def test_slice_end_to_end_matches_jax(mnist_datasets, written_by):
    """Parquet → loader → normalize → 3 SGD steps, JAX (normalize in
    Pallas interpret mode) against the port, on the same dataset and seed."""
    from petastorm_tpu.jax import make_jax_loader
    from petastorm_tpu.ops import normalize_images as jax_normalize
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.examples.mnist import MNIST_MEAN, MNIST_STD
    from petastorm_tpu_torch.ops.normalize import normalize_images

    url = mnist_datasets[0 if written_by == 'jax' else 1]
    kw = dict(batch_size=32, fields=['^digit$', '^image$'], shuffle_rows=True,
              seed=0, reader_pool_type='dummy')
    with make_jax_loader(url, **kw) as loader:
        jax_batches = [b for _, b in zip(range(3), loader)]
    with make_torch_loader(url, device='cpu', **kw) as loader:
        torch_batches = [b for _, b in zip(range(3), loader)]
    jax_inputs, torch_inputs = [], []
    for jb, tb in zip(jax_batches, torch_batches):
        np.testing.assert_array_equal(np.asarray(jb['image']), tb['image'].numpy())
        np.testing.assert_array_equal(np.asarray(jb['digit']), tb['digit'].numpy())
        want = jax_normalize(jb['image'][..., None], np.asarray(MNIST_MEAN, np.float32),
                             np.asarray(MNIST_STD, np.float32), out_dtype=jnp.float32,
                             interpret=True)
        got = normalize_images(tb['image'][..., None], MNIST_MEAN, MNIST_STD,
                               out_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        jax_inputs.append((np.asarray(want), np.asarray(jb['digit'])))
        torch_inputs.append((got.numpy(), tb['digit'].numpy()))
    params, model, losses = _sgd_steps(jax_inputs, torch_inputs)
    for jax_loss, torch_loss in losses:
        np.testing.assert_allclose(torch_loss, jax_loss, rtol=1e-5)
    _assert_params_match(params, model)
