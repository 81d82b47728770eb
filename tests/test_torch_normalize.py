"""petastorm_tpu_torch normalize op against the JAX package's on the CPU.

The port's plain version is held against the JAX ``normalize_images`` in
Pallas interpret mode and on its jnp fallback, on the same uint8 inputs
made with numpy. Tolerances: f32 ``atol 1e-5``; bf16 at most one bf16 ulp
(the two sides may round the f32 intermediate at different places, which
can flip a tie).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from petastorm_tpu.ops import normalize_images as jax_normalize
from petastorm_tpu_torch.ops import normalize as torch_normalize

MEAN_STD = {
    1: ([0.1307], [0.3081]),
    3: ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
}


def _bf16_ulps(a_bits, b_bits):
    """Largest ulp distance between two arrays of bf16 bit patterns."""
    def ordered(bits):
        i = bits.astype(np.int32)
        i = np.where(i >= 0x8000, i - 0x10000, i)
        return np.where(i < 0, -32768 - i, i)
    return int(np.abs(ordered(a_bits) - ordered(b_bits)).max())


def _inputs(c, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (3, 6, 10, c), dtype=np.uint8)


@pytest.mark.parametrize('interpret', [True, False], ids=['pallas-interpret', 'jnp-fallback'])
@pytest.mark.parametrize('out', ['f32', 'bf16'])
@pytest.mark.parametrize('c', [1, 3])
def test_plain_version_matches_jax(c, out, interpret):
    x = _inputs(c, seed=c)
    mean, std = MEAN_STD[c]
    jax_dtype = jnp.float32 if out == 'f32' else jnp.bfloat16
    torch_dtype = torch.float32 if out == 'f32' else torch.bfloat16
    want = np.asarray(jax_normalize(jnp.asarray(x), np.asarray(mean, np.float32),
                                    np.asarray(std, np.float32),
                                    out_dtype=jax_dtype, interpret=interpret))
    got = torch_normalize.normalize_images_reference(torch.from_numpy(x), mean, std,
                                                     out_dtype=torch_dtype)
    assert got.shape == x.shape and got.dtype == torch_dtype
    if out == 'f32':
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    else:
        got_bits = got.view(torch.int16).numpy().view(np.uint16)
        assert _bf16_ulps(got_bits, want.view(np.uint16)) <= 1


def test_wrapper_on_cpu_tensor_runs_plain_version_and_counts_nothing():
    x = torch.from_numpy(_inputs(3, seed=7))
    mean, std = MEAN_STD[3]
    before = torch_normalize.launches
    got = torch_normalize.normalize_images(x, mean, std, out_dtype=torch.float32)
    want = torch_normalize.normalize_images_reference(x, mean, std, out_dtype=torch.float32)
    assert torch.equal(got, want)
    assert torch_normalize.launches == before


def test_affine_matches_jax_precompute():
    mean, std = MEAN_STD[3]
    scale, bias = torch_normalize._affine(mean, std)
    std32 = jnp.asarray(std, jnp.float32)
    np.testing.assert_array_equal(scale.numpy(),
                                  np.asarray((1.0 / (255.0 * std32)).astype(jnp.float32)))
    np.testing.assert_array_equal(
        bias.numpy(), np.asarray((-jnp.asarray(mean, jnp.float32) / std32)))


@pytest.mark.parametrize('bad', ['dtype', 'rank', 'out_dtype', 'channels'])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros((2, 4, 4, 3), dtype=torch.uint8)
    mean, std = MEAN_STD[3]
    out_dtype = torch.bfloat16
    if bad == 'dtype':
        x = x.float()
    elif bad == 'rank':
        x = x[0]
    elif bad == 'out_dtype':
        out_dtype = torch.float16
    else:
        mean, std = MEAN_STD[1]
    with pytest.raises((TypeError, ValueError)):
        torch_normalize.normalize_images(x, mean, std, out_dtype=out_dtype)


def test_default_loader_device_is_the_card():
    """Without CUDA, a loader built with no device= raises rather than
    running on the CPU."""
    from petastorm_tpu_torch.device.loader import make_torch_loader, resolve_device
    if torch.cuda.is_available():
        assert resolve_device(None).type == 'cuda'
        return
    with pytest.raises(RuntimeError, match='CUDA'):
        make_torch_loader('file:///nonexistent/dataset', batch_size=4)
    assert resolve_device('cpu').type == 'cpu'


@pytest.mark.cuda
@pytest.mark.parametrize('out', [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version_on_the_card(out):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the normalize kernel has no CPU mode')
    x = torch.from_numpy(_inputs(3, seed=11)).cuda()
    mean, std = MEAN_STD[3]
    before = torch_normalize.launches
    got = torch_normalize.normalize_images(x, mean, std, out_dtype=out)
    want = torch_normalize.normalize_images_reference(x, mean, std, out_dtype=out)
    torch.cuda.synchronize()
    assert torch_normalize.launches == before + 1
    if out == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        got_bits = got.cpu().view(torch.int16).numpy().view(np.uint16)
        want_bits = want.cpu().view(torch.int16).numpy().view(np.uint16)
        assert _bf16_ulps(got_bits, want_bits) <= 1
