"""petastorm_tpu_torch flash attention against the JAX package's on the CPU.

On a CPU tensor the port's ``flash_attention_fused`` runs the plain
versions of its three kernels through the same ``autograd.Function`` the
card uses; the JAX ``flash_attention_fused`` takes its dense reference
off-TPU (and the Pallas kernel in interpret mode in the ``slow`` test).
Inputs are made with numpy from a seed and handed to both.

Tolerances: f32 outputs and q/k/v grads ``atol 1e-5, rtol 1e-5`` (both
sides compute in f32; the port's lse formulation sums in another order);
bf16 outputs ``atol 1e-2, rtol 1e-2`` (both round an f32 result to bf16,
and a 1-ulp flip at |O| < 2 is under 8e-3) and bf16 grads within 2e-2 of
their max-abs (the two frameworks round the backward's bf16 operands at
different places); the interpret-mode Pallas kernel as the JAX package's
own test, ``2e-5`` on O and ``5e-4`` on the grads.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from petastorm_tpu.ops.flash_attention import flash_attention_fused as jax_flash
from petastorm_tpu.ops.ring_attention import reference_attention as jax_reference
from petastorm_tpu_torch.ops import flash_attention as fa
from petastorm_tpu_torch.ops.ring_attention import reference_attention


def _arrays(shape, seed, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _torch(a, dtype):
    return torch.tensor(a, dtype=dtype, requires_grad=True)


def _jax_value_and_grads(fn, q, k, v, w, dtype):
    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a, dtype) for a in (q, k, v)))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _torch_value_and_grads(fn, q, k, v, w, dtype):
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    out = fn(tq, tk, tv)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in (tq, tk, tv)]


def _assert_grads_close(got, want, dtype):
    for name, g, w in zip('qkv', got, want):
        if dtype == 'f32':
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg='d' + name)
        else:
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), 'd' + name


@pytest.mark.parametrize('s,d', [(33, 16), (20, 96)], ids=['s33-d16', 's20-d96'])
@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'bidir'])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_matches_jax_flash_attention_fused(dtype, causal, s, d):
    q, k, v, w = _arrays((2, s, 3, d), seed=s + d)
    jax_dtype, torch_dtype = ((jnp.float32, torch.float32) if dtype == 'f32'
                              else (jnp.bfloat16, torch.bfloat16))
    want, want_grads = _jax_value_and_grads(
        lambda q, k, v: jax_flash(q, k, v, causal=causal), q, k, v, w, jax_dtype)
    got, got_grads = _torch_value_and_grads(
        lambda q, k, v: fa.flash_attention_fused(q, k, v, causal=causal), q, k, v, w,
        torch_dtype)
    tol = 1e-5 if dtype == 'f32' else 1e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    _assert_grads_close(got_grads, want_grads, dtype)


@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'bidir'])
def test_reference_attention_matches_jax(causal):
    q, k, v = _arrays((2, 19, 2, 16), seed=5, n=3)
    want = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal))
    got = reference_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'bidir'])
def test_plain_kernel_versions_match_dense_autograd(causal):
    """Each kernel's plain version against autograd through the dense
    oracle: the forward's (o, lse), then dK/dV and dQ from that lse and
    Di = rowsum(dO∘O)."""
    q, k, v, do = (torch.from_numpy(a) for a in _arrays((2, 37, 2, 24), seed=9))
    scale = 0.3
    o, lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    want = reference_attention(tq, tk, tv, causal=causal, scale=scale)
    torch.testing.assert_close(o, want.detach(), atol=1e-6, rtol=1e-6)
    scores = torch.einsum('bqhd,bkhd->bhqk', q, k) * scale
    if causal:
        scores = scores.masked_fill(~torch.ones(37, 37, dtype=torch.bool).tril(),
                                    float('-inf'))
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1), atol=1e-6, rtol=1e-6)
    dq_want, dk_want, dv_want = torch.autograd.grad(want, (tq, tk, tv), do)
    di = fa.attention_delta(o, do)
    dk, dv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, di, causal, scale)
    dq = fa.flash_bwd_dq_reference(q, k, v, do, lse, di, causal, scale)
    for got, w in ((dq, dq_want), (dk, dk_want), (dv, dv_want)):
        torch.testing.assert_close(got, w, atol=1e-5, rtol=1e-5)


def test_strided_heads_of_a_fused_projection():
    """q, k, v sliced out of one (B, S, 3·H·D) projection, as the
    transformer passes them, give what contiguous copies give."""
    qkv = torch.from_numpy(_arrays((2, 21, 3 * 2 * 16), seed=3, n=1)[0])
    q, k, v = (qkv[..., i * 32:(i + 1) * 32].reshape(2, 21, 2, 16) for i in range(3))
    assert not q.is_contiguous()
    got = fa.flash_attention_fused(q, k, v)
    want = fa.flash_attention_fused(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert [s for s in fa._strides(q)] == [21 * 96, 96, 16]


@pytest.mark.parametrize('d', [4, 12, 136])
def test_unsupported_head_dim_raises(d):
    q, k, v = (torch.zeros(1, 8, 2, d) for _ in range(3))
    with pytest.raises(ValueError, match='head dim'):
        fa.flash_attention_fused(q, k, v)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(TypeError):
        fa.flash_attention_fused(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        fa.flash_attention_fused(q, q[:, :4], q)
    with pytest.raises(ValueError, match='unit stride'):
        fa._strides(torch.zeros(1, 8, 16, 2).transpose(2, 3))


def test_cpu_tensors_run_the_plain_versions_and_count_nothing():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays((1, 16, 2, 16), seed=1))
    before = (fa.fwd_launches, fa.bwd_dkv_launches, fa.bwd_dq_launches)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_causal_attention(tq, tk, tv)
    out.backward(do)
    o, _ = fa.flash_fwd_reference(q, k, v, True, 0.25)
    assert torch.equal(out.detach(), o)
    assert (fa.fwd_launches, fa.bwd_dkv_launches, fa.bwd_dq_launches) == before
    assert all(t.grad is not None for t in (tq, tk, tv))


def test_kernel_supported_is_truthful():
    assert fa.kernel_supported(1023) == torch.cuda.is_available()
    assert not fa.kernel_supported(0)


@pytest.mark.slow
def test_plain_path_matches_pallas_kernel_in_interpret_mode():
    from jax.experimental.pallas import tpu as pltpu
    q, k, v, w = _arrays((1, 128, 2, 64), seed=0)
    with pltpu.force_tpu_interpret_mode():
        want, want_grads = _jax_value_and_grads(
            lambda q, k, v: jax_flash(q, k, v, causal=True, force_kernel=True), q, k, v, w,
            jnp.float32)
    got, got_grads = _torch_value_and_grads(fa.flash_causal_attention, q, k, v, w,
                                            torch.float32)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    for g, wg in zip(got_grads, want_grads):
        np.testing.assert_allclose(g, wg, atol=5e-4, rtol=5e-4)


# -- on the card -------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the flash kernels have no CPU mode')


@pytest.mark.cuda
@pytest.mark.parametrize('shape,causal', [((2, 130, 3, 64), True), ((1, 77, 2, 96), False),
                                          ((2, 256, 2, 128), True), ((3, 1, 1, 8), True)],
                         ids=['s130-d64', 's77-d96-bidir', 's256-d128', 's1-d8'])
def test_kernels_match_plain_versions_on_the_card(shape, causal):
    _need_cuda()
    q, k, v, do = (torch.from_numpy(a).cuda() for a in _arrays(shape, seed=shape[1]))
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, scale)
    di = fa.attention_delta(o_ref, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, di, causal, scale)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, di, causal, scale)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(q, k, v, do, lse_ref, di, causal, scale)
    dq_ref = fa.flash_bwd_dq_reference(q, k, v, do, lse_ref, di, causal, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, o_ref, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    for got, want in ((dk, dk_ref), (dv, dv_ref), (dq, dq_ref)):
        torch.testing.assert_close(got, want, atol=5e-4, rtol=5e-4)


@pytest.mark.cuda
def test_autograd_on_the_card_launches_each_kernel_once():
    _need_cuda()
    q, k, v, do = (torch.from_numpy(a).cuda().to(torch.bfloat16)
                   for a in _arrays((2, 100, 2, 96), seed=4))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    before = (fa.fwd_launches, fa.bwd_dkv_launches, fa.bwd_dq_launches)
    fa.flash_attention_fused(tq, tk, tv).backward(do)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.bwd_dkv_launches, fa.bwd_dq_launches) == tuple(
        n + 1 for n in before)
    want = reference_attention(*(t.float().requires_grad_() for t in (q, k, v)))
    assert torch.isfinite(tq.grad).all() and want.shape == tq.shape
