"""petastorm_tpu_torch transformer against the JAX package's on the CPU.

Weights carry across with ``params_from_jax``; tokens are made with numpy
from a seed. Sizes: vocab 64, d_model 32, 2 heads, 2 layers, d_ff 64,
16 to 33 positions. ``attn_impl='flash'`` runs the port's plain kernel
versions through the flash ``autograd.Function`` and JAX's dense
reference. Tolerances: f32 logits and losses ``atol 2e-5, rtol 2e-5``
(both sides compute in f32; sums run in another order); bf16 logits
``atol 5e-2`` (the frameworks round bf16 activations at different
places: torch rounds each bf16 matmul's output where JAX keeps f32);
f32 parameters after AdamW steps ``atol 1e-4``, a tenth of one step:
Adam moves each parameter by about the learning rate (1e-3) times
m/sqrt(v), so an element whose grads are near zero, where the two sides
agree only to ~1e-6 absolute, can differ by a visible part of a step
(5e-5 was seen on one element of 2048).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from petastorm_tpu.models import transformer as jt
from petastorm_tpu_torch.models import transformer as tt
from tests.torch_cpu_threads import few_torch_threads  # noqa: F401 - autouse

SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=40)

CASES = {
    'dense-learned-gelu': {},
    'flash-learned-gelu': dict(attn_impl='flash'),
    'dense-rope-swiglu': dict(pos_encoding='rope', ffn='swiglu'),
    'flash-rope-gelu': dict(attn_impl='flash', pos_encoding='rope'),
    'flash-gqa-swiglu': dict(attn_impl='flash', n_kv_heads=1, ffn='swiglu'),
    'dense-gqa-rope': dict(n_kv_heads=1, pos_encoding='rope'),
    'flash-remat': dict(attn_impl='flash', remat=True),
}


def _configs(dtype='f32', **kw):
    jax_dtype, torch_dtype = ((jnp.float32, torch.float32) if dtype == 'f32'
                              else (jnp.bfloat16, torch.bfloat16))
    return (jt.TransformerConfig(dtype=jax_dtype, **SMALL, **kw),
            tt.TransformerConfig(dtype=torch_dtype, **SMALL, **kw))


def _models(jax_config, torch_config, seed=0):
    params = jt.init_transformer_params(jax.random.PRNGKey(seed), jax_config)
    model = tt.Transformer(torch_config)
    model.load_state_dict(tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return params, model


def _tokens(b, s, seed, vocab=64):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize('case', list(CASES))
def test_logits_match_jax(case):
    jax_config, torch_config = _configs(**CASES[case])
    params, model = _models(jax_config, torch_config)
    tokens = _tokens(2, 21, seed=1)
    want = np.asarray(jt.transformer_forward(params, jnp.asarray(tokens), jax_config))
    with torch.no_grad():
        got = tt.transformer_forward(model, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, 21, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize('attn_impl', ['dense', 'flash'])
def test_bf16_logits_match_jax(attn_impl):
    jax_config, torch_config = _configs('bf16', attn_impl=attn_impl)
    params, model = _models(jax_config, torch_config)
    tokens = _tokens(2, 16, seed=2)
    want = np.asarray(jt.transformer_forward(params, jnp.asarray(tokens), jax_config))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2, rtol=0)


@pytest.mark.parametrize('case', ['dense-learned-gelu', 'flash-rope-gelu'])
def test_loss_and_grads_match_jax(case):
    jax_config, torch_config = _configs(**CASES[case])
    params, model = _models(jax_config, torch_config)
    tokens = _tokens(3, 18, seed=3)
    loss, grads = jax.value_and_grad(jt.transformer_loss)(params, jnp.asarray(tokens),
                                                          jax_config)
    got = tt.transformer_loss(model, torch.from_numpy(tokens))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), atol=2e-5, rtol=2e-5)
    want = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize('chunk', [5, 16, 64])
def test_loss_chunk_matches_unchunked_and_jax(chunk):
    jax_config, torch_config = _configs(attn_impl='flash', loss_chunk=chunk)
    params, model = _models(jax_config, torch_config)
    unchunked = tt.Transformer(dataclasses.replace(torch_config, loss_chunk=0))
    unchunked.load_state_dict(model.state_dict())
    tokens = _tokens(2, 17, seed=4)
    want = float(jt.transformer_loss(params, jnp.asarray(tokens), jax_config))
    got = tt.transformer_loss(model, torch.from_numpy(tokens))
    full = tt.transformer_loss(unchunked, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.item(), full.item(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got.item(), want, atol=2e-5, rtol=2e-5)
    got.backward()
    full.backward()
    for (name, a), b in zip(model.named_parameters(), unchunked.parameters()):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=1e-5, msg=name)


def _assert_params_match(params, model, atol):
    want = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    got = model.state_dict()
    assert sorted(want) == sorted(got)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=atol,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize('case', ['dense-learned-gelu', 'flash-gqa-swiglu'])
def test_three_adamw_steps_match_optax(case):
    jax_config, torch_config = _configs(loss_chunk=8, **CASES[case])
    params, model = _models(jax_config, torch_config)
    optimizer = optax.adamw(1e-3)
    opt_state = optimizer.init(params)
    jax_step = jt.transformer_train_step(jax_config, optimizer)
    step = tt.transformer_train_step(model, tt.adamw(model))
    for i in range(3):
        tokens = _tokens(2, 17, seed=10 + i)
        params, opt_state, jax_loss = jax_step(params, opt_state, jnp.asarray(tokens))
        loss = step(torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss), float(jax_loss), atol=2e-5, rtol=2e-5)
    _assert_params_match(params, model, atol=1e-4)


def test_accum_steps_matches_one_full_batch_step():
    _, torch_config = _configs(attn_impl='flash')
    full = tt.init_transformer(0, torch_config, 'cpu')
    accum = tt.init_transformer(0, torch_config, 'cpu')
    tokens = torch.from_numpy(_tokens(4, 17, seed=6))
    loss_full = tt.transformer_train_step(full, tt.adamw(full))(tokens)
    loss_accum = tt.transformer_train_step(accum, tt.adamw(accum), accum_steps=2)(tokens)
    torch.testing.assert_close(loss_accum, loss_full, atol=1e-6, rtol=1e-6)
    for (name, a), b in zip(full.named_parameters(), accum.parameters()):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0, msg=name)
    with pytest.raises(ValueError, match='divisible'):
        tt.transformer_train_step(full, tt.adamw(full), accum_steps=3)(tokens)
    with pytest.raises(ValueError):
        tt.transformer_train_step(full, tt.adamw(full), accum_steps=0)


def test_parameter_tree_matches_jax():
    for kw in ({}, dict(pos_encoding='rope', ffn='swiglu', n_kv_heads=1)):
        jax_config, torch_config = _configs(**kw)
        params = jt.init_transformer_params(jax.random.PRNGKey(0), jax_config)
        want = {k: tuple(v.shape) for k, v in tt.params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)).items()}
        model = tt.init_transformer(0, torch_config, 'cpu')
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


def test_init_is_seeded_and_scaled():
    _, torch_config = _configs()
    a = tt.init_transformer(3, torch_config, 'cpu')
    b = tt.init_transformer(3, torch_config, 'cpu')
    c = tt.init_transformer(4, torch_config, 'cpu')
    for (name, x), y, z in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(x, y), name
        if name.endswith(('ln1', 'ln2', 'ln_f')):
            assert torch.equal(x, torch.ones_like(x))
        else:
            assert not torch.equal(x, z), name
    assert abs(a.embed.detach().std().item() - 0.02) < 0.005
    assert abs(a.blocks[0].mlp_out.detach().std().item() - 64 ** -0.5) < 0.03


@pytest.mark.parametrize('kw,error', [
    (dict(attn_impl='ring'), ValueError),
    (dict(seq_impl='bad'), ValueError),
    (dict(n_kv_heads=3), ValueError),
    (dict(pos_encoding='alibi'), ValueError),
    (dict(ffn='relu'), ValueError),
    (dict(n_experts=4, ffn='swiglu'), ValueError),
    (dict(n_experts=4), NotImplementedError),
    (dict(seq_axis='seq'), NotImplementedError),
])
def test_config_checks_match_jax(kw, error):
    with pytest.raises(error):
        tt.TransformerConfig(**SMALL, **kw)
    if error is ValueError:
        with pytest.raises(ValueError):
            jt.TransformerConfig(**SMALL, **kw)


def test_rope_and_rmsnorm_helpers_match_jax():
    rng = np.random.RandomState(7)
    t = rng.randn(2, 9, 3, 8).astype(np.float32)
    pos = np.arange(9)
    want = np.asarray(jt._rope_rotate(jnp.asarray(t), jnp.asarray(pos), 10000.0))
    got = tt._rope_rotate(torch.from_numpy(t), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    x, gain = rng.randn(3, 5, 8).astype(np.float32), rng.rand(8).astype(np.float32)
    want = np.asarray(jt._rmsnorm(jnp.asarray(x), jnp.asarray(gain)))
    got = tt._rmsnorm(torch.from_numpy(x), torch.from_numpy(gain))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    kv = rng.randn(2, 4, 2, 8).astype(np.float32)
    np.testing.assert_array_equal(
        tt._expand_kv_heads(torch.from_numpy(kv), 6).numpy(),
        np.asarray(jt._expand_kv_heads(jnp.asarray(kv), 6)))


def test_default_device_is_the_card():
    _, torch_config = _configs()
    if torch.cuda.is_available():
        assert next(tt.init_transformer(0, torch_config).parameters()).is_cuda
        return
    with pytest.raises((RuntimeError, AssertionError)):
        tt.init_transformer(0, torch_config)


# -- the masked loss over padded / bucketed batches ------------------------------
# Tolerances as above: f32 losses atol/rtol 2e-5, f32 grads atol 1e-5 rtol 1e-4.

def _padded(b, s, lengths, seed, pad_value=0):
    """Right-padded ``(b, s)`` token rows: row ``i`` is real up to
    ``min(lengths[i], s)`` and ``pad_value`` after."""
    tokens = _tokens(b, s, seed)
    real = np.arange(s)[None, :] < np.minimum(lengths, s)[:, None]
    return np.where(real, tokens, pad_value).astype(np.int32), np.asarray(lengths, np.int32)


MASKED_CASES = {
    'dense': dict(),
    'flash': dict(attn_impl='flash'),
    'dense-chunked': dict(loss_chunk=5),
    'flash-chunked': dict(attn_impl='flash', loss_chunk=7),
    'flash-rope-chunked-64': dict(attn_impl='flash', pos_encoding='rope', loss_chunk=64),
}


@pytest.mark.parametrize('case', sorted(MASKED_CASES))
def test_masked_loss_and_grads_match_jax(case):
    jax_config, torch_config = _configs(**MASKED_CASES[case])
    params, model = _models(jax_config, torch_config)
    # a full row, short rows, a 1-token row (no target), an empty row and a
    # truncated row whose length exceeds S
    tokens, lengths = _padded(6, 17, [17, 5, 11, 1, 0, 40], seed=21)
    loss, grads = jax.value_and_grad(jt.transformer_masked_loss)(
        params, jnp.asarray(tokens), jnp.asarray(lengths), jax_config)
    got = tt.transformer_masked_loss(model, torch.from_numpy(tokens), torch.from_numpy(lengths))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), atol=2e-5, rtol=2e-5)
    want = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize('chunk', [0, 6])
def test_masked_loss_ignores_pad_values(chunk):
    _, torch_config = _configs(attn_impl='flash', loss_chunk=chunk)
    model = tt.init_transformer(0, torch_config, 'cpu')
    losses = []
    for pad_value in (0, 7, 63):
        tokens, lengths = _padded(4, 19, [19, 3, 12, 8], seed=22, pad_value=pad_value)
        losses.append(tt.transformer_masked_loss(model, torch.from_numpy(tokens),
                                                 torch.from_numpy(lengths)).item())
    np.testing.assert_allclose(losses, losses[0], atol=1e-6, rtol=0)


def test_masked_loss_of_full_rows_is_the_loss_and_lengths_saturate():
    _, torch_config = _configs(attn_impl='flash')
    model = tt.init_transformer(0, torch_config, 'cpu')
    tokens = torch.from_numpy(_tokens(3, 16, seed=23))
    want = tt.transformer_loss(model, tokens).item()
    for length in (16, 17, 1000):
        got = tt.transformer_masked_loss(model, tokens, torch.full((3,), length)).item()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # no real target in the batch: 0, not a division by zero
    empty = tt.transformer_masked_loss(model, tokens, torch.tensor([0, 1, 1]))
    assert empty.item() == 0.0


def test_masked_train_steps_match_optax():
    jax_config, torch_config = _configs(attn_impl='flash', loss_chunk=8)
    params, model = _models(jax_config, torch_config)
    optimizer = optax.adamw(1e-3)
    opt_state = optimizer.init(params)
    jax_step = jt.transformer_masked_train_step(jax_config, optimizer)
    step = tt.transformer_masked_train_step(model, tt.adamw(model))
    # bucket widths change from step to step
    for i, (s, lengths) in enumerate([(9, [9, 4, 2]), (17, [17, 13, 10]), (9, [5, 9, 7])]):
        tokens, lengths = _padded(3, s, lengths, seed=30 + i)
        params, opt_state, jax_loss = jax_step(params, opt_state, jnp.asarray(tokens),
                                               jnp.asarray(lengths))
        loss = step(torch.from_numpy(tokens), torch.from_numpy(lengths))
        np.testing.assert_allclose(float(loss), float(jax_loss), atol=2e-5, rtol=2e-5)
    _assert_params_match(params, model, atol=1e-4)
