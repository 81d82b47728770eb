"""petastorm_tpu_torch KV-cache decoding against the JAX package's, on the CPU.

Weights carry across with ``params_from_jax`` (f32); prompts are made with
numpy from a seed. The model is ``tests/test_generate.py``'s tiny config
(vocab 32, d_model 16, 2 layers, d_ff 32, 24 positions) and its rope,
GQA and MQA variants. Greedy tokens are compared exactly: both sides
compute in f32 and an argmax flips only on a near-tie. The JAX decode
costs seconds a call here, so it runs four times in this file and the
JAX recompute oracle (it re-traces every length) not at all; the port's
decode is held against the port's own recompute oracle.

Sampling draws from a ``torch.Generator`` where the JAX package draws
from a PRNG key, so sampled tokens are compared by rule, not value: the
tokens that top-k and top-p keep on crafted logits equal the support of
4,096 JAX ``_select`` draws, and the port's draws stay inside it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from petastorm_tpu.models import generate as jg
from petastorm_tpu.models import transformer as jt
from petastorm_tpu_torch.models import generate as tg
from petastorm_tpu_torch.models import transformer as tt
from tests.torch_cpu_threads import few_torch_threads  # noqa: F401 - autouse
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

BASE = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_seq_len=24)

CONFIGS = {
    'learned': {},
    'rope-gqa': dict(n_heads=4, n_kv_heads=2, pos_encoding='rope'),
    'mqa': dict(n_heads=4, n_kv_heads=1),
    'rope': dict(pos_encoding='rope'),
    'gqa': dict(n_heads=4, n_kv_heads=2),
}


def _setup(seed=0, **kw):
    cfg = dict(BASE, **kw)
    jax_config = jt.TransformerConfig(dtype=jnp.float32, **cfg)
    params = jt.init_transformer_params(jax.random.PRNGKey(seed), jax_config)
    model = tt.Transformer(tt.TransformerConfig(dtype=torch.float32, **cfg))
    model.load_state_dict(tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jax_config, params, model


def _prompt(b, p, seed, vocab=32):
    return np.random.RandomState(seed).randint(0, vocab, (b, p)).astype(np.int32)


@pytest.fixture(scope='module')
def learned():
    return _setup()


@pytest.mark.parametrize('case', ['learned', 'rope-gqa', 'mqa'])
def test_greedy_matches_jax(case):
    jax_config, params, model = _setup(**CONFIGS[case])
    prompt = _prompt(3, 5, seed=1)
    want = np.asarray(jg.greedy_generate(params, jnp.asarray(prompt), jax_config, 8))
    got = tg.greedy_generate(model, torch.from_numpy(prompt), 8)
    assert got.dtype == torch.int32 and got.shape == (3, 13)
    np.testing.assert_array_equal(got.numpy(), want)


def test_eos_stop_matches_jax(learned):
    jax_config, params, model = learned
    prompt = _prompt(2, 5, seed=7)
    free = tg.greedy_generate(model, torch.from_numpy(prompt), 8).numpy()
    # an EOS that row 0 emits and row 1 never does: pins the freeze and
    # the rows' independence
    eos = next(int(t) for t in free[0, 5:] if t not in free[1, 5:].tolist())
    stopped = tg.greedy_generate(model, torch.from_numpy(prompt), 8, eos_token=eos).numpy()
    want = np.asarray(jg.greedy_generate(params, jnp.asarray(prompt), jax_config, 8,
                                         eos_token=eos))
    np.testing.assert_array_equal(stopped, want)
    row = stopped[0, 5:]
    hit = int(np.argmax(row == eos))
    assert (row[hit:] == eos).all()
    np.testing.assert_array_equal(row[:hit], free[0, 5:5 + hit])
    np.testing.assert_array_equal(stopped[1], free[1])


@pytest.mark.parametrize('case', list(CONFIGS))
@pytest.mark.parametrize('new_tokens', [1, 8])
def test_greedy_matches_recompute_oracle_exactly(case, new_tokens):
    _, _, model = _setup(**CONFIGS[case])
    prompt = torch.from_numpy(_prompt(2, 6, seed=3))
    got = tg.greedy_generate(model, prompt, new_tokens)
    want = tg.reference_greedy_generate(model, prompt, new_tokens)
    assert got.shape == (2, 6 + new_tokens)
    assert torch.equal(got, want)


def test_greedy_is_an_ordinary_tensor_on_the_models_device(learned):
    _, _, model = learned
    got = tg.greedy_generate(model, _prompt(1, 3, seed=0), 2)   # a numpy prompt
    assert not got.is_inference() and got.device == model.embed.device
    assert torch.equal(got[:, :3], torch.from_numpy(_prompt(1, 3, seed=0)))


@pytest.mark.parametrize('kv_heads', [2, 1])
def test_gqa_cache_is_kv_heads_wide(monkeypatch, kv_heads):
    _, params, model = _setup(n_heads=4, n_kv_heads=kv_heads)
    assert params['blocks'][0]['qkv'].shape == (16, (4 + 2 * kv_heads) * 4)
    allocated, read = [], []
    attend = tg._attend

    def recording_attend(q, keys, values, *args):
        read.append((q.shape[2], keys.shape[2], values.shape[2]))
        return attend(q, keys, values, *args)

    monkeypatch.setattr(tg, '_attend', recording_attend)
    tg._generate(model, torch.from_numpy(_prompt(2, 4, seed=0)), 5, None,
                 on_cache=lambda k, v: allocated.extend((tuple(k.shape), tuple(v.shape))))
    # (layers, B, max_seq_len, KV, Dh), K then V
    assert allocated == [(2, 2, 24, kv_heads, 4)] * 2
    assert len(read) == 2 * 5 and set(read) == {(4, kv_heads, kv_heads)}


def _sample(model, prompt, n, seed, **kw):
    return tg.sample_generate(model, torch.from_numpy(prompt), n,
                              torch.Generator().manual_seed(seed), **kw)


def test_top_k_one_and_tiny_top_p_equal_greedy(learned):
    _, _, model = learned
    prompt = _prompt(2, 4, seed=4)
    greedy = tg.greedy_generate(model, torch.from_numpy(prompt), 6)
    assert torch.equal(_sample(model, prompt, 6, 0, temperature=0.5, top_k=1), greedy)
    assert torch.equal(_sample(model, prompt, 6, 0, temperature=1.0, top_p=1e-6), greedy)


def test_top_k_beyond_vocab_and_full_top_p_are_plain_sampling(learned):
    _, _, model = learned
    prompt = _prompt(1, 4, seed=6)
    full = _sample(model, prompt, 4, 0, temperature=1.0)
    assert torch.equal(_sample(model, prompt, 4, 0, temperature=1.0, top_k=1000), full)
    assert torch.equal(_sample(model, prompt, 4, 0, temperature=1.0, top_k=32), full)
    assert torch.equal(_sample(model, prompt, 4, 0, temperature=1.0, top_p=1.0), full)


def test_sampling_is_seeded_and_in_vocab(learned):
    _, _, model = learned
    prompt = _prompt(2, 4, seed=5)
    a = _sample(model, prompt, 8, 1, temperature=1.5)
    assert torch.equal(a, _sample(model, prompt, 8, 1, temperature=1.5))
    assert a.shape == (2, 12) and ((a >= 0) & (a < 32)).all()
    assert not torch.equal(_sample(model, prompt, 8, 2, temperature=1.5), a), \
        'different seeds should (overwhelmingly) differ at T=1.5'


def test_sampled_eos_freezes_rows(learned):
    _, _, model = learned
    prompt = _prompt(4, 3, seed=2)
    out = _sample(model, prompt, 12, 3, temperature=2.0, eos_token=5)[:, 3:].numpy()
    for row in out:
        if (row == 5).any():
            assert (row[int(np.argmax(row == 5)):] == 5).all()


def test_decode_reports_its_logits(learned):
    _, _, model = learned
    prompt = torch.from_numpy(_prompt(2, 5, seed=8))
    logits = []
    out = tg._generate(model, prompt, 6, None, on_logits=logits.append)
    assert len(logits) == 6 and all(l.shape == (2, 32) and l.dtype == torch.float32
                                    for l in logits)
    assert torch.equal(torch.stack([l.argmax(-1) for l in logits], 1).to(out.dtype), out[:, 5:])
    with torch.no_grad():
        forward = tt.transformer_forward(model, out[:, :-1])[:, 4:]
    np.testing.assert_allclose(torch.stack(logits, 1).numpy(), forward.numpy(),
                               atol=1e-5, rtol=1e-5)


# -- the rejections of tests/test_generate.py ---------------------------------------

def test_zero_new_tokens_rejected(learned):
    with pytest.raises(ValueError, match='max_new_tokens'):
        tg.greedy_generate(learned[2], torch.zeros((1, 4), dtype=torch.int32), 0)


def test_zero_temperature_rejected(learned):
    with pytest.raises(ValueError, match='temperature'):
        _sample(learned[2], np.zeros((1, 4), np.int32), 2, 0, temperature=0.0)


def test_overflow_rejected():
    _, _, model = _setup(max_seq_len=8)
    with pytest.raises(ValueError, match='exceeds'):
        tg.greedy_generate(model, torch.zeros((1, 5), dtype=torch.int32), 4)


@pytest.mark.parametrize('top_p', [1.5, -0.1])
def test_top_p_out_of_range_rejected(learned, top_p):
    with pytest.raises(ValueError, match='top_p'):
        _sample(learned[2], np.zeros((1, 4), np.int32), 2, 0, top_p=top_p)


def test_moe_and_seq_configs_rejected():
    model = tt.Transformer(tt.TransformerConfig(dtype=torch.float32, n_experts=4, **BASE))
    with pytest.raises(NotImplementedError, match='dense'):
        tg.greedy_generate(model, torch.zeros((1, 4), dtype=torch.int32), 2)
    with pytest.raises(NotImplementedError, match='dense'):
        _sample(model, np.zeros((1, 4), np.int32), 2, 0)
    # a sequence-split config, dense or MoE, decodes in neither package
    seq = tt.Transformer(tt.TransformerConfig(dtype=torch.float32, seq_axis='seq', **BASE))
    with pytest.raises(NotImplementedError, match='dense'):
        tg.greedy_generate(seq, torch.zeros((1, 4), dtype=torch.int32), 2)
    seq_moe = tt.Transformer(tt.TransformerConfig(dtype=torch.float32, seq_axis='seq',
                                                  n_experts=4, **BASE))
    with pytest.raises(NotImplementedError, match='dense'):
        tg.greedy_generate(seq_moe, torch.zeros((1, 4), dtype=torch.int32), 2)


# -- top-k and top-p: the kept set against JAX's _select ----------------------------

LOGITS = np.array([
    [3.0, 2.6, 2.2, 1.5, 1.0, 0.4, -0.5, -1.0, -2.0, -3.0, 0.0, 0.7],
    [0.1, -1.0, 4.0, 3.9, 3.3, 0.0, 2.2, -2.0, 1.1, 0.5, -0.3, 2.8],
], np.float32)
DRAWS = 4096


@pytest.mark.parametrize('temperature,top_k,top_p', [
    (1.0, 3, 0.0), (1.0, 5, 0.0), (1.0, 0, 0.7), (0.7, 0, 0.8), (1.3, 4, 0.6),
])
def test_kept_tokens_equal_jax_select_support(temperature, top_k, top_p):
    keys = jax.random.split(jax.random.PRNGKey(0), DRAWS)
    draws = np.asarray(jax.vmap(lambda key: jg._select(
        jnp.asarray(LOGITS), key, temperature, top_k, top_p))(keys))     # (DRAWS, B)
    want = [set(draws[:, row].tolist()) for row in range(len(LOGITS))]
    logits = torch.from_numpy(LOGITS).repeat(DRAWS, 1)
    got = tg._select(logits, torch.Generator().manual_seed(0), temperature, top_k, top_p)
    got = got.reshape(DRAWS, len(LOGITS)).numpy()
    for row in range(len(LOGITS)):
        assert set(got[:, row].tolist()) == want[row], row
    if top_k:
        assert all(len(s) <= top_k for s in want)
    assert all(int(np.argmax(LOGITS[row])) in want[row] for row in range(len(LOGITS)))


def test_models_exports_the_decoders():
    import petastorm_tpu_torch.models as models
    assert models.greedy_generate is tg.greedy_generate
    assert models.sample_generate is tg.sample_generate
