"""``examples/variable_length.py`` against the JAX package's
``examples/lm/variable_length_example.py`` on the CPU.

Both run at a small width (d_model 32, 4 heads, 1 layer, vocab 256) on the
same C4-like documents, bucketed at (64, 128, 256, 512), from the same
weights: the port's model loads the JAX example's seed-0 parameters through
``params_from_jax``. Both readers run on the dummy pool, so the batches
come in the same order. The JAX example is run as it is; the test only
points its loader at the dummy pool and records each step's loss.

Tolerance: per-step losses within ``5e-3`` absolute (0.1% of a loss near
5.5; 1.1e-3 was seen). Both models compute in bf16 (the JAX example's
dtype) and round activations at different places (see
``test_torch_transformer.py``), and AdamW at the example's learning rate
of 1e-2 carries those differences into the next step's weights.
"""

import functools

import numpy as np
import pytest

import jax

import petastorm_tpu.jax as jax_loader_module
from examples.lm import variable_length_example as jax_example
from petastorm_tpu.models import transformer as jt
from petastorm_tpu_torch.examples import variable_length
from petastorm_tpu_torch.examples.lm_pretrain import generate_c4_like
from petastorm_tpu_torch.models import transformer as tt
from tests.torch_cpu_threads import few_torch_threads  # noqa: F401 - autouse
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

D_MODEL, N_LAYERS, STEPS, BATCH = 32, 1, 8, 8


@pytest.fixture(scope='module')
def documents(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('docs')) + '/c4'
    return generate_c4_like(url, num_docs=192, vocab_size=256, seed=0)


def _run_jax(url, monkeypatch):
    losses = []
    make_step = jt.transformer_masked_train_step

    def recording_step(config, optimizer, mesh=None):
        step = make_step(config, optimizer, mesh)

        def run(params, opt_state, tokens, lengths):
            out = step(params, opt_state, tokens, lengths)
            losses.append(float(out[2]))
            return out
        return run

    monkeypatch.setattr(jt, 'transformer_masked_train_step', recording_step)
    monkeypatch.setattr(jax_loader_module, 'make_jax_loader', functools.partial(
        jax_loader_module.make_jax_loader, reader_pool_type='dummy'))
    final, buckets = jax_example.train_variable_length(
        url, batch_size=BATCH, steps=STEPS, d_model=D_MODEL, n_layers=N_LAYERS,
        log=lambda line: None)
    monkeypatch.undo()
    assert losses[-1] == final
    return losses, buckets


def _jax_weights(config):
    jax_config = jt.TransformerConfig(
        vocab_size=config.vocab_size, d_model=config.d_model, n_heads=config.n_heads,
        n_layers=config.n_layers, d_ff=config.d_ff, max_seq_len=config.max_seq_len)
    params = jt.init_transformer_params(jax.random.PRNGKey(0), jax_config)
    return tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params))


def _run_torch(url, monkeypatch, attn_impl, loss_chunk):
    def init_from_jax(seed, config, device=None):
        assert seed == 0
        model = tt.Transformer(config)
        model.load_state_dict(_jax_weights(config))
        return model.to(device)

    monkeypatch.setattr(tt, 'init_transformer', init_from_jax)
    result = variable_length.train_variable_length(
        url, batch_size=BATCH, steps=STEPS, device='cpu', attn_impl=attn_impl,
        loss_chunk=loss_chunk, reader_pool_type='dummy',
        model_kw=dict(vocab_size=256, d_model=D_MODEL, n_heads=4, n_layers=N_LAYERS,
                      d_ff=4 * D_MODEL))
    monkeypatch.undo()
    return result


@pytest.mark.parametrize('attn_impl,loss_chunk', [('dense', 0), ('flash', 64)],
                         ids=['dense', 'flash-chunked'])
def test_losses_match_the_jax_example(documents, monkeypatch, attn_impl, loss_chunk):
    want, want_buckets = _run_jax(documents, monkeypatch)
    got = _run_torch(documents, monkeypatch, attn_impl, loss_chunk)
    assert got['bucket_steps'] == want_buckets
    assert len(got['losses']) == STEPS
    np.testing.assert_allclose(got['losses'], want, atol=5e-3, rtol=0)
    assert got['losses'][-1] < got['losses'][0]


def test_result_counts_buckets_and_targets(documents):
    result = variable_length.train_variable_length(
        documents, batch_size=BATCH, steps=6, device='cpu', reader_pool_type='dummy',
        shuffle_row_groups=False, model_kw=dict(vocab_size=256, d_model=16, n_heads=2,
                                                n_layers=1, d_ff=32))
    assert result['batch_devices'] == ['cpu']
    assert set(result['widths']) <= set(variable_length.BOUNDARIES)
    assert all(m <= w for m, w in zip(result['max_lens'], result['widths']))
    assert sum(result['bucket_steps'].values()) == 6
    assert 0 < result['target_tokens_per_s'] < result['padded_positions_per_s']
    assert 'step_ms_by_bucket' not in result
    assert all(np.isfinite(result['losses']))
