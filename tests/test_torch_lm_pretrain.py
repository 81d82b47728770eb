"""The LM pretraining slice as a whole, port against the JAX package, on
the CPU: the C4-like dataset both examples write, the packed token batches
both loaders give (dummy pool, no shuffle), and a few AdamW steps of both
trainers from the same weights on those batches.

Tolerances: the written Parquet tables and the token batches are equal
exactly; f32 losses ``atol 2e-5, rtol 2e-5`` (both sides compute in f32;
sums run in another order); f32 parameters after the steps ``atol 1e-4``
(see ``test_torch_transformer.py``: Adam's normalized step magnifies the
~1e-6 disagreement of near-zero grads).
"""

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from petastorm_tpu.models import transformer as jt
from petastorm_tpu_torch.examples import lm_pretrain
from petastorm_tpu_torch.models import transformer as tt
from tests.torch_cpu_threads import few_torch_threads  # noqa: F401 - autouse
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

SEQ = 17
MODEL_KW = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64)


@pytest.fixture(scope='module')
def c4_datasets(tmp_path_factory):
    """The same 256 documents written by the JAX example and by the port's
    copy of it."""
    from examples.lm.pretrain_example import generate_c4_like as jax_generate
    root = tmp_path_factory.mktemp('c4')
    jax_url, torch_url = 'file://%s/jax' % root, 'file://%s/torch' % root
    jax_generate(jax_url, num_docs=256, vocab_size=64, seed=0)
    lm_pretrain.generate_c4_like(torch_url, num_docs=256, vocab_size=64, seed=0)
    return jax_url, torch_url


def test_port_writer_matches_jax_example(c4_datasets):
    jax_path, torch_path = (u[len('file://'):] for u in c4_datasets)
    a = pq.read_table('%s/part-00000.parquet' % jax_path)
    b = pq.read_table('%s/part-00000.parquet' % torch_path)
    assert a.equals(b)
    assert pq.ParquetFile('%s/part-00000.parquet' % torch_path).num_row_groups == 4


def _batches(url, n):
    """``n`` packed token batches from each loader, in order."""
    from examples.lm.pretrain_example import packing_transform as jax_packing
    from petastorm_tpu.jax import make_jax_loader
    from petastorm_tpu_torch.device.loader import make_torch_loader
    kw = dict(batch_size=4, reader_pool_type='dummy', shuffle_row_groups=False)
    with make_jax_loader(url, transform_spec=jax_packing(SEQ), **kw) as loader:
        jax_batches = [np.asarray(b['tokens']) for _, b in zip(range(n), loader)]
    with make_torch_loader(url, device='cpu', transform_spec=lm_pretrain.packing_transform(SEQ),
                           **kw) as loader:
        torch_batches = [b['tokens'] for _, b in zip(range(n), loader)]
    return jax_batches, torch_batches


@pytest.mark.parametrize('written_by', ['jax', 'torch'])
def test_packed_batches_equal_the_jax_loaders(c4_datasets, written_by):
    url = c4_datasets[0 if written_by == 'jax' else 1]
    jax_batches, torch_batches = _batches(url, 12)
    assert len(jax_batches) == len(torch_batches) == 12
    for want, got in zip(jax_batches, torch_batches):
        assert got.dtype == torch.int32 and tuple(got.shape) == (4, SEQ)
        np.testing.assert_array_equal(got.numpy(), want)
    # packing keeps the EOS separators and never emits pad
    stream = np.concatenate([b.ravel() for b in jax_batches])
    assert (stream == lm_pretrain.EOS).any() and not (stream == 0).any()


def test_slice_end_to_end_matches_jax(c4_datasets):
    """Packed batches → 4 AdamW steps of the transformer (flash attention:
    the port's plain kernel versions, JAX's dense reference) from the
    same weights, chunked loss as in the flagship run."""
    jax_batches, torch_batches = _batches(c4_datasets[1], 4)
    jax_config = jt.TransformerConfig(max_seq_len=SEQ, attn_impl='flash', loss_chunk=8,
                                      dtype=jnp.float32, **MODEL_KW)
    config = tt.TransformerConfig(max_seq_len=SEQ, attn_impl='flash', loss_chunk=8,
                                  dtype=torch.float32, **MODEL_KW)
    params = jt.init_transformer_params(jax.random.PRNGKey(0), jax_config)
    model = tt.Transformer(config)
    model.load_state_dict(tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    optimizer = optax.adamw(1e-3)
    opt_state = optimizer.init(params)
    jax_step = jt.transformer_train_step(jax_config, optimizer)
    step = tt.transformer_train_step(model, tt.adamw(model))
    for want_tokens, tokens in zip(jax_batches, torch_batches):
        params, opt_state, jax_loss = jax_step(params, opt_state, jnp.asarray(want_tokens))
        np.testing.assert_allclose(float(step(tokens)), float(jax_loss), atol=2e-5, rtol=2e-5)
    want = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_pretrain_packs_one_more_token_than_attention_sees(c4_datasets, monkeypatch):
    """``pretrain(seq_len=16)`` packs 17-token rows, so every attention
    call runs at exactly 16 positions, through the flash function."""
    from petastorm_tpu_torch.ops import flash_attention
    seen = []
    real = flash_attention.flash_attention_fused

    def recording(q, k, v, causal=True, sm_scale=None):
        seen.append((tuple(q.shape), causal))
        return real(q, k, v, causal=causal, sm_scale=sm_scale)

    monkeypatch.setattr(flash_attention, 'flash_attention_fused', recording)
    result = lm_pretrain.pretrain(c4_datasets[1], batch_size=2, steps=3, seq_len=SEQ - 1,
                                  model_kw=MODEL_KW, device='cpu')
    assert result['batch_devices'] == ['cpu']
    assert len(result['losses']) == 3 and all(np.isfinite(result['losses']))
    assert result['tokens_per_s'] > 0 and result['steps_per_s'] > 0
    assert seen and set(seen) == {((2, SEQ - 1, 2, 16), True)}
    assert len(seen) == 3 * MODEL_KW['n_layers']


def test_flagship_numbers_are_the_benchmarks():
    import bench
    assert lm_pretrain.FLAGSHIP_LM_KW == bench.FLAGSHIP_LM_KW


def test_pretrain_resumes_from_its_checkpoint(c4_datasets, tmp_path):
    """``pretrain(checkpoint_dir=)`` saves model, optimizer and data
    position every ``checkpoint_every`` steps, resumes from the latest
    step, and trains nothing once the checkpoint is at the requested step."""
    from petastorm_tpu_torch.checkpoint import TrainCheckpointer
    kw = dict(batch_size=2, seq_len=SEQ - 1, model_kw=MODEL_KW, device='cpu',
              checkpoint_dir=str(tmp_path / 'ckpt'), checkpoint_every=2)
    first = lm_pretrain.pretrain(c4_datasets[1], steps=4, **kw)
    assert first['start_step'] == 0 and len(first['losses']) == 4
    assert TrainCheckpointer(kw['checkpoint_dir']).all_steps() == [2, 4]
    steps_seen = []
    second = lm_pretrain.pretrain(c4_datasets[1], steps=6,
                                  on_step=lambda i, batch, loss: steps_seen.append(i), **kw)
    assert second['start_step'] == 4 and steps_seen == [5, 6]
    assert len(second['losses']) == 2 and all(np.isfinite(second['losses']))
    assert TrainCheckpointer(kw['checkpoint_dir']).latest_step == 6
    assert lm_pretrain.pretrain(c4_datasets[1], steps=6, **kw) is None


@pytest.fixture(scope='module')
def token_corpora(tmp_path_factory):
    """Two token corpora of 96 and 32 documents from the port's writer."""
    root = tmp_path_factory.mktemp('corpora')
    return {name: lm_pretrain.write_token_corpus('file://%s/%s' % (root, name), docs, seed)
            for name, docs, seed in (('web', 96, 1), ('code', 32, 2))}


def test_token_corpus_is_the_benchmarks(tmp_path):
    """``write_token_corpus`` writes what ``bench.py``'s
    ``_build_mixture_source`` writes: the same tables in the same files
    and row-groups."""
    import bench
    want, got = 'file://%s/bench' % tmp_path, 'file://%s/port' % tmp_path
    bench._build_mixture_source(want, 129, seed=3)
    lm_pretrain.write_token_corpus(got, 129, seed=3)
    for part in ('part-0.parquet', 'part-1.parquet'):
        a = pq.ParquetFile('%s/bench/%s' % (tmp_path, part))
        b = pq.ParquetFile('%s/port/%s' % (tmp_path, part))
        assert a.read().equals(b.read())
        assert a.metadata.num_row_groups == b.metadata.num_row_groups


def test_pretrain_mixture_resumes_bit_for_bit(token_corpora, tmp_path):
    """``pretrain_mixture`` on a 3:1 mixture: a run checkpointed at step 3
    and resumed in fresh objects trains steps 4-6 on the same token rows,
    to the same losses, as the unbroken run (exact on the CPU)."""
    from petastorm_tpu_torch.mixture import MixtureSource, MixtureSpec
    spec = MixtureSpec([MixtureSource('web', 3, url=token_corpora['web']),
                        MixtureSource('code', 1, url=token_corpora['code'])],
                       seed=0, seq_len=SEQ)

    def run(steps, checkpoint_dir=None):
        batches = []
        result = lm_pretrain.pretrain_mixture(
            spec, batch_size=2, steps=steps, model_kw=dict(MODEL_KW, vocab_size=1024),
            device='cpu',
            checkpoint_dir=checkpoint_dir, checkpoint_every=3, workers_count=2,
            on_step=lambda i, batch, loss: batches.append((i, batch['tokens'].clone())))
        return result, batches

    unbroken, want = run(6)
    assert unbroken['batch_devices'] == ['cpu'] and len(unbroken['losses']) == 6
    assert unbroken['pack_stats']['fill_ratio'] > 0.9
    assert set(unbroken['source_docs']) == {'web', 'code'}
    assert unbroken['realized_deviation'] <= 1.0
    directory = str(tmp_path / 'ckpt')
    head, _ = run(3, directory)
    tail, got = run(6, directory)
    assert unbroken['restore_s'] is None and unbroken['saves'] == []
    assert [save['step'] for save in head['saves']] == [3] and head['saves'][0]['bytes'] > 0
    assert [save['step'] for save in tail['saves']] == [6] and tail['restore_s'] > 0
    assert tail['start_step'] == 3 and [i for i, _ in got] == [4, 5, 6]
    for (i, tokens), (j, want_tokens) in zip(got, want[3:]):
        assert i == j and torch.equal(tokens, want_tokens)
    assert head['losses'] + tail['losses'] == unbroken['losses']


def test_example_recipe_losses_match_the_jax_example(c4_datasets, monkeypatch):
    """``pretrain_example`` at its defaults (batch 16, 20 steps, Adam 1e-2,
    128 positions, the default ``TransformerConfig`` in bf16) against the
    JAX example's ``pretrain`` at its defaults, from the same seed-0
    weights on the same packed batches (both loaders on the dummy pool,
    row-groups shuffled by the same seed): per-step losses within 5e-3
    absolute, as the variable-length example's are held (both compute in
    bf16 and round activations at different places; Adam at 1e-2 carries
    that into the next step)."""
    import functools

    import petastorm_tpu.jax as jax_loader_module
    from examples.lm import pretrain_example as jax_example

    url = c4_datasets[1]
    want = []
    make_step = jt.transformer_train_step

    def recording_step(config, optimizer, *args, **kwargs):
        step = make_step(config, optimizer, *args, **kwargs)

        def run(params, opt_state, tokens):
            out = step(params, opt_state, tokens)
            want.append(float(out[2]))
            return out
        return run

    monkeypatch.setattr(jt, 'transformer_train_step', recording_step)
    monkeypatch.setattr(jax_loader_module, 'make_jax_loader', functools.partial(
        jax_loader_module.make_jax_loader, reader_pool_type='dummy'))
    final = jax_example.pretrain(url)
    monkeypatch.undo()
    assert len(want) == 20 and want[-1] == final

    def init_from_jax(seed, config, device=None, mesh=None):
        assert seed == 0 and mesh is None
        jax_config = jt.TransformerConfig(max_seq_len=config.max_seq_len)
        params = jt.init_transformer_params(jax.random.PRNGKey(0), jax_config)
        model = tt.Transformer(config)
        model.load_state_dict(tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        return model.to(device)

    monkeypatch.setattr(tt, 'init_transformer', init_from_jax)
    got = lm_pretrain.pretrain_example(url, device='cpu', reader_pool_type='dummy')
    assert got['batch_devices'] == ['cpu']
    np.testing.assert_allclose(got['losses'], want, atol=5e-3, rtol=0)
    assert got['losses'][-1] < got['losses'][0]


def test_pretrain_takes_a_learning_rate(c4_datasets):
    """``pretrain(learning_rate=)`` reaches the optimizer: at 0 the
    weights do not move, so the second batch's loss differs from a run at
    the default rate on the same batches."""
    kw = dict(batch_size=2, steps=2, seq_len=SEQ - 1, model_kw=MODEL_KW, attn_impl='dense',
              device='cpu', reader_pool_type='dummy')
    still = lm_pretrain.pretrain(c4_datasets[1], learning_rate=0.0, **kw)
    moving = lm_pretrain.pretrain(c4_datasets[1], **kw)
    assert still['losses'][0] == moving['losses'][0]
    assert still['losses'][1] != moving['losses'][1]
