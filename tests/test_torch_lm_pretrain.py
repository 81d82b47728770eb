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
    step = tt.transformer_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4))
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
