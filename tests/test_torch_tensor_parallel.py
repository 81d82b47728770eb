"""Tensor parallelism on ``'model'`` (dp x tp) in the port against the JAX
package's Megatron layout, on the CPU.

The reference runs in this process on a ``make_mesh(data=2, model=2)`` of
the conftest's virtual CPU devices: ``transformer_loss`` with its
gradients, ``transformer_forward`` and the ViT's loss, from weights placed
by ``_param_specs``. The port runs as four spawned gloo ranks on the same
``(2, 2)`` mesh (one spawn for the module, every case in it): each rank
loads its shards with ``params_from_jax(params, mesh, config)``, takes its
data rows, and runs ``transformer_train_step`` at learning rate 0, so its
gradients are the synced ones. Held, f32, max-abs error over the
reference's max-abs: the loss, this rank's logits block (its rows and
vocabulary slice), every gradient shard, and the masked loss over the
whole batch with its gradient shards within 1e-4, for multi-head,
GQA with K/V heads split evenly, GQA with fewer K/V heads than ranks, GQA
groups that straddle two ranks, heads that do not divide over the ranks
(attention replicated), swiglu and rope, a chunked loss, and the flash
path; the ViT the same way. ``pretrain_example(model_axis=2)`` on two
ranks holds the JAX example's first losses (bf16, 5e-3 absolute, as
``test_torch_lm_pretrain.py`` holds the one-device recipe), and its
checkpoint, saved and resumed, holds each rank's own shards.
"""

import functools
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tests import torch_parallel_reference as ref
from tests.torch_ranks import Ranks
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

BASE = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=64, max_seq_len=16)
LM_CASES = {
    'mha-learned-gelu': {},
    'flash-mha-learned': dict(attn_impl='flash'),
    'gqa2-rope-swiglu-chunked': dict(n_kv_heads=2, pos_encoding='rope', ffn='swiglu',
                                     loss_chunk=4),
    'gqa1-fewer-kv-than-ranks': dict(n_kv_heads=1),
    'gqa3-straddling-groups-rope': dict(d_model=48, n_heads=6, n_kv_heads=3,
                                        pos_encoding='rope'),
    'heads-not-split': dict(d_model=48, n_heads=3),
}
VIT = dict(image_size=16, patch_size=4, channels=3, n_classes=10, d_model=32, n_heads=4,
           n_layers=2, d_ff=64, attn_impl='flash')
BATCH, SEQ = 4, 16
# lengths of the masked loss: the first data block's rows hold far fewer
# real targets than the second's
LENGTHS = np.array([2, 4, SEQ + 3, SEQ - 1], np.int64)


def _lm_kw(name):
    return dict(BASE, **LM_CASES[name])


@pytest.fixture(scope='module')
def dp_tp(tmp_path_factory):
    """The four ranks' results and the reference's, computed while the
    ranks run."""
    rng = np.random.RandomState(0)
    payload = {'data': 2, 'model': 2, 'lm': {}, 'vit': {}}
    for i, name in enumerate(LM_CASES):
        kw = _lm_kw(name)
        payload['lm'][name] = {
            'config': kw, 'params': ref.lm_params(kw, i),
            'tokens': rng.randint(0, kw['vocab_size'], (BATCH, SEQ + 1)).astype(np.int64),
            'lengths': LENGTHS}
    payload['vit']['vit'] = {
        'config': VIT, 'params': ref.vit_params(VIT, 10),
        'images': rng.rand(BATCH, 16, 16, 3).astype(np.float32),
        'labels': rng.randint(0, VIT['n_classes'], BATCH).astype(np.int64)}
    ranks = Ranks(tmp_path_factory.mktemp('dp_tp'), 4, 'tests.torch_parallel_bodies:tp_body',
                  payload)
    mesh = ref.tp_mesh(2, 2)
    want = {'lm': {}, 'vit': {}}
    for name, case in payload['lm'].items():
        want['lm'][name] = ref.lm_reference(case['config'], case['params'], case['tokens'],
                                            mesh, lengths=case['lengths'])
    case = payload['vit']['vit']
    want['vit']['vit'] = ref.vit_reference(VIT, case['params'], case['images'],
                                           case['labels'], mesh)
    got = ranks.results()
    from tests.torch_parallel_bodies import to_numpy
    return [to_numpy(r) for r in got], want, payload


def _rows(x, data_index, n=2):
    return np.split(x, n, axis=0)[data_index]


def test_ranks_sit_on_the_reference_mesh(dp_tp):
    got, _, _ = dp_tp
    assert [(r['coordinate']['data'], r['coordinate']['model']) for r in got] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert np.asarray(ref.tp_mesh(2, 2).device_ids).tolist() == [[0, 1], [2, 3]]


@pytest.mark.parametrize('name', LM_CASES)
def test_loss_matches(dp_tp, name):
    got, want, _ = dp_tp
    for r in got:
        ref.close(r['lm'][name]['loss'], want['lm'][name]['loss'])


@pytest.mark.parametrize('name', LM_CASES)
def test_logits_blocks_match(dp_tp, name):
    got, want, _ = dp_tp
    for r in got:
        c = r['coordinate']
        block = np.split(_rows(want['lm'][name]['logits'], c['data']), 2, axis=2)[c['model']]
        ref.close(r['lm'][name]['logits'], block)


@pytest.mark.parametrize('name', LM_CASES)
def test_gradient_shards_match(dp_tp, name):
    got, want, _ = dp_tp
    kw = _lm_kw(name)
    full = ref.full_state(want['lm'][name]['grads'])
    for r in got:
        grads = r['lm'][name]['grads']
        assert set(grads) == set(full)
        for key, value in full.items():
            ref.close(grads[key], ref.expected_shard(key, value, kw, 2, r['coordinate']['model']))


@pytest.mark.parametrize('name', LM_CASES)
def test_masked_loss_and_gradient_shards_match(dp_tp, name):
    """``transformer_masked_train_step`` against the reference's masked
    loss over the whole batch: the real targets' sums and counts add up
    over ``'data'``, so the block with more of them weighs more."""
    got, want, _ = dp_tp
    kw = _lm_kw(name)
    full = ref.full_state(want['lm'][name]['masked_grads'])
    for r in got:
        ref.close(r['lm'][name]['masked_loss'], want['lm'][name]['masked_loss'])
        grads = r['lm'][name]['masked_grads']
        for key, value in full.items():
            ref.close(grads[key], ref.expected_shard(key, value, kw, 2, r['coordinate']['model']))


@pytest.mark.parametrize('name', LM_CASES)
def test_each_rank_holds_only_its_shards(dp_tp, name):
    """The parameters a rank holds are its slices, not the full arrays:
    the split ones at half width (the K/V part of ``qkv`` at the width of
    the K/V heads its queries read)."""
    got, _, payload = dp_tp
    kw = _lm_kw(name)
    state = ref.full_state(payload['lm'][name]['params'])
    for r in got:
        shapes = r['lm'][name]['shapes']
        for key, value in state.items():
            want = ref.expected_shard(key, value, kw, 2, r['coordinate']['model']).shape
            assert shapes[key] == want, (key, shapes[key], want)
    if name == 'gqa1-fewer-kv-than-ranks':
        # both ranks hold the one K/V head
        assert got[0]['lm'][name]['shapes']['blocks.0.qkv'] == (64, 2 * 16 + 2 * 16)


def test_vit_matches(dp_tp):
    got, want, _ = dp_tp
    full = ref.full_state(want['vit']['vit']['grads'])
    kw = dict(VIT, vocab_size=2)
    for r in got:
        result, c = r['vit']['vit'], r['coordinate']
        ref.close(result['loss'], want['vit']['vit']['loss'])
        ref.close(result['logits'], _rows(want['vit']['vit']['logits'], c['data']))
        for key, value in full.items():
            ref.close(result['grads'][key], ref.expected_shard(key, value, kw, 2, c['model']))


# -- the example's recipe on two ranks ---------------------------------------------


@pytest.fixture(scope='module')
def example_losses(tmp_path_factory):
    """``pretrain_example(model_axis=2)`` on two ranks and the JAX
    example's ``pretrain(model_axis=2)`` from the same seed-0 weights, on
    the same dataset and the dummy pool."""
    import jax

    import petastorm_tpu.jax as jax_loader_module
    from examples.lm import pretrain_example as jax_example
    from petastorm_tpu.models import transformer as jt
    from petastorm_tpu_torch.examples import lm_pretrain
    root = tmp_path_factory.mktemp('c4_tp')
    url = 'file://%s/c4' % root
    lm_pretrain.generate_c4_like(url, num_docs=256, vocab_size=256, seed=0)
    params = jt.init_transformer_params(jax.random.PRNGKey(0),
                                        jt.TransformerConfig(max_seq_len=128))
    aligned = root / 'aligned'
    aligned.mkdir()
    # 127-token documents: each packs with its EOS into one 128-token row,
    # and 16 of them a row-group fill one 16-row batch exactly, so a
    # checkpoint at a step falls on a row-group boundary
    rng = np.random.RandomState(1)
    docs = [rng.randint(2, 256, size=127).tolist() for _ in range(128)]
    pq.write_table(pa.table({'doc_id': np.arange(128), 'tokens': docs}),
                   str(aligned / 'part-0.parquet'), row_group_size=16)
    payload = {'url': url, 'steps': 3, 'model_axis': 2,
               'params': jax.tree_util.tree_map(np.asarray, params),
               'aligned_url': 'file://%s' % aligned, 'half': 2,
               'checkpoint_dir': str(root / 'ckpt')}
    ranks = Ranks(root / 'ranks', 2, 'tests.torch_parallel_bodies:pretrain_example_body',
                  payload)
    want = []
    make_step = jt.transformer_train_step

    def recording_step(config, optimizer, *args, **kwargs):
        step = make_step(config, optimizer, *args, **kwargs)

        def run(p, opt_state, tokens):
            out = step(p, opt_state, tokens)
            want.append(float(out[2]))
            return out
        return run

    saved = (jt.transformer_train_step, jax_loader_module.make_jax_loader)
    jt.transformer_train_step = recording_step
    jax_loader_module.make_jax_loader = functools.partial(saved[1], reader_pool_type='dummy')
    try:
        jax_example.pretrain(url, steps=3, model_axis=2)
    finally:
        jt.transformer_train_step, jax_loader_module.make_jax_loader = saved
    return ranks.results(), want, payload


def test_pretrain_example_model_axis_matches_the_jax_example(example_losses):
    got, want, _ = example_losses
    assert len(want) == 3
    for r in got:
        assert r['batch_devices'] == ['cpu']
        np.testing.assert_allclose(r['losses'], want, atol=5e-3, rtol=0)
    assert got[0]['losses'] == got[1]['losses']


def test_pretrain_example_model_axis_resumes_each_ranks_shards(example_losses):
    """A split model's checkpoint holds every rank's shards: the run
    checkpointed at step 2 and resumed in fresh objects trains steps 3-4
    to the unbroken run's losses (the same rows: the checkpoint falls on a
    row-group boundary). A rank restored on another rank's shards would
    not."""
    from petastorm_tpu_torch.checkpoint import TrainCheckpointer
    got, _, payload = example_losses
    half = payload['half']
    for r in got:
        assert r['start_step'] == half and len(r['head']) == len(r['tail']) == half
        np.testing.assert_allclose(r['head'] + r['tail'], r['unbroken'], rtol=1e-6, atol=0)
    step_dir = os.path.join(payload['checkpoint_dir'], str(2 * half), 'train_state')
    assert sorted(os.listdir(step_dir)) == ['state.0.pt', 'state.1.pt']
    assert TrainCheckpointer(payload['checkpoint_dir']).all_steps() == [half, 2 * half]
