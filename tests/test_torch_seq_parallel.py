"""Sequence parallelism in the port against the JAX package, on the CPU:
ring and Ulysses attention alone, the Ulysses head-count error, and
``TransformerConfig(seq_axis=)`` training.

The reference runs in this process on ``make_named_mesh`` meshes of the
conftest's virtual CPU devices: ``ring_attention`` and
``ulysses_attention`` over ``{'seq': 2}``, ``{'seq': 4}`` and ``{'data':
2, 'seq': 2}`` (the batch split over ``'data'``), and ``transformer_loss``
(and ``transformer_masked_loss``) with gradients under ``{'data': 1,
'seq': 2}`` and ``{'data': 2, 'seq': 2}``. The port runs as spawned gloo
ranks on the same meshes (one spawn per world size, 2 and 4): each rank
holds its block of the sequence (and its rows of ``'data'``) and returns
its output block, or its loss and synced gradients from
``transformer_train_step`` at learning rate 0. Held, f32, max-abs error
over the reference's max-abs: attention blocks within 1e-5 of the
reference's ring and Ulysses, causal and bidirectional, and ring within
1e-5 of Ulysses; the loss and every gradient within 1e-4 for ring and
Ulysses, learned positions and rope, GQA and a chunked loss, and for
the masked loss (the mean over the whole batch's real targets); the
error type and text equal. A loader over the same meshes gives ranks that differ only
on ``'seq'`` the same rows in the reader's ventilation order, from a
thread pool as from the dummy pool.
"""

import functools

import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tests import torch_parallel_reference as ref
from tests.torch_ranks import Ranks
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

OP_SHAPE = (4, 16, 4, 8)   # B, S, H, D
OP_CASES = {'causal': True, 'bidir': False}
OP_MESHES = {2: {'seq2': {'seq': 2}},
             4: {'seq4': {'seq': 4}, 'data2-seq2': {'data': 2, 'seq': 2}}}
LM_MESHES = {2: {'data': 1, 'seq': 2}, 4: {'data': 2, 'seq': 2}}
BASE = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=64, max_seq_len=16,
            seq_axis='seq')
LM_CASES = {
    'ring-learned': dict(seq_impl='ring'),
    'ulysses-learned-chunked': dict(seq_impl='ulysses', loss_chunk=4),
    'ring-rope-gqa': dict(seq_impl='ring', pos_encoding='rope', n_kv_heads=2),
    'ulysses-rope-swiglu': dict(seq_impl='ulysses', pos_encoding='rope', ffn='swiglu'),
}
BATCH, SEQ = 4, 16
# lengths of the masked loss: the first data block's rows hold far fewer
# real targets than the second's, so a mean of the blocks' means would
# not pass for the mean over the batch
LENGTHS = np.array([2, 4, SEQ + 3, SEQ - 1], np.int64)


def _payload(world):
    rng = np.random.RandomState(world)
    ops = {'meshes': OP_MESHES[world], 'cases': {}}
    for name, causal in OP_CASES.items():
        q, k, v = (rng.randn(*OP_SHAPE).astype(np.float32) for _ in range(3))
        ops['cases'][name] = {'q': q, 'k': k, 'v': v, 'causal': causal}
    lm = {'mesh': LM_MESHES[world], 'cases': {}}
    for i, (name, kw) in enumerate(LM_CASES.items()):
        kw = dict(BASE, **kw)
        lm['cases'][name] = {
            'config': kw, 'params': ref.lm_params(kw, 10 * world + i),
            'tokens': rng.randint(0, kw['vocab_size'], (BATCH, SEQ + 1)).astype(np.int64),
            'lengths': LENGTHS}
    return {'ops': ops, 'lm': lm}


def _reference(payload):
    from petastorm_tpu.ops.ring_attention import ring_attention
    from petastorm_tpu.ops.ulysses_attention import ulysses_attention
    want = {'ops': {}, 'errors': {}, 'lm': {}}
    for label, axes in payload['ops']['meshes'].items():
        mesh = ref.seq_mesh(axes)
        batch_axis = 'data' if 'data' in axes else None
        for name, case in payload['ops']['cases'].items():
            for impl, fn in (('ring', ring_attention), ('ulysses', ulysses_attention)):
                run = jax.jit(functools.partial(fn, mesh=mesh, causal=case['causal'],
                                                batch_axis=batch_axis))
                want['ops'][label, name, impl] = np.asarray(run(case['q'], case['k'],
                                                                case['v']))
        q = np.zeros((1, 2 * axes['seq'], 3, 4), np.float32)
        try:
            ulysses_attention(q, q, q, mesh)
        except ValueError as e:
            want['errors'][label] = ('ValueError', str(e))
    mesh = ref.seq_mesh(payload['lm']['mesh'])
    for name, case in payload['lm']['cases'].items():
        want['lm'][name] = ref.lm_reference(case['config'], case['params'], case['tokens'],
                                            mesh, lengths=case['lengths'])
    return want


@pytest.fixture(scope='module', params=[2, 4], ids=['world2', 'world4'])
def world(request, tmp_path_factory):
    """One spawn per world size; the reference computed while it runs."""
    from tests.torch_parallel_bodies import to_numpy
    payload = _payload(request.param)
    root = tmp_path_factory.mktemp('seq%d' % request.param)
    # 16 row-groups of 4 rows: each 4-row batch is one row-group
    (root / 'ids').mkdir()
    pq.write_table(pa.table({'id': np.arange(64)}), str(root / 'ids' / 'part-0.parquet'),
                   row_group_size=4)
    payload['loader'] = {'url': 'file://%s' % (root / 'ids'), 'mesh': LM_MESHES[request.param]}
    ranks = Ranks(root / 'ranks', request.param, 'tests.torch_parallel_bodies:seq_body',
                  payload)
    want = _reference(payload)
    got = [to_numpy(r) for r in ranks.results()]
    return request.param, got, want


def _block(full, coordinate, axes):
    """The rows and sequence block of ``full`` that a rank at
    ``coordinate`` holds."""
    if 'data' in axes:
        full = np.split(full, axes['data'], axis=0)[coordinate['data']]
    return np.split(full, axes['seq'], axis=1)[coordinate['seq']]


@pytest.mark.parametrize('impl', ['ring', 'ulysses'])
@pytest.mark.parametrize('case', OP_CASES)
def test_attention_blocks_match_the_references(world, case, impl):
    n, got, want = world
    for label, axes in OP_MESHES[n].items():
        for r in got:
            c = r['ops']['coordinate', label]
            ref.close(r['ops']['cases'][label, case, impl],
                      _block(want['ops'][label, case, impl], c, axes), ref.ATTENTION_TOL)


@pytest.mark.parametrize('case', OP_CASES)
def test_ring_and_ulysses_agree(world, case):
    n, got, _ = world
    for label in OP_MESHES[n]:
        for r in got:
            cases = r['ops']['cases']
            ref.close(cases[label, case, 'ring'], cases[label, case, 'ulysses'],
                      ref.ATTENTION_TOL)


def test_ulysses_head_count_error_is_the_references(world):
    n, got, want = world
    for label in OP_MESHES[n]:
        assert want['errors'][label][1].startswith('ulysses_attention needs n_heads')
        for r in got:
            assert r['ops']['errors'][label] == want['errors'][label]


def test_ranks_sit_on_the_reference_mesh(world):
    n, got, _ = world
    axes = LM_MESHES[n]
    coords = [(r['lm']['coordinate']['data'], r['lm']['coordinate']['seq']) for r in got]
    grid = np.asarray(ref.seq_mesh(axes).device_ids)
    assert [tuple(int(i) for i in np.argwhere(grid == rank)[0]) for rank in range(n)] == coords


@pytest.mark.parametrize('name', LM_CASES)
def test_seq_axis_loss_and_gradients_match(world, name):
    _, got, want = world
    want = want['lm'][name]
    full = ref.full_state(want['grads'])
    for r in got:
        result = r['lm']['cases'][name]
        ref.close(result['loss'], want['loss'])
        assert set(result['grads']) == set(full)
        for key, value in full.items():
            ref.close(result['grads'][key], value)


@pytest.mark.parametrize('name', LM_CASES)
def test_seq_axis_masked_loss_matches(world, name):
    """The masked loss over the whole batch: every rank's sums and
    counts of real targets add up over ``'seq'`` and ``'data'``, so rows
    with more real targets weigh more, as in the reference."""
    _, got, want = world
    want = want['lm'][name]
    full = ref.full_state(want['masked_grads'])
    for r in got:
        result = r['lm']['cases'][name]
        ref.close(result['masked_loss'], want['masked_loss'])
        for key, value in full.items():
            ref.close(result['masked_grads'][key], value)


def test_replicas_read_the_same_rows_in_ventilation_order(world):
    """Ranks that differ only on ``'seq'`` replicate a batch: from a thread
    pool of four workers each still gets the rows in the reader's
    ventilation order (the dummy pool's), both epochs, so the replicas
    train on the same rows; the ``'data'`` shards read different ones."""
    _, got, _ = world
    by_data = {}
    for r in got:
        rows = r['loader']['thread']
        assert len(rows) == 2 * 64 // 4 // LM_MESHES[len(got)]['data']
        assert rows == r['loader']['dummy']
        by_data.setdefault(r['loader']['coordinate']['data'], []).append(rows)
    for replicas in by_data.values():
        assert all(rows == replicas[0] for rows in replicas)
    if len(by_data) > 1:
        assert by_data[0][0] != by_data[1][0]
