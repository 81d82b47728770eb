"""Expert parallelism and the MoE routing scope in the port against the
JAX package, on the CPU.

The reference runs in this process on the conftest's virtual CPU devices:
the MoE transformer's loss, aux, logits and gradients with the tokens
``NamedSharding``-split over ``'data'`` (and over ``'seq'`` for a
sequence-split config), and the MoE layer with its experts sharded by
``moe_param_specs`` (under a ``shard_map`` manual over ``'seq'`` for
``moe_forward(seq_axis=)``). The port runs as spawned gloo ranks, one
spawn per world size (2 and 4), each case in it: every rank loads its
shards of the same numpy weights and takes its rows.

What the routing scope means: the tokens that share one capacity budget
and one set of aux statistics are the ones the JAX function sees as one
array, the global batch. So a split batch keeps the global capacity, a
token's queue position counts the earlier tokens of the other ranks, and
the aux loss is the global one on every rank; ``capacity_factor`` 0.5
drops tokens, 8.0 drops none.

Tolerances (f32, max-abs error over the reference's max-abs): losses,
aux and logits 1e-4, gradients 1e-4, the MoE layer's output 1e-4; the
weights after one AdamW step (learning rate 1e-5) 1e-4.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tests import torch_parallel_reference as ref
from tests.torch_ranks import Ranks
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

MOE_LM = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=16,
              n_experts=4)
LAYER = dict(d_model=16, d_ff=32, n_experts=4)
BATCH, SEQ = 4, 8
LR = 1e-5
# the spawns share the host with the other test workers
SPAWN_TIMEOUT_S = 300

LM_CASES = {
    2: {'data2-cf0.5': ({'data': 2}, dict(capacity_factor=0.5)),
        'data2-cf8': ({'data': 2}, dict(capacity_factor=8.0)),
        'seq2-ring-cf0.5': ({'seq': 2}, dict(capacity_factor=0.5, seq_axis='seq')),
        'seq2-ulysses-cf8': ({'seq': 2}, dict(capacity_factor=8.0, seq_axis='seq',
                                               seq_impl='ulysses')),
        'expert2-cf0.5': ({'expert': 2}, dict(capacity_factor=0.5))},
    4: {'data2-expert2': ({'data': 2, 'expert': 2}, {}),
        'data2-expert2-cf0.5': ({'data': 2, 'expert': 2}, dict(capacity_factor=0.5)),
        'data2-seq2-cf0.5': ({'data': 2, 'seq': 2}, dict(capacity_factor=0.5,
                                                          seq_axis='seq'))},
}
LAYER_CASES = {
    2: {'expert2': ({'expert': 2}, None, None),
        'expert2-tight': ({'expert': 2}, 3, None),
        'data2-tight': ({'data': 2}, 3, None),
        'seq2-seq_axis': ({'seq': 2}, None, 'seq'),
        'seq2-seq_axis-tight': ({'seq': 2}, 2, 'seq')},
    4: {'data2-expert2-tight': ({'data': 2, 'expert': 2}, 3, None),
        'expert4': ({'expert': 4}, None, None)},
}


def _payload(world, root):
    rng = np.random.RandomState(world)
    payload = {'cases': {}, 'errors': {}, 'loaders': {}, 'resumes': {}}
    for i, (name, (axes, kw)) in enumerate(LM_CASES[world].items()):
        config = dict(MOE_LM, **kw)
        payload['cases'][name] = {
            'kind': 'lm', 'mesh': axes, 'config': config, 'lr': LR,
            'params': ref.moe_lm_params(config, 10 * world + i),
            'tokens': rng.randint(0, 64, (BATCH, SEQ + 1)).astype(np.int64)}
    for name, (axes, capacity, seq_axis) in LAYER_CASES[world].items():
        payload['cases'][name] = {
            'kind': 'moe_layer', 'mesh': axes, 'config': LAYER, 'capacity': capacity,
            'seq_axis': seq_axis, 'params': ref.moe_params(LAYER, rng),
            'x': rng.randn(BATCH, SEQ, LAYER['d_model']).astype(np.float32),
            'g': rng.randn(BATCH, SEQ, LAYER['d_model']).astype(np.float32)}
    if world == 2:
        payload['errors']['experts'] = {'what': 'experts', 'mesh': {'expert': 2},
                                        'n_experts': 3}
        # 8 row-groups of 4 rows: each 4-row batch is one row-group, so a
        # checkpoint after a step falls on a row-group boundary
        (root / 'ids').mkdir()
        pq.write_table(pa.table({'id': np.arange(32)}), str(root / 'ids' / 'part-0.parquet'),
                       row_group_size=4)
        payload['resumes']['expert2'] = {
            'mesh': {'expert': 2}, 'config': dict(MOE_LM, capacity_factor=1.0),
            'url': 'file://%s' % (root / 'ids'), 'half': 2, 'dir': str(root / 'ckpt'),
            'table': rng.randint(0, 64, (32, SEQ + 1)).astype(np.int64)}
    else:
        (root / 'ids').mkdir()
        pq.write_table(pa.table({'id': np.arange(64)}), str(root / 'ids' / 'part-0.parquet'),
                       row_group_size=4)
        payload['loaders']['data2-expert2'] = {'url': 'file://%s' % (root / 'ids'),
                                               'mesh': {'data': 2, 'expert': 2}}
    return payload


def _reference(payload):
    want = {}
    for name, case in payload['cases'].items():
        if case['kind'] == 'lm':
            want[name] = ref.lm_step_reference(case['config'], case['params'],
                                               case['tokens'], case['mesh'], lr=LR)
        else:
            want[name] = ref.moe_layer_reference(case['config'], case['params'], case['x'],
                                                 case['g'], case['mesh'], case['capacity'],
                                                 case['seq_axis'])
    return want


@pytest.fixture(scope='module')
def spawns(tmp_path_factory):
    """Both spawns started together, the reference computed while they
    run: ``{world: (results by rank, reference, payload)}``."""
    from tests.torch_parallel_bodies import to_numpy
    started = {}
    for world in (2, 4):
        root = tmp_path_factory.mktemp('ep%d' % world)
        payload = _payload(world, root)
        started[world] = (Ranks(root / 'ranks', world,
                                'tests.torch_parallel_bodies:parallel_cases_body', payload,
                                timeout=SPAWN_TIMEOUT_S),
                          payload)
    try:
        want = {world: _reference(payload) for world, (_, payload) in started.items()}
    finally:
        got = {world: [to_numpy(r) for r in ranks.results()]
               for world, (ranks, _) in started.items()}
    return {world: (got[world], want[world], payload) for world, (_, payload) in started.items()}


def _block(full, coordinate, axes):
    """The rows and positions of ``full`` a rank holds."""
    if 'data' in axes:
        full = np.split(full, axes['data'], axis=0)[coordinate['data']]
    if 'seq' in axes:
        full = np.split(full, axes['seq'], axis=1)[coordinate['seq']]
    return full


def _cases(table):
    return [(world, name) for world in (2, 4) for name in table[world]]


def _pick(spawns, world, name):
    got, want, payload = spawns[world]
    return got, want[name], payload['cases'][name]


@pytest.mark.parametrize('world,name', _cases(LM_CASES))
def test_moe_lm_loss_aux_and_logits_match(spawns, world, name):
    """Every rank's loss and aux are the global batch's, its logits the
    block of its rows (and positions)."""
    got, want, case = _pick(spawns, world, name)
    for r in got:
        result = r['cases'][name]
        ref.close(result['loss'], want['loss'])
        ref.close(result['aux'], want['aux'])
        if want['logits'] is not None:
            ref.close(result['logits'], _block(want['logits'], result['coordinate'],
                                               case['mesh']))
        assert want['aux'] > 2.0 - 1e-4     # both blocks' Switch losses, each >= 1


@pytest.mark.parametrize('world,name', _cases(LM_CASES))
def test_moe_lm_gradients_and_adamw_step_match(spawns, world, name):
    """The synced gradients are this rank's shards of the reference's (an
    expert rank's experts only), and one AdamW step moves the weights as
    optax's ``adamw`` moves the reference's."""
    got, want, case = _pick(spawns, world, name)
    grads, updated = ref.full_state_nested(want['grads']), ref.full_state_nested(want['updated'])
    for r in got:
        result, c = r['cases'][name], r['cases'][name]['coordinate']
        assert set(result['grads']) == set(grads)
        for key, value in grads.items():
            ref.close(result['grads'][key], ref.rank_part(key, value, case['config'], c,
                                                          case['mesh']))
            ref.close(result['params'][key], ref.rank_part(key, updated[key], case['config'],
                                                           c, case['mesh']))


@pytest.mark.parametrize('world,name', _cases(LAYER_CASES))
def test_moe_layer_matches(spawns, world, name):
    """The layer alone: each rank's output and input gradient for its
    block, the aux, and its experts' and the router's gradients (summed
    over ``'data'`` and ``'seq'``) against the reference's."""
    got, want, case = _pick(spawns, world, name)
    for r in got:
        result, c = r['cases'][name], r['cases'][name]['coordinate']
        ref.close(result['y'], _block(want['y'], c, case['mesh']))
        ref.close(result['x_grad'], _block(want['x_grad'], c, case['mesh']))
        ref.close(result['aux'], want['aux'])
        for key, value in want['grads'].items():
            ref.close(result['grads'][key],
                      ref.expert_part(key, value, case['mesh'].get('expert', 1),
                                      c.get('expert', 0)))


def test_dense_oracle_sums_over_expert_shards():
    """:func:`dense_oracle` on each expert rank's layer gives that rank's
    experts' share; the shares add up to the whole layer's output."""
    import torch

    from petastorm_tpu_torch.models import moe as tm

    class ExpertMesh:
        mesh_dim_names = ('expert',)

        def __init__(self, index):
            self.index = index

        def get_coordinate(self):
            return [self.index]

        def size(self, dim):
            return 2

        def get_group(self, name):
            return None

        def get_local_rank(self, name):
            return self.index

    cfg = tm.MoEConfig(dtype=torch.float32, **LAYER)
    whole = tm.init_moe(0, cfg, device='cpu')
    x = np.random.RandomState(0).randn(2, 8, LAYER['d_model']).astype(np.float32)
    parts = [tm.dense_oracle(tm.init_moe(0, cfg, device='cpu', mesh=ExpertMesh(i)), x, cfg)
             for i in range(2)]
    np.testing.assert_allclose(parts[0] + parts[1], tm.dense_oracle(whole, x, cfg),
                               atol=1e-6, rtol=1e-6)
    assert np.abs(parts[0]).sum() > 0 and np.abs(parts[1]).sum() > 0


def test_indivisible_experts_are_refused(spawns):
    for r in spawns[2][0]:
        assert r['errors']['experts'] == (
            'ValueError', "n_experts=3 does not split over the 2 ranks of mesh dim 'expert'")


def test_expert_split_model_resumes_each_ranks_experts(spawns):
    """An ``{'expert': 2}`` MoE model saved after two steps and restored in
    fresh objects trains the next two batches to the unbroken run's
    losses, bit for bit, on the same rows; every rank writes its own
    experts."""
    got = spawns[2][0]
    for r in got:
        result = r['resumes']['expert2']
        assert result['files'] == ['state.0.pt', 'state.1.pt']
        assert result['resumed']['ids'] == result['unbroken']['ids']
        assert result['resumed']['losses'] == result['unbroken']['losses']
        assert len(set(map(tuple, result['unbroken']['ids']))) == 4
    assert got[0]['resumes'] == got[1]['resumes']


def test_expert_replicas_read_the_same_rows(spawns):
    """A loader over ``{'data': 2, 'expert': 2}`` splits rows over
    ``'data'`` only: the two expert ranks of a data shard get the same
    rows in ventilation order (from four thread workers as from the dummy
    pool), and the data shards' rows partition the dataset."""
    by_data = {}
    for r in spawns[4][0]:
        rows = r['loaders']['data2-expert2']
        assert rows['thread'] == rows['dummy']
        by_data.setdefault(rows['coordinate']['data'], []).append(rows['thread'])
    for replicas in by_data.values():
        assert len(replicas) == 2 and replicas[0] == replicas[1]
    for epoch in range(2):
        ids = [i for shard in by_data.values() for batch in shard[0][8 * epoch:8 * (epoch + 1)]
               for i in batch]
        assert sorted(ids) == list(range(64))
