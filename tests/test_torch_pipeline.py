"""The GPipe pipeline and the pipelined transformer in the port against the
JAX package, on the CPU.

``pipeline_apply`` is held against the reference's sequential oracle
(``reference_pipeline`` under ``jax.grad``; its own ``pipeline_apply`` for
an aux over several microbatches): the output, the aux, each stage's
weight gradients, the input's gradient and an upstream layer's, over 1,
2 and 4 stages and 1, 2 and 4 microbatches, a multi-layer stage, a
sequence split, and the refused indivisible batch.

The pipelined transformer is held against the reference's layered model
where the reference's pipeline equals it (a dense model; an MoE model at
one microbatch, which routes the whole batch), and against the
reference's pipelined forward and loss where microbatching changes the
routing (an MoE model at two microbatches, or its sequence shards routed
alone): loss, aux, this rank's logits block, its stage's gradient shards
and its weights after one AdamW step. The families: pp, pp×ep, dp×pp×ep,
dp×pp with replicated experts, dp×pp with 3 microbatches of a 6-row
batch (one straddles the data ranks, dense and MoE), 4-way dp with 2
microbatches (each rank holding rows of one only, dense and MoE),
dp×pp×tp, pp×sp (ring and Ulysses),
dp×pp×sp and pp×sp×ep, each MoE one at ample (8.0 or 4.0) and at binding
(0.5) capacity, in bf16 on a pipe mesh, and the refused layouts. The port
runs as spawned gloo ranks, one spawn per world size (2, 4 and 8, the
last for the 2×2×2 families only); every rank loads its stage's shards
with ``pipelined_params_from_jax``.

Tolerances (f32, max-abs error over the reference's max-abs): 1e-4 for
every comparison; the bf16 step's loss within 2e-2 of the reference's
f32 loss.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tests import torch_parallel_reference as ref
from tests.torch_ranks import Ranks
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

DENSE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_seq_len=16)
MOE = dict(DENSE, n_experts=4)
BATCH, SEQ, D = 4, 8, 16
LR = 1e-5
# the spawns share the host with the other test workers
SPAWN_TIMEOUT_S = 300

# name: (mesh, config changes, n_microbatches, the reference: a key of REFS)
LM_CASES = {
    2: {'pipe2-m2': ({'pipe': 2}, {}, 2, 'dense'),
        'pipe2-m4-rope-chunked': ({'pipe': 2}, dict(pos_encoding='rope', loss_chunk=4), 4,
                                  'dense-rope'),
        'pipe2-moe-m2-cf0.5': ({'pipe': 2}, dict(MOE, capacity_factor=0.5), 2,
                               'moe-cf0.5-m2'),
        'pipe2-moe-m1-cf0.5-remat': ({'pipe': 2}, dict(MOE, capacity_factor=0.5, remat=True),
                                     1, 'moe-cf0.5')},
    4: {'pipe4': ({'pipe': 4}, {}, None, 'dense'),
        'data2-pipe2-m4': ({'data': 2, 'pipe': 2}, {}, 4, 'dense'),
        'pipe2-expert2-m1-cf8': ({'pipe': 2, 'expert': 2}, dict(MOE, capacity_factor=8.0), 1,
                                 'moe-cf8'),
        'pipe2-expert2-m2-cf8': ({'pipe': 2, 'expert': 2}, dict(MOE, capacity_factor=8.0), 2,
                                 'moe-cf8-m2'),
        'pipe2-expert2-m1-cf0.5': ({'pipe': 2, 'expert': 2}, dict(MOE, capacity_factor=0.5),
                                   1, 'moe-cf0.5'),
        'pipe2-expert2-m2-cf0.5': ({'pipe': 2, 'expert': 2}, dict(MOE, capacity_factor=0.5),
                                   2, 'moe-cf0.5-m2'),
        'data2-pipe2-moe-m2': ({'data': 2, 'pipe': 2}, dict(MOE, capacity_factor=0.5), 2,
                               'moe-cf0.5-m2'),
        # 3 global microbatches of a 6-row batch: microbatch 1 straddles
        # the two data ranks, one row on each
        'data2-pipe2-m3-b6': ({'data': 2, 'pipe': 2}, {}, 3, 'dense-b6'),
        'data2-pipe2-moe-m3-b6': ({'data': 2, 'pipe': 2}, dict(MOE, capacity_factor=0.5), 3,
                                  'moe-cf0.5-m3-b6'),
        # 2 global microbatches over 4 data ranks: each rank holds rows
        # of one and none of the other
        'data4-pipe1-m2': ({'data': 4, 'pipe': 1}, {}, 2, 'dense'),
        'data4-pipe1-moe-m2': ({'data': 4, 'pipe': 1}, dict(MOE, capacity_factor=0.5), 2,
                               'moe-cf0.5-m2'),
        'pipe2-seq2-ring': ({'pipe': 2, 'seq': 2}, dict(seq_axis='seq'), 2, 'dense'),
        'pipe2-seq2-ulysses': ({'pipe': 2, 'seq': 2}, dict(seq_axis='seq', seq_impl='ulysses'),
                               2, 'dense')},
    8: {'data2-pipe2-expert2-m1-cf4': ({'data': 2, 'pipe': 2, 'expert': 2},
                                       dict(MOE, capacity_factor=4.0), 1, 'moe-cf4'),
        'data2-pipe2-expert2-m2-cf4': ({'data': 2, 'pipe': 2, 'expert': 2},
                                       dict(MOE, capacity_factor=4.0), 2, 'moe-cf4-m2'),
        'data2-pipe2-expert2-m1-cf0.5': ({'data': 2, 'pipe': 2, 'expert': 2},
                                         dict(MOE, capacity_factor=0.5), 1, 'moe-cf0.5'),
        'data2-pipe2-expert2-m2-cf0.5': ({'data': 2, 'pipe': 2, 'expert': 2},
                                         dict(MOE, capacity_factor=0.5), 2, 'moe-cf0.5-m2'),
        'data2-pipe2-model2': ({'data': 2, 'pipe': 2, 'model': 2}, {}, 2, 'dense'),
        'data2-pipe2-seq2-ring': ({'data': 2, 'pipe': 2, 'seq': 2}, dict(seq_axis='seq'), 2,
                                  'dense'),
        'pipe2-seq2-expert2-m1-cf8': ({'pipe': 2, 'seq': 2, 'expert': 2},
                                      dict(MOE, capacity_factor=8.0, seq_axis='seq'), 1,
                                      'moe-cf8'),
        'pipe2-seq2-expert2-m1-cf0.5': ({'pipe': 2, 'seq': 2, 'expert': 2},
                                        dict(MOE, capacity_factor=0.5, seq_axis='seq'), 1,
                                        'moe-seq-cf0.5')},
}
# name: (config, the reference's mesh (None: layered on one device), n_microbatches)
REFS = {
    'dense': (DENSE, None, None),
    'dense-rope': (dict(DENSE, pos_encoding='rope'), None, None),
    'moe-cf8': (dict(MOE, capacity_factor=8.0), None, None),
    'moe-cf4': (dict(MOE, capacity_factor=4.0), None, None),
    'moe-cf0.5': (dict(MOE, capacity_factor=0.5), None, None),
    'moe-cf8-m2': (dict(MOE, capacity_factor=8.0), {'pipe': 2}, 2),
    'moe-cf4-m2': (dict(MOE, capacity_factor=4.0), {'pipe': 2}, 2),
    'moe-cf0.5-m2': (dict(MOE, capacity_factor=0.5), {'pipe': 2}, 2),
    # the pipelined pp×sp×ep forward routes each sequence shard alone
    'moe-seq-cf0.5': (dict(MOE, capacity_factor=0.5, seq_axis='seq'), {'pipe': 2, 'seq': 2}, 1),
    'dense-b6': (DENSE, None, None),
    'moe-cf0.5-m3-b6': (dict(MOE, capacity_factor=0.5), {'pipe': 2}, 3),
}
# the references whose batch is not BATCH rows
REF_BATCH = {'dense-b6': 6, 'moe-cf0.5-m3-b6': 6}
# name: (mesh, kind, n_microbatches, an upstream layer, with_aux, seq_axis)
APPLY_CASES = {
    2: {'stages2-m1': ({'pipe': 2}, 'affine', 1, False, False, None),
        'stages2-m2': ({'pipe': 2}, 'affine', 2, False, False, None),
        'stages2-m4-upstream': ({'pipe': 2}, 'affine', 4, True, False, None),
        'stages2-multilayer': ({'pipe': 2}, 'multilayer', 2, False, False, None),
        'stages2-aux-m2': ({'pipe': 2}, 'affine', 2, False, True, None),
        'one-stage': ({'data': 2, 'pipe': 1}, 'affine', 2, False, False, None)},
    4: {'stages4-m1': ({'pipe': 4}, 'affine', 1, False, False, None),
        'stages4-m2': ({'pipe': 4}, 'affine', 2, False, False, None),
        'stages4-default-upstream': ({'pipe': 4}, 'affine', None, True, False, None),
        'stages4-aux-m4': ({'pipe': 4}, 'affine', 4, False, True, None),
        'stages2-seq2': ({'pipe': 2, 'seq': 2}, 'affine', 2, True, False, 'seq')},
    8: {},
}


def _params_for(config, params):
    """The numpy weights of ``config``: the MoE or the dense set, without
    the position table under rope."""
    chosen = params['moe' if config.get('n_experts', 0) > 0 else 'dense']
    if config.get('pos_encoding') == 'rope':
        chosen = {k: v for k, v in chosen.items() if k != 'pos_embed'}
    return chosen


def _apply_case(rng, axes, kind, m, upstream, with_aux, seq_axis):
    n = axes['pipe']
    if kind == 'multilayer':
        params = {'w': (rng.randn(n, 3, D, D) * D ** -0.5).astype(np.float32)}
    else:
        params = {'w': (rng.randn(n, D, D) * D ** -0.5).astype(np.float32),
                  'b': (rng.randn(n, D) * 0.1).astype(np.float32)}
    shape = (8, 4, D) if seq_axis is not None else (8, D)
    case = {'kind': kind, 'mesh': axes, 'n_microbatches': m, 'with_aux': with_aux,
            'seq_axis': seq_axis, 'params': params, 'x': rng.randn(*shape).astype(np.float32)}
    if upstream:
        case['w_up'] = (rng.randn(D, D) * 0.3).astype(np.float32)
    return case


def _payload(world, root, params, tokens):
    rng = np.random.RandomState(world)
    payload = {'cases': {}, 'errors': {}, 'loaders': {}, 'resumes': {}}
    for name, (axes, kw, m, reference) in LM_CASES[world].items():
        config = dict(DENSE, **kw)
        payload['cases'][name] = {
            'kind': 'lm', 'mesh': axes, 'config': config, 'lr': LR, 'pipelined': True,
            'n_microbatches': m, 'ref': reference,
            'tokens': tokens[REF_BATCH.get(reference, BATCH)],
            'params': ref.stack_stages(_params_for(config, params), axes['pipe'])}
    for name, spec in APPLY_CASES[world].items():
        payload['cases'][name] = _apply_case(rng, *spec)
    if world == 2:
        payload['cases']['stages2-m2-constant-input'] = dict(payload['cases']['stages2-m2'],
                                                            input_grad=False)
        payload['cases']['pipe2-bf16'] = dict(payload['cases']['pipe2-m2'],
                                              config=dict(DENSE, dtype='bfloat16'))
        payload['errors'] = {
            'microbatches': {'what': 'microbatches', 'mesh': {'pipe': 2}},
            'layers': {'what': 'layers', 'mesh': {'pipe': 2}, 'config': dict(DENSE, n_layers=3)}}
        (root / 'ids').mkdir()
        pq.write_table(pa.table({'id': np.arange(32)}), str(root / 'ids' / 'part-0.parquet'),
                       row_group_size=4)
        payload['resumes']['pipe2'] = {
            'mesh': {'pipe': 2}, 'config': DENSE, 'pipelined': True,
            'url': 'file://%s' % (root / 'ids'), 'half': 2, 'dir': str(root / 'ckpt'),
            'table': rng.randint(0, 64, (32, SEQ + 1)).astype(np.int64)}
    if world == 4:
        payload['errors'] = {
            'indivisible-microbatches': {'what': 'batch', 'mesh': {'data': 2, 'pipe': 2},
                                         'config': DENSE, 'batch': 6, 'n_microbatches': 4},
            'seq-width': {'what': 'seq-width', 'mesh': {'pipe': 2, 'seq': 2}}}
        (root / 'ids').mkdir()
        pq.write_table(pa.table({'id': np.arange(64)}), str(root / 'ids' / 'part-0.parquet'),
                       row_group_size=4)
        payload['loaders']['data2-pipe2'] = {'url': 'file://%s' % (root / 'ids'),
                                             'mesh': {'data': 2, 'pipe': 2}}
    return payload


def _references(params, tokens, needed):
    want = {}
    for name in sorted(needed):
        config, axes, m = REFS[name]
        want[name] = ref.lm_step_reference(config, _params_for(config, params),
                                           tokens[REF_BATCH.get(name, BATCH)], axes,
                                           n_microbatches=m, lr=LR)
    return want


@pytest.fixture(scope='module')
def spawns(tmp_path_factory):
    """The world-8 spawn while the references are computed, then the
    world-2 and world-4 spawns together (at most eight ranks at a time
    beside the other test workers): ``{world: (results by rank,
    references, payload)}``."""
    from tests.torch_parallel_bodies import to_numpy
    params = {'dense': ref.moe_lm_params(DENSE, 0), 'moe': ref.moe_lm_params(MOE, 1)}
    rng = np.random.RandomState(2)
    tokens = {n: rng.randint(0, 64, (n, SEQ + 1)).astype(np.int64) for n in (BATCH, 6)}
    payloads, got = {}, {}

    def start(worlds):
        ranks = {}
        for world in worlds:
            root = tmp_path_factory.mktemp('pipe%d' % world)
            payloads[world] = _payload(world, root, params, tokens)
            ranks[world] = Ranks(root / 'ranks', world,
                                 'tests.torch_parallel_bodies:parallel_cases_body',
                                 payloads[world], timeout=SPAWN_TIMEOUT_S)
        return ranks

    def finish(ranks):
        got.update({world: [to_numpy(r) for r in spawn.results()]
                    for world, spawn in ranks.items()})

    running = start((8,))
    try:
        lm_want = _references(params, tokens,
                              {c[3] for cases in LM_CASES.values() for c in cases.values()})
    finally:
        finish(running)
    running = start((2, 4))
    try:
        apply_want = {name: ref.pipe_apply_reference(case)
                      for payload in payloads.values()
                      for name, case in payload['cases'].items() if case['kind'] != 'lm'}
    finally:
        finish(running)
    return {world: (got[world], lm_want, apply_want, payloads[world]) for world in payloads}


def _block(full, coordinate, axes, vocab=False):
    """The rows, positions and vocabulary of ``full`` a rank holds."""
    if 'data' in axes:
        full = np.split(full, axes['data'], axis=0)[coordinate['data']]
    if 'seq' in axes and full.ndim > 1:
        full = np.split(full, axes['seq'], axis=1)[coordinate['seq']]
    if vocab and 'model' in axes:
        full = np.split(full, axes['model'], axis=2)[coordinate['model']]
    return full


def _stage_state(state, first, per):
    """The layered state's entries a stage holds, under the stage's own
    block numbers."""
    out = {}
    for key, value in state.items():
        if not key.startswith('blocks.'):
            out[key] = value
            continue
        _, index, rest = key.split('.', 2)
        if first <= int(index) < first + per:
            out['blocks.%d.%s' % (int(index) - first, rest)] = value
    return out


def _lm_cases():
    return [(w, n) for w in (2, 4, 8) for n in LM_CASES[w]]


def _apply_cases():
    return [(w, n) for w in (2, 4, 8) for n in APPLY_CASES[w]]


@pytest.mark.parametrize('world,name', _lm_cases())
def test_pipelined_loss_aux_and_logits_match(spawns, world, name):
    """Every stage's loss and aux are the global batch's; its logits are
    the block of its rows, positions and vocabulary."""
    got, lm_want, _, payload = spawns[world]
    case = payload['cases'][name]
    want = lm_want[case['ref']]
    for r in got:
        result = r['cases'][name]
        ref.close(result['loss'], want['loss'])
        ref.close(result['aux'], want['aux'])
        ref.close(result['logits'], _block(want['logits'], result['coordinate'], case['mesh'],
                                           vocab=True))
        if case['config'].get('n_experts'):
            assert want['aux'] > 4.0 - 1e-4     # four blocks' Switch losses, each >= 1


@pytest.mark.parametrize('world,name', _lm_cases())
def test_pipelined_gradients_and_adamw_step_match(spawns, world, name):
    """Each rank's synced gradients are its stage's shards of the
    reference's, the embedding's and the head's whole on every stage; one
    AdamW step moves its weights as optax's ``adamw`` moves the
    reference's."""
    got, lm_want, _, payload = spawns[world]
    case = payload['cases'][name]
    want = lm_want[case['ref']]
    per = case['config']['n_layers'] // case['mesh']['pipe']
    grads = ref.full_state_nested(want['grads'])
    updated = ref.full_state_nested(want['updated'])
    for r in got:
        result, c = r['cases'][name], r['cases'][name]['coordinate']
        assert result['first_layer'] == c['pipe'] * per
        stage_grads = _stage_state(grads, result['first_layer'], per)
        stage_updated = _stage_state(updated, result['first_layer'], per)
        assert set(result['grads']) == set(stage_grads)
        for key, value in stage_grads.items():
            ref.close(result['grads'][key], ref.rank_part(key, value, case['config'], c,
                                                          case['mesh']))
            ref.close(result['params'][key], ref.rank_part(key, stage_updated[key],
                                                           case['config'], c, case['mesh']))
        assert np.abs(result['grads']['embed']).max() > 0


def test_bf16_pipelined_step_on_a_pipe_mesh(spawns):
    """The production dtype through the pipeline: the bf16 step's loss is
    finite and within 2e-2 of the reference's f32 loss, and every
    gradient is finite."""
    got, lm_want, _, _ = spawns[2]
    want = lm_want['dense']['loss']
    for r in got:
        result = r['cases']['pipe2-bf16']
        assert np.isfinite(result['loss']) and abs(result['loss'] - want) <= 2e-2 * want
        assert all(np.isfinite(g).all() for g in result['grads'].values())


@pytest.mark.parametrize('world,name', _apply_cases())
def test_pipeline_apply_matches_sequential(spawns, world, name):
    """``pipeline_apply``'s output, aux, stage gradients and the input's
    (and an upstream layer's) gradient on every stage against the
    reference's oracle."""
    got, _, apply_want, payload = spawns[world]
    case, want = payload['cases'][name], apply_want[name]
    for r in got:
        result, c = r['cases'][name], r['cases'][name]['coordinate']
        ref.close(result['out'], want['out'])
        ref.close(result['x_grad'], want['x_grad'])
        if case['with_aux']:
            ref.close(result['aux'], want['aux'])
        if 'w_up' in case:
            ref.close(result['up_grad'], want['up_grad'])
        for key, value in want['grads'].items():
            ref.close(result['grads'][key], value[c['pipe']])


def test_pipeline_trains_its_stages_on_an_input_without_gradient(spawns):
    """A batch that needs no gradient (raw features, not an embedding's
    output) still trains every stage's weights through the pipeline."""
    got, _, apply_want, _ = spawns[2]
    want = apply_want['stages2-m2']
    for r in got:
        result = r['cases']['stages2-m2-constant-input']
        ref.close(result['out'], want['out'])
        assert result['x_grad'] is None
        for key, value in want['grads'].items():
            ref.close(result['grads'][key], value[result['coordinate']['pipe']])


def _reference_error(fn):
    try:
        fn()
    except ValueError as e:
        return 'ValueError', str(e)
    raise AssertionError('the reference did not refuse')


def test_refused_layouts_raise_as_the_reference(spawns):
    """A batch that does not divide into the microbatches (on one data
    rank and, for the pipelined transformer, over two), a sequence that
    does not divide over the seq ranks and layers that do not divide over
    the stages raise the reference's errors. Global microbatches that
    straddle ``'data'`` ranks unevenly run (the ``-m3-b6`` cases)."""
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.models import transformer as jt
    from petastorm_tpu.parallel import pipeline as jp
    pipe2 = ref.seq_mesh({'pipe': 2})
    params = {'w': jnp.zeros((2, 8, 8))}
    want = {
        'microbatches': _reference_error(lambda: jp.pipeline_apply(
            lambda p, x: x, params, jnp.zeros((7, 8)), pipe2, n_microbatches=3)),
        'seq-width': _reference_error(lambda: jp.pipeline_apply(
            lambda p, x: x, params, jnp.zeros((8, 5, 16)), ref.seq_mesh({'pipe': 2, 'seq': 2}),
            seq_axis='seq')),
        'layers': _reference_error(lambda: jt.init_pipelined_transformer_params(
            jax.random.PRNGKey(0), ref.jax_config(dict(DENSE, n_layers=3)), pipe2))}
    for r in spawns[2][0]:
        assert r['errors']['microbatches'] == want['microbatches']
        assert r['errors']['layers'] == want['layers']
    data2_pipe2 = ref.seq_mesh({'data': 2, 'pipe': 2})
    want['indivisible-microbatches'] = _reference_error(lambda: jt.pipelined_transformer_forward(
        jt.init_pipelined_transformer_params(jax.random.PRNGKey(0), ref.jax_config(DENSE),
                                             data2_pipe2),
        jnp.zeros((6, 8), jnp.int32), ref.jax_config(DENSE), data2_pipe2, n_microbatches=4))
    for r in spawns[4][0]:
        assert r['errors']['seq-width'] == want['seq-width']
        assert r['errors']['indivisible-microbatches'] == want['indivisible-microbatches']


def test_pipeline_stage_resumes_its_own_blocks(spawns):
    """A ``{'pipe': 2}`` model saved after two steps and restored in fresh
    objects trains the next two batches to the unbroken run's losses, bit
    for bit, on the same rows; each stage writes its own blocks."""
    got = spawns[2][0]
    for r in got:
        result = r['resumes']['pipe2']
        assert result['files'] == ['state.0.pt', 'state.1.pt']
        assert result['resumed']['ids'] == result['unbroken']['ids']
        assert result['resumed']['losses'] == result['unbroken']['losses']
    assert got[0]['resumes'] == got[1]['resumes']


def test_pipe_replicas_read_the_same_rows(spawns):
    """A loader over ``{'data': 2, 'pipe': 2}`` splits rows over
    ``'data'`` only: both stages of a data shard get the same rows in
    ventilation order, and the data shards' rows partition the
    dataset."""
    by_data = {}
    for r in spawns[4][0]:
        rows = r['loaders']['data2-pipe2']
        assert rows['thread'] == rows['dummy']
        by_data.setdefault(rows['coordinate']['data'], []).append(rows['thread'])
    for replicas in by_data.values():
        assert len(replicas) == 2 and replicas[0] == replicas[1]
    for epoch in range(2):
        ids = [i for shard in by_data.values() for batch in shard[0][8 * epoch:8 * (epoch + 1)]
               for i in batch]
        assert sorted(ids) == list(range(64))


@pytest.mark.parametrize('kind', ['affine', 'multilayer'])
def test_reference_pipeline_is_the_references(kind):
    """The port's sequential oracle applies the stacked stages in order as
    the reference's does (output, aux and the stages' gradients), and the
    pipeline runs here (``pipeline_supported``)."""
    import torch
    import torch.nn.functional as F

    from petastorm_tpu_torch.parallel import pipeline as tp
    case = _apply_case(np.random.RandomState(9), {'pipe': 3}, kind, 1, False, True, None)
    want = ref.pipe_apply_reference(case)
    params = {k: torch.from_numpy(v).requires_grad_() for k, v in case['params'].items()}

    def stage_fn(p, x):
        if kind == 'multilayer':
            for i in range(p['w'].shape[0]):
                x = torch.tanh(x @ p['w'][i])
        else:
            x = F.gelu(x @ p['w'] + p['b'], approximate='tanh')
        return x, x.mean() ** 2

    out, aux = tp.reference_pipeline(stage_fn, params, torch.from_numpy(case['x']),
                                     with_aux=True)
    ((out ** 2).sum() + aux).backward()
    ref.close(out.detach().numpy(), want['out'])
    ref.close(float(aux), want['aux'])
    for key, value in want['grads'].items():
        ref.close(params[key].grad.numpy(), value)
    assert tp.pipeline_supported()
