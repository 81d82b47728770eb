"""petastorm_tpu_torch.checkpoint against petastorm_tpu.jax.checkpoint, on
the CPU.

``merge_loader_states`` gives the JAX function's merged dict, or raises
its ``ValueError`` with its message, on every case of
``tests/test_elastic_resume.py``. ``TrainCheckpointer`` runs the cases of
``tests/test_train_checkpoint.py`` on the port's loader, restores a loader
position that the JAX checkpointer saved to the same remaining rows, and
merges a payload written by a different number of ranks (through
``merge_mixture_states`` for a mixture). Every comparison is exact: row
ids, token rows, tensors and merged states are equal.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from petastorm_tpu.jax import checkpoint as jax_checkpoint
from petastorm_tpu.jax import make_jax_loader
from petastorm_tpu_torch import checkpoint as ckpt_mod
from petastorm_tpu_torch.checkpoint import TrainCheckpointer, merge_loader_states
from petastorm_tpu_torch.device.loader import make_torch_loader
from petastorm_tpu_torch.reader import make_batch_reader
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

# -- merge_loader_states: the cases of tests/test_elastic_resume.py ------------


def _base(**kw):
    return dict({'epoch': 0, 'seed': 0, 'iterations_remaining': 1,
                 'consumed_items': [], 'items_global': [[0, 0]]}, **kw)


def _family(cur, count):
    return _base(items_global=[[0, 0, 1]], cur_shard=cur, shard_count=count)


MERGE_CASES = {
    'no-items-global': [{'epoch': 0, 'consumed_items': [], 'seed': 0,
                         'iterations_remaining': 1}],
    'empty': [],
    'earliest-epoch-union': [
        {'epoch': 0, 'seed': 7, 'iterations_remaining': 3, 'consumed_items': [1],
         'items_global': [[0, 0], [2, 0], [4, 0]]},
        {'epoch': 1, 'seed': 7, 'iterations_remaining': 2, 'consumed_items': [0],
         'items_global': [[1, 0], [3, 0]]}],
    'infinite-epochs': [_base(epoch=2, iterations_remaining=None)] * 2,
    'seed-order-ab': [_base(seed=9), _base(seed=2)],
    'seed-order-ba': [_base(seed=2), _base(seed=9)],
    'seed-none-first': [_base(seed=None), _base(seed=9)],
    'seed-none-last': [_base(seed=9), _base(seed=None)],
    'mixed-sharded-unsharded': [_base(shard_count=2, cur_shard=0), _base()],
    'complete-family': [_base(shard_count=2, cur_shard=0), _base(shard_count=2, cur_shard=1)],
    'duplicated-shard': [_base(shard_count=2, cur_shard=0)] * 2,
    'missing-cur-shard': [_base(shard_count=2, cur_shard=0), _base(shard_count=2)],
    'shard-0-twice': [_family(0, 2), _family(0, 2)],
    'disagreeing-counts': [_family(0, 2), _family(1, 3)],
    'malformed-entry': [_base(items_global=[[0, 0, 1]]), None],
}


@pytest.mark.parametrize('case', sorted(MERGE_CASES))
def test_merge_loader_states_matches_jax(case):
    states = MERGE_CASES[case]
    try:
        want = jax_checkpoint.merge_loader_states(states)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            merge_loader_states(states)
        assert str(got.value) == str(e)
        return
    assert merge_loader_states(states) == want


def _drain_ids(reader):
    return [i for batch in reader for i in np.asarray(batch.id).tolist()]


def _consume(reader, n):
    return [i for _ in range(n) for i in np.asarray(next(reader).id).tolist()]


@pytest.mark.parametrize('n_to,shuffle', [(3, True), (1, False)], ids=['2-to-3', '2-to-1'])
def test_reader_states_merge_onto_another_shard_count(scalar_dataset, n_to, shuffle):
    """Port readers on two shards, merged by the port (equal to the JAX
    merge), resumed on ``n_to`` port shards: nothing lost, nothing
    consumed re-read."""
    kw = dict(schema_fields=['^id$'], shuffle_row_groups=shuffle, seed=13, num_epochs=1)
    states, before = [], []
    for shard in range(2):
        with make_batch_reader(scalar_dataset.url, cur_shard=shard, shard_count=2, **kw) as r:
            before.extend(_consume(r, 2))
            states.append(r.state_dict())
    merged = merge_loader_states(states)
    assert merged == jax_checkpoint.merge_loader_states(states)
    after = []
    for shard in range(n_to):
        shards = dict(cur_shard=shard, shard_count=n_to) if n_to > 1 else {}
        with make_batch_reader(scalar_dataset.url, **shards, **kw) as r:
            r.load_state_dict(merged)
            after.extend(_drain_ids(r))
    assert set(before) | set(after) == set(range(100))
    assert not set(before) & set(after)


def test_drop_partition_count_change_re_reads(scalar_dataset):
    kw = dict(schema_fields=['^id$'], shuffle_row_groups=False, num_epochs=1)
    with make_batch_reader(scalar_dataset.url, shuffle_row_drop_partitions=2, **kw) as r:
        _consume(r, 2)
        state = r.state_dict()
    assert state['consumed_items']
    merged = merge_loader_states([state])
    with make_batch_reader(scalar_dataset.url, **kw) as r:
        r.load_state_dict(merged)
        assert set(_drain_ids(r)) == set(range(100))


# -- TrainCheckpointer: the cases of tests/test_train_checkpoint.py ------------


def _state(seed=0):
    rng = np.random.RandomState(seed)
    return {'params': {'w': torch.from_numpy(rng.randn(4, 4).astype(np.float32)),
                       'b': torch.from_numpy(rng.randn(4).astype(np.float32))},
            'step_count': torch.tensor(7, dtype=torch.int32)}


def _zeros_like(state):
    return {'params': {k: torch.zeros_like(v) for k, v in state['params'].items()},
            'step_count': torch.zeros_like(state['step_count'])}


def _loader(url, **kw):
    return make_torch_loader(url, device='cpu', fields=['^id$'], **kw)


def _ids(batch):
    return batch['id'].numpy().tolist()


def test_fresh_run_returns_template_and_step_zero(tmp_path, scalar_dataset):
    with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
        assert ckpt.latest_step is None
        template = _state()
        assert ckpt.restore_state(template) is template
        with _loader(scalar_dataset.url, batch_size=16) as loader:
            assert ckpt.restore_loader(loader) == 0


def test_train_state_round_trips(tmp_path):
    want = _state(seed=3)
    with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
        ckpt.save(5, want)
        assert ckpt.latest_step == 5
    with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
        got = ckpt.restore_state(_zeros_like(want))
    for name in ('w', 'b'):
        assert torch.equal(got['params'][name], want['params'][name])
    assert int(got['step_count']) == 7 and got['step_count'].dtype == torch.int32


def test_loader_resume_covers_remaining_rows(tmp_path, scalar_dataset):
    kw = dict(batch_size=10, num_epochs=1, shuffle_row_groups=True, seed=11,
              last_batch='short')
    before = []
    with _loader(scalar_dataset.url, **kw) as loader:
        it = iter(loader)
        for _ in range(3):
            before.extend(_ids(next(it)))
        with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            ckpt.save(3, _state(), loader)
    after = []
    with _loader(scalar_dataset.url, **kw) as loader:
        with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            assert ckpt.restore_loader(loader) == 3
        for batch in loader:
            after.extend(_ids(batch))
    assert set(before) | set(after) == set(range(100))
    assert len(after) < 100


def test_loader_resume_with_shuffle_buffer(tmp_path, scalar_dataset):
    kw = dict(batch_size=8, num_epochs=1, shuffle_rows=True, shuffling_queue_capacity=48,
              seed=5, last_batch='short')
    before = []
    with _loader(scalar_dataset.url, **kw) as loader:
        it = iter(loader)
        for _ in range(4):
            before.extend(_ids(next(it)))
        with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            ckpt.save(4, _state(), loader)
    after = []
    with _loader(scalar_dataset.url, **kw) as loader:
        with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            ckpt.restore_loader(loader)
        for batch in loader:
            after.extend(_ids(batch))
    assert set(before) | set(after) == set(range(100))


def test_model_only_checkpoint_leaves_loader_fresh(tmp_path, scalar_dataset, caplog):
    with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
        ckpt.save(2, _state())
    with _loader(scalar_dataset.url, batch_size=20, num_epochs=1,
                 last_batch='short') as loader:
        with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            with caplog.at_level(logging.WARNING, logger=ckpt_mod.__name__):
                assert ckpt.restore_loader(loader) == 2
        rows = sum(len(b['id']) for b in loader)
    assert rows == 100
    assert 'without loader state' in caplog.text


def test_present_but_unreadable_loader_state_raises(tmp_path, scalar_dataset):
    with _loader(scalar_dataset.url, batch_size=10, num_epochs=1,
                 last_batch='short') as loader:
        with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            next(iter(loader))
            ckpt.save(1, _state(), loader)
    with open(tmp_path / 'ckpt' / '1' / 'loader_state' / 'metadata', 'w') as f:
        f.write('{"0": {"epoch": 0, "se')
    with _loader(scalar_dataset.url, batch_size=10, num_epochs=1,
                 last_batch='short') as loader:
        with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            with pytest.raises(ValueError):
                ckpt.restore_loader(loader)


def test_resume_math_treats_absent_epoch_as_incomplete(scalar_dataset):
    with make_batch_reader(scalar_dataset.url, num_epochs=3) as reader:
        all_items = set(range(reader._num_items))
        state = reader.resume_state_from({1: set(all_items)})
    assert state['epoch'] == 0
    assert state['consumed_items'] == []
    assert state['iterations_remaining'] == 3


def test_checkpoint_after_restore_does_not_rewind(scalar_dataset):
    # the dummy pool delivers row-groups in ventilation order. On the thread
    # pool an epoch-1 row-group can be delivered before the last of epoch 0,
    # and the delivery-accurate state then rightly stays at epoch 0 (the JAX
    # twin in tests/test_train_checkpoint.py fails the same way)
    def fresh_loader():
        return _loader(scalar_dataset.url, batch_size=10, num_epochs=3, last_batch='short',
                       reader_pool_type='dummy')

    with fresh_loader() as loader:
        it = iter(loader)
        for _ in range(13):  # 100 rows an epoch: 130 rows reach epoch 1
            next(it)
        state1 = loader.state_dict()
    assert state1['epoch'] == 1
    assert state1['iterations_remaining'] == 2
    with fresh_loader() as loader:
        loader.load_state_dict(state1)
        state_same = loader.state_dict()
        assert state_same['epoch'] == 1
        assert sorted(state_same['consumed_items']) == sorted(state1['consumed_items'])
        it = iter(loader)
        rows = 0
        while rows < 60:
            rows += len(next(it)['id'])
        state2 = loader.state_dict()
    assert (state2['epoch'], len(state2['consumed_items'])) >= \
        (state1['epoch'], len(state1['consumed_items']))
    assert state2['iterations_remaining'] <= 2


def test_max_to_keep_prunes(tmp_path):
    with TrainCheckpointer(str(tmp_path / 'ckpt'), max_to_keep=2) as ckpt:
        for step in (1, 2, 3):
            ckpt.save(step, _state())
        assert ckpt.latest_step == 3
        assert ckpt.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / 'ckpt')) == ['2', '3']


def test_restore_specific_step(tmp_path):
    with TrainCheckpointer(str(tmp_path / 'ckpt'), max_to_keep=5) as ckpt:
        a, b = _state(seed=1), _state(seed=2)
        ckpt.save(1, a)
        ckpt.save(2, b)
        got = ckpt.restore_state(_zeros_like(a), step=1)
    assert torch.equal(got['params']['w'], a['params']['w'])


def test_a_step_is_written_once_and_unfinished_saves_are_not_steps(tmp_path):
    with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
        assert ckpt.save(1, _state()).endswith(os.sep + '1')
        # orbax's rule: a step not after the latest is skipped unless
        # forced, and a forced save of an existing step raises
        assert ckpt.save(1, _state()) is None
        with pytest.raises(ValueError, match='already exists'):
            ckpt.save(1, _state(), force=True)
        os.makedirs(tmp_path / 'ckpt' / '.tmp-2-abc')
        assert ckpt.all_steps() == [1]
        with pytest.raises(ValueError, match='max_to_keep'):
            TrainCheckpointer(str(tmp_path / 'other'), max_to_keep=0)


def test_module_and_optimizer_resume_bit_for_bit(tmp_path):
    """Saving a model and its AdamW state, then loading both into fresh
    objects, continues the same trajectory exactly."""
    from petastorm_tpu_torch.models.transformer import adamw

    def build():
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                                    torch.nn.Linear(8, 1))
        return model, adamw(model)

    data = torch.from_numpy(np.random.RandomState(0).randn(6, 4, 6).astype(np.float32))

    def train(model, optimizer, batches):
        losses = []
        for x in batches:
            optimizer.zero_grad()
            loss = model(x).pow(2).mean()
            loss.backward()
            optimizer.step()
            losses.append(float(loss.detach()))
        return losses

    want = train(*build(), data)
    model, optimizer = build()
    head = train(model, optimizer, data[:3])
    with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
        ckpt.save(3, {'model': model, 'optimizer': optimizer})
    model, optimizer = build()
    with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
        restored = ckpt.restore_state({'model': model, 'optimizer': optimizer})
    assert restored['model'] is model and restored['optimizer'] is optimizer
    assert head + train(model, optimizer, data[3:]) == want


# -- across packages and across rank counts ------------------------------------


class _StateOnly:
    """Stands in for a loader at save time (``state_dict`` only)."""

    def __init__(self, state):
        self._state = state

    def state_dict(self):
        return self._state


def test_jax_saved_loader_position_restores_in_the_port(tmp_path, scalar_dataset):
    """A JAX ``TrainCheckpointer`` checkpoint: the port finds its step and
    restores its loader item to the same remaining rows as the JAX loader."""
    kw = dict(batch_size=10, fields=['^id$'], num_epochs=1, shuffle_row_groups=True,
              seed=11, last_batch='short', reader_pool_type='dummy')
    with make_jax_loader(scalar_dataset.url, **kw) as loader:
        it = iter(loader)
        for _ in range(3):
            next(it)
        with jax_checkpoint.TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            ckpt.save(3, {'w': np.zeros(2, np.float32)}, loader)
    with make_jax_loader(scalar_dataset.url, **kw) as loader:
        with jax_checkpoint.TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            assert ckpt.restore_loader(loader) == 3
        want = [np.asarray(b['id']).tolist() for b in loader]
    with make_torch_loader(scalar_dataset.url, device='cpu', **kw) as loader:
        with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            assert ckpt.latest_step == 3
            assert ckpt.restore_loader(loader) == 3
        got = [_ids(b) for b in loader]
    assert got == want and 0 < sum(map(len, got)) < 100


def test_port_payload_is_the_json_jax_writes(tmp_path, scalar_dataset):
    """The port's loader item is the orbax JSON item's file, with the same
    ``{str(process): state}`` dict, so the JAX checkpointer reads it too."""
    import orbax.checkpoint as ocp
    with _loader(scalar_dataset.url, batch_size=10, num_epochs=1,
                 reader_pool_type='dummy') as loader:
        next(iter(loader))
        with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            ckpt.save(1, _state(), loader)
        want = json.loads(json.dumps(loader.state_dict()))
    with open(tmp_path / 'ckpt' / '1' / 'loader_state' / 'metadata') as f:
        assert json.load(f) == {'0': want}
    manager = ocp.CheckpointManager(str(tmp_path / 'ckpt'))
    try:
        restored = manager.restore(1, args=ocp.args.Composite(
            loader_state=ocp.args.JsonRestore()))
    finally:
        manager.close()
    assert restored['loader_state'] == {'0': want}


def test_restore_merges_on_rank_count_mismatch(tmp_path, scalar_dataset, monkeypatch):
    """A payload from two (simulated) ranks restored on one: the elastic
    merge, and the resumed loader covers everything the two shards had not
    consumed."""
    kw = dict(batch_size=10, num_epochs=1, shuffle_row_groups=True, seed=3,
              last_batch='short')
    states, before = [], []
    for shard in range(2):
        with _loader(scalar_dataset.url, cur_shard=shard, shard_count=2, **kw) as loader:
            it = iter(loader)
            for _ in range(2):
                before.extend(_ids(next(it)))
            states.append(loader.state_dict())
    monkeypatch.setattr(ckpt_mod, '_gather_per_process',
                        lambda state: {'0': states[0], '1': states[1]})
    with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
        ckpt.save(4, _state(), loader=_StateOnly(states[0]))
    after = []
    with _loader(scalar_dataset.url, **kw) as loader:
        with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            assert ckpt.restore_loader(loader) == 4
        for batch in loader:
            after.extend(_ids(batch))
    assert set(before) | set(after) == set(range(100))
    assert len(after) < 100


def test_pre_elastic_state_still_starts_fresh(tmp_path, scalar_dataset, monkeypatch):
    legacy = {'version': 1, 'seed': 0, 'epoch': 0, 'iterations_remaining': 1,
              'consumed_items': []}
    monkeypatch.setattr(ckpt_mod, '_gather_per_process',
                        lambda state: {'0': legacy, '1': legacy})
    with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
        ckpt.save(2, _state(), loader=_StateOnly(legacy))
    with _loader(scalar_dataset.url, batch_size=10, num_epochs=1,
                 last_batch='short') as loader:
        with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            assert ckpt.restore_loader(loader) == 2
        assert {i for b in loader for i in _ids(b)} == set(range(100))


@pytest.fixture(scope='module')
def token_corpora(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq
    root = tmp_path_factory.mktemp('ckpt_mixture')
    urls = {}
    for name, seed in (('web', 1), ('code', 2)):
        os.makedirs(root / name)
        rng = np.random.RandomState(seed)
        tokens = [rng.randint(2, 1000, size=rng.randint(5, 60)).tolist() for _ in range(24)]
        pq.write_table(pa.table({'tokens': tokens}), str(root / name / 'part-0.parquet'),
                       row_group_size=6)
        urls[name] = 'file://' + str(root / name)
    return urls


def _mixture_spec(pkg, urls):
    return pkg.MixtureSpec([pkg.MixtureSource('web', 3, url=urls['web']),
                            pkg.MixtureSource('code', 1, url=urls['code'])],
                           seed=0, seq_len=33)


def test_mixture_payload_from_two_ranks_merges_onto_one(tmp_path, token_corpora,
                                                        monkeypatch):
    """Two ranks' mixture loader states (saved at the same step) restored
    on one rank go through ``merge_mixture_states`` and continue the
    uninterrupted global stream of packed rows exactly."""
    import petastorm_tpu_torch.mixture as tm

    def loader(**kw):
        return make_torch_loader(None, batch_size=2, mixture=_mixture_spec(tm, token_corpora),
                                 device='cpu', reader_pool_type='dummy', **kw)

    with loader() as whole:
        oracle = [b['tokens'].numpy() for b in whole]
    states = []
    for rank in range(2):
        with loader(cur_shard=rank, shard_count=2) as shard:
            it = iter(shard)
            for _ in range(2):
                next(it)
            states.append(json.loads(json.dumps(shard.state_dict())))
    monkeypatch.setattr(ckpt_mod, '_gather_per_process',
                        lambda state: {'0': states[0], '1': states[1]})
    with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
        ckpt.save(2, _state(), loader=_StateOnly(states[0]))
    with loader() as resumed:
        with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            assert ckpt.restore_loader(resumed) == 2
        tail = [b['tokens'].numpy() for b in resumed]
    # two ranks took 2 batches of 2 rows each: 8 rows, 4 batches of the
    # one-rank stream
    want = np.concatenate(oracle)[8:]
    got = np.concatenate(tail)
    np.testing.assert_array_equal(got, want[:len(got)])
    assert len(want) - len(got) < 2  # only the dropped short tail differs


def test_mixture_loader_position_from_jax_restores_in_the_port(tmp_path, token_corpora):
    import petastorm_tpu.mixture as jm
    import petastorm_tpu_torch.mixture as tm
    kw = dict(batch_size=2, reader_pool_type='dummy')
    with make_jax_loader(None, mixture=_mixture_spec(jm, token_corpora), **kw) as loader:
        oracle = [np.asarray(b['tokens']) for b in loader]
    with make_jax_loader(None, mixture=_mixture_spec(jm, token_corpora), **kw) as loader:
        it = iter(loader)
        head = [np.asarray(next(it)['tokens']) for _ in range(3)]
        with jax_checkpoint.TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            ckpt.save(3, {'w': np.zeros(2, np.float32)}, loader)
    with make_torch_loader(None, mixture=_mixture_spec(tm, token_corpora), device='cpu',
                           **kw) as loader:
        with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
            assert ckpt.restore_loader(loader) == 3
        tail = [b['tokens'].numpy() for b in loader]
    assert len(head + tail) == len(oracle)
    for a, b in zip(oracle, head + tail):
        np.testing.assert_array_equal(a, b)


def _two_rank_save(rank, init_file, directory, states):
    torch.distributed.init_process_group('gloo', init_method='file://' + init_file,
                                         world_size=2, rank=rank)
    try:
        assert ckpt_mod._world() == (2, rank)
        assert ckpt_mod._gather_per_process(states[rank]) == \
            {'0': states[0], '1': states[1]}
        TrainCheckpointer(directory).save(5, {'w': torch.full((2,), float(rank))},
                                          loader=_StateOnly(states[rank]))
    finally:
        torch.distributed.destroy_process_group()


def test_ranks_gather_their_states_and_rank_zero_writes(tmp_path):
    """Two gloo ranks on the CPU: ``save`` gathers both loader states with
    ``all_gather_object`` and rank 0 writes the step; without a process
    group the payload is ``{'0': state}``."""
    import torch.multiprocessing as mp
    states = [{'epoch': 0, 'rank': 0}, {'epoch': 1, 'rank': 1}]
    directory = str(tmp_path / 'ckpt')
    mp.spawn(_two_rank_save, args=(str(tmp_path / 'init'), directory, states), nprocs=2,
             join=True)
    with open(os.path.join(directory, '5', 'loader_state', 'metadata')) as f:
        assert json.load(f) == {'0': states[0], '1': states[1]}
    got = TrainCheckpointer(directory).restore_state({'w': torch.zeros(2)})
    assert torch.equal(got['w'], torch.zeros(2))  # rank 0's replica
    assert ckpt_mod._world() == (1, 0)
    assert ckpt_mod._gather_per_process(states[1]) == {'0': states[1]}
