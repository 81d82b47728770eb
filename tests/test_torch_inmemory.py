"""``inmemory_cache_all=True`` in make_torch_loader against the JAX
package's ``InMemoryCachedLoader`` on the CPU.

Both loaders read the same datasets on the dummy pool and draw each replay
epoch's order from ``numpy.random.RandomState(seed + epoch)``, so every
pass, the first and each replay, is compared batch for batch. The semantic
checks mirror ``tests/test_inmemory_cache.py``. The ``cuda`` test holds the
replay on the card: its batches stay there and no data is copied from the
host. The machine with the card has no JAX, so this file imports the JAX
loader only where it is installed; run the card's test there with
``python -m pytest --noconftest -m cuda tests/test_torch_inmemory.py``.
"""

import itertools

import numpy as np
import pytest
import torch

try:
    from petastorm_tpu.jax import make_jax_loader
except ImportError:  # the machine with the card: only the cuda test runs there
    make_jax_loader = None
from petastorm_tpu_torch.device.loader import MASK_FIELD, make_torch_loader
from petastorm_tpu_torch.device.staging import H2D_BYTES
from petastorm_tpu_torch.telemetry import get_registry, reset_registry


def _passes(make, url, passes, **kw):
    with make(url, reader_pool_type='dummy', inmemory_cache_all=True, **kw) as loader:
        return [[{k: np.asarray(v) for k, v in b.items()} for b in loader]
                for _ in range(passes)]


def _jax_passes(url, passes, **kw):
    return _passes(make_jax_loader, url, passes, **kw)


def _torch_passes(url, passes, **kw):
    return _passes(make_torch_loader, url, passes, device='cpu', **kw)


def _assert_same_passes(want, got):
    assert len(want) == len(got)
    for pass_want, pass_got in zip(want, got):
        assert len(pass_want) == len(pass_got)
        for a, b in zip(pass_want, pass_got):
            assert sorted(a) == sorted(b)
            for name in a:
                np.testing.assert_array_equal(a[name], b[name].astype(a[name].dtype),
                                              err_msg=name)


def _ids(batches, masked=True):
    out = []
    for b in batches:
        ids = b['id']
        if masked and MASK_FIELD in b:
            ids = ids[b[MASK_FIELD]]
        out.extend(ids.tolist())
    return out


REPLAY_CASES = {
    'batch-order': dict(batch_size=10, last_batch='short', seed=7),
    'batch-order-drop': dict(batch_size=12, seed=2),
    'rows': dict(batch_size=10, shuffle_rows=True, seed=3),
    'rows-pad-tail': dict(batch_size=30, shuffle_rows=True, last_batch='pad', seed=5),
    'rows-short-tail': dict(batch_size=30, shuffle_rows=True, last_batch='short', seed=8),
    'rows-drop-tail': dict(batch_size=30, shuffle_rows=True, seed=9),
}


@pytest.mark.parametrize('case', sorted(REPLAY_CASES))
def test_replay_epochs_match_jax(scalar_dataset, case):
    kw = dict(REPLAY_CASES[case], fields=['^id$', '^float64$'], shuffle_row_groups=True)
    want = _jax_passes(scalar_dataset.url, 4, **kw)
    got = _torch_passes(scalar_dataset.url, 4, **kw)
    _assert_same_passes(want, got)
    full = kw.get('last_batch') in ('short', 'pad')
    for batches in got:
        ids = _ids(batches)
        assert len(set(ids)) == len(ids)
        if full:
            assert sorted(ids) == list(range(100))
    # each replay changes the order of the first pass
    assert all(_ids(p) != _ids(got[0]) for p in got[1:])


def test_row_replay_redraws_batch_membership(scalar_dataset):
    got = _torch_passes(scalar_dataset.url, 3, batch_size=10, shuffle_rows=True, seed=3,
                        fields=['^id$'])
    sets = [{frozenset(b['id'].tolist()) for b in p} for p in got]
    assert sets[1] != sets[0] and sets[2] != sets[1]


def test_row_replay_pads_its_tail(scalar_dataset):
    replay = _torch_passes(scalar_dataset.url, 2, batch_size=30, shuffle_rows=True,
                           last_batch='pad', seed=5, fields=['^id$'])[1]
    assert len(replay) == 4 and all(len(b[MASK_FIELD]) == 30 for b in replay)
    assert sorted(_ids(replay)) == list(range(100))
    assert sorted(int(b[MASK_FIELD].sum()) for b in replay) == [10, 30, 30, 30]
    tail = next(b for b in replay if not b[MASK_FIELD].all())
    assert (tail['id'][~tail[MASK_FIELD]] == 0).all()


def test_batch_order_replay_keeps_membership(scalar_dataset):
    got = _torch_passes(scalar_dataset.url, 3, batch_size=5, last_batch='short', seed=7,
                        fields=['^id$'])
    first = {tuple(b['id'].tolist()) for b in got[0]}
    for replay in got[1:]:
        assert {tuple(b['id'].tolist()) for b in replay} == first
    assert _ids(got[1]) != _ids(got[2])


@pytest.fixture(scope='module')
def ragged_url(tmp_path_factory):
    import pyarrow as pa

    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    url = 'file://' + str(tmp_path_factory.mktemp('ragged_inmemory')) + '/ds'
    schema = Unischema('Ragged', [
        UnischemaField('id', np.int32, (), ScalarCodec(pa.int32()), False),
        UnischemaField('tokens', np.int32, (None,), NdarrayCodec(), False)])
    rng = np.random.RandomState(0)
    write_dataset(url, schema, [{'id': i, 'tokens': rng.randint(1, 100, (3 + i % 9,),
                                                                  dtype=np.int32)}
                                for i in range(32)], rowgroup_size_rows=8)
    return url


@pytest.mark.parametrize('shuffle_rows', [False, True], ids=['in-order', 'shuffled'])
def test_bucketed_replay_matches_jax(ragged_url, shuffle_rows):
    # bucketed batches have a width per bucket: replay reshuffles batch order
    kw = dict(batch_size=4, bucket_boundaries={'tokens': [6, 12]}, last_batch='short',
              shuffle_rows=shuffle_rows, seed=1, shuffle_row_groups=True)
    want = _jax_passes(ragged_url, 3, **kw)
    got = _torch_passes(ragged_url, 3, **kw)
    _assert_same_passes(want, got)
    first = {tuple(b['id'].tolist()) for b in got[0]}
    for replay in got[1:]:
        assert {tuple(b['id'].tolist()) for b in replay} == first
        assert {b['tokens'].shape[1] for b in replay} == {6, 12}


def test_replay_reads_nothing_and_copies_nothing(scalar_dataset):
    reset_registry()
    with make_torch_loader(scalar_dataset.url, batch_size=20, device='cpu',
                           reader_pool_type='dummy', fields=['^id$'], last_batch='short',
                           inmemory_cache_all=True) as loader:
        first = list(loader)
        assert loader.reader.last_row_consumed
        staged = get_registry().counter(H2D_BYTES).value
        delivered = loader.diagnostics['batches_delivered']
        second = list(loader)
        assert get_registry().counter(H2D_BYTES).value == staged > 0
        assert loader.diagnostics['batches_delivered'] == delivered == len(first)
    reset_registry()
    # replay serves the same tensors: no re-stage, no copy
    assert {id(b['id']) for b in first} == {id(b['id']) for b in second}


def test_iter_steps_crosses_epochs_as_jax(scalar_dataset):
    kw = dict(batch_size=20, fields=['^id$'], reader_pool_type='dummy', seed=4,
              inmemory_cache_all=True, shuffle_row_groups=True)
    with make_jax_loader(scalar_dataset.url, **kw) as loader:
        want = [np.asarray(b['id']) for b in loader.iter_steps(12)]
    with make_torch_loader(scalar_dataset.url, device='cpu', **kw) as loader:
        got = [b['id'].numpy() for b in loader.iter_steps(7)]
        got += [b['id'].numpy() for b in loader.iter_steps(5)]
    assert len(got) == 12
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_abandoned_boundary_iterator_does_not_duplicate_the_cache(scalar_dataset):
    with make_torch_loader(scalar_dataset.url, batch_size=20, device='cpu',
                           reader_pool_type='dummy', fields=['^id$'],
                           inmemory_cache_all=True) as loader:
        head = list(itertools.islice(loader, 5))  # exactly one epoch
        assert len(head) == 5
        replay = list(loader)
    assert len(replay) == 5 and sorted(_ids(replay)) == list(range(100))


def test_empty_cache_replays_empty_and_iter_steps_raises(scalar_dataset):
    with make_torch_loader(scalar_dataset.url, batch_size=512, device='cpu',
                           reader_pool_type='dummy', fields=['^id$'], shuffle_rows=True,
                           inmemory_cache_all=True) as loader:
        assert list(loader) == [] and list(loader) == []
        with pytest.raises(RuntimeError, match='no batches'):
            list(loader.iter_steps(1))


@pytest.mark.parametrize('shuffle_rows', [False, True], ids=['batch-order', 'rows'])
def test_stop_releases_the_cache(scalar_dataset, shuffle_rows):
    loader = make_torch_loader(scalar_dataset.url, batch_size=10, device='cpu',
                               reader_pool_type='dummy', fields=['^id$'],
                               shuffle_rows=shuffle_rows, inmemory_cache_all=True)
    list(loader.iter_steps(13))
    live = iter(loader)
    next(live)
    loader.stop()
    with pytest.raises(RuntimeError, match='stopped'):
        next(live)
    with pytest.raises(RuntimeError, match='stopped'):
        list(loader.iter_steps(1))
    with pytest.raises(RuntimeError, match='stopped'):
        iter(loader)


def test_no_checkpoint_and_one_epoch_reader(scalar_dataset):
    with pytest.raises(ValueError, match='caches exactly one epoch'):
        make_torch_loader(scalar_dataset.url, batch_size=10, device='cpu',
                          num_epochs=3, inmemory_cache_all=True)
    with make_torch_loader(scalar_dataset.url, batch_size=10, device='cpu',
                           fields=['^id$'], inmemory_cache_all=True) as loader:
        with pytest.raises(RuntimeError, match='no checkpointable reader'):
            loader.state_dict()
        with pytest.raises(RuntimeError, match='no checkpointable reader'):
            loader.load_state_dict({'epoch': 0})
        assert isinstance(loader.diagnostics, dict) and loader.batch_size == 10


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_bucketed_replay_stays_on_the_card(ragged_url):
    """The bucketed loader's batches lie on the card, and replay epochs
    stage nothing: no loader bytes and no host-to-device copy in the
    profiler's trace."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the staging ring copies to the card')
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reset_registry()
    with make_torch_loader(ragged_url, batch_size=4, bucket_boundaries={'tokens': [6, 12]},
                           last_batch='short', inmemory_cache_all=True,
                           reader_pool_type='dummy') as loader:
        first = list(loader)
        torch.cuda.synchronize()
        staged = get_registry().counter(H2D_BYTES).value
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            replay = list(loader)
            torch.cuda.synchronize()
        assert get_registry().counter(H2D_BYTES).value == staged > 0
    reset_registry()
    assert all(t.is_cuda for b in first + replay for t in b.values())
    assert {b['tokens'].shape[1] for b in first} == {6, 12}
    copies = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA and 'HtoD' in e.name]
    assert not copies, copies
    assert sorted(i for b in replay for i in b['id'].tolist()) == list(range(32))
