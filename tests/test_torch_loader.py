"""petastorm_tpu_torch loader against the JAX loader, on the CPU.

With the dummy pool and the same seed, ``make_torch_loader(device='cpu')``
gives the same batches as ``make_jax_loader``, batch for batch, under
every tail policy and with row shuffling. Tails are held against the JAX
loader with ``PETASTORM_TPU_STAGING=0`` (its pre-arena copy path). The
JAX side runs with 64-bit types off, so its int64/float64 columns arrive
as int32/float32; dtypes are compared after that canonicalization.
The staging ring runs here with unpinned slots and a fake completion
event.
"""

import json

import numpy as np
import pytest
import torch

import jax

from petastorm_tpu.jax import make_jax_loader
from petastorm_tpu.jax import staging as jax_staging
from petastorm_tpu_torch.device import staging
from petastorm_tpu_torch.device.loader import MASK_FIELD, make_torch_loader
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse


@pytest.fixture
def jax_staging_off(monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_STAGING', '0')
    jax_staging.refresh_staging()
    yield
    monkeypatch.undo()
    jax_staging.refresh_staging()


def _jax_batches(url, **kw):
    with make_jax_loader(url, reader_pool_type='dummy', **kw) as loader:
        return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


def _torch_batches(url, **kw):
    with make_torch_loader(url, reader_pool_type='dummy', device='cpu', **kw) as loader:
        return [{k: v.numpy() for k, v in b.items()} for b in loader]


def _assert_same_batches(jax_batches, torch_batches):
    assert len(jax_batches) == len(torch_batches)
    for a, b in zip(jax_batches, torch_batches):
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name].dtype == jax.dtypes.canonicalize_dtype(b[name].dtype), name
            np.testing.assert_array_equal(a[name], b[name].astype(a[name].dtype),
                                          err_msg=name)


CASES = {
    'drop': dict(batch_size=16, last_batch='drop'),
    'pad': dict(batch_size=16, last_batch='pad'),
    'short': dict(batch_size=16, last_batch='short'),
    'shuffle-rows-pad': dict(batch_size=8, last_batch='pad', shuffle_rows=True, seed=4),
    'shuffle-rows-drop-2-epochs': dict(batch_size=8, shuffle_rows=True, seed=1,
                                       num_epochs=2, shuffling_queue_capacity=40,
                                       min_after_retrieve=10, extra_capacity=30),
    'dtype-cast': dict(batch_size=16, last_batch='short',
                       dtypes={'float64': np.float32, 'id': np.int32}),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_batches_match_jax_loader(scalar_dataset, jax_staging_off, case):
    kw = dict(CASES[case], fields=['^id$', '^float64$', '^int_fixed_size_list$'],
              shuffle_row_groups=True)
    want = _jax_batches(scalar_dataset.url, **kw)
    got = _torch_batches(scalar_dataset.url, **kw)
    _assert_same_batches(want, got)
    if kw.get('last_batch') == 'pad':
        assert MASK_FIELD in got[-1] and not got[-1][MASK_FIELD][-1]


def test_image_batches_match_jax_loader(synthetic_dataset, jax_staging_off):
    kw = dict(batch_size=7, last_batch='pad', shuffle_rows=True, seed=2,
              fields=['^id$', '^image_png$', '^matrix_uint16$'])
    _assert_same_batches(_jax_batches(synthetic_dataset.url, **kw),
                         _torch_batches(synthetic_dataset.url, **kw))


def test_bfloat16_cast_applies_after_the_copy(scalar_dataset):
    with make_torch_loader(scalar_dataset.url, batch_size=16, device='cpu',
                           reader_pool_type='dummy', fields=['^id$', '^float64$'],
                           shuffle_row_groups=False,
                           dtypes={'float64': torch.bfloat16}) as loader:
        batch = next(iter(loader))
    assert batch['float64'].dtype == torch.bfloat16
    want = torch.from_numpy(batch['id'].numpy() * 0.66).to(torch.bfloat16)
    assert torch.equal(batch['float64'], want)


def test_state_dict_resumes_in_either_loader(scalar_dataset):
    kw = dict(batch_size=10, fields=['^id$'], shuffle_row_groups=True, seed=7,
              last_batch='short')
    with make_jax_loader(scalar_dataset.url, reader_pool_type='dummy', **kw) as loader:
        it = iter(loader)
        seen = [np.asarray(next(it)['id']) for _ in range(3)]
        state = json.loads(json.dumps(loader.state_dict()))
    with make_jax_loader(scalar_dataset.url, reader_pool_type='dummy', **kw) as loader:
        loader.load_state_dict(state)
        want = [np.asarray(b['id']) for b in loader]
        want_state = loader.state_dict()
    with make_torch_loader(scalar_dataset.url, reader_pool_type='dummy', device='cpu',
                           **kw) as loader:
        loader.load_state_dict(state)
        got = [b['id'].numpy() for b in loader]
        got_state = loader.state_dict()
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert got_state == want_state
    # at-least-once: no row is lost across the resume
    assert set(np.concatenate(seen + got).tolist()) == set(range(100))


def test_iter_steps_crosses_epochs_and_replays(scalar_dataset):
    with make_torch_loader(scalar_dataset.url, batch_size=16, device='cpu',
                           fields=['^id$'], num_epochs=None) as loader:
        batches = list(loader.iter_steps(15))
    assert len(batches) == 15 and all(b['id'].shape == (16,) for b in batches)
    with make_torch_loader(scalar_dataset.url, batch_size=16, device='cpu',
                           fields=['^id$'], last_batch='short') as loader:
        first = sorted(np.concatenate([b['id'].numpy() for b in loader]).tolist())
        second = sorted(np.concatenate([b['id'].numpy() for b in loader]).tolist())
    assert first == second == list(range(100))


@pytest.mark.parametrize('kwargs,item', [
    # mesh= and data_axes= are ported (None): they fail or pass as
    # make_jax_loader does
    (dict(mesh=object()), None),
    (dict(data_axes=('data',)), None),
    # mixture= is ported; its sources on a decode daemon are not
    (dict(mixture=True, reader_pool_type='service'), 9),
    (dict(reader_pool_type='process'), 9),
], ids=['mesh', 'data-axes', 'mixture', 'process'])
def test_unported_kwargs_raise(scalar_dataset, kwargs, item):
    url = scalar_dataset.url
    if item is None:
        if 'mesh' in kwargs:
            # not a mesh: both loaders fail reading its dim names
            for make in (make_jax_loader, make_torch_loader):
                with pytest.raises(AttributeError):
                    make(url, batch_size=4, reader_pool_type='dummy', **kwargs)
            return
        # data_axes without a mesh: ignored by both, no sharding
        with make_torch_loader(url, batch_size=4, device='cpu', reader_pool_type='dummy',
                               fields=['^id$'], **kwargs) as loader:
            assert loader.sharding is None
            got = sorted(int(i) for b in loader for i in b['id'])
        assert got == sorted(int(i) for b in _jax_batches(url, batch_size=4, fields=['^id$'],
                                                          **kwargs) for i in b['id'])
        return
    if kwargs.pop('mixture', False):
        from petastorm_tpu_torch.mixture import MixtureSource, MixtureSpec
        kwargs['mixture'] = MixtureSpec([MixtureSource('ids', 1, url=url)], seq_len=8,
                                        token_field='id')
        url = None
    with pytest.raises(NotImplementedError, match='ROADMAP.md: Queue 1 item %d,' % item):
        make_torch_loader(url, batch_size=4, device='cpu', **kwargs)


def test_reader_factory_replaces_make_batch_reader(scalar_dataset, jax_staging_off):
    from petastorm_tpu.reader import make_batch_reader as jax_reader
    from petastorm_tpu_torch.reader import make_batch_reader as torch_reader
    calls = []

    def factory(maker):
        def make(url, **kwargs):
            calls.append(sorted(kwargs))
            return maker(url, reader_pool_type='dummy', **kwargs)
        return make

    kw = dict(batch_size=16, last_batch='short', fields=['^id$', '^float64$'], seed=3,
              shuffle_row_groups=True)
    with make_jax_loader(scalar_dataset.url, reader_factory=factory(jax_reader), **kw) as loader:
        want = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    with make_torch_loader(scalar_dataset.url, device='cpu',
                           reader_factory=factory(torch_reader), **kw) as loader:
        got = [{k: v.numpy() for k, v in b.items()} for b in loader]
    _assert_same_batches(want, got)
    # called as make_batch_reader is, and with no fused-decode hand-shake
    assert calls == [['num_epochs', 'schema_fields', 'shuffle_row_groups']] * 2


def test_reader_factory_must_give_a_batched_reader(scalar_dataset):
    stopped = []

    class RowReader:
        batched_output = False

        def stop(self):
            stopped.append('stop')

        def join(self):
            stopped.append('join')

    with pytest.raises(ValueError, match='batched reader'):
        make_torch_loader(scalar_dataset.url, batch_size=4, device='cpu',
                          reader_factory=lambda url, **kw: RowReader())
    assert stopped == ['stop', 'join']


def test_string_field_refused_with_reason(scalar_dataset):
    with make_torch_loader(scalar_dataset.url, batch_size=4, device='cpu',
                           fields=['^string$']) as loader:
        with pytest.raises(TypeError, match='strings'):
            next(iter(loader))


# -- the pinned-slot ring, with unpinned slots and a fake completion event ---


class _FakeEvent:
    def __init__(self, log, index):
        self.log, self.index, self.synchronized = log, index, False

    def synchronize(self):
        self.synchronized = True
        self.log.append(self.index)


class _FakeTarget:
    """Stands in for :class:`staging.CudaTarget`: a copy is a clone, the
    completion event records when the ring waits on it."""

    pin_memory = False

    def __init__(self):
        self.events, self.waits, self.delivered = [], [], 0

    def transfer(self, host, device_casts):
        out = {k: (v.clone().to(device_casts[k]) if k in device_casts else v.clone())
               for k, v in host.items()}
        event = _FakeEvent(self.waits, len(self.events))
        self.events.append(event)
        return out, event

    def deliver(self, tensors, event):
        self.delivered += 1
        return tensors


def test_ring_recycles_a_slot_only_after_its_previous_handoff():
    target = _FakeTarget()
    engine = staging.StagingEngine(4, {'x': np.float32}, 'pad', target, num_slots=2)
    held = []
    for i in range(6):
        part = {'x': np.arange(3, dtype=np.float64) + 10 * i, 'y': np.full(3, i)}
        held.append(engine.stage([part], 3).deliver())
        # refilling the slot of batch i waits on batch i-2's event, never on
        # the batch just handed over
        assert target.waits == list(range(max(0, i - 1)))
    assert engine.slabs_allocated == 2
    assert target.delivered == 6
    for i, batch in enumerate(held):
        assert batch['x'].dtype == torch.float32
        assert batch['x'].tolist() == [10. * i, 10. * i + 1, 10. * i + 2, 0.]
        assert batch['y'].tolist() == [i, i, i, 0]
        assert batch[MASK_FIELD].tolist() == [True, True, True, False]


def test_ring_assembles_parts_and_short_tails():
    target = _FakeTarget()
    engine = staging.StagingEngine(5, None, 'short', target)
    parts = [{'x': np.arange(2)}, {'x': np.arange(2, 5)}]
    assert engine.stage(parts, 5).deliver()['x'].tolist() == [0, 1, 2, 3, 4]
    tail = engine.stage([{'x': np.arange(7, 9)}], 2).deliver()
    assert tail['x'].tolist() == [7, 8]
    # a tail reuses the full-size ring: same signature, no new slots
    assert engine.slabs_allocated == 2
    with pytest.raises(ValueError, match='does not fit'):
        engine.stage([{'x': np.zeros((2, 3))}, {'x': np.zeros((3, 2))}], 5)
