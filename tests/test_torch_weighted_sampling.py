"""petastorm_tpu_torch.weighted_sampling_reader against the JAX package's
``WeightedSamplingReader``, on the CPU.

Both mixes run over their package's batch readers of the same datasets
(dummy pool, in order, repeating epochs), so each draw is a row-group
batch whose ``id`` column tells which source and where. With the same
seed and probabilities both draw the same sequence, in random and in
deterministic (interleave-schedule) mode, and a state saved by either
mix restores in the other to the same continuation. Every comparison is
exact.
"""

import json

import numpy as np
import pytest

from petastorm_tpu.reader import make_batch_reader as jax_reader
from petastorm_tpu.weighted_sampling_reader import WeightedSamplingReader as JaxMix
from petastorm_tpu_torch.reader import make_batch_reader as torch_reader
from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader as TorchMix


@pytest.fixture(scope='module')
def id_datasets(tmp_path_factory):
    """Two plain-Parquet datasets with disjoint ids (0-39 and 100-129),
    row-groups of 5 rows."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    root = tmp_path_factory.mktemp('weighted')
    urls = []
    for name, start, n in (('a', 0, 40), ('b', 100, 30)):
        (root / name).mkdir()
        ids = np.arange(start, start + n, dtype=np.int64)
        pq.write_table(pa.table({'id': ids, 'x': ids.astype(np.float64) / 2}),
                       str(root / name / 'part-0.parquet'), row_group_size=5)
        urls.append('file://' + str(root / name))
    return urls


def _readers(make, urls, num_epochs=None, **kw):
    return [make(url, reader_pool_type='dummy', shuffle_row_groups=False,
                 num_epochs=num_epochs, **kw) for url in urls]


def _close(mix):
    mix.stop()
    mix.join()


def _draws(mix, n):
    return [np.asarray(next(mix).id).tolist() for _ in range(n)]


MIXES = {
    'random-seed0': dict(probabilities=[0.8, 0.2], seed=0),
    'random-seed42': dict(probabilities=[0.5, 0.5], seed=42),
    'random-weights': dict(probabilities=[3, 1], seed=7),
    'deterministic': dict(probabilities=[3, 1], seed=5, deterministic=True),
    'deterministic-default-seed': dict(probabilities=[1, 2], deterministic=True),
}


@pytest.mark.parametrize('case', sorted(MIXES))
def test_draws_match_jax(id_datasets, case):
    kw = dict(MIXES[case])
    probabilities = kw.pop('probabilities')
    want = JaxMix(_readers(jax_reader, id_datasets), probabilities, **kw)
    got = TorchMix(_readers(torch_reader, id_datasets), probabilities, **kw)
    try:
        assert _draws(got, 60) == _draws(want, 60)
        got_state, want_state = (json.loads(json.dumps(m.state_dict())) for m in (got, want))
        if kw.get('seed') is None:
            # seed=None: both generators are seeded from the OS, and the
            # deterministic mix never draws from them
            del got_state['rng_state'], want_state['rng_state']
        assert got_state == want_state
    finally:
        _close(want)
        _close(got)


@pytest.mark.parametrize('deterministic', [False, True], ids=['random', 'deterministic'])
@pytest.mark.parametrize('direction', ['torch-to-torch', 'torch-to-jax', 'jax-to-torch'])
def test_state_round_trips(id_datasets, direction, deterministic):
    """A mix checkpointed after 17 draws and restored in a fresh mix (of
    either package) continues the uninterrupted sequence. The sources are
    restored at row-group granularity, and every draw is a whole row-group,
    so the continuation is exact."""
    kw = dict(seed=3, deterministic=deterministic)
    oracle = JaxMix(_readers(jax_reader, id_datasets), [0.6, 0.4], **kw)
    try:
        want = _draws(oracle, 40)
    finally:
        _close(oracle)
    first, second = {'torch-to-torch': ((torch_reader, TorchMix), (torch_reader, TorchMix)),
                     'torch-to-jax': ((torch_reader, TorchMix), (jax_reader, JaxMix)),
                     'jax-to-torch': ((jax_reader, JaxMix), (torch_reader, TorchMix))}[direction]
    mix = first[1](_readers(first[0], id_datasets), [0.6, 0.4], **kw)
    try:
        head = _draws(mix, 17)
        state = json.loads(json.dumps(mix.state_dict()))
    finally:
        _close(mix)
    resumed = second[1](_readers(second[0], id_datasets), [0.6, 0.4], **kw)
    try:
        resumed.load_state_dict(state)
        tail = _draws(resumed, 23)
    finally:
        _close(resumed)
    assert head + tail == want


def test_legacy_draws_state_replays(id_datasets):
    """A state without ``rng_state`` (seed and draw count only) replays
    the generator; a deterministic mix takes the draw count as its cursor."""
    for deterministic in (False, True):
        mix = TorchMix(_readers(torch_reader, id_datasets), [0.7, 0.3], seed=9,
                       deterministic=deterministic)
        try:
            head = _draws(mix, 11)
            state = json.loads(json.dumps(mix.state_dict()))
            want = _draws(mix, 9)
        finally:
            _close(mix)
        state.pop('rng_state')
        state.pop('interleave', None)
        resumed = TorchMix(_readers(torch_reader, id_datasets), [0.7, 0.3], seed=9,
                           deterministic=deterministic)
        try:
            resumed.load_state_dict(state)
            assert len(head) == 11 and _draws(resumed, 9) == want
        finally:
            _close(resumed)


def test_exhaustion_ends_the_mix_without_charging_a_draw(id_datasets):
    """Finite sources: the first to run dry ends the mix, and the failed
    draw is not counted, in either package."""
    results = []
    for make, mix_cls in ((jax_reader, JaxMix), (torch_reader, TorchMix)):
        mix = mix_cls(_readers(make, id_datasets, num_epochs=1), [0.5, 0.5], seed=1)
        try:
            draws = [np.asarray(b.id).tolist() for b in mix]
            results.append((draws, mix.state_dict()['draws'], mix.last_row_consumed))
        finally:
            _close(mix)
    assert results[1] == results[0]
    assert results[1][1] == len(results[1][0]) and results[1][2]


def test_reset_restarts_the_dry_sources(id_datasets):
    with TorchMix(_readers(torch_reader, id_datasets, num_epochs=1), [0.5, 0.5],
                  seed=1) as mix:
        first = [np.asarray(b.id).tolist() for b in mix]
        mix.reset()
        assert not mix.last_row_consumed
        second = _draws(mix, 3)
    assert first and all(len(d) == 5 for d in second)


@pytest.mark.parametrize('case', ['lengths', 'empty', 'negative', 'zero-sum', 'schema'])
def test_rejects_what_jax_rejects(id_datasets, case):
    def build(make, mix_cls):
        readers = _readers(make, id_datasets)
        if case == 'schema':
            readers[1].stop()
            readers[1] = make(id_datasets[1], reader_pool_type='dummy', schema_fields=['^id$'])
        args = {'lengths': (readers, [1.0]), 'empty': ([], []),
                'negative': (readers, [1.0, -1.0]), 'zero-sum': (readers, [0.0, 0.0]),
                'schema': (readers, [0.5, 0.5])}[case]
        try:
            return mix_cls(*args)
        finally:
            for reader in readers:
                reader.stop()
                reader.join()

    with pytest.raises(ValueError) as want:
        build(jax_reader, JaxMix)
    with pytest.raises(ValueError) as got:
        build(torch_reader, TorchMix)
    assert str(got.value) == str(want.value)


def test_passes_the_readers_surface_through(id_datasets):
    readers = _readers(torch_reader, id_datasets)
    with TorchMix(readers, [0.5, 0.5], seed=0) as mix:
        assert mix.schema is readers[0].schema
        assert mix.batched_output is True
        assert mix.ngram is None
        assert next(mix).id.shape == (5,) and mix.next().id.shape == (5,)
        with pytest.raises(ValueError, match='reader states'):
            mix.load_state_dict({'readers': [{}], 'draws': 0})
