"""petastorm_tpu_torch.mixture against petastorm_tpu.mixture, on the CPU.

The same seeds, weights, documents and corpora go through both packages'
interleave schedule, sequence packer, mixture stream, batch adapter and
loader, and every comparison is exact: source orders and JSON states are
equal, packed rows are equal byte for byte (int32 on both sides), and a
state saved by either package resumes in the other to the same
remainder. The N→M reshard oracle (after ``tests/test_mixture.py``) holds
for 2→3, 3→2 and 2→1 with the port's ``merge_mixture_states``, whose
merged state equals the JAX function's.
"""

import json

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import petastorm_tpu.mixture as jm
import petastorm_tpu_torch.mixture as tm
from petastorm_tpu.jax import make_jax_loader
from petastorm_tpu_torch.device.loader import make_torch_loader
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

ROW_COLS = ('tokens', 'loss_mask', 'segment_ids')
WEIGHT_SETS = [[3, 1], [1, 1, 1], [5, 2, 3], [0.7, 0.2, 0.1], [0.3, 0.3, 0.4]]


@pytest.fixture(scope='module')
def mix_datasets(tmp_path_factory):
    """Three plain-Parquet token corpora (list<int64> ``tokens``) of
    different sizes and lengths, as ``tests/test_mixture.py`` writes them."""
    root = tmp_path_factory.mktemp('torch_mixture')
    urls = {}
    for name, num_files, seed in [('a', 3, 1), ('b', 2, 2), ('c', 2, 3)]:
        d = root / name
        d.mkdir()
        rng = np.random.RandomState(seed)
        row = 0
        for f in range(num_files):
            tokens = [rng.randint(1, 1000, size=rng.randint(1, 50)).tolist()
                      for _ in range(10)]
            pq.write_table(pa.table({'row_id': np.arange(row, row + 10), 'tokens': tokens}),
                           str(d / ('part-%d.parquet' % f)), row_group_size=5)
            row += 10
        urls[name] = 'file://' + str(d)
    return urls


def _spec(pkg, urls, sources=('a', 'b'), weights=(3, 1), seed=11, seq_len=64, **kw):
    return pkg.MixtureSpec([pkg.MixtureSource(n, w, url=urls[n])
                            for n, w in zip(sources, weights)],
                           seed=seed, seq_len=seq_len, **kw)


def _drain(stream):
    try:
        return list(stream)
    finally:
        stream.stop()
        stream.join()


def _assert_rows_equal(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        for key in a:
            if key == 'source':
                assert a[key] == b[key]
            else:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _json(state):
    return json.loads(json.dumps(state))


# -- interleave schedule -----------------------------------------------------


@pytest.mark.parametrize('seed', [0, 7, 13])
@pytest.mark.parametrize('weights', WEIGHT_SETS, ids=str)
def test_schedule_order_and_state_match(weights, seed):
    want = jm.InterleaveSchedule(weights, seed=seed)
    got = tm.InterleaveSchedule(weights, seed=seed)
    assert got.fractions == want.fractions
    assert got.peek(9) == want.peek(9)
    assert [got.next() for _ in range(37)] == [want.next() for _ in range(37)]
    assert got.state_dict() == want.state_dict()
    assert [got.source_at(p) for p in (0, 5, 36, 80)] == \
        [want.source_at(p) for p in (0, 5, 36, 80)]
    order = tm.InterleaveSchedule.order(weights, seed, 20, 200)
    assert order == jm.InterleaveSchedule.order(weights, seed, 20, 200)
    assert tm.realized_deviation(order, weights) == jm.realized_deviation(order, weights)
    got.reset()
    want.reset()
    assert got.state_dict() == want.state_dict()


@pytest.mark.parametrize('direction', ['jax-to-torch', 'torch-to-jax'])
def test_schedule_state_continues_across_packages(direction):
    weights, seed = [5, 2, 3], 3
    first, second = (jm, tm) if direction == 'jax-to-torch' else (tm, jm)
    sched = first.InterleaveSchedule(weights, seed=seed)
    head = [sched.next() for _ in range(23)]
    resumed = second.InterleaveSchedule.from_state(weights, seed, _json(sched.state_dict()))
    tail = [resumed.next() for _ in range(40)]
    assert head + tail == jm.InterleaveSchedule.order(weights, seed, 0, 63)


@pytest.mark.parametrize('bad', [[], [1, 0], [-1, 2]], ids=['empty', 'zero', 'negative'])
def test_schedule_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError) as want:
        jm.InterleaveSchedule(bad)
    with pytest.raises(ValueError) as got:
        tm.InterleaveSchedule(bad)
    assert str(got.value) == str(want.value)


# -- spec ----------------------------------------------------------------------


@pytest.mark.parametrize('kw', [
    dict(),
    dict(weights=(0.75, 0.25), seed=3),
    dict(sources=('a', 'b', 'c'), weights=(5, 2, 3), seq_len=None),
    dict(seq_len=1025, token_field='tokens', open_bins=2, pad_id=7),
], ids=['default', 'float-weights', 'raw-documents', 'flagship-row'])
def test_fingerprint_matches_jax(mix_datasets, kw):
    want = _spec(jm, mix_datasets, **kw)
    got = _spec(tm, mix_datasets, **kw)
    assert got.fingerprint() == want.fingerprint()
    assert (got.names, got.weights, got.seed, got.seq_len, got.token_field) == \
        (want.names, want.weights, want.seed, want.seq_len, want.token_field)


@pytest.mark.parametrize('case', ['no-name', 'zero-weight', 'url-and-factory', 'neither',
                                  'no-sources', 'duplicate', 'bad-seq-len', 'not-a-source'])
def test_spec_rejects_what_jax_rejects(case):
    def build(pkg):
        source = pkg.MixtureSource
        calls = {
            'no-name': lambda: source('', 1, url='file:///x'),
            'zero-weight': lambda: source('a', 0, url='file:///x'),
            'url-and-factory': lambda: source('a', 1, url='file:///x', reader_factory=object),
            'neither': lambda: source('a', 1),
            'no-sources': lambda: pkg.MixtureSpec([]),
            'duplicate': lambda: pkg.MixtureSpec([source('a', 1, url='file:///x')] * 2),
            'bad-seq-len': lambda: pkg.MixtureSpec([source('a', 1, url='file:///x')],
                                                   seq_len=0),
            'not-a-source': lambda: pkg.MixtureSpec(['a']),
        }
        return calls[case]()

    with pytest.raises((ValueError, TypeError)) as want:
        build(jm)
    with pytest.raises((ValueError, TypeError)) as got:
        build(tm)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


# -- packer --------------------------------------------------------------------


def _documents(seed, n=60, max_len=90):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, 1000, size=rng.randint(1, max_len)) for _ in range(n)]


def _pack_all(packer, docs):
    rows = []
    for doc in docs:
        rows.extend(packer.feed(doc))
    return rows


@pytest.mark.parametrize('seq_len,open_bins,seed', [(64, 4, 0), (33, 1, 1), (128, 2, 2),
                                                    (17, 8, 3)])
def test_packer_rows_match_byte_for_byte(seq_len, open_bins, seed):
    docs = _documents(seed)
    want_packer = jm.SequencePacker(seq_len, open_bins=open_bins, pad_id=5)
    got_packer = tm.SequencePacker(seq_len, open_bins=open_bins, pad_id=5)
    want = _pack_all(want_packer, docs)
    got = _pack_all(got_packer, docs)
    assert got_packer.state_dict() == want_packer.state_dict()
    want += want_packer.flush()
    got += got_packer.flush()
    _assert_rows_equal(want, got)
    for a, b in zip(want, got):
        for key in ROW_COLS:
            assert a[key].tobytes() == b[key].tobytes()
    assert got_packer.stats == want_packer.stats
    assert got_packer.state_dict() == want_packer.state_dict()


@pytest.mark.parametrize('direction', ['jax-to-torch', 'torch-to-jax'])
def test_packer_state_continues_across_packages(direction):
    docs = _documents(4, n=80)
    oracle = jm.SequencePacker(48, open_bins=3)
    want = _pack_all(oracle, docs) + oracle.flush()
    first, second = (jm, tm) if direction == 'jax-to-torch' else (tm, jm)
    head_packer = first.SequencePacker(48, open_bins=3)
    head = _pack_all(head_packer, docs[:31])
    tail_packer = second.SequencePacker(48, open_bins=3)
    tail_packer.load_state_dict(_json(head_packer.state_dict()))
    tail = _pack_all(tail_packer, docs[31:]) + tail_packer.flush()
    _assert_rows_equal(want, head + tail)
    assert tail_packer.stats == oracle.stats


def test_packer_open_bins_knob(monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_MIXTURE_OPEN_BINS', '2')
    docs = _documents(5)
    want_packer, got_packer = jm.SequencePacker(40), tm.SequencePacker(40)
    want, got = _pack_all(want_packer, docs), _pack_all(got_packer, docs)
    _assert_rows_equal(want, got)
    assert got_packer.stats['open_bins'] <= 2
    assert got_packer.stats == want_packer.stats


def test_packer_rejects_what_jax_rejects():
    for pkg_call in (lambda p: p.SequencePacker(0), lambda p: p.SequencePacker(8, open_bins=0)):
        with pytest.raises(ValueError) as want:
            pkg_call(jm)
        with pytest.raises(ValueError) as got:
            pkg_call(tm)
        assert str(got.value) == str(want.value)
    packer = tm.SequencePacker(8)
    with pytest.raises(ValueError, match='seq_len'):
        packer.load_state_dict(dict(jm.SequencePacker(9).state_dict()))


def test_pack_span_and_counters_count_the_packers_work():
    from petastorm_tpu_torch.mixture import packing
    from petastorm_tpu_torch.telemetry import get_registry, reset_registry
    reset_registry()
    try:
        packer = tm.SequencePacker(50, open_bins=2)
        _pack_all(packer, _documents(6))
        packer.flush()
        counters = get_registry().snapshot()['counters']
    finally:
        reset_registry()
    stats = packer.stats
    assert counters[packing.PACK_ROWS] == stats['rows']
    assert counters[packing.PACK_TOKENS] == stats['tokens']
    assert counters[packing.PACK_PADDING_TOKENS] == stats['padding_tokens']
    assert counters[packing.PACK_SPLIT_DOCS] == stats['split_docs'] > 0
    # one span per fed document and one for the flush
    assert counters['petastorm_tpu_stage_calls_total{stage="pack"}'] == stats['docs'] + 1


# -- stream --------------------------------------------------------------------


STREAM_CASES = {
    'two-sources': dict(),
    'three-sources': dict(sources=('a', 'b', 'c'), weights=(5, 2, 3), seed=4, seq_len=40),
    'raw-documents': dict(sources=('a', 'c'), weights=(1, 1), seq_len=None),
    'one-open-bin': dict(seq_len=24, open_bins=1),
}


@pytest.mark.parametrize('case', sorted(STREAM_CASES))
def test_stream_rows_match_jax(mix_datasets, case):
    kw = STREAM_CASES[case]
    want_stream = jm.MixtureStream(_spec(jm, mix_datasets, **kw), reader_pool_type='dummy')
    got_stream = tm.MixtureStream(_spec(tm, mix_datasets, **kw), reader_pool_type='dummy')
    want, got = _drain(want_stream), _drain(got_stream)
    assert len(got) > 3
    _assert_rows_equal(want, got)
    assert got_stream.pack_stats == want_stream.pack_stats
    assert got_stream.source_doc_counts == want_stream.source_doc_counts
    assert got_stream.diagnostics == want_stream.diagnostics
    assert _json(got_stream.state_dict()) == _json(want_stream.state_dict())


def test_thread_pool_stream_matches_jax_dummy_pool(mix_datasets):
    want = _drain(jm.MixtureStream(_spec(jm, mix_datasets, seed=21), reader_pool_type='dummy'))
    got = _drain(tm.MixtureStream(_spec(tm, mix_datasets, seed=21), reader_pool_type='thread',
                                  workers_count=3))
    _assert_rows_equal(want, got)


def test_reset_replays_the_stream(mix_datasets):
    """Reset is valid once every source drained (a one-source mixture
    here; with more, the first source to run dry ends the stream while
    the others are mid-epoch, and their readers refuse a reset, as the
    JAX stream's do)."""
    spec_kw = dict(sources=('b',), weights=(1,))
    want = _drain(jm.MixtureStream(_spec(jm, mix_datasets, **spec_kw),
                                   reader_pool_type='dummy'))
    stream = tm.MixtureStream(_spec(tm, mix_datasets, **spec_kw), reader_pool_type='dummy')
    try:
        first = list(stream)
        stream.reset()
        second = list(stream)
    finally:
        stream.stop()
        stream.join()
    _assert_rows_equal(want, first)
    # the readers' reset advances their seed, so the sweep reshuffles: the
    # same documents packed in another order
    assert sorted(np.concatenate([r['tokens'] for r in first]).tolist()) == \
        sorted(np.concatenate([r['tokens'] for r in second]).tolist())


def test_source_readers_get_seeds_and_interleave_shares(mix_datasets, monkeypatch):
    spec = _spec(tm, mix_datasets, sources=('a', 'b', 'c'), weights=(5, 2, 3), seed=9)
    readers = tm.build_source_readers(spec, reader_pool_type='dummy')
    try:
        shares = jm.InterleaveSchedule([5, 2, 3], seed=9).fractions
        for idx, reader in enumerate(readers):
            assert reader.mixture_interleave == {'source': idx, 'sources': 3,
                                                 'share': shares[idx], 'seed': 9}
            assert reader.state_dict()['seed'] == 9 + idx
    finally:
        for reader in readers:
            reader.stop()
            reader.join()
    # on a standing decode daemon each source is its own job, named and
    # weighted as the source, in both packages
    from petastorm_tpu.service import ServiceDaemon as JaxDaemon
    from petastorm_tpu_torch.service import DaemonClientPool, ServiceDaemon
    jobs = {}
    for name, pkg, daemon_class in (('jax', jm, JaxDaemon), ('torch', tm, ServiceDaemon)):
        daemon = daemon_class('tcp://127.0.0.1:0', initial_workers=0, supervise=False)
        daemon.start()
        try:
            monkeypatch.setenv('PETASTORM_TPU_SERVICE_DAEMON', daemon.endpoint)
            readers = pkg.build_source_readers(
                _spec(pkg, mix_datasets, sources=('a', 'b', 'c'), weights=(5, 2, 3), seed=9),
                reader_pool_type='service')
            try:
                if name == 'torch':
                    assert all(isinstance(r._pool, DaemonClientPool) for r in readers)
                jobs[name] = sorted((q['name'], q['weight'])
                                    for q in daemon.dispatcher.health()['qos'])
            finally:
                for reader in readers:
                    reader.stop()
                    reader.join()
        finally:
            monkeypatch.delenv('PETASTORM_TPU_SERVICE_DAEMON')
            daemon.stop()
    assert jobs['torch'] == jobs['jax'] == [('a', 5.0), ('b', 2.0), ('c', 3.0)]


# -- resume and reshard ----------------------------------------------------------


@pytest.mark.parametrize('direction', ['jax-to-torch', 'torch-to-jax'])
def test_mid_stream_state_resumes_in_the_other_package(mix_datasets, direction):
    oracle = _drain(jm.MixtureStream(_spec(jm, mix_datasets), reader_pool_type='dummy'))
    first, second = (jm, tm) if direction == 'jax-to-torch' else (tm, jm)
    for cut in (1, len(oracle) // 2, len(oracle) - 2):
        head_stream = first.MixtureStream(_spec(first, mix_datasets),
                                          reader_pool_type='thread', workers_count=3)
        head = [next(head_stream) for _ in range(cut)]
        state = _json(head_stream.state_dict())
        head_stream.stop()
        head_stream.join()
        tail_stream = second.MixtureStream(_spec(second, mix_datasets),
                                           reader_pool_type='dummy')
        tail_stream.load_state_dict(state)
        _assert_rows_equal(oracle, head + _drain(tail_stream))


@pytest.mark.parametrize('n_from,n_to,steps', [(2, 3, 3), (3, 2, 2), (2, 1, 4)])
def test_reshard_oracle_bit_identical(mix_datasets, n_from, n_to, steps):
    """N shard states merged by the port and restored on M port consumers
    stitch back into the JAX package's uninterrupted global stream; the
    merged state equals the JAX merge of the same states."""
    oracle = _drain(jm.MixtureStream(_spec(jm, mix_datasets), reader_pool_type='dummy'))
    states, pre = [], {}
    for r in range(n_from):
        s = tm.MixtureStream(_spec(tm, mix_datasets), reader_pool_type='thread',
                             workers_count=2, cur_shard=r, shard_count=n_from)
        pre[r] = [next(s) for _ in range(steps)]
        states.append(_json(s.state_dict()))
        s.stop()
        s.join()
    merged = tm.merge_mixture_states(states)
    assert _json(merged) == _json(jm.merge_mixture_states(states))
    resume = merged['resume_ordinal']
    stitched = [None] * len(oracle)
    for r in range(n_from):
        for i, row in enumerate(pre[r]):
            stitched[r + i * n_from] = row
    for r in range(n_to):
        s = tm.MixtureStream(_spec(tm, mix_datasets), reader_pool_type='thread',
                             workers_count=2, cur_shard=r, shard_count=n_to)
        s.load_state_dict(_json(merged))
        post = _drain(s)
        ordinals = [o for o in range(resume, len(oracle)) if o % n_to == r]
        assert len(ordinals) == len(post)
        for o, row in zip(ordinals, post):
            stitched[o] = row
    assert all(x is not None for x in stitched)
    _assert_rows_equal(oracle, stitched)


def test_merge_rejects_what_jax_rejects(mix_datasets):
    s = tm.MixtureStream(_spec(tm, mix_datasets), reader_pool_type='dummy',
                         cur_shard=0, shard_count=2)
    next(s)
    state = _json(s.state_dict())
    s.stop()
    s.join()
    for bad in ([], [state, dict(state, mixture='0' * 16)],
                [state, dict(state, shard_count=3)], [state]):
        with pytest.raises(ValueError) as want:
            jm.merge_mixture_states(bad)
        with pytest.raises(ValueError) as got:
            tm.merge_mixture_states(bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize('saver', ['jax', 'torch'])
def test_fingerprint_guard_refuses_a_changed_spec(mix_datasets, saver):
    pkg = jm if saver == 'jax' else tm
    s = pkg.MixtureStream(_spec(pkg, mix_datasets), reader_pool_type='dummy')
    next(s)
    state = _json(s.state_dict())
    s.stop()
    s.join()
    for changed in (dict(weights=(1, 1)), dict(seed=12), dict(seq_len=65)):
        t = tm.MixtureStream(_spec(tm, mix_datasets, **changed), reader_pool_type='dummy')
        try:
            with pytest.raises(ValueError, match='fingerprint'):
                t.load_state_dict(state)
        finally:
            t.stop()
            t.join()


# -- adapter and loader --------------------------------------------------------


def test_adapter_pulls_and_states_match_jax(mix_datasets):
    want = jm.MixtureBatchReader(jm.MixtureStream(_spec(jm, mix_datasets),
                                                  reader_pool_type='dummy'), rows_per_pull=3)
    got = tm.MixtureBatchReader(tm.MixtureStream(_spec(tm, mix_datasets),
                                                 reader_pool_type='dummy'), rows_per_pull=3)
    try:
        for _ in range(4):
            (a, pull_a, epoch_a), (b, pull_b, epoch_b) = want.next_batch_info(), \
                got.next_batch_info()
            assert (pull_a, epoch_a) == (pull_b, epoch_b)
            _assert_rows_equal([a], [b])
        assert _json(got.state_dict()) == _json(want.state_dict())
        delivered = {0: {0, 1}}
        assert _json(got.resume_state_from(delivered)) == \
            _json(want.resume_state_from(delivered))
        assert got.consumption_record_for_resume({'pull_base': 3}) == \
            want.consumption_record_for_resume({'pull_base': 3})
        assert sorted(got.schema.fields) == sorted(want.schema.fields)
        assert (got.batched_output, got.ngram, got.num_epochs) == (True, None, 1)
    finally:
        for reader in (want, got):
            reader.stop()
            reader.join()
    stream = tm.MixtureStream(_spec(tm, mix_datasets, seq_len=None), reader_pool_type='dummy')
    try:
        with pytest.raises(ValueError, match='seq_len'):
            tm.MixtureBatchReader(stream)
    finally:
        stream.stop()
        stream.join()


def _jax_loader(spec, **kw):
    return make_jax_loader(None, mixture=spec, reader_pool_type='dummy', **kw)


def _torch_loader(spec, **kw):
    return make_torch_loader(None, mixture=spec, reader_pool_type='dummy', device='cpu', **kw)


def _numpy(batches):
    return [{k: np.asarray(v) for k, v in b.items()} for b in batches]


LOADER_CASES = {
    'drop': dict(batch_size=4),
    'short': dict(batch_size=5, last_batch='short'),
    'pad': dict(batch_size=3, last_batch='pad'),
    'two-epochs': dict(batch_size=4, num_epochs=2),
}


@pytest.mark.parametrize('case', sorted(LOADER_CASES))
def test_loader_batches_match_jax(mix_datasets, case):
    kw = LOADER_CASES[case]
    with _jax_loader(_spec(jm, mix_datasets, seq_len=48), **kw) as loader:
        want = _numpy(loader)
    with _torch_loader(_spec(tm, mix_datasets, seq_len=48), **kw) as loader:
        batches = list(loader)
    assert {v.device.type for b in batches for v in b.values()} == {'cpu'}
    got = [{k: v.numpy() for k, v in b.items()} for b in batches]
    assert len(got) == len(want) > 1
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        for key in a:
            assert b[key].dtype == a[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert got[0]['tokens'].shape == (kw['batch_size'], 48)


@pytest.mark.parametrize('direction', ['jax-to-torch', 'torch-to-jax'])
def test_loader_state_resumes_in_the_other_package(mix_datasets, direction):
    spec_kw = dict(sources=('a', 'b', 'c'), weights=(5, 2, 3), seq_len=32)
    with _jax_loader(_spec(jm, mix_datasets, **spec_kw), batch_size=3) as loader:
        oracle = _numpy(loader)
    cut = len(oracle) // 2
    if direction == 'jax-to-torch':
        with _jax_loader(_spec(jm, mix_datasets, **spec_kw), batch_size=3) as loader:
            head = _numpy(b for _, b in zip(range(cut), loader))
            state = _json(loader.state_dict())
        with _torch_loader(_spec(tm, mix_datasets, **spec_kw), batch_size=3) as loader:
            loader.load_state_dict(state)
            tail = _numpy(loader)
    else:
        with _torch_loader(_spec(tm, mix_datasets, **spec_kw), batch_size=3) as loader:
            head = _numpy(b for _, b in zip(range(cut), loader))
            state = _json(loader.state_dict())
        with _jax_loader(_spec(jm, mix_datasets, **spec_kw), batch_size=3) as loader:
            loader.load_state_dict(state)
            tail = _numpy(loader)
    assert state['pull_base'] == cut
    got = head + tail
    assert len(got) == len(oracle)
    for a, b in zip(oracle, got):
        for key in ROW_COLS:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize('case', ['url', 'reader-factory', 'fields', 'inmemory'])
def test_loader_value_errors_match_jax(mix_datasets, case):
    def build(make, pkg):
        spec = _spec(pkg, mix_datasets)
        kwargs = {
            'url': dict(dataset_url_or_urls=mix_datasets['a']),
            'reader-factory': dict(reader_factory=lambda *a, **k: None),
            'fields': dict(fields=['^tokens$']),
            'inmemory': dict(inmemory_cache_all=True),
        }[case]
        url = kwargs.pop('dataset_url_or_urls', None)
        return make(url, batch_size=2, mixture=spec, **kwargs)

    with pytest.raises(ValueError) as want:
        build(make_jax_loader, jm)
    with pytest.raises(ValueError) as got:
        build(lambda *a, **k: make_torch_loader(*a, device='cpu', **k), tm)
    assert str(got.value) == str(want.value)


def test_loader_defaults_to_the_card(mix_datasets):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: device=None would run there')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make_torch_loader(None, batch_size=2, mixture=_spec(tm, mix_datasets))


def test_reader_keeps_a_validated_mixture_interleave(mix_datasets):
    from petastorm_tpu.reader import make_batch_reader as jax_reader
    from petastorm_tpu_torch.reader import make_batch_reader as torch_reader
    share = {'source': 1, 'sources': 2, 'share': 0.25, 'seed': 0}
    with torch_reader(mix_datasets['a'], reader_pool_type='dummy',
                      mixture_interleave=share) as reader:
        assert reader.mixture_interleave == share
        rows = sum(len(b.tokens) for b in reader)
    with torch_reader(mix_datasets['a'], reader_pool_type='dummy') as reader:
        assert reader.mixture_interleave is None
        assert sum(len(b.tokens) for b in reader) == rows == 30
    bad = dict(share, share=1.5)
    with pytest.raises(ValueError) as want:
        jax_reader(mix_datasets['a'], reader_pool_type='dummy', mixture_interleave=bad)
    with pytest.raises(ValueError) as got:
        torch_reader(mix_datasets['a'], reader_pool_type='dummy', mixture_interleave=bad)
    assert str(got.value) == str(want.value)
