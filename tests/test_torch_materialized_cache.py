"""The port's decoded row-group cache
(``petastorm_tpu_torch/materialized_cache.py``) held against the JAX
package's: the Arrow IPC entry format read across the packages both ways,
zero-copy read-only hits, the memory tier and its eviction, corrupt and
truncated entries, the fingerprints, crash safety under SIGKILL, the end
to end reads (cold and warm epochs, TransformSpecs, the fleet knob) with
the same row multisets and column bytes as the JAX reader, the report's
``decoded_cache`` verdict, and the fleet-tier satellites (placement
markers, the rate-limited LRU touch, eviction racing a reader in another
process). Cache directories live under ``tmp_path``."""

import collections
import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from petastorm_tpu import materialized_cache as jax_mc
from petastorm_tpu import sanitizer as jax_sanitizer
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.arrow_worker import ColumnBatch as JaxColumnBatch
from petastorm_tpu.transform import TransformSpec as JaxTransformSpec
from petastorm_tpu_torch import materialized_cache as mc
from petastorm_tpu_torch import sanitizer
from petastorm_tpu_torch import telemetry
from petastorm_tpu_torch.arrow_worker import ColumnBatch
from petastorm_tpu_torch.cache import MARKER_PREFIX
from petastorm_tpu_torch.transform import TransformSpec

from tests.torch_telemetry_common import telemetry_guard  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGES = {'jax': (jax_mc, JaxColumnBatch, jax_telemetry),
            'torch': (mc, ColumnBatch, telemetry)}
both = pytest.mark.parametrize('package', sorted(PACKAGES))


def _sample_columns(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return {
        'image': rng.randint(0, 256, (n, 8, 8, 3)).astype(np.uint8),
        'ids': np.arange(n, dtype=np.int64) + seed,
        'score': rng.rand(n).astype(np.float32),
        'name': np.array(['row%d' % (i + seed) for i in range(n)]),
        'ragged': np.array([np.arange(i + 1) for i in range(n)] + [None],
                           dtype=object)[:n],
    }


def _cache(package, tmp_path, mem_mb=0, disk_limit=10 ** 8, name='dc'):
    return PACKAGES[package][0].MaterializedRowGroupCache(
        str(tmp_path / name), disk_limit, mem_limit_bytes=mem_mb * 2 ** 20)


def _fill(package, columns, calls=None):
    batch_type = PACKAGES[package][1]

    def fill():
        if calls is not None:
            calls.append(1)
        return batch_type(dict(columns), len(columns['ids']))
    return fill


def _assert_columns_equal(got, want):
    assert sorted(got) == sorted(want)
    for name, col in want.items():
        if col.dtype == object:
            assert len(got[name]) == len(col)
            for a, b in zip(got[name], col):
                np.testing.assert_array_equal(a, b)
        else:
            assert got[name].dtype == col.dtype and got[name].shape == col.shape, name
            assert got[name].tobytes() == col.tobytes(), name


def _counters(tel, prefix='petastorm_tpu_decoded_cache_'):
    return {k: v for k, v in tel.get_registry().snapshot()['counters'].items()
            if k.startswith(prefix)}


# -- the entry format ----------------------------------------------------------


@pytest.mark.parametrize('writer,reader', [('jax', 'torch'), ('torch', 'jax'),
                                           ('torch', 'torch')])
@pytest.mark.parametrize('seed', [0, 5])
def test_entries_read_across_packages(tmp_path, writer, reader, seed):
    cols = _sample_columns(6, seed)
    path = str(tmp_path / 'entry.arrow')
    size = PACKAGES[writer][0].write_entry(path, cols, 6)
    assert size == os.path.getsize(path)
    got, length, mmaped, copied = PACKAGES[reader][0].read_entry(path)
    assert (length, mmaped, copied) == (6, 4, 1)
    _assert_columns_equal(got, cols)
    assert all(not col.flags.writeable for col in got.values() if isinstance(col, np.ndarray))


def test_entry_bytes_are_the_references(tmp_path):
    cols = _sample_columns(5, 2)
    blobs = []
    for package in ('jax', 'torch'):
        path = str(tmp_path / (package + '.arrow'))
        PACKAGES[package][0].write_entry(path, cols, 5)
        with open(path, 'rb') as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1]


def test_unknown_format_version_raises(tmp_path):
    import pyarrow as pa
    path = str(tmp_path / 'e.arrow')
    schema = pa.schema([pa.field('x', pa.large_binary())],
                       metadata={b'petastorm_tpu.version': b'9', b'petastorm_tpu.length': b'1'})
    with pa.OSFile(path, 'wb') as sink:
        with pa.ipc.new_file(sink, schema) as writer:
            writer.write_batch(pa.RecordBatch.from_arrays([pa.array([b'']).cast(
                pa.large_binary())], schema=schema))
    for package in PACKAGES:
        with pytest.raises(ValueError, match='unknown format version'):
            PACKAGES[package][0].read_entry(path)


# -- the round trip ----------------------------------------------------------------


@both
def test_decode_once_then_hit(tmp_path, package):
    cache = _cache(package, tmp_path)
    cols = _sample_columns()
    calls = []
    first = cache.get('k', _fill(package, cols, calls))
    second = cache.get('k', _fill(package, cols, calls))
    assert len(calls) == 1
    assert first.length == second.length == 4
    _assert_columns_equal(second.columns, cols)


def test_hit_is_mmap_backed_not_fresh_allocation(tmp_path):
    cache = _cache('torch', tmp_path)
    cols = _sample_columns()
    cache.get('k', _fill('torch', cols))
    batch = cache.get('k', _fill('torch', cols))
    for name in ('image', 'ids', 'score', 'name'):
        col = batch.columns[name]
        assert not col.flags['OWNDATA'] and not col.flags.writeable, name
        base = col
        while getattr(base, 'base', None) is not None and \
                type(base).__module__.split('.')[0] != 'pyarrow':
            base = base.base
        assert type(base).__module__.split('.')[0] == 'pyarrow', name
    with pytest.raises(ValueError, match='read-only'):
        batch.columns['ids'][0] = 7
    assert telemetry.get_registry().counter_value(mc.DECODED_CACHE_MMAP_READS) == 4


def test_counters_are_the_references(tmp_path):
    """The same gets count the same in both packages' registries."""
    counted = {}
    for package in ('jax', 'torch'):
        cache = _cache(package, tmp_path, mem_mb=1, disk_limit=40_000, name=package)
        for i in (0, 1, 0, 2, 3, 0, 1):
            cache.get('k%d' % i, _fill(package, _sample_columns(40, i)))
        counted[package] = _counters(PACKAGES[package][2])
    assert counted['torch'] == counted['jax']
    assert counted['torch'][mc.DECODED_CACHE_MEM_HITS] == 3


@both
def test_hit_records_no_decode_or_transform_spans(tmp_path, package):
    tel = PACKAGES[package][2]
    cache = _cache(package, tmp_path)
    cols = _sample_columns()
    cache.get('k', _fill(package, cols))
    registry = tel.get_registry()
    base = registry.counter_value('petastorm_tpu_stage_calls_total', stage='cache_hit_read')
    cache.get('k', _fill(package, cols))
    assert registry.counter_value('petastorm_tpu_stage_calls_total', stage='decode') == 0
    assert registry.counter_value('petastorm_tpu_stage_calls_total', stage='transform') == 0
    assert registry.counter_value('petastorm_tpu_stage_calls_total',
                                  stage='cache_hit_read') == base + 1


@both
def test_empty_rowgroup_tombstone(tmp_path, package):
    cache = _cache(package, tmp_path)
    calls = []
    assert cache.get('k', lambda: calls.append(1)) is None
    assert cache.get('k', lambda: calls.append(1)) is None
    assert len(calls) == 1


@both
def test_memory_tier_hit_touches_disk_lru(tmp_path, package):
    cache = _cache(package, tmp_path, mem_mb=64)
    cols = _sample_columns()
    cache.get('k', _fill(package, cols))
    entry = cache._entry_path('k')
    os.utime(entry, (1.0, 1.0))
    cache.get('k', _fill(package, cols))
    assert os.stat(entry).st_atime > 1.0


@both
def test_memory_tier_serves_without_disk(tmp_path, package):
    import shutil
    cache = _cache(package, tmp_path, mem_mb=64)
    cols = _sample_columns()
    cache.get('k', _fill(package, cols))
    shutil.rmtree(str(tmp_path / 'dc'))
    batch = cache.get('k', _fill(package, cols))
    _assert_columns_equal(batch.columns, cols)
    assert PACKAGES[package][2].get_registry().counter_value(mc.DECODED_CACHE_MEM_HITS) == 1


def test_memory_tier_lru_evicts_in_the_references_order(tmp_path):
    """A tier smaller than the working set: the same access sequence
    serves the same gets from memory in both packages (an epoch in
    row-group order over a tier that holds less than the epoch serves
    none from memory)."""
    served = {}
    for package in ('jax', 'torch'):
        cache = _cache(package, tmp_path, name=package)
        cache._mem_limit = 3 * 1000 + 1  # three entries of 1000 bytes
        seen = []
        for key in [0, 1, 2, 3, 0, 1, 2, 3, 3, 2, 1, 0, 3]:
            before = PACKAGES[package][2].get_registry().counter_value(mc.DECODED_CACHE_MEM_HITS)
            cache.get('k%d' % key, _fill(package, {'ids': np.arange(40, dtype=np.int64),
                                                   'x': np.zeros((40, 17), np.uint8)}))
            seen.append(PACKAGES[package][2].get_registry().counter_value(
                mc.DECODED_CACHE_MEM_HITS) - before)
        served[package] = seen
    assert served['torch'] == served['jax']
    assert served['torch'][4:8] == [0, 0, 0, 0]   # row-group order: none from memory
    assert sum(served['torch'][8:]) >= 3


@both
def test_disk_tier_lru_eviction_bounds_size(tmp_path, package):
    cache = PACKAGES[package][0].MaterializedRowGroupCache(str(tmp_path / 'dc'), 200_000,
                                                          mem_limit_bytes=0)
    payload = np.zeros(50_000, dtype=np.uint8)
    for i in range(10):
        cache.get('k%d' % i, _fill(package, {'x': payload, 'ids': np.arange(1)}))
        time.sleep(0.01)
    total = sum(os.path.getsize(os.path.join(root, f))
                for root, _, files in os.walk(str(tmp_path / 'dc')) for f in files)
    assert total <= 200_000
    assert PACKAGES[package][2].get_registry().counter_value(mc.DECODED_CACHE_EVICTIONS) > 0


@both
def test_corrupt_entry_deleted_and_refilled(tmp_path, package):
    cache = _cache(package, tmp_path)
    cols = _sample_columns()
    cache.get('k', _fill(package, cols))
    entry = cache._entry_path('k')
    with open(entry, 'wb') as f:
        f.write(b'not an arrow file')
    batch = cache.get('k', _fill(package, cols))
    np.testing.assert_array_equal(batch.columns['ids'], cols['ids'])
    assert mc.read_entry(entry)[1] == 4
    assert PACKAGES[package][2].get_registry().counter_value(
        mc.DECODED_CACHE_DISK_FAILURES, op='corrupt') == 1


@both
def test_truncated_entry_treated_as_miss(tmp_path, package):
    cache = _cache(package, tmp_path)
    cols = _sample_columns()
    cache.get('k', _fill(package, cols))
    entry = cache._entry_path('k')
    with open(entry, 'rb') as f:
        blob = f.read()
    with open(entry, 'wb') as f:
        f.write(blob[:len(blob) // 2])
    calls = []
    batch = cache.get('k', _fill(package, cols, calls))
    assert len(calls) == 1
    np.testing.assert_array_equal(batch.columns['image'], cols['image'])


@both
def test_pickles_across_process_boundary(tmp_path, package):
    cache = _cache(package, tmp_path, mem_mb=16)
    cols = _sample_columns()
    cache.get('k', _fill(package, cols))
    clone = pickle.loads(pickle.dumps(cache))
    calls = []
    batch = clone.get('k', _fill(package, cols, calls))
    assert not calls
    np.testing.assert_array_equal(batch.columns['ids'], cols['ids'])


@both
def test_reroot_switches_directory(tmp_path, package):
    cache = _cache(package, tmp_path, mem_mb=16)
    cols = _sample_columns()
    cache.get('k', _fill(package, cols))
    cache.reroot(str(tmp_path / 'other'))
    calls = []
    cache.get('k', _fill(package, cols, calls))
    assert len(calls) == 1
    assert cache.path == str(tmp_path / 'other') and os.path.isdir(cache.path)


def test_armed_memory_tier_guards_its_payload(tmp_path, monkeypatch):
    """``PETASTORM_TPU_SANITIZE=1``: the memory tier freezes what it
    shares, counted as guarded views in both packages alike; the fill
    path's batch then raises on an in-place write."""
    monkeypatch.setenv('PETASTORM_TPU_SANITIZE', '1')
    jax_telemetry.refresh()
    telemetry.refresh()
    guarded = {}
    for package, san in (('jax', jax_sanitizer), ('torch', sanitizer)):
        cache = _cache(package, tmp_path, mem_mb=16, name=package)
        cols = {'ids': np.arange(4, dtype=np.int64), 'x': np.ones((4, 3), np.float32)}
        batch = cache.get('k', _fill(package, cols))
        with pytest.raises(ValueError, match='read-only'):
            batch.columns['x'][0, 0] = 5
        cache.get('k', _fill(package, cols))
        guarded[package] = PACKAGES[package][2].get_registry().counter_value(
            san.SANITIZER_VIEWS_GUARDED)
    assert guarded['torch'] == guarded['jax'] > 0


# -- fingerprints: never serve stale decoded rows -----------------------------


def _transform_a(df):
    return df


def _transform_b(df):
    return df.head(1)


def _closure_transform(k):
    def inner(df):
        return df.head(k)
    return inner


def _transform_with_inner_lambda(df):
    return df.assign(id=df['id'].map(lambda x: x + 0))


def _torch_test_schema():
    from petastorm_tpu_torch.unischema import Unischema
    from tests.test_common import TestSchema
    return Unischema.from_json_dict(TestSchema.to_json_dict())


def sample_decode_fingerprint():
    """Shared with the cross-process test: the child prints it and both
    sides must agree (the nested lambda's code object is hashed by its
    bytes, never by its address)."""
    spec = TransformSpec(_transform_with_inner_lambda, removed_fields=['matrix_string'])
    return mc.decode_fingerprint(_torch_test_schema(), spec)


def test_transform_code_change_misses():
    assert mc.transform_fingerprint(TransformSpec(_transform_a)) != \
        mc.transform_fingerprint(TransformSpec(_transform_b))


@pytest.mark.parametrize('func', [_transform_a, _transform_b, _transform_with_inner_lambda,
                                  _closure_transform(2), _closure_transform(3), None])
def test_callable_fingerprint_is_the_references(func):
    assert mc.callable_fingerprint(func) == jax_mc.callable_fingerprint(func)


def test_transform_fingerprint_is_the_references():
    for kwargs in ({}, {'removed_fields': ['x']}, {'selected_fields': ['x']}):
        assert mc.transform_fingerprint(TransformSpec(_transform_a, **kwargs)) == \
            jax_mc.transform_fingerprint(JaxTransformSpec(_transform_a, **kwargs))


def test_transform_closure_change_misses():
    assert mc.callable_fingerprint(_closure_transform(2)) != \
        mc.callable_fingerprint(_closure_transform(3))


def test_transform_schema_edit_change_misses():
    prints = {mc.transform_fingerprint(s) for s in (
        TransformSpec(_transform_a), TransformSpec(_transform_a, removed_fields=['x']),
        TransformSpec(_transform_a, selected_fields=['x']))}
    assert len(prints) == 3


def test_identical_spec_same_fingerprint():
    assert mc.transform_fingerprint(TransformSpec(_transform_a, removed_fields=['x'])) == \
        mc.transform_fingerprint(TransformSpec(_transform_a, removed_fields=['x']))


def test_none_transform_stable():
    assert mc.transform_fingerprint(None) == 'none'


def test_large_ndarray_closure_change_misses():
    base = np.arange(10_000, dtype=np.int64)
    changed = base.copy()
    changed[5_000] += 1

    def closing(table):
        def inner(df):
            return table
        return inner
    assert mc.callable_fingerprint(closing(base)) != mc.callable_fingerprint(closing(changed))
    assert mc.callable_fingerprint(closing(base)) == mc.callable_fingerprint(closing(base.copy()))


def test_nested_lambda_fingerprint_is_process_stable():
    fp = mc.callable_fingerprint(_transform_with_inner_lambda)
    assert '0x' not in fp
    assert fp == mc.callable_fingerprint(_transform_with_inner_lambda)


def test_ngram_shape_change_misses():
    from petastorm_tpu_torch.ngram import NGram
    schema = _torch_test_schema()

    def gram(length):
        return NGram({i: ['id', 'matrix'] for i in range(length)}, delta_threshold=10,
                     timestamp_field='id')
    assert mc.ngram_fingerprint(gram(2)) != mc.ngram_fingerprint(gram(3))
    assert mc.ngram_fingerprint(gram(2)) == mc.ngram_fingerprint(gram(2))
    assert mc.ngram_fingerprint(None) == 'none'
    assert mc.decode_fingerprint(schema, None, gram(2)) != mc.decode_fingerprint(schema, None,
                                                                                 gram(3))


def test_codec_parameter_change_misses():
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    def schema(quality):
        return Unischema('S', [
            UnischemaField('id', np.int32, (), ScalarCodec(np.int32), False),
            UnischemaField('image', np.uint8, (8, 8, 3),
                           CompressedImageCodec('jpeg', quality=quality), False)])
    assert mc.schema_fingerprint(schema(80)) != mc.schema_fingerprint(schema(90))
    assert mc.schema_fingerprint(schema(80)) == mc.schema_fingerprint(schema(80))


def test_column_set_change_misses():
    schema = _torch_test_schema()
    assert mc.schema_fingerprint(schema) != \
        mc.schema_fingerprint(schema.create_schema_view(['id', 'matrix']))


def test_identical_spec_across_processes_hits():
    out = subprocess.run(
        [sys.executable, '-c', 'from tests.test_torch_materialized_cache import '
                               'sample_decode_fingerprint; print(sample_decode_fingerprint())'],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS='cpu'))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == sample_decode_fingerprint()


# -- crash safety ------------------------------------------------------------

_CRASH_WRITER = r'''
import sys
sys.path.insert(0, sys.argv[2])
import numpy as np
from petastorm_tpu_torch.arrow_worker import ColumnBatch
from petastorm_tpu_torch.materialized_cache import MaterializedRowGroupCache
cache = MaterializedRowGroupCache(sys.argv[1], 10**9, mem_limit_bytes=0)
cols = {'x': np.arange(200_000, dtype=np.int64)}
print('ready', flush=True)
i = 0
while True:
    cache.get('key%d' % i, lambda: ColumnBatch(dict(cols), 1))
    i += 1
'''


def test_sigkill_mid_write_never_exposes_partial_entry(tmp_path):
    """A writer killed in a tight fill loop leaves at most tmp files:
    every published entry opens and round-trips in both packages, and a
    fresh cache purges the orphans."""
    cache_dir = str(tmp_path / 'dc')
    proc = subprocess.Popen([sys.executable, '-c', _CRASH_WRITER, cache_dir, REPO],
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == 'ready'
        time.sleep(0.3)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        proc.stdout.close()
    published = [os.path.join(root, f) for root, _, files in os.walk(cache_dir)
                 for f in files if '.tmp.' not in f]
    assert published, 'writer never published an entry'
    for path in published:
        for module in (mc, jax_mc):
            columns, length, _, _ = module.read_entry(path)
            assert length == 1
            np.testing.assert_array_equal(columns['x'], np.arange(200_000, dtype=np.int64))
    mc.MaterializedRowGroupCache(cache_dir, 10 ** 9)
    assert not [f for _, _, files in os.walk(cache_dir) for f in files if '.tmp.' in f]


# -- end to end through the readers ------------------------------------------


def _eq(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == object or b.dtype == object:
            return a.shape == b.shape and all(_eq(x, y) for x, y in zip(a.ravel(), b.ravel()))
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if a is None or b is None:
        return a is None and b is None
    return type(a) is type(b) and (a == b or (a != a and b != b))


def _read_rows(package, url, tmp_path, cache=True, **extra):
    if package == 'jax':
        from petastorm_tpu.reader import make_reader
    else:
        from petastorm_tpu_torch.reader import make_reader
    kwargs = dict(reader_pool_type='thread', workers_count=2, shuffle_row_groups=False)
    if cache:
        kwargs.update(cache_type='decoded', cache_location=str(tmp_path / ('dc-' + package)),
                      cache_size_limit=10 ** 9)
    kwargs.update(extra)
    with make_reader(url, **kwargs) as reader:
        return {int(row.id): row._asdict() for row in reader}


def _assert_rows_equal(got, want):
    assert sorted(got) == sorted(want) and got
    for i, row in want.items():
        assert sorted(got[i]) == sorted(row)
        for name in row:
            assert _eq(got[i][name], row[name]), (i, name)


@pytest.fixture
def no_jax_readahead(monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_READAHEAD', '0')


def test_warm_pass_is_cache_bound_with_zero_decode(synthetic_dataset, tmp_path,
                                                   no_jax_readahead):
    """Cold and warm epochs read the JAX package's uncached rows, value for
    value; the warm pass is cache-bound, every read a hit mapped from disk,
    with no io or decode span."""
    want = _read_rows('jax', synthetic_dataset.url, tmp_path, cache=False)
    cold = _read_rows('torch', synthetic_dataset.url, tmp_path)
    registry = telemetry.get_registry()
    assert registry.counter_value(mc.DECODED_CACHE_MISSES) > 0
    mid = registry.snapshot()
    warm = _read_rows('torch', synthetic_dataset.url, tmp_path)
    _assert_rows_equal(cold, want)
    _assert_rows_equal(warm, want)
    report = telemetry.pipeline_report(baseline=mid)
    section = report['decoded_cache']
    assert section['verdict'] == 'cache-bound' and section['hit_rate'] == 1.0
    assert section['mmap_reads'] > 0 and section['misses'] == 0

    def warm_calls(stage):
        key = 'petastorm_tpu_stage_calls_total{stage="%s"}' % stage
        return registry.counter_value('petastorm_tpu_stage_calls_total', stage=stage) - \
            mid['counters'].get(key, 0)
    assert warm_calls('decode') == 0 and warm_calls('io') == 0
    assert warm_calls('cache_hit_read') > 0
    assert 'decoded cache: cache-bound' in telemetry.format_pipeline_report(report)


def test_warm_epochs_match_the_references_warm_epochs(synthetic_dataset, tmp_path,
                                                      no_jax_readahead):
    rows = {package: [_read_rows(package, synthetic_dataset.url, tmp_path) for _ in range(2)]
            for package in ('jax', 'torch')}
    for epoch in range(2):
        _assert_rows_equal(rows['torch'][epoch], rows['jax'][epoch])
    sections = {'jax': jax_telemetry.decoded_cache_section(),
                'torch': telemetry.decoded_cache_section()}
    for key in ('hits', 'misses', 'mmap_reads', 'copy_reads'):
        assert sections['torch'][key] == sections['jax'][key], key


def test_batched_warm_epoch_column_bytes(synthetic_dataset, tmp_path, no_jax_readahead):
    """``make_batch_reader`` with the decoded cache: every column's bytes
    equal the JAX reader's uncached batches, cold and warm, on the dummy
    pool in order."""
    from petastorm_tpu.reader import make_batch_reader as jax_reader
    from petastorm_tpu_torch.reader import make_batch_reader as torch_reader
    fields = ['^id$', '^matrix$', '^image_png$', '^sensor_name$']

    def batches(make, **kwargs):
        with make(synthetic_dataset.url, reader_pool_type='dummy', shuffle_row_groups=False,
                  schema_fields=fields, **kwargs) as reader:
            return [batch._asdict() for batch in reader]
    want = batches(jax_reader)
    for _ in range(2):
        got = batches(torch_reader, cache_type='decoded', cache_location=str(tmp_path / 'dc'),
                      cache_size_limit=10 ** 9)
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            for name in b:
                assert _eq(a[name], b[name]), name


def test_transform_spec_output_is_cached(synthetic_dataset, tmp_path, no_jax_readahead):
    kw = dict(removed_fields=['matrix_string'])
    want = _read_rows('jax', synthetic_dataset.url, tmp_path, cache=False,
                      transform_spec=JaxTransformSpec(_transform_a, **kw))
    cold = _read_rows('torch', synthetic_dataset.url, tmp_path,
                      transform_spec=TransformSpec(_transform_a, **kw))
    mid = telemetry.get_registry().snapshot()
    warm = _read_rows('torch', synthetic_dataset.url, tmp_path,
                      transform_spec=TransformSpec(_transform_a, **kw))
    _assert_rows_equal(cold, want)
    _assert_rows_equal(warm, want)
    assert 'matrix_string' not in warm[0]
    assert telemetry.decoded_cache_section(baseline=mid)['hit_rate'] == 1.0


def test_uncacheable_transform_bypasses_decoded_cache(synthetic_dataset, tmp_path):
    spec = TransformSpec(_transform_a, cacheable=False)
    assert spec.cacheable is False
    for _ in range(2):
        _read_rows('torch', synthetic_dataset.url, tmp_path, transform_spec=spec)
    registry = telemetry.get_registry()
    assert registry.counter_value(mc.DECODED_CACHE_HITS) == 0
    assert registry.counter_value(mc.DECODED_CACHE_MISSES) == 0


def test_changed_transform_never_serves_stale_rows(synthetic_dataset, tmp_path):
    _read_rows('torch', synthetic_dataset.url, tmp_path,
               transform_spec=TransformSpec(_transform_a))
    mid = telemetry.get_registry().snapshot()
    rows = _read_rows('torch', synthetic_dataset.url, tmp_path,
                      transform_spec=TransformSpec(_transform_a,
                                                   removed_fields=['matrix_string']))
    assert telemetry.decoded_cache_section(baseline=mid)['hits'] == 0
    assert 'matrix_string' not in rows[0]


def test_filters_join_the_key(synthetic_dataset, tmp_path, no_jax_readahead):
    """A ``filters=`` reader caches under its clause digest: its warm
    epoch hits and reads the JAX reader's filtered rows, and another
    filter never hits its entries."""
    near = [('id', '<', 37)]
    want = _read_rows('jax', synthetic_dataset.url, tmp_path, cache=False, filters=near)
    for _ in range(2):
        _assert_rows_equal(_read_rows('torch', synthetic_dataset.url, tmp_path, filters=near),
                           want)
    mid = telemetry.get_registry().snapshot()
    far = _read_rows('torch', synthetic_dataset.url, tmp_path, filters=[('id', '>=', 37)])
    assert min(far) == 37 and telemetry.decoded_cache_section(baseline=mid)['hits'] == 0


def test_explicit_cache_with_an_arbitrary_predicate_raises(synthetic_dataset, tmp_path):
    from petastorm_tpu_torch.predicates import in_lambda
    with pytest.raises(RuntimeError, match='not supported together with predicates'):
        _read_rows('torch', synthetic_dataset.url, tmp_path,
                   predicate=in_lambda(['id'], lambda v: v['id'] < 5))


def _knob_env(monkeypatch, tmp_path):
    monkeypatch.setenv('PETASTORM_TPU_DECODED_CACHE', '1')
    monkeypatch.setenv('PETASTORM_TPU_DECODED_CACHE_DIR', str(tmp_path / 'fleet'))


def test_env_knob_never_breaks_predicate_readers(synthetic_dataset, tmp_path, monkeypatch):
    from petastorm_tpu_torch.predicates import in_lambda
    from petastorm_tpu_torch.reader import make_reader
    _knob_env(monkeypatch, tmp_path)
    with make_reader(synthetic_dataset.url, reader_pool_type='dummy',
                     predicate=in_lambda(['id'], lambda v: v['id'] < 5), num_epochs=1) as reader:
        rows = list(reader)
    assert rows and all(r.id < 5 for r in rows)
    registry = telemetry.get_registry()
    assert registry.counter_value(mc.DECODED_CACHE_MISSES) == 0
    assert registry.counter_value(mc.DECODED_CACHE_SKIPPED, reason='predicate') == 1


def test_env_knob_never_caches_undeclared_transforms(synthetic_dataset, tmp_path, monkeypatch):
    from petastorm_tpu_torch.reader import make_reader
    _knob_env(monkeypatch, tmp_path)
    registry = telemetry.get_registry()
    with make_reader(synthetic_dataset.url, reader_pool_type='dummy',
                     transform_spec=TransformSpec(_transform_a), num_epochs=1) as reader:
        next(reader)
    assert registry.counter_value(mc.DECODED_CACHE_MISSES) == 0
    with make_reader(synthetic_dataset.url, reader_pool_type='dummy',
                     transform_spec=TransformSpec(_transform_a, cacheable=True),
                     num_epochs=1) as reader:
        next(reader)
    assert registry.counter_value(mc.DECODED_CACHE_MISSES) > 0


def test_env_knob_upgrades_default_readers(synthetic_dataset, tmp_path, monkeypatch):
    """The knob's upgrade reads the JAX package's rows under the same
    knob, and both packages cache them."""
    monkeypatch.setenv('PETASTORM_TPU_READAHEAD', '0')
    _knob_env(monkeypatch, tmp_path)
    rows = {}
    for package in ('jax', 'torch'):
        rows[package] = _read_rows(package, synthetic_dataset.url, tmp_path, cache=False)
    _assert_rows_equal(rows['torch'], rows['jax'])
    for tel in (jax_telemetry, telemetry):
        assert tel.get_registry().counter_value(mc.DECODED_CACHE_MISSES) > 0
    assert os.path.isdir(str(tmp_path / 'fleet'))


def test_cached_reads_decline_fused_decode(synthetic_dataset, tmp_path):
    """A cache stores finished batches, so a cached reader never defers
    image decode (counted once, as a worker-config fallback)."""
    from petastorm_tpu_torch.fused import EncodedImageColumn
    from petastorm_tpu_torch.reader import make_batch_reader
    with make_batch_reader(synthetic_dataset.url, reader_pool_type='dummy',
                           schema_fields=['^id$', '^image_png$'], defer_image_decode=True,
                           cache_type='decoded', cache_location=str(tmp_path / 'dc'),
                           cache_size_limit=10 ** 9) as reader:
        batch = next(reader)
    assert not isinstance(batch.image_png, EncodedImageColumn)
    assert telemetry.get_registry().counter_value(
        'petastorm_tpu_fused_decode_fallbacks_total', reason='worker-config') == 1


# -- the fleet tier's satellites -----------------------------------------------


def _marker(path, fingerprint):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, MARKER_PREFIX + fingerprint), 'a'):
        pass


def test_reroot_purges_markers_with_no_entries_behind_them(tmp_path):
    host_dir = str(tmp_path / 'host')
    _marker(host_dir, 'stale-fp')
    _cache('torch', tmp_path).reroot(host_dir)
    assert not [n for n in os.listdir(host_dir) if n.startswith(MARKER_PREFIX)]


def test_reroot_keeps_markers_backed_by_real_entries(tmp_path):
    host_dir = str(tmp_path / 'host')
    mc.MaterializedRowGroupCache(host_dir, 10 ** 8).get('k', _fill('torch', _sample_columns()))
    _marker(host_dir, 'earned-fp')
    _cache('torch', tmp_path).reroot(host_dir)
    assert MARKER_PREFIX + 'earned-fp' in os.listdir(host_dir)


def test_cleanup_purges_markers_from_kept_directory(tmp_path):
    cache = _cache('torch', tmp_path)
    _marker(cache.path, 'fp')
    cache.cleanup()
    assert os.path.isdir(cache.path)
    assert not [n for n in os.listdir(cache.path) if n.startswith(MARKER_PREFIX)]


def test_markers_purge_as_the_references(tmp_path):
    from petastorm_tpu.service import placement
    from petastorm_tpu_torch.cache import purge_stale_markers
    for label, with_entry in (('bare', False), ('earned', True)):
        dirs = [str(tmp_path / label / pkg) for pkg in ('jax', 'torch')]
        for d in dirs:
            _marker(d, 'a')
            _marker(d, 'b')
            if with_entry:
                with open(os.path.join(d, 'entry.arrow'), 'wb') as f:
                    f.write(b'x')
        assert purge_stale_markers(dirs[1]) == placement.purge_stale_markers(dirs[0])
        assert sorted(os.listdir(dirs[1])) == sorted(os.listdir(dirs[0]))


def test_mem_tier_hits_touch_disk_entry_rate_limited(tmp_path, monkeypatch):
    cache = _cache('torch', tmp_path, mem_mb=64)
    cols = _sample_columns()
    cache.get('k', _fill('torch', cols))
    entry = cache._entry_path('k')
    touched = []
    real_utime = os.utime

    def counting_utime(path, *args, **kwargs):
        touched.append(path)
        return real_utime(path, *args, **kwargs)

    monkeypatch.setattr(os, 'utime', counting_utime)
    for _ in range(10):
        cache.get('k', _fill('torch', cols))
    assert touched.count(entry) == 1
    with cache._lock:
        cache._utime_at[entry] -= mc._UTIME_INTERVAL_S + 1
    cache.get('k', _fill('torch', cols))
    assert touched.count(entry) == 2


def test_publish_listeners_see_every_publish(tmp_path):
    seen = []

    def listener(entry, size):
        seen.append((entry, size))

    mc.add_publish_listener(listener)
    try:
        cache = _cache('torch', tmp_path)
        for i in range(3):
            cache.get('k%d' % i, _fill('torch', _sample_columns(4, i)))
        cache.get('k0', _fill('torch', _sample_columns()))
    finally:
        mc.remove_publish_listener(listener)
    assert [e for e, _ in seen] == [cache._entry_path('k%d' % i) for i in range(3)]
    assert all(size == os.path.getsize(e) for e, size in seen)


_RACE_READER = '''
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from petastorm_tpu_torch.arrow_worker import ColumnBatch
from petastorm_tpu_torch.materialized_cache import MaterializedRowGroupCache

path, direction = sys.argv[2], int(sys.argv[3])
cache = MaterializedRowGroupCache(path, 30_000)  # ~6 entries: heavy churn
order = range(20) if direction else range(19, -1, -1)
for _round in range(3):
    for i in order:
        def fill(i=i):
            return ColumnBatch({'v': np.full(512, i, dtype=np.int64)}, 512)
        batch = cache.get(('race', i), fill)
        v = batch.columns['v']
        assert batch.length == 512 and (np.asarray(v) == i).all(), i
print('OK')
'''


def test_eviction_racing_a_reader_in_another_process(tmp_path):
    shared = str(tmp_path / 'shared')
    procs = [subprocess.Popen([sys.executable, '-c', _RACE_READER, REPO, shared, str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for d in (0, 1)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        outs.append((p.returncode, out.decode(errors='replace')))
    for code, out in outs:
        assert code == 0 and 'OK' in out, out


def test_row_multiset_of_a_cached_thread_pool_epoch(synthetic_dataset, tmp_path):
    from petastorm_tpu_torch.reader import make_reader
    ids = []
    for _ in range(2):
        with make_reader(synthetic_dataset.url, reader_pool_type='thread', workers_count=4,
                         schema_fields=['^id$'], cache_type='decoded',
                         cache_location=str(tmp_path / 'dc'), cache_size_limit=10 ** 9) as reader:
            ids.append(collections.Counter(int(row.id) for row in reader))
    assert ids[0] == ids[1] == collections.Counter(range(100))


# -- the torch bridges over read-only hits -------------------------------------

_BRIDGE_SCRIPT = r'''
import json, sys, warnings
sys.path.insert(0, sys.argv[1])
root = sys.argv[2]
import numpy as np
from tests.torch_telemetry_common import write_small_dataset
from petastorm_tpu_torch.pytorch import BatchedDataLoader, DataLoader
from petastorm_tpu_torch.reader import make_batch_reader, make_reader
url = write_small_dataset('file://%s/ds' % root, rows=40, rowgroup_size_rows=10)
kw = dict(reader_pool_type='dummy', shuffle_row_groups=False)
cache = dict(cache_type='decoded', cache_location=root + '/dc', cache_size_limit=10 ** 8)


def epoch(kind, cached):
    extra = cache if cached else {}
    if kind == 'batched':
        loader = BatchedDataLoader(make_batch_reader(url, **kw, **extra), batch_size=8,
                                   device='cpu')
    else:
        loader = DataLoader(make_reader(url, **kw, **extra), batch_size=8, device='cpu')
    seen = []
    with loader:
        for batch in loader:
            seen.append({k: v.tolist() for k, v in sorted(batch.items())})
            batch['x'] -= 1.0      # the in-place op a training loop makes
            batch['id'] += 1000
    return seen


out = {'uncached': epoch('batched', False)}
epoch('batched', True)             # the cold epoch fills the cache
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter('always')
    for kind in ('batched', 'row'):
        out[kind] = [epoch(kind, True) for _ in range(2)]
out['warnings'] = [str(w.message) for w in caught]
print(json.dumps(out))
'''


def test_bridges_copy_read_only_hits(tmp_path):
    """Warm decoded-cache epochs through ``BatchedDataLoader`` and
    ``DataLoader`` with an in-place op on every batch: the next epoch's
    batches equal the first's (and an uncached read's), and torch never
    warns about a non-writable array (a fresh process: torch warns once
    per process)."""
    import json
    proc = subprocess.run([sys.executable, '-c', _BRIDGE_SCRIPT, REPO, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not [w for w in out['warnings'] if 'not writable' in w], out['warnings']
    assert len(out['uncached']) == 5
    for kind in ('batched', 'row'):
        first, second = out[kind]
        assert first == second, kind
    assert out['batched'][0] == out['uncached']
    rows = sorted(i for b in out['row'][0] for i in b['id'])
    assert rows == list(range(40))


def test_fill_path_batches_are_frozen_once_the_memory_tier_holds_them(tmp_path):
    """The memory tier shares the fill path's arrays with every later hit:
    the port freezes them, so an in-place write raises instead of
    corrupting the next epoch; a batch too large for the tier stays the
    consumer's own writable memory."""
    cache = _cache('torch', tmp_path, mem_mb=1)
    held = cache.get('small', _fill('torch', _sample_columns()))
    with pytest.raises(ValueError, match='read-only'):
        held.columns['ids'][0] = 9
    big = {'ids': np.arange(4, dtype=np.int64), 'x': np.zeros((4, 2 ** 19), np.uint8)}
    kept = cache.get('big', _fill('torch', big))
    kept.columns['x'][0, 0] = 1
    assert cache.get('small', _fill('torch', _sample_columns())).columns['ids'][0] == 0
