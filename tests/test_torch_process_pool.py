"""The port's process pool (``petastorm_tpu_torch/workers/process_pool.py``)
against the JAX package's, on the CPU.

Workers are spawned Python processes; every pool here has at most two,
and every test stops and joins its pool in a ``finally`` (or through a
reader's or loader's context), so no child outlives it. Held:

* the pool contract, the cases of ``tests/test_workers_pool.py`` on the
  port's ``ProcessPool(2)``: an identity round trip, worker args, a
  forwarded exception, the empty pool, ventilator epochs, a SIGKILLed
  worker, a worker that dies at start-up, a stop mid-stream, and the
  shared gauges, whose names are the JAX package's;
* ``exec_in_new_process``: a new interpreter, its exit code, and
  ``CUDA_VISIBLE_DEVICES=''`` with neither ``jax`` nor ``petastorm_tpu``
  loaded in the child; the pool's workers report the same at check-in;
* worker metrics deltas and trace events ride the completion markers
  into the consumer's registry and recorder;
* reads through the process pool equal the JAX package's process-pool
  reads: batch for batch on one worker with unshuffled row-groups, as a
  multiset on two; ``make_reader`` rows; ``make_torch_loader`` batches,
  the fused ViT image path (encoded cells cross the pool, the loader's
  staging decodes them) and two ViT AdamW steps on them from
  ``vit_params_from_jax`` weights, losses within 1e-4 (f32); a row-group
  a predicate empties under the in-order loader; the workers' readahead
  hits reach the consumer's registry;
* the write plane on ``pool='process'`` and on a port ``ProcessPool(2)``
  writes the JAX writer's parts and manifest on its process pool.
"""

import collections
import os
import signal

import numpy as np
import pytest

from petastorm_tpu.workers import SHARED_POOL_GAUGES as JAX_SHARED_POOL_GAUGES
from petastorm_tpu_torch import telemetry as T
from petastorm_tpu_torch.telemetry import tracing
from petastorm_tpu_torch.workers import SHARED_POOL_GAUGES, EmptyResultError
from petastorm_tpu_torch.workers.dummy_pool import DummyPool
from petastorm_tpu_torch.workers.process_pool import ProcessPool
from petastorm_tpu_torch.workers.thread_pool import ThreadPool
from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator
from tests.torch_cpu_threads import few_torch_threads  # noqa: F401 - autouse
from tests.torch_stub_workers import (
    EnvironmentProbeWorker, ExceptionOnFiveWorker, FailingStartWorker, IdentityWorker,
    MultiplyingWorker, SleepyIdentityWorker, SpanningSleepyWorker, TracingProbeWorker,
    exit_with, report_environment, write_marker,
)
from tests.torch_telemetry_common import (  # noqa: F401 - autouse, fixture
    telemetry_guard, traced, write_small_dataset,
)

_RESULT_TIMEOUT_S = 60
STAGE_SECONDS = 'petastorm_tpu_stage_seconds_total'


def _drain(pool):
    out = []
    while True:
        try:
            out.append(pool.get_results(timeout=_RESULT_TIMEOUT_S))
        except EmptyResultError:
            return out


def _run(pool, worker_class, items, worker_args=None, ventilator=None):
    """Start ``pool``, ventilate ``items`` (unless a ventilator does),
    drain it, and stop and join it whatever happens; no worker is left."""
    try:
        pool.start(worker_class, worker_args, ventilator=ventilator)
        for item in items:
            pool.ventilate(item)
        return _drain(pool)
    finally:
        pool.stop()
        pool.join()
        assert pool.diagnostics['workers_alive'] == 0


# -- the pool contract -----------------------------------------------------------


def test_identity_roundtrip_and_gauges():
    pool = ProcessPool(2)
    try:
        pool.start(IdentityWorker)
        assert pool.diagnostics['workers_alive'] == 2
        for i in range(20):
            pool.ventilate(i)
        assert sorted(_drain(pool)) == list(range(20))
        diag = pool.diagnostics
        assert SHARED_POOL_GAUGES == JAX_SHARED_POOL_GAUGES <= set(diag)
        assert (diag['items_ventilated'], diag['items_processed'],
                diag['items_inflight']) == (20, 20, 0)
    finally:
        pool.stop()
        pool.join()
    assert pool.diagnostics['workers_alive'] == 0


@pytest.mark.parametrize('make_pool', [lambda: ThreadPool(2), DummyPool],
                         ids=['thread', 'dummy'])
def test_every_pool_has_the_shared_gauges(make_pool):
    pool = make_pool()
    assert sorted(_run(pool, IdentityWorker, range(3))) == [0, 1, 2]
    assert SHARED_POOL_GAUGES <= set(pool.diagnostics)


def test_worker_args():
    assert sorted(_run(ProcessPool(2), MultiplyingWorker, range(5),
                       worker_args={'factor': 3})) == [0, 3, 6, 9, 12]


def test_exception_propagates_to_consumer():
    pool = ProcessPool(2)
    try:
        pool.start(ExceptionOnFiveWorker)
        for i in range(10):
            pool.ventilate(i)
        with pytest.raises(ValueError, match='value was 5'):
            while True:
                pool.get_results(timeout=_RESULT_TIMEOUT_S)
        # terminal: a later read raises it again
        with pytest.raises(ValueError, match='value was 5'):
            pool.get_results(timeout=_RESULT_TIMEOUT_S)
    finally:
        pool.stop()
        pool.join()
    assert pool.diagnostics['workers_alive'] == 0


def test_empty_pool_raises_empty_result():
    assert _run(ProcessPool(2), IdentityWorker, []) == []


@pytest.mark.parametrize('iterations,items', [(1, 30), (3, 7)], ids=['one-epoch', 'epochs'])
def test_with_ventilator(iterations, items):
    pool = ProcessPool(2)
    vent = ConcurrentVentilator(pool.ventilate, [{'value': i} for i in range(items)],
                                iterations=iterations, max_ventilation_queue_size=4)
    got = _run(pool, IdentityWorker, [], ventilator=vent)
    assert sorted(got) == sorted(list(range(items)) * iterations)


def test_sigkilled_worker_is_detected():
    pool = ProcessPool(2)
    try:
        pool.start(SleepyIdentityWorker)
        for i in range(50):
            pool.ventilate(i)
        os.kill(pool.worker_pids[0], signal.SIGKILL)
        with pytest.raises(RuntimeError, match='died unexpectedly'):
            for _ in range(60):
                pool.get_results(timeout=30)
    finally:
        pool.stop()
        pool.join()


def test_worker_dying_at_startup_is_reported():
    pool = ProcessPool(2)
    with pytest.raises(RuntimeError, match='died during startup'):
        pool.start(FailingStartWorker)
    # start cleaned up after itself: nothing to stop, nothing alive
    assert pool.worker_pids == [] and pool.diagnostics['workers_alive'] == 0
    pool.stop()
    pool.join()


def test_stop_mid_stream_does_not_hang():
    pool = ProcessPool(2, results_queue_size=2)
    try:
        pool.start(SleepyIdentityWorker)
        processes = list(pool._processes)
        for i in range(50):
            pool.ventilate(i, sleep_s=0.001)
        pool.get_results(timeout=_RESULT_TIMEOUT_S)
    finally:
        pool.stop()
        pool.join()
    # the workers parked on the full channel heard the stop and exited
    # cleanly: none was terminated
    assert [p.returncode for p in processes] == [0, 0]
    with pytest.raises(RuntimeError, match='stop'):
        ProcessPool(1).join()


def test_results_hwm_splits_the_queue_bound():
    pool = ProcessPool(2, results_queue_size=20)
    try:
        pool.start(IdentityWorker)
        import zmq
        assert pool._results_socket.get(zmq.RCVHWM) == 5
    finally:
        pool.stop()
        pool.join()


# -- spawned processes -------------------------------------------------------------


def test_exec_in_new_process_runs_a_fresh_interpreter(tmp_path):
    from petastorm_tpu_torch.workers.exec_in_new_process import exec_in_new_process
    out = str(tmp_path / 'out.txt')
    assert exec_in_new_process(write_marker, out, value='hello').wait(timeout=60) == 0
    value, pid = open(out).read().split(':')
    assert value == 'hello' and int(pid) != os.getpid()


def test_exec_in_new_process_exit_code():
    from petastorm_tpu_torch.workers.exec_in_new_process import exec_in_new_process
    assert exec_in_new_process(exit_with, 3).wait(timeout=60) == 3


def test_child_sees_no_card_and_no_jax(tmp_path, monkeypatch):
    """Even where the parent exports a card and has imported JAX and the
    JAX package (this test process has), the child sees no card and loads
    neither."""
    import sys
    from petastorm_tpu_torch.workers.exec_in_new_process import exec_in_new_process
    assert 'jax' in sys.modules and 'petastorm_tpu' in sys.modules
    monkeypatch.setenv('CUDA_VISIBLE_DEVICES', '0')
    out = str(tmp_path / 'env.txt')
    assert exec_in_new_process(report_environment, out).wait(timeout=60) == 0
    assert open(out).read() == "''|False|False"


def test_pool_workers_report_no_card_and_no_jax():
    pool = ProcessPool(2)
    try:
        pool.start(EnvironmentProbeWorker)
        reports = sorted(pool.worker_reports, key=lambda r: r['worker_id'])
        for i in range(4):
            pool.ventilate(i)
        published = _drain(pool)
    finally:
        pool.stop()
        pool.join()
    assert [r['worker_id'] for r in reports] == [0, 1]
    pids = {r['pid'] for r in reports}
    assert {p['pid'] for p in published} <= pids and os.getpid() not in pids
    for r in reports:
        assert r['cuda_visible_devices'] == ''
        assert not {'jax', 'petastorm_tpu', 'torch'} & set(r['modules']), r['modules']
    assert sorted(p['value'] for p in published) == [0, 1, 2, 3]
    assert all(p['cuda_visible_devices'] == '' and not p['jax'] and not p['petastorm_tpu']
               for p in published)


# -- telemetry across the boundary -------------------------------------------------


def test_deltas_ride_markers():
    """The workers' spans reach this process's registry through the delta
    on each completion marker (``tests/test_telemetry_pools.py``'s case)."""
    pool = ProcessPool(1, results_queue_size=10)
    try:
        pool.start(SpanningSleepyWorker)
        for i in range(5):
            pool.ventilate(i, sleep_s=0.02)
        assert sorted(_drain(pool)) == list(range(5))
    finally:
        pool.stop()
        pool.join()
    registry = T.get_registry()
    assert registry.counter_value(STAGE_SECONDS, stage='decode') >= 0.08
    assert registry.counter_value('petastorm_tpu_stage_calls_total', stage='decode') == 5


def test_trace_events_ride_markers(traced):
    """A trace id minted here is active in the worker process, and its
    events come back to this process's recorder
    (``tests/test_tracing_pools.py``'s case)."""
    pool = ProcessPool(1, results_queue_size=10)
    ventilator = ConcurrentVentilator(pool.ventilate, [{'item_index': i} for i in range(6)],
                                      iterations=1)
    results = dict(_run(pool, TracingProbeWorker, [], ventilator=ventilator))
    assert sorted(results) == list(range(6))
    for item_index, worker_side_id in results.items():
        assert worker_side_id == tracing.ctx_for(item_index, epoch=0).trace_id
    events = T.get_recorder().snapshot()
    names = collections.Counter(e['name'] for e in events)
    assert names['attempt'] == 6 and names['decode'] == 6
    worker_pids = {e['pid'] for e in events if e['name'] == 'attempt'}
    assert worker_pids and os.getpid() not in worker_pids
    assert {e['tid'] for e in events if e['name'] == 'attempt'} == {'process-0'}


# -- reads -------------------------------------------------------------------------


@pytest.fixture(scope='module')
def small_url(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('small')) + '/ds'
    write_small_dataset(url)
    return url


def _batches(make, url, **kw):
    with make(url, schema_fields=['^id$', '^x$'], **kw) as reader:
        return [(np.asarray(b.id).copy(), np.asarray(b.x).copy()) for b in reader]


def _rows_of(batches):
    return sorted((int(i), tuple(x.tolist())) for ids, xs in batches for i, x in zip(ids, xs))


@pytest.fixture(scope='module')
def jax_process_read(small_url):
    from petastorm_tpu.reader import make_batch_reader
    return _batches(make_batch_reader, small_url, reader_pool_type='process', workers_count=1,
                    shuffle_row_groups=False)


def test_batch_reader_on_one_worker_is_the_references_batch_for_batch(small_url,
                                                                        jax_process_read):
    from petastorm_tpu_torch.reader import make_batch_reader
    got = _batches(make_batch_reader, small_url, reader_pool_type='process', workers_count=1,
                   shuffle_row_groups=False)
    assert len(got) == len(jax_process_read) == 12
    for (a_id, a_x), (b_id, b_x) in zip(jax_process_read, got):
        np.testing.assert_array_equal(a_id, b_id)
        np.testing.assert_array_equal(a_x, b_x)


def test_batch_reader_on_two_workers_is_the_references_multiset(small_url, jax_process_read):
    from petastorm_tpu_torch.reader import make_batch_reader
    got = _batches(make_batch_reader, small_url, reader_pool_type='process', workers_count=2,
                   shuffle_row_groups=True, seed=5, num_epochs=2)
    assert _rows_of(got) == sorted(_rows_of(jax_process_read) * 2)


def test_row_reader_rows_are_the_references(small_url, jax_process_read):
    from petastorm_tpu_torch.reader import make_reader
    with make_reader(small_url, schema_fields=['^id$', '^x$'], reader_pool_type='process',
                     workers_count=2) as reader:
        rows = sorted((int(r.id), tuple(r.x.tolist())) for r in reader)
    assert rows == _rows_of(jax_process_read)


def test_readahead_hits_in_the_workers_reach_the_consumer(small_url):
    from petastorm_tpu_torch import readahead
    from petastorm_tpu_torch.reader import make_batch_reader
    with make_batch_reader(small_url, schema_fields=['^id$'], reader_pool_type='process',
                           workers_count=2, shuffle_row_groups=False) as reader:
        ids = sorted(int(i) for b in reader for i in b.id)
        # the managers live in the workers, none in this process
        assert not list(readahead._live_managers)
    assert ids == list(range(120))
    counters = T.get_registry().snapshot()['counters']
    hits = counters.get(readahead.READAHEAD_HITS, 0)
    misses = counters.get(readahead.READAHEAD_MISSES, 0)
    assert hits >= 1 and hits + misses == 12, counters
    assert counters.get(readahead.READAHEAD_BYTES, 0) > 0
    assert counters['petastorm_tpu_stage_calls_total{stage="io"}'] == 12


def test_sanitized_process_read_is_read_only(small_url, monkeypatch):
    from petastorm_tpu_torch import sanitizer
    from petastorm_tpu_torch.reader import make_batch_reader
    monkeypatch.setenv('PETASTORM_TPU_SANITIZE', '1')
    T.refresh()
    sanitizer.refresh_sanitizer()
    with make_batch_reader(small_url, schema_fields=['^id$', '^x$'], reader_pool_type='process',
                           workers_count=1) as reader:
        batch = next(reader)
        assert not batch.x.flags.writeable
        with pytest.raises(ValueError):
            batch.x[0, 0] = 1.0
        assert sum(1 for _ in reader) == 11
    assert not sanitizer.violations()


def test_loader_batches_are_the_references(small_url):
    from petastorm_tpu.jax import make_jax_loader
    from petastorm_tpu_torch.device.loader import make_torch_loader
    kw = dict(batch_size=16, fields=['^id$', '^x$'], reader_pool_type='process',
              workers_count=1, shuffle_row_groups=False, last_batch='short')
    with make_jax_loader(small_url, **kw) as loader:
        want = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    with make_torch_loader(small_url, device='cpu', **kw) as loader:
        got = [{k: v.numpy().copy() for k, v in b.items()} for b in loader]
        assert loader.diagnostics['workers_alive'] == 1
    assert len(got) == len(want) == 8
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_in_order_loader_reads_past_an_emptied_row_group(tmp_path):
    """``ZeroRowItem`` crosses the process pool: an endless in-order
    loader whose predicate empties row-group 1 reads three epochs, each
    the survivors (``tests/test_torch_in_order_loader.py`` on processes)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from petastorm_tpu_torch.arrow_worker import ZeroRowItem
    from petastorm_tpu_torch.device.loader import TorchLoader
    from petastorm_tpu_torch.predicates import in_lambda
    from petastorm_tpu_torch.reader import make_batch_reader
    import pickle
    item = pickle.loads(pickle.dumps(ZeroRowItem(3, 1), protocol=5))
    assert (item.item_index, item.epoch) == (3, 1)
    pq.write_table(pa.table({'id': np.arange(64, dtype=np.int64)}),
                   str(tmp_path / 'part-0.parquet'), row_group_size=8)
    reader = make_batch_reader('file://%s' % tmp_path, schema_fields=['id'], num_epochs=None,
                               reader_pool_type='process', workers_count=2,
                               predicate=in_lambda(['id'], lambda v: not 8 <= v['id'] < 16))
    survivors = sorted(set(range(64)) - set(range(8, 16)))
    with TorchLoader(reader, 8, device='cpu', in_order=True) as loader:
        it = iter(loader)
        batches = [next(it)['id'].tolist() for _ in range(3 * 7)]
        state = loader.state_dict()
    for epoch in range(3):
        assert sorted(i for b in batches[epoch * 7:(epoch + 1) * 7] for i in b) == survivors
    assert state['epoch'] == 3


# -- the fused ViT image path ------------------------------------------------------

VIT_SMALL = dict(image_size=32, patch_size=8, n_classes=1000, d_model=64, n_heads=2,
                 n_layers=2, d_ff=128)


@pytest.fixture(scope='module')
def vit_url(tmp_path_factory):
    from petastorm_tpu_torch.examples.imagenet import generate_imagenet_like
    url = 'file://' + str(tmp_path_factory.mktemp('vit')) + '/ds'
    return generate_imagenet_like(url, num_rows=32, size=32, image_codec='png',
                                  rowgroup_size_rows=8)


def test_fused_vit_path_batches_and_losses_are_the_references(vit_url):
    import jax
    import jax.numpy as jnp
    import optax
    import torch
    from petastorm_tpu.jax import make_jax_loader
    from petastorm_tpu.models import vit as jv
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.examples.imagenet import IMAGENET_MEAN, IMAGENET_STD
    from petastorm_tpu_torch.models import vit as tv
    kw = dict(batch_size=8, fields=['^image$', '^label$'], reader_pool_type='process',
              workers_count=1, shuffle_row_groups=False)
    with make_jax_loader(vit_url, **kw) as loader:
        want = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    with make_torch_loader(vit_url, device='cpu', **kw) as loader:
        got = [{k: v.numpy().copy() for k, v in b.items()} for b in loader]
        diag = loader.diagnostics
    # the worker shipped encoded cells; the loader's staging decoded them
    assert diag['fused_decode_mode'] == 'fused-into-slab' and diag['fused_decode_rows'] == 32
    assert len(got) == len(want) == 4
    for a, b in zip(want, got):
        for name in ('image', 'label'):
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)

    def normalized(images):
        return ((images.astype(np.float32) / 255.0 - np.float32(IMAGENET_MEAN))
                / np.float32(IMAGENET_STD)).astype(np.float32)

    jax_config = jv.ViTConfig(dtype=jnp.float32, attn_impl='flash', **VIT_SMALL)
    params = jv.init_vit_params(jax.random.PRNGKey(0), jax_config)
    params['head'] = jax.random.normal(jax.random.PRNGKey(1), params['head'].shape) * 0.1
    model = tv.ViT(tv.ViTConfig(dtype=torch.float32, attn_impl='flash', **VIT_SMALL))
    model.load_state_dict(tv.vit_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    optimizer = optax.adamw(1e-3)
    step = jv.vit_train_step(jax_config, optimizer)
    opt_state = optimizer.init(params)
    torch_step = tv.vit_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4))
    for batch in got[:2]:
        images = normalized(batch['image'])
        params, opt_state, loss = step(params, opt_state, jnp.asarray(images),
                                       jnp.asarray(batch['label']))
        torch_loss = torch_step(torch.from_numpy(images), torch.from_numpy(batch['label']))
        np.testing.assert_allclose(float(torch_loss), float(loss), atol=1e-4, rtol=0)


# -- the write plane ---------------------------------------------------------------


def _image_rows(n):
    rng = np.random.RandomState(11)
    return [{'id': np.int64(i), 'vec': rng.rand(4).astype(np.float32),
             'image': rng.randint(0, 255, (8, 8, 3), dtype=np.uint8)} for i in range(n)]


def _part_bytes(root):
    return {name: open(os.path.join(root, name), 'rb').read()
            for name in sorted(os.listdir(root)) if name.startswith('part-')}


_WRITE_KW = dict(sort_by='id', shard_rows=32, rowgroup_size_rows=16)


def _write_schemas():
    """The JAX package's schema of ``_image_rows`` and the port's from its JSON."""
    import pyarrow as pa
    from petastorm_tpu.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
    from petastorm_tpu.unischema import Unischema, UnischemaField
    from petastorm_tpu_torch.unischema import Unischema as TorchUnischema
    schema = Unischema('ProcessWrite', [
        UnischemaField('id', np.int64, (), ScalarCodec(pa.int64()), False),
        UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False),
        UnischemaField('image', np.uint8, (8, 8, 3), CompressedImageCodec('png'), False),
    ])
    return schema, TorchUnischema.from_json_dict(schema.to_json_dict())


def test_write_plane_is_the_references_process_pool_write(tmp_path):
    from petastorm_tpu.workers.process_pool import ProcessPool as JaxProcessPool
    from petastorm_tpu.write import write_dataset_distributed as jax_write
    from petastorm_tpu_torch.write import write_dataset_distributed as torch_write
    schema, torch_schema = _write_schemas()
    rows = _image_rows(96)
    kw = _WRITE_KW
    want = jax_write('file://%s/jax' % tmp_path, schema, rows, pool=JaxProcessPool(2), **kw)
    written = {
        'named': torch_write('file://%s/named' % tmp_path, torch_schema, rows, pool='process',
                             **kw),
        'instance': torch_write('file://%s/instance' % tmp_path, torch_schema, rows,
                                pool=ProcessPool(2), **kw)}
    want_parts = _part_bytes(str(tmp_path / 'jax'))
    assert len(want_parts) == 3
    for name, w in written.items():
        assert w.manifest == want.manifest, name
        assert _part_bytes(str(tmp_path / name)) == want_parts, name
        assert (tmp_path / name / '_manifest.json').read_bytes() == \
            (tmp_path / 'jax' / '_manifest.json').read_bytes()
    # the workers' write counters reached this process through the deltas
    assert T.get_registry().counter_value('petastorm_tpu_write_rows_total') == 2 * 96
    # no rows: the pool never starts, and one empty part commits
    empty = {name: w('file://%s/empty_%s' % (tmp_path, name), sch, [], pool=pool_of(), **kw)
             for name, w, sch, pool_of in (('jax', jax_write, schema, lambda: JaxProcessPool(2)),
                                           ('torch', torch_write, torch_schema,
                                            lambda: ProcessPool(2)))}
    assert empty['torch'].manifest == empty['jax'].manifest
    assert [e['rows'] for e in empty['torch'].manifest['files']] == [0]


@pytest.mark.parametrize('pool', ['named', 'instance'])
def test_process_pool_write_counts_as_the_inline_write(tmp_path, pool):
    """Every ``petastorm_tpu_write_*`` counter and gauge of a process-pool
    write equals the inline write's: the writer reads the pool until it
    reports empty, so the last shards' completion markers, which carry
    their workers' deltas, are read before the pool stops."""
    from petastorm_tpu_torch.write import write_dataset_distributed as torch_write
    _, schema = _write_schemas()
    rows = _image_rows(96)
    counts = {}
    for name, pool_arg in (('inline', None),
                           (pool, 'process' if pool == 'named' else ProcessPool(2))):
        T.reset_for_tests()
        torch_write('file://%s/%s' % (tmp_path, name), schema, rows, pool=pool_arg,
                    **_WRITE_KW)
        registry = T.get_registry()
        counts[name] = (registry.counters_with_prefix('petastorm_tpu_write_'),
                        registry.gauges_with_prefix('petastorm_tpu_write_'))
    assert counts[pool] == counts['inline']
    counters = counts['inline'][0]
    assert counters['petastorm_tpu_write_rows_total'] == 96
    assert counters['petastorm_tpu_write_files_total'] == 3
