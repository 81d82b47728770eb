"""petastorm_tpu_torch stands alone: no module of the port, and not
chip_smoke.py, imports JAX, Flax, Optax, Orbax or the JAX package; nor
does a decode worker the port's process pool spawns, at run time."""

import ast
import os

import pytest
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'petastorm_tpu')


def _sources():
    paths = [os.path.join(ROOT, 'chip_smoke.py')]
    for dirpath, _, files in os.walk(os.path.join(ROOT, 'petastorm_tpu_torch')):
        paths.extend(os.path.join(dirpath, f) for f in files if f.endswith('.py'))
    return sorted(paths)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split('.')[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, 'attr', getattr(
                node.func, 'id', None)) in ('import_module', '__import__')
                and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split('.')[0]


def test_port_has_modules_to_scan():
    rel = [os.path.relpath(p, ROOT) for p in _sources()]
    assert 'chip_smoke.py' in rel
    for module in (('ops', 'normalize.py'), ('ops', 'flash_attention.py'),
                   ('ops', 'ring_attention.py'), ('models', 'transformer.py'),
                   ('models', 'moe.py'), ('models', 'generate.py'),
                   ('examples', 'generate.py'), ('examples', 'modern.py'),
                   ('examples', 'lm_pretrain.py'), ('native', '__init__.py'),
                   ('codecs.py',), ('fused.py',), ('arrow_worker.py',), ('reader.py',),
                   ('device', 'staging.py'), ('device', 'loader.py'),
                   ('ops', 'augment.py'), ('models', 'vit.py'),
                   ('examples', 'imagenet.py'), ('telemetry', 'names.py'),
                   ('ragged.py',), ('examples', 'variable_length.py'),
                   ('mixture', 'spec.py'), ('mixture', 'interleave.py'),
                   ('mixture', 'packing.py'), ('mixture', 'engine.py'),
                   ('mixture', 'adapter.py'), ('checkpoint.py',),
                   ('weighted_sampling_reader.py',), ('ngram.py',), ('pytorch.py',),
                   ('examples', 'mnist_pytorch.py'), ('examples', 'hello_world.py'),
                   ('predicates.py',), ('filters.py',), ('pushdown.py',),
                   ('parallel', 'sharding.py'), ('telemetry', 'knobs.py'),
                   ('telemetry', 'registry.py'), ('telemetry', 'spans.py'),
                   ('telemetry', 'recorder.py'), ('telemetry', 'tracing.py'),
                   ('telemetry', 'stall.py'), ('telemetry', 'critpath.py'),
                   ('telemetry', 'export.py'), ('telemetry', '__init__.py'),
                   ('telemetry', 'timeseries.py'), ('telemetry', 'slo.py'),
                   ('telemetry', 'obs_server.py'), ('telemetry', 'obslog.py'),
                   ('tools', '__init__.py'), ('tools', 'obs_replay.py'),
                   ('workers', 'ventilator.py'), ('workers', 'thread_pool.py'),
                   ('workers', 'dummy_pool.py'), ('sanitizer.py',), ('ops', 'build.py'),
                   ('analysis', '__init__.py'), ('analysis', '__main__.py'),
                   ('analysis', 'contracts.py'), ('analysis', 'findings.py'),
                   ('analysis', 'core.py'), ('analysis', 'callgraph.py'),
                   ('analysis', 'pass_env_knobs.py'), ('analysis', 'pass_names.py'),
                   ('analysis', 'pass_locks.py'), ('analysis', 'pass_threads.py'),
                   ('analysis', 'pass_payloads.py'), ('analysis', 'pass_buffers.py'),
                   ('faults.py',), ('cache.py',), ('materialized_cache.py',),
                   ('ops', '__init__.py'), ('models', '__init__.py'),
                   ('readahead.py',), ('device', 'autotune.py'),
                   ('write', '__init__.py'), ('write', 'manifest.py'),
                   ('write', 'layout.py'), ('write', 'writer.py'), ('write', 'append.py'),
                   ('write', 'compact.py'), ('etl', 'dataset_metadata.py'),
                   ('etl', '__init__.py'), ('etl', 'legacy.py'),
                   ('etl', 'rowgroup_indexers.py'), ('etl', 'rowgroup_indexing.py'),
                   ('etl', 'metadata_util.py'), ('etl', 'petastorm_generate_metadata.py'),
                   ('selectors.py',), ('tools', 'copy_dataset.py'),
                   ('tools', 'spark_session_cli.py'), ('parallel', 'mesh.py'),
                   ('parallel', 'collectives.py'), ('ops', 'ulysses_attention.py'),
                   ('examples', 'long_context.py'), ('serializers.py',),
                   ('workers', '__init__.py'), ('workers', 'exec_in_new_process.py'),
                   ('workers', 'process_pool.py'), ('fs.py',), ('hdfs.py',),
                   ('service', '__init__.py'), ('service', 'protocol.py'),
                   ('service', 'placement.py'), ('service', 'peer_cache.py'),
                   ('service', 'dispatcher.py'), ('service', 'worker_server.py'),
                   ('service', 'service_pool.py'), ('service', 'daemon.py'),
                   ('service', 'supervisor.py'), ('service', 'standby.py'),
                   ('service', '__main__.py')):
        assert os.path.join('petastorm_tpu_torch', *module) in rel
    assert len(rel) > 20


@pytest.mark.parametrize('path', [os.path.relpath(p, ROOT) for p in _sources()])
def test_module_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(os.path.join(ROOT, path))) & set(FORBIDDEN))
    assert not bad, '%s imports %s' % (path, bad)


def test_spawned_decode_workers_load_nothing_of_jax(tmp_path):
    """A process-pool read's workers, at check-in (their worker args loaded,
    the readahead plane attached): no JAX, no JAX package, no torch, and
    no card."""
    from tests.torch_telemetry_common import write_small_dataset
    from petastorm_tpu_torch.reader import make_batch_reader
    url = 'file://%s/ds' % tmp_path
    write_small_dataset(url, rows=40)
    with make_batch_reader(url, reader_pool_type='process', workers_count=2) as reader:
        reports = list(reader._pool.worker_reports)
        assert sorted(int(i) for b in reader for i in b.id) == list(range(40))
    assert len(reports) == 2
    for report in reports:
        assert not set(report['modules']) & set(FORBIDDEN + ('torch',)), report['modules']
        assert 'petastorm_tpu_torch' in report['modules']
        assert report['cuda_visible_devices'] == ''


@pytest.mark.parametrize('launch', ['spawned', 'cli', 'daemon-cli'])
def test_worker_servers_load_nothing_of_jax(launch):
    """The decode service's worker servers, spawned by a ``ServicePool``,
    started through the CLI, or supervised by the standing daemon's CLI: no
    JAX, no JAX package, no torch, and no card (``CUDA_VISIBLE_DEVICES=''``)
    in the process that decodes."""
    import subprocess
    import sys
    from petastorm_tpu_torch.service import DaemonClientPool, ServicePool
    from petastorm_tpu_torch.service.protocol import free_tcp_port
    from petastorm_tpu_torch.workers import EmptyResultError
    from tests.torch_stub_workers import EnvironmentProbeWorker
    procs = []
    if launch == 'daemon-cli':
        endpoint = 'tcp://127.0.0.1:%d' % free_tcp_port()
        env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES='0')
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'petastorm_tpu_torch.service', '--endpoint', endpoint,
             '--workers', '2', '--heartbeat-interval', '0.2'], env=env))
        pool = DaemonClientPool(endpoint, heartbeat_interval_s=0.2, connect_timeout_s=60)
    elif launch == 'cli':
        endpoint = 'tcp://127.0.0.1:%d' % free_tcp_port()
        env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES='0')
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'petastorm_tpu_torch.service.worker_server', '--endpoint',
             endpoint, '--parent-pid', str(os.getpid()), '--heartbeat-interval', '0.2'],
            env=env))
        pool = ServicePool(endpoint=endpoint, expected_workers=1, connect_timeout_s=60)
    else:
        pool = ServicePool(spawn_local_workers=2, connect_timeout_s=60)
    published = []
    try:
        pool.start(EnvironmentProbeWorker)
        for i in range(4):
            pool.ventilate(i)
        while True:
            try:
                published.append(pool.get_results(timeout=60))
            except EmptyResultError:
                break
    finally:
        pool.stop()
        pool.join()
        for proc in procs:
            proc.terminate()
            proc.wait(timeout=30)
    assert sorted(p['value'] for p in published) == [0, 1, 2, 3]
    assert os.getpid() not in {p['pid'] for p in published}
    for p in published:
        assert p['cuda_visible_devices'] == '', p
        assert not (p['jax'] or p['petastorm_tpu'] or p['torch']), p


@pytest.mark.parametrize('path', [os.path.relpath(p, ROOT) for p in _sources()
                                  if os.sep + 'analysis' + os.sep in p])
def test_analyzer_imports_only_the_stdlib_and_the_names(path):
    """pipecheck stays stdlib-only, as the reference's is: of the port it
    reads only its own modules and the one registry, and no torch."""
    roots = set(_imported_roots(os.path.join(ROOT, path)))
    assert not roots & {'torch', 'triton', 'numpy', 'pyarrow'}, (path, roots)
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    port = {node.module for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.module
            and node.module.split('.')[0] == 'petastorm_tpu_torch'}
    assert all(m.startswith('petastorm_tpu_torch.analysis')
               or m == 'petastorm_tpu_torch.telemetry.names' for m in port), (path, port)


def test_port_stage_names_are_the_references():
    """Every literal ``span(...)`` stage in the port is in its copy of the
    stage names, and that copy agrees with the JAX package's contract."""
    from petastorm_tpu.analysis.contracts import STAGES as JAX_STAGES
    from petastorm_tpu_torch.telemetry.names import STAGES
    assert set(STAGES) <= set(JAX_STAGES)
    recorded = set()
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and getattr(node.func, 'id', None) == 'span'
                    and node.args and isinstance(node.args[0], ast.Constant)):
                recorded.add(node.args[0].value)
    assert recorded == set(STAGES)


def test_port_event_names_are_the_references():
    """Every literal event the port records through ``record_complete`` /
    ``record_instant`` is a stage or an event name of its copy, and that
    copy is within the JAX package's event names."""
    from petastorm_tpu.analysis.contracts import EVENT_NAMES as JAX_EVENT_NAMES
    from petastorm_tpu_torch.telemetry.names import EVENT_NAMES, STAGES
    assert set(EVENT_NAMES) <= set(JAX_EVENT_NAMES)
    recorded = set()
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, 'attr', None) in ('record_complete', 'record_instant')
                    and node.args and isinstance(node.args[0], ast.Constant)):
                recorded.add(node.args[0].value)
    # the decode service's dispatcher stamps an item's lifecycle and the
    # job registry's changes, and the standby its failover (the supervisor
    # records its actions under names it passes in)
    assert recorded == {'queue_wait', 'mixture_pull', 'autotune_decision', 'dispatch',
                        'reventilate', 'retry', 'poisoned', 'done', 'duplicate_done',
                        'job_register', 'job_gone', 'job_preempt', 'standby_promote',
                        'endpoint_takeover'}
    assert recorded <= set(STAGES) | set(EVENT_NAMES)


def test_port_anomaly_kinds_are_the_references():
    """Every literal kind the port records (``record_anomaly(...)`` and the
    detector's ``_fire(...)``) is a key of its copy of ``ANOMALY_KINDS``,
    and that copy equals the JAX package's, runbook headings included."""
    from petastorm_tpu.analysis.contracts import ANOMALY_KINDS as JAX_ANOMALY_KINDS
    from petastorm_tpu_torch.telemetry.names import ANOMALY_KINDS
    assert ANOMALY_KINDS == JAX_ANOMALY_KINDS
    recorded = set()
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, 'attr', getattr(node.func, 'id', None))
                    in ('record_anomaly', '_fire')
                    and node.args and isinstance(node.args[0], ast.Constant)):
                recorded.add(node.args[0].value)
    assert recorded == {'queue_saturated', 'h2d_starvation', 'throughput_collapse',
                        'stall_flap', 'heartbeat_gap', 'slo_breach', 'cache_degraded',
                        'row_group_poisoned', 'job_lease_expired', 'worker_flapping',
                        'dispatcher_failover'}
    assert recorded <= set(ANOMALY_KINDS)


def test_port_knobs_are_the_references():
    """The live plane's knobs are registered in the port, and every knob
    the port registers is one the JAX package registers."""
    from petastorm_tpu.analysis.contracts import KNOWN_KNOBS as JAX_KNOBS
    from petastorm_tpu_torch.telemetry.names import KNOWN_KNOBS
    assert KNOWN_KNOBS <= set(JAX_KNOBS)
    assert {'PETASTORM_TPU_OBS_PORT', 'PETASTORM_TPU_OBS_HOST', 'PETASTORM_TPU_OBS_WINDOW_SEC',
            'PETASTORM_TPU_OBS_WINDOWS', 'PETASTORM_TPU_OBS_SATURATED_SHARE',
            'PETASTORM_TPU_OBS_COLLAPSE_FRAC', 'PETASTORM_TPU_OBS_FLAP_FLIPS',
            'PETASTORM_TPU_OBS_LOG_DIR', 'PETASTORM_TPU_OBS_LOG_MB',
            'PETASTORM_TPU_SLO'} <= KNOWN_KNOBS
