"""petastorm_tpu_torch stands alone: no module of the port, and not
chip_smoke.py, imports JAX, Flax, Optax, Orbax or the JAX package."""

import ast
import os

import pytest

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
                   ('workers', 'dummy_pool.py')):
        assert os.path.join('petastorm_tpu_torch', *module) in rel
    assert len(rel) > 20


@pytest.mark.parametrize('path', [os.path.relpath(p, ROOT) for p in _sources()])
def test_module_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(os.path.join(ROOT, path))) & set(FORBIDDEN))
    assert not bad, '%s imports %s' % (path, bad)


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
    assert recorded == {'queue_wait', 'mixture_pull'}
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
                        'stall_flap', 'heartbeat_gap', 'slo_breach'}
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
