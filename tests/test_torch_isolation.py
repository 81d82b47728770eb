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
                   ('weighted_sampling_reader.py',)):
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
