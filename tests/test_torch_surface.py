"""The port's public surface against the JAX package's: top-level exports,
``Reader.cleanup``/``exit``, ``make_torch_loader``'s positional order and
the schema helpers ``UnischemaField.is_scalar``,
``Unischema.as_arrow_schema`` and ``insert_explicit_nulls``."""

import inspect
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest

import petastorm_tpu
import petastorm_tpu_torch
from petastorm_tpu import unischema as jax_unischema
from petastorm_tpu.jax import make_jax_loader
from petastorm_tpu_torch import unischema as torch_unischema
from petastorm_tpu_torch.device.loader import make_torch_loader

from tests.test_common import TestSchema


@pytest.mark.parametrize('name', ['NoDataAvailableError', 'TransformSpec', 'make_reader',
                                  'make_batch_reader', 'make_torch_loader'])
def test_package_exports_the_references_names(name):
    jax_name = 'make_jax_loader' if name == 'make_torch_loader' else name
    assert hasattr(petastorm_tpu, jax_name)
    assert hasattr(petastorm_tpu_torch, name)


def test_exported_classes_are_the_modules():
    from petastorm_tpu_torch.errors import NoDataAvailableError
    from petastorm_tpu_torch.transform import TransformSpec
    assert petastorm_tpu_torch.NoDataAvailableError is NoDataAvailableError
    assert petastorm_tpu_torch.TransformSpec is TransformSpec


def test_package_import_stays_free_of_the_loader():
    """``import petastorm_tpu_torch`` loads neither torch nor the loader."""
    code = ('import sys, petastorm_tpu_torch; '
            'print(sorted(m for m in sys.modules if m == "torch" '
            'or m.startswith("petastorm_tpu_torch.device")))')
    out = subprocess.run([sys.executable, '-c', code], check=True, capture_output=True,
                         text=True, timeout=120).stdout
    assert out.strip() == '[]'


def test_package_make_torch_loader_reads(scalar_dataset):
    with petastorm_tpu_torch.make_torch_loader(scalar_dataset.url, 25, fields=['^id$'],
                                               reader_pool_type='dummy',
                                               device='cpu') as loader:
        ids = sorted(int(i) for b in loader for i in b['id'])
    assert ids == list(range(100))


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_reader_cleanup_and_exit(scalar_dataset, package):
    make = {'jax': petastorm_tpu.make_batch_reader,
            'torch': petastorm_tpu_torch.make_batch_reader}[package]
    reader = make(scalar_dataset.url, reader_pool_type='dummy')
    assert reader.cleanup() is None
    next(reader)
    reader.exit()
    with pytest.raises(RuntimeError, match='stopped reader'):
        next(reader)


def test_loader_positions_are_make_jax_loaders():
    want = list(inspect.signature(make_jax_loader).parameters)
    got = list(inspect.signature(make_torch_loader).parameters)
    # the reference's order, with device last before **reader_kwargs
    assert got == want[:-1] + ['device', want[-1]]
    assert got[2:4] == ['mesh', 'data_axes']


def test_loader_third_positional_is_mesh(scalar_dataset):
    """A third positional argument binds ``mesh`` in both packages."""
    for make in (make_jax_loader, make_torch_loader):
        with pytest.raises(AttributeError):
            make(scalar_dataset.url, 4, object(), reader_pool_type='dummy')


def _field_pairs():
    for jf in TestSchema:
        tf = torch_unischema.UnischemaField.from_json_dict(jf.to_json_dict())
        yield jf, tf


def test_is_scalar_is_the_references():
    pairs = list(_field_pairs())
    assert any(jf.is_scalar for jf, _ in pairs) and not all(jf.is_scalar for jf, _ in pairs)
    for jf, tf in pairs:
        assert tf.is_scalar == jf.is_scalar, jf.name


def test_as_arrow_schema_is_the_references():
    torch_schema = torch_unischema.Unischema.from_json_dict(TestSchema.to_json_dict())
    want = TestSchema.as_arrow_schema()
    got = torch_schema.as_arrow_schema()
    assert isinstance(got, pa.Schema)
    assert got.equals(want)


@pytest.mark.parametrize('row', [
    {'id': 1},
    {'id': 1, 'string_array_nullable': None},
    {'id': 1, 'string_array_nullable': np.array(['a'])},
], ids=['missing', 'explicit-none', 'present'])
def test_insert_explicit_nulls_is_the_references(row):
    schema_kw = [('id', np.int64, (), None, False),
                 ('string_array_nullable', np.str_, (None,), None, True),
                 ('nullable_scalar', np.int32, (), None, True)]
    schemas = {
        'jax': jax_unischema.Unischema('S', [jax_unischema.UnischemaField(*f)
                                             for f in schema_kw]),
        'torch': torch_unischema.Unischema('S', [torch_unischema.UnischemaField(*f)
                                                 for f in schema_kw])}
    out = {}
    for package, module in (('jax', jax_unischema), ('torch', torch_unischema)):
        d = dict(row)
        assert module.insert_explicit_nulls(schemas[package], d) is d
        out[package] = d
    assert sorted(out['jax']) == sorted(out['torch'])
    for k in out['jax']:
        assert (out['jax'][k] is None) == (out['torch'][k] is None), k


def test_insert_explicit_nulls_refuses_a_missing_required_field():
    f = [('id', np.int64, (), None, False), ('x', np.int32, (), None, True)]
    for module in (jax_unischema, torch_unischema):
        schema = module.Unischema('S', [module.UnischemaField(*a) for a in f])
        with pytest.raises(ValueError, match="Field 'id' is not found in row and is not nullable"):
            module.insert_explicit_nulls(schema, {'x': 1})
