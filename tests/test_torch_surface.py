"""The port's public surface against the JAX package's: top-level exports,
``Reader.cleanup``/``exit``, ``make_torch_loader``'s positional order,
the schema helpers ``UnischemaField.is_scalar``,
``Unischema.as_arrow_schema`` and ``insert_explicit_nulls``, a pool
instance as ``reader_pool_type``, the ``ops``/``models`` exports, and the
signatures of ``ConcurrentVentilator`` (with its ``error``),
``TrainCheckpointer.save(force=)``, the flash entry points'
``force_kernel=``, and the readahead and autotune seams
(``Reader.ventilate_extra``/``set_ventilate_extra``, the decoder-thread
override, ``TorchLoader.autotune_report``, ``set_num_slots``, the public
names of ``readahead`` and ``device.autotune``), and the names of item
10b (the ETL tools) where the reference exports them."""

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


# -- a pool instance as reader_pool_type ---------------------------------------


def _ten_rows(tmp_path):
    from tests.torch_telemetry_common import write_small_dataset
    return write_small_dataset('file://%s/ten' % tmp_path, rows=10, rowgroup_size_rows=4)


def test_reader_takes_a_pool_instance(tmp_path):
    from petastorm_tpu.workers.thread_pool import ThreadPool as JaxThreadPool
    from petastorm_tpu_torch.workers.thread_pool import ThreadPool
    url = _ten_rows(tmp_path)
    rows = {}
    for package, make, pool in (('jax', petastorm_tpu.make_batch_reader, JaxThreadPool(2)),
                                ('torch', petastorm_tpu_torch.make_batch_reader, ThreadPool(2))):
        with make(url, reader_pool_type=pool, shuffle_row_groups=False) as reader:
            assert reader.diagnostics == pool.diagnostics
            rows[package] = sorted((int(i), x.tobytes()) for b in reader
                                   for i, x in zip(b.id, b.x))
    assert rows['torch'] == rows['jax'] and len(rows['torch']) == 10


def test_a_pool_instance_without_the_contract_is_refused(tmp_path):
    url = _ten_rows(tmp_path)
    for make in (petastorm_tpu.make_batch_reader, petastorm_tpu_torch.make_batch_reader):
        with pytest.raises(ValueError, match="lacks pool contract member.*'get_results'"):
            make(url, reader_pool_type=object())


# -- the subpackages' exports ------------------------------------------------------

#: reference exports the port reaches at their module only: ``ring_attention``
#: shares its module's name, and a lazily resolved package attribute is
#: replaced by the submodule once anything imports it
#: (``petastorm_tpu_torch.ops.ring_attention.ring_attention``)
ITEM_8 = {'ring_attention'}


@pytest.mark.parametrize('package', ['ops', 'models'])
def test_subpackage_exports_are_the_references(package):
    import importlib
    ref = importlib.import_module('petastorm_tpu.' + package)
    port = importlib.import_module('petastorm_tpu_torch.' + package)
    want = {name for name in vars(ref) if not name.startswith('_')
            and callable(getattr(ref, name)) and not inspect.ismodule(getattr(ref, name))}
    want -= ITEM_8
    # the port initializes parameters through init_transformer/init_vit
    want -= {'init_transformer_params', 'init_vit_params'}
    assert set(port.__all__) == want
    for name in port.__all__:
        obj = getattr(port, name)
        assert obj.__module__.startswith('petastorm_tpu_torch.%s.' % package), name
    with pytest.raises(AttributeError, match='no attribute'):
        getattr(port, 'not_an_export')


def test_subpackage_import_stays_light():
    """``import petastorm_tpu_torch.ops`` (or ``.models``) loads none of
    their modules until a name is asked for."""
    code = ('import sys, petastorm_tpu_torch.ops, petastorm_tpu_torch.models; '
            'print(sorted(m for m in sys.modules if m.startswith(('
            '"petastorm_tpu_torch.ops.", "petastorm_tpu_torch.models."))))')
    out = subprocess.run([sys.executable, '-c', code], check=True, capture_output=True,
                         text=True, timeout=120).stdout
    assert out.strip() == '[]'


# -- signatures -------------------------------------------------------------------


def test_ventilator_signature_is_the_references():
    from petastorm_tpu.workers.ventilator import ConcurrentVentilator as JaxVentilator
    from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator
    assert list(inspect.signature(ConcurrentVentilator).parameters) == \
        list(inspect.signature(JaxVentilator).parameters)


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_ventilator_keeps_the_error_that_killed_it(package):
    """A ``ventilate_fn`` dying on the 3rd item: ventilation reads as
    completed (consumers drain and stop) and ``error`` is the exception,
    so a cut-short epoch is told from a finished one."""
    import time
    if package == 'jax':
        from petastorm_tpu.workers.ventilator import ConcurrentVentilator
    else:
        from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator
    seen = []

    def ventilate(item):
        if len(seen) == 2:
            raise RuntimeError('ventilation died on item %d' % item)
        seen.append(item)

    finished = ConcurrentVentilator(lambda item: None, [{'item': i} for i in range(3)])
    vent = ConcurrentVentilator(ventilate, [{'item': i} for i in range(5)])
    assert vent.error is None
    for v in (finished, vent):
        v.start()
    deadline = time.monotonic() + 10
    while not (vent.completed() and finished.completed()) and time.monotonic() < deadline:
        for v in (finished, vent):
            v.processed_item()
        time.sleep(0.01)
    assert vent.completed() and finished.completed()
    assert finished.error is None
    assert isinstance(vent.error, RuntimeError) and 'item 2' in str(vent.error)
    assert seen == [0, 1]
    for v in (finished, vent):
        v.stop()


def test_checkpoint_save_takes_force(tmp_path):
    import os
    from petastorm_tpu.jax.checkpoint import TrainCheckpointer as JaxCheckpointer
    from petastorm_tpu_torch.checkpoint import TrainCheckpointer
    want = inspect.signature(JaxCheckpointer.save).parameters
    got = inspect.signature(TrainCheckpointer.save).parameters
    assert list(got) == list(want) and got['force'].default is want['force'].default is False
    import torch
    with TrainCheckpointer(str(tmp_path / 'ckpt')) as ckpt:
        state = {'w': torch.zeros(2)}
        assert ckpt.save(3, state) == os.path.join(str(tmp_path / 'ckpt'), '3')
        # not after the latest step: skipped, as orbax's save returns False
        assert ckpt.save(2, state) is None and ckpt.all_steps() == [3]
        assert ckpt.save(2, state, force=True) == os.path.join(str(tmp_path / 'ckpt'), '2')
        assert ckpt.all_steps() == [2, 3]


@pytest.mark.parametrize('name', ['flash_attention_fused', 'flash_causal_attention'])
def test_flash_entry_points_take_force_kernel(name):
    import torch
    from petastorm_tpu.ops import flash_attention as jax_flash
    from petastorm_tpu_torch.ops import flash_attention as torch_flash
    fn = getattr(torch_flash, name)
    want = inspect.signature(getattr(jax_flash, name)).parameters
    got = inspect.signature(fn).parameters
    assert list(got) == list(want) and got['force_kernel'].default is False
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 16, 2, 8, generator=gen) for _ in range(3))
    plain = fn(q, k, v)
    assert torch.equal(fn(q, k, v, force_kernel=False), plain)
    # a CPU tensor has no kernel: forcing it raises, never a silent fallback
    with pytest.raises(RuntimeError, match=r'force_kernel=True\) needs CUDA tensors'):
        fn(q, k, v, force_kernel=True)


# -- the readahead and autotune seams -------------------------------------------


def _members(path):
    """``module:attr[.attr]`` of either package to the object."""
    import importlib
    module, _, attrs = path.partition(':')
    obj = importlib.import_module(module)
    for attr in attrs.split('.'):
        obj = getattr(obj, attr)
    return obj


SEAMS = {
    'Reader.set_ventilate_extra': ('petastorm_tpu.reader:Reader.set_ventilate_extra',
                                   'petastorm_tpu_torch.reader:Reader.set_ventilate_extra'),
    'set_image_decoder_threads_override': (
        'petastorm_tpu.codecs:set_image_decoder_threads_override',
        'petastorm_tpu_torch.codecs:set_image_decoder_threads_override'),
    'image_decoder_threads_from_knob': (
        'petastorm_tpu.codecs:image_decoder_threads_from_knob',
        'petastorm_tpu_torch.codecs:image_decoder_threads_from_knob'),
    'image_decoder_threads': ('petastorm_tpu.codecs:image_decoder_threads',
                              'petastorm_tpu_torch.codecs:image_decoder_threads'),
    'autotune_report': ('petastorm_tpu.jax.loader:JaxLoader.autotune_report',
                        'petastorm_tpu_torch.device.loader:TorchLoader.autotune_report'),
    'set_num_slots': ('petastorm_tpu.jax.staging:StagingEngine.set_num_slots',
                      'petastorm_tpu_torch.device.staging:StagingEngine.set_num_slots'),
}
SEAMS.update({
    'readahead.%s' % name: ('petastorm_tpu.readahead:%s' % name,
                            'petastorm_tpu_torch.readahead:%s' % name)
    for name in ('build_plan', 'attach', 'release', 'coalesce_ranges', 'count_degrade',
                 'current_depth', 'health_snapshot', 'live_manager_count', 'pool_status',
                 'readahead_enabled', 'set_depth_override', 'readahead_depth',
                 'readahead_max_depth', 'readahead_threads', 'pool_budget_bytes', 'gap_bytes',
                 'max_range_bytes', 'refresh_readahead', 'ReadaheadManager',
                 'ReadaheadManager.observe', 'ReadaheadManager.serve',
                 'ReadaheadManager.close', 'ReadaheadManager.acquire',
                 'ReadaheadManager.release')})
SEAMS.update({
    'autotune.%s' % name: ('petastorm_tpu.jax.autotune:%s' % name,
                           'petastorm_tpu_torch.device.autotune:%s' % name)
    for name in ('autotune_enabled', 'autotune_window_sec', 'autotune_max_slots',
                 'autotune_max_prefetch', 'refresh_autotune', 'record_decision',
                 'recent_decisions', 'decision_counts', 'StagingAutotuner',
                 'StagingAutotuner.apply_learned', 'StagingAutotuner.maybe_tick',
                 'StagingAutotuner.tick', 'StagingAutotuner.observe', 'StagingAutotuner.close',
                 'StagingAutotuner.summary')})


@pytest.mark.parametrize('name', sorted(SEAMS))
def test_readahead_and_autotune_seams_are_the_references(name):
    want, got = (_members(path) for path in SEAMS[name])
    assert inspect.signature(got) == inspect.signature(want)


def test_ventilate_extra_is_a_property_on_both_readers():
    from petastorm_tpu.reader import Reader as JaxReader
    from petastorm_tpu_torch.reader import Reader
    assert isinstance(JaxReader.ventilate_extra, property)
    assert isinstance(Reader.ventilate_extra, property)


def test_readahead_exports_the_references_names():
    from petastorm_tpu import readahead as jax_readahead
    from petastorm_tpu_torch import readahead
    assert set(jax_readahead.__all__) <= set(readahead.__all__)
    for name in readahead.__all__:
        assert hasattr(readahead, name)
    for name in ('READAHEAD_HITS', 'READAHEAD_MISSES', 'READAHEAD_BYTES',
                 'READAHEAD_COALESCED_READS', 'READAHEAD_DEGRADED', 'READAHEAD_POOL_BYTES'):
        assert getattr(readahead, name) == getattr(jax_readahead, name)
    from petastorm_tpu.jax import autotune as jax_autotune
    from petastorm_tpu_torch.device import autotune
    assert autotune.AUTOTUNE_DECISIONS == jax_autotune.AUTOTUNE_DECISIONS
    assert autotune._MAX_INFLIGHT_EXTRA == jax_autotune._MAX_INFLIGHT_EXTRA
    assert autotune._READAHEAD_POOL_PRESSURE == jax_autotune._READAHEAD_POOL_PRESSURE


# -- the reference's names the port dropped (ROADMAP Queue 3) ------------------------


def test_reader_positions_are_the_references():
    """``Reader.__init__`` takes ``rowgroup_selector`` and
    ``poison_policy`` at the reference's positions, and its tail in the
    reference's order."""
    from petastorm_tpu.reader import Reader as JaxReader
    from petastorm_tpu_torch.reader import Reader
    assert list(inspect.signature(Reader.__init__).parameters) == \
        list(inspect.signature(JaxReader.__init__).parameters)


# the ids are those of when the selector still raised item 10
@pytest.mark.parametrize('kwarg,item', [('rowgroup_selector', None), ('poison_policy', 9)],
                         ids=['rowgroup_selector-10', 'poison_policy-9'])
def test_reader_refuses_what_it_lacks(scalar_dataset, kwarg, item):
    """``poison_policy`` raises its item; the selector is ported, and a
    dataset without a row-group index refuses it as the JAX reader does."""
    from petastorm_tpu.etl.dataset_metadata import ParquetDatasetInfo as JaxInfo
    from petastorm_tpu.reader import Reader as JaxReader
    from petastorm_tpu_torch.errors import MetadataError
    from petastorm_tpu_torch.etl.dataset_metadata import ParquetDatasetInfo
    from petastorm_tpu_torch.reader import Reader
    from petastorm_tpu_torch.selectors import SingleIndexSelector
    info = ParquetDatasetInfo(scalar_dataset.url)
    if item is not None:
        with pytest.raises(NotImplementedError, match=r'ROADMAP.md: Queue 1 item %d,' % item):
            Reader(info, reader_pool_type='dummy', **{kwarg: 'skip'})
        return
    # the ninth positional argument is the selector, as in the reference
    for reader, dataset_info, error in ((Reader, info, MetadataError),
                                        (JaxReader, JaxInfo(scalar_dataset.url), Exception)):
        with pytest.raises(error, match='carries no row-group index'):
            reader(dataset_info, None, 'dummy', None, 50, False, 1, None,
                   SingleIndexSelector('id_index', ['3']))


def test_no_item_10_is_left():
    """ROADMAP item 10 is done: ``ROADMAP_ITEMS`` has no entry for it and
    no ``unported(..., 10)`` is left in the port."""
    import ast
    import os
    from petastorm_tpu_torch import errors
    assert 10 not in errors.ROADMAP_ITEMS and set(errors.ROADMAP_ITEMS) == {9, 11}
    root = os.path.dirname(os.path.abspath(petastorm_tpu_torch.__file__))
    items = set()
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith('.py'):
                continue
            with open(os.path.join(dirpath, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call) and getattr(node.func, 'id', None) == 'unported'
                        and len(node.args) == 2 and isinstance(node.args[1], ast.Constant)):
                    items.add(node.args[1].value)
    assert items == {9, 11}


def test_what_is_left_of_item_9_is_the_service():
    """ROADMAP items 9a (the process pool) and 9b (filesystems) are done:
    ``fs.py`` and ``hdfs.py`` raise no ``unported``, and every
    ``unported(..., 9)`` left in the port names the service."""
    import ast
    import os
    from petastorm_tpu_torch import errors
    assert 'service' in errors.ROADMAP_ITEMS[9]
    root = os.path.dirname(os.path.abspath(petastorm_tpu_torch.__file__))
    left = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith('.py'):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call) and getattr(node.func, 'id', None) == 'unported'
                        and len(node.args) == 2 and isinstance(node.args[1], ast.Constant)
                        and node.args[1].value == 9):
                    left['%s:%d' % (os.path.relpath(path, root), node.lineno)] = \
                        ast.unparse(node.args[0])
    assert not [where for where in left if where.split(':')[0] in ('fs.py', 'hdfs.py')], left
    assert sorted(where.split(':')[0] for where in left) == [
        os.path.join('mixture', 'engine.py'), 'reader.py', 'reader.py',
        os.path.join('write', 'writer.py')], left
    for where, feature in left.items():
        assert 'service' in feature.lower(), (where, feature)


@pytest.mark.parametrize('module,names', [
    ('errors', ('MetadataGenerationError', 'MetadataError', 'NoDataAvailableError')),
    ('etl', ('RowGroupIndexerBase',)),
    ('etl.rowgroup_indexers', ('SingleFieldIndexer', 'FieldNotNullIndexer',
                               'indexer_from_json')),
    ('etl.rowgroup_indexing', ('build_rowgroup_index', 'get_row_group_indexes',
                               'ROWGROUPS_INDEX_KEY')),
    ('selectors', ('RowGroupSelectorBase', 'SingleIndexSelector', 'IntersectIndexSelector',
                   'UnionIndexSelector')),
    ('etl.legacy', ('depickle_legacy_unischema', 'pickle_unischema_for_reference')),
    ('etl.metadata_util', ('print_metadata', 'main')),
    ('etl.petastorm_generate_metadata', ('generate_petastorm_metadata', 'main')),
    ('tools.copy_dataset', ('copy_dataset', 'main')),
    ('tools.spark_session_cli', ('add_configure_spark_arguments', 'configure_spark',
                                 'parse_session_config')),
    ('codecs', ('ARROW_TO_SPARK_TYPE_NAME',)),
])
def test_etl_tools_export_the_references_names(module, names):
    """Item 10b's names sit where the reference exports them, with the
    reference's signatures and, for the error, its base class."""
    import importlib
    ref = importlib.import_module('petastorm_tpu.' + module)
    port = importlib.import_module('petastorm_tpu_torch.' + module)
    for name in names:
        assert hasattr(ref, name), name
        obj = getattr(port, name)
        if inspect.isfunction(obj):
            assert inspect.signature(obj) == inspect.signature(getattr(ref, name)), name
        elif inspect.isclass(obj):
            assert [c.__name__ for c in obj.__mro__] == \
                [c.__name__ for c in getattr(ref, name).__mro__], name
        else:
            assert obj == getattr(ref, name), name


def test_current_trace_id_is_the_references():
    from petastorm_tpu.telemetry import tracing as jax_tracing
    from petastorm_tpu_torch.telemetry import tracing
    assert tracing.current_trace_id() is None is jax_tracing.current_trace_id()
    ctx = tracing.TraceContext('run-e0-i7', 7, 0, None)
    with tracing.activate(ctx, 'main'):
        assert tracing.current_trace_id() == 'run-e0-i7'
    assert tracing.current_trace_id() is None


def test_flight_recorder_clear_is_the_references():
    from petastorm_tpu.telemetry.recorder import FlightRecorder as JaxRecorder
    from petastorm_tpu_torch.telemetry.recorder import FlightRecorder
    for recorder in (FlightRecorder(), JaxRecorder()):
        recorder.add({'name': 'io'})
        recorder.add({'name': 'decode'})
        assert recorder.clear() is None
        assert len(recorder) == 0 and recorder.snapshot() == []


@pytest.mark.parametrize('base,subclasses', [
    ('buffers.BatchedShufflingBufferBase',
     ('buffers.BatchedNoopShufflingBuffer', 'buffers.BatchedRandomShufflingBuffer')),
    ('workers.ventilator.Ventilator', ('workers.ventilator.ConcurrentVentilator',)),
])
def test_base_classes_are_the_references(base, subclasses):
    import importlib

    def resolve(package, dotted):
        module, _, name = ('%s.%s' % (package, dotted)).rpartition('.')
        return getattr(importlib.import_module(module), name)

    port_base, jax_base = resolve('petastorm_tpu_torch', base), resolve('petastorm_tpu', base)
    assert port_base.__abstractmethods__ == jax_base.__abstractmethods__
    for sub in subclasses:
        assert issubclass(resolve('petastorm_tpu_torch', sub), port_base)
    with pytest.raises(TypeError):
        port_base(4)


def test_decode_field_error_is_the_references():
    from petastorm_tpu import errors as jax_errors
    from petastorm_tpu_torch import errors
    assert issubclass(errors.DecodeFieldError, errors.PetastormTpuError)
    assert errors.DecodeFieldError.__mro__[1].__name__ == \
        jax_errors.DecodeFieldError.__mro__[1].__name__


# -- ROADMAP item 8: what the multi-rank slices left ------------------------------


def test_no_item_8_is_left():
    """ROADMAP item 8 is done (decoding a model split over ``'model'`` was
    its last piece): ``ROADMAP_ITEMS`` has no entry for it and no
    ``unported(..., 8)`` is left in the package."""
    import ast
    import os

    import petastorm_tpu_torch
    from petastorm_tpu_torch import errors
    assert 8 not in errors.ROADMAP_ITEMS
    root = os.path.dirname(petastorm_tpu_torch.__file__)
    found = []
    for folder, _, files in os.walk(root):
        for name in files:
            if not name.endswith('.py'):
                continue
            path = os.path.join(folder, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call) and getattr(node.func, 'id', None) == 'unported'
                        and len(node.args) == 2 and isinstance(node.args[1], ast.Constant)
                        and node.args[1].value == 8):
                    found.append(os.path.relpath(path, root))
    assert found == []


def test_seq_axis_config_builds_as_the_references():
    from petastorm_tpu.models import transformer as jt
    from petastorm_tpu_torch.models import transformer as tt
    for impl in ('ring', 'ulysses'):
        ours = tt.TransformerConfig(seq_axis='seq', seq_impl=impl)
        theirs = jt.TransformerConfig(seq_axis='seq', seq_impl=impl)
        assert (ours.seq_axis, ours.seq_impl) == (theirs.seq_axis, theirs.seq_impl)


def _pipelined_calls():
    from petastorm_tpu_torch.models import transformer as tt
    return {name: getattr(tt, name) for name in (
        'init_pipelined_transformer', 'pipelined_transformer_forward',
        'pipelined_transformer_forward_with_aux', 'pipelined_transformer_train_step')}


class _OneDimMesh:
    """A mesh of one named dim seen from the rank at index 0, whose group
    is None (no process group: every collective is the identity)."""

    def __init__(self, name, size):
        self.mesh_dim_names, self._size = (name,), size

    def get_coordinate(self):
        return [0]

    def size(self, dim):
        return self._size

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return 0


@pytest.mark.parametrize('what', ['moe-seq-config', 'moe_forward-seq_axis', 'expert-mesh-dim',
                                  'pipe-mesh-dim'] + sorted(_pipelined_calls()))
def test_what_is_left_of_item_8_raises_it(what):
    """The calls that raised item 8 before expert parallelism and the
    pipeline were ported now build and run on the CPU, each against the
    unsplit model: a sequence-split MoE config, ``moe_forward(seq_axis=)``
    on one shard, an ``'expert'`` and a ``'pipe'`` mesh dim, and the four
    pipelined entry points on one stage."""
    import torch

    from petastorm_tpu.models import transformer as jt
    from petastorm_tpu_torch.models import moe as tm
    from petastorm_tpu_torch.models import transformer as tt
    base = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_seq_len=16,
                dtype=torch.float32)
    dense, moe = tt.TransformerConfig(**base), tt.TransformerConfig(n_experts=4, **base)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 32, (2, 9)))
    if what == 'moe-seq-config':
        ours = tt.TransformerConfig(seq_axis='seq', n_experts=4)
        theirs = jt.TransformerConfig(seq_axis='seq', n_experts=4)
        assert (ours.seq_axis, ours.n_experts) == (theirs.seq_axis, theirs.n_experts)
    elif what == 'moe_forward-seq_axis':
        cfg = tm.MoEConfig(dtype=torch.float32)
        layer = tm.init_moe(0, cfg, device='cpu')
        x = torch.from_numpy(np.random.RandomState(1).randn(2, 4, 64).astype(np.float32))
        with torch.no_grad():
            got = tm.moe_forward(layer, x, cfg, seq_axis='seq', mesh=_OneDimMesh('seq', 1))
            want = tm.moe_forward(layer, x, cfg)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    elif what == 'expert-mesh-dim':
        par = tt.Parallel(moe, _OneDimMesh('expert', 2))
        assert (par.ep, par.ep_rank, par.holds_shards) == (2, 0, True)
        full = torch.arange(4 * 16 * 32, dtype=torch.float32).reshape(4, 16, 32)
        assert torch.equal(par.shard('blocks.0.moe.w_in', full), full[:2])
        assert tt.Parallel(dense, _OneDimMesh('expert', 2)).holds_shards is False
    elif what == 'pipe-mesh-dim':
        assert tt.Parallel(dense, _OneDimMesh('pipe', 2)).pp == 1     # layered: replicated
        par = tt.Parallel(dense, _OneDimMesh('pipe', 2), pipe_axis='pipe')
        assert (par.pp, par.stage, par.holds_shards) == (2, 0, True)
    elif what == 'init_pipelined_transformer':
        stage = tt.init_pipelined_transformer(0, dense, _OneDimMesh('pipe', 2), device='cpu')
        layered = tt.init_transformer(0, dense, 'cpu')
        assert len(stage.blocks) == 1 and stage.first_layer == 0
        for name, value in stage.state_dict().items():
            assert torch.equal(value, layered.state_dict()[name]), name
    else:
        mesh = _OneDimMesh('pipe', 1)
        config = moe if what.endswith('with_aux') else dense
        model = tt.init_pipelined_transformer(0, config, mesh, device='cpu')
        layered = tt.init_transformer(0, config, 'cpu')
        if what == 'pipelined_transformer_train_step':
            loss = tt.pipelined_transformer_train_step(
                model, torch.optim.SGD(model.parameters(), lr=0.0), n_microbatches=2)(tokens)
            want = tt.transformer_loss(layered, tokens)
            want.backward()
            assert abs(float(loss) - want.item()) <= 1e-5
            for name, p in layered.named_parameters():
                torch.testing.assert_close(dict(model.named_parameters())[name].grad, p.grad,
                                           atol=1e-5, rtol=1e-5)
        else:
            with torch.no_grad():
                got = _pipelined_calls()[what](model, tokens, 1)
                want = tt.transformer_forward_with_aux(layered, tokens)
            if what == 'pipelined_transformer_forward':
                torch.testing.assert_close(got, want[0], atol=1e-5, rtol=1e-5)
            else:
                torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5)
                assert abs(float(got[1]) - float(want[1])) <= 1e-5 and float(got[1]) >= 2.0
