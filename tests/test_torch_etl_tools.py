"""The port's ETL tools against the JAX package's, on the CPU:
``tools/copy_dataset.py``, ``etl/petastorm_generate_metadata.py``,
``etl/metadata_util.py`` and ``tools/spark_session_cli.py``.

Each tool runs in both packages on the same source, written once by the
JAX package (40 rows in 8-row groups, one a file: an id, a label of 4
values, a nullable int, a float vector and an 8×8 PNG), into its own
``tmp_path`` directory. Copies equal the reference's: the same part
files, the same footer keys and values, the same rows. (Both packages'
copies read the source on a thread pool, so the row order within the
parts is the order the row-groups arrive in; the source's equal-sized
row-groups keep the footer's counts independent of it.) A generated
footer is the reference's; the printed metadata is the reference's text;
the Spark flags reach a duck-typed builder as they do in the reference;
each ``main()`` runs, and one module runs as ``python -m``.
"""

import argparse
import io
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu import unischema as jax_unischema
from petastorm_tpu.etl import dataset_metadata as jax_meta
from petastorm_tpu.etl import metadata_util as jax_metadata_util
from petastorm_tpu.etl import petastorm_generate_metadata as jax_generate
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu.tools import copy_dataset as jax_copy
from petastorm_tpu.tools import spark_session_cli as jax_spark_cli
from petastorm_tpu_torch import unischema as torch_unischema
from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.etl import dataset_metadata as torch_meta
from petastorm_tpu_torch.etl import metadata_util as torch_metadata_util
from petastorm_tpu_torch.etl import petastorm_generate_metadata as torch_generate
from petastorm_tpu_torch.etl import rowgroup_indexers as torch_indexers
from petastorm_tpu_torch.etl import rowgroup_indexing as torch_indexing
from petastorm_tpu_torch.reader import make_batch_reader
from petastorm_tpu_torch.tools import copy_dataset as torch_copy
from petastorm_tpu_torch.tools import spark_session_cli as torch_spark_cli
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_SCHEMA = jax_unischema.Unischema('ToolSchema', [
    jax_unischema.UnischemaField('id', np.int64, (), jax_codecs.ScalarCodec(pa.int64()), False),
    jax_unischema.UnischemaField('label', np.int32, (), jax_codecs.ScalarCodec(pa.int32()),
                                 False),
    jax_unischema.UnischemaField('maybe', np.int32, (), jax_codecs.ScalarCodec(pa.int32()),
                                 True),
    jax_unischema.UnischemaField('vec', np.float32, (3,), jax_codecs.NdarrayCodec(), False),
    jax_unischema.UnischemaField('img', np.uint8, (8, 8, 3),
                                 jax_codecs.CompressedImageCodec('png'), False),
])
#: the same schema as the port's object, for ``--unischema-class``
TORCH_SCHEMA = torch_unischema.Unischema.from_json_dict(JAX_SCHEMA.to_json_dict())
N_ROWS = 40

PACKAGES = {
    'jax': dict(copy=jax_copy, generate=jax_generate, metadata_util=jax_metadata_util,
                meta=jax_meta, spark_cli=jax_spark_cli, schema='JAX_SCHEMA',
                reader=jax_make_batch_reader),
    'torch': dict(copy=torch_copy, generate=torch_generate,
                  metadata_util=torch_metadata_util, meta=torch_meta,
                  spark_cli=torch_spark_cli, schema='TORCH_SCHEMA', reader=make_batch_reader),
}


def _rows():
    rng = np.random.RandomState(11)
    return [{'id': np.int64(i), 'label': np.int32(i % 4),
             'maybe': None if i % 3 == 0 else np.int32(i * 7),
             'vec': rng.rand(3).astype(np.float32),
             'img': rng.randint(0, 255, (8, 8, 3), np.uint8)} for i in range(N_ROWS)]


@pytest.fixture(scope='module')
def source(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('tool-source')) + '/ds'
    jax_meta.write_dataset(url, JAX_SCHEMA, _rows(), rowgroup_size_rows=8, num_files=5)
    return url


def _url(path):
    return 'file://' + str(path)


def _parts(path):
    """``{relative path: row-groups}`` of every parquet part under ``path``."""
    out = {}
    for dirpath, _, files in os.walk(str(path)):
        for f in files:
            if f.endswith('.parquet'):
                meta = pq.read_metadata(os.path.join(dirpath, f))
                out[os.path.relpath(os.path.join(dirpath, f), str(path))] = meta.num_row_groups
    return out


def _footer(package, url):
    return dict(PACKAGES[package]['meta'].ParquetDatasetInfo(url).common_metadata.metadata)


def _read_rows(url):
    """Every row as ``{field: value}``, sorted by id (cells as lists)."""
    rows = []
    with make_batch_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        for b in reader:
            cols = b._asdict()
            for i in range(len(cols['id'])):
                rows.append({k: (None if v[i] is None else np.asarray(v[i]).tolist())
                             for k, v in cols.items()})
    return sorted(rows, key=lambda r: r['id'])


# -- copy_dataset -------------------------------------------------------------------------

COPY_CASES = {
    'full': dict(),
    'regex': dict(field_regex=['^id$', '^label$', '^vec$']),
    'not-null': dict(field_regex=['^id$', '^maybe$'], not_null_fields=['maybe'],
                     num_files=2),
    'partition-by': dict(field_regex=['^id$', '^label$', '^img$'], partition_by=('label',),
                         rowgroup_size_rows=3),
    'one-file': dict(num_files=1, rowgroup_size_rows=5),
}


@pytest.mark.parametrize('case', sorted(COPY_CASES))
def test_copy_dataset_is_the_references(source, tmp_path, case):
    kw = COPY_CASES[case]
    copied = {}
    for package in ('jax', 'torch'):
        copied[package] = PACKAGES[package]['copy'].copy_dataset(
            source, _url(tmp_path / package), **kw)
    assert copied['torch'] == copied['jax']
    assert copied['torch'] == (N_ROWS - len(range(0, N_ROWS, 3)) if case == 'not-null'
                               else N_ROWS)
    parts = _parts(tmp_path / 'torch')
    assert parts and parts == _parts(tmp_path / 'jax')
    assert _footer('torch', _url(tmp_path / 'torch')) == _footer('jax', _url(tmp_path / 'jax'))
    got = _read_rows(_url(tmp_path / 'torch'))
    assert got == _read_rows(_url(tmp_path / 'jax'))
    source_rows = {r['id']: r for r in _read_rows(source)}
    for row in got:
        want = source_rows[row['id']]
        assert all(row[k] == want[k] for k in row), row['id']
    if case == 'partition-by':
        assert sorted(os.listdir(tmp_path / 'torch')) == \
            ['_common_metadata'] + ['label=%d' % i for i in range(4)]
        # the copy's schema keeps the view's fields
        schema = torch_meta.get_schema_from_dataset_url(_url(tmp_path / 'torch'))
        assert list(schema.fields) == ['id', 'label', 'img']


# -- petastorm_generate_metadata --------------------------------------------------------------


def _plain_store(path):
    """A Parquet store written by pyarrow alone: no petastorm footer."""
    os.makedirs(str(path))
    for f in range(2):
        table = pa.table({'id': pa.array(np.arange(f * 10, f * 10 + 10, dtype=np.int64)),
                          'x': pa.array(np.linspace(0, 1, 10) + f),
                          'name': pa.array(['n%d' % i for i in range(10)])})
        pq.write_table(table, os.path.join(str(path), 'part-%d.parquet' % f),
                       row_group_size=4)
    return _url(path)


def test_generate_metadata_on_a_plain_store(tmp_path):
    schemas = {}
    for package in ('jax', 'torch'):
        url = _plain_store(tmp_path / package)
        with pytest.raises(Exception):
            PACKAGES[package]['meta'].get_schema_from_dataset_url(url)
        schemas[package] = PACKAGES[package]['generate'].generate_petastorm_metadata(url)
    assert schemas['torch'].to_json_dict() == schemas['jax'].to_json_dict()
    got, want = _footer('torch', _url(tmp_path / 'torch')), _footer('jax', _url(tmp_path / 'jax'))
    assert got == want
    stored = torch_meta.get_schema_from_dataset_url(_url(tmp_path / 'torch'))
    assert list(stored.fields) == ['id', 'x', 'name']
    assert len(torch_meta.load_row_groups(torch_meta.ParquetDatasetInfo(
        _url(tmp_path / 'torch')))) == 6


def test_generate_metadata_with_a_class(tmp_path):
    for package in ('jax', 'torch'):
        url = _plain_store(tmp_path / package)
        with pytest.raises(ValueError, match='does not resolve to a Unischema'):
            PACKAGES[package]['generate'].generate_petastorm_metadata(
                url, unischema_class='tests.test_torch_etl_tools.N_ROWS')
    # a copy of the source with its footer lost, regenerated from the class
    for package in ('jax', 'torch'):
        p = PACKAGES[package]
        url = _url(tmp_path / ('copy-' + package))
        p['copy'].copy_dataset(_url_of_source(tmp_path), url)
        os.remove(str(tmp_path / ('copy-' + package) / '_common_metadata'))
        with pytest.raises(Exception):
            p['meta'].get_schema_from_dataset_url(url)
        schema = p['generate'].generate_petastorm_metadata(
            url, unischema_class='tests.test_torch_etl_tools.' + p['schema'])
        assert list(schema.fields) == list(JAX_SCHEMA.fields)
    assert _footer('torch', _url(tmp_path / 'copy-torch')) == \
        _footer('jax', _url(tmp_path / 'copy-jax'))
    assert _read_rows(_url(tmp_path / 'copy-torch')) == _read_rows(_url(tmp_path / 'copy-jax'))


def _url_of_source(tmp_path):
    url = _url(tmp_path / 'source')
    if not os.path.exists(str(tmp_path / 'source')):
        jax_meta.write_dataset(url, JAX_SCHEMA, _rows(), rowgroup_size_rows=8, num_files=5)
    return url


def test_generate_metadata_from_the_stored_footer(tmp_path):
    """Without a class the footer's own schema is written again, with the
    counts of the files now there: the same footer in both packages."""
    for package in ('jax', 'torch'):
        url = _url(tmp_path / package)
        jax_meta.write_dataset(url, JAX_SCHEMA, _rows(), rowgroup_size_rows=8, num_files=5)
        before = _footer(package, url)
        schema = PACKAGES[package]['generate'].generate_petastorm_metadata(url)
        assert schema.to_json_dict() == JAX_SCHEMA.to_json_dict()
        after = _footer(package, url)
        assert sorted(after) == sorted(before)
        for key in (torch_meta.UNISCHEMA_KEY, torch_meta.ROW_GROUPS_PER_FILE_KEY,
                    torch_meta.LEGACY_ROW_GROUPS_PER_FILE_KEY):
            assert after[key] == before[key]
    assert _footer('torch', _url(tmp_path / 'torch')) == _footer('jax', _url(tmp_path / 'jax'))


# -- metadata_util ---------------------------------------------------------------------------


def _printed(package, url, **kw):
    out = io.StringIO()
    PACKAGES[package]['metadata_util'].print_metadata(url, out=out, **kw)
    return out.getvalue()


@pytest.mark.parametrize('flags', [dict(), dict(print_schema=False),
                                   dict(print_row_groups=False, print_index=False)],
                         ids=['all', 'no-schema', 'schema-only'])
def test_print_metadata_is_the_references_text(source, tmp_path, flags):
    text = _printed('torch', source, **flags)
    assert text == _printed('jax', source, **flags)
    if flags.get('print_index', True):
        assert 'Row-group indexes: none' in text
    # with indexes: the port's build, printed by both
    url = _url_of_source(tmp_path)
    torch_indexing.build_rowgroup_index(url, [
        torch_indexers.SingleFieldIndexer('label_index', 'label'),
        torch_indexers.FieldNotNullIndexer('maybe_not_null', 'maybe')])
    text = _printed('torch', url, **flags)
    assert text == _printed('jax', url, **flags)
    if flags.get('print_index', True):
        assert '  label_index: fields=[\'label\'] values=4\n' in text
        assert '  maybe_not_null: fields=[\'maybe\'] values=1\n' in text
    if flags.get('print_row_groups', True):
        assert 'Row-groups: 5 over 5 file(s)\n' in text
    if flags.get('print_schema', True):
        assert text.startswith('Unischema: ToolSchema\n  id: int64 () codec=ScalarCodec')


def test_print_metadata_of_the_pinned_and_a_plain_dataset(tmp_path):
    pinned = 'file://' + os.path.join(ROOT, 'tests', 'data', 'reference_written')
    assert _printed('torch', pinned) == _printed('jax', pinned)
    plain = _plain_store(tmp_path / 'plain')
    assert _printed('torch', plain) == _printed('jax', plain)


# -- spark_session_cli -----------------------------------------------------------------------


class _Builder:
    """A duck-typed ``SparkSession.Builder`` that records its calls."""

    def __init__(self):
        self.calls = []

    def config(self, key, value):
        self.calls.append(('config', key, value))
        return self

    def master(self, url):
        self.calls.append(('master', url))
        return self


@pytest.mark.parametrize('argv', [
    [],
    ['--master', 'local[4]'],
    ['--spark-session-config', 'spark.executor.cores=2', 'spark.executor.memory=10g'],
    ['--master', 'yarn', '--spark-session-config', 'a=b=c'],
], ids=['none', 'master', 'config', 'both'])
def test_spark_session_cli_is_the_references(argv):
    calls, helps = {}, {}
    for package in ('jax', 'torch'):
        cli = PACKAGES[package]['spark_cli']
        parser = argparse.ArgumentParser()
        cli.add_configure_spark_arguments(parser)
        builder = _Builder()
        assert cli.configure_spark(builder, parser.parse_args(argv)) is builder
        calls[package] = builder.calls
        helps[package] = parser.format_help()
    assert calls['torch'] == calls['jax']
    assert helps['torch'] == helps['jax']


def test_spark_session_cli_errors_are_the_references():
    for cli in (jax_spark_cli, torch_spark_cli):
        with pytest.raises(RuntimeError, match='add_configure_spark_arguments'):
            cli.configure_spark(_Builder(), argparse.Namespace(master=None))
        for bad in (['novalue='], ['=v'], ['noequals']):
            with pytest.raises(ValueError, match='key=value'):
                cli.parse_session_config(bad)
        assert cli.parse_session_config(None) == {}
        assert cli.parse_session_config(['k=v=w']) == {'k': 'v=w'}


# -- the CLIs' main() ------------------------------------------------------------------------


def test_each_main(source, tmp_path, capsys):
    printed = {}
    for package in ('jax', 'torch'):
        p = PACKAGES[package]
        target = _url(tmp_path / package)
        assert p['copy'].main([source, target, '--field-regex', '^id$', '^maybe$',
                               '--not-null-fields', 'maybe',
                               '--rowgroup-size-rows', '100']) == 0
        os.remove(str(tmp_path / package / '_common_metadata'))
        assert p['generate'].main([target]) == 0
        capsys.readouterr()
        assert p['metadata_util'].main([target, '--skip-index']) == 0
        printed[package] = capsys.readouterr().out
    assert _parts(tmp_path / 'torch') == _parts(tmp_path / 'jax')
    assert _footer('torch', _url(tmp_path / 'torch')) == _footer('jax', _url(tmp_path / 'jax'))
    assert _read_rows(_url(tmp_path / 'torch')) == _read_rows(_url(tmp_path / 'jax'))
    # the footer was lost: both generate an inferred, codec-less schema
    assert printed['torch'] == printed['jax']
    assert printed['torch'].startswith('Unischema: inferred\n')
    assert 'Row-group indexes' not in printed['torch']
    with pytest.raises(MetadataError):
        torch_indexing.get_row_group_indexes(torch_meta.ParquetDatasetInfo(
            _url(tmp_path / 'torch')))


def test_metadata_util_runs_as_a_module(source):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.etl.metadata_util', source],
                         check=True, capture_output=True, text=True, timeout=120, env=env,
                         cwd=ROOT).stdout
    assert out == _printed('jax', source)
