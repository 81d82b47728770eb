"""petastorm_tpu_torch.examples.hello_world against the JAX package's
hello-world examples, on the CPU.

Each package writes its hello-world dataset and plain Parquet store from
the same seeded rows; each reads the other's; the row, the first
``DataLoader`` batch and the ``BatchedDataLoader`` batch equal what the
JAX package's readers and bridge give on the same store.
"""

import numpy as np
import pytest
import torch

from examples.hello_world import generate_petastorm_dataset as jax_generate
from examples.hello_world.external_dataset import generate_external_dataset as jax_external
from petastorm_tpu.pytorch import BatchedDataLoader as JaxBatchedDataLoader
from petastorm_tpu.pytorch import DataLoader as JaxDataLoader
from petastorm_tpu.reader import make_batch_reader as jax_batch_reader
from petastorm_tpu.reader import make_reader as jax_reader
from petastorm_tpu_torch.examples import hello_world
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp('hello_world')
    urls = {'torch': 'file://%s/torch' % root, 'torch_external': 'file://%s/torch_ext' % root,
            'jax_external': 'file://%s/jax_ext' % root}
    hello_world.generate_petastorm_dataset(urls['torch'])
    hello_world.generate_external_dataset(urls['torch_external'])
    jax_external.generate_external_dataset(urls['jax_external'])
    return urls


def _assert_row_equal(a, b):
    assert list(a._asdict()) == list(b._asdict())
    for name, value in a._asdict().items():
        other = getattr(b, name)
        assert np.asarray(value).dtype == np.asarray(other).dtype, name
        assert np.array_equal(value, other), name


def test_rows_match_the_jax_generator(stores):
    """The port's hello-world rows are the JAX example's row_generator's."""
    for i in (0, 3, 9):
        want, got = jax_generate.row_generator(i), hello_world.row_generator(i)
        assert sorted(want) == sorted(got)
        assert all(np.array_equal(want[k], got[k]) for k in want)


def test_python_hello_world_reads_the_first_row(stores):
    row = hello_world.python_hello_world(stores['torch'])
    with jax_reader(stores['torch']) as reader:
        want = {int(r.id): r for r in reader}
    _assert_row_equal(want[int(row.id)], row)
    assert row.image1.shape == (128, 256, 3) and row.array_4d.shape == (4, 128, 30, 3)


def test_torch_hello_world_batch(stores):
    batch = hello_world.torch_hello_world(stores['torch'], device='cpu')
    assert batch['id'].dtype == torch.int32 and batch['id'].shape == (4,)
    with JaxDataLoader(jax_reader(stores['torch'], schema_fields=['^id$']), batch_size=4) as loader:
        ids = sorted(i for b in loader for i in b['id'].tolist())
    assert ids == list(range(10)) and set(batch['id'].tolist()) <= set(ids)


def test_external_stores_equal(stores):
    import pyarrow.parquet as pq
    want = pq.read_table(stores['jax_external'][len('file://'):]).to_pandas()
    got = pq.read_table(stores['torch_external'][len('file://'):]).to_pandas()
    assert want.sort_values('id').reset_index(drop=True).equals(
        got.sort_values('id').reset_index(drop=True))


def test_external_python_hello_world(stores):
    ids = hello_world.external_python_hello_world(stores['jax_external'])
    with jax_batch_reader(stores['jax_external']) as reader:
        want = sorted(i for b in reader for i in b.id.tolist())
    assert sorted(ids) == want == list(range(100))


def test_external_pytorch_hello_world(stores):
    got = hello_world.external_pytorch_hello_world(stores['torch_external'], device='cpu')
    with JaxBatchedDataLoader(jax_batch_reader(stores['torch_external'], reader_pool_type='dummy',
                                               shuffle_row_groups=False),
                              batch_size=16) as loader:
        by_id = {}
        for b in loader:
            for j, i in enumerate(b['id'].tolist()):
                by_id[i] = {k: v[j] for k, v in b.items()}
    assert sorted(got) == ['id', 'value1', 'value2'] and len(got['id']) == 16
    for j, i in enumerate(got['id'].tolist()):
        for name in got:
            assert got[name][j].dtype == by_id[i][name].dtype
            assert got[name][j] == by_id[i][name], (i, name)
