"""Hello-world writes and reads with petastorm_tpu_torch.

Counterpart of ``examples/hello_world/``: a tiny petastorm dataset
(scalar, PNG image and ragged 4-d array fields) read row by row with
``make_reader`` in Python and through :class:`~petastorm_tpu_torch.pytorch.DataLoader`
onto the card; and a plain Parquet store read by row-group with
``make_batch_reader`` in Python and through
:class:`~petastorm_tpu_torch.pytorch.BatchedDataLoader`.

    python -m petastorm_tpu_torch.examples.hello_world --consumer torch
"""

import argparse

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

HelloWorldSchema = Unischema('HelloWorldSchema', [
    UnischemaField('id', np.int32, (), ScalarCodec(pa.int32()), False),
    UnischemaField('image1', np.uint8, (128, 256, 3), CompressedImageCodec('png'), False),
    UnischemaField('array_4d', np.uint8, (None, 128, 30, None), NdarrayCodec(), False),
])


def row_generator(x):
    """One row of the hello-world dataset."""
    rng = np.random.RandomState(x)
    return {'id': x,
            'image1': rng.randint(0, 255, dtype=np.uint8, size=(128, 256, 3)),
            'array_4d': rng.randint(0, 255, dtype=np.uint8, size=(4, 128, 30, 3))}


def generate_petastorm_dataset(output_url='file:///tmp/hello_world_dataset',
                               num_rows=10, rowgroup_size_rows=5):
    """Write the hello-world dataset (the reference also indexes its ``id``
    column for ``rowgroup_selector=``, which is ROADMAP item 10)."""
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
    write_dataset(output_url, HelloWorldSchema,
                  [row_generator(i) for i in range(num_rows)],
                  rowgroup_size_rows=rowgroup_size_rows)
    print('Dataset written to %s' % output_url)


def python_hello_world(dataset_url='file:///tmp/hello_world_dataset'):
    """The first row, read with ``make_reader``."""
    from petastorm_tpu_torch.reader import make_reader
    with make_reader(dataset_url) as reader:
        for row in reader:
            print(row.id, row.image1.shape, row.array_4d.shape)
            return row


def torch_hello_world(dataset_url='file:///tmp/hello_world_dataset', device=None):
    """The first batch of 4 ids, through ``DataLoader`` onto ``device``
    (None: the card)."""
    from petastorm_tpu_torch.pytorch import DataLoader
    from petastorm_tpu_torch.reader import make_reader
    with DataLoader(make_reader(dataset_url, schema_fields=['^id$']), batch_size=4,
                    device=device) as loader:
        batch = next(iter(loader))
        print('torch ids:', batch['id'])
        return batch


def generate_external_dataset(output_url='file:///tmp/external_dataset',
                              num_rows=100, rows_per_file=25):
    """Plain Parquet files of ``(id, value1, value2)`` rows, with no
    petastorm metadata."""
    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
    fs, path = get_filesystem_and_path_or_paths(output_url)
    fs.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(0)
    for start in range(0, num_rows, rows_per_file):
        ids = np.arange(start, min(start + rows_per_file, num_rows))
        table = pa.table({'id': ids.astype(np.int64),
                          'value1': rng.randint(0, 255, len(ids)).astype(np.int32),
                          'value2': rng.rand(len(ids)).astype(np.float64)})
        with fs.open('%s/part-%05d.parquet' % (path, start), 'wb') as f:
            pq.write_table(table, f)
    print('External dataset written to %s' % output_url)


def external_python_hello_world(dataset_url='file:///tmp/external_dataset'):
    """Every row-group of a plain Parquet store, read with
    ``make_batch_reader``; returns the ids."""
    from petastorm_tpu_torch.reader import make_batch_reader
    ids = []
    with make_batch_reader(dataset_url) as reader:
        for batch in reader:
            print('batch of %d rows; first id: %d' % (len(batch.id), batch.id[0]))
            ids.extend(batch.id.tolist())
    return ids


def external_pytorch_hello_world(dataset_url='file:///tmp/external_dataset', device=None):
    """The first batch of 16 rows of a plain Parquet store, through
    ``BatchedDataLoader`` onto ``device`` (None: the card)."""
    from petastorm_tpu_torch.pytorch import BatchedDataLoader
    from petastorm_tpu_torch.reader import make_batch_reader
    with BatchedDataLoader(make_batch_reader(dataset_url), batch_size=16,
                           device=device) as loader:
        for batch in loader:
            print('id batch: %s' % batch['id'][:5])
            return batch


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--dataset-url', default='file:///tmp/hello_world_dataset')
    parser.add_argument('--external-url', default='file:///tmp/external_dataset')
    parser.add_argument('--consumer', default='python',
                        choices=['python', 'torch', 'external-python', 'external-torch'])
    parser.add_argument('--device', default=None)
    args = parser.parse_args()
    if args.consumer.startswith('external'):
        generate_external_dataset(args.external_url)
    else:
        generate_petastorm_dataset(args.dataset_url)
    if args.consumer == 'python':
        python_hello_world(args.dataset_url)
    elif args.consumer == 'torch':
        torch_hello_world(args.dataset_url, device=args.device)
    elif args.consumer == 'external-python':
        external_python_hello_world(args.external_url)
    else:
        external_pytorch_hello_world(args.external_url, device=args.device)
