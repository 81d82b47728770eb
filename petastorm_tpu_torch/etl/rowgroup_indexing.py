"""Build and load the row-group indexes stored in a dataset's footer.

Counterpart of ``petastorm_tpu/etl/rowgroup_indexing.py``: one scan over
the row-groups on a thread pool, each decoding only the indexed columns,
and the indexes stored as JSON under the reference's footer key, so
either package reads the other's index.

An index names row-groups by their ordinal in ``load_row_groups``. An
append or a compaction of a manifest-committed dataset renumbers them
and keeps the footer's other entries, so an index built before such a
commit is stale until it is built again (the reference behaves the same).
"""

import json
import logging
from concurrent.futures import ThreadPoolExecutor

import pyarrow.parquet as pq

from petastorm_tpu_torch.codecs import decode_batch_with_nulls
from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.etl.dataset_metadata import (
    ParquetDatasetInfo, add_to_dataset_metadata, get_schema, load_row_groups,
)
from petastorm_tpu_torch.etl.rowgroup_indexers import indexer_from_json

logger = logging.getLogger(__name__)

ROWGROUPS_INDEX_KEY = b'petastorm_tpu.rowgroups_index.v1'


def build_rowgroup_index(dataset_url, indexers, storage_options=None, workers=8):
    """Scan the dataset once and store the indexes in ``_common_metadata``.

    :param indexers: list of
        :class:`~petastorm_tpu_torch.etl.RowGroupIndexerBase` instances.
    """
    info = ParquetDatasetInfo(dataset_url, storage_options)
    schema = get_schema(info)
    pieces = load_row_groups(info)

    needed_columns = sorted({c for ix in indexers for c in ix.column_names})
    missing = [c for c in needed_columns if c not in schema.fields]
    if missing:
        raise ValueError('Indexed fields not in schema: %s' % missing)

    def decode_piece(piece_and_index):
        piece_index, piece = piece_and_index
        file_columns = [c for c in needed_columns if c not in piece.partition_values]
        with info.open(piece.path) as f:
            table = pq.ParquetFile(f).read_row_group(piece.row_group, columns=file_columns)
        columns = {}
        for name in file_columns:
            field = schema.fields[name]
            values = table.column(name).to_pylist()
            # null cells bypass the codec: FieldNotNullIndexer needs them
            columns[name] = (decode_batch_with_nulls(field, values)
                             if field.codec is not None else values)
        n = table.num_rows
        for name in needed_columns:
            if name in piece.partition_values:
                columns[name] = [piece.partition_values[name]] * n
        rows = [{c: columns[c][i] for c in needed_columns} for i in range(n)]
        return piece_index, rows

    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix='petastorm-tpu-torch-index') as pool:
        for piece_index, rows in pool.map(decode_piece, enumerate(pieces)):
            for indexer in indexers:
                indexer.build_index(rows, piece_index)

    payload = json.dumps({ix.index_name: ix.to_json_dict() for ix in indexers})
    add_to_dataset_metadata(info, ROWGROUPS_INDEX_KEY, payload.encode('utf-8'))
    logger.info('Built %d row-group index(es) over %d row-groups', len(indexers), len(pieces))


def get_row_group_indexes(dataset_info):
    """``{index_name: indexer}`` from the footer."""
    cm = dataset_info.common_metadata
    if cm is None or cm.metadata is None or ROWGROUPS_INDEX_KEY not in cm.metadata:
        raise MetadataError('Dataset %r carries no row-group index; run '
                            'build_rowgroup_index first' % dataset_info.url)
    raw = json.loads(cm.metadata[ROWGROUPS_INDEX_KEY].decode('utf-8'))
    return {name: indexer_from_json(d) for name, d in raw.items()}
