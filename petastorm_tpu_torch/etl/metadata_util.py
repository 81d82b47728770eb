"""Print a dataset's stored schema, its row-groups by file and its
row-group indexes (counterpart of ``petastorm_tpu/etl/metadata_util.py``;
the text is the reference's).

Usage: ``python -m petastorm_tpu_torch.etl.metadata_util file:///path``
"""

import argparse
import sys


def print_metadata(dataset_url, print_schema=True, print_row_groups=True,
                   print_index=True, storage_options=None, out=None):
    from petastorm_tpu_torch.errors import MetadataError
    from petastorm_tpu_torch.etl.dataset_metadata import (
        ParquetDatasetInfo, infer_or_load_unischema, load_row_groups,
    )
    from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes

    out = out or sys.stdout
    info = ParquetDatasetInfo(dataset_url, storage_options)
    if print_schema:
        schema = infer_or_load_unischema(info)
        print('Unischema: %s' % schema._name, file=out)
        for field in schema:
            print('  %s: %s %s codec=%s nullable=%s'
                  % (field.name, getattr(field.numpy_dtype, '__name__', field.numpy_dtype),
                     field.shape, type(field.codec).__name__ if field.codec else None,
                     field.nullable), file=out)
    if print_row_groups:
        pieces = load_row_groups(info)
        by_file = {}
        for piece in pieces:
            by_file[piece.path] = by_file.get(piece.path, 0) + 1
        print('Row-groups: %d over %d file(s)' % (len(pieces), len(by_file)), file=out)
        for path in sorted(by_file):
            print('  %s: %d' % (info.relpath(path), by_file[path]), file=out)
    if print_index:
        try:
            indexes = get_row_group_indexes(info)
        except MetadataError:
            print('Row-group indexes: none', file=out)
        else:
            print('Row-group indexes:', file=out)
            for name, indexer in indexes.items():
                print('  %s: fields=%s values=%d'
                      % (name, sorted(indexer.column_names), len(indexer.indexed_values)),
                      file=out)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('dataset_url')
    parser.add_argument('--skip-schema', action='store_true')
    parser.add_argument('--skip-row-groups', action='store_true')
    parser.add_argument('--skip-index', action='store_true')
    args = parser.parse_args(argv)
    print_metadata(args.dataset_url, print_schema=not args.skip_schema,
                   print_row_groups=not args.skip_row_groups,
                   print_index=not args.skip_index)
    return 0


if __name__ == '__main__':
    sys.exit(main())
