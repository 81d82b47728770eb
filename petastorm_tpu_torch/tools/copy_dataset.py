"""Copy a materialized dataset, optionally transformed (counterpart of
``petastorm_tpu/tools/copy_dataset.py``): a column subset by regex, a
not-null row filter, and a new file, row-group and partition layout. One
row-group at a time streams through the batch reader (each cell decoded)
into a :class:`~petastorm_tpu_torch.etl.dataset_metadata.DatasetWriter`
(each cell encoded again).

Usage: ``python -m petastorm_tpu_torch.tools.copy_dataset <src_url> <dst_url>``
"""

import argparse
import logging
import sys

logger = logging.getLogger(__name__)


def copy_dataset(source_url, target_url, field_regex=None, not_null_fields=None,
                 rowgroup_size_rows=1000, num_files=4, partition_by=(),
                 storage_options=None):
    """Copy ``source_url`` to ``target_url``; returns the rows copied.

    :param field_regex: regex list; only matching fields are copied.
    :param not_null_fields: rows with a null in any of these fields are
        dropped.
    :param num_files: the source's row-groups are spread over about this
        many files.
    :param partition_by: hive-partition the copy by these fields.
    """
    from petastorm_tpu_torch.etl.dataset_metadata import (
        DatasetWriter, ParquetDatasetInfo, infer_or_load_unischema, load_row_groups,
        materialize_dataset,
    )
    from petastorm_tpu_torch.predicates import in_lambda
    from petastorm_tpu_torch.reader import make_batch_reader

    info = ParquetDatasetInfo(source_url, storage_options)
    schema = infer_or_load_unischema(info)
    if field_regex:
        schema = schema.create_schema_view(field_regex)

    predicate = None
    if not_null_fields:
        predicate = in_lambda(list(not_null_fields),
                              lambda values: all(v is not None for v in values.values()))

    n_source_rowgroups = len(load_row_groups(info))
    rowgroups_per_file = max(1, -(-n_source_rowgroups // max(1, num_files)))

    copied = 0
    with materialize_dataset(target_url, schema, storage_options=storage_options):
        writer = DatasetWriter(target_url, schema, rowgroup_size_rows=rowgroup_size_rows,
                               partition_by=partition_by, storage_options=storage_options)
        with make_batch_reader(source_url, schema_fields=field_regex, predicate=predicate,
                               num_epochs=1, shuffle_row_groups=False,
                               storage_options=storage_options) as reader:
            with writer:
                for rowgroup_idx, batch in enumerate(reader):
                    if rowgroup_idx and rowgroup_idx % rowgroups_per_file == 0:
                        writer.new_file()
                    columns = batch._asdict()
                    n = len(next(iter(columns.values())))
                    writer.write_row_dicts({name: columns[name][i] for name in schema.fields}
                                           for i in range(n))
                    copied += n
    logger.info('Copied %d rows from %s to %s', copied, source_url, target_url)
    return copied


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('source_url')
    parser.add_argument('target_url')
    parser.add_argument('--field-regex', nargs='+', default=None)
    parser.add_argument('--not-null-fields', nargs='+', default=None)
    parser.add_argument('--rowgroup-size-rows', type=int, default=1000)
    parser.add_argument('--partition-by', nargs='+', default=())
    parser.add_argument('-v', '--verbose', action='store_true')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    copy_dataset(args.source_url, args.target_url, field_regex=args.field_regex,
                 not_null_fields=args.not_null_fields,
                 rowgroup_size_rows=args.rowgroup_size_rows,
                 partition_by=tuple(args.partition_by))
    return 0


if __name__ == '__main__':
    sys.exit(main())
