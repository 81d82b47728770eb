"""Write or rewrite the footer metadata of an existing Parquet store
(counterpart of ``petastorm_tpu/etl/petastorm_generate_metadata.py``): for
a dataset written without ``materialize_dataset``, or one whose
``_common_metadata`` was lost. The schema comes from, in this order, an
explicit ``--unischema-class`` (a fully qualified name, found with
``pydoc.locate``), the footer already there, or inference from the
Parquet schema.

Usage::

    python -m petastorm_tpu_torch.etl.petastorm_generate_metadata \\
        file:///path/to/dataset [--unischema-class mypkg.MySchema]
"""

import argparse
import logging
import sys

logger = logging.getLogger(__name__)


def generate_petastorm_metadata(dataset_url, unischema_class=None, storage_options=None):
    """Write the schema (JSON and pickled) and the row-group counts into
    ``_common_metadata``; returns the schema written."""
    from pydoc import locate

    from petastorm_tpu_torch.errors import MetadataError
    from petastorm_tpu_torch.etl.dataset_metadata import (
        ParquetDatasetInfo, _write_dataset_footer, get_schema, infer_or_load_unischema,
    )
    from petastorm_tpu_torch.unischema import Unischema

    info = ParquetDatasetInfo(dataset_url, storage_options)
    if unischema_class:
        schema = locate(unischema_class)
        if not isinstance(schema, Unischema):
            raise ValueError('%r does not resolve to a Unischema instance' % unischema_class)
    else:
        try:
            schema = get_schema(info)
            logger.info('Regenerating metadata from the existing footer schema')
        except MetadataError:
            schema = infer_or_load_unischema(info)
            logger.info('No stored schema found; inferred one from the arrow schema '
                        '(codec-less fields)')
    _write_dataset_footer(dataset_url, schema, storage_options)
    return schema


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('dataset_url')
    parser.add_argument('--unischema-class', default=None,
                        help='full qualified name of a Unischema instance, '
                             'e.g. examples.mnist.schema.MnistSchema')
    parser.add_argument('-v', '--verbose', action='store_true')
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    generate_petastorm_metadata(args.dataset_url, unischema_class=args.unischema_class)
    return 0


if __name__ == '__main__':
    sys.exit(main())
