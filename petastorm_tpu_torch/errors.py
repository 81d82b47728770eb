"""Exception types for petastorm_tpu_torch (counterpart of
``petastorm_tpu/errors.py``; the service-pool errors wait for the port of
the service pool)."""


class PetastormTpuError(Exception):
    """Base class for all framework-specific errors."""


class NoDataAvailableError(PetastormTpuError):
    """Raised when a reader ends up with zero work items, most often when
    more shards are requested than the dataset has row-groups."""


class MetadataError(PetastormTpuError):
    """Dataset metadata is missing or malformed."""


#: ``ROADMAP.md`` Queue 1 items the port has not reached yet, by number
ROADMAP_ITEMS = {
    3: 'caches, readahead, pushdown, filters and predicates, faults, sanitizer',
    5: 'mesh via torch.distributed',
    7: 'the row reader: make_reader and NGram',
    8: 'LM consumer layer: MoE, ring/Ulysses attention, pipeline, generate',
    9: 'process and service pools, HDFS and object stores',
    10: 'write plane and ETL tools',
    11: 'bridges, benchmark, examples and test utilities',
}


def unported(feature, roadmap_item):
    """The one error every not-yet-ported kwarg or branch raises: it names
    the feature and the ``ROADMAP.md`` Queue 1 item that will bring it."""
    return NotImplementedError(
        '%s is not ported to petastorm_tpu_torch yet (ROADMAP.md: Queue 1 '
        'item %d, %s)' % (feature, roadmap_item, ROADMAP_ITEMS[roadmap_item]))
