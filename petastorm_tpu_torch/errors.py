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


class MetadataGenerationError(MetadataError):
    """Metadata could not be generated."""


class DecodeFieldError(PetastormTpuError):
    """A field value failed codec decode."""


#: ``ROADMAP.md`` Queue 1 items the port has not reached yet, by number
#: (done items leave gaps: numbers are never reused)
ROADMAP_ITEMS = {
    9: 'the service pool',
    11: 'bridges, benchmark, examples and test utilities',
}


def unported(feature, roadmap_item):
    """The one error every not-yet-ported kwarg or branch raises: it names
    the feature and the ``ROADMAP.md`` Queue 1 item that will bring it."""
    return NotImplementedError(
        '%s is not ported to petastorm_tpu_torch yet (ROADMAP.md: Queue 1 '
        'item %d, %s)' % (feature, roadmap_item, ROADMAP_ITEMS[roadmap_item]))
