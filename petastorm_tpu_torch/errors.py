"""Exception types for petastorm_tpu_torch (counterpart of
``petastorm_tpu/errors.py``)."""


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


class RowGroupPoisonedError(PetastormTpuError):
    """A service work item exhausted its retry budget and was quarantined.

    Raised by :class:`~petastorm_tpu_torch.service.service_pool.ServicePool`
    under ``poison_policy='raise'`` when the dispatcher quarantines an item
    whose failures carried no worker exception (a row-group that kills its
    workers rather than erroring). ``info`` is the dispatcher's quarantine
    descriptor (item id, attempts, reason)."""

    def __init__(self, message, info=None):
        super().__init__(message)
        self.info = info or {}


class ServiceWedgedError(PetastormTpuError):
    """A service consumer read made no progress for the configured deadline
    while work was outstanding (``PETASTORM_TPU_SERVICE_READ_DEADLINE_S``).
    ``fleet`` carries the dispatcher's live fleet view at raise time
    (per-worker liveness, in-flight loads, queue state)."""

    def __init__(self, message, fleet=None):
        super().__init__(message)
        self.fleet = fleet or {}


#: ``ROADMAP.md`` Queue 1 items the port has not reached yet, by number
#: (done items leave gaps: numbers are never reused)
ROADMAP_ITEMS = {
    11: 'bridges, benchmark, examples and test utilities',
}


def unported(feature, roadmap_item):
    """The one error every not-yet-ported kwarg or branch raises: it names
    the feature and the ``ROADMAP.md`` Queue 1 item that will bring it."""
    return NotImplementedError(
        '%s is not ported to petastorm_tpu_torch yet (ROADMAP.md: Queue 1 '
        'item %d, %s)' % (feature, roadmap_item, ROADMAP_ITEMS[roadmap_item]))
