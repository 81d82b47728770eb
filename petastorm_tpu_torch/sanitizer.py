"""pipesan runtime half (counterpart of ``petastorm_tpu/sanitizer.py``):
ASan-style guards for the zero-copy boundaries.

The static ``buffer-escape``/``buffer-write`` pass
(:mod:`petastorm_tpu_torch.analysis.pass_buffers`) proves the *source*
honors the borrow contracts registered in ``telemetry/names.py``; this
module catches what static analysis cannot — a consumer mutating or
outliving a borrowed view at runtime. ``PETASTORM_TPU_SANITIZE=1`` arms
the guards of the pinned slot ring (``device/staging.py``):

* every ring slot owns one flat ``torch.uint8`` slab per field (pinned on
  a CUDA target) with poisoned *red zones* (canary bytes) before and after
  the field's tensor, which is a typed view into the slab's middle. The
  zones are verified before every refill — after the slot's CUDA event,
  so the copy has finished reading — and poisoned again, so a wild write
  through an escaped view (or a native decoder's overrun) is caught at
  the next cycle instead of silently corrupting a neighbouring batch;
* a **weakref census** of the host views handed to the transfer records
  every holder that still keeps one when the slot comes up for refilling.
  The refill is then *aborted*: the slot gets fresh guarded tensors and
  the holder keeps the old memory (quarantine, like ASan's).

The slab is owned explicitly because a pinned tensor's ``.numpy()`` view
does not lead back to a uint8 numpy slab through ``.base``: the
reference's base walk would find nothing and check nothing.

:func:`guard_readonly` and :func:`guard_payload` force shared numpy
payloads read-only: the decoded cache's memory tier
(:mod:`petastorm_tpu_torch.materialized_cache`) calls :func:`guard_payload`
on what it shares, and the process pool (ROADMAP item 9) will too.

Violations the guards detect are recorded in a bounded in-process ring,
surfaced as the ``pipesan`` section of ``pipeline_report()`` and counted
in the ``petastorm_tpu_sanitizer_*`` metrics; they are logged, never
raised. Unarmed (the default) the engine resolves the knob once at
construction and does no guard work.
"""

import logging
import threading
import time
import weakref

import numpy as np

from petastorm_tpu_torch.telemetry import (
    get_registry, knobs, metrics_disabled, register_refresh,
)

logger = logging.getLogger(__name__)

#: registry counters
SANITIZER_VIOLATIONS = 'petastorm_tpu_sanitizer_violations_total'
SANITIZER_VIEWS_GUARDED = 'petastorm_tpu_sanitizer_views_guarded_total'
SANITIZER_CANARY_CHECKS = 'petastorm_tpu_sanitizer_canary_checks_total'

#: red-zone size on each side of a guarded slab. 64 bytes keeps every
#: dtype's alignment intact for the visible region and is wide enough that
#: an off-by-one-row write cannot jump the zone.
CANARY_BYTES = 64

#: the poison pattern (0xA5 = alternating bits, unlikely fill value)
CANARY_BYTE = 0xA5

#: violation-ring bound: keeps the newest entries, so the ``recent`` slice
#: of ``pipeline_report()['pipesan']`` stays recent in a long soak; the
#: per-kind counters carry the full totals
_RING_LIMIT = 50

# cached knob (refresh_sanitizer/telemetry.refresh re-reads)
_enabled = None

_lock = threading.Lock()
_violations = []


def sanitize_enabled():
    """True when ``PETASTORM_TPU_SANITIZE`` carries an enable spelling
    (off by default — the guards cost real per-batch work)."""
    global _enabled
    if _enabled is None:
        _enabled = knobs.is_enabled('PETASTORM_TPU_SANITIZE')
    return _enabled


def refresh_sanitizer():
    """Re-read the knob; engines resolve it at construction, so the next
    loader pass sees the new value."""
    global _enabled
    _enabled = None


register_refresh(refresh_sanitizer)


def record_violation(kind, detail):
    """One sanitizer finding: counted per ``kind``, kept in the bounded
    ring for ``pipeline_report()['pipesan']``, and logged — never raised (a
    false positive must not kill a training job)."""
    with _lock:
        _violations.append({'kind': kind, 'detail': detail, 'ts': time.time()})
        if len(_violations) > _RING_LIMIT:
            del _violations[:len(_violations) - _RING_LIMIT]
    if not metrics_disabled():
        get_registry().counter(SANITIZER_VIOLATIONS, kind=kind).inc()
    logger.warning('pipesan violation [%s]: %s', kind, detail)


def violations():
    """Snapshot of the recorded violations (oldest first)."""
    with _lock:
        return [dict(v) for v in _violations]


def reset_for_tests():
    """Clear the violation ring and the cached knob (the counters live in
    the registry and reset with it)."""
    global _enabled
    with _lock:
        del _violations[:]
    _enabled = None


# -- read-only view guards ----------------------------------------------------


def guard_readonly(arr):
    """Force ``writeable=False`` on an ndarray; returns 1 when the flag was
    flipped (0 for non-arrays, already read-only views, and the rare base
    that refuses)."""
    if isinstance(arr, np.ndarray) and arr.flags.writeable:
        try:
            arr.flags.writeable = False
            return 1
        except ValueError:
            return 0
    return 0


def guard_payload(value):
    """Force every reachable top-level ndarray in a result payload
    read-only: plain arrays, dicts/lists/tuples of them, and objects with a
    ``columns`` dict attribute (a column batch). Returns the number of
    arrays guarded (also counted in the ``views_guarded`` metric)."""
    guarded = _guard_value(value, depth=0)
    if guarded and not metrics_disabled():
        get_registry().counter(SANITIZER_VIEWS_GUARDED).inc(guarded)
    return guarded


def _guard_value(value, depth):
    if depth > 3:  # payloads are shallow; never chase arbitrary graphs
        return 0
    if isinstance(value, np.ndarray):
        return guard_readonly(value)
    guarded = 0
    if isinstance(value, dict):
        for v in value.values():
            guarded += _guard_value(v, depth + 1)
        return guarded
    if isinstance(value, (list, tuple)):
        for v in value:
            guarded += _guard_value(v, depth + 1)
        return guarded
    columns = getattr(value, 'columns', None)
    if isinstance(columns, dict):
        return _guard_value(columns, depth + 1)
    return guarded


# -- red-zone (canary) slabs --------------------------------------------------


def allocate_guarded(shape, dtype, pin_memory=False):
    """A ``torch.empty(shape, dtype=dtype)`` equivalent whose memory sits
    between two poisoned red zones inside one flat ``torch.uint8`` slab.
    Returns ``(slab, tensor)``: the tensor is a typed view into the slab's
    middle, and the caller keeps the slab to hand to
    :func:`check_canaries`."""
    import torch
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize
    slab = torch.empty(nbytes + 2 * CANARY_BYTES, dtype=torch.uint8, pin_memory=pin_memory)
    _poison(slab.numpy(), nbytes)
    view = slab[CANARY_BYTES:CANARY_BYTES + nbytes].view(dtype)
    return slab, view.view(shape)


def _poison(raw, nbytes):
    raw[:CANARY_BYTES] = CANARY_BYTE
    raw[CANARY_BYTES + nbytes:] = CANARY_BYTE


def _slab_bytes(slab):
    """The slab's bytes as a numpy view, or None when ``slab`` is not a
    flat uint8 CPU tensor wide enough to carry two red zones."""
    import torch
    if isinstance(slab, torch.Tensor) and slab.dtype == torch.uint8 \
            and slab.dim() == 1 and slab.device.type == 'cpu' \
            and slab.numel() >= 2 * CANARY_BYTES:
        return slab.numpy()
    return None


def check_canaries(slab, repoison=True):
    """True when both red zones of a slab from :func:`allocate_guarded`
    still carry the poison pattern; trampled zones are poisoned again (so
    the next trample is caught too) when ``repoison``. Counted per check.
    Anything else is not a guarded slab and has nothing to say (True)."""
    raw = _slab_bytes(slab)
    if raw is None:
        return True
    if not metrics_disabled():
        get_registry().counter(SANITIZER_CANARY_CHECKS).inc()
    nbytes = raw.nbytes - 2 * CANARY_BYTES
    intact = bool((raw[:CANARY_BYTES] == CANARY_BYTE).all()
                  and (raw[CANARY_BYTES + nbytes:] == CANARY_BYTE).all())
    if not intact and repoison:
        _poison(raw, nbytes)
    return intact


# -- escaped-view census ------------------------------------------------------


class ViewCensus:
    """Weakrefs of the views a ring slot handed out on its last dispatch.
    At refill time, any ref still resolving means a holder kept the view
    past the slot's documented lifetime — the classic use-after-recycle.
    Single-threaded like the staging engine itself."""

    __slots__ = ('_refs',)

    def __init__(self):
        self._refs = []

    def register(self, arrays):
        """Record this dispatch's outbound views (replaces the previous
        dispatch's refs — those were checked at the recycle gate)."""
        refs = []
        for arr in arrays:
            try:
                refs.append(weakref.ref(arr))
            except TypeError:  # non-weakref-able stand-in (tests, scalars)
                pass
        self._refs = refs

    def escaped(self):
        """How many of the registered views are still alive."""
        return sum(1 for ref in self._refs if ref() is not None)
