"""Host→device staging: pinned slot rings and async copies on a side stream.

Counterpart of ``petastorm_tpu/jax/staging.py``. Two strategies, by target:

* **Ring** (a CUDA device): per batch signature (field shapes and host
  dtypes), a ring of ``PETASTORM_TPU_STAGING_SLOTS`` (default and floor 2)
  preallocated pinned host slots at ``(batch_size, *shape)``. Collate, pad
  and cast write INTO the slot (``np.copyto`` with cast-during-copy), the
  copy to the card is dispatched ``non_blocking`` on a side copy stream,
  and a CUDA event is recorded after it. A slot is refilled only after the
  event of its PREVIOUS handoff has completed. The consumer's stream waits
  on the batch's event before use, and every device tensor is
  ``record_stream``-ed on the consumer stream so the caching allocator
  cannot hand its memory out early.
* **Fresh assembly** (``device='cpu'``, or ``PETASTORM_TPU_STAGING=0``):
  every batch assembles into fresh host buffers, copied to a CUDA device
  with a plain ``.to()``; nothing is reused, so a held batch is never
  overwritten.

Encoded image parts (:class:`~petastorm_tpu_torch.fused.EncodedImageColumn`)
decode in the fill, straight into the slot's (or the fresh buffer's)
rows, under the ``decode_fused`` span: the fused pass.

Every mode dispatches through one seam, :meth:`StagingEngine._put`, which
holds the ``staging.h2d`` faultpoint (:mod:`petastorm_tpu_torch.faults`):
an injected fault raises before any copy or event exists.

Pinning and the completion event belong to the target
(:class:`CudaTarget`), so the ring logic also runs on a CPU build of torch
with unpinned slots and a fake event (the tests do).

``PETASTORM_TPU_SANITIZE=1`` (:mod:`petastorm_tpu_torch.sanitizer`,
resolved once per engine) guards the ring: each slot's field tensors are
views into flat uint8 slabs with poisoned red zones, verified before every
refill, and a weakref census of the host views handed to the transfer
quarantines a slot whose views outlived it. Fresh assembly is never
recycled, so it stays unguarded.

``dtypes=`` takes numpy or torch dtypes. A torch dtype with no numpy
counterpart (``torch.bfloat16``) is staged in the source dtype and cast on
the device after the copy; every other cast happens during the host copy.
"""

import contextlib

import numpy as np
import torch

from petastorm_tpu_torch import faults, sanitizer
from petastorm_tpu_torch.fused import EncodedImageColumn, count_fallback
from petastorm_tpu_torch.ragged import STRING_MESSAGE, reject_object_column
from petastorm_tpu_torch.telemetry import (
    FUSED_BYTES, FUSED_ROWS, get_registry, knobs, metrics_disabled, span,
)

#: registry counter: bytes handed to the device transfer path
H2D_BYTES = 'petastorm_tpu_h2d_bytes_total'

#: validity-mask column added under ``last_batch='pad'``
MASK_FIELD = 'valid_mask'

_MIN_SLOTS = 2


def staging_slots():
    """Ring depth from ``PETASTORM_TPU_STAGING_SLOTS`` (default and floor 2)."""
    return knobs.get_int('PETASTORM_TPU_STAGING_SLOTS', _MIN_SLOTS, floor=_MIN_SLOTS)


def staging_enabled():
    """False when ``PETASTORM_TPU_STAGING`` turns the pinned slot ring off."""
    return not knobs.is_disabled('PETASTORM_TPU_STAGING')


def torch_dtype_of(np_dtype, name=None):
    """The torch dtype of a numpy dtype; TypeError when torch has none."""
    try:
        return torch.from_numpy(np.empty(0, np_dtype)).dtype
    except TypeError as e:
        raise TypeError('field %r: numpy dtype %s has no torch counterpart'
                        % (name, np_dtype)) from e


def _numpy_dtype_of(torch_dtype):
    try:
        return torch.empty(0, dtype=torch_dtype).numpy().dtype
    except TypeError:
        return None


def resolve_cast_policy(dtypes):
    """Split a ``{field: numpy or torch dtype}`` policy into host casts
    (numpy dtypes, applied during the slot copy) and device casts (torch
    dtypes without a numpy counterpart, applied after the transfer)."""
    host, device = {}, {}
    for name, want in (dtypes or {}).items():
        if isinstance(want, torch.dtype):
            np_dtype = _numpy_dtype_of(want)
            if np_dtype is None:
                device[name] = want
            else:
                host[name] = np_dtype
        else:
            host[name] = np.dtype(want)
    return host, device


def check_deviceable(name, arr):
    """Refuse columns that cannot become tensors, with the classified
    reason (:mod:`petastorm_tpu_torch.ragged`): a ragged column's message
    names ``pad_ragged=``/``bucket_boundaries=``."""
    if arr.dtype == object:
        reject_object_column(name, arr)
    if arr.dtype.kind in 'US':
        raise TypeError(STRING_MESSAGE % name)


class CudaTarget:
    """Copies pinned host tensors to one CUDA device on a side stream and
    hands them to the consumer's stream."""

    pin_memory = True

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)

    @contextlib.contextmanager
    def thread_context(self):
        """Set the device and the copy stream on the calling (staging)
        thread: both are per-thread state in torch."""
        torch.cuda.set_device(self.device)
        with torch.cuda.stream(self.stream):
            yield

    def transfer(self, host_tensors, device_casts):
        """Async copies of ``host_tensors`` on the copy stream, then an
        event recorded after them; returns ``(device_tensors, event)``."""
        with torch.cuda.stream(self.stream):
            out = {}
            for name, t in host_tensors.items():
                d = t.to(self.device, non_blocking=True)
                cast = device_casts.get(name)
                out[name] = d if cast is None else d.to(cast)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def deliver(self, tensors, event):
        """Make the consumer thread's current stream wait for the copy and
        own the tensors' memory."""
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        for t in tensors.values():
            t.record_stream(consumer)
        return tensors


class Handoff:
    """One staged batch on its way to the consumer."""

    __slots__ = ('tensors', 'event', 'target')

    def __init__(self, tensors, event=None, target=None):
        self.tensors = tensors
        self.event = event
        self.target = target

    def deliver(self):
        """The batch, ready for use on the calling thread's stream."""
        if self.target is None:
            return self.tensors
        return self.target.deliver(self.tensors, self.event)


class _Slot:
    """One ring slot: host tensors, their numpy views, and the completion
    event of the transfer last dispatched from it. Under the sanitizer it
    also owns each field's guarded slab and the census of its last
    dispatch's views."""

    __slots__ = ('tensors', 'views', 'event', 'slabs', 'census')

    def __init__(self, tensors, slabs=None):
        self.event = None
        self.census = None if slabs is None else sanitizer.ViewCensus()
        self.back(tensors, slabs)

    def back(self, tensors, slabs=None):
        """(Re)point the slot at its host memory."""
        self.tensors = tensors
        self.slabs = slabs
        self.views = {name: t.numpy() for name, t in tensors.items()}

    def await_retired(self):
        """Block until the transfer previously dispatched from this slot has
        read its buffers; only then may they be overwritten."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None


class StagingEngine:
    """Per-pass staging engine; only the loader's staging thread calls
    :meth:`stage`. ``target=None`` selects fresh assembly on the host, whose
    batches move to ``device`` when that is a CUDA device."""

    def __init__(self, batch_size, dtypes, last_batch, target=None,
                 num_slots=_MIN_SLOTS, device=None):
        self._batch_size = batch_size
        self._host_casts, self._device_casts = resolve_cast_policy(dtypes)
        self._last_batch = last_batch
        self._target = target
        self._device = device
        self._num_slots = max(_MIN_SLOTS, num_slots)
        self._rings = {}            # signature -> (slots, [cursor])
        #: ring slots allocated (startup only in steady state)
        self.slabs_allocated = 0
        # pipesan: resolved once here, so the unarmed path pays one
        # attribute read per batch
        self._sanitize = sanitizer.sanitize_enabled()
        #: slots re-backed because a dispatched view outlived its slot
        self.slabs_quarantined = 0
        #: ring stages that refilled a slot used before (each waited on its
        #: previous handoff's event; armed, each verified its red zones)
        self.slot_refills = 0
        #: rows decoded straight into staging buffers, and where:
        #: ``'fused-into-slot'`` (the pinned ring) or ``'fused-into-slab'``
        #: (fresh assembly)
        self.fused_rows = 0
        self.fused_mode = None

    @property
    def num_slots(self):
        """Ring depth (slots per batch signature)."""
        return self._num_slots

    def set_num_slots(self, num_slots):
        """Deepen, never shrink, the ring depth: the staging autotuner's
        seam. A ring grows at its next use on the staging thread (a removed
        slot's in-flight copy would lose its refill gate). Returns the
        depth."""
        self._num_slots = max(self._num_slots, max(_MIN_SLOTS, int(num_slots)))
        return self._num_slots

    def _resolve_dtypes(self, parts):
        """Per-field host dtype: the cast policy wins; otherwise mixed-dtype
        parts promote like ``np.concatenate``."""
        resolved = {}
        for name, arr in parts[0].items():
            want = self._host_casts.get(name)
            if want is None:
                want = np.result_type(*[p[name].dtype for p in parts])
            resolved[name] = want
        return resolved

    def _new_tensors(self, columns, dtype_map, with_mask, pin, guarded=False):
        """``(tensors, slabs)`` of one batch's host memory. ``guarded``
        (sanitizer armed, ring slots only) makes each tensor a view into its
        own slab with poisoned red zones; ``slabs`` is None otherwise."""
        specs = {name: ((self._batch_size,) + arr.shape[1:],
                        torch_dtype_of(dtype_map[name], name))
                 for name, arr in columns.items()}
        if with_mask:
            specs[MASK_FIELD] = ((self._batch_size,), torch.bool)
        if not guarded:
            return {name: torch.empty(shape, dtype=dtype, pin_memory=pin)
                    for name, (shape, dtype) in specs.items()}, None
        tensors, slabs = {}, {}
        for name, (shape, dtype) in specs.items():
            slabs[name], tensors[name] = sanitizer.allocate_guarded(shape, dtype, pin)
        return tensors, slabs

    def _next_slot(self, columns, dtype_map, with_mask):
        sig = (with_mask,) + tuple(
            (name, arr.shape[1:], dtype_map[name].str)
            for name, arr in sorted(columns.items()))
        ring = self._rings.get(sig)
        if ring is None:
            slots = [_Slot(*self._new_tensors(columns, dtype_map, with_mask,
                                              self._target.pin_memory, self._sanitize))
                     for _ in range(self._num_slots)]
            self.slabs_allocated += len(slots)
            ring = self._rings[sig] = (slots, [0])
        elif len(ring[0]) < self._num_slots:
            # the autotuner deepened the ring (set_num_slots): it grows
            # here, at its next use, on the staging thread that owns it
            add = self._num_slots - len(ring[0])
            ring[0].extend(_Slot(*self._new_tensors(columns, dtype_map, with_mask,
                                                    self._target.pin_memory, self._sanitize))
                           for _ in range(add))
            self.slabs_allocated += add
        slots, cursor = ring
        slot = slots[cursor[0]]
        cursor[0] = (cursor[0] + 1) % len(slots)
        return slot

    def stage(self, columns, n_valid):
        """Assemble and dispatch one batch. ``columns`` is one column dict
        or a list of column-dict parts (chunk views), copied in sequence so
        no concatenated intermediate exists. Returns a :class:`Handoff`
        without waiting for the transfer."""
        parts = columns if isinstance(columns, list) else [columns]
        parts = [{name: arr if isinstance(arr, EncodedImageColumn) else np.asarray(arr)
                  for name, arr in p.items()} for p in parts]
        for p in parts:
            for name, arr in p.items():
                check_deviceable(name, arr)
        with_mask = self._last_batch == 'pad'
        dtype_map = self._resolve_dtypes(parts)
        if self._target is None:
            with span('stage_fill'):
                tensors, _ = self._new_tensors(parts[0], dtype_map, with_mask, pin=False)
                views = {name: t.numpy() for name, t in tensors.items()}
                n = self._fill(views, parts, n_valid, with_mask)
                host = {name: t[:n] for name, t in tensors.items()}
                host = {name: (t.to(self._device_casts[name])
                               if name in self._device_casts else t)
                        for name, t in host.items()}
            tensors, _ = self._put(host)
            self._account(host)
            return Handoff(tensors)
        slot = self._next_slot(parts[0], dtype_map, with_mask)
        if slot.event is not None:
            self.slot_refills += 1
        with span('h2d_ready'):
            # gate the refill on the slot's PREVIOUS handoff; with ≥2 slots
            # that is never the batch just handed to the consumer
            slot.await_retired()
        if self._sanitize:
            self._sanitize_recycle(slot, parts[0], dtype_map, with_mask)
        with span('stage_fill'):
            n = self._fill(slot.views, parts, n_valid, with_mask)
        host = {name: t[:n] for name, t in slot.tensors.items()}
        with span('h2d_dispatch'):
            tensors, event = self._put(host)
        slot.event = event
        if self._sanitize:
            # the views just handed to the transfer: any that still
            # resolve when this slot comes up for refilling outlived it
            slot.census.register(host.values())
        self._account(host)
        return Handoff(tensors, event, self._target)

    def _put(self, host):
        """The one dispatch seam every staging mode passes: the
        ``staging.h2d`` faultpoint, then the pinned ring's async transfer,
        a fresh batch's copy to the card, or no copy on the CPU. Returns
        ``(tensors, event)``; the event is None but for the ring's. A
        fault raises before any copy is dispatched, so no handoff waits on
        an event that is never recorded."""
        if faults.ARMED:
            faults.fault_hit('staging.h2d')
        if self._target is not None:
            return self._target.transfer(host, self._device_casts)
        if self._device is not None and self._device.type == 'cuda':
            return {name: t.to(self._device) for name, t in host.items()}, None
        return host, None

    def _sanitize_recycle(self, slot, columns, dtype_map, with_mask):
        """pipesan refill gate (armed only, after the slot's event): abort
        the refill when a view of the last dispatch is still alive (its
        holder keeps the old slab — quarantine, no corruption), else verify
        the red zones before the fill overwrites the slab."""
        escaped = slot.census.escaped()
        if escaped:
            sanitizer.record_violation(
                'staging-use-after-recycle',
                '%d staged view(s) still alive when their slot came up for '
                'recycling; recycle aborted — slot re-backed with fresh '
                'buffers' % escaped)
            slot.back(*self._new_tensors(columns, dtype_map, with_mask,
                                         self._target.pin_memory, guarded=True))
            slot.census = sanitizer.ViewCensus()
            self.slabs_quarantined += 1
            return
        for name, slab in slot.slabs.items():
            if not sanitizer.check_canaries(slab):
                sanitizer.record_violation(
                    'staging-canary-trampled',
                    'red zone around staging slot field %r overwritten while '
                    'the slot was out — a write ran past its bounds' % name)

    def _fill(self, buffers, parts, n, with_mask):
        """Cast/pad/mask-assemble ``parts`` into ``buffers``; returns the
        row count to hand over (the batch size when padding, else ``n``)."""
        full = n >= self._batch_size
        for name in parts[0]:
            dst = buffers[name]
            offset = 0
            for p in parts:
                column = p[name]
                m = len(column)
                if column.shape[1:] != dst.shape[1:]:
                    # np.copyto would broadcast a narrower chunk silently
                    raise ValueError(
                        'staging: field %r chunk of shape %s does not fit the '
                        'batch slot of shape %s' % (name, column.shape, dst.shape))
                if isinstance(column, EncodedImageColumn):
                    self._fill_fused(column, dst[offset:offset + m])
                else:
                    np.copyto(dst[offset:offset + m], column, casting='unsafe')
                offset += m
            if with_mask and not full:
                dst[n:] = 0
        if with_mask:
            mask = buffers[MASK_FIELD]
            mask[:n] = True
            mask[n:] = False
            return self._batch_size
        return min(n, self._batch_size)

    def _fill_fused(self, column, dst):
        """Decode one encoded part into its destination rows. A slot of
        another dtype (the loader materializes those first) decodes to a
        scratch batch and cast-copies: a fallback, not counted as fused."""
        if dst.dtype != column.dtype:
            count_fallback('dtype-cast')
            with span('decode'):
                np.copyto(dst, column.materialize(), casting='unsafe')
            return
        with span('decode_fused'):
            column.decode_into(dst)
        self.fused_rows += len(column)
        self.fused_mode = 'fused-into-slab' if self._target is None else 'fused-into-slot'
        if not metrics_disabled():
            registry = get_registry()
            registry.counter(FUSED_ROWS).inc(len(column))
            registry.counter(FUSED_BYTES).inc(dst.nbytes)

    def release(self):
        """Pass end: drop the slots (and their pinned memory)."""
        self._rings = {}

    def _account(self, host):
        if not metrics_disabled():
            get_registry().counter(H2D_BYTES).inc(
                sum(t.numel() * t.element_size() for t in host.values()))
