"""Ventilator: feeds work items into a pool with a bounded in-flight count
(counterpart of ``petastorm_tpu/workers/ventilator.py``). Checkpointable:
:meth:`ConcurrentVentilator.state_dict` captures (epoch, cursor, seed), and
the per-epoch order is the reference's, so a reader resumes in either
package."""

import inspect
import logging
import threading
from abc import ABCMeta, abstractmethod

import numpy as np

from petastorm_tpu_torch.telemetry import span, tracing

logger = logging.getLogger(__name__)


def _accepts_trace_ctx(fn):
    """True when ``fn(**item)`` takes the injected ``_trace_ctx`` kwarg
    (a ``**kwargs`` or a parameter of that name): the pools' ``ventilate``
    does; a bare user callable may not, and then the context is not
    carried rather than failing the ventilation thread."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return any(p.kind is inspect.Parameter.VAR_KEYWORD or p.name == tracing.TRACE_CTX_KEY
               for p in sig.parameters.values())

_VENTILATION_INTERVAL_S = 0.01

# seed advance per reset() sweep, so successive sweeps never replay orders
_RESET_SEED_STRIDE = 0x9E3779B1


def epoch_order(n_items, seed, epoch, randomize):
    """Epoch ``e`` permutes with ``RandomState((seed + e) mod 2^32)``
    (identity when not randomized), exactly as the reference does."""
    if not randomize:
        return list(range(n_items))
    rng = np.random.RandomState((seed + epoch) % (2 ** 32))
    return [int(i) for i in rng.permutation(n_items)]


class Ventilator(metaclass=ABCMeta):
    """Base class of the ventilators: what a pool calls on the one it is
    started with."""

    def __init__(self, ventilate_fn):
        self._ventilate_fn = ventilate_fn

    @abstractmethod
    def start(self):
        """Begin ventilation."""

    @abstractmethod
    def processed_item(self):
        """Called by the pool whenever a worker finishes one item."""

    @abstractmethod
    def completed(self):
        """True when no more items will ever be ventilated."""

    @abstractmethod
    def stop(self):
        """Stop ventilation."""


class ConcurrentVentilator(Ventilator):
    """Feeds items from a background thread, keeping at most
    ``max_ventilation_queue_size`` in flight.

    :param ventilate_fn: callable receiving ``**item`` for each work item.
    :param items_to_ventilate: list of dicts (kwargs for ``ventilate_fn``).
    :param iterations: number of epochs over the list; None = infinite.
    :param max_ventilation_queue_size: in-flight bound, or a zero-arg
        callable re-read on every wait; defaults to one epoch.
    :param randomize_item_order: reshuffle the item order each epoch.
    :param random_seed: epoch ``e`` uses ``seed + e``; None draws one.
    :param pass_epoch: also pass ``epoch=`` to ``ventilate_fn``.
    :param trace_shard: shard recorded in the trace contexts minted here.
        With ``PETASTORM_TPU_TRACE`` on, each sampled item gets a context
        (:func:`~petastorm_tpu_torch.telemetry.tracing.mint`), passed to
        ``ventilate_fn`` as the reserved ``_trace_ctx`` kwarg, which the
        pools strip before ``worker.process``.
    :param always_exclude: item indices never ventilated, in any epoch or
        sweep: the Reader's statistics-pruned row-groups, which stay in the
        item list (indices, shards and checkpoints are unchanged) but
        deliver no row.
    """

    def __init__(self, ventilate_fn, items_to_ventilate, iterations=1,
                 max_ventilation_queue_size=None, randomize_item_order=False,
                 random_seed=0, pass_epoch=False, trace_shard=None,
                 always_exclude=None):
        if iterations is not None and iterations <= 0:
            raise ValueError('iterations must be positive or None, got %r' % iterations)
        super().__init__(ventilate_fn)
        self._pass_epoch = pass_epoch
        self._items = list(items_to_ventilate)
        self._initial_iterations = iterations
        self._iterations_remaining = iterations
        self._max_queue_size = (max_ventilation_queue_size
                                or max(1, len(self._items)))
        self._randomize = randomize_item_order
        if random_seed is None:
            random_seed = int(np.random.randint(0, 2 ** 32, dtype=np.uint32))
        self._seed = random_seed
        self._epoch = 0
        self._cursor = 0
        self._exclude_once = frozenset()
        self._exclude_always = frozenset(always_exclude or ())
        self._trace_shard = trace_shard
        self._carries_trace_ctx = _accepts_trace_ctx(ventilate_fn)
        self._in_flight = 0
        self._cv = threading.Condition()
        self._stop_requested = False
        self._completed = False
        self._error = None
        self._thread = None

    def start(self):
        with self._cv:
            if self._thread is not None:
                raise RuntimeError('Ventilator already started')
            if not self._items or self._exclude_always.issuperset(range(len(self._items))):
                # nothing will ever ventilate: complete now, even for
                # infinite epochs, which would otherwise spin on empty ones
                self._completed = True
                return
            if self._stop_requested:
                return
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name='petastorm-tpu-torch-ventilator')
            self._thread.start()

    def processed_item(self):
        with self._cv:
            self._in_flight = max(0, self._in_flight - 1)
            self._cv.notify_all()

    def completed(self):
        return self._completed

    @property
    def error(self):
        """The exception that killed ventilation, or None. A dead
        ventilator reads as completed, so consumers drain and stop; a
        caller that must tell a cut-short epoch from a finished one
        checks here."""
        return self._error

    def stop(self):
        with self._cv:
            self._stop_requested = True
            self._cv.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join()
            with self._cv:
                self._thread = None

    def reset(self):
        """Restart ventilation for the original epoch count; legal only
        after the previous run completed."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError('Cannot reset a ventilator that is still ventilating')
        if not self._completed:
            raise RuntimeError('Cannot reset a ventilator before it completed')
        self._thread = None
        self._completed = False
        self._error = None
        self._stop_requested = False
        self._cursor = 0
        self._epoch = 0
        self._seed = (self._seed + _RESET_SEED_STRIDE) % (2 ** 32)
        self._in_flight = 0
        self._iterations_remaining = self._initial_iterations
        self.start()

    def state_dict(self):
        with self._cv:
            return {
                'epoch': self._epoch,
                'cursor': self._cursor,
                'seed': self._seed,
                'iterations_remaining': self._iterations_remaining,
            }

    def load_state_dict(self, state):
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError('Cannot load state while ventilating')
        self._epoch = state['epoch']
        self._cursor = state['cursor']
        self._seed = state['seed']
        self._iterations_remaining = state['iterations_remaining']

    def exclude_from_next_epoch(self, item_indices):
        """Skip these item indices during the next epoch only (exact resume)."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError('Cannot set exclusions while ventilating')
        self._exclude_once = frozenset(item_indices)
        self._cursor = 0

    def _current_max_queue_size(self):
        size = self._max_queue_size
        return size() if callable(size) else size

    def _run(self):
        # a dead ventilation thread must read as completed, or every
        # consumer polling completed() would wait forever
        try:
            self._run_inner()
        except Exception as e:  # noqa: BLE001 - kept as .error; consumers drain and stop
            logger.exception('Ventilator thread died; marking ventilation '
                             'complete so consumers do not wait forever')
            with self._cv:
                self._error = e
                self._completed = True
                self._cv.notify_all()

    def _run_inner(self):
        while True:
            with self._cv:
                if self._stop_requested:
                    break
                if self._iterations_remaining is not None and self._iterations_remaining <= 0:
                    self._completed = True
                    break
            order = epoch_order(len(self._items), self._seed, self._epoch,
                                self._randomize)
            if self._exclude_always:
                order = [i for i in order if i not in self._exclude_always]
            if self._exclude_once:
                order = [i for i in order if i not in self._exclude_once]
                self._exclude_once = frozenset()
            while self._cursor < len(order):
                with self._cv:
                    while (self._in_flight >= self._current_max_queue_size()
                           and not self._stop_requested):
                        self._cv.wait(_VENTILATION_INTERVAL_S)
                    if self._stop_requested:
                        return
                    # in_flight rises BEFORE the item reaches the pool, so a
                    # fast processed_item() decrement is never lost
                    self._in_flight += 1
                    item_index = order[self._cursor]
                item = self._items[item_index]
                ctx = tracing.mint(item.get('item_index', item_index), epoch=self._epoch,
                                   shard=self._trace_shard)
                if ctx is not None and self._carries_trace_ctx:
                    item = dict(item)
                    item[tracing.TRACE_CTX_KEY] = ctx
                with tracing.activate(ctx, track='ventilator'):
                    with span('ventilate'):
                        if self._pass_epoch:
                            self._ventilate_fn(epoch=self._epoch, **item)
                        else:
                            self._ventilate_fn(**item)
                # the cursor advances only after the hand-off, so a
                # state_dict() never skips an item (at-least-once resume)
                with self._cv:
                    self._cursor += 1
            with self._cv:
                self._epoch += 1
                self._cursor = 0
                if self._iterations_remaining is not None:
                    self._iterations_remaining -= 1
        with self._cv:
            self._cv.notify_all()
