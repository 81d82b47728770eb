"""Bounded-staleness append reads: follow a growing dataset.

Counterpart of ``petastorm_tpu/write/append.py``. The append write mode
(``DistributedDatasetWriter(append=True)``) stacks monotonic manifest
generations; :class:`AppendFollower` is the read side:

* it polls the committed manifest every ``max_staleness_s / 2`` and yields
  the batches of every part file it has not delivered yet, so a row
  committed at T is yielded by T + ``max_staleness_s`` (plus the read);
* a ``source='compact'`` entry whose ``replaces`` were all delivered is
  skipped (its rows already flowed through the old files); a fold of
  sources none of which were delivered is delivered whole; a fold that
  mixes the two is not delivered at all: the follower reads the
  undelivered source files directly (superseded files stay on disk until
  ``gc_superseded``'s grace window passes), so delivery stays
  file-granular and multiset-exact.

Iterate it on any thread, or let :meth:`AppendFollower.start` run the
iteration on the follower's own thread, which :meth:`~AppendFollower.stop`
stops and joins.
"""

import logging
import posixpath
import threading
import time

from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths, normalize_dir_url
from petastorm_tpu_torch.telemetry import get_registry, metrics_disabled
from petastorm_tpu_torch.write import manifest

logger = logging.getLogger(__name__)

#: commit-to-delivery lag at each poll: the committed manifest's age while
#: undelivered rows exist, 0 once caught up
APPEND_STALENESS = 'petastorm_tpu_append_staleness_s'


class AppendFollower:
    """Iterator of row-group batches over a manifest dataset that keeps
    picking up newly committed generations.

    ``for batch in AppendFollower(url, max_staleness_s=5): ...`` yields the
    namedtuple batches of :func:`~petastorm_tpu_torch.reader.make_batch_reader`,
    one file set at a time. ``stop()`` ends the iteration; between
    generations the follower waits in poll steps and holds no reader open.
    """

    def __init__(self, dataset_url, max_staleness_s=5.0, reader_factory=None,
                 storage_options=None, stop_after_idle_s=None):
        """``reader_factory(file_urls)`` returns a context-manager reader
        (default: :func:`make_batch_reader`, one epoch, files in order);
        ``stop_after_idle_s`` ends the iteration after that long without
        a new commit (None: follow until ``stop()``)."""
        self._url = normalize_dir_url(dataset_url)
        self._storage_options = storage_options
        self.max_staleness_s = float(max_staleness_s)
        self._poll_s = max(0.05, self.max_staleness_s / 2.0)
        self._stop_after_idle_s = stop_after_idle_s
        self._reader_factory = reader_factory or self._default_reader
        self.fs, self.root_path = get_filesystem_and_path_or_paths(self._url, storage_options)
        self._delivered = set()
        self._stop = threading.Event()
        self._thread = None
        self.error = None  #: what ended the owned thread's iteration, or None
        self.generation = 0  #: the latest generation this follower consumed

    def _default_reader(self, file_urls):
        from petastorm_tpu_torch.reader import make_batch_reader
        return make_batch_reader(file_urls, shuffle_row_groups=False, num_epochs=1,
                                 storage_options=self._storage_options)

    def start(self, on_batch):
        """Iterate on the follower's own thread, handing each batch to
        ``on_batch(batch)``; :meth:`stop` ends and joins it. An exception
        there ends the iteration and is kept in :attr:`error`."""
        if self._thread is not None:
            raise RuntimeError('AppendFollower already started')

        def run():
            try:
                for batch in self:
                    on_batch(batch)
            except Exception as e:  # noqa: BLE001 - kept for the owner to read
                logger.exception('append follower: iteration failed')
                self.error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name='petastorm-tpu-torch-follower')
        self._thread.start()
        return self

    def stop(self, timeout=None):
        """End the iteration at its next batch or poll; with an owned
        thread, join it."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout)

    def _fresh_entries(self):
        """The latest generation's undelivered entries, compaction folds of
        delivered rows filtered out; a fold that mixes delivered and
        undelivered sources comes back as entries for its undelivered
        source files (each ``settles`` the fold), never the fold."""
        committed = manifest.load(self.fs, self.root_path)
        if committed is None or committed['generation'] <= self.generation:
            return None
        fresh = []
        for entry in committed['files']:
            if entry['path'] in self._delivered:
                continue
            replaces = entry.get('replaces') or []
            undelivered = [p for p in replaces if p not in self._delivered]
            if replaces and not undelivered:
                self._delivered.add(entry['path'])
                continue
            if replaces and len(undelivered) < len(replaces):
                on_disk = [p for p in undelivered if self._on_disk(p)]
                if len(on_disk) == len(undelivered):
                    fresh.extend({'path': p, 'settles': entry['path']} for p in undelivered)
                    continue
                logger.warning(
                    'append follower: fold %r mixes delivered and undelivered sources but '
                    '%d source file(s) are already garbage-collected; delivering the whole '
                    'fold (bounded redelivery — keep the gc grace window above the follower '
                    'poll interval to avoid this)',
                    entry['path'], len(undelivered) - len(on_disk))
            fresh.append(entry)
        self.generation = committed['generation']
        return fresh

    def _note_staleness(self, pending):
        """Publish the observed lag: the manifest's age while rows are
        pending, 0 once caught up."""
        if metrics_disabled():
            return
        lag = (manifest.staleness_s(self.fs, self.root_path) or 0.0) if pending else 0.0
        get_registry().gauge(APPEND_STALENESS).set(round(lag, 3))

    def _on_disk(self, rel_path):
        try:
            return self.fs.exists(posixpath.join(self.root_path, rel_path))
        except (OSError, ValueError):
            return False

    def _mark_delivered(self, fresh):
        """Record entries as delivered: the entries, every source they
        folded, and any fold a direct source read settles."""
        for entry in fresh:
            self._delivered.add(entry['path'])
            self._delivered.update(entry.get('replaces') or [])
            settles = entry.get('settles')
            if settles is not None:
                self._delivered.add(settles)

    def __iter__(self):
        idle_since = time.monotonic()
        while not self._stop.is_set():
            fresh = self._fresh_entries()
            self._note_staleness(bool(fresh))
            if fresh:
                idle_since = time.monotonic()
                urls = [self._url.rstrip('/') + '/' + e['path'] for e in fresh]
                with self._reader_factory(urls) as reader:
                    for batch in reader:
                        if self._stop.is_set():
                            return
                        yield batch
                # marked after the whole read: a read cut short is delivered
                # again by the next iteration
                self._mark_delivered(fresh)
                continue
            if (self._stop_after_idle_s is not None
                    and time.monotonic() - idle_since >= self._stop_after_idle_s):
                return
            self._stop.wait(self._poll_s)


def follow_dataset(dataset_url, max_staleness_s=5.0, **kwargs):
    """Iterate a growing dataset with a staleness bound."""
    return iter(AppendFollower(dataset_url, max_staleness_s=max_staleness_s, **kwargs))
