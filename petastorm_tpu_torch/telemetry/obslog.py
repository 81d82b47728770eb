"""The on-disk flight log (counterpart of
``petastorm_tpu/telemetry/obslog.py``): closed windows, anomalies and SLO
verdicts as JSON lines, size-capped.

The in-process surfaces (the rollup ring, the anomaly ring, the trace
recorder) die with the process. When ``PETASTORM_TPU_OBS_LOG_DIR`` names
a directory, the sampler (:class:`~petastorm_tpu_torch.telemetry
.timeseries.ObsCollector`) appends each closed window, the anomalies it
raised, the SLO verdicts and a periodic critical-path digest to
``obslog.jsonl`` there. The file is a two-slot ring: past
``PETASTORM_TPU_OBS_LOG_MB`` (default 64) it rotates to
``obslog.jsonl.1``, replacing the previous rotation, so the disk holds at
most about twice the cap.

One record a line, ``{'kind': 'window'|'anomaly'|'slo'|'critpath', 'ts':
..., ...payload}``: the reference's format, so either package's replay
(``python -m petastorm_tpu_torch.tools.obs_replay DIR``) reads the
other's log. Best effort: an unwritable directory logs one warning and
never raises on the sampler thread.
"""

import json
import logging
import os
import threading
import time

from petastorm_tpu_torch.telemetry import knobs

logger = logging.getLogger(__name__)

_LOG_NAME = 'obslog.jsonl'
_DEFAULT_CAP_MB = 64


def log_dir():
    """The armed directory, or None (flight logging off)."""
    return knobs.get_str('PETASTORM_TPU_OBS_LOG_DIR') or None


def cap_bytes():
    return knobs.get_int('PETASTORM_TPU_OBS_LOG_MB', _DEFAULT_CAP_MB, floor=1) * 1024 * 1024


class ObsLogWriter:
    """Appender over the two-slot on-disk ring; one per process."""

    def __init__(self, directory, cap=None):
        self.directory = directory
        self.path = os.path.join(directory, _LOG_NAME)
        self._cap = cap or cap_bytes()
        self._lock = threading.Lock()
        self._size = None
        self._warned = False

    def append(self, kind, record):
        """Write one record; True when the line landed."""
        line = json.dumps(dict(record, kind=kind), sort_keys=True, default=str)
        with self._lock:
            try:
                if self._size is None:
                    os.makedirs(self.directory, exist_ok=True)
                    self._size = os.path.getsize(self.path) if os.path.exists(self.path) else 0
                if self._size >= self._cap:
                    os.replace(self.path, self.path + '.1')
                    self._size = 0
                with open(self.path, 'a') as f:
                    f.write(line + '\n')
                self._size += len(line) + 1
                return True
            except OSError as e:
                if not self._warned:
                    self._warned = True
                    logger.warning('obs log %s unwritable (%s); flight logging degraded '
                                   'for this process', self.path, e)
                return False


def read_log(directory):
    """Every surviving record under ``directory``, oldest first (the
    rotated slot, then the live file). Torn lines (a crash mid-write) are
    skipped."""
    records = []
    base = os.path.join(directory, _LOG_NAME)
    for path in (base + '.1', base):
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    continue
    return records


_writer_lock = threading.Lock()
_writer = None


def get_writer():
    """The process-wide writer when the knob arms a directory, else None;
    made anew when the directory changes."""
    global _writer
    directory = log_dir()
    if directory is None:
        return None
    with _writer_lock:
        if _writer is None or _writer.directory != directory:
            _writer = ObsLogWriter(directory)
        return _writer


def append(kind, record):
    """Append one record when a directory is armed; a no-op otherwise."""
    writer = get_writer()
    if writer is None:
        return False
    if 'ts' not in record:
        record = dict(record, ts=time.time())
    return writer.append(kind, record)


def refresh_obslog():
    """Knob-refresh hook: the next append re-reads the directory and cap."""
    global _writer
    with _writer_lock:
        _writer = None


def _reset_for_tests():
    refresh_obslog()
