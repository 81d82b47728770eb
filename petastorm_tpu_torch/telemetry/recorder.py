"""Flight recorder: a bounded per-process ring of trace events
(counterpart of ``petastorm_tpu/telemetry/recorder.py``; the port's pools
are threads, so every event lands in this one ring and none crosses a
process).

Events are plain dicts already shaped like Chrome trace events:
``{'name', 'ph', 'ts', 'dur', 'pid', 'tid', 'args'}`` with ``ts``/``dur``
in microseconds of wall time (``time.time()``) and ``tid`` a track label
string (``ventilator``, ``thread-3``, ``consumer``, ``stager``).
:func:`export_chrome_trace` interns the labels to integer tids and emits
``thread_name`` metadata, giving Perfetto one named track per label.
"""

import collections
import json
import threading

#: default ring capacity (events per process); at ~10 events per
#: row-group this keeps the most recent ~2k items
DEFAULT_CAPACITY = 20000


class FlightRecorder:
    """Bounded ring of trace events. ``add`` takes no lock (a
    ``deque.append`` with a ``maxlen`` is atomic under the GIL); reads lock
    for a consistent cut."""

    def __init__(self, capacity=DEFAULT_CAPACITY):
        self._events = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def add(self, event):
        self._events.append(event)

    def __len__(self):
        return len(self._events)

    def snapshot(self):
        """All buffered events, oldest first (the ring keeps them)."""
        with self._lock:
            return list(self._events)


_global_lock = threading.Lock()
_global_recorder = None


def get_recorder():
    """The process-wide flight recorder trace events accumulate in."""
    global _global_recorder
    if _global_recorder is None:
        with _global_lock:
            if _global_recorder is None:
                _global_recorder = FlightRecorder()
    return _global_recorder


def reset_recorder():
    """Swap in a fresh process-wide recorder (test isolation)."""
    global _global_recorder
    with _global_lock:
        _global_recorder = FlightRecorder()


def export_chrome_trace(path_or_file, events=None):
    """Write ``events`` (default: the process-wide recorder's snapshot) as
    Chrome trace-event JSON, viewable in Perfetto (ui.perfetto.dev) or
    ``chrome://tracing``: track labels interned to integer tids per
    ``pid``, each announced by a ``thread_name`` metadata event, to a path
    or a writable text file. Returns the number of data events written."""
    if events is None:
        events = get_recorder().snapshot()
    tids = {}          # (pid, label) -> int tid
    out = []
    for event in events:
        pid = event.get('pid', 0)
        label = str(event.get('tid', 'main'))
        tid = tids.get((pid, label))
        if tid is None:
            tid = tids[(pid, label)] = len(tids) + 1
        out.append(dict(event, pid=pid, tid=tid))
    meta = [{'name': 'thread_name', 'ph': 'M', 'pid': pid, 'tid': tid,
             'args': {'name': label}}
            for (pid, label), tid in sorted(tids.items(), key=lambda kv: kv[1])]
    doc = {'traceEvents': meta + out, 'displayTimeUnit': 'ms'}
    if hasattr(path_or_file, 'write'):
        json.dump(doc, path_or_file)
    else:
        with open(path_or_file, 'w') as f:
            json.dump(doc, f)
    return len(out)


def slowest_items(events=None, n=3):
    """The ``n`` traces with the largest summed worker-side duration:
    ``dur`` summed over the complete (``ph == 'X'``) ``attempt`` events of
    each trace id, or over every complete event of it when no attempt was
    recorded. Returns ``[(trace_id, seconds, last_args), ...]``, slowest
    first."""
    if events is None:
        events = get_recorder().snapshot()
    totals = {}
    args_by_id = {}
    have_attempts = any(e.get('name') == 'attempt' and e.get('ph') == 'X'
                        for e in events)
    for event in events:
        if event.get('ph') != 'X':
            continue
        if have_attempts and event.get('name') != 'attempt':
            continue
        trace_id = (event.get('args') or {}).get('trace_id')
        if trace_id is None:
            continue
        totals[trace_id] = totals.get(trace_id, 0.0) + event.get('dur', 0.0)
        args_by_id[trace_id] = event.get('args') or {}
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [(tid, dur / 1e6, args_by_id[tid]) for tid, dur in ranked]
