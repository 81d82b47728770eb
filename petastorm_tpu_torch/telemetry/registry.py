"""Process-wide metrics registry: counters, gauges and fixed-bucket
histograms (counterpart of ``petastorm_tpu/telemetry/registry.py``).
Stdlib only; one lock per metric instance. A spawned decode worker records
into its own registry and ships the increments back with each completion
marker (:func:`dump_delta_frame`); the consumer folds them into its own
(:func:`merge_worker_delta`)."""

import bisect
import threading

#: default histogram buckets (seconds); the +Inf bucket is implicit
DEFAULT_DURATION_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def metric_key(name, labels=None):
    """``name`` or ``name{k="v",...}`` with label keys sorted and label
    values escaped as Prometheus escapes them."""
    if not labels:
        return name
    inner = ','.join('%s="%s"' % (k, _escape_label(str(v)))
                     for k, v in sorted(labels.items()))
    return '%s{%s}' % (name, inner)


def _escape_label(value):
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (value.replace('\\', '\\\\').replace('"', '\\"')
            .replace('\n', '\\n'))


class Counter:
    """Monotonic float counter."""

    __slots__ = ('_value', '_lock')

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError('counters only go up; got %r' % (amount,))
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value


class Gauge:
    """Settable instantaneous value."""

    __slots__ = ('_value', '_lock')

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount=1.0):
        self.inc(-amount)

    @property
    def value(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram; the +Inf bucket is the trailing slot."""

    __slots__ = ('buckets', '_counts', '_sum', '_count', '_lock')

    def __init__(self, buckets=DEFAULT_DURATION_BUCKETS):
        buckets = tuple(float(b) for b in buckets)
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError('histogram buckets must be strictly ascending; '
                             'got %r' % (buckets,))
        self.buckets = buckets
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value):
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def sum(self):
        return self._sum

    @property
    def count(self):
        return self._count

    def state(self):
        with self._lock:
            return {'buckets': list(self.buckets), 'counts': list(self._counts),
                    'sum': self._sum, 'count': self._count}


class MetricsRegistry:
    """Named metrics with optional labels and a JSON-safe snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {Counter: {}, Gauge: {}, Histogram: {}}
        # collect_delta's cursor: each key's value at the previous call
        self._delta_base = {Counter: {}, Gauge: {}, Histogram: {}}

    def _get(self, kind, name, labels, *args):
        return self._by_key(kind, metric_key(name, labels), *args)

    def counter(self, name, **labels):
        return self._get(Counter, name, labels)

    def gauge(self, name, **labels):
        return self._get(Gauge, name, labels)

    def histogram(self, name, buckets=DEFAULT_DURATION_BUCKETS, **labels):
        return self._get(Histogram, name, labels, buckets)

    def _value(self, kind, name, labels):
        metric = self._metrics[kind].get(metric_key(name, labels))
        return metric.value if metric is not None else 0.0

    def counter_value(self, name, **labels):
        return self._value(Counter, name, labels)

    def gauge_value(self, name, **labels):
        return self._value(Gauge, name, labels)

    def _with_prefix(self, kind, prefix):
        return {k: m.value for k, m in list(self._metrics[kind].items())
                if k.startswith(prefix)}

    def counters_with_prefix(self, prefix):
        """``{key: value}`` of every counter whose key starts with
        ``prefix`` (the labelled series of one name share its prefix)."""
        return self._with_prefix(Counter, prefix)

    def gauges_with_prefix(self, prefix):
        return self._with_prefix(Gauge, prefix)

    def snapshot(self):
        """Full state as a JSON-serializable dict."""
        return {
            'counters': {k: c.value for k, c in list(self._metrics[Counter].items())},
            'gauges': {k: g.value for k, g in list(self._metrics[Gauge].items())},
            'histograms': {k: h.state()
                           for k, h in list(self._metrics[Histogram].items())},
        }


    # -- cross-process aggregation -----------------------------------------

    def collect_delta(self):
        """The increments since the previous call (the worker-side flush):
        counters and histograms ship increments, gauges their current
        value. None when nothing changed."""
        delta = {'counters': {}, 'gauges': {}, 'histograms': {}}
        base = self._delta_base
        for key, c in list(self._metrics[Counter].items()):
            value = c.value
            before = base[Counter].get(key, 0.0)
            if value != before:
                delta['counters'][key] = value - before
                base[Counter][key] = value
        for key, h in list(self._metrics[Histogram].items()):
            state = h.state()
            before = base[Histogram].get(key)
            if before is None or before['count'] != state['count']:
                delta['histograms'][key] = state if before is None else {
                    'buckets': state['buckets'],
                    'counts': [a - b for a, b in zip(state['counts'], before['counts'])],
                    'sum': state['sum'] - before['sum'],
                    'count': state['count'] - before['count']}
                base[Histogram][key] = state
        for key, g in list(self._metrics[Gauge].items()):
            value = g.value
            if base[Gauge].get(key) != value:
                delta['gauges'][key] = value
                base[Gauge][key] = value
        if not (delta['counters'] or delta['gauges'] or delta['histograms']):
            return None
        return delta

    def merge_delta(self, delta):
        """Fold a worker's :meth:`collect_delta` payload into this registry
        (gauges: last writer wins). A histogram whose bucket layout differs
        from this registry's drops its increment."""
        if not delta:
            return
        for key, inc in delta.get('counters', {}).items():
            self._by_key(Counter, key).inc(inc)
        for key, value in delta.get('gauges', {}).items():
            self._by_key(Gauge, key).set(value)
        for key, inc in delta.get('histograms', {}).items():
            hist = self._by_key(Histogram, key, inc['buckets'])
            with hist._lock:
                if len(hist._counts) == len(inc['counts']):
                    hist._counts = [a + b for a, b in zip(hist._counts, inc['counts'])]
                    hist._sum += inc['sum']
                    hist._count += inc['count']

    def _by_key(self, kind, key, *args):
        """The metric of ``kind`` under ``key``, made on first use."""
        table = self._metrics[kind]
        metric = table.get(key)
        if metric is None:
            with self._lock:
                metric = table.setdefault(key, kind(*args))
        return metric


_global_lock = threading.Lock()
_global_registry = None
_reset_hooks = []


def on_registry_reset(hook):
    """Run ``hook`` whenever :func:`reset_registry` swaps the registry
    (modules caching metric objects register here)."""
    _reset_hooks.append(hook)


def get_registry():
    """The process-wide registry every pipeline layer records into."""
    global _global_registry
    if _global_registry is None:
        with _global_lock:
            if _global_registry is None:
                _global_registry = MetricsRegistry()
    return _global_registry


def reset_registry():
    """Swap in a fresh process-wide registry (test isolation)."""
    global _global_registry
    with _global_lock:
        _global_registry = MetricsRegistry()
    for hook in _reset_hooks:
        hook()


def dump_delta_frame():
    """The process-wide registry's increments since the previous call,
    dill-framed for a pool's result channel (b'' when nothing changed);
    the one owner of delta framing. Trace events the flight recorder holds
    ride along under ``trace_events`` and leave the recorder. Telemetry
    never fails a completion: an error gives b''."""
    import dill
    try:
        delta = get_registry().collect_delta()
        from petastorm_tpu_torch.telemetry.recorder import get_recorder
        recorder = get_recorder()
        if len(recorder):
            delta = delta or {'counters': {}, 'gauges': {}, 'histograms': {}}
            delta['trace_events'] = recorder.drain()
        return dill.dumps(delta) if delta else b''
    except Exception:  # noqa: BLE001 - telemetry is advisory
        return b''


def load_delta_frame(frame):
    """Inverse of :func:`dump_delta_frame`; None for an empty, undecodable
    or not delta-shaped frame. The shape check is strict: exactly the
    three delta keys, all dicts (plus an optional ``trace_events`` list),
    at least one of them non-empty, so no other pickled payload passes
    for a delta."""
    if not frame:
        return None
    import dill
    try:
        delta = dill.loads(frame)
    except Exception:  # noqa: BLE001 - telemetry is advisory
        return None
    if not isinstance(delta, dict):
        return None
    base_keys = {'counters', 'gauges', 'histograms'}
    if set(delta) not in (base_keys, base_keys | {'trace_events'}):
        return None
    if not all(isinstance(delta[k], dict) for k in base_keys):
        return None
    if not isinstance(delta.get('trace_events', []), list):
        return None
    if not any(delta.values()):
        return None
    return delta


def merge_worker_delta(delta):
    """The consumer side of a delta that came over a pool's channel: fold
    it into the process-wide registry, its trace events into the
    recorder, and replay its wait increments into the stall attributor,
    so a worker's back-pressure takes part in window verdicts. Never
    raises."""
    if not delta:
        return
    try:
        _merge_worker_delta(delta)
    except Exception:  # noqa: BLE001 - telemetry is advisory
        import logging
        logging.getLogger(__name__).debug('Dropping unmergeable metrics delta', exc_info=True)


def _merge_worker_delta(delta):
    get_registry().merge_delta(delta)
    events = delta.get('trace_events')
    if events:
        from petastorm_tpu_torch.telemetry.recorder import get_recorder
        get_recorder().add_many(e for e in events if isinstance(e, dict))
    counters = delta.get('counters', {})
    # late imports: the package's __init__ imports this module first
    from petastorm_tpu_torch.telemetry import STALL_CONSUMER_WAIT, STALL_PRODUCER_WAIT
    from petastorm_tpu_torch.telemetry.stall import get_attributor
    producer = counters.get(STALL_PRODUCER_WAIT, 0.0)
    consumer = counters.get(STALL_CONSUMER_WAIT, 0.0)
    if producer > 0.0:
        get_attributor().note_producer_wait(producer)
    if consumer > 0.0:
        get_attributor().note_consumer_wait(consumer)
