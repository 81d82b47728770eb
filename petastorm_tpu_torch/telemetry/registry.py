"""Process-wide metrics registry: counters, gauges and fixed-bucket
histograms (counterpart of ``petastorm_tpu/telemetry/registry.py``
without the cross-process delta channel, which waits for the process
pool). Stdlib only; one lock per metric instance."""

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

    def _get(self, kind, name, labels, *args):
        key = metric_key(name, labels)
        table = self._metrics[kind]
        metric = table.get(key)
        if metric is None:
            with self._lock:
                metric = table.setdefault(key, kind(*args))
        return metric

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
