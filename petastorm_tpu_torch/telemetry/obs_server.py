"""The HTTP observability endpoint (counterpart of
``petastorm_tpu/telemetry/obs_server.py``), stdlib only.

One server a process, armed only when ``PETASTORM_TPU_OBS_PORT`` names a
port (``0`` picks a free one) and metrics are on. With the knob unset no
server or sampler thread and no socket is ever made. Routes:

* ``/metrics``: the registry in the Prometheus text format
  (:func:`~petastorm_tpu_torch.telemetry.export.prometheus_text`);
* ``/report``: the live ``pipeline_report()`` JSON, the ``rollup``
  section and each mounted component's report entries;
* ``/health``: pid, uptime, each mounted component's health dict and,
  when ``PETASTORM_TPU_SLO`` arms a policy, the SLO section (status
  ``slo-breach`` while a target burns);
* ``/trace``: the flight recorder as Chrome trace-event JSON
  (``PETASTORM_TPU_TRACE=1`` must have been on for it to hold events);
* ``/critpath``: the critical-path analysis of the same recorder.

Components mount themselves (:func:`mount`): the port's ``Reader`` as
``reader`` and ``TorchLoader`` as ``torch-loader``. The first armed mount
binds the server (thread ``petastorm-tpu-torch-obs-http``) and starts
the sampler; the server then lives for the process while mounts come and
go. It binds ``127.0.0.1`` unless ``PETASTORM_TPU_OBS_HOST`` names
another address: it is read-only but tells a reader much about the job.
"""

import http.server
import io
import json
import logging
import os
import threading
import time

from petastorm_tpu_torch.telemetry import knobs, timeseries
from petastorm_tpu_torch.telemetry.spans import metrics_disabled

logger = logging.getLogger(__name__)

#: endpoint requests served, by route
OBS_SCRAPES = 'petastorm_tpu_obs_scrapes_total'

_DEFAULT_HOST = '127.0.0.1'
_ROUTES = '/metrics /report /health /trace /critpath'


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.server = None
        self.thread = None
        self.mounts = {}
        self.started_ts = None
        self.bind_failed = False
        self.seq = 0


_state = _State()


class Mount:
    """Handle of one mounted component; ``close()`` detaches it."""

    def __init__(self, key):
        self._key = key

    @property
    def live(self):
        return True

    def close(self):
        with _state.lock:
            _state.mounts.pop(self._key, None)


class _NoopMount:
    """The handle of an unarmed plane: nothing started, nothing to close."""

    @property
    def live(self):
        return False

    def close(self):
        pass


_NOOP_MOUNT = _NoopMount()


class _Provider:
    __slots__ = ('name', 'health', 'report')

    def __init__(self, name, health, report):
        self.name = name
        self.health = health
        self.report = report


def requested_port():
    """The knob's port, or None when it is unset (plane off)."""
    if knobs.get_str('PETASTORM_TPU_OBS_PORT') == '':
        return None
    return knobs.get_int('PETASTORM_TPU_OBS_PORT', None, floor=0)


def mount(name, health=None, report=None):
    """Attach one component to this process's endpoint.

    When the plane is armed, the first mount binds the server and starts
    the sampler; otherwise the shared no-op handle comes back and nothing
    is started. ``health`` and ``report`` are zero-argument callables that
    return JSON-ready dicts, called per request (an exception shows as an
    ``error`` entry). Returns a handle whose ``close()`` detaches it."""
    if metrics_disabled():
        return _NOOP_MOUNT
    port = requested_port()
    if port is None:
        return _NOOP_MOUNT
    with _state.lock:
        _state.seq += 1
        key = '%s-%d' % (name, _state.seq)
        _state.mounts[key] = _Provider(name, health, report)
    _ensure_server(port)
    timeseries.ensure_collector()
    return Mount(key)


def _ensure_server(port):
    with _state.lock:
        if _state.server is not None or _state.bind_failed:
            return
        host = knobs.get_str('PETASTORM_TPU_OBS_HOST') or _DEFAULT_HOST
        try:
            server = http.server.ThreadingHTTPServer((host, port), _Handler)
        except OSError as e:
            # observability is advisory: a fixed port taken by another
            # process logs once, and later mounts do not retry
            _state.bind_failed = True
            logger.warning('Observability endpoint failed to bind %s:%s (%s); set '
                           'PETASTORM_TPU_OBS_PORT=0 for a free port', host, port, e)
            return
        server.daemon_threads = True
        _state.server = server
        _state.started_ts = time.time()
        _state.thread = threading.Thread(target=server.serve_forever, daemon=True,
                                         name='petastorm-tpu-torch-obs-http')
        _state.thread.start()
        logger.info('Observability endpoint listening on http://%s:%d (%s)',
                    *server.server_address[:2], _ROUTES)


def server_port():
    """The bound port of this process's endpoint, or None."""
    server = _state.server
    return server.server_address[1] if server is not None else None


def server_address():
    """``(host, port)`` of the live endpoint, or None."""
    server = _state.server
    return tuple(server.server_address[:2]) if server is not None else None


def _component_sections(attr):
    """``{name: result}`` over every mount's ``attr`` callable; a second
    component of one name gets a numeric suffix."""
    with _state.lock:
        providers = list(_state.mounts.values())
    out = {}
    for provider in providers:
        fn = getattr(provider, attr)
        if fn is None:
            continue
        try:
            value = fn()
        except Exception as e:  # noqa: BLE001 - a scrape must not fail
            value = {'error': repr(e)[:200]}
        name = provider.name
        n = 2
        while name in out:
            name = '%s-%d' % (provider.name, n)
            n += 1
        out[name] = value
    return out


def build_health():
    """The ``/health`` document."""
    from petastorm_tpu_torch.telemetry import slo
    started = _state.started_ts
    doc = {
        'status': 'ok',
        'pid': os.getpid(),
        'ts': time.time(),
        'uptime_s': round(time.time() - started, 3) if started else None,
        'components': _component_sections('health'),
    }
    slo_view = slo.slo_section()
    if slo_view is not None:
        doc['slo'] = slo_view
        if any(t['breaching'] for t in slo_view['targets']):
            doc['status'] = 'slo-breach'
    return doc


def build_report():
    """The ``/report`` document: ``pipeline_report()``, the rollup and the
    mounted components' entries. An entry never overwrites another: a key
    already present gets a numeric suffix."""
    from petastorm_tpu_torch.telemetry.export import pipeline_report
    report = pipeline_report()
    rollup = timeseries.rollup_section()
    if rollup is not None:
        report['rollup'] = rollup
    for section in _component_sections('report').values():
        if not isinstance(section, dict):
            continue
        for key, value in section.items():
            out_key = key
            n = 2
            while out_key in report:
                out_key = '%s-%d' % (key, n)
                n += 1
            report[out_key] = value
    return report


def _json_default(value):
    try:
        return float(value)
    except (TypeError, ValueError):
        return str(value)


def _critpath_body():
    from petastorm_tpu_torch.telemetry import critpath
    section = critpath.critpath_section()
    if section is None:
        section = {'error': 'no trace events recorded (set PETASTORM_TPU_TRACE=1)'}
    return section


def _trace_body():
    from petastorm_tpu_torch.telemetry.recorder import export_chrome_trace
    buf = io.StringIO()
    export_chrome_trace(buf)
    return buf.getvalue()


def _metrics_body():
    from petastorm_tpu_torch.telemetry.export import prometheus_text
    return prometheus_text()


#: route → (body function, content type); a dict body is served as JSON
_ROUTE_TABLE = {
    '/metrics': (_metrics_body, 'text/plain; version=0.0.4'),
    '/report': (build_report, 'application/json'),
    '/health': (build_health, 'application/json'),
    '/trace': (_trace_body, 'application/json'),
    '/critpath': (_critpath_body, 'application/json'),
}


class _Handler(http.server.BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # noqa: A003 - stdlib signature
        logger.debug('obs-http ' + fmt, *args)

    def do_GET(self):  # noqa: N802 - stdlib handler naming
        route = self.path.split('?', 1)[0].rstrip('/') or '/'
        entry = _ROUTE_TABLE.get(route)
        if entry is None:
            self.send_error(404, 'routes: ' + _ROUTES)
            return
        build, content_type = entry
        try:
            body = build()
            if not isinstance(body, str):
                body = json.dumps(body, default=_json_default)
            body = body.encode()
        except Exception:  # noqa: BLE001 - a scrape must not stop the server
            logger.debug('obs-http %s failed', route, exc_info=True)
            self.send_error(500)
            return
        if not metrics_disabled():
            from petastorm_tpu_torch.telemetry.registry import get_registry
            get_registry().counter(OBS_SCRAPES, route=route.strip('/')).inc()
        self.send_response(200)
        self.send_header('Content-Type', content_type)
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _reset_for_tests():
    """Shut the server down and drop every mount (test isolation; a
    production server lives for the process)."""
    with _state.lock:
        server, thread = _state.server, _state.thread
        _state.server = None
        _state.thread = None
        _state.mounts.clear()
        _state.started_ts = None
        _state.bind_failed = False
    if server is not None:
        server.shutdown()
        server.server_close()
    if thread is not None:
        thread.join(timeout=5)
