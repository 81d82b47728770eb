"""Worker server: a standalone decode host process for the service pool
(counterpart of ``petastorm_tpu/service/worker_server.py``).

Runs any :class:`~petastorm_tpu_torch.workers.worker_base.WorkerBase` against
work items streamed from a dispatcher over ``tcp://``::

    python -m petastorm_tpu_torch.service.worker_server \\
        --endpoint tcp://10.0.0.5:7777 --worker-id 0

* **Registration with retry/backoff**: REGISTER is re-sent on an exponential
  backoff until the dispatcher answers with the job SPEC, so worker servers
  can start before the dispatcher exists.
* **The network loop owns the socket**: the main thread polls, heartbeats
  and ships buffered results; one executor thread runs ``process()``, so
  heartbeats keep flowing during a long decode.
* **Atomic item results**: ``publish_func`` appends to a per-item buffer
  that ships in ONE ``DONE`` after ``process()`` returns: a worker killed
  mid-item has delivered nothing for it, and its re-run is no duplicate.
* **Persistence**: after a job ends (STOP, or no HEARTBEAT_ACK for
  ``ack_timeout``) the server shuts the worker down and registers again, so
  one fleet outlives any number of readers. ``--once`` (or a dead
  ``--parent-pid``) exits instead.
* **Dispatcher restarts**: an ack carrying another incarnation token than
  the SPEC's means a new dispatcher took the endpoint; the server abandons
  the job and re-registers at once.
* **No card**: the server decodes on the host. Its CLI hides the GPUs
  (``CUDA_VISIBLE_DEVICES=''``), and a spawned local fleet goes through
  :func:`~petastorm_tpu_torch.workers.exec_in_new_process.exec_in_new_process`,
  which does the same.

* **The fleet cache tier**: with a host-local cache directory
  (``--cache-dir`` / ``PETASTORM_TPU_DECODED_CACHE_DIR``) the server starts
  its :class:`~petastorm_tpu_torch.service.peer_cache.PeerCacheServer`
  before it registers, so the REGISTER advert carries every entry the host
  kept; a job decoding into a decoded cache gets a
  :class:`~petastorm_tpu_torch.service.peer_cache.PeerCacheClient` for the
  job's lifetime. ``PETASTORM_TPU_PEER_CACHE=0`` is the host-local oracle.
"""

import argparse
import json
import logging
import os
import queue
import signal
import sys
import threading
import time
import uuid

from petastorm_tpu_torch import faults
from petastorm_tpu_torch.service import peer_cache, placement, protocol as proto
from petastorm_tpu_torch.service.peer_cache import materialized_cache_of
from petastorm_tpu_torch.telemetry import (
    count_swallowed, knobs, obs_server, timeseries, tracing,
)

logger = logging.getLogger(__name__)

_POLL_INTERVAL_MS = 50
_REGISTER_BACKOFF_MAX_S = 2.0
_EXECUTOR_JOIN_TIMEOUT_S = 5.0


def _parent_died(parent_pid):
    """Whether process ``parent_pid`` is gone (``os.kill(pid, 0)``, the
    standard library's existence probe; a pid we may not signal exists)."""
    if parent_pid is None:
        return False
    try:
        os.kill(parent_pid, 0)
    except ProcessLookupError:
        return True
    except PermissionError:
        return False
    return False


def _register(sock, parent_pid, register_timeout_s, term_event=None, cache_fps=(),
              peer_server=None):
    """REGISTER with exponential backoff until the SPEC arrives.

    Returns ``(spec payload, dispatcher token)`` (token None from a
    dispatcher that sends none), or ``(None, None)`` when the server should
    exit (orphaned, SIGTERMed, or the registration window closed).
    """
    backoff_s = 0.1
    deadline = None if register_timeout_s is None else time.monotonic() + register_timeout_s
    last_parent_check = 0.0
    # the cache-fingerprint advert (JSON list, an additive frame like the
    # pid): the dispatcher must see which decoded caches this HOST holds
    # before it binds us to a job
    try:
        advert = json.dumps(list(cache_fps)).encode() if cache_fps else b''
    except Exception:  # noqa: BLE001 - placement is advisory
        count_swallowed('worker-cache-advert')
        advert = b''
    # the fleet cache tier: the full set of entries this host holds rides
    # REGISTER, so the dispatcher's directory is complete before the first
    # WORK lands
    peer_advert = b''
    if peer_server is not None:
        try:
            peer_advert = proto.dump_json_params(peer_server.full_advert())
        except Exception:  # noqa: BLE001 - adverts are advisory
            count_swallowed('worker-peer-advert')
            peer_advert = b''
    frames_out = [proto.MSG_REGISTER, b'%d' % os.getpid()]
    if peer_advert:
        # frames are positional: the placement advert holds frame 3
        # (possibly empty) so the peer advert lands at frame 4
        frames_out.extend([advert, peer_advert])
    elif advert:
        frames_out.append(advert)
    while True:
        # the pid frame is advisory and additive: it lets a standing
        # daemon's supervisor tell a worker between jobs from a wedged one
        sock.send_multipart(frames_out)
        poll_deadline = time.monotonic() + backoff_s
        while time.monotonic() < poll_deadline:
            if term_event is not None and term_event.is_set():
                logger.info('SIGTERM during registration; exiting')
                return None, None
            if sock.poll(_POLL_INTERVAL_MS):
                frames = sock.recv_multipart()
                if frames[0] == proto.MSG_SPEC:
                    return frames[1], (frames[2] if len(frames) > 2 else None)
                # STOP/stray frames during registration are meaningless
                continue
            now = time.monotonic()
            if now - last_parent_check > 1.0:
                last_parent_check = now
                if _parent_died(parent_pid):
                    logger.info('Parent %s died; exiting', parent_pid)
                    return None, None
            if deadline is not None and now > deadline:
                logger.error('No dispatcher answered REGISTER within %.1fs',
                             register_timeout_s)
                return None, None
        backoff_s = min(backoff_s * 2, _REGISTER_BACKOFF_MAX_S)


def _reroot_decoded_cache(worker_args):
    """Point a job's materialized decoded cache at THIS host's shared
    directory (``--cache-dir`` / ``PETASTORM_TPU_DECODED_CACHE_DIR``).

    The cache travels inside the job spec with the directory the client
    configured, which means nothing on a remote decode host. With the
    override set, every job the server serves lands on one local tier, so N
    jobs over one dataset decode each row-group once per host. Without it
    the spec's directory is kept (a localhost fleet shares the client's)."""
    cache_dir = knobs.get_str('PETASTORM_TPU_DECODED_CACHE_DIR')
    if not cache_dir:
        return
    cache = materialized_cache_of(worker_args)
    if cache is not None and cache.path != cache_dir:
        logger.info('Rerooting decoded cache %s -> %s', cache.path, cache_dir)
        cache.reroot(cache_dir)


def _run_job(sock, spec_payload, worker_id, heartbeat_interval_s, ack_timeout_s,
             parent_pid, status=None, token=None, term_event=None, known_fps=None,
             endpoint=None, peer_server=None, peer_live=None):
    """One job lifetime: build the worker, stream items until STOP, the
    dispatcher vanishes (ack timeout), or another dispatcher incarnation
    takes the endpoint (heartbeat-ack token mismatch). Returns True if the
    server should serve again."""
    worker_class, worker_args, serializer = proto.load_job_spec(spec_payload)
    _reroot_decoded_cache(worker_args)
    # cache-aware placement: this job's decode fingerprint joins the host's
    # advert set (heartbeat summaries now; a marker file so later server
    # processes advertise it from their first REGISTER)
    fingerprint = placement.placement_fingerprint(worker_args)
    if fingerprint:
        known_fps = known_fps if known_fps is not None else set()
        known_fps.add(fingerprint)
        placement.note_fingerprint(knobs.get_str('PETASTORM_TPU_DECODED_CACHE_DIR'),
                                   fingerprint)
    advertised = sorted(known_fps)[:placement.MAX_ADVERTISED] if known_fps else None
    # the per-heartbeat observability summary: thread-free rates since the
    # previous heartbeat, for the dispatcher's per-worker fleet view
    summarizer = timeseries.HeartbeatSummarizer(worker_id)
    status = status if status is not None else {}

    buffer = []
    worker = worker_class(worker_id, buffer.append, worker_args)
    worker.initialize()
    peer_server, peer_client, peer_cached = _wire_peer_client(worker_args, endpoint, peer_server,
                                                              peer_live)

    work_queue = queue.Queue()
    out_queue = queue.Queue()
    stop_flag = threading.Event()

    def executor():
        while not stop_flag.is_set():
            try:
                item_id, payload = work_queue.get(timeout=0.05)
            except queue.Empty:
                continue
            del buffer[:]
            try:
                args, kwargs = proto.load_work_item(payload)
                # a traced item's context rides inside the WORK frame's
                # kwargs: its stage spans and the attempt event join the
                # item's timeline and ship back in the DONE's delta frame
                ctx = kwargs.pop(tracing.TRACE_CTX_KEY, None)
                with tracing.attempt(ctx, 'service-%d' % worker_id):
                    worker.process(*args, **kwargs)
                # the metrics delta rides the DONE, so the dispatcher
                # aggregates the whole fleet without another channel
                frames = ([proto.MSG_DONE, proto.pack_item_id(item_id),
                           proto.dump_metrics_delta()]
                          + [serializer.serialize(v) for v in buffer])
                status['items_done'] = status.get('items_done', 0) + 1
            except Exception as e:  # noqa: BLE001 - forwarded to consumer
                logger.debug('Worker %d forwarding exception', worker_id, exc_info=True)
                frames = [proto.MSG_ERROR, proto.pack_item_id(item_id),
                          proto.dump_exception(e), proto.dump_metrics_delta()]
                # errored items are not done: a sick worker's completions
                # must show stalling in the fleet view
                status['items_errored'] = status.get('items_errored', 0) + 1
            out_queue.put(frames)

    executor_thread = threading.Thread(target=executor, daemon=True,
                                       name='petastorm-tpu-torch-service-executor')
    executor_thread.start()

    sock.send_multipart([proto.MSG_READY])
    now = time.monotonic()
    last_heartbeat_sent = 0.0
    last_ack = now
    last_parent_check = now
    serve_again = True
    try:
        while True:
            now = time.monotonic()
            if now - last_heartbeat_sent >= heartbeat_interval_s:
                last_heartbeat_sent = now
                if faults.ARMED and faults.fault_hit('zmq.heartbeat', key=worker_id) == 'drop':
                    pass  # injected: heartbeat lost; the dispatcher will lapse
                else:
                    try:
                        summary = summarizer.summary(obs_port=obs_server.server_port())
                        summary['items_done'] = status.get('items_done', 0)
                        if advertised:
                            summary['cache_fp'] = advertised
                        if peer_server is not None:
                            # the bounded add/evict/touch delta since the
                            # last heartbeat
                            delta = peer_server.advert_delta()
                            if delta:
                                summary['peer'] = delta
                        frame = proto.dump_obs_summary(summary)
                    except Exception:  # noqa: BLE001 - advisory telemetry
                        count_swallowed('worker-obs-summary')
                        frame = b''
                    if token is not None:
                        # the token rides its OWN frame, never inside the
                        # advisory summary: the dispatcher's foreign-worker
                        # check must survive the summary degrading to b''
                        sock.send_multipart([proto.MSG_HEARTBEAT, frame, token])
                    elif frame:
                        sock.send_multipart([proto.MSG_HEARTBEAT, frame])
                    else:
                        sock.send_multipart([proto.MSG_HEARTBEAT])
            while True:
                try:
                    result_frames = out_queue.get_nowait()
                except queue.Empty:
                    break
                if faults.ARMED and faults.fault_hit(
                        'zmq.done', key=result_frames[1]) == 'drop':
                    continue  # injected: completion lost in flight
                sock.send_multipart(result_frames)
            if sock.poll(_POLL_INTERVAL_MS):
                frames = sock.recv_multipart()
                msg = frames[0]
                if msg == proto.MSG_WORK:
                    work_queue.put((proto.unpack_item_id(frames[1]), frames[2]))
                    if peer_client is not None and len(frames) > 3 and frames[3]:
                        # a piggybacked fleet-directory delta: holders of
                        # recently advertised entries, no DIRGET needed
                        peer_client.update_directory(proto.load_json_params(frames[3]))
                elif msg == proto.MSG_STOP:
                    logger.info('Dispatcher sent STOP; job over')
                    break
                elif msg == proto.MSG_HEARTBEAT_ACK:
                    last_ack = now
                    if peer_server is not None and len(frames) > 2 and frames[2]:
                        # advisory global-eviction hints (an additive
                        # trailing frame); the holder re-checks its atime
                        try:
                            hints = proto.load_json_params(frames[2]).get('evict')
                            if hints:
                                peer_server.apply_evict_hints(hints)
                        except Exception:  # noqa: BLE001 - advisory
                            count_swallowed('peer-evict-hint')
                    if token is not None and len(frames) > 1 and frames[1] != token:
                        # a NEW dispatcher incarnation answered on this
                        # endpoint: our job spec and item-id space are dead
                        logger.warning('Dispatcher incarnation changed (token %r -> %r); '
                                       'abandoning job to re-register', token, frames[1])
                        break
                elif msg == proto.MSG_SPEC:
                    pass  # duplicate reply to a re-sent REGISTER
            if now - last_ack > ack_timeout_s:
                logger.warning('No dispatcher heartbeat ack for %.1fs; abandoning job',
                               ack_timeout_s)
                break
            if now - last_parent_check > 1.0:
                last_parent_check = now
                if _parent_died(parent_pid):
                    logger.info('Parent %s died; exiting', parent_pid)
                    serve_again = False
                    break
            if term_event is not None and term_event.is_set():
                # graceful release: stop taking work, say BYE, exit; never a
                # heartbeat lapse, so nothing is re-ventilated
                logger.info('SIGTERM: finishing job and exiting')
                serve_again = False
                break
    finally:
        stop_flag.set()
        executor_thread.join(_EXECUTOR_JOIN_TIMEOUT_S)
        if peer_client is not None:
            # after the join: a live fetch must not race the close
            peer_cached.attach_peer_client(None)
            if peer_live is not None:
                peer_live.pop('client', None)
            peer_client.close()
        if executor_thread.is_alive():
            # a decode wedged past the join budget: shutting the worker down
            # under the live process() call would close its resources
            # mid-use, and re-registering would stack a second worker on
            # the core the first still burns; exit and let the OS reclaim
            logger.warning('Decode still running %.0fs after job end; exiting instead of '
                           're-registering', _EXECUTOR_JOIN_TIMEOUT_S)
            serve_again = False
        else:
            try:
                worker.shutdown()
            except Exception:  # noqa: BLE001 - best-effort shutdown
                count_swallowed('worker-shutdown')
    return serve_again


def _wire_peer_client(worker_args, endpoint, peer_server, peer_live):
    """Serve this job's decoded cache to peers and fetch what peers
    already decoded: ``(server, client, cache)``, where the server is the
    eager one or, without it, one over the spec's own directory for this
    job's lifetime; client and cache are None when the tier is off, the job
    decodes into no healthy cache, or the wiring failed (the tier is
    advisory: a failure here costs hits, never the job)."""
    if not endpoint or not peer_cache.peer_cache_enabled():
        return peer_server, None, None
    cache = materialized_cache_of(worker_args)
    if cache is None or cache.degraded:
        return peer_server, None, None
    try:
        if peer_server is None:
            peer_server = peer_cache.get_server(cache.path)
        client = peer_cache.PeerCacheClient(endpoint, self_endpoint=peer_server.endpoint)
        cache.attach_peer_client(client)
    except Exception:  # noqa: BLE001 - the tier is advisory
        count_swallowed('peer-client-wire')
        return peer_server, None, None
    if peer_live is not None:
        peer_live['client'] = client
    return peer_server, client, cache


def serve(endpoint, worker_id=0, heartbeat_interval_s=1.0, ack_timeout_s=None,
          parent_pid=None, once=False, register_timeout_s=None):
    """Serve decode jobs from the dispatcher at ``endpoint`` until orphaned
    (``parent_pid`` died), the registration window closes, or, with
    ``once``, the first job ends."""
    import zmq

    if ack_timeout_s is None:
        ack_timeout_s = max(10 * heartbeat_interval_s, 10.0)
    # graceful SIGTERM: finish the in-flight item, send BYE, exit (the
    # default instant death reads as a lapse and re-ventilates work).
    # Handlers install only on the main thread; an embedded serve() skips it.
    term_event = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda signum, frame: term_event.set())
    except ValueError:
        pass
    # the live observability plane: with PETASTORM_TPU_OBS_PORT set the
    # server exposes its own /metrics /report /health /trace, and the bound
    # port rides every heartbeat summary into the dispatcher's fleet view
    status = {'worker_id': worker_id, 'state': 'registering', 'jobs_served': 0,
              'items_done': 0, 'endpoint': endpoint}
    peer_live = {}

    def _health():
        # each decode host runs its own readahead manager (the plan rides
        # the job spec), so its numbers belong on this host's /health
        from petastorm_tpu_torch import readahead
        out = dict(status, readahead=readahead.health_snapshot())
        # the fleet cache tier's holder view: what this host serves to
        # peers and, while a job runs, the fetch client's hits and budget
        snap = peer_cache.server_snapshot()
        if snap is not None:
            out['peer_cache'] = snap
        client = peer_live.get('client')
        if client is not None:
            out.setdefault('peer_cache', {})['client'] = client.stats()
        return out

    obs_mount = obs_server.mount('worker-server', health=_health)
    # fingerprints of decoded caches this host holds, advertised on REGISTER
    # and heartbeats: warm markers on disk plus every job this process served
    known_fps = set(placement.advertised_fingerprints(
        knobs.get_str('PETASTORM_TPU_DECODED_CACHE_DIR')))
    # the fleet cache tier: with a host-local cache directory the serve
    # socket starts BEFORE registering, so the REGISTER advert carries what
    # this host kept across restarts
    peer_server = None
    cache_dir = knobs.get_str('PETASTORM_TPU_DECODED_CACHE_DIR')
    if cache_dir and peer_cache.peer_cache_enabled():
        try:
            peer_server = peer_cache.get_server(cache_dir)
        except Exception:  # noqa: BLE001 - the tier is advisory
            count_swallowed('peer-server-start')
    try:
        while True:
            # a fresh socket (and identity) per job lifetime: a stale DEALER
            # can hold frames buffered for the previous dispatcher
            context = zmq.Context()
            sock = context.socket(zmq.DEALER)
            sock.setsockopt(zmq.IDENTITY,
                            ('worker-%d-%s' % (worker_id, uuid.uuid4().hex[:8])).encode())
            sock.setsockopt(zmq.LINGER, 500)
            sock.connect(endpoint)
            try:
                status['state'] = 'registering'
                spec_payload, token = _register(
                    sock, parent_pid, register_timeout_s, term_event=term_event,
                    cache_fps=sorted(known_fps)[:placement.MAX_ADVERTISED],
                    peer_server=peer_server)
                if spec_payload is None:
                    return
                status['state'] = 'serving'
                serve_again = _run_job(sock, spec_payload, worker_id, heartbeat_interval_s,
                                       ack_timeout_s, parent_pid, status=status, token=token,
                                       term_event=term_event, known_fps=known_fps,
                                       endpoint=endpoint, peer_server=peer_server,
                                       peer_live=peer_live)
                status['jobs_served'] += 1
                try:
                    sock.send_multipart([proto.MSG_BYE])
                except Exception:  # noqa: BLE001 - dispatcher may be gone
                    count_swallowed('worker-bye-send')
            finally:
                sock.close(linger=500)
                context.term()
            if once or not serve_again:
                return
    finally:
        peer_cache.close_server()
        obs_mount.close()


def main(argv=None):
    parser = argparse.ArgumentParser(description='petastorm_tpu_torch decode worker server')
    parser.add_argument('--endpoint', required=True,
                        help='dispatcher tcp:// endpoint to register with')
    parser.add_argument('--worker-id', type=int, default=0)
    parser.add_argument('--heartbeat-interval', type=float, default=1.0,
                        help='seconds between heartbeats; the dispatcher declares a worker '
                             'dead after its liveness timeout without one')
    parser.add_argument('--ack-timeout', type=float, default=None,
                        help='exit the current job after this long without a dispatcher '
                             'heartbeat ack (default max(10*interval, 10s))')
    parser.add_argument('--parent-pid', type=int, default=None,
                        help='exit when this process dies (for locally spawned fleets)')
    parser.add_argument('--once', action='store_true',
                        help='exit after the first job instead of re-registering')
    parser.add_argument('--register-timeout', type=float, default=None,
                        help='give up when no dispatcher answers within this many seconds '
                             '(default: retry forever)')
    parser.add_argument('--cache-dir', default=None,
                        help='host-local directory for the materialized decoded-row-group '
                             'cache: every job this server registers for shares it (same '
                             'as setting PETASTORM_TPU_DECODED_CACHE_DIR)')
    parser.add_argument('--obs-port', type=int, default=None,
                        help="expose this server's observability endpoint (/metrics /report "
                             '/health /trace) on this port; 0 picks a free one (same as '
                             'setting PETASTORM_TPU_OBS_PORT)')
    parser.add_argument('-v', '--verbose', action='store_true')
    args = parser.parse_args(argv)
    if args.cache_dir:
        knobs.set_env('PETASTORM_TPU_DECODED_CACHE_DIR', args.cache_dir)
    if args.obs_port is not None:
        knobs.set_env('PETASTORM_TPU_OBS_PORT', str(args.obs_port))
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format='%(asctime)s worker-server[%(process)d] %(message)s')
    # decode hosts never open a context on a trainer's card, whatever the
    # inherited environment says
    os.environ['CUDA_VISIBLE_DEVICES'] = ''
    serve(args.endpoint, worker_id=args.worker_id,
          heartbeat_interval_s=args.heartbeat_interval, ack_timeout_s=args.ack_timeout,
          parent_pid=args.parent_pid, once=args.once,
          register_timeout_s=args.register_timeout)
    return 0


if __name__ == '__main__':
    sys.exit(main())
