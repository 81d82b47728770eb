"""Wire protocol of the decode service (counterpart of
``petastorm_tpu/service/protocol.py``; every frame is byte-compatible with
the reference's, so a port worker server serves a reference dispatcher and
the other way round).

One ZMQ ROUTER socket on the dispatcher; one DEALER per worker server. All
messages are multipart frames; the first payload frame is the message type.
The DEALER side sends ``[TYPE, ...]``; the ROUTER side sees
``[identity, TYPE, ...]`` and addresses replies with the same identity.

    worker ──► dispatcher                      dispatcher ──► worker
    REGISTER [<pid> [<fps> [<peer advert>]]]   SPEC <job payload> [<token>]
    READY                                      WORK <item id> <item payload>
    HEARTBEAT [<obs summary> [<token>]]        HEARTBEAT_ACK [<token>]
    DONE <item id> <metrics> <result>*         STOP
    ERROR <item id> <exc payload> <metrics>
    BYE

A standing dispatcher also speaks a client vocabulary on the same ROUTER
socket; clients are DEALER peers told apart by message type alone:

    client ──► dispatcher                      dispatcher ──► client
    REGISTER_JOB <spec> <params json>          JOB_OK <job id> <token>
                                               BUSY <info json>  (retryable)
    SUBMIT <job id> <client item id> <item>    RESULT <kind> <cid> <payload>*
    CLIENT_HB <job id> <acked count>           CLIENT_HB_ACK <token> <status>
    JOB_GONE <job id>                          JOB_EXPIRED <job id>

The optional trailing ``<token>`` frames carry the dispatcher's random
incarnation token. A worker echoes the token its SPEC carried on every
HEARTBEAT (its own frame, never inside the advisory summary) and treats an
ack bearing a different token as proof that a new dispatcher took the
endpoint: it abandons the job and re-registers. The dispatcher re-admits a
foreign-token worker for liveness but never assigns it work.

The ``<metrics>`` frame carries the worker server's telemetry delta
(:func:`~petastorm_tpu_torch.telemetry.dump_delta_frame`, b'' when nothing
changed), so the dispatcher aggregates stage timings fleet-wide; with
tracing on it also carries the server's trace events. The HEARTBEAT's
optional summary frame is JSON (pid, uptime, counter rates, the server's
own obs endpoint port).

Work items and the job spec ride dill; result payloads ride the serializer
named in the job spec (:class:`~petastorm_tpu_torch.serializers.PickleSerializer`
by default). Payloads are dill/pickle, arbitrary code by design (the job
spec IS code): bind the dispatcher to loopback or a private network only.
"""

import dill

# worker -> dispatcher
MSG_REGISTER = b'REG'
MSG_READY = b'RDY'
MSG_HEARTBEAT = b'HB'
MSG_DONE = b'DONE'
MSG_ERROR = b'ERR'
MSG_BYE = b'BYE'

# dispatcher -> worker
MSG_SPEC = b'SPEC'
MSG_WORK = b'WORK'
MSG_STOP = b'STOP'
MSG_HEARTBEAT_ACK = b'HBACK'

# client -> standing dispatcher. These frames are ADDITIVE: a standing daemon still speaks the whole
# worker vocabulary above unchanged (an old-build worker server needs no
# REGISTER_JOB awareness), and an old embedded dispatcher that receives
# one of these simply logs an unknown message type — both directions
# stay compatible with frame-less builds.
MSG_REGISTER_JOB = b'REGJOB'     # [REGJOB, <spec payload>, <params json>]
MSG_SUBMIT = b'SUBMIT'           # [SUBMIT, <job id>, <client item id>, <payload>]
MSG_CLIENT_HB = b'CHB'           # [CHB, <job id>, <acked count>]
MSG_JOB_GONE = b'JOBGONE'        # [JOBGONE, <job id>]

# standing dispatcher -> client
MSG_JOB_OK = b'JOBOK'            # [JOBOK, <job id>, <token>]
MSG_BUSY = b'BUSY'               # [BUSY, <info json>] — retryable refusal
MSG_JOB_EXPIRED = b'JOBEXP'      # [JOBEXP, <job id>] — lease lapsed / unknown
MSG_CLIENT_HB_ACK = b'CHBACK'    # [CHBACK, <token>, <status json>]
MSG_RESULT = b'RES'              # [RES, <kind>, <client item id>, <payload>*]
# MSG_RESULT's kind frame carries b'result' / b'error' / b'marker' /
# b'poisoned' — the wire form of the dispatcher's local delivery tuples

# warm-standby replication. The standby daemon is one more DEALER peer on the primary's ROUTER socket
# — told apart by message type exactly like clients — that periodically
# pulls a registry snapshot. Pull, not push: the primary stays ignorant
# of how many standbys watch it, and a lapsed standby costs nothing.
# These frames are ADDITIVE like the client vocabulary: an old
# dispatcher logs an unknown message type and the standby degrades to a
# cold promote (re-registration only).
MSG_STANDBY_SYNC = b'SSYNC'      # [SSYNC] — standby pulls a snapshot
MSG_STANDBY_STATE = b'SSTATE'    # [SSTATE, <token>, <state payload>]

# fleet-wide decoded-cache tier. Two ADDITIVE vocabularies. (1) Directory lookups on the dispatcher's
# ROUTER: a worker's peer-cache client is one more DEALER peer (its own
# socket — the worker's network loop owns the main DEALER) asking which
# fleet members hold a decoded entry digest. (2) Entry fetches on a
# worker server's OWN serve ROUTER: a fetching peer asks for the
# finished Arrow IPC bytes of one entry. Old builds on either side log
# an unknown message type and the fetcher degrades to local decode —
# never wrong, only decode-priced.
MSG_DIR_GET = b'DIRGET'          # [DIRGET, <digests json list>]
MSG_DIR = b'DIR'                 # [DIR, <{digest: [[endpoint, size], ...]} json>]
MSG_PEER_FETCH = b'PFETCH'       # [PFETCH, <digest>]
MSG_PEER_ENTRY = b'PENTRY'       # [PENTRY, <digest>, <meta json>, <chunk>*]
MSG_PEER_MISS = b'PMISS'         # [PMISS, <digest>] — holder no longer has it


def pack_item_id(item_id):
    return b'%d' % item_id


def unpack_item_id(frame):
    return int(frame)


def dump_job_spec(worker_class, worker_args, serializer):
    """The payload a worker server needs to become this job's decode worker."""
    return dill.dumps((worker_class, worker_args, serializer))


def load_job_spec(payload):
    return dill.loads(payload)


def dump_work_item(args, kwargs):
    return dill.dumps((args, kwargs))


def load_work_item(payload):
    return dill.loads(payload)


def dump_exception(exc):
    try:
        return dill.dumps(exc)
    except Exception:  # noqa: BLE001 - unpicklable exception
        from petastorm_tpu_torch.telemetry import count_swallowed
        count_swallowed('exception-pickle')
        return dill.dumps(RuntimeError('%s: %s' % (type(exc).__name__, exc)))


def load_exception(payload):
    return dill.loads(payload)


def dump_metrics_delta():
    """The calling process's registry increments since the previous call,
    framed for the wire (b'' when nothing changed — telemetry must never
    fail a completion, so errors degrade to the empty frame). One shared
    framing with the process pool's markers
    (:func:`petastorm_tpu_torch.telemetry.registry.dump_delta_frame`)."""
    from petastorm_tpu_torch.telemetry.registry import dump_delta_frame
    return dump_delta_frame()


def load_metrics_delta(frame):
    """Inverse of :func:`dump_metrics_delta`; None for empty, undecodable
    or non-delta-shaped frames (a dropped delta loses gauge freshness,
    nothing more)."""
    from petastorm_tpu_torch.telemetry.registry import load_delta_frame
    return load_delta_frame(frame)


def dump_obs_summary(summary):
    """Frame a worker server's per-heartbeat observability summary
    (:class:`~petastorm_tpu_torch.telemetry.timeseries.HeartbeatSummarizer`)
    for the HEARTBEAT message's optional trailing frame. JSON, not dill:
    the payload is plain scalars and the dispatcher must be able to
    serve it to an HTTP scrape verbatim. Errors degrade to ``b''``
    (observability must never fail a heartbeat)."""
    import json

    try:
        return json.dumps(summary).encode()
    except Exception:  # noqa: BLE001 - telemetry is advisory
        from petastorm_tpu_torch.telemetry import count_swallowed
        count_swallowed('obs-summary-encode')
        return b''


def load_obs_summary(frame):
    """Inverse of :func:`dump_obs_summary`; None for empty, undecodable
    or non-dict frames (a pre-observability worker build sends a bare
    HEARTBEAT — the absence of the frame is the compatible case)."""
    if not frame:
        return None
    import json

    try:
        summary = json.loads(frame)
    except Exception:  # noqa: BLE001 - telemetry is advisory
        return None
    return summary if isinstance(summary, dict) else None


def dump_poisoned_info(info):
    """Frame a quarantine descriptor for a client job's RESULT channel.
    dill-first so ``poison_policy='raise'`` can surface the ORIGINAL
    worker exception on the client; an unpicklable member degrades the
    ``error`` field to its repr (the loss is cosmetic — the quarantine
    itself, the attempts count and the reason always arrive)."""
    try:
        return dill.dumps(info)
    except Exception:  # noqa: BLE001 - unpicklable member
        from petastorm_tpu_torch.telemetry import count_swallowed
        count_swallowed('poisoned-info-pickle')
        degraded = dict(info)
        if degraded.get('error') is not None:
            degraded['error'] = RuntimeError(repr(degraded['error']))
        try:
            return dill.dumps(degraded)
        except Exception:  # noqa: BLE001 - give the client SOMETHING
            return dill.dumps({'item_id': info.get('item_id'),
                               'attempts': info.get('attempts'),
                               'reason': str(info.get('reason')),
                               'error': None})


def load_poisoned_info(payload):
    return dill.loads(payload)


def dump_json_params(params):
    """Frame a small scalar dict (job params, BUSY info, heartbeat-ack
    status) as JSON — NOT dill: these frames cross trust-relevant
    client/daemon boundaries where arbitrary-code payloads are reserved
    for the job spec alone, and the daemon must be able to serve them to
    an HTTP scrape verbatim. Errors degrade to ``b'{}'``."""
    import json

    try:
        return json.dumps(params or {}).encode()
    except Exception:  # noqa: BLE001 - params are advisory metadata
        from petastorm_tpu_torch.telemetry import count_swallowed
        count_swallowed('json-params-encode')
        return b'{}'


def load_json_params(frame):
    """Inverse of :func:`dump_json_params`; ``{}`` for empty, undecodable
    or non-dict frames (a missing param falls back to its default)."""
    if not frame:
        return {}
    import json

    try:
        params = json.loads(frame)
    except Exception:  # noqa: BLE001 - advisory metadata
        return {}
    return params if isinstance(params, dict) else {}


def dump_standby_state(state):
    """Frame the dispatcher's replication snapshot (job specs, leases,
    credit watermarks, QoS params, fleet cache directory — see
    ``Dispatcher.standby_snapshot``) for the SSTATE reply. dill, not
    JSON: the snapshot embeds the jobs' spec payloads verbatim, which
    are dill by design (the job spec IS code — same trust model as the
    rest of the wire). Errors degrade to ``b''`` (a lost snapshot costs
    one sync round, never the primary)."""
    try:
        return dill.dumps(state)
    except Exception:  # noqa: BLE001 - replication is advisory
        from petastorm_tpu_torch.telemetry import count_swallowed
        count_swallowed('standby-state-encode')
        return b''


def load_standby_state(payload):
    """Inverse of :func:`dump_standby_state`; None for empty or
    undecodable frames (the standby keeps its previous snapshot and the
    lag gauge shows the staleness)."""
    if not payload:
        return None
    try:
        state = dill.loads(payload)
    except Exception:  # noqa: BLE001 - replication is advisory
        from petastorm_tpu_torch.telemetry import count_swallowed
        count_swallowed('standby-state-decode')
        return None
    return state if isinstance(state, dict) else None


def free_tcp_port(host='127.0.0.1'):
    """A currently-free TCP port on ``host`` (small bind race accepted;
    used by tests and the benchmark CLI to pre-agree an endpoint)."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]
