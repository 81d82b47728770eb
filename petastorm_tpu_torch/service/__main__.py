"""CLI of the standing decode-service daemon (counterpart of
``petastorm_tpu/service/__main__.py``)::

    python -m petastorm_tpu_torch.service --endpoint tcp://0.0.0.0:7777 \\
        --workers 2 --max-workers 8 --obs-port 0

Runs the daemonized dispatcher (job registry, leases, admission control)
and the self-healing worker supervisor until SIGTERM/SIGINT drains the
registry empty (a second signal stops hard).

With ``--standby`` the process is a warm standby instead: it mirrors the
primary daemon already serving ``--endpoint`` and promotes itself onto that
endpoint when the primary goes silent past the lapse window::

    python -m petastorm_tpu_torch.service --standby \\
        --endpoint tcp://127.0.0.1:7777 --workers 2

The daemon and its fleet decode on the host: the GPUs are hidden
(``CUDA_VISIBLE_DEVICES=''``) before anything can load torch.
"""

import argparse
import logging
import os
import sys


def main(argv=None):
    # first, before any import that could load torch and open a context on
    # a card a trainer owns, whatever the inherited environment says (the
    # package and this module import no torch)
    os.environ['CUDA_VISIBLE_DEVICES'] = ''
    from petastorm_tpu_torch.service.daemon import ServiceDaemon
    from petastorm_tpu_torch.telemetry import knobs
    parser = argparse.ArgumentParser(
        prog='python -m petastorm_tpu_torch.service',
        description='petastorm_tpu_torch standing decode-service daemon')
    parser.add_argument('--endpoint', default='tcp://127.0.0.1:0',
                        help='tcp://host:port to bind (port 0 = random; the resolved endpoint '
                             'is logged)')
    parser.add_argument('--workers', type=int, default=1,
                        help='initial supervised worker-server fleet size')
    parser.add_argument('--min-workers', type=int, default=None,
                        help='release floor (default PETASTORM_TPU_SERVICE_MIN_WORKERS)')
    parser.add_argument('--max-workers', type=int, default=None,
                        help='recruitment ceiling (default PETASTORM_TPU_SERVICE_MAX_WORKERS)')
    parser.add_argument('--no-supervisor', action='store_true',
                        help='serve an externally-managed fleet: no worker processes are '
                             'spawned, replaced or released by this daemon')
    parser.add_argument('--heartbeat-interval', type=float, default=1.0)
    parser.add_argument('--liveness-timeout', type=float, default=None,
                        help='heartbeat silence after which a worker is declared dead '
                             '(default 4 intervals)')
    parser.add_argument('--max-jobs', type=int, default=None,
                        help='admission ceiling (default PETASTORM_TPU_SERVICE_MAX_JOBS)')
    parser.add_argument('--lease', type=float, default=None,
                        help='default job lease seconds (default PETASTORM_TPU_SERVICE_LEASE_S)')
    parser.add_argument('--obs-port', type=int, default=None,
                        help='serve /metrics /report /health /trace on this port (0 = ephemeral; '
                             'same as setting PETASTORM_TPU_OBS_PORT)')
    parser.add_argument('--standby', action='store_true',
                        help='run as a warm standby for the PRIMARY daemon at --endpoint: mirror '
                             'its registry and promote onto that endpoint when it lapses '
                             '(requires a concrete port)')
    parser.add_argument('--standby-sync-interval', type=float, default=None,
                        help='seconds between replication pulls (default '
                             'PETASTORM_TPU_SERVICE_STANDBY_SYNC_S)')
    parser.add_argument('--standby-lapse', type=float, default=None,
                        help='primary silence before promotion (default '
                             'PETASTORM_TPU_SERVICE_STANDBY_LAPSE_S)')
    parser.add_argument('-v', '--verbose', action='store_true')
    args = parser.parse_args(argv)
    if args.obs_port is not None:
        knobs.set_env('PETASTORM_TPU_OBS_PORT', str(args.obs_port))
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format='%(asctime)s service-daemon[%(process)d] %(message)s')
    daemon_kwargs = dict(
        initial_workers=args.workers, min_workers=args.min_workers,
        max_workers=args.max_workers, heartbeat_interval_s=args.heartbeat_interval,
        liveness_timeout_s=args.liveness_timeout, max_jobs=args.max_jobs, lease_s=args.lease,
        supervise=not args.no_supervisor)
    if args.standby:
        from petastorm_tpu_torch.service.standby import StandbyDaemon
        standby = StandbyDaemon(args.endpoint, sync_interval_s=args.standby_sync_interval,
                                lapse_s=args.standby_lapse, **daemon_kwargs)
        standby.run_forever()
        return 0
    daemon = ServiceDaemon(args.endpoint, **daemon_kwargs)
    daemon.start()
    daemon.run_forever()
    return 0


if __name__ == '__main__':
    sys.exit(main())
