"""Faultpoints: deterministic fault injection (counterpart of
``petastorm_tpu/faults.py``).

Every failure domain on the port's read path can be provoked on demand:
a failed parquet read, a poisoned row-group, a full cache disk, a failed
host-to-device dispatch.

* **Registry**: every site is a key of
  :data:`petastorm_tpu_torch.telemetry.names.FAULTPOINTS` (the pipecheck
  ``faultpoint`` rule holds every ``fault_hit()`` literal to it, and an
  armed hit of an unregistered name raises).
* **Spec**: ``PETASTORM_TPU_FAULTS`` holds comma-separated clauses::

      site:mode[:rate][:opt=value...]

      io.read:error:0.05:seed=7           # 5% of reads raise, seeded
      cache.write:oserror:1:errno=28      # every store hits ENOSPC
      decode.rowgroup:error:1:match=#rg3  # poison one row-group
      staging.h2d:error:1:after=3:times=1 # the 4th dispatch fails

  Modes: ``error`` raises :class:`FaultInjected`; ``oserror`` raises
  :class:`FaultInjectedOSError` (``errno=N``, default EIO); ``drop``
  returns ``'drop'`` so the site skips its action; ``delay`` sleeps
  ``ms=N``. Options: ``seed=N`` (decision seed, default 0), ``after=N``
  (the first N eligible hits pass), ``times=N`` (at most N fires),
  ``match=S`` (only keys containing S are eligible).
* **Determinism**: the n-th eligible hit of a clause fires iff
  ``sha1(seed:salt:n)`` maps below ``rate``, the reference's rule, so one
  spec and one per-site call sequence inject the same faults in both
  packages.
* **Zero unarmed cost**: call sites guard with ``if faults.ARMED:``, one
  module-attribute read; with the knob unset nothing is parsed or
  allocated.

Wired sites: the worker's row-group read and decode and the footer read
of the pushdown planner (:mod:`~petastorm_tpu_torch.arrow_worker`,
:mod:`~petastorm_tpu_torch.pushdown`), the codec batch decode
(:mod:`~petastorm_tpu_torch.codecs`), the decoded cache's entry read and
publish (:mod:`~petastorm_tpu_torch.materialized_cache`) and the staging
engine's dispatch (:mod:`~petastorm_tpu_torch.device.staging`).
"""

import hashlib
import logging
import threading
import time

from petastorm_tpu_torch.telemetry.names import FAULTPOINTS

logger = logging.getLogger(__name__)

#: injected-fault counter, labeled by site so a chaos run's report shows
#: exactly which seams fired how often
FAULTS_INJECTED = 'petastorm_tpu_faults_injected_total'

_MODES = ('error', 'oserror', 'drop', 'delay')

#: default errno for ``oserror`` mode: EIO, the "disk went bad" shape
_DEFAULT_ERRNO = 5


class FaultInjected(RuntimeError):
    """An injected fault from a ``PETASTORM_TPU_FAULTS`` clause.

    Deliberately a plain exception (not a subclass of any domain error):
    hardening must treat it like the arbitrary worker/IO failure it
    stands in for, and a test can always tell an injected fault from a
    real one by type."""


class FaultInjectedOSError(FaultInjected, OSError):
    """Injected OS-level fault (``oserror`` mode): carries a real
    ``errno`` so disk-full/EIO/permission hardening paths (the decoded
    cache's degrade-to-decode) exercise their errno dispatch exactly as
    they would on a failing filesystem. ``errno`` is set explicitly:
    ``OSError.__new__``'s two-arg parsing does not run for multiple-
    inheritance subclasses."""

    def __init__(self, errno_, message):
        super().__init__(errno_, message)
        self.errno = errno_


class _Clause:
    """One parsed spec clause with its per-clause decision state.
    ``salt`` (set at plan build) joins the decision digest so two
    clauses on ONE site draw independently — without it, same-seed
    clauses would fire fully correlated and combinations like
    "delay without error" would be structurally unreachable."""

    __slots__ = ('site', 'mode', 'rate', 'seed', 'after', 'times',
                 'match', 'errno', 'delay_ms', 'salt', 'hits', 'fired')

    def __init__(self, site, mode, rate, seed, after, times, match,
                 errno_, delay_ms):
        self.site = site
        self.mode = mode
        self.rate = rate
        self.seed = seed
        self.after = after
        self.times = times
        self.match = match
        self.errno = errno_
        self.delay_ms = delay_ms
        self.salt = site   # plan build appends mode + clause index
        self.hits = 0      # eligible (match-passing) hits seen
        self.fired = 0     # faults actually injected

    def describe(self):
        return '%s:%s(rate=%g, seed=%d, after=%d, times=%s, match=%r)' % (
            self.site, self.mode, self.rate, self.seed, self.after,
            self.times, self.match)


class _Plan:
    """The armed state: parsed clauses by site + one decision lock.

    The lock serializes counter advances so concurrent hits of one site
    each get a unique decision index; determinism then only requires the
    per-site call SEQUENCE to be deterministic, not the thread timing of
    unrelated sites."""

    __slots__ = ('spec', 'by_site', 'lock')

    def __init__(self, spec, clauses):
        self.spec = spec
        self.by_site = {}
        for clause in clauses:
            siblings = self.by_site.setdefault(clause.site, [])
            clause.salt = '%s:%s:%d' % (clause.site, clause.mode,
                                        len(siblings))
            siblings.append(clause)
        self.lock = threading.Lock()

    def stats(self):
        """``{site: {'hits': n, 'fired': n}}`` — chaos-test accounting."""
        out = {}
        with self.lock:
            for site, clauses in self.by_site.items():
                out[site] = {
                    'hits': sum(c.hits for c in clauses),
                    'fired': sum(c.fired for c in clauses),
                }
        return out


#: the ONE hot-path guard: ``None`` when unarmed (the knob is unset or
#: unparseable); a :class:`_Plan` when armed. Call sites read this and
#: nothing else before calling :func:`fault_hit`.
ARMED = None


def _parse_clause(text):
    fields = [f.strip() for f in text.strip().split(':')]
    if len(fields) < 2:
        raise ValueError('clause %r needs at least site:mode' % (text,))
    site, mode = fields[0], fields[1].lower()
    if site not in FAULTPOINTS:
        raise ValueError(
            'unregistered faultpoint %r (register it in '
            'petastorm_tpu_torch/telemetry/names.py FAULTPOINTS)' % (site,))
    if mode not in _MODES:
        raise ValueError('unknown fault mode %r (one of %s)'
                         % (mode, ', '.join(_MODES)))
    rate = 1.0
    seed, after, times, match = 0, 0, None, None
    errno_, delay_ms = _DEFAULT_ERRNO, 10
    for field in fields[2:]:
        if '=' not in field:
            rate = float(field)
            continue
        key, _, value = field.partition('=')
        key = key.strip().lower()
        if key == 'seed':
            seed = int(value)
        elif key == 'after':
            after = int(value)
        elif key == 'times':
            times = int(value)
        elif key == 'match':
            match = value
        elif key == 'errno':
            errno_ = int(value)
        elif key == 'ms':
            delay_ms = int(value)
        else:
            raise ValueError('unknown fault option %r in clause %r'
                             % (key, text))
    if not 0.0 <= rate <= 1.0:
        raise ValueError('fault rate %r outside [0, 1] in clause %r'
                         % (rate, text))
    return _Clause(site, mode, rate, seed, after, times, match, errno_,
                   delay_ms)


def parse_spec(spec):
    """Parse a full ``PETASTORM_TPU_FAULTS`` value into a :class:`_Plan`.
    Raises ``ValueError`` on any malformed clause — a chaos run with a
    typo'd spec must fail loudly, not silently test nothing."""
    clauses = [_parse_clause(c) for c in spec.split(',') if c.strip()]
    if not clauses:
        raise ValueError('empty PETASTORM_TPU_FAULTS spec %r' % (spec,))
    return _Plan(spec, clauses)


def _decision(seed, salt, n):
    """Deterministic uniform draw in [0, 1) for the n-th eligible hit of
    a clause — pure function of (seed, clause salt, n), so replay is
    exact AND same-site clauses draw independent sequences (the salt
    carries site, mode and clause index)."""
    digest = hashlib.sha1(
        ('%d:%s:%d' % (seed, salt, n)).encode()).digest()
    return int.from_bytes(digest[:8], 'big') / float(1 << 64)


def fault_hit(site, key=None):
    """One faultpoint hit. Returns ``None`` (no fault) or ``'drop'``
    (the site must skip its action); raises :class:`FaultInjected` /
    :class:`FaultInjectedOSError` for the error modes; sleeps for
    ``delay`` clauses.

    Only ever called behind the ``if faults.ARMED:`` guard, so the
    unarmed hot path never enters this function. ``key`` is the site's
    item identity (a row-group path, an item id, a message type) —
    ``match=`` clauses select on its string form."""
    plan = ARMED
    if plan is None:
        return None
    if site not in FAULTPOINTS:
        raise ValueError('fault_hit(%r): unregistered faultpoint '
                         '(telemetry.names.FAULTPOINTS)' % (site,))
    action = None
    for clause in plan.by_site.get(site, ()):
        if clause.match is not None and clause.match not in str(key):
            continue
        with plan.lock:
            n = clause.hits
            clause.hits += 1
            if n < clause.after:
                continue
            if clause.times is not None and clause.fired >= clause.times:
                continue
            if clause.rate < 1.0 and \
                    _decision(clause.seed, clause.salt, n) >= clause.rate:
                continue
            clause.fired += 1
        _count_injection(site)
        logger.info('Faultpoint %s fired (%s; hit %d, key=%r)',
                    site, clause.mode, n, key)
        if clause.mode == 'error':
            raise FaultInjected(
                'injected fault at %s (hit %d, key=%r, clause %s)'
                % (site, n, key, clause.describe()))
        if clause.mode == 'oserror':
            raise FaultInjectedOSError(
                clause.errno,
                'injected OS fault at %s (hit %d, key=%r)'
                % (site, n, key))
        if clause.mode == 'delay':
            time.sleep(clause.delay_ms / 1000.0)
        elif clause.mode == 'drop':
            action = 'drop'
    return action


def _count_injection(site):
    # function-level imports: only the armed path pays them, and the
    # module's import stays free of the registry
    from petastorm_tpu_torch.telemetry.registry import get_registry
    from petastorm_tpu_torch.telemetry.spans import metrics_disabled
    if not metrics_disabled():
        get_registry().counter(FAULTS_INJECTED, site=site).inc()


def injection_stats():
    """Per-site ``{'hits', 'fired'}`` counts of the armed plan (empty
    when unarmed) — chaos tests assert exact replay against this."""
    plan = ARMED
    return plan.stats() if plan is not None else {}


def refresh_faults():
    """Re-read ``PETASTORM_TPU_FAULTS`` (hooked into
    ``telemetry.refresh()``): re-arming RESETS all clause counters, so a
    test that refreshes with the same spec replays the same schedule.
    An unparseable spec logs and disarms — a broken chaos config must
    never take the injection harness down with undefined behavior."""
    global ARMED
    from petastorm_tpu_torch.telemetry import knobs
    spec = knobs.get_str('PETASTORM_TPU_FAULTS')
    if not spec:
        ARMED = None
        return
    try:
        ARMED = parse_spec(spec)
    except ValueError:
        logger.exception('Ignoring unparseable PETASTORM_TPU_FAULTS=%r',
                         spec)
        ARMED = None
        return
    logger.warning('Fault injection ARMED: %s', spec)


def _register_refresh():
    from petastorm_tpu_torch import telemetry
    telemetry.register_refresh(refresh_faults)


_register_refresh()
refresh_faults()
