"""Cache-aware placement: decode fingerprints for the service (counterpart
of ``petastorm_tpu/service/placement.py``).

Two jobs reading the same dataset with the same decode pipeline produce the
same materialized row-group cache, so the second job should land on the
host that already decoded it. The currency of that decision is the decode
fingerprint (:func:`petastorm_tpu_torch.materialized_cache.decode_fingerprint`):

* the client stamps its job registration with the fingerprint of the job's
  worker args;
* each worker server advertises the fingerprints of the caches its host
  already holds, on REGISTER (a trailing JSON frame) and in every heartbeat
  summary (``cache_fp``), kept across restarts by marker files in the
  decoded-cache directory;
* the dispatcher prefers fingerprint-matching workers when binding
  (``Dispatcher._bind_worker``) and counts hits and misses.

Both sides compute the fingerprint with :func:`placement_fingerprint`. Jobs
whose worker args carry no schema can opt in with an explicit
``placement_group`` string in ``worker_args``, matched verbatim.

Everything here is advisory: a wrong or missing fingerprint costs warm
starts, never correctness, so every helper counts its own failures
(:func:`petastorm_tpu_torch.telemetry.count_swallowed`) and degrades to "no
fingerprint".
"""

import os

from petastorm_tpu_torch.telemetry import count_swallowed

#: cap on fingerprints a worker advertises (REGISTER frame / heartbeat
#: summary) and on marker files scanned — adverts ride the hot
#: heartbeat path and a host rarely holds more than a handful of warm
#: datasets at once
MAX_ADVERTISED = 8

_MARKER_PREFIX = '.fp_'


def placement_fingerprint(worker_args):
    """The placement identity of a job, or None when it has none.

    An explicit ``placement_group`` string in ``worker_args`` wins
    unconditionally (the user-facing escape hatch, and how schema-less
    stub jobs participate); otherwise the fingerprint derives from the
    decode-relevant args exactly like the materialized cache's own
    layout key (``loaded_schema`` + ``transform_spec`` + ``ngram``).
    """
    if not isinstance(worker_args, dict):
        return None
    try:
        group = worker_args.get('placement_group')
        if group:
            return str(group)
        loaded_schema = worker_args.get('loaded_schema')
        if loaded_schema is None:
            return None
        from petastorm_tpu_torch.materialized_cache import decode_fingerprint
        return decode_fingerprint(loaded_schema,
                                  worker_args.get('transform_spec'),
                                  ngram=worker_args.get('ngram'))
    except Exception:  # noqa: BLE001 - placement is advisory
        count_swallowed('placement-fingerprint')
        return None


def note_fingerprint(cache_dir, fingerprint):
    """Drop a marker file so FUTURE worker servers on this host advertise
    ``fingerprint`` from their first REGISTER (the in-process set covers
    the current server's lifetime; the marker survives it)."""
    if not cache_dir or not fingerprint:
        return
    try:
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, _MARKER_PREFIX + str(fingerprint))
        with open(path, 'a'):
            pass
    except Exception:  # noqa: BLE001 - placement is advisory
        count_swallowed('placement-marker')


def purge_stale_markers(cache_dir):
    """Remove every ``.fp_`` marker from a cache directory that holds no
    real entries — a re-rooted or cleaned-up cache must not keep
    advertising a fingerprint it no longer backs (the marker would steer
    placement at a cold host forever). Returns the number removed: 0
    when any real entry still exists (the markers are earned), or on any
    failure — advisory like everything here."""
    try:
        if not cache_dir or not os.path.isdir(cache_dir):
            return 0
        from petastorm_tpu_torch.cache import is_tmp_entry
        markers = []
        for root, _, files in os.walk(cache_dir):
            for name in files:
                if name.startswith(_MARKER_PREFIX):
                    markers.append(os.path.join(root, name))
                elif not is_tmp_entry(name):
                    return 0  # a real entry: the markers are earned
        removed = 0
        for path in markers:
            try:
                os.remove(path)
                removed += 1
            except OSError:
                pass
        return removed
    except Exception:  # noqa: BLE001 - placement is advisory
        count_swallowed('placement-marker-purge')
        return 0


def advertised_fingerprints(cache_dir, extra=()):
    """The fingerprints a worker server should advertise: marker files
    under ``cache_dir`` plus the in-process ``extra`` set, sorted and
    capped at :data:`MAX_ADVERTISED`."""
    found = set(str(fp) for fp in extra if fp)
    try:
        if cache_dir and os.path.isdir(cache_dir):
            for name in os.listdir(cache_dir):
                if name.startswith(_MARKER_PREFIX):
                    found.add(name[len(_MARKER_PREFIX):])
    except Exception:  # noqa: BLE001 - placement is advisory
        count_swallowed('placement-scan')
    return sorted(found)[:MAX_ADVERTISED]
