"""The staging ring's refill gate on one CUDA card, old against new.

Runs ``chip_smoke.py``'s ``obs_lm_path`` phase (the flagship LM with the
live plane armed, 0.25 s windows, ``h2d_overlap>=0.3``) ``2 * --pairs``
times, in the order sync, query, query, sync, ...:

* ``sync``: a refill blocks on the slot's last copy with
  ``event.synchronize()`` every time (the gate before ``query()`` came
  first);
* ``query``: the package's gate (``staging._Slot.await_retired``), which
  asks ``event.query()`` and blocks only on a copy still in flight.

Each run prints one JSON line: the least and median per-window
``h2d_overlap``, the worst window's ``stage_fill``/``h2d_dispatch``/
``h2d_ready`` seconds per second, the refills asked and those that had to
block (``query`` runs), ``/health`` at each mark, the phase's tokens/s and
whether every gate of the phase held. A summary line and the card's name
and power limit follow.

    python3 chip_refill_gate.py [--pairs 8]
"""
import argparse
import json
import os
import sys
import tempfile
import time

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--pairs', type=int, default=8,
                        help='sync/query pairs, run as sync, query, query, sync')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_refill_gate.py needs a CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from petastorm_tpu_torch.device import staging
    from petastorm_tpu_torch.telemetry import slo

    package_gate = staging._Slot.await_retired
    blocked = {'asked': 0, 'blocked': 0}

    class CountingEvent:
        def __init__(self, event):
            self.event = event

        def query(self):
            blocked['asked'] += 1
            done = self.event.query()
            blocked['blocked'] += not done
            return done

        def synchronize(self):
            self.event.synchronize()

    def sync_gate(slot):
        if slot.event is not None:
            slot.event.synchronize()
            slot.event = None

    def query_gate(slot):
        if slot.event is not None:
            slot.event = CountingEvent(slot.event)
        package_gate(slot)

    windows = []
    resolve = slo._resolve_h2d_overlap

    def recording(window):
        rates = window.get('rates', {})
        windows.append((rates.get(slo._STAGE_FILL_KEY, 0.0),
                        rates.get(slo._H2D_DISPATCH_KEY, 0.0),
                        rates.get(slo._H2D_READY_KEY, 0.0)))
        return resolve(window)

    emitted = []
    slo._resolve_h2d_overlap = recording
    cs.emit = emitted.append
    runs = []
    t0 = time.perf_counter()
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        lm_url = 'file://' + os.path.join(tmp, 'c4_like')
        cs.write_lm_dataset(lm_url)
        cs.phase_lm_path(lm_url)
        for i, gate in enumerate(['sync', 'query', 'query', 'sync'] * (args.pairs // 2)
                                 + ['sync', 'query'] * (args.pairs % 2)):
            staging._Slot.await_retired = sync_gate if gate == 'sync' else query_gate
            windows.clear()
            emitted.clear()
            blocked.update(asked=0, blocked=0)
            run_dir = os.path.join(tmp, 'run%d' % i)
            os.makedirs(run_dir)
            error = None
            try:
                cs.phase_obs_lm_path(lm_url, run_dir)
            except AssertionError as e:
                error = str(e)[:300]
            finally:
                staging._Slot.await_retired = package_gate
            line = next((e for e in reversed(emitted) if e.get('phase') == 'obs_lm_path'), {})
            staged = [w for w in windows if sum(w)]
            overlaps = [1.0 - r / (f + d + r) for f, d, r in staged]
            worst = min(range(len(overlaps)), key=overlaps.__getitem__) if overlaps else None
            run = {'run': i, 'gate': gate, 'gates_held': error is None, 'error': error,
                   'health': line.get('health_status'),
                   'overlap_min': min(overlaps) if overlaps else None,
                   'overlap_median': sorted(overlaps)[len(overlaps) // 2] if overlaps else None,
                   'windows': len(overlaps),
                   'worst_fill_dispatch_ready_s_per_s': staged[worst] if overlaps else None,
                   'ready_max_s_per_s': max(w[2] for w in staged) if staged else None,
                   'refills_asked': blocked['asked'] if gate == 'query' else None,
                   'refills_blocked': blocked['blocked'] if gate == 'query' else None,
                   'tokens_per_s': line.get('tokens_per_s')}
            runs.append(run)
            print(json.dumps(run), flush=True)
    summary = {}
    for gate in ('sync', 'query'):
        mine = [r for r in runs if r['gate'] == gate and r['overlap_min'] is not None]
        summary[gate] = {
            'runs': len(mine),
            'overlap_min': [min(r['overlap_min'] for r in mine),
                            max(r['overlap_min'] for r in mine)] if mine else None,
            'ready_max_s_per_s': max(r['ready_max_s_per_s'] for r in mine) if mine else None,
            'gates_held': sum(r['gates_held'] for r in mine),
            'refills_blocked': sum(r['refills_blocked'] or 0 for r in mine),
            'refills_asked': sum(r['refills_asked'] or 0 for r in mine)}
    print(json.dumps({'summary': summary, 'seconds': time.perf_counter() - t0}), flush=True)
    print(cs.card_line(), flush=True)
    return 0 if all(r['gates_held'] for r in runs) else 1


if __name__ == '__main__':
    sys.exit(main())
