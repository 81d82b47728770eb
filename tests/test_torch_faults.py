"""Fault injection on the port (``petastorm_tpu_torch/faults.py``) held
against the JAX package's ``faults.py``: the spec grammar, the seeded
decision sequence hit for hit, the ``after``/``times``/``match`` windows,
the modes, the injection counter, arming through ``telemetry.refresh()``,
and the structural guarantee that every call site in the port is guarded
by one attribute read. The autouse guard of ``torch_telemetry_common``
disarms both packages around each test."""

import ast
import glob
import os

import pytest

from petastorm_tpu import faults as jax_faults
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu_torch import faults
from petastorm_tpu_torch import telemetry

from tests.torch_telemetry_common import telemetry_guard  # noqa: F401 - autouse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGES = {'jax': (jax_faults, jax_telemetry), 'torch': (faults, telemetry)}


@pytest.fixture
def armed(monkeypatch):
    """Arm one spec in both packages; disarm both after."""
    def arm(spec):
        monkeypatch.setenv('PETASTORM_TPU_FAULTS', spec)
        jax_faults.refresh_faults()
        faults.refresh_faults()
        return faults.ARMED
    yield arm
    monkeypatch.delenv('PETASTORM_TPU_FAULTS', raising=False)
    jax_faults.refresh_faults()
    faults.refresh_faults()
    assert faults.ARMED is None and jax_faults.ARMED is None


def _fire_indices(module, n=40, site='io.read', key='k'):
    fired = []
    for i in range(n):
        try:
            module.fault_hit(site, key=key)
        except module.FaultInjected:
            fired.append(i)
    return fired


# -- the spec grammar ----------------------------------------------------------

FULL_SPEC = ('io.read:error:0.05:seed=7,zmq.heartbeat:drop:after=20,'
             'cache.write:oserror:1:errno=28,staging.h2d:delay:ms=1')
CLAUSE_FIELDS = ('site', 'mode', 'rate', 'seed', 'after', 'times', 'match', 'errno',
                 'delay_ms', 'salt')


def test_parse_full_grammar():
    plan = faults.parse_spec(FULL_SPEC)
    io_clause = plan.by_site['io.read'][0]
    assert (io_clause.mode, io_clause.rate, io_clause.seed) == ('error', 0.05, 7)
    hb = plan.by_site['zmq.heartbeat'][0]
    assert (hb.mode, hb.rate, hb.after) == ('drop', 1.0, 20)
    assert plan.by_site['cache.write'][0].errno == 28
    assert plan.by_site['staging.h2d'][0].delay_ms == 1
    ref = jax_faults.parse_spec(FULL_SPEC)
    assert sorted(plan.by_site) == sorted(ref.by_site)
    for site, clauses in ref.by_site.items():
        for want, got in zip(clauses, plan.by_site[site]):
            assert [getattr(got, f) for f in CLAUSE_FIELDS] == \
                [getattr(want, f) for f in CLAUSE_FIELDS]
            assert got.describe() == want.describe()


@pytest.mark.parametrize('bad', [
    'io.read',                      # no mode
    'io.reed:error',                # unregistered site
    'io.read:explode',              # unknown mode
    'io.read:error:1.5',            # rate out of range
    'io.read:error:1:bogus=3',      # unknown option
    '',                             # empty
])
@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_parse_rejects_malformed(bad, package):
    with pytest.raises(ValueError):
        PACKAGES[package][0].parse_spec(bad)


@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_unparseable_env_spec_disarms_not_crashes(monkeypatch, package):
    module = PACKAGES[package][0]
    monkeypatch.setenv('PETASTORM_TPU_FAULTS', 'io.read:explode')
    module.refresh_faults()
    assert module.ARMED is None


# -- determinism: the same decisions in both packages ---------------------------


@pytest.mark.parametrize('spec', [
    'io.read:error:0.3:seed=11',
    'io.read:error:0.3:seed=12',
    'io.read:error:0.05:seed=7',
    'io.read:error:0.7:seed=3:after=5:times=9',
])
def test_seeded_rate_replays_exactly(armed, spec):
    armed(spec)
    first = _fire_indices(faults, n=200)
    assert first, 'the spec fired nothing over 200 hits'
    assert _fire_indices(jax_faults, n=200) == first
    assert faults.injection_stats() == jax_faults.injection_stats()
    armed(spec)  # re-arming resets the counters
    assert _fire_indices(faults, n=200) == first


def test_another_seed_draws_another_sequence(armed):
    armed('io.read:error:0.3:seed=11')
    first = _fire_indices(faults)
    armed('io.read:error:0.3:seed=12')
    assert _fire_indices(faults) != first


@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_after_and_times_windows(armed, package):
    armed('io.read:error:1:after=3:times=2')
    assert _fire_indices(PACKAGES[package][0], 10) == [3, 4]


@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_match_selects_keys(armed, package):
    module = PACKAGES[package][0]
    armed('decode.rowgroup:error:1:match=#rg3')
    module.fault_hit('decode.rowgroup', key='/data/f.parquet#rg2')
    with pytest.raises(module.FaultInjected):
        module.fault_hit('decode.rowgroup', key='/data/f.parquet#rg3')
    assert module.injection_stats()['decode.rowgroup'] == {'hits': 1, 'fired': 1}


def test_same_site_clauses_draw_independently(armed):
    """Two clauses on one site with one seed do not fire in lockstep (the
    digest carries the clause's mode and index), and the port's pattern
    of (delay fired, drop fired) is the reference's, hit for hit."""
    armed('zmq.recv:delay:0.5:ms=0,zmq.recv:drop:0.5')
    patterns = {}
    for name, module in (('jax', jax_faults), ('torch', faults)):
        c_delay, c_drop = module.ARMED.by_site['zmq.recv']
        pattern = []
        for i in range(128):
            before = (c_delay.fired, c_drop.fired)
            action = module.fault_hit('zmq.recv', key=i)
            pattern.append((c_delay.fired - before[0], c_drop.fired - before[1], action))
        patterns[name] = pattern
    assert patterns['torch'] == patterns['jax']
    assert {(1, 0, None), (0, 1, 'drop')} <= set(patterns['torch'])


@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_oserror_mode_carries_errno(armed, package):
    module = PACKAGES[package][0]
    armed('cache.write:oserror:1:errno=28')
    with pytest.raises(module.FaultInjectedOSError) as info:
        module.fault_hit('cache.write', key='x')
    assert info.value.errno == 28
    assert isinstance(info.value, OSError)
    assert isinstance(info.value, module.FaultInjected)


@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_drop_mode_returns_action(armed, package):
    armed('zmq.heartbeat:drop')
    assert PACKAGES[package][0].fault_hit('zmq.heartbeat', key=0) == 'drop'


@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_armed_hit_of_unregistered_site_raises(armed, package):
    armed('io.read:error:1')
    with pytest.raises(ValueError, match='unregistered faultpoint'):
        PACKAGES[package][0].fault_hit('io.reed', key='x')


def test_injections_counted_per_site(armed):
    armed('io.read:error:1:times=3,decode.batch:error:1:times=2')
    counted = {}
    for name, (module, tel) in PACKAGES.items():
        _fire_indices(module, 5)
        _fire_indices(module, 4, site='decode.batch')
        counted[name] = tel.get_registry().counters_with_prefix(module.FAULTS_INJECTED)
    assert counted['torch'] == counted['jax']
    assert counted['torch'] == {'%s{site="io.read"}' % faults.FAULTS_INJECTED: 3.0,
                                '%s{site="decode.batch"}' % faults.FAULTS_INJECTED: 2.0}
    assert faults.injection_stats() == {'io.read': {'hits': 5, 'fired': 3},
                                        'decode.batch': {'hits': 4, 'fired': 2}}


def test_metrics_off_counts_nothing(armed, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_METRICS', '0')
    telemetry.refresh()
    armed('io.read:error:1:times=2')
    assert _fire_indices(faults, 3) == [0, 1]
    assert not telemetry.get_registry().counters_with_prefix(faults.FAULTS_INJECTED)


@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_telemetry_refresh_arms_and_disarms(monkeypatch, package):
    module, tel = PACKAGES[package]
    monkeypatch.setenv('PETASTORM_TPU_FAULTS', 'io.read:error:1')
    tel.refresh()
    assert module.ARMED is not None
    monkeypatch.delenv('PETASTORM_TPU_FAULTS')
    tel.refresh()
    assert module.ARMED is None


def test_delay_mode_sleeps(armed, monkeypatch):
    slept = []
    monkeypatch.setattr(faults.time, 'sleep', slept.append)
    armed('staging.h2d:delay:ms=7:times=2')
    for _ in range(3):
        assert faults.fault_hit('staging.h2d') is None
    assert slept == [0.007, 0.007]


# -- the structural unarmed guarantees ----------------------------------------


@pytest.mark.parametrize('package', sorted(PACKAGES))
def test_unarmed_is_structurally_stateless(package):
    module = PACKAGES[package][0]
    assert 'PETASTORM_TPU_FAULTS' not in os.environ
    module.refresh_faults()
    assert module.ARMED is None
    assert module.fault_hit('io.read', key='x') is None
    assert module.injection_stats() == {}


#: the port's wired sites: module → number of ``fault_hit`` calls
PORT_SITES = {
    'arrow_worker.py': 3,           # io.read, decode.rowgroup (two read paths)
    'codecs.py': 1,                 # decode.batch
    'materialized_cache.py': 2,     # cache.read, cache.write
    'pushdown.py': 1,               # io.read #footer
    'readahead.py': 1,              # io.read #readahead
    os.path.join('device', 'staging.py'): 1,  # staging.h2d
    os.path.join('write', 'manifest.py'): 1,  # io.write #manifest
    os.path.join('write', 'writer.py'): 2,    # io.write #part, #rename
    os.path.join('write', 'compact.py'): 2,   # io.write #part, #rename
}


def test_every_call_site_is_guarded_by_one_attribute_read():
    """Every ``fault_hit`` call in the port sits inside an ``if`` whose
    test reads ``faults.ARMED``, so an unarmed run pays one attribute
    read; and the scan finds exactly the wired sites."""
    def guards(test_node):
        names = set()
        for node in ast.walk(test_node):
            if isinstance(node, ast.Attribute):
                names.add(node.attr)
            elif isinstance(node, ast.Name):
                names.add(node.id)
        return names

    root = os.path.join(REPO, 'petastorm_tpu_torch')
    offenders, sites = [], {}
    for path in glob.glob(os.path.join(root, '**', '*.py'), recursive=True):
        if os.path.basename(path) == 'faults.py':
            continue  # the harness itself, not a call site
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        guarded = [(node.lineno, max(n.lineno for n in ast.walk(node) if hasattr(n, 'lineno')))
                   for node in ast.walk(tree)
                   if isinstance(node, ast.If) and 'ARMED' in guards(node.test)]
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if getattr(node.func, 'attr', getattr(node.func, 'id', None)) != 'fault_hit':
                continue
            rel = os.path.relpath(path, root)
            sites[rel] = sites.get(rel, 0) + 1
            if not any(lo <= node.lineno <= hi for lo, hi in guarded):
                offenders.append('%s:%d' % (rel, node.lineno))
    assert sites == PORT_SITES
    assert not offenders, 'fault_hit call sites missing the `if faults.ARMED:` guard: %s' \
        % offenders


def test_every_port_site_is_a_registered_faultpoint():
    from petastorm_tpu_torch.telemetry.names import FAULTPOINTS
    root = os.path.join(REPO, 'petastorm_tpu_torch')
    named = set()
    for path in glob.glob(os.path.join(root, '**', '*.py'), recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, 'attr', None) == 'fault_hit'
                    and node.args and isinstance(node.args[0], ast.Constant)):
                named.add(node.args[0].value)
    assert named == {'io.read', 'decode.rowgroup', 'decode.batch', 'cache.read',
                     'cache.write', 'staging.h2d', 'io.write'}
    assert named <= set(FAULTPOINTS)
