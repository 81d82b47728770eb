"""pipesan on the port (``petastorm_tpu_torch/sanitizer.py`` and the pinned
slot ring of ``device/staging.py``) held against the JAX package's
sanitizer on the same inputs.

The ring runs on the CPU with a stand-in target (a copy is a clone, a
fake completion event), as the ring tests of ``test_torch_loader.py`` and
``test_torch_fused.py`` do; the reference's engine runs with its
accelerator stand-in, as ``tests/test_sanitizer.py`` does. Cases: the
knob, guarded slabs (torch slabs here, numpy slabs there), the census,
the seeded use-after-recycle and the red-zone trample through the slot's
slab, the unarmed engine doing no guard work, fresh assembly unguarded,
the report's ``pipesan`` section, the violation ring and
``guard_payload``. The autouse guard of ``torch_telemetry_common`` resets
both packages' sanitizers around each test.
"""

import numpy as np
import pytest
import torch

from petastorm_tpu import sanitizer as jax_sanitizer
from petastorm_tpu import telemetry as jax_telemetry
from petastorm_tpu.arrow_worker import ColumnBatch as JaxColumnBatch
from petastorm_tpu.jax import staging as jax_staging
from petastorm_tpu_torch import sanitizer
from petastorm_tpu_torch import telemetry
from petastorm_tpu_torch.arrow_worker import ColumnBatch
from petastorm_tpu_torch.device import staging
from petastorm_tpu_torch.telemetry.export import _label_of

from tests.torch_telemetry_common import (  # noqa: F401 - fixtures
    telemetry_guard, write_small_dataset,
)

TRAMPLED = 'staging-canary-trampled'
ESCAPED = 'staging-use-after-recycle'


@pytest.fixture
def armed(monkeypatch):
    """``PETASTORM_TPU_SANITIZE=1`` for both packages (the guard's closing
    reset re-reads the restored environment)."""
    monkeypatch.setenv('PETASTORM_TPU_SANITIZE', '1')
    jax_telemetry.refresh()
    telemetry.refresh()


class _Event:
    def query(self):
        return False

    def synchronize(self):
        pass


class _Target:
    """Stands in for :class:`staging.CudaTarget`; with ``leak`` it keeps
    the host views of the first transfer (the deliberate escape)."""

    pin_memory = False

    def __init__(self, leak=False):
        self.leak = leak
        self.kept = None

    def transfer(self, host, device_casts):
        if self.leak and self.kept is None:
            self.kept = dict(host)
        return {k: v.clone().to(device_casts.get(k, v.dtype)) for k, v in host.items()}, _Event()

    def deliver(self, tensors, event):
        return tensors


class _AcceleratorLeaf:
    """The reference's device-array stand-in (``tests/test_sanitizer.py``):
    it copies on construction and claims a non-host platform, pinning the
    reference engine's ring mode on the CPU."""

    def __init__(self, arr):
        self.value = np.array(arr, copy=True)

    def devices(self):
        class _Dev:
            platform = 'tpu'
        return (_Dev(),)

    def block_until_ready(self):
        return self


def _jax_engine(leak=None):
    """The reference's engine; ``leak`` (a dict) keeps the host views of
    the first dispatch only."""
    puts = []

    def put(tree):
        if leak is not None and not puts:
            leak.update(tree)
        puts.append(1)
        return {k: _AcceleratorLeaf(v) for k, v in tree.items()}
    return jax_staging.StagingEngine(8, {'v': np.float32}, 'drop', put, num_slots=2)


def _slots(engine):
    (slots, _), = engine._rings.values()
    return slots


def _checks(registry, module):
    return registry.counter_value(module.SANITIZER_CANARY_CHECKS)


# -- the knob -----------------------------------------------------------------


def test_knob_off_by_default_and_covered_by_telemetry_refresh(monkeypatch):
    assert not sanitizer.sanitize_enabled()
    monkeypatch.setenv('PETASTORM_TPU_SANITIZE', '1')
    assert not sanitizer.sanitize_enabled()        # cached until a refresh
    telemetry.refresh()
    assert sanitizer.sanitize_enabled()
    monkeypatch.delenv('PETASTORM_TPU_SANITIZE')
    telemetry.refresh()
    assert not sanitizer.sanitize_enabled()


@pytest.mark.parametrize('value,want', [('1', True), ('on', True), ('yes', True),
                                        ('0', False), ('', False), ('nope', False)])
def test_knob_spellings_match_the_reference(monkeypatch, value, want):
    monkeypatch.setenv('PETASTORM_TPU_SANITIZE', value)
    telemetry.refresh()
    jax_telemetry.refresh()
    assert sanitizer.sanitize_enabled() is jax_sanitizer.sanitize_enabled() is want


# -- guarded slabs and the census ----------------------------------------------


@pytest.mark.parametrize('shape,np_dtype,torch_dtype', [
    ((4, 8), np.float32, torch.float32), ((3, 5, 2), np.uint8, torch.uint8),
    ((7,), np.int64, torch.int64), ((6,), np.bool_, torch.bool),
    ((2, 3), np.float16, torch.float16)])
def test_guarded_slab_round_trips_and_catches_tramples(shape, np_dtype, torch_dtype):
    """The same fill and the same tramples through a torch slab here and a
    numpy slab in the reference give the same verdicts, and the visible
    tensor is a typed view into the slab's middle."""
    slab, tensor = sanitizer.allocate_guarded(shape, torch_dtype)
    ref = jax_sanitizer.allocate_guarded(shape, np_dtype)
    ref_slab = ref
    while isinstance(ref_slab.base, np.ndarray):
        ref_slab = ref_slab.base
    assert tensor.shape == shape and tensor.dtype == torch_dtype
    assert slab.dtype == torch.uint8 and slab.dim() == 1
    assert slab.numel() == ref_slab.nbytes == ref.nbytes + 2 * sanitizer.CANARY_BYTES
    assert tensor.data_ptr() == slab.data_ptr() + sanitizer.CANARY_BYTES
    values = np.arange(int(np.prod(shape))).reshape(shape).astype(np_dtype)
    tensor.numpy()[...] = values
    ref[...] = values
    verdicts, ref_verdicts = [], []
    for where in (None, 0, -1, sanitizer.CANARY_BYTES - 1):
        if where is not None:
            slab[where] = 0
            ref_slab[where] = 0
        verdicts.append(sanitizer.check_canaries(slab))
        ref_verdicts.append(jax_sanitizer.check_canaries(ref))
    assert verdicts == ref_verdicts == [True, False, False, False]
    # trampled zones are poisoned again, so the next check is clean
    assert sanitizer.check_canaries(slab) and jax_sanitizer.check_canaries(ref)
    np.testing.assert_array_equal(tensor.numpy(), values)
    np.testing.assert_array_equal(ref, values)


def test_a_write_into_the_visible_region_is_not_a_trample():
    slab, tensor = sanitizer.allocate_guarded((4, 8), torch.float32)
    tensor.fill_(-1.0)
    assert sanitizer.check_canaries(slab)


def test_check_without_repoison_leaves_the_zone_trampled():
    slab, _ = sanitizer.allocate_guarded((4,), torch.int32)
    slab[-1] = 7
    assert not sanitizer.check_canaries(slab, repoison=False)
    assert not sanitizer.check_canaries(slab)
    assert sanitizer.check_canaries(slab)


def test_plain_tensors_are_not_guarded_slabs():
    """An unguarded allocation, or the typed view instead of its slab, has
    nothing to verify — the reference answers the same for a plain array."""
    _, view = sanitizer.allocate_guarded((4, 8), torch.float32)
    assert sanitizer.check_canaries(torch.empty((4, 8)))
    assert sanitizer.check_canaries(view)
    assert sanitizer.check_canaries(np.empty((4, 8), np.float32))
    assert jax_sanitizer.check_canaries(np.empty((4, 8), np.float32))


def test_canary_checks_are_counted_like_the_references():
    slab, _ = sanitizer.allocate_guarded((4,), torch.float32)
    ref = jax_sanitizer.allocate_guarded((4,), np.float32)
    for _ in range(3):
        sanitizer.check_canaries(slab)
        jax_sanitizer.check_canaries(ref)
    assert _checks(telemetry.get_registry(), sanitizer) \
        == _checks(jax_telemetry.get_registry(), jax_sanitizer) == 3


@pytest.mark.parametrize('make', [lambda: torch.arange(8), lambda: np.arange(8)],
                         ids=['torch', 'numpy'])
def test_view_census_counts_live_views(make):
    for census in (sanitizer.ViewCensus(), jax_sanitizer.ViewCensus()):
        a, b = make(), make()
        census.register([a, b])
        assert census.escaped() == 2
        del a
        assert census.escaped() == 1
        view = b[:4]
        census.register([view])       # a new dispatch replaces the old refs
        assert census.escaped() == 1
        del view
        assert census.escaped() == 0


def test_census_skips_what_cannot_be_weakly_referenced():
    census = sanitizer.ViewCensus()
    census.register([3, 'x', torch.zeros(2)])
    assert census.escaped() == 0


# -- the ring -----------------------------------------------------------------


def test_escaped_staging_view_trips_the_census_and_quarantines(armed):
    """A holder keeps the first batch's host views: when that slot comes
    up for refilling the census catches it, the refill is aborted (fresh
    guarded tensors; the holder keeps the old memory) and the violation
    recorded — as the reference does on the same inputs."""
    target = _Target(leak=True)
    engine = staging.StagingEngine(8, {'v': np.float32}, 'drop', target, num_slots=2)
    jax_leaked = {}
    jax_engine = _jax_engine(jax_leaked)
    rng = np.random.RandomState(0)
    sources, held, jax_held = [], [], []
    for i in range(6):
        cols = {'v': rng.rand(8, 4) + i}                 # f64 -> f32: a cast copy
        sources.append(cols['v'].astype(np.float32))
        held.append(engine.stage(dict(cols), 8).deliver())
        jax_held.append(jax_engine.stage(dict(cols), 8))
    assert engine.slabs_quarantined == jax_engine.slabs_quarantined == 1
    kinds = [v['kind'] for v in sanitizer.violations()]
    assert kinds == [v['kind'] for v in jax_sanitizer.violations()] == [ESCAPED]
    assert telemetry.get_registry().counter_value(sanitizer.SANITIZER_VIOLATIONS,
                                                  kind=ESCAPED) == 1
    # the quarantined slab was never refilled: the holder's data survives
    np.testing.assert_array_equal(target.kept['v'].numpy(), sources[0])
    np.testing.assert_array_equal(jax_leaked['v'], sources[0])
    for src, batch, jax_batch in zip(sources, held, jax_held):
        np.testing.assert_array_equal(batch['v'].numpy(), src)
        np.testing.assert_array_equal(jax_batch['v'].value, src)
    # the slot came back with fresh guarded memory and a fresh census
    assert all(slot.slabs is not None and slot.census is not None for slot in _slots(engine))
    assert _checks(telemetry.get_registry(), sanitizer) \
        == _checks(jax_telemetry.get_registry(), jax_sanitizer) == 5


def test_canary_trample_detected_on_recycle(armed):
    """One byte past the field's tensor, written through the slot's slab
    while the slot is out: the slot's next refill records the trample,
    poisons the zone again, and does not quarantine (a trample is not an
    escape); the refill after that is clean."""
    engine = staging.StagingEngine(8, {'v': np.float32}, 'drop', _Target(), num_slots=2)
    captured = {}
    jax_engine = _jax_engine(captured)
    rng = np.random.RandomState(1)
    batches = [{'v': rng.rand(8, 4)} for _ in range(5)]
    seen = []
    for i, cols in enumerate(batches):
        out = engine.stage(dict(cols), 8).deliver()
        jax_engine.stage(dict(cols), 8)
        np.testing.assert_array_equal(out['v'].numpy(), cols['v'].astype(np.float32))
        if i == 0:
            slab = _slots(engine)[0].slabs['v']
            slab[-1] = 0
            root = captured['v']
            while isinstance(root.base, np.ndarray):
                root = root.base
            root[-1] = 0
            captured.clear()             # drop the ref: the census stays clean
        seen.append(len(sanitizer.violations()))
    assert seen == [0, 0, 1, 1, 1]
    assert int(slab[-1]) == sanitizer.CANARY_BYTE
    kinds = [v['kind'] for v in sanitizer.violations()]
    assert kinds == [v['kind'] for v in jax_sanitizer.violations()] == [TRAMPLED]
    assert "'v'" in sanitizer.violations()[0]['detail']
    assert engine.slabs_quarantined == jax_engine.slabs_quarantined == 0
    assert _checks(telemetry.get_registry(), sanitizer) \
        == _checks(jax_telemetry.get_registry(), jax_sanitizer) == 5
    assert engine.slot_refills == 3


def test_every_field_and_the_mask_are_guarded(armed):
    engine = staging.StagingEngine(4, {'x': torch.bfloat16}, 'pad', _Target(), num_slots=2)
    for i in range(4):
        out = engine.stage([{'x': np.full((3, 2), i, np.float32), 'y': np.arange(3)}],
                           3).deliver()
        assert out['x'].dtype == torch.bfloat16 and out['x'][:3].eq(i).all()
        assert out['valid_mask'].tolist() == [True, True, True, False]
    for slot in _slots(engine):
        assert set(slot.slabs) == {'x', 'y', 'valid_mask'}
        for name, tensor in slot.tensors.items():
            assert tensor.data_ptr() == slot.slabs[name].data_ptr() + sanitizer.CANARY_BYTES
    assert _checks(telemetry.get_registry(), sanitizer) == 3 * 4
    assert sanitizer.violations() == []


def test_unarmed_engine_does_no_guard_work():
    engine = staging.StagingEngine(8, {'v': np.float32}, 'drop', _Target(), num_slots=2)
    jax_engine = _jax_engine()
    rng = np.random.RandomState(2)
    for _ in range(5):
        cols = {'v': rng.rand(8, 4)}
        engine.stage(dict(cols), 8)
        jax_engine.stage(dict(cols), 8)
    assert engine._sanitize is jax_engine._sanitize is False
    for slot in _slots(engine):
        assert slot.slabs is None and slot.census is None
        assert slot.tensors['v']._base is None      # a plain allocation
    assert _checks(telemetry.get_registry(), sanitizer) \
        == _checks(jax_telemetry.get_registry(), jax_sanitizer) == 0
    assert sanitizer.violations() == jax_sanitizer.violations() == []
    assert 'pipesan' not in telemetry.pipeline_report()


def test_fresh_assembly_stays_unguarded(armed):
    """Fresh buffers are never recycled, so their red zones would never be
    checked: the armed engine without a ring target guards nothing."""
    engine = staging.StagingEngine(4, None, 'drop', target=None)
    for i in range(3):
        out = engine.stage({'v': np.full((4, 2), i)}, 4).deliver()
        assert out['v'].eq(i).all()
    assert engine._sanitize is True and engine._rings == {}
    assert _checks(telemetry.get_registry(), sanitizer) == 0
    assert sanitizer.violations() == []


def test_loader_reports_refills_and_quarantines(armed, tmp_path):
    """``make_torch_loader`` on the CPU has no ring: its diagnostics carry
    the ring's counts at zero, and the armed report stays clean."""
    from petastorm_tpu_torch.device.loader import make_torch_loader
    url = write_small_dataset('file://' + str(tmp_path / 'small'))
    with make_torch_loader(url, batch_size=16, device='cpu', reader_pool_type='dummy',
                           num_epochs=1) as loader:
        rows = sum(len(b['id']) for b in loader)
        diag = loader.diagnostics
    assert rows == 112
    assert diag['staging_slot_refills'] == diag['staging_slabs_quarantined'] == 0
    section = telemetry.pipeline_report()['pipesan']
    assert section['enabled'] and section['violations'] == 0


# -- report, ring and payload guards ------------------------------------------


def _strip_ts(section):
    return dict(section, recent=[{k: v for k, v in e.items() if k != 'ts'}
                                 for e in section['recent']])


def test_pipeline_report_grows_a_pipesan_section_when_armed(armed):
    for module in (sanitizer, jax_sanitizer):
        module.record_violation(TRAMPLED, 'seeded')
    section = telemetry.pipeline_report()['pipesan']
    jax_section = jax_telemetry.pipeline_report()['pipesan']
    assert _strip_ts(section) == _strip_ts(jax_section)
    assert section['enabled'] is True and section['violations'] == 1
    assert section['by_kind'] == {TRAMPLED: 1}
    assert section['recent'][-1]['detail'] == 'seeded'
    line = [ln for ln in telemetry.format_pipeline_report(telemetry.pipeline_report())
            .splitlines() if ln.startswith('pipesan')]
    jax_line = [ln for ln in jax_telemetry.format_pipeline_report(
        jax_telemetry.pipeline_report()).splitlines() if ln.startswith('pipesan')]
    assert line == jax_line == ['pipesan: armed — 1 violation(s) (%s: 1), 0 view(s) forced '
                                'read-only, 0 canary check(s)' % TRAMPLED]


def test_an_unarmed_violation_still_shows():
    sanitizer.record_violation(ESCAPED, 'seeded')
    section = telemetry.pipeline_report()['pipesan']
    assert section['enabled'] is False and section['by_kind'] == {ESCAPED: 1}


def test_pipeline_report_omits_pipesan_when_unarmed_and_clean():
    assert 'pipesan' not in telemetry.pipeline_report()
    assert 'pipesan' not in jax_telemetry.pipeline_report()


@pytest.mark.parametrize('key,want', [('m{kind="a"}', 'a'), ('m{srckind="a"}', None),
                                      ('m{a="x",kind="b"}', 'b'), ('m', None)])
def test_report_label_parsing_is_anchored(key, want):
    from petastorm_tpu.telemetry.export import _label_of as jax_label_of
    assert _label_of(key, 'kind') == jax_label_of(key, 'kind') == want


def test_violation_ring_is_bounded_and_keeps_the_newest():
    total = sanitizer._RING_LIMIT + 10
    for module in (sanitizer, jax_sanitizer):
        for i in range(total):
            module.record_violation(TRAMPLED, 'v%d' % i)
    kept = [v['detail'] for v in sanitizer.violations()]
    assert kept == [v['detail'] for v in jax_sanitizer.violations()]
    assert len(kept) == sanitizer._RING_LIMIT == jax_sanitizer._RING_LIMIT
    assert kept[0] == 'v10' and kept[-1] == 'v%d' % (total - 1)
    assert telemetry.get_registry().counter_value(sanitizer.SANITIZER_VIOLATIONS,
                                                  kind=TRAMPLED) == total


def _payloads(batch_type):
    inner = np.arange(4)
    frozen = np.arange(3)
    frozen.flags.writeable = False
    return [batch_type({'a': inner}, 4), {'b': np.arange(2), 'c': [np.zeros(2), 'x']},
            (frozen, np.ones(1)), [[[[np.arange(5)]]]], 7], inner


@pytest.mark.parametrize('index', range(5))
def test_guard_payload_walks_what_the_reference_walks(index):
    """The same payload shapes, guarded by both: the same counts, the same
    arrays left read-only (the reference's ``ColumnBatch`` and the port's
    alike), nothing past the depth bound."""
    ours, inner = _payloads(ColumnBatch)
    theirs, jax_inner = _payloads(JaxColumnBatch)
    got = sanitizer.guard_payload(ours[index])
    want = jax_sanitizer.guard_payload(theirs[index])
    assert got == want == [1, 2, 1, 0, 0][index]
    assert inner.flags.writeable is jax_inner.flags.writeable is (index != 0)
    assert telemetry.get_registry().counter_value(sanitizer.SANITIZER_VIEWS_GUARDED) == got


def test_guarded_payload_refuses_writes():
    arr = np.arange(4)
    assert sanitizer.guard_readonly(arr) == 1
    assert sanitizer.guard_readonly(arr) == 0
    assert sanitizer.guard_readonly([1, 2]) == 0
    with pytest.raises(ValueError, match='read-only'):
        arr[0] = 9
