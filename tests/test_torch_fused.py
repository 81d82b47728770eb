"""petastorm_tpu_torch fused decode against the JAX package's, on the CPU.

Image datasets are written with numpy rows from a seed (PNG, lossless, and
JPEG decoded in fancy mode, ``PETASTORM_TPU_JPEG_FANCY=1``, where every
path is bit-identical to cv2). With the dummy pool, the torch loader whose
staging fill decodes encoded cells straight into its buffers yields the
JAX loader's batches byte for byte. Also held: ``fused_decode_mode`` of
fresh assembly (``device='cpu'``) and of the pinned slot ring (a stand-in
target), each decline reason with its counter, the ``decode_fused`` stage
and the fused rows and bytes counters, and the reader's deferral gates.
"""

import os

import numpy as np
import pytest
import torch

from petastorm_tpu.jax import make_jax_loader
from petastorm_tpu.jax import staging as jax_staging
from petastorm_tpu_torch import fused, native
from petastorm_tpu_torch.codecs import CompressedImageCodec
from petastorm_tpu_torch.device import staging
from petastorm_tpu_torch.device.loader import make_torch_loader
from petastorm_tpu_torch.reader import make_batch_reader
from petastorm_tpu_torch.telemetry import (
    FUSED_BYTES, FUSED_FALLBACKS, FUSED_ROWS, get_registry, reset_registry,
)
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

IMG_SHAPE = (32, 24, 3)


def _write(url, kind, rows=96, shape=IMG_SHAPE):
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
    schema = Unischema('FusedImages', [
        UnischemaField('id', np.int32, (), None, False),
        UnischemaField('image', np.uint8, shape, CompressedImageCodec(kind, quality=90), False),
    ])
    rng = np.random.RandomState(5)
    data = [{'id': np.int32(i), 'image': rng.randint(0, 255, shape, dtype=np.uint8)}
            for i in range(rows)]
    write_dataset(url, schema, data, rowgroup_size_rows=16, num_files=2)
    return data


@pytest.fixture(scope='module')
def png_url(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('fused_png')) + '/ds'
    return url, _write(url, 'png')


@pytest.fixture(scope='module')
def jpeg_url(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('fused_jpeg')) + '/ds'
    _write(url, 'jpeg')
    return url


@pytest.fixture
def env(monkeypatch):
    """Set knobs for both packages; the JAX staging knob is cached."""
    def set_env(**values):
        for name, value in values.items():
            monkeypatch.setenv(name, value)
        jax_staging.refresh_staging()
    yield set_env
    monkeypatch.undo()
    jax_staging.refresh_staging()


@pytest.fixture
def registry():
    reset_registry()
    yield get_registry()
    reset_registry()


def _jax(url, **kw):
    with make_jax_loader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                         **kw) as loader:
        return [{k: np.asarray(v).copy() for k, v in b.items()} for b in loader]


def _torch(url, **kw):
    with make_torch_loader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                           device='cpu', **kw) as loader:
        batches = [{k: (v.float() if v.dtype == torch.bfloat16 else v).numpy().copy()
                    for k, v in b.items()} for b in loader]
        return batches, loader.diagnostics


def _assert_same(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name].astype(a[name].dtype),
                                          err_msg=name)


def _fallbacks(registry, reason):
    return registry.snapshot()['counters'].get('%s{reason="%s"}' % (FUSED_FALLBACKS, reason), 0)


@pytest.mark.parametrize('last_batch', ['drop', 'pad', 'short'])
def test_fused_png_batches_match_jax_loader(png_url, registry, last_batch):
    url, rows = png_url
    kw = dict(batch_size=36, last_batch=last_batch)
    got, diag = _torch(url, **kw)
    # 'drop' drops the 24-row tail before it is staged
    fused_rows = 72 if last_batch == 'drop' else 96
    assert diag['fused_decode_mode'] == 'fused-into-slab'
    assert diag['fused_decode_rows'] == fused_rows
    _assert_same(_jax(url, **kw), got)
    counters = registry.snapshot()['counters']
    assert counters[FUSED_ROWS] == fused_rows
    assert counters[FUSED_BYTES] == fused_rows * np.prod(IMG_SHAPE)
    assert 'petastorm_tpu_stage_seconds_total{stage="decode_fused"}' in counters
    if last_batch == 'pad':
        tail = got[-1]
        assert tail['valid_mask'][:24].all() and not tail['valid_mask'][24:].any()
        assert not tail['image'][24:].any()  # padded rows are zero, not stale
    # and against the source pixels, in the two full batches
    by_id = {int(i): im for b in got[:2] for i, im in zip(b['id'], b['image'])}
    for row in rows[:72]:
        np.testing.assert_array_equal(by_id[int(row['id'])], row['image'])


def test_fused_jpeg_batches_match_jax_loader(jpeg_url, env):
    env(PETASTORM_TPU_JPEG_FANCY='1')
    got, diag = _torch(jpeg_url, batch_size=24)
    assert diag['fused_decode_mode'] == 'fused-into-slab'
    _assert_same(_jax(jpeg_url, batch_size=24), got)


def test_shuffled_rows_decline_and_match_jax(png_url, registry):
    url, _ = png_url
    kw = dict(batch_size=24, shuffle_rows=True, seed=3)
    got, diag = _torch(url, defer_image_decode=True, **kw)
    assert diag['fused_decode_mode'] == 'batched'
    assert diag['fused_decode_fallback'] == 'shuffled-rows'
    assert _fallbacks(registry, 'shuffled-rows') == 6  # one per row-group
    _assert_same(_jax(url, **kw), got)
    # without the explicit request the hand-shake does not defer at all
    reset_registry()
    _, diag = _torch(url, **kw)
    assert diag['fused_decode_mode'] == 'batched' and 'fused_decode_fallback' not in diag


def test_dtype_cast_declines_and_matches_jax(png_url, registry):
    url, _ = png_url
    kw = dict(batch_size=24, dtypes={'image': np.float32})
    got, diag = _torch(url, **kw)
    assert got[0]['image'].dtype == np.float32
    assert diag['fused_decode_fallback'] == 'dtype-cast'
    assert _fallbacks(registry, 'dtype-cast') == 6
    _assert_same(_jax(url, **kw), got)


def test_device_cast_still_fuses(png_url, registry):
    """A bf16 cast applies after the copy, so the slot keeps uint8."""
    url, _ = png_url
    got, diag = _torch(url, batch_size=24, dtypes={'image': torch.bfloat16})
    assert diag['fused_decode_mode'] == 'fused-into-slab'
    assert not registry.snapshot()['counters'].get(FUSED_FALLBACKS)
    want = _jax(url, batch_size=24)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a['image'].astype(np.float32), b['image'])


def test_staging_off_declines_and_matches_jax(png_url, registry, env):
    url, _ = png_url
    env(PETASTORM_TPU_STAGING='0')
    got, diag = _torch(url, batch_size=24, defer_image_decode=True)
    assert diag['fused_decode_fallback'] == 'staging-off'
    assert _fallbacks(registry, 'staging-off') == 6
    _assert_same(_jax(url, batch_size=24), got)


def test_transform_declines_once_per_reader(png_url, registry):
    from petastorm_tpu_torch.transform import TransformSpec
    url, _ = png_url
    with make_batch_reader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                           defer_image_decode=True,
                           transform_spec=TransformSpec(lambda frame: frame)) as reader:
        batch = next(reader)
    assert isinstance(batch.image, np.ndarray)
    assert _fallbacks(registry, 'worker-config') == 1


def test_reader_defers_only_when_asked(png_url):
    url, rows = png_url
    with make_batch_reader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                           defer_image_decode=True) as reader:
        columns, _, _ = reader.next_batch_info()
    column = columns['image']
    assert isinstance(column, fused.EncodedImageColumn)
    assert isinstance(column.cells, native.PackedCells)
    assert isinstance(columns['id'], np.ndarray)
    assert column.shape == (16,) + IMG_SHAPE and column.dtype == np.uint8
    np.testing.assert_array_equal(column.materialize(),
                                  np.stack([r['image'] for r in rows[:16]]))
    with make_batch_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        assert isinstance(next(reader).image, np.ndarray)


def test_variable_shape_column_declines(tmp_path, registry):
    from petastorm_tpu_torch.examples.imagenet import generate_petastorm_imagenet
    url = 'file://' + str(tmp_path) + '/ds'
    generate_petastorm_imagenet(url, num_rows=8)
    with make_batch_reader(url, reader_pool_type='dummy', defer_image_decode=True) as reader:
        batch = next(reader)
    assert batch.image.dtype == object
    assert _fallbacks(registry, 'column-shape') == 1


def test_encoded_column_surface():
    codec = CompressedImageCodec('png')
    field = UnischemaField('image', np.uint8, IMG_SHAPE, codec, False)
    rng = np.random.RandomState(6)
    images = [rng.randint(0, 255, IMG_SHAPE, dtype=np.uint8) for _ in range(6)]
    cells = native.PackedCells.from_cells([bytes(codec.encode(field, im)) for im in images])
    column = fused.EncodedImageColumn(field, cells)
    assert len(column) == 6 and column.nbytes == 6 * int(np.prod(IMG_SHAPE))
    head = column[:2]
    assert isinstance(head, fused.EncodedImageColumn) and len(head) == 2
    np.testing.assert_array_equal(head.materialize(), np.stack(images[:2]))
    np.testing.assert_array_equal(column[2:].materialize(), np.stack(images[2:]))
    with pytest.raises(TypeError, match='encoded'):
        column[0]
    slab = fused.alloc_column_slab((6,) + IMG_SHAPE, np.uint8)
    assert slab.ctypes.data % fused.SLAB_ALIGN == 0


# -- the pinned slot ring, with a stand-in target ------------------------------


class _Event:
    def query(self):
        return False

    def synchronize(self):
        pass


class _Target:
    pin_memory = False

    def transfer(self, host, device_casts):
        return {k: v.clone() for k, v in host.items()}, _Event()

    def deliver(self, tensors, event):
        return tensors


def test_ring_fill_decodes_into_the_slot(registry):
    codec = CompressedImageCodec('png')
    field = UnischemaField('image', np.uint8, IMG_SHAPE, codec, False)
    rng = np.random.RandomState(7)
    engine = staging.StagingEngine(8, None, 'drop', _Target(), num_slots=2)
    for step in range(4):
        images = [rng.randint(0, 255, IMG_SHAPE, dtype=np.uint8) for _ in range(8)]
        cells = [bytes(codec.encode(field, im)) for im in images]
        parts = [{'image': fused.EncodedImageColumn(field, cells[:3]),
                  'id': np.arange(3)},
                 {'image': fused.EncodedImageColumn(field, cells[3:]),
                  'id': np.arange(3, 8)}]
        batch = engine.stage(parts, 8).deliver()
        np.testing.assert_array_equal(batch['image'].numpy(), np.stack(images))
    assert engine.fused_mode == 'fused-into-slot' and engine.fused_rows == 32
    assert engine.slabs_allocated == 2
    assert registry.snapshot()['counters'][FUSED_ROWS] == 32


def test_handshake_follows_the_staging_knob(png_url, env):
    url, _ = png_url
    env(PETASTORM_TPU_STAGING='0')
    assert not staging.staging_enabled()
    _, diag = _torch(url, batch_size=24)
    assert diag['fused_decode_mode'] == 'batched' and 'fused_decode_fallback' not in diag
    os.environ.pop('PETASTORM_TPU_STAGING')
    assert staging.staging_enabled()
