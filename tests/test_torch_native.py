"""petastorm_tpu_torch's native decoders against the JAX package's, on the CPU.

The same cells (made with numpy from a seed, encoded with cv2) go through
the JAX package's ``decode_batch`` and the port's; every comparison is
byte for byte: ``.npy`` payloads are copied, PNG is lossless, and JPEG
runs in fancy upsampling (``PETASTORM_TPU_JPEG_FANCY=1`` or ``fancy=1``),
where libjpeg is bit-identical to cv2. Also held: the prefix-count
contract on a bad cell, equal output at 1 and 4 threads, the
``PETASTORM_TPU_NATIVE`` kill switch, the zero-copy cells of Arrow binary
columns, and the port's zlib-only PNG decoder on all five scanline
filters of the PNG specification.
"""

import struct
import zlib

import cv2
import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu.unischema import UnischemaField as JaxField
from petastorm_tpu_torch import codecs, native
from petastorm_tpu_torch.unischema import UnischemaField
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

SHAPE = (24, 40, 3)


@pytest.fixture
def fancy_jpeg(monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_JPEG_FANCY', '1')


def _images(n, seed, shape=SHAPE):
    rng = np.random.RandomState(seed)
    # smooth content plus noise, so JPEG chroma upsampling matters
    base = cv2.resize((rng.rand(4, 4, 3) * 200).astype(np.uint8), shape[1::-1],
                      interpolation=cv2.INTER_CUBIC).astype(np.float64)
    return [np.clip(base + rng.rand(*shape) * 40, 0, 255).astype(np.uint8) for _ in range(n)]


def _image_cells(kind, n, seed, shape=SHAPE):
    codec = codecs.CompressedImageCodec(kind, quality=90)
    field = UnischemaField('image', np.uint8, shape, codec, False)
    return [bytes(codec.encode(field, im)) for im in _images(n, seed, shape)], field


def _jax_field(field):
    codec = field.codec
    jax_codec = (jax_codecs.NdarrayCodec() if isinstance(codec, codecs.NdarrayCodec)
                 else jax_codecs.CompressedImageCodec(codec.image_codec, 90))
    return JaxField(field.name, field.numpy_dtype, field.shape, jax_codec, False)


@pytest.mark.parametrize('kind', ['png', 'jpeg'])
def test_image_batches_match_jax_decode_batch(kind, fancy_jpeg):
    cells, field = _image_cells(kind, 9, seed=1)
    want = _jax_field(field).codec.decode_batch(_jax_field(field), cells)
    got = field.codec.decode_batch(field, cells)
    assert got.dtype == np.uint8 and got.shape == (9,) + SHAPE
    np.testing.assert_array_equal(got, want)
    out = np.full((9,) + SHAPE, 0x5A, np.uint8)
    assert field.codec.decode_batch(field, native.PackedCells.from_cells(cells), out=out) is out
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize('dtype,shape', [(np.uint8, (28, 28)), (np.float32, (5, 7)),
                                         (np.int64, (3,)), (np.float64, (2, 3, 4))])
def test_npy_batches_match_jax_decode_batch(dtype, shape):
    codec = codecs.NdarrayCodec()
    field = UnischemaField('m', dtype, shape, codec, False)
    rng = np.random.RandomState(2)
    arrays = [(rng.rand(*shape) * 100).astype(dtype) for _ in range(11)]
    cells = [bytes(codec.encode(field, a)) for a in arrays]
    want = _jax_field(field).codec.decode_batch(_jax_field(field), cells)
    got = codec.decode_batch(field, cells)
    assert got.dtype == np.dtype(dtype) and got.shape == (11,) + shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack(arrays))


def test_native_decoders_are_live_here():
    assert native.load_all() == {name: 'live' for name in native.DECODERS}


def test_direct_calls_match_the_jax_native_modules():
    """The C entry points against the JAX package's extension modules on
    the same cells (JPEG in fancy mode)."""
    from petastorm_tpu.native import get_jpeg_module, get_png_module
    for kind, module, call in (
            ('jpeg', get_jpeg_module(), lambda c, o: native.decode_jpeg_batch(c, o, 1, 2)),
            ('png', get_png_module(), lambda c, o: native.decode_png_batch(c, o, 2))):
        cells, _ = _image_cells(kind, 6, seed=3)
        want = np.empty((6,) + SHAPE, np.uint8)
        got = np.empty((6,) + SHAPE, np.uint8)
        args = (1,) if kind == 'jpeg' else ()
        assert getattr(module, 'decode_%s_batch' % kind)(cells, want, *args) == 6
        assert call(cells, got) == 6
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('kind', ['png', 'jpeg', 'npy'])
@pytest.mark.parametrize('bad', ['corrupt', 'wrong-size', 'truncated'])
def test_prefix_count_stops_at_the_first_bad_cell(kind, bad):
    """A cell the decoder rejects stops the loop at its index; the codec
    then decodes that cell per cell and the decoder takes the rest."""
    if kind == 'npy':
        codec = codecs.NdarrayCodec()
        field = UnischemaField('m', np.uint8, SHAPE, codec, False)
        images = _images(6, seed=4)
        cells = [bytes(codec.encode(field, im)) for im in images]
        other = bytes(codec.encode(UnischemaField('m', np.uint8, (40, 24, 3), codec, False),
                                   np.zeros((40, 24, 3), np.uint8)))
    else:
        cells, field = _image_cells(kind, 6, seed=4)
        other = _image_cells(kind, 1, seed=5, shape=(40, 24, 3))[0][0]
    bad_cell = {'corrupt': cells[3][:8] + bytes(len(cells[3]) - 8),
                'wrong-size': other,
                'truncated': cells[3][:len(cells[3]) // 2]}[bad]
    cells[3] = bad_cell
    out = np.empty((6,) + SHAPE, np.uint8)
    if kind == 'npy':
        descr, shape_str = np.dtype(np.uint8).str, "'shape': %r" % (SHAPE,)
        done = native.decode_npy_batch(cells, out, descr, shape_str, 1)
    elif kind == 'png':
        done = native.decode_png_batch(cells, out, 1)
    else:
        done = native.decode_jpeg_batch(cells, out, 1, 1)
    assert done == 3
    if bad == 'wrong-size':
        # the codec keeps the odd cell's true shape on the list path
        rows = field.codec.decode_batch(field, cells)
        assert [np.shape(r) for r in rows] == [SHAPE] * 3 + [(40, 24, 3)] + [SHAPE] * 2
        with pytest.raises(ValueError):
            field.codec.decode_batch(field, cells, out=np.empty((6,) + SHAPE, np.uint8))


@pytest.mark.parametrize('kind', ['png', 'jpeg', 'npy'])
def test_one_and_four_threads_give_equal_output(kind, monkeypatch):
    if kind == 'npy':
        codec = codecs.NdarrayCodec()
        field = UnischemaField('m', np.uint8, SHAPE, codec, False)
        cells = [bytes(codec.encode(field, im)) for im in _images(13, seed=6)]
    else:
        cells, field = _image_cells(kind, 13, seed=6)
    outs = []
    for threads in ('1', '4'):
        monkeypatch.setenv('PETASTORM_TPU_IMAGE_DECODER_THREADS', threads)
        assert codecs.image_decoder_threads() == int(threads)
        outs.append(field.codec.decode_batch(field, cells))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_kill_switch_turns_every_decoder_off(monkeypatch, fancy_jpeg):
    cells, field = _image_cells('png', 5, seed=7)
    want = field.codec.decode_batch(field, cells)
    monkeypatch.setenv('PETASTORM_TPU_NATIVE', '0')
    assert native.native_status() == {name: 'disabled' for name in native.DECODERS}
    assert native.decode_png_batch(cells, np.empty((5,) + SHAPE, np.uint8), 1) is None
    # the codec still decodes, per cell through cv2
    np.testing.assert_array_equal(field.codec.decode_batch(field, cells), want)
    monkeypatch.delenv('PETASTORM_TPU_NATIVE')
    assert native.available('png_batch')


def test_jpeg_threads_knob_default_and_garbage(monkeypatch):
    monkeypatch.delenv('PETASTORM_TPU_IMAGE_DECODER_THREADS', raising=False)
    assert 1 <= codecs.image_decoder_threads() <= 4
    monkeypatch.setenv('PETASTORM_TPU_IMAGE_DECODER_THREADS', 'many')
    assert codecs.image_decoder_threads() == 0


def test_jpeg_calibration_picks_a_mode_and_caches_it(monkeypatch, tmp_path):
    monkeypatch.delenv('PETASTORM_TPU_JPEG_FANCY', raising=False)
    monkeypatch.setattr(codecs, '_JPEG_FANCY_MODE', None)
    cache = tmp_path / 'mode.txt'
    monkeypatch.setattr(codecs, '_jpeg_mode_cache_path', lambda: str(cache))
    cells, _ = _image_cells('jpeg', 8, seed=8)
    mode = codecs._jpeg_upsampling_mode(cells, SHAPE)
    assert mode in (0, 1) and cache.read_text() == str(mode)
    monkeypatch.setattr(codecs, '_JPEG_FANCY_MODE', None)
    cache.write_text(str(1 - mode))
    assert codecs._jpeg_upsampling_mode(cells, SHAPE) == 1 - mode
    monkeypatch.setenv('PETASTORM_TPU_JPEG_FANCY', '1')
    assert codecs._jpeg_upsampling_mode(cells, SHAPE) == -1


# -- cells of Arrow binary columns ---------------------------------------------


@pytest.mark.parametrize('arrow_type', [pa.binary(), pa.large_binary()])
def test_binary_cells_are_zero_copy_views(arrow_type):
    values = [b'a', b'', b'bcd', b'efgh', b'ij']
    column = pa.chunked_array([pa.array(values, arrow_type)])
    cells = native.binary_cells(column)
    assert isinstance(cells, native.PackedCells) and len(cells) == 5
    assert [bytes(c) for c in cells] == values
    data = column.chunk(0).buffers()[2]
    assert cells.data.ctypes.data == data.address
    # a sliced column has a non-zero offset base
    sliced = native.binary_cells(column.slice(2, 3))
    assert [bytes(c) for c in sliced] == values[2:]
    assert [bytes(c) for c in cells[1:4]] == values[1:4]
    assert cells[1:4].nbytes == 7


def test_binary_cells_with_nulls_and_other_types():
    cells = native.binary_cells(pa.chunked_array([pa.array([b'x', None, b'yz'])]))
    assert [None if c is None else bytes(c) for c in cells] == [b'x', None, b'yz']
    assert native.binary_cells(pa.chunked_array([pa.array([1, 2])])) is None
    two = native.binary_cells(pa.chunked_array([pa.array([b'a']), pa.array([b'bc'])]))
    assert [bytes(c) for c in two] == [b'a', b'bc']


# -- the zlib-only PNG decoder on every scanline filter ------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa_, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa_ <= pb and pa_ <= pc else (b if pb <= pc else c)


def _png(image, filters, idat_chunks=3):
    """An 8-bit RGB PNG of ``image`` with the given filter type on each
    row (cycled), its zlib stream split over ``idat_chunks`` IDAT chunks."""
    h, w, _ = image.shape
    raw = bytearray()
    prior = np.zeros(w * 3, np.int64)
    for r in range(h):
        row = image[r].reshape(-1).astype(np.int64)
        ftype = filters[r % len(filters)]
        left = np.concatenate([np.zeros(3, np.int64), row[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), prior[:-3]])
        pred = {0: np.zeros_like(row), 1: left, 2: prior, 3: (left + prior) // 2,
                4: np.array([_paeth(a, b, c) for a, b, c in zip(left, prior, upleft)])}[ftype]
        raw.append(ftype)
        raw.extend(((row - pred) % 256).astype(np.uint8).tobytes())
        prior = row
    stream = zlib.compress(bytes(raw))

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))

    step = -(-len(stream) // idat_chunks)
    return (b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + chunk(b'tEXt', b'Comment\x00made by a test')
            + b''.join(chunk(b'IDAT', stream[i:i + step]) for i in range(0, len(stream), step))
            + chunk(b'IEND', b''))


@pytest.mark.parametrize('filters', [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]],
                         ids=['none', 'sub', 'up', 'average', 'paeth', 'mixed'])
def test_png_decoder_undoes_every_filter(filters):
    images = _images(3, seed=9)
    cells = [_png(im, filters) for im in images]
    out = np.empty((3,) + SHAPE, np.uint8)
    assert native.decode_png_batch(cells, out, 2) == 3
    np.testing.assert_array_equal(out, np.stack(images))
    # and libpng (through the JAX package's decoder) reads the same pixels
    from petastorm_tpu.native import get_png_module
    want = np.empty_like(out)
    assert get_png_module().decode_png_batch(cells, want) == 3
    np.testing.assert_array_equal(out, want)


def test_png_decoder_rejects_what_it_does_not_decode():
    image = _images(1, seed=10)[0]
    good = _png(image, [4])
    bad_crc = bytearray(good)
    bad_crc[-20] ^= 0xFF  # inside the last IDAT's data
    rgba = cv2.imencode('.png', np.zeros((24, 40, 4), np.uint8))[1].tobytes()
    gray = cv2.imencode('.png', np.zeros((24, 40), np.uint8))[1].tobytes()
    deep = cv2.imencode('.png', np.zeros((24, 40, 3), np.uint16))[1].tobytes()
    for cell in (bytes(bad_crc), rgba, gray, deep, good[:-40], b'not a png at all' * 3):
        out = np.empty((2,) + SHAPE, np.uint8)
        assert native.decode_png_batch([good, cell], out, 1) == 1


def test_calls_refuse_destinations_and_offsets_the_decoder_would_overrun():
    cells, _ = _image_cells('png', 2, seed=11)
    with pytest.raises(ValueError, match='uint8'):
        native.decode_png_batch(cells, np.empty((2,) + SHAPE, np.float32), 1)
    with pytest.raises(ValueError, match='uint8'):
        native.decode_jpeg_batch(cells, np.empty((2, 24, 40, 4), np.uint8), 1, 1)
    with pytest.raises(ValueError, match='C-contiguous'):
        native.decode_png_batch(cells, np.empty((2, 40, 24, 3), np.uint8).transpose(0, 2, 1, 3), 1)
    with pytest.raises(ValueError, match='cells for'):
        native.decode_png_batch(cells, np.empty((3,) + SHAPE, np.uint8), 1)
    packed = native.PackedCells.from_cells(cells)
    bad = native.PackedCells(packed.data, packed.offsets + 5)
    with pytest.raises(ValueError, match='outside'):
        native.decode_png_batch(bad, np.empty((2,) + SHAPE, np.uint8), 1)
