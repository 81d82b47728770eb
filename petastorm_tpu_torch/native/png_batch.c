/* Native batched PNG decode: the 8-bit RGB fast path of
 * CompressedImageCodec, sibling of jpeg_batch.c, behind a plain C ABI
 * (bound with ctypes, which releases the GIL for the call).
 *
 * int64_t pt_decode_png_batch(data, offsets, n, out, height, width, threads)
 *
 * Cell i is data[offsets[i]:offsets[i + 1]] (an Arrow binary column's
 * data and offsets buffers). Each cell is decoded straight into row i of
 * the C-contiguous (n, height, width, 3) uint8 `out`. PNG stores RGB
 * natively, so rows land with no channel conversion: the result is
 * bit-identical to libpng's, and so to OpenCV's (PNG is lossless).
 *
 * The decoder needs only zlib, not libpng: a non-interlaced 8-bit RGB PNG
 * is its IDAT chunks' zlib stream, one filter-type byte before each
 * scanline, and the five scanline filters of the PNG specification
 * (section 9), which are undone here. The CRCs of IHDR and of every IDAT
 * chunk are checked, as libpng checks them.
 *
 * Returns the count of leading cells decoded: a cell that is not a
 * non-interlaced 8-bit RGB PNG of exactly (height, width) (or is corrupt,
 * truncated, or carries an unknown critical chunk) stops the loop, and
 * the caller decodes the rest per cell (the prefix-count contract).
 * `threads` > 1 fans the cells across that many pthreads (clamped to 32),
 * disjoint output rows each.
 */

#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

#define PT_MAX_THREADS 32

static const uint8_t PNG_SIGNATURE[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

static uint32_t
be32(const uint8_t *p)
{
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8)
           | (uint32_t)p[3];
}

static int
crc_ok(const uint8_t *chunk, uint32_t length)
{
    /* the CRC covers the chunk type and data */
    uLong crc = crc32(0L, chunk + 4, (uInt)(length + 4));
    return crc == be32(chunk + 8 + length);
}

static uint8_t
paeth(int a, int b, int c)
{
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc)
        return (uint8_t)a;
    return (uint8_t)(pb <= pc ? b : c);
}

/* Undo one scanline's filter into `dst` (`prior` is the row above, or
 * NULL for the first); -1 on an unknown filter type. */
static int
unfilter(uint8_t type, const uint8_t *src, const uint8_t *prior, uint8_t *dst,
         size_t stride)
{
    size_t i;
    switch (type) {
    case 0:
        memcpy(dst, src, stride);
        return 0;
    case 1:
        for (i = 0; i < stride; i++)
            dst[i] = (uint8_t)(src[i] + (i >= 3 ? dst[i - 3] : 0));
        return 0;
    case 2:
        for (i = 0; i < stride; i++)
            dst[i] = (uint8_t)(src[i] + (prior ? prior[i] : 0));
        return 0;
    case 3:
        for (i = 0; i < stride; i++) {
            int a = i >= 3 ? dst[i - 3] : 0, b = prior ? prior[i] : 0;
            dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        return 0;
    case 4:
        for (i = 0; i < stride; i++) {
            int a = i >= 3 ? dst[i - 3] : 0, b = prior ? prior[i] : 0;
            int c = (i >= 3 && prior) ? prior[i - 3] : 0;
            dst[i] = (uint8_t)(src[i] + paeth(a, b, c));
        }
        return 0;
    default:
        return -1;
    }
}

/* One cell into `dst`; `z` is a reused inflate stream and `scratch` holds
 * height * (1 + width * 3) filtered bytes. 0 on success, -1 otherwise. */
static int
decode_one(z_stream *z, const uint8_t *buf, size_t len, uint8_t *dst,
           int height, int width, uint8_t *scratch)
{
    size_t stride = (size_t)width * 3, filtered = (size_t)height * (stride + 1);
    size_t pos = 8;
    int seen_ihdr = 0, done = 0, r;

    if (len < 8 + 25 || memcmp(buf, PNG_SIGNATURE, 8) != 0)
        return -1;
    if (inflateReset(z) != Z_OK)
        return -1;
    z->next_out = scratch;
    z->avail_out = (uInt)filtered;
    while (!done) {
        uint32_t length;
        const uint8_t *chunk = buf + pos, *body;
        if (pos + 12 > len)
            return -1;
        length = be32(chunk);
        if (length > len - pos - 12)
            return -1;
        body = chunk + 8;
        if (!seen_ihdr) {
            /* IHDR comes first: the declared size, 8-bit depth, color
             * type 2 (RGB), deflate, adaptive filters, no interlace */
            if (memcmp(chunk + 4, "IHDR", 4) != 0 || length != 13 || !crc_ok(chunk, length)
                || be32(body) != (uint32_t)width || be32(body + 4) != (uint32_t)height
                || body[8] != 8 || body[9] != 2 || body[10] != 0 || body[11] != 0
                || body[12] != 0)
                return -1;
            seen_ihdr = 1;
        } else if (memcmp(chunk + 4, "IDAT", 4) == 0) {
            int rc;
            if (!crc_ok(chunk, length))
                return -1;
            z->next_in = (Bytef *)body;
            z->avail_in = length;
            rc = inflate(z, Z_NO_FLUSH);
            if (rc == Z_STREAM_END || z->avail_out == 0)
                done = 1;
            else if (rc != Z_OK && !(rc == Z_BUF_ERROR && length == 0))
                return -1;
        } else if (memcmp(chunk + 4, "IEND", 4) == 0) {
            return -1;  /* image data ended early */
        } else if (!(chunk[4] & 0x20) && memcmp(chunk + 4, "PLTE", 4) != 0) {
            return -1;  /* an unknown critical chunk */
        }
        pos += 12 + (size_t)length;
    }
    if (z->avail_out != 0)
        return -1;
    for (r = 0; r < height; r++) {
        const uint8_t *src = scratch + (size_t)r * (stride + 1);
        uint8_t *row = dst + (size_t)r * stride;
        if (unfilter(src[0], src + 1, r ? row - stride : NULL, row, stride) != 0)
            return -1;
    }
    return 0;
}

struct pt_png_task {
    const uint8_t *data;
    const int64_t *offsets;
    uint8_t *out;
    int64_t lo, hi, fail;
    int height, width;
};

static void *
pt_png_worker(void *arg)
{
    struct pt_png_task *t = (struct pt_png_task *)arg;
    size_t stride = (size_t)t->width * 3;
    uint8_t *scratch = (uint8_t *)malloc((size_t)t->height * (stride + 1) + 1);
    z_stream z;
    int64_t i = t->lo;

    memset(&z, 0, sizeof(z));
    if (scratch != NULL && inflateInit(&z) == Z_OK) {
        for (; i < t->hi; i++) {
            if (decode_one(&z, t->data + t->offsets[i],
                           (size_t)(t->offsets[i + 1] - t->offsets[i]),
                           t->out + (size_t)i * t->height * stride, t->height, t->width,
                           scratch) != 0)
                break;
        }
        inflateEnd(&z);
    }
    t->fail = i;
    free(scratch);
    return NULL;
}

int64_t
pt_decode_png_batch(const uint8_t *data, const int64_t *offsets, int64_t n, uint8_t *out,
                    int height, int width, int threads)
{
    struct pt_png_task tasks[PT_MAX_THREADS];
    pthread_t tids[PT_MAX_THREADS];
    int created[PT_MAX_THREADS] = {0};
    int64_t n_tasks, chunk, t, decoded;

    if (n <= 0 || height <= 0 || width <= 0)
        return 0;
    n_tasks = threads;
    if (n_tasks > PT_MAX_THREADS)
        n_tasks = PT_MAX_THREADS;
    if (n_tasks > n)
        n_tasks = n;
    if (n_tasks < 1)
        n_tasks = 1;
    chunk = (n + n_tasks - 1) / n_tasks;
    for (t = 0; t < n_tasks; t++) {
        tasks[t].data = data;
        tasks[t].offsets = offsets;
        tasks[t].out = out;
        tasks[t].lo = t * chunk < n ? t * chunk : n;
        tasks[t].hi = (t + 1) * chunk < n ? (t + 1) * chunk : n;
        tasks[t].fail = tasks[t].lo;
        tasks[t].height = height;
        tasks[t].width = width;
    }
    for (t = 1; t < n_tasks; t++)
        created[t] = pthread_create(&tids[t], NULL, pt_png_worker, &tasks[t]) == 0;
    pt_png_worker(&tasks[0]);
    for (t = 1; t < n_tasks; t++) {
        if (created[t])
            pthread_join(tids[t], NULL);
        else
            pt_png_worker(&tasks[t]);  /* spawn failed: decode inline */
    }
    decoded = n;
    for (t = 0; t < n_tasks; t++) {
        if (tasks[t].fail < tasks[t].hi && tasks[t].fail < decoded)
            decoded = tasks[t].fail;
    }
    return decoded;
}
