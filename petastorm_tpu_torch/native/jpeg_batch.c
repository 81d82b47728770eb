/* Native batched JPEG decode: the hot inner loop of CompressedImageCodec.
 *
 * Counterpart of petastorm_tpu/native/jpeg_batch.c behind a plain C ABI
 * (bound with ctypes, which releases the GIL for the call; no Python.h).
 * Cell i is data[offsets[i]:offsets[i + 1]] (an Arrow binary column's
 * data and offsets buffers, so no per-cell object exists).
 *
 * int64_t pt_decode_jpeg_batch(data, offsets, n, out, height, width,
 *                              fancy, threads)
 *
 * Decodes each cell with libjpeg(-turbo) straight into row i of the
 * C-contiguous (n, height, width, 3) uint8 `out`, RGB, ISLOW DCT (or
 * IFAST when PETASTORM_TPU_JPEG_DCT=ifast). `fancy` picks the chroma
 * upsampling: 1 = fancy (bit-identical to OpenCV's imdecode of the same
 * bytes, both ride libjpeg), 0 = merged, -1 = the PETASTORM_TPU_JPEG_FANCY
 * environment variable (unset or 0 = merged). `threads` > 1 fans the
 * cells across that many pthreads (clamped to 32), each with its own
 * decompress object and disjoint output rows.
 *
 * Returns the count of leading cells decoded: a cell that is not an 8-bit
 * 3-component JPEG of exactly (height, width) stops the loop, and the
 * caller decodes the rest per cell (the prefix-count contract).
 */

#include <pthread.h>
#include <setjmp.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <strings.h>
#include <jpeglib.h>

#define PT_MAX_THREADS 32

struct pt_jpeg_error_mgr {
    struct jpeg_error_mgr pub;
    jmp_buf setjmp_buffer;
};

static void
pt_error_exit(j_common_ptr cinfo)
{
    struct pt_jpeg_error_mgr *err = (struct pt_jpeg_error_mgr *)cinfo->err;
    longjmp(err->setjmp_buffer, 1);
}

static void
pt_emit_message(j_common_ptr cinfo, int msg_level)
{
    /* no stderr from a data-loader loop; corrupt data still longjmps */
    (void)cinfo;
    (void)msg_level;
}

/* One cell with a reused decompress object; 0 on success, -1 on a
 * mismatch (after jpeg_abort_decompress, which keeps the object usable).
 * `rows` is scratch for >= height row pointers, so each
 * jpeg_read_scanlines call may hand back several rows. */
static int
decode_one(struct jpeg_decompress_struct *cinfo, const uint8_t *buf,
           size_t len, uint8_t *dst, int height, int width, JSAMPROW *rows,
           boolean fancy, J_DCT_METHOD dct)
{
    size_t stride = (size_t)width * 3;
    int r;

    jpeg_mem_src(cinfo, (unsigned char *)buf, (unsigned long)len);
    if (jpeg_read_header(cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_abort_decompress(cinfo);
        return -1;
    }
    if (cinfo->data_precision != 8 || cinfo->num_components != 3) {
        jpeg_abort_decompress(cinfo);
        return -1;
    }
    cinfo->out_color_space = JCS_RGB;
    cinfo->do_fancy_upsampling = fancy;
    cinfo->dct_method = dct;
    jpeg_start_decompress(cinfo);
    if ((int)cinfo->output_height != height || (int)cinfo->output_width != width
        || cinfo->output_components != 3) {
        jpeg_abort_decompress(cinfo);
        return -1;
    }
    for (r = 0; r < height; r++)
        rows[r] = dst + (size_t)r * stride;
    while (cinfo->output_scanline < cinfo->output_height) {
        JDIMENSION done = cinfo->output_scanline;
        jpeg_read_scanlines(cinfo, rows + done, cinfo->output_height - done);
    }
    jpeg_finish_decompress(cinfo);
    return 0;
}

/* One contiguous cell range of one thread; `fail` is its first rejected
 * index (== hi when the whole range decoded). */
struct pt_jpeg_task {
    const uint8_t *data;
    const int64_t *offsets;
    uint8_t *out;
    size_t row_bytes;
    int64_t lo, hi, fail;
    int height, width;
    boolean fancy;
    J_DCT_METHOD dct;
};

static void *
pt_jpeg_worker(void *arg)
{
    struct pt_jpeg_task *t = (struct pt_jpeg_task *)arg;
    struct jpeg_decompress_struct cinfo;
    struct pt_jpeg_error_mgr jerr;
    JSAMPROW *rows;
    /* changed between setjmp and a possible longjmp: must be volatile */
    volatile int64_t i_v = t->lo;

    t->fail = t->lo;
    rows = (JSAMPROW *)malloc(sizeof(JSAMPROW) * (size_t)(t->height ? t->height : 1));
    if (rows == NULL)
        return NULL;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = pt_error_exit;
    jerr.pub.emit_message = pt_emit_message;
    if (setjmp(jerr.setjmp_buffer) == 0) {
        jpeg_create_decompress(&cinfo);
        for (; i_v < t->hi; i_v = i_v + 1) {
            int64_t i = i_v;
            if (decode_one(&cinfo, t->data + t->offsets[i],
                           (size_t)(t->offsets[i + 1] - t->offsets[i]),
                           t->out + (size_t)i * t->row_bytes, t->height,
                           t->width, rows, t->fancy, t->dct) != 0)
                break;
        }
    }
    /* a longjmp lands here too: the cell being decoded is the failure */
    t->fail = i_v;
    jpeg_destroy_decompress(&cinfo);
    free(rows);
    return NULL;
}

int64_t
pt_decode_jpeg_batch(const uint8_t *data, const int64_t *offsets, int64_t n,
                     uint8_t *out, int height, int width, int fancy, int threads)
{
    struct pt_jpeg_task tasks[PT_MAX_THREADS];
    pthread_t tids[PT_MAX_THREADS];
    int created[PT_MAX_THREADS] = {0};
    int64_t n_tasks, chunk, t, decoded;
    boolean use_fancy;
    J_DCT_METHOD dct;
    const char *dct_env = getenv("PETASTORM_TPU_JPEG_DCT");

    if (n <= 0)
        return 0;
    if (fancy >= 0) {
        use_fancy = fancy ? TRUE : FALSE;
    } else {
        /* parsed by value: FANCY=0 and FANCY= keep the merged default */
        const char *env = getenv("PETASTORM_TPU_JPEG_FANCY");
        use_fancy = (env != NULL && env[0] != '\0' && strcmp(env, "0") != 0)
                        ? TRUE : FALSE;
    }
    dct = (dct_env != NULL && strcasecmp(dct_env, "ifast") == 0) ? JDCT_IFAST
                                                                   : JDCT_ISLOW;
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
        tasks[t].row_bytes = (size_t)height * (size_t)width * 3;
        tasks[t].lo = t * chunk < n ? t * chunk : n;
        tasks[t].hi = (t + 1) * chunk < n ? (t + 1) * chunk : n;
        tasks[t].fail = tasks[t].lo;
        tasks[t].height = height;
        tasks[t].width = width;
        tasks[t].fancy = use_fancy;
        tasks[t].dct = dct;
    }
    for (t = 1; t < n_tasks; t++)
        created[t] = pthread_create(&tids[t], NULL, pt_jpeg_worker, &tasks[t]) == 0;
    pt_jpeg_worker(&tasks[0]);
    for (t = 1; t < n_tasks; t++) {
        if (created[t])
            pthread_join(tids[t], NULL);
        else
            pt_jpeg_worker(&tasks[t]);  /* spawn failed: decode inline */
    }
    /* the decoded prefix ends at the first rejected index overall */
    decoded = n;
    for (t = 0; t < n_tasks; t++) {
        if (tasks[t].fail < tasks[t].hi && tasks[t].fail < decoded)
            decoded = tasks[t].fail;
    }
    return decoded;
}
