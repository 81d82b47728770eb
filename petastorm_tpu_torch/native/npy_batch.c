/* Native batched NPY decode: the hot inner loop of NdarrayCodec.
 *
 * Counterpart of petastorm_tpu/native/npy_batch.c behind a plain C ABI
 * (bound with ctypes; no Python.h, no numpy headers). The cells arrive
 * as one byte buffer and n + 1 offsets: cell i is
 * data[offsets[i]:offsets[i + 1]], which is exactly an Arrow binary
 * column's data and offsets buffers, so no per-cell object exists.
 *
 * int64_t pt_decode_npy_batch(data, offsets, n, out, row_bytes, descr,
 *                             shape_str, threads)
 *
 * Each cell's .npy header (magic, version, dict literal) is parsed and
 * checked against `descr` (e.g. "<f4") and `shape_str` (numpy's canonical
 * "'shape': (2, 3)"), then its payload is memcpy'd into row i of `out`.
 * Returns the count of leading cells decoded: a cell whose header, dtype,
 * shape or payload size disagrees stops the loop, and the caller decodes
 * the rest per cell (the prefix-count contract of every decoder here).
 * Headers are checked serially; the payload copies fan across `threads`
 * pthreads (clamped to 32), disjoint rows each.
 */

#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define PT_MAX_THREADS 32

static const char NPY_MAGIC[6] = {'\x93', 'N', 'U', 'M', 'P', 'Y'};

/* Payload offset and header dict of one cell; -1 when it is not .npy. */
static int
parse_npy_header(const uint8_t *buf, int64_t len, int64_t *data_offset,
                 const char **header, int64_t *header_len)
{
    uint32_t hlen;
    if (len < 10 || memcmp(buf, NPY_MAGIC, 6) != 0)
        return -1;
    if (buf[6] == 1) {
        hlen = (uint32_t)buf[8] | ((uint32_t)buf[9] << 8);
        *data_offset = 10 + (int64_t)hlen;
        *header = (const char *)buf + 10;
    } else if (buf[6] == 2 || buf[6] == 3) {
        if (len < 12)
            return -1;
        hlen = (uint32_t)buf[8] | ((uint32_t)buf[9] << 8)
             | ((uint32_t)buf[10] << 16) | ((uint32_t)buf[11] << 24);
        *data_offset = 12 + (int64_t)hlen;
        *header = (const char *)buf + 12;
    } else {
        return -1;
    }
    if (*data_offset > len)
        return -1;
    *header_len = (int64_t)hlen;
    return 0;
}

/* fortran_order False, the declared descr, and the declared shape: a cell
 * whose true shape differs but whose byte count coincides must not be
 * copied into the declared shape (silent reinterpretation). */
static int
header_compatible(const char *header, int64_t header_len, const char *descr,
                  const char *shape_str)
{
    char needle[64];
    char *tmp;
    int ok;

    if (header_len <= 0 || header_len > 65536
        || strlen(descr) + 3 > sizeof(needle))
        return 0;
    /* the header is not NUL-terminated */
    tmp = (char *)malloc((size_t)header_len + 1);
    if (tmp == NULL)
        return 0;
    memcpy(tmp, header, (size_t)header_len);
    tmp[header_len] = '\0';
    ok = strstr(tmp, "'fortran_order': False") != NULL
         || strstr(tmp, "\"fortran_order\": False") != NULL;
    if (ok) {
        snprintf(needle, sizeof(needle), "'%s'", descr);
        if (strstr(tmp, needle) == NULL) {
            snprintf(needle, sizeof(needle), "\"%s\"", descr);
            ok = strstr(tmp, needle) != NULL;
        }
    }
    if (ok)
        ok = strstr(tmp, shape_str) != NULL;
    free(tmp);
    return ok;
}

struct pt_npy_task {
    const uint8_t *const *srcs;
    uint8_t *out;
    int64_t row_bytes;
    int64_t lo, hi;
};

static void *
pt_npy_worker(void *arg)
{
    struct pt_npy_task *t = (struct pt_npy_task *)arg;
    int64_t i;

    for (i = t->lo; i < t->hi; i++)
        memcpy(t->out + i * t->row_bytes, t->srcs[i], (size_t)t->row_bytes);
    return NULL;
}

int64_t
pt_decode_npy_batch(const uint8_t *data, const int64_t *offsets, int64_t n,
                    uint8_t *out, int64_t row_bytes, const char *descr,
                    const char *shape_str, int threads)
{
    const uint8_t **srcs;
    struct pt_npy_task tasks[PT_MAX_THREADS];
    pthread_t tids[PT_MAX_THREADS];
    int created[PT_MAX_THREADS] = {0};
    int64_t i, n_ok, n_tasks, chunk, t;

    if (n <= 0)
        return 0;
    srcs = (const uint8_t **)malloc(sizeof(*srcs) * (size_t)n);
    if (srcs == NULL)
        return 0;
    /* phase 1: validate headers; the decoded prefix ends at the first
     * cell that is not a compatible .npy payload of row_bytes bytes */
    for (i = 0; i < n; i++) {
        const uint8_t *cell = data + offsets[i];
        int64_t len = offsets[i + 1] - offsets[i];
        int64_t data_offset, header_len;
        const char *header;
        if (parse_npy_header(cell, len, &data_offset, &header, &header_len) != 0
            || !header_compatible(header, header_len, descr, shape_str)
            || len - data_offset != row_bytes)
            break;
        srcs[i] = cell + data_offset;
    }
    n_ok = i;

    /* phase 2: copy every validated payload */
    if (n_ok > 0 && row_bytes > 0) {
        n_tasks = threads;
        if (n_tasks > PT_MAX_THREADS)
            n_tasks = PT_MAX_THREADS;
        if (n_tasks > n_ok)
            n_tasks = n_ok;
        if (n_tasks < 1)
            n_tasks = 1;
        chunk = (n_ok + n_tasks - 1) / n_tasks;
        for (t = 0; t < n_tasks; t++) {
            tasks[t].srcs = srcs;
            tasks[t].out = out;
            tasks[t].row_bytes = row_bytes;
            tasks[t].lo = t * chunk < n_ok ? t * chunk : n_ok;
            tasks[t].hi = (t + 1) * chunk < n_ok ? (t + 1) * chunk : n_ok;
        }
        for (t = 1; t < n_tasks; t++)
            created[t] = pthread_create(&tids[t], NULL, pt_npy_worker,
                                        &tasks[t]) == 0;
        pt_npy_worker(&tasks[0]);
        for (t = 1; t < n_tasks; t++) {
            if (created[t])
                pthread_join(tids[t], NULL);
            else
                pt_npy_worker(&tasks[t]);  /* spawn failed: copy inline */
        }
    }
    free(srcs);
    return n_ok;
}
