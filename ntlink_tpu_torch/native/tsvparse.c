/* ntlink_tsv — native parser for indexlr-style sketch TSVs.
 *
 * The contig index TSV (reference shape `name\thash:pos:strand ...`,
 * ntLink:198-199) reaches ~1.8 GB / ~60 M entries for a human assembly;
 * parsing it with per-token Python splits costs minutes of startup. This
 * module parses the whole buffer with the GIL released.
 *
 * API:
 *   parse_sketch(buf: bytes-like) ->
 *       list[(name: str, n: int, hashes u64 bytes, pos i32 bytes,
 *             strand u8 bytes)]
 *   Lines without a body (no tab or empty body) are skipped, matching
 *   ContigIndex.from_tsv. Strand column is optional per token
 *   (hash:pos[:strand]); missing strand parses as '+'.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    const char *name;
    Py_ssize_t name_len;
    uint64_t *hashes;
    int32_t *pos;
    uint8_t *strand;
    Py_ssize_t n;
} LineOut;

static int parse_all(const char *buf, Py_ssize_t len, LineOut **out_lines,
                     Py_ssize_t *out_n)
{
    Py_ssize_t cap = 64, n = 0;
    LineOut *lines = (LineOut *)malloc((size_t)cap * sizeof(LineOut));
    if (!lines)
        return -1;
    const char *p = buf;
    const char *end = buf + len;
    while (p < end) {
        const char *nl = memchr(p, '\n', (size_t)(end - p));
        const char *line_end = nl ? nl : end;
        const char *tab = memchr(p, '\t', (size_t)(line_end - p));
        if (tab && tab + 1 < line_end) {
            const char *body = tab + 1;
            /* token count = spaces + 1 over the body */
            Py_ssize_t count = 1;
            for (const char *q = body; q < line_end; q++)
                if (*q == ' ')
                    count++;
            uint64_t *hashes = (uint64_t *)malloc((size_t)count * 8);
            int32_t *pos = (int32_t *)malloc((size_t)count * 4);
            uint8_t *strand = (uint8_t *)malloc((size_t)count);
            if (!hashes || !pos || !strand) {
                free(hashes);
                free(pos);
                free(strand);
                goto oom;
            }
            Py_ssize_t k = 0;
            const char *q = body;
            while (q < line_end && k < count) {
                uint64_t h = 0;
                while (q < line_end && *q >= '0' && *q <= '9')
                    h = h * 10 + (uint64_t)(*q++ - '0');
                int32_t ps = 0;
                if (q < line_end && *q == ':') {
                    q++;
                    while (q < line_end && *q >= '0' && *q <= '9')
                        ps = ps * 10 + (*q++ - '0');
                }
                uint8_t st = 1;
                if (q < line_end && *q == ':') {
                    q++;
                    if (q < line_end) {
                        st = (*q == '+');
                        q++;
                    }
                }
                hashes[k] = h;
                pos[k] = ps;
                strand[k] = st;
                k++;
                /* guaranteed progress: skip anything that is not a token
                 * separator (tolerates extra columns / \r; from_tsv only
                 * feeds contig-shape TSVs, but never crash on others) */
                while (q < line_end && *q != ' ')
                    q++;
                while (q < line_end && *q == ' ')
                    q++;
            }
            if (n == cap) {
                cap *= 2;
                LineOut *nl2 =
                    (LineOut *)realloc(lines, (size_t)cap * sizeof(LineOut));
                if (!nl2) {
                    free(hashes);
                    free(pos);
                    free(strand);
                    goto oom;
                }
                lines = nl2;
            }
            lines[n].name = p;
            lines[n].name_len = tab - p;
            lines[n].hashes = hashes;
            lines[n].pos = pos;
            lines[n].strand = strand;
            lines[n].n = k;
            n++;
        }
        if (!nl)
            break;
        p = nl + 1;
    }
    *out_lines = lines;
    *out_n = n;
    return 0;
oom:
    for (Py_ssize_t i = 0; i < n; i++) {
        free(lines[i].hashes);
        free(lines[i].pos);
        free(lines[i].strand);
    }
    free(lines);
    return -1;
}

static PyObject *py_parse_sketch(PyObject *self, PyObject *args)
{
    Py_buffer buf_v;
    if (!PyArg_ParseTuple(args, "y*", &buf_v))
        return NULL;
    LineOut *lines = NULL;
    Py_ssize_t n = 0;
    int rc;
    Py_BEGIN_ALLOW_THREADS
    rc = parse_all((const char *)buf_v.buf, buf_v.len, &lines, &n);
    Py_END_ALLOW_THREADS
    if (rc < 0) {
        PyBuffer_Release(&buf_v);
        return PyErr_NoMemory();
    }
    PyObject *result = PyList_New(n);
    if (result) {
        for (Py_ssize_t i = 0; i < n; i++) {
            LineOut *L = &lines[i];
            PyObject *tup = Py_BuildValue(
                "s#ny#y#y#", L->name, L->name_len, L->n,
                (const char *)L->hashes, L->n * 8,
                (const char *)L->pos, L->n * 4,
                (const char *)L->strand, L->n);
            if (!tup) {
                Py_CLEAR(result);
                break;
            }
            PyList_SET_ITEM(result, i, tup);
        }
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        free(lines[i].hashes);
        free(lines[i].pos);
        free(lines[i].strand);
    }
    free(lines);
    PyBuffer_Release(&buf_v);
    return result;
}

static PyMethodDef tsv_methods[] = {
    {"parse_sketch", py_parse_sketch, METH_VARARGS,
     "parse_sketch(buf) -> list[(name, n, hashes_u64, pos_i32, strand_u8)]"},
    {NULL, NULL, 0, NULL},
};

static PyModuleDef tsv_module = {
    PyModuleDef_HEAD_INIT,
    .m_name = "ntlink_tsv",
    .m_doc = "Native indexlr-TSV parser",
    .m_size = -1,
    .m_methods = tsv_methods,
};

PyMODINIT_FUNC PyInit_ntlink_tsv(void)
{
    return PyModule_Create(&tsv_module);
}
