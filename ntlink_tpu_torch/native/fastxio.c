/* ntlink_fastx — native streaming FASTA/FASTQ reader.
 *
 * The native counterpart of the engine's host input pipeline (the reference
 * pipeline leans on btllib::SeqReader + pigz for this role). Transparent
 * gzip via zlib, readfq-compatible record splitting, and optional in-reader
 * 2-bit-code encoding (A/C/G/T -> 0..3, other -> 4) so the Python layer can
 * hand buffers straight to the device packer without touching each base.
 *
 * Exposed API:
 *   Reader(path, codes=False)
 *     iterator of (name: str, comment: str | None, payload: bytes,
 *                  qual: bytes | None)
 *     payload is the raw sequence (codes=False) or the encoded code bytes.
 *
 * The whole record parse — zlib inflate, line splitting, 2-bit encoding —
 * runs with the GIL RELEASED (the reference gets the same effect from
 * pigz -p + a separate indexlr process; ntLink:112-117,221-225). Only the
 * final Python object construction holds the GIL, so reader threads
 * decompress genuinely in parallel with host-side chaining/tally work.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <string.h>
#include <zlib.h>

#define CHUNK (1 << 20)

static unsigned char CODE_TAB[256];

/* -- dynamic byte buffer (plain malloc: usable without the GIL) --------- */
typedef struct {
    char *data;
    size_t len;
    size_t cap;
} DynBuf;

typedef struct {
    PyObject_HEAD
    gzFile gz;
    int codes;
    int eof;
    /* buffered reader state */
    unsigned char *buf;
    size_t buf_len;
    size_t buf_pos;
    /* carried-over header line (without leading marker) */
    char *pending;
    size_t pending_len;
    int pending_is_fastq;
    /* per-record scratch, reused across records */
    DynBuf line;
} ReaderObject;

static int dyn_reserve(DynBuf *b, size_t extra)
{
    if (b->len + extra <= b->cap)
        return 0;
    size_t cap = b->cap ? b->cap : 4096;
    while (cap < b->len + extra)
        cap *= 2;
    char *p = realloc(b->data, cap);
    if (!p)
        return -1;
    b->data = p;
    b->cap = cap;
    return 0;
}

static void dyn_free(DynBuf *b)
{
    free(b->data);
    b->data = NULL;
    b->len = b->cap = 0;
}

/* -- buffered line reading --------------------------------------------- */

/* No Python API below this line until Reader_iternext's object-building
 * phase: parse-path helpers return negative codes instead of setting
 * exceptions so they can run with the GIL released.
 *   -1 = IO error, -2 = out of memory */

static int fill_buffer(ReaderObject *self)
{
    if (self->eof)
        return 0;
    int n = gzread(self->gz, self->buf, CHUNK);
    if (n < 0)
        return -1;
    if (n == 0)
        self->eof = 1;
    self->buf_len = (size_t)n;
    self->buf_pos = 0;
    return 0;
}

/* Append the next line (without trailing newline) into out.
 * Returns 1 on line read, 0 on EOF, negative code on error. */
static int read_line(ReaderObject *self, DynBuf *out)
{
    out->len = 0;
    int got_any = 0;
    for (;;) {
        if (self->buf_pos >= self->buf_len) {
            if (fill_buffer(self) < 0)
                return -1;
            if (self->buf_len == 0)
                return got_any ? 1 : 0;
        }
        unsigned char *start = self->buf + self->buf_pos;
        size_t avail = self->buf_len - self->buf_pos;
        unsigned char *nl = memchr(start, '\n', avail);
        size_t span = nl ? (size_t)(nl - start) : avail;
        if (span) {
            if (dyn_reserve(out, span) < 0)
                return -2;
            memcpy(out->data + out->len, start, span);
            out->len += span;
        }
        got_any = 1;
        if (nl) {
            self->buf_pos += span + 1;
            return 1;
        }
        self->buf_pos += span;
    }
}

/* -- Reader type -------------------------------------------------------- */

static void Reader_dealloc(ReaderObject *self)
{
    if (self->gz)
        gzclose(self->gz);
    free(self->buf);
    free(self->pending);
    dyn_free(&self->line);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *Reader_new(PyTypeObject *type, PyObject *args, PyObject *kwds)
{
    static char *kwlist[] = {"path", "codes", NULL};
    const char *path;
    int codes = 0;
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "s|p", kwlist, &path, &codes))
        return NULL;

    ReaderObject *self = (ReaderObject *)type->tp_alloc(type, 0);
    if (!self)
        return NULL;
    self->codes = codes;
    self->eof = 0;
    self->buf_len = self->buf_pos = 0;
    self->pending = NULL;
    self->pending_len = 0;
    self->line.data = NULL;
    self->line.len = self->line.cap = 0;
    self->buf = malloc(CHUNK);
    if (!self->buf) {
        Py_DECREF(self);
        return PyErr_NoMemory();
    }
    self->gz = gzopen(path, "rb");
    if (!self->gz) {
        Py_DECREF(self);
        PyErr_Format(PyExc_IOError, "cannot open %s", path);
        return NULL;
    }
    gzbuffer(self->gz, CHUNK);
    return (PyObject *)self;
}

static void encode_inplace(char *seq, size_t n)
{
    for (size_t i = 0; i < n; i++)
        seq[i] = (char)CODE_TAB[(unsigned char)seq[i]];
}

/* Parse one full record without touching the Python API (GIL-free).
 * Returns 1 on record, 0 on EOF, -1 on IO error, -2 on OOM. On success
 * *header_out is malloc'd (caller frees); seq/qual are caller-owned
 * DynBufs. Sequence codes are encoded in place when self->codes. */
static int parse_record(ReaderObject *self, char **header_out,
                        size_t *header_len_out, DynBuf *seq, DynBuf *qual,
                        int *have_qual_out)
{
    DynBuf *line = &self->line;
    char *header = NULL;
    size_t header_len = 0;
    int rc;

    /* find the record header */
    if (self->pending) {
        header = self->pending;
        header_len = self->pending_len;
        self->pending = NULL;
    } else {
        for (;;) {
            rc = read_line(self, line);
            if (rc <= 0)
                return rc;
            if (line->len && (line->data[0] == '>' || line->data[0] == '@')) {
                header = malloc(line->len ? line->len : 1); /* drops marker */
                if (!header)
                    return -2;
                memcpy(header, line->data + 1, line->len - 1);
                header_len = line->len - 1;
                break;
            }
        }
    }

    /* read sequence lines until the next header or '+' */
    int next_is_plus = 0;
    for (;;) {
        rc = read_line(self, line);
        if (rc < 0)
            goto error;
        if (rc == 0)
            break;
        if (line->len &&
            (line->data[0] == '>' || line->data[0] == '@' ||
             line->data[0] == '+')) {
            if (line->data[0] == '+') {
                next_is_plus = 1;
            } else {
                self->pending = malloc(line->len);
                if (!self->pending) {
                    rc = -2;
                    goto error;
                }
                memcpy(self->pending, line->data + 1, line->len - 1);
                self->pending_len = line->len - 1;
            }
            break;
        }
        if (dyn_reserve(seq, line->len) < 0) {
            rc = -2;
            goto error;
        }
        memcpy(seq->data + seq->len, line->data, line->len);
        seq->len += line->len;
    }

    int have_qual = 0;
    if (next_is_plus) {
        /* FASTQ: read quality until it covers the sequence */
        while (qual->len < seq->len) {
            rc = read_line(self, line);
            if (rc < 0)
                goto error;
            if (rc == 0)
                break;
            if (dyn_reserve(qual, line->len) < 0) {
                rc = -2;
                goto error;
            }
            memcpy(qual->data + qual->len, line->data, line->len);
            qual->len += line->len;
        }
        have_qual = qual->len >= seq->len;
    }

    if (self->codes)
        encode_inplace(seq->data, seq->len);
    *header_out = header;
    *header_len_out = header_len;
    *have_qual_out = have_qual;
    return 1;

error:
    free(header);
    return rc;
}

static PyObject *Reader_iternext(ReaderObject *self)
{
    DynBuf seq = {0};
    DynBuf qual = {0};
    char *header = NULL;
    size_t header_len = 0;
    int have_qual = 0;
    int rc;

    Py_BEGIN_ALLOW_THREADS
    rc = parse_record(self, &header, &header_len, &seq, &qual, &have_qual);
    Py_END_ALLOW_THREADS

    if (rc <= 0) {
        dyn_free(&seq);
        dyn_free(&qual);
        if (rc == 0)
            PyErr_SetNone(PyExc_StopIteration);
        else if (rc == -2)
            PyErr_NoMemory();
        else
            PyErr_SetString(PyExc_IOError, "gzread failed");
        return NULL;
    }

    /* split header into name + comment */
    size_t sp = 0;
    while (sp < header_len && header[sp] != ' ' && header[sp] != '\t')
        sp++;
    PyObject *name = PyUnicode_DecodeASCII(header, sp, "replace");
    PyObject *comment;
    if (sp < header_len) {
        size_t cstart = sp;
        while (cstart < header_len &&
               (header[cstart] == ' ' || header[cstart] == '\t'))
            cstart++;
        comment = PyUnicode_DecodeASCII(header + cstart,
                                        header_len - cstart, "replace");
    } else {
        comment = Py_None;
        Py_INCREF(Py_None);
    }
    PyObject *payload = PyBytes_FromStringAndSize(seq.data, seq.len);
    PyObject *qual_obj;
    if (have_qual) {
        qual_obj = PyBytes_FromStringAndSize(qual.data, qual.len);
    } else {
        qual_obj = Py_None;
        Py_INCREF(Py_None);
    }
    PyObject *result = NULL;
    if (name && comment && payload && qual_obj)
        result = PyTuple_Pack(4, name, comment, payload, qual_obj);
    Py_XDECREF(name);
    Py_XDECREF(comment);
    Py_XDECREF(payload);
    Py_XDECREF(qual_obj);
    free(header);
    dyn_free(&seq);
    dyn_free(&qual);
    return result;
}

static PyTypeObject ReaderType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "ntlink_fastx.Reader",
    .tp_basicsize = sizeof(ReaderObject),
    .tp_dealloc = (destructor)Reader_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Streaming FASTA/FASTQ(.gz) reader",
    .tp_iter = PyObject_SelfIter,
    .tp_iternext = (iternextfunc)Reader_iternext,
    .tp_new = Reader_new,
};

/* pack_batch(rows: list[bytes of base codes], pad: int) -> bytes
 *
 * Builds a (len(rows), pad/4) 2-bit-packed matrix in one pass: row r's
 * codes occupy its first len(codes) bases, the rest is A(0) padding. pad
 * must be a multiple of 4. Bases > 3 are masked to 0 (callers route
 * N-containing reads elsewhere). */
static PyObject *py_pack_batch(PyObject *self, PyObject *args)
{
    PyObject *rows;
    Py_ssize_t pad;
    if (!PyArg_ParseTuple(args, "On", &rows, &pad))
        return NULL;
    if (pad % 4 != 0) {
        PyErr_SetString(PyExc_ValueError, "pad must be a multiple of 4");
        return NULL;
    }
    Py_ssize_t nrows = PySequence_Length(rows);
    if (nrows < 0)
        return NULL;
    Py_ssize_t stride = pad / 4;
    PyObject *out = PyBytes_FromStringAndSize(NULL, nrows * stride);
    if (!out)
        return NULL;
    unsigned char *dst = (unsigned char *)PyBytes_AS_STRING(out);

    /* phase 1 (GIL held): pin every row's buffer */
    Py_buffer *views = PyMem_Malloc(sizeof(Py_buffer) * (nrows ? nrows : 1));
    if (!views) {
        Py_DECREF(out);
        return PyErr_NoMemory();
    }
    Py_ssize_t got = 0;
    for (; got < nrows; got++) {
        PyObject *item = PySequence_GetItem(rows, got);
        if (!item)
            goto fail;
        int rc = PyObject_GetBuffer(item, &views[got], PyBUF_SIMPLE);
        Py_DECREF(item);
        if (rc < 0)
            goto fail;
    }

    /* phase 2 (GIL released): the packing loop itself */
    Py_BEGIN_ALLOW_THREADS
    memset(dst, 0, (size_t)(nrows * stride));
    for (Py_ssize_t r = 0; r < nrows; r++) {
        const unsigned char *src = views[r].buf;
        Py_ssize_t n = views[r].len < pad ? views[r].len : pad;
        unsigned char *row_dst = dst + r * stride;
        Py_ssize_t full = n / 4;
        for (Py_ssize_t i = 0; i < full; i++) {
            const unsigned char *s = src + 4 * i;
            row_dst[i] = (unsigned char)(((s[0] & 3)) | ((s[1] & 3) << 2) |
                                         ((s[2] & 3) << 4) | ((s[3] & 3) << 6));
        }
        for (Py_ssize_t b = full * 4; b < n; b++)
            row_dst[b / 4] |= (unsigned char)((src[b] & 3) << (2 * (b % 4)));
    }
    Py_END_ALLOW_THREADS

    for (Py_ssize_t r = 0; r < nrows; r++)
        PyBuffer_Release(&views[r]);
    PyMem_Free(views);
    return out;

fail:
    for (Py_ssize_t r = 0; r < got; r++)
        PyBuffer_Release(&views[r]);
    PyMem_Free(views);
    Py_DECREF(out);
    return NULL;
}

/* u64 -> decimal into p, returns new p (no terminator) */
static char *fmt_u64(char *p, unsigned long long v)
{
    char tmp[20];
    int n = 0;
    do {
        tmp[n++] = (char)('0' + (v % 10));
        v /= 10;
    } while (v);
    while (n)
        *p++ = tmp[--n];
    return p;
}

/* render_minimizers(hashes u64 buf, positions i64 buf, forward u8 buf | None,
 *                   n) -> bytes
 *
 * The indexlr TSV body "hash:pos[:strand] hash:pos[:strand] ..." rendered in
 * one GIL-released pass (the reference emits this per sequence via indexlr;
 * Python string formatting is ~30x slower at assembly scale). forward=None
 * omits the strand column (overlap dialect). */
static PyObject *py_render_minimizers(PyObject *self, PyObject *args)
{
    Py_buffer h_v, p_v;
    PyObject *fwd_obj;
    Py_ssize_t n;
    if (!PyArg_ParseTuple(args, "y*y*On", &h_v, &p_v, &fwd_obj, &n))
        return NULL;
    Py_buffer f_v;
    int with_strand = fwd_obj != Py_None;
    if (with_strand && PyObject_GetBuffer(fwd_obj, &f_v, PyBUF_SIMPLE) < 0) {
        PyBuffer_Release(&h_v);
        PyBuffer_Release(&p_v);
        return NULL;
    }
    /* worst case per token: 20 (hash) + 1 + 19 (pos) + 2 (strand) + 1 sep */
    PyObject *out = PyBytes_FromStringAndSize(NULL, n ? n * 44 : 1);
    if (!out)
        goto fail;
    {
        char *base = PyBytes_AS_STRING(out);
        char *p = base;
        const unsigned long long *hs = h_v.buf;
        const long long *ps = p_v.buf;
        const unsigned char *fs = with_strand ? f_v.buf : NULL;
        Py_BEGIN_ALLOW_THREADS
        for (Py_ssize_t i = 0; i < n; i++) {
            if (i)
                *p++ = ' ';
            p = fmt_u64(p, hs[i]);
            *p++ = ':';
            p = fmt_u64(p, (unsigned long long)ps[i]);
            if (fs) {
                *p++ = ':';
                *p++ = fs[i] ? '+' : '-';
            }
        }
        Py_END_ALLOW_THREADS
        if (_PyBytes_Resize(&out, p - base) < 0)
            goto fail;
    }
    if (with_strand)
        PyBuffer_Release(&f_v);
    PyBuffer_Release(&h_v);
    PyBuffer_Release(&p_v);
    return out;

fail:
    if (with_strand)
        PyBuffer_Release(&f_v);
    PyBuffer_Release(&h_v);
    PyBuffer_Release(&p_v);
    Py_XDECREF(out);
    return NULL;
}

static PyMethodDef fastx_methods[] = {
    {"pack_batch", py_pack_batch, METH_VARARGS,
     "pack_batch(rows, pad) -> packed bytes matrix"},
    {"render_minimizers", py_render_minimizers, METH_VARARGS,
     "render_minimizers(hashes_u64, positions_i64, forward_u8|None, n) -> "
     "TSV body bytes"},
    {NULL, NULL, 0, NULL},
};

static PyModuleDef fastx_module = {
    PyModuleDef_HEAD_INIT,
    .m_name = "ntlink_fastx",
    .m_doc = "Native FASTA/FASTQ streaming + 2-bit encoding",
    .m_size = -1,
    .m_methods = fastx_methods,
};

PyMODINIT_FUNC PyInit_ntlink_fastx(void)
{
    memset(CODE_TAB, 4, sizeof(CODE_TAB));
    CODE_TAB['A'] = CODE_TAB['a'] = 0;
    CODE_TAB['C'] = CODE_TAB['c'] = 1;
    CODE_TAB['G'] = CODE_TAB['g'] = 2;
    CODE_TAB['T'] = CODE_TAB['t'] = 3;

    if (PyType_Ready(&ReaderType) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&fastx_module);
    if (!m)
        return NULL;
    Py_INCREF(&ReaderType);
    if (PyModule_AddObject(m, "Reader", (PyObject *)&ReaderType) < 0) {
        Py_DECREF(&ReaderType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
