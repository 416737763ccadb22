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
 *   Reader.read_block(max_bases, max_records)   (codes=True only)
 *     the next records, up to the first that brings their bases to
 *     max_bases or their count to max_records, as (names: list[str],
 *     codes: bytes back to back, offsets: bytes of int64 (n + 1),
 *     has_n: bytes of one 0/1 per record, 1 where a code is above 3);
 *     None at the end of the file. Quality is parsed by length alone.
 *
 * The whole record parse — zlib inflate, line splitting, 2-bit encoding —
 * runs with the GIL RELEASED (the reference gets the same effect from
 * pigz -p + a separate indexlr process; ntLink:112-117,221-225). Only the
 * final Python object construction holds the GIL, so reader threads
 * decompress genuinely in parallel with host-side chaining/tally work; a
 * block takes the GIL once for all of its records.
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
    /* scratch, reused across records and blocks */
    DynBuf line;
    DynBuf seq;
    DynBuf qual;
    /* read_block's block: codes, names, int64 code and name offsets,
     * has-N flags */
    DynBuf blk_codes;
    DynBuf blk_names;
    DynBuf blk_offs;
    DynBuf blk_noffs;
    DynBuf blk_hasn;
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

/* Append the next line (without trailing newline) to out, or only count
 * it where out is NULL; *len_out is its length. Returns 1 on line read, 0
 * on EOF, negative code on error. */
static int next_line(ReaderObject *self, DynBuf *out, size_t *len_out)
{
    size_t n = 0;
    int got_any = 0;
    for (;;) {
        if (self->buf_pos >= self->buf_len) {
            if (fill_buffer(self) < 0)
                return -1;
            if (self->buf_len == 0) {
                *len_out = n;
                return got_any ? 1 : 0;
            }
        }
        unsigned char *start = self->buf + self->buf_pos;
        size_t avail = self->buf_len - self->buf_pos;
        unsigned char *nl = memchr(start, '\n', avail);
        size_t span = nl ? (size_t)(nl - start) : avail;
        if (span && out) {
            if (dyn_reserve(out, span) < 0)
                return -2;
            memcpy(out->data + out->len, start, span);
            out->len += span;
        }
        n += span;
        got_any = 1;
        if (nl) {
            self->buf_pos += span + 1;
            *len_out = n;
            return 1;
        }
        self->buf_pos += span;
    }
}

/* The next line (without trailing newline) in out, from its start. */
static int read_line(ReaderObject *self, DynBuf *out)
{
    size_t n;
    out->len = 0;
    return next_line(self, out, &n);
}

/* -- Reader type -------------------------------------------------------- */

static void Reader_dealloc(ReaderObject *self)
{
    if (self->gz)
        gzclose(self->gz);
    free(self->buf);
    free(self->pending);
    dyn_free(&self->line);
    dyn_free(&self->seq);
    dyn_free(&self->qual);
    dyn_free(&self->blk_codes);
    dyn_free(&self->blk_names);
    dyn_free(&self->blk_offs);
    dyn_free(&self->blk_noffs);
    dyn_free(&self->blk_hasn);
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
    /* tp_alloc zeroes the object: every DynBuf starts empty */
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

/* Encode seq[0:n] in place; nonzero where a code is above 3 (not ACGT). */
static int encode_inplace(char *seq, size_t n)
{
    unsigned char bad = 0;
    for (size_t i = 0; i < n; i++) {
        unsigned char c = CODE_TAB[(unsigned char)seq[i]];
        seq[i] = (char)c;
        bad |= c;
    }
    return (bad & 4) != 0;
}

/* Parse one full record without touching the Python API (GIL-free).
 * Returns 1 on record, 0 on EOF, -1 on IO error, -2 on OOM. On success
 * *header_out is malloc'd (caller frees). The sequence is appended to
 * `seq` from seq->len on (encoded in place when self->codes, and
 * *has_n_out set where a code is above 3); the quality is appended to
 * `qual`, or only its length counted where qual is NULL. Where the record
 * fails, seq keeps its length from before. */
static int parse_record(ReaderObject *self, char **header_out,
                        size_t *header_len_out, DynBuf *seq, DynBuf *qual,
                        int *have_qual_out, int *has_n_out)
{
    DynBuf *line = &self->line;
    char *header = NULL;
    size_t header_len = 0;
    size_t seq0 = seq->len;
    size_t n;
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

    /* sequence lines, each straight into seq, until the next header or
     * '+' (which is taken back out of seq) */
    int next_is_plus = 0;
    for (;;) {
        size_t at = seq->len;
        rc = next_line(self, seq, &n);
        if (rc < 0)
            goto error;
        if (rc == 0)
            break;
        char c0 = n ? seq->data[at] : 0;
        if (c0 == '>' || c0 == '@' || c0 == '+') {
            if (c0 == '+') {
                next_is_plus = 1;
            } else {
                self->pending = malloc(n);
                if (!self->pending) {
                    rc = -2;
                    goto error;
                }
                memcpy(self->pending, seq->data + at + 1, n - 1);
                self->pending_len = n - 1;
            }
            seq->len = at;
            break;
        }
    }
    size_t seq_len = seq->len - seq0;

    int have_qual = 0;
    if (next_is_plus) {
        /* FASTQ: read quality until it covers the sequence */
        size_t qlen = 0;
        while (qlen < seq_len) {
            rc = next_line(self, qual, &n);
            if (rc < 0)
                goto error;
            if (rc == 0)
                break;
            qlen += n;
        }
        have_qual = qlen >= seq_len;
    }

    int has_n = 0;
    if (self->codes)
        has_n = encode_inplace(seq->data + seq0, seq_len);
    *header_out = header;
    *header_len_out = header_len;
    *have_qual_out = have_qual;
    *has_n_out = has_n;
    return 1;

error:
    seq->len = seq0;
    free(header);
    return rc;
}

static PyObject *Reader_iternext(ReaderObject *self)
{
    DynBuf *seq = &self->seq;
    DynBuf *qual = &self->qual;
    char *header = NULL;
    size_t header_len = 0;
    int have_qual = 0, has_n = 0;
    int rc;

    seq->len = qual->len = 0;
    Py_BEGIN_ALLOW_THREADS
    rc = parse_record(self, &header, &header_len, seq, qual, &have_qual,
                      &has_n);
    Py_END_ALLOW_THREADS

    if (rc <= 0) {
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
    PyObject *payload = PyBytes_FromStringAndSize(seq->data, seq->len);
    PyObject *qual_obj;
    if (have_qual) {
        qual_obj = PyBytes_FromStringAndSize(qual->data, qual->len);
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
    return result;
}

static int dyn_put_i64(DynBuf *b, int64_t v)
{
    if (dyn_reserve(b, sizeof v) < 0)
        return -2;
    memcpy(b->data + b->len, &v, sizeof v);
    b->len += sizeof v;
    return 0;
}

/* read_block's parse (GIL-free): records into the block buffers until
 * their bases reach max_bases or their count max_records. Returns 0 with
 * *n_out records (0 at the end of the file), or a negative code. */
static int parse_block(ReaderObject *self, size_t max_bases,
                       size_t max_records, size_t *n_out)
{
    DynBuf *codes = &self->blk_codes, *names = &self->blk_names;
    size_t n = 0;
    codes->len = names->len = self->blk_offs.len = self->blk_noffs.len =
        self->blk_hasn.len = 0;
    if (dyn_put_i64(&self->blk_offs, 0) < 0 ||
        dyn_put_i64(&self->blk_noffs, 0) < 0)
        return -2;
    while (n < max_records && codes->len < max_bases) {
        char *header = NULL;
        size_t header_len = 0;
        int have_qual, has_n;
        int rc = parse_record(self, &header, &header_len, codes, NULL,
                              &have_qual, &has_n);
        if (rc < 0)
            return rc;
        if (rc == 0)
            break;
        size_t sp = 0;
        while (sp < header_len && header[sp] != ' ' && header[sp] != '\t')
            sp++;
        rc = dyn_reserve(names, sp ? sp : 1);
        if (rc == 0) {
            memcpy(names->data + names->len, header, sp);
            names->len += sp;
        }
        free(header);
        if (rc < 0 || dyn_reserve(&self->blk_hasn, 1) < 0 ||
            dyn_put_i64(&self->blk_offs, (int64_t)codes->len) < 0 ||
            dyn_put_i64(&self->blk_noffs, (int64_t)names->len) < 0)
            return -2;
        self->blk_hasn.data[self->blk_hasn.len++] = (char)(has_n != 0);
        n++;
    }
    *n_out = n;
    return 0;
}

static PyObject *Reader_read_block(ReaderObject *self, PyObject *args)
{
    Py_ssize_t max_bases, max_records;
    if (!PyArg_ParseTuple(args, "nn", &max_bases, &max_records))
        return NULL;
    if (!self->codes) {
        PyErr_SetString(PyExc_ValueError, "read_block needs codes=True");
        return NULL;
    }
    if (max_bases < 1 || max_records < 1) {
        PyErr_SetString(PyExc_ValueError,
                        "max_bases and max_records must be positive");
        return NULL;
    }
    size_t n = 0;
    int rc;
    Py_BEGIN_ALLOW_THREADS
    rc = parse_block(self, (size_t)max_bases, (size_t)max_records, &n);
    Py_END_ALLOW_THREADS
    if (rc < 0) {
        if (rc == -2)
            PyErr_NoMemory();
        else
            PyErr_SetString(PyExc_IOError, "gzread failed");
        return NULL;
    }
    if (n == 0)
        Py_RETURN_NONE;

    const int64_t *noffs = (const int64_t *)self->blk_noffs.data;
    PyObject *names = PyList_New((Py_ssize_t)n);
    if (!names)
        return NULL;
    for (size_t i = 0; i < n; i++) {
        PyObject *name = PyUnicode_DecodeASCII(
            self->blk_names.data + noffs[i], noffs[i + 1] - noffs[i],
            "replace");
        if (!name) {
            Py_DECREF(names);
            return NULL;
        }
        PyList_SET_ITEM(names, (Py_ssize_t)i, name);
    }
    PyObject *codes = PyBytes_FromStringAndSize(self->blk_codes.data,
                                                self->blk_codes.len);
    PyObject *offs = PyBytes_FromStringAndSize(self->blk_offs.data,
                                               self->blk_offs.len);
    PyObject *has_n = PyBytes_FromStringAndSize(self->blk_hasn.data,
                                                self->blk_hasn.len);
    PyObject *result = NULL;
    if (codes && offs && has_n)
        result = PyTuple_Pack(4, names, codes, offs, has_n);
    Py_DECREF(names);
    Py_XDECREF(codes);
    Py_XDECREF(offs);
    Py_XDECREF(has_n);
    return result;
}

static PyMethodDef reader_methods[] = {
    {"read_block", (PyCFunction)Reader_read_block, METH_VARARGS,
     "read_block(max_bases, max_records) -> (names, codes, offsets, has_n) "
     "or None at the end"},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject ReaderType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "ntlink_fastx.Reader",
    .tp_basicsize = sizeof(ReaderObject),
    .tp_dealloc = (destructor)Reader_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Streaming FASTA/FASTQ(.gz) reader",
    .tp_iter = PyObject_SelfIter,
    .tp_iternext = (iternextfunc)Reader_iternext,
    .tp_methods = reader_methods,
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
