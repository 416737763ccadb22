/* ntlink_chain — native anchor chaining + verbose formatting.
 *
 * Exact C implementation of the chaining acceptance semantics
 * (mapping.chain_read_hits; reference ntlink_utils.py:200-294):
 *   z filter -> noisy-span filter -> consecutive runs -> subsume marking
 *   (specific | sensitive) -> merge adjacent same-contig runs,
 * plus the verbose_mapping line rendering, so the mapping hot loop touches
 * each anchor zero times in Python.
 *
 * API:
 *   Chainer(contig_lengths: int32 buffer, names: list[str])
 *     .chain(cids, cpos, rpos, sbits: int32 buffers, n, read_len, k, z, x,
 *            sensitive, read_name or None)
 *       -> (runs, verbose_bytes | None)
 *     .chain_batch(cids, cpos, rpos, sbits: int32 buffers (anchors for all
 *            reads, concatenated), offsets: int64 buffer (n_reads+1),
 *            read_lens: int32 buffer, read_names: list[str] | None,
 *            k, z, sensitive, x[, mode])
 *       -> (runs_bytes, run_offsets_bytes, verbose_bytes | None,
 *           paf_bytes | None)
 *     chain_batch handles the whole drained device batch in one call with
 *     the GIL released, rendering the verbose lines straight into the
 *     bytes object it returns (allocated at the group's upper bound and
 *     shrunk to fit); runs_bytes is int32[n_runs][8] rows
 *     (cid, hit_count, first_cpos, first_rpos, first_bits,
 *      last_cpos, last_rpos, last_bits), run_offsets_bytes is
 *     int32[n_reads+1] prefix offsets into those rows. mode bit 0 requests
 *     verbose rendering, bit 1 PAF rendering (exact contract of paf.py /
 *     reference ntlink_paf_output.py); default mode renders verbose iff
 *     read_names is a list. Rendering requires read_names.
 *   runs (per-read form): list of the same 8 fields as tuples.
 *   sbits: bit0 = contig strand is '+', bit1 = read strand is '+'.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    PyObject_HEAD
    int32_t *clen;
    Py_ssize_t n_contigs;
    PyObject *names;       /* list of str (owned) */
    const char **name_ptr; /* cached UTF-8 pointers into names */
    int32_t *name_len;     /* bytes before the first NUL, as %s prints */
    int32_t max_name_len;
    Py_buffer clen_view;
} ChainerObject;

static void Chainer_dealloc(ChainerObject *self)
{
    if (self->clen_view.obj)
        PyBuffer_Release(&self->clen_view);
    PyMem_Free(self->name_ptr);
    PyMem_Free(self->name_len);
    Py_XDECREF(self->names);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *Chainer_new(PyTypeObject *type, PyObject *args, PyObject *kwds)
{
    PyObject *clen_obj, *names;
    if (!PyArg_ParseTuple(args, "OO", &clen_obj, &names))
        return NULL;
    if (!PyList_Check(names)) {
        PyErr_SetString(PyExc_TypeError, "names must be a list");
        return NULL;
    }
    ChainerObject *self = (ChainerObject *)type->tp_alloc(type, 0);
    if (!self)
        return NULL;
    memset(&self->clen_view, 0, sizeof(self->clen_view));
    self->name_ptr = NULL;
    self->name_len = NULL;
    self->max_name_len = 0;
    if (PyObject_GetBuffer(clen_obj, &self->clen_view, PyBUF_SIMPLE) < 0) {
        Py_DECREF(self);
        return NULL;
    }
    self->clen = (int32_t *)self->clen_view.buf;
    self->n_contigs = self->clen_view.len / 4;
    Py_INCREF(names);
    self->names = names;
    /* cache UTF-8 pointers so the hot path never touches Python objects;
     * PyUnicode_AsUTF8 interns the byte form inside the (owned) str */
    Py_ssize_t nn = PyList_GET_SIZE(names);
    self->name_ptr = PyMem_Malloc(sizeof(char *) * (nn ? nn : 1));
    self->name_len = PyMem_Malloc(sizeof(int32_t) * (nn ? nn : 1));
    if (!self->name_ptr || !self->name_len) {
        Py_DECREF(self);
        return PyErr_NoMemory();
    }
    for (Py_ssize_t i = 0; i < nn; i++) {
        Py_ssize_t blen;
        const char *s =
            PyUnicode_AsUTF8AndSize(PyList_GET_ITEM(names, i), &blen);
        if (!s) {
            Py_DECREF(self);
            return NULL;
        }
        self->name_ptr[i] = s;
        self->name_len[i] = (int32_t)strnlen(s, (size_t)blen);
        if (self->name_len[i] > self->max_name_len)
            self->max_name_len = self->name_len[i];
    }
    return (PyObject *)self;
}

typedef struct {
    int32_t cid;
    int32_t start; /* index into kept[] */
    int32_t end;   /* exclusive */
    int subsumed;
} Run;

/* sortable (ctg_pos, read_pos) key for PAF block ordering */
typedef struct {
    int32_t cpos;
    int32_t rpos;
    int32_t idx; /* tiebreak = stability */
} PafKey;

/* per-call scratch sized for the largest read in the batch */
typedef struct {
    int32_t *kept;
    Run *runs;
    int32_t *final_idx;
    Run *final_runs;
    int32_t *distinct, *mn, *mx, *mn_r, *mx_r, *cnt;
    PafKey *pkeys, *pkeys2;
    int32_t *paux; /* 5 lanes: ord, dsc, is_dup, trans, mark */
    Py_ssize_t cap;
} Scratch;

static int scratch_reserve(Scratch *s, Py_ssize_t n)
{
    if (n <= s->cap)
        return 0;
    Py_ssize_t c = s->cap ? s->cap : 64;
    while (c < n)
        c *= 2;
    int32_t *k2 = realloc(s->kept, sizeof(int32_t) * c);
    Run *r2 = realloc(s->runs, sizeof(Run) * c);
    int32_t *f2 = realloc(s->final_idx, sizeof(int32_t) * c);
    Run *fr2 = realloc(s->final_runs, sizeof(Run) * c);
    int32_t *d2 = realloc(s->distinct, sizeof(int32_t) * c * 6);
    PafKey *p2 = realloc(s->pkeys, sizeof(PafKey) * c);
    PafKey *p3 = realloc(s->pkeys2, sizeof(PafKey) * c);
    int32_t *a2 = realloc(s->paux, sizeof(int32_t) * c * 5);
    if (!k2 || !r2 || !f2 || !fr2 || !d2 || !p2 || !p3 || !a2) {
        /* keep old pointers for the free path */
        if (k2) s->kept = k2;
        if (r2) s->runs = r2;
        if (f2) s->final_idx = f2;
        if (fr2) s->final_runs = fr2;
        if (d2) s->distinct = d2;
        if (p2) s->pkeys = p2;
        if (p3) s->pkeys2 = p3;
        if (a2) s->paux = a2;
        return -1;
    }
    s->kept = k2;
    s->runs = r2;
    s->final_idx = f2;
    s->final_runs = fr2;
    s->distinct = d2;
    s->mn = d2 + c;
    s->mx = d2 + 2 * c;
    s->mn_r = d2 + 3 * c;
    s->mx_r = d2 + 4 * c;
    s->cnt = d2 + 5 * c;
    s->pkeys = p2;
    s->pkeys2 = p3;
    s->paux = a2;
    s->cap = c;
    return 0;
}

static void scratch_free(Scratch *s)
{
    free(s->kept);
    free(s->runs);
    free(s->final_idx);
    free(s->final_runs);
    free(s->distinct);
    free(s->pkeys);
    free(s->pkeys2);
    free(s->paux);
    memset(s, 0, sizeof(*s));
}

/* Core chaining for one read over scratch buffers (pre-reserved >= n).
 * Fills s->final_runs / s->final_idx; returns n_final. */
static Py_ssize_t chain_core(const ChainerObject *self, const int32_t *cids,
                             const int32_t *cpos, const int32_t *rpos,
                             const int32_t *sbits, Py_ssize_t n, long read_len,
                             long k, long z, int sensitive, double x,
                             Scratch *s)
{
    int32_t *kept = s->kept;
    Run *runs = s->runs;
    int32_t *final_idx = s->final_idx;
    Run *final_runs = s->final_runs;

    /* 1. z filter */
    Py_ssize_t n_kept = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        int32_t c = cids[i];
        if (c >= 0 && c < self->n_contigs && self->clen[c] >= z)
            kept[n_kept++] = (int32_t)i;
    }

    /* 2. noisy-span filter: per contig, first-occurrence min/max of cpos */
    {
        int32_t *distinct = s->distinct;
        int32_t *mn = s->mn, *mx = s->mx, *mn_r = s->mn_r, *mx_r = s->mx_r,
                *cnt = s->cnt;
        Py_ssize_t n_distinct = 0;
        for (Py_ssize_t ki = 0; ki < n_kept; ki++) {
            int32_t c = cids[kept[ki]];
            Py_ssize_t d;
            for (d = 0; d < n_distinct; d++)
                if (distinct[d] == c)
                    break;
            if (d == n_distinct) {
                distinct[n_distinct] = c;
                mn[n_distinct] = mx[n_distinct] = cpos[kept[ki]];
                mn_r[n_distinct] = mx_r[n_distinct] = rpos[kept[ki]];
                cnt[n_distinct] = 1;
                n_distinct++;
            } else {
                cnt[d]++;
                if (cpos[kept[ki]] < mn[d]) {
                    mn[d] = cpos[kept[ki]];
                    mn_r[d] = rpos[kept[ki]];
                }
                if (cpos[kept[ki]] > mx[d]) {
                    mx[d] = cpos[kept[ki]];
                    mx_r[d] = rpos[kept[ki]];
                }
            }
        }
        for (Py_ssize_t d = 0; d < n_distinct; d++) {
            if (cnt[d] < 2)
                continue;
            long span = (long)mx[d] - (long)mn[d];
            if (span < 0)
                span = -span;
            int noisy;
            if (x == 0.0) {
                noisy = span > read_len + k;
            } else {
                long rspan = (long)mx_r[d] - (long)mn_r[d];
                if (rspan < 0)
                    rspan = -rspan;
                double threshold = x * (double)rspan + (double)k;
                double cap = (double)(read_len + k);
                if (threshold > cap)
                    threshold = cap;
                noisy = (double)span > threshold;
            }
            if (noisy) {
                Py_ssize_t w = 0;
                for (Py_ssize_t ki = 0; ki < n_kept; ki++)
                    if (cids[kept[ki]] != distinct[d])
                        kept[w++] = kept[ki];
                n_kept = w;
            }
        }
    }

    /* 3. consecutive runs */
    Py_ssize_t n_runs = 0;
    for (Py_ssize_t ki = 0; ki < n_kept; ki++) {
        int32_t c = cids[kept[ki]];
        if (n_runs && runs[n_runs - 1].cid == c) {
            runs[n_runs - 1].end = (int32_t)(ki + 1);
        } else {
            runs[n_runs].cid = c;
            runs[n_runs].start = (int32_t)ki;
            runs[n_runs].end = (int32_t)(ki + 1);
            runs[n_runs].subsumed = 0;
            n_runs++;
        }
    }

    /* 4. subsume marking */
    if (sensitive) {
        /* mark runs strictly between consecutive sightings of a contig */
        for (Py_ssize_t i = 0; i < n_runs; i++) {
            for (Py_ssize_t j = i + 1; j < n_runs; j++) {
                if (runs[j].cid == runs[i].cid) {
                    for (Py_ssize_t m = i + 1; m < j; m++)
                        runs[m].subsumed = 1;
                    break; /* consecutive pair (i, j); next pair starts at j */
                }
            }
        }
    } else {
        /* specific: contigs nested between repeat sightings are fully out */
        for (Py_ssize_t i = 0; i < n_runs; i++) {
            Py_ssize_t first = -1;
            for (Py_ssize_t j = 0; j < i; j++) {
                if (runs[j].cid == runs[i].cid) {
                    first = j;
                    break;
                }
            }
            if (first >= 0) {
                for (Py_ssize_t m = first + 1; m < i; m++) {
                    int32_t doomed = runs[m].cid;
                    for (Py_ssize_t q = 0; q < n_runs; q++)
                        if (runs[q].cid == doomed)
                            runs[q].subsumed = 1;
                }
            }
        }
    }

    /* 5. drop subsumed, merge adjacent same-contig runs (rebuild indices) */
    Py_ssize_t n_final = 0;
    Py_ssize_t out_pos = 0;
    for (Py_ssize_t i = 0; i < n_runs; i++) {
        if (runs[i].subsumed)
            continue;
        if (n_final && final_runs[n_final - 1].cid == runs[i].cid) {
            for (int32_t ki = runs[i].start; ki < runs[i].end; ki++)
                final_idx[out_pos++] = kept[ki];
            final_runs[n_final - 1].end = (int32_t)out_pos;
        } else {
            final_runs[n_final].cid = runs[i].cid;
            final_runs[n_final].start = (int32_t)out_pos;
            for (int32_t ki = runs[i].start; ki < runs[i].end; ki++)
                final_idx[out_pos++] = kept[ki];
            final_runs[n_final].end = (int32_t)out_pos;
            n_final++;
        }
    }
    return n_final;
}

/* Pre-chained core: the anchors already passed z/noisy/subsume upstream
 * (on-device chaining, mesh.chain_anchors_device, or a pre-selected host
 * payload) — every anchor is kept, in final order; final runs are just
 * maximal consecutive same-cid groups. */
static Py_ssize_t chain_core_prechained(const int32_t *cids, Py_ssize_t n,
                                        Scratch *s)
{
    int32_t *final_idx = s->final_idx;
    Run *final_runs = s->final_runs;
    Py_ssize_t n_final = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        final_idx[i] = (int32_t)i;
        int32_t c = cids[i];
        if (n_final && final_runs[n_final - 1].cid == c) {
            final_runs[n_final - 1].end = (int32_t)(i + 1);
        } else {
            final_runs[n_final].cid = c;
            final_runs[n_final].start = (int32_t)i;
            final_runs[n_final].end = (int32_t)(i + 1);
            final_runs[n_final].subsumed = 0;
            n_final++;
        }
    }
    return n_final;
}

/* growable byte buffer for PAF rendering */
typedef struct {
    char *buf;
    size_t len, cap;
} ByteBuf;

static int bb_reserve(ByteBuf *b, size_t extra)
{
    if (b->len + extra <= b->cap)
        return 0;
    size_t c = b->cap ? b->cap : 4096;
    while (c < b->len + extra)
        c *= 2;
    char *p = realloc(b->buf, c);
    if (!p)
        return -1;
    b->buf = p;
    b->cap = c;
    return 0;
}

/* Verbose rendering without printf: names are copied by length and
 * integers are written two decimal digits per step from DIGIT_PAIRS. The
 * bytes are exactly those of "%s\t%s\t%d\t" per run and "%d:%c_%d:%c"
 * per anchor. */
static const char DIGIT_PAIRS[201] =
    "00010203040506070809101112131415161718192021222324252627282930313233"
    "34353637383940414243444546474849505152535455565758596061626364656667"
    "6869707172737475767778798081828384858687888990919293949596979899";

/* most bytes one run's header ("\t" x 3 and a count of <= 10 digits) and
 * one anchor ("-2147483648:+_-2147483648:- ") take besides the names */
#define VERBOSE_RUN_BYTES 13
#define VERBOSE_ANCHOR_BYTES 28

static inline char *put_u32(char *p, uint32_t v)
{
    int n = v < 10u           ? 1
            : v < 100u        ? 2
            : v < 1000u       ? 3
            : v < 10000u      ? 4
            : v < 100000u     ? 5
            : v < 1000000u    ? 6
            : v < 10000000u   ? 7
            : v < 100000000u  ? 8
            : v < 1000000000u ? 9
                              : 10;
    char *q = p + n;
    while (v >= 100u) {
        uint32_t r = v % 100u;
        v /= 100u;
        q -= 2;
        memcpy(q, DIGIT_PAIRS + 2 * r, 2);
    }
    if (v >= 10u)
        memcpy(q - 2, DIGIT_PAIRS + 2 * v, 2);
    else
        q[-1] = (char)('0' + v);
    return p + n;
}

static inline char *put_i32(char *p, int32_t x)
{
    uint32_t v = (uint32_t)x;
    if (x < 0) {
        *p++ = '-';
        v = 0u - v; /* INT32_MIN's magnitude fits in uint32 */
    }
    return put_u32(p, v);
}

/* Most bytes render_verbose writes for a read of n anchors on contigs
 * cids: its final runs keep the anchors' order, so there are no more of
 * them than runs of equal ids among the anchors. */
static size_t verbose_bound(const ChainerObject *self, const int32_t *cids,
                            Py_ssize_t n, Py_ssize_t rname_len)
{
    if (n == 0)
        return 0;
    size_t runs = 1;
    for (Py_ssize_t j = 1; j < n; j++)
        runs += cids[j] != cids[j - 1];
    return runs * ((size_t)rname_len + (size_t)self->max_name_len +
                   VERBOSE_RUN_BYTES) +
           (size_t)VERBOSE_ANCHOR_BYTES * (size_t)n;
}

/* Render one read's verbose lines at p, which has room for verbose_bound's
 * bytes; rname_len stops at the name's first NUL, as %s does. Returns the
 * end of what was written. */
static char *render_verbose(const ChainerObject *self, char *p,
                            const char *rname, Py_ssize_t rname_len,
                            Py_ssize_t n_final, const Run *final_runs,
                            const int32_t *final_idx, const int32_t *cpos,
                            const int32_t *rpos, const int32_t *sbits)
{
    for (Py_ssize_t i = 0; i < n_final; i++) {
        int32_t cid = final_runs[i].cid;
        memcpy(p, rname, (size_t)rname_len);
        p += rname_len;
        *p++ = '\t';
        memcpy(p, self->name_ptr[cid], (size_t)self->name_len[cid]);
        p += self->name_len[cid];
        *p++ = '\t';
        p = put_i32(p, final_runs[i].end - final_runs[i].start);
        *p++ = '\t';
        for (int32_t ki = final_runs[i].start; ki < final_runs[i].end; ki++) {
            int32_t h = final_idx[ki];
            p = put_i32(p, cpos[h]);
            p[0] = ':';
            p[1] = (sbits[h] & 1) ? '+' : '-';
            p[2] = '_';
            p = put_i32(p + 3, rpos[h]);
            p[0] = ':';
            p[1] = (sbits[h] & 2) ? '+' : '-';
            p[2] = (ki + 1 < final_runs[i].end) ? ' ' : '\n';
            p += 3;
        }
    }
    return p;
}

static int pafkey_asc(const void *a, const void *b)
{
    const PafKey *x = a, *y = b;
    if (x->cpos != y->cpos)
        return x->cpos < y->cpos ? -1 : 1;
    if (x->rpos != y->rpos)
        return x->rpos < y->rpos ? -1 : 1;
    return x->idx < y->idx ? -1 : (x->idx > y->idx ? 1 : 0);
}

static int pafkey_desc(const void *a, const void *b)
{
    const PafKey *x = a, *y = b;
    if (x->cpos != y->cpos)
        return x->cpos > y->cpos ? -1 : 1;
    if (x->rpos != y->rpos)
        return x->rpos > y->rpos ? -1 : 1;
    return x->idx < y->idx ? -1 : (x->idx > y->idx ? 1 : 0);
}

/* One PAF line (12-col); bb capacity must be pre-reserved. */
static void paf_emit(const ChainerObject *self, ByteBuf *bb, const char *rname,
                     long read_len, long k, int32_t cid, int32_t ca,
                     int32_t cb, int32_t ra, int32_t rb, long cnt, long nsame)
{
    long ts = ca < cb ? ca : cb;
    long te = (ca > cb ? ca : cb) + k;
    long qs = ra < rb ? ra : rb;
    long qe = (ra > rb ? ra : rb) + k;
    /* majority-vote strand: n_same/len*100 >= 50  <=>  2*n_same >= len */
    char strand = (2 * nsame >= cnt) ? '+' : '-';
    char *p = bb->buf + bb->len;
    p += sprintf(p,
                 "%s\t%ld\t%ld\t%ld\t%c\t%s\t%d\t%ld\t%ld\t%ld\t%ld\t255\n",
                 rname, read_len, qs, qe, strand, self->name_ptr[cid],
                 (int)self->clen[cid], ts, te, cnt, te - ts);
    bb->len = p - bb->buf;
}

/* Render one read's PAF lines into bb — exact contract of paf.py
 * (reference ntlink_paf_output.py): per accepted run, stable-sort hits by
 * (ctg_pos, read_pos); monotonic runs render whole; otherwise split/repair
 * blocks at >=75% direction consistency or suppress. Returns 0 / -1. */
static int render_paf(const ChainerObject *self, ByteBuf *bb,
                      const char *rname, Py_ssize_t rname_len, long read_len,
                      long k, Py_ssize_t n_final, const Run *final_runs,
                      const int32_t *final_idx, const int32_t *cpos,
                      const int32_t *rpos, const int32_t *sbits, Scratch *s)
{
    int32_t *ord = s->paux;
    int32_t *is_dup = s->paux + 2 * s->cap;
    int32_t *trans = s->paux + 3 * s->cap;
    int32_t *mark = s->paux + 4 * s->cap; /* bit0 drop, bit1 break-before */

    for (Py_ssize_t ri = 0; ri < n_final; ri++) {
        const int32_t *hidx = final_idx + final_runs[ri].start;
        Py_ssize_t m = final_runs[ri].end - final_runs[ri].start;
        if (m <= 0)
            continue;
        if (bb_reserve(bb, (size_t)m *
                               (rname_len +
                                self->name_len[final_runs[ri].cid] + 200)) < 0)
            return -1;
        for (Py_ssize_t j = 0; j < m; j++) {
            s->pkeys[j].cpos = cpos[hidx[j]];
            s->pkeys[j].rpos = rpos[hidx[j]];
            s->pkeys[j].idx = (int32_t)j;
        }
        qsort(s->pkeys, m, sizeof(PafKey), pafkey_asc);
        for (Py_ssize_t t = 0; t < m; t++)
            ord[t] = s->pkeys[t].idx;

        /* hits already in ascending (or exactly descending) order -> one
         * block over the ascending order (paf.py paf_lines) */
        int asc_eq = 1, desc_eq = 0;
        for (Py_ssize_t t = 0; t < m && asc_eq; t++) {
            int32_t a = hidx[ord[t]], b = hidx[t];
            asc_eq = cpos[a] == cpos[b] && rpos[a] == rpos[b] &&
                     sbits[a] == sbits[b];
        }
        if (!asc_eq) {
            desc_eq = 1;
            for (Py_ssize_t t = 0; t < m; t++) {
                s->pkeys2[t].cpos = cpos[hidx[ord[t]]];
                s->pkeys2[t].rpos = rpos[hidx[ord[t]]];
                s->pkeys2[t].idx = (int32_t)t;
            }
            qsort(s->pkeys2, m, sizeof(PafKey), pafkey_desc);
            for (Py_ssize_t t = 0; t < m && desc_eq; t++) {
                int32_t a = hidx[ord[s->pkeys2[t].idx]], b = hidx[t];
                desc_eq = cpos[a] == cpos[b] && rpos[a] == rpos[b] &&
                          sbits[a] == sbits[b];
            }
        }

        int single = asc_eq || desc_eq;
        int suppressed = 0;
        if (!single) {
            /* split_mapping_blocks(ordered): dup ctg_pos values are
             * adjacent after the sort */
            for (Py_ssize_t t = 0; t < m; t++)
                is_dup[t] =
                    (t > 0 &&
                     cpos[hidx[ord[t]]] == cpos[hidx[ord[t - 1]]]) ||
                    (t + 1 < m &&
                     cpos[hidx[ord[t]]] == cpos[hidx[ord[t + 1]]]);
            Py_ssize_t denom = m - 1, n_incr = 0, n_decr = 0;
            for (Py_ssize_t t = 0; t < denom; t++) {
                int32_t a = rpos[hidx[ord[t]]], b = rpos[hidx[ord[t + 1]]];
                n_incr += a <= b;
                n_decr += a >= b;
            }
            if (n_incr == denom || n_decr == denom) {
                single = 1;
            } else {
                int increasing = 0;
                /* n/denom >= 0.75  <=>  4n >= 3*denom (exact int form) */
                if (4 * n_incr >= 3 * denom)
                    increasing = 1;
                else if (4 * (denom - n_incr) < 3 * denom)
                    suppressed = 1;
                if (!suppressed) {
#define PAF_CONS(i1, i2)                                                     \
    (is_dup[i1] || is_dup[i2] ||                                             \
     (increasing ? rpos[hidx[ord[i1]]] <= rpos[hidx[ord[i2]]]                \
                 : rpos[hidx[ord[i1]]] >= rpos[hidx[ord[i2]]]))
                    int any_mark = 0;
                    for (Py_ssize_t t = 0; t < denom; t++) {
                        int32_t a = rpos[hidx[ord[t]]],
                                b = rpos[hidx[ord[t + 1]]];
                        trans[t] = increasing ? (a <= b) : (a >= b);
                    }
                    for (Py_ssize_t t = 0; t < m; t++)
                        mark[t] = 0;
                    for (Py_ssize_t i = 0; i < denom; i++) {
                        if (trans[i])
                            continue;
                        if (is_dup[i] || is_dup[i + 1])
                            continue;
                        if (i + 2 >= denom)
                            mark[i + 1] |= 2;
                        else if (PAF_CONS(i, i + 2))
                            mark[i + 1] |= 1;
                        else if (i > 0 && PAF_CONS(i - 1, i + 1))
                            mark[i] |= 1;
                        else
                            mark[i + 1] |= 2;
                        any_mark = 1;
                    }
#undef PAF_CONS
                    if (!any_mark)
                        single = 1;
                }
            }
        }
        if (suppressed)
            continue;

        int32_t cid = final_runs[ri].cid;
        if (single) {
            long nsame = 0;
            for (Py_ssize_t t = 0; t < m; t++) {
                int32_t b = sbits[hidx[ord[t]]];
                nsame += ((b ^ (b >> 1)) & 1) == 0;
            }
            int32_t a = hidx[ord[0]], b = hidx[ord[m - 1]];
            paf_emit(self, bb, rname, read_len, k, cid, cpos[a], cpos[b],
                     rpos[a], rpos[b], (long)m, nsame);
        } else {
            Py_ssize_t first = -1, last = -1;
            long cnt = 0, nsame = 0;
            for (Py_ssize_t t = 0; t < m; t++) {
                if (mark[t] & 1)
                    continue;
                if ((mark[t] & 2) && cnt > 0) {
                    int32_t a = hidx[ord[first]], b = hidx[ord[last]];
                    paf_emit(self, bb, rname, read_len, k, cid, cpos[a],
                             cpos[b], rpos[a], rpos[b], cnt, nsame);
                    first = -1;
                    cnt = 0;
                    nsame = 0;
                }
                if (first < 0)
                    first = t;
                last = t;
                cnt++;
                int32_t b = sbits[hidx[ord[t]]];
                nsame += ((b ^ (b >> 1)) & 1) == 0;
            }
            if (cnt > 0) {
                int32_t a = hidx[ord[first]], b = hidx[ord[last]];
                paf_emit(self, bb, rname, read_len, k, cid, cpos[a], cpos[b],
                         rpos[a], rpos[b], cnt, nsame);
            }
        }
    }
    return 0;
}

static PyObject *Chainer_chain(ChainerObject *self, PyObject *args)
{
    Py_buffer cids_v, cpos_v, rpos_v, sbits_v;
    Py_ssize_t n;
    long read_len, k, z;
    double x;
    int sensitive;
    PyObject *read_name;
    if (!PyArg_ParseTuple(args, "y*y*y*y*nlllidO", &cids_v, &cpos_v, &rpos_v,
                          &sbits_v, &n, &read_len, &k, &z, &sensitive, &x,
                          &read_name))
        return NULL;
    const int32_t *cids = cids_v.buf;
    const int32_t *cpos = cpos_v.buf;
    const int32_t *rpos = rpos_v.buf;
    const int32_t *sbits = sbits_v.buf;

    PyObject *result = NULL;
    Scratch s;
    memset(&s, 0, sizeof(s));
    if (scratch_reserve(&s, n ? n : 1) < 0) {
        PyErr_NoMemory();
        goto done;
    }

    {
        Py_ssize_t n_final = chain_core(self, cids, cpos, rpos, sbits, n,
                                        read_len, k, z, sensitive, x, &s);
        PyObject *run_list = PyList_New(n_final);
        if (!run_list)
            goto done;
        for (Py_ssize_t i = 0; i < n_final; i++) {
            int32_t a = s.final_idx[s.final_runs[i].start];
            int32_t b = s.final_idx[s.final_runs[i].end - 1];
            PyObject *tup = Py_BuildValue(
                "iiiiiiii", (int)s.final_runs[i].cid,
                (int)(s.final_runs[i].end - s.final_runs[i].start),
                (int)cpos[a], (int)rpos[a], (int)sbits[a], (int)cpos[b],
                (int)rpos[b], (int)sbits[b]);
            if (!tup) {
                Py_DECREF(run_list);
                goto done;
            }
            PyList_SET_ITEM(run_list, i, tup);
        }

        PyObject *verbose = Py_None;
        if (read_name != Py_None && n_final > 0) {
            Py_ssize_t rlen;
            const char *rname = PyUnicode_AsUTF8AndSize(read_name, &rlen);
            if (!rname) {
                Py_DECREF(run_list);
                goto done;
            }
            rlen = (Py_ssize_t)strnlen(rname, (size_t)rlen);
            verbose = PyBytes_FromStringAndSize(
                NULL, (Py_ssize_t)verbose_bound(self, cids, n, rlen));
            if (verbose) {
                char *v = PyBytes_AS_STRING(verbose);
                char *end = render_verbose(self, v, rname, rlen, n_final,
                                           s.final_runs, s.final_idx, cpos,
                                           rpos, sbits);
                _PyBytes_Resize(&verbose, end - v);
            }
            if (!verbose) {
                Py_DECREF(run_list);
                goto done;
            }
        } else {
            Py_INCREF(Py_None);
        }
        result = PyTuple_Pack(2, run_list, verbose);
        Py_DECREF(run_list);
        Py_DECREF(verbose);
    }

done:
    scratch_free(&s);
    PyBuffer_Release(&cids_v);
    PyBuffer_Release(&cpos_v);
    PyBuffer_Release(&rpos_v);
    PyBuffer_Release(&sbits_v);
    return result;
}

/* growable int32 buffer for batched run rows */
typedef struct {
    int32_t *buf;
    size_t len, cap; /* in int32 units */
} I32Buf;

static int ib_reserve(I32Buf *b, size_t extra)
{
    if (b->len + extra <= b->cap)
        return 0;
    size_t c = b->cap ? b->cap : 1024;
    while (c < b->len + extra)
        c *= 2;
    int32_t *p = realloc(b->buf, c * sizeof(int32_t));
    if (!p)
        return -1;
    b->buf = p;
    b->cap = c;
    return 0;
}

static PyObject *Chainer_chain_batch(ChainerObject *self, PyObject *args)
{
    Py_buffer cids_v, cpos_v, rpos_v, sbits_v, offs_v, rlens_v;
    PyObject *read_names;
    long k, z;
    double x;
    int sensitive;
    int mode = -1; /* default: verbose iff read_names given, no PAF */
    int prechained = 0; /* anchors already filtered/ordered upstream */
    if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*Ollid|ii", &cids_v, &cpos_v,
                          &rpos_v, &sbits_v, &offs_v, &rlens_v, &read_names,
                          &k, &z, &sensitive, &x, &mode, &prechained))
        return NULL;
    const int32_t *cids = cids_v.buf;
    const int32_t *cpos = cpos_v.buf;
    const int32_t *rpos = rpos_v.buf;
    const int32_t *sbits = sbits_v.buf;
    const int64_t *offs = offs_v.buf;
    const int32_t *rlens = rlens_v.buf;
    Py_ssize_t n_reads = offs_v.len / 8 - 1;

    PyObject *result = NULL;
    int want_verbose, want_paf;
    if (mode < 0) {
        want_verbose = (read_names != Py_None);
        want_paf = 0;
    } else {
        want_verbose = (mode & 1) && read_names != Py_None;
        want_paf = (mode & 2) != 0;
    }
    const char **rname = NULL;
    int32_t *rname_len = NULL;
    int32_t *run_offs = NULL;
    Scratch s;
    PyObject *verbose = NULL; /* filled without the GIL, then shrunk */
    char *vbase = NULL, *vp = NULL;
    ByteBuf pb = {NULL, 0, 0};
    I32Buf rb = {NULL, 0, 0};
    memset(&s, 0, sizeof(s));
    int failed = 0;

    if (want_paf && read_names == Py_None) {
        PyErr_SetString(PyExc_TypeError, "PAF mode requires read_names");
        goto done;
    }
    if (want_verbose || want_paf) {
        if (!PyList_Check(read_names) ||
            PyList_GET_SIZE(read_names) != n_reads) {
            PyErr_SetString(PyExc_TypeError,
                            "read_names must be a list of len n_reads");
            goto done;
        }
        rname = PyMem_Malloc(sizeof(char *) * (n_reads ? n_reads : 1));
        rname_len = PyMem_Malloc(sizeof(int32_t) * (n_reads ? n_reads : 1));
        if (!rname || !rname_len) {
            PyErr_NoMemory();
            goto done;
        }
        for (Py_ssize_t i = 0; i < n_reads; i++) {
            Py_ssize_t blen;
            const char *p = PyUnicode_AsUTF8AndSize(
                PyList_GET_ITEM(read_names, i), &blen);
            if (!p)
                goto done;
            rname[i] = p;
            rname_len[i] = (int32_t)strnlen(p, (size_t)blen);
        }
    }
    run_offs = PyMem_Malloc(sizeof(int32_t) * (n_reads + 1));
    if (!run_offs) {
        PyErr_NoMemory();
        goto done;
    }

    Py_ssize_t max_n = 1;
    for (Py_ssize_t i = 0; i < n_reads; i++) {
        Py_ssize_t n = (Py_ssize_t)(offs[i + 1] - offs[i]);
        if (n > max_n)
            max_n = n;
    }
    if (scratch_reserve(&s, max_n) < 0) {
        PyErr_NoMemory();
        goto done;
    }
    if (want_verbose) {
        size_t bound = 0;
        for (Py_ssize_t i = 0; i < n_reads; i++)
            bound += verbose_bound(self, cids + offs[i],
                                   (Py_ssize_t)(offs[i + 1] - offs[i]),
                                   rname_len[i]);
        verbose = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)bound);
        if (!verbose)
            goto done;
        vbase = vp = PyBytes_AS_STRING(verbose);
    }

    Py_BEGIN_ALLOW_THREADS
    run_offs[0] = 0;
    for (Py_ssize_t i = 0; i < n_reads && !failed; i++) {
        int64_t o = offs[i];
        Py_ssize_t n = (Py_ssize_t)(offs[i + 1] - o);
        Py_ssize_t n_final = 0;
        if (n)
            n_final = prechained
                          ? chain_core_prechained(cids + o, n, &s)
                          : chain_core(self, cids + o, cpos + o, rpos + o,
                                       sbits + o, n, rlens[i], k, z,
                                       sensitive, x, &s);
        if (ib_reserve(&rb, (size_t)n_final * 8) < 0) {
            failed = 1;
            break;
        }
        for (Py_ssize_t r = 0; r < n_final; r++) {
            int32_t a = s.final_idx[s.final_runs[r].start];
            int32_t b = s.final_idx[s.final_runs[r].end - 1];
            int32_t *row = rb.buf + rb.len;
            row[0] = s.final_runs[r].cid;
            row[1] = s.final_runs[r].end - s.final_runs[r].start;
            row[2] = cpos[o + a];
            row[3] = rpos[o + a];
            row[4] = sbits[o + a];
            row[5] = cpos[o + b];
            row[6] = rpos[o + b];
            row[7] = sbits[o + b];
            rb.len += 8;
        }
        run_offs[i + 1] = (int32_t)(rb.len / 8);
        if (want_verbose && n_final > 0)
            vp = render_verbose(self, vp, rname[i], rname_len[i], n_final,
                                s.final_runs, s.final_idx, cpos + o,
                                rpos + o, sbits + o);
        if (want_paf && n_final > 0 &&
            render_paf(self, &pb, rname[i], rname_len[i], rlens[i], k,
                       n_final, s.final_runs, s.final_idx, cpos + o, rpos + o,
                       sbits + o, &s) < 0)
            failed = 1;
    }
    Py_END_ALLOW_THREADS

    if (failed) {
        PyErr_NoMemory();
        goto done;
    }
    {
        PyObject *runs_b =
            PyBytes_FromStringAndSize((char *)rb.buf, rb.len * sizeof(int32_t));
        PyObject *offs_b = PyBytes_FromStringAndSize(
            (char *)run_offs, (n_reads + 1) * sizeof(int32_t));
        if (want_verbose)
            _PyBytes_Resize(&verbose, vp - vbase);
        else {
            verbose = Py_None;
            Py_INCREF(Py_None);
        }
        PyObject *paf;
        if (want_paf)
            paf = PyBytes_FromStringAndSize(pb.buf, pb.len);
        else {
            paf = Py_None;
            Py_INCREF(Py_None);
        }
        if (runs_b && offs_b && verbose && paf)
            result = PyTuple_Pack(4, runs_b, offs_b, verbose, paf);
        Py_XDECREF(runs_b);
        Py_XDECREF(offs_b);
        Py_XDECREF(paf);
    }

done:
    Py_XDECREF(verbose);
    scratch_free(&s);
    free(pb.buf);
    free(rb.buf);
    PyMem_Free(run_offs);
    PyMem_Free(rname);
    PyMem_Free(rname_len);
    PyBuffer_Release(&cids_v);
    PyBuffer_Release(&cpos_v);
    PyBuffer_Release(&rpos_v);
    PyBuffer_Release(&sbits_v);
    PyBuffer_Release(&offs_v);
    PyBuffer_Release(&rlens_v);
    return result;
}

/* Single-read chain selection: run the full acceptance pipeline and
 * return the surviving anchors' ORIGINAL indices (final order) as int32
 * bytes. Used by prechaining host paths (HostMapper workers, the device
 * mapper's exact per-read fallback) so their payloads match the
 * on-device chaining stage's output contract. */
static PyObject *Chainer_chain_select(ChainerObject *self, PyObject *args)
{
    Py_buffer cids_v, cpos_v, rpos_v, sbits_v;
    long read_len, k, z;
    int sensitive;
    double x;
    if (!PyArg_ParseTuple(args, "y*y*y*y*lllid", &cids_v, &cpos_v, &rpos_v,
                          &sbits_v, &read_len, &k, &z, &sensitive, &x))
        return NULL;
    Py_ssize_t n = cids_v.len / (Py_ssize_t)sizeof(int32_t);
    PyObject *result = NULL;
    Scratch s;
    memset(&s, 0, sizeof(s));
    if (scratch_reserve(&s, n ? n : 1) < 0) {
        PyErr_NoMemory();
        goto done;
    }
    {
        Py_ssize_t n_final = 0;
        Py_ssize_t n_sel = 0;
        Py_BEGIN_ALLOW_THREADS
        if (n)
            n_final = chain_core(self, cids_v.buf, cpos_v.buf, rpos_v.buf,
                                 sbits_v.buf, n, read_len, k, z, sensitive,
                                 x, &s);
        for (Py_ssize_t r = 0; r < n_final; r++)
            n_sel = s.final_runs[r].end;
        Py_END_ALLOW_THREADS
        result = PyBytes_FromStringAndSize((char *)s.final_idx,
                                           n_sel * sizeof(int32_t));
    }
done:
    scratch_free(&s);
    PyBuffer_Release(&cids_v);
    PyBuffer_Release(&cpos_v);
    PyBuffer_Release(&rpos_v);
    PyBuffer_Release(&sbits_v);
    return result;
}

/* Batched chain selection: one GIL crossing per read BLOCK. Returns
 * (sel_bytes, offs_bytes): int32 GLOBAL indices into the concatenated
 * anchor arrays (accepted anchors, final order) plus int32[n_reads+1]
 * prefix offsets into that selection. */
static PyObject *Chainer_chain_select_batch(ChainerObject *self,
                                            PyObject *args)
{
    Py_buffer cids_v, cpos_v, rpos_v, sbits_v, offs_v, rlens_v;
    long k, z;
    int sensitive;
    double x;
    if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*llid", &cids_v, &cpos_v,
                          &rpos_v, &sbits_v, &offs_v, &rlens_v, &k, &z,
                          &sensitive, &x))
        return NULL;
    const int32_t *cids = cids_v.buf;
    const int32_t *cpos = cpos_v.buf;
    const int32_t *rpos = rpos_v.buf;
    const int32_t *sbits = sbits_v.buf;
    const int64_t *offs = offs_v.buf;
    const int32_t *rlens = rlens_v.buf;
    Py_ssize_t n_reads = offs_v.len / 8 - 1;
    PyObject *result = NULL;
    Scratch s;
    I32Buf sel = {NULL, 0, 0};
    int32_t *new_offs = NULL;
    int failed = 0;
    memset(&s, 0, sizeof(s));
    Py_ssize_t max_n = 1;
    for (Py_ssize_t i = 0; i < n_reads; i++) {
        Py_ssize_t n = (Py_ssize_t)(offs[i + 1] - offs[i]);
        if (n > max_n)
            max_n = n;
    }
    new_offs = PyMem_Malloc(sizeof(int32_t) * (n_reads + 1));
    if (!new_offs || scratch_reserve(&s, max_n) < 0) {
        PyErr_NoMemory();
        goto done;
    }
    Py_BEGIN_ALLOW_THREADS
    new_offs[0] = 0;
    for (Py_ssize_t i = 0; i < n_reads && !failed; i++) {
        int64_t o = offs[i];
        Py_ssize_t n = (Py_ssize_t)(offs[i + 1] - o);
        Py_ssize_t n_final = 0;
        if (n)
            n_final = chain_core(self, cids + o, cpos + o, rpos + o,
                                 sbits + o, n, rlens[i], k, z, sensitive, x,
                                 &s);
        Py_ssize_t n_sel = n_final ? s.final_runs[n_final - 1].end : 0;
        if (ib_reserve(&sel, (size_t)n_sel) < 0) {
            failed = 1;
            break;
        }
        for (Py_ssize_t j = 0; j < n_sel; j++)
            sel.buf[sel.len + j] = (int32_t)(s.final_idx[j] + o);
        sel.len += n_sel;
        new_offs[i + 1] = (int32_t)sel.len;
    }
    Py_END_ALLOW_THREADS
    if (failed) {
        PyErr_NoMemory();
        goto done;
    }
    {
        PyObject *sel_b = PyBytes_FromStringAndSize(
            (char *)sel.buf, sel.len * sizeof(int32_t));
        PyObject *no_b = PyBytes_FromStringAndSize(
            (char *)new_offs, (n_reads + 1) * sizeof(int32_t));
        if (sel_b && no_b)
            result = PyTuple_Pack(2, sel_b, no_b);
        Py_XDECREF(sel_b);
        Py_XDECREF(no_b);
    }
done:
    scratch_free(&s);
    free(sel.buf);
    PyMem_Free(new_offs);
    PyBuffer_Release(&cids_v);
    PyBuffer_Release(&cpos_v);
    PyBuffer_Release(&rpos_v);
    PyBuffer_Release(&sbits_v);
    PyBuffer_Release(&offs_v);
    PyBuffer_Release(&rlens_v);
    return result;
}

static PyMethodDef Chainer_methods[] = {
    {"chain_select_batch", (PyCFunction)Chainer_chain_select_batch,
     METH_VARARGS,
     "chain_select_batch(cids, cpos, rpos, sbits, offsets, read_lens, "
     "k, z, sensitive, x) -> (global int32 selected-anchor indices, "
     "int32[n_reads+1] prefix offsets)"},
    {"chain_select", (PyCFunction)Chainer_chain_select, METH_VARARGS,
     "chain_select(cids, cpos, rpos, sbits, read_len, k, z, sensitive, x) "
     "-> int32 bytes of surviving anchor indices (final order)"},
    {"chain", (PyCFunction)Chainer_chain, METH_VARARGS,
     "chain(cids, cpos, rpos, sbits, n, read_len, k, z, sensitive, x, "
     "read_name) -> (runs, verbose_bytes|None)"},
    {"chain_batch", (PyCFunction)Chainer_chain_batch, METH_VARARGS,
     "chain_batch(cids, cpos, rpos, sbits, offsets, read_lens, read_names, "
     "k, z, sensitive, x[, mode[, prechained]]) -> (runs_bytes, "
     "run_offsets_bytes, verbose_bytes|None, paf_bytes|None); mode "
     "bit0=verbose bit1=paf; prechained=1 skips filters (anchors are "
     "already accepted, in final order)"},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject ChainerType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "ntlink_chain.Chainer",
    .tp_basicsize = sizeof(ChainerObject),
    .tp_dealloc = (destructor)Chainer_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Per-read anchor chaining",
    .tp_methods = Chainer_methods,
    .tp_new = Chainer_new,
};

static PyModuleDef chain_module = {
    PyModuleDef_HEAD_INIT,
    .m_name = "ntlink_chain",
    .m_doc = "Native anchor chaining + verbose formatting",
    .m_size = -1,
};

PyMODINIT_FUNC PyInit_ntlink_chain(void)
{
    if (PyType_Ready(&ChainerType) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&chain_module);
    if (!m)
        return NULL;
    Py_INCREF(&ChainerType);
    if (PyModule_AddObject(m, "Chainer", (PyObject *)&ChainerType) < 0) {
        Py_DECREF(&ChainerType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
