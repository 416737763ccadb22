/* ntlink_liftover — native AGP-based mapping liftover.
 *
 * Exact C implementation of liftover.liftover_mappings (reference
 * ntlink_liftover_mappings.py): every verbose_mapping row is re-expressed
 * in the next round's scaffold coordinates, out-of-range anchors dropped,
 * runs merged per new scaffold with nested runs subsumed, non-monotonic
 * concatenations discarded. Pure line-streaming transform; the Python
 * caller parses the (tiny) AGP and passes the placement table, and the
 * whole verbose file is processed here with the GIL released
 * (~30x the per-anchor Python path at assembly scale).
 *
 * API:
 *   lift(verbose_path, out_path, k,
 *        names: list[str],        # contig name per component
 *        new_names: list[str],    # destination scaffold id per component
 *        scaf_start: int64 buf, ctg_start: int64 buf, ctg_end: int64 buf,
 *        ori_plus: uint8 buf,     # 1 if orientation '+'
 *        self_flag: uint8 buf)    # 1 if path_id == ctg (pass-through row)
 *     -> number of output rows written
 *
 * Rows whose contig has no AGP placement keep their original name with an
 * empty hit list — they still participate in the grouping/subsume
 * bookkeeping exactly like the Python path.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* ---------- string -> component-index hash table (FNV-1a, open addr) */
typedef struct {
    const char **keys;
    int32_t *klen;
    int32_t *val;
    size_t size; /* power of two */
} StrMap;

static uint32_t fnv1a(const char *s, size_t n)
{
    uint32_t h = 2166136261u;
    for (size_t i = 0; i < n; i++) {
        h ^= (unsigned char)s[i];
        h *= 16777619u;
    }
    return h;
}

static int strmap_init(StrMap *m, size_t n)
{
    size_t size = 16;
    while (size < 2 * (n ? n : 1))
        size <<= 1;
    m->keys = calloc(size, sizeof(char *));
    m->klen = malloc(size * sizeof(int32_t));
    m->val = malloc(size * sizeof(int32_t));
    m->size = size;
    return (m->keys && m->klen && m->val) ? 0 : -1;
}

static void strmap_free(StrMap *m)
{
    free(m->keys);
    free(m->klen);
    free(m->val);
}

static void strmap_put(StrMap *m, const char *key, size_t n, int32_t v)
{
    size_t i = fnv1a(key, n) & (m->size - 1);
    while (m->keys[i])
        i = (i + 1) & (m->size - 1);
    m->keys[i] = key;
    m->klen[i] = (int32_t)n;
    m->val[i] = v;
}

static int32_t strmap_get(const StrMap *m, const char *key, size_t n)
{
    size_t i = fnv1a(key, n) & (m->size - 1);
    while (m->keys[i]) {
        if (m->klen[i] == (int32_t)n && memcmp(m->keys[i], key, n) == 0)
            return m->val[i];
        i = (i + 1) & (m->size - 1);
    }
    return -1;
}

/* ---------- per-read accumulation */
typedef struct {
    int64_t cpos;
    int32_t rpos;
    uint8_t cstrand_plus;
    uint8_t rstrand_plus;
} Hit;

typedef struct {
    const char *name_ptr; /* canonical new name, or NULL -> name_buf */
    size_t name_off;      /* offset into name_buf when name_ptr == NULL */
    int32_t name_len;
    int32_t hit_start; /* into hits[] */
    int32_t hit_end;
} Row;

typedef struct {
    Hit *hits;
    size_t n_hits, cap_hits;
    Row *rows;
    size_t n_rows, cap_rows;
    char *name_buf; /* storage for unknown-contig names (per read) */
    size_t nb_len, nb_cap;
    char *read_id;
    size_t read_id_len, read_id_cap;
} ReadAcc;

static int acc_reserve_hits(ReadAcc *a, size_t extra)
{
    if (a->n_hits + extra <= a->cap_hits)
        return 0;
    size_t c = a->cap_hits ? a->cap_hits : 256;
    while (c < a->n_hits + extra)
        c *= 2;
    Hit *p = realloc(a->hits, c * sizeof(Hit));
    if (!p)
        return -1;
    a->hits = p;
    a->cap_hits = c;
    return 0;
}

static int acc_reserve_rows(ReadAcc *a)
{
    if (a->n_rows < a->cap_rows)
        return 0;
    size_t c = a->cap_rows ? a->cap_rows * 2 : 16;
    Row *p = realloc(a->rows, c * sizeof(Row));
    if (!p)
        return -1;
    a->rows = p;
    a->cap_rows = c;
    return 0;
}

static size_t acc_store_name(ReadAcc *a, const char *s, size_t n)
{
    if (a->nb_len + n > a->nb_cap) {
        size_t c = a->nb_cap ? a->nb_cap : 1024;
        while (c < a->nb_len + n)
            c *= 2;
        char *p = realloc(a->name_buf, c);
        if (!p)
            return (size_t)-1;
        a->name_buf = p;
        a->nb_cap = c;
    }
    memcpy(a->name_buf + a->nb_len, s, n);
    size_t off = a->nb_len;
    a->nb_len += n;
    return off;
}

static int acc_set_read_id(ReadAcc *a, const char *s, size_t n)
{
    if (n + 1 > a->read_id_cap) {
        size_t c = a->read_id_cap ? a->read_id_cap : 256;
        while (c < n + 1)
            c *= 2;
        char *p = realloc(a->read_id, c);
        if (!p)
            return -1;
        a->read_id = p;
        a->read_id_cap = c;
    }
    memcpy(a->read_id, s, n);
    a->read_id[n] = 0;
    a->read_id_len = n;
    return 0;
}

static void acc_reset(ReadAcc *a)
{
    a->n_hits = a->n_rows = a->nb_len = 0;
}

static void acc_free(ReadAcc *a)
{
    free(a->hits);
    free(a->rows);
    free(a->name_buf);
    free(a->read_id);
    memset(a, 0, sizeof(*a));
}

/* ---------- buffered output */
typedef struct {
    char *buf;
    size_t len, cap;
    FILE *fh;
} Out;

static int out_flush(Out *o)
{
    if (o->len && fwrite(o->buf, 1, o->len, o->fh) != o->len)
        return -1;
    o->len = 0;
    return 0;
}

static int out_reserve(Out *o, size_t extra)
{
    if (o->len + extra <= o->cap)
        return 0;
    if (out_flush(o) < 0)
        return -1;
    if (extra > o->cap) {
        size_t c = o->cap ? o->cap : (1 << 20);
        while (c < extra)
            c *= 2;
        char *p = realloc(o->buf, c);
        if (!p)
            return -1;
        o->buf = p;
        o->cap = c;
    }
    return 0;
}

static char *fmt_i64(char *p, long long v)
{
    char tmp[24];
    int n = 0;
    unsigned long long u;
    if (v < 0) {
        *p++ = '-';
        u = (unsigned long long)(-v);
    } else {
        u = (unsigned long long)v;
    }
    do {
        tmp[n++] = (char)('0' + (u % 10));
        u /= 10;
    } while (u);
    while (n)
        *p++ = tmp[--n];
    return p;
}

/* Emit one read's rows (exact contract of liftover._emit_read).
 * Returns number of rows written, or -1 on error. */
typedef struct {
    const char *name;
    int32_t len;
    size_t row_start, row_end; /* [start, end) into rows */
} Group;

static long emit_read(ReadAcc *a, Out *o)
{
    size_t nr = a->n_rows;
    if (!nr)
        return 0;
    const char **nm = malloc(nr * sizeof(char *));
    Group *groups = malloc(nr * sizeof(Group));
    /* distinct-name bookkeeping (first group index + subsumed flag) */
    size_t *dg_first = malloc(nr * sizeof(size_t));
    unsigned char *dg_sub = malloc(nr * sizeof(unsigned char));
    size_t *grp_name = malloc(nr * sizeof(size_t)); /* group -> distinct id */
    unsigned char *row_keep = malloc(nr);
    if (!nm || !groups || !dg_first || !dg_sub || !grp_name || !row_keep)
        goto nomem;

    for (size_t i = 0; i < nr; i++)
        nm[i] = a->rows[i].name_ptr ? a->rows[i].name_ptr
                                    : a->name_buf + a->rows[i].name_off;

    /* consecutive grouping by new name */
    size_t ng = 0;
    for (size_t i = 0; i < nr; i++) {
        if (ng && groups[ng - 1].len == a->rows[i].name_len &&
            memcmp(groups[ng - 1].name, nm[i], groups[ng - 1].len) == 0) {
            groups[ng - 1].row_end = i + 1;
        } else {
            groups[ng].name = nm[i];
            groups[ng].len = a->rows[i].name_len;
            groups[ng].row_start = i;
            groups[ng].row_end = i + 1;
            ng++;
        }
    }

    /* distinct ids + subsume marking: a repeated name marks every name
     * strictly between its first sighting and the repeat as subsumed */
    size_t nd = 0;
    for (size_t g = 0; g < ng; g++) {
        size_t d;
        for (d = 0; d < nd; d++) {
            const Group *fg = &groups[dg_first[d]];
            if (fg->len == groups[g].len &&
                memcmp(fg->name, groups[g].name, fg->len) == 0)
                break;
        }
        if (d == nd) {
            dg_first[nd] = g;
            dg_sub[nd] = 0;
            nd++;
        } else {
            for (size_t j = dg_first[d] + 1; j < g; j++)
                dg_sub[grp_name[j]] = 1;
        }
        grp_name[g] = d;
    }

    for (size_t g = 0; g < ng; g++) {
        unsigned char keep = !dg_sub[grp_name[g]];
        for (size_t i = groups[g].row_start; i < groups[g].row_end; i++)
            row_keep[i] = keep;
    }

    /* regroup the surviving rows consecutively by name and render */
    long written = 0;
    size_t i = 0;
    while (i < nr) {
        if (!row_keep[i]) {
            i++;
            continue;
        }
        /* collect this regrouped run: surviving rows with the same name,
         * consecutive in the filtered sequence */
        const char *name = nm[i];
        int32_t nlen = a->rows[i].name_len;
        size_t total = 0;
        int incr = 1, decr = 1;
        int64_t prev_cpos = 0;
        int have_prev = 0;
        /* first pass over the regrouped members to validate monotonicity */
        size_t j = i;
        size_t end = i;
        while (j < nr) {
            if (!row_keep[j]) {
                j++;
                continue;
            }
            if (!(a->rows[j].name_len == nlen &&
                  memcmp(nm[j], name, nlen) == 0))
                break;
            for (int32_t h = a->rows[j].hit_start; h < a->rows[j].hit_end;
                 h++) {
                int64_t c = a->hits[h].cpos;
                if (have_prev) {
                    if (!(prev_cpos < c))
                        incr = 0;
                    if (!(prev_cpos > c))
                        decr = 0;
                }
                prev_cpos = c;
                have_prev = 1;
                total++;
            }
            j++;
            end = j;
        }
        if (total && (incr || decr)) {
            size_t need = a->read_id_len + (size_t)nlen + 32 + total * 48;
            if (out_reserve(o, need) < 0)
                goto nomem;
            char *p = o->buf + o->len;
            memcpy(p, a->read_id, a->read_id_len);
            p += a->read_id_len;
            *p++ = '\t';
            memcpy(p, name, nlen);
            p += nlen;
            *p++ = '\t';
            p = fmt_i64(p, (long long)total);
            *p++ = '\t';
            size_t emitted = 0;
            for (size_t m = i; m < end; m++) {
                if (!row_keep[m])
                    continue;
                if (!(a->rows[m].name_len == nlen &&
                      memcmp(nm[m], name, nlen) == 0))
                    continue;
                for (int32_t h = a->rows[m].hit_start; h < a->rows[m].hit_end;
                     h++) {
                    if (emitted)
                        *p++ = ' ';
                    p = fmt_i64(p, (long long)a->hits[h].cpos);
                    *p++ = ':';
                    *p++ = a->hits[h].cstrand_plus ? '+' : '-';
                    *p++ = '_';
                    p = fmt_i64(p, (long long)a->hits[h].rpos);
                    *p++ = ':';
                    *p++ = a->hits[h].rstrand_plus ? '+' : '-';
                    emitted++;
                }
            }
            *p++ = '\n';
            o->len = p - o->buf;
            written++;
        }
        /* advance past the scanned regrouped run */
        i = end > i ? end : i + 1;
    }

    free(nm);
    free(groups);
    free(dg_first);
    free(dg_sub);
    free(grp_name);
    free(row_keep);
    return written;

nomem:
    free(nm);
    free(groups);
    free(dg_first);
    free(dg_sub);
    free(grp_name);
    free(row_keep);
    return -1;
}

/* parse a non-negative decimal; returns end pointer or NULL */
static const char *parse_i64(const char *p, const char *lim, int64_t *out)
{
    if (p >= lim || *p < '0' || *p > '9')
        return NULL;
    int64_t v = 0;
    while (p < lim && *p >= '0' && *p <= '9') {
        v = v * 10 + (*p - '0');
        p++;
    }
    *out = v;
    return p;
}

static PyObject *py_lift(PyObject *self, PyObject *args)
{
    const char *verbose_path, *out_path;
    long k;
    PyObject *names, *new_names;
    Py_buffer ss_v, cs_v, ce_v, op_v, sf_v;
    if (!PyArg_ParseTuple(args, "sslOOy*y*y*y*y*", &verbose_path, &out_path,
                          &k, &names, &new_names, &ss_v, &cs_v, &ce_v, &op_v,
                          &sf_v))
        return NULL;

    PyObject *result = NULL;
    StrMap map = {0};
    ReadAcc acc = {0};
    Out out = {0};
    FILE *in = NULL;
    char *line = NULL;
    size_t line_cap = 0;
    const char **comp_name = NULL, **comp_new = NULL;
    int32_t *comp_new_len = NULL;
    long total_rows = 0;
    int failed = 0;

    if (!PyList_Check(names) || !PyList_Check(new_names) ||
        PyList_GET_SIZE(names) != PyList_GET_SIZE(new_names)) {
        PyErr_SetString(PyExc_TypeError,
                        "names/new_names must be equal-length lists");
        goto done;
    }
    Py_ssize_t n_comp = PyList_GET_SIZE(names);
    const int64_t *scaf_start = ss_v.buf;
    const int64_t *ctg_start = cs_v.buf;
    const int64_t *ctg_end = ce_v.buf;
    const uint8_t *ori_plus = op_v.buf;
    const uint8_t *self_flag = sf_v.buf;

    comp_name = PyMem_Malloc(sizeof(char *) * (n_comp ? n_comp : 1));
    comp_new = PyMem_Malloc(sizeof(char *) * (n_comp ? n_comp : 1));
    comp_new_len = PyMem_Malloc(sizeof(int32_t) * (n_comp ? n_comp : 1));
    if (!comp_name || !comp_new || !comp_new_len) {
        PyErr_NoMemory();
        goto done;
    }
    if (strmap_init(&map, (size_t)n_comp) < 0) {
        PyErr_NoMemory();
        goto done;
    }
    for (Py_ssize_t i = 0; i < n_comp; i++) {
        Py_ssize_t nlen, mlen;
        const char *nm =
            PyUnicode_AsUTF8AndSize(PyList_GET_ITEM(names, i), &nlen);
        const char *nn =
            PyUnicode_AsUTF8AndSize(PyList_GET_ITEM(new_names, i), &mlen);
        if (!nm || !nn)
            goto done;
        comp_name[i] = nm;
        comp_new[i] = nn;
        comp_new_len[i] = (int32_t)mlen;
        strmap_put(&map, nm, (size_t)nlen, (int32_t)i);
    }

    in = fopen(verbose_path, "r");
    if (!in) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, verbose_path);
        goto done;
    }
    out.fh = fopen(out_path, "w");
    if (!out.fh) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, out_path);
        goto done;
    }

    Py_BEGIN_ALLOW_THREADS
    ssize_t got;
    int have_read = 0;
    while ((got = getline(&line, &line_cap, in)) > 0) {
        const char *lim = line + got;
        if (lim > line && lim[-1] == '\n')
            lim--;
        const char *t1 = memchr(line, '\t', lim - line);
        if (!t1)
            continue;
        const char *t2 = memchr(t1 + 1, '\t', lim - (t1 + 1));
        if (!t2)
            continue;
        const char *t3 = memchr(t2 + 1, '\t', lim - (t2 + 1));
        if (!t3)
            continue;
        size_t rid_len = (size_t)(t1 - line);
        const char *ctg = t1 + 1;
        size_t ctg_len = (size_t)(t2 - ctg);
        const char *hits = t3 + 1;

        if (!have_read || rid_len != acc.read_id_len ||
            memcmp(line, acc.read_id, rid_len) != 0) {
            if (have_read) {
                long w = emit_read(&acc, &out);
                if (w < 0) {
                    failed = 1;
                    break;
                }
                total_rows += w;
            }
            acc_reset(&acc);
            if (acc_set_read_id(&acc, line, rid_len) < 0) {
                failed = 1;
                break;
            }
            have_read = 1;
        }

        if (acc_reserve_rows(&acc) < 0) {
            failed = 1;
            break;
        }
        Row *row = &acc.rows[acc.n_rows];
        row->hit_start = (int32_t)acc.n_hits;

        int32_t ci = strmap_get(&map, ctg, ctg_len);
        if (ci < 0) {
            /* unplaced contig: empty hits, original name */
            size_t off = acc_store_name(&acc, ctg, ctg_len);
            if (off == (size_t)-1) {
                failed = 1;
                break;
            }
            row->name_ptr = NULL;
            row->name_off = off;
            row->name_len = (int32_t)ctg_len;
            row->hit_end = row->hit_start;
            acc.n_rows++;
            continue;
        }
        row->name_ptr = comp_new[ci];
        row->name_off = 0;
        row->name_len = comp_new_len[ci];

        int64_t lo = ctg_start[ci] - 1;
        int64_t hi = ctg_end[ci] - (int64_t)k;
        int64_t clen = ctg_end[ci] - ctg_start[ci] + 1;
        int64_t offset = scaf_start[ci] - 1;
        int is_self = self_flag[ci];
        int is_plus = ori_plus[ci];

        const char *p = hits;
        while (p < lim) {
            int64_t cpos, rpos;
            const char *q = parse_i64(p, lim, &cpos);
            if (!q || q >= lim || *q != ':') {
                failed = 2;
                break;
            }
            q++;
            char cs = *q++;
            if (q >= lim || *q != '_') {
                failed = 2;
                break;
            }
            q++;
            q = parse_i64(q, lim, &rpos);
            if (!q || q >= lim || *q != ':') {
                failed = 2;
                break;
            }
            q++;
            char rs = *q++;
            if (lo <= cpos && cpos <= hi) {
                if (acc_reserve_hits(&acc, 1) < 0) {
                    failed = 1;
                    break;
                }
                Hit *h = &acc.hits[acc.n_hits];
                int64_t local = cpos - lo;
                if (is_self) {
                    h->cpos = cpos;
                    h->cstrand_plus = cs == '+';
                } else if (is_plus) {
                    h->cpos = offset + local;
                    h->cstrand_plus = cs == '+';
                } else {
                    h->cpos = offset + (clen - local) - (int64_t)k;
                    h->cstrand_plus = cs != '+';
                }
                h->rpos = (int32_t)rpos;
                h->rstrand_plus = rs == '+';
                acc.n_hits++;
            }
            if (q < lim && *q == ' ')
                q++;
            p = q;
        }
        if (failed)
            break;
        row->hit_end = (int32_t)acc.n_hits;
        acc.n_rows++;
    }
    if (!failed && have_read) {
        long w = emit_read(&acc, &out);
        if (w < 0)
            failed = 1;
        else
            total_rows += w;
    }
    if (!failed && out_flush(&out) < 0)
        failed = 1;
    Py_END_ALLOW_THREADS

    if (failed == 1) {
        PyErr_NoMemory();
        goto done;
    }
    if (failed == 2) {
        PyErr_SetString(PyExc_ValueError, "malformed verbose mapping line");
        goto done;
    }
    result = PyLong_FromLong(total_rows);

done:
    if (in)
        fclose(in);
    if (out.fh)
        fclose(out.fh);
    free(out.buf);
    free(line);
    acc_free(&acc);
    strmap_free(&map);
    PyMem_Free(comp_name);
    PyMem_Free(comp_new);
    PyMem_Free(comp_new_len);
    PyBuffer_Release(&ss_v);
    PyBuffer_Release(&cs_v);
    PyBuffer_Release(&ce_v);
    PyBuffer_Release(&op_v);
    PyBuffer_Release(&sf_v);
    return result;
}

static PyMethodDef lift_methods[] = {
    {"lift", py_lift, METH_VARARGS,
     "lift(verbose_path, out_path, k, names, new_names, scaf_start, "
     "ctg_start, ctg_end, ori_plus, self_flag) -> rows written"},
    {NULL, NULL, 0, NULL},
};

static PyModuleDef lift_module = {
    PyModuleDef_HEAD_INIT,
    .m_name = "ntlink_liftover",
    .m_doc = "Native AGP mapping liftover",
    .m_size = -1,
    .m_methods = lift_methods,
};

PyMODINIT_FUNC PyInit_ntlink_liftover(void)
{
    return PyModule_Create(&lift_module);
}
