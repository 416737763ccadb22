/* ntlink_sketch — native rolling ntHash2 minimizer sketching (+ index join).
 *
 * Exact C implementation of the engine's sketch semantics (bit-identical to
 * ops/nthash_np.sketch_codes, itself validated against the reference
 * toolchain's committed indexlr TSV goldens; reference contract:
 * btllib indexlr, invoked at ntLink:199,221-225,243-244):
 *
 *   - ntHash2 split-rotation rolling hash (31/33-bit fields), O(1)/base,
 *   - canonical = fh + rh (mod 2^64); strand '+' iff fh <= rh,
 *   - reported hash = 2nd multi-hash (constant multiply + xorshift),
 *   - windows of w consecutive VALID k-mers (k-mers containing non-ACGT
 *     are skipped; windows span N gaps), leftmost-minimum tie-break,
 *     consecutive duplicate winners deduplicated,
 *   - N handling: the roll restarts after each invalid base (O(k) re-init,
 *     amortized O(1) for rare Ns).
 *
 * API (module functions; the GIL is released during compute):
 *   sketch(codes: u8 buffer, k, w)
 *     -> (n, hashes_bytes u64[n], positions_bytes i64[n], fwd_bytes u8[n])
 *   sketch_join(codes: u8 buffer, k, w,
 *               idx_hashes: u64 buffer (sorted ascending),
 *               idx_cid: i32 buffer, idx_pos: i32 buffer,
 *               idx_strand: u8 buffer)
 *     -> None                       (no minimizer matched the index)
 *      | (n, rpos i32, cid i32, cpos i32, sbits i32, hi i32, lo i32) bytes
 *     sbits: bit0 = contig strand '+', bit1 = read strand '+' (the raw
 *     anchor payload of device_map/host_map).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static const uint64_t SEEDS[4] = {
    0x3C8BFBB395C60474ULL, /* A */
    0x3193C18562A02B4CULL, /* C */
    0x20323ED082572324ULL, /* G */
    0x295549F54BE24456ULL, /* T */
};
#define MULTISEED 0x90B45D39FB6DA1FAULL
#define MULTISHIFT 27

#define M31 0x7FFFFFFFULL
#define M33 0x1FFFFFFFFULL

static inline uint64_t srol_d(uint64_t x, long d)
{
    uint64_t hi = (x >> 33) & M31;
    uint64_t lo = x & M33;
    long da = d % 31, db = d % 33;
    if (da)
        hi = ((hi << da) | (hi >> (31 - da))) & M31;
    if (db)
        lo = ((lo << db) | (lo >> (33 - db))) & M33;
    return (hi << 33) | lo;
}

static inline uint64_t srol1(uint64_t x)
{
    uint64_t hi = (x >> 33) & M31;
    uint64_t lo = x & M33;
    hi = ((hi << 1) | (hi >> 30)) & M31;
    lo = ((lo << 1) | (lo >> 32)) & M33;
    return (hi << 33) | lo;
}

static inline uint64_t sror1(uint64_t x)
{
    uint64_t hi = (x >> 33) & M31;
    uint64_t lo = x & M33;
    hi = ((hi >> 1) | (hi << 30)) & M31;
    lo = ((lo >> 1) | (lo << 32)) & M33;
    return (hi << 33) | lo;
}

typedef struct {
    uint64_t out;   /* reported (multi) hash */
    int64_t pos;    /* k-mer start position */
    uint8_t fwd;    /* 1 iff fh <= rh */
} MinOut;

typedef struct {
    uint64_t key;  /* canonical hash (minimization key) */
    int64_t pos;
    int64_t vidx;  /* index in the valid-kmer sequence */
    uint8_t fwd;
} DqEnt;

/* Core sweep: emits minimizers into out (capacity >= n-k+1). Returns the
 * number emitted, or -1 on allocation failure. */
static Py_ssize_t sketch_core(const uint8_t *codes, Py_ssize_t n, long k,
                              long w, MinOut *out)
{
    Py_ssize_t m = n - k + 1;
    if (m <= 0 || w <= 0)
        return 0;

    uint64_t fA[5], fAk[5], rC[5], rCk[5];
    for (int b = 0; b < 4; b++) {
        fA[b] = SEEDS[b];
        fAk[b] = srol_d(SEEDS[b], k);
        rC[b] = SEEDS[3 - b];
        rCk[b] = srol_d(SEEDS[3 - b], k);
    }
    fA[4] = fAk[4] = rC[4] = rCk[4] = 0; /* never used for valid k-mers */
    uint64_t mult = (uint64_t)1 ^ ((uint64_t)(uint64_t)k * MULTISEED);

    Py_ssize_t cap = 2;
    while (cap < w + 1)
        cap <<= 1; /* power of two: ring arithmetic is a mask */
    Py_ssize_t mask = cap - 1;
    DqEnt *dq = (DqEnt *)malloc((size_t)cap * sizeof(DqEnt));
    if (!dq)
        return -1;
    Py_ssize_t head = 0, len = 0; /* ring deque */

    int64_t vcount = 0;
    int64_t last_bad = -1;
    int64_t last_emitted = -2;
    Py_ssize_t n_out = 0;
    int have = 0;
    uint64_t fh = 0, rh = 0;

    for (Py_ssize_t j = 0; j < k - 1; j++)
        if (codes[j] > 3)
            last_bad = j;

    for (Py_ssize_t e = k - 1; e < n; e++) {
        uint8_t cnew = codes[e];
        if (cnew > 3) {
            last_bad = e;
            have = 0;
            continue;
        }
        Py_ssize_t s = e - k + 1;
        if (last_bad >= s) {
            have = 0;
            continue;
        }
        if (have) {
            uint8_t cold = codes[s - 1];
            fh = srol1(fh) ^ fAk[cold] ^ fA[cnew];
            rh = sror1(rh ^ rC[cold] ^ rCk[cnew]);
        } else {
            fh = 0;
            for (long j = 0; j < k; j++)
                fh = srol1(fh) ^ fA[codes[s + j]];
            /* descending Horner: term j accumulates exactly j rotations,
             * giving rh = XOR_j srol^j(C(s+j)) */
            rh = 0;
            for (long j = k - 1; j >= 0; j--)
                rh = srol1(rh) ^ rC[codes[s + j]];
        }
        have = 1;
        uint64_t canon = fh + rh;
        uint8_t fwd = fh <= rh;
        int64_t vidx = vcount++;

        /* pop back while strictly greater (equal keys keep the leftmost) */
        while (len > 0) {
            Py_ssize_t tail = (head + len - 1) & mask;
            if (dq[tail].key > canon)
                len--;
            else
                break;
        }
        Py_ssize_t tail = (head + len) & mask;
        dq[tail].key = canon;
        dq[tail].pos = s;
        dq[tail].vidx = vidx;
        dq[tail].fwd = fwd;
        len++;
        while (len > 0 && dq[head].vidx <= vidx - w) {
            head = (head + 1) & mask;
            len--;
        }
        if (vcount >= w) {
            DqEnt *f = &dq[head];
            if (f->pos != last_emitted) {
                last_emitted = f->pos;
                uint64_t t = f->key * mult;
                out[n_out].out = t ^ (t >> MULTISHIFT);
                out[n_out].pos = f->pos;
                out[n_out].fwd = f->fwd;
                n_out++;
            }
        }
    }
    free(dq);
    return n_out;
}

static PyObject *py_sketch(PyObject *self, PyObject *args)
{
    Py_buffer codes_v;
    long k, w;
    if (!PyArg_ParseTuple(args, "y*ll", &codes_v, &k, &w))
        return NULL;
    const uint8_t *codes = (const uint8_t *)codes_v.buf;
    Py_ssize_t n = codes_v.len;
    Py_ssize_t m = n - k + 1;
    MinOut *out = NULL;
    Py_ssize_t n_out = 0;
    if (m > 0) {
        out = (MinOut *)malloc((size_t)m * sizeof(MinOut));
        if (!out) {
            PyBuffer_Release(&codes_v);
            return PyErr_NoMemory();
        }
        Py_BEGIN_ALLOW_THREADS
        n_out = sketch_core(codes, n, k, w, out);
        Py_END_ALLOW_THREADS
        if (n_out < 0) {
            free(out);
            PyBuffer_Release(&codes_v);
            return PyErr_NoMemory();
        }
    }
    PyObject *hb = PyBytes_FromStringAndSize(NULL, n_out * 8);
    PyObject *pb = PyBytes_FromStringAndSize(NULL, n_out * 8);
    PyObject *fb = PyBytes_FromStringAndSize(NULL, n_out);
    if (hb && pb && fb) {
        uint64_t *hp = (uint64_t *)PyBytes_AS_STRING(hb);
        int64_t *pp = (int64_t *)PyBytes_AS_STRING(pb);
        uint8_t *fp = (uint8_t *)PyBytes_AS_STRING(fb);
        for (Py_ssize_t i = 0; i < n_out; i++) {
            hp[i] = out[i].out;
            pp[i] = out[i].pos;
            fp[i] = out[i].fwd;
        }
    }
    free(out);
    PyBuffer_Release(&codes_v);
    if (!hb || !pb || !fb) {
        Py_XDECREF(hb);
        Py_XDECREF(pb);
        Py_XDECREF(fb);
        return NULL;
    }
    PyObject *res = Py_BuildValue("nNNN", n_out, hb, pb, fb);
    return res;
}

static inline Py_ssize_t bsearch_u64(const uint64_t *arr, Py_ssize_t n,
                                     uint64_t key)
{
    Py_ssize_t lo = 0, hi = n;
    while (lo < hi) {
        Py_ssize_t mid = lo + ((hi - lo) >> 1);
        if (arr[mid] < key)
            lo = mid + 1;
        else
            hi = mid;
    }
    if (lo < n && arr[lo] == key)
        return lo;
    return -1;
}

static PyObject *py_sketch_join(PyObject *self, PyObject *args)
{
    Py_buffer codes_v, ih_v, ic_v, ip_v, is_v;
    long k, w;
    if (!PyArg_ParseTuple(args, "y*lly*y*y*y*", &codes_v, &k, &w, &ih_v,
                          &ic_v, &ip_v, &is_v))
        return NULL;
    const uint8_t *codes = (const uint8_t *)codes_v.buf;
    Py_ssize_t n = codes_v.len;
    const uint64_t *ih = (const uint64_t *)ih_v.buf;
    const int32_t *ic = (const int32_t *)ic_v.buf;
    const int32_t *ip = (const int32_t *)ip_v.buf;
    const uint8_t *is = (const uint8_t *)is_v.buf;
    Py_ssize_t n_idx = ih_v.len / 8;

    Py_ssize_t m = n - k + 1;
    MinOut *mins = NULL;
    int32_t *rpos = NULL, *cid = NULL, *cpos = NULL, *sbits = NULL;
    int32_t *hi = NULL, *lo = NULL;
    Py_ssize_t n_hit = 0;
    int oom = 0;

    if (m > 0) {
        mins = (MinOut *)malloc((size_t)m * sizeof(MinOut));
        if (!mins)
            oom = 1;
    }
    if (!oom && m > 0) {
        Py_BEGIN_ALLOW_THREADS
        Py_ssize_t n_min = sketch_core(codes, n, k, w, mins);
        if (n_min < 0) {
            oom = 1;
        } else if (n_min > 0) {
            rpos = (int32_t *)malloc((size_t)n_min * sizeof(int32_t));
            cid = (int32_t *)malloc((size_t)n_min * sizeof(int32_t));
            cpos = (int32_t *)malloc((size_t)n_min * sizeof(int32_t));
            sbits = (int32_t *)malloc((size_t)n_min * sizeof(int32_t));
            hi = (int32_t *)malloc((size_t)n_min * sizeof(int32_t));
            lo = (int32_t *)malloc((size_t)n_min * sizeof(int32_t));
            if (!rpos || !cid || !cpos || !sbits || !hi || !lo) {
                oom = 1;
            } else {
                for (Py_ssize_t i = 0; i < n_min; i++) {
                    Py_ssize_t j = bsearch_u64(ih, n_idx, mins[i].out);
                    if (j < 0)
                        continue;
                    rpos[n_hit] = (int32_t)mins[i].pos;
                    cid[n_hit] = ic[j];
                    cpos[n_hit] = ip[j];
                    sbits[n_hit] =
                        (is[j] ? 1 : 0) | (mins[i].fwd ? 2 : 0);
                    hi[n_hit] = (int32_t)(uint32_t)(mins[i].out >> 32);
                    lo[n_hit] =
                        (int32_t)(uint32_t)(mins[i].out & 0xFFFFFFFFULL);
                    n_hit++;
                }
            }
        }
        Py_END_ALLOW_THREADS
    }
    free(mins);

    PyObject *res = NULL;
    if (oom) {
        PyErr_NoMemory();
    } else if (n_hit == 0) {
        res = Py_None;
        Py_INCREF(res);
    } else {
        PyObject *bufs[6] = {NULL};
        int32_t *srcs[6] = {rpos, cid, cpos, sbits, hi, lo};
        int ok = 1;
        for (int i = 0; i < 6; i++) {
            bufs[i] = PyBytes_FromStringAndSize((const char *)srcs[i],
                                                n_hit * sizeof(int32_t));
            if (!bufs[i])
                ok = 0;
        }
        if (ok)
            res = Py_BuildValue("nNNNNNN", n_hit, bufs[0], bufs[1], bufs[2],
                                bufs[3], bufs[4], bufs[5]);
        if (!res)
            for (int i = 0; i < 6; i++)
                Py_XDECREF(bufs[i]);
    }
    free(rpos);
    free(cid);
    free(cpos);
    free(sbits);
    free(hi);
    free(lo);
    PyBuffer_Release(&codes_v);
    PyBuffer_Release(&ih_v);
    PyBuffer_Release(&ic_v);
    PyBuffer_Release(&ip_v);
    PyBuffer_Release(&is_v);
    return res;
}

static PyMethodDef sketch_methods[] = {
    {"sketch", py_sketch, METH_VARARGS,
     "sketch(codes, k, w) -> (n, hashes_u64, positions_i64, fwd_u8) bytes"},
    {"sketch_join", py_sketch_join, METH_VARARGS,
     "sketch_join(codes, k, w, idx_hashes, idx_cid, idx_pos, idx_strand) "
     "-> None | (n, rpos, cid, cpos, sbits, hi, lo) i32 bytes"},
    {NULL, NULL, 0, NULL},
};

static PyModuleDef sketch_module = {
    PyModuleDef_HEAD_INIT,
    .m_name = "ntlink_sketch",
    .m_doc = "Native rolling ntHash2 minimizer sketching + index join",
    .m_size = -1,
    .m_methods = sketch_methods,
};

PyMODINIT_FUNC PyInit_ntlink_sketch(void)
{
    return PyModule_Create(&sketch_module);
}
