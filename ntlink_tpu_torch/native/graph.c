/* ntlink_graph — native scaffold-graph kernels.
 *
 * transitive_reduce(n_nodes, src, dst, max_hops) -> bytes keep-mask
 *
 * Bit-compatible native implementation of layout.remove_transitive_edges'
 * sequential per-edge reachability check (the layout engine's hottest loop
 * on dense noisy graphs; the reference delegates this regime to ABySS
 * abyss-scaffold, invoked at ntLink:228-231). Semantics replicated exactly,
 * including the parts where the answer depends on traversal order:
 *
 *   - edges are processed in the given (insertion) order; an edge removed
 *     earlier is no longer available to later reachability queries,
 *   - the reachability walk is a LIFO stack seeded with the source's
 *     successors in adjacency order (direct edge excluded), popping the
 *     most recently pushed first,
 *   - a node is marked seen when popped at depth < max_hops (the mark is
 *     depth-insensitive), and the target is tested at push time, exactly
 *     like the Python walk in layout._has_alternate_path.
 *
 * The successor arrays are built by appending edges in input order, which
 * reproduces the per-source insertion order of the Python dict adjacency.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    int32_t node;
    int32_t depth;
} Frame;

static PyObject *py_transitive_reduce(PyObject *self, PyObject *args)
{
    Py_ssize_t n_nodes;
    PyObject *src_obj, *dst_obj;
    Py_ssize_t max_hops;
    if (!PyArg_ParseTuple(args, "nOOn", &n_nodes, &src_obj, &dst_obj,
                          &max_hops))
        return NULL;

    Py_buffer src_view, dst_view;
    if (PyObject_GetBuffer(src_obj, &src_view, PyBUF_SIMPLE) < 0)
        return NULL;
    if (PyObject_GetBuffer(dst_obj, &dst_view, PyBUF_SIMPLE) < 0) {
        PyBuffer_Release(&src_view);
        return NULL;
    }
    if (src_view.len != dst_view.len || src_view.len % 4 != 0) {
        PyBuffer_Release(&src_view);
        PyBuffer_Release(&dst_view);
        PyErr_SetString(PyExc_ValueError,
                        "src/dst must be equal-length int32 buffers");
        return NULL;
    }
    Py_ssize_t n_edges = src_view.len / 4;
    const int32_t *src = src_view.buf;
    const int32_t *dst = dst_view.buf;

    PyObject *out = PyBytes_FromStringAndSize(NULL, n_edges);
    if (!out) {
        PyBuffer_Release(&src_view);
        PyBuffer_Release(&dst_view);
        return NULL;
    }
    unsigned char *keep = (unsigned char *)PyBytes_AS_STRING(out);

    int ok = 1;
    Py_BEGIN_ALLOW_THREADS
    {
        /* per-node successor lists (edge ids) in input order: CSR built
         * with a counting pass */
        int32_t *head = calloc((size_t)n_nodes + 1, sizeof(int32_t));
        int32_t *succ_edge = malloc(sizeof(int32_t) * (size_t)(n_edges ? n_edges : 1));
        int32_t *fill = calloc((size_t)n_nodes ? (size_t)n_nodes : 1, sizeof(int32_t));
        uint32_t *stamp = calloc((size_t)n_nodes ? (size_t)n_nodes : 1, sizeof(uint32_t));
        unsigned char *alive = malloc((size_t)(n_edges ? n_edges : 1));
        size_t stack_cap = 1024;
        Frame *stack = malloc(sizeof(Frame) * stack_cap);
        if (!head || !succ_edge || !fill || !stamp || !alive || !stack) {
            ok = 0;
            goto cleanup;
        }
        for (Py_ssize_t i = 0; i < n_edges; i++)
            head[src[i] + 1]++;
        for (Py_ssize_t v = 0; v < n_nodes; v++)
            head[v + 1] += head[v];
        for (Py_ssize_t i = 0; i < n_edges; i++) {
            int32_t s = src[i];
            succ_edge[head[s] + fill[s]] = (int32_t)i;
            fill[s]++;
        }
        memset(alive, 1, (size_t)n_edges);
        uint32_t epoch = 0;

        for (Py_ssize_t e = 0; e < n_edges; e++) {
            int32_t s = src[e];
            int32_t t = dst[e];
            epoch++;
            stamp[s] = epoch; /* seen = {source} */
            size_t top = 0;
            int found = 0;
            /* seed: source's live successors, direct edge excluded */
            for (int32_t j = head[s]; j < head[s + 1]; j++) {
                int32_t ei = succ_edge[j];
                if (!alive[ei] || dst[ei] == t)
                    continue;
                if (top == stack_cap) {
                    stack_cap *= 2;
                    Frame *ns = realloc(stack, sizeof(Frame) * stack_cap);
                    if (!ns) { ok = 0; goto cleanup; }
                    stack = ns;
                }
                stack[top].node = dst[ei];
                stack[top].depth = 1;
                top++;
            }
            while (top) {
                top--;
                int32_t node = stack[top].node;
                int32_t depth = stack[top].depth;
                if (node == t) { found = 1; break; }
                if (depth >= max_hops || stamp[node] == epoch)
                    continue;
                stamp[node] = epoch;
                for (int32_t j = head[node]; j < head[node + 1]; j++) {
                    int32_t ei = succ_edge[j];
                    if (!alive[ei])
                        continue;
                    int32_t nxt = dst[ei];
                    if (nxt == t) { found = 1; break; }
                    if (top == stack_cap) {
                        stack_cap *= 2;
                        Frame *ns = realloc(stack, sizeof(Frame) * stack_cap);
                        if (!ns) { ok = 0; goto cleanup; }
                        stack = ns;
                    }
                    stack[top].node = nxt;
                    stack[top].depth = depth + 1;
                    top++;
                }
                if (found)
                    break;
            }
            if (found)
                alive[e] = 0;
            keep[e] = alive[e];
        }

    cleanup:
        free(head);
        free(succ_edge);
        free(fill);
        free(stamp);
        free(alive);
        free(stack);
    }
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&src_view);
    PyBuffer_Release(&dst_view);
    if (!ok) {
        Py_DECREF(out);
        return PyErr_NoMemory();
    }
    return out;
}

static PyMethodDef graph_methods[] = {
    {"transitive_reduce", py_transitive_reduce, METH_VARARGS,
     "transitive_reduce(n_nodes, src_int32, dst_int32, max_hops) -> "
     "keep-mask bytes"},
    {NULL, NULL, 0, NULL},
};

static PyModuleDef graph_module = {
    PyModuleDef_HEAD_INIT,
    .m_name = "ntlink_graph",
    .m_doc = "Native scaffold-graph kernels",
    .m_size = -1,
    .m_methods = graph_methods,
};

PyMODINIT_FUNC PyInit_ntlink_graph(void)
{
    return PyModule_Create(&graph_module);
}
