/* Native byte-trie tokenizer: greedy longest-match encode for the RWKV world
 * vocabulary, a CPython C API module (the port's own copy of the JAX
 * package's chirrup_tpu/native/trie_tokenizer.c).
 *
 * The server tokenizes every prompt on the request path; this trie encodes
 * far faster than the pure-Python one. Children are sorted (byte, child)
 * arrays with binary search, so memory stays ~30 bytes/node instead of
 * 2KB/node for 256-entry fanout tables.
 *
 * Python surface:
 *   t = NativeTrie({token_id: token_bytes, ...})
 *   ids = t.encode(b"some bytes")   -> list[int]
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdlib.h>
#include <string.h>

typedef struct Node {
    struct Node **children;   /* sorted by edge byte */
    unsigned char *edges;     /* edge bytes, parallel to children */
    int n_children;
    int cap_children;
    int token_id;             /* -1 if not a token end */
} Node;

static Node *node_new(void) {
    Node *n = (Node *)calloc(1, sizeof(Node));
    if (n) n->token_id = -1;
    return n;
}

static void node_free(Node *n) {
    if (!n) return;
    for (int i = 0; i < n->n_children; i++) node_free(n->children[i]);
    free(n->children);
    free(n->edges);
    free(n);
}

static int node_find(const Node *n, unsigned char b) {
    int lo = 0, hi = n->n_children - 1;
    while (lo <= hi) {
        int mid = (lo + hi) >> 1;
        unsigned char e = n->edges[mid];
        if (e == b) return mid;
        if (e < b) lo = mid + 1; else hi = mid - 1;
    }
    return -(lo + 1); /* insertion point encoding */
}

static Node *node_child_or_insert(Node *n, unsigned char b) {
    int idx = node_find(n, b);
    if (idx >= 0) return n->children[idx];
    int at = -idx - 1;
    if (n->n_children == n->cap_children) {
        int cap = n->cap_children ? n->cap_children * 2 : 2;
        /* each array is stored as soon as its realloc succeeds, so a failed
         * second realloc leaves the node consistent (the old pointer freed
         * by the first realloc is never kept) */
        Node **nc = (Node **)realloc(n->children, cap * sizeof(Node *));
        if (!nc) return NULL;
        n->children = nc;
        unsigned char *ne = (unsigned char *)realloc(n->edges, cap);
        if (!ne) return NULL;
        n->edges = ne;
        n->cap_children = cap;
    }
    memmove(n->children + at + 1, n->children + at,
            (n->n_children - at) * sizeof(Node *));
    memmove(n->edges + at + 1, n->edges + at, n->n_children - at);
    Node *child = node_new();
    if (!child) return NULL;
    n->children[at] = child;
    n->edges[at] = b;
    n->n_children++;
    return child;
}

/* ------------------------------------------------------------------ object */

typedef struct {
    PyObject_HEAD
    Node *root;
} NativeTrieObject;

static void NativeTrie_dealloc(NativeTrieObject *self) {
    node_free(self->root);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static int NativeTrie_init(NativeTrieObject *self, PyObject *args, PyObject *kwds) {
    PyObject *vocab;
    if (!PyArg_ParseTuple(args, "O!", &PyDict_Type, &vocab)) return -1;

    node_free(self->root); /* __init__ called again: start a new trie */
    self->root = node_new();
    if (!self->root) { PyErr_NoMemory(); return -1; }

    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(vocab, &pos, &key, &value)) {
        long tid = PyLong_AsLong(key);
        if (tid == -1 && PyErr_Occurred()) return -1;
        if (tid == 0) continue; /* <|endoftext|> is special, never matched by text */
        char *buf;
        Py_ssize_t len;
        if (PyBytes_AsStringAndSize(value, &buf, &len) < 0) return -1;
        Node *n = self->root;
        for (Py_ssize_t i = 0; i < len; i++) {
            n = node_child_or_insert(n, (unsigned char)buf[i]);
            if (!n) { PyErr_NoMemory(); return -1; }
        }
        n->token_id = (int)tid;
    }
    return 0;
}

static PyObject *NativeTrie_encode(NativeTrieObject *self, PyObject *arg) {
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
    const unsigned char *data = (const unsigned char *)view.buf;
    Py_ssize_t n = view.len;

    PyObject *out = PyList_New(0);
    if (!out) { PyBuffer_Release(&view); return NULL; }

    Py_ssize_t i = 0;
    while (i < n) {
        const Node *node = self->root;
        int best_id = -1;
        Py_ssize_t best_end = i;
        Py_ssize_t j = i;
        while (j < n) {
            int idx = node_find(node, data[j]);
            if (idx < 0) break;
            node = node->children[idx];
            j++;
            if (node->token_id >= 0) { best_id = node->token_id; best_end = j; }
        }
        if (best_id < 0) {
            PyBuffer_Release(&view);
            Py_DECREF(out);
            PyErr_Format(PyExc_ValueError,
                         "byte 0x%02x at offset %zd not in vocabulary",
                         data[i], (Py_ssize_t)i);
            return NULL;
        }
        PyObject *tid = PyLong_FromLong(best_id);
        if (!tid || PyList_Append(out, tid) < 0) {
            Py_XDECREF(tid);
            PyBuffer_Release(&view);
            Py_DECREF(out);
            return NULL;
        }
        Py_DECREF(tid);
        i = best_end;
    }
    PyBuffer_Release(&view);
    return out;
}

static PyMethodDef NativeTrie_methods[] = {
    {"encode", (PyCFunction)NativeTrie_encode, METH_O,
     "encode(data: bytes) -> list[int] — greedy longest-match tokenize"},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject NativeTrieType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "trie_tokenizer.NativeTrie",
    .tp_basicsize = sizeof(NativeTrieObject),
    .tp_dealloc = (destructor)NativeTrie_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Native greedy longest-match byte trie",
    .tp_methods = NativeTrie_methods,
    .tp_init = (initproc)NativeTrie_init,
    .tp_new = PyType_GenericNew,
};

static PyModuleDef trie_module = {
    PyModuleDef_HEAD_INIT, "trie_tokenizer",
    "Native byte-trie tokenizer for the RWKV world vocabulary", -1, NULL,
};

PyMODINIT_FUNC PyInit_trie_tokenizer(void) {
    PyObject *m;
    if (PyType_Ready(&NativeTrieType) < 0) return NULL;
    m = PyModule_Create(&trie_module);
    if (!m) return NULL;
    Py_INCREF(&NativeTrieType);
    if (PyModule_AddObject(m, "NativeTrie", (PyObject *)&NativeTrieType) < 0) {
        Py_DECREF(&NativeTrieType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
