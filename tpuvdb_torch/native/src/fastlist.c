/* tpuvdb_fastlist: CPython C-API helpers for the serving hot path.
 *
 * The engine's row->key resolution gets key bytes out of the C++ KvStore
 * in one FFI call (kv_keys_at: packed blob + per-key lengths), but
 * materializing the python strings one slice at a time in the
 * interpreter cost ~0.5 us/key — at Q=512 x k=10 per batch that was
 * ~2.4 ms, 3x the device scan itself (bench: search.assemble p50).
 * Building the list here with PyUnicode_DecodeUTF8 runs at ~60 ns/key.
 *
 * Loaded as a real extension module (importlib ExtensionFileLoader) by
 * tpuvdb_torch/native/__init__.py (the port's copy of the reference's
 * tpuvdb/native/src/fastlist.c), which builds it beside the C++ library:
 * the native doc store needs both.
 */
#include <Python.h>
#include <stdint.h>

/* keys_from_buffer(addr, lens_addr, n) -> list[str | None]
 *
 * addr:      address of the packed key blob (consecutive UTF-8 keys)
 * lens_addr: address of a uint32[n] array; lens[i] == 0 => None
 * n:         number of entries
 *
 * The caller owns both buffers and must keep them alive for the call
 * (tpuvdb_torch.native.NativeKv.keys_at holds them as locals). */
static PyObject* keys_from_buffer(PyObject* self, PyObject* args) {
  Py_ssize_t addr = 0, lens_addr = 0, n = 0;
  if (!PyArg_ParseTuple(args, "nnn", &addr, &lens_addr, &n)) return NULL;
  const char* p = (const char*)addr;
  const uint32_t* lens = (const uint32_t*)lens_addr;
  PyObject* out = PyList_New(n);
  if (!out) return NULL;
  for (Py_ssize_t i = 0; i < n; i++) {
    uint32_t ln = lens[i];
    if (ln == 0) {
      Py_INCREF(Py_None);
      PyList_SET_ITEM(out, i, Py_None);
    } else {
      PyObject* s = PyUnicode_DecodeUTF8(p, (Py_ssize_t)ln, NULL);
      if (!s) {
        Py_DECREF(out);
        return NULL;
      }
      PyList_SET_ITEM(out, i, s);
      p += ln;
    }
  }
  return out;
}

/* keys_from_buffer_rows(addr, lens_addr, n, row) -> list[list[str|None]]
 *
 * Same contract as keys_from_buffer, but shapes the output as n/row
 * row-sized inner lists (the engine's per-query key lists) — the python
 * slicing loop that re-shaped the flat list cost ~0.3 us per query at
 * serving batch sizes. n must be a multiple of row. */
static PyObject* keys_from_buffer_rows(PyObject* self, PyObject* args) {
  Py_ssize_t addr = 0, lens_addr = 0, n = 0, row = 0;
  if (!PyArg_ParseTuple(args, "nnnn", &addr, &lens_addr, &n, &row))
    return NULL;
  if (row <= 0 || n % row != 0) {
    PyErr_SetString(PyExc_ValueError, "n must be a multiple of row");
    return NULL;
  }
  const char* p = (const char*)addr;
  const uint32_t* lens = (const uint32_t*)lens_addr;
  Py_ssize_t nrows = n / row;
  PyObject* out = PyList_New(nrows);
  if (!out) return NULL;
  Py_ssize_t i = 0;
  for (Py_ssize_t r = 0; r < nrows; r++) {
    PyObject* inner = PyList_New(row);
    if (!inner) {
      Py_DECREF(out);
      return NULL;
    }
    PyList_SET_ITEM(out, r, inner);
    for (Py_ssize_t j = 0; j < row; j++, i++) {
      uint32_t ln = lens[i];
      if (ln == 0) {
        Py_INCREF(Py_None);
        PyList_SET_ITEM(inner, j, Py_None);
      } else {
        PyObject* s = PyUnicode_DecodeUTF8(p, (Py_ssize_t)ln, NULL);
        if (!s) {
          Py_DECREF(out);
          return NULL;
        }
        PyList_SET_ITEM(inner, j, s);
        p += ln;
      }
    }
  }
  return out;
}

static PyMethodDef Methods[] = {
    {"keys_from_buffer", keys_from_buffer, METH_VARARGS,
     "Build a list[str|None] from a packed key blob + uint32 lengths."},
    {"keys_from_buffer_rows", keys_from_buffer_rows, METH_VARARGS,
     "Build a list of row-sized list[str|None] from a packed key blob."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "tpuvdb_fastlist",
    "C-speed list builders for the tpuvdb serving path", -1, Methods,
};

PyMODINIT_FUNC PyInit_tpuvdb_fastlist(void) {
  return PyModule_Create(&moduledef);
}
