// _gofr_torch_data: native batch assembly for the training data-loader.
//
// The loader's hot path gathers B shuffled fixed-length windows from a
// memory-mapped token file into one contiguous batch buffer every step.
// NumPy fancy indexing does this in C too, but holds the GIL and walks a
// generic take() path; this extension does straight-line memcpys with the
// GIL RELEASED, so batch assembly for step N+1 overlaps the device step N
// from the prefetch thread (gofr_tpu_torch/data/__init__.py).
//
//   gather_windows(src, starts, window, itemsize, out) -> None
//     src:    buffer (the mmap'd token file, any 1-byte-addressable view)
//     starts: int64 C-contiguous array of ELEMENT offsets, one per row
//     window: elements per row
//     itemsize: bytes per element (2 or 4)
//     out:    writable buffer of len(starts) * window * itemsize bytes

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstring>

namespace {

PyObject *gather_windows(PyObject *, PyObject *args) {
  Py_buffer src, starts, out;
  Py_ssize_t window, itemsize;
  if (!PyArg_ParseTuple(args, "y*y*nny*", &src, &starts, &window, &itemsize,
                        &out))
    return nullptr;

  PyObject *err = nullptr;
  const Py_ssize_t n = starts.len / Py_ssize_t(sizeof(long long));
  const long long *idx = static_cast<const long long *>(starts.buf);
  // validate itemsize FIRST: the divisions below would SIGFPE on 0
  Py_ssize_t row_bytes = 0, src_elems = 0;

  if (itemsize != 2 && itemsize != 4) {
    PyErr_SetString(PyExc_ValueError, "itemsize must be 2 or 4");
    err = Py_None;
  } else if (window <= 0) {
    // a negative window would wrap the memcpy size to ~2^64 bytes
    PyErr_SetString(PyExc_ValueError, "window must be positive");
    err = Py_None;
  } else if (starts.len % Py_ssize_t(sizeof(long long)) != 0) {
    PyErr_SetString(PyExc_ValueError, "starts must be int64");
    err = Py_None;
  } else if (window > PY_SSIZE_T_MAX / itemsize) {
    PyErr_SetString(PyExc_ValueError, "window too large");
    err = Py_None;
  } else if ((row_bytes = window * itemsize,
              src_elems = src.len / itemsize,
              row_bytes > 0 && n > PY_SSIZE_T_MAX / row_bytes)) {
    // n * row_bytes below must not wrap
    PyErr_SetString(PyExc_ValueError, "batch too large");
    err = Py_None;
  } else if (out.len < n * row_bytes) {
    PyErr_SetString(PyExc_ValueError, "out buffer too small");
    err = Py_None;
  } else if (window > src_elems) {
    PyErr_SetString(PyExc_ValueError, "window exceeds source length");
    err = Py_None;
  } else {
    // bounds-check before dropping the GIL; phrased as idx > limit (not
    // idx + window > elems) so a hostile start offset cannot wrap int64
    for (Py_ssize_t i = 0; i < n; ++i) {
      if (idx[i] < 0 || idx[i] > (long long)(src_elems - window)) {
        PyErr_Format(PyExc_IndexError,
                     "window %zd at element %lld out of range (%zd elements)",
                     i, idx[i], src_elems);
        err = Py_None;
        break;
      }
    }
  }
  if (!err) {
    const char *s = static_cast<const char *>(src.buf);
    char *d = static_cast<char *>(out.buf);
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < n; ++i) {
      memcpy(d + i * row_bytes, s + idx[i] * itemsize, size_t(row_bytes));
    }
    Py_END_ALLOW_THREADS
  }

  PyBuffer_Release(&src);
  PyBuffer_Release(&starts);
  PyBuffer_Release(&out);
  if (err) return nullptr;
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"gather_windows", gather_windows, METH_VARARGS,
     "gather_windows(src, starts_int64, window, itemsize, out)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_gofr_torch_data",
    "Native batch gather for the token data-loader (datacore.cc)",
    -1, methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__gofr_torch_data(void) { return PyModule_Create(&moduledef); }
