// Flat C API over the mxnet_tpu_torch runtime (see mxtpu_c_api.h).
//
// Counterpart of src/c_api.cc (reference: src/c_api/c_api.cc +
// c_api_ndarray.cc).  The reference's C layer marshals into its C++
// engine; this one marshals into the PyTorch port by embedding CPython.
// All the work (dtypes, op dispatch, autograd, kvstore, the predictor)
// lives in mxnet_tpu_torch/c_api_impl.py; this file is only the ABI
// boundary: GIL management, handle lifetimes (handles ARE PyObject*),
// and error capture into MXGetLastError().  The library is built by
// mxnet_tpu_torch._kernels.build_c_api() (g++ with python3-config's
// --includes and --ldflags --embed).

#include "mxtpu_c_api.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;
PyObject *g_impl = nullptr;      // mxnet_tpu_torch.c_api_impl module
PyThreadState *g_main_tstate = nullptr;
bool g_we_initialized = false;
std::mutex g_init_mutex;

// Safe to call WITHOUT the GIL: entry points must check this before
// constructing Gil — PyGILState_Ensure on an uninitialized interpreter
// is a fatal abort, not an error return.
bool runtime_ready() { return Py_IsInitialized() && g_impl != nullptr; }

bool require_ready() {
  if (!runtime_ready()) {
    g_last_error = "MXTPUInit() not called (or failed)";
    return false;
  }
  return true;
}

void capture_py_error() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  if (value != nullptr) {
    PyObject *s = PyObject_Str(value);
    if (s != nullptr) {
      const char *msg = PyUnicode_AsUTF8(s);
      g_last_error = msg ? msg : "<unprintable python error>";
      Py_DECREF(s);
    }
  } else {
    g_last_error = "unknown python error";
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

// RAII GIL hold for every API entry point.
class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

// Call impl.<method>(args...); returns new reference or nullptr (error
// captured).  Caller must hold the GIL.
PyObject *call_impl(const char *method, PyObject *args) {
  if (g_impl == nullptr) {
    g_last_error = "MXTPUInit() not called";
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject *fn = PyObject_GetAttrString(g_impl, method);
  if (fn == nullptr) {
    capture_py_error();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject *res = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  Py_XDECREF(args);
  if (res == nullptr) capture_py_error();
  return res;
}

}  // namespace

extern "C" {

const char *MXGetLastError(void) { return g_last_error.c_str(); }

int MXTPUInit(void) {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (runtime_ready()) return 0;  // idempotent (incl. re-init after
                                  // MXTPUShutdown released the module)
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = true;
    g_impl = PyImport_ImportModule("mxnet_tpu_torch.c_api_impl");
    if (g_impl == nullptr) capture_py_error();
    // release the GIL so other threads (and Gil) can take it
    g_main_tstate = PyEval_SaveThread();
  } else {
    // attached mode: a Python process loaded us (e.g. via ctypes);
    // the interpreter is initialized so taking the GIL is safe even
    // though g_impl is not imported yet
    Gil gil;
    g_impl = PyImport_ImportModule("mxnet_tpu_torch.c_api_impl");
    if (g_impl == nullptr) capture_py_error();
  }
  return g_impl != nullptr ? 0 : -1;
}

int MXTPUShutdown(void) {
  // Releases the framework module; the embedded interpreter stays alive.
  // CPython extension modules (numpy, torch's C deps) do not survive
  // Py_Finalize + re-init, so finalizing would make the documented
  // shutdown->init sequence crash; keeping the interpreter makes
  // MXTPUInit() after shutdown well-defined.
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_impl != nullptr && Py_IsInitialized()) {
    Gil gil;
    Py_DECREF(g_impl);
    g_impl = nullptr;
  }
  return 0;
}

int MXNDArrayCreate(const void *data, size_t nbytes, const int64_t *shape,
                    int ndim, const char *dtype, NDArrayHandle *out) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *buf = PyBytes_FromStringAndSize(
      static_cast<const char *>(data), static_cast<Py_ssize_t>(nbytes));
  PyObject *shp = PyTuple_New(ndim);
  for (int i = 0; i < ndim; ++i)
    PyTuple_SET_ITEM(shp, i, PyLong_FromLongLong(shape[i]));
  PyObject *res = call_impl(
      "create", Py_BuildValue("(NNs)", buf, shp, dtype));
  if (res == nullptr) return -1;
  *out = res;  // ownership moves to the handle
  return 0;
}

int MXNDArrayFree(NDArrayHandle h) {
  if (h == nullptr) return 0;
  if (!require_ready()) return -1;
  Gil gil;
  Py_DECREF(static_cast<PyObject *>(h));
  return 0;
}

int MXNDArrayGetShape(NDArrayHandle h, int *ndim, int64_t shape[8]) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *res = call_impl(
      "shape_of", Py_BuildValue("(O)", static_cast<PyObject *>(h)));
  if (res == nullptr) return -1;
  Py_ssize_t n = PyTuple_Size(res);
  if (n > 8) {
    g_last_error = "ndim > 8 unsupported by the C shape call";
    Py_DECREF(res);
    return -1;
  }
  *ndim = static_cast<int>(n);
  for (Py_ssize_t i = 0; i < n; ++i)
    shape[i] = PyLong_AsLongLong(PyTuple_GET_ITEM(res, i));
  Py_DECREF(res);
  return 0;
}

int MXNDArrayGetDType(NDArrayHandle h, char dtype[16]) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *res = call_impl(
      "dtype_of", Py_BuildValue("(O)", static_cast<PyObject *>(h)));
  if (res == nullptr) return -1;
  const char *s = PyUnicode_AsUTF8(res);
  std::strncpy(dtype, s ? s : "", 15);
  dtype[15] = '\0';
  Py_DECREF(res);
  return 0;
}

int MXNDArraySize(NDArrayHandle h, size_t *nbytes) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *res = call_impl(
      "size_bytes", Py_BuildValue("(O)", static_cast<PyObject *>(h)));
  if (res == nullptr) return -1;
  *nbytes = static_cast<size_t>(PyLong_AsSize_t(res));
  Py_DECREF(res);
  return 0;
}

int MXNDArraySyncCopyToCPU(NDArrayHandle h, void *out, size_t nbytes) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *res = call_impl(
      "to_bytes", Py_BuildValue("(O)", static_cast<PyObject *>(h)));
  if (res == nullptr) return -1;
  char *buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(res, &buf, &len) != 0) {
    capture_py_error();
    Py_DECREF(res);
    return -1;
  }
  if (static_cast<size_t>(len) != nbytes) {
    g_last_error = "MXNDArraySyncCopyToCPU: size mismatch (" +
                   std::to_string(len) + " vs " + std::to_string(nbytes) +
                   " bytes)";
    Py_DECREF(res);
    return -1;
  }
  std::memcpy(out, buf, nbytes);
  Py_DECREF(res);
  return 0;
}

int MXImperativeInvoke(const char *op_name, NDArrayHandle *inputs,
                       int n_inputs, const char **param_keys,
                       const char **param_vals, int n_params,
                       NDArrayHandle *outputs, int *n_out) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *ins = PyList_New(n_inputs);
  for (int i = 0; i < n_inputs; ++i) {
    PyObject *o = static_cast<PyObject *>(inputs[i]);
    Py_INCREF(o);
    PyList_SET_ITEM(ins, i, o);
  }
  PyObject *keys = PyList_New(n_params);
  PyObject *vals = PyList_New(n_params);
  for (int i = 0; i < n_params; ++i) {
    PyList_SET_ITEM(keys, i, PyUnicode_FromString(param_keys[i]));
    PyList_SET_ITEM(vals, i, PyUnicode_FromString(param_vals[i]));
  }
  PyObject *res = call_impl(
      "invoke", Py_BuildValue("(sNNN)", op_name, ins, keys, vals));
  if (res == nullptr) return -1;
  Py_ssize_t n = PyList_Size(res);
  if (n > *n_out) {
    g_last_error = "MXImperativeInvoke: output capacity " +
                   std::to_string(*n_out) + " < " + std::to_string(n);
    Py_DECREF(res);
    return -1;
  }
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *o = PyList_GET_ITEM(res, i);
    Py_INCREF(o);
    outputs[i] = o;
  }
  *n_out = static_cast<int>(n);
  Py_DECREF(res);
  return 0;
}

int MXListAllOpNames(int *count, const char ***names) {
  if (!require_ready()) return -1;
  Gil gil;
  // leak-once static storage, same convention as the reference's
  // MXListAllOpNames (the strings live for the process lifetime)
  static std::vector<std::string> storage;
  static std::vector<const char *> ptrs;
  if (storage.empty()) {
    PyObject *res = call_impl("list_op_names", PyTuple_New(0));
    if (res == nullptr) return -1;
    Py_ssize_t n = PyList_Size(res);
    storage.reserve(n);
    for (Py_ssize_t i = 0; i < n; ++i) {
      const char *s = PyUnicode_AsUTF8(PyList_GET_ITEM(res, i));
      storage.emplace_back(s ? s : "");
    }
    Py_DECREF(res);
    ptrs.reserve(storage.size());
    for (const auto &s : storage) ptrs.push_back(s.c_str());
  }
  *count = static_cast<int>(ptrs.size());
  *names = ptrs.data();
  return 0;
}

// -- autograd -----------------------------------------------------------

static int simple_call(const char *method, NDArrayHandle h) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *res = call_impl(
      method, Py_BuildValue("(O)", static_cast<PyObject *>(h)));
  if (res == nullptr) return -1;
  Py_DECREF(res);
  return 0;
}

int MXAutogradAttachGrad(NDArrayHandle h) {
  return simple_call("attach_grad", h);
}

int MXAutogradRecordStart(void) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *res = call_impl("record_start", PyTuple_New(0));
  if (res == nullptr) return -1;
  Py_DECREF(res);
  return 0;
}

int MXAutogradRecordStop(void) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *res = call_impl("record_stop", PyTuple_New(0));
  if (res == nullptr) return -1;
  Py_DECREF(res);
  return 0;
}

int MXAutogradBackward(NDArrayHandle loss) {
  return simple_call("backward", loss);
}

int MXNDArrayGetGrad(NDArrayHandle h, NDArrayHandle *out) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *res = call_impl(
      "grad_of", Py_BuildValue("(O)", static_cast<PyObject *>(h)));
  if (res == nullptr) return -1;
  *out = res;
  return 0;
}

// -- predictor (reference: c_predict_api.cc) ----------------------------
// Predictor handles are PyLong ids into c_api_impl._PREDICTORS, boxed
// as PyObject* so PredictorHandle stays an opaque pointer.

int MXPredCreate(const char *symbol_json_str, const void *param_bytes,
                 size_t param_size, int dev_type, int dev_id,
                 uint32_t num_input_nodes, const char **input_keys,
                 PredictorHandle *out) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *names = PyList_New(num_input_nodes);
  for (uint32_t i = 0; i < num_input_nodes; ++i) {
    PyObject *s = PyUnicode_FromString(input_keys[i]);
    if (s == nullptr) {  // e.g. invalid UTF-8 key: error, never crash
      capture_py_error();
      Py_DECREF(names);
      return -1;
    }
    PyList_SET_ITEM(names, i, s);
  }
  PyObject *res = call_impl(
      "pred_create",
      Py_BuildValue("(sy#Nii)", symbol_json_str,
                    static_cast<const char *>(param_bytes),
                    static_cast<Py_ssize_t>(param_size), names, dev_type,
                    dev_id));
  if (res == nullptr) return -1;
  *out = res;  // PyLong id, owned by the handle
  return 0;
}

int MXPredSetInput(PredictorHandle h, const char *key, const float *data,
                   const int64_t *shape, int ndim) {
  if (!require_ready()) return -1;
  Gil gil;
  size_t n = 1;
  PyObject *shp = PyList_New(ndim);
  for (int i = 0; i < ndim; ++i) {
    n *= static_cast<size_t>(shape[i]);
    PyList_SET_ITEM(shp, i, PyLong_FromLongLong(shape[i]));
  }
  PyObject *res = call_impl(
      "pred_set_input",
      Py_BuildValue("(Osy#N)", static_cast<PyObject *>(h), key,
                    reinterpret_cast<const char *>(data),
                    static_cast<Py_ssize_t>(n * sizeof(float)), shp));
  if (res == nullptr) return -1;
  Py_DECREF(res);
  return 0;
}

int MXPredForward(PredictorHandle h) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *res = call_impl(
      "pred_forward", Py_BuildValue("(O)", static_cast<PyObject *>(h)));
  if (res == nullptr) return -1;
  Py_DECREF(res);
  return 0;
}

int MXPredGetOutputShape(PredictorHandle h, uint32_t index, int *ndim,
                         int64_t shape[8]) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *res = call_impl(
      "pred_output_shape",
      Py_BuildValue("(OI)", static_cast<PyObject *>(h), index));
  if (res == nullptr) return -1;
  Py_ssize_t n = PyTuple_Size(res);
  if (n > 8) {
    g_last_error = "MXPredGetOutputShape: ndim > 8";
    Py_DECREF(res);
    return -1;
  }
  *ndim = static_cast<int>(n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    shape[i] = PyLong_AsLongLong(PyTuple_GET_ITEM(res, i));
  }
  Py_DECREF(res);
  return 0;
}

int MXPredGetOutput(PredictorHandle h, uint32_t index, float *data,
                    size_t n_floats) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *res = call_impl(
      "pred_get_output",
      Py_BuildValue("(OI)", static_cast<PyObject *>(h), index));
  if (res == nullptr) return -1;
  char *buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(res, &buf, &len) != 0) {
    capture_py_error();
    Py_DECREF(res);
    return -1;
  }
  if (static_cast<size_t>(len) != n_floats * sizeof(float)) {
    g_last_error = "MXPredGetOutput: buffer size mismatch (want " +
                   std::to_string(len) + " bytes)";
    Py_DECREF(res);
    return -1;
  }
  std::memcpy(data, buf, len);
  Py_DECREF(res);
  return 0;
}

int MXPredFree(PredictorHandle h) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *id = static_cast<PyObject *>(h);
  PyObject *res = call_impl("pred_free", Py_BuildValue("(O)", id));
  Py_DECREF(id);
  if (res == nullptr) return -1;
  Py_DECREF(res);
  return 0;
}

// -- kvstore ------------------------------------------------------------

int MXKVStoreCreate(const char *type, KVStoreHandle *out) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *res = call_impl("kv_create", Py_BuildValue("(s)", type));
  if (res == nullptr) return -1;
  *out = static_cast<int>(PyLong_AsLong(res));
  Py_DECREF(res);
  return 0;
}

static int kv_call(const char *method, KVStoreHandle kv, int key,
                   NDArrayHandle v) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *res = call_impl(
      method, Py_BuildValue("(iiO)", kv, key, static_cast<PyObject *>(v)));
  if (res == nullptr) return -1;
  Py_DECREF(res);
  return 0;
}

int MXKVStoreInit(KVStoreHandle kv, int key, NDArrayHandle v) {
  return kv_call("kv_init", kv, key, v);
}

int MXKVStorePush(KVStoreHandle kv, int key, NDArrayHandle v) {
  return kv_call("kv_push", kv, key, v);
}

int MXKVStorePull(KVStoreHandle kv, int key, NDArrayHandle *out) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *res = call_impl("kv_pull", Py_BuildValue("(ii)", kv, key));
  if (res == nullptr) return -1;
  *out = res;
  return 0;
}

int MXKVStoreFree(KVStoreHandle kv) {
  if (!require_ready()) return -1;
  Gil gil;
  PyObject *res = call_impl("kv_free", Py_BuildValue("(i)", kv));
  if (res == nullptr) return -1;
  Py_DECREF(res);
  return 0;
}

}  // extern "C"
