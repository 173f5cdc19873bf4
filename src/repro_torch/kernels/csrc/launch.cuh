// What every launcher of the port shares. Each csrc/<name>.cu includes this
// once and is built into a library of its own (kernels/build.py), which
// REPRO_PY_MODULE below makes a Python extension module.
//
// Why not ctypes: ctypes converts each argument of a call through its
// argtypes, about 3.3 us for rmsnorm's eleven on the H100's host, more than
// the kernel's device time. Here the conversions are typed at compile time
// from the launcher's own signature and cost a few hundred nanoseconds.
// Nothing here includes PyTorch's headers, so a library still builds in
// seconds.
#pragma once
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <mutex>
#include <tuple>
#include <utility>

namespace repro {

// Makes `device` current for one launch and gives the caller's device back
// after it, so the Python wrapper passes its tensors' device index and
// enters no device context. Setting the device that is already current is
// skipped; reading it costs no driver call.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) : device_(device) {
    error_ = cudaGetDevice(&prev_);
    if (error_ == cudaSuccess && prev_ != device_)
      error_ = cudaSetDevice(device_);
  }
  ~DeviceGuard() {
    if (prev_ >= 0 && prev_ != device_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  int error() const { return (int)error_; }

 private:
  int device_;
  int prev_ = -1;
  cudaError_t error_;
};

// Raises one kernel's dynamic shared memory limit on a device only when a
// launch needs more than it was last raised to there: the attribute holds
// for the process, so a launch of a size already seen makes no driver
// call. A launcher keeps one of these, static, per kernel instantiation,
// and calls it after DeviceGuard has made `device` current.
class SmemLimit {
 public:
  template <typename Kernel>
  cudaError_t ensure(Kernel* kernel, int bytes, int device) {
    if (device < 0 || device >= kDevices)
      return cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (bytes <= raised_[device].load(std::memory_order_acquire))
      return cudaSuccess;
    // the limit only rises, also when two threads raise it at once
    std::lock_guard<std::mutex> lock(mutex_);
    const int target = std::max(bytes, raised_[device].load());
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, target);
    if (err == cudaSuccess)
      raised_[device].store(target, std::memory_order_release);
    return err;
  }

 private:
  static constexpr int kDevices = 64;
  std::atomic<int> raised_[kDevices] = {};
  std::mutex mutex_;
};

// One launcher parameter from a Python object: a pointer from an int (None
// is null), an integer from an int, a float from a float. A bad value sets
// a Python error, which call() checks before it launches anything.
template <typename T>
struct FromPy;
template <typename T>
struct FromPy<T*> {
  static T* get(PyObject* o) {
    return o == Py_None ? nullptr : static_cast<T*>(PyLong_AsVoidPtr(o));
  }
};
template <>
struct FromPy<int> {
  static int get(PyObject* o) {
    const long v = PyLong_AsLong(o);
    if (v < INT_MIN || v > INT_MAX)
      PyErr_SetString(PyExc_OverflowError, "launcher argument exceeds int");
    return (int)v;
  }
};
template <>
struct FromPy<int64_t> {
  static int64_t get(PyObject* o) { return PyLong_AsLongLong(o); }
};
template <>
struct FromPy<float> {
  static float get(PyObject* o) { return (float)PyFloat_AsDouble(o); }
};

template <typename... P, size_t... I>
PyObject* call(int (*fn)(P...), PyObject* const* args,
               std::index_sequence<I...>) {
  std::tuple<P...> values{FromPy<P>::get(args[I])...};   // left to right
  if (PyErr_Occurred()) return nullptr;
  return PyLong_FromLong(std::apply(fn, values));
}

// Calls the C launcher `fn` with Python's positional `args`, converted to
// its parameters' types; returns its cudaError_t as an int.
template <typename... P>
PyObject* call(int (*fn)(P...), PyObject* const* args, Py_ssize_t n) {
  if (n != (Py_ssize_t)sizeof...(P)) {
    PyErr_Format(PyExc_TypeError, "the launcher takes %d arguments, not %zd",
                 (int)sizeof...(P), n);
    return nullptr;
  }
  return call(fn, args, std::index_sequence_for<P...>{});
}

// The further launchers of a library with more than one kernel, which
// REPRO_PY_ALSO registers while the library loads and REPRO_PY_MODULE adds
// to the module beside `launch`.
struct AlsoMethods {
  static constexpr int kMax = 4;
  PyMethodDef defs[kMax + 1] = {};   // null-terminated
  int count = 0;
};
inline AlsoMethods& also_methods() {
  static AlsoMethods methods;
  return methods;
}
struct AlsoLaunch {
  AlsoLaunch(const char* name, PyCFunction fn) {
    AlsoMethods& m = also_methods();
    if (m.count < AlsoMethods::kMax)
      m.defs[m.count++] = {name, fn, METH_FASTCALL,
                           "Launch a kernel; returns cudaGetLastError() as "
                           "an int."};
  }
};

}  // namespace repro

// A further launcher of the library, as the module function `pyname`; put it
// before REPRO_PY_MODULE.
#define REPRO_PY_ALSO(pyname, launcher)                                       \
  static PyObject* repro_py_##pyname(PyObject*, PyObject* const* args,        \
                                     Py_ssize_t n) {                          \
    return repro::call(launcher, args, n);                                    \
  }                                                                           \
  static repro::AlsoLaunch repro_py_also_##pyname(                            \
      #pyname, (PyCFunction)(void (*)(void))repro_py_##pyname);

// The library as the Python extension module `repro_kernel_<name>`, with
// launch(*args) -> cudaError_t of `launcher`, each REPRO_PY_ALSO launcher,
// and error_string(code).
#define REPRO_PY_MODULE(name, launcher)                                       \
  static PyObject* repro_py_launch(PyObject*, PyObject* const* args,          \
                                   Py_ssize_t n) {                            \
    return repro::call(launcher, args, n);                                    \
  }                                                                           \
  static PyObject* repro_py_error_string(PyObject*, PyObject* code) {         \
    const long c = PyLong_AsLong(code);                                       \
    if (c == -1 && PyErr_Occurred()) return nullptr;                          \
    return PyUnicode_FromString(cudaGetErrorString((cudaError_t)c));          \
  }                                                                           \
  static PyMethodDef repro_py_methods[] = {                                   \
      {"launch", (PyCFunction)(void (*)(void))repro_py_launch, METH_FASTCALL, \
       "Launch the kernel; returns cudaGetLastError() as an int."},           \
      {"error_string", repro_py_error_string, METH_O,                         \
       "cudaGetErrorString of a cudaError_t."},                               \
      {nullptr, nullptr, 0, nullptr}};                                        \
  static PyModuleDef repro_py_module = {                                      \
      PyModuleDef_HEAD_INIT, "repro_kernel_" #name, nullptr, -1,              \
      repro_py_methods};                                                      \
  PyMODINIT_FUNC PyInit_repro_kernel_##name(void) {                           \
    PyObject* module = PyModule_Create(&repro_py_module);                     \
    repro::AlsoMethods& also = repro::also_methods();                         \
    if (module && also.count &&                                               \
        PyModule_AddFunctions(module, also.defs) < 0) {                       \
      Py_DECREF(module);                                                      \
      return nullptr;                                                         \
    }                                                                         \
    return module;                                                            \
  }
