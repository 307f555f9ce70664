// Native C API for the JAX registration engine — the equivalent
// of the reference's MEX wrapper boundary (WrapperOpticalFlow2d.cpp:18-155):
// the same 5-command stateful surface (init / register / get-motion / warp /
// close), exposed as a plain C shared library so C, C++, Fortran, MATLAB
// (loadlibrary) and Octave hosts can drive the engine. Internally embeds
// CPython and forwards to native/capi_bridge.py, which runs the JAX
// session.
//
// Layout contract (identical to the MEX wrapper): double arrays, x-fastest
// (flat[i + j*dimx]); motion output is the x-plane then the y-plane.
//
// Build: native/build.sh  ->  native/build/libopticalflow2d.so
// The embedding locates the repo via OF2D_PYTHONPATH (or PYTHONPATH).

#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

static PyObject* g_bridge = nullptr;
static std::string g_last_error = "";
static int g_dimx = 0, g_dimy = 0;

extern "C" {

const char* of2d_last_error(void) { return g_last_error.c_str(); }

static void capture_py_error(const char* where) {
    PyObject *type, *value, *tb;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    g_last_error = std::string(where) + ": ";
    if (value) {
        PyObject* s = PyObject_Str(value);
        if (s) {
            g_last_error += PyUnicode_AsUTF8(s);
            Py_DECREF(s);
        }
    } else {
        g_last_error += "unknown error";
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
}

static int ensure_bridge() {
    if (g_bridge) return 0;
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    // Prepend OF2D_PYTHONPATH (or cwd) so `native.capi_bridge` and
    // `opticalflow2d_tpu` resolve.
    const char* extra = std::getenv("OF2D_PYTHONPATH");
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    if (sys_path && extra) {
        PyObject* p = PyUnicode_FromString(extra);
        PyList_Insert(sys_path, 0, p);
        Py_DECREF(p);
    }
    PyObject* mod = PyImport_ImportModule("native.capi_bridge");
    if (!mod) {
        // fall back to a flat module name if the repo root itself is on path
        PyErr_Clear();
        mod = PyImport_ImportModule("capi_bridge");
    }
    if (!mod) {
        capture_py_error("of2d: import capi_bridge");
        PyGILState_Release(gil);
        return -1;
    }
    g_bridge = mod;
    PyGILState_Release(gil);
    return 0;
}

static PyObject* call_bridge(const char* fn, PyObject* args) {
    PyObject* f = PyObject_GetAttrString(g_bridge, fn);
    if (!f) return nullptr;
    PyObject* r = PyObject_CallObject(f, args);
    Py_DECREF(f);
    return r;
}

int of2d_init(int dimx, int dimy, const int* niter, int nscales, int reg,
              const double* regparams, int nparams, int nrefine, int verbose) {
    if (ensure_bridge() != 0) return -1;
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* niter_list = PyList_New(nscales + 1);
    for (int s = 0; s < nscales + 1; s++) {
        PyList_SetItem(niter_list, s, PyLong_FromLong(niter[s]));
    }
    PyObject* params_list = PyList_New(nparams);
    for (int p = 0; p < nparams; p++) {
        PyList_SetItem(params_list, p, PyFloat_FromDouble(regparams[p]));
    }
    PyObject* args = Py_BuildValue(
        "(iiOiiOii)", dimx, dimy, niter_list, nscales, reg, params_list,
        nrefine, verbose);
    Py_DECREF(niter_list);
    Py_DECREF(params_list);
    PyObject* r = call_bridge("init", args);
    Py_DECREF(args);
    int rc = 0;
    if (!r) {
        capture_py_error("of2d_init");
        rc = -1;
    } else {
        Py_DECREF(r);
        g_dimx = dimx;
        g_dimy = dimy;
    }
    PyGILState_Release(gil);
    return rc;
}

static PyObject* mv_from(const double* data, size_t n) {
    return PyMemoryView_FromMemory(
        reinterpret_cast<char*>(const_cast<double*>(data)),
        n * sizeof(double), PyBUF_READ);
}

int of2d_register_images(const double* iref, const double* imov) {
    if (!g_bridge) { g_last_error = "of2d: not initialized"; return -1; }
    PyGILState_STATE gil = PyGILState_Ensure();
    size_t n = (size_t)g_dimx * g_dimy;
    PyObject* args = PyTuple_Pack(2, mv_from(iref, n), mv_from(imov, n));
    PyObject* r = call_bridge("register_images", args);
    Py_DECREF(args);
    int rc = 0;
    if (!r) { capture_py_error("of2d_register_images"); rc = -1; }
    else Py_DECREF(r);
    PyGILState_Release(gil);
    return rc;
}

static int copy_bytes_out(PyObject* bytes, double* out, size_t n_expected,
                          const char* where) {
    if (!bytes) { capture_py_error(where); return -1; }
    char* buf = nullptr;
    Py_ssize_t len = 0;
    if (PyBytes_AsStringAndSize(bytes, &buf, &len) != 0 ||
        (size_t)len != n_expected * sizeof(double)) {
        g_last_error = std::string(where) + ": bad payload size";
        Py_DECREF(bytes);
        return -1;
    }
    std::memcpy(out, buf, len);
    Py_DECREF(bytes);
    return 0;
}

int of2d_get_motion(double* out) {
    if (!g_bridge) { g_last_error = "of2d: not initialized"; return -1; }
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call_bridge("get_motion", nullptr);
    int rc = copy_bytes_out(r, out, 2 * (size_t)g_dimx * g_dimy, "of2d_get_motion");
    PyGILState_Release(gil);
    return rc;
}

int of2d_warp(const double* img, double* out) {
    if (!g_bridge) { g_last_error = "of2d: not initialized"; return -1; }
    PyGILState_STATE gil = PyGILState_Ensure();
    size_t n = (size_t)g_dimx * g_dimy;
    PyObject* args = PyTuple_Pack(1, mv_from(img, n));
    PyObject* r = call_bridge("warp", args);
    Py_DECREF(args);
    int rc = copy_bytes_out(r, out, n, "of2d_warp");
    PyGILState_Release(gil);
    return rc;
}

int of2d_close(void) {
    if (!g_bridge) return 0;
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = call_bridge("close", nullptr);
    int rc = 0;
    if (!r) { capture_py_error("of2d_close"); rc = -1; }
    else Py_DECREF(r);
    PyGILState_Release(gil);
    return rc;
}

}  // extern "C"
