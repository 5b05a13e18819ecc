// tachyon_tpu C ABI over the PyTorch/CUDA port: embeds CPython and
// dispatches into the tachyon_tpu_torch.c.bridge module (which owns all
// byte and tensor plumbing).
//
// The port's counterpart of tachyon_tpu/c/c_api.cc, with the same symbols
// and error model.  Analog of the reference's C API layer (reference:
// tachyon/c/, e.g. c/math/elliptic_curves/msm/msm.cc,
// c/zk/plonk/halo2/bn254_prover.cc): there the C shims call the C++
// template core; here they call the port through an interpreter, embedded
// when the host process has none, or the caller's own (a ctypes caller).
// tachyon_tpu_init(platform) passes the platform to bridge.init, which
// selects the card ("cuda", "gpu", NULL, "") or the CPU ("cpu") and fails
// on anything else, or on the card without CUDA.  The GIL is taken per
// call, so the library is safe to use from multiple host threads (calls
// serialize, matching the one-card execution model).
//
// Build: make -C tachyon_tpu_torch/c (into tachyon_tpu_torch/_build/c)
#define PY_SSIZE_T_CLEAN  // y#/s# take Py_ssize_t lengths
#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

#include "api.h"

namespace {

std::mutex g_mu;
bool g_inited = false;
PyObject* g_bridge = nullptr;          // tachyon_tpu_torch.c.bridge module
thread_local std::string g_last_error;

void set_error_from_python() {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* c = PyUnicode_AsUTF8(s);
      g_last_error = c ? c : "unknown python error";
      Py_DECREF(s);
    }
  } else {
    g_last_error = "unknown python error";
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

// Calls bridge.<fn>(*args); returns new ref or nullptr (error recorded).
PyObject* call_bridge(const char* fn, PyObject* args) {
  PyObject* f = PyObject_GetAttrString(g_bridge, fn);
  if (!f) {
    set_error_from_python();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* ret = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (!ret) set_error_from_python();
  return ret;
}

struct GILGuard {
  PyGILState_STATE st;
  GILGuard() : st(PyGILState_Ensure()) {}
  ~GILGuard() { PyGILState_Release(st); }
};

}  // namespace

extern "C" {

uint32_t tachyon_tpu_version(void) { return TACHYON_TPU_VERSION; }

const char* tachyon_tpu_version_str(void) {
  static char buf[32];
  snprintf(buf, sizeof(buf), "%d.%d.%d", TACHYON_TPU_VERSION_MAJOR,
           TACHYON_TPU_VERSION_MINOR, TACHYON_TPU_VERSION_PATCH);
  return buf;
}

const char* tachyon_tpu_last_error(void) { return g_last_error.c_str(); }

int tachyon_tpu_init(const char* platform) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (g_inited) return 0;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(/*install_sigint_handler=*/0);
    // Initialisation leaves this thread holding the GIL; release it so
    // that every call, from any thread, takes it through GILGuard.
    PyEval_SaveThread();
  }
  GILGuard gil;
  PyObject* mod = PyImport_ImportModule("tachyon_tpu_torch.c.bridge");
  if (!mod) {
    set_error_from_python();
    return -1;
  }
  PyObject* ret = (platform && *platform)
                      ? PyObject_CallMethod(mod, "init", "s", platform)
                      : PyObject_CallMethod(mod, "init", "O", Py_None);
  if (!ret) {
    set_error_from_python();
    Py_DECREF(mod);
    return -1;
  }
  Py_DECREF(ret);
  g_bridge = mod;  // keep the reference for the process lifetime
  g_inited = true;
  return 0;
}

void tachyon_tpu_shutdown(void) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (!g_inited) return;
  GILGuard gil;
  Py_CLEAR(g_bridge);
  g_inited = false;
  // The interpreter stays up: CUDA contexts and extension modules do not
  // survive re-initialization, and the reference's release() keeps state too.
}

void tachyon_tpu_free_string(char* s) { free(s); }

static int require_init() {
  if (!g_inited) {
    g_last_error = "tachyon_tpu_init was not called";
    return -1;
  }
  return 0;
}

// Copies the contents of a python bytes object into out (exact size n).
static int bytes_out(PyObject* ret, uint8_t* out, size_t n) {
  char* buf;
  Py_ssize_t len;
  if (PyBytes_AsStringAndSize(ret, &buf, &len) != 0 ||
      static_cast<size_t>(len) != n) {
    set_error_from_python();
    g_last_error = "bridge returned wrong byte count";
    return -1;
  }
  memcpy(out, buf, n);
  return 0;
}

int tachyon_tpu_bn254_g1_msm(const uint8_t* bases, const uint8_t* scalars,
                             size_t n, uint8_t* out64) {
  if (require_init()) return -1;
  GILGuard gil;
  PyObject* args = Py_BuildValue(
      "(y#y#n)", reinterpret_cast<const char*>(bases), (Py_ssize_t)(n * 64),
      reinterpret_cast<const char*>(scalars), (Py_ssize_t)(n * 32),
      (Py_ssize_t)n);
  PyObject* ret = call_bridge("msm_g1", args);
  if (!ret) return -2;
  int rc = bytes_out(ret, out64, 64);
  Py_DECREF(ret);
  return rc;
}

int tachyon_tpu_bn254_fft(const uint8_t* in, size_t n, int inverse,
                          uint8_t* out) {
  if (require_init()) return -1;
  GILGuard gil;
  PyObject* args = Py_BuildValue(
      "(y#ni)", reinterpret_cast<const char*>(in), (Py_ssize_t)(n * 32),
      (Py_ssize_t)n, inverse);
  PyObject* ret = call_bridge("fft", args);
  if (!ret) return -2;
  int rc = bytes_out(ret, out, n * 32);
  Py_DECREF(ret);
  return rc;
}

int tachyon_tpu_bn254_poseidon2_hash(const uint8_t* inputs, size_t n,
                                     uint8_t* out32) {
  if (require_init()) return -1;
  GILGuard gil;
  PyObject* args = Py_BuildValue(
      "(y#n)", reinterpret_cast<const char*>(inputs), (Py_ssize_t)(n * 32),
      (Py_ssize_t)n);
  PyObject* ret = call_bridge("poseidon2_hash", args);
  if (!ret) return -2;
  int rc = bytes_out(ret, out32, 32);
  Py_DECREF(ret);
  return rc;
}

int tachyon_tpu_halo2_bn254_prove(const char* circuit_json,
                                  char** proof_hex_out) {
  if (require_init()) return -1;
  GILGuard gil;
  PyObject* args = Py_BuildValue("(s)", circuit_json);
  PyObject* ret = call_bridge("halo2_prove", args);
  if (!ret) return -2;
  const char* hex = PyUnicode_AsUTF8(ret);
  if (!hex) {
    set_error_from_python();
    Py_DECREF(ret);
    return -3;
  }
  if (proof_hex_out) *proof_hex_out = strdup(hex);
  Py_DECREF(ret);
  return 0;
}

int tachyon_tpu_sp1_baby_bear_fri_commit(uint32_t log_blowup,
                                         const uint8_t* matrices,
                                         size_t matrices_len,
                                         uint8_t* out32) {
  if (require_init()) return -1;
  GILGuard gil;
  PyObject* args = Py_BuildValue(
      "(Iy#)", log_blowup, reinterpret_cast<const char*>(matrices),
      (Py_ssize_t)matrices_len);
  PyObject* ret = call_bridge("sp1_baby_bear_fri_commit", args);
  if (!ret) return -2;
  int rc = bytes_out(ret, out32, 32);
  Py_DECREF(ret);
  return rc;
}

int tachyon_tpu_sp1_baby_bear_fri_prove_verify(
    uint32_t log_blowup, uint32_t num_queries, uint32_t pow_bits,
    const uint8_t* matrices, size_t matrices_len, uint8_t* out32) {
  if (require_init()) return -1;
  GILGuard gil;
  PyObject* args = Py_BuildValue(
      "(IIIy#)", log_blowup, num_queries, pow_bits,
      reinterpret_cast<const char*>(matrices), (Py_ssize_t)matrices_len);
  PyObject* ret = call_bridge("sp1_baby_bear_fri_prove_verify", args);
  if (!ret) return -2;
  int rc = bytes_out(ret, out32, 32);
  Py_DECREF(ret);
  return rc;
}

int tachyon_tpu_bn254_groth16_prove(const char* zkey_path,
                                    const char* wtns_path, int no_zk,
                                    int verify, char** proof_json_out,
                                    char** public_json_out) {
  if (require_init()) return -1;
  GILGuard gil;
  PyObject* args =
      Py_BuildValue("(ssii)", zkey_path, wtns_path, no_zk, verify);
  PyObject* ret = call_bridge("groth16_prove", args);
  if (!ret) return -2;
  // ret = (proof_json: str, public_json: str)
  const char* proof = nullptr;
  const char* pub = nullptr;
  if (!PyArg_ParseTuple(ret, "ss", &proof, &pub)) {
    set_error_from_python();
    Py_DECREF(ret);
    return -3;
  }
  if (proof_json_out) *proof_json_out = strdup(proof);
  if (public_json_out) *public_json_out = strdup(pub);
  Py_DECREF(ret);
  return 0;
}

}  // extern "C"
