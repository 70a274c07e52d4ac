/* The port's backend for the native host ABI (native/tpu_proto.h,
 * unchanged): the counterpart of native/tpu_backend.cpp on PyTorch and the
 * H100.
 *
 * Like the JAX backend it stages the read-only state in host memory and
 * forwards the WHOLE batch, in one call a batch, to the port's scorer
 * through an embedded CPython interpreter
 * (mpi_openmp_cuda_tpu_torch.native_bridge.score_strided), which launches
 * the Hopper kernels on the card.  torch is imported once a process, at
 * the first batch.  Marshalling is plain bytes both ways: no numpy C API,
 * no pybind11, no PyTorch headers.
 *
 * Built with the unchanged driver native/main.cpp into ./final_torch
 * (`make final_torch`, with -I native for the header).  Env knobs:
 *   TPU_SEQALIGN_BACKEND  auto | cuda | mm | gather | oracle   (default auto
 *                         = cuda: the Hopper kernels)
 *   TPU_SEQALIGN_MESH     the --mesh grammar: N / batch:N, seq:N, DxS
 *                         (default: one device)
 *   TPU_SEQALIGN_DEVICE   cuda (default) | cpu; without a card and without
 *                         cpu the run fails, it never moves to the CPU
 *   TPU_SEQALIGN_PYROOT   package root override (default: the installed
 *                         package, else the compiled-in repo root)
 *
 * Fail-stop error handling, as checkStatus (cudaFunctions.cu:15-33) and
 * the JAX backend: print a diagnostic on stderr (with the Python
 * traceback), exit(1).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "tpu_proto.h"

#ifndef TPU_SEQALIGN_REPO_ROOT
#define TPU_SEQALIGN_REPO_ROOT ""
#endif

namespace {

constexpr int kMatCells = 27 * 27;

/* Staged read-only state (the reference's __constant__ tier). */
char g_mat1[kMatCells];
char g_mat2[kMatCells];
std::vector<char> g_seq1;
int g_weights[4];
bool g_have_mats = false, g_have_seq1 = false, g_have_weights = false;

/* Exit 1 without running the atexit teardown: finalizing an interpreter
 * that holds torch halfway through a failed call can crash, and the exit
 * code must stay 1. */
[[noreturn]] void fail_stop() {
  std::fflush(stderr);
  std::_Exit(1);
}

[[noreturn]] void die(const char *msg) {
  std::fprintf(stderr, "torch_backend: error: %s\n", msg);
  fail_stop();
}

[[noreturn]] void die_py(const char *what) {
  std::fprintf(stderr, "torch_backend: error: %s\n", what);
  if (PyErr_Occurred()) PyErr_Print();
  fail_stop();
}

void ensure_python() {
  if (Py_IsInitialized()) return;
  Py_Initialize();
  std::atexit(tpu_backend_shutdown);
  /* The package: TPU_SEQALIGN_PYROOT first, then the installed package;
   * only when neither resolves the compiled-in repo root and the working
   * directory. */
  std::string code =
      "import sys, os\n"
      "_p = os.environ.get('TPU_SEQALIGN_PYROOT')\n"
      "if _p and _p not in sys.path:\n"
      "    sys.path.insert(0, _p)\n"
      "import importlib.util\n"
      "if importlib.util.find_spec('mpi_openmp_cuda_tpu_torch') is None:\n"
      "    for _p in (r'" TPU_SEQALIGN_REPO_ROOT "' or None, os.getcwd()):\n"
      "        if _p and _p not in sys.path:\n"
      "            sys.path.append(_p)\n";
  if (PyRun_SimpleString(code.c_str()) != 0)
    die_py("failed to set up sys.path for the bridge module");
}

const char *env_or(const char *name, const char *dflt) {
  const char *v = std::getenv(name);
  return (v && *v) ? v : dflt;
}

}  // namespace

extern "C" void send_mat_levels_cuda(char mat_level1[kMatCells],
                                     char mat_level2[kMatCells], int size) {
  if (size != kMatCells) die("send_mat_levels_cuda: size must be 27*27");
  std::memcpy(g_mat1, mat_level1, kMatCells);
  std::memcpy(g_mat2, mat_level2, kMatCells);
  g_have_mats = true;
}

extern "C" void send_Seq1_To_Cuda(char *seq1, int seq1_size) {
  if (seq1_size < 0 || seq1_size > BUF_SIZE_SEQ1)
    die("send_Seq1_To_Cuda: seq1_size out of range");
  g_seq1.assign(seq1, seq1 + seq1_size);
  g_have_seq1 = true;
}

extern "C" void send_weights_cuda(int weights[4]) {
  std::memcpy(g_weights, weights, sizeof(g_weights));
  g_have_weights = true;
}

extern "C" void send_divided_Seq2_To_Cuda(char *seq2_divided, int seq2_size,
                                          int num_rows_each_proc,
                                          int *local_score, int *local_offset,
                                          int *local_k) {
  if (num_rows_each_proc <= 0) return;
  if (!g_have_mats || !g_have_seq1 || !g_have_weights)
    die(
        "send_divided_Seq2_To_Cuda: stage matrices, seq1 and weights first "
        "(ABI contract, myProto.h order)");
  if (seq2_size <= 0 || seq2_size % num_rows_each_proc != 0)
    die("send_divided_Seq2_To_Cuda: seq2_size must be rows * stride");
  const int stride = seq2_size / num_rows_each_proc;

  ensure_python();
  const char *backend = env_or("TPU_SEQALIGN_BACKEND", "auto");
  const char *mesh = env_or("TPU_SEQALIGN_MESH", "");
  const char *device = env_or("TPU_SEQALIGN_DEVICE", "cuda");

  PyObject *mod =
      PyImport_ImportModule("mpi_openmp_cuda_tpu_torch.native_bridge");
  if (!mod) die_py("cannot import mpi_openmp_cuda_tpu_torch.native_bridge");
  PyObject *res = PyObject_CallMethod(
      mod, "score_strided", "(y#y#iiy#y#(iiii)sss)", g_seq1.data(),
      (Py_ssize_t)g_seq1.size(), seq2_divided, (Py_ssize_t)seq2_size, stride,
      num_rows_each_proc, g_mat1, (Py_ssize_t)kMatCells, g_mat2,
      (Py_ssize_t)kMatCells, g_weights[0], g_weights[1], g_weights[2],
      g_weights[3], backend, mesh, device);
  Py_DECREF(mod);
  if (!res) die_py("score_strided raised");

  char *buf = nullptr;
  Py_ssize_t nbytes = 0;
  if (PyBytes_AsStringAndSize(res, &buf, &nbytes) != 0)
    die_py("score_strided returned a non-bytes result");
  const Py_ssize_t want =
      (Py_ssize_t)num_rows_each_proc * 3 * (Py_ssize_t)sizeof(int32_t);
  if (nbytes != want) die("score_strided result has the wrong size");
  const int32_t *vals = reinterpret_cast<const int32_t *>(buf);
  for (int r = 0; r < num_rows_each_proc; ++r) {
    local_score[r] = vals[3 * r + 0];
    local_offset[r] = vals[3 * r + 1];
    local_k[r] = vals[3 * r + 2];
  }
  Py_DECREF(res);
}

extern "C" void tpu_backend_shutdown(void) {
  /* The result lines are out before the interpreter goes. */
  std::fflush(stdout);
  if (Py_IsInitialized()) Py_FinalizeEx();
}
