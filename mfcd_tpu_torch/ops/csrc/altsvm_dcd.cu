// K2: one whole dual-coordinate-descent (DCD) phase of AltSVM on NVIDIA
// Hopper (sm_90a), in one warp.
//
// Replaces no TPU kernel: the JAX package runs the phase as XLA, two
// lax.scan bodies under jax.jit (mfcd_tpu/models/altsvm.py::_dcd_users,
// ::_dcd_items, scanned at :109 and :136 inside the epoch scan at :177).
// One launch runs the picks' T * sweeps dependent coordinate steps in
// order.  User phase (V fixed), for comparison idx = picks[s] of user
// i = users[idx] with rows j, k and label p:
//   x = p * (V[j] - V[k]),  q = dot(x, x) / lam,  grad = dot(U[i], x) - 1,
//   new = clip(alpha[idx] - grad / max(q, 1e-12), 0, C),
//   U[i] += ((new - alpha[idx]) * x) / lam,  alpha[idx] = new.
// Item phase (U fixed), u = U[i]:
//   margin = p * dot(u, V[j] - V[k]),  q = (2 * dot(u, u)) / lam,
//   new = clip(beta[idx] - (margin - 1) / max(q, 1e-12), 0, C),
//   V[j] += ((delta * p) * u) / lam, then V[k] += (((-delta) * p) * u) / lam
//   (in that order, so j == k adds both).
//
// What bounds it.  Neither bytes nor operations: every step reads the row
// the previous step may have written, so the phase is a chain of T * sweeps
// dependent steps, each a few global loads deep (the pick, the comparison's
// indices, the rows) plus two warp reductions.  Its bound by bytes (the rows
// and indices each step touches, over 3.35 TB/s) is far below what a chain
// of latencies allows.
//
// What the design does about it: the least that is right.  One warp, one
// block; lane l owns components l, l + 32, ... of every row, so any f works;
// dot(x, x), dot(u, x) and the margin are butterfly shuffle reductions that
// leave the same bits in every lane; lane 0 alone reads and writes the dual
// and broadcasts it.  Every lane reads back only components it wrote itself,
// so consecutive steps need no barrier.  The library is built with
// --fmad=false and each expression keeps the JAX body's order, so the plain
// PyTorch version (ops/altsvm_kernels.py::dcd_phase_reference, which sums
// in the same butterfly order) gives the same bits.  Staging the written
// table in shared memory and prefetching the next step's indices are left
// for later.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kLanes = 32;

// The sum over the warp, as the plain version folds it: lane l adds lane
// l ^ off at off = 16, 8, 4, 2, 1 (a + b == b + a, so every lane ends with
// the same bits).
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    v = v + __shfl_xor_sync(kFullMask, v, off);
  }
  return v;
}

__device__ __forceinline__ float clip_step(float dual, float grad, float q,
                                           float c) {
  return fminf(fmaxf(dual - grad / fmaxf(q, 1e-12f), 0.0f), c);
}

// kUsers: the user phase (table = U, fixed = V, dual = alpha); else the item
// phase (table = V, fixed = U, dual = beta).  Rows are f floats, row-major.
template <bool kUsers>
__global__ void __launch_bounds__(kLanes, 1)
dcd_phase_kernel(float* table, const float* __restrict__ fixed, float* dual,
                 const int* __restrict__ picks, long long steps,
                 const int* __restrict__ users, const int* __restrict__ mj,
                 const int* __restrict__ mk, const float* __restrict__ prefs,
                 int f, float lam, float c) {
  const int lane = threadIdx.x;
  for (long long s = 0; s < steps; ++s) {
    const int idx = picks[s];
    const long long i = users[idx];
    const long long j = mj[idx];
    const long long k = mk[idx];
    const float pref = prefs[idx];
    float old = 0.0f;
    if (lane == 0) old = dual[idx];
    old = __shfl_sync(kFullMask, old, 0);

    if (kUsers) {
      float xx = 0.0f, ux = 0.0f;
      for (int e = lane; e < f; e += kLanes) {
        const float x = pref * (fixed[j * f + e] - fixed[k * f + e]);
        xx = xx + x * x;
        ux = ux + table[i * f + e] * x;
      }
      const float q = warp_sum(xx) / lam;
      const float grad = warp_sum(ux) - 1.0f;
      const float fresh = clip_step(old, grad, q, c);
      const float delta = fresh - old;
      if (lane == 0) dual[idx] = fresh;
      for (int e = lane; e < f; e += kLanes) {
        const float x = pref * (fixed[j * f + e] - fixed[k * f + e]);
        table[i * f + e] = table[i * f + e] + (delta * x) / lam;
      }
    } else {
      float udv = 0.0f, uu = 0.0f;
      for (int e = lane; e < f; e += kLanes) {
        const float u = fixed[i * f + e];
        udv = udv + u * (table[j * f + e] - table[k * f + e]);
        uu = uu + u * u;
      }
      const float margin = pref * warp_sum(udv);
      const float q = (2.0f * warp_sum(uu)) / lam;
      const float fresh = clip_step(old, margin - 1.0f, q, c);
      const float delta = fresh - old;
      if (lane == 0) dual[idx] = fresh;
      for (int e = lane; e < f; e += kLanes) {
        const float u = fixed[i * f + e];
        table[j * f + e] = table[j * f + e] + ((delta * pref) * u) / lam;
        table[k * f + e] = table[k * f + e] + (((-delta) * pref) * u) / lam;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* mfcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One DCD phase on `stream`: users_phase != 0 updates U and alpha in place
// (table, dual), else V and beta.  Returns the launch's CUDA error code.
int mfcd_altsvm_dcd(int users_phase, float* table, const float* fixed,
                    float* dual, const int* picks, long long steps,
                    const int* users, const int* mj, const int* mk,
                    const float* prefs, int f, float lam, float c,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (users_phase) {
    dcd_phase_kernel<true><<<1, kLanes, 0, st>>>(
        table, fixed, dual, picks, steps, users, mj, mk, prefs, f, lam, c);
  } else {
    dcd_phase_kernel<false><<<1, kLanes, 0, st>>>(
        table, fixed, dual, picks, steps, users, mj, mk, prefs, f, lam, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
