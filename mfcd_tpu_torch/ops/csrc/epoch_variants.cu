// The fused training epoch with stages removed (P1) and over the factored
// state layout (P2), for splitting K1's step by stage, on NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernels scripts/profile_kernel_split.py::_variant_kernel
// (launched by _run_variant) and ::_factored_kernel (launched by
// _run_factored).  Both are K1 (epoch_kernel.cu) itself: epoch_body.cuh's
// template at the other stage sets (P1's loop_only ... no_adam; P1's full is
// K1's stage set, compiled here again) and at kFull over the factored layout
// (P2), with K1's shared-memory layout and barriers, launched at the shape
// K1 takes for the same shape (ops/kernel_split.py).  The
// header says what each stage set keeps and how P2's layout and V-gradient
// order go.  Differences between the variants' times estimate each stage's
// share of K1's step.
//
// What bounds them on this card: as K1, the chain of dependent steps
// (latency), not bytes or FLOPs.
//
// Built with --fmad=false like epoch_kernel.cu.  No float atomics.

#include "epoch_body.cuh"

namespace {

// A kernel instantiation: stage set V over the row or factored layout.
template <int V, bool kFactored>
struct Kernel {
  static constexpr int kV = V;
  static constexpr bool kF = kFactored;
};

// fn(Kernel<V, false>()) for stage set `variant`.
template <typename F>
int dispatch(int variant, F fn) {
  switch (variant) {
    case kLoopOnly: return fn(Kernel<kLoopOnly, false>());
    case kOhOnly: return fn(Kernel<kOhOnly, false>());
    case kNoScatter: return fn(Kernel<kNoScatter, false>());
    case kNoAdam: return fn(Kernel<kNoAdam, false>());
    case kFull: return fn(Kernel<kFull, false>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* mfcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// P1: launches variant `variant` (0 loop_only .. 4 full) for R runs on
// `stream` at launch shape c (as mfcd_train_epoch; the caller picks K1's
// shape for the same n, m, d, bs), pack "full"; `alive` is written by the
// ablated variants only.  Returns the launch's error.
int mfcd_train_epoch_variant(int variant, float* u_t, float* v_t, float* mu_u,
                             float* nu_u, float* mu_v, float* nu_v,
                             const int32_t* s0, const float* lr,
                             const float* wd, const float* step0,
                             const int32_t* count, float* loss, float* alive,
                             int R, int n, int m, int d, int num_batches,
                             int bs, int bits_n, int bits_m, int bits_z,
                             int denom, float b1, float omb1, float b2,
                             float omb2, float eps, float log_b1,
                             float log_b2, int c, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* none = nullptr;
  return dispatch(variant, [&](auto k) {
    using K = decltype(k);
    return launch<K::kV, K::kF>(
        R, n, m, d, bs, c, st, u_t, v_t, mu_u, nu_u, mu_v, nu_v, s0, none,
        none, static_cast<const float*>(nullptr), lr, wd, step0, count, loss,
        n, m, d, num_batches, bs, kModeFull, bits_n, bits_m, bits_z, denom,
        b1, omb1, b2, omb2, eps, log_b1, log_b2, alive);
  });
}

// P2: one full epoch for R runs, each table [R, H, d * 128] (H * 128 rows),
// on `stream` at launch shape c; returns the launch's error.
int mfcd_train_epoch_factored(float* u_f, float* v_f, float* mu_u, float* nu_u,
                              float* mu_v, float* nu_v, const int32_t* s0,
                              const float* lr, const float* wd,
                              const float* step0, const int32_t* count,
                              float* loss, int R, int H, int d,
                              int num_batches, int bs, int bits_n, int bits_m,
                              int bits_z, int denom, float b1, float omb1,
                              float b2, float omb2, float eps, float log_b1,
                              float log_b2, int c, void* stream) {
  const int rows = H * kLanes;
  if ((1 << bits_n) > rows || (1 << bits_m) > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* none = nullptr;
  return launch<kFull, true>(
      R, rows, rows, d, bs, c, static_cast<cudaStream_t>(stream), u_f, v_f,
      mu_u, nu_u, mu_v, nu_v, s0, none, none,
      static_cast<const float*>(nullptr), lr, wd, step0, count, loss, rows,
      rows, d, num_batches, bs, kModeFull, bits_n, bits_m, bits_z, denom, b1,
      omb1, b2, omb2, eps, log_b1, log_b2, static_cast<float*>(nullptr));
}

}  // extern "C"
