// Fused training epoch for R matrix-factorization runs on NVIDIA Hopper
// (sm_90a): each run on a cluster of c CTAs of 512 threads (c = 1 to 16), or
// on one CTA of 256 threads packed three to an SM.
//
// Replaces the TPU kernel mfcd_tpu/ops/kernels.py::_epoch_kernel (launched by
// pallas_train_epoch).  It computes what that kernel computes, not how: for
// each executed batch t < ceil(count / bs) it unpacks the rows, masks
// slot >= count, takes logit = sum_d U[u,d] * (V[i,d] - V[j,d]), the masked
// mean of the stable BCE, g = (sigmoid(logit) - z) * mask / cnt, scatters
// g * (V[i] - V[j]) into U[u], +g * U[u] into V[i] and -g * U[u] into V[j]
// (duplicate rows summed), and runs the dense coupled-weight-decay Adam over
// every element of U and V with bias corrections 1 - exp(t * log(beta)).  The
// TPU workarounds (one-hot MXU gather/scatter, split-3 bf16 dots, the
// batch-chunk grid axis) are left out.
//
// What bounds it.  Neither bytes nor FLOPs: an epoch is a chain of
// ceil(count / bs) dependent steps (1,250 at the canonical n = m = 1000,
// d = 2, bs = 64) over state kept in shared memory.  At small R (4 to 8
// runs on 132 SMs) the step's latency bounds it: the batch phase (row
// reads, sigmoid, links), the barriers, and the dense Adam over (n + m) * d
// elements, whose IEEE divisions and square root each branch to a slow path
// and so issue one element after another: about 2 us on one H100 SM.  At large
// R (hundreds of runs, one parameter_scan_fast chunk) the SMs' issue rate
// bounds it: every run's Adam must be issued every step.
//
// What the design does about it.
// - Gradient rows as entry lists.  Each batch row b writes its contributions
//   g * (V[i] - V[j]) and g * U[u] to shared memory, and each of its three
//   gradient entries (U: id b; V: id bs + 2b for i, bs + 2b + 1 for j) is
//   linked into its row's list by a thread of its own, with one integer
//   atomicExch, beside the row's forward; the entry that opens a row's list
//   in a step appends the row to the step's touched rows.  In the Adam pass
//   one thread per (touched row, component k) adds the row's contributions
//   in ascending id order, starting from 0: U over rows 0..bs-1, V over
//   i_0, j_0, i_1, j_1, ..., the order of a sequential index_add_ (a short
//   list by selection of the next-larger id, a long one by a scan of the
//   ids in order, so a row named k times costs O(min(k^2, bs))); every
//   other element takes the dense pass with a gradient of 0.  No float
//   atomics, no gradient plane, no serial scatter, and any bs.
// - Small R, where the card holds R clusters of c > 1 at once: a run split
//   over c CTAs, each holding 1/c of the rows, so each CTA issues 1/c of
//   Adam.  Every CTA computes the whole batch phase from a buffer of the
//   step's rows that their owners pushed into every CTA's shared memory
//   (st.async) after the previous step's Adam; the step waits on the
//   buffer's mbarrier, which counts the pushed bytes, not on a cluster
//   barrier, whose arrive follows the batch phase and whose wait, before
//   the pushes, overlaps Adam.  Where the whole batch's rows do not fit
//   beside a CTA's share, the buffer holds as many batch rows as do, and
//   a step pushes and reads its batch in rounds of that many.
// - Up to one run per SM (c = 1): one 512-thread CTA per run, in one wave.
// - Large R, more runs than SMs (packed): 256 threads and at most 85
//   registers a thread, so three runs share an SM and its issue slots.
// The library is compiled with --fmad=false so every multiply and add
// rounds on its own, as the plain PyTorch version's separate operations do;
// every c gives the same bits.
//
// The body is epoch_body.cuh's template at stage set kFull over the row
// layout; the kernel-split profiler's kernels (epoch_variants.cu) are the
// same template with stages removed or over another layout.

#include "epoch_body.cuh"

extern "C" {

const char* mfcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// At launch shape c (kPacked, or the wide kernel over clusters of c CTAs):
// the CTAs that fit on one SM, and the runs the card holds at once (its
// resident clusters where c > 1).  A cluster size above 8 that the card does
// not schedule gives 0 runs, not an error.
int mfcd_epoch_occupancy(int c, int n, int m, int d, int bs,
                         int* blocks_per_sm, int* runs) {
  return occupancy<kFull, false>(c, n, m, d, bs, blocks_per_sm, runs);
}

// Launches one epoch for R runs on `stream` at launch shape c: kPacked, one
// 256-thread CTA per run; 1, one 512-thread CTA per run; c > 1, a cluster of
// c 512-thread CTAs per run.  Returns the launch's error.
int mfcd_train_epoch(float* u_t, float* v_t, float* mu_u, float* nu_u,
                     float* mu_v, float* nu_v, const int32_t* s0,
                     const int32_t* s1, const int32_t* s2, const float* sz,
                     const float* lr, const float* wd, const float* step0,
                     const int32_t* count, float* loss, int R, int n, int m,
                     int d, int num_batches, int bs, int mode, int bits_n,
                     int bits_m, int bits_z, int denom, float b1, float omb1,
                     float b2, float omb2, float eps, float log_b1,
                     float log_b2, int c, void* stream) {
  return launch<kFull, false>(
      R, n, m, d, bs, c, static_cast<cudaStream_t>(stream), u_t, v_t, mu_u,
      nu_u, mu_v, nu_v, s0, s1, s2, sz, lr, wd, step0, count, loss, n, m, d,
      num_batches, bs, mode, bits_n, bits_m, bits_z, denom, b1, omb1, b2,
      omb2, eps, log_b1, log_b2, static_cast<float*>(nullptr));
}

}  // extern "C"
