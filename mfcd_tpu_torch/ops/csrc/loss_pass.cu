// L1: the validation pass's masked batch-mean BCE on NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package computes the same function,
// mfcd_tpu/train/trainer.py::batch_losses, inside a jit-ed scan, where XLA
// fuses it into a few device loops.  The port's plain version
// (ops/loss_pass.py::batch_losses_reference) runs eagerly, some 21 launches
// for every 64 batches: at hard K = 10 that is ~680 launches an epoch,
// whose issue the card waits on.  This is the port's counterpart of XLA's
// fusion: for each run, each batch's masked sum and count of
// BCE(sum_d U[u] * (V[i] - V[j]), z), its mean, then the epoch's mean over
// the non-empty batches, in two launches a pass.
//
// What bounds it on this card.  A row reads its u, i, j, z and valid (17
// bytes) and gathers 3d floats of U and V, which a run's tables (8 KB each
// at n = m = 1000, d = 2) keep in L2; at hard K = 10 a pass reads 11 MB, 3
// us at 3.35 TB/s.  The work is small and the pass sits between two K1
// launches, so what counts is that it is one short launch and a tiny one,
// issued from the host in one call.
//
// What the design does about it.
// - One group of lanes covers one batch (the batch size rounded up to a
//   power of two, at most 32 lanes): a lane sums its rows in order, the
//   group adds its lanes by an xor butterfly, so no batch straddles two
//   blocks and no float atomic is used.  A block of 256 threads holds
//   256 / lanes groups and walks a chunk of batches; the grid is (chunks,
//   runs), the chunk count taken from the runs, the batches and the
//   card's resident blocks so that small passes still spread over the
//   SMs.
// - A row's five fields load before its gathers, and only valid rows
//   gather; U and V are read through their strides, so the trainer's
//   [R, d, n] tables pass as [R, n, d] views with no copy.
// - An empty batch's mean is written as -0.0, which no non-empty batch can
//   give (every loss is >= +0 and every sum starts at +0): the second
//   launch, one block a run, counts the non-empty batches by it, rewrites
//   it as +0 and divides the sum of the means, taken in a fixed order, by
//   their count.  So the loss needs no scratch tensor and gives the same
//   bits every time.
// - The count is a compile-time variant of both kernels, taken where the
//   caller passes its outputs: each group adds its lanes' hits in the same
//   butterfly, as integers, into a per-batch count, and the second launch
//   sums a run's counts in a fixed order.  Integer sums are exact, so the
//   count does not depend on the launch shape, and the loss-only variant
//   the validation pass takes is the code it was.
// - A row's decision is the plain version's, sigmoid(x) > 0.5 as PyTorch's
//   CUDA sigmoid rounds it (1 / (1 + exp(-x)) in float32), on the logit the
//   loss takes.  The sigmoid rounds to exactly 0.5 for x in a small
//   interval above 0, so x > 0 is not the same test.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kEmpty = 0x80000000u;  // -0.0f: the mean of no rows

struct Field {
  const void* ptr;
  long long run;  // element strides
  long long col;
};

struct PassArgs {
  const float* U;
  long long u_run, u_row, u_col;
  const float* V;
  long long v_run, v_row, v_col;
  Field f[5];  // u, i, j (int32), z (float32), valid (bool)
  int runs;
  long long rows;
  long long batches;
  int batch_size;
  int d;
  int lanes;        // a batch's group: batch_size rounded up to 2^k, <= 32
  long long chunk;  // batches a block, a multiple of the groups a block
  float* means;     // [runs, batches]
  int* hits;        // [runs, batches]: the correct rows of each batch
};

template <typename T>
__device__ __forceinline__ T at(const Field& f, int r, long long k) {
  return __ldg(static_cast<const T*>(f.ptr) + r * f.run + k * f.col);
}

// max(x, 0) - x * z + log1p(exp(-|x|)), the plain version's stable form.
__device__ __forceinline__ float bce(float x, float z) {
  return (fmaxf(x, 0.0f) - x * z) + log1pf(expf(-fabsf(x)));
}

// The plain version's prediction: sigmoid(x) > 0.5, rounded as it rounds.
__device__ __forceinline__ float predict(float x) {
  return 1.0f / (1.0f + expf(-x)) > 0.5f ? 1.0f : 0.0f;
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads) loss_batch_kernel(PassArgs a) {
  const int groups = kThreads / a.lanes;
  const int lane = threadIdx.x % a.lanes;
  const int group = threadIdx.x / a.lanes;
  for (int r = blockIdx.y; r < a.runs; r += gridDim.y) {
    const long long b0 = blockIdx.x * a.chunk;
    long long b1 = b0 + a.chunk;
    if (b1 > a.batches) b1 = a.batches;
    const float* U = a.U + r * a.u_run;
    const float* V = a.V + r * a.v_run;
    // The whole block walks the chunk together, so every lane of a warp
    // reaches each butterfly.
    for (long long base = b0; base < b1; base += groups) {
      const long long b = base + group;
      const long long row0 = b * a.batch_size;
      long long end = row0 + a.batch_size;
      if (end > a.rows) end = a.rows;
      if (b >= b1) end = row0;
      float sum = 0.0f;
      int count = 0;
      int hit = 0;
      for (long long k = row0 + lane; k < end; k += a.lanes) {
        const int u = at<int>(a.f[0], r, k);
        const int i = at<int>(a.f[1], r, k);
        const int j = at<int>(a.f[2], r, k);
        const float z = at<float>(a.f[3], r, k);
        const bool valid = at<unsigned char>(a.f[4], r, k) != 0;
        if (valid) {
          const float* eu = U + u * a.u_row;
          const float* vi = V + i * a.v_row;
          const float* vj = V + j * a.v_row;
          float x = __ldg(eu) * (__ldg(vi) - __ldg(vj));
          for (int c = 1; c < a.d; ++c) {
            x += __ldg(eu + c * a.u_col) *
                 (__ldg(vi + c * a.v_col) - __ldg(vj + c * a.v_col));
          }
          sum += bce(x, z);
          ++count;
          if constexpr (kCount) hit += predict(x) == z;
        }
      }
      for (int off = a.lanes / 2; off > 0; off /= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        count += __shfl_xor_sync(0xffffffffu, count, off);
        if constexpr (kCount) hit += __shfl_xor_sync(0xffffffffu, hit, off);
      }
      if (lane == 0 && b < b1) {
        a.means[r * a.batches + b] =
            count > 0 ? sum / static_cast<float>(count)
                      : __uint_as_float(kEmpty);
        if constexpr (kCount) a.hits[r * a.batches + b] = hit;
      }
    }
  }
}

// One block a run: the sum of its batch means and the count of non-empty
// batches (and the sum of its batches' correct rows), each thread's share
// in batch order, then its warp's butterfly, then the warps in order.
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    loss_epoch_kernel(float* means, const int* hits, int runs,
                      long long batches, float* epoch, int* correct) {
  __shared__ float sums[kThreads / 32];
  __shared__ long long counts[kThreads / 32];
  __shared__ long long rights[kThreads / 32];
  for (int r = blockIdx.x; r < runs; r += gridDim.x) {
    float* row = means + r * batches;
    float sum = 0.0f;
    long long count = 0;
    long long right = 0;
    for (long long b = threadIdx.x; b < batches; b += kThreads) {
      const float m = row[b];
      if (__float_as_uint(m) == kEmpty) {
        row[b] = 0.0f;
      } else {
        sum += m;
        ++count;
      }
      if constexpr (kCount) right += hits[r * batches + b];
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      count += __shfl_xor_sync(0xffffffffu, count, off);
      if constexpr (kCount) right += __shfl_xor_sync(0xffffffffu, right, off);
    }
    if (threadIdx.x % 32 == 0) {
      sums[threadIdx.x / 32] = sum;
      counts[threadIdx.x / 32] = count;
      if constexpr (kCount) rights[threadIdx.x / 32] = right;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = sums[0];
      long long nonempty = counts[0];
      for (int w = 1; w < kThreads / 32; ++w) {
        total += sums[w];
        nonempty += counts[w];
      }
      epoch[r] = total / static_cast<float>(nonempty > 0 ? nonempty : 1);
      if constexpr (kCount) {
        long long all = 0;
        for (int w = 0; w < kThreads / 32; ++w) all += rights[w];
        correct[r] = static_cast<int>(all);
      }
    }
    __syncthreads();
  }
}

int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 132;
  }
  return sms[dev];
}

// Blocks of kThreads of `kernel` an SM holds at once, read once.
template <typename Kernel>
int resident(Kernel kernel) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
  return n > 0 ? n : 1;
}

// Enough blocks to fill the card once, each a whole number of rounds of
// its groups; sets a.chunk.
template <bool kCount>
dim3 batch_grid(PassArgs& a) {
  static const int per_sm = resident(loss_batch_kernel<kCount>);
  const long long groups = kThreads / a.lanes;
  const long long fill = static_cast<long long>(sm_count()) * per_sm;
  const long long most = (a.batches + groups - 1) / groups;
  long long chunks = (fill + a.runs - 1) / a.runs;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  a.chunk = (most + chunks - 1) / chunks * groups;
  chunks = (a.batches + a.chunk - 1) / a.chunk;
  return dim3(static_cast<unsigned>(chunks),
              static_cast<unsigned>(a.runs < 65535 ? a.runs : 65535));
}

// The pass's two launches, the variant that counts or the one that does
// not.
template <bool kCount>
int launch(PassArgs& a, float* epoch, int* correct, cudaStream_t st) {
  if (a.batches > 0) {
    const dim3 grid = batch_grid<kCount>(a);
    loss_batch_kernel<kCount><<<grid, kThreads, 0, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = a.runs < 65535 ? a.runs : 65535;
  loss_epoch_kernel<kCount><<<blocks, kThreads, 0, st>>>(
      a.means, a.hits, a.runs, a.batches, epoch, correct);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* mfcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The pass over `runs` runs of `rows` rows in batches of `batch_size`:
// means [runs, batches] (contiguous) and epoch [runs], on `stream`.
// U [runs, n, d] and V [runs, m, d] float32 by their element strides; u, i,
// j int32, z float32 and valid bool [runs, rows], each by its run and
// column strides (a pointer may be null where rows is 0).  Valid rows'
// indices must lie in the tables.  Where `correct` is not null, also each
// run's count of correct valid rows into correct [runs] (int32), by way of
// hits [runs, batches] (contiguous, int32), in the same launches.  Two
// launches (one where rows is 0); returns the launches' error.
int mfcd_loss_pass(const float* U, long long u_run, long long u_row,
                   long long u_col, const float* V, long long v_run,
                   long long v_row, long long v_col, const int* su,
                   long long su_run, long long su_col, const int* si,
                   long long si_run, long long si_col, const int* sj,
                   long long sj_run, long long sj_col, const float* z,
                   long long z_run, long long z_col, const bool* valid,
                   long long valid_run, long long valid_col, int runs,
                   long long rows, int batch_size, int d, float* means,
                   float* epoch, int* hits, int* correct, void* stream) {
  if (runs < 0 || rows < 0 || batch_size < 1 || d < 1 ||
      (correct != nullptr && hits == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (runs == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PassArgs a = {};
  a.U = U;
  a.u_run = u_run;
  a.u_row = u_row;
  a.u_col = u_col;
  a.V = V;
  a.v_run = v_run;
  a.v_row = v_row;
  a.v_col = v_col;
  a.f[0] = {su, su_run, su_col};
  a.f[1] = {si, si_run, si_col};
  a.f[2] = {sj, sj_run, sj_col};
  a.f[3] = {z, z_run, z_col};
  a.f[4] = {valid, valid_run, valid_col};
  a.runs = runs;
  a.rows = rows;
  a.batches = (rows + batch_size - 1) / batch_size;
  a.batch_size = batch_size;
  a.d = d;
  a.lanes = 1;
  while (a.lanes < batch_size && a.lanes < 32) a.lanes *= 2;
  a.means = means;
  a.hits = hits;
  return correct != nullptr ? launch<true>(a, epoch, correct, st)
                            : launch<false>(a, epoch, nullptr, st);
}

}  // extern "C"
