// The earlier design of S2 and T1 (one slot, one hash a thread), kept
// unchanged for scripts/ab_shuffle_kernels.py and chip_smoke.py [14a]
// to time the kernels of ops/csrc/ against; no wrapper of the port calls it.
//
// T1: the threefry2x32 counter hash on NVIDIA Hopper (sm_90a), one thread per
// output word, bit-equal to jax.random (threefry.cuh).
//
// Replaces what jax.random's threefry lowers to inside the JAX package's
// device programs: jax/_src/prng.py::threefry_2x32 behind
// jax.random.fold_in, split and bits, as mfcd_tpu calls them (for example
// mfcd_tpu/core/rng.py:58-72, mfcd_tpu/ops/shuffle.py:39, the samplers and
// generators).  The port's plain version (core/prng.py::threefry2x32_reference)
// spreads every uint32 step over several int64 torch operations, a few
// hundred launches a hash.
//
// What bounds it.  Bytes: a hash is about 80 integer operations on words
// held in registers, against 16 to 32 bytes of input and 8 to 16 of output;
// at the sizes the port asks for (a few words to 2^23) the store stream
// bounds it, and below some 10^5 words the launch does.
//
// What the design does about it.  One launch a call, each thread hashes its
// words in registers and writes them once:
// - mfcd_threefry_hash (fold_in, bits_at, threefry2x32): four word tensors
//   broadcast against each other, read through their strides (a broadcast
//   dimension has stride 0), so nothing is expanded in device memory;
// - mfcd_threefry_bits (split, bits): keys [L, 2] and a count n per key; the
//   counter of flat index i is made in the kernel, with no iota tensor.
// Outputs are uint32 values in int64 lanes, the port's word layout: one word
// o0 ^ o1 (bits) or the pair (o0, o1) side by side (keys).

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 8192;
constexpr int kMaxDims = 8;

struct HashArgs {
  const int64_t* in[4];  // k0, k1, x0, x1
  int64_t stride[4][kMaxDims];
  int64_t shape[kMaxDims];
  int ndim;
  int64_t n;
  int64_t* out;
  int pairs;
};

__device__ __forceinline__ void store(int64_t* out, int64_t idx, int pairs,
                                      uint32_t o0, uint32_t o1) {
  if (pairs) {
    out[2 * idx] = static_cast<int64_t>(o0);
    out[2 * idx + 1] = static_cast<int64_t>(o1);
  } else {
    out[idx] = static_cast<int64_t>(o0 ^ o1);
  }
}

__global__ void __launch_bounds__(kThreads) hash_kernel(HashArgs a) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       idx < a.n; idx += step) {
    int64_t off[4] = {0, 0, 0, 0};
    int64_t rest = idx;
    for (int d = a.ndim - 1; d >= 0; --d) {
      const int64_t c = rest % a.shape[d];
      rest /= a.shape[d];
#pragma unroll
      for (int q = 0; q < 4; ++q) off[q] += c * a.stride[q][d];
    }
    uint32_t o0, o1;
    mfcd::threefry2x32(static_cast<uint32_t>(a.in[0][off[0]]),
                       static_cast<uint32_t>(a.in[1][off[1]]),
                       static_cast<uint32_t>(a.in[2][off[2]]),
                       static_cast<uint32_t>(a.in[3][off[3]]), o0, o1);
    store(a.out, idx, a.pairs, o0, o1);
  }
}

__global__ void __launch_bounds__(kThreads)
    bits_kernel(const int64_t* keys, int64_t key_row, int64_t key_word,
                int64_t rows, int64_t n, int64_t* out, int pairs) {
  const int64_t total = rows * n;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       idx < total; idx += step) {
    const int64_t l = idx / n;
    const uint64_t i = static_cast<uint64_t>(idx - l * n);
    uint32_t o0, o1;
    mfcd::hash_index(static_cast<uint32_t>(keys[l * key_row]),
                     static_cast<uint32_t>(keys[l * key_row + key_word]), i,
                     o0, o1);
    store(out, idx, pairs, o0, o1);
  }
}

int blocks_for(int64_t total) {
  const int64_t b = (total + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

const char* mfcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// threefry2x32 of (k0, k1, x0, x1), int64 word tensors broadcast to `shape`
// (ndim dims, at most 8) and read through `strides` (4 rows of ndim element
// strides, 0 on a broadcast dimension), n = prod(shape) hashes on `stream`
// into out [n] (o0 ^ o1) or [n, 2] (pairs != 0).  shape and strides are host
// arrays.  Returns the launch's error.
int mfcd_threefry_hash(const int64_t* k0, const int64_t* k1,
                       const int64_t* x0, const int64_t* x1,
                       const long long* shape, const long long* strides,
                       int ndim, long long n, int64_t* out, int pairs,
                       void* stream) {
  if (ndim < 0 || ndim > kMaxDims || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  HashArgs a = {};
  a.in[0] = k0;
  a.in[1] = k1;
  a.in[2] = x0;
  a.in[3] = x1;
  for (int d = 0; d < ndim; ++d) {
    a.shape[d] = shape[d];
    for (int q = 0; q < 4; ++q) a.stride[q][d] = strides[q * ndim + d];
  }
  a.ndim = ndim;
  a.n = n;
  a.out = out;
  a.pairs = pairs;
  hash_kernel<<<blocks_for(n), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// bits(keys[l], (n,)) for each of `rows` keys, the key words at
// keys[l * key_row] and keys[l * key_row + key_word], on `stream` into
// out [rows, n] (o0 ^ o1) or [rows, n, 2] (pairs != 0: split's keys).
// Returns the launch's error.
int mfcd_threefry_bits(const int64_t* keys, long long key_row,
                       long long key_word, long long rows, long long n,
                       int64_t* out, int pairs, void* stream) {
  if (rows < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(rows) * n;
  if (total == 0) return static_cast<int>(cudaSuccess);
  bits_kernel<<<blocks_for(total), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      keys, key_row, key_word, rows, n, out, pairs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
