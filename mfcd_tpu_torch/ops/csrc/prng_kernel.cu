// T1: the threefry2x32 counter hash on NVIDIA Hopper (sm_90a), bit-equal to
// jax.random (threefry.cuh).
//
// Replaces what jax.random's threefry lowers to inside the JAX package's
// device programs: jax/_src/prng.py::threefry_2x32 behind
// jax.random.fold_in, split and bits, as mfcd_tpu calls them (for example
// mfcd_tpu/core/rng.py:58-72, mfcd_tpu/ops/shuffle.py:39, the samplers and
// generators).  The port's plain version (core/prng.py::threefry2x32_reference)
// spreads every uint32 step over several int64 torch operations, a few
// hundred launches a hash.
//
// What bounds it on this card.  A hash is 20 rounds of add, rotate and
// xor and 5 key injections on words held in registers: about 70 32-bit
// integer operations, of which the 20 rotates (SHF) and 20 xors (LOP3)
// issue only on the integer ALU pipe, 64 a clock per SM (16.7e12 a second
// on 132 SMs at 1.98 GHz), while the compiler issues the adds as IMAD on
// the FMA pipe beside them.  Against 8 bytes stored a word (16 a key pair)
// that takes as long as the stores: bits over [2, 2^22] needs 20.1 us of
// ALU issue and 20.0 us of stores.  On the main path T1 hashes a few keys
// at a time, and there a launch and the host's issue bound it.
//
// What the design does about it.
// - One launch a call, whatever the entry (fold_in, split, bits, bits_at,
//   threefry2x32): the four words of every hash (k0, k1, x0, x1) are
//   operands, each a value passed by value, a word tensor read through its
//   strides (0 on a broadcast dimension: nothing is expanded), the high word
//   of an int64 tensor, or the index along the last dimension (split's and
//   bits' counter).  fold_in's zero counter word and every 32-bit mask
//   happen here, so the wrapper launches nothing else.
// - A 2-D grid: y walks the rows of the output (every dimension but the
//   last, decomposed once a row in 32-bit arithmetic), x its last
//   dimension; no element pays a 64-bit division.
// - split's and bits' counter layout (keys whose leading dims make one
//   stride) takes a kernel of its own with scalar parameters only: a row's
//   key read once, the counter made from the index, no other load.  Any
//   other layout reads its operands through their strides, every load of
//   a thread issued before its hashes.
// - Four hashes a thread, interleaved for instruction-level parallelism;
//   words stored as 16-byte pairs (a key pair, or two neighbouring o0 ^ o1
//   words) coalesced across the warp.  The port's word layout stays:
//   uint32 values in int64 lanes.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;         // hashes a thread
constexpr int kMaxDims = 8;

// How an operand of the hash is read (core/prng.py's _VALUE ... _LAST).
enum Kind {
  kValue = 0,    // `value`, the same for every element
  kInt64 = 1,    // int64 tensor at `ptr`, its low word
  kInt32 = 2,    // int32 tensor, its bits
  kLast = 3,     // the index along the output's last dimension
  kInt64Hi = 4,  // int64 tensor, its high word
  kInt32Hi = 5,  // int32 tensor sign-extended, its high word
};

struct Operand {
  const void* ptr;
  long long value;
  long long stride[kMaxDims];  // elements, aligned to the output's dims
  int kind;
};

struct HashArgs {
  Operand op[4];  // k0, k1, x0, x1
  unsigned outer[kMaxDims];  // the output's dims but the last
  int outer_dims;
  unsigned rows;
  unsigned cols;
  int pairs;
  long long* out;
};

__device__ __forceinline__ uint32_t read(const Operand& o, long long off,
                                         unsigned j) {
  switch (o.kind) {
    case kValue:
      return static_cast<uint32_t>(o.value);
    case kInt64:
      return static_cast<uint32_t>(
          __ldg(static_cast<const long long*>(o.ptr) + off));
    case kInt32:
      return static_cast<uint32_t>(
          __ldg(static_cast<const int*>(o.ptr) + off));
    case kLast:
      return j;
    case kInt64Hi:
      return static_cast<uint32_t>(
          __ldg(static_cast<const long long*>(o.ptr) + off) >> 32);
    default:  // kInt32Hi
      return static_cast<uint32_t>(
          static_cast<long long>(
              __ldg(static_cast<const int*>(o.ptr) + off)) >> 32);
  }
}

// Every operand read through its strides, all of a thread's loads issued
// before its hashes.
__global__ void __launch_bounds__(kThreads) hash_kernel(HashArgs a) {
  const int t = threadIdx.x;
  // Two neighbouring o0 ^ o1 words share a 16-byte store where a row has
  // an even length; key pairs are 16 bytes each.
  const bool two = !a.pairs && (a.cols % 2 == 0);
  const unsigned chunk = kThreads * kPer;
  const int last = a.outer_dims;
  for (unsigned row = blockIdx.y; row < a.rows; row += gridDim.y) {
    long long base[4] = {0, 0, 0, 0};
    unsigned rest = row;
    for (int d = a.outer_dims - 1; d >= 0; --d) {
      const unsigned c = rest % a.outer[d];
      rest /= a.outer[d];
#pragma unroll
      for (int q = 0; q < 4; ++q) base[q] += c * a.op[q].stride[d];
    }
    long long* out_row =
        a.out + static_cast<long long>(row) * a.cols * (a.pairs ? 2 : 1);
    for (unsigned c0 = blockIdx.x * chunk; c0 < a.cols;
         c0 += gridDim.x * chunk) {
      unsigned j[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        j[k] = two ? c0 + 2 * (t + (k >> 1) * kThreads) + (k & 1)
                   : c0 + t + k * kThreads;
      }
      uint32_t w[kPer][4];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const unsigned jk = j[k] < a.cols ? j[k] : 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          w[k][q] = read(a.op[q], base[q] + jk * a.op[q].stride[last], jk);
        }
      }
      uint32_t o0[kPer], o1[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        mfcd::threefry2x32(w[k][0], w[k][1], w[k][2], w[k][3], o0[k], o1[k]);
      }
      if (a.pairs) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (j[k] < a.cols) {
            reinterpret_cast<longlong2*>(out_row)[j[k]] =
                make_longlong2(o0[k], o1[k]);
          }
        }
      } else if (two) {
#pragma unroll
        for (int k = 0; k < kPer; k += 2) {
          if (j[k] < a.cols) {
            reinterpret_cast<longlong2*>(out_row)[j[k] / 2] =
                make_longlong2(o0[k] ^ o1[k], o0[k + 1] ^ o1[k + 1]);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (j[k] < a.cols) out_row[j[k]] = o0[k] ^ o1[k];
        }
      }
    }
  }
}

// split's and bits' layout with the keys' leading dims in one stride:
// scalar parameters only (a small launch's parameter block).
__global__ void __launch_bounds__(kThreads)
    counter_kernel(const long long* keys, long long key_row, long long word,
                   unsigned rows, unsigned cols, int pairs, long long* out) {
  const int t = threadIdx.x;
  const bool two = !pairs && (cols % 2 == 0);
  const unsigned chunk = kThreads * kPer;
  for (unsigned row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long* k = keys + static_cast<long long>(row) * key_row;
    const uint32_t key0 = static_cast<uint32_t>(__ldg(k));
    const uint32_t key1 = static_cast<uint32_t>(__ldg(k + word));
    long long* out_row =
        out + static_cast<long long>(row) * cols * (pairs ? 2 : 1);
    for (unsigned c0 = blockIdx.x * chunk; c0 < cols;
         c0 += gridDim.x * chunk) {
      unsigned j[kPer];
      uint32_t o0[kPer], o1[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        j[q] = two ? c0 + 2 * (t + (q >> 1) * kThreads) + (q & 1)
                   : c0 + t + q * kThreads;
      }
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        mfcd::threefry2x32(key0, key1, 0u, j[q] < cols ? j[q] : 0u, o0[q],
                           o1[q]);
      }
      if (pairs) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          if (j[q] < cols) {
            reinterpret_cast<longlong2*>(out_row)[j[q]] =
                make_longlong2(o0[q], o1[q]);
          }
        }
      } else if (two) {
#pragma unroll
        for (int q = 0; q < kPer; q += 2) {
          if (j[q] < cols) {
            reinterpret_cast<longlong2*>(out_row)[j[q] / 2] =
                make_longlong2(o0[q] ^ o1[q], o0[q + 1] ^ o1[q + 1]);
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          if (j[q] < cols) out_row[j[q]] = o0[q] ^ o1[q];
        }
      }
    }
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

}  // namespace

extern "C" {

const char* mfcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// threefry2x32 of (k0, k1, x0, x1) over an output of `ndim` dims (1 to 8),
// on `stream`, into out (int64, contiguous): o0 ^ o1 a word (pairs == 0)
// or the pair (o0, o1) in the last, extra dim of 2.  `desc` holds the
// output's shape (ndim int64s), then four operands in the order k0, k1, x0,
// x1, each as ndim + 2 int64s: kind (enum Kind), the pointer or the value,
// then its ndim element strides aligned to the shape.  Every dim but the
// last below 2^32 rows in all, the last below 2^31.  Returns the launch's
// error.
int mfcd_threefry(const long long* desc, int ndim, int pairs, long long* out,
                  void* stream) {
  if (ndim < 1 || ndim > kMaxDims) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* shape = desc;
  HashArgs a = {};
  long long rows = 1;
  for (int d = 0; d + 1 < ndim; ++d) {
    if (shape[d] < 0 || shape[d] >= (1LL << 32)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.outer[d] = static_cast<unsigned>(shape[d]);
    rows *= shape[d];
  }
  const long long cols = shape[ndim - 1];
  if (cols < 0 || cols >= (1LL << 31) || rows >= (1LL << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int q = 0; q < 4; ++q) {
    const long long* o = desc + ndim + q * (ndim + 2);
    if (o[0] < kValue || o[0] > kInt32Hi) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.op[q].kind = static_cast<int>(o[0]);
    a.op[q].ptr = reinterpret_cast<const void*>(o[1]);
    a.op[q].value = o[1];
    for (int d = 0; d < ndim; ++d) a.op[q].stride[d] = o[2 + d];
  }
  if (rows == 0 || cols == 0) return static_cast<int>(cudaSuccess);
  a.outer_dims = ndim - 1;
  a.rows = static_cast<unsigned>(rows);
  a.cols = static_cast<unsigned>(cols);
  a.pairs = pairs;
  a.out = out;
  // split's and bits' layout: the keys' words at a fixed distance, their
  // leading dims one stride, x0 = 0, x1 the index along the last dim.
  bool counter = a.op[0].kind == kInt64 && a.op[1].kind == kInt64 &&
                 a.op[0].stride[ndim - 1] == 0 &&
                 a.op[1].stride[ndim - 1] == 0 && a.op[2].kind == kValue &&
                 a.op[2].value == 0 && a.op[3].kind == kLast;
  for (int d = 0; counter && d < ndim - 1; ++d) {
    counter = a.op[1].stride[d] == a.op[0].stride[d] &&
              (d + 2 >= ndim ||
               a.op[0].stride[d] == a.op[0].stride[d + 1] * shape[d + 1]);
  }
  static const int per_sm[2] = {resident(hash_kernel),
                                resident(counter_kernel)};
  const long long fill =
      static_cast<long long>(sm_count()) * per_sm[counter ? 1 : 0];
  const long long need_x = (cols + kThreads * kPer - 1) / (kThreads * kPer);
  long long gx = need_x < fill ? need_x : fill;
  long long gy = fill / gx;
  if (gy > rows) gy = rows;
  if (gy > 65535) gy = 65535;
  if (gy < 1) gy = 1;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (counter) {
    const char* k0 = static_cast<const char*>(a.op[0].ptr);
    const char* k1 = static_cast<const char*>(a.op[1].ptr);
    counter_kernel<<<grid, kThreads, 0, st>>>(
        reinterpret_cast<const long long*>(k0),
        ndim >= 2 ? a.op[0].stride[ndim - 2] : 0, (k1 - k0) / 8, a.rows,
        a.cols, pairs, out);
  } else {
    hash_kernel<<<grid, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
