// The earlier design of S1, S2 and T1 (one slot, one hash a thread), kept
// unchanged for scripts/ab_shuffle_kernels.py and chip_smoke.py [14a]
// to time the kernels of ops/csrc/ against; no wrapper of the port calls it.
//
// S1 and S2: the keyed pseudorandom permutation (PRP) of the epoch shuffle and
// the fused epoch shuffle on NVIDIA Hopper (sm_90a), bit-equal to the JAX
// package and to the port's plain versions (ops/shuffle.py).
//
// Replaces, in mfcd_tpu/ops/shuffle.py:
// - S1: epoch_permutation (:57, the lax.while_loop walk at :73-84 with its
//   48-step cap and strided fallback), exact_prefix_permutation (:146, the
//   uncapped walk at :170-177) and exact_prefix_permutation_inverse (:116,
//   the walk of the inverse mixing at :135-142);
// - S2: mix_stream (:284, its lax.cond over a fresh PRP gather and a prefix
//   rotation composed with a PRP of the full tiles), with the key fold_in
//   of mfcd_tpu/train/pallas_trainer.py:137-138 moved inside.
//
// What bounds it.  Bytes: S2 reads and writes every slot of every stream
// array once (R x S x 8 bytes an array, 4.19 MB at the canonical R = 4,
// S = 131,072); the keyed mixing is a few dozen integer operations a step of
// the walk, and a walk takes one or two steps where count > 2^(k-1).  The
// gather's reads scatter in the PRP epochs.  Below some 10^6 slots the
// launch itself bounds it.  S1 likewise: 8 bytes read and 4 written a slot.
//
// What the design does about it.
// - One launch an epoch for every run and every array (S2), where the plain
//   version takes dozens of tensor operations and the JAX package a device
//   loop.  The per-run constants (fold_in, split, the six mixing words, rho)
//   come from threefry in the kernel, a few threads of each block computing
//   them into shared memory, so no key work is launched beside it.
// - Each lane walks alone, in registers.  A finished lane is a fixed point of
//   where(x < count, x, mix(x)), so a per-lane walk gives the bits of JAX's
//   `while any(x >= count)` loop (capped at 48 steps) with no host sync and
//   no lane waiting for the slowest one.
// - S2 composes the epoch's movement into one source slot per output slot,
//   then copies each array's word from it into a fresh output: one read and
//   one write a slot and array, pad slots included, so the whole [R, S] array
//   matches the plain version's.
// - S1 reads one row of slots for every key where the slots broadcast (the
//   tile PRP's, the fresh epoch's iota), so nothing is expanded.
// - 64-bit slot offsets; the mask (1 << k) - 1 is formed without a 32-bit
//   shift by 32 when k = 32.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFillBlocks = 2112;  // 132 SMs x 16 blocks: the card's fill
constexpr int kWalkIters = 48;     // mfcd_tpu/ops/shuffle.py::_WALK_ITERS
constexpr int kRounds = 3;

enum PrpMode { kCapped = 0, kExact = 1, kInverse = 2 };

// The keyed mixing of [0, 2^k): rounds of odd multiply, xorshift and add.
struct Mixer {
  uint32_t mul[kRounds];
  uint32_t add[kRounds];
  uint32_t inv[kRounds];  // multiplicative inverses of mul (unmix only)
  uint32_t mask;
  int shift;
  int unmix_iters;
};

__device__ __forceinline__ Mixer make_mixer(const uint32_t* words,
                                            const uint32_t* inv, int k_bits) {
  Mixer m;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    m.mul[r] = words[r] | 1u;
    m.add[r] = words[kRounds + r];
    m.inv[r] = inv ? inv[r] : 0u;
  }
  m.mask = k_bits >= 32 ? 0xFFFFFFFFu : ((1u << k_bits) - 1u);
  m.shift = k_bits / 2 > 1 ? k_bits / 2 : 1;
  m.unmix_iters = (k_bits + m.shift - 1) / m.shift - 1;
  return m;
}

__device__ __forceinline__ uint32_t mix(uint32_t x, const Mixer& m) {
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    x = (x * m.mul[r]) & m.mask;
    x ^= x >> m.shift;
    x = (x + m.add[r]) & m.mask;
  }
  return x;
}

__device__ __forceinline__ uint32_t unmix(uint32_t y, const Mixer& m) {
#pragma unroll
  for (int r = kRounds - 1; r >= 0; --r) {
    y = (y - m.add[r]) & m.mask;
    uint32_t x = y;
    for (int it = 0; it < m.unmix_iters; ++it) x = y ^ (x >> m.shift);
    y = (x * m.inv[r]) & m.mask;
  }
  return y;
}

// The inverse of odd m mod 2^32 (Newton, 5 steps).
__device__ __forceinline__ uint32_t inverse_odd(uint32_t m) {
  uint32_t v = m;
#pragma unroll
  for (int it = 0; it < 5; ++it) v = v * (2u - m * v);
  return v;
}

// epoch_permutation of one slot: the capped walk, then the strided fallback.
__device__ __forceinline__ uint32_t capped_walk(uint32_t slot, uint32_t count,
                                                const Mixer& m) {
  uint32_t x = mix(slot, m);
  for (int it = 0; it < kWalkIters && x >= count; ++it) x = mix(x, m);
  if (x >= count) x = (slot * m.mul[0]) % (count > 1u ? count : 1u);
  return x;
}

// The six mixing words of a key (_derive_constants: bits(key, (6,))), into
// words[t] by thread t < 6.
__device__ __forceinline__ void derive_word(uint32_t k0, uint32_t k1, int t,
                                            uint32_t* words) {
  if (t < 2 * kRounds) words[t] = mfcd::bits_at(k0, k1, t);
}

// S1: one keyed PRP walk per slot, a key and a count per row of slots.
__global__ void __launch_bounds__(kThreads)
    prp_kernel(const int64_t* keys, const int64_t* count,
               const int64_t* slots, int64_t slot_row, int32_t* out,
               int64_t n, int blocks_per_row, int mode, int k_bits) {
  __shared__ uint32_t words[2 * kRounds];
  __shared__ uint32_t inv[kRounds];
  const int64_t row = blockIdx.x / blocks_per_row;
  const int part = blockIdx.x % blocks_per_row;
  const int t = threadIdx.x;
  derive_word(static_cast<uint32_t>(keys[2 * row]),
              static_cast<uint32_t>(keys[2 * row + 1]), t, words);
  __syncthreads();
  if (mode == kInverse) {
    if (t < kRounds) inv[t] = inverse_odd(words[t] | 1u);
    __syncthreads();
  }
  const Mixer m = make_mixer(words, mode == kInverse ? inv : nullptr, k_bits);
  const uint32_t c = static_cast<uint32_t>(count[row]);
  const uint32_t c1 = c > 1u ? c : 1u;
  const int64_t base = row * n;
  const int64_t step = static_cast<int64_t>(blocks_per_row) * kThreads;
  for (int64_t s = static_cast<int64_t>(part) * kThreads + t; s < n;
       s += step) {
    const uint32_t v = static_cast<uint32_t>(slots[row * slot_row + s]);
    uint32_t x;
    if (mode == kCapped) {
      x = capped_walk(v, c, m);
    } else if (mode == kExact) {
      x = mix(v < c1 ? v : 0u, m);
      while (x >= c1) x = mix(x, m);
    } else {
      x = unmix(v < c1 ? v : 0u, m);
      while (x >= c1) x = unmix(x, m);
    }
    out[base + s] = static_cast<int32_t>(x);
  }
}

struct StreamArgs {
  const uint32_t* in[4];
  uint32_t* out[4];
  int arrays;
};

// out[q][dst] = in[q][src] for each array q (unrolled: the pointers stay in
// the kernel's parameter space, not in a local-memory copy).
__device__ __forceinline__ void copy_words(const StreamArgs& a, int64_t dst,
                                           int64_t src) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < a.arrays) a.out[q][dst] = a.in[q][src];
  }
}

// S2: one epoch of the carried stream, every run's arrays in one launch.
__global__ void __launch_bounds__(kThreads)
    mix_stream_kernel(const int64_t* keys, const int32_t* count,
                      StreamArgs a, int64_t s_len, int blocks_per_row,
                      int64_t epoch, int period, int k_bits, int tile_w) {
  __shared__ uint32_t words[2 * kRounds];
  __shared__ uint32_t rho_word;
  const int64_t row = blockIdx.x / blocks_per_row;
  const int part = blockIdx.x % blocks_per_row;
  const int t = threadIdx.x;
  const bool fresh = period == 1 || epoch % period == 0;
  if (t <= 2 * kRounds) {
    uint32_t k0 = static_cast<uint32_t>(keys[2 * row]);
    uint32_t k1 = static_cast<uint32_t>(keys[2 * row + 1]);
    mfcd::fold_in(k0, k1, static_cast<uint32_t>(epoch));
    // split(key, 3) = (k_prp, k_rho, k_tile)
    uint32_t s0, s1;
    if (t < 2 * kRounds) {
      mfcd::split_at(k0, k1, fresh ? 0u : 2u, s0, s1);
      derive_word(s0, s1, t, words);
    } else {
      mfcd::split_at(k0, k1, 1u, s0, s1);
      rho_word = mfcd::bits_at(s0, s1, 0);
    }
  }
  __syncthreads();
  const int64_t c = count[row];
  const uint32_t cu = static_cast<uint32_t>(c);
  const int64_t base = row * s_len;
  const int64_t step = static_cast<int64_t>(blocks_per_row) * kThreads;
  const int64_t first = static_cast<int64_t>(part) * kThreads + t;
  if (fresh) {
    const Mixer m = make_mixer(words, nullptr, k_bits);
    for (int64_t s = first; s < s_len; s += step) {
      const int64_t src = capped_walk(static_cast<uint32_t>(s), cu, m);
      copy_words(a, base + s, base + src);
    }
    return;
  }
  const int64_t rho = rho_word % (cu > 1u ? cu : 1u);
  int t_bits = 1;
  int64_t full = 0;
  if (tile_w > 0) {
    const int w_bits = 32 - __clz(tile_w);  // tile_w.bit_length()
    t_bits = k_bits - w_bits + 1 > 1 ? k_bits - w_bits + 1 : 1;
    full = c / tile_w;
  }
  const Mixer m = make_mixer(words, nullptr, t_bits);
  const uint32_t full1 = full > 1 ? static_cast<uint32_t>(full) : 1u;
  for (int64_t s = first; s < s_len; s += step) {
    int64_t p = s;
    if (tile_w > 0) {
      const int64_t tile = s / tile_w;
      if (tile < full) {
        p = static_cast<int64_t>(
                capped_walk(static_cast<uint32_t>(tile), full1, m)) *
                tile_w +
            (s - tile * tile_w);
      }
    }
    const int64_t src = p < c - rho ? p + rho : p + rho - c;
    copy_words(a, base + s, base + src);
  }
}

int blocks_per_row(int64_t rows, int64_t n) {
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t fill = (kFillBlocks + rows - 1) / rows;
  const int64_t b = need < fill ? need : fill;
  return static_cast<int>(b > 1 ? b : 1);
}

}  // namespace

extern "C" {

const char* mfcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// S1 on `stream`: out[l, i] = the PRP of slots[l * slot_row + i] (int64;
// slot_row n, or 0 where every row permutes the same slots) under keys[l]
// (int64 words [rows, 2]) and count[l] (int64 [rows]), on [0, 2^k_bits);
// mode 0 the capped walk (epoch_permutation), 1 the exact walk
// (exact_prefix_permutation), 2 the exact inverse walk.  All contiguous.
// Returns the launch's error.
int mfcd_prp(const int64_t* keys, const int64_t* count, const int64_t* slots,
             long long slot_row, int32_t* out, long long rows, long long n,
             int mode, int k_bits, void* stream) {
  if (rows < 0 || n < 0 || mode < kCapped || mode > kInverse || k_bits < 1 ||
      k_bits > 32 || !(slot_row == 0 || slot_row == n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const int bpr = blocks_per_row(rows, n);
  prp_kernel<<<static_cast<unsigned>(rows * bpr), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      keys, count, slots, slot_row, out, n, bpr, mode, k_bits);
  return static_cast<int>(cudaGetLastError());
}

// S2 on `stream`: one epoch of mix_stream for `rows` runs of s_len slots.
// keys: the epochs keys, int64 words [rows, 2] (folded with `epoch` in the
// kernel); count: int32 [rows]; in / out: `arrays` (1, 2 or 4) pointers each
// to [rows, s_len] 32-bit words; tile_w: the stream's tile width, 0 for
// none.  All contiguous, out distinct from in.  Returns the launch's error.
int mfcd_mix_stream(const int64_t* keys, const int32_t* count,
                    const void* const* in, void* const* out, int arrays,
                    long long rows, long long s_len, long long epoch,
                    int period, int k_bits, int tile_w, void* stream) {
  if (rows < 0 || s_len < 0 || epoch < 0 || period < 1 || k_bits < 1 ||
      k_bits > 32 || tile_w < 0 || !(arrays == 1 || arrays == 2 ||
                                     arrays == 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || s_len == 0) return static_cast<int>(cudaSuccess);
  StreamArgs a = {};
  for (int q = 0; q < arrays; ++q) {
    a.in[q] = static_cast<const uint32_t*>(in[q]);
    a.out[q] = static_cast<uint32_t*>(out[q]);
  }
  a.arrays = arrays;
  const int bpr = blocks_per_row(rows, s_len);
  mix_stream_kernel<<<static_cast<unsigned>(rows * bpr), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      keys, count, a, s_len, bpr, epoch, period, k_bits, tile_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
