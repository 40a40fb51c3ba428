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
//   of mfcd_tpu/train/pallas_trainer.py:137-138 moved inside (or, as JAX's
//   mix_stream takes it, the epoch's key already folded).
//
// What bounds them on this card.  Bytes: S2 reads and writes every slot of
// every stream array once (R x S x 8 bytes an array: 4.19 MB at the
// canonical R = 4, S = 131,072, 67 MB at hard K = 50's 2 x 2^22); S1 reads
// 8 bytes and writes 4 a slot.  Operations: a step of the keyed walk is 3
// rounds of multiply, mask, shift, xor, add, mask and a test, 14 of them
// on the integer ALU pipe alone (64 a clock per SM, 16.7e12 a second on
// 132 SMs at 1.98 GHz; the multiplies and adds issue as IMAD on the FMA
// pipe beside them).  A fresh epoch walks every slot, one or two steps
// where count > 2^(k-1): about 25 ALU operations against 8 bytes a slot,
// so its bytes bound it, but its gathers read scattered 4-byte words, a
// 32-byte sector each.  A cheap epoch needs one walk a tile: its bytes
// bound it.  Below some 10^6 slots the launch and each run's key words
// bound both.
//
// What S2's design does about it.
// - One launch an epoch for every run and every array.  A grid sized from
//   the SM count and the blocks of 256 threads an SM holds, rows on y,
//   each block deriving its run's words once: threads 0-6 in parallel take
//   the split key and its words (and fold the epoch in first unless the
//   key comes folded, as on the trainer's path: two dependent hashes
//   there).
// - A fresh epoch: each thread takes quads of 4 neighbouring slots, walks
//   the quad's 4 slots in registers, issues its gathers of every array
//   before any store, and stores each array's quad as one 16-byte
//   streaming store (evict-first in L2).  (Two quads a thread at a time
//   ran slower at five of the six main-path shapes.)  Only as many
//   runs are in flight as half the L2 holds of their source words (one at
//   hard K = 50's 2^22 slots), so the scattered gathers, a 32-byte sector
//   for each 4-byte word, find their rows in L2.
// - A cheap epoch: one walk a tile.  A warp takes a group of T tiles (T
//   from 1 to 32, chosen from the SM count so that every SM has warps to
//   run); lane l < T walks tile l, and each lane copying a quad of output
//   words reads its tile's source from that lane (a warp shuffle).  The
//   quad's 4 source words are contiguous unless the rotation wraps inside
//   it (once a run): the lane reads the one or two aligned 16-byte quads
//   that hold them and shifts them into place in registers, then stores 16
//   bytes.  No 64-bit division anywhere: 32-bit slot arithmetic, shifts by
//   log2(tile_w).
// - Shapes the vector path does not take (S not a multiple of 4, a tile
//   width that is not a power of two, an array not 16-byte aligned) run a
//   per-slot kernel of the same arithmetic.
// - Each lane walks alone, in registers.  A finished lane is a fixed point
//   of where(x < count, x, mix(x)), so a per-lane walk gives the bits of
//   JAX's `while any(x >= count)` loop (capped at 48 steps) with no host
//   sync and no lane waiting for the slowest one.  Pad slots are written
//   too, so the whole [R, S] array matches the plain version's.
//
// S1 (not redesigned): one slot a thread; it reads one row of slots for
// every key where the slots broadcast (the tile PRP's, the fresh epoch's
// iota), so nothing is expanded; 64-bit slot offsets.  The mask
// (1 << k) - 1 is formed without a 32-bit shift by 32 when k = 32.

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

// ---------------------------------------------------------------------------
// S2

constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct StreamArgs {
  const uint32_t* in[4];
  uint32_t* out[4];
};

// One run's constants of one epoch: the mixing words of k_prp (fresh) or
// k_tile (cheap) in words[0..5] and rho's word in words[6], each from one
// of threads 0-6.  The caller synchronises.
__device__ __forceinline__ void epoch_words(const int64_t* keys,
                                            long long key_row, unsigned row,
                                            uint32_t epoch, bool folded,
                                            bool fresh, uint32_t* words) {
  const int t = threadIdx.x;
  if (t > 2 * kRounds) return;
  const int64_t* k = keys + static_cast<long long>(row) * key_row;
  uint32_t k0 = static_cast<uint32_t>(k[0]);
  uint32_t k1 = static_cast<uint32_t>(k[1]);
  if (!folded) mfcd::fold_in(k0, k1, epoch);
  // split(key, 3) = (k_prp, k_rho, k_tile)
  const bool rho = t == 2 * kRounds;
  uint32_t s0, s1;
  mfcd::split_at(k0, k1, rho ? 1u : (fresh ? 0u : 2u), s0, s1);
  words[t] = mfcd::bits_at(s0, s1, rho ? 0u : static_cast<unsigned>(t));
}

// The rotation of the prefix: slot p reads p + rho, or p + rho - count past
// count - rho (lim); every sum stays in [0, S).
__device__ __forceinline__ uint32_t rotate(uint32_t p, uint32_t lim,
                                           uint32_t rho, uint32_t cu) {
  return p < lim ? p + rho : p + rho - cu;
}

// The 4 source words of output quad p..p+3 (contiguous in p) after the
// rotation, from one or two aligned 16-byte loads shifted into place, or
// word by word where the rotation wraps inside the quad.
__device__ __forceinline__ uint4 rotated_quad(const uint32_t* row_in,
                                              uint32_t p, uint32_t lim,
                                              uint32_t rho, uint32_t cu) {
  uint32_t src;
  if (p + 3 < lim) {
    src = p + rho;
  } else if (p >= lim) {
    src = p + rho - cu;
  } else {
    return make_uint4(__ldg(row_in + rotate(p, lim, rho, cu)),
                      __ldg(row_in + rotate(p + 1, lim, rho, cu)),
                      __ldg(row_in + rotate(p + 2, lim, rho, cu)),
                      __ldg(row_in + rotate(p + 3, lim, rho, cu)));
  }
  const uint32_t off = src & 3u;
  const uint4* q = reinterpret_cast<const uint4*>(row_in + (src - off));
  const uint4 a = __ldg(q);
  if (off == 0) return a;
  const uint4 b = __ldg(q + 1);  // holds a valid word: inside the row
  switch (off) {
    case 1:
      return make_uint4(a.y, a.z, a.w, b.x);
    case 2:
      return make_uint4(a.z, a.w, b.x, b.y);
    default:
      return make_uint4(a.w, b.x, b.y, b.z);
  }
}

// S2 on quads: every [R, S] array with S a multiple of 4, 16-byte aligned;
// tile_w 0 (no tiles) or a power of two from 4; A arrays.
template <int A>
__global__ void __launch_bounds__(kThreads)
    mix_stream_kernel(const int64_t* keys, long long key_row,
                      const int32_t* count, StreamArgs a, unsigned rows,
                      unsigned s_len, uint32_t epoch, int fresh, int folded,
                      int k_bits, int tile_w, int tiles_per_group) {
  __shared__ uint32_t words[2 * kRounds + 1];
  const int t = threadIdx.x;
  for (unsigned row = blockIdx.y; row < rows; row += gridDim.y) {
    epoch_words(keys, key_row, row, epoch, folded, fresh, words);
    __syncthreads();
    const uint32_t cu = static_cast<uint32_t>(count[row]);
    const long long base = static_cast<long long>(row) * s_len;
    if (fresh) {
      const Mixer m = make_mixer(words, nullptr, k_bits);
      const unsigned quads = s_len / 4;
      for (unsigned q = blockIdx.x * kThreads + t; q < quads;
           q += gridDim.x * kThreads) {
        uint32_t src[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) src[k] = capped_walk(4 * q + k, cu, m);
        uint4 v[A];
#pragma unroll
        for (int arr = 0; arr < A; ++arr) {
          const uint32_t* in = a.in[arr] + base;
          v[arr] = make_uint4(__ldg(in + src[0]), __ldg(in + src[1]),
                              __ldg(in + src[2]), __ldg(in + src[3]));
        }
#pragma unroll
        for (int arr = 0; arr < A; ++arr) {
          __stcs(reinterpret_cast<uint4*>(a.out[arr] + base) + q, v[arr]);
        }
      }
    } else {
      const uint32_t rho = words[2 * kRounds] % (cu > 1u ? cu : 1u);
      const uint32_t lim = cu - rho;
      // tile_w 0: a virtual width of 128 that no tile moves in
      const int w_shift = tile_w > 0 ? 31 - __clz(tile_w) : 7;
      const uint32_t tw = 1u << w_shift;
      const int t_bits = tile_w > 0 && k_bits - w_shift > 1
                             ? k_bits - w_shift : 1;  // k - bit_length + 1
      const uint32_t full = tile_w > 0 ? cu >> w_shift : 0u;
      const uint32_t full1 = full > 1u ? full : 1u;
      const Mixer m = make_mixer(words, nullptr, t_bits);
      const unsigned tiles = (s_len + tw - 1) >> w_shift;
      const unsigned per = static_cast<unsigned>(tiles_per_group);
      const unsigned group_words = per << w_shift;
      const unsigned iters = group_words / 128;
      const unsigned groups = (tiles + per - 1) / per;
      const int lane = t & 31;
      for (unsigned g = blockIdx.x * kWarps + (t >> 5); g < groups;
           g += gridDim.x * kWarps) {
        // one walk a tile: lane l < T walks tile g * T + l
        const uint32_t tile = g * per + lane;
        uint32_t src_tile = tile;
        if (lane < static_cast<int>(per) && tile < full) {
          src_tile = capped_walk(tile, full1, m);
        }
        for (unsigned it = 0; it < iters; it += 2) {
          uint4 v[2][A];
          unsigned w[2];
          bool ok[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const unsigned at = (it + u) * 128 + 4 * lane;  // in the group
            const uint32_t st = __shfl_sync(kFull, src_tile, at >> w_shift);
            w[u] = g * group_words + at;
            ok[u] = it + u < iters && w[u] < s_len;
            if (ok[u]) {
              const uint32_t p = (st << w_shift) + (w[u] & (tw - 1));
#pragma unroll
              for (int q = 0; q < A; ++q) {
                v[u][q] = rotated_quad(a.in[q] + base, p, lim, rho, cu);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (ok[u]) {
#pragma unroll
              for (int q = 0; q < A; ++q) {
                reinterpret_cast<uint4*>(a.out[q] + base)[w[u] / 4] =
                    v[u][q];
              }
            }
          }
        }
      }
    }
    __syncthreads();  // words[] is rewritten for the next row
  }
}

// S2 a slot a thread, for the shapes the quad kernel does not take: any S,
// any tile width.
__global__ void __launch_bounds__(kThreads)
    mix_stream_slots(const int64_t* keys, long long key_row,
                     const int32_t* count, StreamArgs a, int arrays,
                     unsigned rows, unsigned s_len, uint32_t epoch,
                     int fresh, int folded, int k_bits, unsigned tile_w) {
  __shared__ uint32_t words[2 * kRounds + 1];
  const int t = threadIdx.x;
  for (unsigned row = blockIdx.y; row < rows; row += gridDim.y) {
    epoch_words(keys, key_row, row, epoch, folded, fresh, words);
    __syncthreads();
    const uint32_t cu = static_cast<uint32_t>(count[row]);
    const long long base = static_cast<long long>(row) * s_len;
    const uint32_t rho = words[2 * kRounds] % (cu > 1u ? cu : 1u);
    const uint32_t lim = cu - rho;
    int t_bits = k_bits;
    uint32_t full = 0;
    if (!fresh && tile_w > 0) {
      const int w_bits = 32 - __clz(tile_w);  // tile_w.bit_length()
      t_bits = k_bits - w_bits + 1 > 1 ? k_bits - w_bits + 1 : 1;
      full = cu / tile_w;
    }
    const uint32_t full1 = full > 1u ? full : 1u;
    const Mixer m = make_mixer(words, nullptr, fresh ? k_bits : t_bits);
    for (unsigned s = blockIdx.x * kThreads + t; s < s_len;
         s += gridDim.x * kThreads) {
      uint32_t src;
      if (fresh) {
        src = capped_walk(s, cu, m);
      } else {
        uint32_t p = s;
        if (tile_w > 0) {
          const uint32_t tile = s / tile_w;
          if (tile < full) {
            p = capped_walk(tile, full1, m) * tile_w + (s - tile * tile_w);
          }
        }
        src = rotate(p, lim, rho, cu);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < arrays) a.out[q][base + s] = a.in[q][base + src];
      }
    }
    __syncthreads();
  }
}

int blocks_per_row(int64_t rows, int64_t n) {
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int64_t fill = (kFillBlocks + rows - 1) / rows;
  const int64_t b = need < fill ? need : fill;
  return static_cast<int>(b > 1 ? b : 1);
}

struct Card {
  int sms;
  int l2_bytes;
};

// The current card's SM count and L2 size, read once a device.
Card card() {
  static Card cards[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) {
    return {132, 50 << 20};
  }
  if (cards[dev].sms == 0) {
    int sms = 0, l2 = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
    cards[dev] = {sms > 0 ? sms : 132, l2 > 0 ? l2 : (50 << 20)};
  }
  return cards[dev];
}

// Blocks of kThreads of `kernel` an SM holds at once (its registers and
// shared memory), read once.
template <typename Kernel>
int resident(Kernel kernel) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
  return n > 0 ? n : 1;
}

// The quad kernel's launch: x blocks a row, y rows at once.  A fresh
// epoch keeps as many rows in flight as half the L2 holds of their source
// words, so its scattered gathers find them there; a cheap epoch streams,
// every row at once.  T tiles a warp in a cheap epoch: at least 128 words
// a group, at most 32 tiles, and enough groups for 32 warps an SM where
// the stream has them.
template <int A>
void launch_quads(cudaStream_t stream, const int64_t* keys, long long key_row,
                  const int32_t* count, const StreamArgs& a, long long rows,
                  long long s_len, uint32_t epoch, bool fresh, int folded,
                  int k_bits, int tile_w) {
  static const int per_sm = resident(mix_stream_kernel<A>);
  const Card c = card();
  const long long fill = static_cast<long long>(c.sms) * per_sm;
  long long gy = rows, need;
  int per = 1;
  if (fresh) {
    const long long row_bytes = s_len * 4 * A;
    const long long fit = c.l2_bytes / 2 / row_bytes;
    gy = fit < 1 ? 1 : (fit < rows ? fit : rows);
    need = (s_len / 4 + kThreads - 1) / kThreads;
  } else {
    const long long tw = tile_w > 0 ? tile_w : 128;
    const long long tiles = (s_len + tw - 1) / tw;
    per = tile_w > 0 && tile_w < 128 ? static_cast<int>(128 / tw) : 1;
    const long long target = static_cast<long long>(c.sms) * 32;
    while (tile_w > 0 && per < 32 &&
           rows * ((tiles + 2 * per - 1) / (2 * per)) >= target) {
      per *= 2;
    }
    need = ((tiles + per - 1) / per + kWarps - 1) / kWarps;
  }
  if (gy > 65535) gy = 65535;
  const long long per_row = fill / gy > 1 ? fill / gy : 1;
  const dim3 grid(static_cast<unsigned>(need < per_row ? need : per_row),
                  static_cast<unsigned>(gy));
  mix_stream_kernel<A><<<grid, kThreads, 0, stream>>>(
      keys, key_row, count, a, static_cast<unsigned>(rows),
      static_cast<unsigned>(s_len), epoch, fresh ? 1 : 0, folded, k_bits,
      tile_w, per);
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
// keys: int64 words, run l's at keys[l * key_row] and the next word: the
// epochs keys (folded == 0: the kernel folds `epoch` in) or the epoch's
// keys fold_in(epochs key, epoch) (folded != 0); count: int32 [rows];
// in0-in3 / out0-out3: `arrays` (1, 2 or 4) pointers each to [rows, s_len]
// 32-bit words, the rest null; tile_w: the stream's tile width, 0 for none.
// All contiguous, out distinct from in.  Returns the launch's error.
int mfcd_mix_stream(const int64_t* keys, long long key_row,
                    const int32_t* count, const void* in0, const void* in1,
                    const void* in2, const void* in3, void* out0, void* out1,
                    void* out2, void* out3, int arrays, long long rows,
                    long long s_len, long long epoch, int period, int k_bits,
                    int tile_w, int folded, void* stream) {
  if (rows < 0 || rows >= (1LL << 32) || s_len < 0 || s_len >= (1LL << 31) ||
      epoch < 0 || period < 1 || k_bits < 1 || k_bits > 32 || tile_w < 0 ||
      !(arrays == 1 || arrays == 2 || arrays == 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || s_len == 0) return static_cast<int>(cudaSuccess);
  const void* ins[4] = {in0, in1, in2, in3};
  void* outs[4] = {out0, out1, out2, out3};
  StreamArgs a = {};
  bool aligned = true;
  for (int q = 0; q < arrays; ++q) {
    a.in[q] = static_cast<const uint32_t*>(ins[q]);
    a.out[q] = static_cast<uint32_t*>(outs[q]);
    aligned = aligned && reinterpret_cast<uintptr_t>(ins[q]) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(outs[q]) % 16 == 0;
  }
  const bool fresh = period == 1 || epoch % period == 0;
  const uint32_t e = static_cast<uint32_t>(epoch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pow2 =
      tile_w == 0 || (tile_w >= 4 && (tile_w & (tile_w - 1)) == 0);
  if (s_len % 4 == 0 && pow2 && aligned) {
    switch (arrays) {
      case 1:
        launch_quads<1>(st, keys, key_row, count, a, rows, s_len, e, fresh,
                        folded, k_bits, tile_w);
        break;
      case 2:
        launch_quads<2>(st, keys, key_row, count, a, rows, s_len, e, fresh,
                        folded, k_bits, tile_w);
        break;
      default:
        launch_quads<4>(st, keys, key_row, count, a, rows, s_len, e, fresh,
                        folded, k_bits, tile_w);
        break;
    }
  } else {
    static const int per_sm = resident(mix_stream_slots);
    const long long fill = static_cast<long long>(card().sms) * per_sm;
    const long long gy = rows < 65535 ? rows : 65535;
    const long long per_row = fill / gy > 1 ? fill / gy : 1;
    const long long need = (s_len + kThreads - 1) / kThreads;
    const dim3 grid(static_cast<unsigned>(need < per_row ? need : per_row),
                    static_cast<unsigned>(gy));
    mix_stream_slots<<<grid, kThreads, 0, st>>>(
        keys, key_row, count, a, arrays, static_cast<unsigned>(rows),
        static_cast<unsigned>(s_len), e, fresh ? 1 : 0, folded, k_bits,
        static_cast<unsigned>(tile_w));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
