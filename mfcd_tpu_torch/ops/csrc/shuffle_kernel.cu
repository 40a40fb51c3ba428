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
// a slot (4 bytes as the samplers pass them, int32) and writes 4 bytes a
// slot.  Operations: a step of the keyed walk is 3 rounds of multiply,
// mask, shift, xor, add, mask and a test, 14 of them on the integer ALU
// pipe alone (64 a clock per SM, 16.7e12 a second on 132 SMs at 1.98 GHz;
// the multiplies and adds issue as IMAD on the FMA pipe beside them); a
// step of the inverse walk has up to 2 xorshift passes a round, 20.  A
// fresh epoch walks every slot, one or two steps where count > 2^(k-1):
// about 25 ALU operations against 8 bytes a slot, so its bytes bound it,
// but its gathers read scattered 4-byte words, a 32-byte sector each.  A
// cheap epoch needs one walk a tile: its bytes bound it.  S1's walks at
// the samplers' shapes (1.08 steps a slot at k = 30, 1.31 of the inverse
// at k = 17) are under its bytes.  Below some 10^6 slots the launch and
// each run's key words bound both.
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
// What S1's design does about it.
// - It reads its arguments as the callers hold them: a key row stride (0
//   where one key serves every row, as the split key does), a count as a
//   scalar or an int32 / int64 tensor with its row stride (0 for one count
//   broadcast), int32 or int64 slots with their row stride (0 for one
//   shared row).  The wrapper builds nothing but the output.
// - A grid from the SM count and the blocks an SM holds, rows on y (a loop
//   over rows past 65,535), 32-bit slot arithmetic inside a row and one
//   64-bit base a row.
// - Key words once a block: threads 0-5 hash one word each, threads 0-2 of
//   the inverse walk invert theirs (Newton), behind one barrier; once for
//   all rows where one key serves every row.  (A warp's words, lanes 0-5
//   and shuffles with no barrier, ran even or up to 14 % slower on an
//   H100.)
// - Four slots a thread: one 16-byte load of int32 slots (two of int64),
//   the four walks' rounds interleaved in registers, one 16-byte store;
//   the next quad's load issued before this one's walk, the row's first
//   before its words.  S not a multiple of 4 or a row not 16-byte aligned
//   loads and stores slot by slot, with the same walks.
// - A landed slot is a fixed point, as in S2, so four walks in step give
//   each slot its own walk's bits; the capped walk stops a quad at 48
//   steps and takes the strided fallback slot by slot.
// - The walk's tail: where the count is under 7/8 of 2^k, a warp's slots
//   still out once at most 32 are left go one to a lane (walk4), so the
//   warp does not wait for the slowest of 128 walks four to a lane (on an
//   H100, walked in step to the end, the inverse walk at c / 2^k =
//   0.61-0.76 took 1.22 to 1.36 times as long; above 7/8 the hand-out
//   cost more than it saved).  Lane refill, a lane taking its next slot
//   as soon as its walk lands, took 1.0 to 3.1 times as long: its 4-byte
//   loads and stores scatter.
// The mask (1 << k) - 1 is formed without a 32-bit shift by 32 when k = 32.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
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

// The inverse of mix.  A round's xorshift x ^= x >> shift is undone by
// ceil(k / shift) - 1 passes of x = y ^ (x >> shift), at most 2 since shift
// = max(k / 2, 1); two passes are y ^ (y >> shift) ^ (y >> 2 shift), one
// three-input xor.
__device__ __forceinline__ uint32_t unmix(uint32_t y, const Mixer& m) {
#pragma unroll
  for (int r = kRounds - 1; r >= 0; --r) {
    y = (y - m.add[r]) & m.mask;
    const uint32_t once = m.unmix_iters > 0 ? y >> m.shift : 0u;
    const uint32_t twice = m.unmix_iters > 1 ? y >> (2 * m.shift) : 0u;
    y = ((y ^ once ^ twice) * m.inv[r]) & m.mask;
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

// ---------------------------------------------------------------------------
// S1

// One S1 launch.  Row l (of `rows`) walks the n slots at slots + l *
// slot_row (int32 or int64 as Slot; slot_row 0: one row of slots for every
// row) under the key at keys + l * key_row (int64 words; key_row 0: one key
// for every row) and the count count_value (count_bytes 0) or the int32 /
// int64 at count + l * count_row, into int32 out + l * n.  vec: 16-byte
// loads and stores (n % 4 == 0, slots and out 16-byte aligned at every
// row).
struct PrpArgs {
  const int64_t* keys;
  long long key_row;
  const void* count;
  long long count_row;
  uint32_t count_value;
  int count_bytes;
  const void* slots;
  long long slot_row;
  int32_t* out;
  unsigned rows;
  unsigned n;
  int k_bits;
  int vec;
};

__device__ __forceinline__ uint32_t row_count(const PrpArgs& a,
                                              unsigned row) {
  const long long at = static_cast<long long>(row) * a.count_row;
  if (a.count_bytes == 4) {
    return static_cast<uint32_t>(static_cast<const int32_t*>(a.count)[at]);
  }
  if (a.count_bytes == 8) {
    return static_cast<uint32_t>(static_cast<const int64_t*>(a.count)[at]);
  }
  return a.count_value;
}

// A key's Mixer (_derive_constants: bits(key, (6,))), derived once a block:
// thread t < 6 hashes word t, threads 0-2 of the inverse walk invert theirs
// (Newton), into shared memory behind a barrier.  Every thread of the block
// calls it.
template <int kMode>
__device__ __forceinline__ Mixer block_mixer(const int64_t* key, int k_bits) {
  __shared__ uint32_t words[3 * kRounds];
  __syncthreads();  // the previous row's words have been read
  const int t = threadIdx.x;
  if (t < 2 * kRounds) {
    const uint32_t w = mfcd::bits_at(static_cast<uint32_t>(key[0]),
                                     static_cast<uint32_t>(key[1]), t);
    words[t] = w;
    if (kMode == kInverse && t < kRounds) {
      words[2 * kRounds + t] = inverse_odd(w | 1u);
    }
  }
  __syncthreads();
  return make_mixer(words, kMode == kInverse ? words + 2 * kRounds : nullptr,
                    k_bits);
}

template <int kMode>
__device__ __forceinline__ uint32_t step(uint32_t x, const Mixer& m) {
  return kMode == kInverse ? unmix(x, m) : mix(x, m);
}

__device__ __forceinline__ bool any_out(const uint32_t (&x)[4], uint32_t c) {
  return (x[0] >= c) | (x[1] >= c) | (x[2] >= c) | (x[3] >= c);
}

// The position of the j-th (from 0) set bit of v, which has more than j.
__device__ __forceinline__ unsigned nth_set(unsigned v, unsigned j) {
  unsigned pos = 0;
#pragma unroll
  for (unsigned w = 16; w > 0; w >>= 1) {
    const unsigned low = __popc(v & ((1u << w) - 1u));
    if (j >= low) {
      j -= low;
      v >>= w;
      pos += w;
    }
  }
  return pos;
}

// The walks of a lane's 4 slots (x: their values as uint32; `has`: the lane
// holds a quad) under count c, the rounds of the four interleaved; a landed
// slot is a fixed point, so each ends with its own walk's bits.  Every lane
// of the warp calls it.
// - Capped: mix, at most 48 more steps, the strided fallback.
// - Exact and inverse: slots at or above max(c, 1) start from 0, no cap.
//   A walk takes 2^k / c steps on average, but four slots walked in step
//   keep their warp until the slowest of 128 lands (at c / 2^k = 0.76, 4.3
//   steps for 1.31).  So where c is under 7/8 of 2^k: one step of all
//   four; while more than 32 of the warp's 128 slots are still out,
//   another; then the slots still out go one to a lane (4 ballots give
//   each its place, shuffles carry it there and back) and each lane walks
//   its one alone.  Above 7/8 the tail is short and the hand-out costs
//   more than it saves.
template <int kMode>
__device__ __forceinline__ void walk4(uint32_t (&x)[4], uint32_t c, bool has,
                                      const Mixer& m) {
  const uint32_t c1 = c > 1u ? c : 1u;
  if constexpr (kMode == kCapped) {
    uint32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = x[k];
      x[k] = mix(x[k], m);
    }
    for (int it = 0; it < kWalkIters && has && any_out(x, c); ++it) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t y = mix(x[k], m);
        x[k] = x[k] >= c ? y : x[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (x[k] >= c) x[k] = (v[k] * m.mul[0]) % c1;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = step<kMode>(x[k] < c1 ? x[k] : 0u, m);
  if (8ull * c1 >= 7ull * (m.mask + 1ull)) {
    while (has && any_out(x, c1)) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t y = step<kMode>(x[k], m);
        x[k] = x[k] >= c1 ? y : x[k];
      }
    }
    return;
  }
  for (;;) {
    unsigned out[4], base[4], total = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[k] = __ballot_sync(kFull, has && x[k] >= c1);
      base[k] = total;
      total += __popc(out[k]);
    }
    if (total == 0) return;
    if (total > 32) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t y = step<kMode>(x[k], m);
        x[k] = x[k] >= c1 ? y : x[k];
      }
      continue;
    }
    // Lane p takes the slot at place p (places in the order of k, then of
    // lane): the (p - base[k])-th lane of out[k] holds it.
    const unsigned lane = threadIdx.x & 31;
    int kind = -1;
    unsigned held = 0, rank = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (lane >= base[k] && lane - base[k] < __popc(out[k])) {
        kind = k;
        held = out[k];
        rank = lane - base[k];
      }
    }
    const unsigned src = kind >= 0 ? nth_set(held, rank) : lane;
    uint32_t y = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t v = __shfl_sync(kFull, x[k], src);
      if (k == kind) y = v;
    }
    if (kind >= 0) {
      do {
        y = step<kMode>(y, m);
      } while (y >= c1);
    }
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned place = (base[k] + __popc(out[k] & below)) & 31u;
      const uint32_t v = __shfl_sync(kFull, y, place);
      if ((out[k] >> lane) & 1u) x[k] = v;
    }
    return;
  }
}

// Quad q's 4 slot values (slots 4q to 4q + 3; past n: 0, walked and not
// stored).
template <typename Slot>
__device__ __forceinline__ void load4(const Slot* in, unsigned q, unsigned n,
                                      bool vec, uint32_t (&x)[4]) {
  if (vec && sizeof(Slot) == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(in) + q);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else if (vec) {
    const ulonglong2* p = reinterpret_cast<const ulonglong2*>(in) + 2 * q;
    const ulonglong2 lo = __ldg(p), hi = __ldg(p + 1);
    x[0] = static_cast<uint32_t>(lo.x);
    x[1] = static_cast<uint32_t>(lo.y);
    x[2] = static_cast<uint32_t>(hi.x);
    x[3] = static_cast<uint32_t>(hi.y);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned s = 4 * q + k;
      x[k] = s < n ? static_cast<uint32_t>(in[s]) : 0u;
    }
  }
}

__device__ __forceinline__ void store4(int32_t* out, unsigned q, unsigned n,
                                       bool vec, const uint32_t (&x)[4]) {
  if (vec) {
    reinterpret_cast<uint4*>(out)[q] = make_uint4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * q + k < n) out[4 * q + k] = static_cast<int32_t>(x[k]);
    }
  }
}

// S1 in quads: thread t of a row's grid walks quads t, t + stride, ...,
// the lanes of a warp in step (the walk's ballots and shuffles need all
// 32), each quad's slots loaded before the walk of the one before it (the
// row's first before its words are derived).  A block with no quad in a
// row has none in any row and leaves at once.
template <int kMode, typename Slot>
__global__ void __launch_bounds__(kThreads) prp_quads(PrpArgs a) {
  const unsigned quads = (a.n + 3) / 4;
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t - threadIdx.x >= quads) return;
  const unsigned stride = gridDim.x * kThreads;
  const bool vec = a.vec != 0;
  Mixer m;
  for (unsigned row = blockIdx.y; row < a.rows; row += gridDim.y) {
    const Slot* in = static_cast<const Slot*>(a.slots) + row * a.slot_row;
    int32_t* out = a.out + static_cast<long long>(row) * a.n;
    uint32_t next[4] = {0u, 0u, 0u, 0u};
    bool more = t < quads;
    if (more) load4(in, t, a.n, vec, next);
    if (row == blockIdx.y || a.key_row != 0) {
      m = block_mixer<kMode>(a.keys + row * a.key_row, a.k_bits);
    }
    const uint32_t c = row_count(a, row);
    for (unsigned q = t; q - (t & 31u) < quads; q += stride) {
      uint32_t x[4] = {next[0], next[1], next[2], next[3]};
      const bool has = more;
      more = q + stride < quads;
      if (more) load4(in, q + stride, a.n, vec, next);
      walk4<kMode>(x, c, has, m);
      if (has) store4(out, q, a.n, vec, x);
    }
  }
}

// ---------------------------------------------------------------------------
// S2

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

// S1's launch: rows on y (at most 65,535, each block looping over rows past
// that), as many blocks a row on x as the card holds at once shared among
// them, and no more than a row has quads.
template <int kMode, typename Slot>
void launch_prp(cudaStream_t stream, const PrpArgs& a) {
  static const int per_sm = resident(prp_quads<kMode, Slot>);
  const long long fill = static_cast<long long>(card().sms) * per_sm;
  const long long gy = a.rows < 65535u ? a.rows : 65535;
  const long long fit = fill / gy > 1 ? fill / gy : 1;
  const long long need = ((a.n + 3) / 4 + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(need < fit ? need : fit),
                  static_cast<unsigned>(gy));
  prp_quads<kMode, Slot><<<grid, kThreads, 0, stream>>>(a);
}

template <typename Slot>
void launch_prp_mode(cudaStream_t stream, const PrpArgs& a, int mode) {
  switch (mode) {
    case kCapped:
      launch_prp<kCapped, Slot>(stream, a);
      break;
    case kExact:
      launch_prp<kExact, Slot>(stream, a);
      break;
    default:
      launch_prp<kInverse, Slot>(stream, a);
      break;
  }
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

// S1 on `stream`: out[l, i] = the PRP of slot i of row l, on [0, 2^k_bits)
// restricted to [0, count), for `rows` rows of n slots.  keys: int64
// words, row l's at keys + l * key_row (0: one key for every row); count:
// count_value (count_bytes 0) or the int32 (4) / int64 (8) at count + l *
// count_row; slots: int32 (slot_bytes 4) or int64 (8), row l's at slots +
// l * slot_row elements; out: int32 [rows, n], contiguous.  mode 0 the
// capped walk (epoch_permutation), 1 the exact walk
// (exact_prefix_permutation), 2 the exact inverse walk.
// Returns the launch's error.
int mfcd_prp(const int64_t* keys, long long key_row, const void* count,
             long long count_row, int count_bytes, long long count_value,
             const void* slots, long long slot_row, int slot_bytes,
             int32_t* out, long long rows, long long n, int mode, int k_bits,
             void* stream) {
  if (rows < 0 || rows >= (1LL << 32) || n < 0 || n >= (1LL << 31) ||
      mode < kCapped || mode > kInverse || k_bits < 1 || k_bits > 32 ||
      key_row < 0 || count_row < 0 || slot_row < 0 ||
      !(count_bytes == 0 || count_bytes == 4 || count_bytes == 8) ||
      !(slot_bytes == 4 || slot_bytes == 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const uintptr_t at = reinterpret_cast<uintptr_t>(slots) |
                       reinterpret_cast<uintptr_t>(out);
  PrpArgs a = {keys,
               key_row,
               count,
               count_row,
               static_cast<uint32_t>(count_value),
               count_bytes,
               slots,
               slot_row,
               out,
               static_cast<unsigned>(rows),
               static_cast<unsigned>(n),
               k_bits,
               n % 4 == 0 && at % 16 == 0 && slot_row * slot_bytes % 16 == 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slot_bytes == 4) {
    launch_prp_mode<int32_t>(st, a, mode);
  } else {
    launch_prp_mode<int64_t>(st, a, mode);
  }
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
