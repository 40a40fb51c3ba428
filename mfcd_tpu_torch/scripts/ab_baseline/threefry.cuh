// The earlier design of S2 and T1 (one slot, one hash a thread), kept
// unchanged for scripts/ab_shuffle_kernels.py and chip_smoke.py [14a]
// to time the kernels of ops/csrc/ against; no wrapper of the port calls it.
//
// threefry2x32 on native uint32 words, bit-equal to jax 0.9.0's jax.random
// with jax_threefry_partitionable=True (that version's default), and the key
// operations built on it.  Shared by prng_kernel.cu (T1) and
// shuffle_kernel.cu (S1, S2); core/prng.py documents the layout:
//
// - a key is two words (k0, k1); fold_in(k, x) hashes the counter (0, x),
// - split(k, num)[i] is the pair hashed from the counter of flat index i,
// - bits(k, shape)[i] is o0 ^ o1 of that same hash,
// - the counter of flat index i is (i >> 32, i & 0xFFFFFFFF).
//
// Every sum wraps mod 2^32, as the plain version's `& M32` does.

#pragma once

#include <cstdint>

namespace mfcd {

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// The 20-round threefry2x32 hash of the counter (x0, x1) under (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x0 += x1;
      x1 = rotl32(x1, kRot[block % 2][q]) ^ x0;
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + static_cast<uint32_t>(block + 1);
  }
  o0 = x0;
  o1 = x1;
}

// The hash of flat counter index i (jax's partitionable iota).
__device__ __forceinline__ void hash_index(uint32_t k0, uint32_t k1,
                                           uint64_t i, uint32_t& o0,
                                           uint32_t& o1) {
  threefry2x32(k0, k1, static_cast<uint32_t>(i >> 32),
               static_cast<uint32_t>(i), o0, o1);
}

// jax.random.fold_in(k, data): the key hashed from the counter (0, data).
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t data) {
  threefry2x32(k0, k1, 0u, data, k0, k1);
}

// jax.random.split(k, num)[i] for i < 2^32.
__device__ __forceinline__ void split_at(uint32_t k0, uint32_t k1,
                                         uint32_t i, uint32_t& s0,
                                         uint32_t& s1) {
  threefry2x32(k0, k1, 0u, i, s0, s1);
}

// jax.random.bits(k, shape, uint32) at flat index i.
__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1,
                                            uint64_t i) {
  uint32_t o0, o1;
  hash_index(k0, k1, i, o0, o1);
  return o0 ^ o1;
}

}  // namespace mfcd
