// The fused training epoch on NVIDIA Hopper (sm_90a), one template for the
// kernels built from it: K1 (epoch_kernel.cu, stage set kFull over the row
// layout) and the kernel-split profiler's P1 (the other stage sets) and P2
// (kFull over the factored layout), both in epoch_variants.cu.  The design
// is K1's (see epoch_kernel.cu); each stage is guarded by `if constexpr`, so
// the kFull instantiation is K1 and every other one is K1 with stages
// removed.
//
// Stage set V keeps stage s when V >= s (the order of VARIANTS in
// ops/kernel_split.py):
//   kLoopOnly  (0): the step loop, the one-step-ahead stream fetch, unpack,
//                   mask and the step's barriers (at c > 1 also the cluster
//                   barrier's arrive after each round of the batch phase
//                   and its wait before the next round's);
//   kOhOnly    (1): + resolving each index to its owner rank and local row
//                   (the TPU builds one-hot matrices here);
//   kNoScatter (2): + the reads of U[u], V[i], V[j] (at c > 1 the owners'
//                   push of the next step's rows into every CTA and the
//                   wait for their arrival), the logit, BCE, g and the
//                   contributions;
//   kNoAdam    (3): + the entry-list links, the touched rows and each touched
//                   row's ordered sum: the gradient the scatter produces;
//   kFull      (4): + the sparse and dense Adam.  This is K1.
// The ablated sets write no state back; each makes the loss and `alive`
// terms ops/kernel_split.py defines where its last stage's work is
// (loop_only the raw indices, oh_only the resolved rows, no_scatter |g|,
// no_adam |row sum| x the row's entry count), and keeps what it computes
// and does not use live with keep(), which issues no instruction.  The loss
// terms, as K1's, are kept per batch row by CTA 0, which computes every
// batch row at every launch shape, so state and loss are bit-equal across
// launch shapes; `alive` is each thread's running sum, reduced over the
// block and then the cluster once per epoch.
//
// The factored layout (P2) holds each table as [rows / 128, d * 128] (table
// row h * 128 + l, component k at [h, k * 128 + l]); loads and stores go
// through that index map into K1's planes.  V's gradient row then sums its
// i-entries (even V ids) in ascending order from 0, its j-entries (odd ids)
// likewise, and adds the two: the order of profile_kernel_split.py:447-450.
// The layout's padding rows (beyond the tables' own) hold p = 0 and get no
// gradient, so Adam leaves them at 0; the dense pass skips such all-zero
// elements, which on the IEEE slow paths cost a quarter of a microsecond of
// every step.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Stream layouts (mode 1, "uij", is a packed int32 (u, i, j) + float32 z).
constexpr int kModeFull = 0;  // one int32: u | i << bn | j << (bn+bm) | k << (bn+2bm)
constexpr int kModeNone = 2;  // int32 u, i, j + float32 z

// Stage sets.
constexpr int kLoopOnly = 0;
constexpr int kOhOnly = 1;
constexpr int kNoScatter = 2;
constexpr int kNoAdam = 3;
constexpr int kFull = 4;
constexpr float kScale = 1e-9f;  // weight of the ablated sets' loss terms

// Threads per CTA and CTAs per SM the compiler budgets registers for: the
// wide kernel spreads a run over 512 threads in each of its c CTAs; the
// packed one's CTA of 256 threads leaves room for three runs on one SM.
__host__ __device__ constexpr int threads_of(bool wide) { return wide ? 512 : 256; }
__host__ __device__ constexpr int min_blocks_of(bool wide) { return wide ? 1 : 3; }
constexpr int kPacked = 0;  // the launch shape "c" of the packed kernel
constexpr unsigned long long kEmpty = ~0ull;  // a list head no step wrote
// A row's list longer than this is summed by a scan of the entry ids.
constexpr int kShortList = 4;
constexpr int kLanes = 128;  // lanes per row of the factored layout
constexpr int kWarpSlots = 16;  // alive partial sums, one per warp

constexpr size_t kSmemPerBlock = 232448;  // a Hopper block's shared memory

// What an ablated stage set adds: a third loss term per batch row by step
// parity, and the block's alive partial sums.
__host__ __device__ inline size_t term_smem_bytes(int v, int bs) {
  return v == kFull ? 0 : sizeof(float) * (2 * (size_t)bs + kWarpSlots);
}

// One CTA's shared memory without the pushed rows' buffer: over its share of
// rows, ceil(n / c) + ceil(m / c), a stamped list head (8 bytes), and P, MU
// and NU, d floats each; per batch row three list links, three entry rows
// and three touched-row slots, 2 * d contributions, two (logit, z) pairs and
// a loss sum; two touched-row counts; when c > 1 the buffer's mbarrier (8
// bytes).
__host__ __device__ inline size_t base_smem_bytes(int n, int m, int d, int bs,
                                                  int c) {
  c = c < 1 ? 1 : c;
  const size_t rows = (size_t)((n + c - 1) / c) + (m + c - 1) / c;
  return 8 * rows + (c > 1 ? 8 : 0) +
         sizeof(float) * (3 * rows * d + (size_t)bs * (14 + 2 * d) + 2);
}

// When c > 1: the batch rows whose operand rows (3 * d floats each) one
// CTA's buffer holds at once, the whole batch where it fits beside the rest
// of the block and `extra` more bytes, else as many rows as fit (at least
// one); a step then takes its batch in rounds of that many rows.  0 when
// c <= 1.
__host__ __device__ inline int pushed_rows(int n, int m, int d, int bs, int c,
                                           size_t extra) {
  if (c <= 1) return 0;
  const size_t used = base_smem_bytes(n, m, d, bs, c) + extra;
  const size_t row = sizeof(float) * 3 * (size_t)d;
  const size_t fit = used < kSmemPerBlock ? (kSmemPerBlock - used) / row : 0;
  return (int)(fit < 1 ? 1 : fit < (size_t)bs ? fit : (size_t)bs);
}

// One CTA's shared memory: base_smem_bytes and, when c > 1, the pushed rows'
// buffer sized by pushed_rows (`extra` as there).
inline size_t epoch_smem_bytes(int n, int m, int d, int bs, int c,
                               size_t extra) {
  return base_smem_bytes(n, m, d, bs, c) +
         sizeof(float) * 3 * (size_t)d * pushed_rows(n, m, d, bs, c, extra);
}

struct Adam {
  float lr, wd, b1, omb1, b2, omb2, eps, bc1, bc2;
  // One element: (p, mu, nu) from (p, mu, nu) and the gradient sum acc.
  __device__ __forceinline__ void step(float& p, float& mu, float& nu,
                                       float acc) const {
    const float g = acc + wd * p;
    mu = b1 * mu + omb1 * g;
    nu = b2 * nu + omb2 * g * g;
    p = p - lr * (mu / bc1) / (sqrtf(nu / bc2) + eps);
  }
};

// Keeps values computed that a stage set does not use; issues nothing.
__device__ __forceinline__ void keep() {}
template <typename... T>
__device__ __forceinline__ void keep(int v, T... rest) {
  asm volatile("" ::"r"(v));
  keep(rest...);
}

// Element (component k, row row0 + row) of a run's table of `total` rows:
// [R, d, total], or factored [R, total / 128, d * 128].
template <bool kFactored>
__device__ __forceinline__ size_t table_index(int run, int k, int row0,
                                              int row, int total, int d) {
  if constexpr (kFactored) {
    const int r = row0 + row;
    return ((size_t)run * (total / kLanes) + r / kLanes) * d * kLanes +
           k * kLanes + r % kLanes;
  } else {
    return ((size_t)run * d + k) * total + row0 + row;
  }
}

// acc plus component k of entry e's contribution.  U ids are < bs and read
// cu; V id bs + x reads cv of batch row x >> 1, added for i (x even) and
// subtracted for j (x odd).
__device__ __forceinline__ float add_entry(float acc, int e,
                                           const float* __restrict__ cu,
                                           const float* __restrict__ cv,
                                           int bs, int d, int k) {
  if (e < bs) return acc + cu[e * d + k];
  const int x = e - bs;
  const float c = cv[(x >> 1) * d + k];
  return (x & 1) ? acc - c : acc + c;
}

// The sum of component k of local row `row`'s contributions (its list
// starts at `h`), in ascending id order, starting from 0; kSplitV: a V
// row's even (i) ids so, its odd (j) ids so, and the two added.  A list of
// up to kShortList entries by selection of the next-larger id; a longer one
// by a scan, in order, of the ids that can name the row (U: 0..bs-1, V:
// bs..3bs-1), whose entry rows `erow` hold.  Both give the same order.  The
// scan loads every id's row and contribution and selects the sum without a
// branch, so the loads of later ids go out ahead of the adds.  kCount: the
// row's entry count goes to *named.
template <bool kSplitV, bool kCount>
__device__ float row_sum(const int* __restrict__ nxt,
                         const int* __restrict__ erow, int h, int row,
                         bool is_v, const float* __restrict__ cu,
                         const float* __restrict__ cv, int bs, int d, int k,
                         int* named) {
  int len = 0;
  for (int e = h; e >= 0 && len <= kShortList; e = nxt[e]) ++len;
  float acc = 0.f, acc_j = 0.f;  // acc_j: kSplitV's j-entries
  if (len > kShortList) {
    int hits = 0;
    if (!is_v) {
#pragma unroll 8
      for (int b = 0; b < bs; ++b) {
        const float c = cu[b * d + k];
        acc = erow[b] == row ? acc + c : acc;
        if constexpr (kCount) hits += erow[b] == row;
      }
    } else {  // batch row b: entry bs + 2b (i, +c), then bs + 2b + 1 (j, -c)
#pragma unroll 8
      for (int b = 0; b < bs; ++b) {
        const float c = cv[b * d + k];
        acc = erow[bs + 2 * b] == row ? acc + c : acc;
        if constexpr (kSplitV)
          acc_j = erow[bs + 2 * b + 1] == row ? acc_j - c : acc_j;
        else
          acc = erow[bs + 2 * b + 1] == row ? acc - c : acc;
        if constexpr (kCount)
          hits += (erow[bs + 2 * b] == row) + (erow[bs + 2 * b + 1] == row);
      }
    }
    if constexpr (kCount) *named = hits;
    return kSplitV && is_v ? acc + acc_j : acc;
  }
  if constexpr (kCount) *named = len;
  int prev = -1;
  for (int q = 0; q < len; ++q) {
    int best = INT_MAX;
    for (int e = h; e >= 0; e = nxt[e])
      if (e > prev && e < best) best = e;
    if (kSplitV && is_v && ((best - bs) & 1))
      acc_j = add_entry(acc_j, best, cu, cv, bs, d, k);
    else
      acc = add_entry(acc, best, cu, cv, bs, d, k);
    prev = best;
  }
  return kSplitV && is_v ? acc + acc_j : acc;
}

__device__ __forceinline__ float bce(float logit, float z) {
  return fmaxf(logit, 0.f) - logit * z + log1pf(expf(-fabsf(logit)));
}

// The pushed rows' exchange within a cluster: an mbarrier that counts the
// bytes a step's pushes bring, st.async stores into a peer's shared memory
// that count on the peer's mbarrier, and the cluster barrier's two halves.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Address `a` of this CTA's shared memory in that of cluster CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of the barrier's phase, which then waits for `bytes`.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.  A phase that
// has not completed kWaitNs after its 1,024th poll never will (a valid row
// whose index names no CTA): it traps rather than hanging the card.  A
// healthy phase completes within microseconds of the pushes behind it, and
// its first polls read no clock.
constexpr unsigned long long kWaitNs = 10'000'000'000ull;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  unsigned long long start = 0;
  for (uint32_t spins = 1;; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023) == 0) {  // the clock, every 1,024 polls
      const unsigned long long t = now_ns();
      if (start == 0)
        start = t;
      else if (t - start > kWaitNs)
        __trap();
    }
  }
}

// One float, or two at an 8-byte-aligned address, into a peer's shared
// memory at cluster address `dst`, counted on its mbarrier `bar`.
__device__ __forceinline__ void push1(uint32_t dst, float a, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(dst),
      "r"(__float_as_uint(a)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void push2(uint32_t dst, float a, float b,
                                      uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];" ::"r"(dst),
      "r"(__float_as_uint(a)), "r"(__float_as_uint(b)), "r"(bar)
      : "memory");
}

// The cluster barrier's halves: arrive after this thread's reads of the
// pushed rows, wait before it writes a peer's buffer.  The arrive is
// relaxed: it orders no memory (the PTX memory model gives the reads no
// order against it), and the reads it follows have returned on the
// hardware, since the logit and the stores before it use every value they
// load; a release would wait for the step's stream prefetch from device
// memory too.  A push that overtook a read would change the bits
// tests/test_torch_cuda.py::test_push_path_is_bit_equal_at_every_launch_shape
// compares.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// kWide: 512 threads, one run per cluster of c CTAs, CTA r owning the U
// and V rows whose index is r modulo c (c = 1: the whole run, no
// cluster); otherwise 256 threads, one run per CTA (c = 1).  V: the
// stage set; kFactored: the factored layout (kFull only); kRounds: the
// steps take their batch in rounds (c > 1, a CTA's buffer holds fewer than
// bs rows; otherwise the rounds' code is left out).  alive_out: the ablated
// sets' alive sums.
template <bool kWide, int V, bool kFactored, bool kRounds>
__global__ void __launch_bounds__(threads_of(kWide), min_blocks_of(kWide))
epoch_kernel(
    float* __restrict__ u_t, float* __restrict__ v_t,
    float* __restrict__ mu_u, float* __restrict__ nu_u,
    float* __restrict__ mu_v, float* __restrict__ nu_v,
    const int32_t* __restrict__ s0, const int32_t* __restrict__ s1,
    const int32_t* __restrict__ s2, const float* __restrict__ sz,
    const float* __restrict__ lr_p, const float* __restrict__ wd_p,
    const float* __restrict__ step0_p, const int32_t* __restrict__ count_p,
    float* __restrict__ loss_out, int n, int m, int d, int num_batches,
    int bs, int mode, int bits_n, int bits_m, int bits_z, int denom,
    float b1, float omb1, float b2, float omb2, float eps, float log_b1,
    float log_b2, float* __restrict__ alive_out, int c) {
  static_assert(!kFactored || V == kFull, "P2 is the full epoch only");
  static_assert(kWide || !kRounds, "a packed run holds its whole batch");
  constexpr int kThreads = threads_of(kWide);
  // Row components a batch row loads at once: wide, four in flight beat
  // one (and packed, one beats four).
  constexpr int kLoads = kWide ? 4 : 1;
  extern __shared__ unsigned long long smem_words[];
  const bool split = kWide && c > 1;  // a run over a cluster of CTAs
  // Split, the stage sets that read rows have them pushed (below).
  const bool pushes = split && V >= kNoScatter;
  const int run = blockIdx.x / c;
  const int rank = split ? (int)cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x;
  // The share: the rows whose index is rank modulo c (c is a power of 2),
  // so that popular rows, which tend to have small indices, spread over the
  // cluster; local row q is row rank + q * c.
  const int sh_u = (n + c - 1) / c, sh_v = (m + c - 1) / c;  // share sizes
  const int lg_c = __ffs(c) - 1;
  const int own_u = rank < n ? ((n - 1 - rank) >> lg_c) + 1 : 0;
  const int own_v = rank < m ? ((m - 1 - rank) >> lg_c) + 1 : 0;
  const int own = own_u + own_v;
  const int rows = sh_u + sh_v;
  // Split: the batch rows the pushed buffer holds, all bs but in rounds.
  const int S =
      kRounds ? pushed_rows(n, m, d, bs, c, term_smem_bytes(V, bs)) : bs;

  // Component-major planes [d][rows]: the share's U rows at 0.., its V rows
  // at sh_u...  Adam updates P in place: no CTA reads another's P.  Split,
  // the batch phase reads its operands from `pushed`, [S][3][d] (U[u],
  // V[i], V[j] of each batch row), which the rows' owners fill with the
  // step's rows after the previous step's Adam, in every CTA of the
  // cluster.  A step takes its batch in rounds of S rows (one round where
  // S = bs); each round is one phase of `bar`, which completes when the
  // round's bytes have arrived.  The cluster barrier's arrive follows a
  // round's reads and its wait precedes the next round's pushes, so no CTA
  // writes a buffer a peer still reads.  A list head holds (step << 32 |
  // first id): a head stamped with another step is empty, so no pass resets
  // the heads.
  unsigned long long* head = smem_words;               // [rows]
  unsigned long long* bar = head + rows;               // split: [1]
  float* pushed = reinterpret_cast<float*>(bar + (split ? 1 : 0));
  float* P = pushed + (split ? 3 * S * d : 0);         // [d][rows]
  float* MU = P + rows * d;
  float* NU = MU + rows * d;
  int* nxt = reinterpret_cast<int*>(NU + rows * d);    // [3 bs] list links
  int* erow = nxt + 3 * bs;     // [3 bs] entry's local row, -1: not linked
  int* touched = erow + 3 * bs;  // [3 bs] rows whose list a step opened
  float* cu = reinterpret_cast<float*>(touched + 3 * bs);  // [bs][d] g * dv
  float* cv = cu + bs * d;                                 // [bs][d] g * eu
  float* lz = cv + bs * d;   // [2][bs][2] (logit, z) by step parity
  float* lsum = lz + 4 * bs;  // [bs] row b's BCE terms, summed over steps
  // [2] touched rows by step parity: step t counts in [t & 1] and zeroes
  // [(t + 1) & 1], which no thread reads or counts until step t + 1.
  int* ntouched = reinterpret_cast<int*>(lsum + bs);
  // Ablated sets (term_smem_bytes): [2][bs] a third loss term by step
  // parity, and [kWarpSlots] the block's alive partial sums.
  float* aux = reinterpret_cast<float*>(ntouched + 2);
  float* red = aux + 2 * bs;

  // Load the share's state, as far as the stage set reads it.
  if constexpr (V >= kNoScatter) {
    for (int e = tid; e < own_u * d; e += kThreads) {
      const int k = e / own_u, row = e - k * own_u, s = k * rows + row;
      const size_t g = table_index<kFactored>(run, k, rank, row << lg_c, n, d);
      P[s] = u_t[g];
      if constexpr (V == kFull) {
        MU[s] = mu_u[g];
        NU[s] = nu_u[g];
      }
    }
    for (int e = tid; e < own_v * d; e += kThreads) {
      const int k = e / own_v, row = e - k * own_v, s = k * rows + sh_u + row;
      const size_t g = table_index<kFactored>(run, k, rank, row << lg_c, m, d);
      P[s] = v_t[g];
      if constexpr (V == kFull) {
        MU[s] = mu_v[g];
        NU[s] = nu_v[g];
      }
    }
  }
  for (int row = tid; row < rows; row += kThreads) head[row] = kEmpty;
  for (int b = tid; b < bs; b += kThreads) lsum[b] = 0.f;
  if (tid < 2) ntouched[tid] = 0;
  const float step0 = step0_p[run];
  const int count = max(count_p[run], 0);
  const int num_exec = (count + bs - 1) / bs;
  const int steps = min(num_exec, num_batches);
  // Split: step s's rounds, and the bytes its round r's pushes bring each
  // CTA, the three rows of each of the round's valid batch rows.
  auto rounds_of = [&](int s) {
    return kRounds ? (min(bs, count - s * bs) + S - 1) / S : 1;
  };
  auto pushed_bytes = [&](int s, int r) {
    const int hi = min(min(bs, count - s * bs), (r + 1) * S);
    return (uint32_t)(3 * (hi - r * S) * d * sizeof(float));
  };
  const uint32_t bar_a = smem_addr(bar);
  if (pushes && tid == 0) {
    bar_init(bar_a);
    if (steps > 0) bar_expect(bar_a, pushed_bytes(0, 0));
  }
  if (split)
    cg::this_cluster().sync();
  else
    __syncthreads();

  Adam adam;
  adam.lr = lr_p[run];
  adam.wd = wd_p[run];
  adam.b1 = b1;
  adam.omb1 = omb1;
  adam.b2 = b2;
  adam.omb2 = omb2;
  adam.eps = eps;
  const size_t base = (size_t)run * num_batches * bs;
  const int mask_n = (1 << bits_n) - 1;
  const int mask_m = (1 << bits_m) - 1;
  const int mask_z = (1 << bits_z) - 1;
  const float denom_f = (float)denom;
  // The batch phase's work items, over the threads: bs rows (forward, g,
  // contributions), 3 bs gradient entries (the list links, which need only
  // the stream word), and where this CTA keeps the loss (CTA 0), the bs
  // BCE terms of the previous step, off the rows' critical path.  Row b's
  // terms are summed in lsum[b] by one item whatever the thread count, so
  // the loss is the same at every cluster size.
  const bool keeps_loss = rank == 0;
  const int items = (keeps_loss ? 5 : 4) * bs;
  auto batch_row = [&](int w) {  // the batch row of item w < 4 bs
    const int id = w - bs;
    return w < bs ? w : id < bs ? id : (id - bs) >> 1;
  };
  float alive = 0.f;  // ablated sets: this thread's alive terms

  // Batch row b of step t's stream words.
  auto fetch = [&](int t, int b, int32_t& w0, int32_t& w1, int32_t& w2,
                   float& wz) {
    const size_t o = base + (size_t)t * bs + b;
    w0 = s0[o];
    if (mode == kModeNone) {
      w1 = s1[o];
      w2 = s2[o];
    }
    if (mode != kModeFull) wz = sz[o];
  };
  auto label = [&](int32_t w0, float wz) {
    return mode == kModeNone ? wz
           : mode == kModeFull
               ? (float)((w0 >> (bits_n + 2 * bits_m)) & mask_z) / denom_f
               : wz;
  };
  // Row b's term of step t's loss (0 for a masked row but in loop_only,
  // whose index sums take every row): K1's masked-mean BCE, plus the
  // ablated sets' terms weighted kScale.
  auto loss_term = [&](int t, int b) {
    const int cnt = min(bs, count - t * bs);
    if constexpr (V == kLoopOnly) {
      const float* pair = lz + (t & 1) * 2 * bs + 2 * b;  // (z, u + i + j)
      return (b < cnt ? pair[0] : 0.f) + pair[1] * kScale;
    } else {
      if (b >= cnt) return 0.f;
      const float* pair = lz + (t & 1) * 2 * bs + 2 * b;
      if constexpr (V == kOhOnly)  // the one-hots' row terms
        return pair[0] * kScale + pair[1] * kScale;
      const float l = bce(pair[0], pair[1]) * (1.f / (float)max(cnt, 1));
      if constexpr (V == kNoScatter || V == kNoAdam)
        return l + aux[(t & 1) * bs + b] * kScale;
      return l;
    }
  };
  auto unpack = [&](int32_t w0, int32_t w1, int32_t w2, int& u, int& i,
                    int& j) {
    if (mode == kModeNone) {
      u = w0;
      i = w1;
      j = w2;
    } else {
      u = w0 & mask_n;
      i = (w0 >> bits_n) & mask_m;
      j = (w0 >> (bits_n + bits_m)) & mask_m;
    }
  };
  // The words of the thread's first item are fetched one step ahead, into
  // registers.
  int32_t y0 = 0, y1 = 0, y2 = 0;
  float yz = 0.f;
  if (tid < 4 * bs && steps > 0) fetch(0, batch_row(tid), y0, y1, y2, yz);

  // Split: round r of step s's rows, pushed by their owners.  Entry id x
  // (the batch phase's item bs + x: U of row x, V i and j of row
  // (x - bs) >> 1) names one row, whose d floats go into slot
  // (b - r * S, 0 | 1 | 2) of every CTA's buffer, this one's included.  A
  // warp takes 32 items at a time, in the batch phase's order, so in round
  // 0, before the batch phase takes it, the thread whose first item it is
  // holds step s's words already (others fetch them); the lanes whose row
  // this CTA owns are then served 32 / c at a time, lane l storing one of
  // them into CTA (rank + l) % c, whose buffer and mbarrier it mapped once.
  const int lane = tid & 31;
  const int per = 32 / c;  // owned rows a warp pushes at once
  const int to = (rank + lane) % c;
  const uint32_t peer_pushed = pushes ? peer_addr(smem_addr(pushed), to) : 0;
  const uint32_t peer_bar = pushes ? peer_addr(bar_a, to) : 0;
  auto push = [&](int s, int r) {
    const int lo = r * S, hi = min(min(bs, count - s * bs), lo + S);
    for (int base = tid - lane; base < 4 * bs; base += kThreads) {
      const int w = base + lane, x = w - bs;
      const bool is_v = x >= bs;
      const int b = is_v ? (x - bs) >> 1 : x;
      // masked rows are neither pushed nor read
      bool mine = w >= bs && w < 4 * bs && b >= lo && b < hi;
      int slot = 0, lrow = 0;  // the row's slot in a buffer, local row
      if (mine) {
        int32_t w0 = y0, w1 = y1, w2 = y2;
        float wz = 0.f;
        if (w != tid || r > 0) fetch(s, b, w0, w1, w2, wz);
        int u, i, j;
        unpack(w0, w1, w2, u, i, j);
        const int o = is_v ? 1 + ((x - bs) & 1) : 0;
        const int row = o == 0 ? u : o == 1 ? i : j;
        mine = (row & (c - 1)) == rank;
        slot = ((b - lo) * 3 + o) * d;
        lrow = (is_v ? sh_u : 0) + (row >> lg_c);
      }
      const unsigned owned = __ballot_sync(~0u, mine);
      const int n_owned = __popc(owned);
      for (int first = 0; first < n_owned; first += per) {
        const int pos = first + lane / c;
        const bool serves = lane < per * c && pos < n_owned;
        const int from = serves ? (int)__fns(owned, 0, pos + 1) : lane;
        const int off = __shfl_sync(~0u, slot, from);
        const float* src = P + __shfl_sync(~0u, lrow, from);
        if (serves) {
          const uint32_t dst = peer_pushed + 4 * off;
          int k = 0;
          if ((d & 1) == 0)
            for (; k < d; k += 2)
              push2(dst + 4 * k, src[k * rows], src[(k + 1) * rows],
                    peer_bar);
          for (; k < d; ++k) push1(dst + 4 * k, src[k * rows], peer_bar);
        }
      }
    }
  };
  // The round of a step of `rounds` that takes item w (kRounds): a row's
  // forward in the round that pushes its rows (a masked row's in the last),
  // every other item in round 0.
  auto round_of = [&](int w, int rounds) {
    return w < bs ? min(w / S, rounds - 1) : 0;
  };
  int phase = 0;  // kRounds: the rounds before this one, over the epoch
  for (int t = 0; t < steps; ++t) {
    const int cnt = min(bs, count - t * bs);
    const float inv_cnt = 1.f / (float)max(cnt, 1);
    const unsigned long long stamp = (unsigned long long)t << 32;
    const int rounds = rounds_of(t);  // 1 but where kRounds

    // 1. Batch phase.  Split, every CTA computes every row, reading the
    // rows pushed into its buffer, and links the entries whose rows it
    // owns.  A masked row contributes exactly zero: it is not linked.
    for (int r = 0; r < rounds; ++r) {
      // Split: every CTA past its reads of the previous round's rows (the
      // wait), then this round's rows pushed; the epoch's first follow the
      // barrier before the loop.
      if (split) {
        if (t > 0 || r > 0) cluster_wait();
        if (pushes) push(t, r);
      }
      bool arrived = false;  // split: this thread has seen the round's rows
      // Thread 0 (its row 0 always valid in round 0) arms the next round's
      // phase once this one has completed; no push reaches it before.
      auto arm_next = [&]() {
        if (r + 1 < rounds)
          bar_expect(bar_a, pushed_bytes(t, r + 1));
        else if (t + 1 < steps)
          bar_expect(bar_a, pushed_bytes(t + 1, 0));
      };
      for (int w = tid; w < items; w += kThreads) {
        if constexpr (kRounds)
          if (round_of(w, rounds) != r) continue;
        if (w >= 4 * bs) {
          if (t > 0) lsum[w - 4 * bs] += loss_term(t - 1, w - 4 * bs);
          continue;
        }
        const int b = batch_row(w);
        int32_t w0 = 0, w1 = 0, w2 = 0;
        float wz = 0.f;
        if (w == tid) {
          w0 = y0;
          w1 = y1;
          w2 = y2;
          wz = yz;
          if (t + 1 < steps) fetch(t + 1, b, y0, y1, y2, yz);
        } else {
          fetch(t, b, w0, w1, w2, wz);
        }
        int u, i, j;
        unpack(w0, w1, w2, u, i, j);
        const bool valid = b < cnt;
        if constexpr (V == kLoopOnly) {  // CTA 0 records every row's indices
          keep(u, i, j, valid);
          if (w < bs && keeps_loss) {
            const float s = (float)u + (float)i + (float)j;
            lz[(t & 1) * 2 * bs + 2 * b] = label(w0, wz);
            lz[(t & 1) * 2 * bs + 2 * b + 1] = s;
            alive += s;
          }
          continue;
        }
        if (w >= bs) {  // gradient entry id: U (b), V i (even), V j (odd)
          const int id = w - bs;
          const bool is_v = id >= bs;
          const int row = !is_v ? u : ((id - bs) & 1) ? j : i;
          const int owner = row & (c - 1);
          const int lrow = (is_v ? sh_u : 0) + (row >> lg_c);
          const bool linked = valid && owner == rank;
          if constexpr (V < kNoAdam) {  // resolved, not linked
            if constexpr (V == kOhOnly) alive += linked ? (float)row : 0.f;
            keep(lrow, linked);
            continue;
          }
          erow[id] = linked ? lrow : -1;
          if (linked) {
            const unsigned long long old =
                atomicExch(&head[lrow], stamp | (unsigned)id);
            const bool opens = (old >> 32) != (unsigned long long)t;
            nxt[id] = opens ? -1 : (int)old;
            if (opens) touched[atomicAdd(&ntouched[t & 1], 1)] = lrow;
          }
          continue;
        }
        if (!valid) continue;
        if constexpr (V == kOhOnly) {  // the rows' owners, resolved only
          keep(u & (c - 1), i & (c - 1), j & (c - 1));
          if (keeps_loss) {
            lz[(t & 1) * 2 * bs + 2 * b] = u < n ? 1.f : 0.f;
            lz[(t & 1) * 2 * bs + 2 * b + 1] =
                (i < m ? 1.f : 0.f) - (j < m ? 1.f : 0.f);
          }
          continue;
        }
        const float z = label(w0, wz);
        const float *pu, *pi, *pj;
        int stride;  // between a row's components
        if (split) {
          if (!arrived) {
            bar_wait(bar_a, (kRounds ? phase : t) & 1);
            arrived = true;
            if (tid == 0) arm_next();
          }
          pu = pushed + (b - r * S) * 3 * d;
          pi = pu + d;
          pj = pi + d;
          stride = 1;
        } else {
          pu = P + u;
          pi = P + sh_u + i;
          pj = P + sh_u + j;
          stride = rows;
        }
        // Up to kLoads components' loads go out together, ahead of stores
        // the compiler cannot tell apart from them.  The first kLoads
        // components' dv and eu stay in registers until g scales them; the
        // rest wait in cu and cv.
        float logit = 0.f;
        float dv0[kLoads], eu0[kLoads];
        for (int k0 = 0; k0 < d; k0 += kLoads) {
          float eu[kLoads], vi[kLoads], vj[kLoads];
#pragma unroll
          for (int x = 0; x < kLoads; ++x)
            if (k0 + x < d) {
              eu[x] = pu[(k0 + x) * stride];
              vi[x] = pi[(k0 + x) * stride];
              vj[x] = pj[(k0 + x) * stride];
            }
#pragma unroll
          for (int x = 0; x < kLoads; ++x)
            if (k0 + x < d) {
              const float dv = vi[x] - vj[x];
              logit += eu[x] * dv;
              if (k0 == 0) {
                dv0[x] = dv;
                eu0[x] = eu[x];
              } else {
                cu[b * d + k0 + x] = dv;
                cv[b * d + k0 + x] = eu[x];
              }
            }
        }
        const float sig = 1.f / (1.f + expf(-logit));
        const float g = (sig - z) * inv_cnt;
#pragma unroll
        for (int x = 0; x < kLoads; ++x)
          if (x < d) {
            cu[b * d + x] = g * dv0[x];
            cv[b * d + x] = g * eu0[x];
          }
        for (int k = kLoads; k < d; ++k) {
          cu[b * d + k] = g * cu[b * d + k];
          cv[b * d + k] = g * cv[b * d + k];
        }
        if (keeps_loss) {
          lz[(t & 1) * 2 * bs + 2 * b] = logit;
          lz[(t & 1) * 2 * bs + 2 * b + 1] = z;
          if constexpr (V == kNoScatter) {  // sum(g), and |g| into alive
            aux[(t & 1) * bs + b] = g;
            alive += fabsf(g);
          }
          if constexpr (V == kNoAdam) {  // sum(grad U); V's sums to 0
            float s = 0.f;
            for (int k = 0; k < d; ++k) s += cu[b * d + k];
            aux[(t & 1) * bs + b] = s;
          }
        }
      }
      if constexpr (kRounds)
        if (pushes && tid == 0 && !arrived) {  // no row of its in the round
          bar_wait(bar_a, phase & 1);
          arm_next();
        }
      if (split) cluster_arrive();  // this thread's reads of `pushed` are done
      if constexpr (kRounds) ++phase;
    }
    __syncthreads();

    // 2. Adam over the share.  Component k of a touched row is updated by
    // the thread of (the row, k), which sums the row's list; every other
    // element by the dense pass, with a gradient of 0.  The sparse items
    // start at the highest thread, the dense elements at the lowest: where a
    // share has fewer elements than threads, the two run side by side.
    // no_adam: each touched row's sum, no Adam.
    if constexpr (V >= kNoAdam) {
      const float t_step = step0 + (float)(t + 1);
      adam.bc1 = 1.f - expf(t_step * log_b1);
      adam.bc2 = 1.f - expf(t_step * log_b2);
      const int sparse = ntouched[t & 1] * d;
      if (tid == 0) ntouched[(t + 1) & 1] = 0;
      for (int x = kThreads - 1 - tid; x < sparse; x += kThreads) {
        const int q = x / d, k = x - q * d;
        const int row = touched[q];
        if constexpr (V == kNoAdam) {
          // |sum| once for each lane that names the row: its entries, and
          // on CTA 0 the masked lanes, which name U and V row 0 (u, i, j).
          int named = 0;
          const float s = row_sum<false, true>(
              nxt, erow, (int)(unsigned)head[row], row, row >= sh_u, cu, cv,
              bs, d, k, &named);
          if (rank == 0 && (row == 0 || row == sh_u))
            named += (row == 0 ? 1 : 2) * (bs - cnt);
          alive += fabsf(s) * (float)named;
        } else {
          const int e = k * rows + row;
          float p = P[e], mu = MU[e], nu = NU[e];
          adam.step(p, mu, nu,
                    row_sum<kFactored, false>(nxt, erow,
                                              (int)(unsigned)head[row], row,
                                              row >= sh_u, cu, cv, bs, d, k,
                                              nullptr));
          P[e] = p;
          MU[e] = mu;
          NU[e] = nu;
        }
      }
      if constexpr (V == kFull) {
        // Dense: element f = k * own + q of the share (q over its rows), f
        // from tid in steps of kThreads.
        int k = 0, q = tid;
        while (q >= own && k < d) {
          q -= max(own, 1);
          ++k;
        }
        while (k < d) {
          const int row = q < own_u ? q : sh_u + (q - own_u);
          if ((head[row] >> 32) != (unsigned long long)t) {
            const int e = k * rows + row;
            float p = P[e], mu = MU[e], nu = NU[e];
            // P2's padding rows: Adam with no gradient leaves an all-zero
            // element at 0, but only after the IEEE division's and square
            // root's slow paths on zeros; those rows skip it.
            if (!(kFactored && p == 0.f && mu == 0.f && nu == 0.f)) {
              adam.step(p, mu, nu, 0.f);
              P[e] = p;
              MU[e] = mu;
              NU[e] = nu;
            }
          }
          q += kThreads;
          while (q >= own && k < d) {
            q -= own;
            ++k;
          }
        }
      }
    }
    // Adam's writes before the pushes that read them and the next batch
    // phase.
    __syncthreads();
  }
  if (split && steps > 0) cluster_wait();  // the last step's arrive

  // Write the share back.  Every push into this CTA has arrived, and no CTA
  // reads its shared memory.
  if constexpr (V == kFull) {
    for (int e = tid; e < own_u * d; e += kThreads) {
      const int k = e / own_u, row = e - k * own_u, s = k * rows + row;
      const size_t g = table_index<kFactored>(run, k, rank, row << lg_c, n, d);
      u_t[g] = P[s];
      mu_u[g] = MU[s];
      nu_u[g] = NU[s];
    }
    for (int e = tid; e < own_v * d; e += kThreads) {
      const int k = e / own_v, row = e - k * own_v, s = k * rows + sh_u + row;
      const size_t g = table_index<kFactored>(run, k, rank, row << lg_c, m, d);
      v_t[g] = P[s];
      mu_v[g] = MU[s];
      nu_v[g] = NU[s];
    }
  } else {
    // alive: the mean over executed batches of the block's, then the
    // cluster's, sums.
    for (int o = 16; o > 0; o >>= 1)
      alive += __shfl_down_sync(0xffffffffu, alive, o);
    if ((tid & 31) == 0) red[tid >> 5] = alive;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s += red[w];
      red[0] = s;
    }
    if (split) cg::this_cluster().sync();
    if (keeps_loss && tid == 0) {
      float total = red[0];
      if (split) {
        cg::cluster_group cl = cg::this_cluster();
        for (int r = 1; r < c; ++r) total += *cl.map_shared_rank(red, r);
      }
      alive_out[run] = total / fmaxf((float)num_exec, 1.f);
    }
    if (split) cg::this_cluster().sync();  // CTA 0 has read every share
  }
  // The epoch's loss: the mean over executed batches of the masked means.
  if (!keeps_loss) return;
  if (steps > 0)
    for (int b = tid; b < bs; b += kThreads) lsum[b] += loss_term(steps - 1, b);
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int b = 0; b < bs; ++b) total += lsum[b];
    loss_out[run] = total / fmaxf((float)num_exec, 1.f);
  }
}

// The wide kernel at launch shape c pushes its steps' rows in rounds.
template <int V>
bool in_rounds(int n, int m, int d, int bs, int c) {
  return c > 1 && pushed_rows(n, m, d, bs, c, term_smem_bytes(V, bs)) < bs;
}

// Stage set V's kernel (layout kFactored) at launch shape c (kPacked: the
// packed kernel; c >= 1: the wide kernel over clusters of c CTAs).
template <int V, bool kFactored>
const void* kernel_of(int n, int m, int d, int bs, int c) {
  if (c == kPacked)
    return (const void*)epoch_kernel<false, V, kFactored, false>;
  if (in_rounds<V>(n, m, d, bs, c))
    return (const void*)epoch_kernel<true, V, kFactored, true>;
  return (const void*)epoch_kernel<true, V, kFactored, false>;
}

// Sets the launch attributes of stage set V's kernel (layout kFactored) of
// launch shape c; returns the shared memory per CTA in *smem.
template <int V, bool kFactored>
cudaError_t prepare(int n, int m, int d, int bs, int c, size_t* smem) {
  const size_t extra = term_smem_bytes(V, bs);
  *smem = epoch_smem_bytes(n, m, d, bs, c, extra) + extra;
  const void* fn = kernel_of<V, kFactored>(n, m, d, bs, c);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem));
  if (err == cudaSuccess && c > 8)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t cluster_config(int clusters, int c, size_t smem,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * c);
  cfg.blockDim = dim3(threads_of(true));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// At launch shape c (kPacked, or the wide kernel over clusters of c CTAs):
// the CTAs that fit on one SM, and the runs the card holds at once (its
// resident clusters where c > 1).  A cluster size above 8 that the card does
// not schedule gives 0 runs, not an error.
template <int V, bool kFactored>
int occupancy(int c, int n, int m, int d, int bs, int* blocks_per_sm,
              int* runs) {
  size_t smem;
  *blocks_per_sm = 0;
  *runs = 0;
  cudaError_t err = prepare<V, kFactored>(n, m, d, bs, c, &smem);
  if (err != cudaSuccess) {
    if (c <= 8) return static_cast<int>(err);
    cudaGetLastError();
    return 0;
  }
  const void* fn = kernel_of<V, kFactored>(n, m, d, bs, c);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, threads_of(c != kPacked), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c <= 1) {
    int dev, sms;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) *runs = *blocks_per_sm * sms;
    return static_cast<int>(err);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, c, smem, &attr, 0);
  err = cudaOccupancyMaxActiveClusters(runs, fn, &cfg);
  if (err != cudaSuccess && c > 8) {
    cudaGetLastError();
    *runs = 0;
    return 0;
  }
  return static_cast<int>(err);
}

// Launches one epoch of stage set V (layout kFactored) for R runs on
// `stream` at launch shape c: kPacked, one 256-thread CTA per run; 1, one
// 512-thread CTA per run; c > 1, a cluster of c 512-thread CTAs per run.
// `args` are the kernel's arguments before c.  Returns the launch's error.
template <int V, bool kFactored, typename... Args>
int launch(int R, int n, int m, int d, int bs, int c, cudaStream_t st,
           Args... args) {
  size_t smem;
  cudaError_t err = prepare<V, kFactored>(n, m, d, bs, c, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R == 0) return 0;
  if (c <= 1) {
    if (c == kPacked)
      epoch_kernel<false, V, kFactored, false>
          <<<R, threads_of(false), smem, st>>>(args..., 1);
    else
      epoch_kernel<true, V, kFactored, false>
          <<<R, threads_of(true), smem, st>>>(args..., 1);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(R, c, smem, &attr, st);
  err = in_rounds<V>(n, m, d, bs, c)
            ? cudaLaunchKernelEx(&cfg, epoch_kernel<true, V, kFactored, true>,
                                 args..., c)
            : cudaLaunchKernelEx(&cfg, epoch_kernel<true, V, kFactored, false>,
                                 args..., c);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
