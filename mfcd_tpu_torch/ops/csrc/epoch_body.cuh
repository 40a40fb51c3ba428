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
//                   mask and the step's two barriers (the second a cluster
//                   barrier at c > 1);
//   kOhOnly    (1): + resolving each index to its owner rank and local row
//                   (the TPU builds one-hot matrices here);
//   kNoScatter (2): + the gathers of U[u], V[i], V[j] (DSMEM at c > 1), the
//                   logit, BCE, g and the contributions;
//   kNoAdam    (3): + the entry-list links, the touched rows and each touched
//                   row's ordered sum: the gradient the scatter produces;
//   kFull      (4): + the sparse and dense Adam.  This is K1.
// The ablated sets write no state back and never flip their P buffer; each
// makes the loss and `alive` terms ops/kernel_split.py defines where its
// last stage's work is (loop_only the raw indices, oh_only the resolved
// rows, no_scatter |g|, no_adam |row sum| x the row's entry count), and
// keeps what it computes and does not use live with keep(), which issues no
// instruction.  The loss terms, as K1's, are kept per batch row by CTA 0,
// which computes every batch row at every launch shape, so state and loss
// are bit-equal across launch shapes; `alive` is each thread's running sum,
// reduced over the block and then the cluster once per epoch.
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

inline size_t epoch_smem_bytes(int n, int m, int d, int bs, int c) {
  // Over the CTA's share of rows, ceil(n / c) + ceil(m / c): a stamped list
  // head (8 bytes), and P (twice when c > 1), MU and NU, d floats each; per
  // batch row three list links, three entry rows and three touched-row
  // slots, 2 * d contributions, two (logit, z) pairs and a loss sum; two
  // touched-row counts.
  c = c < 1 ? 1 : c;
  const size_t rows = (size_t)((n + c - 1) / c) + (m + c - 1) / c;
  const size_t planes = c > 1 ? 4 : 3;
  return 8 * rows + sizeof(float) * (planes * rows * d +
                                     (size_t)bs * (14 + 2 * d) + 2);
}

// What an ablated stage set adds: a third loss term per batch row by step
// parity, and the block's alive partial sums.
inline size_t term_smem_bytes(int v, int bs) {
  return v == kFull ? 0 : sizeof(float) * (2 * (size_t)bs + kWarpSlots);
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

// kWide: 512 threads, one run per cluster of c CTAs, CTA r owning U rows
// [r * ceil(n / c), ...) and V rows [r * ceil(m / c), ...) (c = 1: the whole
// run, no cluster); otherwise 256 threads, one run per CTA (c = 1).  V: the
// stage set; kFactored: the factored layout (kFull only).  alive_out: the
// ablated sets' alive sums.
template <bool kWide, int V, bool kFactored>
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
  constexpr int kThreads = threads_of(kWide);
  // Row components a batch row gathers at once: split, the gathers are
  // remote, and four in flight beat one (and packed, one beats four).
  constexpr int kLoads = kWide ? 4 : 1;
  constexpr bool kFlips = V == kFull;  // Adam writes the other P buffer
  extern __shared__ unsigned long long smem_words[];
  const bool split = kWide && c > 1;  // a run over a cluster of CTAs
  const int run = blockIdx.x / c;
  const int rank = split ? (int)cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x;
  const int sh_u = (n + c - 1) / c, sh_v = (m + c - 1) / c;  // share sizes
  const int u0 = rank * sh_u, v0 = rank * sh_v;  // the share's first rows
  const int own_u = max(0, min(sh_u, n - u0)), own_v = max(0, min(sh_v, m - v0));
  const int own = own_u + own_v;
  const int rows = sh_u + sh_v;

  // Component-major planes [d][rows]: the share's U rows at 0.., its V rows
  // at sh_u...  Split, P is double-buffered: step t gathers from buffer t & 1
  // in every CTA of the cluster and Adam writes buffer (t + 1) & 1, so one
  // cluster barrier per step keeps a row from changing while another CTA
  // reads it.  A list head holds (step << 32 | first id): a head stamped
  // with another step is empty, so no pass resets the heads.
  unsigned long long* head = smem_words;               // [rows]
  float* P0 = reinterpret_cast<float*>(head + rows);   // [d][rows]
  float* P1 = split ? P0 + rows * d : P0;
  float* MU = P1 + rows * d;
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
      const size_t g = table_index<kFactored>(run, k, u0, row, n, d);
      P0[s] = u_t[g];
      if constexpr (V == kFull) {
        MU[s] = mu_u[g];
        NU[s] = nu_u[g];
      }
    }
    for (int e = tid; e < own_v * d; e += kThreads) {
      const int k = e / own_v, row = e - k * own_v, s = k * rows + sh_u + row;
      const size_t g = table_index<kFactored>(run, k, v0, row, m, d);
      P0[s] = v_t[g];
      if constexpr (V == kFull) {
        MU[s] = mu_v[g];
        NU[s] = nu_v[g];
      }
    }
  }
  for (int row = tid; row < rows; row += kThreads) head[row] = kEmpty;
  for (int b = tid; b < bs; b += kThreads) lsum[b] = 0.f;
  if (tid < 2) ntouched[tid] = 0;
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
  const float step0 = step0_p[run];
  const int count = max(count_p[run], 0);
  const int num_exec = (count + bs - 1) / bs;
  const int steps = min(num_exec, num_batches);
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
  // The words of the thread's first item are fetched one step ahead, into
  // registers.
  int32_t y0 = 0, y1 = 0, y2 = 0;
  float yz = 0.f;
  if (tid < 4 * bs && steps > 0) fetch(0, batch_row(tid), y0, y1, y2, yz);

  for (int t = 0; t < steps; ++t) {
    const int cnt = min(bs, count - t * bs);
    const float inv_cnt = 1.f / (float)max(cnt, 1);
    const float* Pc = (kFlips && (t & 1)) ? P1 : P0;  // read this step
    float* Pn = (kFlips && (t & 1)) ? P0 : P1;        // written by Adam
    const unsigned long long stamp = (unsigned long long)t << 32;

    // 1. Batch phase.  Split, every CTA computes every row, gathering from
    // the owning CTAs' shared memory, and links the entries whose rows it
    // owns.  A masked row contributes exactly zero: it is not linked.
    for (int w = tid; w < items; w += kThreads) {
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
      if (mode == kModeNone) {
        u = w0;
        i = w1;
        j = w2;
      } else {
        u = w0 & mask_n;
        i = (w0 >> bits_n) & mask_m;
        j = (w0 >> (bits_n + bits_m)) & mask_m;
      }
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
        const int sh = is_v ? sh_v : sh_u;
        const int owner = split ? row / sh : 0;
        const int lrow = (is_v ? sh_u : 0) + row - owner * sh;
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
      if constexpr (V == kOhOnly) {  // the gathers' owners, resolved only
        keep(split ? u / sh_u : 0, split ? i / sh_v : 0,
             split ? j / sh_v : 0);
        if (keeps_loss) {
          lz[(t & 1) * 2 * bs + 2 * b] = u < n ? 1.f : 0.f;
          lz[(t & 1) * 2 * bs + 2 * b + 1] =
              (i < m ? 1.f : 0.f) - (j < m ? 1.f : 0.f);
        }
        continue;
      }
      const float z = label(w0, wz);
      const int ru = split ? u / sh_u : 0;  // owning ranks
      const int ri = split ? i / sh_v : 0;
      const int rj = split ? j / sh_v : 0;
      const float* pu = Pc + u - ru * sh_u;
      const float* pi = Pc + sh_u + i - ri * sh_v;
      const float* pj = Pc + sh_u + j - rj * sh_v;
      if (split) {
        cg::cluster_group cl = cg::this_cluster();
        pu = cl.map_shared_rank(pu, ru);
        pi = cl.map_shared_rank(pi, ri);
        pj = cl.map_shared_rank(pj, rj);
      }
      // Up to kLoads components' gathers go out together, ahead of stores
      // the compiler cannot tell apart from them.
      float logit = 0.f;
      for (int k0 = 0; k0 < d; k0 += kLoads) {
        float eu[kLoads], vi[kLoads], vj[kLoads];
#pragma unroll
        for (int x = 0; x < kLoads; ++x)
          if (k0 + x < d) {
            eu[x] = pu[(k0 + x) * rows];
            vi[x] = pi[(k0 + x) * rows];
            vj[x] = pj[(k0 + x) * rows];
          }
#pragma unroll
        for (int x = 0; x < kLoads; ++x)
          if (k0 + x < d) {
            const float dv = vi[x] - vj[x];
            cu[b * d + k0 + x] = dv;
            cv[b * d + k0 + x] = eu[x];
            logit += eu[x] * dv;
          }
      }
      const float sig = 1.f / (1.f + expf(-logit));
      const float g = (sig - z) * inv_cnt;
      for (int k = 0; k < d; ++k) {
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
          float p = Pc[e], mu = MU[e], nu = NU[e];
          adam.step(p, mu, nu,
                    row_sum<kFactored, false>(nxt, erow,
                                              (int)(unsigned)head[row], row,
                                              row >= sh_u, cu, cv, bs, d, k,
                                              nullptr));
          Pn[e] = p;
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
            float p = Pc[e], mu = MU[e], nu = NU[e];
            // P2's padding rows: Adam with no gradient leaves an all-zero
            // element at 0, but only after the IEEE division's and square
            // root's slow paths on zeros; those rows skip it.
            if (kFactored && p == 0.f && mu == 0.f && nu == 0.f) {
              Pn[e] = p;
            } else {
              adam.step(p, mu, nu, 0.f);
              Pn[e] = p;
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
    if (split)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }

  // Write the share back.  The last cluster barrier has passed, so no CTA
  // reads this one's shared memory any more.
  if constexpr (V == kFull) {
    const float* P = (steps & 1) ? P1 : P0;
    for (int e = tid; e < own_u * d; e += kThreads) {
      const int k = e / own_u, row = e - k * own_u, s = k * rows + row;
      const size_t g = table_index<kFactored>(run, k, u0, row, n, d);
      u_t[g] = P[s];
      mu_u[g] = MU[s];
      nu_u[g] = NU[s];
    }
    for (int e = tid; e < own_v * d; e += kThreads) {
      const int k = e / own_v, row = e - k * own_v, s = k * rows + sh_u + row;
      const size_t g = table_index<kFactored>(run, k, v0, row, m, d);
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

// Sets the launch attributes of stage set V's kernel (layout kFactored) of
// launch shape c (kPacked: the packed kernel; c >= 1: the wide kernel over
// clusters of c CTAs); returns the shared memory per CTA in *smem.
template <int V, bool kFactored>
cudaError_t prepare(int n, int m, int d, int bs, int c, size_t* smem) {
  *smem = epoch_smem_bytes(n, m, d, bs, c) + term_smem_bytes(V, bs);
  const void* fn = c == kPacked
                       ? (const void*)epoch_kernel<false, V, kFactored>
                       : (const void*)epoch_kernel<true, V, kFactored>;
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
  const bool wide = c != kPacked;
  err = wide ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, epoch_kernel<true, V, kFactored>,
                   threads_of(true), smem)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, epoch_kernel<false, V, kFactored>,
                   threads_of(false), smem);
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
  err = cudaOccupancyMaxActiveClusters(runs, epoch_kernel<true, V, kFactored>,
                                       &cfg);
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
      epoch_kernel<false, V, kFactored>
          <<<R, threads_of(false), smem, st>>>(args..., 1);
    else
      epoch_kernel<true, V, kFactored>
          <<<R, threads_of(true), smem, st>>>(args..., 1);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(R, c, smem, &attr, st);
  err = cudaLaunchKernelEx(&cfg, epoch_kernel<true, V, kFactored>, args...,
                           c);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
