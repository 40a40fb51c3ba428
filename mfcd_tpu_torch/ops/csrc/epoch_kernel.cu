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
// runs on 132 SMs) the step's latency bounds it: the batch phase (gathers,
// sigmoid, links), two barriers, and the dense Adam over (n + m) * d
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
//   Adam.  Every CTA computes the whole batch phase, gathering rows from
//   their owners' shared memory (DSMEM); one cluster barrier a step.
// - Up to one run per SM (c = 1): one 512-thread CTA per run, in one wave.
// - Large R, more runs than SMs (packed): 256 threads and at most 85
//   registers a thread, so three runs share an SM and its issue slots.
// The library is compiled with --fmad=false so every multiply and add
// rounds on its own, as the plain PyTorch version's separate operations do;
// every c gives the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Stream layouts (mode 1, "uij", is a packed int32 (u, i, j) + float32 z).
constexpr int kModeFull = 0;  // one int32: u | i << bn | j << (bn+bm) | k << (bn+2bm)
constexpr int kModeNone = 2;  // int32 u, i, j + float32 z

// Threads per CTA and CTAs per SM the compiler budgets registers for: the
// wide kernel spreads a run over 512 threads in each of its c CTAs; the
// packed one's CTA of 256 threads leaves room for three runs on one SM.
__host__ __device__ constexpr int threads_of(bool wide) { return wide ? 512 : 256; }
__host__ __device__ constexpr int min_blocks_of(bool wide) { return wide ? 1 : 3; }
constexpr int kPacked = 0;  // the launch shape "c" of the packed kernel
constexpr unsigned long long kEmpty = ~0ull;  // a list head no step wrote
// A row's list longer than this is summed by a scan of the entry ids.
constexpr int kShortList = 4;

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
// starts at `h`), in ascending id order, starting from 0.  A list of up to
// kShortList entries by selection of the next-larger id; a longer one by a
// scan, in order, of the ids that can name the row (U: 0..bs-1, V:
// bs..3bs-1), whose entry rows `erow` hold.  Both give the same order.  The
// scan loads every id's row and contribution and selects the sum without a
// branch, so the loads of later ids go out ahead of the adds.
__device__ float row_sum(const int* __restrict__ nxt,
                         const int* __restrict__ erow, int h, int row,
                         bool is_v, const float* __restrict__ cu,
                         const float* __restrict__ cv, int bs, int d, int k) {
  int len = 0;
  for (int e = h; e >= 0 && len <= kShortList; e = nxt[e]) ++len;
  float acc = 0.f;
  if (len > kShortList) {
    if (!is_v) {
#pragma unroll 8
      for (int b = 0; b < bs; ++b) {
        const float c = cu[b * d + k];
        acc = erow[b] == row ? acc + c : acc;
      }
    } else {  // batch row b: entry bs + 2b (i, +c), then bs + 2b + 1 (j, -c)
#pragma unroll 8
      for (int b = 0; b < bs; ++b) {
        const float c = cv[b * d + k];
        acc = erow[bs + 2 * b] == row ? acc + c : acc;
        acc = erow[bs + 2 * b + 1] == row ? acc - c : acc;
      }
    }
    return acc;
  }
  int prev = -1;
  for (int q = 0; q < len; ++q) {
    int best = INT_MAX;
    for (int e = h; e >= 0; e = nxt[e])
      if (e > prev && e < best) best = e;
    acc = add_entry(acc, best, cu, cv, bs, d, k);
    prev = best;
  }
  return acc;
}

__device__ __forceinline__ float bce(float logit, float z) {
  return fmaxf(logit, 0.f) - logit * z + log1pf(expf(-fabsf(logit)));
}

// kWide: 512 threads, one run per cluster of c CTAs, CTA r owning U rows
// [r * ceil(n / c), ...) and V rows [r * ceil(m / c), ...) (c = 1: the whole
// run, no cluster); otherwise 256 threads, one run per CTA (c = 1).
template <bool kWide>
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
    float log_b2, int c) {
  constexpr int kThreads = threads_of(kWide);
  // Row components a batch row gathers at once: split, the gathers are
  // remote, and four in flight beat one (and packed, one beats four).
  constexpr int kLoads = kWide ? 4 : 1;
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

  // Load the share's state from the [R, d, rows] layout.
  for (int e = tid; e < own_u * d; e += kThreads) {
    const int k = e / own_u, row = e - k * own_u, s = k * rows + row;
    const size_t g = ((size_t)run * d + k) * n + u0 + row;
    P0[s] = u_t[g];
    MU[s] = mu_u[g];
    NU[s] = nu_u[g];
  }
  for (int e = tid; e < own_v * d; e += kThreads) {
    const int k = e / own_v, row = e - k * own_v, s = k * rows + sh_u + row;
    const size_t g = ((size_t)run * d + k) * m + v0 + row;
    P0[s] = v_t[g];
    MU[s] = mu_v[g];
    NU[s] = nu_v[g];
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
  // Row b's term of step t's masked-mean BCE (0 for a masked row).
  auto loss_term = [&](int t, int b) {
    const int cnt = min(bs, count - t * bs);
    if (b >= cnt) return 0.f;
    const float* pair = lz + (t & 1) * 2 * bs + 2 * b;
    return bce(pair[0], pair[1]) * (1.f / (float)max(cnt, 1));
  };
  // The words of the thread's first item are fetched one step ahead, into
  // registers.
  int32_t y0 = 0, y1 = 0, y2 = 0;
  float yz = 0.f;
  if (tid < 4 * bs && steps > 0) fetch(0, batch_row(tid), y0, y1, y2, yz);

  for (int t = 0; t < steps; ++t) {
    const int cnt = min(bs, count - t * bs);
    const float inv_cnt = 1.f / (float)max(cnt, 1);
    const float* Pc = (t & 1) ? P1 : P0;  // read this step
    float* Pn = (t & 1) ? P0 : P1;        // written by this step's Adam
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
      if (w >= bs) {  // gradient entry id: U (b), V i (even), V j (odd)
        const int id = w - bs;
        const bool is_v = id >= bs;
        const int row = !is_v ? u : ((id - bs) & 1) ? j : i;
        const int sh = is_v ? sh_v : sh_u;
        const int owner = split ? row / sh : 0;
        const int lrow = (is_v ? sh_u : 0) + row - owner * sh;
        const bool linked = valid && owner == rank;
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
      const float z =
          mode == kModeNone ? wz
          : mode == kModeFull
              ? (float)((w0 >> (bits_n + 2 * bits_m)) & mask_z) / denom_f
              : wz;
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
      }
    }
    __syncthreads();

    // 2. Adam over the share.  Component k of a touched row is updated by
    // the thread of (the row, k), which sums the row's list; every other
    // element by the dense pass, with a gradient of 0.  The sparse items
    // start at the highest thread, the dense elements at the lowest: where a
    // share has fewer elements than threads, the two run side by side.
    const float t_step = step0 + (float)(t + 1);
    adam.bc1 = 1.f - expf(t_step * log_b1);
    adam.bc2 = 1.f - expf(t_step * log_b2);
    const int sparse = ntouched[t & 1] * d;
    if (tid == 0) ntouched[(t + 1) & 1] = 0;
    for (int x = kThreads - 1 - tid; x < sparse; x += kThreads) {
      const int q = x / d, k = x - q * d;
      const int row = touched[q];
      const int e = k * rows + row;
      float p = Pc[e], mu = MU[e], nu = NU[e];
      adam.step(p, mu, nu,
                row_sum(nxt, erow, (int)(unsigned)head[row], row, row >= sh_u,
                        cu, cv, bs, d, k));
      Pn[e] = p;
      MU[e] = mu;
      NU[e] = nu;
    }
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
        adam.step(p, mu, nu, 0.f);
        Pn[e] = p;
        MU[e] = mu;
        NU[e] = nu;
      }
      q += kThreads;
      while (q >= own && k < d) {
        q -= own;
        ++k;
      }
    }
    if (split)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }

  // Write the share back in the [R, d, rows] layout.  The last cluster
  // barrier has passed, so no CTA reads this one's shared memory any more.
  const float* P = (steps & 1) ? P1 : P0;
  for (int e = tid; e < own_u * d; e += kThreads) {
    const int k = e / own_u, row = e - k * own_u, s = k * rows + row;
    const size_t g = ((size_t)run * d + k) * n + u0 + row;
    u_t[g] = P[s];
    mu_u[g] = MU[s];
    nu_u[g] = NU[s];
  }
  for (int e = tid; e < own_v * d; e += kThreads) {
    const int k = e / own_v, row = e - k * own_v, s = k * rows + sh_u + row;
    const size_t g = ((size_t)run * d + k) * m + v0 + row;
    v_t[g] = P[s];
    mu_v[g] = MU[s];
    nu_v[g] = NU[s];
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

// Sets the launch attributes of the kernel of launch shape c (kPacked: the
// packed kernel; c >= 1: the wide kernel over clusters of c CTAs); returns
// the shared memory per CTA in *smem.
cudaError_t prepare(int n, int m, int d, int bs, int c, size_t* smem) {
  *smem = epoch_smem_bytes(n, m, d, bs, c);
  const void* fn = c == kPacked ? (const void*)epoch_kernel<false>
                                : (const void*)epoch_kernel<true>;
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

}  // namespace

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
  size_t smem;
  *blocks_per_sm = 0;
  *runs = 0;
  cudaError_t err = prepare(n, m, d, bs, c, &smem);
  if (err != cudaSuccess) {
    if (c <= 8) return static_cast<int>(err);
    cudaGetLastError();
    return 0;
  }
  const bool wide = c != kPacked;
  err = wide ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, epoch_kernel<true>, threads_of(true), smem)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks_per_sm, epoch_kernel<false>, threads_of(false),
                   smem);
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
  err = cudaOccupancyMaxActiveClusters(runs, epoch_kernel<true>, &cfg);
  if (err != cudaSuccess && c > 8) {
    cudaGetLastError();
    *runs = 0;
    return 0;
  }
  return static_cast<int>(err);
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
  size_t smem;
  cudaError_t err = prepare(n, m, d, bs, c, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c <= 1) {
    if (c == kPacked)
      epoch_kernel<false><<<R, threads_of(false), smem, st>>>(
          u_t, v_t, mu_u, nu_u, mu_v, nu_v, s0, s1, s2, sz, lr, wd, step0,
          count, loss, n, m, d, num_batches, bs, mode, bits_n, bits_m,
          bits_z, denom, b1, omb1, b2, omb2, eps, log_b1, log_b2, 1);
    else
      epoch_kernel<true><<<R, threads_of(true), smem, st>>>(
          u_t, v_t, mu_u, nu_u, mu_v, nu_v, s0, s1, s2, sz, lr, wd, step0,
          count, loss, n, m, d, num_batches, bs, mode, bits_n, bits_m,
          bits_z, denom, b1, omb1, b2, omb2, eps, log_b1, log_b2, 1);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(R, c, smem, &attr, st);
  err = cudaLaunchKernelEx(
      &cfg, epoch_kernel<true>, u_t, v_t, mu_u, nu_u, mu_v, nu_v, s0, s1, s2,
      sz, lr, wd, step0, count, loss, n, m, d, num_batches, bs, mode, bits_n,
      bits_m, bits_z, denom, b1, omb1, b2, omb2, eps, log_b1, log_b2, c);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
