// The fused training epoch with stages removed (P1) and over the factored
// state layout (P2), for splitting its cost by stage: one thread block per
// run, on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels scripts/profile_kernel_split.py::_variant_kernel
// (launched by _run_variant) and ::_factored_kernel (launched by
// _run_factored).  Both are the fused epoch of epoch_kernel.cu in pack mode
// "full" (same block, same 512 threads, same three barriers per step, same
// shared-memory layout), one template over the stage set V and the layout.
// Variant V keeps stage s when V >= s:
//
//   loop_only  (0): the batch loop, the stream prefetch, unpack, mask and
//                   the barriers;
//   oh_only    (1): + resolving the row indices.  The TPU builds one-hot
//                   matrices here; this card gathers by index and builds
//                   none, so the stage is a range test per index;
//   no_scatter (2): + the gathers of U[u], V[i], V[j], the logits, BCE, g;
//   no_adam    (3): + the ordered scatter of the gradient rows into G;
//   full       (4): + the dense Adam over every element of U and V.
//
// Each ablated variant adds the JAX variant's keep-alive terms to its loss,
// term for term and in the same order (profile_kernel_split.py:196-250), and
// writes no state back: its outputs alias its inputs there.  Those terms
// weigh 1e-9 and vanish in the float32 loss, so the kernel also sums, per
// run, a second accumulator `alive` of unweighted terms that depend on every
// stage it keeps: loop_only the raw unpacked indices over all bs lanes,
// masked or not; oh_only the resolved rows (u if u < n, i if i < m, j if
// j < m) over valid lanes; no_scatter sum |g|; no_adam, once its scatter is
// done, |G| read back at each gradient entry's row (a row named twice counts
// twice).  Both are the sum over the executed batches divided by their
// number.  The keep-alive work stays off the step's serial path: a step's
// terms are reduced together, in one shuffle chain as K1 reduces its loss;
// no_adam's read-back is done in the Adam phase by the batch-row threads,
// each reading its own row's u, i and j into a register sum reduced once
// per epoch, and each zeroing those rows at the start of the next step (no
// dense pass, no extra barrier); no_adam takes the loss's 1e-9 * sum(grad)
// terms from the contributions its scatter adds.
//
// The factored layout (P2, full only) holds each table as [H, d * 128]
// (table row h * 128 + l, component k at [h, k * 128 + l]) over H * 128
// rows; the kernel loads and stores through that index map.  The padding
// rows get g = 0 and hold p = 0, so Adam leaves them at 0.  V's gradient
// follows the TPU kernel's order (profile_kernel_split.py:447-450): the
// i-entries in batch order (warp 1, into G), the j-entries in batch order
// (warp 2, into a plane of their own, GJ), then the two added in the Adam
// pass.  In the row layout warp 1 adds V's entries interleaved (i_0, j_0,
// i_1, ...) as epoch_kernel.cu does.  Warp 0 adds U's; warp 3 reduces the
// batch's loss and keep-alive terms.
//
// What bounds it on this card: as epoch_kernel.cu, the chain of dependent
// steps inside one SM (latency), not bytes or FLOPs.  Differences between
// the variants' times estimate each stage's share of a step.  The state is
// loaded only by the variants that read it (no_scatter onward), and the
// moments only by full; that one-time load is small next to 1,250 steps.
//
// Built with --fmad=false like epoch_kernel.cu.  No float atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLoopOnly = 0;
constexpr int kOhOnly = 1;
constexpr int kNoScatter = 2;
constexpr int kNoAdam = 3;
constexpr int kFull = 4;
constexpr int kThreads = 512;
constexpr int kReducer = 96;     // warp 3, lane 0: holds the run's sums
constexpr int kLanes = 128;      // lanes per row of the factored layout
constexpr float kScale = 1e-9f;  // weight of the keep-alive terms in the loss

inline size_t split_smem_bytes(int n, int m, int d, int bs, bool factored) {
  // epoch_kernel.cu's layout, V's j-plane (factored), three per-row term
  // planes and two step sums.
  return sizeof(float) * (4 * (size_t)(n + m) * d +
                          (factored ? (size_t)m * d : 0) +
                          (size_t)bs * (5 + 2 * d) + 3 * (size_t)bs + 2);
}

// Element e of a run's table, in the row layout [d, rows] or the factored
// layout [rows / 128, d * 128], as a slot of the rows-first [row][d] copy.
template <bool kFactored>
__device__ __forceinline__ int slot(int e, int rows, int d) {
  if (kFactored) {
    const int dl = d * kLanes, h = e / dl, rem = e - h * dl;
    const int k = rem / kLanes, l = rem - k * kLanes;
    return (h * kLanes + l) * d + k;
  }
  const int k = e / rows;
  return (e - k * rows) * d + k;
}

// Sums each v[k] over the warp's lanes in one shuffle chain; lane 0 holds
// the sums.
template <int K>
__device__ __forceinline__ void warp_reduce(float (&v)[K]) {
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
  }
}

// K sums over b in [0, count) of the terms f(b, x) writes into x[0, K), by
// one warp; lane 0 holds them in v.
template <int K, typename F>
__device__ __forceinline__ void warp_sums(int count, int lane, float (&v)[K],
                                          F f) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.f;
  for (int b = lane; b < count; b += 32) {
    float x[K];
    f(b, x);
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += x[k];
  }
  warp_reduce(v);
}

template <int V, bool kFactored>
__global__ void __launch_bounds__(kThreads, 1) split_kernel(
    float* __restrict__ u_t, float* __restrict__ v_t,
    float* __restrict__ mu_u, float* __restrict__ nu_u,
    float* __restrict__ mu_v, float* __restrict__ nu_v,
    const int32_t* __restrict__ s0, const float* __restrict__ lr_p,
    const float* __restrict__ wd_p, const float* __restrict__ step0_p,
    const int32_t* __restrict__ count_p, float* __restrict__ loss_out,
    float* __restrict__ alive_out, int n, int m, int d, int num_batches,
    int bs, int bits_n, int bits_m, int bits_z, int denom, float b1,
    float omb1, float b2, float omb2, float eps, float log_b1,
    float log_b2) {
  static_assert(!kFactored || V == kFull, "P2 is the full epoch only");
  extern __shared__ float smem[];
  const int run = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int n_u = n * d;
  const int n_v = m * d;
  const int n_p = n_u + n_v;

  // Row layout [row][d]: U rows at P[0, n_u), V rows at P[n_u, n_p).
  float* P = smem;
  float* MU = P + n_p;
  float* NU = MU + n_p;
  float* G = NU + n_p;
  float* GJ = G + n_p;  // factored: V's j-entry sums, [row][d]
  float* row_g = GJ + (kFactored ? n_v : 0);
  float* row_loss = row_g + bs;
  float* row_eu = row_loss + bs;
  float* row_dv = row_eu + bs * d;
  int* row_u = reinterpret_cast<int*>(row_dv + bs * d);
  int* row_i = row_u + bs;
  int* row_j = row_i + bs;
  float* row_term = reinterpret_cast<float*>(row_j + bs);  // [3][bs]
  float* step_sum = row_term + 3 * bs;  // no_adam: sum(grad), U's and V's
  float* PV = P + n_u;

  // Load the run's state, as far as it is read.
  const size_t gu = (size_t)run * n_u, gv = (size_t)run * n_v;
  if (V >= kNoScatter) {
    for (int e = tid; e < n_u; e += nthreads) {
      const int s = slot<kFactored>(e, n, d);
      P[s] = u_t[gu + e];
      if (V == kFull) {
        MU[s] = mu_u[gu + e];
        NU[s] = nu_u[gu + e];
      }
      if (V >= kNoAdam) G[s] = 0.f;
    }
    for (int e = tid; e < n_v; e += nthreads) {
      const int s = slot<kFactored>(e, m, d);
      P[n_u + s] = v_t[gv + e];
      if (V == kFull) {
        MU[n_u + s] = mu_v[gv + e];
        NU[n_u + s] = nu_v[gv + e];
      }
      if (V >= kNoAdam) G[n_u + s] = 0.f;
      if (kFactored) GJ[s] = 0.f;
    }
  }
  __syncthreads();

  const float lr = lr_p[run];
  const float wd = wd_p[run];
  const float step0 = step0_p[run];
  const int count = max(count_p[run], 0);
  const int num_exec = (count + bs - 1) / bs;
  const int steps = min(num_exec, num_batches);
  const size_t base = (size_t)run * num_batches * bs;
  const int mask_n = (1 << bits_n) - 1;
  const int mask_m = (1 << bits_m) - 1;
  const int mask_z = (1 << bits_z) - 1;
  const float denom_f = (float)denom;

  int32_t y0 = 0;
  if (tid < bs && steps > 0) y0 = s0[base + tid];

  float loss_sum = 0.f;   // kReducer's
  float alive_sum = 0.f;  // kReducer's
  float step_loss = 0.f;  // no_adam: the batch's BCE loss, kReducer's
  float read_back = 0.f;  // no_adam: this row thread's sum of |G| read
  int own_u = 0, own_i = 0, own_j = 0;  // no_adam: this thread's last rows
  for (int t = 0; t < steps; ++t) {
    const int cnt = min(bs, count - t * bs);
    const float inv_cnt = 1.f / (float)max(cnt, 1);

    // 1. One thread per batch row: unpack, mask, and the row's work.
    if (tid < bs) {
      if (V == kNoAdam && t > 0) {  // reset the rows read back last step
        for (int k = 0; k < d; ++k) {
          G[own_u * d + k] = 0.f;
          G[n_u + own_i * d + k] = 0.f;
          G[n_u + own_j * d + k] = 0.f;
        }
      }
      int u = y0 & mask_n;
      int i = (y0 >> bits_n) & mask_m;
      int j = (y0 >> (bits_n + bits_m)) & mask_m;
      const int kz = (y0 >> (bits_n + 2 * bits_m)) & mask_z;
      const float z = (float)kz / denom_f;
      if (t + 1 < steps) y0 = s0[base + (size_t)(t + 1) * bs + tid];
      const bool valid = t * bs + tid < count;
      const float mask = valid ? 1.f : 0.f;
      if (V == kLoopOnly) {
        row_term[tid] = z * mask;
        row_u[tid] = u;
        row_i[tid] = i;
        row_j[tid] = j;
      } else if (V == kOhOnly) {
        const bool in_u = u < n, in_i = i < m, in_j = j < m;
        row_term[tid] = (in_u ? 1.f : 0.f) * mask;
        row_term[bs + tid] = ((in_i ? 1.f : 0.f) - (in_j ? 1.f : 0.f)) * mask;
        row_term[2 * bs + tid] =
            (float)((in_u ? u : 0) + (in_i ? i : 0) + (in_j ? j : 0)) * mask;
      } else {
        if (!valid) u = i = j = 0;  // contributes exactly zero below
        float logit = 0.f;
        for (int k = 0; k < d; ++k) {
          const float eu = P[u * d + k];
          const float dv = PV[i * d + k] - PV[j * d + k];
          if (V >= kNoAdam) {
            row_eu[tid * d + k] = eu;
            row_dv[tid * d + k] = dv;
          }
          logit += eu * dv;
        }
        const float bce =
            fmaxf(logit, 0.f) - logit * z + log1pf(expf(-fabsf(logit)));
        const float sig = 1.f / (1.f + expf(-logit));
        row_g[tid] = (sig - z) * mask * inv_cnt;
        row_loss[tid] = bce * mask;
        if (V >= kNoAdam) {
          row_u[tid] = u;
          row_i[tid] = i;
          row_j[tid] = j;
        }
        if (V == kNoAdam) {
          own_u = u;
          own_i = i;
          own_j = j;
        }
      }
    }
    __syncthreads();

    // 2. Warp 0 adds U's gradient rows into G, and V's go in by warp 1
    // (interleaved) or warps 1 and 2 (factored: i-rows into G, j-rows into
    // GJ), each in batch order, 32 entries at a time: within a chunk the
    // lowest lane naming a row adds the chunk's entries for it in lane
    // order.  Warp 3 reduces the batch's terms.
    const int warp = tid >> 5, lane = tid & 31;
    const int scatter_warps = V >= kNoAdam ? (kFactored ? 3 : 2) : 0;
    if (warp < scatter_warps) {
      const bool interleaved = !kFactored && warp == 1;
      const int entries = interleaved ? 2 * bs : bs;
      const int* targets = warp == 0 ? row_u : (warp == 1 ? row_i : row_j);
      const float* vals = warp == 0 ? row_dv : row_eu;
      float* GW = warp == 0 ? G : (warp == 1 ? G + n_u : GJ);
      auto row_of = [&](int e) {
        return !interleaved ? targets[e]
                            : ((e & 1) ? row_j[e >> 1] : row_i[e >> 1]);
      };
      float added = 0.f;  // no_adam: this lane's share of sum(grad)
      for (int c0 = 0; c0 < entries; c0 += 32) {
        const int e = c0 + lane;
        const bool live = e < entries;
        const int target = live ? row_of(e) : -1 - lane;
        const unsigned peers = __match_any_sync(0xffffffffu, target);
        if (live && lane == __ffs(peers) - 1) {
          for (int k = 0; k < d; ++k) {
            float acc = GW[target * d + k];
            for (unsigned rest = peers; rest; rest &= rest - 1) {
              const int pe = c0 + __ffs(rest) - 1;
              const int pb = interleaved ? pe >> 1 : pe;
              const float c = row_g[pb] * vals[pb * d + k];
              const bool neg = interleaved ? (pe & 1) != 0 : warp == 2;
              acc = neg ? acc - c : acc + c;
              if (V == kNoAdam) added = neg ? added - c : added + c;
            }
            GW[target * d + k] = acc;
          }
        }
        __syncwarp();
      }
      if (V == kNoAdam) {
        float sum[1] = {added};
        warp_reduce(sum);
        if (lane == 0) step_sum[warp] = sum[0];
      }
    } else if (warp == 3) {
      const bool lead = lane == 0;
      if (V == kLoopOnly) {
        float v[4];  // sum z * mask, sum u, sum i, sum j
        warp_sums(bs, lane, v, [&](int b, float* x) {
          x[0] = row_term[b];
          x[1] = (float)row_u[b];
          x[2] = (float)row_i[b];
          x[3] = (float)row_j[b];
        });
        if (lead) {
          loss_sum = loss_sum + v[0];
          loss_sum = loss_sum + v[1] * kScale;
          loss_sum = loss_sum + v[2] * kScale;
          loss_sum = loss_sum + v[3] * kScale;
          alive_sum = alive_sum + v[1];
          alive_sum = alive_sum + v[2];
          alive_sum = alive_sum + v[3];
        }
      } else if (V == kOhOnly) {
        float v[3];  // the two one-hots' masked sums, the resolved rows
        warp_sums(bs, lane, v, [&](int b, float* x) {
          x[0] = row_term[b];
          x[1] = row_term[bs + b];
          x[2] = row_term[2 * bs + b];
        });
        if (lead) {
          loss_sum = loss_sum + v[0] * kScale;
          loss_sum = loss_sum + v[1] * kScale;
          alive_sum = alive_sum + v[2];
        }
      } else if (V == kNoScatter) {
        float v[3];  // sum of masked BCE, sum g, sum |g|
        warp_sums(bs, lane, v, [&](int b, float* x) {
          x[0] = row_loss[b];
          x[1] = row_g[b];
          x[2] = fabsf(row_g[b]);
        });
        if (lead) {
          loss_sum = loss_sum + v[0] * inv_cnt;
          loss_sum = loss_sum + v[1] * kScale;
          alive_sum = alive_sum + v[2];
        }
      } else {
        float v[1];
        warp_sums(bs, lane, v, [&](int b, float* x) { x[0] = row_loss[b]; });
        if (V == kNoAdam) {
          step_loss = v[0] * inv_cnt;
        } else if (lead) {
          loss_sum += v[0] * inv_cnt;
        }
      }
    }
    __syncthreads();

    // 3. full: the dense coupled-weight-decay Adam (factored: V's gradient
    // is its i-sum plus its j-sum); no_adam: read |G| back at each row
    // thread's rows, and fold the step's sums into the loss.
    if (V == kFull) {
      const float t_step = step0 + (float)(t + 1);
      const float bc1 = 1.f - expf(t_step * log_b1);
      const float bc2 = 1.f - expf(t_step * log_b2);
      for (int e = tid; e < n_p; e += nthreads) {
        const float p = P[e];
        float grad = G[e];
        if (kFactored && e >= n_u) {
          grad = grad + GJ[e - n_u];
          GJ[e - n_u] = 0.f;
        }
        const float g = grad + wd * p;
        const float mu = b1 * MU[e] + omb1 * g;
        const float nu = b2 * NU[e] + omb2 * g * g;
        P[e] = p - lr * (mu / bc1) / (sqrtf(nu / bc2) + eps);
        MU[e] = mu;
        NU[e] = nu;
        G[e] = 0.f;
      }
    } else if (V == kNoAdam) {
      if (tid < bs) {
        for (int k = 0; k < d; ++k) {
          read_back += fabsf(G[own_u * d + k]);
          read_back += fabsf(G[n_u + own_i * d + k]);
          read_back += fabsf(G[n_u + own_j * d + k]);
        }
      }
      if (tid == kReducer) {
        loss_sum = loss_sum + step_loss;
        loss_sum = loss_sum + step_sum[0] * kScale;
        loss_sum = loss_sum + step_sum[1] * kScale;
      }
    }
    __syncthreads();
  }

  // no_adam: the row threads' read-back sums, warp by warp, then in warp
  // order into alive (row_term is free after the loop).
  if (V == kNoAdam) {
    const int warp = tid >> 5;
    if (warp < (bs + 31) / 32) {
      float sum[1] = {read_back};
      warp_reduce(sum);
      if ((tid & 31) == 0) row_term[warp] = sum[0];
    }
    __syncthreads();
    if (tid == kReducer)
      for (int w = 0; w < (bs + 31) / 32; ++w) alive_sum += row_term[w];
  }

  // Only full writes the state back.
  if (V == kFull) {
    for (int e = tid; e < n_u; e += nthreads) {
      const int s = slot<kFactored>(e, n, d);
      u_t[gu + e] = P[s];
      mu_u[gu + e] = MU[s];
      nu_u[gu + e] = NU[s];
    }
    for (int e = tid; e < n_v; e += nthreads) {
      const int s = n_u + slot<kFactored>(e, m, d);
      v_t[gv + e] = P[s];
      mu_v[gv + e] = MU[s];
      nu_v[gv + e] = NU[s];
    }
  }
  if (tid == kReducer) {
    const float execs = fmaxf((float)num_exec, 1.f);
    loss_out[run] = loss_sum / execs;
    if (V != kFull) alive_out[run] = alive_sum / execs;
  }
}

template <int V, bool kFactored>
cudaError_t launch(float* u_t, float* v_t, float* mu_u, float* nu_u,
                   float* mu_v, float* nu_v, const int32_t* s0,
                   const float* lr, const float* wd, const float* step0,
                   const int32_t* count, float* loss, float* alive, int R,
                   int n, int m, int d, int num_batches, int bs, int bits_n,
                   int bits_m, int bits_z, int denom, float b1, float omb1,
                   float b2, float omb2, float eps, float log_b1,
                   float log_b2, cudaStream_t stream) {
  const size_t smem = split_smem_bytes(n, m, d, bs, kFactored);
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel<V, kFactored>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (R == 0) return cudaSuccess;
  split_kernel<V, kFactored><<<R, kThreads, smem, stream>>>(
      u_t, v_t, mu_u, nu_u, mu_v, nu_v, s0, lr, wd, step0, count, loss, alive,
      n, m, d, num_batches, bs, bits_n, bits_m, bits_z, denom, b1, omb1, b2,
      omb2, eps, log_b1, log_b2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mfcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// P1: launches variant `variant` (0 loop_only .. 4 full, the order of
// VARIANTS in kernel_split.py) for R runs on `stream`; `alive` is written by
// the ablated variants only.  Returns cudaGetLastError().
int mfcd_train_epoch_variant(int variant, float* u_t, float* v_t, float* mu_u,
                             float* nu_u, float* mu_v, float* nu_v,
                             const int32_t* s0, const float* lr,
                             const float* wd, const float* step0,
                             const int32_t* count, float* loss, float* alive,
                             int R, int n, int m, int d, int num_batches,
                             int bs, int bits_n, int bits_m, int bits_z,
                             int denom, float b1, float omb1, float b2,
                             float omb2, float eps, float log_b1,
                             float log_b2, void* stream) {
  if (bs > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MFCD_LAUNCH(V)                                                        \
  launch<V, false>(u_t, v_t, mu_u, nu_u, mu_v, nu_v, s0, lr, wd, step0,       \
                   count, loss, alive, R, n, m, d, num_batches, bs, bits_n,   \
                   bits_m, bits_z, denom, b1, omb1, b2, omb2, eps, log_b1,    \
                   log_b2, st)
  cudaError_t err;
  switch (variant) {
    case kLoopOnly: err = MFCD_LAUNCH(kLoopOnly); break;
    case kOhOnly: err = MFCD_LAUNCH(kOhOnly); break;
    case kNoScatter: err = MFCD_LAUNCH(kNoScatter); break;
    case kNoAdam: err = MFCD_LAUNCH(kNoAdam); break;
    case kFull: err = MFCD_LAUNCH(kFull); break;
    default: err = cudaErrorInvalidValue;
  }
#undef MFCD_LAUNCH
  return static_cast<int>(err);
}

// P2: one full epoch for R runs, each table [R, H, d * 128] (H * 128 rows),
// on `stream`; returns cudaGetLastError().
int mfcd_train_epoch_factored(float* u_f, float* v_f, float* mu_u, float* nu_u,
                              float* mu_v, float* nu_v, const int32_t* s0,
                              const float* lr, const float* wd,
                              const float* step0, const int32_t* count,
                              float* loss, int R, int H, int d,
                              int num_batches, int bs, int bits_n, int bits_m,
                              int bits_z, int denom, float b1, float omb1,
                              float b2, float omb2, float eps, float log_b1,
                              float log_b2, void* stream) {
  const int rows = H * kLanes;
  if (bs > kThreads || (1 << bits_n) > rows || (1 << bits_m) > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<kFull, true>(
      u_f, v_f, mu_u, nu_u, mu_v, nu_v, s0, lr, wd, step0, count, loss,
      nullptr, R, rows, rows, d, num_batches, bs, bits_n, bits_m, bits_z,
      denom, b1, omb1, b2, omb2, eps, log_b1, log_b2,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
