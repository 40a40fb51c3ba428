// Fused training epoch for R matrix-factorization runs, one thread block per
// run, on NVIDIA Hopper (sm_90a).
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
// What bounds it on this card: a chain of ceil(count / bs) dependent steps
// (1,250 per epoch at the canonical n = m = 1000, d = 2, bs = 64) inside one
// SM, each about 66 KFLOP (the dense Adam over (n + m) * d = 4,000 elements
// dominates), with only ~4 B of device-memory traffic per row (one packed
// int32).  Neither bytes nor FLOPs bound it: it is latency-bound, by the
// step-to-step dependency.  The design keeps U, V, the four Adam moments and
// a gradient buffer resident in shared memory for the whole epoch (no
// device-memory round trip between steps), prefetches the next batch's rows
// into registers while the current batch computes, spreads the dense Adam
// over 16 warps, and orders each step with three __syncthreads.
//
// Determinism: every gradient row is summed in batch order (U: rows
// 0..bs-1; V: i_0, j_0, i_1, j_1, ...), the order in which a sequential
// index_add_ sums them, by one warp for U and one for V.  No float atomics.
// The library is compiled with --fmad=false so every multiply and add rounds
// on its own, as the plain PyTorch version's separate operations do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Stream layouts (mode 1, "uij", is a packed int32 (u, i, j) + float32 z).
constexpr int kModeFull = 0;  // one int32: u | i << bn | j << (bn+bm) | k << (bn+2bm)
constexpr int kModeNone = 2;  // int32 u, i, j + float32 z

inline size_t epoch_smem_bytes(int n, int m, int d, int bs) {
  // P, MU, NU, G over (n + m) * d floats; per batch row g, loss, u, i, j
  // (5 words) and eu, dv (2 * d floats).
  return sizeof(float) * (4 * (size_t)(n + m) * d + (size_t)bs * (5 + 2 * d));
}

// 16 warps: the dense Adam spreads over them, and one row per thread needs
// bs <= kThreads.
constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads, 1) epoch_kernel(
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
    float log_b2) {
  extern __shared__ float smem[];
  const int run = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int n_u = n * d;
  const int n_p = (n + m) * d;

  // Row layout [row][d]: U rows at P[0, n_u), V rows at P[n_u, n_p).
  float* P = smem;
  float* MU = P + n_p;
  float* NU = MU + n_p;
  float* G = NU + n_p;
  float* row_g = G + n_p;
  float* row_loss = row_g + bs;
  float* row_eu = row_loss + bs;
  float* row_dv = row_eu + bs * d;
  int* row_u = reinterpret_cast<int*>(row_dv + bs * d);
  int* row_i = row_u + bs;
  int* row_j = row_i + bs;
  float* PV = P + n_u;

  // Load the run's state from the [R, d, rows] layout.
  {
    const size_t gu = (size_t)run * n_u;
    for (int e = tid; e < n_u; e += nthreads) {
      const int k = e / n, row = e - k * n, s = row * d + k;
      P[s] = u_t[gu + e];
      MU[s] = mu_u[gu + e];
      NU[s] = nu_u[gu + e];
      G[s] = 0.f;
    }
    const size_t gv = (size_t)run * (m * d);
    for (int e = tid; e < m * d; e += nthreads) {
      const int k = e / m, row = e - k * m, s = n_u + row * d + k;
      P[s] = v_t[gv + e];
      MU[s] = mu_v[gv + e];
      NU[s] = nu_v[gv + e];
      G[s] = 0.f;
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

  int32_t y0 = 0, y1 = 0, y2 = 0;
  float yz = 0.f;
  auto prefetch = [&](int t) {
    if (t < steps) {
      const size_t o = base + (size_t)t * bs + tid;
      y0 = s0[o];
      if (mode == kModeNone) {
        y1 = s1[o];
        y2 = s2[o];
      }
      if (mode != kModeFull) yz = sz[o];
    }
  };
  if (tid < bs) prefetch(0);

  float loss_sum = 0.f;
  for (int t = 0; t < steps; ++t) {
    const int cnt = min(bs, count - t * bs);
    const float inv_cnt = 1.f / (float)max(cnt, 1);

    // 1. One thread per batch row: unpack, forward, BCE and g.
    if (tid < bs) {
      int u, i, j;
      float z;
      if (mode == kModeNone) {
        u = y0;
        i = y1;
        j = y2;
        z = yz;
      } else {
        u = y0 & mask_n;
        i = (y0 >> bits_n) & mask_m;
        j = (y0 >> (bits_n + bits_m)) & mask_m;
        if (mode == kModeFull) {
          const int k = (y0 >> (bits_n + 2 * bits_m)) & mask_z;
          z = (float)k / denom_f;
        } else {
          z = yz;
        }
      }
      prefetch(t + 1);
      const bool valid = t * bs + tid < count;
      if (!valid) u = i = j = 0;  // contributes exactly zero below
      const float mask = valid ? 1.f : 0.f;
      float logit = 0.f;
      for (int k = 0; k < d; ++k) {
        const float eu = P[u * d + k];
        const float dv = PV[i * d + k] - PV[j * d + k];
        row_eu[tid * d + k] = eu;
        row_dv[tid * d + k] = dv;
        logit += eu * dv;
      }
      const float bce =
          fmaxf(logit, 0.f) - logit * z + log1pf(expf(-fabsf(logit)));
      const float sig = 1.f / (1.f + expf(-logit));
      row_g[tid] = (sig - z) * mask * inv_cnt;
      row_loss[tid] = bce * mask;
      row_u[tid] = u;
      row_i[tid] = i;
      row_j[tid] = j;
    }
    __syncthreads();

    // 2. Warp 0 adds the U gradient rows and warp 1 the V gradient rows
    // into G, in batch order (U: rows 0..bs-1; V: i_0, j_0, i_1, j_1, ...),
    // 32 entries at a time.  Within a chunk, the lowest lane of each group
    // naming the same row adds the group's contributions one by one in lane
    // order; chunks follow each other.  Warp 2 takes the batch's loss.
    const int warp = tid >> 5, lane = tid & 31;
    if (warp < 2) {
      const bool is_v = warp == 1;
      const int entries = is_v ? 2 * bs : bs;
      float* GW = is_v ? G + n_u : G;
      const float* rows = is_v ? row_eu : row_dv;
      for (int c0 = 0; c0 < entries; c0 += 32) {
        const int e = c0 + lane;
        const bool live = e < entries;
        int target = -1 - lane;  // distinct for lanes past the end
        if (live)
          target = !is_v ? row_u[e] : ((e & 1) ? row_j[e >> 1] : row_i[e >> 1]);
        const unsigned peers = __match_any_sync(0xffffffffu, target);
        if (live && lane == __ffs(peers) - 1) {
          for (int k = 0; k < d; ++k) {
            float acc = GW[target * d + k];
            for (unsigned rest = peers; rest; rest &= rest - 1) {
              const int pe = c0 + __ffs(rest) - 1;
              const int pb = is_v ? pe >> 1 : pe;
              const float c = row_g[pb] * rows[pb * d + k];
              acc = (is_v && (pe & 1)) ? acc - c : acc + c;
            }
            GW[target * d + k] = acc;
          }
        }
        __syncwarp();
      }
    } else if (warp == 2) {
      float v = 0.f;
      for (int b = lane; b < bs; b += 32) v += row_loss[b];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) loss_sum += v * inv_cnt;
    }
    __syncthreads();

    // 3. Dense coupled-weight-decay Adam over every element of U and V.
    const float t_step = step0 + (float)(t + 1);
    const float bc1 = 1.f - expf(t_step * log_b1);
    const float bc2 = 1.f - expf(t_step * log_b2);
    for (int e = tid; e < n_p; e += nthreads) {
      const float p = P[e];
      const float g = G[e] + wd * p;
      const float mu = b1 * MU[e] + omb1 * g;
      const float nu = b2 * NU[e] + omb2 * g * g;
      P[e] = p - lr * (mu / bc1) / (sqrtf(nu / bc2) + eps);
      MU[e] = mu;
      NU[e] = nu;
      G[e] = 0.f;
    }
    __syncthreads();
  }

  // Write the state back in the [R, d, rows] layout.
  {
    const size_t gu = (size_t)run * n_u;
    for (int e = tid; e < n_u; e += nthreads) {
      const int k = e / n, row = e - k * n, s = row * d + k;
      u_t[gu + e] = P[s];
      mu_u[gu + e] = MU[s];
      nu_u[gu + e] = NU[s];
    }
    const size_t gv = (size_t)run * (m * d);
    for (int e = tid; e < m * d; e += nthreads) {
      const int k = e / m, row = e - k * m, s = n_u + row * d + k;
      v_t[gv + e] = P[s];
      mu_v[gv + e] = MU[s];
      nu_v[gv + e] = NU[s];
    }
  }
  if (tid == 64) loss_out[run] = loss_sum / fmaxf((float)num_exec, 1.f);
}

}  // namespace

extern "C" {

const char* mfcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches one epoch for R runs on `stream`; returns cudaGetLastError().
int mfcd_train_epoch(float* u_t, float* v_t, float* mu_u, float* nu_u,
                     float* mu_v, float* nu_v, const int32_t* s0,
                     const int32_t* s1, const int32_t* s2, const float* sz,
                     const float* lr, const float* wd, const float* step0,
                     const int32_t* count, float* loss, int R, int n, int m,
                     int d, int num_batches, int bs, int mode, int bits_n,
                     int bits_m, int bits_z, int denom, float b1, float omb1,
                     float b2, float omb2, float eps, float log_b1,
                     float log_b2, void* stream) {
  const size_t smem = epoch_smem_bytes(n, m, d, bs);
  if (bs > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R == 0) return 0;
  epoch_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u_t, v_t, mu_u, nu_u, mu_v, nu_v, s0, s1, s2, sz, lr, wd, step0, count,
      loss, n, m, d, num_batches, bs, mode, bits_n, bits_m, bits_z, denom, b1,
      omb1, b2, omb2, eps, log_b1, log_b2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
