// K2: one whole dual-coordinate-descent (DCD) phase of AltSVM on NVIDIA
// Hopper (sm_90a): a schedule pass, then one persistent block whose warps
// run the phase's coordinate steps out of pick order, each row's writes in
// pick order.
//
// Replaces no TPU kernel: the JAX package runs the phase as XLA, two
// lax.scan bodies under jax.jit (mfcd_tpu/models/altsvm.py::_dcd_users,
// ::_dcd_items, scanned at :109 and :136 inside the epoch scan at :177).
// A phase is the picks' T * sweeps coordinate steps.  User phase (V
// fixed), for comparison idx = picks[s] of user i = users[idx] with rows
// j, k and label p:
//   x = p * (V[j] - V[k]),  q = dot(x, x) / lam,  grad = dot(U[i], x) - 1,
//   new = clip(alpha[idx] - grad / max(q, 1e-12), 0, C),
//   U[i] += ((new - alpha[idx]) * x) / lam,  alpha[idx] = new.
// Item phase (U fixed), u = U[i]:
//   margin = p * dot(u, V[j] - V[k]),  q = (2 * dot(u, u)) / lam,
//   new = clip(beta[idx] - (margin - 1) / max(q, 1e-12), 0, C),
//   V[j] += ((delta * p) * u) / lam, then V[k] += (((-delta) * p) * u) / lam
//   (in that order, so j == k adds both).
//
// What bounds it.  Neither bytes nor operations but a chain: a step reads
// the rows earlier steps wrote.  Yet a step writes only its own rows (user
// phase U[i], item phase V[j] and V[k]) and its dual, and reads the fixed
// table, so two steps that share no written row commute exactly: the same
// float operations on the same inputs.  Any order in which every row takes
// its writes in pick order gives the sequential sweep's bits; the same idx
// in two sweeps writes the same rows, so the row order orders its dual too.
// The chain is then the longest run of steps linked through shared rows:
// a few hundred to a few thousand steps at MovieLens-100k's shape, against
// T * sweeps = 300,000.
//
// What the design does about it.
// - The schedule (three small kernels): a step's expected version of each
//   row it writes is the number of earlier steps that write that row.  Each
//   warp takes a contiguous chunk of "slots" (users: one per step, the row
//   i; items: two, j and k, k masked where k == j), counts its rows with
//   __match_any_sync into its own column of a rows x parts table, a warp
//   per row turns the table into exclusive prefix sums, and each warp walks
//   its chunk again: base + rank among the equal rows before it.  The
//   schedule writes each step's record: its comparison, versions and the
//   curvature q, which reads only the fixed table.
// - The phase (one block of 32 warps on one SM): a group of kGroup = 4
//   lanes runs one step, so 256 steps are in flight.  Group g holds a
//   window of two steps, in increasing pick order, their records
//   (comparison, expected versions, curvature) from the schedule: in the
//   user phase its share g, g + 256, ..., in the item phase the next
//   untaken ones from a counter in shared memory (on an H100, 2.4 %
//   faster there and 1.9 % slower on users, in 12 alternated rounds at
//   MovieLens-100k's shape: scripts/ab_dcd_phase.py).
//   Lane 0 of the group runs the first step whose rows all hold their
//   expected versions (an acquire load each): the second may run before
//   the first, as it then shares no row with it.  The lanes read the rows,
//   reduce, clip and write, and lane 0 bumps the versions with a release
//   store.  The loop is warp-synchronous: a group with no step ready
//   computes and writes nothing and tries again on the warp's next pass
//   (a warp with none ready passes at once), so no group blocks another
//   in its warp, and the lowest unfinished step always has every
//   predecessor done: the phase always makes progress.  Where the next
//   step's rows already hold their versions when a step ends, lane 0
//   loads its dual then, off the chain.
//   What bounds it at MovieLens-100k's shape: one SM's instruction issue,
//   not the chain (417 / 1,401 steps deep, against 1,172 a group).  A
//   whole warp a step leaves most lanes idle at f = 20 and issues every
//   shuffle, division and branch for one step only; 4 lanes a step share
//   each instruction among 8 steps, and (f <= 20) hold their components
//   of the rows in registers from the reduction to the write.  On a set whose items
//   are skewed, one row's chain of tens of thousands of steps bounds it.
// - The written table and the row versions sit in dynamic shared memory,
//   and the fixed table too where both fit (kBoth); where only the written
//   one fits, the fixed rows come from global memory (kWritten); where
//   neither fits, the same dataflow runs on a global copy of the table with
//   gpu-scope acquire and release on versions in global memory (kGlobal,
//   1.6-2.1x kBoth's time at f = 20 on an H100).
//   ops/altsvm_kernels.py::dcd_mode picks the case by size.
// Lane l of a group owns components l, l + 4, ... of every row, so any f
// works, and the dots are butterfly shuffle reductions that leave the same
// bits in every lane of the group.  The library is built with --fmad=false
// and each expression keeps the JAX body's order, so the plain PyTorch
// version (ops/altsvm_kernels.py::dcd_phase_reference, which sums in the
// same butterfly order) gives the same bits.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kLanes = 32;
// The phase kernel's block: on an H100, 16 warps run MovieLens-100k's
// phases 12-37 % slower.
constexpr int kWarps = 32;
constexpr int kThreads = kWarps * kLanes;

// The lanes that run one step (ops/altsvm_kernels.py::GROUP): a warp runs
// 32 / kGroup steps at once.
constexpr int kGroup = 4;

// Where the phase keeps its tables (ops/altsvm_kernels.py::MODES).
enum Mode { kBoth = 0, kWritten = 1, kGlobal = 2 };

__device__ __forceinline__ float clip_step(float dual, float grad, float q,
                                           float c) {
  return fminf(fmaxf(dual - grad / fmaxf(q, 1e-12f), 0.0f), c);
}

// Version loads and stores, at block scope (shared memory, one block) or
// gpu scope (kGlobal).
template <bool kGpu>
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  if (kGpu) {
    asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  } else {
    asm volatile("ld.acquire.cta.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  }
  return v;
}

template <bool kGpu>
__device__ __forceinline__ void store_release(int* p, int v) {
  if (kGpu) {
    asm volatile("st.release.gpu.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
  } else {
    asm volatile("st.release.cta.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
  }
}

// ---------------------------------------------------------------- schedule

// A step's comparison: idx = picks[step], its user, rows and label.
struct Comparison {
  int idx, i, j, k;
  float pref;
};

__device__ __forceinline__ Comparison load_comparison(
    long long step, const int* __restrict__ picks,
    const int* __restrict__ users, const int* __restrict__ mj,
    const int* __restrict__ mk, const float* __restrict__ prefs) {
  Comparison cmp;
  cmp.idx = picks[step];
  cmp.i = users[cmp.idx];
  cmp.j = mj[cmp.idx];
  cmp.k = mk[cmp.idx];
  cmp.pref = prefs[cmp.idx];
  return cmp;
}

// The row that a slot writes, or -1: users one slot a step (i), items two
// (j, then k; k == j is written once, so its slot is -1).
template <bool kUsers>
__device__ __forceinline__ int slot_row(long long slot,
                                        const Comparison& cmp) {
  if (kUsers) return cmp.i;
  if ((slot & 1) == 0) return cmp.j;
  return cmp.k == cmp.j ? -1 : cmp.k;
}

template <bool kUsers>
__device__ __forceinline__ long long slot_step(long long slot) {
  return kUsers ? slot : slot >> 1;
}

// Pass 1: warp g counts the rows of its chunk of slots into cnt[row][g].
template <bool kUsers>
__global__ void schedule_count(const int* __restrict__ picks, long long slots,
                               const int* __restrict__ users,
                               const int* __restrict__ mj,
                               const int* __restrict__ mk,
                               const float* __restrict__ prefs, int* cnt,
                               int parts, long long chunk) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  if (g >= parts) return;
  const long long lo = g * chunk;
  const long long hi = lo + chunk < slots ? lo + chunk : slots;
  for (long long base = lo; base < hi; base += kLanes) {
    const long long slot = base + lane;
    int row = -1;
    if (slot < hi) {
      row = slot_row<kUsers>(slot, load_comparison(slot_step<kUsers>(slot),
                                                   picks, users, mj, mk,
                                                   prefs));
    }
    const unsigned same = __match_any_sync(kFullMask, row);
    if (row >= 0 && lane == 31 - __clz(same)) {
      cnt[static_cast<long long>(row) * parts + g] += __popc(same);
    }
    __syncwarp();
  }
}

// Pass 2: a warp per row turns cnt[row][0..parts) into exclusive prefix
// sums over the parts.
__global__ void schedule_scan(int* cnt, int rows, int parts) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) /
      kLanes;
  const int lane = threadIdx.x % kLanes;
  if (r >= rows) return;
  int* row = cnt + r * parts;
  int carry = 0;
  for (int g0 = 0; g0 < parts; g0 += kLanes) {
    const int g = g0 + lane;
    const int v = g < parts ? row[g] : 0;
    int incl = v;
    for (int off = 1; off < kLanes; off <<= 1) {
      const int t = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += t;
    }
    if (g < parts) row[g] = carry + incl - v;
    carry += __shfl_sync(kFullMask, incl, kLanes - 1);
  }
}

// A step's record, two int4: {i, j, k, idx} and {pref's bits, va, vb, q's
// bits}, va and vb the expected versions of the rows it writes (users:
// U[i], both; items: V[j], V[k], k == j taking j's), q the step's
// curvature, which reads only the fixed table: users dot(x, x) / lam with
// x = p * (V[j] - V[k]), items (2 * dot(u, u)) / lam.  One thread sums
// the dot as a group of kGroup lanes does (lane l's components l,
// l + kGroup, ... in order, then the fold), so q has the phase's bits.
__device__ __forceinline__ float fixed_q(bool users_phase,
                                         const Comparison& cmp,
                                         const float* __restrict__ fixed,
                                         int f, float lam) {
  const float* a = fixed + static_cast<long long>(users_phase ? cmp.j
                                                               : cmp.i) * f;
  const float* b = fixed + static_cast<long long>(cmp.k) * f;
  float acc[kGroup];
#pragma unroll
  for (int l = 0; l < kGroup; ++l) {
    acc[l] = 0.0f;
    for (int e = l; e < f; e += kGroup) {
      const float x = users_phase ? cmp.pref * (a[e] - b[e]) : a[e];
      acc[l] = acc[l] + x * x;
    }
  }
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int l = 0; l < off; ++l) acc[l] = acc[l] + acc[l + off];
  }
  return users_phase ? acc[0] / lam : (2.0f * acc[0]) / lam;
}

// Pass 3: warp g walks its chunk again; a slot's version is its row's base
// for the chunk plus its rank among the slots of its match set.  Each
// step's record goes to rec (its j slot's lane writes it for items).
// fixed: the phase's fixed table, [*, f].
template <bool kUsers>
__global__ void schedule_assign(const int* __restrict__ picks,
                                long long slots,
                                const int* __restrict__ users,
                                const int* __restrict__ mj,
                                const int* __restrict__ mk,
                                const float* __restrict__ prefs,
                                const float* __restrict__ fixed, int f,
                                float lam, int* cnt, int parts,
                                long long chunk, int4* rec) {
  const int g = (blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  if (g >= parts) return;
  const long long lo = g * chunk;
  const long long hi = lo + chunk < slots ? lo + chunk : slots;
  for (long long base = lo; base < hi; base += kLanes) {
    const long long slot = base + lane;
    Comparison cmp{};
    int row = -1;
    if (slot < hi) {
      cmp = load_comparison(slot_step<kUsers>(slot), picks, users, mj, mk,
                            prefs);
      row = slot_row<kUsers>(slot, cmp);
    }
    const unsigned same = __match_any_sync(kFullMask, row);
    int* at = cnt + static_cast<long long>(row < 0 ? 0 : row) * parts + g;
    int v = 0;
    if (row >= 0) v = *at + __popc(same & ((1u << lane) - 1u));
    __syncwarp();
    if (row >= 0 && lane == 31 - __clz(same)) *at = v + 1;
    // Items: the j slot's lane takes the k slot's version from lane + 1.
    const int right = __shfl_down_sync(kFullMask, v, 1);
    if (slot < hi && (kUsers || (slot & 1) == 0)) {
      const int vb = kUsers || cmp.k == cmp.j ? v : right;
      const long long step = slot_step<kUsers>(slot);
      rec[2 * step] = make_int4(cmp.i, cmp.j, cmp.k, cmp.idx);
      rec[2 * step + 1] =
          make_int4(__float_as_int(cmp.pref), v, vb,
                    __float_as_int(fixed_q(kUsers, cmp, fixed, f, lam)));
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------------- phase

// The sum over a group of kGroup lanes, as the plain version folds it:
// lane l adds lane l ^ off at off = kGroup / 2, ..., 2, 1 (a + b == b + a,
// so every lane of the group ends with the same bits).
__device__ __forceinline__ float group_sum(float v) {
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    v = v + __shfl_xor_sync(kFullMask, v, off);
  }
  return v;
}

struct Step {
  int i, j, k, idx, va, vb;
  float pref, q;
};

// Step s's record, as the schedule wrote it.
__device__ __forceinline__ Step load_step(const int4* __restrict__ rec,
                                          long long s) {
  const int4 a = rec[2 * s];
  const int4 b = rec[2 * s + 1];
  return Step{a.x, a.y, a.z, a.w, b.y, b.z, __int_as_float(b.x),
              __int_as_float(b.w)};
}

template <bool kUsers, bool kGpu>
__device__ __forceinline__ bool rows_ready(const int* versions,
                                           const Step& st) {
  const int a = kUsers ? st.i : st.j;
  if (load_acquire<kGpu>(versions + a) != st.va) return false;
  return kUsers || load_acquire<kGpu>(versions + st.k) == st.vb;
}

// One step's chain for lane `lane` of its group: read the written rows,
// reduce, clip, and (go) write; returns the new dual.  kPer > 0: the lane's
// components l, l + kGroup, ... (at most kPer, f <= kPer * kGroup) stay in
// registers between the reduction and the write; kPer == 0: any f, read
// twice.
template <bool kUsers, int kPer>
__device__ __forceinline__ float run_step(float* tab, const float* fix,
                                          const Step& st, float prior,
                                          bool go, int lane, int f, float lam,
                                          float c) {
  constexpr int kHeld = kPer > 0 ? kPer : 1;
  const float* vj = fix + static_cast<long long>(st.j) * f;
  const float* vk = fix + static_cast<long long>(st.k) * f;
  const float* u_row = fix + static_cast<long long>(st.i) * f;
  if (kUsers) {
    float* row = tab + static_cast<long long>(st.i) * f;
    float x[kHeld], r[kHeld];
    float ux = 0.0f;
    if (kPer > 0) {
#pragma unroll
      for (int h = 0; h < kHeld; ++h) {
        const int e = lane + h * kGroup;
        if (e < f) {
          x[h] = st.pref * (vj[e] - vk[e]);
          r[h] = row[e];
          ux = ux + r[h] * x[h];
        }
      }
    } else {
      for (int e = lane; e < f; e += kGroup) {
        ux = ux + row[e] * (st.pref * (vj[e] - vk[e]));
      }
    }
    const float fresh = clip_step(prior, group_sum(ux) - 1.0f, st.q, c);
    const float delta = fresh - prior;
    if (go && kPer > 0) {
#pragma unroll
      for (int h = 0; h < kHeld; ++h) {
        const int e = lane + h * kGroup;
        if (e < f) row[e] = r[h] + (delta * x[h]) / lam;
      }
    } else if (go) {
      for (int e = lane; e < f; e += kGroup) {
        const float x1 = st.pref * (vj[e] - vk[e]);
        row[e] = row[e] + (delta * x1) / lam;
      }
    }
    return fresh;
  }
  // V[k] takes (((-delta) * p) * u) / lam, the negation of V[j]'s term bit
  // for bit (IEEE negation is exact, and division rounds symmetrically), so
  // it subtracts the same quotient; where k == j it does so from V[j]'s
  // new value.
  float* rj = tab + static_cast<long long>(st.j) * f;
  float* rk = tab + static_cast<long long>(st.k) * f;
  const bool one_row = st.j == st.k;
  float u[kHeld], aj[kHeld], ak[kHeld];
  float udv = 0.0f;
  if (kPer > 0) {
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
      const int e = lane + h * kGroup;
      if (e < f) {
        u[h] = u_row[e];
        aj[h] = rj[e];
        ak[h] = rk[e];
        udv = udv + u[h] * (aj[h] - ak[h]);
      }
    }
  } else {
    for (int e = lane; e < f; e += kGroup) {
      udv = udv + u_row[e] * (rj[e] - rk[e]);
    }
  }
  const float margin = st.pref * group_sum(udv);
  const float fresh = clip_step(prior, margin - 1.0f, st.q, c);
  const float delta = fresh - prior;
  if (go && kPer > 0) {
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
      const int e = lane + h * kGroup;
      if (e < f) {
        const float w = ((delta * st.pref) * u[h]) / lam;
        const float nj = aj[h] + w;
        rj[e] = nj;
        rk[e] = (one_row ? nj : ak[h]) - w;
      }
    }
  } else if (go) {
    for (int e = lane; e < f; e += kGroup) {
      const float w = ((delta * st.pref) * u_row[e]) / lam;
      rj[e] = rj[e] + w;
      rk[e] = rk[e] - w;
    }
  }
  return fresh;
}

// kUsers: the user phase (table = U, fixed = V, dual = alpha); else the item
// phase (table = V, fixed = U, dual = beta).  Rows are f floats, row-major.
// The block's W = kThreads / kGroup groups take the steps in increasing
// pick order: in the user phase group g runs steps g, g + W, ..., in the
// item phase (kCounter) the next untaken step from a counter in shared
// memory.  gver: the row versions in global memory, zeroed (kGlobal).
// kPer: the components of a row a lane holds in registers (f <= kPer *
// kGroup), or 0 for any f (run_step).
template <bool kUsers, int kMode, int kPer>
__global__ void __launch_bounds__(kThreads, 1)
dcd_phase_kernel(float* table, const float* __restrict__ fixed_in,
                 float* dual, const int4* __restrict__ rec, long long steps,
                 int* gver, int rows, int other, int f, float lam, float c) {
  constexpr bool kGpu = kMode == kGlobal;
  constexpr bool kCounter = !kUsers;
  extern __shared__ float smem[];
  __shared__ unsigned long long untaken;
  const long long wide = static_cast<long long>(rows) * f;
  const long long fixed_wide = static_cast<long long>(other) * f;
  float* tab = kMode == kGlobal ? table : smem;
  const float* fix = kMode == kBoth ? smem + wide : fixed_in;
  int* versions = kMode == kGlobal
                      ? gver
                      : reinterpret_cast<int*>(
                            smem + wide + (kMode == kBoth ? fixed_wide : 0));
  if (kMode != kGlobal) {
    for (long long e = threadIdx.x; e < wide; e += blockDim.x) {
      smem[e] = table[e];
    }
    for (long long r = threadIdx.x; r < rows; r += blockDim.x) {
      versions[r] = 0;
    }
  }
  if (kMode == kBoth) {
    for (long long e = threadIdx.x; e < fixed_wide; e += blockDim.x) {
      smem[wide + e] = fixed_in[e];
    }
  }
  __syncthreads();

  constexpr int groups = kThreads / kGroup;
  const int group = threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  if (threadIdx.x == 0) untaken = 2ull * groups;
  __syncthreads();
  // The group's window: its step (cur) and the one after (nxt), whose
  // record is in flight while the group runs cur; each group starts on
  // group, group + W.
  long long cur = group;
  long long nxt_step = group + groups;
  Step st{}, nxt{};
  if (cur < steps) st = load_step(rec, cur);
  if (nxt_step < steps) nxt = load_step(rec, nxt_step);
  // st's dual, loaded by lane 0 where st's rows already held their
  // versions when the group's last step ended (its dual final then).
  bool ready = false;
  float old = 0.0f;
  // Warp-synchronous: every lane runs every pass of the loop, and a group
  // none of whose steps is ready computes but writes nothing.  So no group
  // waits on another inside its warp.
  while (__any_sync(kFullMask, cur < steps)) {
    // Lane 0 picks the step the group runs now: cur where its rows hold
    // their versions, else nxt where its rows do (nxt shares no row with
    // cur then, or it would wait on it); the group's lanes read the rows
    // after its acquire.
    int go = 0, later = 0;
    float prior = old;
    if (lane == 0 && cur < steps) {
      go = ready || rows_ready<kUsers, kGpu>(versions, st);
      if (go && !ready) prior = dual[st.idx];
      if (!go && nxt_step < steps && rows_ready<kUsers, kGpu>(versions, nxt)) {
        go = later = 1;
        prior = dual[nxt.idx];
      }
    }
    __syncwarp();
    go = __shfl_sync(kFullMask, go, 0, kGroup);
    later = __shfl_sync(kFullMask, later, 0, kGroup);
    prior = __shfl_sync(kFullMask, prior, 0, kGroup);
    // A warp none of whose groups can run passes again at once, and leaves
    // the SM's issue slots to the warps that can.
    if (!__any_sync(kFullMask, go)) continue;

    const Step run = later ? nxt : st;
    const float fresh = run_step<kUsers, kPer>(tab, fix, run, prior, go,
                                               lane, f, lam, c);
    // Every lane's writes before lane 0's release of the versions.
    __syncwarp();
    int got = 0;
    if (go && lane == 0) {
      dual[run.idx] = fresh;
      if (kUsers) {
        store_release<kGpu>(versions + run.i, run.va + 1);
      } else {
        store_release<kGpu>(versions + run.j, run.va + 1);
        if (run.k != run.j) {
          store_release<kGpu>(versions + run.k, run.vb + 1);
        }
      }
      // The window's next step: where its rows already hold their
      // versions, its dual is final, so lane 0 loads it now, off the chain.
      if (!later && nxt_step < steps) {
        got = rows_ready<kUsers, kGpu>(versions, nxt);
        if (got) old = dual[nxt.idx];
      }
    }
    unsigned long long taken = 0;
    if (kCounter && go && lane == 0) taken = atomicAdd(&untaken, 1ull);
    got = __shfl_sync(kFullMask, got, 0, kGroup);
    taken = __shfl_sync(kFullMask, taken, 0, kGroup);
    if (go) {
      if (!later) {
        ready = got != 0;
        cur = nxt_step;
        st = nxt;
      }
      nxt_step = kCounter ? static_cast<long long>(taken) : nxt_step + groups;
      if (nxt_step < steps) nxt = load_step(rec, nxt_step);
    }
  }

  __syncthreads();
  if (kMode != kGlobal) {
    for (long long e = threadIdx.x; e < wide; e += blockDim.x) {
      table[e] = smem[e];
    }
  }
}

template <bool kUsers, int kMode, int kPer>
cudaError_t launch_phase(size_t smem, cudaStream_t st,
                         float* table, const float* fixed, float* dual,
                         const int4* rec, long long steps, int* gver,
                         int rows, int other, int f, float lam, float c) {
  auto kernel = dcd_phase_kernel<kUsers, kMode, kPer>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, smem, st>>>(table, fixed, dual, rec, steps, gver,
                                    rows, other, f, lam, c);
  return cudaGetLastError();
}

// Components a lane holds in registers: kHeldPer covers f <= 20 (the
// model's default; 6-16 % faster than reading the rows twice there), any
// larger f reads them twice.
constexpr int kHeldPer = 5;

template <bool kUsers, int kMode>
cudaError_t launch_held(size_t smem, cudaStream_t st, float* table,
                        const float* fixed, float* dual, const int4* rec,
                        long long steps, int* gver, int rows, int other,
                        int f, float lam, float c) {
  if (f <= kHeldPer * kGroup) {
    return launch_phase<kUsers, kMode, kHeldPer>(
        smem, st, table, fixed, dual, rec, steps, gver, rows, other, f, lam,
        c);
  }
  return launch_phase<kUsers, kMode, 0>(smem, st, table, fixed, dual, rec,
                                        steps, gver, rows, other, f, lam, c);
}

template <bool kUsers>
cudaError_t dispatch_phase(int mode, cudaStream_t st, float* table,
                           const float* fixed, float* dual, const int4* rec,
                           long long steps, int* gver, int rows, int other,
                           int f, float lam, float c) {
  const size_t tables = mode == kBoth ? static_cast<size_t>(rows) + other
                                      : static_cast<size_t>(rows);
  const size_t smem =
      mode == kGlobal ? 0 : (tables * f + rows) * sizeof(float);
  if (mode == kBoth) {
    return launch_held<kUsers, kBoth>(smem, st, table, fixed, dual, rec,
                                      steps, gver, rows, other, f, lam, c);
  }
  if (mode == kWritten) {
    return launch_held<kUsers, kWritten>(smem, st, table, fixed, dual, rec,
                                         steps, gver, rows, other, f, lam,
                                         c);
  }
  return launch_held<kUsers, kGlobal>(smem, st, table, fixed, dual, rec,
                                      steps, gver, rows, other, f, lam, c);
}

}  // namespace

extern "C" {

const char* mfcd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The schedule of one phase on `stream`: rec[steps, 8] int32 gets each
// step's record (its comparison, the expected versions of the rows it
// writes and its curvature from `fixed`, [*, f]).  cnt is a zeroed int32
// scratch of rows * parts; each of the parts warps takes `chunk` slots (a
// multiple of 32).  Returns the CUDA error code.
int mfcd_altsvm_schedule(int users_phase, const int* picks, long long steps,
                         const int* users, const int* mj, const int* mk,
                         const float* prefs, const float* fixed, int f,
                         float lam, int rows, int parts, long long chunk,
                         int* cnt, int* rec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (steps == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const int per_block = threads / kLanes;
  const int blocks = (parts + per_block - 1) / per_block;
  const int scan_blocks = (rows + per_block - 1) / per_block;
  int4* out = reinterpret_cast<int4*>(rec);
  if (users_phase) {
    schedule_count<true><<<blocks, threads, 0, st>>>(
        picks, steps, users, mj, mk, prefs, cnt, parts, chunk);
    schedule_scan<<<scan_blocks, threads, 0, st>>>(cnt, rows, parts);
    schedule_assign<true><<<blocks, threads, 0, st>>>(
        picks, steps, users, mj, mk, prefs, fixed, f, lam, cnt, parts, chunk,
        out);
  } else {
    schedule_count<false><<<blocks, threads, 0, st>>>(
        picks, 2 * steps, users, mj, mk, prefs, cnt, parts, chunk);
    schedule_scan<<<scan_blocks, threads, 0, st>>>(cnt, rows, parts);
    schedule_assign<false><<<blocks, threads, 0, st>>>(
        picks, 2 * steps, users, mj, mk, prefs, fixed, f, lam, cnt, parts,
        chunk, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// One DCD phase on `stream`, from its schedule's records `rec`:
// users_phase != 0 updates U and alpha in place (table, dual), else V and
// beta.  mode: 0 both tables in shared memory, 1 the written one, 2 neither
// (gver: rows zeroed int32 versions); group: the caller's lanes a step,
// which must be kGroup (the plain version sums in the same order).
// Returns the CUDA error code.
int mfcd_altsvm_dcd(int users_phase, int mode, int group, float* table,
                    const float* fixed, float* dual, const int* rec,
                    long long steps, int* gver, int rows, int other, int f,
                    float lam, float c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode < kBoth || mode > kGlobal || group != kGroup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int4* records = reinterpret_cast<const int4*>(rec);
  auto dispatch = users_phase ? dispatch_phase<true> : dispatch_phase<false>;
  return static_cast<int>(dispatch(mode, st, table, fixed, dual, records,
                                   steps, gver, rows, other, f, lam, c));
}

}  // extern "C"
