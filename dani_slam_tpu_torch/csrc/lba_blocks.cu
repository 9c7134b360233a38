// Local-BA landmark-block reduction and its reduction plan, for sm_90a.
//
// Replaces: dani_slam_tpu/ops/pallas_kernels.py lba_landmark_blocks (Pallas
// body _lba_acc_kernel), called by ops/ba.ba_solve in every LM iteration.
//
// What it computes, from per-observation blocks vals [P,N,30] =
// [JtJ_l (9) | b_l (3) | JtJ_pl (18)] and the landmark id of each
// observation: hll[l], gl[l] = sum over every observation of landmark l of
// the first 9 and the next 3 channels (H_ll, g_l), and hpl[p,l] = sum over the observations of
// landmark l in keyframe row p of the last 18 channels (H_pl), duplicates
// within a row included; hpl is dense, zero where a row does not see l.
//
// What bounds it on an H100: a gather-and-add over ~16k observations:
// about 1.4 MB of valid vals in, 2.4 MB of H_pl out at P=16, L=2048 —
// bytes, ~1.2 us at 3.35 TB/s. The TPU kernel generates one-hot indicator
// tiles and lets the MXU contract them; here the work is O(observations),
// not O(P*N*L). At this size the time is a chain of dependent loads
// (offsets -> permutation -> values) and the launch, not bandwidth.
//
// Design. Float atomicAdd would make the sums depend on the order the
// atomics land, which changes from run to run, so the reduction follows a
// plan with a fixed order, built once per solve (the ids do not change
// across LM iterations) and applied in every iteration.
//  * lba_plan_kernel builds the plan in one launch of one block, with no
//    sort: an integer histogram of the ids in shared memory (integer
//    atomics give the same counts on every run), an exclusive scan to the
//    segment offsets lm_off [L+1], a fill of the segments one keyframe row
//    after the other (within a row in whatever order the atomics hand out
//    slots), and then, only where a landmark occurs more than once in a
//    row, each entry's rank within that run by counting the run's smaller
//    flat ids — so a segment ends up in ascending flat observation id
//    p*N+n (keyframe rows, then n), the order a stable sort by (landmark,
//    row) gives. (Ranking every entry within its whole segment instead
//    cost more than all the rest of the kernel, in shared-memory reads.)
//    Observations
//    without a landmark (id < 0 or >= L) follow, ascending, by an ordered
//    compaction. Ids and the unordered fill live in shared memory when
//    they fit (they do at P*N = 16384), else in scratch of the wrapper.
//  * lba_blocks_kernel: a block owns 16 consecutive landmarks, one warp
//    each. A warp reads its segment's permutation entries in one coalesced
//    load, hands them round by shuffle, and starts the vals loads of up to
//    eight observations before it adds any; the adds then run in the
//    plan's order as separately rounded f32 adds, so two launches are
//    bitwise equal. Lanes 0..11 sum the H_ll/g_l channels over the whole
//    segment; lanes 12..29 sum the H_pl channels and flush at every change
//    of keyframe row into a shared-memory stage [P][16][18] that starts at
//    zero. The block then writes the stage out, zeros included: per
//    keyframe row its 16 landmarks are one contiguous run of 1152 bytes,
//    so all of H_pl is written exactly once, coalesced, and the wrapper
//    allocates it uninitialised.
//
// Numerics: f32 throughout, as the TPU kernel. The plain version contracts
// one-hot indicators in another order, so the two agree within rtol/atol
// 1e-5, not bit for bit; the plan equals the plain version's sort exactly.
#include <cuda_runtime.h>

namespace {

constexpr int C = 30;
constexpr int LB = 16;        // landmarks per block, one warp each
constexpr int UNROLL = 8;     // observations whose loads are in flight
constexpr int PLAN_NT = 1024;
constexpr int SMEM_MAX = 200 * 1024;

__global__ void __launch_bounds__(32 * LB)
lba_blocks_kernel(const float* __restrict__ vals, const int* __restrict__ perm,
                  const int* __restrict__ lm_off, int P, int L, int N,
                  float* __restrict__ hll, float* __restrict__ gl,
                  float* __restrict__ hpl) {
  extern __shared__ float stage[];   // [P][LB][18]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int l0 = blockIdx.x * LB;
  const int l = l0 + warp;
  for (int e = tid; e < P * LB * 18; e += 32 * LB) stage[e] = 0.f;
  __syncthreads();

  if (l < L) {
    const int s = lm_off[l];
    const int e = lm_off[l + 1];
    float acc = 0.f;
    int cur_p = -1;
    for (int base = s; base < e; base += 32) {
      const int n = min(32, e - base);
      const int mine = lane < n ? perm[base + lane] : 0;
      for (int k0 = 0; k0 < n; k0 += UNROLL) {
        int o[UNROLL];
        float v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          o[u] = __shfl_sync(0xffffffffu, mine, (k0 + u) & 31);
          v[u] = (k0 + u < n && lane < C) ? vals[(size_t)o[u] * C + lane]
                                          : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (k0 + u < n) {
            const int p = o[u] / N;
            if (lane >= 12 && p != cur_p) {
              if (cur_p >= 0 && lane < C)
                stage[(cur_p * LB + warp) * 18 + (lane - 12)] = acc;
              acc = 0.f;
            }
            cur_p = p;
            acc = __fadd_rn(acc, v[u]);
          }
        }
      }
    }
    if (lane < 9) {
      hll[(size_t)l * 9 + lane] = acc;
    } else if (lane < 12) {
      gl[(size_t)l * 3 + (lane - 9)] = acc;
    } else if (lane < C && cur_p >= 0) {
      stage[(cur_p * LB + warp) * 18 + (lane - 12)] = acc;
    }
  }
  __syncthreads();

  const int run = min(LB, L - l0) * 18;   // floats per keyframe row
  for (int e = tid; e < P * run; e += 32 * LB) {
    const int p = e / run, r = e % run;
    hpl[((size_t)p * L + l0) * 18 + r] = stage[p * LB * 18 + r];
  }
}

// Exclusive prefix of v over the block's PLAN_NT threads, in thread order.
__device__ __forceinline__ int block_exclusive(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += t;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_tot[lane];
    int winc = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, winc, off);
      if (lane >= off) winc += t;
    }
    warp_tot[lane] = winc - w;
  }
  __syncthreads();
  const int res = warp_tot[warp] + inc - v;
  __syncthreads();   // warp_tot may be reused
  return res;
}

__global__ void __launch_bounds__(PLAN_NT)
lba_plan_kernel(const int* __restrict__ row_lm, int P, int N, int L,
                int in_smem,
                int* __restrict__ perm, int* __restrict__ lm_off,
                int* __restrict__ scratch) {
  extern __shared__ int sm[];
  __shared__ int warp_tot[32];
  int* off = sm;                 // [L+1] counts, then exclusive offsets
  int* cur = sm + (L + 1);       // [L+1] fill cursors
  const int tid = threadIdx.x;
  const int PN = P * N;
  const int* ids = row_lm;       // flat [PN]
  int* fill = scratch;           // [PN] a segment's members, any order
  if (in_smem) {
    int* sids = sm + 2 * (L + 1);
    fill = sids + PN;
#pragma unroll 8
    for (int o = tid; o < PN; o += PLAN_NT) sids[o] = __ldg(row_lm + o);
    ids = sids;
  }
  for (int b = tid; b <= L; b += PLAN_NT) off[b] = 0;
  __syncthreads();

  // histogram of the valid ids (bin L stays empty: after the scan it holds
  // their total, where the observations without a landmark begin; counting
  // those with atomics would serialise thousands of adds on one address)
  for (int o = tid; o < PN; o += PLAN_NT) {
    const int l = ids[o];
    if (l >= 0 && l < L) atomicAdd(&off[l], 1);
  }
  __syncthreads();

  // exclusive scan over the L+1 bins, a contiguous chunk per thread
  {
    const int chunk = (L + 1 + PLAN_NT - 1) / PLAN_NT;
    const int lo = min(tid * chunk, L + 1), hi = min(lo + chunk, L + 1);
    int sum = 0;
    for (int b = lo; b < hi; ++b) sum += off[b];
    int run = block_exclusive(sum, warp_tot);
    for (int b = lo; b < hi; ++b) {
      const int c = off[b];
      off[b] = run;
      cur[b] = run;
      lm_off[b] = run;
      run += c;
    }
  }
  __syncthreads();

  // fill each landmark's segment keyframe row by keyframe row, so that a
  // segment's rows ascend; within one row the atomics hand out the slots
  // in any order
  for (int p = 0; p < P; ++p) {
    for (int n = tid; n < N; n += PLAN_NT) {
      const int o = p * N + n;
      const int l = ids[o];
      if (l >= 0 && l < L) fill[atomicAdd(&cur[l], 1)] = o;
    }
    __syncthreads();
  }

  // order within a row: only a landmark seen twice in one keyframe row
  // leaves a run of more than one entry; an entry's rank in its run is the
  // number of smaller flat ids in it
  const int n_valid = off[L];
  for (int k = tid; k < n_valid; k += PLAN_NT) {
    const int o = fill[k];
    const int l = ids[o];
    const int s = off[l], e = off[l + 1];
    const int lo = (o / N) * N, hi = lo + N;   // the flat ids of o's row
    int a = k, b = k + 1;
    while (a > s && fill[a - 1] >= lo) --a;    // rows to the left are <= p
    while (b < e && fill[b] < hi) ++b;         // rows to the right are >= p
    int rank = 0;
    for (int j = a; j < b; ++j) rank += fill[j] < o;
    perm[a + rank] = o;
  }

  // the rest, ascending: ordered compaction. Each warp owns a contiguous
  // range of ids and walks it 32 at a time (ballot + popcount), first to
  // count, then, after a scan over the warps' counts, to write.
  {
    const int lane = tid & 31, warp = tid >> 5;
    const int per_warp = ((PN + 31) / 32 + 31) / 32 * 32;
    const int lo = min(warp * per_warp, PN), hi = min(lo + per_warp, PN);
    int cnt = 0;
    for (int o = lo + lane; o - lane < hi; o += 32) {
      const int l = o < hi ? ids[o] : 0;
      const bool inv = o < hi && !(l >= 0 && l < L);
      cnt += __popc(__ballot_sync(0xffffffffu, inv));
    }
    int dst = off[L] + block_exclusive(lane == 0 ? cnt : 0, warp_tot);
    dst = __shfl_sync(0xffffffffu, dst, 0);
    for (int o = lo + lane; o - lane < hi; o += 32) {
      const int l = o < hi ? ids[o] : 0;
      const bool inv = o < hi && !(l >= 0 && l < L);
      const unsigned m = __ballot_sync(0xffffffffu, inv);
      if (inv) perm[dst + __popc(m & ((1u << lane) - 1u))] = o;
      dst += __popc(m);
    }
  }
}

}  // namespace

// row_lm [P*N] int32 ids; perm [P*N], lm_off [L+1], scratch [P*N] int32.
// Returns the CUDA error of the launch (0: none).
extern "C" int lba_plan_launch(const int* row_lm, int P, int N, int L,
                               int* perm, int* lm_off, int* scratch,
                               void* stream) {
  const long PN = (long)P * N;
  if (P <= 0 || N <= 0 || L < 0) return (int)cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;
  const long small = 2L * (L + 1) * sizeof(int);
  const long full = small + 2L * PN * sizeof(int);
  if (small > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int in_smem = full <= SMEM_MAX;
  const int smem = (int)(in_smem ? full : small);
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        lba_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  lba_plan_kernel<<<1, PLAN_NT, smem, (cudaStream_t)stream>>>(
      row_lm, P, N, L, in_smem, perm, lm_off, scratch);
  return (int)cudaGetLastError();
}

// vals [P*N*30] f32; perm, lm_off: the plan; hll [L*9], gl [L*3], hpl
// [P*L*18] f32, all written in full (they need no initial value).
extern "C" int lba_landmark_blocks_launch(const float* vals, const int* perm,
                                          const int* lm_off, int P, int L,
                                          int N, float* hll, float* gl,
                                          float* hpl, void* stream) {
  if (L <= 0 || P <= 0) return 0;
  static int smem_set = 48 * 1024;
  const long smem = (long)P * LB * 18 * sizeof(float);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        lba_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = (int)smem;
  }
  lba_blocks_kernel<<<(L + LB - 1) / LB, 32 * LB, (int)smem,
                      (cudaStream_t)stream>>>(vals, perm, lm_off, P, L, N,
                                              hll, gl, hpl);
  return (int)cudaGetLastError();
}
