// Fixed-order per-landmark segment sum of the map-scale bundle
// adjustments, for sm_90a.
//
// Replaces no TPU kernel. The JAX package forms the per-landmark sums of
// its whole-map PCG solve (dani_slam_tpu/ops/ba_large.py, _segsum) in
// plain XLA, as differences of one f32 running sum, cs[end] - cs[start].
// At map scale that running sum reaches ~1e8 while one landmark's block is
// ~1e4, so the difference keeps few of the block's bits, and the float32
// solve ends where the rounding puts it (a cost of 98020 against 708.43 in
// float64 on the drifted 16-keyframe loop map). This kernel sums each
// segment directly. It serves ops/ba_large.py at eight sites: H_ll and g_l
// once per LM iteration, H_pl^T x in every CG matvec and in the landmark
// back-substitution, in ba_solve_pcg, ba_pcg_chunk and full_inertial_ba.
//
// What it computes: out[l, c] = sum of vals[perm[k], c] for k in
// [starts[l], ends[l]), for every landmark l < L and channel c < d <= 16,
// in float32 or float64.
//
// Order. Lane j of 32 adds the terms k = start + j, + 32, ... in turn to a
// sum that starts at 0, then the lanes combine in a butterfly over offsets
// 16, 8, 4, 2, 1 (every lane ends with the same bits). Two ways of running
// it, which a segment's own length n = ends[l] - starts[l] picks, give the
// same bits:
//   n <= SEG_SHORT (8): only lanes 0..n-1 hold a term, so the butterfly
//     reduces to ((t0 + t4) + (t2 + t6)) + ((t1 + t5) + (t3 + t7)), the
//     missing terms zeros; one thread computes that;
//   n > SEG_SHORT: the 32 lanes of a warp run it as written.
// A keyframe observes a landmark once, so at MapCaps() (K 256) a lane adds
// at most 8 terms: each result lies within 7 + 5 roundings (3 for n <= 8)
// of the sum of its own terms' magnitudes, whatever the rest of the map
// holds. The order depends on the segment's own terms alone, in
// observation order: no atomics, no running totals, so two launches are
// bitwise equal, and relabelling or sharding the landmarks gives the same
// bits per landmark. The plain version (ops/kernels.segment_sum_ref) adds in
// the same order and gives the same bits, as did the first version of this
// kernel (a warp for every landmark): a faster kernel, the same sums.
//
// What bounds it on an H100: bytes. Each live observation's row is read
// once through the permutation (d values and one index), the segment
// bounds once, each landmark's row written once: at MapCaps() with the
// loop map's 16k live observations of 32768 landmarks, 2.4 MB (d 9), 0.7
// us at 3.35 TB/s. That is below the cost of a launch, so the launch and
// the chain of dependent loads (bounds, perm, then the row) set its time.
// There is no product, so the tensor cores play no part; the rows are
// gathered through perm, and the Tensor Memory Accelerator copies strided
// tiles and does not gather on sm_90, so neither does TMA.
//
// Design: a lane per landmark.
//   * Each warp owns 32 consecutive landmarks, so its reads of starts and
//     ends are coalesced. Most segments are short (2.2 terms a live
//     landmark on the loop map), and an empty one costs a lane, not a warp:
//     32768 landmarks are 1024 warps, one wave.
//   * A short lane starts all of its <= 8 perm loads, then all of its rows'
//     loads, through the read-only path, before any add: three round trips
//     (bounds, perm, rows) for the whole warp, not three per term; its
//     adds are a tree three deep. Neighbouring landmarks' segments are
//     neighbours in perm, so a warp's perm loads are close to coalesced.
//   * The lanes whose segment is long (__ballot_sync) are then taken one
//     after another, all 32 lanes striding each of them together.
//   * The warp stages its 32 x d results in shared memory and stores them
//     as one contiguous run of 32 * d values.
//   * Two warps a block: the warps are independent (each has its own
//     staging buffer), so the block size only sets how they spread over
//     the 132 SMs. At L 32768 the 512 blocks put at most 8 warps on an SM,
//     as 128-thread blocks would; at the dry run's L 8192 they reach 128
//     SMs where 128-thread blocks would reach 64.
//   * d is a template parameter (1..16), so a row's channels live in
//     registers; a short lane keeps at most 160 32-bit registers of row
//     values in flight (all 8 terms, or 4 at a time for float64 rows wider
//     than 10 channels).
#include <cuda_runtime.h>

namespace {

constexpr int SEG_SHORT = 8;  // longest segment one thread adds alone
constexpr int WARPS = 2;      // warps a block, 32 landmarks each
constexpr int DMAX = 16;
constexpr unsigned FULL = 0xffffffffu;

template <typename T, int D>
__global__ void __launch_bounds__(32 * WARPS)
segment_sum_kernel(const T* __restrict__ vals,
                   const long long* __restrict__ perm,
                   const long long* __restrict__ starts,
                   const long long* __restrict__ ends, long long M, int L,
                   T* __restrict__ out) {
  // short terms whose rows are in flight together: all 8, or 4 at a time
  // where 8 rows would take more than 160 32-bit registers
  constexpr int BATCH =
      SEG_SHORT * D * (int)sizeof(T) <= 160 * 4 ? SEG_SHORT : SEG_SHORT / 2;
  __shared__ T stage[WARPS][32 * D];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int base = (blockIdx.x * WARPS + w) * 32;
  if (base >= L) return;                    // the whole warp leaves
  T* sh = stage[w];
  const int l = base + lane;
  long long s = 0, n = 0;
  if (l < L) {
    s = max(__ldg(starts + l), 0LL);
    n = max(min(__ldg(ends + l), M) - s, 0LL);
  }

  // short segments (empty ones too): this lane alone. a[j] is what lane
  // j (< 4) of the warp would hold after the butterfly's offsets 16, 8, 4:
  // (0 + t_j) + t_{j+4}; a masked term is 0, which leaves a sum that
  // started at 0 as it is.
  if (n <= SEG_SHORT) {
    long long idx[SEG_SHORT];
#pragma unroll
    for (int t = 0; t < SEG_SHORT; ++t)
      idx[t] = t < n ? __ldg(perm + s + t) : 0LL;
    T a[4][D];
#pragma unroll
    for (int t0 = 0; t0 < SEG_SHORT; t0 += BATCH) {
      T v[BATCH][D];
#pragma unroll
      for (int t = 0; t < BATCH; ++t)
#pragma unroll
        for (int c = 0; c < D; ++c)
          v[t][c] = t0 + t < n ? __ldg(vals + idx[t0 + t] * D + c) : T(0);
#pragma unroll
      for (int t = 0; t < BATCH; ++t)
#pragma unroll
        for (int c = 0; c < D; ++c)
          a[(t0 + t) & 3][c] = t0 + t < 4 ? T(0) + v[t][c]
                                          : a[(t0 + t) & 3][c] + v[t][c];
    }
#pragma unroll
    for (int c = 0; c < D; ++c)
      sh[lane * D + c] = (a[0][c] + a[2][c]) + (a[1][c] + a[3][c]);
  }

  // long segments: the whole warp, one after another in lane order
  unsigned todo = __ballot_sync(FULL, n > SEG_SHORT);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long ls = __shfl_sync(FULL, s, src);
    const long long le = ls + __shfl_sync(FULL, n, src);
    T acc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = T(0);
    for (long long k = ls + lane; k < le; k += 32) {
      const T* row = vals + __ldg(perm + k) * D;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = acc[c] + __ldg(row + c);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < D; ++c)
        acc[c] = acc[c] + __shfl_xor_sync(FULL, acc[c], off);
    }
    // lane c stages channel c (a register picked by an unrolled compare)
    T mine = T(0);
#pragma unroll
    for (int c = 0; c < D; ++c)
      if (c == lane) mine = acc[c];
    if (lane < D) sh[src * D + lane] = mine;
  }

  // one contiguous run of the warp's 32 rows
  __syncwarp();
  const int count = min(32, L - base) * D;
  T* dst = out + (long long)base * D;
  for (int i = lane; i < count; i += 32) dst[i] = sh[i];
}

template <typename T, int D>
void launch(const void* vals, const long long* perm, const long long* starts,
            const long long* ends, long long M, int L, void* out,
            cudaStream_t st) {
  const int warps = (L + 31) / 32;
  segment_sum_kernel<T, D><<<(warps + WARPS - 1) / WARPS, 32 * WARPS, 0,
                             st>>>((const T*)vals, perm, starts, ends, M, L,
                                   (T*)out);
}

// launch<T, D> for the run-time d: the entry of D - 1 in a table
template <typename T, int... Ds>
struct Table {
  using Fn = void (*)(const void*, const long long*, const long long*,
                      const long long*, long long, int, void*, cudaStream_t);
  static constexpr Fn fns[sizeof...(Ds)] = {&launch<T, Ds>...};
};

template <typename T>
using ByD = Table<T, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16>;

}  // namespace

// vals [rows * d] (f32, or f64 when is_double), perm [M], starts [L],
// ends [L] int64; out [L * d] of vals' type, written in full (it needs no
// initial value). perm's entries index rows of vals. Returns the CUDA
// error of the launch (0: none).
extern "C" int segment_sum_launch(const void* vals, const long long* perm,
                                  const long long* starts,
                                  const long long* ends, long long M, int L,
                                  int d, int is_double, void* out,
                                  void* stream) {
  if (d < 1 || d > DMAX || L < 0 || M < 0) return (int)cudaErrorInvalidValue;
  if (L == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    ByD<double>::fns[d - 1](vals, perm, starts, ends, M, L, out, st);
  else
    ByD<float>::fns[d - 1](vals, perm, starts, ends, M, L, out, st);
  return (int)cudaGetLastError();
}
