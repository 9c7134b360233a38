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
// What bounds it on an H100: bytes. Each live observation's row is read
// once through the permutation (d values and one index), the segment
// bounds once, each landmark's row written once: at MapCaps() with the
// loop map's 16k live observations of 32768 landmarks, 2.4 MB (d 9), 0.7
// us at 3.35 TB/s; so the launch and a chain of dependent loads (bounds,
// perm, then the row) set its time.
//
// Design. One warp per landmark segment, eight warps a block. Lane j takes
// the terms k = start + j, start + j + 32, ... in that order (a coalesced
// read of perm for every 32 terms; all 32 lanes' row loads in flight at
// once), keeping one partial sum per channel in registers, each add a
// separately rounded add. The lanes then combine in a fixed butterfly
// (__shfl_xor_sync with offsets 16, 8, 4, 2, 1): every lane ends with the
// same total, and lane c writes channel c. The order of the adds is fixed
// by the segment bounds alone: no atomics, no running totals, so two
// launches are bitwise equal. A keyframe observes a landmark once, so at
// MapCaps() (K 256) a lane adds at most 8 terms and the butterfly 5
// partial sums: each result lies within ~13 roundings of the sum of its
// own terms' magnitudes, whatever the rest of the map holds.
// The plain version (ops/kernels.segment_sum_ref) adds in the same order
// and gives the same bits.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;      // landmark segments per block, one warp each
constexpr int DMAX = 16;

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
segment_sum_kernel(const T* __restrict__ vals,
                   const long long* __restrict__ perm,
                   const long long* __restrict__ starts,
                   const long long* __restrict__ ends, long long M, int L,
                   int d, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (l >= L) return;                       // the whole warp leaves
  const long long s = max(starts[l], 0LL);
  const long long e = min(ends[l], M);
  T acc[DMAX];
#pragma unroll
  for (int c = 0; c < DMAX; ++c) acc[c] = T(0);
  for (long long k = s + lane; k < e; k += 32) {
    const T* row = vals + perm[k] * d;
#pragma unroll
    for (int c = 0; c < DMAX; ++c)
      if (c < d) acc[c] = acc[c] + row[c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < DMAX; ++c)
      if (c < d) acc[c] = acc[c] + __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  // lane c writes channel c (a register picked by an unrolled compare)
  T mine = T(0);
#pragma unroll
  for (int c = 0; c < DMAX; ++c)
    if (c == lane) mine = acc[c];
  if (lane < d) out[(long long)l * d + lane] = mine;
}

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
  const dim3 grid((L + WARPS - 1) / WARPS), block(32 * WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    segment_sum_kernel<double><<<grid, block, 0, st>>>(
        (const double*)vals, perm, starts, ends, M, L, d, (double*)out);
  else
    segment_sum_kernel<float><<<grid, block, 0, st>>>(
        (const float*)vals, perm, starts, ends, M, L, d, (float*)out);
  return (int)cudaGetLastError();
}
