// Masked projected-window descriptor match with per-row top-2 and per-column
// best query, for sm_90a: the descriptor dot runs on the tensor cores.
//
// Replaces: dani_slam_tpu/ops/pallas_kernels.py window_match_topk2 (Pallas
// body _match_kernel), the target-side search of track-local-map
// (ops/matching.search_by_projection_bind).
//
// What it computes, for queries q [M,D] and targets t [N,D] (f32 in memory):
//   dist[i,j] = max(2 - 2 * dot(bf16(q_i), bf16(t_j)), 0)   (squared L2 of
//   unit descriptors; operands rounded to bf16 with round-to-nearest-even,
//   products exact in f32, sums in f32), replaced by BIG = 1e9 unless
//   dx*dx + dy*dy <= radius_i^2 and both q_i and t_j are valid. Per row:
//   best, second best, argmin (first column on ties). Per column: best
//   distance and the earliest row reaching it.
//
// What bounds it on an H100: at the main-path shape (M=4096 with ~3000 live
// rows, N=1024, D=256) the work is 1.6 GFLOP against 4.3 MB, so operations
// bound it: 1.6 us at 989 TFLOP/s bf16. Only the tensor cores reach that
// rate. The compacted query set fills 47 tiles of 64 rows, a third of the
// 132 SMs, and with 64-column wgmma steps one SM's tensor cores stay
// well below their peak; so the columns of a row tile are split over two
// blocks (94 SMs), and what a launch can reach is the time of ONE block:
// its prologue, eight 64x64x256 products with their epilogues, the merge
// of the two blocks' rows, and the launch itself.
//
// Design. One C call launches two kernels on the caller's stream.
//  * wm_prep_kernel rounds the targets to bf16 ONCE per call (not once per
//    block) into scratch that the wrapper allocates, laid out as the exact
//    shared-memory image of each 64-column tile: per 64-deep slice of the
//    descriptor a [64 rows][128 bytes] block in the 128-byte swizzle that
//    wgmma reads (16-byte chunk index XOR row % 8), followed by the tile's
//    pixel coordinates with NaN for an invalid or padded column (a NaN
//    window test is false, so validity needs no separate load). Because the
//    image is contiguous, the match kernel fetches a tile with plain bulk
//    asynchronous copies (cp.async.bulk, the TMA engine without a tensor
//    map) that complete on an mbarrier: one thread starts them, no thread
//    spends registers on addresses, and no host API call encodes a tensor
//    map. It also sets the column winners to (bits(BIG) << 32) | 0.
//  * wm_match_kernel: one block of two warpgroups owns 64 query rows. It
//    converts them to bf16 once into swizzled shared memory (32 KB); it is
//    launched as a programmatic dependent of wm_prep_kernel, so this
//    prologue runs while the targets are still being rounded, and the
//    first target tiles are requested as soon as that grid is done. The
//    two warpgroups then work independently, each on every other tile of
//    the block with a two-stage ring (2 x 33 KB) of its own; a ninth warp
//    is the producer
//    that refills a stage as soon as the warpgroup's four warps have
//    released it (full/empty mbarriers, no block-wide barrier in the
//    sweep), so tile i+2 loads while tile i+1 multiplies, and one
//    warpgroup's epilogue overlaps the other's product. A tile is one
//    wgmma.mma_async chain m64n64k16, A and B from shared memory through
//    matrix descriptors, f32 accumulators in registers (16 steps
//    for D = 256). The epilogue never leaves registers: the window test of
//    all 32 pairs of a thread first (a window holds a few of the N
//    targets, so most warps find no pair in a tile and one warp-wide OR
//    settles it), and only where a pair passes the distance, the clamp and
//    the row's running (best, second, idx) in ascending column order;
//    column minima, only for the column groups in which some row of the
//    warp passed, by shuffles over the eight rows a warp holds per column
//    pair, then one packed 64-bit atomicMin per column and warp on
//    (float_bits(dist) << 32) | row: distances are >= +0, so the bit order
//    is the numeric order and ties keep the smallest row. The rows'
//    partial results are merged once, at the end, across the four threads
//    of a quad (shuffles) and the two warpgroups (shared memory), with
//    ties going to the smaller column. (Keeping the queries in registers
//    as wgmma's A operand instead was tried: it did not speed the products
//    up and made the prologue several times slower.)
//    The distance matrix never reaches shared or device memory. A block
//    whose rows are all invalid writes BIG/BIG/0 and returns (the TPU
//    kernel's dead-tile skip): the compacted query set is a valid prefix.
//  * Column splits. gridDim.y blocks share a row tile, each taking every
//    gridDim.y-th target tile (two blocks at M = 4096: 128 blocks for 132
//    SMs; up to four for smaller M). A block leaves its rows' (best,
//    second, idx) in scratch and counts itself in on the row tile's
//    arrival counter; the block that arrives last merges the partial
//    results in the fixed order of the splits, so the outcome does not
//    depend on which block that was.
//  * wgmma rather than mma.sync: the descriptors and the swizzle are fixed
//    by the image layout above, so nothing is computed per thread, and it
//    is the operation that reaches the card's bf16 rate.
//
// Numerics: bf16 products are exact in f32, so against the plain version
// (ascending-k sums on the CUDA cores or the CPU) only the order and the
// rounding of the 256-term sum differ: |d dot| <= 255 * 2^-24 * sum |q_k
// t_k| <= 1.5e-5 for unit descriptors, twice that on the distance, and the
// tensor cores may truncate where the CUDA cores round. Agreement is
// therefore stated as atol 1e-4 on distances, with indices free only on
// near-ties (ops/kernels.window_match_agreement). The window test uses the
// plain version's separately rounded f32 arithmetic, so the masks are
// equal, and every reduction here is order-independent (min, atomicMin):
// two launches on equal inputs give bitwise equal outputs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;            // query rows per block (wgmma M)
constexpr int TN = 64;            // target columns per tile (wgmma N)
constexpr int NT = 288;           // two consumer warpgroups, one producer warp
constexpr int STAGES = 2;         // per warpgroup
constexpr int MAX_D = 256;
constexpr int Q_ATOM = TM * 128;  // bytes of one 64-deep slice of the queries
constexpr int T_ATOM = TN * 128;  // ... of a target tile
constexpr int XY_BYTES = TN * 8;  // float2 per column
constexpr int XY_PAD = 1024;      // keeps every tile image 1024-byte aligned
constexpr float BIG = 1e9f;

typedef unsigned long long u64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Eight f32 values as one 16-byte chunk of bf16.
__device__ __forceinline__ uint4 pack8_bf16(const float (&f)[8]) {
  uint4 out;
  __nv_bfloat162 h;
  h = __floats2bfloat162_rn(f[0], f[1]);
  out.x = *reinterpret_cast<uint32_t*>(&h);
  h = __floats2bfloat162_rn(f[2], f[3]);
  out.y = *reinterpret_cast<uint32_t*>(&h);
  h = __floats2bfloat162_rn(f[4], f[5]);
  out.z = *reinterpret_cast<uint32_t*>(&h);
  h = __floats2bfloat162_rn(f[6], f[7]);
  out.w = *reinterpret_cast<uint32_t*>(&h);
  return out;
}

// Eight consecutive descriptor values of one row as bf16 (zeros beyond D or
// for a row that does not exist). VEC: D is a multiple of 8, so a chunk is
// two aligned float4 loads with no branch around them — a thread's chunks
// can then all be in flight together (a chunk that does not exist reads
// the first chunk of the array instead and is zeroed by a select).
template <bool VEC>
__device__ __forceinline__ uint4 load8_bf16(const float* __restrict__ base,
                                            bool row_ok, size_t row, int k0,
                                            int D) {
  float f[8];
  if (VEC) {
    const bool ok = row_ok && k0 < D;
    const float* p = base + (ok ? row * (size_t)D + k0 : 0);
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = ok ? f[i] : 0.f;
  } else {
    const float* p = base + row * (size_t)D + k0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = (row_ok && k0 + i < D) ? p[i] : 0.f;
  }
  return pack8_bf16(f);
}

// Byte offset of 16-byte chunk `c` (over the whole descriptor) of row `r`
// in a swizzled operand whose 64-deep slices are `atom_bytes` apart.
__device__ __forceinline__ uint32_t swizzled(int r, int c, int atom_bytes) {
  return (uint32_t)(c >> 3) * atom_bytes + r * 128 +
         (((c & 7) ^ (r & 7)) << 4);
}

template <bool VEC>
__global__ void __launch_bounds__(256)
wm_prep_kernel(const float* __restrict__ tdesc, const float* __restrict__ txy,
               const unsigned char* __restrict__ tvalid, int N, int D, int ka,
               unsigned char* __restrict__ timg, u64* __restrict__ colwin,
               int* __restrict__ arrived, int n_arrived) {
  // let the match kernel start its prologue while this grid still runs
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n_arrived;
       e += gridDim.x * blockDim.x)
    arrived[e] = 0;
  const int ntiles = (N + TN - 1) / TN;
  const int cpr = ka * 8;                       // 16-byte chunks per row
  const long total = (long)ntiles * TN * cpr;
  const size_t stage_bytes = (size_t)ka * T_ATOM + XY_PAD;
  for (long e = blockIdx.x * (long)blockDim.x + threadIdx.x; e < total;
       e += (long)gridDim.x * blockDim.x) {
    const int c = (int)(e % cpr);
    const long col = e / cpr;
    const int tile = (int)(col / TN), r = (int)(col % TN);
    unsigned char* img = timg + tile * stage_bytes;
    *reinterpret_cast<uint4*>(img + swizzled(r, c, T_ATOM)) =
        load8_bf16<VEC>(tdesc, col < N, (size_t)col, c * 8, D);
    if (c == 0) {
      const float nan = __int_as_float(0x7fc00000);
      float2 p = make_float2(nan, nan);
      if (col < N) {
        if (tvalid[col]) p = make_float2(txy[2 * col], txy[2 * col + 1]);
        colwin[col] = (u64)__float_as_uint(BIG) << 32;
      }
      *reinterpret_cast<float2*>(img + (size_t)ka * T_ATOM + r * 8) = p;
    }
  }
}

// --- mbarrier, bulk copy and wgmma primitives (PTX) -----------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor: K-major operand in the 128-byte swizzle,
// eight-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;            // leading byte offset: unused here
  d |= (uint64_t)(1024 >> 4) << 32;  // stride between eight-row groups
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// (best, second, idx) of one row merged with another partial result of the
// same row over other columns; equal bests keep the smaller column.
__device__ __forceinline__ void merge_top2(float& b, float& s, int& i,
                                           float ob, float os, int oi) {
  if (ob < b || (ob == b && oi < i)) {
    s = fminf(b, os);
    b = ob;
    i = oi;
  } else {
    s = fminf(s, ob);
  }
}

template <int KA>   // 64-deep slices of the descriptor: ceil(D / 64)
__global__ void __launch_bounds__(NT, 1)
wm_match_kernel(const float* __restrict__ qdesc, const float* __restrict__ qxy,
                const unsigned char* __restrict__ qvalid,
                const float* __restrict__ radius, float radius_scalar,
                const unsigned char* __restrict__ timg, int M, int N, int D,
                float4* __restrict__ parts, int* __restrict__ arrived,
                float* __restrict__ best, float* __restrict__ second,
                int* __restrict__ idx, u64* __restrict__ colwin) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full_bar[2][STAGES], empty_bar[2][STAGES];
  __shared__ float rowb[2][TM], rows[2][TM];
  __shared__ int rowi[2][TM];
  __shared__ int last_block;

  // the swizzle pattern repeats every 1024 bytes of ADDRESS: align the base
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  constexpr uint32_t stage_bytes = (uint32_t)KA * T_ATOM + XY_PAD;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;          // warpgroup 0, 1: consumers; 2: producer
  const int wt = tid & 127;         // thread of the warpgroup
  const int row0 = blockIdx.x * TM;
  unsigned char* qs = smem;
  unsigned char* rings = smem + KA * Q_ATOM;   // [warpgroup][stage]

  if (tid == 0) {
    for (int g = 0; g < 2; ++g) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full_bar[g][s], 1);    // the producer's expect_tx arrival
        mbar_init(&empty_bar[g][s], 4);   // one arrival per consumer warp
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  int live = 0;
  if (tid < TM) live = (row0 + tid < M) && qvalid[row0 + tid];
  if (!__syncthreads_or(live)) {
    if (blockIdx.y == 0 && tid < TM && row0 + tid < M) {
      best[row0 + tid] = BIG;
      second[row0 + tid] = BIG;
      idx[row0 + tid] = 0;
    }
    return;
  }

  // The gridDim.y blocks of a row tile split the target tiles: this block
  // takes tiles y, y + S, y + 2S, ... Its k-th tile goes to warpgroup k % 2
  // as that warpgroup's tile i = k / 2, into stage i % STAGES of its ring:
  // ka descriptor slices and the coordinates, all completing on the
  // stage's full barrier.
  const int S = gridDim.y, y = blockIdx.y;
  const int ntiles = (N + TN - 1) / TN;
  const int nloc = (ntiles - y + S - 1) / S;
  auto request_tile = [&](int k) {
    const int g = k & 1, stage = (k >> 1) % STAGES;
    uint64_t* bar = &full_bar[g][stage];
    unsigned char* dst = rings + (g * STAGES + stage) * stage_bytes;
    const unsigned char* src = timg + (size_t)(y + S * k) * stage_bytes;
    mbar_expect_tx(bar, (uint32_t)KA * T_ATOM + XY_BYTES);
#pragma unroll
    for (int a = 0; a < KA; ++a)
      bulk_load(dst + a * T_ATOM, src + (size_t)a * T_ATOM, T_ATOM, bar);
    bulk_load(dst + KA * T_ATOM, src + (size_t)KA * T_ATOM, XY_BYTES, bar);
  };

  // The launch may overlap the end of wm_prep_kernel (programmatic
  // dependent launch): nothing above reads what that kernel writes, and the
  // query conversion below does not either. The tile images and the column
  // winners do, so every thread waits for that grid before it touches them.
  if (wg == 2) {
    // producer: the first tile of each warpgroup now, so that they and the
    // queries share the SM's inbound bandwidth and nothing else does
    if (lane == 0) {
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int k = 0; k < 2 && k < nloc; ++k) request_tile(k);
    }
  } else {
    // the block's queries: f32 -> bf16, once, into the swizzled A operand;
    // a thread's loads are all in flight before the first chunk is converted
    constexpr int cpr = KA * 8;
    constexpr int NC = 256;                  // consumer threads
    if ((D & 7) == 0) {
      constexpr int PER = TM * cpr / NC;     // 2 * KA chunks a thread
      uint4 v[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int e = u * NC + tid;
        v[u] = load8_bf16<true>(qdesc, row0 + e / cpr < M,
                                (size_t)(row0 + e / cpr), (e % cpr) * 8, D);
      }
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int e = u * NC + tid;
        *reinterpret_cast<uint4*>(qs + swizzled(e / cpr, e % cpr, Q_ATOM)) =
            v[u];
      }
    } else {
      for (int e = tid; e < TM * cpr; e += NC)
        *reinterpret_cast<uint4*>(qs + swizzled(e / cpr, e % cpr, Q_ATOM)) =
            load8_bf16<false>(qdesc, row0 + e / cpr < M,
                              (size_t)(row0 + e / cpr), (e % cpr) * 8, D);
    }
    // generic-proxy writes must be visible to the async proxy wgmma reads by
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  }
  __syncthreads();

  // accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16w..16w+15; a thread holds rows lane/4 and lane/4 + 8, and of every
  // eight columns the pair 2*(lane%4), 2*(lane%4)+1
  const int quad = lane & 3;
  const int rloc = 16 * (wt >> 5) + (lane >> 2);
  float rb[2] = {BIG, BIG}, rs[2] = {BIG, BIG};
  int ri[2] = {0, 0};

  if (wg == 2) {
    // producer: keep both rings full. Tile k reuses the stage of tile
    // k - 2 * STAGES once that warpgroup's four warps have released it.
    if (lane == 0) {
      for (int k = 2; k < nloc; ++k) {
        const int i = k >> 1;
        if (i >= STAGES)
          mbar_wait(&empty_bar[k & 1][i % STAGES],
                    (uint32_t)(i / STAGES - 1) & 1u);
        request_tile(k);
      }
    }
  } else {
    float qx[2], qy[2], r2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + rloc + 8 * h;
      const bool ok = gr < M && qvalid[gr];
      qx[h] = ok ? qxy[2 * gr] : 0.f;
      qy[h] = ok ? qxy[2 * gr + 1] : 0.f;
      const float r = ok ? (radius ? radius[gr] : radius_scalar) : 0.f;
      r2[h] = ok ? __fmul_rn(r, r) : -1.f;   // -1: no squared offset passes
    }
    const u64 none = (u64)__float_as_uint(BIG) << 32;
    const int nmine = (nloc - wg + 1) / 2;

    for (int i = 0; i < nmine; ++i) {
      const int s = i % STAGES;
      const int tile = y + S * (wg + 2 * i);
      mbar_wait(&full_bar[wg][s], (uint32_t)(i / STAGES) & 1u);
      const unsigned char* st = rings + (wg * STAGES + s) * stage_bytes;

      float acc[32];   // the first wgmma of a tile overwrites (scale_d = 0)
#pragma unroll
      for (int k = 0; k < 32; ++k) asm volatile("" : "+f"(acc[k])::"memory");
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint64_t da = wgmma_desc(qs);
      const uint64_t db = wgmma_desc(st);
#pragma unroll
      for (int a = 0; a < KA; ++a) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)   // 16 bf16 = 32 bytes along the row
          wgmma_m64n64k16(acc, da + ((a * Q_ATOM + kk * 32) >> 4),
                          db + ((a * T_ATOM + kk * 32) >> 4), (a | kk) != 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < 32; ++k) asm volatile("" : "+f"(acc[k])::"memory");

      // window test of the thread's 32 pairs first: bit 4j + 2e + h is
      // column pair member e, row half h of column group j.
      const float4* txy4 = reinterpret_cast<const float4*>(st + KA * T_ATOM);
      unsigned okbits = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 tc = txy4[4 * j + quad];        // x0 y0 x1 y1
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float dx = __fsub_rn(qx[h], e ? tc.z : tc.x);
            const float dy = __fsub_rn(qy[h], e ? tc.w : tc.y);
            const float w = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
            okbits |= (w <= r2[h] ? 1u : 0u) << (4 * j + 2 * e + h);
          }
        }
      }
      // the stage is read: hand it back to the producer
      __syncwarp();
      if (lane == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                         smem_u32(&empty_bar[wg][s]))
                     : "memory");

      // Usually no pair of the whole warp passes (a window holds a few of
      // the N targets) and one warp-wide OR settles the tile; else only
      // the column groups in which some row of the warp passed are reduced.
      unsigned grp = 0;   // bit j: a pair of column group j passed
#pragma unroll
      for (int j = 0; j < 8; ++j)
        grp |= (((okbits >> (4 * j)) & 15u) ? 1u : 0u) << j;
      const unsigned wgrp = __reduce_or_sync(0xffffffffu, grp);
      if (wgrp == 0) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!((wgrp >> j) & 1u)) continue;         // the whole warp skips
        const int cg = tile * TN + 8 * j + 2 * quad;   // even column
        u64 cw[2] = {none, none};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!((okbits >> (4 * j + 2 * e + h)) & 1u)) continue;   // BIG
            float d = __fsub_rn(2.f, __fmul_rn(2.f, acc[4 * j + 2 * h + e]));
            d = d > 0.f ? d : 0.f;   // +0, never -0: the packed order
            if (d < rb[h]) {
              rs[h] = rb[h];
              rb[h] = d;
              ri[h] = cg + e;
            } else {
              rs[h] = fminf(rs[h], d);
            }
            const u64 pk = ((u64)__float_as_uint(d) << 32) |
                           (u64)(unsigned)(row0 + rloc + 8 * h);
            cw[e] = pk < cw[e] ? pk : cw[e];
          }
        }
        // the warp's eight row pairs of this column pair, then one atomic
        // per column that some row of the warp reached
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const u64 o = __shfl_xor_sync(0xffffffffu, cw[e], off);
            cw[e] = o < cw[e] ? o : cw[e];
          }
        }
        if (lane < 4) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (cw[e] < none) atomicMin(&colwin[cg + e], cw[e]);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, rb[h], off);
      const float os = __shfl_xor_sync(0xffffffffu, rs[h], off);
      const int oi = __shfl_xor_sync(0xffffffffu, ri[h], off);
      merge_top2(rb[h], rs[h], ri[h], ob, os, oi);
    }
    if (quad == 0 && wg < 2) {
      rowb[wg][rloc + 8 * h] = rb[h];
      rows[wg][rloc + 8 * h] = rs[h];
      rowi[wg][rloc + 8 * h] = ri[h];
    }
  }
  __syncthreads();
  float b = BIG, s2 = BIG;
  int bi = 0;
  if (tid < TM) {
    b = rowb[0][tid], s2 = rows[0][tid], bi = rowi[0][tid];
    merge_top2(b, s2, bi, rowb[1][tid], rows[1][tid], rowi[1][tid]);
  }
  if (S > 1) {
    // The row's result over this block's columns goes to scratch; the block
    // of the row tile that arrives last merges the S partial results, in
    // the order of y whoever is last, so the outcome never depends on it.
    const size_t mpad = (size_t)gridDim.x * TM;
    if (tid < TM)
      parts[y * mpad + row0 + tid] =
          make_float4(b, s2, __int_as_float(bi), 0.f);
    __threadfence();
    __syncthreads();
    if (tid == 0) last_block = atomicAdd(&arrived[blockIdx.x], 1) == S - 1;
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    if (tid < TM) {
      const float4 p0 = __ldcg(&parts[row0 + tid]);
      b = p0.x, s2 = p0.y, bi = __float_as_int(p0.z);
      for (int k = 1; k < S; ++k) {
        const float4 pk = __ldcg(&parts[k * mpad + row0 + tid]);
        merge_top2(b, s2, bi, pk.x, pk.y, __float_as_int(pk.z));
      }
    }
  }
  if (tid < TM && row0 + tid < M) {
    best[row0 + tid] = b;
    second[row0 + tid] = s2;
    idx[row0 + tid] = bi;
  }
}

// How many blocks share a row tile's columns: enough to put every SM of
// the card to work (a block fills an SM's shared memory), at least two
// tiles each, at most four. A function of the shapes and the card only.
int column_splits(int M, int N) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
  }
  const int rowtiles = (M + TM - 1) / TM, ntiles = (N + TN - 1) / TN;
  int s = sms / rowtiles;
  s = s < (ntiles + 1) / 2 ? s : (ntiles + 1) / 2;
  return s < 1 ? 1 : (s > 4 ? 4 : s);
}

template <int KA>
int launch_match(const float* qdesc, const float* qxy,
                 const unsigned char* qvalid, const float* radius,
                 float radius_scalar, const unsigned char* timg, int M, int N,
                 int D, float4* parts, int* arrived, float* best,
                 float* second, int* idx, u64* colwin, cudaStream_t st) {
  static bool smem_set = false;
  constexpr int smem =
      1024 + KA * Q_ATOM + 2 * STAGES * (KA * T_ATOM + XY_PAD);
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wm_match_kernel<KA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + TM - 1) / TM, column_splits(M, N));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, wm_match_kernel<KA>, qdesc, qxy,
                                 qvalid, radius, radius_scalar, timg, M, N, D,
                                 parts, arrived, best, second, idx, colwin);
}

}  // namespace

// Bytes of scratch the launch needs for M queries and N targets of depth D:
// the bf16 tile images, then the row partial results of the column splits
// and the row tiles' arrival counters.
extern "C" long window_match_scratch_bytes(int M, int N, int D) {
  const long ka = (D + 63) / 64;
  const long rowtiles = (M + TM - 1) / TM;
  return (long)((N + TN - 1) / TN) * (ka * T_ATOM + XY_PAD) +
         column_splits(M, N) * rowtiles * TM * (long)sizeof(float4) +
         rowtiles * (long)sizeof(int);
}

// radius: [M] f32 on the device, or null to use radius_scalar for every
// query. scratch: window_match_scratch_bytes(M, N, D) bytes, 16-byte
// aligned, no initial value. colwin [N]: packed column winners,
// (float_bits(dist) << 32) | row; it needs no initial value. Returns the
// CUDA error of the launches (0: none).
extern "C" int window_match_topk2_launch(
    const float* qdesc, const float* qxy, const unsigned char* qvalid,
    const float* radius, float radius_scalar, const float* tdesc,
    const float* txy, const unsigned char* tvalid, int M, int N, int D,
    unsigned char* scratch, float* best, float* second, int* idx,
    unsigned long long* colwin, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (D <= 0 || D > MAX_D) return (int)cudaErrorInvalidValue;
  const int ka = (D + 63) / 64;
  const int ntiles = (N + TN - 1) / TN;
  const int rowtiles = (M + TM - 1) / TM;
  float4* parts = reinterpret_cast<float4*>(
      scratch + (size_t)ntiles * (ka * T_ATOM + XY_PAD));
  int* arrived = reinterpret_cast<int*>(
      parts + (size_t)column_splits(M, N) * rowtiles * TM);
  cudaStream_t st = (cudaStream_t)stream;
  const long chunks = (long)ntiles * TN * ka * 8;
  const unsigned pgrid = (unsigned)((chunks + 255) / 256);
  if ((D & 7) == 0)
    wm_prep_kernel<true><<<pgrid, 256, 0, st>>>(
        tdesc, txy, tvalid, N, D, ka, scratch, colwin, arrived, rowtiles);
  else
    wm_prep_kernel<false><<<pgrid, 256, 0, st>>>(
        tdesc, txy, tvalid, N, D, ka, scratch, colwin, arrived, rowtiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (ka) {
    case 1:
      return launch_match<1>(qdesc, qxy, qvalid, radius, radius_scalar,
                             scratch, M, N, D, parts, arrived, best, second,
                             idx, colwin, st);
    case 2:
      return launch_match<2>(qdesc, qxy, qvalid, radius, radius_scalar,
                             scratch, M, N, D, parts, arrived, best, second,
                             idx, colwin, st);
    case 3:
      return launch_match<3>(qdesc, qxy, qvalid, radius, radius_scalar,
                             scratch, M, N, D, parts, arrived, best, second,
                             idx, colwin, st);
    default:
      return launch_match<4>(qdesc, qxy, qvalid, radius, radius_scalar,
                             scratch, M, N, D, parts, arrived, best, second,
                             idx, colwin, st);
  }
}
