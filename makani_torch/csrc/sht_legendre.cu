// Legendre contractions of the real spherical harmonic transform: kernels K1
// (analysis) and K2 (synthesis) of makani_torch.
//
// Replaces makani_tpu/ops/sht.py _analysis_contract_cl_s and
// _synthesis_contract_cl_s, which the JAX package hands to XLA as einsums
// over channels-last split-complex arrays with fp32 (HIGHEST) accumulation.
//
//   analysis  (mode 0): out[b, l, m, n] = sum_k W[m, l, k] * x[b, k, m, n]
//   synthesis (mode 1): out[b, k, m, n] = sum_l P[m, l, k] * c[b, l, m, n]
//
// n runs over the channels and the re/im pair (N = 2 C, contiguous). For each
// (b, m) this is one GEMM: rows i (l or k), depth j (k or l), columns n. The
// tables are exactly zero for m > l (asserted by the CPU tests).
//
// What bounds it on the card: at the flagship's full resolution (nlat 721,
// lmax 240, mmax 241, C 384) the analysis is a 64 GFLOP dense product
// against ~0.7 GB of input, table and output. Half of the product is the
// table's zero triangle; what is left is bound by the tensor cores when they
// run it, by the fp32 FMA pipes (67 TFLOP/s) otherwise.
//
// The fp32 analysis (K1 on the main paths) runs on the tensor cores:
// legendre_analysis_tc_kernel below. It computes the transposed tile
// D[n, l] = sum_k x[k, n] W[l, k] with wgmma m64n64k8 in 3xTF32 (each
// operand split into a TF32 high part and residual with cvt.rna; hi.hi +
// hi.lo + lo.hi accumulated in fp32, lo.lo dropped), as K3 does in
// dhconv.cu. The table row W[m, l, :] is k-contiguous, so the table is the
// K-major B operand straight from shared memory; x is the A operand from
// registers, staged [k][n] as it lies in device memory. The table is a
// constant: the wrapper keeps its TF32 high and low planes in device
// memory, padded with zeros to 64 rows l and 32 deep k, so every table copy
// is a 16-byte cp.async (721-float rows are only 4-byte aligned) and the
// kernel never splits the table. Each 32-deep stage is summed into fresh
// registers and added to the total with a rounded fp32 add: the tensor
// cores add into their accumulator with truncation, a bias that grows with
// the depth (721 here). A 256-thread block (two warpgroups) computes 128
// columns n x 64 rows l of one (b, m) through a three-stage cp.async ring
// (x and both table planes, 34 KB a stage). Within a stage each 8-deep step
// is its own wgmma group, so only two steps' A fragments are held at a
// time. One block an SM (102 KB of shared memory, 168-175 registers and no
// spills by the ptxas lines that chip_smoke.py prints): two would cap the
// registers at 128 and spill, which measured slower. A tile whose
// 64 rows all lie above the diagonal (l < m) writes zeros and reads
// nothing: 624 of the 964 (m, l-tile) pairs are live at the flagship's
// shape (65%), against 76% with 128-row tiles. The accumulators hold
// D[n, l]; they go through shared memory as [l][n] so that the stores run
// along n, 16 bytes at a time where N is a multiple of 4 (8 bytes
// otherwise, as at FCN3's 677 channels: N = 1354, 5416-byte rows). Three
// TF32 passes over the live tiles take ~0.25 ms at the tensor cores' 495
// TFLOP/s, about the 0.26 ms its bytes need at 3.35 TB/s.
//
// The fp32 synthesis (K2 on the main paths) takes one of two routes, picked
// by the wrapper (makani_torch/ops/sht.py synthesis_route) from N alone; a
// failed launch of either raises, there is no fallback between them:
//
// * wide N (N > 32: the SFNO's 768, FCN3's 1354, noise ensembles of 8 and
//   more members): legendre_synthesis_tc_kernel, K1's tensor-core kernel
//   with the roles swapped. It computes D[n, k] = sum_l c[l, n] P[l, k],
//   c the A operand from registers staged [l][n] as it lies in device
//   memory, the table the K-major B operand from shared memory: its TF32
//   planes transposed to [m][k][l] (l-contiguous), padded to 64 rows k and
//   32 deep l (sht.synthesis_planes). The depth loop starts at the stage
//   that holds l = m: the zero triangle (l < m) is neither read nor
//   multiplied. Same stage partials, ring, one block an SM and stores
//   through shared memory as K1.
// * narrow N (N <= 32: the FCN3 noise, N = 16): legendre_synthesis_narrow_
//   kernel streams the table once. At 721 x 721 x 721 the live (l >= m)
//   triangle is 751 MB and the product 6 GFLOP: bound by the bytes
//   (0.22 ms at 3.35 TB/s), and a 128-column tensor-core tile would leave
//   7/8 of its columns empty and read two planes (1.5 GB). A block owns up
//   to 256 latitudes k of one (b, m), two a thread (512, four a thread in
//   one 16-byte load, where K % 4 == 0), and reads each row of the slab
//   P[m, l >= m, :] once, coalesced along k (128 bytes a warp at least),
//   the next four rows' loads in flight while four rows are summed;
//   c[b, l, m, :] is staged 32 rows l at a time in a cp.async double buffer
//   and read as broadcasts; each thread holds its k x N fp32 accumulators
//   (N padded to 16 or 32). The orders run slowest in the grid, m = 0 first, so the
//   longest slabs start first and the shortest fill the last round. Nothing
//   is made from the table: the route is picked before any planes would be.
//
// The crossover N = 32 is measured on an H100 (sweep_k2_k7.py times both
// routes at N 16 and 32 on the SFNO's full-resolution table and on the
// noise's; PERF.md): the narrow route is 2-4x faster at N 16 and still
// ahead at N 32, where it takes about twice its time at N 16, while the
// tensor cores' time does not change with N up to their 128-column tile.
// bf16 input (no main path runs it) stays on the fp32 FMA kernel
// legendre_contract_kernel: 64 x 128 output tiles, each thread 4 x 8
// accumulators fed by three 16-byte shared loads per 32 FMAs, 16-deep
// stages double-buffered in shared memory, fp32 accumulation. Its analysis
// writes the zero tiles above the diagonal without reading anything, and
// its synthesis starts the depth loop at l = m.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"
#include "sm90.cuh"

namespace {

constexpr int TI = 64;   // output rows per block
constexpr int TN = 128;  // output columns per block
constexpr int TK = 16;   // depth per shared-memory stage
constexpr int THREADS = 256;
constexpr int A_LOADS = TI * TK / THREADS;  // 4 table values per thread per stage
constexpr int X_LOADS = TN * TK / THREADS;  // 8 input values per thread per stage

using mt::from_f32;
using mt::to_f32;

// table: (M, L, K); x: (B, depth, M, N); out: (B, rows, M, N)
// analysis: rows = L, depth = K, A(i, j) = table[m, i, j]
// synthesis: rows = K, depth = L, A(i, j) = table[m, j, i]
template <typename T>
__global__ void __launch_bounds__(THREADS)
    legendre_contract_kernel(const T* __restrict__ table, const T* __restrict__ x, T* __restrict__ out, int M, int rows, int depth, int N, int mode) {
  const int b = blockIdx.z / M;
  const int m = blockIdx.z % M;
  const int i0 = blockIdx.y * TI;
  const int n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid / 16;  // output rows ty*4 .. +3

  const long long MN = (long long)M * N;
  T* out_base = out + (long long)b * rows * MN + (long long)m * N;

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  // analysis rows l < m multiply table rows that are exactly zero
  const bool zero_tile = (mode == 0) && (i0 + TI <= m);
  if (!zero_tile) {
    const T* a_base = table + (long long)m * rows * depth;
    const long long a_si = (mode == 0) ? depth : 1;
    const long long a_sj = (mode == 0) ? 1 : rows;
    const T* x_base = x + (long long)b * depth * MN + (long long)m * N;

    // which table and input element each thread stages: neighbouring threads
    // take neighbouring addresses (along j for the analysis table, along i
    // for the synthesis table, along n for the input)
    int a_ii[A_LOADS], a_kk[A_LOADS], x_kk[X_LOADS];
#pragma unroll
    for (int e = 0; e < A_LOADS; ++e) {
      const int idx = tid + e * THREADS;
      a_ii[e] = (mode == 0) ? idx / TK : idx % TI;
      a_kk[e] = (mode == 0) ? idx % TK : idx / TI;
    }
    const int x_nn = tid % TN;
#pragma unroll
    for (int e = 0; e < X_LOADS; ++e) x_kk[e] = (tid + e * THREADS) / TN;

    // rows padded by 4 floats: fewer bank conflicts on the transposing stores,
    // and every 4-float group stays 16-byte aligned for float4 reads
    __shared__ __align__(16) float As[2][TK][TI + 4];
    __shared__ __align__(16) float Xs[2][TK][TN];
    float ra[A_LOADS], rx[X_LOADS];

    auto load = [&](int j0) {
#pragma unroll
      for (int e = 0; e < A_LOADS; ++e) {
        const int i = i0 + a_ii[e], j = j0 + a_kk[e];
        ra[e] = (i < rows && j < depth) ? to_f32(a_base[i * a_si + j * a_sj]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < X_LOADS; ++e) {
        const int n = n0 + x_nn, j = j0 + x_kk[e];
        rx[e] = (n < N && j < depth) ? to_f32(x_base[(long long)j * MN + n]) : 0.f;
      }
    };
    auto stage = [&](int buf) {
#pragma unroll
      for (int e = 0; e < A_LOADS; ++e) As[buf][a_kk[e]][a_ii[e]] = ra[e];
#pragma unroll
      for (int e = 0; e < X_LOADS; ++e) Xs[buf][x_kk[e]][x_nn] = rx[e];
    };

    // synthesis: table entries with l < m are exactly zero
    const int j_start = (mode == 1) ? (m / TK) * TK : 0;
    load(j_start);
    stage(0);
    __syncthreads();
    int cur = 0;
    for (int j0 = j_start; j0 < depth; j0 += TK) {
      const bool more = j0 + TK < depth;
      if (more) load(j0 + TK);  // in flight while this stage computes
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
        const float4 v0 = *reinterpret_cast<const float4*>(&Xs[cur][kk][tx * 4]);
        const float4 v1 = *reinterpret_cast<const float4*>(&Xs[cur][kk][64 + tx * 4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], v[c], acc[r][c]);
      }
      // the other buffer was last read before the previous barrier
      if (more) stage(cur ^ 1);
      __syncthreads();
      cur ^= 1;
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= rows) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = n0 + (c < 4 ? tx * 4 + c : 64 + tx * 4 + c - 4);
      if (n < N) out_base[(long long)i * MN + n] = from_f32<T>(acc[r][c]);
    }
  }
}

}  // namespace

// ---- K1 and K2 in fp32 on the tensor cores ---------------------------------

namespace tc {

using namespace sm90;

// In K1 the tile's rows r are degrees l and its depth d runs over latitudes
// k; in K2 the rows are latitudes k and the depth runs over degrees l.
constexpr int BN = 128;       // columns n per block: two warpgroups of 64 (wgmma M)
constexpr int BL = 64;        // rows r per block (wgmma N)
constexpr int THREADS = 256;  // two warpgroups
constexpr int ACC = BL / 2;   // fp32 accumulators per thread of an m64n64 wgmma
constexpr int LDX = BN + 8;   // x stage [d][n]: the A-fragment loads hit 32 banks
constexpr int LDO = BN + 4;   // output tile [r][n]: the accumulator stores hit 32 banks

constexpr int BK = 32;        // depth d per stage
constexpr int STAGES = 3;     // cp.async ring
constexpr int KSTEPS = BK / 8;
constexpr int SBO = (BK / 4) * CORE + 16;  // bytes between 8-row groups of a table plane
constexpr int PLANE = (BL / 8) * SBO;      // bytes of one table plane per stage
constexpr int X_BYTES = BK * LDX * 4;
constexpr int STAGE_BYTES = X_BYTES + 2 * PLANE;
constexpr int SMEM = STAGES * STAGE_BYTES;
static_assert(BL * LDO * 4 <= SMEM, "the output tile reuses the ring");

// d (m64 x n64, fp32) = a (registers) . b (shared) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
};

// planes: (2, M, Rp, Dp) TF32 high and low parts of the table as [m][r][d],
// zero-padded; x: (B, D, M, N); out: (B, R, M, N). VEC: floats per copy and
// store along n. SYNTH: K2 (the depth starts at the stage that holds l = m)
// rather than K1 (tiles whose rows all lie at l < m write zeros).
template <int VEC, bool SYNTH>
__device__ __forceinline__ void legendre_tc_body(const uint32_t* __restrict__ planes, const float* __restrict__ x, float* __restrict__ out, int M,
                                                 int R, int D, int Rp, int Dp, int N, int n_rtiles) {
  using V = typename Vec<VEC>::T;
  constexpr int CPR = BN / VEC;  // copies (and stores) per row of BN floats
  extern __shared__ __align__(128) unsigned char smem[];
  const int rt = blockIdx.x % n_rtiles, nt = blockIdx.x / n_rtiles;
  const int m = blockIdx.y, b = blockIdx.z;
  const int r0 = rt * BL, n0 = nt * BN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int n_valid = min(BN, N - n0), r_valid = min(BL, R - r0);
  const long long MN = (long long)M * N;
  float* o_base = out + ((long long)b * R + r0) * MN + (long long)m * N + n0;

  if (!SYNTH && r0 + r_valid <= m) {  // every row l < m: the table is zero there
    for (int e = tid; e < r_valid * CPR; e += THREADS) {
      const int r = e / CPR, c = (e % CPR) * VEC;
      if (c < n_valid) *reinterpret_cast<V*>(o_base + r * MN + c) = Vec<VEC>::zero();
    }
    return;
  }

  const float* x_base = x + (long long)b * D * MN + (long long)m * N + n0;
  const uint32_t* w_hi = planes + ((long long)m * Rp + r0) * Dp;
  const uint32_t* w_lo = w_hi + (long long)M * Rp * Dp;
  const int nk = (D + BK - 1) / BK;  // Dp >= nk * BK
  // K2: the table is zero at depths l < m, so the sum starts at m's stage
  const int kt0 = SYNTH ? min(m / BK, nk) : 0;

  auto load_stage = [&](int s, int kt) {
    unsigned char* st = smem + s * STAGE_BYTES;
    float* xs = reinterpret_cast<float*>(st);
    const int k0 = kt * BK;
#pragma unroll
    for (int e0 = 0; e0 < BK * CPR; e0 += THREADS) {
      const int e = e0 + tid, r = e / CPR, c = (e % CPR) * VEC;
      const bool ok = k0 + r < D && c < n_valid;
      cp_async<4 * VEC>(xs + r * LDX + c, ok ? x_base + (long long)(k0 + r) * MN + c : x, ok);
    }
    // table rows r, 16-byte chunks of 4 d into wgmma's core-matrix layout
#pragma unroll
    for (int e0 = 0; e0 < 2 * BL * (BK / 4); e0 += THREADS) {
      const int e = e0 + tid, plane = e / (BL * (BK / 4)), l = (e / (BK / 4)) % BL, kc = e % (BK / 4);
      const uint32_t* src = (plane ? w_lo : w_hi) + (long long)l * Dp + k0 + kc * 4;
      cp_async<16>(st + X_BYTES + plane * PLANE + (l / 8) * SBO + kc * CORE + (l % 8) * 16, src, true);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kt0 + s < nk) load_stage(s, kt0 + s);
    cp_async_commit();
  }

  float acc[ACC], part[ACC];
#pragma unroll
  for (int q = 0; q < ACC; ++q) acc[q] = part[q] = 0.f;
  const int row0 = (warp / 4) * 64 + (warp % 4) * 16;  // this warp's 16 columns n of the tile

  for (int kt = kt0; kt < nk; ++kt) {
    const int i = kt - kt0;
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage kt have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have; stage kt - 1 is no longer read
    if (kt + STAGES - 1 < nk) load_stage((i + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();

    const unsigned char* st = smem + (i % STAGES) * STAGE_BYTES;
    const float* xs = reinterpret_cast<const float*>(st) + row0 + gq;
    const uint32_t b_base = smem_addr(st + X_BYTES);
    // one wgmma group per 8-deep step; the A fragments of two steps live at
    // a time: a step's registers are reused once its group has completed
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t(&h)[4] = ah[ks & 1];
      uint32_t(&l)[4] = al[ks & 1];
      // A fragment: (row gq, d tq), (gq + 8, tq), (gq, tq + 4), (gq + 8, tq + 4)
      const float v[4] = {xs[(8 * ks + tq) * LDX], xs[(8 * ks + tq) * LDX + 8], xs[(8 * ks + tq + 4) * LDX], xs[(8 * ks + tq + 4) * LDX + 8]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        h[q] = tf32(v[q]);
        l[q] = tf32(v[q] - __uint_as_float(h[q]));
      }
      // one wgmma spans two core matrices along d
      const uint64_t bh = descriptor(b_base + ks * 2 * CORE, CORE, SBO);
      const uint64_t bl = descriptor(b_base + PLANE + ks * 2 * CORE, CORE, SBO);
      wgmma_fence();
      wgmma_tf32(part, l, bh, ks > 0);
      wgmma_tf32(part, h, bl, 1);
      wgmma_tf32(part, h, bh, 1);
      wgmma_commit();
      if (ks > 0) {
        wgmma_wait<1>();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          pin(ah[(ks - 1) & 1][q]);
          pin(al[(ks - 1) & 1][q]);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      pin(ah[(KSTEPS - 1) & 1][q]);
      pin(al[(KSTEPS - 1) & 1][q]);
    }
#pragma unroll
    for (int q = 0; q < ACC; ++q) {
      pin(part[q]);
      acc[q] += part[q];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the output tile [r][n]

  // accumulator j: column n = row0 + gq (+8 for j % 4 >= 2), row r =
  // (j / 4) * 8 + 2 tq (+1 for odd j)
  float* os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < ACC; ++j) os[((j / 4) * 8 + 2 * tq + (j & 1)) * LDO + row0 + gq + 8 * ((j / 2) & 1)] = acc[j];
  __syncthreads();
  for (int e = tid; e < r_valid * CPR; e += THREADS) {
    const int r = e / CPR, c = (e % CPR) * VEC;
    if (c < n_valid) *reinterpret_cast<V*>(o_base + r * MN + c) = *reinterpret_cast<const V*>(os + r * LDO + c);
  }
}

// K1: planes (2, M, Lp, Kp), x (B, K, M, N), out (B, L, M, N)
template <int VEC>
__global__ void __launch_bounds__(THREADS, 1)
    legendre_analysis_tc_kernel(const uint32_t* __restrict__ planes, const float* __restrict__ x, float* __restrict__ out, int M, int L, int K,
                                int Lp, int Kp, int N, int n_ltiles) {
  legendre_tc_body<VEC, false>(planes, x, out, M, L, K, Lp, Kp, N, n_ltiles);
}

// K2: planes (2, M, Kp, Lp), c (B, L, M, N), out (B, K, M, N)
template <int VEC>
__global__ void __launch_bounds__(THREADS, 1)
    legendre_synthesis_tc_kernel(const uint32_t* __restrict__ planes, const float* __restrict__ c, float* __restrict__ out, int M, int K, int L,
                                 int Kp, int Lp, int N, int n_ktiles) {
  legendre_tc_body<VEC, true>(planes, c, out, M, K, L, Kp, Lp, N, n_ktiles);
}

// R, D: the rows and the depth of the product (K1: L, K; K2: K, L)
template <int VEC, bool SYNTH>
int launch(const uint32_t* planes, const float* x, float* out, int B, int M, int R, int D, int Rp, int Dp, int N, cudaStream_t s) {
  void (*kernel)(const uint32_t*, const float*, float*, int, int, int, int, int, int, int) = legendre_analysis_tc_kernel<VEC>;
  if constexpr (SYNTH) kernel = legendre_synthesis_tc_kernel<VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_rtiles = (R + BL - 1) / BL;
  const dim3 grid(n_rtiles * ((N + BN - 1) / BN), M, B);
  kernel<<<grid, THREADS, SMEM, s>>>(planes, x, out, M, R, D, Rp, Dp, N, n_rtiles);
  return (int)cudaGetLastError();
}

// the arguments both tensor-core entry points check; 0 if they are good
static int check_args(const void* planes, const void* x, const void* out, int B, int M, int R, int D, int Rp, int Dp, int N) {
  if (B <= 0 || M <= 0 || R <= 0 || D <= 0 || N <= 0 || N % 2 || B > 65535 || M > 65535 || Rp < R || Rp % BL || Dp < D || Dp % BK)
    return (int)cudaErrorInvalidValue;
  const uintptr_t io = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  if (reinterpret_cast<uintptr_t>(planes) % 16 || io % 8) return (int)cudaErrorMisalignedAddress;
  return 0;
}

template <bool SYNTH>
int dispatch(const void* planes, const void* x, void* out, int B, int M, int R, int D, int Rp, int Dp, int N, void* stream) {
  if (int err = check_args(planes, x, out, B, M, R, D, Rp, Dp, N)) return err;
  const uintptr_t io = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(planes);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (N % 4 == 0 && io % 16 == 0) return launch<4, SYNTH>(p, xf, of, B, M, R, D, Rp, Dp, N, s);
  return launch<2, SYNTH>(p, xf, of, B, M, R, D, Rp, Dp, N, s);
}

}  // namespace tc

// ---- K2 in fp32 at narrow N: one pass over the table -----------------------

namespace narrow {

using namespace sm90;

constexpr int THREADS = 128;
constexpr int LC = 32;     // degrees l per staged chunk of c
constexpr int UNROLL = 4;  // table rows per group; two groups in flight a thread

// latitudes per thread: VEC 1, k0 + t and k0 + t + THREADS (4-byte loads,
// 128 bytes a warp); VEC 4, k0 + 4t .. +3 (one 16-byte load, K % 4 == 0)
template <int VEC>
__host__ __device__ constexpr int kpt() {
  return VEC == 4 ? 4 : 2;
}

// table: (M, L, K); c: (B, L, M, N); out: (B, K, M, N); N <= NC, N even.
// A block owns ktile latitudes (at most THREADS * kpt) of one (b, m). The
// orders run slowest in the grid, m = 0 first: the blocks with the longest
// slabs (L - m rows) start first and the shortest fill the last round.
template <int NC, int VEC>
__global__ void __launch_bounds__(THREADS)
    legendre_synthesis_narrow_kernel(const float* __restrict__ table, const float* __restrict__ c, float* __restrict__ out, int M, int L, int K,
                                     int N, int ktile) {
  constexpr int KPT = kpt<VEC>();
  __shared__ __align__(16) float cs[2][LC][NC];
  const int b = blockIdx.x, k0 = blockIdx.y * ktile, tid = threadIdx.x;
  const int k_end = min(k0 + ktile, K);
  const long long MN = (long long)M * N;
  int kk[KPT];
  bool kv[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    kk[j] = VEC == 4 ? k0 + 4 * tid + j : k0 + tid + THREADS * j;
    kv[j] = kk[j] < k_end;
  }

  // the table rows of one group, from row `rows` on, `left` of them live
  auto load_group = [&](float(&p)[UNROLL][KPT], const float* rows, int left) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float* row = rows + (long long)u * K;
      const bool live = u < left;
      if constexpr (VEC == 4) {
        const float4 v = live && kv[0] ? __ldcs(reinterpret_cast<const float4*>(row + kk[0])) : make_float4(0.f, 0.f, 0.f, 0.f);
        p[u][0] = v.x;
        p[u][1] = v.y;
        p[u][2] = v.z;
        p[u][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < KPT; ++j) p[u][j] = live && kv[j] ? __ldcs(row + kk[j]) : 0.f;
      }
    }
  };

  const int m = blockIdx.z;
  const float* c_base = c + (long long)b * L * MN + (long long)m * N;
  float acc[KPT][NC];
#pragma unroll
  for (int j = 0; j < KPT; ++j)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[j][n] = 0.f;

  // rows l0 .. l0 + LC of c[b, :, m, :] into cs[buf], in 8-byte pieces;
  // zeros past N and past L
  auto stage = [&](int buf, int l0) {
#pragma unroll
    for (int e0 = 0; e0 < LC * NC / 2; e0 += THREADS) {
      const int e = e0 + tid, r = e / (NC / 2), q = (e % (NC / 2)) * 2;
      const bool ok = l0 + r < L && q < N;
      cp_async<8>(&cs[buf][r][q], ok ? c_base + (long long)(l0 + r) * MN + q : c, ok);
    }
  };
  auto fma_group = [&](const float(&p)[UNROLL][KPT], const float(*cb)[NC], int r) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int n4 = 0; n4 < NC / 4; ++n4) {
        const float4 cv = *reinterpret_cast<const float4*>(&cb[r + u][4 * n4]);
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          acc[j][4 * n4 + 0] = fmaf(p[u][j], cv.x, acc[j][4 * n4 + 0]);
          acc[j][4 * n4 + 1] = fmaf(p[u][j], cv.y, acc[j][4 * n4 + 1]);
          acc[j][4 * n4 + 2] = fmaf(p[u][j], cv.z, acc[j][4 * n4 + 2]);
          acc[j][4 * n4 + 3] = fmaf(p[u][j], cv.w, acc[j][4 * n4 + 3]);
        }
      }
  };

  // the table is zero at l < m: the sum runs over l = m .. L - 1. The
  // loads of the next group are in flight while a group is summed, also
  // across the chunks' barriers; rows past L multiply zeros staged in cs.
  const int nrows = max(L - m, 0), nch = (nrows + LC - 1) / LC;
  const float* t_rows = table + ((long long)m * L + m) * K;
  if (nch > 0) stage(0, m);
  cp_async_commit();
  float pa[UNROLL][KPT], pb[UNROLL][KPT];
  load_group(pa, t_rows, nrows);
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ch has landed; chunk ch - 1 is no longer read
    if (ch + 1 < nch) stage((ch + 1) & 1, m + (ch + 1) * LC);
    cp_async_commit();
    const float(*cb)[NC] = cs[ch & 1];
    const int r_end = min(LC, nrows - ch * LC);
    for (int r = 0; r < r_end; r += 2 * UNROLL) {
      const int g = ch * LC + r;
      load_group(pb, t_rows + (long long)(g + UNROLL) * K, nrows - g - UNROLL);
      fma_group(pa, cb, r);
      load_group(pa, t_rows + (long long)(g + 2 * UNROLL) * K, nrows - g - 2 * UNROLL);
      fma_group(pb, cb, r + UNROLL);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    if (!kv[j]) continue;
    float* o = out + ((long long)b * K + kk[j]) * MN + (long long)m * N;
#pragma unroll
    for (int n = 0; n < NC; n += 2)
      if (n < N) *reinterpret_cast<float2*>(o + n) = make_float2(acc[j][n], acc[j][n + 1]);
  }
}

template <int NC, int VEC>
int launch(const float* table, const float* c, float* out, int B, int M, int L, int K, int N, cudaStream_t s) {
  // latitude tiles of about equal width, at most THREADS * kpt (a multiple of VEC)
  const int slots = THREADS * kpt<VEC>(), n_tiles = (K + slots - 1) / slots;
  const int ktile = ((K + n_tiles - 1) / n_tiles + VEC - 1) / VEC * VEC;
  const dim3 grid(B, (K + ktile - 1) / ktile, M);
  legendre_synthesis_narrow_kernel<NC, VEC><<<grid, THREADS, 0, s>>>(table, c, out, M, L, K, N, ktile);
  return (int)cudaGetLastError();
}

}  // namespace narrow

// K1 and K2 in bf16 on the fp32 FMA kernel: dtype 1 (bfloat16) only, fp32
// has the tensor-core and narrow kernels. mode: 0 analysis, 1 synthesis.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mt_legendre_contract(int dtype, const void* table, const void* x, void* out, int B, int M, int rows, int depth, int N, int mode,
                                    void* stream) {
  if (dtype != 1 || B <= 0 || M <= 0 || rows <= 0 || depth <= 0 || N <= 0 || (long long)B * M > 65535 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + TN - 1) / TN, (rows + TI - 1) / TI, B * M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  legendre_contract_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(table), static_cast<const __nv_bfloat16*>(x),
                                                                   static_cast<__nv_bfloat16*>(out), M, rows, depth, N, mode);
  return (int)cudaGetLastError();
}

// K1, fp32 on the tensor cores. planes: uint32 (2, M, Lp, Kp), the TF32 high
// and low parts of the analysis table (M, L, K), zero-padded to Lp (a
// multiple of 64) and Kp (a multiple of 32); x: float32 (B, K, M, N); out:
// float32 (B, L, M, N); N even. Returns cudaGetLastError() after the launch,
// or an argument error without launching.
extern "C" int mt_legendre_analysis_tc(const void* planes, const void* x, void* out, int B, int M, int L, int K, int Lp, int Kp, int N,
                                       void* stream) {
  return tc::dispatch<false>(planes, x, out, B, M, L, K, Lp, Kp, N, stream);
}

// K2, fp32 on the tensor cores. planes: uint32 (2, M, Kp, Lp), the TF32 high
// and low parts of the synthesis table (M, L, K) transposed to [m][k][l],
// zero-padded to Kp (a multiple of 64) and Lp (a multiple of 32); c: float32
// (B, L, M, N); out: float32 (B, K, M, N); N even.
extern "C" int mt_legendre_synthesis_tc(const void* planes, const void* c, void* out, int B, int M, int L, int K, int Kp, int Lp, int N,
                                        void* stream) {
  return tc::dispatch<true>(planes, c, out, B, M, K, L, Kp, Lp, N, stream);
}

// K2, fp32 at narrow N (N even, N <= 32): one pass over the table itself,
// (M, L, K) float32; c: float32 (B, L, M, N); out: float32 (B, K, M, N).
extern "C" int mt_legendre_synthesis_narrow(const void* table, const void* c, void* out, int B, int M, int L, int K, int N, void* stream) {
  if (B <= 0 || M <= 0 || L <= 0 || K <= 0 || N <= 0 || N % 2 || N > 32 || M > 65535 || K > 65535)
    return (int)cudaErrorInvalidValue;
  const uintptr_t io = reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(out);
  if (io % 8 || reinterpret_cast<uintptr_t>(table) % 4) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const float* cf = static_cast<const float*>(c);
  float* of = static_cast<float*>(out);
  const bool wide = K % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0;
  if (N <= 16) return wide ? narrow::launch<16, 4>(t, cf, of, B, M, L, K, N, s) : narrow::launch<16, 1>(t, cf, of, B, M, L, K, N, s);
  return wide ? narrow::launch<32, 4>(t, cf, of, B, M, L, K, N, s) : narrow::launch<32, 1>(t, cf, of, B, M, L, K, N, s);
}

extern "C" const char* mt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
