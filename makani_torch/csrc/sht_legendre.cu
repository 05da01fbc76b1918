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
// (b, m) this is one GEMM: rows i (l or k), depth j (k or l), columns n.
//
// What bounds it on the card: at the flagship's full resolution (nlat 721,
// lmax 240, mmax 241, C 384) the analysis is ~64 GFLOP against ~0.7 GB of
// input and table, so it is bound by arithmetic, not memory. This version
// runs on the fp32 FMA pipes (no tensor cores), with fp32 accumulation for
// fp32 and bf16 input alike. Each 256-thread block computes a 64 x 128 output
// tile; each thread holds 4 x 8 accumulators, fed by three 16-byte shared
// loads per 32 FMAs. The 16-deep stages are double-buffered in shared memory:
// the next stage's global loads are issued into registers before the current
// stage is computed, so their latency hides behind the FMAs, and one barrier
// per stage suffices. The tables are exactly zero for m > l (asserted by the
// CPU tests), so the analysis writes zero tiles above the diagonal without
// reading anything, and the synthesis starts its depth loop at l = m: about a
// third of the dense work is skipped. Each output still sums its depth in
// order with FMA. wgmma/TMA on bf16 tensor cores is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "convert.cuh"

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

// dtype: 0 float32, 1 bfloat16. mode: 0 analysis, 1 synthesis.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mt_legendre_contract(int dtype, const void* table, const void* x, void* out, int B, int M, int rows, int depth, int N, int mode,
                                    void* stream) {
  if (B <= 0 || M <= 0 || rows <= 0 || depth <= 0 || N <= 0 || (long long)B * M > 65535 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + TN - 1) / TN, (rows + TI - 1) / TI, B * M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    legendre_contract_kernel<float><<<grid, THREADS, 0, s>>>(static_cast<const float*>(table), static_cast<const float*>(x),
                                                             static_cast<float*>(out), M, rows, depth, N, mode);
  } else if (dtype == 1) {
    legendre_contract_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(table),
                                                                     static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), M,
                                                                     rows, depth, N, mode);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
