// Dense channels-last dhconv contraction: kernel K3 of makani_torch.
//
// Replaces makani_tpu/models/common/contractions.py contract_dense_s (dhconv,
// dense, channels-last: 'bxygi,giox->bxygo') and the four real einsums of
// cmul_einsum_s it runs on the TPU's matrix unit:
//
//   out[b, l, m, g, o] = sum_i x[b, l, m, g, i] * w[l, g, i, o]   (complex)
//
// on split-complex data (trailing re/im pair). For each (b, l, g) this is a
// complex GEMM (M x Ci) . (Ci x Co): one weight matrix per degree l, shared by
// all orders m. The weight is read in the layout (L, G, Ci, Co, 2), which the
// Python wrapper makes once per weight, not per call.
//
// What bounds it on the card: at the flagship (L 240, M 241, C 384) a layer is
// ~68 GFLOP (four real products per complex one) against ~0.6 GB of traffic:
// arithmetic bound. This version computes the real and imaginary parts in one
// pass on the fp32 FMA pipes, with fp32 accumulation for fp32 and bf16 input
// alike. Each 256-thread block holds a 64-row x 64-complex-column tile, each
// thread 4 rows x 4 complex columns (32 accumulators), fed by six vector
// shared loads per 64 FMAs from 16-deep stages with re and im split into
// separate planes. The stages are double-buffered: the next stage's global
// loads are in flight while the current one is computed. It computes every
// (l, m) exactly, the m > l entries included, so its result does not depend
// on the input's zero triangle. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "convert.cuh"

namespace {

constexpr int TM = 64;  // rows (orders m) per block
constexpr int TO = 64;  // complex output channels per block
constexpr int TC = 16;  // complex input channels per shared-memory stage
constexpr int THREADS = 256;
constexpr int X_LOADS = TM * TC * 2 / THREADS;  // 8 input values per thread per stage
constexpr int W_LOADS = TC * TO * 2 / THREADS;  // 8 weight values per thread per stage

using mt::from_f32;
using mt::to_f32;

// x: (B, L, M, G, Ci, 2); w: (L, G, Ci, Co, 2); out: (B, L, M, G, Co, 2)
template <typename T>
__global__ void __launch_bounds__(THREADS)
    dhconv_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int L, int M, int G, int Ci, int Co) {
  const int g = blockIdx.z % G;
  const int l = (blockIdx.z / G) % L;
  const int b = blockIdx.z / (G * L);
  const int m0 = blockIdx.y * TM;
  const int o0 = blockIdx.x * TO;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // complex output columns tx*2 .. +1 and 32 + tx*2 .. +1
  const int ty = tid / 16;  // output rows ty*4 .. +3

  const long long x_row = (long long)G * Ci * 2;
  const long long o_row = (long long)G * Co * 2;
  const T* x_base = x + ((long long)b * L + l) * M * x_row + (long long)g * Ci * 2;
  const T* w_base = w + ((long long)l * G + g) * Ci * Co * 2;
  T* o_base = out + ((long long)b * L + l) * M * o_row + (long long)g * Co * 2;

  // which values each thread stages: neighbouring threads take neighbouring
  // (i, re/im) values of one x row and neighbouring (o, re/im) values of one
  // w row
  const int xq = tid % (2 * TC);  // x: (i - i0) * 2 + re/im
  const int wq = tid % (2 * TO);  // w: (o - o0) * 2 + re/im
  int x_row_of[X_LOADS], w_kk[W_LOADS];
#pragma unroll
  for (int e = 0; e < X_LOADS; ++e) x_row_of[e] = (tid + e * THREADS) / (2 * TC);
#pragma unroll
  for (int e = 0; e < W_LOADS; ++e) w_kk[e] = (tid + e * THREADS) / (2 * TO);

  // x planes padded by 4 floats: fewer bank conflicts on the transposing
  // stores, and the 4-float groups stay 16-byte aligned for float4 reads
  __shared__ __align__(16) float Xr[2][TC][TM + 4];
  __shared__ __align__(16) float Xi[2][TC][TM + 4];
  __shared__ __align__(16) float Wr[2][TC][TO];
  __shared__ __align__(16) float Wi[2][TC][TO];
  float rx[X_LOADS], rw[W_LOADS];

  auto load = [&](int i0) {
#pragma unroll
    for (int e = 0; e < X_LOADS; ++e) {
      const int i = i0 + xq / 2, m = m0 + x_row_of[e];
      rx[e] = (m < M && i < Ci) ? to_f32(x_base[m * x_row + 2 * i + (xq & 1)]) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < W_LOADS; ++e) {
      const int i = i0 + w_kk[e], o = o0 + wq / 2;
      rw[e] = (i < Ci && o < Co) ? to_f32(w_base[((long long)i * Co + o) * 2 + (wq & 1)]) : 0.f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int e = 0; e < X_LOADS; ++e) {
      if (xq & 1)
        Xi[buf][xq / 2][x_row_of[e]] = rx[e];
      else
        Xr[buf][xq / 2][x_row_of[e]] = rx[e];
    }
#pragma unroll
    for (int e = 0; e < W_LOADS; ++e) {
      if (wq & 1)
        Wi[buf][w_kk[e]][wq / 2] = rw[e];
      else
        Wr[buf][w_kk[e]][wq / 2] = rw[e];
    }
  };

  float accr[4][4], acci[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) accr[r][c] = acci[r][c] = 0.f;

  load(0);
  stage(0);
  __syncthreads();
  int cur = 0;
  for (int i0 = 0; i0 < Ci; i0 += TC) {
    const bool more = i0 + TC < Ci;
    if (more) load(i0 + TC);  // in flight while this stage computes
#pragma unroll
    for (int kk = 0; kk < TC; ++kk) {
      const float4 xr4 = *reinterpret_cast<const float4*>(&Xr[cur][kk][ty * 4]);
      const float4 xi4 = *reinterpret_cast<const float4*>(&Xi[cur][kk][ty * 4]);
      const float2 wr0 = *reinterpret_cast<const float2*>(&Wr[cur][kk][tx * 2]);
      const float2 wr1 = *reinterpret_cast<const float2*>(&Wr[cur][kk][32 + tx * 2]);
      const float2 wi0 = *reinterpret_cast<const float2*>(&Wi[cur][kk][tx * 2]);
      const float2 wi1 = *reinterpret_cast<const float2*>(&Wi[cur][kk][32 + tx * 2]);
      const float xr[4] = {xr4.x, xr4.y, xr4.z, xr4.w}, xi[4] = {xi4.x, xi4.y, xi4.z, xi4.w};
      const float wr[4] = {wr0.x, wr0.y, wr1.x, wr1.y}, wi[4] = {wi0.x, wi0.y, wi1.x, wi1.y};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          accr[r][c] = fmaf(xr[r], wr[c], fmaf(-xi[r], wi[c], accr[r][c]));
          acci[r][c] = fmaf(xr[r], wi[c], fmaf(xi[r], wr[c], acci[r][c]));
        }
    }
    // the other buffer was last read before the previous barrier
    if (more) stage(cur ^ 1);
    __syncthreads();
    cur ^= 1;
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty * 4 + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int o = o0 + (c < 2 ? tx * 2 + c : 32 + tx * 2 + c - 2);
      if (o < Co) {
        o_base[m * o_row + 2 * o] = from_f32<T>(accr[r][c]);
        o_base[m * o_row + 2 * o + 1] = from_f32<T>(acci[r][c]);
      }
    }
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int mt_dhconv_contract(int dtype, const void* x, const void* w, void* out, int B, int L, int M, int G, int Ci, int Co, void* stream) {
  if (B <= 0 || L <= 0 || M <= 0 || G <= 0 || Ci <= 0 || Co <= 0 || (long long)B * L * G > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((Co + TO - 1) / TO, (M + TM - 1) / TM, B * L * G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dhconv_kernel<float><<<grid, THREADS, 0, s>>>(static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), L, M, G, Ci, Co);
  } else if (dtype == 1) {
    dhconv_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                                                          static_cast<__nv_bfloat16*>(out), L, M, G, Ci, Co);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
