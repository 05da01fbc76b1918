// Pieces shared by the AFNO spectral mixer's kernels, K18 (afno_mixer.cu) and
// K19 (afno_mixer_grad.cu).
//
// The mixer works on the 2-D spectrum of a token grid, carried as fp32 [re, im]
// pairs. A spectral mode m = r * Wh + c (r the row of the unhalved frequency
// axis, c the column of the halved one) of sample b holds, for each of the nb
// channel blocks, a complex vector of bs channels. The tensors are read
// through three strides (in floats, re and im adjacent):
//
//   element (b, m, channel) at base + b * sB + m * sM + channel * sC
//
// so one kernel reads a contiguous (B, H, Wh, C, 2) spectrum (sM = 2C, sC =
// 2) and, in place, the channels-first (B, C, H, Wh, 2) storage that the rFFT
// of channels-last tokens gives behind that shape (sM = 2, sC = 2 H Wh). The weights and biases are read in place, in the layouts of
// their parameters, through four strides each (WLayout): a weight's element
// (block k, part p of [re, im], row r, column c), a bias's with row 0. K19
// writes the weights' and biases' gradients in the same layouts.
#pragma once

#include <cuda_runtime.h>

namespace afno {

constexpr int TM = 32;        // modes a block of the mode-tiled kernels
constexpr int LDA = TM + 4;   // shared row stride of a tile's [row][mode] planes (16-byte aligned rows)
constexpr int KC = 16;        // weight rows staged at a time
constexpr int MAX_THREADS = 1024;

struct Layout {
  long long sB, sM, sC;
};

// Element (block k, part p, row r, column c) of a weight or bias at
// base + k * sK + p * sP + r * sR + c * sC (floats; sR = 0 for a bias)
struct WLayout {
  long long sK, sP, sR, sC;
  __host__ __device__ __forceinline__ long long at(long long k, long long p, long long r, long long c) const { return k * sK + p * sP + r * sR + c * sC; }
};

// The four parameters' layouts, as the wrappers pass them: w1, w2, b1, b2
// (16 strides; a missing bias's are zeros)
struct Params {
  WLayout w1, w2, b1, b2;
};

__host__ __forceinline__ Params params_from(const long long* s) {
  return Params{WLayout{s[0], s[1], s[2], s[3]}, WLayout{s[4], s[5], s[6], s[7]}, WLayout{s[8], s[9], s[10], s[11]}, WLayout{s[12], s[13], s[14], s[15]}};
}

// The kept modes: rows [ra0, ra1) and [rb0, rb1) of the unhalved axis, columns [0, kc)
struct Band {
  int ra0, ra1, rb0, rb1, kc;
  __device__ __forceinline__ bool kept(int r, int c) const { return c < kc && ((r >= ra0 && r < ra1) || (r >= rb0 && r < rb1)); }
};

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// Threads of a mode-tiled block: TM / 4 mode groups times the output groups
// of four of the wider of the two products, whole warps.
__host__ __forceinline__ int tile_threads(int o1, int o2) {
  const int og = (o1 > o2 ? round4(o1) : round4(o2)) / 4;
  return ((TM / 4) * og + 31) / 32 * 32;
}

// Floats of shared memory of a mode-tiled block: the input planes (K1 rows),
// the hidden planes (K2 rows) and one staged chunk of a weight (KC rows of
// the wider output), each re and im.
__host__ __forceinline__ size_t tile_smem_bytes(int k1, int k2) {
  const int op = k1 > k2 ? round4(k1) : round4(k2);
  return sizeof(float) * (2 * (size_t)k1 * LDA + 2 * (size_t)k2 * LDA + 2 * (size_t)KC * op);
}

// Load the tile's input vectors of one channel block into Ar/Ai[i * LDA + m]
// (zero beyond the last mode): element (m, i) at src + m * sM + i * sC, times
// (mask != 0) elementwise where a mask is given (same strides). The loop
// order follows the smaller stride, so that a warp reads adjacent floats.
__device__ __forceinline__ void load_tile(float* Ar, float* Ai, const float* src, const float* mask, long long sM, long long sC, int nvalid, int K) {
  const int n = TM * K;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    int m, i;
    if (sC <= sM) {
      m = idx / K;
      i = idx - m * K;
    } else {
      i = idx / TM;
      m = idx - i * TM;
    }
    float2 v = make_float2(0.f, 0.f);
    if (m < nvalid) {
      const long long off = m * sM + i * sC;
      v = *reinterpret_cast<const float2*>(src + off);
      if (mask != nullptr) {
        const float2 k = *reinterpret_cast<const float2*>(mask + off);
        v.x = k.x != 0.f ? v.x : 0.f;
        v.y = k.y != 0.f ? v.y : 0.f;
      }
    }
    Ar[i * LDA + m] = v.x;
    Ai[i * LDA + m] = v.y;
  }
}

// acc[q][j] = sum_r A[r][mg*4+q] * W[r][og*4+j] over r < K, complex (W
// conjugated when conj). A: Ar/Ai[r * LDA + m] in shared memory. W: element
// (part p, row r, column c) at W[p * P + r * sR + c * sC], O columns, staged
// KC rows at a time into Wr/Wi[kk * OP + c] (zero beyond the matrix). Every
// thread of the block calls it (the staging is shared); only active ones
// accumulate.
__device__ __forceinline__ void cgemm(float (&accr)[4][4], float (&acci)[4][4], const float* Ar, const float* Ai, float* Wr, float* Wi, const float* __restrict__ W,
                                      long long P, long long sR, long long sC, int K, int O, int OP, bool conj, int mg, int og, bool active) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) accr[q][j] = acci[q][j] = 0.f;
  for (int r0 = 0; r0 < K; r0 += KC) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < KC * OP; idx += blockDim.x) {
      const int kk = idx / OP, c = idx - kk * OP, r = r0 + kk;
      float vr = 0.f, vi = 0.f;
      if (r < K && c < O) {
        const float* w = W + r * sR + c * sC;
        vr = w[0];
        vi = w[P];
      }
      Wr[idx] = vr;
      Wi[idx] = conj ? -vi : vi;
    }
    __syncthreads();
    if (active) {
      const int n = K - r0 < KC ? K - r0 : KC;
#pragma unroll 4
      for (int kk = 0; kk < n; ++kk) {
        const float4 ar = *reinterpret_cast<const float4*>(Ar + (r0 + kk) * LDA + mg * 4);
        const float4 ai = *reinterpret_cast<const float4*>(Ai + (r0 + kk) * LDA + mg * 4);
        const float4 wr = *reinterpret_cast<const float4*>(Wr + kk * OP + og * 4);
        const float4 wi = *reinterpret_cast<const float4*>(Wi + kk * OP + og * 4);
        const float a_r[4] = {ar.x, ar.y, ar.z, ar.w}, a_i[4] = {ai.x, ai.y, ai.z, ai.w};
        const float w_r[4] = {wr.x, wr.y, wr.z, wr.w}, w_i[4] = {wi.x, wi.y, wi.z, wi.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            accr[q][j] = fmaf(a_r[q], w_r[j], accr[q][j]);
            accr[q][j] = fmaf(-a_i[q], w_i[j], accr[q][j]);
            acci[q][j] = fmaf(a_r[q], w_i[j], acci[q][j]);
            acci[q][j] = fmaf(a_i[q], w_r[j], acci[q][j]);
          }
      }
    }
  }
}

}  // namespace afno
