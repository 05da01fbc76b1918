// The AFNO spectral mixer, forward: kernel K18 of makani_torch.
//
// Replaces the split re/im einsums of makani_tpu/models/networks/afnonet.py
// AFNO2D (:78-97, FourCastNet v1) and afnonet_v2.py AFNO2Dv2 (_compl_mul_add_s
// :33-39 and the mixer, truncation and soft-shrink :77-92). For each spectral
// mode m of sample b and channel block k, with x the block's bs-vector of
// complex inputs:
//
//   o1 = relu(W1[k]^T x + b1[k])   (relu on re and im apart: "cartesian")
//   o2 = W2[k]^T o1 + b2[k]
//   y  = softshrink(kept(m) ? o2 : 0, lambda)   (on re and im apart)
//
// b1 and b2 are v1's (v2 has none: null pointers). kept(m) is the band of
// modes (afno.cuh Band): v1's centered rows, v2's two-sided rows, all modes at
// hard_thresholding_fraction 1. Inputs, weights, accumulation and output are
// fp32. A block takes TM modes of one channel block of one sample: it stages
// the modes' inputs in shared memory, runs the first product into a hidden
// tile in shared memory (o1 goes to device memory only when the caller asks
// for it, in training, as K19's input), then the second product and the
// epilogue. The weights stream through shared memory KC rows at a time; each
// thread holds 4 modes x 4 outputs of complex accumulators (64 FMAs per four
// 16-byte shared loads). A tile with no kept mode writes zeros.
//
// What bounds it on the card: the operations. At afno_73ch (B 1, 90 x 91
// modes, C 768, nb 8, bs 96) one launch does 8 blocks x 8190 modes x 2
// products x 4 real 96 x 96 products = 9.66 GFLOP against 100.6 MB of x in and
// y out.

#include <cuda_runtime.h>

#include <cstdint>

#include "afno.cuh"

namespace {

using afno::Band;
using afno::Layout;
using afno::LDA;
using afno::TM;

__device__ __forceinline__ float shrink(float v, float lambd) {
  const float a = fabsf(v) - lambd;
  return a > 0.f ? copysignf(a, v) : 0.f;
}

__global__ void afno_mixer_kernel(const float* __restrict__ x, float* __restrict__ y, float* __restrict__ h, const float* __restrict__ w1,
                                  const float* __restrict__ b1, const float* __restrict__ w2, const float* __restrict__ b2, Layout L, afno::Params wp, int M,
                                  int Wh, int nb, int bs, int hbs, Band band, float lambd) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int OP = afno::round4(bs > hbs ? bs : hbs);
  float* Xr = smem;
  float* Xi = Xr + bs * LDA;
  float* Hr = Xi + bs * LDA;
  float* Hi = Hr + hbs * LDA;
  float* Wr = Hi + hbs * LDA;
  float* Wi = Wr + afno::KC * OP;
  __shared__ int keep[TM];

  const int m0 = blockIdx.x * TM, k = blockIdx.y, b = blockIdx.z;
  const int nvalid = M - m0 < TM ? M - m0 : TM;
  const int tid = threadIdx.x;
  int kp = 0;
  if (tid < TM) {
    const int m = m0 + tid;
    kp = m < M && band.kept(m / Wh, m % Wh);
    keep[tid] = kp;
  }
  const bool any = __syncthreads_or(kp);

  const long long cb = (long long)k * bs * L.sC;
  const float* xb = x + b * L.sB + m0 * L.sM + cb;
  float* yb = y + b * L.sB + m0 * L.sM + cb;
  float* hb = h == nullptr ? nullptr : h + (((long long)b * nb + k) * M + m0) * hbs * 2;
  if (!any) {
    for (int idx = tid; idx < nvalid * bs; idx += blockDim.x) {
      const int m = idx / bs, i = idx - m * bs;
      *reinterpret_cast<float2*>(yb + m * L.sM + i * L.sC) = make_float2(0.f, 0.f);
    }
    if (hb != nullptr)
      for (int idx = tid; idx < nvalid * hbs; idx += blockDim.x) *reinterpret_cast<float2*>(hb + 2 * (long long)idx) = make_float2(0.f, 0.f);
    return;
  }

  afno::load_tile(Xr, Xi, xb, nullptr, L.sM, L.sC, nvalid, bs);

  const int mg = tid % (TM / 4), og = tid / (TM / 4);
  float accr[4][4], acci[4][4];
  // first product and split relu -> H[o][m]
  const float* W1 = w1 + k * wp.w1.sK;
  afno::cgemm(accr, acci, Xr, Xi, Wr, Wi, W1, wp.w1.sP, wp.w1.sR, wp.w1.sC, bs, hbs, OP, false, mg, og, og * 4 < hbs);
  if (og * 4 < hbs) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = og * 4 + j;
      if (o >= hbs) break;
      const float br = b1 != nullptr ? b1[wp.b1.at(k, 0, 0, o)] : 0.f;
      const float bi = b1 != nullptr ? b1[wp.b1.at(k, 1, 0, o)] : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = mg * 4 + q;
        const float vr = fmaxf(accr[q][j] + br, 0.f), vi = fmaxf(acci[q][j] + bi, 0.f);
        Hr[o * LDA + m] = vr;
        Hi[o * LDA + m] = vi;
        if (hb != nullptr && m < nvalid) *reinterpret_cast<float2*>(hb + ((long long)m * hbs + o) * 2) = make_float2(vr, vi);
      }
    }
  }
  // second product, band, soft-shrink -> y
  const float* W2 = w2 + k * wp.w2.sK;
  afno::cgemm(accr, acci, Hr, Hi, Wr, Wi, W2, wp.w2.sP, wp.w2.sR, wp.w2.sC, hbs, bs, OP, false, mg, og, og * 4 < bs);
  if (og * 4 < bs) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = og * 4 + j;
      if (o >= bs) break;
      const float br = b2 != nullptr ? b2[wp.b2.at(k, 0, 0, o)] : 0.f;
      const float bi = b2 != nullptr ? b2[wp.b2.at(k, 1, 0, o)] : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = mg * 4 + q;
        if (m >= nvalid) continue;
        float vr = 0.f, vi = 0.f;
        if (keep[m]) {
          vr = shrink(accr[q][j] + br, lambd);
          vi = shrink(acci[q][j] + bi, lambd);
        }
        *reinterpret_cast<float2*>(yb + m * L.sM + o * L.sC) = make_float2(vr, vi);
      }
    }
  }
}

}  // namespace

// K18. x, y: fp32 spectra with strides (sB, sM, sC) in floats (y the same
// layout as x); h: null, or fp32 (B, nb, M, hbs, 2) for the hidden o1 after
// the relu; w1 (nb, 2, bs, hbs), w2 (nb, 2, hbs, bs), b1 (nb, 2, hbs) and b2
// (nb, 2, bs) fp32 (the biases may be null), read in place through the 16
// strides wst (afno.cuh Params: w1, w2, b1, b2). M = H * Wh modes.
extern "C" int mt_afno_mixer(const void* x, void* y, void* h, const void* w1, const void* b1, const void* w2, const void* b2, const long long* wst, int B, int M,
                             int Wh, int nb, int bs, int hbs, long long sB, long long sM, long long sC, int ra0, int ra1, int rb0, int rb1, int kc, float lambd,
                             void* stream) {
  if (B <= 0 || B > 65535 || M <= 0 || Wh <= 0 || M % Wh || nb <= 0 || nb > 65535 || bs <= 0 || hbs <= 0 || lambd < 0.f || wst == nullptr)
    return (int)cudaErrorInvalidValue;
  const int threads = afno::tile_threads(hbs, bs);
  if (threads > afno::MAX_THREADS) return (int)cudaErrorInvalidConfiguration;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(h)) % 8 || (sB | sM | sC) % 2)
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = afno::tile_smem_bytes(bs, hbs);
  static size_t opted = 0;
  if (smem > 48 * 1024 && smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(afno_mixer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  const dim3 grid((M + TM - 1) / TM, nb, B);
  afno_mixer_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(h), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), Layout{sB, sM, sC}, afno::params_from(wst), M, Wh, nb, bs, hbs, Band{ra0, ra1, rb0, rb1, kc}, lambd);
  return (int)cudaGetLastError();
}
