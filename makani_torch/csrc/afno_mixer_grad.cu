// The AFNO spectral mixer, backward: kernel K19 of makani_torch.
//
// Replaces the VJP that JAX derives for K18's einsums (makani_tpu/models/
// networks/afnonet.py :78-97, afnonet_v2.py :33-39 and :77-92). K18 keeps the
// hidden o1 (after the relu) and its output y; with dy the incoming gradient,
// everything complex and per mode m and channel block k:
//
//   g2  = dy * (y != 0)             re and im apart: the soft-shrink's slope
//                                   (1 where |o2| > lambda) and the band (y = 0
//                                   off the band)
//   g1  = (W2[k] g2-conj) * (o1 > 0) the first product's output gradient
//                                   through the split relu: g2 . conj(W2)^T
//   dx  = g1 . conj(W1[k])^T
//   dW1[k] = sum_m conj(x) (x) g1,  db1[k] = sum_m g1
//   dW2[k] = sum_m conj(o1) (x) g2, db2[k] = sum_m g2
//
// The mode sums run over the B * M modes of all samples. They are
// deterministic: no float atomics. Three launches:
//
//   1. afno_grad_data: TM modes of a channel block a block, as K18's tiles:
//      g2 staged in shared memory, the first product (K18's cgemm on W2
//      transposed and conjugated) gives g1, which goes to device memory and
//      to a shared tile, the second (on W1) gives dx. A tile with no kept
//      mode writes zeros.
//   2. afno_grad_weight: each block sums one 32 x 32 tile of dW1 or dW2 (and
//      its bias's 32 columns) over one of S fixed, contiguous ranges of modes,
//      32 modes a round, into its own partial in a scratch buffer.
//   3. afno_grad_reduce: each output element sums its S partials in order.
//
// So a step repeats bit for bit. o1 is read, not recomputed: K18 writes it
// (B nb M hbs complex, the size of x) when the forward is to be
// differentiated.
//
// What bounds it on the card: the operations, twice K18's (four complex
// products of the same size). At afno_73ch (B 1, 90 x 91 modes, C 768, nb 8,
// bs 96) 19.3 GFLOP against ~352 MB (x, y, dy, o1 read, g1 and dx written,
// g1 read again by the weight pass).

#include <cuda_runtime.h>

#include <cstdint>

#include "afno.cuh"

namespace {

using afno::Band;
using afno::Layout;
using afno::LDA;
using afno::TM;

__global__ void afno_grad_data_kernel(const float* __restrict__ dy, const float* __restrict__ y, const float* __restrict__ h, const float* __restrict__ w1,
                                      const float* __restrict__ w2, float* __restrict__ dx, float* __restrict__ g1, Layout L, afno::Params wp, int M, int Wh,
                                      int nb, int bs, int hbs, Band band) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int OP = afno::round4(bs > hbs ? bs : hbs);
  float* Gr = smem;
  float* Gi = Gr + bs * LDA;
  float* Hr = Gi + bs * LDA;
  float* Hi = Hr + hbs * LDA;
  float* Wr = Hi + hbs * LDA;
  float* Wi = Wr + afno::KC * OP;

  const int m0 = blockIdx.x * TM, k = blockIdx.y, b = blockIdx.z;
  const int nvalid = M - m0 < TM ? M - m0 : TM;
  const int tid = threadIdx.x;
  int kp = 0;
  if (tid < TM) {
    const int m = m0 + tid;
    kp = m < M && band.kept(m / Wh, m % Wh);
  }
  const bool any = __syncthreads_or(kp);

  const long long off = b * L.sB + m0 * L.sM + (long long)k * bs * L.sC;
  float* dxb = dx + off;
  const long long hoff = (((long long)b * nb + k) * M + m0) * hbs * 2;
  float* g1b = g1 + hoff;
  const float* hb = h + hoff;
  if (!any) {
    for (int idx = tid; idx < nvalid * bs; idx += blockDim.x) {
      const int m = idx / bs, i = idx - m * bs;
      *reinterpret_cast<float2*>(dxb + m * L.sM + i * L.sC) = make_float2(0.f, 0.f);
    }
    for (int idx = tid; idx < nvalid * hbs; idx += blockDim.x) *reinterpret_cast<float2*>(g1b + 2 * (long long)idx) = make_float2(0.f, 0.f);
    return;
  }

  afno::load_tile(Gr, Gi, dy + off, y + off, L.sM, L.sC, nvalid, bs);

  const int mg = tid % (TM / 4), og = tid / (TM / 4);
  float accr[4][4], acci[4][4];
  // g1[m][i] = sum_o g2[m][o] conj(W2[i][o]), W2 (p, i, o) read as (row o, column i)
  const float* W2 = w2 + k * wp.w2.sK;
  afno::cgemm(accr, acci, Gr, Gi, Wr, Wi, W2, wp.w2.sP, wp.w2.sC, wp.w2.sR, bs, hbs, OP, true, mg, og, og * 4 < hbs);
  if (og * 4 < hbs) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = og * 4 + j;
      if (i >= hbs) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = mg * 4 + q;
        float vr = 0.f, vi = 0.f;
        if (m < nvalid) {
          const float2 o1 = *reinterpret_cast<const float2*>(hb + ((long long)m * hbs + i) * 2);
          vr = o1.x > 0.f ? accr[q][j] : 0.f;
          vi = o1.y > 0.f ? acci[q][j] : 0.f;
          *reinterpret_cast<float2*>(g1b + ((long long)m * hbs + i) * 2) = make_float2(vr, vi);
        }
        Hr[i * LDA + m] = vr;
        Hi[i * LDA + m] = vi;
      }
    }
  }
  // dx[m][c] = sum_i g1[m][i] conj(W1[c][i]), W1 (p, c, i) read as (row i, column c)
  const float* W1 = w1 + k * wp.w1.sK;
  afno::cgemm(accr, acci, Hr, Hi, Wr, Wi, W1, wp.w1.sP, wp.w1.sC, wp.w1.sR, hbs, bs, OP, true, mg, og, og * 4 < bs);
  if (og * 4 < bs) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = og * 4 + j;
      if (c >= bs) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = mg * 4 + q;
        if (m < nvalid) *reinterpret_cast<float2*>(dxb + m * L.sM + c * L.sC) = make_float2(accr[q][j], acci[q][j]);
      }
    }
  }
}

// One operand of a weight-gradient sum: element (row q = b * M + m, column c)
// of channel block k at p + b * sB + m * sM + k * sK + c * sC, times
// (mask != 0) elementwise where a mask is given.
struct Operand {
  const float* p;
  const float* mask;
  long long sB, sM, sK, sC;
};

constexpr int WT = 32;         // rows and columns of a weight-gradient tile
constexpr int WLD = WT + 4;    // its shared row stride
constexpr int WTHREADS = 64;   // 8 x 8 threads of 4 x 4 complex outputs

// Stage rows [q0, q0 + WT) (of R) and columns [c0, c0 + WT) (of Cn) into
// S[r * WLD + c] re and im.
__device__ __forceinline__ void load_rows(float* Sr, float* Si, const Operand& A, int k, int M, long long q0, long long R, int c0, int Cn) {
  for (int idx = threadIdx.x; idx < WT * WT; idx += WTHREADS) {
    int r, c;
    if (A.sC <= A.sM) {
      r = idx / WT;
      c = idx - r * WT;
    } else {
      c = idx / WT;
      r = idx - c * WT;
    }
    const long long q = q0 + r;
    float2 v = make_float2(0.f, 0.f);
    if (q < R && c0 + c < Cn) {
      const long long b = q / M, m = q - b * M;
      const long long o = b * A.sB + m * A.sM + k * A.sK + (long long)(c0 + c) * A.sC;
      v = *reinterpret_cast<const float2*>(A.p + o);
      if (A.mask != nullptr) {
        const float2 t = *reinterpret_cast<const float2*>(A.mask + o);
        v.x = t.x != 0.f ? v.x : 0.f;
        v.y = t.y != 0.f ? v.y : 0.f;
      }
    }
    Sr[r * WLD + c] = v.x;
    Si[r * WLD + c] = v.y;
  }
}

// grid (tiles, nb, 2 S): blockIdx.z = which * S + s. which 0: dW1 (rows: x,
// bs columns; g1, hbs columns); which 1: dW2 (o1, hbs; g2, bs). Partial
// (s, k, p, i, o) of each into pw[which], the bias's (s, k, p, o) into
// pb[which] (when pb[which] is not null).
struct WeightArgs {
  Operand a[2], g[2];
  int ka[2], kg[2];
  float* pw[2];
  float* pb[2];
};

__global__ void __launch_bounds__(WTHREADS) afno_grad_weight_kernel(WeightArgs args, int M, long long R, int nb, int S) {
  __shared__ __align__(16) float Ar[WT * WLD], Ai[WT * WLD], Gr_[WT * WLD], Gi_[WT * WLD];
  const int which = blockIdx.z / S, s = blockIdx.z - which * S, k = blockIdx.y;
  const int KA = args.ka[which], KG = args.kg[which];
  const int ntc = (KG + WT - 1) / WT;
  const int tiles = (KA + WT - 1) / WT * ntc;
  if ((int)blockIdx.x >= tiles) return;
  const int ti0 = blockIdx.x / ntc * WT, to0 = blockIdx.x % ntc * WT;
  const Operand A = args.a[which], G = args.g[which];
  const long long q_lo = R * s / S, q_hi = R * (s + 1) / S;
  const int tid = threadIdx.x, ti = tid % 8, to = tid / 8;
  float* pb = args.pb[which];
  const bool bias = pb != nullptr && ti0 == 0;

  float accr[4][4] = {}, acci[4][4] = {};
  float bsr = 0.f, bsi = 0.f;
  for (long long q0 = q_lo; q0 < q_hi; q0 += WT) {
    __syncthreads();
    load_rows(Ar, Ai, A, k, M, q0, q_hi, ti0, KA);
    load_rows(Gr_, Gi_, G, k, M, q0, q_hi, to0, KG);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < WT; ++r) {
      const float4 ar = *reinterpret_cast<const float4*>(Ar + r * WLD + ti * 4);
      const float4 ai = *reinterpret_cast<const float4*>(Ai + r * WLD + ti * 4);
      const float4 gr = *reinterpret_cast<const float4*>(Gr_ + r * WLD + to * 4);
      const float4 gi = *reinterpret_cast<const float4*>(Gi_ + r * WLD + to * 4);
      const float a_r[4] = {ar.x, ar.y, ar.z, ar.w}, a_i[4] = {ai.x, ai.y, ai.z, ai.w};
      const float g_r[4] = {gr.x, gr.y, gr.z, gr.w}, g_i[4] = {gi.x, gi.y, gi.z, gi.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          // conj(a) * g
          accr[u][v] = fmaf(a_r[u], g_r[v], accr[u][v]);
          accr[u][v] = fmaf(a_i[u], g_i[v], accr[u][v]);
          acci[u][v] = fmaf(a_r[u], g_i[v], acci[u][v]);
          acci[u][v] = fmaf(-a_i[u], g_r[v], acci[u][v]);
        }
    }
    if (bias && tid < WT)
      for (int r = 0; r < WT; ++r) {
        bsr += Gr_[r * WLD + tid];
        bsi += Gi_[r * WLD + tid];
      }
  }
  float* pw = args.pw[which] + ((long long)s * nb + k) * 2 * KA * KG;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = ti0 + ti * 4 + u;
    if (i >= KA) break;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int o = to0 + to * 4 + v;
      if (o >= KG) break;
      pw[(long long)i * KG + o] = accr[u][v];
      pw[(long long)KA * KG + (long long)i * KG + o] = acci[u][v];
    }
  }
  if (bias && tid < WT && to0 + tid < KG) {
    float* p = pb + ((long long)s * nb + k) * 2 * KG;
    p[to0 + tid] = bsr;
    p[KG + to0 + tid] = bsi;
  }
}

// One output of the reduction: its S partials, each n = nb * 2 * rows * cols
// floats in the order (k, p, r, c), and the output in its parameter's layout.
struct ReduceOut {
  const float* part;
  float* out;
  long long n;
  int rows, cols;
  afno::WLayout at;
};

// out[(k, p, r, c)] = sum_{s < S} part[s * n + e], in order, e the canonical
// index, for the four outputs laid end to end (dw1, dw2, db1, db2; n = 0 for
// an absent one).
__global__ void afno_grad_reduce_kernel(ReduceOut o1, ReduceOut o2, ReduceOut o3, ReduceOut o4, int S) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  ReduceOut o;
  if (e < o1.n) {
    o = o1;
  } else if ((e -= o1.n) < o2.n) {
    o = o2;
  } else if ((e -= o2.n) < o3.n) {
    o = o3;
  } else if ((e -= o3.n) < o4.n) {
    o = o4;
  } else {
    return;
  }
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += o.part[s * o.n + e];
  const long long c = e % o.cols, rest = e / o.cols, r = rest % o.rows, kp = rest / o.rows;
  o.out[o.at.at(kp / 2, kp % 2, r, c)] = acc;
}

}  // namespace

// Floats of the scratch buffer K19 needs with S mode ranges (the partials).
extern "C" long long mt_afno_grad_scratch(int S, int nb, int bs, int hbs, int bias) {
  const long long w = 2LL * nb * 2 * bs * hbs, b = bias ? (long long)nb * 2 * (bs + hbs) : 0;
  return (long long)S * (w + b);
}

// K19. x, y, dy, dx: fp32 spectra with strides (sB, sM, sC) (K18's layout);
// h: K18's o1, fp32 (B, nb, M, hbs, 2); g1: a buffer of h's size (written);
// w1 (nb, 2, bs, hbs), w2 (nb, 2, hbs, bs) as K18 takes them, with the 16
// strides wst (afno.cuh Params: w1, w2, b1, b2); dw1, dw2 of their shapes
// and layouts, db1 (nb, 2, hbs) and db2 (nb, 2, bs) in the biases' layouts
// (null without biases) written; scratch: mt_afno_grad_scratch(S, ...)
// floats.
extern "C" int mt_afno_mixer_grad(const void* x, const void* y, const void* dy, const void* h, const void* w1, const void* w2, const long long* wst, void* dx,
                                  void* g1, void* dw1, void* db1, void* dw2, void* db2, void* scratch, int S, int B, int M, int Wh, int nb, int bs, int hbs,
                                  long long sB, long long sM, long long sC, int ra0, int ra1, int rb0, int rb1, int kc, void* stream) {
  if (B <= 0 || B > 65535 || M <= 0 || Wh <= 0 || M % Wh || nb <= 0 || nb > 65535 || bs <= 0 || hbs <= 0 || S <= 0 || 2LL * S > 65535 || wst == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((db1 == nullptr) != (db2 == nullptr)) return (int)cudaErrorInvalidValue;
  const int threads = afno::tile_threads(hbs, bs);
  if (threads > afno::MAX_THREADS) return (int)cudaErrorInvalidConfiguration;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(h) |
                         reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(g1);
  if (ptrs % 8 || (sB | sM | sC) % 2) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout L{sB, sM, sC};
  const Band band{ra0, ra1, rb0, rb1, kc};
  const afno::Params wp = afno::params_from(wst);

  const size_t smem = afno::tile_smem_bytes(bs, hbs);
  static size_t opted = 0;
  if (smem > 48 * 1024 && smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(afno_grad_data_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  afno_grad_data_kernel<<<dim3((M + TM - 1) / TM, nb, B), threads, smem, st>>>(
      static_cast<const float*>(dy), static_cast<const float*>(y), static_cast<const float*>(h), static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<float*>(dx), static_cast<float*>(g1), L, wp, M, Wh, nb, bs, hbs, band);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // the canonical (B, nb, M, hbs, 2) layout of o1 and g1
  const long long hB = (long long)nb * M * hbs * 2, hK = (long long)M * hbs * 2;
  float* part = static_cast<float*>(scratch);
  const long long nw = (long long)nb * 2 * bs * hbs, nb1 = (long long)nb * 2 * hbs, nb2 = (long long)nb * 2 * bs;
  const bool bias = db1 != nullptr;
  WeightArgs a;
  a.a[0] = Operand{static_cast<const float*>(x), nullptr, sB, sM, (long long)bs * sC, sC};
  a.g[0] = Operand{static_cast<const float*>(g1), nullptr, hB, 2LL * hbs, hK, 2};
  a.ka[0] = bs, a.kg[0] = hbs;
  a.a[1] = Operand{static_cast<const float*>(h), nullptr, hB, 2LL * hbs, hK, 2};
  a.g[1] = Operand{static_cast<const float*>(dy), static_cast<const float*>(y), sB, sM, (long long)bs * sC, sC};
  a.ka[1] = hbs, a.kg[1] = bs;
  a.pw[0] = part;
  a.pw[1] = part + S * nw;
  a.pb[0] = bias ? part + 2 * S * nw : nullptr;
  a.pb[1] = bias ? part + 2 * S * nw + S * nb1 : nullptr;
  const int tiles = ((bs + 31) / 32) * ((hbs + 31) / 32);
  afno_grad_weight_kernel<<<dim3(tiles, nb, 2 * S), WTHREADS, 0, st>>>(a, M, (long long)B * M, nb, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long n = 2 * nw + (bias ? nb1 + nb2 : 0);
  const ReduceOut r1{a.pw[0], static_cast<float*>(dw1), nw, bs, hbs, wp.w1}, r2{a.pw[1], static_cast<float*>(dw2), nw, hbs, bs, wp.w2};
  const ReduceOut r3{a.pb[0], static_cast<float*>(db1), bias ? nb1 : 0, 1, hbs, wp.b1}, r4{a.pb[1], static_cast<float*>(db2), bias ? nb2 : 0, 1, bs, wp.b2};
  afno_grad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(r1, r2, r3, r4, S);
  return (int)cudaGetLastError();
}
