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
//   1. the data pass: afno.cuh's mode-tile kernel in its DATA_GRAD mode, K18's
//      machinery on dy masked by y, W2 transposed and conjugated, the relu's
//      mask from o1 (g1, which goes to device memory for the weight pass), then
//      W1 transposed and conjugated: dx.
//   2. the weight pass (afno_grad_weight_kernel): each weight gradient of a
//      channel block is a real GEMM whose rows are the input channels i, whose
//      columns are the output channels' (o, re/im), interleaved, and whose
//      depth is the modes' (m, re/im): conj(a) (x) g, conj(a) the A operand
//      and g's 2x2 blocks [[gr, gi], [-gi, gr]] the B operand. A block takes
//      128 rows (two warpgroups of 64) and 48 output channels (wgmma
//      m64n96k8, 3xTF32 as K9) over one of S fixed, contiguous ranges of the
//      B M modes, 16 modes a stage, into its own partial.
//   3. afno_grad_reduce: each output element sums its S partials in order and
//      writes the parameter's layout.
//
// So a step repeats bit for bit. o1 is read, not recomputed: K18 writes it
// (B nb M hbs complex, the size of x) when the forward is to be
// differentiated.
//
// What bounds it on the card: the operations, twice K18's (four complex
// products of the same size). At afno_73ch (B 1, 90 x 91 modes, C 768, nb 8,
// bs 96) 19.3 GFLOP against ~352 MB (x, y, dy, o1 read, g1 and dx written,
// g1 read again by the weight pass): 0.288 ms on the fp32 FMA pipes, 0.117 ms
// in 3xTF32.
//
// The weight pass, built like K9 (dhconv_grad.cu). Neither operand of conj(a)
// (x) g is K-major in the depth (the modes): x, o1, g1, dy keep their
// channels apart and, in the rFFT's storage and in o1's and g1's (B, nb, hbs,
// M, 2), each channel's modes contiguous. So a's tile is staged as it lies
// (rows i, 16 modes each, padded so that a half warp's 8-byte fragment loads
// hit distinct banks) and read into registers as the A operand with K9's depth
// order: k = t <-> (mode 4 s + t, re), k = 4 + t <-> (mode 4 s + t, im), so
// the fragment (row i, k t | k t + 4) is a's (re, im) pair at (mode, i), its
// im part negated (conj(a)). g's tile is staged as it lies too and each
// thread expands one output channel at four modes into its two columns' TF32
// high and low planes in the 128-byte swizzle (afno.cuh store_blocks, as K18
// expands a weight), masking dy by y on the way (g2); the bias's sums come
// from the same values. The copies are cp.async, 8 bytes an element (the only
// alignment every stride set guarantees), a ring of three stages; each
// thread copies one mode offset of every row it stages and carries that mode's
// (b, m) from stage to stage (no division in the copies' path).
//
// What holds it above its bound: as in K18, each stage's fixed work. The
// weight pass keeps ~40% of its time with its wgmmas, copies and expansion
// all cut out (two barriers, the fragments' splits and the partial sums of each
// of a block's 128 stages of 16 modes at afno_73ch), and its rows are 96 of
// the tile's 128 there (sweep_k18_k19.py, PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "afno.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;

// One operand of a weight-gradient sum: element (row q = b * M + m, column c)
// of channel block k at p + b * sB + m * sM + k * sK + c * sC
struct Operand {
  const float* p;
  long long sB, sM, sK, sC;
};

constexpr int WROWS = 128;           // rows i a block: two warpgroups of 64
constexpr int WCH = afno::PIECE;     // output channels o a block: 96 real columns
constexpr int NS = 16;               // modes a stage: 32 real depth, four k8 steps
constexpr int WTHREADS = 256;
constexpr int RING = 3;              // stages of the copies in flight: two ahead
constexpr int LDA = 2 * NS + 8;      // floats a staged row of a: 40, 8 mod 32
constexpr int LDG = 2 * NS + 4;      // floats a staged row of g (and its mask): 36, 4 mod 32
constexpr int A_BYTES = WROWS * LDA * 4;
constexpr int G_BYTES = WCH * LDG * 4;
constexpr int STAGE = A_BYTES + 2 * G_BYTES;  // a, g and g's mask
constexpr int WSMEM = 2 * afno::SLOT + RING * STAGE + 4 * WCH * 2 * 4;
static_assert(WSMEM <= afno::SMEM_MAX, "the weight pass's ring does not fit");
static_assert(WTHREADS / NS == 16 && WROWS % 16 == 0 && WCH % 16 == 0, "a thread's staged rows are 16 apart");

// grid (tiles, nb, 2 S): blockIdx.z = which * S + s. which 0: dW1 (a: x, bs
// rows; g: g1, hbs channels); which 1: dW2 (a: o1, hbs; g: dy masked by y,
// bs). Partial (s, k, i, o, re/im) of each into pw[which], the bias's (s, k,
// o, re/im) into pb[which] (when pb[which] is not null).
struct WeightArgs {
  Operand a[2], g[2], mask[2];
  int ka[2], kg[2];
  float* pw[2];
  float* pb[2];
};

__global__ void __launch_bounds__(WTHREADS, 1) afno_grad_weight_kernel(WeightArgs args, int M, long long R, int nb, int S) {
  extern __shared__ __align__(1024) unsigned char smem[];
  // g's expanded blocks (two stages, 1024-byte aligned), then the copy ring,
  // then the bias's partial sums
  auto slot_a = [&](int kt) { return reinterpret_cast<float*>(smem + 2 * afno::SLOT + (kt % RING) * STAGE); };
  auto slot_g = [&](int kt) { return reinterpret_cast<float*>(smem + 2 * afno::SLOT + (kt % RING) * STAGE + A_BYTES); };
  auto slot_m = [&](int kt) { return reinterpret_cast<float*>(smem + 2 * afno::SLOT + (kt % RING) * STAGE + A_BYTES + G_BYTES); };
  float* bias_red = reinterpret_cast<float*>(smem + 2 * afno::SLOT + RING * STAGE);

  const int which = blockIdx.z / S, s = blockIdx.z - which * S, k = blockIdx.y;
  const int KA = args.ka[which], KG = args.kg[which];
  const int ntc = (KG + WCH - 1) / WCH;
  const int tiles = (KA + WROWS - 1) / WROWS * ntc;
  if ((int)blockIdx.x >= tiles) return;
  const int i0 = blockIdx.x / ntc * WROWS, o0 = blockIdx.x % ntc * WCH;
  const Operand A = args.a[which], G = args.g[which], Mk = args.mask[which];
  const bool masked = Mk.p != nullptr;
  const long long q_lo = R * s / S, q_hi = R * (s + 1) / S;
  const int nt = (int)((q_hi - q_lo + NS - 1) / NS);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* pb = args.pb[which];
  const bool bias = pb != nullptr && i0 == 0;

  // copies: this thread stages mode n of each stage, rows r0 + 16 e; its
  // mode's (b, m) and depth index q advance by NS a stage
  const int n = tid % NS, r0 = tid / NS;
  long long q = q_lo + n;
  int cb = (int)(q / M), cm = (int)(q - (long long)cb * M);
  const float* a_row = A.p + k * A.sK + (long long)(i0 + r0) * A.sC;
  const float* g_row = G.p + k * G.sK + (long long)(o0 + r0) * G.sC;
  const float* m_row = masked ? Mk.p + k * Mk.sK + (long long)(o0 + r0) * Mk.sC : nullptr;
  // this thread's rows below the tile's edge: r0 + 16 e for e < na (a), ng (g)
  const int na = min(WROWS / 16, max(0, (KA - i0 - r0 + 15) / 16)), ng = min(WCH / 16, max(0, (KG - o0 - r0 + 15) / 16));
  auto issue = [&](int kt) {
    const bool ok = q < q_hi;
    float* da = slot_a(kt) + r0 * LDA + 2 * n;
    float* dg = slot_g(kt) + r0 * LDG + 2 * n;
    float* dm = slot_m(kt) + r0 * LDG + 2 * n;
    const float* pa = a_row + (cb * A.sB + cm * A.sM);
    const float* pg = g_row + (cb * G.sB + cm * G.sM);
#pragma unroll
    for (int e = 0; e < WROWS / 16; ++e, pa += 16 * A.sC) {
      const bool v = ok && e < na;
      cp_async<8>(da + 16 * e * LDA, v ? pa : A.p, v);
    }
#pragma unroll
    for (int e = 0; e < WCH / 16; ++e, pg += 16 * G.sC) {
      const bool v = ok && e < ng;
      cp_async<8>(dg + 16 * e * LDG, v ? pg : G.p, v);
    }
    if (masked) {
      const float* pm = m_row + (cb * Mk.sB + cm * Mk.sM);
#pragma unroll
      for (int e = 0; e < WCH / 16; ++e, pm += 16 * Mk.sC) {
        const bool v = ok && e < ng;
        cp_async<8>(dm + 16 * e * LDG, v ? pm : Mk.p, v);
      }
    }
    cp_async_commit();
    q += NS;
    cm += NS;
    while (cm >= M) {
      cm -= M;
      ++cb;
    }
  };

  // g's blocks of stage kt: this thread's output channel go at modes 4 gs ..
  // 4 gs + 3, columns 2 go (dW's re) and 2 go + 1 (im): (re depth, im depth)
  // = (gr, -gi) and (gi, gr) against conj(a)'s (ar, -ai); the bias's sums of
  // the same values
  const int go = tid % WCH, gs = tid / WCH;
  const bool expander = tid < 4 * WCH;
  float bsr = 0.f, bsi = 0.f;
  auto expand = [&](int kt) {
    if (expander) {
      const float* src = slot_g(kt) + go * LDG + 8 * gs;
      const float4 v0 = *reinterpret_cast<const float4*>(src), v1 = *reinterpret_cast<const float4*>(src + 4);
      float gr[4] = {v0.x, v0.z, v1.x, v1.z}, gi[4] = {v0.y, v0.w, v1.y, v1.w};
      if (masked) {
        const float* msrc = slot_m(kt) + go * LDG + 8 * gs;
        const float4 u0 = *reinterpret_cast<const float4*>(msrc), u1 = *reinterpret_cast<const float4*>(msrc + 4);
        const float mr[4] = {u0.x, u0.z, u1.x, u1.z}, mi[4] = {u0.y, u0.w, u1.y, u1.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          gr[u] = mr[u] != 0.f ? gr[u] : 0.f;
          gi[u] = mi[u] != 0.f ? gi[u] : 0.f;
        }
      }
      uint32_t rh[4], rl[4], ih[4], il[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        afno::split(gr[u], rh[u], rl[u]);
        afno::split(gi[u], ih[u], il[u]);
        bsr += gr[u];
        bsi += gi[u];
      }
      afno::store_blocks(smem + (kt & 1) * afno::SLOT, go, gs, rh, rl, ih, il);
    }
    fence_proxy_async();
  };

  float acc[afno::ACC], part[afno::ACC];
#pragma unroll
  for (int j = 0; j < afno::ACC; ++j) acc[j] = part[j] = 0.f;

  const int row0 = (warp / 4) * 64 + (warp % 4) * 16;  // this warp's 16 rows of the tile
  const int gq = lane / 4, tq = lane % 4;
  for (int st = 0; st < RING - 1; ++st) issue(st);
  cp_async_wait<RING - 2>();
  __syncthreads();
  expand(0);
  __syncthreads();
  for (int kt = 0; kt < nt; ++kt) {
    // the slot refilled here was last read before the previous barrier
    issue(kt + RING - 1);
    // this stage's a fragments: k8 step ks, (row i, k tq | k tq + 4) =
    // conj(a)'s (re, im) at mode 4 ks + tq
    const float* as = slot_a(kt) + (row0 + gq) * LDA;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float2 p0 = *reinterpret_cast<const float2*>(as + 2 * (4 * ks + tq));
      const float2 p1 = *reinterpret_cast<const float2*>(as + 8 * LDA + 2 * (4 * ks + tq));
      const float v[4] = {p0.x, p1.x, -p0.y, -p1.y};
#pragma unroll
      for (int u = 0; u < 4; ++u) afno::split(v[u], ah[ks][u], al[ks][u]);
    }
    const uint32_t base = smem_addr(smem + (kt & 1) * afno::SLOT);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t bh = afno::b_desc(base, ks), bl = afno::b_desc(base + afno::PLANE, ks);
      afno::wgmma_n96(part, al[ks], bh, ks > 0);
      afno::wgmma_n96(part, ah[ks], bl, 1);
      afno::wgmma_n96(part, ah[ks], bh, 1);
    }
    wgmma_commit();
    // the next stage's blocks, while the wgmmas run: its copies landed
    // (this thread's, then everyone's past the barrier)
    if (kt + 1 < nt) {
      cp_async_wait<RING - 2>();
      __syncthreads();
      expand(kt + 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        pin(ah[ks][u]);
        pin(al[ks][u]);
      }
#pragma unroll
    for (int j = 0; j < afno::ACC; ++j) {
      pin(part[j]);
      acc[j] += part[j];
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // accumulator j: row gq (+8 for j % 4 >= 2), column (j / 4) * 8 + 2 tq
  // (+1 for odd j): output channel o0 + 4 (j / 4) + tq's (re, im)
  float* pw = args.pw[which] + ((long long)s * nb + k) * KA * KG * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + row0 + gq + 8 * h;
    if (i >= KA) continue;
#pragma unroll
    for (int c = 0; c < afno::ACC / 4; ++c) {
      const int o = o0 + 4 * c + tq;
      if (o < KG) *reinterpret_cast<float2*>(pw + ((long long)i * KG + o) * 2) = make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
    }
  }
  if (bias) {
    if (expander) {
      bias_red[(gs * WCH + go) * 2] = bsr;
      bias_red[(gs * WCH + go) * 2 + 1] = bsi;
    }
    __syncthreads();
    if (tid < WCH && o0 + tid < KG) {
      float sr = 0.f, si = 0.f;
      for (int u = 0; u < 4; ++u) {
        sr += bias_red[(u * WCH + tid) * 2];
        si += bias_red[(u * WCH + tid) * 2 + 1];
      }
      *reinterpret_cast<float2*>(pb + (((long long)s * nb + k) * KG + o0 + tid) * 2) = make_float2(sr, si);
    }
  }
}

// One output of the reduction: its S partials, each n = nb * rows * cols * 2
// floats in the order (k, r, c, p), and the output in its parameter's layout.
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
  const long long p = e % 2, rest = e / 2, c = rest % o.cols, kr = rest / o.cols, r = kr % o.rows, k = kr / o.rows;
  o.out[o.at.at(k, p, r, c)] = acc;
}

}  // namespace

// Floats of the scratch buffer K19 needs with S mode ranges (the partials).
extern "C" long long mt_afno_grad_scratch(int S, int nb, int bs, int hbs, int bias) {
  const long long w = 2LL * nb * 2 * bs * hbs, b = bias ? (long long)nb * 2 * (bs + hbs) : 0;
  return (long long)S * (w + b);
}

// K19. x, y, dx: fp32 spectra with strides (sB, sM, sC) (K18's layout); dy
// with its own strides (dB, dM, dC); h: K18's o1, fp32 (B, nb, hbs, M, 2)
// (afno.cuh hidden_at); g1: a buffer of h's size (written); w1 (nb, 2, bs,
// hbs), w2 (nb, 2, hbs, bs) as K18 takes them, with the 16 strides wst
// (afno.cuh Params: w1, w2, b1, b2); dw1, dw2 of their shapes and layouts,
// db1 (nb, 2, hbs) and db2 (nb, 2, bs) in the biases' layouts (null without
// biases) written; scratch: mt_afno_grad_scratch(S, ...) floats.
extern "C" int mt_afno_mixer_grad(const void* x, const void* y, const void* dy, const void* h, const void* w1, const void* w2, const long long* wst, void* dx,
                                  void* g1, void* dw1, void* db1, void* dw2, void* db2, void* scratch, int S, int B, int M, int Wh, int nb, int bs, int hbs,
                                  long long sB, long long sM, long long sC, long long dB, long long dM, long long dC, int ra0, int ra1, int rb0, int rb1, int kc,
                                  void* stream) {
  if (B <= 0 || B > 65535 || M <= 0 || Wh <= 0 || M % Wh || nb <= 0 || nb > 65535 || bs <= 0 || hbs <= 0 || S <= 0 || 2LL * S > 65535 || wst == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((db1 == nullptr) != (db2 == nullptr)) return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(h) |
                         reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(g1) | reinterpret_cast<uintptr_t>(dw1) | reinterpret_cast<uintptr_t>(dw2) |
                         reinterpret_cast<uintptr_t>(scratch);
  if (ptrs % 8 || (sB | sM | sC | dB | dM | dC) % 2) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const afno::Layout L{sB, sM, sC}, Ld{dB, dM, dC};
  const afno::Params wp = afno::params_from(wst);

  const afno::TileArgs t{static_cast<const float*>(dy), static_cast<const float*>(y), static_cast<const float*>(h), static_cast<float*>(g1), static_cast<float*>(dx),
                         static_cast<const float*>(w1), static_cast<const float*>(w2), nullptr, nullptr, Ld, L, L, wp};
  int err = afno::launch_tile<afno::DATA_GRAD>(t, B, M, Wh, nb, bs, hbs, afno::Band{ra0, ra1, rb0, rb1, kc}, 0.f, st);
  if (err != 0) return err;

  // o1's and g1's (B, nb, hbs, M, 2) layout
  const long long hB = (long long)nb * hbs * M * 2, hK = (long long)hbs * M * 2, hC = 2LL * M;
  float* part = static_cast<float*>(scratch);
  const long long nw = (long long)nb * 2 * bs * hbs, nb1 = (long long)nb * 2 * hbs, nb2 = (long long)nb * 2 * bs;
  const bool bias = db1 != nullptr;
  WeightArgs a;
  a.a[0] = Operand{static_cast<const float*>(x), sB, sM, (long long)bs * sC, sC};
  a.g[0] = Operand{static_cast<const float*>(g1), hB, 2, hK, hC};
  a.mask[0] = Operand{nullptr, 0, 0, 0, 0};
  a.ka[0] = bs, a.kg[0] = hbs;
  a.a[1] = Operand{static_cast<const float*>(h), hB, 2, hK, hC};
  a.g[1] = Operand{static_cast<const float*>(dy), dB, dM, (long long)bs * dC, dC};
  a.mask[1] = Operand{static_cast<const float*>(y), sB, sM, (long long)bs * sC, sC};
  a.ka[1] = hbs, a.kg[1] = bs;
  a.pw[0] = part;
  a.pw[1] = part + S * nw;
  a.pb[0] = bias ? part + 2 * S * nw : nullptr;
  a.pb[1] = bias ? part + 2 * S * nw + S * nb1 : nullptr;
  const int t0 = (bs + WROWS - 1) / WROWS * ((hbs + WCH - 1) / WCH), t1 = (hbs + WROWS - 1) / WROWS * ((bs + WCH - 1) / WCH);
  cudaError_t e = cudaFuncSetAttribute(afno_grad_weight_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WSMEM);
  if (e != cudaSuccess) return (int)e;
  afno_grad_weight_kernel<<<dim3(t0 > t1 ? t0 : t1, nb, 2 * S), WTHREADS, WSMEM, st>>>(a, M, (long long)B * M, nb, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long n = 2 * nw + (bias ? nb1 + nb2 : 0);
  const ReduceOut r1{a.pw[0], static_cast<float*>(dw1), nw, bs, hbs, wp.w1}, r2{a.pw[1], static_cast<float*>(dw2), nw, hbs, bs, wp.w2};
  const ReduceOut r3{a.pb[0], static_cast<float*>(db1), bias ? nb1 : 0, 1, hbs, wp.b1}, r4{a.pb[1], static_cast<float*>(db2), bias ? nb2 : 0, 1, bs, wp.b2};
  afno_grad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(r1, r2, r3, r4, S);
  return (int)cudaGetLastError();
}
