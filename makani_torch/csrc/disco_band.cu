// Banded DISCO contraction: kernel K5 of makani_torch.
//
// Replaces scripts/r3/disco_pallas.py pallas_band_contract (the repository's
// one Pallas kernel) and the XLA grouped convolution that computes the same
// function in makani_tpu/ops/disco.py (DiscoConvS2.__call__ and the
// weight-fused DiscoConvS2.fused):
//
//   out[b, h, wo, g, o] = sum_{i, j, w} F[h, g % Gf, i, j, w, o]
//                         * x[b, band_start[h] + j, (off + u*a + w) mod Win, g*IG + i]
//
// with wo = phase + phases*u, u < n_out. Responses mode (the processor's
// two-stage conv) is G = C channels, IG = 1, OG = K basis functions and one
// filter shared by all channels (Gf = 1, F = psi). Fused mode (encoders and
// decoders) is F = w (x) psi, contracted once per weight version by the
// wrapper; Gf < G repeats the Gf filters over the channel axis (the JAX
// package's fold of the pressure levels into the batch).
//
// x is read through arbitrary element strides (channels-last or NCHW alike);
// out is channels-last (B, Hout, Wout, G*OG), the layout the processor's
// channel-mix GEMM and the surrounding channels-last layers read. Phases
// (b > 1, when nlon_out/nlon_in is not 1/a) write their interleaved columns
// directly: no stack/reshape copy.
//
// What bounds it on the card: at the FCN3 processor (B 2, 360x720, C 677,
// K 9, BL 9, WW 31) the dense window is ~0.9 TFLOP of fp32 FMAs (about 40%
// of the taps are inside the disc) against ~1.4 GB read and 12.6 GB written,
// so it is bound by arithmetic. This version runs on the fp32 FMA pipes:
// a 128-thread block stages, one input channel of each group at a time, the
// F slice of its output latitude and the band window of 8 groups x 128
// output columns in shared memory, and every thread holds 8 columns x OT
// outputs of one group in registers: OT = 9 gives 72 FMAs per 10 shared
// loads (the window slides through registers for stride 1; the F values are
// broadcasts). Every output sums its taps in (i, j, w) order. Skipping psi's
// zero taps, tensor cores (TF32 wgmma) and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int TG = 8;                // groups per block
constexpr int NU = 16;               // column chunks per block
constexpr int UT = 8;                // output columns per thread
constexpr int TU = NU * UT;          // output columns per block
constexpr int THREADS = TG * NU;     // 128
constexpr int TGP = TG + 1;          // padded group stride in shared memory

struct Params {
  long long sB, sH, sW, sC;  // x strides, elements
  int Hin, Win, Hout, Wout;
  int G, Gf, IG, OG, OGp, BL, WW;
  int a, off, n_out, phase, phases;
  int n_utiles, n_gtiles, cols, col_fast;
};

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }

template <int OT, bool A1>
__global__ void __launch_bounds__(THREADS)
    disco_band_kernel(const float* __restrict__ x, const float* __restrict__ F, const int* __restrict__ band_start, float* __restrict__ out, Params p) {
  extern __shared__ float smem[];
  int bid = blockIdx.x;
  const int ut = bid % p.n_utiles;
  bid /= p.n_utiles;
  const int h = bid % p.Hout;
  const int b = bid / p.Hout;
  const int gt = blockIdx.y % p.n_gtiles;
  const int oc = blockIdx.y / p.n_gtiles;
  const int u0 = ut * TU;
  const int g0 = gt * TG;
  const int tid = threadIdx.x;
  const int tg = tid % TG;
  const int nu = tid / TG;
  const int cols = p.cols;
  const int per_i = p.BL * p.WW * OT;  // F values per (gf, i)
  const int nF = p.Gf * per_i;
  float* Fs = smem;                     // (Gf, BL, WW, OT) of one input channel i
  float* Xs = smem + round_up4(nF);     // (BL, cols, TGP)

  // this latitude's filter for output chunk oc
  const float* Fh = F + (long long)h * p.Gf * p.IG * p.BL * p.WW * p.OGp + oc * OT;

  const int g = g0 + tg;
  const bool g_ok = g < p.G;
  const int gf = g_ok ? g % p.Gf : 0;
  const int row0 = band_start[h];
  const int col0 = p.off + u0 * p.a;
  const float* xb = x + (long long)b * p.sB;

  float acc[OT][UT];
#pragma unroll
  for (int o = 0; o < OT; ++o)
#pragma unroll
    for (int q = 0; q < UT; ++q) acc[o][q] = 0.f;

  for (int i = 0; i < p.IG; ++i) {
    __syncthreads();  // the previous channel's window and filter are no longer read
    // stage F[h, :, i, :, :, oc*OT ..] as (Gf, BL, WW, OT)
    for (int idx = tid; idx < nF; idx += THREADS) {
      const int e = idx / OT, gfi = e / (p.BL * p.WW), jw = e % (p.BL * p.WW);
      Fs[idx] = Fh[((long long)(gfi * p.IG + i) * p.BL * p.WW + jw) * p.OGp + idx % OT];
    }
    // stage the band window of channel i of groups g0 .. g0+TG-1; the
    // fastest index follows the input's contiguous axis
    const int n = p.BL * cols * TG;
    for (int idx = tid; idx < n; idx += THREADS) {
      int j, col, t;
      if (p.col_fast) {
        col = idx % cols;
        t = (idx / cols) % TG;
        j = idx / (cols * TG);
      } else {
        t = idx % TG;
        col = (idx / TG) % cols;
        j = idx / (TG * cols);
      }
      float v = 0.f;
      if (g0 + t < p.G) {
        int wc = (col0 + col) % p.Win;
        if (wc < 0) wc += p.Win;
        v = xb[(long long)(row0 + j) * p.sH + (long long)wc * p.sW + (long long)((g0 + t) * p.IG + i) * p.sC];
      }
      Xs[(j * cols + col) * TGP + t] = v;
    }
    __syncthreads();

    const float* Fi = Fs + gf * per_i;
    for (int j = 0; j < p.BL; ++j) {
      const float* Xj = Xs + j * cols * TGP + tg;
      const float* Fj = Fi + j * p.WW * OT;
      if (A1) {
        // stride 1: columns nu*UT + q + w; the window slides through registers
        float xr[UT];
#pragma unroll
        for (int q = 0; q < UT; ++q) xr[q] = Xj[(nu * UT + q) * TGP];
        for (int w = 0; w < p.WW; ++w) {
          float f[OT];
#pragma unroll
          for (int o = 0; o < OT; ++o) f[o] = Fj[w * OT + o];
#pragma unroll
          for (int o = 0; o < OT; ++o)
#pragma unroll
            for (int q = 0; q < UT; ++q) acc[o][q] = fmaf(f[o], xr[q], acc[o][q]);
#pragma unroll
          for (int q = 0; q < UT - 1; ++q) xr[q] = xr[q + 1];
          if (w + 1 < p.WW) xr[UT - 1] = Xj[(nu * UT + UT + w) * TGP];
        }
      } else {
        for (int w = 0; w < p.WW; ++w) {
          float f[OT];
#pragma unroll
          for (int o = 0; o < OT; ++o) f[o] = Fj[w * OT + o];
#pragma unroll
          for (int q = 0; q < UT; ++q) {
            const float xv = Xj[((nu * UT + q) * p.a + w) * TGP];
#pragma unroll
            for (int o = 0; o < OT; ++o) acc[o][q] = fmaf(f[o], xv, acc[o][q]);
          }
        }
      }
    }
  }

  if (!g_ok) return;
  const int Cout = p.G * p.OG;
#pragma unroll
  for (int q = 0; q < UT; ++q) {
    const int u = u0 + nu * UT + q;
    if (u >= p.n_out) continue;
    const int wo = p.phase + p.phases * u;
    float* dst = out + ((long long)(b * p.Hout + h) * p.Wout + wo) * Cout + g * p.OG + oc * OT;
#pragma unroll
    for (int o = 0; o < OT; ++o)
      if (oc * OT + o < p.OG) dst[o] = acc[o][q];
  }
}

template <int OT, bool A1>
int launch(const float* x, const float* F, const int* band_start, float* out, const Params& p, int B, cudaStream_t s) {
  const int nF = p.Gf * p.BL * p.WW * OT;
  const size_t smem = (size_t)(round_up4(nF) + p.BL * p.cols * TGP) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kern = disco_band_kernel<OT, A1>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nx = (long long)p.n_utiles * p.Hout * B;
  const int n_oc = p.OGp / OT;
  if (nx > 2147483647LL || (long long)p.n_gtiles * n_oc > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nx, p.n_gtiles * n_oc);
  kern<<<grid, THREADS, smem, s>>>(x, F, band_start, out, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x: float32, element strides (sB, sH, sW, sC) over (B, Hin, Win, G*IG);
// F: float32 (Hout, Gf, IG, BL, WW, OGp) contiguous, OGp = OG rounded up to
// the kernel's outputs per thread (1 for OG == 1, else a multiple of 9),
// zero-padded; band_start: int32 (Hout,); out: float32 (B, Hout, Wout, G*OG)
// contiguous. Returns cudaGetLastError() after the launch, or an argument
// error without launching.
extern "C" int mt_disco_band_contract(const void* x, const void* F, const void* band_start, void* out, int B, int Hin, int Win, long long sB,
                                      long long sH, long long sW, long long sC, int Hout, int Wout, int G, int Gf, int IG, int OG, int OGp, int BL,
                                      int WW, int a, int off, int n_out, int phase, int phases, void* stream) {
  if (B <= 0 || Hin <= 0 || Win <= 0 || Hout <= 0 || G <= 0 || Gf <= 0 || G % Gf || IG <= 0 || OG <= 0 || BL <= 0 || WW <= 0 || a <= 0 ||
      n_out <= 0 || phases <= 0 || phase < 0 || phase >= phases || phase + phases * (n_out - 1) >= Wout)
    return (int)cudaErrorInvalidValue;
  const int OT = OG == 1 ? 1 : 9;
  if (OGp % OT || OGp < OG || OGp - OG >= OT) return (int)cudaErrorInvalidValue;
  Params p;
  p.sB = sB, p.sH = sH, p.sW = sW, p.sC = sC;
  p.Hin = Hin, p.Win = Win, p.Hout = Hout, p.Wout = Wout;
  p.G = G, p.Gf = Gf, p.IG = IG, p.OG = OG, p.OGp = OGp, p.BL = BL, p.WW = WW;
  p.a = a, p.off = off, p.n_out = n_out, p.phase = phase, p.phases = phases;
  p.n_utiles = (n_out + TU - 1) / TU;
  p.n_gtiles = (G + TG - 1) / TG;
  p.cols = (TU - 1) * a + WW;
  p.col_fast = sC != 1 && sW == 1;
  const float* xf = static_cast<const float*>(x);
  const float* Ff = static_cast<const float*>(F);
  const int* bs = static_cast<const int*>(band_start);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (OT == 1) return a == 1 ? launch<1, true>(xf, Ff, bs, of, p, B, s) : launch<1, false>(xf, Ff, bs, of, p, B, s);
  return a == 1 ? launch<9, true>(xf, Ff, bs, of, p, B, s) : launch<9, false>(xf, Ff, bs, of, p, B, s);
}
