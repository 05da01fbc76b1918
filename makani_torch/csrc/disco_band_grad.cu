// The transpose of the banded DISCO contraction: kernel K12 of makani_torch.
//
// Replaces the VJP with respect to x of makani_tpu/ops/disco.py
// DiscoConvS2.__call__ (:638, its banded part) and of the weight-fused
// DiscoConvS2.fused (:739), which JAX derives as the transposed grouped
// convolution: the gradient of K5 (disco_band.cu). K5 computes
//
//   out[b, h, p + phases*u, g, o] = sum_{i, j, w} F[h, g % Gf, i, j, w, o]
//                                   * x[b, band_start[h] + j, (off + u*a + w) mod Win, g*IG + i]
//
// and this kernel its transpose, for one phase p:
//
//   dx[b, hi, wi, g*IG + i] (+)= sum_{h in rows(hi)} sum_{w live at (h, j)} sum_o
//                                F[h, g % Gf, i, j, w, o] * dout[b, h, p + phases*u, g*OG + o]
//
// with j = hi - band_start[h] and u the one output column whose window puts
// tap w on column wi: u*a = (wi - off - w) mod Win, kept where a divides it
// and u < n_out. Responses mode (the processor) is IG = 1, Gf = 1, OG = K;
// fused mode (the decoders) the filter w (x) psi of FusedFilterCache.
//
// It is a gather: no atomics, one thread a (b, hi, wi, channel), its sum in
// a fixed order, and the phases in turn (``accumulate`` adds a later phase
// to the earlier ones' result). The wrapper builds rows(hi) on the host
// (a CSR list of the output latitudes whose band covers input row hi with a
// live tap there), and the kernel walks the live runs [lo, hi) of
// ``live_tap_runs`` as K5 does, so the polar rows (psi zeroed: no live tap)
// send nothing back: their responses are exactly 0 and the polar path
// carries their gradient. dout is read through its pixel stride sO, so the
// processor's response rows padded to a multiple of 4 floats are read in
// place and their pad never as data.
//
// The block: 32 consecutive channels (a warp's lanes) x 32 consecutive input
// columns (8 warps, 4 columns a thread) of one input row. A warp reads the
// OG contiguous floats of 32 consecutive channels of one output pixel per
// tap (1152 bytes at the processor); the warps of the block read the
// neighbouring output columns, so most of dout comes from L1.
//
// What bounds it on the card: at the processor (B 4, 180 x 360, C 677, K 9,
// 60.7 live taps a latitude) it does 0.19 TFLOP of fp32 FMAs (2.9 ms at
// 67 TFLOP/s) and must read 6.3 GB of dout and write 0.7 GB (2.1 ms at 3.35
// TB/s); every dout element is read once per live tap that reaches it, so
// this simple form leans on L1 and L2. Staging dout tiles in shared memory
// and tensor cores are later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CT = 32;           // channels a block: one per lane
constexpr int QPT = 4;           // input columns a thread
constexpr int WT = 8 * QPT;      // input columns a block

struct Params {
  long long sO;  // dout: floats between pixels
  int Hin, Win, Hout, Wout, C, Gf, IG, OG, OGp, BL, WW, a, off, n_out, phase, phases, accumulate, n_ct;
};

template <int OT>
__global__ void __launch_bounds__(THREADS)
    disco_band_grad_kernel(const float* __restrict__ dout, const float* __restrict__ F, const int* __restrict__ band_start,
                           const int* __restrict__ taps, const int* __restrict__ row_ptr, const int* __restrict__ row_h, float* __restrict__ dx,
                           Params p) {
  const int OG = OT > 0 ? OT : p.OG;
  const int ct = blockIdx.x % p.n_ct, wt = blockIdx.x / p.n_ct;
  const int hi = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ch = ct * CT + lane;
  const bool live_ch = ch < p.C;
  const int g = (live_ch ? ch : 0) / p.IG, i = (live_ch ? ch : 0) % p.IG, gf = g % p.Gf;
  int wi[QPT];
#pragma unroll
  for (int q = 0; q < QPT; ++q) wi[q] = wt * WT + warp + 8 * q;
  float acc[QPT];
#pragma unroll
  for (int q = 0; q < QPT; ++q) acc[q] = 0.f;

  const int r0 = row_ptr[hi], r1 = row_ptr[hi + 1];
  if (live_ch) {
    for (int r = r0; r < r1; ++r) {
      const int h = row_h[r], j = hi - band_start[h];
      const int lo = taps[(h * p.BL + j) * 2], hi_w = taps[(h * p.BL + j) * 2 + 1];
      const float* Fj = F + ((((long long)h * p.Gf + gf) * p.IG + i) * p.BL + j) * p.WW * p.OGp;
      const float* dh = dout + (long long)(b * p.Hout + h) * p.Wout * p.sO + (long long)g * OG;
      for (int w = lo; w < hi_w; ++w) {
        const float* fw = Fj + w * p.OGp;
#pragma unroll
        for (int q = 0; q < QPT; ++q) {
          if (wi[q] >= p.Win) continue;
          int d = (wi[q] - p.off - w) % p.Win;
          if (d < 0) d += p.Win;
          const int u = d / p.a;
          if (u * p.a != d || u >= p.n_out) continue;
          const float* src = dh + (long long)(p.phase + p.phases * u) * p.sO;
          float s = acc[q];
          if constexpr (OT > 0) {
#pragma unroll
            for (int o = 0; o < OT; ++o) s = fmaf(fw[o], src[o], s);
          } else {
            for (int o = 0; o < OG; ++o) s = fmaf(fw[o], src[o], s);
          }
          acc[q] = s;
        }
      }
    }
  }
  if (!live_ch) return;
#pragma unroll
  for (int q = 0; q < QPT; ++q) {
    if (wi[q] >= p.Win) continue;
    float* dst = dx + (((long long)b * p.Hin + hi) * p.Win + wi[q]) * p.C + ch;
    *dst = p.accumulate ? *dst + acc[q] : acc[q];
  }
}

template <int OT>
int launch(const float* dout, const float* F, const int* bs, const int* taps, const int* rp, const int* rh, float* dx, Params p, int B,
           cudaStream_t s) {
  const long long nx = (long long)p.n_ct * ((p.Win + WT - 1) / WT);
  if (nx > 2147483647LL) return (int)cudaErrorInvalidValue;
  disco_band_grad_kernel<OT><<<dim3((unsigned)nx, p.Hin, B), THREADS, 0, s>>>(dout, F, bs, taps, rp, rh, dx, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dout: float32 (B, Hout, Wout, G*OG), contiguous but for sO >= G*OG floats
// between pixels; F: float32 (Hout, Gf, IG, BL, WW, OGp) contiguous (K5's
// filter); band_start: int32 (Hout,); taps: int32 (Hout, BL, 2), K5's live
// runs; row_ptr: int32 (Hin + 1,) and row_h: int32, for each input row the
// output latitudes with a live tap on it; dx: float32 (B, Hin, Win, G*IG)
// contiguous, written (accumulate 0) or added to (accumulate 1). Returns
// cudaGetLastError() after the launch, or an argument error.
extern "C" int mt_disco_band_grad(const void* dout, const void* F, const void* band_start, const void* taps, const void* row_ptr, const void* row_h,
                                  void* dx, int B, int Hin, int Win, int Hout, int Wout, int C, int Gf, int IG, int OG, int OGp, int BL, int WW,
                                  int a, int off, int n_out, int phase, int phases, long long sO, int accumulate, void* stream) {
  if (B <= 0 || B > 65535 || Hin <= 0 || Hin > 65535 || Win <= 0 || Hout <= 0 || C <= 0 || IG <= 0 || C % IG || Gf <= 0 || (C / IG) % Gf ||
      OG <= 0 || OGp < OG || BL <= 0 || WW <= 0 || a <= 0 || n_out <= 0 || phases <= 0 || phase < 0 || phase >= phases ||
      phase + phases * (n_out - 1) >= Wout || sO < (long long)(C / IG) * OG)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.sO = sO;
  p.Hin = Hin, p.Win = Win, p.Hout = Hout, p.Wout = Wout, p.C = C, p.Gf = Gf, p.IG = IG, p.OG = OG, p.OGp = OGp, p.BL = BL, p.WW = WW;
  p.a = a, p.off = off, p.n_out = n_out, p.phase = phase, p.phases = phases, p.accumulate = accumulate;
  p.n_ct = (C + CT - 1) / CT;
  const float* d = static_cast<const float*>(dout);
  const float* f = static_cast<const float*>(F);
  const int* bs = static_cast<const int*>(band_start);
  const int* tp = static_cast<const int*>(taps);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* rh = static_cast<const int*>(row_h);
  float* o = static_cast<float*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (OG == 9) return launch<9>(d, f, bs, tp, rp, rh, o, p, B, s);
  if (OG == 1) return launch<1>(d, f, bs, tp, rp, rh, o, p, B, s);
  return launch<0>(d, f, bs, tp, rp, rh, o, p, B, s);
}
