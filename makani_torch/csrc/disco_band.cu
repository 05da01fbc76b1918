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
// out is channels-last (B, Hout, Wout, G*OG), pixels sO >= G*OG floats
// apart: the layout the surrounding channels-last layers read (sO = G*OG),
// or the processor's response rows padded to a multiple of four floats, so
// that K8 (disco_mix.cu) reads them in 16-byte copies. Phases
// (b > 1, when nlon_out/nlon_in is not 1/a) write their interleaved columns
// directly: no stack/reshape copy.
//
// Live taps. Most of the (j, w) window lies outside the disc: at the FCN3
// processor (B 2, 360x720, C 677, K 9, BL 9, WW 31) 60.7 of its 279 taps
// per latitude hold a nonzero psi_k on average, and the 66 polar latitudes
// (computed by K6) none. The wrapper passes a tap table, (Hout, BL, 2) int32:
// for each (h, j) the one run [lo, hi) of w where some psi_k is nonzero
// (empty: lo = hi), built on the host from psi, which also bounds the
// support of the fused filter w (x) psi. The kernel stages and sums only
// those runs, in the dense kernel's (i, j, w) order, so every finite output
// is bit-equal to the dense sum (a skipped tap added fmaf(0, x, acc) = acc).
// A NaN or inf of x under a dead tap no longer reaches the output, and a
// latitude with no live tap writes +0 without reading x or F.
//
// What bounds it on the card: at the processor the live taps are ~0.38
// TFLOP of fp32 FMAs (5.6 ms at 67 TFLOP/s) against ~1.4 GB read and 12.6
// GB written (4.2 ms at 3.35 TB/s): both matter. A 256-thread block takes
// one output latitude, TG channels (32, a 128-byte piece of a channels-last
// row, when G >= 96; else 8) and one output-chunk oc, and walks every
// column tile of TU outputs of its latitude, so the live rows are found
// once (a ballot over the tap table) and the filter is staged once where
// IG = 1. Every thread holds one channel x UT columns x OT outputs in
// registers (OT = 9, UT = 6: 54 FMAs a tap for two broadcast 16-byte and
// one 4-byte filter loads and one window load; the window slides through
// registers for stride 1, two taps a pass; OT = 1, UT = 8). The live rows
// of every input channel i are copied in stages of a cp.async ring, one
// barrier a stage (32-channel tiles: four rows a stage, two buffers;
// 8-channel tiles: two rows, three buffers): each row's live column span
// only, in 4-byte copies (677-channel rows are only 4-byte aligned; each
// thread keeps one channel and steps along the columns). The filter of
// channel i is staged with its first rows (a ring where IG > 1). The
// output goes through shared memory, one column's TG*OG contiguous floats
// at a time, and leaves in 16-byte stores along (g, o) after a scalar head
// that reaches 16-byte alignment (G*OG is odd at the processor). Launch
// bounds give two blocks an SM: 125-127 registers and no spills (the ptxas
// lines that chip_smoke.py prints); 103 KB of shared memory a block at the
// processor, 66 KB at the decoders.
//
// What holds it back at the processor: the row copies and the FMAs with
// the stores each take a large part of the time and overlap only in part;
// 16-byte copies (pieces from the 16-byte boundary below a column's 32
// channels) gained little and were not kept. At the decoders (IG = 9,
// OG = 1) the copies dominate: one input channel of each group is a
// 4-byte gather at a stride of IG floats. Tensor cores (3xTF32 mma with
// N = K = 9 padded to 16) are later work.
//
// Wide bands. A cutoff taken from the spectral truncation (FCN3.1's lmax
// rule) gives bands of 25 to ~74 rows and windows of 75 to ~210 longitudes
// at 0.25 degrees: a latitude's whole filter (BL x WW x 12 floats a filter
// group, 327 KB at BL 49, WW 139) no longer fits in shared memory. The live
// rows are compacted 32 band rows a ballot, so any BL works, and a second
// layout (route 2) stages the filter with the rows: each stage of the ring
// carries, beside its ROWS input rows, those rows' live filter spans (all
// Gf filter groups of channel i), so the shared memory grows with
// ROWS x WW, not BL x WW. The sums keep the dense (i, j, w) order in both
// layouts, so finite outputs stay bit-equal to the plain version. The
// entry point takes the first layout (route 1) where BL <= 32 and two of its
// blocks fit on an SM (every FCN3 conv: 103 KB at the processor), else
// route 2 (at the FCN3.1 processor, BL 25, route 1 needs 219 KB, one block
// an SM, and took 49.4 ms against route 2's 45.9 on an H100 80GB HBM3 at
// 700 W, sweep_k5.py). mt_disco_band_route reports the route taken.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using sm90::cp_async;

constexpr int THREADS = 256;

struct Params {
  long long sB, sH, sW, sC;  // x strides, elements
  long long sO;              // out: elements between pixels
  int Hin, Win, Hout, Wout;
  int G, Gf, IG, OG, OGp, BL, WW;
  int a, off, n_out, phase, phases;
  int n_utiles, n_gtiles, n_oc, col_fast;
  int xcols;                      // window columns a stage can hold: (TU - 1) * a + WW
  int off_f, off_x, off_o, xrow, xbuf, fbuf;  // shared-memory layout, floats
};

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }

template <int OT>
struct FilterTile {
  static constexpr int OP = OT == 9 ? 12 : OT;  // floats per tap in shared memory: 16-byte loads for OT 9
  static constexpr int UT = OT == 9 ? 6 : 8;    // output columns per thread: 54 or 8 accumulators
};

template <int OT, int TG>
struct GroupTile {
  static constexpr int UT = FilterTile<OT>::UT;
  static constexpr int TGP = TG == 32 ? 32 : 9;  // window stride per column: 32 banks for the column-chunk lanes
  static constexpr int NU = THREADS / TG;        // column chunks
  static constexpr int TU = NU * UT;             // output columns per block
  static constexpr int SEGS = 32 / TG;           // columns a warp holds for one q
};

template <int OT>
__device__ __forceinline__ void load_f(const float* p, float (&f)[OT]) {
  if constexpr (OT == 9) {
    const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w, f[8] = p[8];
  } else {
#pragma unroll
    for (int o = 0; o < OT; ++o) f[o] = p[o];
  }
}

// WIDE: the filter is staged per stage with its rows (route 2), else once per
// latitude (once per input channel where IG > 1; route 1)
template <int OT, bool A1, int TG, int ROWS, int RING, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
    disco_band_kernel(const float* __restrict__ x, const float* __restrict__ F, const int* __restrict__ band_start, const int* __restrict__ taps,
                      float* __restrict__ out, Params p) {
  using GT = GroupTile<OT, TG>;
  constexpr int TGP = GT::TGP, TU = GT::TU, SEGS = GT::SEGS, UT = GT::UT;
  constexpr int OP = FilterTile<OT>::OP;
  constexpr int SEG = TG * OT + 4;  // output staging per column, +4 to match a store's alignment
  extern __shared__ __align__(16) float smem[];
  int* s_run = reinterpret_cast<int*>(smem);  // (lo, hi) of the live rows in j order
  int* s_j = s_run + 2 * p.BL;                // their j, and their count at [BL]
  float* Fs = smem + p.off_f;                 // filter of channel i: (Gf, BL, WW, OP), one buffer, or RING where IG > 1;
                                              // WIDE: RING stages of (Gf, ROWS, WW, OP), the stage's rows' live spans
  float* Xs = smem + p.off_x;                 // RING window rows (cols, TGP)
  float* Os = smem + p.off_o;                 // output staging, SEGS columns of SEG floats a warp

  int bid = blockIdx.x;
  const int gt = bid % p.n_gtiles;
  bid /= p.n_gtiles;
  const int oc = bid % p.n_oc;
  bid /= p.n_oc;
  const int h = bid % p.Hout;
  const int b = bid / p.Hout;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tg = tid % TG, nu = tid / TG;
  const int g0 = gt * TG;
  const int BL = p.BL, WW = p.WW;

  if (warp == 0) {  // the live rows of latitude h, compacted in j order, 32 band rows a ballot
    int n = 0;
    for (int j0 = 0; j0 < BL; j0 += 32) {
      const int j = j0 + lane;
      const int lo = j < BL ? max(0, min(taps[(h * BL + j) * 2], WW)) : 0;
      const int hi = j < BL ? max(lo, min(taps[(h * BL + j) * 2 + 1], WW)) : 0;
      const unsigned live = __ballot_sync(0xffffffffu, hi > lo);
      if (hi > lo) {
        const int k = n + __popc(live & ((1u << lane) - 1u));
        s_run[2 * k] = lo;
        s_run[2 * k + 1] = hi;
        s_j[k] = j;
      }
      n += __popc(live);
    }
    if (lane == 0) s_j[BL] = n;
  }
  __syncthreads();
  const int n_live = s_j[BL];
  // the block walks every column tile of its latitude; a tile's stages are
  // (i, live row)
  const int n_grp = (n_live + ROWS - 1) / ROWS;  // stages of one channel
  const int NSU = p.IG * n_grp;
  const int NS = p.n_utiles * NSU;

  const int g = g0 + tg;
  const int gf = g < p.G ? g % p.Gf : 0;
  const int row0 = band_start[h];
  const float* xb = x + (long long)b * p.sB;
  const float* Fh = F + (long long)h * p.Gf * p.IG * BL * WW * p.OGp + oc * OT;
  const int n_fbuf = p.IG > 1 ? RING : 1;

  // the filter of channel i for column tile k, in slot (k*IG + i) % RING
  auto stage_f = [&](int k, int i) {
    float* dst = Fs + ((k * p.IG + i) % n_fbuf) * p.fbuf;
    const int n = p.Gf * BL * WW * OT;
    for (int idx = tid; idx < n; idx += THREADS) {
      const int o = idx % OT, e = idx / OT, gfi = e / (BL * WW), jw = e % (BL * WW);
      cp_async<4>(dst + e * OP + o, Fh + ((long long)(gfi * p.IG + i) * BL * WW + jw) * p.OGp + o, true);
    }
  };
  // WIDE: the live filter spans of channel i at the rows of stage s (row
  // group gi), in slot s % RING: (Gf, ROWS, WW, OP), w at its own column
  auto stage_fw = [&](int s, int i, int gi) {
    float* dst = Fs + (s % RING) * p.fbuf;
    const int l0 = gi * ROWS, nl = min(n_live, l0 + ROWS) - l0;
    for (int r = 0; r < nl; ++r) {
      const int lo = s_run[2 * (l0 + r)], span = s_run[2 * (l0 + r) + 1] - lo, j = s_j[l0 + r];
      const int n = p.Gf * span * OT;
      for (int idx = tid; idx < n; idx += THREADS) {
        const int o = idx % OT, e = idx / OT, gfi = e / span, w = lo + e % span;
        cp_async<4>(dst + ((gfi * ROWS + r) * WW + w) * OP + o, Fh + ((long long)((gfi * p.IG + i) * BL + j) * WW + w) * p.OGp + o, true);
      }
    }
  };
  // stage s: the live column span of one row of channel i of groups g0 ..
  // g0+TG-1, for column tile s / NSU; the filter of channel i with its
  // first row (once, where IG == 1), or (WIDE) the rows' filter spans
  auto stage = [&](int s) {
    const int k = s / NSU, r = s - k * NSU, i = r / n_grp, gi = r - i * n_grp;
    if constexpr (WIDE) {
      stage_fw(s, i, gi);
    } else if (gi == 0 && (p.IG > 1 || s == 0)) {
      stage_f(k, i);
    }
    const int u0 = k * TU, n_valid = min(TU, p.n_out - u0);
    for (int li = gi * ROWS; li < min(n_live, gi * ROWS + ROWS); ++li) {
      const int lo = s_run[2 * li], hi = s_run[2 * li + 1];
      const int ncols = (n_valid - 1) * p.a + hi - lo;
      float* dst = Xs + (s % RING) * p.xbuf + (li - gi * ROWS) * p.xrow;
      int cb = (p.off + u0 * p.a + lo) % p.Win;
      if (cb < 0) cb += p.Win;
      const float* src = xb + (long long)(row0 + s_j[li]) * p.sH + (long long)i * p.sC;
      if (p.col_fast) {
        for (int idx = tid; idx < ncols * TG; idx += THREADS) {
          const int col = idx % ncols, t = idx / ncols;
          int wc = cb + col;
          if (wc >= p.Win) wc %= p.Win;
          const bool ok = g0 + t < p.G;
          cp_async<4>(dst + col * TGP + t, ok ? src + (long long)wc * p.sW + (long long)(g0 + t) * p.IG * p.sC : x, ok);
        }
      } else {
        // each thread copies one channel t at every NU-th column
        const int t = tid % TG;
        const bool ok = g0 + t < p.G;
        const float* src_t = ok ? src + (long long)(g0 + t) * p.IG * p.sC : x;
        int wc = cb + tid / TG;
        for (int col = tid / TG; col < ncols; col += GT::NU) {
          while (wc >= p.Win) wc -= p.Win;
          cp_async<4>(dst + col * TGP + t, ok ? src_t + (long long)wc * p.sW : x, ok);
          wc += GT::NU;
        }
      }
    }
  };

  // out: for each of the thread's columns, its group's OTv outputs; a
  // warp stages its SEGS columns of one q and stores each column's
  // contiguous (g, o) segment
  const int OTv = min(OT, p.OG - oc * OT);
  const int TGv = min(TG, p.G - g0);
  const int S = TGv * OTv;
  const bool contiguous = OTv == p.OG;
  float* Ow = Os + warp * SEGS * SEG;
  const int sl = lane / TG;  // this lane's column among the warp's SEGS
  auto column = [&](int u) -> float* {
    return out + ((long long)(b * p.Hout + h) * p.Wout + p.phase + p.phases * u) * p.sO + (long long)g0 * p.OG + oc * OT;
  };
  float acc[OT][UT];
  auto store = [&](int u0) {
#pragma unroll
    for (int q = 0; q < UT; ++q) {
      const int mis = contiguous ? (int)((reinterpret_cast<uintptr_t>(column(u0 + nu * UT + q)) >> 2) & 3) : 0;
      if (tg < TGv) {
#pragma unroll
        for (int o = 0; o < OT; ++o)
          if (o < OTv) Ow[sl * SEG + mis + tg * OTv + o] = acc[o][q];
      }
      __syncwarp();
      for (int k = 0; k < SEGS; ++k) {
        const int u = u0 + (warp * SEGS + k) * UT + q;
        if (u >= p.n_out) continue;
        float* dst = column(u);
        if (contiguous) {
          // scalar head to 16-byte alignment, float4 body, scalar tail; the
          // staged segment starts at the same alignment
          const int m = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
          const float* src = Ow + k * SEG + m;
          const int head = min(S, (4 - m) & 3), nv = (S - head) / 4, tail = head + 4 * nv;
          if (lane < head) dst[lane] = src[lane];
          for (int v = lane; v < nv; v += 32)
            *reinterpret_cast<float4*>(dst + head + 4 * v) = *reinterpret_cast<const float4*>(src + head + 4 * v);
          if (tail + lane < S) dst[tail + lane] = src[tail + lane];
        } else {
          const float* src = Ow + k * SEG;
          for (int e = lane; e < S; e += 32) dst[(e / OTv) * p.OG + e % OTv] = src[e];
        }
      }
      __syncwarp();
    }
  };

#pragma unroll
  for (int o = 0; o < OT; ++o)
#pragma unroll
    for (int q = 0; q < UT; ++q) acc[o][q] = 0.f;

  if (NS == 0) {  // no live tap: +0 everywhere, nothing read
    for (int k = 0; k < p.n_utiles; ++k) store(k * TU);
    return;
  }

  // stages s + 1 and s + 2 are copied while stage s is computed; a buffer
  // is rewritten two stages after it was read, past the barrier between
  for (int s = 0; s < RING - 1; ++s) {
    if (s < NS) stage(s);
    sm90::cp_async_commit();
  }
  for (int s = 0; s < NS; ++s) {
    const int k = s / NSU, r = s - k * NSU, i = r / n_grp, gi = r - i * n_grp;
    const int u0 = k * TU;
    sm90::cp_async_wait<RING - 2>();
    __syncthreads();
    if (s + RING - 1 < NS) stage(s + RING - 1);
    sm90::cp_async_commit();
    for (int li = gi * ROWS; li < min(n_live, gi * ROWS + ROWS); ++li) {
      const int lo = s_run[2 * li], hi = s_run[2 * li + 1];
      const float* Xq = Xs + (s % RING) * p.xbuf + (li - gi * ROWS) * p.xrow + nu * UT * p.a * TGP + tg;  // column nu*UT*a + (w - lo)
      const float* Fw = WIDE ? Fs + (s % RING) * p.fbuf + ((gf * ROWS + li - gi * ROWS) * WW) * OP
                             : Fs + ((k * p.IG + i) % n_fbuf) * p.fbuf + ((gf * BL + s_j[li]) * WW) * OP;
      if (u0 + nu * UT < p.n_out) {
        if constexpr (A1) {
          float xr[UT];
#pragma unroll
          for (int q = 0; q < UT; ++q) xr[q] = Xq[q * TGP];
          int w = lo;
          for (; w + 1 < hi; w += 2) {  // two taps a pass: the window slides by two
            float f0[OT], f1[OT];
            load_f<OT>(Fw + w * OP, f0);
            load_f<OT>(Fw + (w + 1) * OP, f1);
            const float xn0 = Xq[(UT + w - lo) * TGP];
            const float xn1 = w + 2 < hi ? Xq[(UT + w + 1 - lo) * TGP] : 0.f;
#pragma unroll
            for (int o = 0; o < OT; ++o)
#pragma unroll
              for (int q = 0; q < UT; ++q) acc[o][q] = fmaf(f0[o], xr[q], acc[o][q]);
#pragma unroll
            for (int o = 0; o < OT; ++o) {
#pragma unroll
              for (int q = 0; q < UT - 1; ++q) acc[o][q] = fmaf(f1[o], xr[q + 1], acc[o][q]);
              acc[o][UT - 1] = fmaf(f1[o], xn0, acc[o][UT - 1]);
            }
#pragma unroll
            for (int q = 0; q < UT - 2; ++q) xr[q] = xr[q + 2];
            xr[UT - 2] = xn0;
            xr[UT - 1] = xn1;
          }
          if (w < hi) {
            float f[OT];
            load_f<OT>(Fw + w * OP, f);
#pragma unroll
            for (int o = 0; o < OT; ++o)
#pragma unroll
              for (int q = 0; q < UT; ++q) acc[o][q] = fmaf(f[o], xr[q], acc[o][q]);
          }
        } else {
          for (int w = lo; w < hi; ++w) {
            float f[OT];
            load_f<OT>(Fw + w * OP, f);
#pragma unroll
            for (int q = 0; q < UT; ++q) {
              const float xv = Xq[(q * p.a + w - lo) * TGP];
#pragma unroll
              for (int o = 0; o < OT; ++o) acc[o][q] = fmaf(f[o], xv, acc[o][q]);
            }
          }
        }
      }
    }
    if (r == NSU - 1) {  // the tile is summed: store it and start the next
      store(u0);
#pragma unroll
      for (int o = 0; o < OT; ++o)
#pragma unroll
        for (int q = 0; q < UT; ++q) acc[o][q] = 0.f;
    }
  }
  sm90::cp_async_wait<0>();
}

constexpr size_t SMEM_MAX = 227 * 1024;
constexpr size_t SMEM_TWO_BLOCKS = 113 * 1024;  // two blocks an SM (the launch bounds' 2)

// the shared-memory layout of a tiling into p; returns its bytes
template <int OT, int TG, int ROWS, int RING, bool WIDE>
size_t layout(Params& p) {
  using GT = GroupTile<OT, TG>;
  constexpr int OP = FilterTile<OT>::OP;
  p.n_utiles = (p.n_out + GT::TU - 1) / GT::TU;
  p.n_gtiles = (p.G + TG - 1) / TG;
  p.xcols = (GT::TU - 1) * p.a + p.WW;
  p.off_f = round_up4(3 * p.BL + 1);
  p.fbuf = round_up4(p.Gf * (WIDE ? ROWS : p.BL) * p.WW * OP);
  p.off_x = p.off_f + (WIDE || p.IG > 1 ? RING : 1) * p.fbuf;
  p.xrow = round_up4(p.xcols * GT::TGP);
  p.xbuf = ROWS * p.xrow;
  p.off_o = p.off_x + RING * p.xbuf;
  return (size_t)(p.off_o + (THREADS / 32) * GT::SEGS * (TG * OT + 4)) * sizeof(float);
}

template <int OT, bool A1, int TG, int ROWS, int RING, bool WIDE>
int launch(const float* x, const float* F, const int* band_start, const int* taps, float* out, Params p, int B, cudaStream_t s) {
  const size_t smem = layout<OT, TG, ROWS, RING, WIDE>(p);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = disco_band_kernel<OT, A1, TG, ROWS, RING, WIDE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nb = (long long)p.n_gtiles * p.n_oc * p.Hout * B;
  if (nb > 2147483647LL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)nb, THREADS, smem, s>>>(x, F, band_start, taps, out, p);
  return (int)cudaGetLastError();
}

// Route 1: 32-channel tiles stage four live rows a stage in a ring of two
// (the fastest at the FCN3 processor of the shapes tried: two or three rows
// in three buffers, four in two, all in two); 8-channel tiles, whose
// windows are four times as wide, two rows in a ring of three. Route 2
// (WIDE) stages two rows a stage with their filter spans, in the same rings
// (at BL ~74 and WW ~200 a 32-channel tile's ring is ~180 KB), or one row a
// stage where two do not fit (wider windows, or a stride of 2 with them).
template <int OT, bool WIDE, int TG>
bool two_rows(const Params& p) {
  Params q = p;
  return !WIDE || (TG == 32 ? layout<OT, 32, 2, 2, true>(q) : layout<OT, 8, 2, 3, true>(q)) <= SMEM_MAX;
}

template <int OT, bool WIDE>
size_t smem_of(const Params& p) {
  Params q = p;
  if (p.G >= 96) return two_rows<OT, WIDE, 32>(p) ? layout<OT, 32, WIDE ? 2 : 4, 2, WIDE>(q) : layout<OT, 32, 1, 2, WIDE>(q);
  return two_rows<OT, WIDE, 8>(p) ? layout<OT, 8, 2, 3, WIDE>(q) : layout<OT, 8, 1, 3, WIDE>(q);
}

// the route the entry point takes: route 1 where BL <= 32 and two of its
// blocks fit on an SM, else route 2
int choose_route(const Params& p, int OT) {
  const size_t s1 = OT == 1 ? smem_of<1, false>(p) : smem_of<9, false>(p);
  return p.BL <= 32 && s1 <= SMEM_TWO_BLOCKS ? 1 : 2;
}

template <int OT, int TG, int ROWS, int RING, bool WIDE>
int launch_a(const float* x, const float* F, const int* band_start, const int* taps, float* out, const Params& p, int B, cudaStream_t s) {
  return p.a == 1 ? launch<OT, true, TG, ROWS, RING, WIDE>(x, F, band_start, taps, out, p, B, s)
                  : launch<OT, false, TG, ROWS, RING, WIDE>(x, F, band_start, taps, out, p, B, s);
}

template <int OT, bool WIDE>
int dispatch(const float* x, const float* F, const int* band_start, const int* taps, float* out, const Params& p, int B, cudaStream_t s) {
  if constexpr (!WIDE) {
    if (p.G >= 96) return launch_a<OT, 32, 4, 2, false>(x, F, band_start, taps, out, p, B, s);
    return launch_a<OT, 8, 2, 3, false>(x, F, band_start, taps, out, p, B, s);
  } else {
    if (p.G >= 96)
      return two_rows<OT, true, 32>(p) ? launch_a<OT, 32, 2, 2, true>(x, F, band_start, taps, out, p, B, s)
                                       : launch_a<OT, 32, 1, 2, true>(x, F, band_start, taps, out, p, B, s);
    return two_rows<OT, true, 8>(p) ? launch_a<OT, 8, 2, 3, true>(x, F, band_start, taps, out, p, B, s)
                                    : launch_a<OT, 8, 1, 3, true>(x, F, band_start, taps, out, p, B, s);
  }
}

}  // namespace

// x: float32, element strides (sB, sH, sW, sC) over (B, Hin, Win, G*IG);
// F: float32 (Hout, Gf, IG, BL, WW, OGp) contiguous, OGp = OG rounded up to
// the kernel's outputs per thread (1 for OG == 1, else a multiple of 9),
// zero-padded; band_start: int32 (Hout,); taps: int32 (Hout, BL, 2), the
// live run [lo, hi) of w of each (h, j), empty where lo >= hi; out: float32
// (B, Hout, Wout, G*OG), contiguous but for sO >= G*OG floats between
// pixels. Returns cudaGetLastError() after the launch, or an argument error
// without launching (a layout whose shared memory exceeds 227 KB is one).
extern "C" int mt_disco_band_contract(const void* x, const void* F, const void* band_start, const void* taps, void* out, int B, int Hin, int Win,
                                      long long sB, long long sH, long long sW, long long sC, int Hout, int Wout, int G, int Gf, int IG, int OG,
                                      int OGp, int BL, int WW, int a, int off, int n_out, int phase, int phases, long long sO,
                                      void* stream) {
  if (B <= 0 || Hin <= 0 || Win <= 0 || Hout <= 0 || G <= 0 || Gf <= 0 || G % Gf || IG <= 0 || OG <= 0 || BL <= 0 || WW <= 0 || a <= 0 ||
      n_out <= 0 || phases <= 0 || phase < 0 || phase >= phases || phase + phases * (n_out - 1) >= Wout || sO < (long long)G * OG)
    return (int)cudaErrorInvalidValue;
  const int OT = OG == 1 ? 1 : 9;
  if (OGp % OT || OGp < OG || OGp - OG >= OT) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 4) return (int)cudaErrorMisalignedAddress;
  Params p;
  p.sB = sB, p.sH = sH, p.sW = sW, p.sC = sC, p.sO = sO;
  p.Hin = Hin, p.Win = Win, p.Hout = Hout, p.Wout = Wout;
  p.G = G, p.Gf = Gf, p.IG = IG, p.OG = OG, p.OGp = OGp, p.BL = BL, p.WW = WW;
  p.a = a, p.off = off, p.n_out = n_out, p.phase = phase, p.phases = phases;
  p.n_oc = OGp / OT;
  p.col_fast = sC != 1 && sW == 1;
  const float* xf = static_cast<const float*>(x);
  const float* Ff = static_cast<const float*>(F);
  const int* bs = static_cast<const int*>(band_start);
  const int* tp = static_cast<const int*>(taps);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = choose_route(p, OT) == 2;
  if (OT == 1) return wide ? dispatch<1, true>(xf, Ff, bs, tp, of, p, B, s) : dispatch<1, false>(xf, Ff, bs, tp, of, p, B, s);
  return wide ? dispatch<9, true>(xf, Ff, bs, tp, of, p, B, s) : dispatch<9, false>(xf, Ff, bs, tp, of, p, B, s);
}

// The route (1 or 2, see above) that mt_disco_band_contract takes for these
// sizes, and in *smem the bytes of shared memory a block of it takes.
extern "C" int mt_disco_band_route(int G, int Gf, int IG, int OG, int BL, int WW, int a, int n_out, long long* smem) {
  if (G <= 0 || Gf <= 0 || IG <= 0 || OG <= 0 || BL <= 0 || WW <= 0 || a <= 0 || n_out <= 0) return -1;
  Params p = {};
  p.G = G, p.Gf = Gf, p.IG = IG, p.OG = OG, p.BL = BL, p.WW = WW, p.a = a, p.n_out = n_out;
  const int OT = OG == 1 ? 1 : 9;
  const int route = choose_route(p, OT);
  const size_t bytes = OT == 1 ? (route == 2 ? smem_of<1, true>(p) : smem_of<1, false>(p)) : (route == 2 ? smem_of<9, true>(p) : smem_of<9, false>(p));
  *smem = (long long)bytes;
  return route;
}
