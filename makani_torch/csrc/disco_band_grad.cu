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
// It is a gather: no atomics, each dx element summed by one thread in a
// fixed order (output rows h ascending, taps w ascending, o ascending), and
// the phases in turn (``accumulate`` adds a later phase to the earlier
// ones' result), so two runs are bit-equal. The wrapper builds rows(hi) on
// the host (a CSR list of the output latitudes whose band covers input row
// hi with a live tap there), and the kernel sums the live runs [lo, hi) of
// ``live_tap_runs`` only, as K5 does, so the polar rows (psi zeroed: no live
// tap) send nothing back: their responses are exactly 0 and the polar path
// carries their gradient. dout is read through its pixel stride sO, so the
// processor's response rows padded to a multiple of 4 floats are read in
// place and their pad is never copied.
//
// What bounds it on the card: at the FCN3 training processor (B 4,
// 180 x 360, C 677, K 9, 60.4 live taps a latitude) the live taps are 0.19
// TFLOP of fp32 FMAs (2.8 ms at 67 TFLOP/s) against 6.3 GB of dout read and
// 0.7 GB of dx written (2.1 ms at 3.35 TB/s); at the atmo decoder (fused,
// IG 9, OG 1, C 585, 361 x 720) the 2.4 GB of dx it writes (0.8 ms).
//
// The staged kernel (stride 1, one phase, n_out = Win: every main-path
// call). A block takes NH consecutive input rows, 32 channels (one a lane)
// and TU = CHUNKS * UT consecutive input columns (UT a thread, one column
// chunk a warp). It walks the output rows h that reach any of its rows, in a
// ring of stages: for each h it stages the dout columns that reach its
// column tile (TU + the union of its rows' live runs - 1 columns, only the
// live channels' floats: the responses' pad is never copied) and each row's
// live filter taps, so a staged dout row feeds every input row of the block
// it reaches. For one h a thread sweeps the union of its rows' runs once:
// its UT columns meet UT consecutive dout columns at each tap, one column to
// the left at the next, so the dout values slide through a register window
// whose slots rotate at compile time (the tap loop unrolled by UT); each tap
// loads one new column and, for every row whose run holds the tap, its
// filter taps for UT * OG FMAs; u and the wrap are found once a stage.
//  * Responses mode (OT = 9; NH 4, 5 chunks of UT 12: the 360 columns of
//    the processor in 6 tiles): the filter is shared by every channel; each
//    tap is staged as three groups of 3 outputs in 4 floats (one broadcast
//    16-byte load a group). A (channel, column) sum is split over three
//    threads, 3 outputs each (480 threads: three times the warps that the
//    shared memory allows with one), added in order at the end. Each dout
//    column's 32 x 9 floats (a lane's 9 floats 9 apart: no bank conflicts)
//    come in one bulk copy from the 16-byte aligned pixel, issued by the
//    first warp on the stage's mbarrier; two 107 KB stages fill the shared
//    memory, one block an SM.
//  * Fused mode with OG = 1 (OT = 1, the decoders; NH 2, 8 chunks of UT 30:
//    720 columns in 3 tiles): the filter differs per channel, so it is
//    staged channel-fastest (a warp reads 32 consecutive floats), eight
//    threads a channel copying along F's rows; dout columns hold the tile's
//    few groups (a lane reads its group's float: a broadcast), in 4-byte
//    copies, six stages in flight.
// Blocks run channel tiles fastest. sweep_k11_k12.py times the other grid
// order, row counts, column widths, the one-thread split, the ring depth,
// and the kernel with its copies, its compute or its stores cut out.
// Every other case (stride 2, several phases, the encoders' fused OG > 1)
// runs the generic kernel: a thread per channel and 4 columns 8 apart,
// dout and F read through L1, u found per tap.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using sm90::cp_async;

constexpr int THREADS = 256;  // generic kernel
constexpr int CT = 32;  // channels a block: one per lane
// the staged kernel's blocks, fastest first: input-row groups, then channel
// tiles (1), or channel tiles first (0)
constexpr int ROWS_FASTEST = 0;

struct Params {
  long long sO;  // dout: floats between pixels
  int Hin, Win, Hout, Wout, C, Gf, IG, OG, OGp, BL, WW, a, off, n_out, phase, phases, accumulate, n_ct;
  // staged kernel
  int n_hg, n_wt, ng, dstr, dbuf, fbuf, vec;
};

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }

// ---------------------------------------------------------------------------
// Staged kernel (a = 1, one phase)

template <int OT>
struct Tile {
  static constexpr int NH = OT == 9 ? 4 : 2;       // input rows a block
  static constexpr int UT = OT == 9 ? 12 : 30;     // columns a thread
  static constexpr int CHUNKS = OT == 9 ? 5 : 8;   // column chunks a block, a warp each
  static constexpr int TU = CHUNKS * UT;           // columns a block
  static constexpr int OS = OT == 9 ? 3 : 1;       // threads that share a (channel, column) sum, OT / OS outputs each
  static constexpr int OPT = OT / OS;
  static constexpr int CW = 32 * CHUNKS;           // threads of one output group
  static constexpr int NT = CW * OS;               // threads a block
  static constexpr int FSTR = OT == 9 ? 12 : CT;   // floats a staged filter tap: 9 as three groups of 3 in 4 (one 16-byte load a group)
  static constexpr int RING = OT == 9 ? 2 : 6;     // stages in flight
};

// the live run [lo, hi) of input row hi at output row h, empty where the
// row is past Hin, outside h's band, or has no live tap there
__device__ __forceinline__ void row_run(const int* __restrict__ band_start, const int* __restrict__ taps, const Params& p, int h, int hi, int& lo,
                                        int& hw) {
  lo = hw = 0;
  if (hi >= p.Hin) return;
  const int j = hi - band_start[h];
  if (j < 0 || j >= p.BL) return;
  lo = max(0, min(taps[(h * p.BL + j) * 2], p.WW));
  hw = max(lo, min(taps[(h * p.BL + j) * 2 + 1], p.WW));
}

template <int OT>
__global__ void __launch_bounds__(Tile<OT>::NT, OT == 9 ? 1 : 2)
    disco_band_grad_staged(const float* __restrict__ dout, const float* __restrict__ F, const int* __restrict__ band_start,
                           const int* __restrict__ taps, const int* __restrict__ row_ptr, const int* __restrict__ row_h, float* __restrict__ dx,
                           Params p) {
  using T = Tile<OT>;
  constexpr int NH = T::NH, UT = T::UT, TU = T::TU, OS = T::OS, OPT = T::OPT, CW = T::CW, NT = T::NT, FSTR = T::FSTR, RING = T::RING;
  extern __shared__ __align__(16) float smem[];
  uint64_t* ready = reinterpret_cast<uint64_t*>(smem);  // RING mbarriers: a stage's bulk copies have landed (OT 9)
  int* s_run = reinterpret_cast<int*>(smem + 2 * RING);  // RING x NH x (lo, hi): each row's live run at the stage's h
  float* Ds = smem + round_up4(2 * RING + RING * NH * 2);  // RING x (columns, dstr): dout columns of the tile's channels
  float* Fs = Ds + RING * p.dbuf;                           // RING x (NH, WW, FSTR): the live taps of each row

  int bid = blockIdx.x, hg, ct;
  if (ROWS_FASTEST) {
    hg = bid % p.n_hg, bid /= p.n_hg;
    ct = bid % p.n_ct, bid /= p.n_ct;
  } else {
    ct = bid % p.n_ct, bid /= p.n_ct;
    hg = bid % p.n_hg, bid /= p.n_hg;
  }
  const int wt = bid % p.n_wt, b = bid / p.n_wt;
  const int tid = threadIdx.x, lane = tid % 32, chunk = (tid % CW) / 32, og = tid / CW;
  const int hi0 = hg * NH, c0 = ct * CT, w0 = wt * TU;
  const int nc = min(CT, p.C - c0);  // live channels of the tile
  const int g0 = c0 / p.IG;
  const int ch = c0 + lane;
  const bool live_ch = lane < nc;
  // this thread's first float in a staged dout column: OT 9, its outputs
  // og*3 .. og*3+2 of its channel's 9; OT 1, its group
  const int dl = OT == 9 ? lane * 9 + og * OPT : (live_ch ? ch / p.IG - g0 : 0);
  constexpr int DSTR = CT * 9;  // floats a staged dout column, responses mode
  const int dstr = OT == 9 ? DSTR : p.dstr;

  // the output rows reaching the block's rows: every h between the first and
  // the last of their row lists (h ascending in each)
  int h_lo = 0x7FFFFFFF, h_hi = -1;
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    const int hi = hi0 + k;
    if (hi < p.Hin) {
      const int r0 = row_ptr[hi], r1 = row_ptr[hi + 1];
      if (r1 > r0) {
        h_lo = min(h_lo, row_h[r0]);
        h_hi = max(h_hi, row_h[r1 - 1]);
      }
    }
  }
  const int NS = h_hi >= h_lo ? h_hi - h_lo + 1 : 0;
  const long long drow = (long long)p.Wout * p.sO;
  const float* dout_b = dout + (long long)b * p.Hout * drow + (long long)g0 * p.OG;
  // floats of a dout column the tile reads: its channels' outputs (OT 9) or groups (OT 1)
  const int nval = OT == 9 ? nc * 9 : min(p.ng, p.C / p.IG - g0);
  if (OT == 9 && tid == 0) {
    for (int q = 0; q < RING; ++q) sm90::mbar_init(&ready[q], 32);
    sm90::mbar_init_fence();
  }
  __syncthreads();  // the barriers

  auto stage = [&](int s) {
    const int h = h_lo + s;
    int lmin = p.WW, hmax = 0;
    int lo[NH], hw[NH];
#pragma unroll
    for (int k = 0; k < NH; ++k) {
      row_run(band_start, taps, p, h, hi0 + k, lo[k], hw[k]);
      if (hw[k] > lo[k]) lmin = min(lmin, lo[k]), hmax = max(hmax, hw[k]);
    }
    int* run = s_run + (s % RING) * NH * 2;
#pragma unroll
    for (int k = 0; k < NH; ++k)
      if (tid == k) run[2 * k] = lo[k], run[2 * k + 1] = hw[k];
    // dout columns x = 0 .. ncols - 1 are output columns ub + x (mod Win)
    const int ncols = hmax > lmin ? TU + hmax - lmin - 1 : 0;
    int ub = (w0 - p.off - (hmax - 1)) % p.Win;
    if (ub < 0) ub += p.Win;
    float* D = Ds + (s % RING) * p.dbuf;
    float* Fb = Fs + (s % RING) * p.fbuf;
    const float* src = dout_b + (long long)h * drow;
    if constexpr (OT == 9) {
      // each dout column's 16-byte pieces in one bulk copy, issued by the
      // first warp's lanes, each arriving on the stage's barrier with its
      // bytes (none where the stage is empty or the pixel stride does not
      // allow 16-byte copies); the rest (a partial tile's tail, or all of
      // it) in 4-byte copies
      const int n16 = p.vec ? nval / 4 : 0, rem = nval - 4 * n16;
      if (tid < 32) {
        int bytes = 0;
        for (int x = lane; x < ncols; x += 32) bytes += 16 * n16;
        sm90::fence_proxy_async();  // the slot's earlier reads before the copy engine's writes
        sm90::mbar_arrive_expect_tx(&ready[s % RING], bytes);
        if (n16)
          for (int x = lane; x < ncols; x += 32) {
            int u = ub + x;
            if (u >= p.Win) u %= p.Win;
            sm90::bulk_copy(D + x * DSTR, src + (long long)u * p.sO, 16 * n16, &ready[s % RING]);
          }
      }
      for (int idx = tid; idx < ncols * rem; idx += NT) {
        const int x = idx / rem, e = 4 * n16 + idx - x * rem;
        int u = ub + x;
        if (u >= p.Win) u %= p.Win;
        cp_async<4>(D + x * DSTR + e, src + (long long)u * p.sO + e, true);
      }
    } else {
      // a thread a float of the column's groups, every xs-th column
      const int xs = NT / nval;
      if (tid < xs * nval) {
        const int e = tid % nval;
        int x = tid / nval, u = (ub + x) % p.Win;
        for (; x < ncols; x += xs) {
          cp_async<4>(D + x * dstr + e, src + (long long)u * p.sO + e, true);
          u += xs;
          while (u >= p.Win) u -= p.Win;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NH; ++k) {
      const int L = hw[k] - lo[k];
      if (L <= 0) continue;
      const int j = hi0 + k - band_start[h];
      float* Fk = Fb + k * p.WW * FSTR;
      if constexpr (OT == 9) {
        // tap w's 9 outputs as three groups of three, each in 4 floats
        const float* fsrc = F + ((long long)(h * p.BL + j) * p.WW + lo[k]) * p.OGp;
        for (int idx = tid; idx < L * 9; idx += NT) {
          const int w = idx / 9, o = idx - w * 9;
          cp_async<4>(Fk + (lo[k] + w) * FSTR + (o / 3) * 4 + o % 3, fsrc + w * p.OGp + o, true);
        }
      } else {
        // eight threads a channel, each every 8th tap: 8 lanes along F's row
        for (int c = tid / 8; c < nc; c += NT / 8) {
          const int g = (c0 + c) / p.IG, i = c0 + c - g * p.IG;
          const float* fsrc = F + ((((long long)h * p.Gf + g % p.Gf) * p.IG + i) * p.BL + j) * p.WW;
          for (int w = lo[k] + tid % 8; w < hw[k]; w += 8) cp_async<4>(Fk + w * FSTR + c, fsrc + w, true);
        }
      }
    }
  };

  float acc[NH][UT];
#pragma unroll
  for (int k = 0; k < NH; ++k)
#pragma unroll
    for (int q = 0; q < UT; ++q) acc[k][q] = 0.f;

  for (int s = 0; s < RING - 1; ++s) {
    if (s < NS) stage(s);
    sm90::cp_async_commit();
  }
  for (int s = 0; s < NS; ++s) {
    if constexpr (OT == 9) sm90::mbar_wait(&ready[s % RING], (s / RING) & 1);
    sm90::cp_async_wait<RING - 2>();
    __syncthreads();
    if (s + RING - 1 < NS) stage(s + RING - 1);
    sm90::cp_async_commit();
    const int* run = s_run + (s % RING) * NH * 2;
    int lo[NH], hw[NH], lmin = p.WW, hmax = 0;
#pragma unroll
    for (int k = 0; k < NH; ++k) {
      lo[k] = run[2 * k], hw[k] = run[2 * k + 1];
      if (hw[k] > lo[k]) lmin = min(lmin, lo[k]), hmax = max(hmax, hw[k]);
    }
    if (hmax <= lmin) continue;
    const float* Fb = Fs + (s % RING) * p.fbuf + (OT == 9 ? og * 4 : lane);
    // one sweep over the union of the rows' runs: at tap w (tau = w - lmin)
    // the thread's column q reads staged column x0 - tau + q, held in window
    // slot (q - tau) mod UT, and every row whose run holds w adds its taps
    const float* Dx = Ds + (s % RING) * p.dbuf + dl + (chunk * UT + hmax - 1 - lmin) * dstr;
    float win[UT][OPT];
#pragma unroll
    for (int q = 0; q < UT; ++q)
#pragma unroll
      for (int o = 0; o < OPT; ++o) win[q][o] = Dx[q * dstr + o];
    const int L = hmax - lmin;
    // each row's filter taps from the union's first, and its run's length
    const float* fk[NH];
    int len[NH];
#pragma unroll
    for (int k = 0; k < NH; ++k) {
      fk[k] = Fb + (k * p.WW + lo[k]) * FSTR;
      len[k] = hw[k] - lo[k];
    }
    // a group of UT taps from tau0 = w0 - lmin: the addresses and each row's
    // first tap in the group are found once a group, so a tap's loads take
    // constant offsets and its row test is one compare
    for (int tau0 = 0; tau0 < L; tau0 += UT) {
      const float* dg = Dx - tau0 * dstr;
      int rk[NH];
      const float* fg[NH];
#pragma unroll
      for (int k = 0; k < NH; ++k) {
        rk[k] = lmin + tau0 - lo[k];  // the group's first tap in row k's run
        fg[k] = fk[k] + rk[k] * FSTR;
      }
#pragma unroll
      for (int t = 0; t < UT; ++t) {
        if (tau0 + t < L) {
          if (tau0 + t > 0) {  // the new column to the left replaces the one the window left behind
#pragma unroll
            for (int o = 0; o < OPT; ++o) win[(UT - t) % UT][o] = dg[-t * dstr + o];
          }
#pragma unroll
          for (int k = 0; k < NH; ++k) {
            if ((unsigned)(rk[k] + t) >= (unsigned)len[k]) continue;
            const float* ft = fg[k] + t * FSTR;
            float f[OPT];
            if constexpr (OPT == 3) {
              const float4 fv = *reinterpret_cast<const float4*>(ft);
              f[0] = fv.x, f[1] = fv.y, f[2] = fv.z;
            } else if constexpr (OPT == 9) {
              const float4 f0 = *reinterpret_cast<const float4*>(ft), f1 = *reinterpret_cast<const float4*>(ft + 4),
                           f2 = *reinterpret_cast<const float4*>(ft + 8);
              f[0] = f0.x, f[1] = f0.y, f[2] = f0.z, f[3] = f1.x, f[4] = f1.y, f[5] = f1.z, f[6] = f2.x, f[7] = f2.y, f[8] = f2.z;
            } else {
#pragma unroll
              for (int o = 0; o < OPT; ++o) f[o] = ft[o];
            }
#pragma unroll
            for (int q = 0; q < UT; ++q) {
              float sum = acc[k][q];
#pragma unroll
              for (int o = 0; o < OPT; ++o) sum = fmaf(f[o], win[(q - t + UT) % UT][o], sum);
              acc[k][q] = sum;
            }
          }
        }
      }
    }
  }
  sm90::cp_async_wait<0>();
  if constexpr (OS > 1) {
    // the output groups' partial sums, added in order by the first group
    __syncthreads();
    float* part = Ds;  // (OS - 1, NH, UT, CW)
    if (og > 0) {
#pragma unroll
      for (int k = 0; k < NH; ++k)
#pragma unroll
        for (int q = 0; q < UT; ++q) part[(((og - 1) * NH + k) * UT + q) * CW + tid % CW] = acc[k][q];
    }
    __syncthreads();
    if (og > 0) return;
#pragma unroll
    for (int k = 0; k < NH; ++k)
#pragma unroll
      for (int q = 0; q < UT; ++q)
#pragma unroll
        for (int g = 1; g < OS; ++g) acc[k][q] += part[(((g - 1) * NH + k) * UT + q) * CW + tid];
  }
  if (!live_ch) return;
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    const int hi = hi0 + k;
    if (hi >= p.Hin) continue;
    float* row = dx + ((long long)b * p.Hin + hi) * p.Win * p.C + ch;
#pragma unroll
    for (int q = 0; q < UT; ++q) {
      const int wi = w0 + chunk * UT + q;
      if (wi >= p.Win) continue;
      float* dst = row + (long long)wi * p.C;
      *dst = p.accumulate ? *dst + acc[k][q] : acc[k][q];
    }
  }
}

// the staged kernel's shared memory, floats, with its layout in p
template <int OT>
size_t staged_smem(Params& p) {
  using T = Tile<OT>;
  p.ng = OT == 9 ? CT : min((CT - 1) / p.IG + 2, p.C / p.IG);
  p.dstr = OT == 9 ? CT * 9 : p.ng;
  // the output groups' partial sums reuse the dout buffers
  p.dbuf = max(round_up4((T::TU + p.WW - 1) * p.dstr), (T::OS - 1) * T::NH * T::UT * T::CW / T::RING);
  p.fbuf = round_up4(T::NH * p.WW * T::FSTR);
  return (size_t)(round_up4(2 * T::RING + T::RING * T::NH * 2) + T::RING * (p.dbuf + p.fbuf)) * sizeof(float);
}

template <int OT>
int launch_staged(const float* dout, const float* F, const int* bs, const int* taps, const int* rp, const int* rh, float* dx, Params p, int B,
                  cudaStream_t s) {
  using T = Tile<OT>;
  p.n_hg = (p.Hin + T::NH - 1) / T::NH;
  p.n_wt = (p.Win + T::TU - 1) / T::TU;
  p.vec = OT == 9 && p.sO % 4 == 0 && reinterpret_cast<uintptr_t>(dout) % 16 == 0;
  const size_t smem = staged_smem<OT>(p);
  auto kern = disco_band_grad_staged<OT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nb = (long long)p.n_hg * p.n_ct * p.n_wt * B;
  if (nb > 2147483647LL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)nb, T::NT, smem, s>>>(dout, F, bs, taps, rp, rh, dx, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Generic kernel (any stride and phase): a thread per channel and QPT
// input columns 8 apart, dout and F read through L1

constexpr int QPT = 4;           // input columns a thread
constexpr int WT = 8 * QPT;      // input columns a block

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
int launch_generic(const float* dout, const float* F, const int* bs, const int* taps, const int* rp, const int* rh, float* dx, Params p, int B,
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
// output latitudes with a live tap on it, ascending; dx: float32 (B, Hin,
// Win, G*IG) contiguous, written (accumulate 0) or added to (accumulate 1).
// Returns cudaGetLastError() after the launch, or an argument error.
extern "C" int mt_disco_band_grad(const void* dout, const void* F, const void* band_start, const void* taps, const void* row_ptr, const void* row_h,
                                  void* dx, int B, int Hin, int Win, int Hout, int Wout, int C, int Gf, int IG, int OG, int OGp, int BL, int WW,
                                  int a, int off, int n_out, int phase, int phases, long long sO, int accumulate, void* stream) {
  if (B <= 0 || B > 65535 || Hin <= 0 || Hin > 65535 || Win <= 0 || Hout <= 0 || C <= 0 || IG <= 0 || C % IG || Gf <= 0 || (C / IG) % Gf ||
      OG <= 0 || OGp < OG || BL <= 0 || WW <= 0 || a <= 0 || n_out <= 0 || phases <= 0 || phase < 0 || phase >= phases ||
      phase + phases * (n_out - 1) >= Wout || sO < (long long)(C / IG) * OG)
    return (int)cudaErrorInvalidValue;
  Params p = {};
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
  // the staged kernel takes stride 1 and one phase (every main-path call)
  // where its ring fits in shared memory
  const bool unit = a == 1 && phases == 1 && n_out == Win;
  constexpr size_t SMEM_MAX = 227 * 1024;
  Params q = p;
  if (unit && OG == 9 && Gf == 1 && IG == 1 && OGp == 9 && staged_smem<9>(q) <= SMEM_MAX) return launch_staged<9>(d, f, bs, tp, rp, rh, o, p, B, s);
  if (unit && OG == 1 && OGp == 1 && staged_smem<1>(q) <= SMEM_MAX) return launch_staged<1>(d, f, bs, tp, rp, rh, o, p, B, s);
  if (OG == 9) return launch_generic<9>(d, f, bs, tp, rp, rh, o, p, B, s);
  if (OG == 1) return launch_generic<1>(d, f, bs, tp, rp, rh, o, p, B, s);
  return launch_generic<0>(d, f, bs, tp, rp, rh, o, p, B, s);
}
