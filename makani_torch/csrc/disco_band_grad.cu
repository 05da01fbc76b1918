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
// The staged kernel (stride 1, one phase, n_out = Win: every FCN3
// main-path call, K 9 and the fused OG 1). A block takes NH consecutive input rows, 32 channels (one a lane)
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
//
// The wide-band kernel (responses mode at K 7: Gf = IG = 1, OG 7, F padded
// to OGp 9; stride 1, one phase, n_out = Win: FCN3.1's processor and
// decoder, BL 25 and 49, WW 71 and 135 at the training step). There the
// staged kernel's stage (TU + WW - 1 dout columns of 32 channels) does not
// fit twice in shared memory, and the live taps are ~0.48 and ~7.0 TFLOP of
// fp32 FMAs a call (7.2 and 104 ms at 67 TFLOP/s): it runs on the tensor
// cores in 3xTF32 (2.9 and 42 ms at 495 TFLOP/s), one tap w an m16n8k8
// product whose depth is the 7 outputs and a zero:
//   A[m, o] = dout[h, (w0 + 16 g + m) - off - w, c, o]  16 input columns of one channel
//   B[o, k] = F[h, hi0 + k - band_start[h], w, o]       8 input rows, shared by all channels
// accumulated over the output rows h and their taps w into a 16 x 8 tile
// (columns x rows) of one channel, held in registers by one warp for the
// whole block. A block takes NJ 8 input rows, 32 channels (4 a warp) and TU
// 64 columns (4 groups of 16): 16 tiles a warp. For each output row h that
// reaches its rows it walks the union [lmin, hmax) of the rows' live runs in
// pieces of P 48 taps, a stage each, in a ring of two (227 KB: one block an
// SM; 16 and 32 taps were slower on an H100): a stage holds the TU + P - 1
// dout columns the piece reaches (the tile's channels' floats only, one bulk
// copy a column on the stage's mbarrier; the responses' pad is never
// copied), in columns of 228 floats (4 mod 32 banks: a fragment's 32 loads
// hit 32 banks), and the piece's filter taps of the 8 rows as [tap][o][row]
// (zero outside each row's own run and at o = 7: only live taps are read).
// A fragment is a Toeplitz slice of the staged columns, loaded by computed
// addresses (its k slot 7 reads the channel's o = 6, which meets B's zero
// row), split into TF32 high and low parts by a mask (B's by cvt.rna, once
// a tap for the warp's 16 tiles); lo.hi, hi.lo and hi.hi go into a partial
// sum of TG 4 taps that starts from zero, and the partial into the tile's
// accumulator by an FADD: the tensor cores' adds truncate, and a sum kept
// in them over a whole band missed the fp32 gate on an H100 (3.8e-5 of
// max|ref| at FCN3.1's training processor). Each dx element has one owner,
// a lane of one block, and one order (h, then taps, then the product's
// own), so two calls are bit-equal. The tiles leave through shared memory,
// a warp writing 32 channels of a pixel (128 bytes) at a time. What bounds
// it is not the tensor cores: with its MMAs cut out (sweep_k11_k12.py) it
// keeps ~85% of its time, and with the copies and stores cut too ~75%: the
// fragments' shared-memory loads, their splits and the address arithmetic
// of a product that reuses each A fragment for one B (8 rows) only.
//
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
// Wide-band kernel at K 7 (responses mode, a = 1, one phase): 3xTF32
// m16n8k8 products, a tap each

struct Wide {
  static constexpr int OG = 7;                         // outputs a channel (the k of a product: 7 and a zero)
  static constexpr int NJ = 8;                         // input rows a block: the n of a product
  static constexpr int TU = 64;                        // input columns a block
  static constexpr int P = 48;                         // taps a stage
  static constexpr int TG = 4;                         // taps a partial sum
  static constexpr int RING = 2;                       // stages in flight
  static constexpr int WARPS = 8;
  static constexpr int NT = 32 * WARPS;                // threads a block
  static constexpr int CW = CT / WARPS;                // channels a warp
  static constexpr int GROUPS = TU / 16;               // 16-column groups (the m of a product)
  static constexpr int DSTR = CT * OG + 4;             // floats a staged dout column
  static constexpr int DBUF = (TU + P - 1) * DSTR;     // a stage's dout columns
  static constexpr int FBUF = P * 8 * NJ;              // a stage's filter taps: [tap][o][row]
  static constexpr int HEAD = 4 * RING;                // floats of the mbarriers and each stage's tap count
  static constexpr int ESTR = CT + 1;                  // the epilogue's floats a pixel
  static constexpr int EROW = TU * ESTR + 4;           // and a row
  static_assert(DSTR % 32 == 4 && DSTR % 4 == 0, "a fragment's loads on 32 banks, columns 16-byte aligned");
  static_assert(EROW % 32 == 4 && NJ == 8 && TU % 16 == 0 && CT % WARPS == 0 && P % TG == 0, "the tile");
  static_assert(NJ * EROW <= RING * DBUF, "the epilogue reuses the dout stages");
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b (from no accumulator)
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// d (+)= a b in 3xTF32, the small terms first; fresh: d starts from zero
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1, bool fresh) {
  if (fresh)
    mma_tf32_fresh(d, al, bh0, bh1);
  else
    mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__global__ void __launch_bounds__(Wide::NT, 1)
    disco_band_grad_wide(const float* __restrict__ dout, const float* __restrict__ F, const int* __restrict__ band_start,
                         const int* __restrict__ taps, const int* __restrict__ row_ptr, const int* __restrict__ row_h, float* __restrict__ dx,
                         Params p) {
  using W = Wide;
  constexpr int OG = W::OG, NJ = W::NJ, TU = W::TU, P = W::P, RING = W::RING, NT = W::NT, CW = W::CW, GROUPS = W::GROUPS, DSTR = W::DSTR;
  extern __shared__ __align__(16) float smem[];
  uint64_t* ready = reinterpret_cast<uint64_t*>(smem);     // RING mbarriers: a stage's bulk copies have landed
  int* s_taps = reinterpret_cast<int*>(smem + 2 * RING);  // RING: the stage's taps
  float* Ds = smem + W::HEAD;                              // RING x (TU + P - 1, DSTR): dout columns
  float* Fs = Ds + RING * W::DBUF;                         // RING x (P, 8, NJ): filter taps

  int bid = blockIdx.x;
  const int ct = bid % p.n_ct;
  bid /= p.n_ct;
  const int hg = bid % p.n_hg;
  bid /= p.n_hg;
  const int wt = bid % p.n_wt, b = bid / p.n_wt;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;  // a fragment's row group and thread in the group
  const int hi0 = hg * NJ, c0 = ct * CT, w0 = wt * TU;
  const int nc = min(CT, p.C - c0);
  const int ngroups = min(GROUPS, (p.Win - w0 + 15) / 16);  // groups with a column inside Win

  // the output rows reaching the block's rows: every h between the first
  // and the last of their row lists
  int h_lo = 0x7FFFFFFF, h_hi = -1;
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    const int hi = hi0 + k;
    if (hi < p.Hin) {
      const int r0 = row_ptr[hi], r1 = row_ptr[hi + 1];
      if (r1 > r0) {
        h_lo = min(h_lo, row_h[r0]);
        h_hi = max(h_hi, row_h[r1 - 1]);
      }
    }
  }
  const long long drow = (long long)p.Wout * p.sO;
  const float* dout_b = dout + (long long)b * p.Hout * drow + (long long)c0 * OG;
  const int nval = nc * OG;  // floats of a dout column the tile reads
  const int n16 = p.vec ? nval / 4 : 0, rem = nval - 4 * n16;
  if (tid == 0) {
    for (int q = 0; q < RING; ++q) sm90::mbar_init(&ready[q], 32);
    sm90::mbar_init_fence();
  }
  __syncthreads();  // the barriers

  // the walk over the stages, alike in every thread: output rows h from
  // h_lo to h_hi, each its rows' union [lmin, hmax) of live runs in pieces
  // of P taps from wa; lo, hw the rows' own runs at h
  int h = h_hi >= h_lo ? h_lo - 1 : 0, wa = 0, hmax = 0;
  int lo[NJ], hw[NJ];
  auto next = [&]() -> bool {
    wa += P;
    while (wa >= hmax) {
      if (++h > h_hi) return false;
      int lmin = p.WW;
      hmax = 0;
#pragma unroll
      for (int k = 0; k < NJ; ++k) {
        row_run(band_start, taps, p, h, hi0 + k, lo[k], hw[k]);
        if (hw[k] > lo[k]) lmin = min(lmin, lo[k]), hmax = max(hmax, hw[k]);
      }
      wa = lmin;
    }
    return true;
  };

  // the walk's current piece [wa, wb) into ring slot q
  auto stage = [&](int q) {
    const int wb = min(wa + P, hmax), n = wb - wa;
    if (tid == 0) s_taps[q] = n;
    // dout columns x = 0 .. ncols - 1 are output columns ub + x (mod Win):
    // tap wa + t meets input column w0 + c at x = c + n - 1 - t
    const int ncols = TU + n - 1;
    int ub = (w0 - p.off - (wb - 1)) % p.Win;
    if (ub < 0) ub += p.Win;
    float* D = Ds + q * W::DBUF;
    const float* src = dout_b + (long long)h * drow;
    // each column's 16-byte pieces in one bulk copy, issued by the first
    // warp's lanes, each arriving on the slot's barrier with its bytes;
    // the rest (a partial tile's tail, or all where the pixel stride does
    // not allow 16-byte copies) in 4-byte copies
    if (warp == 0) {
      int bytes = 0;
      for (int x = lane; x < ncols; x += 32) bytes += 16 * n16;
      sm90::fence_proxy_async();  // the slot's earlier reads before the copy engine's writes
      sm90::mbar_arrive_expect_tx(&ready[q], bytes);
      if (n16)
        for (int x = lane; x < ncols; x += 32) {
          int u = ub + x;
          if (u >= p.Win) u %= p.Win;
          sm90::bulk_copy(D + x * DSTR, src + (long long)u * p.sO, 16 * n16, &ready[q]);
        }
    }
    for (int idx = tid; idx < ncols * rem; idx += NT) {
      const int x = idx / rem, e = 4 * n16 + idx - x * rem;
      int u = ub + x;
      if (u >= p.Win) u %= p.Win;
      cp_async<4>(D + x * DSTR + e, src + (long long)u * p.sO + e, true);
    }
    // tap wa + t, output o of row k at F[(t * 8 + o) * NJ + k]; zeros
    // (nothing read) outside the row's run, past Hin or the band, and at o 7
    float* Fq = Fs + q * W::FBUF;
#pragma unroll
    for (int k = 0; k < NJ; ++k) {
      const float* frow = F + ((long long)h * p.BL + (hi0 + k - band_start[h])) * p.WW * p.OGp;
      for (int e = tid; e < P * 8; e += NT) {
        const int t = e / 8, o = e % 8, w = wa + t;
        const bool live = o < OG && w >= lo[k] && w < hw[k];
        cp_async<4>(Fq + e * NJ + k, live ? frow + (long long)w * p.OGp + o : F, live);
      }
    }
  };

  float acc[CW][GROUPS][4];
#pragma unroll
  for (int ci = 0; ci < CW; ++ci)
#pragma unroll
    for (int gi = 0; gi < GROUPS; ++gi)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[ci][gi][r] = 0.f;

  // a fragment's loads: rows gq and gq + 8 of a group, k slots tq (o = tq)
  // and tq + 4 (o = tq + 4, and o = 6 in place of the zero o = 7)
  const bool computes = warp * CW < nc;
  const int o_hi = min(tq + 4, OG - 1);
  bool more = next();
  int issued = 0;
  for (int q = 0; q < RING - 1; ++q) {
    if (more) {
      stage(issued % RING);
      ++issued;
      more = next();
    }
    sm90::cp_async_commit();
  }
  for (int s = 0; s < issued; ++s) {
    const int q = s % RING;
    sm90::mbar_wait(&ready[q], (s / RING) & 1);
    sm90::cp_async_wait<RING - 2>();
    __syncthreads();
    if (more) {
      stage(issued % RING);
      ++issued;
      more = next();
    }
    sm90::cp_async_commit();
    if (!computes) continue;
    const int n = s_taps[q];
    const float* D = Ds + q * W::DBUF + gq * DSTR + warp * CW * OG;
    const float* Fq = Fs + q * W::FBUF + tq * NJ + gq;
    // TG taps a partial sum: the tensor cores' adds truncate, so a partial
    // starts from zero and goes into acc by a rounded FADD. Past n (the last
    // group of the stage) the filter taps are zeros and the fragments take
    // the last tap's columns again
    for (int t0 = 0; t0 < n; t0 += W::TG) {
      // B: o = tq and tq + 4 of row gq at taps wa + t0 ..
      uint32_t bh[W::TG][2], bl[W::TG][2];
#pragma unroll
      for (int u = 0; u < W::TG; ++u) {
        const float f0 = Fq[(t0 + u) * 8 * NJ], f1 = Fq[(t0 + u) * 8 * NJ + 4 * NJ];
        bh[u][0] = sm90::tf32(f0), bh[u][1] = sm90::tf32(f1);
        bl[u][0] = __float_as_uint(f0 - __uint_as_float(bh[u][0])), bl[u][1] = __float_as_uint(f1 - __uint_as_float(bh[u][1]));
      }
      float part[CW][GROUPS][4];
#pragma unroll
      for (int u = 0; u < W::TG; ++u) {
        const float* Dt = D + max(n - 1 - t0 - u, 0) * DSTR;
#pragma unroll
        for (int gi = 0; gi < GROUPS; ++gi) {
          if (gi >= ngroups) continue;
#pragma unroll
          for (int ci = 0; ci < CW; ++ci) {
            const float* at = Dt + gi * 16 * DSTR + ci * OG;
            const float a[4] = {at[tq], at[8 * DSTR + tq], at[o_hi], at[8 * DSTR + o_hi]};
            uint32_t ah[4], al[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              ah[r] = __float_as_uint(a[r]) & 0xFFFFE000u;
              al[r] = __float_as_uint(a[r] - __uint_as_float(ah[r]));
            }
            mma3(part[ci][gi], ah, al, bh[u][0], bh[u][1], bl[u][0], bl[u][1], u == 0);
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < GROUPS; ++gi) {
        if (gi >= ngroups) continue;
#pragma unroll
        for (int ci = 0; ci < CW; ++ci)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[ci][gi][r] += part[ci][gi][r];
      }
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // every stage read: the epilogue takes the dout stages

  // the tiles through shared memory, (row, column, channel): a thread's
  // accumulators are columns gq and gq + 8 of its group, rows 2 tq and 2 tq + 1
  float* E = Ds;
  if (computes) {
#pragma unroll
    for (int ci = 0; ci < CW; ++ci)
#pragma unroll
      for (int gi = 0; gi < GROUPS; ++gi) {
        float* e = E + (2 * tq) * W::EROW + (gi * 16 + gq) * W::ESTR + warp * CW + ci;
        e[0] = acc[ci][gi][0];
        e[W::EROW] = acc[ci][gi][1];
        e[8 * W::ESTR] = acc[ci][gi][2];
        e[W::EROW + 8 * W::ESTR] = acc[ci][gi][3];
      }
  }
  __syncthreads();
  if (lane >= nc) return;
  for (int e = warp; e < NJ * TU; e += W::WARPS) {
    const int k = e / TU, c = e % TU, hi = hi0 + k, wi = w0 + c;
    if (hi >= p.Hin || wi >= p.Win) continue;
    const float v = E[k * W::EROW + c * W::ESTR + lane];
    float* dst = dx + (((long long)b * p.Hin + hi) * p.Win + wi) * p.C + c0 + lane;
    *dst = p.accumulate ? *dst + v : v;
  }
}

int launch_wide(const float* dout, const float* F, const int* bs, const int* taps, const int* rp, const int* rh, float* dx, Params p, int B,
                cudaStream_t s) {
  using W = Wide;
  p.n_hg = (p.Hin + W::NJ - 1) / W::NJ;
  p.n_wt = (p.Win + W::TU - 1) / W::TU;
  p.vec = p.sO % 4 == 0 && reinterpret_cast<uintptr_t>(dout) % 16 == 0;
  const size_t smem = (size_t)(W::HEAD + W::RING * (W::DBUF + W::FBUF)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(disco_band_grad_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nb = (long long)p.n_hg * p.n_ct * p.n_wt * B;
  if (nb > 2147483647LL) return (int)cudaErrorInvalidValue;
  disco_band_grad_wide<<<(unsigned)nb, W::NT, smem, s>>>(dout, F, bs, taps, rp, rh, dx, p);
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
  // stride 1 and one phase (every main-path call): K 7 in responses mode
  // takes the wide-band kernel, whatever the band; K 9 (responses) and OG 1
  // (fused) the staged kernel where its ring fits in shared memory
  const bool unit = a == 1 && phases == 1 && n_out == Win;
  if (unit && OG == Wide::OG && Gf == 1 && IG == 1) return launch_wide(d, f, bs, tp, rp, rh, o, p, B, s);
  constexpr size_t SMEM_MAX = 227 * 1024;
  Params q = p;
  if (unit && OG == 9 && Gf == 1 && IG == 1 && OGp == 9 && staged_smem<9>(q) <= SMEM_MAX) return launch_staged<9>(d, f, bs, tp, rp, rh, o, p, B, s);
  if (unit && OG == 1 && OGp == 1 && staged_smem<1>(q) <= SMEM_MAX) return launch_staged<1>(d, f, bs, tp, rp, rh, o, p, B, s);
  if (OG == 9) return launch_generic<9>(d, f, bs, tp, rp, rh, o, p, B, s);
  if (OG == 1) return launch_generic<1>(d, f, bs, tp, rp, rh, o, p, B, s);
  return launch_generic<0>(d, f, bs, tp, rp, rh, o, p, B, s);
}
