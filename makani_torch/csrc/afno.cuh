// Pieces shared by the AFNO spectral mixer's kernels, K18 (afno_mixer.cu) and
// K19 (afno_mixer_grad.cu): the layouts they read, the m64n96 TF32 wgmma, and
// the mode-tile kernel that runs both complex products of K18's forward and
// of K19's data pass on the tensor cores.
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
// of channels-last tokens gives behind that shape (sM = 2, sC = 2 H Wh). The
// weights and biases are read in place, in the layouts of their parameters,
// through four strides each (WLayout): a weight's element (block k, part p of
// [re, im], row r, column c), a bias's with row 0. K19 writes the weights' and
// biases' gradients in the same layouts. The hidden o1 that K18 keeps for K19,
// and K19's g1, are stored mode-contiguous, (B, nb, hbs, M, 2) (hidden_at):
// every channel's modes are one run, as in the rFFT's storage.
//
// The mode-tile kernel (mixer_tile_kernel). Per mode and channel block k both
// products are complex matrix products; each runs as a real GEMM on wgmma
// (m64n96k8, TF32 in, fp32 accumulators), 64 modes a warpgroup, in 3xTF32
// (hi.hi + hi.lo + lo.hi of cvt.rna splits) so that it keeps fp32's accuracy:
// each 32-deep stage is summed into fresh registers and added to the total
// with a rounded fp32 add, as K3 and K9 do. The rows are the modes, the
// depth the input channels' (re, im) and the columns the output channels'
// (re, im), interleaved; the complex weight enters as its real 2x2 blocks
// [[wr, wi], [-wi, wr]] (conjugated: [[wr, -wi], [wi, wr]]).
//
//   The A operand comes from registers. The depth order inside one k8 step is
//   free, and it is chosen so that a thread's fragment (row m, k t | k 4 + t)
//   is the (re, im) pair of channel 4 s + t at mode m: one 8-byte load of the
//   spectrum through its strides, with no staging and no transpose (eight
//   lanes read eight adjacent modes of a channel in the rFFT's storage). The
//   first product's accumulators are then, element for element, the second
//   product's A fragments: accumulator (row, column 8 c + 2 t + e) is the
//   (re, im) part e of hidden channel 4 c + t, which the second product's
//   k8 step c reads at (row, k t + 4 e). So the hidden tile never leaves the
//   thread: after its epilogue (bias, split relu; in K19 the relu's mask) it is
//   parked in the thread's own slots of shared memory (park), which hold no
//   other thread's values and need no barrier.
//
//   The B operand, the weight, is expanded while it is staged: each stage's
//   raw weights (16 depth channels x 48 output channels, read through the
//   parameter's strides, conjugated and transposed for K19) are copied into a
//   ring in shared memory (cp.async, 4 bytes an element: any layout) three
//   stages ahead, then split into TF32 high and low planes of the 2x2 blocks,
//   in wgmma's 128-byte swizzle (a column's 32-deep stage is one 128-byte
//   row): the next stage's blocks are stored while a stage's wgmmas run. One
//   barrier a stage. K19's o1, the relu's mask, is copied the same way into
//   the park slots its g1 will take, so that the epilogue waits on no load.
//
//   The widths are cut into pieces of 48 output channels (n96): a thread holds
//   48 accumulators and 48 stage partials, which leaves room for the fragments
//   without spills in two-warpgroup blocks; the first product's A is read again
//   for each piece (from L2). A block is WG warpgroups, 64 WG modes, of one channel block of one
//   sample; its weights pass once through shared memory for the 64 WG modes.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace afno {

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

// float offset of hidden element (b, k, channel, m) in the (B, nb, hbs, M, 2) storage
__host__ __device__ __forceinline__ long long hidden_at(int b, int k, int ch, int m, int nb, int hbs, int M) {
  return ((((long long)b * nb + k) * hbs + ch) * M + m) * 2;
}

constexpr int WN = 96;                // real columns of a wgmma: 48 output channels (re, im)
constexpr int PIECE = WN / 2;         // output channels a width piece
constexpr int ACC = WN / 2;           // fp32 accumulators a thread of an m64n96 wgmma
constexpr int KCH = 16;               // depth channels a stage: 32 real, four k8 steps
constexpr int ROW = 128;              // bytes of a column's stage: one 128-byte swizzle row
constexpr int PLANE = (WN / 8) * 1024;  // one TF32 plane of a stage's B: twelve 8-column atoms
constexpr int SLOT = 2 * PLANE;       // a stage's high and low planes
constexpr int SMEM_MAX = 232448;

// d (m64 x n96, fp32) = a (registers, TF32) . b (shared, TF32) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_n96(float (&d)[ACC], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// v -> its TF32 high part (cvt.rna: round to nearest, ties away; inf and
// NaN kept) and the rest, rounded to TF32 the same way on its bits (add half
// an ulp of TF32 to the magnitude, clear the low 13 bits): the rest is finite
// and small wherever v is finite, and where v is not the high part carries
// it. Two integer operations in place of the cvt's four.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = sm90::tf32(v);
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// one stage of B (one 128-byte swizzle row a column): descriptors of its
// high and low planes at k8 step ks
__device__ __forceinline__ uint64_t b_desc(uint32_t base, int ks) { return sm90::descriptor(base + ks * 32, 16, 1024) | sm90::SWIZZLE_128B; }

// Store the 2x2 blocks of one output channel n (columns 2n, 2n + 1) at four
// depth channels 4 ks .. 4 ks + 3 of a stage into the swizzled planes at dst:
// column 2n + p, 16-byte chunk 2 ks + r holds the four channels' entries of
// (depth part r, column part p): (0, 0) wr, (1, 0) -wi, (0, 1) wi, (1, 1) wr,
// from the splits (rh, rl) of wr and (ih, il) of wi (already conjugated where
// the product takes the conjugate). Lanes with (n / 4) odd store the other
// chunk first, so that eight lanes' stores hit eight distinct bank groups.
__device__ __forceinline__ void store_blocks(unsigned char* dst, int n, int ks, const uint32_t (&rh)[4], const uint32_t (&rl)[4], const uint32_t (&ih)[4],
                                             const uint32_t (&il)[4]) {
  constexpr uint32_t S = 0x80000000u;  // -v splits into -hi, -lo
  const int h = (n / 4) & 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = j & 1, r = (j >> 1) ^ h;
    const int c = 2 * n + p, q = 2 * ks + r;
    unsigned char* a = dst + c * ROW + ((q ^ (c % 8)) << 4);
    const bool re = p == r;
    const uint32_t sg = (!p && r) ? S : 0u;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      hi[t] = (re ? rh[t] : ih[t]) ^ sg;
      lo[t] = (re ? rl[t] : il[t]) ^ sg;
    }
    *reinterpret_cast<uint4*>(a) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(a + PLANE) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

enum Mode { FORWARD = 0, DATA_GRAD = 1 };

// What the mode-tile kernel reads and writes. FORWARD (K18): a = x, out = y,
// hout = o1 or null. DATA_GRAD (K19's data pass): a = dy, mask = y (the
// first product's input is dy * (y != 0)), hin = o1 (the relu's mask), hout
// = g1, out = dx.
struct TileArgs {
  const float* a;
  const float* mask;
  const float* hin;
  float* hout;
  float* out;
  const float* w1;
  const float* w2;
  const float* b1;
  const float* b2;
  Layout la, lm, lo;
  Params wp;
};

// A stage's raw weights in shared memory, (part, depth d, column n): K18
// reads its weights' columns contiguously, so the columns run fastest (d *
// 48 + n); K19 reads them transposed, depth contiguous, so the depth runs
// fastest, a column padded to 17 floats (n * 17 + d) so that the expansion's
// reads along the columns hit distinct banks. Either way the copying lanes
// walk the contiguous index.
template <int MODE>
struct Raw {
  static constexpr bool DEPTH_FASTEST = MODE == DATA_GRAD;
  static constexpr int PART = DEPTH_FASTEST ? PIECE * (KCH + 1) : KCH * PIECE;  // floats of one part
  static constexpr int SIZE = 2 * PART;                                         // floats of a stage
  __device__ __forceinline__ static int at(int p, int d, int n) { return p * PART + (DEPTH_FASTEST ? n * (KCH + 1) + d : d * PIECE + n); }
};
constexpr int RAW = Raw<1>::SIZE;  // the larger of the two
constexpr int RAW_RING = 4;        // raw stages in flight: copies run three stages ahead

// Shared memory of a mode-tile block: the expanded B (two stages), the raw
// weights' ring, the biases, and the park (48 slots a width piece of the
// hidden, for each of the 128 WG threads).
__host__ __forceinline__ size_t tile_smem_bytes(int bs, int hbs, int wg) {
  const int pieces = (hbs + PIECE - 1) / PIECE;
  return 2 * (size_t)SLOT + sizeof(float) * ((size_t)RAW_RING * RAW + 2 * (size_t)(bs + hbs) + (size_t)ACC * pieces * 128 * wg);
}

// Warpgroups a mode-tile block: two where the park fits, else one; 0 if
// neither fits (at a hidden width above 6 pieces, 288 channels).
__host__ __forceinline__ int tile_warpgroups(int bs, int hbs) {
  return tile_smem_bytes(bs, hbs, 2) <= SMEM_MAX ? 2 : tile_smem_bytes(bs, hbs, 1) <= SMEM_MAX ? 1 : 0;
}

__device__ __forceinline__ float shrink(float v, float lambd) {
  const float a = fabsf(v) - lambd;
  return a > 0.f ? copysignf(a, v) : 0.f;
}

// grid (tiles of 64 WG modes, nb, B), 128 WG threads. Product 1: depth bs,
// width hbs; product 2: depth hbs, width bs. The stages run in one sequence
// kt: product 1's pieces, then product 2's, each piece's stages in depth
// order.
template <int MODE, int WG>
__global__ void __launch_bounds__(128 * WG, 1) mixer_tile_kernel(TileArgs t, int M, int Wh, int nb, int bs, int hbs, Band band, float lambd) {
  constexpr int THREADS = 128 * WG;
  constexpr int ITEMS = (PIECE * 4 + THREADS - 1) / THREADS;  // weight items (output channel, k8 step) a thread a stage
  constexpr int COPIERS = 4 * PIECE;                             // threads that copy a stage's raw weights, 8 elements each
  constexpr int VT = (COPIERS + THREADS - 1) / THREADS;           // copiers a thread stands for
  extern __shared__ __align__(1024) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem + 2 * SLOT);  // [RAW_RING][part][depth][column]
  float* bias = raw + RAW_RING * RAW;                      // b1 (re, im) a hidden channel, then b2's
  float* park = bias + 2 * (bs + hbs);                     // [slot][thread]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int k = blockIdx.y, b = blockIdx.z;
  const int m0 = blockIdx.x * 64 * WG + (warp / 4) * 64 + (warp % 4) * 16 + gq;  // this thread's rows: m0 and m0 + 8
  const int rows[2] = {m0, m0 + 8};

  const int P1 = (hbs + PIECE - 1) / PIECE, S1 = (bs + KCH - 1) / KCH;
  const int P2 = (bs + PIECE - 1) / PIECE, S2 = (hbs + KCH - 1) / KCH;
  const int n1 = P1 * S1, nt = n1 + P2 * S2;

  // the products' B: element (depth d, column n) at W + p * sP + d * sD + n * sN
  // (K19: the other weight, transposed and conjugated)
  const bool conj = MODE == DATA_GRAD;
  const WLayout l1 = MODE == FORWARD ? t.wp.w1 : t.wp.w2, l2 = MODE == FORWARD ? t.wp.w2 : t.wp.w1;
  const float* W1 = (MODE == FORWARD ? t.w1 : t.w2) + k * l1.sK;
  const float* W2 = (MODE == FORWARD ? t.w2 : t.w1) + k * l2.sK;
  const long long sD1 = MODE == FORWARD ? l1.sR : l1.sC, sN1 = MODE == FORWARD ? l1.sC : l1.sR;
  const long long sD2 = MODE == FORWARD ? l2.sR : l2.sC, sN2 = MODE == FORWARD ? l2.sC : l2.sR;

  // a position in the sequence of stages: (product, piece, stage of the
  // piece), advanced one stage at a time (no division)
  struct Cursor {
    int pr, pc, st;
  };
  auto advance = [&](Cursor& c) {
    if (++c.st == (c.pr ? S2 : S1)) {
      c.st = 0;
      if (++c.pc == (c.pr ? P2 : P1)) c.pc = 0, c.pr = 1;
    }
  };

  // K19: o1 at this thread's accumulator positions of piece pc, copied into
  // the park slots its g1 will take (the relu's mask for the epilogue)
  auto copy_o1 = [&](int pc) {
#pragma unroll
    for (int c = 0; c < ACC / 4; ++c) {
      const int ch = pc * PIECE + 4 * c + tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = rows[h] < M && ch < hbs;
        const float* src = ok ? t.hin + hidden_at(b, k, ch, rows[h], nb, hbs, M) : t.hin;
        float* dst = park + (pc * ACC + 4 * c + 2 * h) * THREADS + tid;
        sm90::cp_async<4>(dst, src, ok);
        sm90::cp_async<4>(dst + THREADS, src + 1, ok);
      }
    }
  };

  // stage kt's raw weights into ring slot kt % RAW_RING, one commit group a
  // stage (empty past the last), 4-byte elements with the lanes along the
  // weight's contiguous axis (Raw): copier c takes, of both parts, column c %
  // 48 at depths c / 48 + 4 q (K18), or depth c % 16 at columns c / 16 + 12 q
  // (K19), q < 4. K19 adds a piece's o1 at its first stage.
  Cursor ic{0, 0, 0};  // the next stage to issue
  auto issue = [&](int kt) {
    if (kt < nt) {
      const int pr = ic.pr, pc = ic.pc, st = ic.st;
      advance(ic);
      // a block's weight spans less than 2^31 floats: 32-bit offsets past the stage's corner
      const int sP = (int)(pr ? l2.sP : l1.sP), sD = (int)(pr ? sD2 : sD1), sN = (int)(pr ? sN2 : sN1);
      const float* W = pr ? W2 : W1;
      const float* corner = W + (long long)(st * KCH) * sD + (long long)(pc * PIECE) * sN;
      const int depth = (pr ? hbs : bs) - st * KCH, width = (pr ? bs : hbs) - pc * PIECE;
      float* dst = raw + (kt % RAW_RING) * RAW;
#pragma unroll
      for (int i = 0; i < VT; ++i) {
        const int c = tid + i * THREADS;
        if (VT * THREADS != COPIERS && c >= COPIERS) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int d, n;
          if constexpr (Raw<MODE>::DEPTH_FASTEST) {
            d = c % KCH, n = c / KCH + (COPIERS / KCH) * q;
          } else {
            n = c % PIECE, d = c / PIECE + (COPIERS / PIECE) * q;
          }
          const bool ok = n < width && d < depth;
          const float* src = corner + d * sD + n * sN;
          sm90::cp_async<4>(dst + Raw<MODE>::at(0, d, n), ok ? src : W, ok);
          sm90::cp_async<4>(dst + Raw<MODE>::at(1, d, n), ok ? src + sP : W, ok);
        }
      }
      if (MODE == DATA_GRAD && pr == 0 && st == 0) copy_o1(pc);
    }
    sm90::cp_async_commit();
  };
  // stage kt's blocks from its raw weights into B slot kt & 1
  auto stage_w = [&](int kt) {
    const float* src = raw + (kt % RAW_RING) * RAW;
    unsigned char* dst = smem + (kt & 1) * SLOT;
#pragma unroll
    for (int e = 0; e < ITEMS; ++e) {
      const int item = tid + e * THREADS;
      if (PIECE * 4 % THREADS != 0 && item >= PIECE * 4) continue;
      const int n = item % PIECE, ks = item / PIECE;
      uint32_t rh[4], rl[4], ih[4], il[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float wr = src[Raw<MODE>::at(0, 4 * ks + u, n)], wi = src[Raw<MODE>::at(1, 4 * ks + u, n)];
        split(wr, rh[u], rl[u]);
        split(conj ? -wi : wi, ih[u], il[u]);
      }
      store_blocks(dst, n, ks, rh, rl, ih, il);
    }
    sm90::fence_proxy_async();
  };

  // the first product's input at this thread's rows for one stage: the (re,
  // im) pair of channel 16 st + 4 ks + tq (and in K19 y's, the mask)
  const int cb = k * bs;
  const float* arow[2] = {t.a + b * t.la.sB + m0 * t.la.sM + cb * t.la.sC, t.a + b * t.la.sB + (m0 + 8) * t.la.sM + cb * t.la.sC};
  float2 av[4][2], mv[4][2];
  auto fetch_a = [&](int st) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int ch = st * KCH + 4 * ks + tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = rows[h] < M && ch < bs;
        av[ks][h] = ok ? *reinterpret_cast<const float2*>(arow[h] + ch * t.la.sC) : make_float2(0.f, 0.f);
        if constexpr (MODE == DATA_GRAD)
          mv[ks][h] = ok ? *reinterpret_cast<const float2*>(t.mask + b * t.lm.sB + rows[h] * t.lm.sM + (cb + ch) * t.lm.sC) : make_float2(0.f, 0.f);
      }
    }
  };

  float acc[ACC], part[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = part[j] = 0.f;

  // the band (forward): whether this thread's rows are kept
  bool kept[2] = {true, true};
  if constexpr (MODE == FORWARD) {
#pragma unroll
    for (int h = 0; h < 2; ++h) kept[h] = rows[h] < M && band.kept(rows[h] / Wh, rows[h] % Wh);
  }

  // product 1's epilogue of piece pc: bias and split relu (forward; o1 kept
  // when asked), or the relu's mask from o1 (K19: g1); the hidden values
  // parked in this thread's slots 48 pc + j
  auto epilogue1 = [&](int pc) {
#pragma unroll
    for (int c = 0; c < ACC / 4; ++c) {
      const int ch = pc * PIECE + 4 * c + tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = rows[h];
        float* pk = park + (pc * ACC + 4 * c + 2 * h) * THREADS + tid;
        float re = acc[4 * c + 2 * h], im = acc[4 * c + 2 * h + 1];
        const bool ok = m < M && ch < hbs;
        if constexpr (MODE == FORWARD) {
          if (ch < hbs) {
            re += bias[2 * ch];
            im += bias[2 * ch + 1];
          }
          re = fmaxf(re, 0.f);
          im = fmaxf(im, 0.f);
          if (t.hout != nullptr && ok) *reinterpret_cast<float2*>(t.hout + hidden_at(b, k, ch, m, nb, hbs, M)) = make_float2(re, im);
        } else {
          re = pk[0] > 0.f ? re : 0.f;
          im = pk[THREADS] > 0.f ? im : 0.f;
          if (ok) *reinterpret_cast<float2*>(t.hout + hidden_at(b, k, ch, m, nb, hbs, M)) = make_float2(re, im);
        }
        pk[0] = re;
        pk[THREADS] = im;
      }
    }
  };
  // product 2's epilogue of piece pc: bias, band and soft-shrink (forward:
  // y), or dx as it is
  auto epilogue2 = [&](int pc) {
#pragma unroll
    for (int c = 0; c < ACC / 4; ++c) {
      const int ch = pc * PIECE + 4 * c + tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = rows[h];
        if (m >= M || ch >= bs) continue;
        float re = acc[4 * c + 2 * h], im = acc[4 * c + 2 * h + 1];
        if constexpr (MODE == FORWARD) {
          re = kept[h] ? shrink(re + bias[2 * (hbs + ch)], lambd) : 0.f;
          im = kept[h] ? shrink(im + bias[2 * (hbs + ch) + 1], lambd) : 0.f;
        }
        *reinterpret_cast<float2*>(t.out + b * t.lo.sB + m * t.lo.sM + (cb + ch) * t.lo.sC) = make_float2(re, im);
      }
    }
  };

  // the biases (zeros where there are none: K19, AFNOv2)
  for (int i = tid; i < 2 * (bs + hbs); i += THREADS) {
    const int ch = i / 2, p = i % 2;
    float v = 0.f;
    if (MODE == FORWARD && t.b1 != nullptr) v = ch < hbs ? t.b1[t.wp.b1.at(k, p, 0, ch)] : t.b2[t.wp.b2.at(k, p, 0, ch - hbs)];
    bias[i] = v;
  }
  for (int j = 0; j < RAW_RING - 1; ++j) issue(j);
  fetch_a(0);
  sm90::cp_async_wait<RAW_RING - 3>();  // stages 0 and 1
  __syncthreads();
  stage_w(0);
  __syncthreads();
  Cursor cur{0, 0, 0};  // stage kt
  for (int kt = 0; kt < nt; ++kt, advance(cur)) {
    const int pr = cur.pr, pc = cur.pc, st = cur.st;
    // the ring slot refilled here was last read two barriers ago
    issue(kt + RAW_RING - 1);
    // this stage's A fragments: k8 step ks, (row, k tq | k tq + 4) =
    // channel 4 ks + tq's (re, im) at rows m0 and m0 + 8
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      float v[4];
      if (pr == 0) {
        float2 p0 = av[ks][0], p1 = av[ks][1];
        if constexpr (MODE == DATA_GRAD) {
          p0 = make_float2(mv[ks][0].x != 0.f ? p0.x : 0.f, mv[ks][0].y != 0.f ? p0.y : 0.f);
          p1 = make_float2(mv[ks][1].x != 0.f ? p1.x : 0.f, mv[ks][1].y != 0.f ? p1.y : 0.f);
        }
        v[0] = p0.x, v[1] = p1.x, v[2] = p0.y, v[3] = p1.y;
      } else {
        const float* pk = park + (4 * (4 * st + ks)) * THREADS + tid;
        v[0] = pk[0], v[1] = pk[2 * THREADS], v[2] = pk[THREADS], v[3] = pk[3 * THREADS];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) split(v[q], ah[ks][q], al[ks][q]);
    }
    const bool more = kt + 1 < nt;
    if (more && kt + 1 < n1) fetch_a(st + 1 < S1 ? st + 1 : 0);
    const uint32_t base = sm90::smem_addr(smem + (kt & 1) * SLOT);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t bh = b_desc(base, ks), bl = b_desc(base + PLANE, ks);
      wgmma_n96(part, al[ks], bh, ks > 0);
      wgmma_n96(part, ah[ks], bl, 1);
      wgmma_n96(part, ah[ks], bh, 1);
    }
    sm90::wgmma_commit();
    // the next stage's blocks, while the wgmmas run (its B slot was last
    // read by the previous stage's wgmmas, done before the previous barrier;
    // its raw weights landed before it)
    if (more) stage_w(kt + 1);
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sm90::pin(ah[ks][q]);
        sm90::pin(al[ks][q]);
      }
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      sm90::pin(part[j]);
      acc[j] += part[j];
    }
    if (st == (pr == 0 ? S1 : S2) - 1) {
      if (pr == 0) {
        // (K19: the piece's o1 copies, in its first stage's group, landed
        // by the end of the stage before it)
        epilogue1(pc);
      } else {
        epilogue2(pc);
      }
#pragma unroll
      for (int j = 0; j < ACC; ++j) acc[j] = 0.f;
    }
    // this thread's copies of stage kt + 2, then everyone's
    sm90::cp_async_wait<RAW_RING - 3>();
    __syncthreads();
  }
}

// Launch the mode-tile kernel: WG warpgroups where its park fits
// (tile_warpgroups), 64 WG modes a block.
template <int MODE>
int launch_tile(const TileArgs& t, int B, int M, int Wh, int nb, int bs, int hbs, Band band, float lambd, cudaStream_t s) {
  const int wg = tile_warpgroups(bs, hbs);
  if (wg == 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)tile_smem_bytes(bs, hbs, wg);
  auto kernel = wg == 2 ? mixer_tile_kernel<MODE, 2> : mixer_tile_kernel<MODE, 1>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + 64 * wg - 1) / (64 * wg), nb, B);
  kernel<<<grid, 128 * wg, smem, s>>>(t, M, Wh, nb, bs, hbs, band, lambd);
  return (int)cudaGetLastError();
}

}  // namespace afno
