// Weight gradient of the dense channels-last dhconv: kernel K9 of makani_torch.
//
// Replaces the weight half of jax.grad through
// makani_tpu/models/common/contractions.py contract_dense_s (dhconv, dense,
// channels-last: 'bxygi,giox->bxygo' as the four real einsums of
// cmul_einsum_s), which XLA computes as einsums:
//
//   dw[g, i, o, l] = sum_{b, m} conj(x[b, l, m, g, i]) * gy[b, l, m, g, o]   (complex)
//
// on split-complex data (trailing re/im pair): dwr = sum xr gr + xi gi,
// dwi = sum xr gi - xi gr. It writes the parameter's own layout
// (G, Ci, Co, L, 2), so no copy follows.
//
// What bounds it on the card: at the SFNO training step (B 3, L 120, M 121,
// C 384) a layer is 8 B M L Ci Co = 51.4 GFLOP against ~0.32 GB of traffic
// (x and gy read once, dw written once), so it is bound by operations:
// 0.77 ms a layer on the fp32 FMA pipes (67 TFLOP/s), 0.31 ms in 3xTF32 on
// the tensor cores. The depth of each product is short (B M = 363) against
// its 384 x 384 outputs per degree, so the work is spread over (l, tiles of
// i x o), never over the depth: every output is one block's sum in a fixed
// order, with no atomics and no second pass.
//
// Design: one real GEMM per (l, g) on the tensor cores, as K3 (dhconv.cu)
// runs the forward. Rows are the Ci input channels, columns the 2 Co
// interleaved (o, re/im) outputs, the depth the 2 B M (b, m, re/im) entries:
// the complex product is the real one with gy's 2x2 blocks
// [[gr, gi], [gi, -gr]] (rows: x's re and im parts; columns: dw's re and im
// parts), built while gy's tile is staged into shared memory, never in
// device memory. wgmma m64n128 with fp32 accumulation: bf16 input in one
// bf16 pass; fp32 input as 3xTF32 (hi.hi + hi.lo + lo.hi, cvt.rna splits),
// each 32-deep stage summed into fresh registers and added to the total
// with a rounded fp32 add, against the tensor cores' truncating adds (K3's
// and K8's scheme).
//
// Neither operand arrives K-major: x and gy keep the channel contiguous and
// the depth (b, m) G C 2 elements apart, and TF32 wgmma reads shared memory
// K-major only. The depth order inside one wgmma is free, so it is chosen
// to spare x the transpose: x is the A operand, read from registers, and a
// k8 step (fp32) takes depth rows n .. n+3 with k = t <-> (n+t, re) and
// k = 4+t <-> (n+t, im), so the fragment (row i, k t | k 4+t) of a thread is
// x's (xr, xi) pair at (n+t, i): one 8-byte shared load of x's tile staged
// as it lies (rows n, padded so that a half warp's loads hit distinct
// banks). A bf16 k16 step takes k = 2t+p <-> (n+t, p) over rows n .. n+7,
// again x's own pairs. gy is the B operand from shared memory: staged as it
// lies too, then expanded by each thread for one output channel at four
// depth rows into its two columns, [gr..], [gi..] and [gi..], [-gr..]. fp32
// splits them into TF32 high and low planes in wgmma's 128-byte swizzle (a
// column's 32-deep stage is one 128-byte row; unswizzled core matrices cost
// K8 a third of its time); bf16 keeps padded core matrices.
//
// Copies: every depth row of x's and gy's tiles is one bulk copy (the TMA
// without a tensor map: 16-byte aligned addresses and sizes, no stride
// rule) from the row's 16-byte aligned start at or below its first channel
// pair, one 16-byte chunk wider than the tile; the row's shift (in pairs)
// goes to a small table that the fragment loads and the expansion read.
// So FCN3's odd widths (Ci = 677: 5416-byte fp32 rows, not 16-byte
// aligned) copy like the aligned ones. Lanes 0-3 of each of the 8 warps
// issue 4 of a stage's 32 row copies, each arriving on the ring slot's
// mbarrier with its bytes; a lane copies the same row of every stage and
// carries that row's (b, m) from stage to stage, so no table grows with the
// depth and any B M fits (and no division a row sits in the copies' path).
// Copies run two stages ahead (a 3-slot ring); a stage's expansion runs
// while the previous stage's wgmmas do. (Copies issued by every thread, 16
// bytes each, would spend most of a stage's instructions on their
// addresses and bounds.)
//
// What holds it above its bound: each stage's fixed work in the 8 warps
// (fragment loads and TF32 splits, fences, the partial sums, the barrier
// and the copies' waits) and the staging, not the tensor cores: with the wgmmas cut out it
// takes most of its time (sweep_k9_k13.py, PERF.md).
//
// Tiles and order: a 256-thread block (two warpgroups of 64 rows) holds 128
// input x 64 output channels of two degrees l0 and l0 + 1 of one g, one
// after the other through the same copy ring, in stages of 16 depth rows
// (32 real entries); the first degree's sums are parked in shared memory
// (each thread its own) until the second is done, so each (i, o) is
// written as 16 contiguous bytes (dw is l-contiguous: one degree alone
// writes 8-byte pieces L 8 bytes apart, each its own sector request).
// Blocks run in groups of LGROUP such degree pairs, the pairs fastest, then
// the tiles: the blocks in flight share x's and gy's rows of a few degrees
// in L2, and their stores meet there (other orders, and one degree a
// block: sweep_k9_k13.py; every order gives the same bits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;       // input channels i per block: two warpgroups of 64 rows
constexpr int BN = 128;       // real output columns per block (64 output channels o)
constexpr int NS = 16;        // depth rows n = (b, m) per stage: 32 real entries
constexpr int BK = 2 * NS;    // real depth per stage
constexpr int THREADS = 256;  // two warpgroups
constexpr int ACC = BN / 2;   // fp32 accumulators per thread of an m64n128 wgmma
constexpr int RING = 3;       // stages of x and gy in flight: copies run two stages ahead
constexpr int LB = 2;         // degrees a block (1 or 2)
constexpr int LGROUP = 4;     // units of LB degrees a group of blocks (see the block order above)
static_assert(LB == 1 || LB == 2, "a block parks at most one degree's sums");

template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int PLANES = 2;       // TF32 high and low parts of gy's blocks
  static constexpr int KW = 8;           // real depth of one wgmma: 4 rows n
  static constexpr int LDX = 2 * BM + 8;  // floats a staged x row: 264 words, 8 mod 32
  static constexpr int LDG = BN + 8;      // floats a staged gy row
  static constexpr int WIDE = 2;          // channel pairs a 16-byte chunk
  static constexpr bool SWIZZLE = true;   // a column's 32-deep stage is one 128-byte swizzle row
  using B = uint32_t;
};
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int PLANES = 1;
  static constexpr int KW = 16;            // 8 rows n
  static constexpr int LDX = 2 * BM + 16;  // bf16 a staged x row: 136 words, 8 mod 32
  static constexpr int LDG = BN + 8;
  static constexpr int WIDE = 4;
  static constexpr bool SWIZZLE = false;  // 64-byte columns: core matrices, padded
  using B = __nv_bfloat16;
};

template <typename T>
struct Layout {
  static constexpr int E = 16 / (int)sizeof(typename Tile<T>::B);  // elements per core-matrix row
  static constexpr int ROW = BK * (int)sizeof(typename Tile<T>::B);  // bytes of a column's stage
  // bytes between 8-column groups: a swizzle atom, or 8-column core
  // matrices padded by 16 bytes so that the expanding stores hit distinct banks
  static constexpr int SBO = Tile<T>::SWIZZLE ? 8 * ROW : (BK / E) * CORE + 16;
  static constexpr int PLANE = (BN / 8) * SBO;                      // bytes of one gy block plane
  static constexpr int X_BYTES = NS * Tile<T>::LDX * (int)sizeof(T);
  static constexpr int G_BYTES = NS * Tile<T>::LDG * (int)sizeof(T);  // gy's tile as it lies
  static constexpr int SLOT = X_BYTES + G_BYTES;                      // one stage of the copy ring
  static constexpr int BLOCKS = Tile<T>::PLANES * PLANE;              // gy's expanded blocks, one stage
  static constexpr int PARK = ACC * THREADS * 4;                      // one degree's accumulators
  static constexpr int SMEM = 2 * BLOCKS + RING * SLOT + PARK;
  // a row's chunks (one more than the tile's width: a row starts at its
  // chunk-aligned address) fit its staged row
  static_assert(2 * (BM + Tile<T>::WIDE) <= Tile<T>::LDX && 2 * (BN / 2 + Tile<T>::WIDE) <= Tile<T>::LDG, "staged rows too short");
  static_assert(X_BYTES % 16 == 0 && G_BYTES % 16 == 0 && BLOCKS % 16 == 0, "stage tiles must stay 16-byte aligned");
};
static_assert(Layout<float>::SMEM <= 232448, "the ring exceeds a block's shared memory");
static_assert(Layout<float>::ROW == 128 && Layout<float>::PLANE % 1024 == 0, "the swizzle atoms must be 1024-byte aligned");

// d (m64 x n128, fp32) = a (registers) . b (shared) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[ACC], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x: (B, L, M, G, Ci, 2); gy: (B, L, M, G, Co, 2); dw: (G, Ci, Co, L, 2) fp32
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    dhconv_grad_weight_tc_kernel(const T* __restrict__ x, const T* __restrict__ gy, float* __restrict__ dw, int B, int L, int M, int G, int Ci,
                                 int Co, int tiles_o, int tiles) {
  using Lay = Layout<T>;
  constexpr int PLANES = Tile<T>::PLANES;
  constexpr int LDX = Tile<T>::LDX;
  constexpr int LDG = Tile<T>::LDG;
  constexpr int KW = Tile<T>::KW;
  constexpr int WIDE = Tile<T>::WIDE;
  constexpr int KSTEPS = BK / KW;
  extern __shared__ __align__(1024) unsigned char smem[];
  // gy's expanded blocks (two stages, 1024-byte aligned), the copy ring, and
  // the first degree's accumulators, parked while the block runs its second
  auto blocks = [&](int kt) { return smem + (kt & 1) * Lay::BLOCKS; };
  auto slot_x = [&](int kt) { return reinterpret_cast<T*>(smem + 2 * Lay::BLOCKS + (kt % RING) * Lay::SLOT); };
  auto slot_g = [&](int kt) { return reinterpret_cast<T*>(smem + 2 * Lay::BLOCKS + (kt % RING) * Lay::SLOT + Lay::X_BYTES); };
  float* park = reinterpret_cast<float*>(smem + 2 * Lay::BLOCKS + RING * Lay::SLOT);
  // each stage's rows: x's and gy's shifts (in pairs) from their 16-byte
  // aligned starts; a ring slot's copies complete on its barrier
  __shared__ int shift_x[RING][NS], shift_g[RING][NS];
  __shared__ uint64_t ready[RING];

  // block -> (g, degrees l0 .. l0 + nd - 1, tile): units of LB degrees, in
  // groups of LGROUP units, the last group shorter (all units if there are
  // fewer); within a group the units fastest, then the tiles
  const int LU = (L + LB - 1) / LB;
  const int g = blockIdx.x / (tiles * LU);
  const int b_in = blockIdx.x % (tiles * LU);
  const int ug = b_in / (tiles * LGROUP), n_full = LU / LGROUP;
  const int n_ug = ug < n_full ? LGROUP : LU - n_full * LGROUP;
  const int r_in = b_in - ug * tiles * LGROUP;
  const int tile = r_in / n_ug, l0 = (ug * LGROUP + r_in % n_ug) * LB;
  const int nd = min(LB, L - l0);
  const int i0 = (tile / tiles_o) * BM, o0 = (tile % tiles_o) * (BN / 2);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = (warp / 4) * 64 + (warp % 4) * 16;  // this warp's 16 rows i of the tile
  const int gq = lane / 4, tq = lane % 4;              // fragment coordinates
  const int N = B * M;
  const int nk = (N + NS - 1) / NS, nt = nd * nk;  // stages a degree, of the block
  const long long x_row = (long long)G * Ci * 2, g_row = (long long)G * Co * 2;
  const T* x_end = x + (long long)B * L * M * x_row;
  const T* g_end = gy + (long long)B * L * M * g_row;

  // stage kt's x and gy tiles, as they lie, into ring slot kt % RING: lanes
  // 0-3 of warp w copy row j = 4 w + lane (x's depth rows for j < NS, gy's
  // for the rest), each as one bulk copy from the row's 16-byte aligned
  // start at or below its first channel pair (the shift, in pairs, goes to
  // the stage's table), one 16-byte chunk wider than the tile, cut at the
  // tensor's end (a last piece under 16 bytes by plain loads). Rows past
  // the depth are zero-filled. Each of the 32 arrives on the slot's barrier
  // with its bytes. The stages are issued in order, so a lane's row r
  // advances by NS depth rows a stage and restarts at r with each degree:
  // (rb, rm) is its (b, m).
  int rb = 0, rm = 0;
  auto issue = [&](int kt) {
    if (kt >= nt || lane >= 4) return;
    const int q = kt % RING, j = 4 * warp + lane, r = j % NS;
    const bool is_x = j < NS;
    const int d = kt / nk, s = kt - d * nk, n = s * NS + r;
    rm = s == 0 ? r : rm + NS;
    rb = s == 0 ? 0 : rb;
    while (rm >= M) {
      rm -= M;
      ++rb;
    }
    T* dst = is_x ? slot_x(kt) + r * LDX : slot_g(kt) + r * LDG;
    const int chunks = is_x ? BM / WIDE + 1 : BN / 2 / WIDE + 1;
    const T* src = nullptr;
    int bytes = 0;
    if (n < N) {
      const long long row = ((long long)rb * L + l0 + d) * M + rm;  // (b, l0 + d, m)
      const long long e = is_x ? row * x_row + ((long long)g * Ci + i0) * 2 : row * g_row + ((long long)g * Co + o0) * 2;  // even: a pair
      const int sh = (int)((e / 2) % WIDE);
      (is_x ? shift_x : shift_g)[q][r] = sh;
      src = (is_x ? x : gy) + e - 2 * sh;
      const long long left = (long long)((is_x ? x_end : g_end) - src) * (long long)sizeof(T);
      bytes = left < chunks * 16 ? (int)left & ~15 : chunks * 16;
      for (int k = bytes / (int)sizeof(T); k < left / (long long)sizeof(T) && k < chunks * 16 / (int)sizeof(T); ++k) dst[k] = src[k];
    } else {
      (is_x ? shift_x : shift_g)[q][r] = 0;
      for (int c = 0; c < chunks; ++c) reinterpret_cast<uint4*>(dst)[c] = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();  // the slot's earlier reads before the copy engine's writes
    mbar_arrive_expect_tx(&ready[q], bytes);
    if (bytes) bulk_copy(dst, src, bytes, &ready[q]);
  };
  auto wait = [&](int kt) { mbar_wait(&ready[kt % RING], (kt / RING) & 1); };

  // gy's blocks of stage kt: this thread's output channel go at depth rows
  // 4 gs .. 4 gs + 3, columns 2 go (dwr) and 2 go + 1 (dwi). fp32: 16-byte
  // chunk 2 gs of a column holds the four rows' re parts, 2 gs + 1 their im
  // parts, chunk q of column c at (q ^ c % 8) in its 128-byte row; each
  // store takes one of the four (column, chunk) pairs, the lanes with go / 4
  // odd the other chunk first, so that 8 lanes' stores hit 8 distinct bank
  // groups. bf16: core matrix gs holds the four rows' (re, im) pairs.
  const int go = tid % (BN / 2), gs = tid / (BN / 2);
  auto expand = [&](int kt) {
    const T* src = slot_g(kt) + (4 * gs) * LDG + 2 * go;
    const int* mr = shift_g[kt % RING] + 4 * gs;
    if constexpr (PLANES == 2) {
      uint32_t rh[4], rl[4], ih[4], il[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 v = *reinterpret_cast<const float2*>(src + t * LDG + 2 * mr[t]);
        rh[t] = tf32(v.x);
        rl[t] = tf32(v.x - __uint_as_float(rh[t]));
        ih[t] = tf32(v.y);
        il[t] = tf32(v.y - __uint_as_float(ih[t]));
      }
      constexpr uint32_t S = 0x80000000u;  // -v splits into -hi, -lo
      const int h = (go / 4) & 1;
      unsigned char* dst = blocks(kt);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // (column 2 go + p, chunk 2 gs + r): (0, 0) gr, (0, 1) gi, (1, 0) gi, (1, 1) -gr
        const int p = k & 1, r = (k >> 1) ^ h;
        const int c = 2 * go + p, q = 2 * gs + r;
        unsigned char* a = dst + c * Lay::ROW + ((q ^ (c % 8)) << 4);
        const bool im = p ^ r;
        const uint32_t sg = (p && !im) ? S : 0u;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          hi[t] = (im ? ih[t] : rh[t]) ^ sg;
          lo[t] = (im ? il[t] : rl[t]) ^ sg;
        }
        *reinterpret_cast<uint4*>(a) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(a + Lay::PLANE) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    } else {
      uint32_t col0[4], col1[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(src + t * LDG + 2 * mr[t]);
        col0[t] = bits(v);
        col1[t] = bits(__halves2bfloat162(v.y, __hneg(v.x)));
      }
      unsigned char* q = blocks(kt) + (go / 4) * Lay::SBO + (go % 4) * 32 + gs * CORE;
      *reinterpret_cast<uint4*>(q) = make_uint4(col0[0], col0[1], col0[2], col0[3]);
      *reinterpret_cast<uint4*>(q + 16) = make_uint4(col1[0], col1[1], col1[2], col1[3]);
    }
    fence_proxy_async();
  };

  float acc[ACC], part[ACC];
#pragma unroll
  for (int q = 0; q < ACC; ++q) acc[q] = part[q] = 0.f;

  if (tid == 0) {
    for (int q = 0; q < RING; ++q) mbar_init(&ready[q], 2 * NS);
    mbar_init_fence();
  }
  __syncthreads();  // the barriers
  for (int s = 0; s < RING - 1; ++s) issue(s);
  wait(0);
  expand(0);
  __syncthreads();
  for (int kt = 0; kt < nt; ++kt) {
    // the slot refilled here was last read before the previous barrier
    issue(kt + RING - 1);
    wait(kt);
    // each k step: this warp's x fragments, from x's tile as it lies, then
    // its wgmmas, so that the next step's loads overlap them
    const T* xs = slot_x(kt) + 2 * (row0 + gq);
    const int* mx = shift_x[kt % RING];
    const uint32_t b_base = smem_addr(blocks(kt));
    uint32_t ah[KSTEPS][4], al[KSTEPS][4];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      if constexpr (PLANES == 2) {
        const int r = 4 * ks + tq;
        const float* xr = xs + r * LDX + 2 * mx[r];
        const float2 p0 = *reinterpret_cast<const float2*>(xr);
        const float2 p1 = *reinterpret_cast<const float2*>(xr + 16);
        const float v[4] = {p0.x, p1.x, p0.y, p1.y};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ah[ks][q] = tf32(v[q]);
          al[ks][q] = tf32(v[q] - __uint_as_float(ah[ks][q]));
        }
      } else {
        const int r = 8 * ks + tq;
        const uint32_t* r0 = reinterpret_cast<const uint32_t*>(xs + r * LDX + 2 * mx[r]);
        const uint32_t* r1 = reinterpret_cast<const uint32_t*>(xs + (r + 4) * LDX + 2 * mx[r + 4]);
        ah[ks][0] = r0[0];
        ah[ks][1] = r0[8];
        ah[ks][2] = r1[0];
        ah[ks][3] = r1[8];
      }
      wgmma_fence();
      if constexpr (PLANES == 2) {
        // one k8 step: 32 bytes of each swizzled 128-byte column row
        const uint64_t bh = descriptor(b_base + ks * 32, 16, Lay::SBO) | SWIZZLE_128B;
        const uint64_t bl = descriptor(b_base + Lay::PLANE + ks * 32, 16, Lay::SBO) | SWIZZLE_128B;
        wgmma_tf32(part, al[ks], bh, ks > 0);
        wgmma_tf32(part, ah[ks], bl, 1);
        wgmma_tf32(part, ah[ks], bh, 1);
      } else {
        // one k16 step spans two core matrices along k
        wgmma_bf16(acc, ah[ks], descriptor(b_base + ks * 2 * CORE, CORE, Lay::SBO), 1);
      }
      wgmma_commit();
    }
    // the next stage's blocks, while the wgmmas run
    if (kt + 1 < nt) {
      wait(kt + 1);
      expand(kt + 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        pin(ah[ks][q]);
        if constexpr (PLANES == 2) pin(al[ks][q]);
      }
#pragma unroll
    for (int q = 0; q < ACC; ++q) {
      if constexpr (PLANES == 2) {
        pin(part[q]);
        acc[q] += part[q];
      } else {
        pin(acc[q]);
      }
    }
    // the first degree done: park its sums (this thread's own slots)
    if (nd == 2 && kt == nk - 1) {
#pragma unroll
      for (int q = 0; q < ACC; ++q) {
        park[q * THREADS + tid] = acc[q];
        acc[q] = 0.f;
      }
    }
    __syncthreads();
  }

  // accumulator j: row gq (+8 for j % 4 >= 2), column (j / 4) * 8 + 2 tq
  // (+1 for odd j); the pair (c, c + 1), c even, is output channel c / 2.
  // Two degrees: 16 bytes (l0, l0 + 1) at once where L is even.
  const bool wide_out = nd == 2 && L % 2 == 0;  // l0 is even
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + row0 + gq + 8 * h;
    if (i >= Ci) continue;
    float* drow = dw + (((long long)g * Ci + i) * Co) * L * 2 + (long long)l0 * 2;
#pragma unroll
    for (int j8 = 0; j8 < BN / 8; ++j8) {
      const int o = o0 + j8 * 4 + tq;
      if (o >= Co) continue;
      const int q = 4 * j8 + 2 * h;
      float* dst = drow + (long long)o * L * 2;
      if (nd == 1) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[q], acc[q + 1]);
      } else {
        const float2 first = make_float2(park[q * THREADS + tid], park[(q + 1) * THREADS + tid]);
        if (wide_out) {
          *reinterpret_cast<float4*>(dst) = make_float4(first.x, first.y, acc[q], acc[q + 1]);
        } else {
          *reinterpret_cast<float2*>(dst) = first;
          *reinterpret_cast<float2*>(dst + 2) = make_float2(acc[q], acc[q + 1]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* gy, void* dw, int B, int L, int M, int G, int Ci, int Co, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(dhconv_grad_weight_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<T>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_i = (Ci + BM - 1) / BM, tiles_o = (2 * Co + BN - 1) / BN;
  const long long blocks = (long long)G * ((L + LB - 1) / LB) * tiles_i * tiles_o;
  if (blocks > 2147483647LL || (long long)tiles_i * tiles_o * LGROUP > 2147483647LL || (long long)B * M > 2147483647LL / 2)
    return (int)cudaErrorInvalidValue;
  dhconv_grad_weight_tc_kernel<T><<<(unsigned)blocks, THREADS, Layout<T>::SMEM, s>>>(static_cast<const T*>(x), static_cast<const T*>(gy),
                                                                                   static_cast<float*>(dw), B, L, M, G, Ci, Co, tiles_o, tiles_i * tiles_o);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x and gy); x (B, L, M, G, Ci, 2), gy (B, L,
// M, G, Co, 2) contiguous, dw float32 (G, Ci, Co, L, 2), all three 16-byte
// aligned; every entry of dw written. Returns cudaGetLastError() after the
// launch, or an argument error.
extern "C" int mt_dhconv_grad_weight(int dtype, const void* x, const void* gy, void* dw, int B, int L, int M, int G, int Ci, int Co, void* stream) {
  if (B <= 0 || L <= 0 || M <= 0 || G <= 0 || Ci <= 0 || Co <= 0) return (int)cudaErrorInvalidValue;
  // rows are copied from their 16-byte aligned starts: the tensors must be aligned
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(gy) % 16 || reinterpret_cast<uintptr_t>(dw) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, gy, dw, B, L, M, G, Ci, Co, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, gy, dw, B, L, M, G, Ci, Co, s);
  return (int)cudaErrorInvalidValue;
}

