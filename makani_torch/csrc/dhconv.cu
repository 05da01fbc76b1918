// Dense channels-last dhconv contraction: kernel K3 of makani_torch.
//
// Replaces makani_tpu/models/common/contractions.py contract_dense_s (dhconv,
// dense, channels-last: 'bxygi,giox->bxygo') and the four real einsums of
// cmul_einsum_s it runs on the TPU's matrix unit:
//
//   out[b, l, m, g, o] = sum_i x[b, l, m, g, i] * w[l, g, i, o]   (complex)
//
// on split-complex data (trailing re/im pair). The weight is read in the
// layout (L, G, Ci, Co, 2), which the Python wrapper makes once per weight,
// not per call.
//
// The same kernel, in its input-gradient mode (GRAD_INPUT), is the dhconv's
// dx, which the JAX package leaves to jax.grad through the same einsums:
//
//   dx[b, l, m, g, i] = sum_o g[b, l, m, g, o] * conj(w[l, g, i, o])
//
// reading the forward's cached weight (L, G, Ci, Co, 2) as it lies: for the
// dx product the depth runs over o and the output columns over i, and the
// cached layout holds the o of one i contiguous, which is the K-major order
// wgmma's B operand wants. The weight tile's loads change their lanes (four
// lanes along o, eight columns i a warp: 32-byte runs, whole sectors) and
// the staging writes the conjugate's blocks [[wr, -wi], [wi, wr]] in place
// of the forward's [[wr, wi], [-wi, wr]]; nothing else differs, and no
// conjugate-transposed weight is made in device memory. (Eight lanes along
// o, 64-byte runs, with the core matrices 16 bytes further apart to keep
// the stores' banks apart, was no faster: sweep_k3dx_k10.py.)
//
// One real GEMM per (b, l, g) on the interleaved layout: the channels-last
// input (M, Ci, 2) is already a row-major real (M x 2Ci) matrix and the
// output (M, Co, 2) a real (M x 2Co) matrix, and the complex product is the
// real product with the (2Ci x 2Co) matrix whose 2x2 blocks are
// [[wr, wi], [-wi, wr]]: 4 M Ci Co multiply-adds, as the four real products,
// with no de-interleaving. That block matrix is built while the weight tile
// is staged into shared memory (k contiguous per column: wgmma's K-major B
// operand); it never exists in device memory.
//
// What bounds it on the card: at the SFNO's internal grid (L 240, M 241,
// C 384) a layer is ~68 GFLOP against ~0.6 GB of traffic, so it is bound by
// the matrix units. It runs on the tensor cores with wgmma (m64n128, the
// weight read from shared memory, x from registers): bf16 input in one bf16
// pass with fp32 accumulation; fp32 input as 3xTF32, each operand split
// into a TF32 high part and a TF32 residual (cvt.rna), with hi.hi + hi.lo +
// lo.hi accumulated in fp32 (lo.lo, below fp32's last bit, is dropped).
// 3xTF32 keeps fp32 accuracy, which plain TF32 (about three decimal digits)
// does not: the kernel agrees with the fp32 plain version to 1e-5 of
// max|ref| and the whole-model gates rest on that. Its bound is three TF32
// passes, 3 x 68 GFLOP / 495 TFLOP/s = 0.41 ms, below the 1.02 ms the same
// product needs at the fp32 FMA pipes' 67 TFLOP/s. The tensor cores add
// into an fp32 accumulator with truncation, which biases a long sum (1e-5 of
// max|ref| at FCN3's 1354-deep product): each 32-deep stage is summed into
// fresh registers and added to the total with a rounded fp32 add.
//
// Tiles: a 256-thread block (two warpgroups of 64 rows) holds 128 rows x
// 128 real output columns (64 complex channels) in 32-deep stages (16
// complex input channels). The weight tile is split (fp32) and expanded in
// registers and stored in wgmma's core-matrix layout, padded by 16 bytes per
// 8 columns so that the stores hit distinct banks; x is read into registers
// with ldmatrix. Two stages: the next stage's x tile is copied asynchronously
// (cp.async) and its weight tile loaded while the current stage's wgmmas
// run. FCN3's odd widths (Ci = 677: 5416-byte fp32 rows) are not 16-byte
// aligned, so x is copied as fp32 or bf16 pairs (8 or 4 bytes), the only
// alignment every width guarantees; the ragged depth and rows are
// zero-filled in shared memory, never padded in device memory. It computes
// every (l, m) exactly, the m > l entries included, so its result does not
// depend on the input's zero triangle.
//
// What holds it below that bound: every 64-row wgmma reads its weight slice
// from shared memory, the fp32 passes three times over, and the staging
// writes come on top, so shared-memory bandwidth, and each stage's wait for
// its wgmmas before the partial is added, leave the tensor cores idle part
// of the time. bf16's single pass leaves too little tensor work per stage
// to cover the next stage's loads with one block per SM: it is the slower
// of the two against cuBLAS.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;       // rows (orders m) per block: two warpgroups of 64
constexpr int BN = 128;       // real output columns per block (64 complex channels)
constexpr int BK = 32;        // real depth per stage (16 complex input channels)
constexpr int THREADS = 256;  // two warpgroups
constexpr int ACC = BN / 2;   // fp32 accumulators per thread of an m64n128 wgmma
constexpr int A_COPIES = BM * (BK / 2) / THREADS;       // pair copies of x per thread per stage
constexpr int B_LOADS = (BK / 2) * (BN / 2) / THREADS;  // complex weights per thread per stage

// x rows in shared memory: 36 fp32 words or 40 bf16 halves, so that the
// ldmatrix phases (8 rows x 16 bytes) hit 32 distinct banks. The weight in
// wgmma's K-major core-matrix layout without swizzle: core matrices along k
// LBO bytes apart, 8-column groups SBO bytes apart (padded by 16).
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int LD = BK + 4;
  static constexpr int PLANES = 2;      // TF32 high and low parts
  static constexpr int MIN_BLOCKS = 1;  // the stage partials double the accumulators
  static constexpr int KW = 8;          // depth of one wgmma
  using B = uint32_t;
  using Pair = float2;
};
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int LD = BK + 8;
  static constexpr int PLANES = 1;
  static constexpr int MIN_BLOCKS = 1;
  static constexpr int KW = 16;
  using B = __nv_bfloat16;
  using Pair = __nv_bfloat162;
};

template <typename T>
struct Layout {
  static constexpr int E = 16 / (int)sizeof(T);                 // elements per core-matrix row
  static constexpr int LBO = CORE;                              // bytes between core matrices along k
  static constexpr int SBO = (BK / E) * LBO + 16;               // bytes between 8-column groups
  static constexpr int PLANE = (BN / 8) * SBO;                  // bytes of one weight plane per stage
  static constexpr int A_BYTES = 2 * BM * Tile<T>::LD * (int)sizeof(T);
  static constexpr int SMEM = A_BYTES + 2 * Tile<T>::PLANES * PLANE;
};

// four 8x8 matrices of 16-bit pairs: lane l gives the address of row l % 8
// of matrix l / 8 and receives, of each, the word (row l / 4, column l % 4):
// with the matrices (rows 0-7 | 8-15) x (first | second half of the depth),
// the A fragment of a 16-row slice of wgmma (and mma.sync)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// shared-memory matrix descriptor of the weight tile
template <typename T>
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return sm90::descriptor(addr, Layout<T>::LBO, Layout<T>::SBO);
}

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

// x: (B, L, M, G, Ci, 2); out: (B, L, M, G, Co, 2); w: (L, G, Ci, Co, 2),
// or for GRAD_INPUT (L, G, Co, Ci, 2), the forward's weight with the depth
// Ci (its o) innermost, conjugated as it is staged
template <typename T, bool GRAD_INPUT>
__global__ void __launch_bounds__(THREADS, Tile<T>::MIN_BLOCKS)
    dhconv_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int L, int M, int G, int Ci, int Co) {
  using BT = typename Tile<T>::B;
  using Pair = typename Tile<T>::Pair;
  using Lay = Layout<T>;
  constexpr int LD = Tile<T>::LD;
  constexpr int PLANES = Tile<T>::PLANES;
  constexpr int KW = Tile<T>::KW;
  constexpr int KSTEPS = BK / KW;
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);        // [2][BM][LD]: x, rows m, depth k
  unsigned char* Bs = smem + Lay::A_BYTES;  // [2][PLANES][PLANE]: expanded weight, core matrices

  const int g = blockIdx.z % G;
  const int l = (blockIdx.z / G) % L;
  const int b = blockIdx.z / (G * L);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;  // real output column
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = (warp / 4) * 64 + (warp % 4) * 16;  // this warp's 16 rows of the tile
  const int gq = lane / 4, tq = lane % 4;              // accumulator fragment coordinates
  const int K2 = 2 * Ci, N2 = 2 * Co;

  const long long x_row = (long long)G * K2;
  const long long o_row = (long long)G * N2;
  const T* x_base = x + ((long long)b * L + l) * M * x_row + (long long)g * K2;
  const T* w_base = w + ((long long)l * G + g) * Ci * N2;
  T* o_base = out + ((long long)b * L + l) * M * o_row + (long long)g * N2;

  // x tile: 16 consecutive threads copy one row's 32 values as 16 pairs
  auto copy_x = [&](int stage, int k0) {
    T* dst = As + stage * BM * LD;
#pragma unroll
    for (int e = 0; e < A_COPIES; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / (BK / 2), kp = (idx % (BK / 2)) * 2;
      const int m = m0 + r, k = k0 + kp;
      const bool ok = m < M && k < K2;
      cp_async<2 * sizeof(T)>(dst + r * LD + kp, ok ? x_base + m * x_row + k : x_base, ok);
    }
  };

  // weight tile: 16 complex rows i x 64 complex columns o, load e of a
  // thread at (w_i(e), w_o(e)); each group of 8 lanes reads 8 consecutive
  // (wr, wi) pairs of one row, or for GRAD_INPUT (i innermost) each group of
  // 4 lanes 4 consecutive pairs of one column. Either way a warp's stores
  // below hit every bank pair twice at most
  auto w_o = [&](int e) { return warp * 8 + (GRAD_INPUT ? lane / 4 : lane % 8); };
  auto w_i = [&](int e) { return (GRAD_INPUT ? lane % 4 : lane / 8) + 4 * e; };
  Pair wreg[B_LOADS];
  auto fetch_w = [&](int i0) {
#pragma unroll
    for (int e = 0; e < B_LOADS; ++e) {
      const int o = n0 / 2 + w_o(e), i = i0 + w_i(e);
      if (i < Ci && o < Co) {
        const long long at = GRAD_INPUT ? (long long)o * Ci + i : (long long)i * Co + o;
        wreg[e] = *reinterpret_cast<const Pair*>(w_base + at * 2);
      } else {
        wreg[e].x = wreg[e].y = T(0.f);
      }
    }
  };
  // column 2o holds (wr, -wi) at depth (2i, 2i+1), column 2o+1 holds (wi, wr)
  // (GRAD_INPUT, the conjugate: (wr, wi) and (-wi, wr)); both lie in one core
  // matrix, 16 bytes apart
  auto stage_w = [&](int stage) {
    unsigned char* dst = Bs + stage * PLANES * Lay::PLANE;
#pragma unroll
    for (int e = 0; e < B_LOADS; ++e) {
      const int n = 2 * w_o(e), k = 2 * w_i(e);
      unsigned char* p = dst + (n / 8) * Lay::SBO + (k / Lay::E) * Lay::LBO + (n % 8) * 16 + (k % Lay::E) * (int)sizeof(BT);
      if constexpr (PLANES == 2) {
        const float wr = wreg[e].x, wi = wreg[e].y;
        const float v[4] = {wr, GRAD_INPUT ? wi : -wi, GRAD_INPUT ? -wi : wi, wr};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          hi[q] = tf32(v[q]);
          lo[q] = tf32(v[q] - __uint_as_float(hi[q]));
        }
        *reinterpret_cast<uint2*>(p) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(p + 16) = make_uint2(hi[2], hi[3]);
        *reinterpret_cast<uint2*>(p + Lay::PLANE) = make_uint2(lo[0], lo[1]);
        *reinterpret_cast<uint2*>(p + Lay::PLANE + 16) = make_uint2(lo[2], lo[3]);
      } else {
        const __nv_bfloat16 wr = wreg[e].x, wi = wreg[e].y;
        *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(wr, GRAD_INPUT ? wi : __hneg(wi));
        *reinterpret_cast<__nv_bfloat162*>(p + 16) = __halves2bfloat162(GRAD_INPUT ? __hneg(wi) : wi, wr);
      }
    }
    fence_proxy_async();
  };

  float acc[ACC], part[ACC];
#pragma unroll
  for (int q = 0; q < ACC; ++q) acc[q] = part[q] = 0.f;

  // ldmatrix roles of this lane: row lm_r of matrix lm_j
  const int lm_j = lane / 8, lm_r = lane % 8;
  const int nk = (K2 + BK - 1) / BK;
  fetch_w(0);
  copy_x(0, 0);
  cp_async_commit();
  stage_w(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    // the other stage was last read before the previous barrier
    if (more) {
      copy_x(cur ^ 1, (kt + 1) * BK);
      cp_async_commit();
      fetch_w((kt + 1) * (BK / 2));
    }
    // this warp's x slice for the whole stage, in registers
    const T* a_s = As + cur * BM * LD + (row0 + lm_r + (lm_j & 1) * 8) * LD + (lm_j >> 1) * (KW / 2);
    uint32_t ah[KSTEPS][4], al[KSTEPS][4];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      ldmatrix_x4(ah[ks], a_s + ks * KW);
      if constexpr (PLANES == 2) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = __uint_as_float(ah[ks][q]);
          ah[ks][q] = tf32(v);
          al[ks][q] = tf32(v - __uint_as_float(ah[ks][q]));
        }
      }
    }
    const uint32_t b_base = smem_addr(Bs + cur * PLANES * Lay::PLANE);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      // one wgmma spans two core matrices along k
      const uint64_t bh = b_descriptor<T>(b_base + ks * 2 * Lay::LBO);
      if constexpr (PLANES == 2) {
        const uint64_t bl = b_descriptor<T>(b_base + Lay::PLANE + ks * 2 * Lay::LBO);
        wgmma_tf32(part, al[ks], bh, ks > 0);
        wgmma_tf32(part, ah[ks], bl, 1);
        wgmma_tf32(part, ah[ks], bh, 1);
      } else {
        wgmma_bf16(acc, ah[ks], bh, 1);
      }
    }
    wgmma_commit();
    if (more) stage_w(cur ^ 1);  // while the wgmmas run
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
    cp_async_wait<0>();
    __syncthreads();
  }

  // accumulator j: row gq (+8 for j % 4 >= 2), column (j / 4) * 8 + 2 tq
  // (+1 for odd j); the pairs (c, c + 1), c even, are the (re, im) of one
  // output channel
  const int r = m0 + row0 + gq;
#pragma unroll
  for (int j8 = 0; j8 < BN / 8; ++j8) {
    const int c = n0 + j8 * 8 + 2 * tq;
    if (c >= N2) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r + 8 * h;
      if (m >= M) continue;
      T* dst = o_base + m * o_row + c;
      const float re = acc[4 * j8 + 2 * h], im = acc[4 * j8 + 2 * h + 1];
      if constexpr (PLANES == 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(re, im);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(re, im);
      }
    }
  }
}

template <typename T, bool GRAD_INPUT>
int launch(const void* x, const void* w, void* out, int B, int L, int M, int G, int Ci, int Co, cudaStream_t s) {
  const int smem = Layout<T>::SMEM;
  auto kernel = dhconv_kernel<T, GRAD_INPUT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((2 * Co + BN - 1) / BN, (M + BM - 1) / BM, B * L * G);
  kernel<<<grid, THREADS, smem, s>>>(static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), L, M, G, Ci, Co);
  return (int)cudaGetLastError();
}

template <bool GRAD_INPUT>
int dispatch(int dtype, const void* x, const void* w, void* out, int B, int L, int M, int G, int Ci, int Co, void* stream) {
  if (B <= 0 || L <= 0 || M <= 0 || G <= 0 || Ci <= 0 || Co <= 0 || (long long)B * L * G > 65535 || (M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, GRAD_INPUT>(x, w, out, B, L, M, G, Ci, Co, s);
  if (dtype == 1) return launch<__nv_bfloat16, GRAD_INPUT>(x, w, out, B, L, M, G, Ci, Co, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x (B, L, M, G, Ci, 2), w (L, G, Ci, Co, 2),
// out (B, L, M, G, Co, 2). Returns cudaGetLastError() after the launch.
extern "C" int mt_dhconv_contract(int dtype, const void* x, const void* w, void* out, int B, int L, int M, int G, int Ci, int Co, void* stream) {
  return dispatch<false>(dtype, x, w, out, B, L, M, G, Ci, Co, stream);
}

// The input gradient: g (B, L, M, G, Co, 2) and the forward's weight w (L, G,
// Ci, Co, 2) give dx (B, L, M, G, Ci, 2) = g . conj(w)^T. Returns
// cudaGetLastError() after the launch.
extern "C" int mt_dhconv_grad_input(int dtype, const void* g, const void* w, void* dx, int B, int L, int M, int G, int Ci, int Co, void* stream) {
  return dispatch<true>(dtype, g, w, dx, B, L, M, G, Co, Ci, stream);
}
