// FCN3's processor channel mix: kernel K8 of makani_torch.
//
// Replaces the two-stage DISCO conv's mix of makani_tpu/models/networks/
// fourcastnet3.py DiscoConv.__call__ (:125, einsum "bgikhw,goik->bhwgo" with
// one group, channels-last output), which the JAX package leaves to XLA as
// an fp32 einsum:
//
//   y[r, o] = sum_j t[r, j] * w[o, j]        r < R = B*H*W, j < D = C*K, o < N
//
// t is the basis responses of K5 (ops/disco.py responses_cl), one row of
// C*K floats a pixel; w the conv weight (N, C*K). At the FCN3 processor this
// is 518400 x 6093 x 677, 4.28 TFLOP, eight calls a forecast step.
//
// What bounds it on the card: the operations. The bytes (12.6 GB of t read
// once, 1.4 GB written) take 4.2 ms at 3.35 TB/s; the product takes 63.8
// ms on the fp32 FMA pipes (67 TFLOP/s) and 25.9 ms on the tensor cores as
// three TF32 passes (3 x 4.28 TFLOP at 495 TFLOP/s). TF32 alone keeps about
// three decimal digits, so the kernel runs 3xTF32 (hi.hi + hi.lo + lo.hi, as
// K1 and K3 do): each operand is split into a TF32 high part and a TF32
// residual (cvt.rna), lo.lo, below fp32's last bit, is dropped. The tensor
// cores add into their fp32 accumulator with truncation, a bias that grows
// with the depth (6093 here, against K3's 1354): every 32-deep stage is
// summed into fresh registers and added to the total with a rounded fp32
// add.
//
// Design. wgmma m64n136k8 with both operands K-major, as TF32 requires: the
// rows of t are depth-contiguous (the A operand, from registers), and so
// are the rows of w (the B operand, from shared memory). A 256-thread block
// (two warpgroups of 64 rows) computes 128 rows x 136 columns; 677 columns
// take five column tiles (680, 0.4% padding; 128 would take six, 13%). The
// column tile's width is set by the registers: 68 accumulators and 68 stage
// partials a thread, so one block an SM (255 registers, a few bytes
// spilled). The weight is a constant between calls: the wrapper keeps its
// TF32 high and low planes in device memory (ops/disco_kernels.py
// mix_planes), zero-padded to 680 rows and a depth of 32, so that every
// weight copy is a 16-byte cp.async and the kernel never splits the weight.
// Its stage tiles lie in wgmma's 128-byte swizzle (a 32-deep stage is one
// 128-byte row a column): measured on an H100, the same kernel with the
// unswizzled core-matrix layout K1 and K3 use took 80.5 ms against 52.8 ms
// (PERF.md). t is split in registers after ldmatrix. The response rows are
// 6093 floats, only 4-byte aligned, so K5 writes them 6096 floats apart
// (ops/disco.py RESPONSE_ALIGN): every row of t is 16-byte aligned and
// copied in 16-byte pieces, the depth tail (6093 = 190 x 32 + 13)
// zero-filled by the copy itself, never read from the pad. A four-stage
// cp.async ring (18 KB of t and 34 KB of planes a stage, 208 KB) keeps
// three stages of copies in flight while one is multiplied; within a stage
// each 8-deep step is its own wgmma group, so only two steps' A fragments
// are held at a time. Consecutive blocks take the five column tiles of one
// row tile, so t is read from device memory about once and from L2 five
// times; the planes (33 MB) stay in L2. Rows and columns beyond R and N are
// masked at the store, which goes straight from the accumulators
// (677-float output rows are only 4-byte aligned).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;       // rows r per block: two warpgroups of 64 (wgmma M)
constexpr int BN = 136;       // columns o per block (wgmma N)
constexpr int BK = 32;        // depth j per stage
constexpr int THREADS = 256;  // two warpgroups
constexpr int STAGES = 4;     // cp.async ring
constexpr int ACC = BN / 2;   // fp32 accumulators per thread of an m64n136 wgmma
constexpr int KSTEPS = BK / 8;
constexpr int LDA = BK + 4;                // t stage [r][j], floats: the ldmatrix phases hit 32 banks
constexpr int A_BYTES = BM * LDA * 4;      // bytes of the t stage
constexpr int ROW = BK * 4;                // bytes of a weight row per stage: one 128-byte swizzle row
constexpr int SBO = 8 * ROW;               // bytes between 8-row groups (swizzle atoms) of a weight plane
constexpr int PLANE = BN * ROW;            // bytes of one weight plane per stage
constexpr int STAGE_BYTES = A_BYTES + 2 * PLANE;
constexpr int SMEM = STAGES * STAGE_BYTES;
static_assert(SMEM <= 232448, "the ring exceeds a block's shared memory");
static_assert(A_BYTES % 1024 == 0 && PLANE % 1024 == 0, "the swizzle atoms must be 1024-byte aligned");

// d (m64 x n136, fp32) = a (registers) . b (shared) + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67}, {%68, %69, %70, %71}, %72, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// four 8x8 matrices of 16-bit pairs (here: 8 rows x 4 fp32 each): lane l
// gives the address of row l % 8 of matrix l / 8 and receives, of each, the
// word (row l / 4, column l % 4); with the matrices (rows 0-7 | 8-15) x
// (depth 0-3 | 4-7) that is the A fragment of a 16-row slice of a k8 wgmma
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// t: (R, D) rows lda floats apart (lda % 4 == 0, 16-byte aligned);
// planes: (2, Np, Dp) TF32 high and low parts of w, zero-padded; out (R, N)
__global__ void __launch_bounds__(THREADS, 1)
    disco_mix_kernel(const float* __restrict__ t, long long lda, const uint32_t* __restrict__ planes, float* __restrict__ out, int R, int D,
                     int N, int Np, int Dp, int n_ntiles) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int nt = blockIdx.x % n_ntiles, rt = blockIdx.x / n_ntiles;
  const int r0 = rt * BM, n0 = nt * BN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;
  const float* t_base = t + (long long)r0 * lda;
  const uint32_t* w_hi = planes + (long long)n0 * Dp;
  const uint32_t* w_lo = w_hi + (long long)Np * Dp;
  const int nk = (D + BK - 1) / BK;  // Dp >= nk * BK

  auto load_stage = [&](int s, int kt) {
    unsigned char* st = smem + s * STAGE_BYTES;
    const int k0 = kt * BK;
    // t: eight 16-byte pieces a row, eight consecutive threads one row
#pragma unroll
    for (int e0 = 0; e0 < BM * (BK / 4); e0 += THREADS) {
      const int e = e0 + tid, r = e / (BK / 4), kc = e % (BK / 4);
      const int k = k0 + 4 * kc;
      const int bytes = r0 + r < R ? 4 * max(0, min(4, D - k)) : 0;
      cp_async_zfill16(st + (r * LDA + 4 * kc) * 4, bytes ? t_base + r * lda + k : t, bytes);
    }
    // weight planes in wgmma's 128-byte swizzle: row o's 16-byte piece kc
    // lies at piece kc ^ (o % 8) of its 128 bytes; eight consecutive threads
    // take eight rows o of one depth piece (distinct banks), a warp four
    // pieces (64 contiguous bytes of each row)
#pragma unroll
    for (int e0 = 0; e0 < 2 * BN * (BK / 4); e0 += THREADS) {
      const int e = e0 + tid;
      if (e < 2 * BN * (BK / 4)) {
        const int o8 = e % 8, kc = (e / 8) % (BK / 4), grp = e / (8 * (BK / 4));
        const int plane = grp / (BN / 8), o = (grp % (BN / 8)) * 8 + o8;
        const uint32_t* src = (plane ? w_lo : w_hi) + (long long)o * Dp + k0 + kc * 4;
        cp_async<16>(st + A_BYTES + plane * PLANE + o * ROW + ((kc ^ o8) << 4), src, true);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  float acc[ACC], part[ACC];
#pragma unroll
  for (int q = 0; q < ACC; ++q) acc[q] = part[q] = 0.f;
  const int row0 = (warp / 4) * 64 + (warp % 4) * 16;  // this warp's 16 rows of the tile
  const int lm_j = lane / 8, lm_r = lane % 8;          // ldmatrix: row lm_r of matrix lm_j

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage kt have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have; stage kt - 1 is no longer read
    if (kt + STAGES - 1 < nk) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();

    const unsigned char* st = smem + (kt % STAGES) * STAGE_BYTES;
    const float* a_s = reinterpret_cast<const float*>(st) + (row0 + lm_r + (lm_j & 1) * 8) * LDA + (lm_j >> 1) * 4;
    const uint32_t b_base = smem_addr(st + A_BYTES);
    // one wgmma group per 8-deep step; the A fragments of two steps live at
    // a time: a step's registers are reused once its group has completed
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t(&h)[4] = ah[ks & 1];
      uint32_t(&l)[4] = al[ks & 1];
      ldmatrix_x4(h, a_s + ks * 8);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = __uint_as_float(h[q]);
        h[q] = tf32(v);
        l[q] = tf32(v - __uint_as_float(h[q]));
      }
      // one wgmma reads 32 bytes of each row: the step's offset into the
      // swizzle rows (the hardware applies the swizzle to the address)
      const uint64_t bh = descriptor(b_base + ks * 32, 16, SBO) | SWIZZLE_128B;
      const uint64_t bl = descriptor(b_base + PLANE + ks * 32, 16, SBO) | SWIZZLE_128B;
      wgmma_fence();
      wgmma_tf32(part, l, bh, ks > 0);
      wgmma_tf32(part, h, bl, 1);
      wgmma_tf32(part, h, bh, 1);
      wgmma_commit();
      if (ks > 0) {
        wgmma_wait<1>();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          pin(ah[(ks - 1) & 1][q]);
          pin(al[(ks - 1) & 1][q]);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      pin(ah[(KSTEPS - 1) & 1][q]);
      pin(al[(KSTEPS - 1) & 1][q]);
    }
#pragma unroll
    for (int q = 0; q < ACC; ++q) {
      pin(part[q]);
      acc[q] += part[q];
    }
  }
  cp_async_wait<0>();

  // accumulator j: row gq (+8 for j % 4 >= 2), column (j / 4) * 8 + 2 tq
  // (+1 for odd j)
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int r = r0 + row0 + gq + 8 * ((j / 2) & 1);
    const int o = n0 + (j / 4) * 8 + 2 * tq + (j & 1);
    if (r < R && o < N) out[(long long)r * N + o] = acc[j];
  }
}

}  // namespace

// t: float32 (R, D), rows lda floats apart, lda % 4 == 0 and t 16-byte
// aligned; planes: (2, Np, Dp) TF32 high and low parts of the weight (N, D),
// zero-padded, Np a multiple of 136, Dp of 32; out: float32 (R, N)
// contiguous. Returns cudaGetLastError() after the launch, or an argument
// error without launching.
extern "C" int mt_disco_mix(const void* t, long long lda, const void* planes, void* out, int R, int D, int N, int Np, int Dp, void* stream) {
  if (R <= 0 || D <= 0 || N <= 0 || lda < D || lda % 4 || Np < N || Np % BN || Dp < D || Dp % BK) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(t) | reinterpret_cast<uintptr_t>(planes)) % 16 || reinterpret_cast<uintptr_t>(out) % 4)
    return (int)cudaErrorMisalignedAddress;
  const int n_ntiles = Np / BN;
  const long long blocks = (long long)((R + BM - 1) / BM) * n_ntiles;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(disco_mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  disco_mix_kernel<<<(unsigned)blocks, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), lda, static_cast<const uint32_t*>(planes), static_cast<float*>(out), R, D, N, Np, Dp, n_ntiles);
  return (int)cudaGetLastError();
}
