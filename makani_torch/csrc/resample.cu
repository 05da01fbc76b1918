// Bilinear resampling on the sphere: kernel K7 of makani_torch.
//
// Replaces makani_tpu/ops/resample.py ResampleS2.__call__ (the gather
// method), which XLA runs as index gathers and elementwise passes:
//
//   y[b, ho, wo, c] = y0 + (y1 - y0) * lon_w[wo], with
//   yj = x[b, i, kj, c] + (x[b, i + 1, kj, c] - x[b, i, kj, c]) * lat_w[ho],
//   i = lat_idx[ho], k0 = lon_idx0[wo], k1 = lon_idx1[wo] (periodic).
//
// x is channels-last with any strides (at the FCN3 decoders it is the first
// 585 of 677 channels: a pixel every 2708 bytes, 4-byte aligned); y is
// contiguous (B, Hout, Wout, C).
//
// What bounds it on the card: the bytes. At the atmo decoder (B 2, 360 x 720
// -> 721 x 1440, C 585, fp32) it writes 4.86 GB and needs 1.2 GB of input:
// 1.81 ms at 3.35 TB/s, with ~6 operations per output.
//
// The design: a block makes TW consecutive output columns of one output row
// (b, ho), a contiguous run of TW * C outputs. It reads lat_idx and lat_w
// once and stages the span of input columns that its tile needs
// (lon_idx0[wo0] onward, wrapping from the last column to column 0; the
// wrapper computes the widest span over the tiles from the tables): each
// thread loads its elements of the two input rows, four elements in flight,
// and writes their latitude lerp into shared memory, so each input element
// is read from device memory (or L2) once per block, not once per output
// that uses it, and each output needs two shared loads and one lerp. Every
// offset inside a row is 32-bit, and (column, channel) pairs are advanced by
// additions, with no division per element. Each warp then makes 32 * VEC
// consecutive outputs (VEC = 16 bytes / element size): lanes take
// consecutive elements, reading shared memory without bank conflicts, put
// them in a warp scratch, and store them 16 bytes a lane along the output
// run where it is 16-byte aligned (each output row starts aligned at the
// decoders; 4 or 2 bytes a lane otherwise).
//
// Measured on an H100 (chip_smoke.py's K7 line, sweep_k2_k7.py; PERF.md): a
// 16-column tile (27.8 KB of shared memory, up to 8 blocks an SM) at the
// atmo decoder; cp.async staging of both rows (twice the shared memory), a
// second staging buffer, and tiles of 2 or 4 output rows sharing their
// input rows each measured slower there. The store stream alone takes
// ~1.5 ms of the kernel's time.
//
// Arithmetic: fp32 inputs in the plain version's order and rounding
// (__fsub_rn/__fmul_rn/__fadd_rn: no contraction into FMAs), so the fp32
// kernel repeats the plain version's three elementwise passes exactly; bf16
// inputs are widened to fp32 and the output is rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;
using mt::from_f32;
using mt::to_f32;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float lerp(float a, float b, float w) { return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), w)); }

// (w, c) of a flat index e = w * C + c, advanced by a fixed step (q, r) = divmod(step, C)
struct Cursor {
  int w, c;
  __device__ __forceinline__ void advance(int q, int r, int C) {
    w += q;
    c += r;
    if (c >= C) {
      c -= C;
      ++w;
    }
  }
};

// shared memory: the latitude-lerped row [span][C] fp32, the tile's column
// table {offset of k0 in the span times C, of k1, lon_w}, and the warps'
// scratch of 32 * VEC outputs each
int smem_bytes(int C, int TW, int span) { return ((span * C * 4 + 15) & ~15) + 16 * TW + WARPS * 16 * 32; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    resample_kernel(const T* __restrict__ x, T* __restrict__ y, const int* __restrict__ lat_idx, const float* __restrict__ lat_w,
                    const int* __restrict__ lon_idx0, const int* __restrict__ lon_idx1, const float* __restrict__ lon_w, int Hout, int Wout, int Win,
                    int C, long long sB, long long sH, int sW, int sC, int TW, int span) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNK = 32 * VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_elems = span * C;
  float* mid = reinterpret_cast<float*>(smem);
  int4* cols = reinterpret_cast<int4*>(smem + ((row_elems * 4 + 15) & ~15));
  T* scratch = reinterpret_cast<T*>(cols + TW);

  const int wo0 = blockIdx.x * TW, ho = blockIdx.y, b = blockIdx.z;
  const int tw = min(TW, Wout - wo0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int start = lon_idx0[wo0];

  // input rows lat_idx[ho] and lat_idx[ho] + 1, columns start .. start +
  // span - 1 (mod Win), lerped along the latitude on the way into mid; four
  // elements' loads in flight a thread
  {
    const T* src0 = x + b * sB + lat_idx[ho] * sH;
    const float lw = lat_w[ho];
    const int q = THREADS / C, r = THREADS % C;
    Cursor cur{tid / C, tid % C};
#pragma unroll 4
    for (int e = tid; e < row_elems; e += THREADS) {
      const int col = start + cur.w < Win ? start + cur.w : start + cur.w - Win;
      const T* src = src0 + col * sW + cur.c * sC;
      mid[e] = lerp(to_f32(src[0]), to_f32(src[sH]), lw);
      cur.advance(q, r, C);
    }
  }
  for (int i = tid; i < tw; i += THREADS) {
    int d0 = lon_idx0[wo0 + i] - start, d1 = lon_idx1[wo0 + i] - start;
    d0 += d0 < 0 ? Win : 0;
    d1 += d1 < 0 ? Win : 0;
    cols[i] = make_int4(d0 * C, d1 * C, __float_as_int(lon_w[wo0 + i]), 0);
  }
  __syncthreads();

  // the tile's outputs, a contiguous run of tw * C: each warp makes CHUNK
  // consecutive ones at a time (lane-consecutive, so the reads of mid hit
  // 32 banks), gathers them in its scratch and stores 16 bytes a lane
  const int n_out = tw * C;
  T* y_tile = y + (((long long)b * Hout + ho) * Wout + wo0) * C;
  const bool aligned = reinterpret_cast<uintptr_t>(y_tile) % 16 == 0;
  T* scr = scratch + warp * CHUNK;
  const int q32 = 32 / C, r32 = 32 % C;
  const int skip = (WARPS - 1) * CHUNK, q_skip = skip / C, r_skip = skip % C;
  const int e_first = warp * CHUNK + lane;
  Cursor cur{e_first / C, e_first % C};
  for (int base = warp * CHUNK; base < n_out; base += WARPS * CHUNK) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      if (base + 32 * v + lane < n_out) {
        const int4 cw = cols[cur.w];
        scr[32 * v + lane] = from_f32<T>(lerp(mid[cw.x + cur.c], mid[cw.y + cur.c], __int_as_float(cw.z)));
      }
      cur.advance(q32, r32, C);
    }
    __syncwarp();
    const int e = base + lane * VEC;
    if (aligned && e + VEC <= n_out) {
      *reinterpret_cast<uint4*>(y_tile + e) = *reinterpret_cast<const uint4*>(scr + lane * VEC);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        if (e + v < n_out) y_tile[e + v] = scr[lane * VEC + v];
    }
    __syncwarp();
    cur.advance(q_skip, r_skip, C);
  }
}

template <typename T>
int launch(const void* x, void* y, const int* li, const float* lw, const int* k0, const int* k1, const float* v, int B, int Hout, int Wout, int Win,
           int C, long long sB, long long sH, int sW, int sC, int TW, int span, cudaStream_t s) {
  const int smem = smem_bytes(C, TW, span);
  cudaError_t err = cudaFuncSetAttribute(resample_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Wout + TW - 1) / TW, Hout, B);
  resample_kernel<T><<<grid, THREADS, smem, s>>>(static_cast<const T*>(x), static_cast<T*>(y), li, lw, k0, k1, v, Hout, Wout, Win, C, sB, sH, sW, sC,
                                                 TW, span);
  return (int)cudaGetLastError();
}

}  // namespace

// The shared memory K7 asks for: the lerped row of span columns, the column
// table and the warps' scratch (the wrapper picks the tile width with it).
extern "C" int mt_resample_smem_bytes(int C, int TW, int span) { return smem_bytes(C, TW, span); }

// dtype: 0 float32, 1 bfloat16. x: (B, Hin, Win, C) with element strides
// sB, sH, sW, sC; y: (B, Hout, Wout, C) contiguous; the int32 and float32
// tables on the same device. A block makes TW output columns of one output
// row; span: the widest run of input columns a tile needs (from
// lon_idx0[first column of the tile], modulo Win). Returns
// cudaGetLastError() after the launch, or an argument error without
// launching.
extern "C" int mt_resample(int dtype, const void* x, void* y, const void* lat_idx, const void* lat_w, const void* lon_idx0, const void* lon_idx1,
                           const void* lon_w, int B, int Hout, int Wout, int Win, int C, long long sB, long long sH, long long sW, long long sC,
                           int TW, int span, void* stream) {
  if (B <= 0 || Hout <= 0 || Wout <= 0 || Win <= 0 || C <= 0 || TW <= 0 || span <= 0 || span > Win || B > 65535 || Hout > 65535 ||
      (long long)(Win - 1) * sW + (long long)(C - 1) * sC >= (1LL << 31) || sW < 0 || sC < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* li = static_cast<const int*>(lat_idx);
  const float* lw = static_cast<const float*>(lat_w);
  const int* k0 = static_cast<const int*>(lon_idx0);
  const int* k1 = static_cast<const int*>(lon_idx1);
  const float* v = static_cast<const float*>(lon_w);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, li, lw, k0, k1, v, B, Hout, Wout, Win, C, sB, sH, (int)sW, (int)sC, TW, span, s);
  return launch<float>(x, y, li, lw, k0, k1, v, B, Hout, Wout, Win, C, sB, sH, (int)sW, (int)sC, TW, span, s);
}
