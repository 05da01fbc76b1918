// Instance normalization, channels-last: kernel K4 of makani_torch.
//
// Replaces makani_tpu/models/common/layer_norm.py InstanceNorm2d (:78-122,
// the default two-pass path; the same arithmetic as ops/norm.py _fwd_impl),
// which the JAX package leaves to XLA as reductions:
//
//   per (b, c): mean and variance over the valid pixels (latitude rows below
//   nlat_phys), y = (x - mean) / sqrt(var + eps) rounded to x's dtype, then
//   y * w + b with a rounding to x's dtype after each operation.
//
// Statistics are fp32 and never E[x^2] - E[x]^2: each thread runs Welford's
// update over its pixels, a block merges its threads' (count, mean, M2) with
// Chan's formula, and the blocks' partials are merged the same way. The
// division and the square root are IEEE round-to-nearest, and so is every
// rounding of the affine step (__fmul_rn / __fadd_rn: no contraction into an
// FMA; __float2bfloat16_rn for bf16), as the plain version computes them.
//
// What bounds it on the card: the bytes. At the SFNO flagship's full
// resolution (1, 721, 1440, 384) bf16 the tensor is 797 MB, read once and
// written once at best (0.476 ms at 3.35 TB/s); a norm that reads it twice
// from device memory cannot beat 0.714 ms. At the internal grid (1, 240,
// 480, 384) it is 88.5 MB, and the launches, barriers and grid tails weigh
// as much as the bytes. So one launch does the whole norm, and reads x from
// device memory once where it fits on chip or in L2:
//
// * A persistent cooperative grid, one block an SM, walks the channel groups
//   of CG channels (and the batch) in turn. For each group every block
//   reduces its slice of pixels, writes its partial, and the grid meets at a
//   barrier; one warp a channel merges the blocks' partials and writes the
//   channel's mean and sqrt(var + eps); after a second barrier every block
//   normalizes its slice. Two grid barriers a group, no second launch.
// * The normalization reads the slice again, the last pixel read first, so
//   that what is still in L2 is read from there; the output is stored with
//   the streaming hint (evict first), so it does not push x out of L2.
// * The group is all C channels (models/common/layer_norm.py
//   plan_instance_norm): whole 768-byte pixel rows.
// * Each thread loads 16 bytes of one pixel (8 bf16 or 4 fp32 channels;
//   single elements where C is not a multiple of that), eight pixels in
//   flight.
//
// Measured on an H100 (sweeps of this design's variants, PERF.md): keeping
// each block's first ~200 KB of pixels in shared memory between the two
// passes gained nothing (the re-read hits L2 about as fast); narrower
// channel groups, which would keep a group in L2, were slower at every
// flagship shape (32- to 256-byte pieces of rows 768 bytes apart waste
// device-memory bandwidth, and each group adds two barriers); two blocks an
// SM (64 registers a thread) were slower than one.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"
#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int UNROLL = 8;         // pixels a thread has in flight
constexpr int MAX_THREADS = 512;  // threads a block, at most

// VEC elements of T as one load: 16 bytes, or one element
template <typename T, int VEC>
struct Pack;
template <>
struct Pack<float, 4> {
  using R = float4;
  static __device__ __forceinline__ void unpack(const R& r, float (&v)[4]) { v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w; }
  static __device__ __forceinline__ R pack(const float (&v)[4]) { return make_float4(v[0], v[1], v[2], v[3]); }
};
template <>
struct Pack<__nv_bfloat16, 8> {
  using R = uint4;
  static __device__ __forceinline__ void unpack(const R& r, float (&v)[8]) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ R pack(const float (&v)[8]) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]));
      u[i] = lo | (hi << 16);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};
template <>
struct Pack<float, 1> {
  using R = float;
  static __device__ __forceinline__ void unpack(const R& r, float (&v)[1]) { v[0] = r; }
  static __device__ __forceinline__ R pack(const float (&v)[1]) { return v[0]; }
};
template <>
struct Pack<__nv_bfloat16, 1> {
  using R = unsigned short;
  static __device__ __forceinline__ void unpack(const R& r, float (&v)[1]) { v[0] = __uint_as_float((uint32_t)r << 16); }
  static __device__ __forceinline__ R pack(const float (&v)[1]) { return __bfloat16_as_ushort(__float2bfloat16_rn(v[0])); }
};

// Chan's merge of (nb, mb, qb) into (na, ma, qa)
__device__ __forceinline__ void chan(float& na, float& ma, float& qa, float nb, float mb, float qb) {
  const float n = na + nb;
  if (nb == 0.f) return;
  const float delta = mb - ma;
  const float f = nb / n;
  ma = ma + delta * f;
  qa = qa + qb + delta * delta * (na * f);
  na = n;
}

// x, y: (B, HW, C); w, b: (C,); part: (nblocks, 3, CG) fp32 scratch; stats:
// (B, C / CG, 2, CG) fp32, each (sample, group)'s mean and sqrt(var + eps),
// kept for the backward (K10). The block has ppi * (CG / VEC) threads: thread (row, cv)
// takes channels c0 + cv * VEC ... and pixels p0 + row, p0 + row + ppi, ...
// of its block's slice [p0, p0 + chunk).
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    instance_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias, T* __restrict__ y, float* __restrict__ part,
                         float* __restrict__ stats, int B, int HW, int C, int n_valid, int CG, int ppi, int chunk, float eps) {
  using P = Pack<T, VEC>;
  using R = typename P::R;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int TPP = CG / VEC;
  const int row = tid / TPP, cv = tid % TPP;
  float* s_mean = smem;                 // [ppi][CG]
  float* s_m2 = s_mean + nthreads * VEC;  // [ppi][CG]
  float* s_n = s_m2 + nthreads * VEC;     // [ppi]
  const int nblocks = gridDim.x, blk = blockIdx.x;
  const int p0 = blk * chunk, p1 = min(HW, p0 + chunk);
  const int first = p0 + row, n_k = first < p1 ? (p1 - first + ppi - 1) / ppi : 0;  // this thread's pixels
  const int lane = tid % 32, warp = tid / 32, nwarps = nthreads / 32;
  const int n_groups = C / CG;

  for (int bg = 0; bg < B * n_groups; ++bg) {
    const int b = bg / n_groups, c0 = (bg % n_groups) * CG;
    const T* xb = x + (long long)b * HW * C + c0 + cv * VEC + (long long)first * C;
    T* yb = y + (long long)b * HW * C + c0 + cv * VEC + (long long)first * C;
    const long long step = (long long)ppi * C;

    // ---- reduce this thread's pixels (Welford)
    float n = 0.f, mean[VEC], m2[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) mean[v] = m2[v] = 0.f;
    auto welford = [&](const R& r, int k) {
      if (first + k * ppi >= n_valid) return;
      float xv[VEC];
      P::unpack(r, xv);
      n += 1.f;
      const float inv = 1.f / n;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float d = xv[v] - mean[v];
        mean[v] += d * inv;
        m2[v] += d * (xv[v] - mean[v]);
      }
    };
    int k = 0;
    for (; k + UNROLL <= n_k; k += UNROLL) {
      R r[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) r[u] = *reinterpret_cast<const R*>(xb + (k + u) * step);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) welford(r[u], k + u);
    }
    for (; k < n_k; ++k) welford(*reinterpret_cast<const R*>(xb + k * step), k);

    // ---- merge the block's rows (a tree over row pairs), then publish
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      s_mean[tid * VEC + v] = mean[v];
      s_m2[tid * VEC + v] = m2[v];
    }
    if (cv == 0) s_n[row] = n;
    int span = 1;
    while (span < ppi) span *= 2;
    for (int s = span / 2; s >= 1; s /= 2) {
      __syncthreads();
      for (int i = tid; i < s * CG; i += nthreads) {
        const int ra = i / CG, rb = ra + s, c = i % CG;
        if (rb < ppi) {
          float na = s_n[ra], ma = s_mean[ra * CG + c], qa = s_m2[ra * CG + c];
          chan(na, ma, qa, s_n[rb], s_mean[rb * CG + c], s_m2[rb * CG + c]);
          s_mean[ra * CG + c] = ma;
          s_m2[ra * CG + c] = qa;
        }
      }
      __syncthreads();
      if (tid < s && tid + s < ppi) s_n[tid] += s_n[tid + s];
    }
    __syncthreads();
    for (int c = tid; c < CG; c += nthreads) {
      float* dst = part + (long long)blk * 3 * CG + c;
      dst[0] = s_n[0];
      dst[CG] = s_mean[c];
      dst[2 * CG] = s_m2[c];
    }
    grid.sync();

    // ---- one warp a channel merges the blocks' partials, in a fixed order
    // (read past L1, which other SMs' writes do not reach)
    for (int c = blk * nwarps + warp; c < CG; c += nblocks * nwarps) {
      float na = 0.f, ma = 0.f, qa = 0.f;
      for (int j = lane; j < nblocks; j += 32) {
        const float* src = part + (long long)j * 3 * CG + c;
        chan(na, ma, qa, __ldcg(src), __ldcg(src + CG), __ldcg(src + 2 * CG));
      }
#pragma unroll
      for (int off = 16; off >= 1; off /= 2) {
        const float nb = __shfl_down_sync(0xFFFFFFFFu, na, off);
        const float mb = __shfl_down_sync(0xFFFFFFFFu, ma, off);
        const float qb = __shfl_down_sync(0xFFFFFFFFu, qa, off);
        chan(na, ma, qa, nb, mb, qb);
      }
      if (lane == 0) {
        stats[(long long)bg * 2 * CG + c] = ma;
        stats[(long long)bg * 2 * CG + CG + c] = __fsqrt_rn(__fadd_rn(__fdiv_rn(qa, na), eps));
      }
    }
    grid.sync();

    // ---- normalize the slice, the last pixel read first: the likeliest
    // to be in L2 still
    float mu[VEC], sd[VEC], wv[VEC], bv[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int c = cv * VEC + v;
      mu[v] = __ldcg(stats + (long long)bg * 2 * CG + c);  // L2: written by other blocks
      sd[v] = __ldcg(stats + (long long)bg * 2 * CG + CG + c);
      wv[v] = mt::to_f32(w[c0 + c]);
      bv[v] = mt::to_f32(bias[c0 + c]);
    }
    auto norm = [&](const R& r) -> R {
      float v_[VEC];
      P::unpack(r, v_);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float z = __fdiv_rn(__fsub_rn(v_[v], mu[v]), sd[v]);
        if constexpr (sizeof(T) == 2) {
          // bf16: round after the normalization and after each affine operation
          const float zr = __bfloat162float(__float2bfloat16_rn(z));
          const float zw = __bfloat162float(__float2bfloat16_rn(__fmul_rn(zr, wv[v])));
          v_[v] = __fadd_rn(zw, bv[v]);  // rounded to bf16 by pack
        } else {
          v_[v] = __fadd_rn(__fmul_rn(z, wv[v]), bv[v]);
        }
      }
      return P::pack(v_);
    };
    k = n_k - 1;
    for (; k + 1 >= UNROLL; k -= UNROLL) {
      R r[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) r[u] = *reinterpret_cast<const R*>(xb + (k - u) * step);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) __stcs(reinterpret_cast<R*>(yb + (k - u) * step), norm(r[u]));
    }
    for (; k >= 0; --k) __stcs(reinterpret_cast<R*>(yb + k * step), norm(*reinterpret_cast<const R*>(xb + k * step)));
    // the next group's partials and statistics are written only after the
    // grid barrier that follows its reduction, which every block reaches
    // after this normalization
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* w, const void* b, void* y, void* part, void* stats, int B, int HW, int C, int n_valid, int CG, int ppi,
           int chunk, int nblocks, float eps, cudaStream_t s) {
  const int nthreads = ppi * (CG / VEC);
  if (CG % VEC || C % CG || nthreads > MAX_THREADS || nthreads % 32) return (int)cudaErrorInvalidValue;
  // the rows' (mean, M2) and counts
  const size_t smem = (size_t)2 * nthreads * VEC * sizeof(float) + (size_t)ppi * sizeof(float);
  auto kernel = instance_norm_kernel<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  float* pp = static_cast<float*>(part);
  float* sp = static_cast<float*>(stats);
  void* args[] = {&xp, &wp, &bp, &yp, &pp, &sp, &B, &HW, &C, &n_valid, &CG, &ppi, &chunk, &eps};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(nblocks), dim3(nthreads), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; vec: 16 bytes of channels (4 or 8) or 1.
// x, y: (B, HW, C) contiguous, 16-byte aligned for vec > 1; w, b: (C,) in
// x's dtype; part: float32 (nblocks, 3, CG); stats: float32 (B, C / CG, 2,
// CG), written with each (sample, channel)'s mean and sqrt(var + eps).
// Statistics over the first n_valid pixels of each sample; block k
// normalizes pixels [k * chunk, (k + 1) * chunk). The grid (nblocks) must
// fit on the card at once: the launch is cooperative and fails otherwise.
// Returns cudaGetLastError() after the launch, or an argument error.
extern "C" int mt_instance_norm(int dtype, int vec, const void* x, const void* w, const void* b, void* y, void* part, void* stats, int B, int HW,
                                int C, int n_valid, int CG, int ppi, int chunk, int nblocks, float eps, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || CG <= 0 || ppi <= 0 || chunk <= 0 || nblocks <= 0 || n_valid <= 0 || n_valid > HW ||
      (long long)nblocks * chunk < HW)
    return (int)cudaErrorInvalidValue;
  if (vec > 1 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) return launch<float, 4>(x, w, b, y, part, stats, B, HW, C, n_valid, CG, ppi, chunk, nblocks, eps, s);
  if (dtype == 0 && vec == 1) return launch<float, 1>(x, w, b, y, part, stats, B, HW, C, n_valid, CG, ppi, chunk, nblocks, eps, s);
  if (dtype == 1 && vec == 8) return launch<__nv_bfloat16, 8>(x, w, b, y, part, stats, B, HW, C, n_valid, CG, ppi, chunk, nblocks, eps, s);
  if (dtype == 1 && vec == 1) return launch<__nv_bfloat16, 1>(x, w, b, y, part, stats, B, HW, C, n_valid, CG, ppi, chunk, nblocks, eps, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The instance-norm backward: kernel K10 of makani_torch.
//
// Replaces jax.grad through makani_tpu/models/common/layer_norm.py
// InstanceNorm2d (the default two-pass path, :78-122) and the closed form of
// makani_tpu/ops/norm.py _bwd (:96-121). With z = (x - mean) / sd (sd =
// sqrt(var + eps), K4's saved statistics), dz = g * w (bf16: the bf16
// product, rounded) and the n valid pixels of a sample:
//
//   dx = (dz - S1 / n - z * S2 / n) / sd   on the valid rows (padded rows:
//                                          the terms with S1, S2 are 0),
//   S1 = sum dz,  S2 = sum dz * z          over all pixels of (b, c),
//   dw = sum_{b,p} g * zr,  db = sum_{b,p} g   (bf16: g * zr rounded to bf16,
//                                          and dw, db once more at the end),
//
// zr being z rounded to x's dtype, as the bf16 forward applies its affine
// step to it. Every division and rounding is IEEE round-to-nearest (no FMA
// contraction), as the plain version instance_norm_grad_plain computes it.
//
// What bounds it on the card: the bytes. It reads x and g twice (the sums,
// then dx) and writes dx: at the SFNO training step's full resolution
// (3, 361, 720, 384) bf16 each is 599 MB, a one-read bound of 0.54 ms and a
// two-read floor of 0.89 ms; at its internal grid 66 MB each (0.059 and
// 0.099 ms), where the fixed cost of the launch, its barriers and each
// phase's ramp weighs as much as the bytes. So it is one cooperative launch
// of a persistent grid, one block an SM, that takes S samples a round:
//
// * The grid is split into S parts of blocks / S blocks, one a sample of
//   the round, and each block sums its slice of its sample's pixels (S1, S2
//   and the dw and db terms, per channel). One grid barrier; one warp a
//   (sample, channel) adds the blocks' partials in a fixed order (no
//   atomics: the same result on every run); a second barrier; every block
//   writes dx for its slice. Two barriers a round: with S = B (the plan's
//   choice where it was measured faster) two a launch, where walking the
//   samples in turn (S = 1, the first design) costs 2B and B short phases.
// * Loads that keep HBM busy while the divisions run: each thread streams
//   its pixels of x and g through a ring of RING slots of its own in shared
//   memory, RING - 1 pixels ahead, with asynchronous 16-byte copies
//   (cp.async: no register holds a pixel in flight, and no barrier is needed,
//   since a thread reads only its own slots). 8 slots of x and g for 480
//   threads keep ~105 KB in flight an SM; rings of 4 to 10 slots time within
//   about 1% of it (sweep_k3dx_k10.py).
// * The second pass goes from the last pixel back: the likeliest in L2.
// * The per-(b, c) sums are kept, and after the last round one warp a channel
//   sums them over the batch for dw and db.

namespace {

constexpr int RING = 8;  // pixels of x and of g in flight a thread: its shared-memory slots

// one pixel's R of src into a shared-memory slot: an asynchronous copy where
// R is 4 or 16 bytes, a load and a store for a lone bf16 channel (cp.async
// copies no 2-byte pieces)
template <typename R>
__device__ __forceinline__ void fetch(R* dst, const R* src) {
  if constexpr (sizeof(R) >= 4) {
    sm90::cp_async<sizeof(R)>(dst, src, true);
  } else {
    *dst = *src;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    instance_norm_grad_kernel(const T* __restrict__ gy, const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ stats,
                              T* __restrict__ dx, float* __restrict__ dwdb, float* __restrict__ part, float* __restrict__ sums, int B, int HW, int C,
                              int n_valid, int CG, int ppi, int S, int chunk) {
  using P = Pack<T, VEC>;
  using R = typename P::R;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int TPP = CG / VEC;
  const int row = tid / TPP, cv = tid % TPP;
  float* s_q[4] = {smem, smem + nthreads * VEC, smem + 2 * nthreads * VEC, smem + 3 * nthreads * VEC};  // [ppi][CG] each
  R* ring = reinterpret_cast<R*>(smem + 4 * nthreads * VEC);                                           // [RING][2][nthreads]
  const int nblocks = gridDim.x, blk = blockIdx.x;
  const int bps = nblocks / S;                   // blocks a sample
  const int part_s = blk / bps, j = blk % bps;  // this block's sample of the round, and its slice
  const int p0 = j * chunk, p1 = min(HW, p0 + chunk);
  const int first = p0 + row, n_k = first < p1 ? (p1 - first + ppi - 1) / ppi : 0;  // this thread's pixels
  const int lane = tid % 32, warp = tid / 32, nwarps = nthreads / 32;
  const int n_groups = C / CG, n_rounds = (B + S - 1) / S;

  for (int it = 0; it < n_rounds * n_groups; ++it) {
    const int round = it / n_groups, c0 = (it % n_groups) * CG;
    const int b = round * S + part_s;
    const bool active = b < B;
    const long long off = (long long)min(b, B - 1) * HW * C + c0 + cv * VEC + (long long)first * C;
    const T* xb = x + off;
    const T* gb = gy + off;
    T* db_ = dx + off;
    const long long step = (long long)ppi * C;
    const int nk = active ? n_k : 0;

    float mu[VEC], sd[VEC], wv[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int c = c0 + cv * VEC + v;
      mu[v] = active ? stats[(long long)b * 2 * C + c] : 0.f;
      sd[v] = active ? stats[(long long)b * 2 * C + C + c] : 1.f;
      wv[v] = mt::to_f32(w[c]);
    }
    // z, dz and the weight's term g * zr of channel v of one pixel, one
    // channel at a time (a pixel's VEC channels at once would hold 4 VEC
    // more registers)
    auto term = [&](float xv, float gv, int v, float& z, float& dz, float& gz) {
      z = __fdiv_rn(__fsub_rn(xv, mu[v]), sd[v]);
      if constexpr (sizeof(T) == 2) {
        dz = __bfloat162float(__float2bfloat16_rn(__fmul_rn(gv, wv[v])));
        const float zr = __bfloat162float(__float2bfloat16_rn(z));
        gz = __bfloat162float(__float2bfloat16_rn(__fmul_rn(gv, zr)));
      } else {
        dz = __fmul_rn(gv, wv[v]);
        gz = __fmul_rn(gv, z);
      }
    };

    // this thread's pixel k (of x and g) into its slot k % RING, and a copy
    // group for it, empty past the slice's ends: one group a pixel
    auto slot = [&](int k) { return ring + (k % RING) * 2 * nthreads + tid; };
    auto copy_pixel = [&](int k) {
      asm volatile("" ::: "memory");  // after the reads of the slot's last pixel
      if (k >= 0 && k < nk) {
        fetch(slot(k), reinterpret_cast<const R*>(xb + k * step));
        fetch(slot(k) + nthreads, reinterpret_cast<const R*>(gb + k * step));
      }
      sm90::cp_async_commit();
    };

    // ---- pass 1: this thread's sums over its pixels (all rows, padded too)
    float acc[4][VEC];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[q][v] = 0.f;
    for (int k = 0; k < RING - 1; ++k) copy_pixel(k);
    for (int k = 0; k < nk; ++k) {
      copy_pixel(k + RING - 1);
      sm90::cp_async_wait<RING - 1>();
      float xv[VEC], gv[VEC];
      P::unpack(slot(k)[0], xv);
      P::unpack(slot(k)[nthreads], gv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float z, dz, gz;
        term(xv[v], gv[v], v, z, dz, gz);
        acc[0][v] += dz;
        acc[1][v] += dz * z;
        acc[2][v] += gz;
        acc[3][v] += gv[v];
      }
    }
    sm90::cp_async_wait<0>();

    // ---- sum the block's rows (a tree over row pairs), then publish
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int v = 0; v < VEC; ++v) s_q[q][tid * VEC + v] = acc[q][v];
    int span = 1;
    while (span < ppi) span *= 2;
    for (int s = span / 2; s >= 1; s /= 2) {
      __syncthreads();
      for (int i = tid; i < s * CG; i += nthreads) {
        const int ra = i / CG, rb = ra + s, c = i % CG;
        if (rb < ppi) {
#pragma unroll
          for (int q = 0; q < 4; ++q) s_q[q][ra * CG + c] += s_q[q][rb * CG + c];
        }
      }
    }
    __syncthreads();
    for (int c = tid; c < CG; c += nthreads) {
#pragma unroll
      for (int q = 0; q < 4; ++q) part[((long long)blk * 4 + q) * CG + c] = s_q[q][c];
    }
    grid.sync();

    // ---- one warp a (sample, channel) adds its blocks' partials, in a fixed
    // order (read past L1, which other SMs' writes do not reach)
    for (int sc = blk * nwarps + warp; sc < S * CG; sc += nblocks * nwarps) {
      const int s = sc / CG, c = sc % CG, bs = round * S + s;
      if (bs >= B) continue;
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      for (int jj = lane; jj < bps; jj += 32) {
#pragma unroll
        for (int q = 0; q < 4; ++q) t[q] += __ldcg(part + ((long long)(s * bps + jj) * 4 + q) * CG + c);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int o = 16; o >= 1; o /= 2) t[q] += __shfl_down_sync(0xFFFFFFFFu, t[q], o);
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) sums[((long long)bs * 4 + q) * C + c0 + c] = t[q];
      }
    }
    grid.sync();

    // ---- pass 2: dx for the slice, the last pixel read first (the
    // likeliest in L2)
    float a[VEC], cc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int c = c0 + cv * VEC + v;
      a[v] = active ? __fdiv_rn(__ldcg(sums + ((long long)b * 4 + 0) * C + c), (float)n_valid) : 0.f;
      cc[v] = active ? __fdiv_rn(__ldcg(sums + ((long long)b * 4 + 1) * C + c), (float)n_valid) : 0.f;
    }
    for (int k = nk - 1; k > nk - RING; --k) copy_pixel(k);
    for (int k = nk - 1; k >= 0; --k) {
      copy_pixel(k - RING + 1);
      sm90::cp_async_wait<RING - 1>();
      float xv[VEC], gv[VEC], out[VEC];
      P::unpack(slot(k)[0], xv);
      P::unpack(slot(k)[nthreads], gv);
      const bool valid = first + k * ppi < n_valid;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float z, dz, gz;
        term(xv[v], gv[v], v, z, dz, gz);
        const float av = valid ? a[v] : 0.f, cv_ = valid ? cc[v] : 0.f;
        out[v] = __fdiv_rn(__fsub_rn(__fsub_rn(dz, av), __fmul_rn(z, cv_)), sd[v]);
      }
      __stcs(reinterpret_cast<R*>(db_ + k * step), P::pack(out));
    }
    sm90::cp_async_wait<0>();
    // the next round's partials and sums are written only after the grid
    // barrier that follows its pass 1, which every block reaches after this
  }

  // ---- dw and db: the per-sample sums over the batch, a warp's lane 0 a
  // channel (every sample's sums were written before the last barrier)
  for (int c = blk * nwarps + warp; c < C; c += nblocks * nwarps) {
    if (lane != 0) continue;
    float sw = 0.f, sb = 0.f;
    for (int b = 0; b < B; ++b) {
      sw += __ldcg(sums + ((long long)b * 4 + 2) * C + c);
      sb += __ldcg(sums + ((long long)b * 4 + 3) * C + c);
    }
    if constexpr (sizeof(T) == 2) {
      sw = __bfloat162float(__float2bfloat16_rn(sw));
      sb = __bfloat162float(__float2bfloat16_rn(sb));
    }
    dwdb[c] = sw;
    dwdb[C + c] = sb;
  }
}


template <typename T, int VEC>
int launch_grad(const void* g, const void* x, const void* w, const void* stats, void* dx, void* dwdb, void* part, void* sums, int B, int HW, int C,
                int n_valid, int CG, int ppi, int S, int chunk, int nblocks, cudaStream_t s) {
  const int nthreads = ppi * (CG / VEC);
  if (CG % VEC || C % CG || nthreads > MAX_THREADS || nthreads % 32 || nblocks % S || (long long)(nblocks / S) * chunk < HW)
    return (int)cudaErrorInvalidValue;
  // the rows' four sums, and the threads' rings of x and g
  const size_t smem = (size_t)4 * nthreads * VEC * sizeof(float) + (size_t)RING * 2 * nthreads * sizeof(typename Pack<T, VEC>::R);
  auto kernel = instance_norm_grad_kernel<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const T* gp = static_cast<const T*>(g);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const float* sp = static_cast<const float*>(stats);
  T* dxp = static_cast<T*>(dx);
  float* dwp = static_cast<float*>(dwdb);
  float* pp = static_cast<float*>(part);
  float* su = static_cast<float*>(sums);
  void* args[] = {&gp, &xp, &wp, &sp, &dxp, &dwp, &pp, &su, &B, &HW, &C, &n_valid, &CG, &ppi, &S, &chunk};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(nblocks), dim3(nthreads), args, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; vec: 16 bytes of channels (4 or 8) or 1.
// g, x, dx: (B, HW, C) contiguous, 16-byte aligned for vec > 1; w: (C,) in
// x's dtype; stats: float32 (B, 2, C), each (sample, channel)'s mean and
// sqrt(var + eps) (K4's); dwdb: float32 (2, C) out; part: float32 (nblocks,
// 4, CG) and sums: float32 (B, 4, C) scratch. S samples a round, each on
// nblocks / S blocks of chunk pixels (nblocks a multiple of S); ppi * CG /
// vec threads a block (models/common/layer_norm.py
// plan_instance_norm_grad). The grid must fit on the card at once.
// Returns cudaGetLastError() after the launch, or an argument error.
extern "C" int mt_instance_norm_grad(int dtype, int vec, const void* g, const void* x, const void* w, const void* stats, void* dx, void* dwdb,
                                     void* part, void* sums, int B, int HW, int C, int n_valid, int CG, int ppi, int S, int chunk, int nblocks,
                                     void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || CG <= 0 || ppi <= 0 || S <= 0 || S > nblocks || chunk <= 0 || nblocks <= 0 || n_valid <= 0 || n_valid > HW)
    return (int)cudaErrorInvalidValue;
  if (vec > 1 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) return launch_grad<float, 4>(g, x, w, stats, dx, dwdb, part, sums, B, HW, C, n_valid, CG, ppi, S, chunk, nblocks, s);
  if (dtype == 0 && vec == 1) return launch_grad<float, 1>(g, x, w, stats, dx, dwdb, part, sums, B, HW, C, n_valid, CG, ppi, S, chunk, nblocks, s);
  if (dtype == 1 && vec == 8)
    return launch_grad<__nv_bfloat16, 8>(g, x, w, stats, dx, dwdb, part, sums, B, HW, C, n_valid, CG, ppi, S, chunk, nblocks, s);
  if (dtype == 1 && vec == 1)
    return launch_grad<__nv_bfloat16, 1>(g, x, w, stats, dx, dwdb, part, sums, B, HW, C, n_valid, CG, ppi, S, chunk, nblocks, s);
  return (int)cudaErrorInvalidValue;
}
