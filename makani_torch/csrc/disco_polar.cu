// DISCO polar rows: kernel K6 of makani_torch.
//
// Replaces the polar rows' conjugate multiply-sum of makani_tpu/ops/disco.py
// (the DiscoConvS2.__call__ polar branch, :686-692, and the fused path's
// _polar_fused_prelude / _polar_fused_phase, :856-909). The rows whose disc
// wraps every longitude are an exact circular correlation: an rFFT along the
// longitude, a product with the conjugate spectrum of psi summed over the
// band rows j (and, mixing first, over the basis functions k), then an
// irFFT. This kernel is the product-sum, between the two cuFFTs, in cuFFT's
// own layout: longitude modes m last and interleaved (re, im), as the JAX
// package keeps them, so the FFTs transform their last axis and neither
// side of the kernel needs a copy.
//
//   psi-first: Y[b, p, c, k, m] = sum_j    X[b, p, j, c, m]    conj(Psi[p, j, k, m])
//   mix-first: Y[b, p, c, m]    = sum_{j,k} U[b, p, j, c, k, m] conj(Psi[p, j, k, m])
//
// X (B, P, BL, C, M), U (B, P, BL, C, K, M), Psi (P, BL, K, M) and Y are
// complex64 tensors read as float2.
//
// What bounds it on the card: a few multiply-adds per complex element that
// crosses device memory and no tensor-core work, so it is bound by memory
// bandwidth (at the FCN3 processor, B 2, P 66, BL 9, C 677, K 9, M 361, it
// must read 2.32 GB and write 2.32 GB). The design reads each X (or U)
// element once and writes each Y element once, both coalesced: a block
// takes 32 consecutive modes (one per lane) of 64 channels of one (b, p);
// each lane reads its mode of a channel row as one float2, so a warp reads
// and writes 256 contiguous bytes. Psi's (BL, K, 32-mode) tile is staged
// once per block in shared memory (Psi is 15 MB, L2-resident) and serves
// all 64 channels. Psi-first keeps the K complex sums of two channels in
// registers; K is a template parameter (9, FCN3's basis, in one pass; any
// other K in chunks of 4), never padded to a power of two.
//
// Their transposes, kernel K13 (the VJP that JAX derives for the same
// lines), are modes 2 and 3 of the same entry point, on the same grid and
// the same staged Psi tile:
//
//   psi-first: dX[b, p, j, c, m]    = sum_k dY[b, p, c, k, m] Psi[p, j, k, m]
//   mix-first: dU[b, p, j, c, k, m] = dY[b, p, c, m]          Psi[p, j, k, m]
//
// complex products on the (re, im) views without the forward's conjugate (a
// conjugate there would leave the real parts right and flip the sign of the
// imaginary ones). The psi-first transpose reads the K values of dY of its
// (channel, mode) once into registers and writes BL values of dX, on the
// forward's grid. Both are bound by memory bandwidth like the forward: at
// the FCN3 processor the psi-first transpose reads 2.32 GB and writes 2.32
// GB. The mix-first one reads one dY and writes BL*K values of dU: at the
// FCN3 training step's atmo decoder (B 4, P 58, BL 5, C 65, K 9, M 361) it
// reads 54 MB and writes 1.96 GB, so only the writes count, and the
// forward's grid fits them badly: its 64-channel tile would leave half the
// blocks one channel of C = 65, each block staging Psi's tile behind a
// barrier before its first store, and 361 modes fill a last 32-lane tile to
// 9/32. So it is a stream over dU's flat layout (below): blocks of equal
// spans, 16-byte streaming stores in runs of 512 bytes a warp, any K and M.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int MB = 32;    // modes per block: one per lane
constexpr int ROWS = 8;   // warps per block, each on its own channels
constexpr int CB = 64;    // channels per block
constexpr int THREADS = MB * ROWS;

// Psi (P, BL, K, M) -> shared [BL][KS][MB] for basis functions k0 .. k0+KS-1
// and modes m0 .. m0+MB-1, zero outside
__device__ __forceinline__ void stage_psi(float2* ps, const float2* __restrict__ Pt, int p, int BL, int K, int M, int k0, int KS, int m0) {
  for (int idx = threadIdx.x; idx < BL * KS * MB; idx += THREADS) {
    const int mm = idx % MB, kk = (idx / MB) % KS, j = idx / (MB * KS);
    const int k = k0 + kk, m = m0 + mm;
    ps[idx] = (k < K && m < M) ? Pt[(((long long)p * BL + j) * K + k) * M + m] : make_float2(0.f, 0.f);
  }
}

// acc += v * conj(q)
__device__ __forceinline__ void cmac_conj(float& re, float& im, float2 v, float2 q) {
  re = fmaf(v.x, q.x, fmaf(v.y, q.y, re));
  im = fmaf(v.y, q.x, fmaf(-v.x, q.y, im));
}

template <int KT>
__global__ void __launch_bounds__(THREADS)
    psi_first_kernel(const float2* __restrict__ X, const float2* __restrict__ Pt, float2* __restrict__ Y, int P, int BL, int C, int K, int M) {
  extern __shared__ float2 ps[];
  const int n_ct = (C + CB - 1) / CB;
  const int c_lo = (blockIdx.y % n_ct) * CB, c_hi = min(C, c_lo + CB);
  const int k0 = (blockIdx.y / n_ct) * KT;
  const int bp = blockIdx.z, p = bp % P;
  const int m0 = blockIdx.x * MB;
  const int lane = threadIdx.x % MB, row = threadIdx.x / MB;
  const int m = m0 + lane;
  stage_psi(ps, Pt, p, BL, K, M, k0, KT, m0);
  __syncthreads();
  if (m >= M) return;

  const long long j_stride = (long long)C * M;
  for (int c = c_lo + row; c < c_hi; c += 2 * ROWS) {
    const bool two = c + ROWS < c_hi;
    float re0[KT], im0[KT], re1[KT], im1[KT];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) re0[kk] = im0[kk] = re1[kk] = im1[kk] = 0.f;
    const float2* x0 = X + ((long long)bp * BL * C + c) * M + m;
    const float2* x1 = x0 + (long long)ROWS * M;
#pragma unroll 3
    for (int j = 0; j < BL; ++j) {
      const float2 v0 = x0[j * j_stride];
      const float2 v1 = two ? x1[j * j_stride] : make_float2(0.f, 0.f);
      const float2* q = ps + j * KT * MB + lane;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const float2 w = q[kk * MB];
        cmac_conj(re0[kk], im0[kk], v0, w);
        cmac_conj(re1[kk], im1[kk], v1, w);
      }
    }
    float2* y0 = Y + (((long long)bp * C + c) * K + k0) * M + m;
    float2* y1 = y0 + (long long)ROWS * K * M;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (k0 + kk >= K) break;
      y0[kk * M] = make_float2(re0[kk], im0[kk]);
      if (two) y1[kk * M] = make_float2(re1[kk], im1[kk]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    mix_first_kernel(const float2* __restrict__ U, const float2* __restrict__ Pt, float2* __restrict__ Y, int P, int BL, int C, int K, int M) {
  extern __shared__ float2 ps[];
  const int c_lo = blockIdx.y * CB, c_hi = min(C, c_lo + CB);
  const int bp = blockIdx.z, p = bp % P;
  const int m0 = blockIdx.x * MB;
  const int lane = threadIdx.x % MB, row = threadIdx.x / MB;
  const int m = m0 + lane;
  stage_psi(ps, Pt, p, BL, K, M, 0, K, m0);
  __syncthreads();
  if (m >= M) return;

  const long long j_stride = (long long)C * K * M;
  for (int c = c_lo + row; c < c_hi; c += 2 * ROWS) {
    const bool two = c + ROWS < c_hi;
    float re0 = 0.f, im0 = 0.f, re1 = 0.f, im1 = 0.f;
    const float2* u0 = U + ((long long)bp * BL * C + c) * K * M + m;
    const float2* u1 = u0 + (long long)ROWS * K * M;
    for (int j = 0; j < BL; ++j) {
      const float2* q = ps + j * K * MB + lane;
#pragma unroll 3
      for (int k = 0; k < K; ++k) {
        const float2 w = q[k * MB];
        const long long off = j * j_stride + (long long)k * M;
        cmac_conj(re0, im0, u0[off], w);
        if (two) cmac_conj(re1, im1, u1[off], w);
      }
    }
    float2* y0 = Y + ((long long)bp * C + c) * M + m;
    y0[0] = make_float2(re0, im0);
    if (two) y0[(long long)ROWS * M] = make_float2(re1, im1);
  }
}

// acc += v * q (no conjugate)
__device__ __forceinline__ void cmac(float& re, float& im, float2 v, float2 q) {
  re = fmaf(v.x, q.x, fmaf(-v.y, q.y, re));
  im = fmaf(v.x, q.y, fmaf(v.y, q.x, im));
}

// dX = sum_k dY Psi: KT = K (9) keeps dY's K values in registers; KT = 0
// reads them again for every j (any other K)
template <int KT>
__global__ void __launch_bounds__(THREADS)
    psi_first_grad_kernel(const float2* __restrict__ dY, const float2* __restrict__ Pt, float2* __restrict__ dX, int P, int BL, int C, int K, int M) {
  extern __shared__ float2 ps[];
  const int c_lo = blockIdx.y * CB, c_hi = min(C, c_lo + CB);
  const int bp = blockIdx.z, p = bp % P;
  const int m0 = blockIdx.x * MB;
  const int lane = threadIdx.x % MB, row = threadIdx.x / MB;
  const int m = m0 + lane;
  stage_psi(ps, Pt, p, BL, K, M, 0, K, m0);
  __syncthreads();
  if (m >= M) return;

  const long long j_stride = (long long)C * M;
  for (int c = c_lo + row; c < c_hi; c += ROWS) {
    const float2* y = dY + ((long long)bp * C + c) * K * M + m;
    float2* x = dX + ((long long)bp * BL * C + c) * M + m;
    if constexpr (KT > 0) {
      float2 v[KT];
#pragma unroll
      for (int k = 0; k < KT; ++k) v[k] = y[(long long)k * M];
      for (int j = 0; j < BL; ++j) {
        const float2* q = ps + j * KT * MB + lane;
        float re = 0.f, im = 0.f;
#pragma unroll
        for (int k = 0; k < KT; ++k) cmac(re, im, v[k], q[k * MB]);
        x[j * j_stride] = make_float2(re, im);
      }
    } else {
      for (int j = 0; j < BL; ++j) {
        const float2* q = ps + j * K * MB + lane;
        float re = 0.f, im = 0.f;
        for (int k = 0; k < K; ++k) cmac(re, im, y[(long long)k * M], q[k * MB]);
        x[j * j_stride] = make_float2(re, im);
      }
    }
  }
}

// dU = dY Psi for every (j, k), as a stream over dU's flat layout: block b
// writes the elements [b per_block, (b + 1) per_block), each thread two
// neighbouring ones a step (one 16-byte streaming store; a warp writes 512
// contiguous bytes), its (bp, j, c, k, m) carried from step to step. The
// channel tile, the mode tile and the staged Psi tile of the other modes
// are gone: Psi (p, j) and dY's channel rows are read through L1 and L2.
// A thread takes up to 16 steps (against 64 and 256 the fastest on an H100
// at the FCN3 training step's atmo decoder: sweep_k9_k13.py, PERF.md),
// fewer where the grid would not fill the card twice over (STREAM_SLOTS
// resident blocks of 256 threads).
constexpr int STREAM_THREADS = 256;
constexpr int STREAM_STEPS = 16;
constexpr long long STREAM_SLOTS = 2 * 132 * 8;

// a position in dU (B P, BL, C, K, M) and Psi's p = bp % P
struct Pos {
  int m, k, c, j, p;
  long long bp;
  // the next (bp, j, c, k) row; m is the caller's
  __device__ __forceinline__ void next_row(int P, int BL, int C, int K) {
    if (++k < K) return;
    k = 0;
    if (++c < C) return;
    c = 0;
    if (++j < BL) return;
    j = 0;
    ++bp;
    if (++p == P) p = 0;
  }
  __device__ __forceinline__ float2 value(const float2* __restrict__ dY, const float2* __restrict__ Pt, int P, int BL, int C, int K, int M) const {
    const float2 v = __ldg(dY + (bp * C + c) * M + m);
    const float2 q = __ldg(Pt + (((long long)p * BL + j) * K + k) * M + m);
    float re = 0.f, im = 0.f;
    cmac(re, im, v, q);
    return make_float2(re, im);
  }
};

__global__ void __launch_bounds__(STREAM_THREADS)
    mix_first_grad_kernel(const float2* __restrict__ dY, const float2* __restrict__ Pt, float2* __restrict__ dU, int P, int BL, int C, int K, int M,
                          long long total, long long per_block) {
  const long long e0 = blockIdx.x * per_block;
  const long long e1 = min(total, e0 + per_block);
  long long e = e0 + 2 * threadIdx.x;
  if (e >= e1) return;
  Pos at;
  long long r = e / M;
  at.m = (int)(e - r * M);
  at.k = (int)(r % K);
  r /= K;
  at.c = (int)(r % C);
  r /= C;
  at.j = (int)(r % BL);
  at.bp = r / BL;
  at.p = (int)(at.bp % P);
  constexpr int STEP = 2 * STREAM_THREADS;
  for (; e < e1; e += STEP) {
    const float2 a = at.value(dY, Pt, P, BL, C, K, M);
    if (e + 1 < e1) {
      Pos nx = at;
      if (++nx.m == M) {
        nx.m = 0;
        nx.next_row(P, BL, C, K);
      }
      const float2 b = nx.value(dY, Pt, P, BL, C, K, M);
      __stcs(reinterpret_cast<float4*>(dU + e), make_float4(a.x, a.y, b.x, b.y));
    } else {
      __stcs(dU + e, a);
    }
    at.m += STEP;
    while (at.m >= M) {
      at.m -= M;
      at.next_row(P, BL, C, K);
    }
  }
}

template <typename Kernel>
int launch(Kernel kern, dim3 grid, size_t smem, cudaStream_t s, const float2* src, const float2* Pt, float2* Y, int P, int BL, int C, int K, int M) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, THREADS, smem, s>>>(src, Pt, Y, P, BL, C, K, M);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: psi-first, src X (B, P, BL, C, M) -> Y (B, P, C, K, M);
// mode 1: mix-first, src U (B, P, BL, C, K, M) -> Y (B, P, C, M);
// mode 2: psi-first's transpose, src dY (B, P, C, K, M) -> dX (B, P, BL, C, M);
// mode 3: mix-first's transpose, src dY (B, P, C, M) -> dU (B, P, BL, C, K, M);
// complex64 as interleaved float pairs, Pt (P, BL, K, M). Returns
// cudaGetLastError() after the launch.
extern "C" int mt_disco_polar(int mode, const void* src, const void* Pt, void* Y, int B, int P, int BL, int C, int K, int M, void* stream) {
  if (B <= 0 || P <= 0 || BL <= 0 || C <= 0 || K <= 0 || M <= 0 || (long long)B * P > 65535) return (int)cudaErrorInvalidValue;
  const auto* s_ = static_cast<const float2*>(src);
  const auto* p_ = static_cast<const float2*>(Pt);
  auto* y_ = static_cast<float2*>(Y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_ct = (C + CB - 1) / CB;
  const unsigned mx = (M + MB - 1) / MB;
  if (mode == 0) {
    if (K == 9) return launch(psi_first_kernel<9>, dim3(mx, n_ct, B * P), (size_t)BL * 9 * MB * sizeof(float2), s, s_, p_, y_, P, BL, C, K, M);
    constexpr int KT = 4;
    const long long gy = (long long)n_ct * ((K + KT - 1) / KT);
    if (gy > 65535) return (int)cudaErrorInvalidValue;
    return launch(psi_first_kernel<KT>, dim3(mx, (unsigned)gy, B * P), (size_t)BL * KT * MB * sizeof(float2), s, s_, p_, y_, P, BL, C, K, M);
  }
  if (mode == 1) return launch(mix_first_kernel, dim3(mx, n_ct, B * P), (size_t)BL * K * MB * sizeof(float2), s, s_, p_, y_, P, BL, C, K, M);
  const size_t smem = (size_t)BL * K * MB * sizeof(float2);
  if (mode == 2) {
    if (K == 9) return launch(psi_first_grad_kernel<9>, dim3(mx, n_ct, B * P), smem, s, s_, p_, y_, P, BL, C, K, M);
    return launch(psi_first_grad_kernel<0>, dim3(mx, n_ct, B * P), smem, s, s_, p_, y_, P, BL, C, K, M);
  }
  if (mode == 3) {
    if (reinterpret_cast<uintptr_t>(Y) % 16) return (int)cudaErrorMisalignedAddress;
    const long long total = (long long)B * P * BL * C * K * M;
    const long long steps = std::min<long long>(STREAM_STEPS, std::max<long long>(1, total / (2 * STREAM_THREADS * STREAM_SLOTS)));
    const long long per_block = 2 * STREAM_THREADS * steps;
    const long long blocks = (total + per_block - 1) / per_block;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    mix_first_grad_kernel<<<(unsigned)blocks, STREAM_THREADS, 0, s>>>(s_, p_, y_, P, BL, C, K, M, total, per_block);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
