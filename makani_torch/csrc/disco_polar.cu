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
// (channel, mode) once into registers (K 9 and FCN3.1's K 7) and writes BL
// values of dX, on the forward's grid. Both are bound by memory bandwidth
// like the forward: at the FCN3 processor the psi-first transpose reads
// 2.32 GB and writes 2.32 GB; at FCN3.1's training decoder (BL 49, K 7) it
// writes 7 floats for every one it reads (3.3 GB a run of 23 polar rows).
// The mix-first one reads one dY and writes BL*K values of dU: at the
// FCN3 training step's atmo decoder (B 4, P 58, BL 5, C 65, K 9, M 361) it
// reads 54 MB and writes 1.96 GB, so only the writes count, and the
// forward's grid fits them badly: its 64-channel tile would leave half the
// blocks one channel of C = 65, each block staging Psi's tile behind a
// barrier before its first store, and 361 modes fill a last 32-lane tile to
// 9/32. So it is a stream over dU's flat layout (below): blocks of equal
// spans, 16-byte streaming stores in runs of 512 bytes a warp, any K and M.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

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

// dX = sum_k dY Psi: KT = K (9 or 7) keeps dY's K values of the thread's
// GRAD_CH channels (ROWS apart) in registers, each read once, and writes dX
// by streaming stores (dX is BL times dY's size: nothing reads it soon);
// KT = 0 reads dY again for every j (any other K). A block takes GRAD_CB
// channels. At KT > 0 Psi's tile is staged by 8-byte asynchronous copies,
// all in flight at once, and a warp's next channels' dY values are loaded
// while it stores the current ones' dX; two channels a thread halve the
// shared-memory reads of Psi a store.
//
// What bounds it is dX's stores. At an odd M a row of dX starts anywhere in
// a 32-byte sector, and a warp's 256-byte store of 32 modes from m0 leaves
// partial sectors at both ends, which a neighbouring block fills later: on
// an H100 the same work takes a third less time where the rows start on
// sectors (sweep_k9_k13.py k13psi, PERF.md). So where a row's stride C M is
// a whole number of sectors (C a multiple of 4: FCN3.1's 280 and 256), all
// the rows of a channel start at the same place s in a sector, and the
// block's lanes take the modes m0 - s .. m0 - s + 31 of that channel: every
// store covers whole sectors but at the ends of a row. Psi's tile is then
// staged from m0 - GRAD_PAD, and the grid has a tile more where the shifted
// windows need it to reach M.
constexpr int GRAD_CH = 2;
constexpr int GRAD_CB = 64;
constexpr int GRAD_PAD = 4;

// Psi's columns staged before a tile's first mode: GRAD_PAD where dX's
// rows are a whole number of 32-byte sectors apart, else 0 (no shift)
__host__ __device__ inline int grad_pad(int C, int M) { return (long long)C * M % 4 == 0 ? GRAD_PAD : 0; }

// Psi's rows r = j K + k of one p, modes m0 - pad .. m0 + MB - 1, into
// ps[r][MB + pad] by 8-byte cp.async (zeros outside [0, M)); the caller
// waits for them
__device__ __forceinline__ void stage_psi_rows(float2* ps, const float2* __restrict__ Pt, int p, int rows, int M, int m0, int pad) {
  const int cols = MB + pad;
  const float2* src = Pt + (long long)p * rows * M;
  for (int idx = threadIdx.x; idx < rows * cols; idx += THREADS) {
    const int r = idx / cols, m = m0 - pad + idx - r * cols;
    const bool live = m >= 0 && m < M;
    sm90::cp_async<8>(ps + idx, src + (long long)r * M + (live ? m : 0), live);
  }
  sm90::cp_async_commit();
}

// dY's KT values of GRAD_CH channels c, c + ROWS, ... (zeros at c_hi and past)
template <int KT>
__device__ __forceinline__ void load_dy(float2 (&v)[GRAD_CH][KT], const float2* __restrict__ dY, long long bp, int c, int c_hi, int C, int M, int m) {
#pragma unroll
  for (int i = 0; i < GRAD_CH; ++i) {
    const float2* y = dY + ((bp * C + c + i * ROWS) * KT) * M + m;
#pragma unroll
    for (int k = 0; k < KT; ++k) v[i][k] = c + i * ROWS < c_hi ? y[(long long)k * M] : make_float2(0.f, 0.f);
  }
}

template <int KT>
__global__ void __launch_bounds__(THREADS)
    psi_first_grad_kernel(const float2* __restrict__ dY, const float2* __restrict__ Pt, float2* __restrict__ dX, int P, int BL, int C, int K, int M) {
  extern __shared__ float2 ps[];
  const int c_lo = blockIdx.y * GRAD_CB, c_hi = min(C, c_lo + GRAD_CB);
  const int bp = blockIdx.z, p = bp % P;
  const int m0 = blockIdx.x * MB;
  const int lane = threadIdx.x % MB, row = threadIdx.x / MB;
  const long long j_stride = (long long)C * M;
  if constexpr (KT > 0) {
    const int pad = grad_pad(C, M), cols = MB + pad;
    stage_psi_rows(ps, Pt, p, BL * KT, M, m0, pad);
    // channel c's mode on this lane: its rows' place in a sector, the same
    // for c + ROWS (ROWS M float2 are whole sectors)
    auto mode_of = [&](int c) {
      const float2* row0 = dX + ((long long)bp * BL * C + c) * M;
      return m0 + lane - (pad ? (int)(reinterpret_cast<uintptr_t>(row0) / sizeof(float2) % 4) : 0);
    };
    float2 v[GRAD_CH][KT];
    int c = c_lo + row, m = mode_of(c);
    if (m >= 0 && m < M) load_dy<KT>(v, dY, bp, c, c_hi, C, M, m);
    sm90::cp_async_wait<0>();
    __syncthreads();
    for (; c < c_hi; c += GRAD_CH * ROWS) {
      float2 cur[GRAD_CH][KT];
#pragma unroll
      for (int i = 0; i < GRAD_CH; ++i)
#pragma unroll
        for (int k = 0; k < KT; ++k) cur[i][k] = v[i][k];
      const int mc = m;
      if (c + GRAD_CH * ROWS < c_hi) {
        m = mode_of(c + GRAD_CH * ROWS);
        if (m >= 0 && m < M) load_dy<KT>(v, dY, bp, c + GRAD_CH * ROWS, c_hi, C, M, m);
      }
      if (mc < 0 || mc >= M) continue;
      float2* x = dX + ((long long)bp * BL * C + c) * M + mc;
      const float2* qc = ps + pad + mc - m0;
      for (int j = 0; j < BL; ++j) {
        const float2* q = qc + j * KT * cols;
        float re[GRAD_CH], im[GRAD_CH];
#pragma unroll
        for (int i = 0; i < GRAD_CH; ++i) re[i] = im[i] = 0.f;
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const float2 w = q[k * cols];
#pragma unroll
          for (int i = 0; i < GRAD_CH; ++i) cmac(re[i], im[i], cur[i][k], w);
        }
#pragma unroll
        for (int i = 0; i < GRAD_CH; ++i)
          if (c + i * ROWS < c_hi) __stcs(x + j * j_stride + (long long)i * ROWS * M, make_float2(re[i], im[i]));
      }
    }
  } else {
    const int m = m0 + lane;
    stage_psi(ps, Pt, p, BL, K, M, 0, K, m0);
    __syncthreads();
    if (m >= M) return;
    for (int c = c_lo + row; c < c_hi; c += ROWS) {
      const float2* y = dY + ((long long)bp * C + c) * K * M + m;
      float2* x = dX + ((long long)bp * BL * C + c) * M + m;
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
    // the shifted windows (K 9 and 7) reach M from a tile more where a
    // shift of up to 3 modes needs it, and stage pad more columns of Psi
    const int pad = K == 9 || K == 7 ? grad_pad(C, M) : 0;
    const dim3 grid((M + (pad ? 3 : 0) + MB - 1) / MB, (C + GRAD_CB - 1) / GRAD_CB, B * P);
    const size_t gsmem = (size_t)BL * K * (MB + pad) * sizeof(float2);
    if (K == 9) return launch(psi_first_grad_kernel<9>, grid, gsmem, s, s_, p_, y_, P, BL, C, K, M);
    if (K == 7) return launch(psi_first_grad_kernel<7>, grid, gsmem, s, s_, p_, y_, P, BL, C, K, M);
    return launch(psi_first_grad_kernel<0>, grid, smem, s, s_, p_, y_, P, BL, C, K, M);
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
