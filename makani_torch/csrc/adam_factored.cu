// Adam with a factored second moment: kernel K11 of makani_torch.
//
// Replaces makani_tpu/utils/training/optimizer.py scale_by_adam_factored
// (update_fn, :93-132) chained with scale_by_learning_rate and
// apply_updates, which XLA runs as reductions and elementwise fusions. Per
// leaf, with the fp32 bias corrections c1 = 1 - b1^count, c2 = 1 - b2^count:
//
//   mu' = round_mu(b1 mu + (1 - b1) g)
//   factored (axes d0, d1):  v_row' = b2 v_row + (1 - b2) mean_d1(g^2)
//                            v_col' = b2 v_col + (1 - b2) mean_d0(g^2)
//                            vhat = (v_row' / max(mean_d0(v_row'), 1e-30)) (x) v_col' / c2
//   unfactored:              v' = b2 v + (1 - b2) g^2,  vhat = v' / c2
//   u = (mu' / c1) / (sqrt(vhat) + eps),  p' = p + (-lr) u
//
// The three multiply-adds b1 mu + [(1 - b1) g], b2 v + [(1 - b2) g^2] (and
// the factored EMAs) and p + u (-lr) are fused multiply-adds (__fmaf_rn), the
// bracketed products rounded first, as XLA compiles the JAX step (bit-equal
// to those FMAs on the CPU); every other operation rounds once (__fmul_rn,
// __fdiv_rn, ...: no other contraction), as the plain version
// adam_factored_update_plain computes them. The update is in place: p, mu
// and the second moment are read and written by the same thread.
//
// What bounds it on the card: the bytes. At the SFNO training step (~290 M
// fp32 parameters, 283 M of them the eight dhconv weights) the elementwise
// pass reads g, p and a bf16 mu and writes p and mu: 16 bytes a parameter,
// ~4.6 GB, 1.4 ms at 3.35 TB/s; the two reductions read g twice more (they
// are separate passes, each in a fixed order: no atomics). A leaf is seen as
// (P, R, Mi, S, Q): the axes before, at, between, at and after its two
// factored axes. The reduction over S runs a thread per output with Q >= 32
// (consecutive threads on consecutive q: coalesced), else a warp per output
// (its lanes across S); the reduction over R runs a thread per output
// (consecutive (s, q) are contiguous). The elementwise pass takes a row of
// (P, R, Mi) in chunks of the contiguous (S, Q), so only the split of the
// in-row index into (s, q) divides. Launches: three a factored leaf
// (reductions and EMAs, row mean, update) and one for up to 64 unfactored
// leaves, whose table of pointers is a kernel argument.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEAVES = 64;
constexpr int CHUNK = 4096;  // in-row elements a block of the update

// blocks [0, nA) reduce over S into vA (P, R, Mi, Q); the rest reduce over R
// into vB (P, Mi, S, Q); both then take their EMA in place
__global__ void __launch_bounds__(THREADS)
    factored_reduce_kernel(const float* __restrict__ g, float* __restrict__ vA, float* __restrict__ vB, int P, int R, int Mi, int S, int Q, float b2,
                           float omb2, int nA, int warpA) {
  const long long nOutA = (long long)P * R * Mi * Q, nOutB = (long long)P * Mi * S * Q;
  if ((int)blockIdx.x < nA) {
    if (warpA) {
      // a warp per output (p, r, mi, q), lanes across s
      const long long o = ((long long)blockIdx.x * THREADS + threadIdx.x) / 32;
      const int lane = threadIdx.x % 32;
      if (o >= nOutA) return;
      const long long t = o / Q, q = o % Q;
      const float* src = g + t * S * Q + q;
      float sum = 0.f;
      for (int s = lane; s < S; s += 32) {
        const float v = src[(long long)s * Q];
        sum += __fmul_rn(v, v);
      }
#pragma unroll
      for (int off = 16; off >= 1; off /= 2) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
      if (lane == 0) vA[o] = __fmaf_rn(b2, vA[o], __fmul_rn(omb2, __fdiv_rn(sum, (float)S)));
    } else {
      const long long o = (long long)blockIdx.x * THREADS + threadIdx.x;
      if (o >= nOutA) return;
      const long long t = o / Q, q = o % Q;
      const float* src = g + t * S * Q + q;
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
      int s = 0;
      for (; s + 4 <= S; s += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float v = src[(long long)(s + u) * Q];
          sum[u] += __fmul_rn(v, v);
        }
      }
      for (; s < S; ++s) {
        const float v = src[(long long)s * Q];
        sum[0] += __fmul_rn(v, v);
      }
      const float tot = (sum[0] + sum[1]) + (sum[2] + sum[3]);
      vA[o] = __fmaf_rn(b2, vA[o], __fmul_rn(omb2, __fdiv_rn(tot, (float)S)));
    }
  } else {
    const long long o = (long long)(blockIdx.x - nA) * THREADS + threadIdx.x;
    if (o >= nOutB) return;
    // o = ((p * Mi + mi) * S + s) * Q + q; the element (p, r, mi, s, q)
    const long long sq = o % ((long long)S * Q), pm = o / ((long long)S * Q);
    const long long p = pm / Mi, mi = pm % Mi;
    const long long rstride = (long long)Mi * S * Q;
    const float* src = g + (p * R * Mi + mi) * S * Q + sq;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    int r = 0;
    for (; r + 4 <= R; r += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float v = src[(long long)(r + u) * rstride];
        sum[u] += __fmul_rn(v, v);
      }
    }
    for (; r < R; ++r) {
      const float v = src[(long long)r * rstride];
      sum[0] += __fmul_rn(v, v);
    }
    const float tot = (sum[0] + sum[1]) + (sum[2] + sum[3]);
    vB[o] = __fmaf_rn(b2, vB[o], __fmul_rn(omb2, __fdiv_rn(tot, (float)R)));
  }
}

// rm[p, mi, q] = max(mean_x v_row[...], 1e-30): v_row is (P, X, Mi, Q)
// (layoutA) or (P, Mi, X, Q); a warp per output
__global__ void __launch_bounds__(THREADS)
    factored_rowmean_kernel(const float* __restrict__ vr, float* __restrict__ rm, int P, int X, int Mi, int Q, int layoutA) {
  const long long o = ((long long)blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (o >= (long long)P * Mi * Q) return;
  const long long q = o % Q, t = o / Q, mi = t % Mi, p = t / Mi;
  const long long base = layoutA ? (p * X * Mi + mi) * Q + q : (p * Mi + mi) * X * Q + q;
  const long long stride = layoutA ? (long long)Mi * Q : Q;
  float sum = 0.f;
  for (int x = lane; x < X; x += 32) sum += vr[base + x * stride];
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
  if (lane == 0) rm[o] = fmaxf(__fdiv_rn(sum, (float)X), 1e-30f);
}

// mu' and the parameter's update from the second-moment estimate vhat
template <typename MU>
__device__ __forceinline__ void adam_apply(float& p, const float g, MU& mu, const float vhat, float b1, float omb1, float c1, float eps, float neg_lr) {
  const MU m = mt::from_f32<MU>(__fmaf_rn(b1, mt::to_f32(mu), __fmul_rn(omb1, g)));
  mu = m;
  const float u = __fdiv_rn(__fdiv_rn(mt::to_f32(m), c1), __fadd_rn(__fsqrt_rn(vhat), eps));
  p = __fmaf_rn(u, neg_lr, p);
}

template <typename MU>
__global__ void __launch_bounds__(THREADS)
    factored_apply_kernel(float* __restrict__ p, const float* __restrict__ g, MU* __restrict__ mu, const float* __restrict__ vA,
                          const float* __restrict__ vB, const float* __restrict__ rm, int R, int Mi, int S, int Q, int row_keeps_r, int chunks, float b1,
                          float omb1, float c1, float c2, float eps, float neg_lr) {
  const long long t = blockIdx.x / chunks;  // the row (p, r, mi)
  const int chunk = blockIdx.x % chunks;
  const long long pp = t / ((long long)R * Mi), mi = t % Mi;
  const long long inner = (long long)S * Q;
  const long long e0 = (long long)chunk * CHUNK, e1 = min(inner, e0 + CHUNK);
  for (long long e = e0 + threadIdx.x; e < e1; e += THREADS) {
    const long long s = e / Q, q = e - s * Q;
    const long long idx = t * inner + e;
    const float a = vA[t * Q + q], bv = vB[((pp * Mi + mi) * S + s) * Q + q], r_ = rm[(pp * Mi + mi) * Q + q];
    const float vr = row_keeps_r ? a : bv, vc = row_keeps_r ? bv : a;
    const float vhat = __fdiv_rn(__fmul_rn(__fdiv_rn(vr, r_), vc), c2);
    float pv = p[idx];
    MU m = mu[idx];
    adam_apply(pv, g[idx], m, vhat, b1, omb1, c1, eps, neg_lr);
    p[idx] = pv;
    mu[idx] = m;
  }
}

struct Leaf {
  float* p;
  const float* g;
  void* mu;
  float* v;
  long long n;
};
struct Leaves {
  Leaf leaf[MAX_LEAVES];
};

template <typename MU>
__global__ void __launch_bounds__(THREADS)
    unfactored_kernel(const Leaves leaves, float b1, float omb1, float b2, float omb2, float c1, float c2, float eps, float neg_lr) {
  const Leaf L = leaves.leaf[blockIdx.y];
  MU* mu = static_cast<MU*>(L.mu);
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < L.n; e += (long long)gridDim.x * THREADS) {
    const float gv = L.g[e];
    const float v = __fmaf_rn(b2, L.v[e], __fmul_rn(omb2, __fmul_rn(gv, gv)));
    L.v[e] = v;
    float pv = L.p[e];
    MU m = mu[e];
    adam_apply(pv, gv, m, __fdiv_rn(v, c2), b1, omb1, c1, eps, neg_lr);
    L.p[e] = pv;
    mu[e] = m;
  }
}

}  // namespace

// The two reductions of one factored leaf g (P, R, Mi, S, Q) fp32,
// contiguous, each followed by its EMA in place: vA (P, R, Mi, Q) over S
// and vB (P, Mi, S, Q) over R. omb2 = 1 - b2 (rounded from double).
extern "C" int mt_adam_factored_reduce(const void* g, void* vA, void* vB, int P, int R, int Mi, int S, int Q, float b2, float omb2, void* stream) {
  if (P <= 0 || R <= 0 || Mi <= 0 || S <= 0 || Q <= 0) return (int)cudaErrorInvalidValue;
  const long long nOutA = (long long)P * R * Mi * Q, nOutB = (long long)P * Mi * S * Q;
  const int warpA = Q < 32;
  const long long nA = warpA ? (nOutA * 32 + THREADS - 1) / THREADS : (nOutA + THREADS - 1) / THREADS;
  const long long nB = (nOutB + THREADS - 1) / THREADS;
  if (nA + nB > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  factored_reduce_kernel<<<(unsigned)(nA + nB), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<float*>(vA), static_cast<float*>(vB), P, R, Mi, S, Q, b2, omb2, (int)nA, warpA);
  return (int)cudaGetLastError();
}

// rm (P, Mi, Q) = max(mean over X of v_row, 1e-30), v_row (P, X, Mi, Q)
// with layoutA, else (P, Mi, X, Q).
extern "C" int mt_adam_factored_rowmean(const void* vr, void* rm, int P, int X, int Mi, int Q, int layoutA, void* stream) {
  if (P <= 0 || X <= 0 || Mi <= 0 || Q <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)P * Mi * Q * 32 + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  factored_rowmean_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(vr), static_cast<float*>(rm), P,
                                                                                              X, Mi, Q, layoutA);
  return (int)cudaGetLastError();
}

// The update of one factored leaf: p, g (P, R, Mi, S, Q) fp32 and mu (0
// float32, 1 bfloat16) in place, from the new vA, vB and the row mean rm.
// v_row is vA where row_keeps_r (d0 < d1), else vB.
extern "C" int mt_adam_factored_apply(int mu_dtype, void* p, const void* g, void* mu, const void* vA, const void* vB, const void* rm, int P, int R,
                                      int Mi, int S, int Q, int row_keeps_r, float b1, float omb1, float c1, float c2, float eps, float neg_lr,
                                      void* stream) {
  if (P <= 0 || R <= 0 || Mi <= 0 || S <= 0 || Q <= 0) return (int)cudaErrorInvalidValue;
  const long long chunks = ((long long)S * Q + CHUNK - 1) / CHUNK, blocks = (long long)P * R * Mi * chunks;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fp = static_cast<float*>(p);
  auto gp = static_cast<const float*>(g);
  auto a = static_cast<const float*>(vA);
  auto b = static_cast<const float*>(vB);
  auto r = static_cast<const float*>(rm);
  if (mu_dtype == 0)
    factored_apply_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(fp, gp, static_cast<float*>(mu), a, b, r, R, Mi, S, Q, row_keeps_r, (int)chunks, b1,
                                                                      omb1, c1, c2, eps, neg_lr);
  else if (mu_dtype == 1)
    factored_apply_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, s>>>(fp, gp, static_cast<__nv_bfloat16*>(mu), a, b, r, R, Mi, S, Q, row_keeps_r,
                                                                              (int)chunks, b1, omb1, c1, c2, eps, neg_lr);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The update of n <= 64 unfactored leaves, table: n rows of (p, g, mu, v,
// numel) (pointers as 64-bit integers; p, g, v fp32, mu float32 or
// bfloat16), all in place, in one launch.
extern "C" int mt_adam_unfactored(int mu_dtype, const long long* table, int n, float b1, float omb1, float b2, float omb2, float c1, float c2, float eps,
                                  float neg_lr, void* stream) {
  if (n <= 0 || n > MAX_LEAVES || (mu_dtype != 0 && mu_dtype != 1)) return (int)cudaErrorInvalidValue;
  Leaves leaves;
  long long most = 0;
  for (int j = 0; j < n; ++j) {
    const long long* row = table + 5 * j;
    leaves.leaf[j] = Leaf{reinterpret_cast<float*>(row[0]), reinterpret_cast<const float*>(row[1]), reinterpret_cast<void*>(row[2]),
                          reinterpret_cast<float*>(row[3]), row[4]};
    most = row[4] > most ? row[4] : most;
  }
  for (int j = n; j < MAX_LEAVES; ++j) leaves.leaf[j] = Leaf{nullptr, nullptr, nullptr, nullptr, 0};
  const long long bx = most > 0 ? (most + THREADS - 1) / THREADS : 1;
  dim3 grid((unsigned)(bx < 1024 ? bx : 1024), n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mu_dtype == 0)
    unfactored_kernel<float><<<grid, THREADS, 0, s>>>(leaves, b1, omb1, b2, omb2, c1, c2, eps, neg_lr);
  else
    unfactored_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(leaves, b1, omb1, b2, omb2, c1, c2, eps, neg_lr);
  return (int)cudaGetLastError();
}
