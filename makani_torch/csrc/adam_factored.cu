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
// What bounds it on the card: the bytes. The elementwise update reads g, p
// and mu and writes p and mu: 16 bytes a parameter with a bf16 mu (the
// SFNO training step: 289.4 M parameters, 4.6 GB, 1.38 ms at 3.35 TB/s);
// the reductions of g^2 read g once more (20 bytes a parameter).
//
// A factored leaf is seen as (P, R, Mi, S, Q): the axes before, at,
// between, at and after its two factored axes; vA (P, R, Mi, Q) is the EMA
// of the mean over S, vB (P, Mi, S, Q) over R. Three launches take every
// factored leaf of a step (up to MAX_FLEAVES; a table of leaf descriptors
// is the kernel argument, each block finds its leaf by its index):
//  1. reduce: a block takes an (r, s) tile of one leaf (32 r, and 32 s with
//     all q in chunks of 32 where Q >= 32, lanes across q; where Q < 32,
//     256 / Q values of s, a thread per (s, q) element). It reads each
//     element of g once, squares it, and adds the square into both its
//     column partial (over the tile's r, in registers) and its row partial
//     (over the tile's s: across warps through shared memory where Q >= 32,
//     a warp's shuffle tree over the lanes where Q < 32). Both partials go
//     to fixed positions of a scratch buffer: no atomics.
//  2. combine: a block of 1024 threads takes one (p, mi) and up to 32 q of
//     one side (vA or vB) of one leaf, its other threads along the reduced
//     axis: it adds the partials in a fixed order, takes the EMA
//     in place, and, on the side that is v_row, the row mean (a fixed-order
//     tree over its threads), so the row mean needs no launch of its own.
//  3. apply: a block takes a chunk of one row (p, r, mi) of the contiguous
//     (s, q) run; a thread walks it 4 elements at a time with 16-byte loads
//     where the run and the pointers are aligned, its q kept by a 32-bit
//     counter (no division per element); vB is read along the same run.
// The unfactored leaves take one launch for up to 64 leaves. So a step of
// the SFNO (34 factored leaves, 53 unfactored) launches 4 kernels, and the
// sums run in a fixed order: two runs from one state are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEAVES = 64;   // unfactored leaves a launch
constexpr int MAX_FLEAVES = 40;  // factored leaves a launch (the table stays under 4 KB of kernel arguments)
constexpr int TR = 32;           // r a reduce tile
constexpr int CHUNK = 4096;      // elements of a row an apply block
constexpr int COMBINE_THREADS = 1024;  // a combine block: up to 32 q x 32 lanes along the reduced axis

// s a reduce tile: 32 with lanes across q (Q >= 32), else 256 / Q
__host__ __device__ inline int s_tile(int Q) { return Q >= 32 ? 32 : THREADS / Q; }
__host__ __device__ inline long long round4(long long n) { return (n + 3) & ~3LL; }

struct FLeaf {
  float* p;
  const float* g;
  void* mu;
  float* vA;       // (P, R, Mi, Q)
  float* vB;       // (P, Mi, S, Q)
  float* scratch;  // partials over s tiles (nst, P, R, Mi, Q), over r tiles (nrt, P, Mi, S, Q), row mean (P, Mi, Q)
  int P, R, Mi, S, Q, row_keeps_r;
  float c1, c2;
  int nst, nrt;
  int first;  // this leaf's first block in the launch
};
struct FLeaves {
  FLeaf leaf[MAX_FLEAVES];
};

struct Scratch {
  float *pa, *pb, *rm;
};
__device__ __forceinline__ Scratch scratch_of(const FLeaf& L) {
  const long long nA = (long long)L.P * L.R * L.Mi * L.Q, nB = (long long)L.P * L.Mi * L.S * L.Q;
  Scratch s;
  s.pa = L.scratch;
  s.pb = s.pa + round4(L.nst * nA);
  s.rm = s.pb + round4(L.nrt * nB);
  return s;
}

// the leaf of this block: the last whose first block is not past it
__device__ __forceinline__ int find_leaf(const FLeaves& T, int n) {
  int l = 0;
  while (l + 1 < n && (int)blockIdx.x >= T.leaf[l + 1].first) ++l;
  return l;
}

__global__ void __launch_bounds__(THREADS) factored_reduce_kernel(const __grid_constant__ FLeaves T, int n) {
  __shared__ float red[THREADS / 32][TR][32];  // Q >= 32: row partials (warp, r, lane); Q < 32: squares (r, element)
  const FLeaf& L = T.leaf[find_leaf(T, n)];
  const Scratch sc = scratch_of(L);
  const int R = L.R, Mi = L.Mi, S = L.S, Q = L.Q;
  const long long SQ = (long long)S * Q;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long nA = (long long)L.P * R * Mi * Q, nB = (long long)L.P * Mi * SQ;
  int local = blockIdx.x - L.first;
  if (Q >= 32) {
    const int nqc = (Q + 31) / 32;
    const int qc = local % nqc;
    local /= nqc;
    const int st = local % L.nst;
    local /= L.nst;
    const int rt = local % L.nrt;
    const int pm = local / L.nrt, pp = pm / Mi, mi = pm - pp * Mi;
    const int q = qc * 32 + lane, r0 = rt * TR, s0 = st * 32, nr = min(TR, R - r0);
    const bool qok = q < Q;
    float cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int rr = 0; rr < nr; ++rr) {
      const float* row = L.g + (((long long)pp * R + r0 + rr) * Mi + mi) * SQ + q;
      float v2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + warp + 8 * i;
        const float v = qok && s < S ? row[(long long)s * Q] : 0.f;
        v2[i] = __fmul_rn(v, v);
      }
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rs = __fadd_rn(rs, v2[i]);
        cs[i] = __fadd_rn(cs[i], v2[i]);
      }
      red[warp][rr][lane] = rs;
    }
    __syncthreads();
    if (!qok) return;
    // row partials over the tile's s: the 8 warps' sums in order
    for (int rr = warp; rr < nr; rr += THREADS / 32) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) sum = __fadd_rn(sum, red[w][rr][lane]);
      sc.pa[st * nA + (((long long)pp * R + r0 + rr) * Mi + mi) * Q + q] = sum;
    }
    // column partials over the tile's r
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + warp + 8 * i;
      if (s < S) sc.pb[rt * nB + ((long long)pp * Mi + mi) * SQ + (long long)s * Q + q] = cs[i];
    }
  } else {
    float* sq = &red[0][0][0];  // (TR, THREADS): the tile's squares
    const int st = local % L.nst;
    local /= L.nst;
    const int rt = local % L.nrt;
    const int pm = local / L.nrt, pp = pm / Mi, mi = pm - pp * Mi;
    const int ts = s_tile(Q), r0 = rt * TR, s0 = st * ts, nr = min(TR, R - r0), ns = min(ts, S - s0), ne = ns * Q;
    float cs = 0.f;
    for (int rr = 0; rr < nr; ++rr) {
      const float v = tid < ne ? L.g[(((long long)pp * R + r0 + rr) * Mi + mi) * SQ + (long long)s0 * Q + tid] : 0.f;
      const float v2 = __fmul_rn(v, v);
      cs = __fadd_rn(cs, v2);
      sq[rr * THREADS + tid] = v2;
    }
    if (tid < ne) sc.pb[rt * nB + ((long long)pp * Mi + mi) * SQ + (long long)s0 * Q + tid] = cs;
    __syncthreads();
    // row partials (r, q) over the tile's s: a warp an output, lanes across s
    for (int o = warp; o < nr * Q; o += THREADS / 32) {
      const int rr = o / Q, q = o - rr * Q;
      float sum = 0.f;
      for (int s = lane; s < ns; s += 32) sum = __fadd_rn(sum, sq[rr * THREADS + s * Q + q]);
#pragma unroll
      for (int off = 16; off >= 1; off /= 2) sum = __fadd_rn(sum, __shfl_xor_sync(0xFFFFFFFFu, sum, off));
      if (lane == 0) sc.pa[st * nA + (((long long)pp * R + r0 + rr) * Mi + mi) * Q + q] = sum;
    }
  }
}

// blocks of one side of one leaf in the combine launch
__host__ __device__ inline int combine_tq(int Q) { return Q < 32 ? Q : 32; }

__global__ void __launch_bounds__(COMBINE_THREADS) factored_combine_kernel(const __grid_constant__ FLeaves T, int n, float b2, float omb2) {
  __shared__ float red[COMBINE_THREADS];
  const FLeaf& L = T.leaf[find_leaf(T, n)];
  const Scratch sc = scratch_of(L);
  const int Mi = L.Mi, Q = L.Q, TQ = combine_tq(Q), nqc = (Q + TQ - 1) / TQ;
  int local = blockIdx.x - L.first;
  const int qc = local % nqc;
  local /= nqc;
  const int pm = local % (L.P * Mi), side = local / (L.P * Mi), pp = pm / Mi, mi = pm - pp * Mi;
  // side 0: vA from the s tiles' partials; side 1: vB from the r tiles'
  const bool A = side == 0;
  const int X = A ? L.R : L.S, NT = A ? L.nst : L.nrt;
  const float N = (float)(A ? L.S : L.R);
  float* v = A ? L.vA : L.vB;
  const float* part = A ? sc.pa : sc.pb;
  const long long nv = A ? (long long)L.P * L.R * Mi * Q : (long long)L.P * Mi * L.S * Q;
  const long long base = A ? (long long)pp * L.R * Mi * Q + (long long)mi * Q : ((long long)pp * Mi + mi) * L.S * Q;
  const long long xstride = A ? (long long)Mi * Q : Q;
  const int tid = threadIdx.x, nxl = COMBINE_THREADS / TQ, xl = tid / TQ, ql = tid - xl * TQ, q = qc * TQ + ql;
  const bool ok = xl < nxl && q < Q;
  float rsum = 0.f;
  if (ok) {
    for (int x = xl; x < X; x += nxl) {
      const long long o = base + x * xstride + q;
      float tot = 0.f;
      for (int t = 0; t < NT; ++t) tot = __fadd_rn(tot, part[t * nv + o]);
      const float vn = __fmaf_rn(b2, v[o], __fmul_rn(omb2, __fdiv_rn(tot, N)));
      v[o] = vn;
      rsum = __fadd_rn(rsum, vn);
    }
  }
  if (A != (bool)L.row_keeps_r) return;  // this side is v_col: no row mean
  // the row mean over x of v_row: the x-lanes' sums added in a fixed tree
  red[tid] = rsum;
  __syncthreads();
  int span = 1;
  while (span < nxl) span *= 2;
  for (int h = span / 2; h >= 1; h /= 2) {
    if (ok && xl < h && xl + h < nxl) red[tid] = __fadd_rn(red[tid], red[tid + h * TQ]);
    __syncthreads();
  }
  if (ok && xl == 0) sc.rm[(long long)pm * Q + q] = fmaxf(__fdiv_rn(red[tid], (float)X), 1e-30f);
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
struct Vec4;
template <>
struct Vec4<float> {
  using T = float4;
  static __device__ __forceinline__ void split(const T& v, float (&m)[4]) { m[0] = v.x, m[1] = v.y, m[2] = v.z, m[3] = v.w; }
  static __device__ __forceinline__ T join(const float (&m)[4]) { return make_float4(m[0], m[1], m[2], m[3]); }
};
template <>
struct Vec4<__nv_bfloat16> {
  using T = uint2;
  static __device__ __forceinline__ void split(const T& v, __nv_bfloat16 (&m)[4]) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
    m[0] = h[0], m[1] = h[1], m[2] = h[2], m[3] = h[3];
  }
  static __device__ __forceinline__ T join(const __nv_bfloat16 (&m)[4]) {
    T v;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
    h[0] = m[0], h[1] = m[1], h[2] = m[2], h[3] = m[3];
    return v;
  }
};

template <typename MU>
__global__ void __launch_bounds__(THREADS) factored_apply_kernel(const __grid_constant__ FLeaves T, int n, float b1, float omb1, float eps, float neg_lr) {
  const FLeaf& L = T.leaf[find_leaf(T, n)];
  const Scratch sc = scratch_of(L);
  const int Mi = L.Mi, Q = L.Q;
  const int SQ = L.S * Q, chunks = (SQ + CHUNK - 1) / CHUNK;
  const int local = blockIdx.x - L.first;
  const int chunk = local % chunks;
  const long long row = local / chunks;  // (p, r, mi)
  const long long pm = (row / ((long long)L.R * Mi)) * Mi + row % Mi;
  const int e0 = chunk * CHUNK, e1 = min(SQ, e0 + CHUNK);
  float* p = L.p + row * SQ;
  const float* g = L.g + row * SQ;
  MU* mu = static_cast<MU*>(L.mu) + row * SQ;
  const float* vA = L.vA + row * Q;
  const float* vB = L.vB + pm * SQ;
  const float* rm = sc.rm + pm * Q;
  const bool rk = L.row_keeps_r;
  const float c1 = L.c1, c2 = L.c2;
  auto one = [&](float& pv, float gv, MU& m, float bv, int q) {
    const float a = vA[q], vr = rk ? a : bv, vc = rk ? bv : a;
    const float vhat = __fdiv_rn(__fmul_rn(__fdiv_rn(vr, rm[q]), vc), c2);
    adam_apply(pv, gv, m, vhat, b1, omb1, c1, eps, neg_lr);
  };
  // 16-byte pieces where the run and the pointers allow (every main-path
  // leaf but the FCN3 MLP's (1354, 641)), else one element a step
  const bool vec = SQ % 4 == 0 && ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(vB)) % 16 == 0) &&
                   reinterpret_cast<uintptr_t>(mu) % (4 * sizeof(MU)) == 0;
  const int step = vec ? 4 * THREADS : THREADS;
  // q of the thread's first element, then advanced by dq (mod Q) a step
  int e = e0 + (vec ? 4 : 1) * threadIdx.x;
  int q = e % Q;
  const int dq = step % Q;
  if (vec) {
    using V = Vec4<MU>;
    for (; e < e1; e += step) {
      const float4 pv4 = *reinterpret_cast<const float4*>(p + e), gv4 = *reinterpret_cast<const float4*>(g + e);
      const float4 bv4 = *reinterpret_cast<const float4*>(vB + e);
      float pv[4] = {pv4.x, pv4.y, pv4.z, pv4.w};
      const float gv[4] = {gv4.x, gv4.y, gv4.z, gv4.w}, bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
      MU m[4];
      V::split(*reinterpret_cast<const typename V::T*>(mu + e), m);
      int qq = q;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        one(pv[k], gv[k], m[k], bv[k], qq);
        if (++qq == Q) qq = 0;
      }
      *reinterpret_cast<float4*>(p + e) = make_float4(pv[0], pv[1], pv[2], pv[3]);
      *reinterpret_cast<typename V::T*>(mu + e) = V::join(m);
      q += dq;
      if (q >= Q) q -= Q;
    }
  } else {
    for (; e < e1; e += step) {
      float pv = p[e];
      MU m = mu[e];
      one(pv, g[e], m, vB[e], q);
      p[e] = pv;
      mu[e] = m;
      q += dq;
      if (q >= Q) q -= Q;
    }
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

// blocks of one leaf in each factored launch
long long leaf_blocks(int kind, int P, int R, int Mi, int S, int Q) {
  if (kind == 0) {
    const long long tiles = (long long)P * Mi * ((R + TR - 1) / TR) * ((S + s_tile(Q) - 1) / s_tile(Q));
    return Q >= 32 ? tiles * ((Q + 31) / 32) : tiles;
  }
  if (kind == 1) return 2LL * P * Mi * ((Q + combine_tq(Q) - 1) / combine_tq(Q));
  return (long long)P * R * Mi * (((long long)S * Q + CHUNK - 1) / CHUNK);
}

}  // namespace

// Scratch floats that one factored leaf (P, R, Mi, S, Q) needs in
// mt_adam_factored: its partial sums and row mean.
extern "C" long long mt_adam_factored_scratch(int P, int R, int Mi, int S, int Q) {
  if (P <= 0 || R <= 0 || Mi <= 0 || S <= 0 || Q <= 0) return -1;
  const long long nst = (S + s_tile(Q) - 1) / s_tile(Q), nrt = (R + TR - 1) / TR;
  return round4(nst * P * R * Mi * Q) + round4(nrt * P * Mi * S * Q) + round4((long long)P * Mi * Q);
}

// One of the three launches (kind 0 reduce, 1 combine, 2 apply) over n <=
// MAX_FLEAVES factored leaves, table: n rows of (p, g, mu, vA, vB, scratch,
// P, R, Mi, S, Q, row_keeps_r) as 64-bit integers, and c1, c2 (fp32) a leaf.
// p, g fp32 (P, R, Mi, S, Q) contiguous, mu float32 (mu_dtype 0) or
// bfloat16 (1), vA (P, R, Mi, Q) and vB (P, Mi, S, Q) fp32, scratch
// mt_adam_factored_scratch(...) floats, 16-byte aligned; v_row is vA where
// row_keeps_r, else vB. All in place; the launches run in order 0, 1, 2.
extern "C" int mt_adam_factored(int kind, int mu_dtype, const long long* table, const float* corrections, int n, float b1, float omb1, float b2,
                                float omb2, float eps, float neg_lr, void* stream) {
  if (kind < 0 || kind > 2 || n <= 0 || n > MAX_FLEAVES || (mu_dtype != 0 && mu_dtype != 1)) return (int)cudaErrorInvalidValue;
  FLeaves T;
  long long blocks = 0;
  for (int j = 0; j < n; ++j) {
    const long long* row = table + 12 * j;
    FLeaf& L = T.leaf[j];
    L.p = reinterpret_cast<float*>(row[0]);
    L.g = reinterpret_cast<const float*>(row[1]);
    L.mu = reinterpret_cast<void*>(row[2]);
    L.vA = reinterpret_cast<float*>(row[3]);
    L.vB = reinterpret_cast<float*>(row[4]);
    L.scratch = reinterpret_cast<float*>(row[5]);
    for (int k = 6; k < 11; ++k)
      if (row[k] <= 0 || row[k] > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    L.P = (int)row[6], L.R = (int)row[7], L.Mi = (int)row[8], L.S = (int)row[9], L.Q = (int)row[10], L.row_keeps_r = row[11] != 0;
    if ((long long)L.S * L.Q > 0x7FFFFFFF || reinterpret_cast<uintptr_t>(L.scratch) % 16) return (int)cudaErrorInvalidValue;
    L.c1 = corrections[2 * j], L.c2 = corrections[2 * j + 1];
    L.nst = (L.S + s_tile(L.Q) - 1) / s_tile(L.Q);
    L.nrt = (L.R + TR - 1) / TR;
    L.first = (int)blocks;
    blocks += leaf_blocks(kind, L.P, L.R, L.Mi, L.S, L.Q);
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    factored_reduce_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(T, n);
  else if (kind == 1)
    factored_combine_kernel<<<(unsigned)blocks, COMBINE_THREADS, 0, s>>>(T, n, b2, omb2);
  else if (mu_dtype == 0)
    factored_apply_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(T, n, b1, omb1, eps, neg_lr);
  else
    factored_apply_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, s>>>(T, n, b1, omb1, eps, neg_lr);
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
