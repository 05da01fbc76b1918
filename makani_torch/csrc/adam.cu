// Adam and AdamW: kernel K17 of makani_torch.
//
// Replaces optax.adam / optax.adamw as makani_tpu/utils/training/optimizer.py
// get_optimizer builds them (:364-375): scale_by_adam, add_decayed_weights
// (masked), scale_by_learning_rate and apply_updates, which XLA runs as one
// elementwise fusion a leaf. Per element, with the fp32 bias corrections
// c1 = 1 - b1^count, c2 = 1 - b2^count:
//
//   mu' = (1 - b1) g + b1m mu          (fp32; stored in mu's dtype)
//   v'  = b2 v + (1 - b2) g^2
//   u   = mu' / (c1 (sqrt(v' / c2) + eps))
//   u  += wd p                         (a decayed leaf)
//   p'  = p + (-lr) u
//
// This is optax's order, which differs from the factored Adam's (K11) in
// two places: mu_hat is taken from the fp32 mu' before it is cast to mu's
// dtype, and with a bfloat16 mu, b1 enters the product b1 mu as a bfloat16
// number (b1m = bf16(b1): the JAX package multiplies the weakly typed b1
// into the bf16 mu). The roundings are the JAX step's as XLA compiles it on
// the CPU (bit-equal there): the multiply-adds (1 - b1) g + [b1m mu],
// b2 v + [(1 - b2) [g g]], u + wd p and p + u (-lr) are fused (__fmaf_rn),
// the bracketed products rounded first; XLA folds (mu' / c1) / (sqrt + eps)
// into one division by c1 (sqrt + eps). Every other operation rounds once,
// as the plain version adam_update_plain.
//
// One launch takes up to MAX_LEAVES leaves (the table is the kernel
// argument; each block finds its leaf by its index, CHUNK elements a block,
// 4 at a time with 16-byte loads where the pointers allow). The update is in
// place: p, mu and v are read and written by the same thread.
//
// What bounds it: the bytes. It reads p, g, mu, v and writes p, mu, v: 28
// bytes a parameter with an fp32 mu, 24 with a bfloat16 one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEAVES = 64;  // leaves a launch (the table: 3 KB of kernel arguments)
constexpr int CHUNK = 8192;     // elements a block

struct ALeaf {
  float* p;
  const float* g;
  void* mu;
  float* v;
  long long n;
  float wd;
  int first;  // this leaf's first block in the launch
};
struct ALeaves {
  ALeaf leaf[MAX_LEAVES];
};

struct Hyper {
  float b1m, omb1, b2, omb2, c1, c2, eps, neg_lr;
};

__device__ __forceinline__ int find_leaf(const ALeaves& T, int n) {
  int l = 0;
  while (l + 1 < n && (int)blockIdx.x >= T.leaf[l + 1].first) ++l;
  return l;
}

template <typename MU>
__device__ __forceinline__ void adam_one(float& p, const float g, MU& mu, float& v, const float wd, const Hyper& h) {
  const float m = __fmaf_rn(h.omb1, g, __fmul_rn(h.b1m, mt::to_f32(mu)));
  v = __fmaf_rn(h.b2, v, __fmul_rn(h.omb2, __fmul_rn(g, g)));
  float u = __fdiv_rn(m, __fmul_rn(h.c1, __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.c2)), h.eps)));
  if (wd != 0.f) u = __fmaf_rn(wd, p, u);
  p = __fmaf_rn(u, h.neg_lr, p);
  mu = mt::from_f32<MU>(m);
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
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
    m[0] = b[0], m[1] = b[1], m[2] = b[2], m[3] = b[3];
  }
  static __device__ __forceinline__ T join(const __nv_bfloat16 (&m)[4]) {
    T v;
    __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(&v);
    b[0] = m[0], b[1] = m[1], b[2] = m[2], b[3] = m[3];
    return v;
  }
};

template <typename MU>
__global__ void __launch_bounds__(THREADS) adam_kernel(const __grid_constant__ ALeaves T, int n, const Hyper h) {
  const ALeaf& L = T.leaf[find_leaf(T, n)];
  const long long e0 = (long long)(blockIdx.x - L.first) * CHUNK;
  const long long e1 = min(L.n, e0 + CHUNK);
  float* p = L.p;
  const float* g = L.g;
  MU* mu = static_cast<MU*>(L.mu);
  float* v = L.v;
  const float wd = L.wd;
  const bool vec = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(v)) % 16 == 0) &&
                   reinterpret_cast<uintptr_t>(mu) % (4 * sizeof(MU)) == 0;
  long long e = e0 + (vec ? 4 : 1) * threadIdx.x;
  if (vec) {
    using V = Vec4<MU>;
    for (; e + 3 < e1; e += 4 * THREADS) {
      const float4 p4 = *reinterpret_cast<const float4*>(p + e), g4 = *reinterpret_cast<const float4*>(g + e), v4 = *reinterpret_cast<const float4*>(v + e);
      float pv[4] = {p4.x, p4.y, p4.z, p4.w}, vv[4] = {v4.x, v4.y, v4.z, v4.w};
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
      MU m[4];
      V::split(*reinterpret_cast<const typename V::T*>(mu + e), m);
#pragma unroll
      for (int k = 0; k < 4; ++k) adam_one(pv[k], gv[k], m[k], vv[k], wd, h);
      *reinterpret_cast<float4*>(p + e) = make_float4(pv[0], pv[1], pv[2], pv[3]);
      *reinterpret_cast<float4*>(v + e) = make_float4(vv[0], vv[1], vv[2], vv[3]);
      *reinterpret_cast<typename V::T*>(mu + e) = V::join(m);
    }
    // a leaf's last partial group of 4: its owner takes it one at a time
    for (; e < e1; ++e) {
      float pv = p[e], vv = v[e];
      MU m = mu[e];
      adam_one(pv, g[e], m, vv, wd, h);
      p[e] = pv, v[e] = vv, mu[e] = m;
    }
  } else {
    for (; e < e1; e += THREADS) {
      float pv = p[e], vv = v[e];
      MU m = mu[e];
      adam_one(pv, g[e], m, vv, wd, h);
      p[e] = pv, v[e] = vv, mu[e] = m;
    }
  }
}

}  // namespace

// The update of n <= MAX_LEAVES leaves in one launch, table: n rows of (p,
// g, mu, v, numel) as 64-bit integers (p, g, v fp32 contiguous, mu float32
// (mu_dtype 0) or bfloat16 (1)), and a weight decay a leaf (0: none). b1m
// multiplies mu (b1, or b1 rounded to bfloat16 with a bfloat16 mu); omb1 =
// 1 - b1, omb2 = 1 - b2 as fp32; c1, c2 the bias corrections; neg_lr = -lr.
extern "C" int mt_adam(int mu_dtype, const long long* table, const float* decay, int n, float b1m, float omb1, float b2, float omb2, float c1, float c2,
                       float eps, float neg_lr, void* stream) {
  if (n <= 0 || n > MAX_LEAVES || (mu_dtype != 0 && mu_dtype != 1)) return (int)cudaErrorInvalidValue;
  ALeaves T;
  long long blocks = 0;
  for (int j = 0; j < n; ++j) {
    const long long* row = table + 5 * j;
    if (row[4] <= 0) return (int)cudaErrorInvalidValue;
    T.leaf[j] = ALeaf{reinterpret_cast<float*>(row[0]), reinterpret_cast<const float*>(row[1]), reinterpret_cast<void*>(row[2]),
                      reinterpret_cast<float*>(row[3]), row[4], decay[j], (int)blocks};
    blocks += (row[4] + CHUNK - 1) / CHUNK;
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  }
  for (int j = n; j < MAX_LEAVES; ++j) T.leaf[j] = ALeaf{nullptr, nullptr, nullptr, nullptr, 0, 0.f, 0x7FFFFFFF};
  const Hyper h{b1m, omb1, b2, omb2, c1, c2, eps, neg_lr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mu_dtype == 0)
    adam_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(T, n, h);
  else
    adam_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, s>>>(T, n, h);
  return (int)cudaGetLastError();
}
