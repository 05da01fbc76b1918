// Global-norm gradient clipping: kernel K16 of makani_torch.
//
// Replaces optax.clip_by_global_norm, chained first in
// makani_tpu/utils/training/optimizer.py get_optimizer (:407-411), which XLA
// runs as a reduction per leaf, a scalar sum and an elementwise select:
//
//   norm = sqrt(sum over leaves of sum g^2)
//   g    = g                         where norm < max_norm
//          (g / norm) * max_norm     otherwise (two roundings, in that order)
//
// Two launches over a table of up to MAX_LEAVES fp32 leaves (the table is the
// kernel argument; each block finds its leaf by its index, CHUNK elements a
// block, so the blocks are balanced over leaves of any size):
//  1. sumsq: a block sums the squares of its chunk (fp32, each thread a
//     strided run, then a fixed tree over the block) into its own partial.
//     In the launch that finishes (the last of a step's launches), the block
//     that ends last (a counter, then __threadfence) adds every partial of
//     the step in a fixed order, and writes the norm and the keep flag
//     (norm < max_norm) to device memory. Same inputs, same bits.
//  2. clip: every block reads the flag and returns at once where it keeps;
//     else it scales its chunk in place with __fdiv_rn then __fmul_rn.
// The choice of the clip is made on the device: the host reads nothing back.
//
// What bounds it: the bytes. The sum reads g once (4 bytes a parameter);
// the clip, where it runs, reads and writes g once more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEAVES = 128;  // leaves a launch (the table: 3 KB of kernel arguments)
constexpr int CHUNK = 16384;     // elements a block
constexpr int FINAL_THREADS = 1024;

struct NLeaf {
  float* g;
  long long n;
  int first;  // this leaf's first block in the launch
};
struct NLeaves {
  NLeaf leaf[MAX_LEAVES];
};

// the leaf of this block: the last whose first block is not past it
__device__ __forceinline__ int find_leaf(const NLeaves& T, int n) {
  int l = 0;
  while (l + 1 < n && (int)blockIdx.x >= T.leaf[l + 1].first) ++l;
  return l;
}

// the block's sum of v over its threads, in a fixed tree (warps by shuffles,
// then the warps' sums in order); valid in thread 0
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) v = __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) s = __fadd_rn(s, red[w]);
  return s;
}

// state: [0] the launches' finished-block counter, [1] the keep flag; out: [0] the norm
__global__ void __launch_bounds__(THREADS) sumsq_kernel(const __grid_constant__ NLeaves T, int n, float* partials, int offset, int total, int finish,
                                                        unsigned* state, float* out, float max_norm) {
  __shared__ float red[FINAL_THREADS / 32];
  __shared__ bool last;
  const NLeaf& L = T.leaf[find_leaf(T, n)];
  const long long e0 = (long long)(blockIdx.x - L.first) * CHUNK;
  const long long e1 = min(L.n, e0 + CHUNK);
  const float* g = L.g;
  float s = 0.f;
  if (reinterpret_cast<uintptr_t>(g) % 16 == 0) {
    long long e = e0 + 4 * threadIdx.x;
    for (; e + 3 < e1; e += 4 * THREADS) {
      const float4 v = *reinterpret_cast<const float4*>(g + e);
      s = __fmaf_rn(v.x, v.x, s);
      s = __fmaf_rn(v.y, v.y, s);
      s = __fmaf_rn(v.z, v.z, s);
      s = __fmaf_rn(v.w, v.w, s);
    }
    for (; e < e1; ++e) s = __fmaf_rn(g[e], g[e], s);  // a leaf's last partial group of 4, one thread
  } else {
    for (long long e = e0 + threadIdx.x; e < e1; e += THREADS) s = __fmaf_rn(g[e], g[e], s);
  }
  s = block_sum<THREADS>(s, red);
  if (threadIdx.x == 0) partials[offset + blockIdx.x] = s;
  if (!finish) return;
  // the block that finishes last adds all partials of the step
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&state[0], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float t = 0.f;
  for (int i = threadIdx.x; i < total; i += THREADS) t = __fadd_rn(t, __ldcg(partials + i));
  t = block_sum<THREADS>(t, red);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(t);
    out[0] = norm;
    state[1] = norm < max_norm ? 1u : 0u;
    state[0] = 0u;  // ready for the next step
  }
}

__global__ void __launch_bounds__(THREADS) clip_kernel(const __grid_constant__ NLeaves T, int n, const unsigned* state, const float* out, float max_norm) {
  if (state[1]) return;  // norm < max_norm: g is kept
  const float norm = out[0];
  const NLeaf& L = T.leaf[find_leaf(T, n)];
  const long long e0 = (long long)(blockIdx.x - L.first) * CHUNK;
  const long long e1 = min(L.n, e0 + CHUNK);
  float* g = L.g;
  auto clip = [&](float v) { return __fmul_rn(__fdiv_rn(v, norm), max_norm); };
  if (reinterpret_cast<uintptr_t>(g) % 16 == 0) {
    long long e = e0 + 4 * threadIdx.x;
    for (; e + 3 < e1; e += 4 * THREADS) {
      float4 v = *reinterpret_cast<const float4*>(g + e);
      v.x = clip(v.x), v.y = clip(v.y), v.z = clip(v.z), v.w = clip(v.w);
      *reinterpret_cast<float4*>(g + e) = v;
    }
    for (; e < e1; ++e) g[e] = clip(g[e]);
  } else {
    for (long long e = e0 + threadIdx.x; e < e1; e += THREADS) g[e] = clip(g[e]);
  }
}

}  // namespace

// Blocks one leaf of numel elements takes in either launch.
extern "C" long long mt_grad_norm_blocks(long long numel) { return numel > 0 ? (numel + CHUNK - 1) / CHUNK : 0; }

// One launch (kind 0 sumsq, 1 clip) over n <= MAX_LEAVES leaves, table: n
// rows of (g, numel) as 64-bit integers, g fp32 contiguous. partials: the
// step's `total` floats, this launch's blocks at `offset`; state: two
// unsigned ints, zero before a step's first launch (the finishing launch
// leaves the counter at zero); out: one float, the norm. finish: 1 in the
// step's last sumsq launch. The clip launches run after the sums.
extern "C" int mt_grad_norm(int kind, const long long* table, int n, float* partials, int offset, int total, int finish, unsigned* state, float* out,
                            float max_norm, void* stream) {
  if (kind < 0 || kind > 1 || n <= 0 || n > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  NLeaves T;
  long long blocks = 0;
  for (int j = 0; j < n; ++j) {
    const long long* row = table + 2 * j;
    if (row[1] <= 0) return (int)cudaErrorInvalidValue;
    T.leaf[j] = NLeaf{reinterpret_cast<float*>(row[0]), row[1], (int)blocks};
    blocks += mt_grad_norm_blocks(row[1]);
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  }
  for (int j = n; j < MAX_LEAVES; ++j) T.leaf[j] = NLeaf{nullptr, 0, 0x7FFFFFFF};
  if (kind == 0 && (offset < 0 || (long long)offset + blocks > total)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    sumsq_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(T, n, partials, offset, total, finish, state, out, max_norm);
  else
    clip_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(T, n, state, out, max_norm);
  return (int)cudaGetLastError();
}
