// Ensemble CRPS in its skill-spread form, forward and backward: kernel K15 of
// makani_torch.
//
// Replaces makani_tpu/utils/losses/crps_loss.py crps_ensemble (:136) with
// crps_type "skillspread" (_crps_skillspread :87, _abs_sym :42) and the VJP
// that JAX derives for it through jnp.sort. For each pixel n of sample b,
// with the E members f_e = F[b, e, n] and the observation y = obs[b, n]:
//
//   crps = (1/E) sum_e |y - f_e|
//          - (1/E) sum_r (2r + 1 - E) fs_r * (E - 1 + alpha) / (E (E - 1))
//
// fs the members in ascending order (the spread term is 0 for E = 1). The
// gradient with respect to member e, times the incoming g[b, n]:
//
//   dF[b, e, n] = g * ( sign(f_e - y) / E
//                       - (2 rank_e + 1 - E) (E - 1 + alpha) / (E^2 (E - 1)) )
//
// sign is 0 at f_e == y (_abs_sym's symmetric subgradient). rank_e counts the
// members below f_e, and the equal members of lower index: jnp.sort's VJP
// routes the gradient through a stable sort, so tied members take their
// ranks in member order, and so does this kernel.
//
// One thread a pixel reads its E members (strided by N floats: consecutive
// threads read consecutive pixels, coalesced), keeps them in registers and
// ranks each member against the others (E^2 comparisons, E <= 16, a template
// parameter). No sorted copy is made: sum_r c_r fs_r = sum_e c_(rank_e) f_e.
//
// What bounds it on the card: the bytes. At the FCN3 ensemble step (B 1,
// E 4, 73 x 361 x 720) the forward reads 304 MB and writes 76 MB, the
// backward reads 380 MB and writes 304 MB, against ~E^2 + 4E operations a
// member.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_E = 16;

// rank of member e among f[0..E): the members below it, and the equal ones
// of lower index
template <int E>
__device__ __forceinline__ int rank_of(const float (&f)[E], int e) {
  int r = 0;
#pragma unroll
  for (int k = 0; k < E; ++k) r += (f[k] < f[e]) || (f[k] == f[e] && k < e);
  return r;
}

__device__ __forceinline__ float sgn(float d) { return (float)((d > 0.f) - (d < 0.f)); }

template <int E>
__global__ void __launch_bounds__(THREADS)
    crps_fwd_kernel(const float* __restrict__ F, const float* __restrict__ obs, float* __restrict__ out, long long N, float spread_scale) {
  const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const long long b = blockIdx.y;
  const float* fb = F + b * E * N + n;
  const float y = obs[b * N + n];
  float f[E];
#pragma unroll
  for (int e = 0; e < E; ++e) f[e] = fb[e * N];
  float skill = 0.f, spread = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    skill += fabsf(y - f[e]);
    if (E > 1) spread = fmaf((float)(2 * rank_of<E>(f, e) + 1 - E), f[e], spread);
  }
  // eskill - 0.5 * espread, espread = 2 * mean(c * fs) * (E - 1 + alpha) / (E (E - 1))
  out[b * N + n] = skill / E - (E > 1 ? (spread / E) * spread_scale : 0.f);
}

template <int E>
__global__ void __launch_bounds__(THREADS) crps_bwd_kernel(const float* __restrict__ F, const float* __restrict__ obs, const float* __restrict__ g,
                                                           float* __restrict__ dF, long long N, float rank_scale) {
  const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const long long b = blockIdx.y;
  const float* fb = F + b * E * N + n;
  float* db = dF + b * E * N + n;
  const float y = obs[b * N + n], gn = g[b * N + n];
  float f[E];
#pragma unroll
  for (int e = 0; e < E; ++e) f[e] = fb[e * N];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    float d = sgn(f[e] - y) / E;
    if (E > 1) d -= (float)(2 * rank_of<E>(f, e) + 1 - E) * rank_scale;
    db[e * N] = gn * d;
  }
}

template <int E>
int launch(int mode, const float* F, const float* obs, const float* g, float* out, int B, long long N, float alpha, cudaStream_t s) {
  const dim3 grid((unsigned)((N + THREADS - 1) / THREADS), (unsigned)B);
  if (mode == 0) {
    const float spread_scale = E > 1 ? (E - 1 + alpha) / (float)(E * (E - 1)) : 0.f;
    crps_fwd_kernel<E><<<grid, THREADS, 0, s>>>(F, obs, out, N, spread_scale);
  } else {
    const float rank_scale = E > 1 ? (E - 1 + alpha) / (float)(E * E * (E - 1)) : 0.f;
    crps_bwd_kernel<E><<<grid, THREADS, 0, s>>>(F, obs, g, out, N, rank_scale);
  }
  return (int)cudaGetLastError();
}

template <int E>
int dispatch(int E_, int mode, const float* F, const float* obs, const float* g, float* out, int B, long long N, float alpha, cudaStream_t s) {
  if constexpr (E > MAX_E) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (E_ == E) return launch<E>(mode, F, obs, g, out, B, N, alpha, s);
    return dispatch<E + 1>(E_, mode, F, obs, g, out, B, N, alpha, s);
  }
}

}  // namespace

// mode 0, forward: F float32 (B, E, N), obs (B, N) -> out (B, N), the
// pointwise CRPS; mode 1, backward: with g (B, N) the gradient of the loss
// with respect to out -> out (B, E, N), its gradient with respect to F. All
// contiguous, 1 <= E <= 16. Returns cudaGetLastError() after the launch.
extern "C" int mt_crps_skillspread(int mode, const void* F, const void* obs, const void* g, void* out, int B, int E, long long N, float alpha,
                                   void* stream) {
  if ((mode != 0 && mode != 1) || B <= 0 || B > 65535 || E <= 0 || E > MAX_E || N <= 0 || (N + THREADS - 1) / THREADS > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  return dispatch<1>(E, mode, static_cast<const float*>(F), static_cast<const float*>(obs), static_cast<const float*>(g), static_cast<float*>(out), B,
                     N, alpha, static_cast<cudaStream_t>(stream));
}
