// Weight gradient of the dense channels-last dhconv: kernel K9 of makani_torch.
//
// Replaces the weight half of jax.grad through
// makani_tpu/models/common/contractions.py contract_dense_s (dhconv, dense,
// channels-last: 'bxygi,giox->bxygo' as the four real einsums of
// cmul_einsum_s), which XLA computes as einsums:
//
//   dw[g, i, o, l] = sum_{b, m} conj(x[b, l, m, g, i]) * gy[b, l, m, g, o]   (complex)
//
// on split-complex data (trailing re/im pair): dwr = sum xr gr + xi gi,
// dwi = sum xr gi - xi gr. It writes the parameter's own layout
// (G, Ci, Co, L, 2), so no copy follows.
//
// What bounds it on the card: at the SFNO training step (B 3, L 120, M 121,
// C 384) a layer is 8 B M L Ci Co = 51.4 GFLOP against ~0.32 GB of traffic
// (x and gy read once, dw written once), so it is bound by operations:
// 0.77 ms a layer on the fp32 FMA pipes (67 TFLOP/s), 0.31 ms in 3xTF32 on
// the tensor cores. The depth of each product is short (B M = 363) against
// its 384 x 384 outputs per degree, so the work is spread over (l, tiles of
// i x o), never over the depth: every output is one block's sum in a fixed
// order, with no atomics and no second pass.
//
// Design: plain fp32 FMAs, accumulated in fp32 (bf16 input is widened on
// load). A 256-thread block takes one (l, g) and a tile of 64 input x 64
// output channels (complex); each thread 4 x 4 complex outputs in 32
// registers. The depth is staged through shared memory 16 rows (b, m) at a
// time, x's and gy's tiles as 128 floats a row, read by each thread as two
// 16-byte vectors of each (broadcast for x, distinct banks for gy): 64 FMAs
// for 4 shared-memory loads. The next stage is loaded from device memory into
// registers while the current one is summed. Ragged channels and depth are zero-filled in
// shared memory. Blocks run with l fastest, so that the 8-byte stores of
// neighbouring degrees (dw is l-contiguous) meet in L2. Tensor cores
// (3xTF32, as K3) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int TI = 64;        // input channels a block
constexpr int TO = 64;        // output channels a block
constexpr int NC = 16;        // depth rows (b, m) a stage
constexpr int THREADS = 256;  // 16 x 16 threads of 4 x 4 outputs

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dhconv_grad_weight_kernel(const T* __restrict__ x, const T* __restrict__ gy, float* __restrict__ dw, int B, int L, int M, int G, int Ci, int Co,
                              int tiles_o) {
  __shared__ __align__(16) float xs[NC][2 * TI];
  __shared__ __align__(16) float gs[NC][2 * TO];
  const int l = blockIdx.x;
  const int i0 = (blockIdx.y / tiles_o) * TI, o0 = (blockIdx.y % tiles_o) * TO;
  const int g = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int N = B * M;

  float acc_r[4][4], acc_i[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_r[a][c] = acc_i[a][c] = 0.f;

  // this thread stages column col of rows row0, row0 + 2, ... of each stage
  // (consecutive threads, consecutive floats); the next stage's values are
  // loaded into registers while the current stage is summed
  constexpr int PER = NC * 2 * TI / THREADS;  // 8 rows a thread
  const int col = tid % (2 * TI), row0 = tid / (2 * TI);
  const bool x_in = i0 + col / 2 < Ci, g_in = o0 + col / 2 < Co;
  const long long xs_row = (long long)G * Ci * 2, gs_row = (long long)G * Co * 2;  // a row (b, l, m) apart
  const T* xcol = x + (long long)g * Ci * 2 + (long long)i0 * 2 + col;
  const T* gcol = gy + (long long)g * Co * 2 + (long long)o0 * 2 + col;
  float px[PER], pg[PER];
  auto fetch = [&](int n0) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int n = n0 + row0 + 2 * k;
      px[k] = pg[k] = 0.f;
      if (n < N) {
        const int b = n / M, m = n - b * M;
        const long long r = (long long)(b * L + l) * M + m;
        if (x_in) px[k] = mt::to_f32(xcol[r * xs_row]);
        if (g_in) pg[k] = mt::to_f32(gcol[r * gs_row]);
      }
    }
  };
  fetch(0);

  for (int n0 = 0; n0 < N; n0 += NC) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      xs[row0 + 2 * k][col] = px[k];
      gs[row0 + 2 * k][col] = pg[k];
    }
    __syncthreads();
    if (n0 + NC < N) fetch(n0 + NC);
#pragma unroll 4
    for (int r = 0; r < NC; ++r) {
      const float4 xa = *reinterpret_cast<const float4*>(&xs[r][ty * 8]);
      const float4 xb = *reinterpret_cast<const float4*>(&xs[r][ty * 8 + 4]);
      const float4 ga = *reinterpret_cast<const float4*>(&gs[r][tx * 8]);
      const float4 gb = *reinterpret_cast<const float4*>(&gs[r][tx * 8 + 4]);
      const float xr[4] = {xa.x, xa.z, xb.x, xb.z}, xi[4] = {xa.y, xa.w, xb.y, xb.w};
      const float gr[4] = {ga.x, ga.z, gb.x, gb.z}, gi[4] = {ga.y, ga.w, gb.y, gb.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc_r[a][c] = fmaf(xr[a], gr[c], acc_r[a][c]);
          acc_r[a][c] = fmaf(xi[a], gi[c], acc_r[a][c]);
          acc_i[a][c] = fmaf(xr[a], gi[c], acc_i[a][c]);
          acc_i[a][c] = fmaf(-xi[a], gr[c], acc_i[a][c]);
        }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    if (i >= Ci) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int o = o0 + tx * 4 + c;
      if (o >= Co) continue;
      float2* dst = reinterpret_cast<float2*>(dw + (((long long)g * Ci + i) * Co + o) * L * 2 + (long long)l * 2);
      *dst = make_float2(acc_r[a][c], acc_i[a][c]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* gy, void* dw, int B, int L, int M, int G, int Ci, int Co, cudaStream_t s) {
  const int tiles_i = (Ci + TI - 1) / TI, tiles_o = (Co + TO - 1) / TO;
  if ((long long)tiles_i * tiles_o > 65535 || G > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(L, tiles_i * tiles_o, G);
  dhconv_grad_weight_kernel<T><<<grid, THREADS, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(gy), static_cast<float*>(dw), B, L, M, G, Ci,
                                                       Co, tiles_o);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x and gy); x (B, L, M, G, Ci, 2), gy (B, L,
// M, G, Co, 2) contiguous; dw float32 (G, Ci, Co, L, 2), every entry
// written. Returns cudaGetLastError() after the launch, or an argument error.
extern "C" int mt_dhconv_grad_weight(int dtype, const void* x, const void* gy, void* dw, int B, int L, int M, int G, int Ci, int Co, void* stream) {
  if (B <= 0 || L <= 0 || M <= 0 || G <= 0 || Ci <= 0 || Co <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(dw) % 8) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, gy, dw, B, L, M, G, Ci, Co, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, gy, dw, B, L, M, G, Ci, Co, s);
  return (int)cudaErrorInvalidValue;
}
