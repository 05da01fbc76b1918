// The transpose of the bilinear resampling: kernel K14 of makani_torch.
//
// Replaces the VJP of makani_tpu/ops/resample.py ResampleS2.__call__ (:81),
// which JAX derives as the scatter-adds of the two lerps: the gradient of
// K7 (resample.cu). With the forward's tables lat_idx, lat_w, lon_idx0,
// lon_idx1, lon_w, every output pixel (ho, wo) spreads its gradient dy over
// four input pixels, (lat_idx[ho] + {0, 1}, lon_idx{0, 1}[wo]), with the
// weights (1 - lat_w, lat_w) x (1 - lon_w, lon_w). This kernel gathers
// instead of scattering: the wrapper inverts the tables on the host into
// lists, for each input row the (output row, weight) pairs that read it and
// for each input column the (output column, weight) pairs, and
//
//   dx[b, hi, wi, c] = sum_{(ho, a) in rows(hi)} a * sum_{(wo, v) in cols(wi)} v * dy[b, ho, wo, c]
//
// is summed in list order by one thread per (b, hi, wi, c), with no atomics:
// deterministic, unlike an index_add_. Output rows that clamp at the poles
// (lat_idx + 1 at the last row, lat_w clipped to 0 or 1) are ordinary list
// entries of weight 0 or 1.
//
// dy is channels-last (B, Hout, Wout, C), contiguous; dx is (B, Hin, Win, C)
// contiguous. A block of 256 threads covers consecutive (wi, c) elements of
// one input row: a warp reads 32 consecutive channels of an output pixel
// (128 bytes) per list entry and writes 128 contiguous bytes.
//
// What bounds it on the card: the bytes. At the FCN3 atmo decoder (B 4,
// 361 x 720 -> 180 x 360, C 585) it must read 2.43 GB of dy and write 0.61
// GB of dx. Each dy element is read once per input pixel it feeds (up to
// four times, the repeats from L1 or L2: the two or three output columns of
// an input column lie next to each other, and the output rows of neighbouring
// input rows are read by the blocks running beside each other).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    resample_grad_kernel(const float* __restrict__ dy, float* __restrict__ dx, const int* __restrict__ row_ptr, const int* __restrict__ row_idx,
                         const float* __restrict__ row_w, const int* __restrict__ col_ptr, const int* __restrict__ col_idx,
                         const float* __restrict__ col_w, int Hin, int Win, int Hout, int Wout, int C) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (long long)Win * C) return;
  const int hi = blockIdx.y, b = blockIdx.z;
  const int wi = (int)(e / C), c = (int)(e - (long long)wi * C);
  const int r0 = row_ptr[hi], r1 = row_ptr[hi + 1], k0 = col_ptr[wi], k1 = col_ptr[wi + 1];
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) {
    const float* src = dy + ((long long)b * Hout + row_idx[r]) * Wout * C + c;
    float s = 0.f;
    for (int k = k0; k < k1; ++k) s = fmaf(col_w[k], src[(long long)col_idx[k] * C], s);
    acc = fmaf(row_w[r], s, acc);
  }
  dx[((long long)b * Hin + hi) * Win * C + e] = acc;
}

}  // namespace

// dy: float32 (B, Hout, Wout, C) contiguous; dx: float32 (B, Hin, Win, C)
// contiguous, written whole; row_ptr (Hin + 1), row_idx, row_w: for input
// row hi the output rows row_idx[row_ptr[hi] .. row_ptr[hi + 1]) that read
// it with their latitude weights; col_ptr (Win + 1), col_idx, col_w the
// same for the columns. Returns cudaGetLastError() after the launch.
extern "C" int mt_resample_grad(const void* dy, void* dx, const void* row_ptr, const void* row_idx, const void* row_w, const void* col_ptr,
                                const void* col_idx, const void* col_w, int B, int Hin, int Win, int Hout, int Wout, int C, void* stream) {
  if (B <= 0 || B > 65535 || Hin <= 0 || Hin > 65535 || Win <= 0 || Hout <= 0 || Wout <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const long long nx = ((long long)Win * C + THREADS - 1) / THREADS;
  if (nx > 2147483647LL) return (int)cudaErrorInvalidValue;
  resample_grad_kernel<<<dim3((unsigned)nx, Hin, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<float*>(dx), static_cast<const int*>(row_ptr), static_cast<const int*>(row_idx),
      static_cast<const float*>(row_w), static_cast<const int*>(col_ptr), static_cast<const int*>(col_idx), static_cast<const float*>(col_w), Hin,
      Win, Hout, Wout, C);
  return (int)cudaGetLastError();
}
