// The AFNO spectral mixer, forward: kernel K18 of makani_torch.
//
// Replaces the split re/im einsums of makani_tpu/models/networks/afnonet.py
// AFNO2D (:78-97, FourCastNet v1) and afnonet_v2.py AFNO2Dv2 (_compl_mul_add_s
// :33-39 and the mixer, truncation and soft-shrink :77-92). For each spectral
// mode m of sample b and channel block k, with x the block's bs-vector of
// complex inputs:
//
//   o1 = relu(W1[k]^T x + b1[k])   (relu on re and im apart: "cartesian")
//   o2 = W2[k]^T o1 + b2[k]
//   y  = softshrink(kept(m) ? o2 : 0, lambda)   (on re and im apart)
//
// b1 and b2 are v1's (v2 has none: null pointers). kept(m) is the band of
// modes (afno.cuh Band): v1's centered rows, v2's two-sided rows, all modes at
// hard_thresholding_fraction 1. Inputs, weights, accumulation and output are
// fp32.
//
// What bounds it on the card: the operations. At afno_73ch (B 1, 90 x 91
// modes, C 768, nb 8, bs 96) one launch does 8 blocks x 8190 modes x 2
// products x 4 real 96 x 96 products = 9.66 GFLOP against 100.6 MB of x in and
// y out: 0.144 ms on the fp32 FMA pipes, 0.059 ms as three TF32 passes on the
// tensor cores.
//
// Design: afno.cuh's mode-tile kernel in its FORWARD mode. Both products run
// on wgmma in 3xTF32, 64 modes a warpgroup and two warpgroups a block (128
// modes of one channel block). x's fragments are read through its strides
// straight into registers (in place from the rFFT's channels-first storage),
// the first product's accumulators get the bias and the split relu and become
// the second product's A fragments (parked in the thread's own shared-memory
// slots; in training also written to o1 for K19), and the second product's
// epilogue adds the bias, applies the band and the soft-shrink and writes y
// through its strides. The weights are expanded into the 2x2 blocks' TF32
// planes as they are staged, once per 128 modes: ~75 MB of weight reads from
// L2 a launch at afno_73ch against 100.6 MB of spectrum from device memory.
//
// What holds it above its bound: each stage's fixed work in the block's 8
// warps (the A fragments' splits, the weights' copies and expansion, the
// partial sums, the wait for the stage's wgmmas and the barrier), not the
// tensor cores: with the wgmmas cut out it keeps ~80% of its time, and no
// other single cut saves more than ~11% (sweep_k18_k19.py, PERF.md). A
// block's ~220 registers a thread and 171 KB of shared memory leave one
// block, 8 warps, on an SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "afno.cuh"

// K18. x, y: fp32 spectra with strides (sB, sM, sC) in floats (y the same
// layout as x); h: null, or fp32 (B, nb, hbs, M, 2) for the hidden o1 after
// the relu (afno.cuh hidden_at); w1 (nb, 2, bs, hbs), w2 (nb, 2, hbs, bs), b1
// (nb, 2, hbs) and b2 (nb, 2, bs) fp32 (the biases may be null), read in place
// through the 16 strides wst (afno.cuh Params: w1, w2, b1, b2). M = H * Wh
// modes.
extern "C" int mt_afno_mixer(const void* x, void* y, void* h, const void* w1, const void* b1, const void* w2, const void* b2, const long long* wst, int B, int M,
                             int Wh, int nb, int bs, int hbs, long long sB, long long sM, long long sC, int ra0, int ra1, int rb0, int rb1, int kc, float lambd,
                             void* stream) {
  if (B <= 0 || B > 65535 || M <= 0 || Wh <= 0 || M % Wh || nb <= 0 || nb > 65535 || bs <= 0 || hbs <= 0 || lambd < 0.f || wst == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(h)) % 8 || (sB | sM | sC) % 2)
    return (int)cudaErrorMisalignedAddress;
  const afno::Layout L{sB, sM, sC};
  afno::TileArgs t{static_cast<const float*>(x), nullptr, nullptr, static_cast<float*>(h), static_cast<float*>(y), static_cast<const float*>(w1),
                   static_cast<const float*>(w2), static_cast<const float*>(b1), static_cast<const float*>(b2), L, L, L, afno::params_from(wst)};
  return afno::launch_tile<afno::FORWARD>(t, B, M, Wh, nb, bs, hbs, afno::Band{ra0, ra1, rb0, rb1, kc}, lambd, static_cast<cudaStream_t>(stream));
}
