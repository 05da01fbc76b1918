// The transpose of the bilinear resampling: kernel K14 of makani_torch.
//
// Replaces the VJP of makani_tpu/ops/resample.py ResampleS2.__call__ (:81),
// which JAX derives as the scatter-adds of the two lerps: the gradient of
// K7 (resample.cu). With the forward's tables lat_idx, lat_w, lon_idx0,
// lon_idx1, lon_w, every output pixel (ho, wo) sends its gradient dy to four
// input pixels, (lat_idx[ho] + {0, 1}, lon_idx{0, 1}[wo]), with the weights
// (1 - lat_w, lat_w) x (1 - lon_w, lon_w):
//
//   dx[b, hi, wi, c] = sum_{ho: lat_idx[ho] = hi} (1 - lat_w[ho]) * s[b, ho, wi, c]
//                    + sum_{ho: lat_idx[ho] = hi - 1} lat_w[ho] * s[b, ho, wi, c],
//   s[b, ho, wi, c] = sum_{(wo, v) in cols(wi)} v * dy[b, ho, wo, c].
//
// cols(wi) is the inverted column table without its zero weights (the even
// output columns of a 2x upsampling read one input column with weight 1 and
// the next with weight 0): for finite dy a zero weight adds exactly 0.
//
// dy is channels-last (B, Hout, Wout, C), contiguous, 16-byte aligned; dx is
// (B, Hin, Win, C) contiguous, 16-byte aligned, written whole. What bounds
// it on the card: the bytes. At the FCN3 atmo decoder (B 4, 361 x 720 ->
// 180 x 360, C 585) it must read 2.43 GB of dy and write 0.61 GB of dx
// (0.907 ms at 3.35 TB/s), at ~6 operations a dy element.
//
// The design: a streamed walk down the output rows that reads each dy
// element from device memory once per tile. A block owns one sample b, a
// tile of TW = 8 NC consecutive input columns (all C channels, or a channel
// chunk where a slot would not fit) and a strip of input rows [j0, j1).
// lat_idx is nondecreasing (the wrapper checks it), so the output rows that
// reach the strip are one run, ho in [ho0, ho1): those with lat_idx in
// [j0 - 1, j1 - 1], about two a strip row plus the one or two it shares
// with the strip above. For each such ho, in order:
//  1. Staging. The tile's segment of the dy row, the run of output columns
//     its input columns read (about 2 TW + 1 pixels at a 2x upsampling,
//     wrapping at column 0 as K7's span does), comes into a ring of slots
//     in shared memory as one or two contiguous pieces (one a pixel for a
//     channel chunk): one bulk copy on the slot's mbarrier a piece, from its
//     16-byte aligned floor (a 585-channel pixel is only 4-byte aligned), so
//     that the piece lands `lead` floats into its place (lead = its start's
//     address mod 16, over 4), and one 16-byte cp.async with a zero fill for
//     its partial last chunk, which reads nothing past the piece. The slot's
//     table holds the row's lat_idx and lat_w and each column's entries
//     {offset in the slot with the lead, weight}; each thread keeps one
//     entry of the tile's lists in registers and writes it for a row after
//     the sums of the row before, while that row's lat_w load is in flight.
//     RING - 1 rows are in flight while one is folded.
//  2. Longitude transpose, from shared memory: a warp owns NC whole columns
//     of the tile, a lane the channels lane + 32 g of each (g < GU groups),
//     so a warp loads each entry once (a broadcast) for its GU channel
//     groups, and the loads of the groups are one base register and
//     immediate offsets. Lanes read consecutive floats: no bank conflicts.
//     A tile pads its columns to its longest list with zero weights (which
//     add exactly 0); a lane past a pixel's channels reads floats beyond it
//     (in the ring, or the tables and the pad behind it) and keeps nothing.
//  3. Latitude transpose, in registers: a window of two row accumulators a
//     (column, group), rows r = lat_idx[ho] and r + 1, takes each entry's x
//     with the weights (1 - lat_w) v and lat_w v. When lat_idx moves past r,
//     row r is complete: it is stored once, 4 bytes a lane along a column's
//     channels (rows no output row reads as zeros), and the window slides.
// Each dx element is summed by one thread in a fixed order (output rows
// ascending, entries in output-column order), with no atomics: two launches
// are bit-equal, and so are two plans. Offsets within a row are 32-bit, and
// no element needs a division.
//
// The plan (ops/resample.py plan_resample_grad, made on the host once per
// resampler, device, channel count and batch) is an int32 table: one record
// per tile and channel chunk (its first column, width, first channel,
// channels, pieces {start in the row, floats, place in the slot} and the
// entries {offset, start mod 4, weight bits} of each column), then one
// {j0, j1, ho0, ho1} per strip. The block grid is (records, strips, B).
// The plan also gives the launch's shared memory, which the entry point
// holds to the layout below. sweep_k14.py times other tile widths, channel
// chunks, strip heights and ring depths, 16-byte cp.async copies in place
// of the bulk copies, and the kernel with its copies, its compute or its
// stores cut out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_RING = 8;
constexpr int MAX_UNITS = 20;  // NC * GU: a thread's (column, group) pairs

// a record's header, then pieces_max x {start, floats, place}, then TW x kt_max x {offset, start mod 4, weight}
enum { H_WI0, H_TW, H_C0, H_CC, H_NP, H_KT, HEADER = 8 };

struct Params {
  int B, Hin, Win, Hout, Wout, C;
  int TW, ring, kt_max, pieces_max, slot_floats, tbl_stride, record_ints, n_records;
};

__host__ __device__ inline int bar_bytes(int ring) { return (8 * ring + 15) & ~15; }
// a slot's table: {lat_idx, lat_w, 0, 0}, then TW x kt_max entries {offset, weight}
__host__ __device__ inline int table_ints(int TW, int kt_max) { return 4 + 2 * TW * kt_max; }

// the ring's mbarriers, slots and tables, and 32 GU floats that a lane past
// the last slot's last channels may read
int smem_bytes(int ring, int slot_floats, int TW, int kt_max, int GU) {
  return bar_bytes(ring) + 4 * ring * slot_floats + 4 * ring * table_ints(TW, kt_max) + 128 * GU;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// waits until at most n of this thread's cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: sm90::cp_async_wait<0>(); break;
    case 1: sm90::cp_async_wait<1>(); break;
    case 2: sm90::cp_async_wait<2>(); break;
    case 3: sm90::cp_async_wait<3>(); break;
    case 4: sm90::cp_async_wait<4>(); break;
    case 5: sm90::cp_async_wait<5>(); break;
    default: sm90::cp_async_wait<6>(); break;
  }
}

template <int NC, int GU>
__global__ void __launch_bounds__(THREADS, 1)
    resample_grad_walk_kernel(const float* __restrict__ dy, float* __restrict__ dx, const int* __restrict__ lat_idx, const float* __restrict__ lat_w,
                              const int* __restrict__ plan, Params p) {
  constexpr int U = NC * GU;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* slots = reinterpret_cast<float*>(smem + bar_bytes(p.ring));
  int* tabs = reinterpret_cast<int*>(slots + p.ring * p.slot_floats);

  const int* rec = plan + blockIdx.x * p.record_ints;
  const int* strip = plan + p.n_records * p.record_ints + blockIdx.y * 4;
  const int b = blockIdx.z;
  const int wi0 = rec[H_WI0], tw = rec[H_TW], c0 = rec[H_C0], cc = rec[H_CC], np = rec[H_NP], kt = rec[H_KT];
  const int* pieces = rec + HEADER;
  const int* ents = pieces + 3 * p.pieces_max;
  const int j0 = strip[0], j1 = strip[1], ho0 = strip[2];
  const int n_rows = strip[3] - ho0;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_ent = p.TW * p.kt_max;

  // this warp's columns warp * NC + c (c < NC), this lane's channels lane + 32 g (g < GU)
  unsigned valid = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int g = 0; g < GU; ++g) valid |= warp * NC + c < tw && 32 * g + lane < cc ? 1u << (c * GU + g) : 0u;
  // this thread's entry of the tile's column lists (TW * kt_max <= THREADS)
  const bool has_ent = tid < n_ent;
  const int e_off = has_ent ? ents[3 * tid] : 0, e_m = has_ent ? ents[3 * tid + 1] : 0, e_w = has_ent ? ents[3 * tid + 2] : 0;

  if (tid == 0) {
    for (int q = 0; q < p.ring; ++q) sm90::mbar_init(&bars[q], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  // the copies of row n of the strip into slot n % ring
  auto copy_row = [&](int n) {
    const int slot = n % p.ring;
    float* dst = slots + slot * p.slot_floats;
    const long long row = ((long long)b * p.Hout + ho0 + n) * p.Wout * p.C;
    // each piece's whole 16-byte chunks in one bulk copy; its partial last chunk by one cp.async that stops at the piece's end
    if (tid == 0) {
      int bytes = 0;
      for (int k = 0; k < np; ++k) bytes += 16 * (((int)((row + pieces[3 * k]) & 3) + pieces[3 * k + 1]) / 4);
      sm90::fence_proxy_async();  // the slot's earlier reads before the copy engine's writes
      sm90::mbar_arrive_expect_tx(&bars[slot], bytes);
      for (int k = 0; k < np; ++k) {
        const long long g = row + pieces[3 * k];
        const int lead = (int)(g & 3), whole = (lead + pieces[3 * k + 1]) / 4;
        if (whole > 0) sm90::bulk_copy(dst + pieces[3 * k + 2], dy + (g - lead), 16 * whole, &bars[slot]);
      }
    }
    for (int k = tid; k < np; k += THREADS) {
      const long long g = row + pieces[3 * k];
      const int lead = (int)(g & 3), whole = (lead + pieces[3 * k + 1]) / 4, rest = (lead + pieces[3 * k + 1]) % 4;
      if (rest > 0) sm90::cp_async_zfill16(dst + pieces[3 * k + 2] + 4 * whole, dy + (g - lead) + 4 * whole, 4 * rest);
    }
  };
  // row n's table: {lat_idx, lat_w}, then each entry {offset with the row's lead, weight}
  auto write_table = [&](int n, int li, int u) {
    int* tab = tabs + (n % p.ring) * p.tbl_stride;
    const int rb = (int)((((long long)b * p.Hout + ho0 + n) * p.Wout * p.C) & 3);
    if (tid == 0) *reinterpret_cast<int2*>(tab) = make_int2(li, u);
    if (has_ent) *reinterpret_cast<int2*>(tab + 4 + 2 * tid) = make_int2(e_off + ((rb + e_m) & 3), e_w);
  };

  // dx row q of the tile: the units' values (zero: zeros)
  auto store = [&](int q, const float(&acc)[U], bool zero) {
    float* out = dx + ((long long)b * p.Hin + q) * p.Win * p.C + (long long)(wi0 + warp * NC) * p.C + c0 + lane;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int g = 0; g < GU; ++g)
        if (valid >> (c * GU + g) & 1) put(out + c * p.C + 32 * g, zero ? 0.f : acc[c * GU + g]);
  };

  for (int n = 0; n < p.ring - 1; ++n) {
    if (n < n_rows) {
      copy_row(n);
      write_table(n, tid == 0 ? lat_idx[ho0 + n] : 0, tid == 0 ? __float_as_int(lat_w[ho0 + n]) : 0);
    }
    sm90::cp_async_commit();
  }

  float a0[U], a1[U];
#pragma unroll
  for (int i = 0; i < U; ++i) a0[i] = a1[i] = 0.f;
  int r = 0, next = j0;  // the window's rows r, r + 1; the strip's first row not yet stored
  // row q complete: the strip's rows before it that no output row reads are zeros
  auto flush = [&](int q, const float(&acc)[U]) {
    if (q < j0) return;
    for (; next < q; ++next) store(next, acc, true);
    store(q, acc, false);
    next = q + 1;
  };

  for (int n = 0; n < n_rows; ++n) {
    const int slot = n % p.ring;
    sm90::mbar_wait(&bars[slot], (n / p.ring) & 1);
    cp_async_wait_upto(p.ring - 2);
    __syncthreads();  // row n landed for every thread; row n - 1's slot and table are free
    // row n + ring - 1: its copies now, its table after this row's sums (its loads in flight meanwhile)
    const int nn = n + p.ring - 1;
    int li_next = 0, u_next = 0;
    if (nn < n_rows) {
      copy_row(nn);
      if (tid == 0) {
        li_next = lat_idx[ho0 + nn];
        u_next = __float_as_int(lat_w[ho0 + nn]);
      }
    }
    sm90::cp_async_commit();

    const int* tab = tabs + slot * p.tbl_stride;
    const float* seg = slots + slot * p.slot_floats + lane;
    const int2 hdr = *reinterpret_cast<const int2*>(tab);
    const int li = hdr.x;
    const float u = __int_as_float(hdr.y), w0 = 1.f - u;
    if (n == 0) {
      r = li;
    } else if (li != r) {
      flush(r, a0);
      if (li == r + 1) {
#pragma unroll
        for (int i = 0; i < U; ++i) {
          a0[i] = a1[i];
          a1[i] = 0.f;
        }
      } else {
        flush(r + 1, a1);
#pragma unroll
        for (int i = 0; i < U; ++i) a0[i] = a1[i] = 0.f;
      }
      r = li;
    }
    // the row's column sums go straight into the window: entry k of a column, {offset, v}, adds (1 - lat_w) v x and lat_w v x
    const int2* ent = reinterpret_cast<const int2*>(tab + 4) + warp * NC * p.kt_max;
    for (int k = 0; k < kt; ++k) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int2 e = ent[c * p.kt_max + k];
        const float v0 = w0 * __int_as_float(e.y), v1 = u * __int_as_float(e.y);
        const float* x = seg + e.x;
#pragma unroll
        for (int g = 0; g < GU; ++g) {
          const float xv = x[32 * g];
          a0[c * GU + g] = fmaf(v0, xv, a0[c * GU + g]);
          a1[c * GU + g] = fmaf(v1, xv, a1[c * GU + g]);
        }
      }
    }
    if (nn < n_rows) write_table(nn, li_next, u_next);
  }
  if (n_rows > 0) {
    flush(r, a0);
    if (r + 1 < j1) flush(r + 1, a1);
  }
  for (; next < j1; ++next) store(next, a0, true);
  sm90::cp_async_wait<0>();
}

template <int NC, int GU>
int launch(const float* dy, float* dx, const int* li, const float* lw, const int* plan, const Params& p, int n_strips, int smem, cudaStream_t s) {
  if constexpr (NC * GU > MAX_UNITS) {
    return (int)cudaErrorInvalidValue;
  } else {
    // the plan's shared memory (ops/resample.py _grad_smem_bytes) must be this layout's
    if (smem != smem_bytes(p.ring, p.slot_floats, p.TW, p.kt_max, GU)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(resample_grad_walk_kernel<NC, GU>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    resample_grad_walk_kernel<NC, GU><<<dim3(p.n_records, n_strips, p.B), THREADS, smem, s>>>(dy, dx, li, lw, plan, p);
    return (int)cudaGetLastError();
  }
}

template <int GU>
int launch_nc(int columns, const float* dy, float* dx, const int* li, const float* lw, const int* plan, const Params& p, int n_strips, int smem,
              cudaStream_t s) {
  switch (columns) {
    case 1: return launch<1, GU>(dy, dx, li, lw, plan, p, n_strips, smem, s);
    case 2: return launch<2, GU>(dy, dx, li, lw, plan, p, n_strips, smem, s);
    case 4: return launch<4, GU>(dy, dx, li, lw, plan, p, n_strips, smem, s);
    case 8: return launch<8, GU>(dy, dx, li, lw, plan, p, n_strips, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dy: float32 (B, Hout, Wout, C) contiguous, 16-byte aligned; dx: float32
// (B, Hin, Win, C) contiguous, 16-byte aligned, written whole; lat_idx
// (Hout) int32 nondecreasing in [0, Hin - 2], lat_w (Hout) float32; plan:
// the int32 table of ops/resample.py plan_resample_grad (n_records records
// of record_ints, then n_strips strips), made for these shapes. A warp
// owns `columns` (1, 2, 4 or 8) of the tile_width = 8 columns input columns,
// a lane `groups` (1, 2, 4, 8, 12, 16 or 20; columns x groups <= 20)
// channels of each, 32 apart; smem: the plan's shared memory bytes, which
// must equal the layout's. Returns cudaGetLastError() after the launch, or
// an argument error without launching.
extern "C" int mt_resample_grad(const void* dy, void* dx, const void* lat_idx, const void* lat_w, const void* plan, int B, int Hin, int Win, int Hout,
                                int Wout, int C, int tile_width, int ring, int columns, int groups, int kt_max, int pieces_max, int slot_floats,
                                int record_ints, int n_records, int n_strips, int smem, void* stream) {
  if (B <= 0 || B > 65535 || Hin < 2 || Win <= 0 || Hout <= 0 || Wout <= 0 || C <= 0 || tile_width != WARPS * columns || ring < 2 ||
      ring > MAX_RING || kt_max < 1 || pieces_max < 1 || slot_floats < 4 || slot_floats % 4 != 0 || n_records <= 0 || n_strips <= 0 ||
      n_strips > 65535 || record_ints != HEADER + 3 * pieces_max + 3 * tile_width * kt_max || tile_width * kt_max > THREADS ||
      (long long)Wout * C >= (1LL << 31) || (long long)Win * C >= (1LL << 31) || reinterpret_cast<uintptr_t>(dy) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dx) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Params p{B, Hin, Win, Hout, Wout, C, tile_width, ring, kt_max, pieces_max, slot_floats, table_ints(tile_width, kt_max), record_ints, n_records};
  const float* y = static_cast<const float*>(dy);
  float* x = static_cast<float*>(dx);
  const int* li = static_cast<const int*>(lat_idx);
  const float* lw = static_cast<const float*>(lat_w);
  const int* pl = static_cast<const int*>(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (groups) {
    case 1: return launch_nc<1>(columns, y, x, li, lw, pl, p, n_strips, smem, s);
    case 2: return launch_nc<2>(columns, y, x, li, lw, pl, p, n_strips, smem, s);
    case 4: return launch_nc<4>(columns, y, x, li, lw, pl, p, n_strips, smem, s);
    case 8: return launch_nc<8>(columns, y, x, li, lw, pl, p, n_strips, smem, s);
    case 12: return launch_nc<12>(columns, y, x, li, lw, pl, p, n_strips, smem, s);
    case 16: return launch_nc<16>(columns, y, x, li, lw, pl, p, n_strips, smem, s);
    case 20: return launch_nc<20>(columns, y, x, li, lw, pl, p, n_strips, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
