// Histograms (f32 values -> counts, written as f32) of a batch of equal
// rectangles of one 2D image: the whole frame, or CLAHE's grid of tiles in
// one launch.
//
// Replaces opencv_contrib_tpu/ops/pallas/grid.py::grid_histogram (:205), in
// the role its docstring names (cudev's gridHistogram, the shared-memory
// histogram pattern): on the photometric path it counts CLAHE's 64 tile
// histograms (ops/histogram.py::clahe) and the frame histogram of
// `histogram` / `equalize_hist`.
//
// Two bin rules, a template parameter:
//   DROP   grid_histogram's: NaN, v < vmin and v >= vmax are dropped;
//          bin = clip((v - vmin) * q, 0, bins - 1) with q = bins / (vmax -
//          vmin) rounded to float32 (grid.py:223-225).
//   CLAMP  ops/histogram.py's (:36-37, and CLAHE's :79): x = clip((v - vmin)
//          / q, 0, 1 - 1e-7) with q = vmax - vmin, bin = x * bins; values
//          out of range go to the end bins, and NaN to bin 0 (XLA converts
//          NaN to int32 as 0).
// Each quotient and product is rounded on its own (__fsub_rn, __fmul_rn,
// __fdiv_rn) in the order its JAX function computes it, so every value lands
// in the bin the plain version gives it. Where q is a power of two the
// wrapper passes inv_q = 1 / q, which is exact, and the quotient is the
// product by it: both round the same real number, so the bits are the same.
// CLAHE's q is 1: its tiles take 5.38-5.43 us with the product, 6.34-6.40
// with the quotient (H100 80GB HBM3 at 700 W,
// scripts/getab_histogram_geometry.py).
//
// Bound: bytes. Each value is read once (4 bytes); the counts are a few KB.
//
// Design: the Pallas kernel walks bins one by one over each VMEM tile (Mosaic
// has no scatter). Here blockIdx.y picks a rectangle (origin, rows, cols and
// the image's pitch, so tiles are read in place, with no copy) and the
// blocks of blockIdx.x take equal runs of its units (float4s on the vec4
// path, floats on the scalar one), in one launch:
//   - a walk over rows: a thread finds its (row, column) once by one 32-bit
//     division and then steps THREADS units on by adding, with 32-bit
//     offsets from the tile's origin and U loads in flight; float4 loads
//     where the image, the pitch and the tile's width are 16-byte aligned
//     (CLAHE's tiles of 240 columns in a 1920 pitch are), scalar loads
//     otherwise. No per-value 64-bit division;
//   - the bin rule is a template parameter, and the clamp rule's quotient a
//     product where that is exact, so a value costs a few instructions and
//     one shared atomic;
//   - contention: on the H100 a warp's 32 atomics on one shared counter
//     (a flat frame) cost no more than on 32 counters, and copies of the
//     bins only add their zeroing and fold (H100 80GB HBM3 at 700 W,
//     scripts/getab_histogram_geometry.py), so the bins have one copy;
//   - one launch, no memset and no cast: each block adds its nonzero bins
//     into the tile's int32 counts in a scratch buffer with integer atomics
//     and thread 0 draws the tile's ticket; the tile's last block takes
//     every count with atomicExch(count, 0), writes it as float and sets
//     the ticket back to 0, so the scratch is zero again for the next
//     launch. The L2 applies atomics on one counter one after another,
//     and the ticket's release waits for them: the 1080p frame's 507 blocks
//     on one set of 256 counters took about 3 us more than on 16 copies of
//     it (H100 80GB HBM3 at 700 W, scripts/getab_histogram_geometry.py).
//     So block b adds into copy b % spread of its tile's counts (the wrapper
//     gives about 32 blocks a copy, at most 16 copies), and the last block
//     adds the copies; CLAHE's tiles of 8 blocks keep one copy, which is
//     faster there. The wrapper caches it per device and stream (launches on
//     one stream run one after another). A thread block cluster per tile
//     (the blocks adding into the leader's bins through distributed shared
//     memory) was not taken: a cluster has at most 8 (16 non-portable)
//     blocks, so the one-tile frame histogram could not fill the card with
//     it, and the ticket serves both.
// Integer sums do not depend on their order, so the counts are exact and the
// same from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 4;  // units a thread has in flight
constexpr int SMEM = 48 * 1024;  // ops/cuda/histogram.py _SMEM: the shared bins
constexpr int DROP = 0, CLAMP = 1;  // the rules of the C entry point
constexpr int CLAMP_MUL = 2;  // the clamp rule where the quotient by q is the product by inv_q
constexpr int MAX_SPREAD = 16;  // ops/cuda/histogram.py _MAX_SPREAD: copies of a tile's counts in the scratch
constexpr float BELOW_ONE = 0.99999988f;  // 1 - 1e-7 rounded to float32

struct Rule {
  int bins;
  float vmin, vmax, q, inv_q;
};

template <int RULE>
__device__ __forceinline__ int bin_of(float v, const Rule& r) {
  if (RULE == DROP) {
    if (!(v >= r.vmin && v < r.vmax)) return -1;  // NaN fails both
    const float f = __fmul_rn(__fsub_rn(v, r.vmin), r.q);
    return (int)fminf(fmaxf(f, 0.f), (float)(r.bins - 1));
  }
  const float d = __fsub_rn(v, r.vmin);
  const float x = RULE == CLAMP_MUL ? __fmul_rn(d, r.inv_q) : __fdiv_rn(d, r.q);
  if (x != x) return 0;
  return (int)__fmul_rn(fminf(fmaxf(x, 0.f), BELOW_ONE), (float)r.bins);
}

template <int RULE>
__device__ __forceinline__ void count(float v, const Rule& r, int* sh) {
  const int b = bin_of<RULE>(v, r);
  if (b >= 0) atomicAdd(sh + b, 1);
}

template <bool VEC>
struct Unit;
template <>
struct Unit<true> {
  using T = float4;
  static constexpr int WIDTH = 4;
};
template <>
struct Unit<false> {
  using T = float;
  static constexpr int WIDTH = 1;
};

template <int RULE>
__device__ __forceinline__ void count_unit(float4 x, const Rule& r, int* sh) {
  count<RULE>(x.x, r, sh);
  count<RULE>(x.y, r, sh);
  count<RULE>(x.z, r, sh);
  count<RULE>(x.w, r, sh);
}
template <int RULE>
__device__ __forceinline__ void count_unit(float x, const Rule& r, int* sh) {
  count<RULE>(x, r, sh);
}

// rows x cols rectangles of x (pitch floats a row), tiles_x across; block
// (b, t) counts units [b chunk, (b + 1) chunk) of tile t
template <int RULE, bool VEC>
__global__ void __launch_bounds__(THREADS) grid_histogram_kernel(const float* __restrict__ x, int pitch, int rows,
                                                                 int cols, int tiles_x, Rule r, int chunk,
                                                                 int spread, unsigned* tickets, int* counts,
                                                                 float* __restrict__ out) {
  using T = typename Unit<VEC>::T;
  extern __shared__ int sh[];  // the block's bins
  const int bins = r.bins;
  for (int k = threadIdx.x; k < bins; k += THREADS) sh[k] = 0;
  __syncthreads();
  const int t = blockIdx.y;
  const float* base = x + (size_t)(t / tiles_x) * rows * pitch + (size_t)(t % tiles_x) * cols;
  const int C = cols / Unit<VEC>::WIDTH;  // units a row
  const int k1 = (int)min((long long)rows * C, (long long)(blockIdx.x + 1) * chunk);
  const int di = THREADS / C, dc = THREADS - di * C;  // one step of THREADS units: di rows and dc columns on
  int k = blockIdx.x * chunk + threadIdx.x;
  int i = k / C, c = k - i * C;
  for (; k < k1; k += U * THREADS) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k + u * THREADS < k1) v[u] = __ldg(reinterpret_cast<const T*>(base + i * pitch) + c);
      i += di;
      c += dc;
      if (c >= C) {
        c -= C;
        ++i;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k + u * THREADS < k1) count_unit<RULE>(v[u], r, sh);
  }
  __syncthreads();
  int* cnt = counts + (size_t)t * spread * bins;  // the tile's `spread` copies of its counts
  int* mine = cnt + (blockIdx.x % spread) * bins;  // the copy this block adds into
  for (int b = threadIdx.x; b < bins; b += THREADS) {
    const int s = sh[b];
    if (s) atomicAdd(mine + b, s);
  }
  // thread 0 draws the tile's ticket after the block's barrier with one
  // acquire-release atomic at device scope: its release publishes the
  // block's counts (ordered before it by the barrier), and the last block's
  // acquire orders its reads after every other block's counts
  __syncthreads();
  bool last = false;
  if (threadIdx.x == 0) {
    unsigned drawn;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;" : "=r"(drawn) : "l"(tickets + t) : "memory");
    last = drawn == gridDim.x - 1;
  }
  if (!__syncthreads_or(last)) return;
  float* o = out + (size_t)t * bins;
  if (spread == 1) {
    for (int b = threadIdx.x; b < bins; b += THREADS) o[b] = (float)atomicExch(cnt + b, 0);
  } else {
    for (int b = threadIdx.x; b < bins; b += THREADS) {
      int v[MAX_SPREAD];  // every copy's exchange issued before the first add
#pragma unroll
      for (int g = 0; g < MAX_SPREAD; ++g) v[g] = g < spread ? atomicExch(cnt + g * bins + b, 0) : 0;
      int s = 0;
#pragma unroll
      for (int g = 0; g < MAX_SPREAD; ++g) s += v[g];
      o[b] = (float)s;
    }
  }
  if (threadIdx.x == 0) tickets[t] = 0u;  // the next launch on this stream starts from 0
}

template <int RULE>
int launch(const float* x, int vec4, int pitch, int rows, int cols, int tiles_y, int tiles_x, const Rule& r,
           int blocks_per_tile, int chunk, int spread, unsigned* tickets, int* counts, float* out,
           cudaStream_t stream) {
  const dim3 grid(blocks_per_tile, tiles_y * tiles_x);
  const size_t smem = (size_t)r.bins * sizeof(int);
  if (vec4)
    grid_histogram_kernel<RULE, true><<<grid, THREADS, smem, stream>>>(x, pitch, rows, cols, tiles_x, r, chunk, spread,
                                                                       tickets, counts, out);
  else
    grid_histogram_kernel<RULE, false><<<grid, THREADS, smem, stream>>>(x, pitch, rows, cols, tiles_x, r, chunk, spread,
                                                                        tickets, counts, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x: the image, row pitch `pitch` floats; the rectangles are tiles_y x
// tiles_x tiles of rows x cols from its top-left corner; rule: 0 drop, 1
// clamp; vec4: 1 for float4 loads (x, pitch and cols 16-byte aligned, or one
// row); bins: int32 bins within SMEM; q: the rule's float32 scale (drop) or
// range (clamp), inv_q: 1 / q where that is exact, else 0;
// blocks_per_tile blocks take `chunk` units of a tile each, and block b adds
// its counts into copy b % spread (1 to MAX_SPREAD) of the tile's counts;
// tickets (tiles_y * tiles_x) and counts (tiles_y * tiles_x * spread, bins):
// zero between launches; out: (tiles_y *
// tiles_x, bins) float32.
extern "C" int grid_histogram_f32(const float* x, int rule, int vec4, int pitch, int rows, int cols, int tiles_y,
                                  int tiles_x, int bins, float vmin, float vmax, float q, float inv_q,
                                  int blocks_per_tile, int chunk, int spread, unsigned* tickets, int* counts,
                                  float* out, cudaStream_t stream) {
  if (bins < 1 || (size_t)bins * sizeof(int) > SMEM || blocks_per_tile < 1 || chunk < 1 || spread < 1 ||
      spread > MAX_SPREAD)
    return (int)cudaErrorInvalidValue;
  const Rule r{bins, vmin, vmax, q, inv_q};
  if (rule == DROP)
    return launch<DROP>(x, vec4, pitch, rows, cols, tiles_y, tiles_x, r, blocks_per_tile, chunk, spread, tickets,
                        counts, out, stream);
  if (rule == CLAMP && inv_q != 0.f)
    return launch<CLAMP_MUL>(x, vec4, pitch, rows, cols, tiles_y, tiles_x, r, blocks_per_tile, chunk, spread,
                             tickets, counts, out, stream);
  if (rule == CLAMP)
    return launch<CLAMP>(x, vec4, pitch, rows, cols, tiles_y, tiles_x, r, blocks_per_tile, chunk, spread, tickets,
                         counts, out, stream);
  return (int)cudaErrorInvalidValue;
}
