// Histograms (f32 values -> int32 counts) of a batch of equal rectangles of
// one 2D image: the whole frame, or CLAHE's grid of tiles in one launch.
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
// in the bin the plain version gives it.
//
// Bound: bytes. Each value is read once (4 bytes); the counts are a few KB.
//
// Design: the Pallas kernel walks bins one by one over each VMEM tile (Mosaic
// has no scatter). Here blockIdx.y picks a rectangle (origin, rows, cols and
// the image's pitch, so tiles are read in place, with no copy) and the
// blocks of blockIdx.x share its values. Each block counts into int32 bins
// in shared memory with shared atomics, then adds its nonzero bins into the
// global int32 counts with integer atomics. Integer sums do not depend on
// their order, so the counts are exact and the same from run to run; the
// wrapper returns them as float32, as both JAX functions do.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int DROP = 0, CLAMP = 1;
constexpr float BELOW_ONE = 0.99999988f;  // 1 - 1e-7 rounded to float32

template <int RULE>
__device__ __forceinline__ int bin_of(float v, int bins, float vmin, float vmax, float q) {
  if (RULE == DROP) {
    if (!(v >= vmin && v < vmax)) return -1;  // NaN fails both
    const float f = __fmul_rn(__fsub_rn(v, vmin), q);
    return (int)fminf(fmaxf(f, 0.f), (float)(bins - 1));
  }
  const float x = __fdiv_rn(__fsub_rn(v, vmin), q);
  if (x != x) return 0;
  return (int)__fmul_rn(fminf(fmaxf(x, 0.f), BELOW_ONE), (float)bins);
}

template <int RULE>
__global__ void __launch_bounds__(THREADS) grid_histogram_kernel(const float* __restrict__ x, int pitch, int rows,
                                                                 int cols, int tiles_x, int bins, float vmin,
                                                                 float vmax, float q, int* __restrict__ counts) {
  extern __shared__ int sh[];
  for (int b = threadIdx.x; b < bins; b += THREADS) sh[b] = 0;
  __syncthreads();
  const int t = blockIdx.y;
  const float* base = x + (size_t)(t / tiles_x) * rows * pitch + (size_t)(t % tiles_x) * cols;
  const long long n = (long long)rows * cols;
  for (long long k = (long long)blockIdx.x * THREADS + threadIdx.x; k < n; k += (long long)gridDim.x * THREADS) {
    const long long i = k / cols, j = k - i * cols;
    const int b = bin_of<RULE>(__ldg(base + i * pitch + j), bins, vmin, vmax, q);
    if (b >= 0) atomicAdd(sh + b, 1);
  }
  __syncthreads();
  int* out = counts + (size_t)t * bins;
  for (int b = threadIdx.x; b < bins; b += THREADS)
    if (sh[b]) atomicAdd(out + b, sh[b]);
}

}  // namespace

// x: the image, row pitch `pitch` floats; the rectangles are tiles_y x
// tiles_x tiles of rows x cols from its top-left corner; counts:
// (tiles_y * tiles_x, bins) int32, zeroed by the caller; rule: 0 drop, 1
// clamp; q: the rule's float32 scale (drop) or range (clamp).
extern "C" int grid_histogram_f32(const float* x, int rule, int pitch, int rows, int cols, int tiles_y, int tiles_x,
                                  int bins, float vmin, float vmax, float q, int blocks_per_tile, int* counts,
                                  cudaStream_t stream) {
  const dim3 grid(blocks_per_tile, tiles_y * tiles_x);
  const size_t smem = (size_t)bins * sizeof(int);
  if (rule == DROP)
    grid_histogram_kernel<DROP><<<grid, THREADS, smem, stream>>>(x, pitch, rows, cols, tiles_x, bins, vmin, vmax, q,
                                                                 counts);
  else if (rule == CLAMP)
    grid_histogram_kernel<CLAMP><<<grid, THREADS, smem, stream>>>(x, pitch, rows, cols, tiles_x, bins, vmin, vmax, q,
                                                                  counts);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
