// Fused map + scalar reduction (f32): sum, min or max of map(a0, a1, ...)
// over N strided 2D views, with the sum optionally divided by a count (a
// mean).
//
// Replaces opencv_contrib_tpu/ops/pallas/grid.py::grid_reduce (:91), in the
// role its docstring names (cudev's gridCalcSum / MinVal / MaxVal): on the
// photometric / quality path it takes grayworld's gated channel sums and
// count, the MSE, the SSIM and GMSD means and GMSD's squared deviation, and
// every moment of BRISQUE's GGD / AGGD fits; the intensity transforms take
// their min and max through it. The maps are the functors of maps.cuh.
//
// Bound: bytes. The map's N inputs are read once (4 N bytes an element);
// nothing of the mapped array is written, as in the Pallas kernel, whose map
// output never leaves VMEM.
//
// Design: the Pallas kernel folds each tile into one scratch accumulator on
// the sequential TPU grid, and masks the padded cells of the last tiles to
// the neutral element (grid.py:119-125). Blocks on Hopper run in no order, so
//   grid_reduce_kernel<Map, KIND>: a grid-stride loop folds one accumulator
//     per thread, starting from the neutral element (0, +inf, -inf), so a
//     thread past the extent contributes that element and no padding is
//     needed; a warp-shuffle tree, then warp 0 folds the warps' values in
//     order; each block writes one partial.
//   grid_reduce_finalize_kernel<KIND>: one block folds the partials, each
//     thread a fixed stride of them, then the same trees; the sum is divided
//     by `div`.
// No float atomics: the order is fixed, so a sum does not change from run to
// run. min and max propagate NaN, as torch.amin / jnp.min do.

#include <cuda_runtime.h>

#include "maps.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUM = 0, MIN = 1, MAX = 2;

template <int KIND>
__device__ __forceinline__ float neutral() {
  return KIND == SUM ? 0.f : (KIND == MIN ? __int_as_float(0x7f800000) : __int_as_float(0xff800000));
}

template <int KIND>
__device__ __forceinline__ float fold(float a, float b) {
  if (KIND == SUM) return __fadd_rn(a, b);
  return KIND == MIN ? maps::nan_min(a, b) : maps::nan_max(a, b);
}

// the block's fold of one value per thread, in a fixed order; valid in thread 0
template <int KIND>
__device__ __forceinline__ float block_fold(float acc) {
  __shared__ float warp_acc[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = fold<KIND>(acc, __shfl_down_sync(FULL, acc, o));
  if ((threadIdx.x & 31) == 0) warp_acc[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    acc = warp_acc[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) acc = fold<KIND>(acc, warp_acc[w]);
  }
  return acc;
}

template <class Map, int KIND>
__global__ void __launch_bounds__(THREADS) grid_reduce_kernel(Map map, maps::Views<Map::N> in, int H, int W,
                                                              float* __restrict__ partials) {
  const long long n = (long long)H * W;
  float acc = neutral<KIND>();
  for (long long k = (long long)blockIdx.x * THREADS + threadIdx.x; k < n; k += (long long)gridDim.x * THREADS) {
    const long long i = k / W, j = k - i * W;
    float v[Map::N];
    maps::load(in, i, j, v);
    acc = fold<KIND>(acc, map(v));
  }
  acc = block_fold<KIND>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <int KIND>
__global__ void __launch_bounds__(THREADS) grid_reduce_finalize_kernel(const float* __restrict__ partials, int blocks,
                                                                       float div, float* __restrict__ out) {
  float acc = neutral<KIND>();
  for (int b = threadIdx.x; b < blocks; b += THREADS) acc = fold<KIND>(acc, partials[b]);
  acc = block_fold<KIND>(acc);
  if (threadIdx.x == 0) out[0] = KIND == SUM ? __fdiv_rn(acc, div) : acc;
}

template <int KIND>
int launch(int map, int n_in, const long long* views, const float* hparams, const float* dparams, int H, int W,
           float div, int blocks, float* partials, float* out, cudaStream_t stream) {
  bool arity = true;
  const bool known = maps::dispatch_reduce(map, hparams, dparams, [&](auto m) {
    using Map = decltype(m);
    if (n_in != Map::N) {
      arity = false;
      return;
    }
    grid_reduce_kernel<Map, KIND><<<blocks, THREADS, 0, stream>>>(m, maps::unpack<Map::N>(views), H, W, partials);
  });
  if (!known || !arity) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grid_reduce_finalize_kernel<KIND><<<1, THREADS, 0, stream>>>(partials, blocks, div, out);
  return (int)cudaGetLastError();
}

}  // namespace

// map: a MAP_* reduce number of maps.cuh; kind: 0 sum, 1 min, 2 max; views:
// n_in host triples (pointer, pitch, stride); hparams: 4 host floats;
// dparams: the map's device parameters (or null); partials: (blocks,)
// scratch; out: 1 float, the sum / div (div is 1 for a plain sum), or the
// min or max.
extern "C" int grid_reduce_f32(int map, int kind, int n_in, const long long* views, const float* hparams,
                               const float* dparams, int H, int W, float div, int blocks, float* partials,
                               float* out, cudaStream_t stream) {
  if (kind == SUM) return launch<SUM>(map, n_in, views, hparams, dparams, H, W, div, blocks, partials, out, stream);
  if (kind == MIN) return launch<MIN>(map, n_in, views, hparams, dparams, H, W, 1.f, blocks, partials, out, stream);
  if (kind == MAX) return launch<MAX>(map, n_in, views, hparams, dparams, H, W, 1.f, blocks, partials, out, stream);
  return (int)cudaErrorInvalidValue;
}
