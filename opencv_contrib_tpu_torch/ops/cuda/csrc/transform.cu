// Elementwise maps (f32): grid_transform over N strided 2D views, and
// streamed_transform over one contiguous array.
//
// Replaces opencv_contrib_tpu/ops/pallas/grid.py::grid_transform (:54) and
// opencv_contrib_tpu/ops/pallas/pipeline.py::streamed_transform (:143), in the
// role their docstrings name (cudev's gridTransform; the Stream/Async
// overlap pattern): on the photometric / quality path they apply the
// grayworld gains, convert RGB to gray, and compute the SSIM, GMS and MSCN
// maps and BRISQUE's pairwise products (grid_transform), and the clip-wide
// gamma (streamed_transform). The maps are the functors of maps.cuh.
//
// Bound: bytes. Each map reads its N inputs once and writes one output, at
// most 30 flops an element (SSIM) against 4 (N + 1) bytes: far below the
// card's 20 flops a byte.
//
// grid_transform_kernel<Map>: a grid-stride loop, one element per thread and
// step. Every input and the output is a strided view (pointer, row pitch,
// element stride), so a channel of an interleaved (H, W, 3) frame is read or
// written in place, with no copy. The Pallas kernel's tiles and padding
// exist for VMEM blocks; here the loop covers the (H, W) extent exactly.
//
// streamed_transform_kernel<Map>: the double buffering of emit_pipeline
// (pipeline.py:175-182). Persistent blocks walk the array in 8 KB chunks;
// each block stages its next chunk into shared memory with cp.async while it
// maps the current one, then stores the results with 16-byte writes. The
// map is elementwise, so the (H, W) row blocks of the Pallas function become
// chunks of the flat row-major array; the ragged tail past the last whole
// chunk is mapped directly. The input must be 16-byte aligned (the wrapper
// checks). TMA is for a later kernel.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "maps.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK4 = 2 * THREADS;  // float4s in a chunk: 2048 floats, 8 KB
constexpr int CHUNK = 4 * CHUNK4;

template <class Map>
__global__ void __launch_bounds__(THREADS) grid_transform_kernel(Map map, maps::Views<Map::N> in, maps::View out,
                                                                 int H, int W) {
  const long long n = (long long)H * W;
  for (long long k = (long long)blockIdx.x * THREADS + threadIdx.x; k < n; k += (long long)gridDim.x * THREADS) {
    const long long i = k / W, j = k - i * W;
    float v[Map::N];
    maps::load(in, i, j, v);
    out.p[i * out.pitch + j * out.stride] = map(v);
  }
}

template <class Map>
__global__ void __launch_bounds__(THREADS) streamed_transform_kernel(Map map, const float* __restrict__ x,
                                                                     float* __restrict__ y, int n) {
  __shared__ float4 buf[2][CHUNK4];
  const int chunks = n / CHUNK;
  auto stage = [&](int c, int s) {
    const float4* src = reinterpret_cast<const float4*>(x + (size_t)c * CHUNK);
    for (int k = threadIdx.x; k < CHUNK4; k += THREADS) __pipeline_memcpy_async(&buf[s][k], src + k, 16);
  };
  int s = 0;
  if ((int)blockIdx.x < chunks) stage(blockIdx.x, 0);
  __pipeline_commit();
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int next = c + gridDim.x;
    if (next < chunks) stage(next, s ^ 1);
    __pipeline_commit();  // an empty group past the last chunk keeps the count
    __pipeline_wait_prior(1);  // this thread's copies of chunk c have landed
    __syncthreads();  // and every other thread's
    float4* dst = reinterpret_cast<float4*>(y + (size_t)c * CHUNK);
    for (int k = threadIdx.x; k < CHUNK4; k += THREADS) {
      const float4 a = buf[s][k];
      float4 b;
      b.x = map(&a.x);
      b.y = map(&a.y);
      b.z = map(&a.z);
      b.w = map(&a.w);
      dst[k] = b;
    }
    __syncthreads();  // buffer s is staged into again two chunks on
    s ^= 1;
  }
  for (int i = chunks * CHUNK + blockIdx.x * THREADS + threadIdx.x; i < n; i += gridDim.x * THREADS) y[i] = map(x + i);
}

}  // namespace

// map: a MAP_* transform number of maps.cuh; views: n_in + 1 host triples
// (pointer, pitch, stride), the inputs then the output; hparams: 4 host
// floats; dparams: the map's device parameters (or null). The output is
// (H, W).
extern "C" int grid_transform_f32(int map, int n_in, const long long* views, const float* hparams,
                                  const float* dparams, int H, int W, int blocks, cudaStream_t stream) {
  bool arity = true;
  const bool known = maps::dispatch_transform(map, hparams, dparams, [&](auto m) {
    using Map = decltype(m);
    if (n_in != Map::N) {
      arity = false;
      return;
    }
    const maps::View out = maps::unpack<1>(views + 3 * n_in).v[0];
    grid_transform_kernel<Map><<<blocks, THREADS, 0, stream>>>(m, maps::unpack<Map::N>(views), out, H, W);
  });
  if (!known || !arity) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x, y: n contiguous floats, x 16-byte aligned; map: a one-input transform
// map; blocks: the persistent blocks.
extern "C" int streamed_transform_f32(int map, const float* hparams, const float* dparams, const float* x, float* y,
                                      int n, int blocks, cudaStream_t stream) {
  bool arity = true;
  const bool known = maps::dispatch_transform(map, hparams, dparams, [&](auto m) {
    using Map = decltype(m);
    if constexpr (Map::N == 1)
      streamed_transform_kernel<Map><<<blocks, THREADS, 0, stream>>>(m, x, y, n);
    else
      arity = false;
  });
  if (!known || !arity) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
