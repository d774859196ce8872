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
// card's 20 flops a byte. The bytes come from DRAM when the inputs are cold
// and from the 50 MB L2 when they are warm, as they usually are on the path
// (BRISQUE's product is made and then read 6 times): warm, the L2 delivers
// about three times the DRAM rate, so the instructions a byte costs decide.
//
// grid_transform: the first design (a grid-stride loop, one element per
// thread and step) paid a 64-bit division k / W and a 64-bit
// i * pitch + j * stride per element and view, and moved 4 bytes per load:
// it issued instructions, not bytes, and took about twice as long as the
// eager `a * b` on L2-warm inputs. Now blocks take bands of rows and
// threads take columns (the row walk of maps.cuh): the row offset is
// computed once per row, the column offset in 32 bits, no division.
// Contiguous rows (the wrapper checks stride 1, a pitch that is a multiple
// of 4 and 16-byte aligned pointers) take grid_transform_vec4_kernel:
// 16-byte float4 loads and stores, one per input and thread and step (on
// the card that beat two and four per thread: more threads in flight). Any
// other views take grid_transform_strided_kernel, 4 scalar elements per
// thread and step,
// consecutive threads on consecutive columns: a channel of an interleaved
// (H, W, 3) frame is read or written in place, with no copy (gray and the
// grayworld gains). The maps are elementwise, so the path changes no bit.
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

template <class Map, int U>
__global__ void __launch_bounds__(maps::TX) grid_transform_vec4_kernel(Map map, maps::Views<Map::N> in, maps::View out,
                                                                       int H, int W) {
  constexpr int N = Map::N, TX = maps::TX;
  const int W4 = W >> 2, step = gridDim.x * (TX * U);
  for (int i = blockIdx.y; i < H; i += gridDim.y) {
    const float* row[N];
    maps::row_ptrs(in, i, row);
    float* orow = out.p + (long long)i * out.pitch;
    for (int c = blockIdx.x * (TX * U) + threadIdx.x; c < W4; c += step) {
      float4 x[U][N];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (c + u * TX < W4) maps::load4<N>(row, c + u * TX, x[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (c + u * TX >= W4) continue;
        float v[N], r[4];
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          maps::lane<N>(x[u], l, v);
          r[l] = map(v);
        }
        reinterpret_cast<float4*>(orow)[c + u * TX] = make_float4(r[0], r[1], r[2], r[3]);
      }
    }
    const int j = 4 * W4 + threadIdx.x;  // the row's last W % 4 elements
    if (blockIdx.x == 0 && j < W) {
      float v[N];
#pragma unroll
      for (int a = 0; a < N; ++a) v[a] = __ldg(row[a] + j);
      orow[j] = map(v);
    }
  }
}

template <class Map, int U>
__global__ void __launch_bounds__(maps::TX) grid_transform_strided_kernel(Map map, maps::Views<Map::N> in,
                                                                          maps::View out, int H, int W) {
  constexpr int N = Map::N, TX = maps::TX;
  int s[N];
#pragma unroll
  for (int a = 0; a < N; ++a) s[a] = (int)in.v[a].stride;
  const int so = (int)out.stride, step = gridDim.x * (TX * U);
  for (int i = blockIdx.y; i < H; i += gridDim.y) {
    const float* row[N];
    maps::row_ptrs(in, i, row);
    float* orow = out.p + (long long)i * out.pitch;
    for (int j = blockIdx.x * (TX * U) + threadIdx.x; j < W; j += step) {
      float x[U][N];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (j + u * TX < W)
#pragma unroll
          for (int a = 0; a < N; ++a) x[u][a] = __ldg(row[a] + (j + u * TX) * s[a]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (j + u * TX < W) orow[(j + u * TX) * so] = map(x[u]);
    }
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
// floats; dparams: the map's device parameters (or null); vec4: 1 for the
// vec4 path (the wrapper has checked its conditions), 0 for the strided one.
// The output is (H, W).
extern "C" int grid_transform_f32(int map, int n_in, const long long* views, const float* hparams,
                                  const float* dparams, int H, int W, int vec4, cudaStream_t stream) {
  bool arity = true;
  const bool known = maps::dispatch_transform(map, hparams, dparams, [&](auto m) {
    using Map = decltype(m);
    if (n_in != Map::N) {
      arity = false;
      return;
    }
    const maps::Views<Map::N> in = maps::unpack<Map::N>(views);
    const maps::View out = maps::unpack<1>(views + 3 * n_in).v[0];
    constexpr int UV = maps::unroll(true, false), US = maps::unroll(false, false);
    const dim3 grid(maps::row_blocks(W, vec4, vec4 ? UV : US), H < 65535 ? H : 65535);
    if (vec4)
      grid_transform_vec4_kernel<Map, UV><<<grid, maps::TX, 0, stream>>>(m, in, out, H, W);
    else
      grid_transform_strided_kernel<Map, US><<<grid, maps::TX, 0, stream>>>(m, in, out, H, W);
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
