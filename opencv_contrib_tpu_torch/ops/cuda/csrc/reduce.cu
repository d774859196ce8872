// Fused map + scalar reduction (f32): sum, min or max of map(a0, a1, ...)
// over N strided 2D views, with the sum optionally divided by a count (a
// mean); and K <= 8 sums of the maps of one group over the same views in
// one pass (grid_reduce_sums).
//
// Replaces opencv_contrib_tpu/ops/pallas/grid.py::grid_reduce (:91), in the
// role its docstring names (cudev's gridCalcSum / MinVal / MaxVal): on the
// photometric / quality path it takes grayworld's gated channel sums and
// count (one group), the MSE, the SSIM and GMSD means and GMSD's squared
// deviation, and BRISQUE's GGD and AGGD moments (one group per fit); the
// intensity transforms take their min and max through it. The maps are the
// functors of maps.cuh.
//
// Bound: bytes. The map's N inputs are read once (4 N bytes an element);
// nothing of the mapped array is written, as in the Pallas kernel, whose map
// output never leaves VMEM. Cold, the bytes come from DRAM; warm (the path
// reduces maps it has just made), from the L2.
//
// What held the first design back: the same per-element 64-bit division and
// scalar 4-byte loads as grid_transform's, and a second launch
// (grid_reduce_finalize_kernel) to fold the block partials, so each
// reduction cost two device launches, and the path issued 62 of them a
// frame, 52 of them BRISQUE's moments, which read the same array 2 or 6
// times. Now:
//   - the main loop is the row walk of maps.cuh (bands of rows per block,
//     32-bit column offsets, float4 loads on contiguous rows, a strided path
//     for channel views), folding one accumulator per output and thread from
//     the neutral element (0, +inf, -inf), so threads past the extent add
//     nothing and no padding is needed;
//   - each block folds its accumulators (a warp-shuffle tree, then warp 0's
//     lane 0 folds the warps in order) and writes one partial per output;
//   - one launch: after its partials, a block makes them visible
//     (__threadfence) and draws an integer ticket (atomicAdd on an unsigned
//     int); the block that draws the last ticket folds every partial in
//     block order, divides the sums, writes the results and sets the ticket
//     back to 0 for the next launch;
//   - a group of K maps over the same inputs (the GROUP_* functors) folds K
//     accumulators in one pass: BRISQUE's six AGGD moments read the product
//     once, not six times.
// Deterministic: no float atomics. Each thread's elements, the block tree
// and the final fold follow an order fixed by (H, W), the path and the block
// count, which the wrapper derives from (H, W) and the views alone, so a
// rerun gives the same bits, and each output of a group has the bits of the
// single-map call (same functor, same geometry, same order). The ticket and
// the partials live in a scratch buffer that the wrapper allocates once per
// device and stream: launches on one stream run one after another, so two
// reductions never hold the same ticket at once. min and max propagate NaN,
// as torch.amin / jnp.min do.

#include <cuda_runtime.h>

#include <algorithm>

#include "maps.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TX = maps::TX;
constexpr int WARPS = TX / 32;
constexpr int MAX_BLOCKS = 1024;  // ops/cuda/reduce.py _MAX_BLOCKS: the scratch holds 8 partials per block
constexpr int SUM = 0, MIN = 1, MAX = 2;

template <int K>
struct Divs {
  float v[K];
};

template <int KIND>
__device__ __forceinline__ float neutral() {
  return KIND == SUM ? 0.f : (KIND == MIN ? __int_as_float(0x7f800000) : __int_as_float(0xff800000));
}

template <int KIND>
__device__ __forceinline__ float fold(float a, float b) {
  if (KIND == SUM) return __fadd_rn(a, b);
  return KIND == MIN ? maps::nan_min(a, b) : maps::nan_max(a, b);
}

template <int KIND, class G>
__device__ __forceinline__ void add(const G& g, const float* v, float* acc) {
  float o[G::K];
  g(v, o);
#pragma unroll
  for (int k = 0; k < G::K; ++k) acc[k] = fold<KIND>(acc[k], o[k]);
}

// the block's fold of K values per thread, each in a fixed order; valid in
// thread 0
template <int KIND, int K>
__device__ __forceinline__ void block_fold(float* acc) {
  __shared__ float warp_acc[K][WARPS];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[k] = fold<KIND>(acc[k], __shfl_down_sync(FULL, acc[k], o));
    if ((threadIdx.x & 31) == 0) warp_acc[k][threadIdx.x >> 5] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k] = warp_acc[k][0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) acc[k] = fold<KIND>(acc[k], warp_acc[k][w]);
    }
  }
}

// block partials, the ticket, and the last block's fold of the partials
template <int KIND, int K>
__device__ __forceinline__ void finish(float* acc, const Divs<K>& div, float* partials, unsigned* ticket,
                                       float* out) {
  const int blocks = gridDim.x * gridDim.y, b = blockIdx.y * gridDim.x + blockIdx.x;
  __shared__ bool last;
  block_fold<KIND, K>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) partials[k * blocks + b] = acc[k];
    __threadfence();  // this block's partials reach every block before its ticket does
    last = atomicAdd(ticket, 1u) == (unsigned)blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  // every other block has fenced its partials before drawing its ticket; read
  // them from the L2 (__ldcg: past this SM's L1), in block order
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = neutral<KIND>();
  for (int p = threadIdx.x; p < blocks; p += TX)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = fold<KIND>(acc[k], __ldcg(partials + k * blocks + p));
  block_fold<KIND, K>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = KIND == SUM ? __fdiv_rn(acc[k], div.v[k]) : acc[k];
    *ticket = 0u;  // the next launch on this stream starts from 0
  }
}

template <class G, int KIND, int U>
__global__ void __launch_bounds__(TX) grid_reduce_vec4_kernel(G g, maps::Views<G::N> in, int H, int W, int rows_per,
                                                              Divs<G::K> div, float* partials, unsigned* ticket,
                                                              float* __restrict__ out) {
  constexpr int N = G::N, K = G::K;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = neutral<KIND>();
  const int W4 = W >> 2, step = gridDim.x * (TX * U);
  const int i1 = min(H, (int)(blockIdx.y + 1) * rows_per);
  for (int i = blockIdx.y * rows_per; i < i1; ++i) {
    const float* row[N];
    maps::row_ptrs(in, i, row);
    for (int c = blockIdx.x * (TX * U) + threadIdx.x; c < W4; c += step) {
      float4 x[U][N];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (c + u * TX < W4) maps::load4<N>(row, c + u * TX, x[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (c + u * TX >= W4) continue;
        float v[N];
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          maps::lane<N>(x[u], l, v);
          add<KIND>(g, v, acc);
        }
      }
    }
    const int j = 4 * W4 + threadIdx.x;  // the row's last W % 4 elements
    if (blockIdx.x == 0 && j < W) {
      float v[N];
#pragma unroll
      for (int a = 0; a < N; ++a) v[a] = __ldg(row[a] + j);
      add<KIND>(g, v, acc);
    }
  }
  finish<KIND, K>(acc, div, partials, ticket, out);
}

template <class G, int KIND, int U>
__global__ void __launch_bounds__(TX) grid_reduce_strided_kernel(G g, maps::Views<G::N> in, int H, int W,
                                                                 int rows_per, Divs<G::K> div, float* partials,
                                                                 unsigned* ticket, float* __restrict__ out) {
  constexpr int N = G::N, K = G::K;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = neutral<KIND>();
  int s[N];
#pragma unroll
  for (int a = 0; a < N; ++a) s[a] = (int)in.v[a].stride;
  const int step = gridDim.x * (TX * U);
  const int i1 = min(H, (int)(blockIdx.y + 1) * rows_per);
  for (int i = blockIdx.y * rows_per; i < i1; ++i) {
    const float* row[N];
    maps::row_ptrs(in, i, row);
    for (int j = blockIdx.x * (TX * U) + threadIdx.x; j < W; j += step) {
      float x[U][N];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (j + u * TX < W)
#pragma unroll
          for (int a = 0; a < N; ++a) x[u][a] = __ldg(row[a] + (j + u * TX) * s[a]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (j + u * TX < W) add<KIND>(g, x[u], acc);
    }
  }
  finish<KIND, K>(acc, div, partials, ticket, out);
}

// one launch of group g (K outputs) over the views; scratch: the ticket (one
// unsigned, 0 between launches) then MAX_BLOCKS * 8 partials from float 4 on
template <int KIND, class G>
int launch(const G& g, int n_in, const long long* views, int H, int W, const float* div, int vec4, float* scratch,
           float* out, cudaStream_t stream) {
  constexpr int N = G::N;
  if (n_in != N) return (int)cudaErrorInvalidValue;
  // the geometry depends on (H, W) and the path alone: columns first, then
  // bands of rows_per rows, at most MAX_BLOCKS blocks
  constexpr int UV = maps::unroll(true, true), US = maps::unroll(false, true);
  const int gx = std::min(maps::row_blocks(W, vec4, vec4 ? UV : US), MAX_BLOCKS);
  const int bands = std::max(1, MAX_BLOCKS / gx);
  const int rows_per = (H + bands - 1) / bands;
  const dim3 grid(gx, (H + rows_per - 1) / rows_per);
  Divs<G::K> d;
  for (int k = 0; k < G::K; ++k) d.v[k] = KIND == SUM ? div[k] : 1.f;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  const maps::Views<N> in = maps::unpack<N>(views);
  if (vec4)
    grid_reduce_vec4_kernel<G, KIND, UV><<<grid, TX, 0, stream>>>(g, in, H, W, rows_per, d, scratch + 4, ticket, out);
  else
    grid_reduce_strided_kernel<G, KIND, US><<<grid, TX, 0, stream>>>(g, in, H, W, rows_per, d, scratch + 4, ticket,
                                                                     out);
  return (int)cudaGetLastError();
}

template <int KIND>
int reduce_one(int map, int n_in, const long long* views, const float* hparams, const float* dparams, int H, int W,
               float div, int vec4, float* scratch, float* out, cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  maps::dispatch_reduce(map, hparams, dparams, [&](auto m) {
    err = launch<KIND>(maps::Single<decltype(m)>{m}, n_in, views, H, W, &div, vec4, scratch, out, stream);
  });
  return err;
}

}  // namespace

// map: a MAP_* reduce number of maps.cuh; kind: 0 sum, 1 min, 2 max; views:
// n_in host triples (pointer, pitch, stride); hparams: 4 host floats;
// dparams: the map's device parameters (or null); div: the sum's divisor (1
// for a plain sum); vec4: 1 for the vec4 path, 0 for the strided one;
// scratch: the ticket and partials (ops/cuda/reduce.py _scratch); out: 1
// float, the sum / div, or the min or max.
extern "C" int grid_reduce_f32(int map, int kind, int n_in, const long long* views, const float* hparams,
                               const float* dparams, int H, int W, float div, int vec4, float* scratch, float* out,
                               cudaStream_t stream) {
  if (kind == SUM) return reduce_one<SUM>(map, n_in, views, hparams, dparams, H, W, div, vec4, scratch, out, stream);
  if (kind == MIN) return reduce_one<MIN>(map, n_in, views, hparams, dparams, H, W, 1.f, vec4, scratch, out, stream);
  if (kind == MAX) return reduce_one<MAX>(map, n_in, views, hparams, dparams, H, W, 1.f, vec4, scratch, out, stream);
  return (int)cudaErrorInvalidValue;
}

// group: a GROUP_* number of maps.cuh; views as above; hparams: 4 host
// floats; div: one host float per output; out: K floats, each sum / div.
extern "C" int grid_reduce_sums_f32(int group, int n_in, const long long* views, const float* hparams, int H, int W,
                                    const float* div, int vec4, float* scratch, float* out, cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  maps::dispatch_group(group, hparams, [&](auto g) {
    err = launch<SUM>(g, n_in, views, H, W, div, vec4, scratch, out, stream);
  });
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
