// One Gaussian pyramid step (f32): the separable [1 4 6 4 1] / 16 blur,
// kept at the even rows and columns only. (H, W) -> (ceil(H/2), ceil(W/2)).
//
// Replaces opencv_contrib_tpu/ops/pallas/pipeline.py::grid_pyrdown (body
// `kernel` at :95), and serves core/pyramid.py::pyr_down, which every level of
// the dense-flow pyramids calls. One kernel, templated on the border:
//   REPLICATE    the Pallas kernel's border (which needs even H and W; this
//                one takes any size);
//   REFLECT_101  sep_filter2d's border (cv::BORDER_REFLECT_101,
//                jnp.pad(mode="reflect")), the one pyr_down launches. It
//                gives jnp.pad's fold at any size, so a side of 1 or 2 (a
//                pyramid's last levels) is taken too.
//
// Bound: bytes. Each output reads a 5x5 footprint of the input (60 flops),
// but neighbouring outputs share most of it, so the card need move only H*W*4
// bytes in and about H*W bytes out: 2.2 MB at 436x1024, 0.67 us at 3.35 TB/s.
//
// The Pallas body shifts whole rows with jnp.roll and iota masks and
// decimates with one-hot selection matmuls, because Pallas on the TPU has no
// strided slice. Here a block makes a tile of TY x TX = 4 x 32 outputs, one
// a thread (880 blocks at the 218x512 outputs of a Sintel level 0; the
// fastest of 4x32, 8x32, 8x64 and 16x64 at each Sintel level,
// scripts/scan_pyrdown_geometry.py, PERF.md):
//   1. it stages the tile's (2 TY + 3) x (2 TX + 3) input footprint in shared
//      memory, widened to whole float4s: 16-byte loads where the row and the
//      image allow, else element by element, with the border applied by
//      index while staging, without a branch; each thread has all of its
//      loads in flight before it writes any;
//   2. each thread blurs the five columns of its output's footprint
//      vertically, taps in order, then those five sums horizontally, and
//      stores, neighbouring threads on neighbouring columns.
// Up to three threads blur a column of the footprint (neighbouring outputs
// share columns): a vertical pass into shared memory instead costs a second
// barrier, and was slower at each Sintel level, as was the reflect fold as a
// loop that branches (scripts/scan_pyrdown_geometry.py, PERF.md).
// The sum runs as sep_filter2d's does: each column of the footprint is
// blurred vertically, then the five column sums horizontally. Every product
// and sum is rounded on its own (__fmul_rn, __fadd_rn), as PyTorch's separate
// mul and add kernels round them, so nvcc contracts nothing into an FMA and
// the kernel gives the plain version's bits.

#include <cuda_runtime.h>

namespace {

constexpr int REPLICATE = 0;
constexpr int REFLECT_101 = 1;
constexpr int TY = 4, TX = 32;  // a tile of outputs a block

// i mapped into 0 .. n - 1 by the border, without a branch. The outputs read
// the input at most 2 past an edge (row 2 Ho <= H + 1), where one reflection
// is exact for n >= 3 (-1 -> 1, n -> n - 2); n = 1 and 2 fold with period
// 2 (n - 1) at any distance. A staged position that no output reads (past
// the last output's reach) gets some index in range.
template <int BORDER>
__device__ __forceinline__ int border_index(int i, int n) {
  if (BORDER == REPLICATE) return min(max(i, 0), n - 1);
  const int m = 2 * (n - 1), a = abs(i);
  return n <= 2 ? i & (n - 1) : max(min(a, m - a), 0);
}

__device__ __forceinline__ float tap(float v, float k, float x) { return __fadd_rn(v, __fmul_rn(k, x)); }

// NT threads a block, an output each (a tile past 256 outputs, as a variant
// of scripts/scan_pyrdown_geometry.py builds, gives a thread several).
// Shared memory: the staged footprint, SR = 2 TY + 3 rows of SC = 2 TX + 8
// columns from column 2 ox0 - 4, a float4 boundary (the outputs read its
// columns 2 .. 2 TX + 4).
constexpr int NT = TY * TX < 256 ? TY * TX : 256;
constexpr int SR = 2 * TY + 3, SC = 2 * TX + 8, Q = SC / 4;

template <int BORDER>
__global__ void __launch_bounds__(NT) pyrdown_kernel(const float* __restrict__ x, float* __restrict__ out, int H,
                                                     int W, int Ho, int Wo, bool vec) {
  constexpr int NQ = SR * Q, LOADS = (NQ + NT - 1) / NT;
  __shared__ float4 smem4[NQ];
  const float* stage = reinterpret_cast<const float*>(smem4);
  const int oy0 = blockIdx.y * TY, ox0 = blockIdx.x * TX, y0 = 2 * oy0 - 2, c0 = 2 * ox0 - 4;
  const int tid = threadIdx.x;
  const float k[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};

  // 1. the footprint, a float4 at a time: every load of the thread in
  // flight, then into shared memory
  float4 v[LOADS];
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int e = tid + l * NT, r = e / Q, c = c0 + 4 * (e - r * Q);
    if (e >= NQ) break;
    const float* row = x + (size_t)border_index<BORDER>(y0 + r, H) * W;
    if (vec && c >= 0 && c + 4 <= W) {
      v[l] = __ldg(reinterpret_cast<const float4*>(row + c));
    } else {
      v[l].x = __ldg(row + border_index<BORDER>(c, W));
      v[l].y = __ldg(row + border_index<BORDER>(c + 1, W));
      v[l].z = __ldg(row + border_index<BORDER>(c + 2, W));
      v[l].w = __ldg(row + border_index<BORDER>(c + 3, W));
    }
  }
#pragma unroll
  for (int l = 0; l < LOADS; ++l)
    if (tid + l * NT < NQ) smem4[tid + l * NT] = v[l];  // SC % 4 == 0: element (r, 4 q) of the footprint
  __syncthreads();

  // 2. each output from the footprint: the vertical sums of its five
  // columns, then their horizontal sum
#pragma unroll
  for (int l = 0; l < (TY * TX + NT - 1) / NT; ++l) {
    const int e = tid + l * NT, r = e / TX, j = e - r * TX, oy = oy0 + r, ox = ox0 + j;
    if (oy >= Ho || ox >= Wo) continue;
    const float* s = stage + 2 * r * SC + 2 * j + 2;
    float h = 0.f;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      float a = __fmul_rn(k[0], s[c]);
#pragma unroll
      for (int t = 1; t < 5; ++t) a = tap(a, k[t], s[t * SC + c]);
      h = c == 0 ? __fmul_rn(k[0], a) : tap(h, k[c], a);
    }
    out[(size_t)oy * Wo + ox] = h;
  }
}

}  // namespace

// x: (H, W) contiguous, H, W >= 1; out: (ceil(H/2), ceil(W/2)); border: 0
// replicate, 1 reflect-101.
extern "C" int pyrdown_f32(const float* x, float* out, int H, int W, int border, cudaStream_t stream) {
  if (H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const dim3 grid((Wo + TX - 1) / TX, (Ho + TY - 1) / TY);
  if (border == REFLECT_101)
    pyrdown_kernel<REFLECT_101><<<grid, NT, 0, stream>>>(x, out, H, W, Ho, Wo, vec);
  else
    pyrdown_kernel<REPLICATE><<<grid, NT, 0, stream>>>(x, out, H, W, Ho, Wo, vec);
  return (int)cudaGetLastError();
}
