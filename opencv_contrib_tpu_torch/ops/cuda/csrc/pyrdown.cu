// One Gaussian pyramid step (f32): the separable [1 4 6 4 1] / 16 blur,
// kept at the even rows and columns only. (H, W) -> (ceil(H/2), ceil(W/2)).
//
// Replaces opencv_contrib_tpu/ops/pallas/pipeline.py::grid_pyrdown (body
// `kernel` at :95), and serves core/pyramid.py::pyr_down, which every level of
// the dense-flow pyramids calls. One kernel, templated on the border:
//   REPLICATE    the Pallas kernel's border (which needs even H and W; this
//                one takes any size);
//   REFLECT_101  sep_filter2d's border (cv::BORDER_REFLECT_101), the one
//                pyr_down launches. The two differ in the outer two rows and
//                columns only.
//
// Bound: bytes. Each output reads a 5x5 footprint of the input (25 loads, 60
// flops) but neighbouring outputs share most of it through L1, so the card
// need move only H*W*4 bytes in and about H*W bytes out: 2.2 MB at 436x1024,
// 0.67 us at 3.35 TB/s.
//
// Design: one thread per output pixel. The Pallas body shifts whole rows
// with jnp.roll and iota masks and decimates with one-hot selection matmuls
// because Pallas on the TPU has no strided slice; a thread here computes the
// blur at its even position only. The sum runs as sep_filter2d's does: each
// of the five columns of the footprint is blurred vertically, taps in order,
// then the five column sums horizontally, taps in order. Every product and
// sum is rounded on its own (__fmul_rn, __fadd_rn), as PyTorch's separate
// mul and add kernels round them, so nvcc contracts nothing into an FMA and
// the kernel gives the plain version's bits.

#include <cuda_runtime.h>

namespace {

constexpr int REPLICATE = 0;
constexpr int REFLECT_101 = 1;
constexpr int BX = 32, BY = 8;

template <int BORDER>
__device__ __forceinline__ int border_index(int i, int n) {
  if (BORDER == REPLICATE) return min(max(i, 0), n - 1);
  i = i < 0 ? -i : i;  // -1 -> 1 (n >= 3: the taps reach 2 past each edge)
  return i >= n ? 2 * (n - 1) - i : i;
}

template <int BORDER>
__global__ void __launch_bounds__(BX * BY) pyrdown_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                          int H, int W, int Ho, int Wo) {
  const int ox = blockIdx.x * BX + threadIdx.x;
  const int oy = blockIdx.y * BY + threadIdx.y;
  if (ox >= Wo || oy >= Ho) return;
  const float k[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};
  const float* rows[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) rows[t] = x + (size_t)border_index<BORDER>(2 * oy - 2 + t, H) * W;
  float h = 0.f;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const int col = border_index<BORDER>(2 * ox - 2 + c, W);
    float v = __fmul_rn(k[0], __ldg(rows[0] + col));
#pragma unroll
    for (int t = 1; t < 5; ++t) v = __fadd_rn(v, __fmul_rn(k[t], __ldg(rows[t] + col)));
    h = c == 0 ? __fmul_rn(k[0], v) : __fadd_rn(h, __fmul_rn(k[c], v));
  }
  out[(size_t)oy * Wo + ox] = h;
}

}  // namespace

// x: (H, W); out: (ceil(H/2), ceil(W/2)); border: 0 replicate, 1 reflect-101.
extern "C" int pyrdown_f32(const float* x, float* out, int H, int W, int border, cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const dim3 block(BX, BY), grid((Wo + BX - 1) / BX, (Ho + BY - 1) / BY);
  if (border == REFLECT_101)
    pyrdown_kernel<REFLECT_101><<<grid, block, 0, stream>>>(x, out, H, W, Ho, Wo);
  else
    pyrdown_kernel<REPLICATE><<<grid, block, 0, stream>>>(x, out, H, W, Ho, Wo);
  return (int)cudaGetLastError();
}
