// Bilinear remap (f32) of C maps by one displacement field:
// out[c](y, x) = maps[c](y + dy(y, x), x + dx(y, x)), maps (C, H, W), dy and
// dx (H, W), out (C, H, W).
//
// Replaces opencv_contrib_tpu/ops/pallas/remap.py::remap_bounded (body
// `kernel` at :69), and serves the dense warps of flow/dis.py
// (variational_refine) and flow/tvl1.py (_tvl1_level), which sample the
// second frame and its two gradients at the flow, C = 3, once per outer
// iteration. Two contracts, one kernel, templated on the mode:
//   BOUNDED   remap_bounded: dy and dx clipped to +-max_disp; each corner's
//             integer index clamped to [0, H-1] x [0, W-1] (the Pallas
//             kernel's edge-replicate pad); the fractions come from the
//             clipped displacement, as the shift-stack's weights do.
//   flow warp ops/image.py::sample_bilinear_multi at the grid plus the
//             displacement: no clip; the coordinate is clamped to
//             [0, ylim] x [0, xlim] (H - 1.001 and W - 1.001, rounded once to
//             float by the caller), so the lower and right corners stay
//             inside the image.
//
// Bound: bytes. A pixel reads dy and dx once and four corners of each map,
// and writes C values: (8 + 8 C) bytes moved at the least, 14.3 MB for C = 3
// at 436x1024, 4.3 us at 3.35 TB/s. The corners of neighbouring threads
// overlap, so most corner loads hit L1.
//
// Design: one thread per output pixel; the displacement is read once and
// the four corner indices and weights serve all C maps. The Pallas kernel is
// a shift-stack over (2R+2)^2 statically shifted copies of a whole padded
// image held in VMEM, because the TPU has no per-lane gather; a thread here
// gathers its corners, so no bound on the displacement is needed and no
// block holds the whole image. Every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn), in the order of the plain versions, so nvcc
// contracts nothing into an FMA.

#include <cuda_runtime.h>

namespace {

constexpr int BX = 32, BY = 8;

template <bool BOUNDED>
__global__ void __launch_bounds__(BX * BY) remap_kernel(const float* __restrict__ maps, const float* __restrict__ dy,
                                                        const float* __restrict__ dx, float* __restrict__ out, int C,
                                                        int H, int W, float max_disp, float ylim, float xlim) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int i = y * W + x;
  const float ddy = __ldg(dy + i), ddx = __ldg(dx + i);
  int y0, y1, x0, x1;
  float fy, fx;
  if (BOUNDED) {
    const float cy = fminf(fmaxf(ddy, -max_disp), max_disp);
    const float cx = fminf(fmaxf(ddx, -max_disp), max_disp);
    const float iy = floorf(cy), ix = floorf(cx);
    fy = __fsub_rn(cy, iy);
    fx = __fsub_rn(cx, ix);
    y0 = min(max(y + (int)iy, 0), H - 1);
    y1 = min(max(y + (int)iy + 1, 0), H - 1);
    x0 = min(max(x + (int)ix, 0), W - 1);
    x1 = min(max(x + (int)ix + 1, 0), W - 1);
  } else {
    const float yc = fminf(fmaxf(__fadd_rn((float)y, ddy), 0.f), ylim);
    const float xc = fminf(fmaxf(__fadd_rn((float)x, ddx), 0.f), xlim);
    const float fy0 = floorf(yc), fx0 = floorf(xc);
    fy = __fsub_rn(yc, fy0);
    fx = __fsub_rn(xc, fx0);
    y0 = (int)fy0;
    x0 = (int)fx0;
    y1 = y0 + 1;
    x1 = x0 + 1;
  }
  const float gy = __fsub_rn(1.f, fy), gx = __fsub_rn(1.f, fx);
  const float w00 = __fmul_rn(gy, gx), w01 = __fmul_rn(gy, fx), w10 = __fmul_rn(fy, gx), w11 = __fmul_rn(fy, fx);
  const size_t plane = (size_t)H * W;
  const int i00 = y0 * W + x0, i01 = y0 * W + x1, i10 = y1 * W + x0, i11 = y1 * W + x1;
  for (int c = 0; c < C; ++c) {
    const float* m = maps + c * plane;
    float s = __fmul_rn(w00, __ldg(m + i00));
    s = __fadd_rn(s, __fmul_rn(w01, __ldg(m + i01)));
    s = __fadd_rn(s, __fmul_rn(w10, __ldg(m + i10)));
    s = __fadd_rn(s, __fmul_rn(w11, __ldg(m + i11)));
    out[c * plane + i] = s;
  }
}

}  // namespace

// maps, out: (C, H, W); dy, dx: (H, W). bounded != 0: clip to +-max_disp and
// clamp indices; else clamp coordinates to [0, ylim] x [0, xlim].
extern "C" int remap_f32(const float* maps, const float* dy, const float* dx, float* out, int C, int H, int W,
                         int bounded, float max_disp, float ylim, float xlim, cudaStream_t stream) {
  const dim3 block(BX, BY), grid((W + BX - 1) / BX, (H + BY - 1) / BY);
  if (bounded)
    remap_kernel<true><<<grid, block, 0, stream>>>(maps, dy, dx, out, C, H, W, max_disp, ylim, xlim);
  else
    remap_kernel<false><<<grid, block, 0, stream>>>(maps, dy, dx, out, C, H, W, max_disp, ylim, xlim);
  return (int)cudaGetLastError();
}
