// Tiled map -> vector reduction (f32), and its one instantiation on the
// KinectFusion path: the ICP getAb 6x7 normal system.
//
// Replaces opencv_contrib_tpu/ops/pallas/grid.py::grid_reduce_vec, in the
// role its docstring names for it: the point-to-plane ICP system assembly
// of rgbd/icp.py::build_system (fast_icp.cpp GetAbInvoker).
//
// Bound: bytes. The map reads what each gate needs: every pixel's source valid
// flag (1 B), a valid pixel's source point (12 B), the target's valid flag where
// the point projects inside the target (1 B), the target point where that is
// valid (12 B), and both normals where the distance gate passes (24 B): at most
// 50 B a pixel. Its arithmetic, at most about 120 flops a pixel, is a few
// percent of the card's rate at that traffic.
//
// Design: the Pallas kernel walks the grid in order and adds each tile's
// (out_dim,) vector into one VMEM accumulator. Blocks on Hopper run in no
// order, so the fold becomes the cudev pattern:
//   grid_reduce_vec_kernel<Map, OUT>: a grid-stride loop over pixels, OUT
//     float accumulators per thread, a warp-shuffle reduction, then the warps'
//     sums meet in shared memory; each block writes its OUT partial sums to a
//     (blocks, OUT) buffer. There are no padded cells: the map is called only
//     for pixels inside the image, so it needs no validity tile.
//   A second launch folds the partials with one warp per output: each lane
//     sums a fixed stride of blocks, then a shuffle tree joins the lanes. The
//     order is fixed and there are no atomics, so two runs on the same inputs
//     give the same bits.
// The ICP map (IcpGetAb) is build_system's per-pixel body. Its projection
// u = x / z * fx + cx is written with explicitly rounded operations: nvcc
// would otherwise contract it into an FMA, which rounds differently from
// PyTorch's separate kernels at .5 pixel boundaries and so associates other
// pixels than the plain version on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GETAB_OUT = 29;  // 21 of A's upper triangle, 6 of J^T r, sum w, sum w r^2

template <class Map, int OUT>
__global__ void __launch_bounds__(THREADS) grid_reduce_vec_kernel(Map map, int n, float* __restrict__ partials) {
  __shared__ float warp_sums[WARPS][OUT];
  float acc[OUT];
#pragma unroll
  for (int k = 0; k < OUT; ++k) acc[k] = 0.f;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n; i += gridDim.x * THREADS) map(i, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < OUT; ++k) {
    float s = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(FULL, s, o);
    if (lane == 0) warp_sums[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < OUT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += warp_sums[w][threadIdx.x];
    partials[(size_t)blockIdx.x * OUT + threadIdx.x] = s;
  }
}

struct IcpGetAb {
  const float* T;  // (4, 4) row-major, source camera -> target camera
  const float* intr;  // fx, fy, cx, cy, ...
  const float* src_pts;  // (H, W, 3)
  const float* src_nrm;
  const uint8_t* src_valid;  // (H, W) bool
  const float* dst_pts;  // (Hd, Wd, 3)
  const float* dst_nrm;
  const uint8_t* dst_valid;
  int Hd, Wd;
  float dist2, cos_thresh;

  __device__ void operator()(int i, float* acc) const {
    if (!src_valid[i]) return;
    const float sx = src_pts[3 * i], sy = src_pts[3 * i + 1], sz = src_pts[3 * i + 2];
    const float px = T[0] * sx + T[1] * sy + T[2] * sz + T[3];
    const float py = T[4] * sx + T[5] * sy + T[6] * sz + T[7];
    const float pz = T[8] * sx + T[9] * sy + T[10] * sz + T[11];
    if (!(pz > 0.f)) return;
    const float zs = fmaxf(pz, 1e-9f);
    const float u = __fadd_rn(__fmul_rn(__fdiv_rn(px, zs), intr[0]), intr[2]);
    const float v = __fadd_rn(__fmul_rn(__fdiv_rn(py, zs), intr[1]), intr[3]);
    const int ui = __float2int_rn(u), vi = __float2int_rn(v);  // half to even, as torch.round
    if (ui < 0 || ui >= Wd || vi < 0 || vi >= Hd) return;
    const int j = vi * Wd + ui;
    if (!dst_valid[j]) return;
    const float dx = px - dst_pts[3 * j], dy = py - dst_pts[3 * j + 1], dz = pz - dst_pts[3 * j + 2];
    if (!(dx * dx + dy * dy + dz * dz < dist2)) return;
    const float nx = dst_nrm[3 * j], ny = dst_nrm[3 * j + 1], nz = dst_nrm[3 * j + 2];
    const float mx = src_nrm[3 * i], my = src_nrm[3 * i + 1], mz = src_nrm[3 * i + 2];
    const float rx = T[0] * mx + T[1] * my + T[2] * mz;
    const float ry = T[4] * mx + T[5] * my + T[6] * mz;
    const float rz = T[8] * mx + T[9] * my + T[10] * mz;
    if (!(rx * nx + ry * ny + rz * nz > cos_thresh)) return;
    const float r = nx * dx + ny * dy + nz * dz;  // point-to-plane residual
    const float J[6] = {py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx, nx, ny, nz};
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) acc[k++] += J[a] * J[b];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] += J[a] * r;
    acc[27] += 1.f;
    acc[28] += r * r;
  }
};

// One block of GETAB_OUT warps: warp k folds column k of the (blocks, 29)
// partials, then the block writes A (6, 6) mirrored, b = -J^T r (6,),
// n_corr and mean_err = sum w r^2 / max(n_corr, 1).
__global__ void __launch_bounds__(GETAB_OUT * 32) icp_getab_finalize_kernel(const float* __restrict__ partials,
                                                                            int blocks, float* __restrict__ out) {
  __shared__ float tot[GETAB_OUT];
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  float s = 0.f;
  for (int b = lane; b < blocks; b += 32) s += partials[(size_t)b * GETAB_OUT + k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(FULL, s, o);
  if (lane == 0) tot[k] = s;
  __syncthreads();
  if (threadIdx.x < 36) {
    const int r = threadIdx.x / 6, c = threadIdx.x % 6;
    const int a = min(r, c), b = max(r, c);
    out[threadIdx.x] = tot[a * 6 - a * (a - 1) / 2 + (b - a)];  // row a of the upper triangle starts there
  } else if (threadIdx.x < 42) {
    out[threadIdx.x] = -tot[21 + threadIdx.x - 36];
  } else if (threadIdx.x == 42) {
    out[42] = tot[27];
    out[43] = tot[28] / fmaxf(tot[27], 1.f);
  }
}

}  // namespace

// partials: (blocks, 29) scratch; out: 44 floats (A 36, b 6, n_corr, mean_err).
extern "C" int icp_getab_f32(const float* T, const float* intr, const float* src_pts, const float* src_nrm,
                             const uint8_t* src_valid, const float* dst_pts, const float* dst_nrm,
                             const uint8_t* dst_valid, int n, int Hd, int Wd, float dist2, float cos_thresh,
                             int blocks, float* partials, float* out, cudaStream_t stream) {
  const IcpGetAb map{T, intr, src_pts, src_nrm, src_valid, dst_pts, dst_nrm, dst_valid, Hd, Wd, dist2, cos_thresh};
  grid_reduce_vec_kernel<IcpGetAb, GETAB_OUT><<<blocks, THREADS, 0, stream>>>(map, n, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  icp_getab_finalize_kernel<<<1, GETAB_OUT * 32, 0, stream>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}
