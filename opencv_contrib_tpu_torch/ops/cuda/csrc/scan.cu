// Inclusive prefix sums for summed-area tables (f32).
//
// Replaces opencv_contrib_tpu/ops/pallas/grid.py::integral_image (row-scan
// body _scan_rows_kernel) and ops/pallas/pipeline.py::grid_scan.
//
// Bound: bytes. A scan reads each input once and writes each output once;
// it does one add per element, far below the card's arithmetic rate.
//
// Design: the TPU kernels walked column tiles in grid order and carried the
// running row total in scratch memory from one grid step to the next. Blocks
// on Hopper run in no order, so the carry lives in registers instead:
//   scan_rows: one warp per row. Each lane loads 4 consecutive elements
//     (one 16-byte load when the row allows it), scans them serially, the
//     warp scans the 32 lane totals with shuffles, and the running row total
//     stays in a register as the warp walks the row 128 elements at a time.
//   scan_cols: a block of 32 x 32 threads owns 32 neighbouring columns; each
//     of its 32 thread rows owns one contiguous band of rows (loads of one
//     image row are 128 coalesced bytes). It first sums its band, the band
//     totals meet in shared memory, and then it scans its band again from
//     the sum of the bands above it, writing each output once. The second
//     read of a band comes from L2 (a block's 32 columns are at most a few
//     hundred KB), so device memory sees one read and one write.
// integral_image = scan_rows, then scan_cols: two launches, each one read
// and one write of the image.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(256) scan_rows_kernel(
    const float* __restrict__ x, float* __restrict__ y, int H, int W, bool vec) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= H) return;  // whole warp leaves together
  const float* xr = x + (size_t)row * W;
  float* yr = y + (size_t)row * W;
  float carry = 0.f;
  for (int base = 0; base < W; base += 128) {
    const int i0 = base + lane * 4;
    float v[4];
    if (vec && i0 + 3 < W) {
      const float4 a = *reinterpret_cast<const float4*>(xr + i0);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = (i0 + k < W) ? xr[i0 + k] : 0.f;
    }
    v[1] += v[0];
    v[2] += v[1];
    v[3] += v[2];
    float s = v[3];  // inclusive warp scan of the lane totals
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += n;
    }
    float excl = __shfl_up_sync(FULL, s, 1);
    if (lane == 0) excl = 0.f;
    excl += carry;
    if (vec && i0 + 3 < W) {
      *reinterpret_cast<float4*>(yr + i0) =
          make_float4(v[0] + excl, v[1] + excl, v[2] + excl, v[3] + excl);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + k < W) yr[i0 + k] = v[k] + excl;
    }
    carry += __shfl_sync(FULL, s, 31);
  }
}

__global__ void __launch_bounds__(1024) scan_cols_kernel(
    const float* __restrict__ x, float* __restrict__ y, int H, int W) {
  __shared__ float band_total[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * 32 + tx;
  const int band = (H + 31) / 32;
  const int r0 = ty * band;
  const int r1 = min(H, r0 + band);
  float total = 0.f;
  if (col < W) {
    for (int r = r0; r < r1; ++r) total += x[(size_t)r * W + col];
  }
  band_total[ty][tx] = total;
  __syncthreads();
  float acc = 0.f;
  for (int k = 0; k < ty; ++k) acc += band_total[k][tx];
  if (col < W) {
    for (int r = r0; r < r1; ++r) {
      acc += x[(size_t)r * W + col];
      y[(size_t)r * W + col] = acc;
    }
  }
}

}  // namespace

extern "C" int scan_rows_f32(const float* x, float* y, int H, int W, cudaStream_t stream) {
  const bool vec = (W % 4 == 0) && ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(y)) % 16 == 0);
  const int warps_per_block = 8;
  const int blocks = (H + warps_per_block - 1) / warps_per_block;
  scan_rows_kernel<<<blocks, warps_per_block * 32, 0, stream>>>(x, y, H, W, vec);
  return (int)cudaGetLastError();
}

extern "C" int scan_cols_f32(const float* x, float* y, int H, int W, cudaStream_t stream) {
  const dim3 threads(32, 32);
  const int blocks = (W + 31) / 32;
  scan_cols_kernel<<<blocks, threads, 0, stream>>>(x, y, H, W);
  return (int)cudaGetLastError();
}
