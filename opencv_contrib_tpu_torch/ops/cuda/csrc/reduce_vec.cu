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
// percent of the card's rate at that traffic. The frames are small (7.4 MB of
// points and normals a VGA frame), so on the ICP loop they come from the L2,
// and what costs time is the chain of dependent reads a pixel makes (its
// source point, then the target pixel it projects to) and the fold of 29 sums.
//
// Design: the Pallas kernel walks the grid in order and adds each tile's
// (out_dim,) vector into one VMEM accumulator. Blocks on Hopper run in no
// order, so the fold is the ticket pattern of reduce.cu, in one launch:
//   - the grid is sized from the frame by the wrapper (ops/cuda/reduce.py
//     getab_plan: sqrt(H W) / 2 blocks, at most 2 an SM: 264, 139 and 69 at
//     the three ICP levels of a VGA frame), which balances a thread's
//     pixels against the partials the last block folds;
//   - the map's parameters (T's rows and the intrinsics) are read from
//     global memory once a block into shared memory;
//   - a thread takes U pixels at a time, a grid stride apart, and issues the
//     reads of all U before it uses any: the source flags and points
//     together (a point is read whether or not its flag is set), then the
//     target flag, point and normal and the source normal of every pixel
//     that projects inside the target. So a step costs two dependent round
//     trips to the L2 for U pixels. A warp's three scalar loads of a float3
//     cover 384 contiguous bytes, so each sector fetched is used;
//   - the block folds its OUT sums (a warp-shuffle tree, then thread k adds
//     the warps' k-th sums in warp order) and OUT threads write its
//     partials; between fences, thread 0 draws an integer ticket, and the
//     block that draws the last one folds the partials (8 threads an
//     output, each with all its loads in flight at once, in block order,
//     then a shuffle tree), writes the 44 outputs and sets the ticket back
//     to 0 for the next launch. The ticket and the partials live in the scratch buffer that
//     ops/cuda/reduce.py caches per device and stream (grid_reduce's):
//     launches on one stream run one after another.
// Deterministic: no float atomics, and each thread's pixels, the block tree
// and the fold of the partials follow an order fixed by (H, W), which fixes
// the block count, so a rerun gives the same bits.
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
constexpr int U = 4;  // pixels a thread has in flight
constexpr int MAX_BLOCKS = 2 * 132;  // ops/cuda/reduce.py _GETAB_MAX_BLOCKS: the scratch holds their partials
constexpr int FOLD_LOADS = (MAX_BLOCKS + 7) / 8;  // partials a thread of the last block reads

// true in every thread of the block that draws the last of `blocks` tickets.
// Thread 0 draws it after the block's barrier with one acquire-release
// atomic at device scope: its release publishes the block's writes (ordered
// before it by the barrier), and the last block's acquire orders its reads
// after every other block's writes; the second barrier shares the answer.
__device__ __forceinline__ bool last_block(unsigned* ticket, unsigned blocks) {
  __syncthreads();
  bool last = false;
  if (threadIdx.x == 0) {
    unsigned drawn;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;" : "=r"(drawn) : "l"(ticket) : "memory");
    last = drawn == blocks - 1;
  }
  return __syncthreads_or(last);
}

// joins the sums of the 8 threads t, t + 1, ..., t + 7 (t a multiple of 8)
// in a fixed shuffle tree; valid in thread t
__device__ __forceinline__ float fold8(float s) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) s += __shfl_down_sync(FULL, s, o, 8);
  return s;
}

// Map: PARAMS floats staged once a block (param(t)), OUT sums folded from
// U pixels at a time (step<U>), and the outputs written from the OUT totals
// (finish, by the block's threads).
template <class Map>
__global__ void __launch_bounds__(THREADS, 2) grid_reduce_vec_kernel(Map map, int n, float* partials,
                                                                     unsigned* ticket, float* __restrict__ out) {
  constexpr int OUT = Map::OUT;
  static_assert(8 * OUT <= THREADS, "the last block folds each output with 8 threads");
  __shared__ float prm[Map::PARAMS];
  __shared__ float sums[OUT][THREADS + 1];  // the block's OUT sums a thread; a row's padding shifts its banks
  __shared__ float tot[OUT];
  if (threadIdx.x < Map::PARAMS) prm[threadIdx.x] = map.param(threadIdx.x);
  __syncthreads();
  float acc[OUT];
#pragma unroll
  for (int k = 0; k < OUT; ++k) acc[k] = 0.f;
  const int stride = gridDim.x * THREADS;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n; i += U * stride) map.template step<U>(prm, i, stride, n, acc);
  const int blocks = gridDim.x;
  // the block's partials: each thread's OUT sums into a column of `sums`;
  // the 8 threads of sum k = t / 8 each add one warp's 32 values (from a
  // start rotated by 4 a thread, so that a warp's reads fall in 32 banks),
  // and fold8 adds the warps in order
#pragma unroll
  for (int k = 0; k < OUT; ++k) sums[k][threadIdx.x] = acc[k];
  __syncthreads();
  const int k = threadIdx.x >> 3, sub = threadIdx.x & 7;
  float s = 0.f;
  if (k < OUT) {
#pragma unroll
    for (int j = 0; j < 32; ++j) s += sums[k][sub * 32 + ((j + 4 * sub) & 31)];
  }
  s = fold8(s);
  if (sub == 0 && k < OUT) partials[k * blocks + blockIdx.x] = s;
  if (!last_block(ticket, blocks)) return;
  // the last block: the 8 threads of sum k read blocks t % 8, t % 8 + 8, ...
  // from the L2 (__ldcg: past this SM's L1), every load issued before the
  // first add, add them in block order, and fold8 joins them. (One running
  // sum a column: 29 sums a thread would leave no registers for loads in
  // flight, and the fold would then wait one L2 round trip a block.)
  float v[FOLD_LOADS];
#pragma unroll
  for (int m = 0; m < FOLD_LOADS; ++m) {
    const int p = sub + 8 * m;
    v[m] = k < OUT && p < blocks ? __ldcg(partials + k * blocks + p) : 0.f;
  }
  s = 0.f;
#pragma unroll
  for (int m = 0; m < FOLD_LOADS; ++m) s += v[m];
  s = fold8(s);
  if (sub == 0 && k < OUT) tot[k] = s;
  __syncthreads();
  Map::finish(tot, out);
  if (threadIdx.x == 0) *ticket = 0u;  // the next launch on this stream starts from 0
}

struct IcpGetAb {
  static constexpr int OUT = 29;  // 21 of A's upper triangle, 6 of J^T r, sum w, sum w r^2
  static constexpr int PARAMS = 16;  // T's first three rows (12), fx, fy, cx, cy
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

  __device__ float param(int t) const { return t < 12 ? T[t] : intr[t - 12]; }

  // pixels i, i + stride, ..., i + (V - 1) stride that lie below n
  template <int V>
  __device__ __forceinline__ void step(const float* prm, int i, int stride, int n, float* acc) const {
    // round 1: the source flags and points
    bool ok[V];
    float p[V][3];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int k = i + u * stride;
      ok[u] = k < n;
      if (ok[u]) {
        ok[u] = src_valid[k] != 0;
        const float* s = src_pts + 3 * (size_t)k;
        p[u][0] = __ldg(s);
        p[u][1] = __ldg(s + 1);
        p[u][2] = __ldg(s + 2);
      }
    }
    // the source points in the target frame, and the target pixels they project to
    int j[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      j[u] = -1;
      if (!ok[u]) continue;
      const float sx = p[u][0], sy = p[u][1], sz = p[u][2];
      const float px = prm[0] * sx + prm[1] * sy + prm[2] * sz + prm[3];
      const float py = prm[4] * sx + prm[5] * sy + prm[6] * sz + prm[7];
      const float pz = prm[8] * sx + prm[9] * sy + prm[10] * sz + prm[11];
      p[u][0] = px;
      p[u][1] = py;
      p[u][2] = pz;
      if (!(pz > 0.f)) continue;
      const float zs = fmaxf(pz, 1e-9f);
      const float uu = __fadd_rn(__fmul_rn(__fdiv_rn(px, zs), prm[12]), prm[14]);
      const float vv = __fadd_rn(__fmul_rn(__fdiv_rn(py, zs), prm[13]), prm[15]);
      const int ui = __float2int_rn(uu), vi = __float2int_rn(vv);  // half to even, as torch.round
      if (ui < 0 || ui >= Wd || vi < 0 || vi >= Hd) continue;
      j[u] = vi * Wd + ui;
    }
    // round 2: the target flag, point and normal, and the source normal
    bool tv[V];
    float q[V][3], nd[V][3], ns[V][3];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      tv[u] = j[u] >= 0;
      if (!tv[u]) continue;
      const size_t jj = 3 * (size_t)j[u], kk = 3 * (size_t)(i + u * stride);
      tv[u] = dst_valid[j[u]] != 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        q[u][a] = __ldg(dst_pts + jj + a);
        nd[u][a] = __ldg(dst_nrm + jj + a);
        ns[u][a] = __ldg(src_nrm + kk + a);
      }
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (!tv[u]) continue;
      const float px = p[u][0], py = p[u][1], pz = p[u][2];
      const float dx = px - q[u][0], dy = py - q[u][1], dz = pz - q[u][2];
      if (!(dx * dx + dy * dy + dz * dz < dist2)) continue;
      const float nx = nd[u][0], ny = nd[u][1], nz = nd[u][2];
      const float mx = ns[u][0], my = ns[u][1], mz = ns[u][2];
      const float rx = prm[0] * mx + prm[1] * my + prm[2] * mz;
      const float ry = prm[4] * mx + prm[5] * my + prm[6] * mz;
      const float rz = prm[8] * mx + prm[9] * my + prm[10] * mz;
      if (!(rx * nx + ry * ny + rz * nz > cos_thresh)) continue;
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
  }

  // A (6, 6) mirrored, b = -J^T r (6,), n_corr and mean_err = sum w r^2 /
  // max(n_corr, 1), one output a thread
  __device__ static void finish(const float* tot, float* out) {
    const int t = threadIdx.x;
    if (t < 36) {
      const int r = t / 6, c = t % 6;
      const int a = min(r, c), b = max(r, c);
      out[t] = tot[a * 6 - a * (a - 1) / 2 + (b - a)];  // row a of the upper triangle starts there
    } else if (t < 42) {
      out[t] = -tot[21 + t - 36];
    } else if (t == 42) {
      out[42] = tot[27];
    } else if (t == 43) {
      out[43] = __fdiv_rn(tot[28], fmaxf(tot[27], 1.f));
    }
  }
};

}  // namespace

// n = H W source pixels; blocks: ops/cuda/reduce.py getab_plan(H, W), at
// most MAX_BLOCKS; scratch: the ticket (one unsigned, 0 between launches)
// then MAX_BLOCKS * 29 partials from float 4 on (reduce.py's scratch); out:
// 44 floats (A 36, b 6, n_corr, mean_err).
extern "C" int icp_getab_f32(const float* T, const float* intr, const float* src_pts, const float* src_nrm,
                             const uint8_t* src_valid, const float* dst_pts, const float* dst_nrm,
                             const uint8_t* dst_valid, int n, int Hd, int Wd, float dist2, float cos_thresh,
                             int blocks, float* scratch, float* out, cudaStream_t stream) {
  if (blocks < 1 || blocks > MAX_BLOCKS || n < 1) return (int)cudaErrorInvalidValue;
  const IcpGetAb map{T, intr, src_pts, src_nrm, src_valid, dst_pts, dst_nrm, dst_valid, Hd, Wd, dist2, cos_thresh};
  grid_reduce_vec_kernel<IcpGetAb><<<blocks, THREADS, 0, stream>>>(map, n, scratch + 4,
                                                                  reinterpret_cast<unsigned*>(scratch), out);
  return (int)cudaGetLastError();
}
