// Fused brute-force 2-NN under squared L2 (f32), with a running top-2.
//
// Replaces opencv_contrib_tpu/ops/pallas/matching.py::knn2 (body
// _knn2_kernel): each block owns a query tile in shared memory, streams
// train tiles, and keeps a running (best, second, best_idx) per query, so
// the Q x T distance matrix is never written to device memory.
//
// Bound: operations. 2*Q*T*D flops for Q*D + T*D inputs; at 8192 x 8192 x
// 128 that is 17.2 GFLOP against 8 MB, far above the card's balance point.
// The products run as f32 FMAs on the CUDA cores (not TF32 on the tensor
// cores, which keeps 10 mantissa bits and would not hold the distances to
// the plain version's tolerance).
//
// Design:
//   - 256 threads, 16 x 16, each computing a 4 x 4 register tile of dot
//     products for a 64-query x 64-train tile; the query tile (all of D) is
//     staged once, transposed, in shared memory, the train tile in 32-deep
//     chunks, so each thread reads one float4 of each per depth step.
//   - each thread folds its distances into a per-row running top-2 in
//     registers, visiting its columns in increasing train index; the 16
//     threads that share a row merge with shuffles at the end.
//   - blockIdx.y splits the train set into spans of `span` rows so that
//     enough blocks fill the card at small Q; a second kernel merges the
//     spans' partial top-2 in order.
//   - ties go to the lower train index; the second best excludes only the
//     best's column (as the Pallas merge does).
//   - ragged edges (Q, T, D not multiples of the tiles) are masked here.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int TQ = 64;   // queries per block
constexpr int TT = 64;   // train rows per tile
constexpr int DK = 32;   // depth of one staged train chunk
constexpr int SQ = TQ + 4;  // padded shared-memory row strides (16-byte aligned)
constexpr int ST = TT + 4;
constexpr unsigned FULL = 0xffffffffu;

struct Top2 {
  float best, second;
  int idx;
};

__device__ __forceinline__ void push(Top2& a, float d, int j) {
  // candidates arrive in increasing j: strict < keeps the lower index on ties
  if (d < a.best) {
    a.second = a.best;
    a.best = d;
    a.idx = j;
  } else {
    a.second = fminf(a.second, d);
  }
}

__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool b_wins = (b.best < a.best) || (b.best == a.best && b.idx < a.idx);
  Top2 r;
  r.best = b_wins ? b.best : a.best;
  r.idx = b_wins ? b.idx : a.idx;
  const float loser = b_wins ? a.best : b.best;
  r.second = fminf(loser, fminf(a.second, b.second));
  return r;
}

__global__ void row_sqnorm_kernel(const float* __restrict__ t, int T, int D, float* __restrict__ tn) {
  // one warp per row
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= T) return;
  const float* tr = t + (size_t)row * D;
  float s = 0.f;
  for (int k = lane; k < D; k += 32) s = fmaf(tr[k], tr[k], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) tn[row] = s;
}

__global__ void __launch_bounds__(256) knn2_kernel(
    const float* __restrict__ q, const float* __restrict__ t,
    const float* __restrict__ tn, int Q, int T, int D, int Dp, int span,
    float* __restrict__ part_best, float* __restrict__ part_second,
    int* __restrict__ part_idx, float* __restrict__ dist, int* __restrict__ idx_out,
    int n_split) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [Dp][SQ]
  float* Ts = Qs + (size_t)Dp * SQ;             // [DK][ST]
  __shared__ float qn_s[TQ];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * TQ;
  const int t_begin = blockIdx.y * span;
  const int t_end = min(T, t_begin + span);

  // stage the query tile transposed: thread -> (row r, 8-deep k group)
  {
    const int r = tid & (TQ - 1);
    const int kg = tid >> 6;  // 0..3
    const bool ok_r = q0 + r < Q;
    const float* qr = q + (size_t)(q0 + r) * D;
    for (int k0 = kg * 8; k0 < Dp; k0 += 32) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + i;
        Qs[k * SQ + r] = (ok_r && k < D) ? qr[k] : 0.f;
      }
    }
  }
  __syncthreads();
  if (tid < TQ) {
    float s = 0.f;
    for (int k = 0; k < D; ++k) {
      const float v = Qs[k * SQ + tid];
      s = fmaf(v, v, s);
    }
    qn_s[tid] = s;
  }

  Top2 run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) run[i] = Top2{INFINITY, INFINITY, INT_MAX};

  for (int t0 = t_begin; t0 < t_end; t0 += TT) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < Dp; k0 += DK) {
      __syncthreads();  // the previous chunk has been consumed
      {
        const int c = tid & (TT - 1);
        const int kg = tid >> 6;  // 0..3, 8 deep each
        const bool ok_c = t0 + c < t_end;
        const float* tr = t + (size_t)(t0 + c) * D;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = k0 + kg * 8 + i;
          Ts[(kg * 8 + i) * ST + c] = (ok_c && k < D) ? tr[k] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < DK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&Qs[(k0 + k) * SQ + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Ts[k * ST + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = t0 + tx * 4 + j;
      if (col < t_end) {
        const float tnc = tn[col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = (qn_s[ty * 4 + i] + tnc) - 2.f * acc[i][j];
          push(run[i], d, col);
        }
      }
    }
  }

  // merge across the 16 threads (tx) that share each row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      Top2 other;
      other.best = __shfl_xor_sync(FULL, run[i].best, o);
      other.second = __shfl_xor_sync(FULL, run[i].second, o);
      other.idx = __shfl_xor_sync(FULL, run[i].idx, o);
      run[i] = merge(run[i], other);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row >= Q) continue;
      if (n_split == 1) {
        dist[2 * (size_t)row] = run[i].best;
        dist[2 * (size_t)row + 1] = run[i].second;
        idx_out[row] = run[i].idx == INT_MAX ? 0 : run[i].idx;
      } else {
        const size_t p = (size_t)blockIdx.y * Q + row;
        part_best[p] = run[i].best;
        part_second[p] = run[i].second;
        part_idx[p] = run[i].idx;
      }
    }
  }
}

__global__ void knn2_merge_kernel(const float* __restrict__ part_best,
                                  const float* __restrict__ part_second,
                                  const int* __restrict__ part_idx, int Q, int n_split,
                                  float* __restrict__ dist, int* __restrict__ idx_out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= Q) return;
  Top2 r{INFINITY, INFINITY, INT_MAX};
  for (int s = 0; s < n_split; ++s) {
    const size_t p = (size_t)s * Q + row;
    r = merge(r, Top2{part_best[p], part_second[p], part_idx[p]});
  }
  dist[2 * (size_t)row] = r.best;
  dist[2 * (size_t)row + 1] = r.second;
  idx_out[row] = r.idx == INT_MAX ? 0 : r.idx;
}

}  // namespace

extern "C" int knn2_f32(const float* q, const float* t, int Q, int T, int D, int span,
                        float* tn, float* part_best, float* part_second, int* part_idx,
                        float* dist, int* idx, cudaStream_t stream) {
  if (Q <= 0 || T <= 0 || D <= 0 || span <= 0 || span % TT != 0) return (int)cudaErrorInvalidValue;
  const int Dp = (D + DK - 1) / DK * DK;
  const size_t smem = ((size_t)Dp * SQ + (size_t)DK * ST) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(knn2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  row_sqnorm_kernel<<<(T + 7) / 8, 256, 0, stream>>>(t, T, D, tn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_split = (T + span - 1) / span;
  const dim3 grid((Q + TQ - 1) / TQ, n_split);
  knn2_kernel<<<grid, 256, smem, stream>>>(q, t, tn, Q, T, D, Dp, span, part_best, part_second,
                                           part_idx, dist, idx, n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_split > 1) {
    knn2_merge_kernel<<<(Q + 255) / 256, 256, 0, stream>>>(part_best, part_second, part_idx, Q,
                                                          n_split, dist, idx);
  }
  return (int)cudaGetLastError();
}
