// Fused brute-force 2-NN under squared L2 (f32), with a running top-2.
//
// Replaces opencv_contrib_tpu/ops/pallas/matching.py::knn2 (body
// _knn2_kernel): each block owns a query tile, streams train tiles through
// shared memory, and keeps a running (best, second, best_idx) per query, so
// the Q x T distance matrix is never written to device memory.
//
// Bound: operations. 2*Q*T*D flops for Q*D + T*D inputs; at 8192 x 8192 x
// 128 that is 17.2 GFLOP against 8 MB, far above the card's balance point.
// The products run as f32 FMAs on the CUDA cores (not TF32 on the tensor
// cores, which keeps 10 mantissa bits and would not hold the distances to
// the plain version's tolerance).
//
// What held the first design back: 64 x 64 tiles and a 2048-row span gave
// 8 blocks on 132 SMs at the keyframe tick's 512 x 512; the staging read one
// scalar per (row, k), so a warp's load touched 32 rows; a 4 x 4 register
// tile read two float4 from shared memory per 16 FMAs; and a call made up to
// three launches (train norms, the kernel, a merge of the spans) and set the
// shared-memory attribute every time. Now:
//   - two tile shapes, one template: Large (128 queries x 128 train rows,
//     256 threads, an 8 x 8 register tile each) where the problem has many
//     tiles, Small (32 x 64, 128 threads, 4 x 4) elsewhere; the wrapper
//     picks the shape from (Q, T) and splits the train set into spans
//     (blockIdx.y) so that about one Large or four Small blocks run on each
//     SM;
//   - both tiles are staged row-major as they lie in memory, DK deep a
//     chunk (Large 64, Small 32), with 16-byte cp.async copies (consecutive
//     threads on consecutive addresses of one row; 4-byte copies when D % 4
//     != 0 or a pointer is not 16-byte aligned) into a ring of chunks (Large
//     2, Small 3), so the copy of the next chunks overlaps the FMAs of this
//     one. Rows are padded to DK + 4 floats (144 or 272 bytes): the float4
//     reads of eight neighbouring rows by a quarter-warp hit eight different
//     16-byte bank groups;
//   - each thread reads one float4 of each of its rows and columns per four
//     depth steps, JB columns at a time (Large: 4, so 16 + 8 float4 per 256
//     FMAs; Small: 4 + 4 per 64). Large takes about 250 registers, one
//     block an SM: cut to 128 for two, it spills and runs slower;
//   - one launch: the train norms (and the query norms, on the first train
//     tile) are taken from the staged rows; each span's block writes its
//     partial top-2, fences, and draws a ticket of its query tile; the block
//     that draws the last ticket merges the spans in span order (reading the
//     partials from the L2, __ldcg) and sets the ticket back to 0;
//   - the shared-memory attribute is set once per device and instantiation.
// The bits do not depend on the tile shape, the split or the block order:
// every dot product and norm accumulates in increasing k with fmaf, d is
// (qn + tn) - 2 dot (2 dot is exact, so contraction cannot change it), and
// the top-2 of a set of candidates does not depend on the order of merging:
// ties go to the lower train index, and the second best is the smallest
// candidate other than the best's column. No float atomics. Ragged edges (Q,
// T, D not multiples of the tiles) are zero-filled by the copies and masked.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int TX = 16;  // threads along a train tile; the shuffle merge spans them
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

// TQ x TT tile, RI x RJ a thread, JB of its RJ columns' float4 in registers
// at once, MINB blocks an SM for __launch_bounds__, DK deep chunks in a
// ring of STAGES; shared rows of DK + 4 floats (a stride of 16 bytes past a
// multiple of 128, so eight rows' float4 fall in eight bank groups)
template <int TQ_, int TT_, int RI_, int RJ_, int JB_, int MINB_, int DK_, int STAGES_>
struct Tile {
  static constexpr int TQ = TQ_, TT = TT_, RI = RI_, RJ = RJ_, JB = JB_, MINB = MINB_;
  static constexpr int DK = DK_, SROW = DK_ + 4, STAGES = STAGES_;
  static constexpr int TY = TQ / RI;
  static constexpr int THREADS = TX * TY;
  static constexpr int STAGE_FLOATS = (TQ + TT) * SROW;
  static constexpr int SMEM = STAGES * STAGE_FLOATS * (int)sizeof(float);
  static_assert(TT == TX * RJ && TQ == TY * RI && RJ % JB == 0 && DK % 32 == 0, "tile");
  static_assert(THREADS >= TQ + TT, "one thread per norm");
};
// Large: at 8192 x 8192 x 128 on an H100, JB 4 beat 8, DK 64 in 2 stages
// beat 32 in 3, and two blocks an SM (128 registers) spilled and were slower
using Large = Tile<128, 128, 8, 8, 4, 1, 64, 2>;  // ops/cuda/matching.py _LARGE
using Small = Tile<32, 64, 4, 4, 4, 1, 32, 3>;    // ops/cuda/matching.py _SMALL

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

// the copies of chunk c (train tile c / n_k of the span, depth chunk c % n_k)
// into its ring slot: query rows first, then train rows, DK floats each;
// out-of-range rows and depths are zero-filled
template <class C, bool VEC>
__device__ __forceinline__ void stage(float* smem, int c, int n_k, const float* __restrict__ q,
                                      const float* __restrict__ t, int Q, int D, int q0, int t_begin,
                                      int t_end) {
  constexpr int TQ = C::TQ, TT = C::TT, DK = C::DK, SROW = C::SROW, STAGES = C::STAGES, W = VEC ? 4 : 1;
  float* dst = smem + (c % STAGES) * C::STAGE_FLOATS;
  const int t0 = t_begin + (c / n_k) * TT, k0 = (c % n_k) * DK;
  for (int e = threadIdx.x; e < (TQ + TT) * (DK / W); e += C::THREADS) {
    const int r = e / (DK / W), kk = (e % (DK / W)) * W, k = k0 + kk;
    const bool is_q = r < TQ;
    const int row = is_q ? q0 + r : t0 + (r - TQ);
    const bool ok = (is_q ? row < Q : row < t_end) && k < D;
    const float* src = ok ? (is_q ? q : t) + (size_t)row * D + k : q;
    __pipeline_memcpy_async(dst + r * SROW + kk, src, W * sizeof(float), ok ? 0 : W * sizeof(float));
  }
}

template <class C, bool VEC>
__global__ void __launch_bounds__(C::THREADS, C::MINB) knn2_kernel(
    const float* __restrict__ q, const float* __restrict__ t, int Q, int T, int D, int span,
    unsigned* __restrict__ tickets, float* __restrict__ part, float* __restrict__ dist,
    int* __restrict__ idx_out) {
  constexpr int TQ = C::TQ, TT = C::TT, RI = C::RI, RJ = C::RJ, JB = C::JB, TY = C::TY, NT = C::THREADS;
  constexpr int DK = C::DK, SROW = C::SROW, STAGES = C::STAGES;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float qn_s[TQ], tn_s[TT];
  __shared__ bool last;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int q0 = blockIdx.x * TQ;
  const int t_begin = blockIdx.y * span, t_end = min(T, t_begin + span);
  const int n_k = (D + DK - 1) / DK;
  const int total = (t_end - t_begin + TT - 1) / TT * n_k;  // chunks of this block

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) stage<C, VEC>(smem, s, n_k, q, t, Q, D, q0, t_begin, t_end);
    __pipeline_commit();
  }

  float acc[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) acc[i][j] = 0.f;
  Top2 run[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) run[i] = Top2{INFINITY, INFINITY, INT_MAX};
  // threads 0..TT-1 take the norm of one train row of each tile; the next TQ
  // threads that of one query row, on the first tile
  float nrm = 0.f;

  for (int c = 0; c < total; ++c) {
    __pipeline_wait_prior(STAGES - 2);  // this thread's copies of chunk c have landed
    __syncthreads();                    // everyone's have, and chunk c - 1 is consumed
    if (c + STAGES - 1 < total) stage<C, VEC>(smem, c + STAGES - 1, n_k, q, t, Q, D, q0, t_begin, t_end);
    __pipeline_commit();  // an empty group past the last chunk keeps the count
    const float* As = smem + (c % STAGES) * C::STAGE_FLOATS;
    const float* Bs = As + TQ * SROW;
    const int kc = c % n_k;

    const bool tn_thread = tid < TT;
    const bool qn_thread = !tn_thread && tid < TT + TQ && c < n_k;
    if (tn_thread || qn_thread) {
      const float* row = tn_thread ? Bs + tid * SROW : As + (tid - TT) * SROW;
      if (tn_thread && kc == 0) nrm = 0.f;
#pragma unroll
      for (int k = 0; k < DK; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + k);
        nrm = fmaf(v.x, v.x, nrm);
        nrm = fmaf(v.y, v.y, nrm);
        nrm = fmaf(v.z, v.z, nrm);
        nrm = fmaf(v.w, v.w, nrm);
      }
    }

#pragma unroll
    for (int k = 0; k < DK; k += 4) {
#pragma unroll
      for (int j0 = 0; j0 < RJ; j0 += JB) {
        float4 b[JB];
#pragma unroll
        for (int j = 0; j < JB; ++j) b[j] = *reinterpret_cast<const float4*>(Bs + (tx + TX * (j0 + j)) * SROW + k);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(As + (ty + TY * i) * SROW + k);
#pragma unroll
          for (int j = 0; j < JB; ++j) {
            float& s = acc[i][j0 + j];
            s = fmaf(a.x, b[j].x, s);
            s = fmaf(a.y, b[j].y, s);
            s = fmaf(a.z, b[j].z, s);
            s = fmaf(a.w, b[j].w, s);
          }
        }
      }
    }

    if (kc == n_k - 1) {  // the tile's dot products are complete
      if (tn_thread) tn_s[tid] = nrm;
      if (qn_thread) qn_s[tid - TT] = nrm;
      __syncthreads();
      const int t0 = t_begin + (c / n_k) * TT;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int col = t0 + tx + TX * j;  // increasing in j
        if (col < t_end) {
          const float tnc = tn_s[tx + TX * j];
#pragma unroll
          for (int i = 0; i < RI; ++i) push(run[i], (qn_s[ty + TY * i] + tnc) - 2.f * acc[i][j], col);
        }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) acc[i][j] = 0.f;
    }
  }

  // merge across the 16 threads (tx) that share each row
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int o = TX / 2; o > 0; o >>= 1) {
      Top2 other;
      other.best = __shfl_xor_sync(FULL, run[i].best, o);
      other.second = __shfl_xor_sync(FULL, run[i].second, o);
      other.idx = __shfl_xor_sync(FULL, run[i].idx, o);
      run[i] = merge(run[i], other);
    }
  }

  const int n_split = gridDim.y;
  const size_t P = (size_t)n_split * Q;  // partials: best [0, P), second [P, 2P), idx bits [2P, 3P)
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + TY * i;
      if (row >= Q) continue;
      if (n_split == 1) {
        dist[2 * (size_t)row] = run[i].best;
        dist[2 * (size_t)row + 1] = run[i].second;
        idx_out[row] = run[i].idx == INT_MAX ? 0 : run[i].idx;
      } else {
        const size_t p = (size_t)blockIdx.y * Q + row;
        part[p] = run[i].best;
        part[P + p] = run[i].second;
        part[2 * P + p] = __int_as_float(run[i].idx);
      }
    }
  }
  if (n_split == 1) return;
  __syncthreads();  // the block's partials are written; thread 0 fences them before its ticket
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(tickets + blockIdx.x, 1u) == (unsigned)n_split - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int r = tid; r < TQ; r += NT) {
    const int row = q0 + r;
    if (row >= Q) continue;
    Top2 m{INFINITY, INFINITY, INT_MAX};
    for (int s = 0; s < n_split; ++s) {  // span order
      const size_t p = (size_t)s * Q + row;
      m = merge(m, Top2{__ldcg(part + p), __ldcg(part + P + p), __float_as_int(__ldcg(part + 2 * P + p))});
    }
    dist[2 * (size_t)row] = m.best;
    dist[2 * (size_t)row + 1] = m.second;
    idx_out[row] = m.idx == INT_MAX ? 0 : m.idx;
  }
  if (tid == 0) tickets[blockIdx.x] = 0u;  // the next launch on this stream starts from 0
}

template <class C, bool VEC>
int launch(const float* q, const float* t, int Q, int T, int D, int span, unsigned* tickets, float* part,
           float* dist, int* idx, cudaStream_t stream) {
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || !attr_set[dev]) {
    err = cudaFuncSetAttribute(knn2_kernel<C, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) attr_set[dev] = true;
  }
  const dim3 grid((Q + C::TQ - 1) / C::TQ, (T + span - 1) / span);
  knn2_kernel<C, VEC><<<grid, C::THREADS, C::SMEM, stream>>>(q, t, Q, T, D, span, tickets, part, dist, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// large: 1 for the Large tile, 0 for Small; span: train rows a block, a
// multiple of the tile's train rows; tickets: one unsigned int per query
// tile, 0 between launches; part: 3 * ceil(T / span) * Q floats
extern "C" int knn2_f32(const float* q, const float* t, int Q, int T, int D, int large, int span,
                        unsigned* tickets, float* part, float* dist, int* idx, cudaStream_t stream) {
  const int tt = large ? Large::TT : Small::TT;
  if (Q <= 0 || T <= 0 || D <= 0 || span <= 0 || span % tt != 0) return (int)cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 && ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(t)) % 16 == 0);
  if (large) {
    return vec ? launch<Large, true>(q, t, Q, T, D, span, tickets, part, dist, idx, stream)
               : launch<Large, false>(q, t, Q, T, D, span, tickets, part, dist, idx, stream);
  }
  return vec ? launch<Small, true>(q, t, Q, T, D, span, tickets, part, dist, idx, stream)
             : launch<Small, false>(q, t, Q, T, D, span, tickets, part, dist, idx, stream);
}
