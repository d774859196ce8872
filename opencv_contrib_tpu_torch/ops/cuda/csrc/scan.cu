// Inclusive prefix sums for summed-area tables (f32).
//
// Replaces opencv_contrib_tpu/ops/pallas/grid.py::integral_image (row-scan
// body _scan_rows_kernel) and ops/pallas/pipeline.py::grid_scan.
//
// Bound: bytes. A scan reads each input once and writes each output once;
// it does one add per element, far below the card's arithmetic rate.
//
// The TPU kernels walked column tiles in grid order and carried the running
// row total in scratch memory from one grid step to the next. Blocks on
// Hopper run in no order, so the carry lives in registers instead.
//
// grid_scan: scan_rows_kernel, one warp a row, a grid that covers the card
// (ops/cuda/scan.py::scan_plan: as many SMs as the rows allow; CLAHE's 64
// rows of 256 bins are 64 blocks of one warp). Each lane holds a run of RUN
// consecutive elements of the row in registers (RUN = 4, 8, 16 or 32, the
// shortest that covers the row in one pass of 32 RUN; past 1,024 columns,
// passes of 1,024 with the row total carried in a register). The warp loads
// a pass coalesced, float4s where the row is 16-byte aligned and W % 4 == 0,
// else one float a lane, every load in flight, into a staging row in shared
// memory; each lane takes its run from there, scans it serially, the warp
// joins the 32 run totals in one 5-step shuffle scan, each lane adds its
// exclusive prefix and puts the run back, and the warp stores the pass
// coalesced. (Runs loaded and stored straight from device memory, 16 bytes
// at a time at a stride of the run, took 2.93 us at 480x640 against the
// chunked scan_row's 2.27.) The order of every sum is fixed by W, through
// RUN: a rerun gives the same bits.
//
// scan_row (integral_kernel): one warp scans one row. Each lane takes 4
// consecutive elements of each chunk of 128 (one 16-byte load when the row
// allows it) and scans them serially, the warp scans the 32 lane totals with
// shuffles, and the running row total is carried in a register from chunk to
// chunk; up to 8 chunks are loaded and scanned side by side. Where the output
// row is not 16-byte aligned (the padded table's pitch W + 1), the lanes
// trade values by shuffles so that each store of the warp is one run of 32
// consecutive floats.
//
// integral_image: integral_kernel, one launch. The table is cut into slabs
// of R rows by Cw <= 1024 columns (one slab across at VGA), nb bands of nc
// slabs, numbered row-major, which blocks take in the order of an atomic
// ticket, so every slab above and to the left of a block's has started and
// its waits below end. (Slabs dealt by block index, one each or a fixed
// round each, were far slower at VGA: a block that starts late then holds up
// every slab after it.)
// For each slab:
//   1. each thread loads 4 columns of every row of the slab (BATCH loads in
//      flight), takes their in-band column prefix in registers, keeps it in
//      shared memory and publishes the slab's column totals (a fence, then
//      its status word set to the launch's epoch);
//   2. once the slabs above it have published, the block forms E, the sum
//      of their totals: in groups of BATCH bands, each group summed in band
//      order by a thread of its own (all of its loads in flight), then the
//      group sums added in group order;
//   3. one warp a row scans E + the in-band column prefix (scan_row), into
//      the table where the slab is the first across, else in shared memory,
//      and publishes the row's total for the slabs to its right;
//   4. once the slabs to its left have published, each row adds their row
//      totals, in slab order, and the block writes its part of the table.
// The order of every sum is fixed by (H, W), through (R, Cw): the table does
// not depend on block order or timing. Slab width caps the shared memory, so
// R stays near H / 48 at any width and no slab reads more than about 48
// slabs' totals. Columns first, as the JAX package's integral sums: a slab
// publishes its column totals right after its loads (PERF.md lists the
// slower designs tried). A status holds the launch's epoch and the ticket
// counts on from the last launch's (the wrapper passes both), so no block
// has to set them back. With `pad` the kernel writes the zero-padded (H + 1,
// W + 1) table of ops/integral.py::integral itself, its zero row and column
// included.
//
// A batch of N tables of one (H, W) (MIL's and Boosting's 32 x 32 patches,
// tracking/mil.py) is one launch: the tickets run table-major, ticket
// t n + s being slab s of table t (n = nb nc slabs a table), so every slab
// a block waits on holds a lower ticket of its own table and has started.
// Each table has its own statuses and totals and the slabs of (H, W): its
// bits equal those of a launch on that table alone. Such small tables take
// integral_table_kernel instead, one block a table with its bands in shared
// memory: the same sums in the same order, without tickets or waits (a
// batch of 337 tables of 32 x 32 on the slabs was 1,348 blocks, four bands
// a table each waiting on the band above).

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int INTEGRAL_THREADS = 512;  // 16 warps: one row each of a band of up to 16 (256 and 1024: slower)
constexpr int BATCH = 16;              // rows, or earlier bands' totals, in flight a thread
constexpr int GROUPS = 4;              // groups of BATCH earlier bands summed at a time
constexpr int MAX_COLS = 1024;         // columns a slab: ops/cuda/scan.py _COLS
constexpr int MAX_DEVICES = 64;
constexpr int MAX_SMEM = 200 * 1024;  // ops/cuda/scan.py _SMEM_MAX
constexpr int SCAN_WARPS = 8;         // grid_scan: at most this many warps (rows) a block, ops/cuda/scan.py _SCAN_WARPS
constexpr int TABLE_THREADS = 256;    // integral_table_kernel: 8 warps, one row each at a time
constexpr int TABLE_BLOCKS = 4;       // integral_table_kernel: blocks an SM at least (64 registers a thread)
constexpr int TABLE_BATCH = 8;        // integral_table_kernel: rows' loads in flight a thread
constexpr int TABLE_SMEM = 48 * 1024; // integral_table_kernel's shared memory at most: ops/cuda/scan.py _TABLE_SMEM

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// 4 consecutive elements of a row from global memory; zeros past W
struct GlobalRow {
  const float* p;
  int W;
  bool vec;  // W % 4 == 0 and p 16-byte aligned
  __device__ __forceinline__ void operator()(int i0, float* v) const {
    if (vec && i0 + 3 < W) {
      const float4 a = *reinterpret_cast<const float4*>(p + i0);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = (i0 + k < W) ? p[i0 + k] : 0.f;
    }
  }
};

// 4 consecutive elements of the band's column prefix row plus E_b, from
// shared memory (rows padded to a multiple of 4 floats, 16-byte aligned);
// zeros past W
struct BandRow {
  const float* row;
  const float* excl;  // nullptr for band 0
  int W;
  __device__ __forceinline__ void operator()(int i0, float* v) const {
    if (i0 + 3 < W) {
      float4 a = *reinterpret_cast<const float4*>(row + i0);
      if (excl) a = add4(*reinterpret_cast<const float4*>(excl + i0), a);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = (i0 + k < W) ? (excl ? excl[i0 + k] + row[i0 + k] : row[i0 + k]) : 0.f;
    }
  }
};

// inclusive scan of one row of W elements (4 at a time from `load`) into
// y, by one warp, which returns the row's total; vec: W % 4 == 0 and y
// 16-byte aligned; y may be the row that `load` reads. The chunks of 128
// of a pass are loaded and scanned side by side (their shuffle chains
// overlap); only the carry from chunk to chunk is serial, added in chunk
// order as a walk of one chunk at a time would add it, so the sums do not
// depend on C, the chunks of 128 a pass.
template <int C = 8, class Load>
__device__ __forceinline__ float scan_row(const Load& load, float* y, int W, bool vec, int lane) {
  float carry = 0.f;
  for (int base = 0; base < W; base += 128 * C) {
    float v[C][4], s[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (base + c * 128 < W) load(base + c * 128 + lane * 4, v[c]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (base + c * 128 >= W) break;
      v[c][1] += v[c][0];
      v[c][2] += v[c][1];
      v[c][3] += v[c][2];
      s[c] = v[c][3];
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // inclusive warp scans of the lane totals
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (base + c * 128 >= W) break;
        const float n = __shfl_up_sync(FULL, s[c], o);
        if (lane >= o) s[c] += n;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (base + c * 128 >= W) break;
      const int i0 = base + c * 128 + lane * 4;
      float excl = __shfl_up_sync(FULL, s[c], 1);
      if (lane == 0) excl = 0.f;
      excl += carry;
      const float o0 = v[c][0] + excl, o1 = v[c][1] + excl, o2 = v[c][2] + excl, o3 = v[c][3] + excl;
      if (vec && i0 + 3 < W) {
        *reinterpret_cast<float4*>(y + i0) = make_float4(o0, o1, o2, o3);
      } else if (vec) {
        const float o[4] = {o0, o1, o2, o3};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (i0 + k < W) y[i0 + k] = o[k];
      } else {  // lane l stores elements 32 k + l of the chunk, held by lane 8 k + l / 4: coalesced
        const int m = lane & 3;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int src = 8 * k + (lane >> 2), e = base + c * 128 + 32 * k + lane;
          const float a0 = __shfl_sync(FULL, o0, src), a1 = __shfl_sync(FULL, o1, src);
          const float a2 = __shfl_sync(FULL, o2, src), a3 = __shfl_sync(FULL, o3, src);
          if (e < W) y[e] = m == 0 ? a0 : m == 1 ? a1 : m == 2 ? a2 : a3;
        }
      }
      carry += __shfl_sync(FULL, s[c], 31);
    }
  }
  return carry;
}

// grid_scan's staging rows: float4 p of a warp's row sits in slot p ^ (p / 8
// % 8), so that neither 8 lanes' consecutive float4s (a coalesced load or
// store) nor 8 lanes' runs of 1, 2, 4 or 8 float4s, nor 32 lanes' consecutive
// floats, meet in a bank
__device__ __forceinline__ int swz(int p) { return p ^ ((p >> 3) & 7); }

// grid_scan: row blockIdx.x * warps + warp of x (H, W) into y, through the
// warp's staging row of 32 RUN floats. VEC: W % 4 == 0 and both rows 16-byte
// aligned.
template <int RUN, bool VEC>
__global__ void __launch_bounds__(SCAN_WARPS * 32) scan_rows_kernel(
    const float* __restrict__ x, float* __restrict__ y, int H, int W) {
  constexpr int SPAN = 32 * RUN, R4 = RUN / 4;
  extern __shared__ float4 stage4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= H) return;  // whole warp leaves together
  const float* xr = x + (size_t)row * W;
  float* yr = y + (size_t)row * W;
  float4* st = stage4 + warp * (SPAN / 4);
  float* stf = reinterpret_cast<float*>(st);
  float carry = 0.f;
  for (int base = 0; base < W; base += SPAN) {
    // the pass, loaded coalesced (every load in flight) into the staging row
    if (VEC) {
      float4 a[R4];
#pragma unroll
      for (int k = 0; k < R4; ++k) {
        const int i = base + 4 * (32 * k + lane);
        a[k] = i < W ? __ldg(reinterpret_cast<const float4*>(xr + i)) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < R4; ++k) st[swz(32 * k + lane)] = a[k];
    } else {
      float a[RUN];
#pragma unroll
      for (int k = 0; k < RUN; ++k) a[k] = base + 32 * k + lane < W ? __ldg(xr + base + 32 * k + lane) : 0.f;
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        const int e = 32 * k + lane;
        stf[4 * swz(e >> 2) + (e & 3)] = a[k];
      }
    }
    __syncwarp();
    // the lane's run: a serial scan, then one warp scan of the run totals
    float v[RUN];
#pragma unroll
    for (int j = 0; j < R4; ++j) {
      const float4 b = st[swz(lane * R4 + j)];
      v[4 * j] = b.x; v[4 * j + 1] = b.y; v[4 * j + 2] = b.z; v[4 * j + 3] = b.w;
    }
#pragma unroll
    for (int k = 1; k < RUN; ++k) v[k] += v[k - 1];
    float s = v[RUN - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // inclusive warp scan of the run totals
      const float n = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += n;
    }
    float excl = __shfl_up_sync(FULL, s, 1);
    if (lane == 0) excl = 0.f;
    excl += carry;
    carry += __shfl_sync(FULL, s, 31);
#pragma unroll
    for (int j = 0; j < R4; ++j)  // back into the lane's own slots
      st[swz(lane * R4 + j)] = make_float4(v[4 * j] + excl, v[4 * j + 1] + excl, v[4 * j + 2] + excl,
                                           v[4 * j + 3] + excl);
    __syncwarp();
    // the pass stored coalesced
    if (VEC) {
#pragma unroll
      for (int k = 0; k < R4; ++k) {
        const int i = base + 4 * (32 * k + lane);
        if (i < W) *reinterpret_cast<float4*>(yr + i) = st[swz(32 * k + lane)];
      }
    } else {
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        const int e = 32 * k + lane;
        if (base + e < W) yr[base + e] = stf[4 * swz(e >> 2) + (e & 3)];
      }
    }
    __syncwarp();  // before the next pass stages its loads
  }
}

template <int RUN>
void launch_scan_rows(const float* x, float* y, int H, int W, int warps, bool vec, cudaStream_t stream) {
  const int blocks = (H + warps - 1) / warps;
  const size_t smem = (size_t)warps * 32 * RUN * sizeof(float);
  if (vec)
    scan_rows_kernel<RUN, true><<<blocks, warps * 32, smem, stream>>>(x, y, H, W);
  else
    scan_rows_kernel<RUN, false><<<blocks, warps * 32, smem, stream>>>(x, y, H, W);
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// spin until *p == epoch. The wait ends (see integral_kernel); one that
// outlasts any launch by far traps, so a fault shows as a launch error
// instead of a hung card.
__device__ __forceinline__ void wait_for(const unsigned* p, unsigned epoch) {
  for (unsigned n = 0; load_acquire(p) != epoch; ++n)
    if (n == (1u << 24)) __trap();
}

// ctrl: [0] the slab ticket (base on entry), then the statuses of the
// gridDim.x slabs' column totals, then of their row totals (epoch once
// out); slab s = b * nc + c is band b, columns [c * Cw, c * Cw + Cw). tot:
// nb rows of nc * Cw floats, the slabs' column totals; rtot: a row of R
// floats a slab, its row totals. Shared memory: the slab's R rows of Cw, E,
// GROUPS rows of group sums, and the R row carries. ONE: one slab across
// (nc == 1), compiled without the row totals and carries.
template <bool ONE>
__global__ void __launch_bounds__(INTEGRAL_THREADS) integral_kernel(
    const float* __restrict__ x, int H, int W, int R, int Cw, int nc, int n, bool vec_in, float* __restrict__ out,
    int pitch, int pad, bool vec_out, unsigned* __restrict__ ctrl, unsigned base, unsigned epoch,
    float* __restrict__ tot, float* __restrict__ rtot) {
  constexpr int NT = INTEGRAL_THREADS, NW = NT / 32;
  extern __shared__ float4 smem4[];
  float* band_s = reinterpret_cast<float*>(smem4);
  float* excl_s = band_s + (size_t)R * Cw;
  float* carry_s = excl_s + (size_t)(1 + GROUPS) * Cw;
  __shared__ int s_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_s = (int)(atomicAdd(ctrl, 1u) - base);
  __syncthreads();
  const int t = s_s / n, s = s_s - t * n, b = ONE ? s : s / nc, c = ONE ? 0 : s - b * nc;
  const int r0 = b * R, rows = min(R, H - r0), c0 = c * Cw, cols = min(Cw, W - c0);
  const int Wt = nc * Cw, W4 = Cw / 4;
  // table t: its input, output, statuses and totals
  x += (size_t)t * H * W;
  out += (size_t)t * (H + pad) * pitch;
  unsigned* cstatus = ctrl + 1 + (size_t)t * n;
  unsigned* rstatus = ctrl + 1 + (size_t)gridDim.x + (size_t)t * n;
  tot += (size_t)t * n * Cw;
  rtot += (size_t)t * n * R;
  const float* xs = x + c0;

  // 1. in-band column prefix, 4 columns a thread, BATCH rows' loads in flight
  for (int j = tid * 4; j < cols; j += NT * 4) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r1 = 0; r1 < rows; r1 += BATCH) {
      float v[BATCH][4];
#pragma unroll
      for (int k = 0; k < BATCH; ++k)
        if (r1 + k < rows) GlobalRow{xs + (size_t)(r0 + r1 + k) * W, cols, vec_in}(j, v[k]);
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        if (r1 + k >= rows) break;
        const float4 a = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
        acc = r1 + k == 0 ? a : add4(acc, a);
        *reinterpret_cast<float4*>(band_s + (size_t)(r1 + k) * Cw + j) = acc;
      }
    }
    *reinterpret_cast<float4*>(tot + (size_t)b * Wt + c0 + j) = acc;
  }
  __syncthreads();  // every thread's totals are written; thread 0 fences them and publishes
  if (tid == 0) {
    __threadfence();
    atomicExch(cstatus + s, epoch);
  }

  // 2. E: the totals of the slabs above in groups of BATCH bands, each
  // group summed in band order by a thread of its own (4 columns, all of
  // the group's loads in flight), then the groups added in order, GROUPS of
  // them at a time
  if (b > 0) {
    for (int i = tid; i < b; i += NT) wait_for(cstatus + i * nc + c, epoch);
    __syncthreads();
    const int G = (b + BATCH - 1) / BATCH, C4 = (cols + 3) / 4;
    float4* excl4 = reinterpret_cast<float4*>(excl_s);
    float4* part4 = excl4 + W4;  // GROUPS rows of group sums
    for (int g0 = 0; g0 < G; g0 += GROUPS) {
      const int ng = min(GROUPS, G - g0);
      for (int e = tid; e < ng * C4; e += NT) {
        const int grp = e / C4, q = e - grp * C4, i0 = (g0 + grp) * BATCH;
        const float* t = tot + c0 + q * 4;
        float4 v[BATCH];
#pragma unroll
        for (int k = 0; k < BATCH; ++k)
          if (i0 + k < b) v[k] = __ldcg(reinterpret_cast<const float4*>(t + (size_t)(i0 + k) * Wt));
        float4 p = v[0];
#pragma unroll
        for (int k = 1; k < BATCH; ++k)
          if (i0 + k < b) p = add4(p, v[k]);
        part4[grp * W4 + q] = p;
      }
      __syncthreads();
      for (int q = tid; q < C4; q += NT) {
        float4 p = g0 == 0 ? part4[q] : add4(excl4[q], part4[q]);
        for (int grp = 1; grp < ng; ++grp) p = add4(p, part4[grp * W4 + q]);
        excl4[q] = p;
      }
      __syncthreads();
    }
  }

  // 3. the slab's rows scanned, one warp a row: into the table where no
  // carry comes from the left (c == 0), else in place; the row totals out
  // for the slabs to the right
  float* o = out + (size_t)(r0 + pad) * pitch + pad + c0;
  for (int r = warp; r < rows; r += NW) {
    float* row = band_s + (size_t)r * Cw;
    const float t = scan_row(BandRow{row, b == 0 ? nullptr : excl_s, cols}, c == 0 ? o + (size_t)r * pitch : row,
                             cols, c == 0 ? vec_out : true, lane);
    if (!ONE && lane == 0 && c + 1 < nc) rtot[(size_t)s * R + r] = t;
  }

  // 4. each row's carry, the row totals of the slabs to the left added in
  // slab order; then the slab's part of the table
  if (!ONE) {
    __syncthreads();
    if (tid == 0 && c + 1 < nc) {
      __threadfence();
      atomicExch(rstatus + s, epoch);
    }
    if (c > 0) {
      for (int i = tid; i < c; i += NT) wait_for(rstatus + s - c + i, epoch);
      __syncthreads();
      for (int r = tid; r < rows; r += NT) {
        const float* t = rtot + (size_t)(s - c) * R + r;
        float a = __ldcg(t);
        for (int i = 1; i < c; ++i) a += __ldcg(t + (size_t)i * R);
        carry_s[r] = a;
      }
      __syncthreads();
      for (int r = warp; r < rows; r += NW) {
        const float* row = band_s + (size_t)r * Cw;
        float* y = o + (size_t)r * pitch;
        const float a = carry_s[r];
        if (vec_out) {  // cols % 4 == 0
          for (int i = lane * 4; i < cols; i += 128) {
            const float4 v = *reinterpret_cast<const float4*>(row + i);
            *reinterpret_cast<float4*>(y + i) = make_float4(v.x + a, v.y + a, v.z + a, v.w + a);
          }
        } else {
          for (int i = lane; i < cols; i += 32) y[i] = row[i] + a;
        }
      }
    }
  }
  if (pad) {
    if (c == 0)
      for (int r = tid; r < rows; r += NT) out[(size_t)(r0 + r + 1) * pitch] = 0.f;
    if (b == 0)
      for (int j = tid; j < cols; j += NT) out[c0 + 1 + j] = 0.f;
    if (s == 0 && tid == 0) out[0] = 0.f;
  }
}

// integral_table_kernel: one block a table, for tables one slab across
// (nc == 1) whose R-row bands' column prefixes, their totals and each
// band's E fit in TABLE_SMEM. The same sums in the same order as
// integral_kernel on the slabs of (H, W): each band's column prefix in
// registers (step 1), E of band b as the totals of the bands above summed
// in groups of BATCH, the groups then added in order (step 2), and one warp
// a row scanning E + the prefix with scan_row (step 3); so its bits equal
// integral_kernel's. No tickets, no waits: the bands of a table are the
// block's own. Shared memory: the H rows of prefixes, nb rows of band
// totals and nb rows of E, Cw floats each.
__global__ void __launch_bounds__(TABLE_THREADS, TABLE_BLOCKS) integral_table_kernel(
    const float* __restrict__ x, int H, int W, int R, int Cw, bool vec_in, float* __restrict__ out, int pitch,
    int pad, bool vec_out) {
  constexpr int NW = TABLE_THREADS / 32;
  extern __shared__ float4 smem4[];
  const int nb = (H + R - 1) / R, C4 = (W + 3) / 4;
  float* band_s = reinterpret_cast<float*>(smem4);
  float* tot_s = band_s + (size_t)H * Cw;
  float* excl_s = tot_s + (size_t)nb * Cw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  x += (size_t)blockIdx.x * H * W;
  out += (size_t)blockIdx.x * (H + pad) * pitch;

  // 1. each band's in-band column prefix, 4 columns a thread, TABLE_BATCH
  // rows' loads in flight (the sums run row by row whatever the batch)
  for (int e = tid; e < nb * C4; e += TABLE_THREADS) {
    const int b = e / C4, j = (e - b * C4) * 4, r0 = b * R, rows = min(R, H - r0);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r1 = 0; r1 < rows; r1 += TABLE_BATCH) {
      float v[TABLE_BATCH][4];
#pragma unroll
      for (int k = 0; k < TABLE_BATCH; ++k)
        if (r1 + k < rows) GlobalRow{x + (size_t)(r0 + r1 + k) * W, W, vec_in}(j, v[k]);
#pragma unroll
      for (int k = 0; k < TABLE_BATCH; ++k) {
        if (r1 + k >= rows) break;
        const float4 a = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
        acc = r1 + k == 0 ? a : add4(acc, a);
        *reinterpret_cast<float4*>(band_s + (size_t)(r0 + r1 + k) * Cw + j) = acc;
      }
    }
    *reinterpret_cast<float4*>(tot_s + (size_t)b * Cw + j) = acc;
  }
  __syncthreads();

  // 2. E of each band b > 0: each group of BATCH bands above summed in band
  // order, the group sums added in group order
  for (int e = tid; e < (nb - 1) * C4; e += TABLE_THREADS) {
    const int b = 1 + e / C4, j = (e - (b - 1) * C4) * 4;
    float4 E = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < b; i0 += BATCH) {
      float4 p = *reinterpret_cast<const float4*>(tot_s + (size_t)i0 * Cw + j);
      for (int k = 1; k < BATCH && i0 + k < b; ++k)
        p = add4(p, *reinterpret_cast<const float4*>(tot_s + (size_t)(i0 + k) * Cw + j));
      E = i0 == 0 ? p : add4(E, p);
    }
    *reinterpret_cast<float4*>(excl_s + (size_t)b * Cw + j) = E;
  }
  __syncthreads();

  // 3. the rows scanned, one warp a row, a chunk of 128 at a time, into the table
  float* o = out + (size_t)pad * pitch + pad;
  for (int r = warp; r < H; r += NW) {
    const int b = r / R;
    scan_row<1>(BandRow{band_s + (size_t)r * Cw, b == 0 ? nullptr : excl_s + (size_t)b * Cw, W}, o + (size_t)r * pitch,
             W, vec_out, lane);
  }
  if (pad) {
    for (int r = tid; r < H; r += TABLE_THREADS) out[(size_t)(r + 1) * pitch] = 0.f;
    for (int j = tid; j <= W; j += TABLE_THREADS) out[j] = 0.f;
  }
}

}  // namespace

// x, y (H, W) contiguous; `warps` rows a block (at most SCAN_WARPS), runs
// of `run` floats a lane (4, 8, 16 or 32): ops/cuda/scan.py::scan_plan
extern "C" int scan_rows_f32(const float* x, float* y, int H, int W, int warps, int run, cudaStream_t stream) {
  if (H <= 0 || W <= 0 || warps < 1 || warps > SCAN_WARPS) return (int)cudaErrorInvalidValue;
  const bool vec = (W % 4 == 0) && ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(y)) % 16 == 0);
  switch (run) {
    case 4: launch_scan_rows<4>(x, y, H, W, warps, vec, stream); break;
    case 8: launch_scan_rows<8>(x, y, H, W, warps, vec, stream); break;
    case 16: launch_scan_rows<16>(x, y, H, W, warps, vec, stream); break;
    case 32: launch_scan_rows<32>(x, y, H, W, warps, vec, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x (N, H, W) contiguous; element (i, j) of table t goes to
// out[t (H + pad) pitch + (i + pad) * pitch + j + pad], and with pad = 1
// row 0 and column 0 of each table are zeros; slabs of R rows by Cw columns
// (Cw % 4 == 0), nb = ceil(H / R) bands of nc = ceil(W / Cw) a table; ctrl:
// 1 + 2 N nb nc unsigned ints, ctrl[0] == base and no status equal to epoch
// on entry (the wrapper counts both on: base += N nb nc, epoch += 1 a
// launch); tot: N nb nc Cw floats; rtot: N nb nc R floats
extern "C" int integral_f32(const float* x, float* out, int N, int H, int W, int pitch, int pad, int R, int Cw,
                            unsigned* ctrl, unsigned base, unsigned epoch, float* tot, float* rtot,
                            cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0 || R <= 0 || Cw <= 0 || Cw % 4 || Cw > MAX_COLS || pitch < W + pad || epoch == 0)
    return (int)cudaErrorInvalidValue;
  const int nb = (H + R - 1) / R, nc = (W + Cw - 1) / Cw;
  const size_t smem = (((size_t)R + 1 + GROUPS) * Cw + R) * sizeof(float);
  if (smem > (size_t)MAX_SMEM || (size_t)N * nb * nc > 0x7fffffff / 2) return (int)cudaErrorInvalidValue;
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || !attr_set[dev]) {
    err = cudaFuncSetAttribute(integral_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(integral_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) attr_set[dev] = true;
  }
  // W % 4 == 0 keeps every table's rows 16-byte aligned where the first table's are
  const bool vec_in = (W % 4 == 0) && (reinterpret_cast<size_t>(x) % 16 == 0);
  const float* row0 = out + (size_t)pad * pitch + pad;
  const bool vec_out = (W % 4 == 0) && (pitch % 4 == 0) && (reinterpret_cast<size_t>(row0) % 16 == 0);
  const auto kernel = nc == 1 ? integral_kernel<true> : integral_kernel<false>;
  kernel<<<N * nb * nc, INTEGRAL_THREADS, smem, stream>>>(x, H, W, R, Cw, nc, nb * nc, vec_in, out, pitch, pad,
                                                          vec_out, ctrl, base, epoch, tot, rtot);
  return (int)cudaGetLastError();
}

// the same tables as integral_f32 on slabs of R rows by Cw columns, one
// block a table: W <= Cw (one slab across) and (H + 2 ceil(H / R)) Cw floats
// within TABLE_SMEM (ops/cuda/scan.py::one_block)
extern "C" int integral_table_f32(const float* x, float* out, int N, int H, int W, int pitch, int pad, int R, int Cw,
                                  cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0 || R <= 0 || Cw % 4 || W > Cw || pitch < W + pad) return (int)cudaErrorInvalidValue;
  const int nb = (H + R - 1) / R;
  const size_t smem = ((size_t)H + 2 * nb) * Cw * sizeof(float);
  if (smem > (size_t)TABLE_SMEM) return (int)cudaErrorInvalidValue;
  const bool vec_in = (W % 4 == 0) && (reinterpret_cast<size_t>(x) % 16 == 0);
  const float* row0 = out + (size_t)pad * pitch + pad;
  const bool vec_out = (W % 4 == 0) && (pitch % 4 == 0) && (reinterpret_cast<size_t>(row0) % 16 == 0);
  integral_table_kernel<<<N, TABLE_THREADS, smem, stream>>>(x, H, W, R, Cw, vec_in, out, pitch, pad, vec_out);
  return (int)cudaGetLastError();
}
