// The elementwise maps of the photometric / image-quality path, shared by
// transform.cu (grid_transform, streamed_transform) and reduce.cu
// (grid_reduce).
//
// A CUDA kernel cannot take a Python callable, so each map the path uses is a
// functor here, picked by its number (MAP_* below, mirrored by
// ops/cuda/transform.py MAP_CODES) in a host-side switch that instantiates
// the kernels for these maps and no others. Each functor has N inputs and
// maps the N values of one element to one float. The multi-output sum
// groups of grid_reduce_sums (GROUP_* below, mirrored by GROUP_CODES) call
// these functors, one per output.
//
// Bits: nvcc contracts a * b + c into an FMA by default, which rounds once
// where PyTorch's separate kernels round twice. Every product, sum and
// quotient is therefore written with an explicitly rounded intrinsic, in the
// order of the plain PyTorch expression beside each functor in transform.py,
// so a kernel gives its plain version's bits. powf (the gamma map) is held to
// its plain version within 2 ulp. min, max and clamps propagate NaN, as
// torch.clamp, torch.amax and their JAX twins do.

#pragma once

#include <cuda_runtime.h>

namespace maps {

// transform maps
constexpr int MAP_GAMMA = 0;  // clamp(x, 0, 1) ** g
constexpr int MAP_GRAY = 1;  // r * 0.299 + g * 0.587 + b * 0.114
constexpr int MAP_GAIN = 2;  // clamp(x * gains[ch], 0, 1)
constexpr int MAP_SSIM = 3;  // the SSIM map of (mu_a, mu_b, blur(a a), blur(b b), blur(a b))
constexpr int MAP_GMS = 4;  // the gradient-magnitude similarity of (gax, gay, gbx, gby)
constexpr int MAP_MSCN = 5;  // (x - mu) / (sqrt(max(blur(x x) - mu mu, 0)) + 1)
constexpr int MAP_MUL = 6;  // a * b
// reduce maps
constexpr int MAP_IDENT = 7;  // x
constexpr int MAP_SQDIFF = 8;  // (a - b) ** 2
constexpr int MAP_SQ = 9;  // x * x
constexpr int MAP_ABS = 10;  // |x|
constexpr int MAP_NEG_SQ = 11;  // x * x where x < 0, else 0
constexpr int MAP_POS_SQ = 12;  // x * x where x > 0, else 0
constexpr int MAP_NEG = 13;  // 1 where x < 0, else 0
constexpr int MAP_POS = 14;  // 1 where x > 0, else 0
constexpr int MAP_GATED = 15;  // (r, g, b)[ch] * (max(r, g, b) < sat)
constexpr int MAP_GATED_COUNT = 16;  // 1 where max(r, g, b) < sat, else 0
constexpr int MAP_SQDEV = 17;  // (x - mean[0]) ** 2

// a strided 2D view of float32: element (i, j) at p[i * pitch + j * stride]
struct View {
  float* p;
  long long pitch, stride;
};

template <int N>
struct Views {
  View v[N];
};

__device__ __forceinline__ float nan_max(float a, float b) { return (b > a || b != b) ? b : a; }
__device__ __forceinline__ float nan_min(float a, float b) { return (b < a || b != b) ? b : a; }
__device__ __forceinline__ float clamp01(float x) { return x != x ? x : fminf(fmaxf(x, 0.f), 1.f); }

struct Gamma {
  static constexpr int N = 1;
  float g;
  __device__ float operator()(const float* v) const { return powf(clamp01(v[0]), g); }
};

struct Gray {
  static constexpr int N = 3;
  __device__ float operator()(const float* v) const {
    return __fadd_rn(__fadd_rn(__fmul_rn(v[0], 0.299f), __fmul_rn(v[1], 0.587f)), __fmul_rn(v[2], 0.114f));
  }
};

struct Gain {
  static constexpr int N = 1;
  const float* gains;  // (3,) on the device
  int ch;
  __device__ float operator()(const float* v) const { return clamp01(__fmul_rn(v[0], __ldg(gains + ch))); }
};

struct Ssim {
  static constexpr int N = 5;
  float c1, c2;
  __device__ float operator()(const float* v) const {
    const float ma = v[0], mb = v[1];
    const float aa = __fmul_rn(ma, ma), bb = __fmul_rn(mb, mb), ab = __fmul_rn(ma, mb);
    const float va = __fsub_rn(v[2], aa), vb = __fsub_rn(v[3], bb), cov = __fsub_rn(v[4], ab);
    const float num = __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(2.f, ma), mb), c1), __fadd_rn(__fmul_rn(2.f, cov), c2));
    const float den = __fmul_rn(__fadd_rn(__fadd_rn(aa, bb), c1), __fadd_rn(__fadd_rn(va, vb), c2));
    return __fdiv_rn(num, den);
  }
};

struct Gms {
  static constexpr int N = 4;
  float c;
  __device__ float operator()(const float* v) const {
    const float ma = __fsqrt_rn(__fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1])));
    const float mb = __fsqrt_rn(__fadd_rn(__fmul_rn(v[2], v[2]), __fmul_rn(v[3], v[3])));
    const float num = __fadd_rn(__fmul_rn(__fmul_rn(2.f, ma), mb), c);
    const float den = __fadd_rn(__fadd_rn(__fmul_rn(ma, ma), __fmul_rn(mb, mb)), c);
    return __fdiv_rn(num, den);
  }
};

struct Mscn {
  static constexpr int N = 3;
  __device__ float operator()(const float* v) const {
    const float var = __fsub_rn(v[2], __fmul_rn(v[1], v[1]));
    return __fdiv_rn(__fsub_rn(v[0], v[1]), __fadd_rn(__fsqrt_rn(nan_max(var, 0.f)), 1.f));
  }
};

struct Mul {
  static constexpr int N = 2;
  __device__ float operator()(const float* v) const { return __fmul_rn(v[0], v[1]); }
};

struct Ident {
  static constexpr int N = 1;
  __device__ float operator()(const float* v) const { return v[0]; }
};

struct SqDiff {
  static constexpr int N = 2;
  __device__ float operator()(const float* v) const {
    const float d = __fsub_rn(v[0], v[1]);
    return __fmul_rn(d, d);
  }
};

struct Sq {
  static constexpr int N = 1;
  __device__ float operator()(const float* v) const { return __fmul_rn(v[0], v[0]); }
};

struct Abs {
  static constexpr int N = 1;
  __device__ float operator()(const float* v) const { return fabsf(v[0]); }
};

template <bool NEG>
struct SideSq {
  static constexpr int N = 1;
  __device__ float operator()(const float* v) const {
    return (NEG ? v[0] < 0.f : v[0] > 0.f) ? __fmul_rn(v[0], v[0]) : 0.f;
  }
};

template <bool NEG>
struct SideCount {
  static constexpr int N = 1;
  __device__ float operator()(const float* v) const { return (NEG ? v[0] < 0.f : v[0] > 0.f) ? 1.f : 0.f; }
};

struct Gated {
  static constexpr int N = 3;
  float sat;
  int ch;
  // x * w with w = 1 or 0, as the plain version multiplies (NaN * 0 stays NaN)
  __device__ float operator()(const float* v) const {
    return __fmul_rn(v[ch], nan_max(nan_max(v[0], v[1]), v[2]) < sat ? 1.f : 0.f);
  }
};

struct GatedCount {
  static constexpr int N = 3;
  float sat;
  __device__ float operator()(const float* v) const {
    return nan_max(nan_max(v[0], v[1]), v[2]) < sat ? 1.f : 0.f;
  }
};

struct SqDev {
  static constexpr int N = 1;
  const float* mean;  // (1,) on the device
  __device__ float operator()(const float* v) const {
    const float d = __fsub_rn(v[0], __ldg(mean));
    return __fmul_rn(d, d);
  }
};

// Call f(functor) with the functor of `map`, built from the host parameters
// hp and the device parameters dp; return false for a number that is not a
// map of this kind. Transform kernels are instantiated for the transform
// maps only, reduce kernels for the reduce maps only.
template <class F>
bool dispatch_transform(int map, const float* hp, const float* dp, F&& f) {
  switch (map) {
    case MAP_GAMMA: f(Gamma{hp[0]}); return true;
    case MAP_GRAY: f(Gray{}); return true;
    case MAP_GAIN: f(Gain{dp, (int)hp[0]}); return true;
    case MAP_SSIM: f(Ssim{hp[0], hp[1]}); return true;
    case MAP_GMS: f(Gms{hp[0]}); return true;
    case MAP_MSCN: f(Mscn{}); return true;
    case MAP_MUL: f(Mul{}); return true;
    default: return false;
  }
}

template <class F>
bool dispatch_reduce(int map, const float* hp, const float* dp, F&& f) {
  switch (map) {
    case MAP_IDENT: f(Ident{}); return true;
    case MAP_SQDIFF: f(SqDiff{}); return true;
    case MAP_SQ: f(Sq{}); return true;
    case MAP_ABS: f(Abs{}); return true;
    case MAP_NEG_SQ: f(SideSq<true>{}); return true;
    case MAP_POS_SQ: f(SideSq<false>{}); return true;
    case MAP_NEG: f(SideCount<true>{}); return true;
    case MAP_POS: f(SideCount<false>{}); return true;
    case MAP_GATED: f(Gated{hp[0], (int)hp[1]}); return true;
    case MAP_GATED_COUNT: f(GatedCount{hp[0]}); return true;
    case MAP_SQDEV: f(SqDev{dp}); return true;
    default: return false;
  }
}

// ---- multi-output sum groups (grid_reduce_sums) ----------------------------
// K outputs of one pass over the same N inputs; output k is computed by its
// single map's functor, so a group's sums have the bits of K single calls.
// Only the groups the path uses are instantiated: BRISQUE's GGD and AGGD
// moments and grayworld's gated sums. Each comment lists the maps in output
// order, as the group's constructor in ops/cuda/transform.py (GROUPS) does.
constexpr int GROUP_GGD = 0;  // sq, abs
constexpr int GROUP_AGGD = 1;  // neg, pos, neg_sq, pos_sq, abs, sq
constexpr int GROUP_GRAYWORLD = 2;  // gated, gated, gated, gated_count

// one map as a group of one output (grid_reduce's sum, min and max)
template <class M>
struct Single {
  static constexpr int N = M::N, K = 1;
  M m;
  __device__ void operator()(const float* v, float* o) const { o[0] = m(v); }
};

struct GgdMoments {
  static constexpr int N = 1, K = 2;
  __device__ void operator()(const float* v, float* o) const {
    o[0] = Sq{}(v);
    o[1] = Abs{}(v);
  }
};

struct AggdMoments {
  static constexpr int N = 1, K = 6;
  __device__ void operator()(const float* v, float* o) const {
    o[0] = SideCount<true>{}(v);
    o[1] = SideCount<false>{}(v);
    o[2] = SideSq<true>{}(v);
    o[3] = SideSq<false>{}(v);
    o[4] = Abs{}(v);
    o[5] = Sq{}(v);
  }
};

struct GrayworldSums {  // the gated sums of channels 0, 1, 2 and their count
  static constexpr int N = 3, K = 4;
  float sat;
  __device__ void operator()(const float* v, float* o) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = Gated{sat, c}(v);
    o[3] = GatedCount{sat}(v);
  }
};

template <class F>
bool dispatch_group(int group, const float* hp, F&& f) {
  switch (group) {
    case GROUP_GGD: f(GgdMoments{}); return true;
    case GROUP_AGGD: f(AggdMoments{}); return true;
    case GROUP_GRAYWORLD: f(GrayworldSums{hp[0]}); return true;
    default: return false;
  }
}

// views: n_in + 1 (input views, then the output) host triples (pointer,
// pitch, stride), as ops/cuda/transform.py packs them
template <int N>
Views<N> unpack(const long long* views) {
  Views<N> out;
  for (int a = 0; a < N; ++a)
    out.v[a] = View{reinterpret_cast<float*>(views[3 * a]), views[3 * a + 1], views[3 * a + 2]};
  return out;
}

// ---- the row walk of grid_transform and grid_reduce --------------------------
// A block of TX threads takes a band of rows and its threads take columns, so
// a row's offset is computed once per row (64-bit) and an element's offset in
// its row in 32 bits (the wrappers refuse a row that spans 2**31 elements or
// more): no per-element division. Two paths, chosen by the wrapper from the
// views:
//   vec4: every view has stride 1, a pitch that is a multiple of 4 and a
//     16-byte aligned pointer: a thread takes U float4s of a row per step
//     (16-byte loads, U in flight for each input), and block column 0 maps
//     the row's last W % 4 elements one by one;
//   strided: any strides: a thread takes U elements of a row per step,
//     consecutive threads on consecutive columns.
// The geometry is set by the macros below, so that
// scripts/row_walk_geometry.py can build and time other choices with -D flags.
#ifndef ROW_WALK_TX
#define ROW_WALK_TX 128
#endif
// U on the vec4 path: a map runs fastest with one float4 per input and thread
// (the most threads in flight), a reduction with four (fewer, fuller blocks
// fold and write partials); the strided path takes four elements either way
#ifndef ROW_WALK_MAP_U
#define ROW_WALK_MAP_U 1
#endif
#ifndef ROW_WALK_REDUCE_U
#define ROW_WALK_REDUCE_U 4
#endif
constexpr int TX = ROW_WALK_TX;
constexpr int unroll(bool vec4, bool reduce) { return !vec4 ? 4 : reduce ? ROW_WALK_REDUCE_U : ROW_WALK_MAP_U; }

// blocks along a row: enough for one step of u units a thread to cover it
inline int row_blocks(int W, bool vec4, int u) {
  const int units = vec4 ? W / 4 : W, per = TX * u;
  return units > per ? (units + per - 1) / per : 1;
}

template <int N>
__device__ __forceinline__ void row_ptrs(const Views<N>& in, int i, const float** row) {
#pragma unroll
  for (int a = 0; a < N; ++a) row[a] = in.v[a].p + (long long)i * in.v[a].pitch;
}

template <int N>
__device__ __forceinline__ void load4(const float* const* row, int c, float4* x) {
#pragma unroll
  for (int a = 0; a < N; ++a) x[a] = __ldg(reinterpret_cast<const float4*>(row[a]) + c);
}

// lane l (0-3) of N float4s: the N inputs of element 4 c + l
template <int N>
__device__ __forceinline__ void lane(const float4* x, int l, float* v) {
#pragma unroll
  for (int a = 0; a < N; ++a) v[a] = l == 0 ? x[a].x : l == 1 ? x[a].y : l == 2 ? x[a].z : x[a].w;
}

}  // namespace maps
