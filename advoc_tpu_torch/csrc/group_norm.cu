// GroupNorm + activation for the U-Net's levels: a statistics pass and a
// normalise-activate pass over an activation (bf16, f16 or f32: the
// generator's compute dtype) in the layout the convolution returned it.
//
// Replaces no Pallas kernel: the JAX package leaves GroupNorm to XLA. The
// function (flax GroupNorm, eps 1e-6, then the level's activation), per
// sample b and group g of cg = C / G channels, n = cg * H * W elements:
//
//   mean = sum(x) / n,  var = max(sum(x^2) / n - mean^2, 0)      (f32)
//   inv  = rsqrt(var + 1e-6)
//   t    = (x - mean) * (inv * w[c]) + bias[c]                    (f32, each op rounded)
//   y    = act(T(t)): LeakyReLU(0.2) as T(float(y) * 0.2f) below 0, or ReLU
//
// in x's dtype T, the plain path's own formula op by op (no contraction into
// fma), so with the same statistics the output is bit-identical to it; the
// sums are taken in another order.
//
// With a convolution's bias (conv_bias, (C,) f32, not null) each element
// either pass reads is first x = T(x + float(T(conv_bias[c]))): the value
// PyTorch's bias add_ after a cuDNN convolution would have written, here
// made in registers by the passes that read x anyway, so a level's
// convolution runs without its bias and the add's own pass over the
// activation (a strided elementwise kernel in the channels-last layout) is
// gone. The bias lives in registers (NHWC: a thread's 8 channels) or shared
// memory (NCHW: the unit's group), read once a CTA.
//
// Bound: the floor reads the activation once and writes it once, 4 bytes an
// element in bf16: at the full-width U-Net on 128 windows of 256 frames the
// 11 normalised levels hold 1.150 G elements, 4.60 GB, 1.37 ms at 3.35 TB/s;
// the finest level (64 x 256^2 x 128) alone 0.64 ms. Two passes read a level
// larger than L2 twice (6 bytes an element, 2.06 ms over the 11 levels). Bound
// by bytes, so the design moves each byte once a pass at full width:
//
// * A thread loads and stores 8 elements at a time (one 16-byte vector of a
//   2-byte type, two of f32), neighbouring threads on neighbouring vectors.
//   In the channels-last layout (NHWC, the default path's) a CTA has R rows
//   of V = C / 8 column threads, so a thread's vectors keep the same 8
//   channels at every position it visits: its sums and its normalise
//   coefficients are per channel, in registers, for any group size. In
//   contiguous NCHW (the pixelshuffle and subpixel decoder modes) a group is
//   one contiguous range of cg * H * W elements, cut into tiles of its own.
// * The statistics pass writes one partial (sum, sum of squares) per (unit,
//   tile, group), a unit being a sample (NHWC) or a (sample, group) (NCHW),
//   reduced in the CTA in a fixed order. No float atomics: every run gives
//   the same result. The normalise pass's CTAs each sum their unit's partials
//   in a fixed order, then stream their tile.
// * The tiles per unit are chosen by the wrapper from the shape: enough CTAs
//   to fill the 132 SMs many times over at the large levels, one tile per
//   sample where a sample is small. The normalise pass walks the tiles in
//   the reverse order of the statistics pass, so it starts on the tiles
//   read last, which are still in L2; a level of at most 50 MB (all but the
//   largest at 128 windows) is read the second time from L2.
//
// Measured on an H100 SXM at 700 W (bf16): 2.59 ms over the 11 levels at 128
// windows, 53% of the one-read floor and 79% of the two-pass figure; the
// finest level 1.16 ms (55% of its floor); the smallest levels (a few MB)
// take 8-13 us, launch-bound (PERF.md). With the convolution's bias the pair
// takes 2.61 ms over the 11 levels, where the bias add_ and the pair without
// it took 5.93 ms.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // per CTA; an NHWC CTA takes R * V of them, rounded up to a warp
constexpr int kMaxC = 2048;    // V = C / 8 <= 256 column threads
constexpr int kLeaky = 0;
constexpr int kRelu = 1;

// Eight elements of T, the unit a thread loads and stores: one 16-byte
// vector of a 2-byte T, two of f32.
template <typename T>
struct Vec8 {
  uint4 u[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Vec8<T> ldg(const Vec8<T>* p) {
  Vec8<T> v;
  const uint4* s = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T) / 2); ++i) v.u[i] = __ldg(s + i);
  return v;
}

__device__ __forceinline__ void unpack(const Vec8<__nv_bfloat16>& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(v.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void unpack(const Vec8<__half>& v, float (&f)[8]) {
  const __half2* h = reinterpret_cast<const __half2*>(v.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void unpack(const Vec8<float>& v, float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = __uint_as_float(v.u[i].x);
    f[4 * i + 1] = __uint_as_float(v.u[i].y);
    f[4 * i + 2] = __uint_as_float(v.u[i].z);
    f[4 * i + 3] = __uint_as_float(v.u[i].w);
  }
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

// t rounded to T, then the activation on the rounded value as PyTorch
// computes it on a T tensor (in float, rounded again).
template <int kAct, typename T>
__device__ __forceinline__ T activate(float t) {
  const T y = from_float<T>(t);
  const float f = to_float(y);
  if (kAct == kLeaky) return f > 0.f ? y : from_float<T>(__fmul_rn(f, 0.2f));
  return (f > 0.f || f != f) ? y : from_float<T>(0.f);
}

// The convolution's bias as the convolution casts it to T, in float.
template <typename T>
__device__ __forceinline__ float round_bias(float b) { return to_float(from_float<T>(b)); }

// x + rb in T, as PyTorch's add_ on a T tensor computes it (in float,
// rounded once), back in float.
template <typename T>
__device__ __forceinline__ float add_bias(float x, float rb) {
  return to_float(from_float<T>(__fadd_rn(x, rb)));
}

// (x - m) * a + b with each operation rounded, as three PyTorch ops.
__device__ __forceinline__ float affine(float x, float m, float a, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, m), a), b);
}

__device__ __forceinline__ Vec8<__nv_bfloat16> pack(const __nv_bfloat16 (&o)[8]) {
  Vec8<__nv_bfloat16> v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(v.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __halves2bfloat162(o[2 * i], o[2 * i + 1]);
  return v;
}

__device__ __forceinline__ Vec8<__half> pack(const __half (&o)[8]) {
  Vec8<__half> v;
  __half2* h = reinterpret_cast<__half2*>(v.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __halves2half2(o[2 * i], o[2 * i + 1]);
  return v;
}

__device__ __forceinline__ Vec8<float> pack(const float (&o)[8]) {
  Vec8<float> v;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    v.u[i] = make_uint4(__float_as_uint(o[4 * i]), __float_as_uint(o[4 * i + 1]),
                        __float_as_uint(o[4 * i + 2]), __float_as_uint(o[4 * i + 3]));
  return v;
}

// Mean and inv of each of a unit's gpu groups from its nt partials (laid out
// [tile][group]) into mi[group]: one warp a group, lanes over tiles, then a
// fixed butterfly. Ends with __syncthreads.
__device__ void group_stats(const float2* __restrict__ part, int nt, int gpu, float n,
                            float2* mi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int g = warp; g < gpu; g += nw) {
    float s = 0.f, q = 0.f;
    for (int t = lane; t < nt; t += 32) {
      const float2 v = part[t * gpu + g];
      s += v.x;
      q += v.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (lane == 0) {
      const float mean = __fdiv_rn(s, n);
      float var = __fsub_rn(__fdiv_rn(q, n), __fmul_rn(mean, mean));
      var = var < 0.f ? 0.f : var;  // clamp, a NaN kept
      mi[g] = make_float2(mean, rsqrtf(__fadd_rn(var, 1e-6f)));
    }
  }
  __syncthreads();
}

// ---- channels-last: x (B, H, W, C) in memory, P = H * W positions ----------

// grid: B * nt CTAs (sample, tile); tile covers positions [tile * tp, +tp).
template <bool kBias, typename T>
__global__ void __launch_bounds__(kThreads)
stats_nhwc(const Vec8<T>* __restrict__ x, const float* __restrict__ conv_bias,
           float2* __restrict__ part, int P, int C, int G, int nt, int tp) {
  __shared__ float red[kThreads * 16];
  const int V = C / 8, R = kThreads / V;
  const int unit = blockIdx.x / nt, tile = blockIdx.x % nt;
  const int col = threadIdx.x % V, row = threadIdx.x / V;
  const int p0 = tile * tp, p1 = min(P, p0 + tp);
  const Vec8<T>* xs = x + static_cast<size_t>(unit) * P * V + col;
  float s[8], q[8], rb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
  if (row < R) {
    if constexpr (kBias) {
#pragma unroll
      for (int j = 0; j < 8; ++j) rb[j] = round_bias<T>(conv_bias[col * 8 + j]);
    }
    int p = p0 + row;
    for (; p + 3 * R < p1; p += 4 * R) {
      Vec8<T> v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = ldg(xs + static_cast<size_t>(p + i * R) * V);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float f[8];
        unpack(v[i], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if constexpr (kBias) f[j] = add_bias<T>(f[j], rb[j]);
          s[j] += f[j];
          q[j] = fmaf(f[j], f[j], q[j]);
        }
      }
    }
    for (; p < p1; p += R) {
      float f[8];
      unpack(ldg(xs + static_cast<size_t>(p) * V), f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if constexpr (kBias) f[j] = add_bias<T>(f[j], rb[j]);
        s[j] += f[j];
        q[j] = fmaf(f[j], f[j], q[j]);
      }
    }
  }
  float* mine = red + threadIdx.x * 16;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mine[j] = s[j];
    mine[8 + j] = q[j];
  }
  __syncthreads();
  // Per channel over the rows, in row order; then per group over its
  // channels, in channel order (the channel sums reuse red).
  // blockDim.x >= V, so 8 strides of it cover the C = 8 V channels.
  float cs[8], cq[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    cs[k] = cq[k] = 0.f;
    if (c < C) {
      for (int r = 0; r < R; ++r) {
        const float* e = red + (r * V + c / 8) * 16;
        cs[k] += e[c % 8];
        cq[k] += e[8 + c % 8];
      }
    }
  }
  __syncthreads();
  float2* ch = reinterpret_cast<float2*>(red);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < C) ch[c] = make_float2(cs[k], cq[k]);
  }
  __syncthreads();
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      a += ch[c].x;
      b += ch[c].y;
    }
    part[(static_cast<size_t>(unit) * nt + tile) * G + g] = make_float2(a, b);
  }
}

// grid: B * nt CTAs in the reverse order; dynamic shared memory G float2.
template <int kAct, bool kBias, typename T>
__global__ void __launch_bounds__(kThreads)
apply_nhwc(const Vec8<T>* __restrict__ x, Vec8<T>* __restrict__ y,
           const float2* __restrict__ part, float2* __restrict__ stats,
           const float* __restrict__ w, const float* __restrict__ bias,
           const float* __restrict__ conv_bias, int P, int C, int G, int nt, int tp, float n) {
  extern __shared__ float2 mi[];
  const int idx = gridDim.x - 1 - blockIdx.x;
  const int unit = idx / nt, tile = idx % nt;
  group_stats(part + static_cast<size_t>(unit) * nt * G, nt, G, n, mi);
  if (tile == 0)
    for (int g = threadIdx.x; g < G; g += blockDim.x) stats[unit * G + g] = mi[g];
  const int V = C / 8, R = kThreads / V;
  const int col = threadIdx.x % V, row = threadIdx.x / V;
  if (row >= R) return;
  const int cg = C / G;
  float m[8], a[8], b[8], rb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = col * 8 + j;
    const float2 st = mi[c / cg];
    m[j] = st.x;
    a[j] = __fmul_rn(st.y, w[c]);
    b[j] = bias[c];
    if constexpr (kBias) rb[j] = round_bias<T>(conv_bias[c]);
  }
  const size_t base = static_cast<size_t>(unit) * P * V + col;
  const Vec8<T>* xs = x + base;
  Vec8<T>* ys = y + base;
  const int p0 = tile * tp, p1 = min(P, p0 + tp);
  int p = p0 + row;
  for (; p + 3 * R < p1; p += 4 * R) {
    Vec8<T> v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = ldg(xs + static_cast<size_t>(p + i * R) * V);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[8];
      T o[8];
      unpack(v[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if constexpr (kBias) f[j] = add_bias<T>(f[j], rb[j]);
        o[j] = activate<kAct, T>(affine(f[j], m[j], a[j], b[j]));
      }
      ys[static_cast<size_t>(p + i * R) * V] = pack(o);
    }
  }
  for (; p < p1; p += R) {
    float f[8];
    T o[8];
    unpack(ldg(xs + static_cast<size_t>(p) * V), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (kBias) f[j] = add_bias<T>(f[j], rb[j]);
      o[j] = activate<kAct, T>(affine(f[j], m[j], a[j], b[j]));
    }
    ys[static_cast<size_t>(p) * V] = pack(o);
  }
}

// ---- contiguous NCHW: a unit is (sample, group), L8 vectors in one range ------

// The group's rounded convolution biases rb (shared memory) added to the 8
// elements of vector v of a unit's range, each by its channel.
template <typename T>
__device__ __forceinline__ void add_bias_nchw(float (&f)[8], long long v, int HW,
                                              const float* rb) {
  const long long e = v * 8;
  int c = static_cast<int>(e / HW), r = static_cast<int>(e - static_cast<long long>(c) * HW);
  const bool whole = HW % 8 == 0;  // a vector then lies in one channel
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f[j] = add_bias<T>(f[j], rb[c]);
    if (!whole && ++r == HW) {
      r = 0;
      ++c;
    }
  }
}

// grid: B * G * nt CTAs (unit, tile); tile covers vectors [tile * tv, +tv);
// with kBias, dynamic shared memory cg floats (the group's biases).
template <bool kBias, typename T>
__global__ void __launch_bounds__(kThreads)
stats_nchw(const Vec8<T>* __restrict__ x, const float* __restrict__ conv_bias,
           float2* __restrict__ part, long long L8, int HW, int G, int cg, int nt,
           long long tv) {
  __shared__ float2 red[kThreads / 32];
  extern __shared__ float rb[];
  const int unit = blockIdx.x / nt, tile = blockIdx.x % nt;
  if constexpr (kBias) {
    const float* gb = conv_bias + (unit % G) * cg;
    for (int c = threadIdx.x; c < cg; c += kThreads) rb[c] = round_bias<T>(gb[c]);
    __syncthreads();
  }
  const Vec8<T>* xs = x + static_cast<size_t>(unit) * L8;
  const long long v0 = tile * tv, v1 = min(L8, v0 + tv);
  float s = 0.f, q = 0.f;
  long long v = v0 + threadIdx.x;
  for (; v + 3 * kThreads < v1; v += 4 * kThreads) {
    Vec8<T> u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = ldg(xs + v + i * kThreads);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[8];
      unpack(u[i], f);
      if constexpr (kBias) add_bias_nchw<T>(f, v + i * kThreads, HW, rb);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s += f[j];
        q = fmaf(f[j], f[j], q);
      }
    }
  }
  for (; v < v1; v += kThreads) {
    float f[8];
    unpack(ldg(xs + v), f);
    if constexpr (kBias) add_bias_nchw<T>(f, v, HW, rb);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s += f[j];
      q = fmaf(f[j], f[j], q);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = make_float2(s, q);
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < kThreads / 32; ++k) {
      a += red[k].x;
      b += red[k].y;
    }
    part[static_cast<size_t>(unit) * nt + tile] = make_float2(a, b);
  }
}

// grid: B * G * nt CTAs in the reverse order; dynamic shared memory one
// float2 and 2 * cg floats (the group's channels' coefficients), 3 * cg
// with kBias (the rounded convolution biases).
template <int kAct, bool kBias, typename T>
__global__ void __launch_bounds__(kThreads)
apply_nchw(const Vec8<T>* __restrict__ x, Vec8<T>* __restrict__ y,
           const float2* __restrict__ part, float2* __restrict__ stats,
           const float* __restrict__ w, const float* __restrict__ bias,
           const float* __restrict__ conv_bias, long long L8, int HW, int G, int cg, int nt,
           long long tv, float n) {
  extern __shared__ float2 mi[];
  float* ca = reinterpret_cast<float*>(mi + 1);
  float* cb = ca + cg;
  float* cr = cb + cg;
  const int idx = gridDim.x - 1 - blockIdx.x;
  const int unit = idx / nt, tile = idx % nt, g = unit % G;
  group_stats(part + static_cast<size_t>(unit) * nt, nt, 1, n, mi);
  if (tile == 0 && threadIdx.x == 0) stats[unit] = mi[0];
  const float mean = mi[0].x;
  for (int c = threadIdx.x; c < cg; c += blockDim.x) {
    ca[c] = __fmul_rn(mi[0].y, w[g * cg + c]);
    cb[c] = bias[g * cg + c];
    if constexpr (kBias) cr[c] = round_bias<T>(conv_bias[g * cg + c]);
  }
  __syncthreads();
  const size_t base = static_cast<size_t>(unit) * L8;
  const Vec8<T>* xs = x + base;
  Vec8<T>* ys = y + base;
  const long long v0 = tile * tv, v1 = min(L8, v0 + tv);
  const bool whole = HW % 8 == 0;  // a vector then lies in one channel
  for (long long v = v0 + threadIdx.x; v < v1; v += kThreads) {
    float f[8];
    T o[8];
    unpack(ldg(xs + v), f);
    const long long e = v * 8;
    int c = static_cast<int>(e / HW), r = static_cast<int>(e - static_cast<long long>(c) * HW);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xj = kBias ? add_bias<T>(f[j], cr[c]) : f[j];
      o[j] = activate<kAct, T>(affine(xj, mean, ca[c], cb[c]));
      if (!whole && ++r == HW) {
        r = 0;
        ++c;
      }
    }
    ys[v] = pack(o);
  }
}

template <int kAct, bool kBias, typename T>
int launch(const void* xv, const float* w, const float* bias, const float* conv_bias, void* yv,
           float2* part, float2* stats, int B, int C, int HW, int G, int nhwc, int nt,
           cudaStream_t s) {
  const Vec8<T>* x = static_cast<const Vec8<T>*>(xv);
  Vec8<T>* y = static_cast<Vec8<T>*>(yv);
  const int cg = C / G;
  const float n = static_cast<float>(static_cast<long long>(cg) * HW);
  if (nhwc) {
    const int V = C / 8, R = kThreads / V;
    const int threads = (R * V + 31) / 32 * 32;
    const int tp = (HW + nt - 1) / nt;
    stats_nhwc<kBias, T><<<B * nt, threads, 0, s>>>(x, conv_bias, part, HW, C, G, nt, tp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    apply_nhwc<kAct, kBias, T><<<B * nt, threads, G * sizeof(float2), s>>>(
        x, y, part, stats, w, bias, conv_bias, HW, C, G, nt, tp, n);
  } else {
    const long long L8 = static_cast<long long>(cg) * HW / 8;
    const long long tv = (L8 + nt - 1) / nt;
    stats_nchw<kBias, T><<<B * G * nt, kThreads, kBias ? cg * sizeof(float) : 0, s>>>(
        x, conv_bias, part, L8, HW, G, cg, nt, tv);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem = sizeof(float2) + (kBias ? 3 : 2) * cg * sizeof(float);
    apply_nchw<kAct, kBias, T><<<B * G * nt, kThreads, smem, s>>>(
        x, y, part, stats, w, bias, conv_bias, L8, HW, G, cg, nt, tv, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_act(int act, const void* x, const float* w, const float* bias,
               const float* conv_bias, void* y, float2* part, float2* stats, int B, int C,
               int HW, int G, int nhwc, int nt, cudaStream_t s) {
  auto run = conv_bias ? (act == kLeaky ? launch<kLeaky, true, T> : launch<kRelu, true, T>)
                       : (act == kLeaky ? launch<kLeaky, false, T> : launch<kRelu, false, T>);
  return run(x, w, bias, conv_bias, y, part, stats, B, C, HW, G, nhwc, nt, s);
}

}  // namespace

extern "C" {

// x, y (B, C, H, W) of one dtype (0 bf16, 1 f16, 2 f32), channels-last in
// memory (nhwc = 1) or contiguous NCHW (nhwc = 0), 16-byte aligned; w, bias
// (C,) f32; conv_bias (C,) f32, added to x as T first, or null; part (units, nt, groups a unit) float2 scratch, units = B (NHWC)
// or B * G (NCHW); stats (B, G) float2 (mean, inv), written. act 0 is
// LeakyReLU(0.2), 1 ReLU. Two launches on stream. Needs C % 8 == 0,
// C % G == 0, C <= 2048 and, in NCHW, (C / G) * H * W % 8 == 0 (checked by
// the wrapper); returns cudaErrorInvalidValue otherwise.
int group_norm_act(const void* x, const float* w, const float* bias, const float* conv_bias,
                   void* y, float* part, float* stats, int B, int C, int HW, int G, int nhwc,
                   int act, int nt, int dtype, void* stream) {
  if (C % 8 || C > kMaxC || G < 1 || C % G || nt < 1 || (act != kLeaky && act != kRelu) ||
      dtype < 0 || dtype > 2 || (!nhwc && (static_cast<long long>(C / G) * HW) % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || HW == 0) return 0;
  auto run = dtype == 0 ? launch_act<__nv_bfloat16>
                        : dtype == 1 ? launch_act<__half> : launch_act<float>;
  return run(act, x, w, bias, conv_bias, y, reinterpret_cast<float2*>(part),
             reinterpret_cast<float2*>(stats), B, C, HW, G, nhwc, nt,
             static_cast<cudaStream_t>(stream));
}

// Every library of csrc/ exports error_string (see ops/kernels/_build.py).
const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
