// Bias + crop + activation after a 1-D transposed convolution: one pass from
// cuDNN's un-biased output to the next level's input.
//
// Replaces no Pallas kernel: the JAX package leaves this to XLA, which fuses
// it into the convolution's epilogue. In the port each WaveGAN level but the
// last ran three PyTorch passes after cuDNN's transposed convolution: the
// broadcast bias add (the strided elementwise kernel), the activation on the
// cropped view, and before the float32 last level a cast. The function, per
// row r = (b, c) of y (B, C, Lf) and t < L = Lf - cut_lo - cut_hi:
//
//   out[r, t] = O(act(T(float(y[r, t + cut_lo]) + float(bias[c]))))
//
// in the compute dtype T (bf16, f16 or f32), the sum rounded to T as
// PyTorch's add rounds it (float arithmetic, round to nearest even), the
// activation computed as PyTorch computes it on a T tensor (LeakyReLU(0.2)
// as T(float(v) * 0.2f) below 0, or ReLU), and O either T or float32: a T
// value widened to float32 is exact. So the output is bit-equal to
// act(narrow(y + bias)).to(O), op by op.
//
// Bound: memory, 0 FLOP a byte. One read of y and one write of out: at the
// 65,536-sample WaveGAN on 256 latents the five levels read 1.04 GB of bf16
// and write 1.58 GB (bf16, and float32 at the level before the last): 2.62
// GB, 0.78 ms at 3.35 TB/s. Design:
//
// * A thread writes 8 outputs at a time, one 16-byte store of a 2-byte O,
//   two of float32; neighbouring threads on neighbouring vectors, each
//   thread kUnroll vectors kThreads apart, loads first. The grid is
//   ceil(vectors / (kThreads * kUnroll)): from the shape alone.
// * At k25 the full length is 4n + 1, odd, so a row of y starts at any
//   element modulo 8, not on a 16-byte boundary. A thread whose 8 inputs
//   begin s elements past an aligned 8-element group loads that group and
//   the next with aligned 16-byte loads (the second only where s > 0) and
//   shifts the 8 it needs out of the 16 with register selects and one
//   byte permute a word (2-byte T); the neighbouring threads load the same
//   groups, so y's bytes come from DRAM once and from L1 twice. A float32
//   y is read by 4-byte loads. No padded copy of y is made.
// * The bias is read once for each 8 outputs, an L1 hit: (C,) values of T.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // vectors a thread has in flight
constexpr int kLeaky = 0;
constexpr int kRelu = 1;

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

// The float value of the low (hi = false) or high 2-byte T of a word.
template <typename T>
__device__ __forceinline__ float half_word(uint32_t w, bool hi);
template <>
__device__ __forceinline__ float half_word<__nv_bfloat16>(uint32_t w, bool hi) {
  return __uint_as_float(hi ? w & 0xffff0000u : w << 16);
}
template <>
__device__ __forceinline__ float half_word<__half>(uint32_t w, bool hi) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(hi ? w >> 16 : w)));
}

// y[e .. e + 8) as floats, for a 2-byte T: the aligned 8-element group
// holding e and, where e is not its first element, the next one.
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ y, size_t e, float (&f)[8]) {
  const int s = static_cast<int>(e & 7);
  const uint4* p = reinterpret_cast<const uint4*>(y + (e - s));
  const uint4 lo = __ldg(p);
  const uint4 hi = s ? __ldg(p + 1) : lo;
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int ws = s >> 1;
  uint32_t o[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const uint32_t a = w[j], b = w[j + 1], c = w[j + 2], d = w[j + 3];
    o[j] = ws == 0 ? a : ws == 1 ? b : ws == 2 ? c : d;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // An odd s starts at the high half of o[j]: the word across o[j], o[j + 1].
    const uint32_t v = (s & 1) ? __byte_perm(o[j], o[j + 1], 0x5432) : o[j];
    f[2 * j] = half_word<T>(v, false);
    f[2 * j + 1] = half_word<T>(v, true);
  }
}

template <>
__device__ __forceinline__ void load8<float>(const float* __restrict__ y, size_t e,
                                             float (&f)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __ldg(y + e + j);
}

// act(T(x + b)) as PyTorch computes the add and then the activation on T.
template <int kAct, typename T>
__device__ __forceinline__ T bias_act(float x, float b) {
  const T v = from_float<T>(__fadd_rn(x, b));
  const float f = to_float(v);
  if (kAct == kLeaky) return f > 0.f ? v : from_float<T>(__fmul_rn(f, 0.2f));
  return (f > 0.f || f != f) ? v : from_float<T>(0.f);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  const __nv_bfloat162 h = __halves2bfloat162(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack2(__half a, __half b) {
  const __half2 h = __halves2half2(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Eight T results to out[v * 8 ..) in O: one 16-byte store of a 2-byte O
// (O == T), two of float32.
template <typename T, typename O>
__device__ __forceinline__ void store8(O* __restrict__ out, size_t v, const T (&o)[8]) {
  if constexpr (sizeof(O) == 4) {
    float4* p = reinterpret_cast<float4*>(out + v * 8);
    p[0] = make_float4(to_float(o[0]), to_float(o[1]), to_float(o[2]), to_float(o[3]));
    p[1] = make_float4(to_float(o[4]), to_float(o[5]), to_float(o[6]), to_float(o[7]));
  } else {
    *reinterpret_cast<uint4*>(out + v * 8) =
        make_uint4(pack2(o[0], o[1]), pack2(o[2], o[3]), pack2(o[4], o[5]), pack2(o[6], o[7]));
  }
}

// grid: ceil(nvec / (kThreads * kUnroll)) CTAs; vector v covers out[v * 8, +8),
// row v / L8 of rows * L8 vectors.
template <int kAct, typename T, typename O>
__global__ void __launch_bounds__(kThreads)
conv_bias_act_kernel(const T* __restrict__ y, const T* __restrict__ bias, O* __restrict__ out,
                     unsigned nvec, unsigned L8, unsigned C, unsigned Lf, unsigned cut_lo) {
  const unsigned v0 = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  float f[kUnroll][8], b[kUnroll];
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const unsigned v = v0 + i * kThreads;
    if (v < nvec) {
      const unsigned r = v / L8, p = v - r * L8;
      load8<T>(y, static_cast<size_t>(r) * Lf + cut_lo + p * 8, f[i]);
      b[i] = to_float(bias[r % C]);
    }
  }
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const unsigned v = v0 + i * kThreads;
    if (v < nvec) {
      T o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = bias_act<kAct, T>(f[i][j], b[i]);
      store8<T, O>(out, v, o);
    }
  }
}

template <typename T, typename O>
int launch(int act, const void* y, const void* bias, void* out, unsigned nvec, unsigned L8,
           unsigned C, unsigned Lf, unsigned cut_lo, cudaStream_t s) {
  const unsigned grid = (nvec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  auto kernel = act == kLeaky ? conv_bias_act_kernel<kLeaky, T, O>
                              : conv_bias_act_kernel<kRelu, T, O>;
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const T*>(y), static_cast<const T*>(bias),
                                   static_cast<O*>(out), nvec, L8, C, Lf, cut_lo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (rows, Lf) of dtype (0 bf16, 1 f16, 2 f32), rows = B * C, contiguous and
// 16-byte aligned; bias (C,) of the same dtype; out (rows, L) with
// L = Lf - cut_lo - cut_hi, in y's dtype (out_f32 = 0) or float32 (1),
// 16-byte aligned. act 0 is LeakyReLU(0.2), 1 ReLU. One launch on stream.
// Needs L % 8 == 0, cut_lo + L <= Lf and rows * L / 8 < 2^31 (checked by the
// wrapper); returns cudaErrorInvalidValue otherwise.
int conv_bias_act(const void* y, const void* bias, void* out, long long rows, int C, int Lf,
                  int L, int cut_lo, int act, int dtype, int out_f32, void* stream) {
  const long long nvec = rows * (L / 8);
  if (L % 8 || L < 0 || cut_lo < 0 || cut_lo + L > Lf || C < 1 || rows % C ||
      nvec >= (1LL << 31) || (act != kLeaky && act != kRelu) || dtype < 0 || dtype > 2 ||
      (out_f32 != 0 && out_f32 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nvec == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n = static_cast<unsigned>(nvec), l8 = L / 8;
  if (dtype == 0)
    return out_f32 ? launch<__nv_bfloat16, float>(act, y, bias, out, n, l8, C, Lf, cut_lo, s)
                   : launch<__nv_bfloat16, __nv_bfloat16>(act, y, bias, out, n, l8, C, Lf,
                                                          cut_lo, s);
  if (dtype == 1)
    return out_f32 ? launch<__half, float>(act, y, bias, out, n, l8, C, Lf, cut_lo, s)
                   : launch<__half, __half>(act, y, bias, out, n, l8, C, Lf, cut_lo, s);
  return launch<float, float>(act, y, bias, out, n, l8, C, Lf, cut_lo, s);
}

// Every library of csrc/ exports error_string (see ops/kernels/_build.py).
const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
