// Fast Griffin-Lim on Hopper's tensor cores: the bf16 iterations.
//
// Replaces, with csrc/griffin_lim.cu, the Pallas kernels griffin_lim_pallas
// (B1) and griffin_lim_pallas_tiled (B2) of advoc_tpu/ops/pallas/
// griffin_lim.py in its four bf16 loop modes (loop_dtype, _gl_maps and mm,
// griffin_lim.py:64-124, :165-225): "split_synth", what the JAX Vocoder runs
// by default, "split", "split_anal" and "bfloat16". Each product is either
// split (a bf16 (hi, lo) pair of the f32 map, two bf16 products into one
// f32 accumulator: ~16 mantissa bits of the map) or plain (the hi half
// alone, bf16(map)), chosen for synthesis and analysis apart:
//
//   mode          synthesis  analysis
//   split_synth   split      plain
//   split         split      split
//   split_anal    plain      split
//   bfloat16      plain      plain
//
//   synthesis  y[r, s] = norm[j, s] * sum_{k<4} sum_f  bf16(re[r+3-k, f]) W_re,k[f, s]
//                                                    + bf16(im[r+3-k, f]) W_im,k[f, s]
//              with W = inv_hi + inv_lo (split) or inv_hi (plain),
//              inv_hi = bf16(inv), inv_lo = bf16(inv - inv_hi) (_gl_maps._split),
//              and f32 accumulation;
//   analysis   acc[r, f] = sum_{k<4} bf16(y[r+k, :]) . V_k[:, f], V = fwd_hi + fwd_lo
//              (split) or fwd_hi (plain), f32 accumulation,
//              then the f32 momentum step and the projection onto |mag|:
//                u = acc + m (acc - pre);  pre = acc;
//                (re, im) = u * mag * rsqrt(u_re^2 + u_im^2 + 1e-12).
//
// Layout. re/im are bf16 (3 + B(T+3), F_pad) arrays with three zero rows
// before each utterance: frame t of row b lives at carry row
// 3 + b(T+3) + t. y is (B(T+3), hop_pad), hop block j of row b at row
// b(T+3) + j. Both products are then dense GEMMs over the flattened rows
// whose A tile for band k starts k rows away: synthesis reads carry rows
// r + 3 - k, analysis reads y rows r + k. The zero rows supply the frames
// outside [0, T), so no band masks are needed, and tiles cross utterances
// freely. Analysis output row r is carry row r + 3; rows with
// r mod (T+3) >= T are skipped, so the zero rows stay zero. F is padded
// to F_pad (a multiple of 64) and hop to hop_pad (a multiple of 64) with
// zero magnitude, zero map rows and columns and zero norm: the padding is
// exact, as the TPU kernel's lane padding is. bf16 rows of F_pad or hop_pad
// elements are multiples of 128 bytes, so every row is legal for TMA.
//
// Design. One CTA computes a 128-row x 128-column tile with two consumer
// warpgroups (64 rows each, wgmma.mma_async m64n128k16, bf16 in, f32
// accumulator in registers) and one producer warp whose one thread keeps
// TMA loads (cp.async.bulk.tensor, 128-byte swizzle) in flight into a ring
// of shared-memory stages, each with a full and an empty mbarrier. A
// stage holds one A tile (re or im rows in synthesis, y rows in analysis)
// and, for a split product, the hi and lo B tiles of the same map rows:
// the A tile feeds two wgmmas into one accumulator. A plain product's
// stage holds the A tile and the hi tile alone. Four stages of three 16 KB
// tiles (192 KB) or of two (128 KB) fit the 227 KB a block may take. The
// analysis tile's 128 columns are 64 bins of the real map followed by the
// same 64 bins of the imaginary map, so each thread holds
// acc_re and acc_im of the same (t, f) in its accumulator and the momentum
// and projection epilogue stays in registers; its f32 inputs (mag, pre,
// pim) are loaded into registers before the products, so their latency
// hides behind the mainloop. Outputs are written by exactly one thread
// each: no atomics, deterministic.
//
// Bound: the work is operations. A split product does twice the products
// of a plain one, so one split_synth iteration at B=128 x 256 frames,
// F=512, hop 256 is ~0.21 TFLOP on the tensor cores (0.21 ms at 989 TFLOP/s dense bf16);
// the carries move ~0.5 GB per iteration (bf16 re/im/y, f32 mag/pre/pim),
// 0.15 ms at 3.35 TB/s. The design keeps the products on the tensor cores
// and the epilogue's traffic to one read and one write of each carry. On
// an H100 the split synthesis runs near 685 TFLOP/s; the analysis is held
// by its epilogue's memory traffic, which runs near 1.4 TB/s (PERF.md).
//
// hop and F are launch arguments (any n_fft = 4 hop).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;                    // rows per CTA: two warpgroups of 64
constexpr int kBN = 128;                    // wgmma N
constexpr int kBK = 64;                     // bf16 per 128-byte swizzled row
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kTileBytes = kBM * kBK * 2;   // one A or B tile, 16 KB
constexpr int kStages = 4;                  // 3 tiles a stage (split): 192 KB
// One CTA per SM in both modes: synthesis for its shared memory, analysis
// for the registers of its epilogue's prefetch (two 64-row CTAs per SM
// measured no faster on an H100).

enum Mode { kSynthBf16 = 0, kSynthF32 = 1, kAnalyze = 2 };

struct Args {
  int M;        // B (T + 3): rows of y
  int T;
  int f_pad;
  int hop_pad;
  const float* norm;   // synthesis: (T + 3, hop_pad)
  void* out;           // synthesis: (M, hop_pad) bf16 or f32
  const float* mag;    // analysis: (M + 3, f_pad) carries
  float* pre;
  float* pim;
  __nv_bfloat16* re;
  __nv_bfloat16* im;
  float* re32;         // optional f32 copies of the projected spectrum
  float* im32;
  float momentum;
};

// A stage: the A tile, then the map's hi tile and, for a split product, its lo tile.
template <bool kSplit>
__host__ __device__ constexpr int stage_bytes() {
  return (kSplit ? 3 : 2) * kTileBytes;
}

template <bool kSplit>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<kSplit>() + 1024 + 2 * kStages * 8;
}
static_assert(smem_bytes<true>() <= 232448, "the split ring must fit a block's shared memory");

// Synthesis (kMode 0, 1): map_a0/map_a1 are re/im (f_pad, M + 3), map_b the
// split inverse maps (f_pad, hop_pad, 16), band (k, part, hi|lo); a plain
// synthesis reads the hi bands alone. Grid (hop_pad / 128, M / 128).
// Analysis (kMode 2): map_a0 is y (hop_pad, M), map_b the forward maps'
// hi halves (4 hop_pad, 2 f_pad), rows interleaved 64 real and 64
// imaginary bins, and map_a1 their lo halves in the same layout (read by a
// split analysis alone). Grid (f_pad / 64, M / 128).
template <int kMode, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    gl_tc_kernel(const __grid_constant__ CUtensorMap map_a0,
                 const __grid_constant__ CUtensorMap map_a1,
                 const __grid_constant__ CUtensorMap map_b, const Args args) {
  constexpr bool kSynth = kMode != kAnalyze;
  constexpr int kStageBytes = stage_bytes<kSplit>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int nf = args.f_pad / kBK;
  const int nh = args.hop_pad / kBK;
  const int KT = kSynth ? 4 * 2 * nf : 4 * nh;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer: one thread keeps the ring full.
    if (threadIdx.x != kConsumers) return;
    for (int it = 0; it < KT; ++it) {
      const int s = it % kStages;
      const int round = it / kStages;
      if (round > 0) mbar_wait(smem_u32(&empty[s]), (round - 1) & 1);
      const uint32_t dst = smem_u32(smem + s * kStageBytes);
      const uint32_t bar = smem_u32(&full[s]);
      mbar_expect_tx(bar, kStageBytes);
      if constexpr (kSynth) {
        const int k = it / (2 * nf);
        const int rem = it - k * 2 * nf;
        const int part = rem / nf;
        const int f0 = (rem - part * nf) * kBK;
        tma_2d(dst, part ? &map_a1 : &map_a0, bar, f0, m0 + 3 - k);
        const int band = (k * 2 + part) * 2;
        tma_3d(dst + kTileBytes, &map_b, bar, f0, n0, band);
        if constexpr (kSplit) tma_3d(dst + 2 * kTileBytes, &map_b, bar, f0, n0, band + 1);
      } else {
        const int k = it / nh;
        const int s0 = (it - k * nh) * kBK;
        tma_2d(dst, &map_a0, bar, s0, m0 + k);
        tma_2d(dst + kTileBytes, &map_b, bar, k * args.hop_pad + s0, n0);
        if constexpr (kSplit)
          tma_2d(dst + 2 * kTileBytes, &map_a1, bar, k * args.hop_pad + s0, n0);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows m0 + 64 wg .. + 63. Accumulator
  // layout of m64nNk16: warp w of the warpgroup holds rows 16w .. 16w + 15;
  // d[4j + 2i + c] is row lane/4 + 8i, column 8j + 2(lane % 4) + c.
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int tp3 = args.T + 3;
  int rows[2];
  bool live[2];  // analysis: a row the epilogue writes
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows[i] = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * i;
    live[i] = rows[i] < args.M && (kSynth || rows[i] % tp3 < args.T);
  }
  // Analysis: the epilogue's f32 inputs are loaded before the products, so
  // their latency hides behind the mainloop (loaded after it, one row at a
  // time, they made the epilogue 8x slower than the products).
  float2 pf_pre[2][8], pf_pim[2][8], pf_mag[2][8];
  if constexpr (!kSynth) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t base = static_cast<size_t>(rows[i] + 3) * args.f_pad + blockIdx.x * 64 +
                          2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 zero = make_float2(0.f, 0.f);
        pf_pre[i][j] = live[i] ? *reinterpret_cast<const float2*>(args.pre + base + 8 * j) : zero;
        pf_pim[i][j] = live[i] ? *reinterpret_cast<const float2*>(args.pim + base + 8 * j) : zero;
        pf_mag[i][j] = live[i] ? __ldg(reinterpret_cast<const float2*>(args.mag + base + 8 * j))
                               : zero;
      }
    }
  }
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;

  for (int it = 0; it < KT; ++it) {
    const int s = it % kStages;
    mbar_wait(smem_u32(&full[s]), (it / kStages) & 1);
    const uint32_t a = smem_u32(smem + s * kStageBytes) + wg * 64 * 128;
    const uint32_t b0 = smem_u32(smem + s * kStageBytes + kTileBytes);
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_128(d, sw128_desc(a + kk * 32), sw128_desc(b0 + kk * 32));
      if constexpr (kSplit)
        wgmma_128(d, sw128_desc(a + kk * 32), sw128_desc(b0 + kTileBytes + kk * 32));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    mbar_arrive(smem_u32(&empty[s]));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    const int row = rows[i];
    if constexpr (kSynth) {
      const float* w = args.norm + (row % tp3) * args.hop_pad;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        if (col >= args.hop_pad) continue;
        const float2 w2 = *reinterpret_cast<const float2*>(w + col);
        const float v0 = d[4 * j + 2 * i] * w2.x;
        const float v1 = d[4 * j + 2 * i + 1] * w2.y;
        const size_t o = static_cast<size_t>(row) * args.hop_pad + col;
        if constexpr (kMode == kSynthF32)
          *reinterpret_cast<float2*>(static_cast<float*>(args.out) + o) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(args.out) + o) =
              __floats2bfloat162_rn(v0, v1);
      }
    } else {
      // Rows with row % (T + 3) >= T are not live: the zero rows stay zero.
      const size_t base = static_cast<size_t>(row + 3) * args.f_pad + blockIdx.x * 64;
      const float m = args.momentum;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const size_t idx = base + 8 * j + 2 * (lane % 4);
        const float2 pr = pf_pre[i][j], pi = pf_pim[i][j], mg = pf_mag[i][j];
        const float ar0 = d[4 * j + 2 * i], ar1 = d[4 * j + 2 * i + 1];
        const float ai0 = d[4 * (j + 8) + 2 * i], ai1 = d[4 * (j + 8) + 2 * i + 1];
        const float ur0 = ar0 + m * (ar0 - pr.x), ur1 = ar1 + m * (ar1 - pr.y);
        const float ui0 = ai0 + m * (ai0 - pi.x), ui1 = ai1 + m * (ai1 - pi.y);
        *reinterpret_cast<float2*>(args.pre + idx) = make_float2(ar0, ar1);
        *reinterpret_cast<float2*>(args.pim + idx) = make_float2(ai0, ai1);
        const float s0 = mg.x * rsqrtf(ur0 * ur0 + ui0 * ui0 + 1e-12f);
        const float s1 = mg.y * rsqrtf(ur1 * ur1 + ui1 * ui1 + 1e-12f);
        const float re0 = ur0 * s0, re1 = ur1 * s1, im0 = ui0 * s0, im1 = ui1 * s1;
        *reinterpret_cast<__nv_bfloat162*>(args.re + idx) = __floats2bfloat162_rn(re0, re1);
        *reinterpret_cast<__nv_bfloat162*>(args.im + idx) = __floats2bfloat162_rn(im0, im1);
        if (args.re32 != nullptr) {
          *reinterpret_cast<float2*>(args.re32 + idx) = make_float2(re0, re1);
          *reinterpret_cast<float2*>(args.im32 + idx) = make_float2(im0, im1);
        }
      }
    }
  }
}

// A bf16 tensor map with 128-byte swizzle and a (64, 128[, 1]) box;
// elements outside the tensor read as zero. dims innermost first, strides
// in bytes for dims 1.. .
int encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides) {
  const cuuint32_t box[3] = {kBK, kBM, 1};
  return hopper::encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, ptr, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int kMode, bool kSplit>
int launch(const CUtensorMap& a0, const CUtensorMap& a1, const CUtensorMap& b, const Args& args,
           dim3 grid, cudaStream_t stream) {
  constexpr int smem = smem_bytes<kSplit>();
  cudaError_t e = cudaFuncSetAttribute(gl_tc_kernel<kMode, kSplit>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  gl_tc_kernel<kMode, kSplit><<<grid, kThreads, smem, stream>>>(a0, a1, b, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One synthesis, split or plain: re/im (B(T+3) + 3, f_pad) bf16, ws (16,
// hop_pad, f_pad) bf16, norm (T+3, hop_pad) f32 → out (B(T+3), hop_pad),
// bf16 or (out_f32) f32.
int gl_tc_synth(const void* re, const void* im, const void* ws, const float* norm, void* out,
                int out_f32, int split, int B, int T, int f_pad, int hop_pad, void* stream) {
  Args args{};
  args.M = B * (T + 3);
  args.T = T;
  args.f_pad = f_pad;
  args.hop_pad = hop_pad;
  args.norm = norm;
  args.out = out;
  CUtensorMap m_re, m_im, m_ws;
  const cuuint64_t carry_dims[2] = {static_cast<cuuint64_t>(f_pad),
                                    static_cast<cuuint64_t>(args.M + 3)};
  const cuuint64_t carry_strides[1] = {static_cast<cuuint64_t>(f_pad) * 2};
  const cuuint64_t ws_dims[3] = {static_cast<cuuint64_t>(f_pad), static_cast<cuuint64_t>(hop_pad),
                                 16};
  const cuuint64_t ws_strides[2] = {static_cast<cuuint64_t>(f_pad) * 2,
                                    static_cast<cuuint64_t>(f_pad) * hop_pad * 2};
  int code = encode(&m_re, re, 2, carry_dims, carry_strides);
  if (code == 0) code = encode(&m_im, im, 2, carry_dims, carry_strides);
  if (code == 0) code = encode(&m_ws, ws, 3, ws_dims, ws_strides);
  if (code != 0) return code;
  const dim3 grid((hop_pad + kBN - 1) / kBN, (args.M + kBM - 1) / kBM);
  const auto s = static_cast<cudaStream_t>(stream);
  if (split)
    return out_f32 ? launch<kSynthF32, true>(m_re, m_im, m_ws, args, grid, s)
                   : launch<kSynthBf16, true>(m_re, m_im, m_ws, args, grid, s);
  return out_f32 ? launch<kSynthF32, false>(m_re, m_im, m_ws, args, grid, s)
                 : launch<kSynthBf16, false>(m_re, m_im, m_ws, args, grid, s);
}

// One analysis, split or plain, with the momentum and projection epilogue:
// y (B(T+3), hop_pad) bf16, wa and (split) wa_lo (2 f_pad, 4 hop_pad) bf16;
// mag/pre/pim f32 and re/im bf16 are (B(T+3) + 3, f_pad) carries;
// re32/im32 (same shape, f32) may be null.
int gl_tc_analyze(const void* y, const void* wa, const void* wa_lo, const float* mag, float* pre,
                  float* pim, void* re, void* im, float* re32, float* im32, int split, int B,
                  int T, int f_pad, int hop_pad, float momentum, void* stream) {
  Args args{};
  args.M = B * (T + 3);
  args.T = T;
  args.f_pad = f_pad;
  args.hop_pad = hop_pad;
  args.mag = mag;
  args.pre = pre;
  args.pim = pim;
  args.re = static_cast<__nv_bfloat16*>(re);
  args.im = static_cast<__nv_bfloat16*>(im);
  args.re32 = re32;
  args.im32 = im32;
  args.momentum = momentum;
  CUtensorMap m_y, m_wa, m_lo;
  const cuuint64_t y_dims[2] = {static_cast<cuuint64_t>(hop_pad), static_cast<cuuint64_t>(args.M)};
  const cuuint64_t y_strides[1] = {static_cast<cuuint64_t>(hop_pad) * 2};
  const cuuint64_t wa_dims[2] = {static_cast<cuuint64_t>(4 * hop_pad),
                                 static_cast<cuuint64_t>(2 * f_pad)};
  const cuuint64_t wa_strides[1] = {static_cast<cuuint64_t>(4 * hop_pad) * 2};
  int code = encode(&m_y, y, 2, y_dims, y_strides);
  if (code == 0) code = encode(&m_wa, wa, 2, wa_dims, wa_strides);
  if (code == 0 && split) code = encode(&m_lo, wa_lo, 2, wa_dims, wa_strides);
  if (code != 0) return code;
  const dim3 grid(f_pad / 64, (args.M + kBM - 1) / kBM);
  const auto s = static_cast<cudaStream_t>(stream);
  return split ? launch<kAnalyze, true>(m_y, m_lo, m_wa, args, grid, s)
               : launch<kAnalyze, false>(m_y, m_y, m_wa, args, grid, s);
}

// Every library of csrc/ exports error_string (see ops/kernels/_build.py).
const char* error_string(int code) { return hopper::error_string(code); }

}  // extern "C"
