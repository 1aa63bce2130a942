// Fast Griffin-Lim on Hopper's tensor cores in fp32: the "float32" loop
// mode (JAX's precision="highest") and B2's fp32 final synthesis.
//
// Replaces, with csrc/griffin_lim_tc.cu, the Pallas kernels
// griffin_lim_pallas (B1) and griffin_lim_pallas_tiled (B2) of
// advoc_tpu/ops/pallas/griffin_lim.py in the loop mode "float32", whose
// products Mosaic runs as 3-pass MXU products (f32-faithful). Here every
// product runs on the tensor cores in 3xTF32: an operand v is split into
// big = tf32_rna(v) and small = tf32_rna(v - big), and
// small*big + big*small + big*big is summed in f32 (the small*small term
// is below f32 rounding). Two launches an iteration:
//
//   gl_synth_ola        y[r, s] = norm[j, s] * sum_{k<4} sum_f  re[r+3-k, f] W_re,k[f, s]
//                                                              + im[r+3-k, f] W_im,k[f, s]
//                       (W = the windowed inverse-DFT maps, j = r mod (T+3));
//   gl_analyze_project  acc[r, f] = sum_{k<4} y[r+k, :] . V_k[:, f] (V = the
//                       forward maps), then the momentum step and the
//                       projection onto |mag|:
//                         u = acc + m (acc - pre);  pre = acc;
//                         (re, im) = u * mag * rsqrt(u_re^2 + u_im^2 + 1e-12).
//
// Layout: griffin_lim_tc.cu's, every carry in f32. re/im/mag/pre/pim are
// (3 + B(T+3), F_pad) arrays with three zero rows before each utterance
// (frame t of row b at carry row 3 + b(T+3) + t); y is (B(T+3), hop_pad),
// hop block j of row b at row b(T+3) + j. Both products are then dense
// GEMMs over the flattened rows whose A tile for band k starts k rows away:
// synthesis reads carry rows r + 3 - k, analysis y rows r + k; the zero
// rows supply the frames outside [0, T), so no band masks are needed.
// Analysis output row r is carry row r + 3; rows with r mod (T+3) >= T are
// skipped, so the zero rows stay zero. F and hop are padded to multiples
// of 64 with zero magnitude, maps and norm: exact. An f32 row of F_pad or
// hop_pad floats is a multiple of 256 bytes, legal for TMA.
//
// Design. One CTA computes a 128-row x 128-column tile with two consumer
// warpgroups (64 rows each, 232 registers a thread: setmaxnreg takes them
// from the producer warpgroup) and one producer warpgroup whose one thread keeps
// TMA loads (128-byte swizzle) in flight into a ring of four stages, each
// with a full and an empty mbarrier. A stage is the f32 A tile (128 rows x
// 32 floats: re or im carry rows in synthesis, y rows in analysis) and the
// big and small tiles of the map (128 rows x 32 floats, K-major; split
// once by the host, ops/kernels/griffin_lim.py:_tf32_maps): 3 x 16 KB,
// 192 KB for the ring. A 128-byte row is four k8 steps of
// wgmma.mma_async m64n128k8 tf32, each step's B a 32-byte K slice of the
// swizzled tile (sw128_desc + 32 kk). A is split in registers: a thread
// reads its fragment from the swizzled A tile (conflict-free: the 16-byte
// chunk of a row is XORed with row % 8) and feeds big and small as the
// wgmma's register A operand; while one stage's twelve products run, the
// next stage's fragments are read and split into a second register set.
// scripts/gl_fp32_ablation.py measures what each part of this costs.
//
// The tensor cores add each product into the accumulator with truncation,
// and 3xTF32 takes three k8 products where fp32 FMA takes one multiply-add:
// summed over all of K (up to 3 x 8192 / 8 steps) in one accumulator, the
// truncation's bias would reach ~1e-5 of the output. So each pair of
// stages' 24 products starts from zero (scale-d off) and is added into an
// f32 sum in registers, rounded to nearest: the bias stays within a pair's
// partial sum. The analysis epilogue keeps the momentum and projection in
// registers: a 128-column tile is 64 real bins then the same 64 imaginary
// bins, so each thread holds acc_re and acc_im of the same (t, f); its f32
// inputs (mag, pre, pim) are read after the mainloop, all at once, into the
// registers the products have freed. Outputs are written by exactly one
// thread each: no atomics, deterministic.
//
// Bound: operations. One iteration at B=128 x 256 frames, F=512, hop 256
// is 0.137 TFLOP counted once, 0.41 TFLOP of tf32 products in 3xTF32:
// 0.83 ms at the 495 TFLOP/s dense TF32 rate (the whole 30-iteration call
// 25 ms, against 4.2 ms for the work counted once at the bf16 rate); the
// carries move ~0.5 GB an iteration, 0.15 ms at 3.35 TB/s.
//
// hop and F are launch arguments (any n_fft = 4 hop).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;                      // rows per CTA: two warpgroups of 64
constexpr int kBN = 128;                      // wgmma N
constexpr int kBK = 32;                       // f32 per 128-byte swizzled row: four k8 steps
constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;    // and a producer warpgroup
// Registers a thread: the producer's few, the consumers' two accumulators
// and two A register sets (128 x 40 + 256 x 232 <= 65536).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kTileBytes = kBM * kBK * 4;     // one A or B tile, 16 KB
constexpr int kStageBytes = 3 * kTileBytes;   // A, the map's big and small tiles
constexpr int kStages = 4;
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;
static_assert(kSmemBytes <= 232448, "the ring must fit a block's shared memory");

struct Args {
  int M;        // B (T + 3): rows of y
  int T;
  int f_pad;
  int hop_pad;
  const float* norm;  // synthesis: (T + 3, hop_pad)
  float* y;           // synthesis: (M, hop_pad)
  const float* mag;   // analysis: (M + 3, f_pad) carries
  float* pre;
  float* pim;
  float* re;
  float* im;
  float momentum;
};

// A thread's fragments of the four k8 steps of a 128-row x 32-float A tile
// swizzled by TMA's SWIZZLE_128B (the 16-byte chunk c of row r at chunk
// c ^ (r % 8)), split into big and small. The tf32 A fragment of step kk:
// e = 0 (row g, column 8 kk + t), 1 (g + 8, 8 kk + t), 2 (g, 8 kk + t + 4),
// 3 (g + 8, 8 kk + t + 4), rows from `row`, the thread's first row, whose
// row % 8 is g.
__device__ __forceinline__ void load_split(const uint8_t* tile, int row, int g, int t,
                                           uint32_t (&big)[4][4], uint32_t (&small)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + (e & 1) * 8;
      const int chunk = (2 * kk + (e >> 1)) ^ g;
      const float v = *reinterpret_cast<const float*>(tile + r * 128 + chunk * 16 + t * 4);
      tf32_split(v, big[kk][e], small[kk][e]);
    }
}

// Synthesis (kSynth): map_a0/map_a1 are re/im (f_pad, M + 3), map_b the
// split inverse maps (f_pad, hop_pad, 16), band (k, part, big|small). Grid
// (hop_pad / 128, M / 128).
// Analysis: map_a0 is y (hop_pad, M), map_b the split forward maps
// (4 hop_pad, 2 f_pad, 2), rows interleaved 64 real and 64 imaginary bins,
// big then small. Grid (f_pad / 64, M / 128).
template <bool kSynth>
__global__ void __launch_bounds__(kThreads, 1)
    gl_tf32_kernel(const __grid_constant__ CUtensorMap map_a0,
                   const __grid_constant__ CUtensorMap map_a1,
                   const __grid_constant__ CUtensorMap map_b, const Args args) {
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
    setmaxnreg_dec<kProducerRegs>();
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
        tma_3d(dst + 2 * kTileBytes, &map_b, bar, f0, n0, band + 1);
      } else {
        const int k = it / nh;
        const int s0 = (it - k * nh) * kBK;
        tma_2d(dst, &map_a0, bar, s0, m0 + k);
        tma_3d(dst + kTileBytes, &map_b, bar, k * args.hop_pad + s0, n0, 0);
        tma_3d(dst + 2 * kTileBytes, &map_b, bar, k * args.hop_pad + s0, n0, 1);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  // Consumers: warpgroup wg owns rows m0 + 64 wg .. + 63. Accumulator
  // layout of m64nNk8: warp w of the warpgroup holds rows 16w .. 16w + 15;
  // d[4j + 2i + c] is row lane/4 + 8i, column 8j + 2(lane % 4) + c.
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int g = lane / 4, t = lane % 4;
  const int row = wg * 64 + warp * 16 + g;  // the thread's first row in the tile

  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;

  // Stage it's fragments, once its tiles have landed.
  auto fetch = [&](uint32_t (&ab)[4][4], uint32_t (&as)[4][4], int it) {
    const int s = it % kStages;
    mbar_wait(smem_u32(&full[s]), (it / kStages) & 1);
    load_split(smem + s * kStageBytes, row, g, t, ab, as);
  };
  // Stage it's twelve products into d, one group; a fresh stage's first
  // product overwrites d.
  auto mma = [&](uint32_t (&ab)[4][4], uint32_t (&as)[4][4], int it, bool fresh) {
    const uint32_t b_big = smem_u32(smem + (it % kStages) * kStageBytes + kTileBytes);
    const uint32_t b_small = b_big + kTileBytes;
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tf32_128(d, as[kk], sw128_desc(b_big + kk * 32), !fresh || kk > 0);
      wgmma_tf32_128(d, ab[kk], sw128_desc(b_small + kk * 32));
      wgmma_tf32_128(d, ab[kk], sw128_desc(b_big + kk * 32));
    }
    wgmma_commit();
  };
  // Wait for stage it's group, add it into acc, release the stage.
  auto retire = [&](int it) {
    wgmma_wait<0>();
    fence_regs(d);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
    mbar_arrive(smem_u32(&empty[it % kStages]));
  };

  // Two register sets: a stage's products run while the next stage's
  // fragments are read and split; two stages' 24 products go into d back
  // to back, then d is added into acc.
  uint32_t a0b[4][4], a0s[4][4], a1b[4][4], a1s[4][4];
  fetch(a0b, a0s, 0);
  for (int it = 0; it < KT; it += 2) {  // KT is even
    mma(a0b, a0s, it, true);
    fetch(a1b, a1s, it + 1);
    mma(a1b, a1s, it + 1, false);
    wgmma_wait<1>();
    mbar_arrive(smem_u32(&empty[it % kStages]));
    if (it + 2 < KT) fetch(a0b, a0s, it + 2);
    retire(it + 1);
  }

  const int tp3 = args.T + 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + row + 8 * i;
    if (r >= args.M) continue;
    if constexpr (kSynth) {
      const float* w = args.norm + static_cast<size_t>(r % tp3) * args.hop_pad;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= args.hop_pad) continue;
        const float2 w2 = *reinterpret_cast<const float2*>(w + col);
        *reinterpret_cast<float2*>(args.y + static_cast<size_t>(r) * args.hop_pad + col) =
            make_float2(acc[4 * j + 2 * i] * w2.x, acc[4 * j + 2 * i + 1] * w2.y);
      }
    } else {
      // Rows with r % (T + 3) >= T are skipped: the zero rows stay zero.
      if (r % tp3 >= args.T) continue;
      const size_t base = static_cast<size_t>(r + 3) * args.f_pad + blockIdx.x * 64 + 2 * t;
      float2 pr[8], pi[8], mg[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        pr[j] = *reinterpret_cast<const float2*>(args.pre + base + 8 * j);
        pi[j] = *reinterpret_cast<const float2*>(args.pim + base + 8 * j);
        mg[j] = __ldg(reinterpret_cast<const float2*>(args.mag + base + 8 * j));
      }
      const float m = args.momentum;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const size_t idx = base + 8 * j;
        const float ar0 = acc[4 * j + 2 * i], ar1 = acc[4 * j + 2 * i + 1];
        const float ai0 = acc[4 * (j + 8) + 2 * i], ai1 = acc[4 * (j + 8) + 2 * i + 1];
        const float ur0 = ar0 + m * (ar0 - pr[j].x), ur1 = ar1 + m * (ar1 - pr[j].y);
        const float ui0 = ai0 + m * (ai0 - pi[j].x), ui1 = ai1 + m * (ai1 - pi[j].y);
        *reinterpret_cast<float2*>(args.pre + idx) = make_float2(ar0, ar1);
        *reinterpret_cast<float2*>(args.pim + idx) = make_float2(ai0, ai1);
        const float s0 = mg[j].x * rsqrtf(ur0 * ur0 + ui0 * ui0 + 1e-12f);
        const float s1 = mg[j].y * rsqrtf(ur1 * ur1 + ui1 * ui1 + 1e-12f);
        *reinterpret_cast<float2*>(args.re + idx) = make_float2(ur0 * s0, ur1 * s1);
        *reinterpret_cast<float2*>(args.im + idx) = make_float2(ui0 * s0, ui1 * s1);
      }
    }
  }
}

// An f32 tensor map with 128-byte swizzle and a (32, 128[, 1]) box;
// elements outside the tensor read as zero. dims innermost first, strides
// in bytes for dims 1.. .
int encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides) {
  const cuuint32_t box[3] = {kBK, kBM, 1};
  return hopper::encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, ptr, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool kSynth>
int launch(const CUtensorMap& a0, const CUtensorMap& a1, const CUtensorMap& b, const Args& args,
           dim3 grid, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(gl_tf32_kernel<kSynth>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  gl_tf32_kernel<kSynth><<<grid, kThreads, kSmemBytes, stream>>>(a0, a1, b, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One synthesis: re/im (B(T+3) + 3, f_pad) f32 carries, ws (16, hop_pad,
// f_pad) the split inverse maps, norm (T+3, hop_pad) → y (B(T+3), hop_pad).
int gl_synth_ola(const float* re, const float* im, const float* ws, const float* norm, float* y,
                 int B, int T, int f_pad, int hop_pad, void* stream) {
  Args args{};
  args.M = B * (T + 3);
  args.T = T;
  args.f_pad = f_pad;
  args.hop_pad = hop_pad;
  args.norm = norm;
  args.y = y;
  CUtensorMap m_re, m_im, m_ws;
  const cuuint64_t carry_dims[2] = {static_cast<cuuint64_t>(f_pad),
                                    static_cast<cuuint64_t>(args.M + 3)};
  const cuuint64_t carry_strides[1] = {static_cast<cuuint64_t>(f_pad) * 4};
  const cuuint64_t ws_dims[3] = {static_cast<cuuint64_t>(f_pad), static_cast<cuuint64_t>(hop_pad),
                                 16};
  const cuuint64_t ws_strides[2] = {static_cast<cuuint64_t>(f_pad) * 4,
                                    static_cast<cuuint64_t>(f_pad) * hop_pad * 4};
  int code = encode(&m_re, re, 2, carry_dims, carry_strides);
  if (code == 0) code = encode(&m_im, im, 2, carry_dims, carry_strides);
  if (code == 0) code = encode(&m_ws, ws, 3, ws_dims, ws_strides);
  if (code != 0) return code;
  const dim3 grid((hop_pad + kBN - 1) / kBN, (args.M + kBM - 1) / kBM);
  return launch<true>(m_re, m_im, m_ws, args, grid, static_cast<cudaStream_t>(stream));
}

// One analysis with the momentum and projection epilogue: y (B(T+3),
// hop_pad), wa (2, 2 f_pad, 4 hop_pad) the split forward maps; mag, pre,
// pim, re, im (B(T+3) + 3, f_pad) f32 carries.
int gl_analyze_project(const float* y, const float* wa, const float* mag, float* pre, float* pim,
                       float* re, float* im, int B, int T, int f_pad, int hop_pad,
                       float momentum, void* stream) {
  Args args{};
  args.M = B * (T + 3);
  args.T = T;
  args.f_pad = f_pad;
  args.hop_pad = hop_pad;
  args.mag = mag;
  args.pre = pre;
  args.pim = pim;
  args.re = re;
  args.im = im;
  args.momentum = momentum;
  CUtensorMap m_y, m_wa;
  const cuuint64_t y_dims[2] = {static_cast<cuuint64_t>(hop_pad), static_cast<cuuint64_t>(args.M)};
  const cuuint64_t y_strides[1] = {static_cast<cuuint64_t>(hop_pad) * 4};
  const cuuint64_t wa_dims[3] = {static_cast<cuuint64_t>(4 * hop_pad),
                                 static_cast<cuuint64_t>(2 * f_pad), 2};
  const cuuint64_t wa_strides[2] = {static_cast<cuuint64_t>(4 * hop_pad) * 4,
                                    static_cast<cuuint64_t>(8) * hop_pad * f_pad * 4};
  int code = encode(&m_y, y, 2, y_dims, y_strides);
  if (code == 0) code = encode(&m_wa, wa, 3, wa_dims, wa_strides);
  if (code != 0) return code;
  const dim3 grid(f_pad / 64, (args.M + kBM - 1) / kBM);
  return launch<false>(m_y, m_y, m_wa, args, grid, static_cast<cudaStream_t>(stream));
}

// Every library of csrc/ exports error_string (see ops/kernels/_build.py).
const char* error_string(int code) { return hopper::error_string(code); }

}  // extern "C"
