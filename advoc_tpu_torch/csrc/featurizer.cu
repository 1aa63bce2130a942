// Fused featurizer on Hopper's tensor cores: waveform -> r9y9 normalized mel
// in one launch.
//
// Counterpart of the Pallas kernel fused_melspec / _featurizer_kernel
// (advoc_tpu/ops/pallas/featurizer.py), which runs its products at
// Precision.HIGHEST: the log turns reduced-precision error in quiet bins
// into large errors in dB. Here every product runs on the tensor cores in
// 3xTF32: an operand a is split into big = tf32_rna(a) and small =
// tf32_rna(a - big), and big*big + big*small + small*big is summed in f32,
// which holds fp32 accuracy (the small*small term is below f32 rounding).
//
// One CTA per (row, tile of 64 G frames), G consumer warpgroups of 64
// frames and one producer warp. G = 2 where the window fits (hop <= 256)
// and the 128-frame tiles fill the card at least once (B = 128 rows of
// 256 frames: 256 CTAs); G = 1 otherwise (one 1024-frame utterance: 16
// CTAs, not 8). Each hop block is padded with zeros to hb = hop rounded up
// to 16 samples, one K slice, and the maps are zero there, so any hop runs:
//
//   1. The tile's (64 G + 3) hop blocks of the reflect-padded row are read
//      once into shared memory, block i at i * (hb + 4) floats (the pitch
//      spreads a fragment's rows over all banks). Padded sample p is
//      x[|p - pad|] on the left, x[2(L-1) - (p - pad)] on the right and 0
//      past L + 2 pad, so neither the padding nor the frames exist in
//      device memory. Frame t's band k is block t + k: the banded form of
//      the JAX kernel, frame t @ W = sum_k block[t + k] @ W_k.
//   2. For each chunk of 64 of the 384 kept bins, re/im[t, f] is a
//      (64 G x 4 hb) @ (4 hb x 128) product (window folded into the maps):
//      wgmma m64n128k8 tf32 with A, the audio, from registers (a thread
//      loads its fragment from the window at its band's row offset and
//      splits it) and B, the maps, from shared memory. The host splits the
//      maps and stores them K-major (bins x samples), each 128-row chunk
//      64 cosine bins then the same 64 sine bins, so a thread's accumulator
//      holds re and im of the same bins and |X| is taken in registers.
//      While a 16-sample K slice's products run, the next slice's
//      fragments are loaded into a second register set.
//   3. The mel fold is a second product, mel[t, m] += |X|[t, f] mel_t[f, m],
//      wgmma m64n80k8 tf32 with |X| as the A fragment straight from the
//      DFT accumulator: a thread holds bins 8j + 2t' and 8j + 2t' + 1 of
//      its rows (t' = lane % 4), which serve as the fragment's columns t'
//      and t' + 4 once the host orders each 8-bin group of the filterbank
//      (0, 2, 4, 6, 1, 3, 5, 7). |X| is never staged in shared memory.
//   4. dB, normalize and clip; only the (64 G, n_mels) result is written.
//
// The producer streams, per chunk, the K slices of the big and small maps
// and then four 16-bin slices of the big and small filterbank, with TMA
// (64-byte swizzle) through a ring of 5 stages (2 where a hop above 544
// leaves no room for more; hop <= 736); maps and filterbank (6.5 MB) stay
// in L2. Each output is computed by one thread in a fixed order: no
// atomics, deterministic.
//
// Bound: 2*2*1024*384 + 2*384*80 FLOP per frame against 4 bytes of audio
// per sample: operations. The work counted once is 0.054 ms at the bf16
// tensor-core rate; 3xTF32 does it three times at the TF32 rate (495
// TFLOP/s), a ceiling of 0.32 ms at B=128 x 65536 samples.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBins = 64;        // bins per chunk
constexpr int kKept = 384;       // F_KEPT: bins of the DFT maps
constexpr int kChunks = kKept / kBins;
constexpr int kMels = 80;        // filterbank rows (n_mels <= 80, zero beyond)
constexpr int kBK = 16;          // f32 per 64-byte swizzled row: one K slice
constexpr int kTileB = 2 * kBins * kBK * 4;  // one map tile (128 rows), 8 KB
constexpr int kTileM = kMels * kBK * 4;      // one filterbank tile (80 rows), 5 KB
constexpr int kMelSlices = kBins / kBK;      // filterbank slices per chunk
constexpr int kSmemLimit = 232448;  // a CTA's shared memory on an H100

// A hop block padded to whole K slices, and its pitch in shared memory.
__host__ __device__ constexpr int block_width(int hop) { return (hop + kBK - 1) / kBK * kBK; }
__host__ __device__ constexpr int win_pitch(int hb) { return hb + 4; }

int smem_bytes(int frames, int hb, int stages) {
  return stages * 2 * kTileB + 4 * (frames + 3) * win_pitch(hb) + 2 * stages * 8 + 1024;
}

// d[64 x 80] += A[64 x 8] B[8 x 80], as wgmma_tf32_128.
__device__ __forceinline__ void wgmma_tf32_80(float (&d)[40], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// map_big, map_small: the split DFT maps (2 kKept rows, 4 hb samples);
// mel_big, mel_small: the split filterbank (kMels rows, kKept bins), each
// 8-bin group in the order (0, 2, 4, 6, 1, 3, 5, 7). All f32. kWG consumer
// warpgroups of 64 frames; a ring of kStages (big + small) tiles.
template <int kWG, int kStages>
__global__ void __launch_bounds__(128 * kWG + 32, 1)
    featurizer_kernel(const __grid_constant__ CUtensorMap map_big,
                      const __grid_constant__ CUtensorMap map_small,
                      const __grid_constant__ CUtensorMap mel_big,
                      const __grid_constant__ CUtensorMap mel_small,
                      const float* __restrict__ x, float* __restrict__ out, int L, int hop,
                      int n_frames, int n_tiles, int n_mels, float amp_floor, float ref_db,
                      float min_db) {
  constexpr int kFrames = 64 * kWG;
  constexpr int kConsumers = 128 * kWG;
  constexpr int kThreads = kConsumers + 32;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int hb = block_width(hop), pitch = win_pitch(hb);
  uint8_t* ring = smem;                                                // [kStages][big, small]
  float* win = reinterpret_cast<float*>(ring + kStages * 2 * kTileB);  // [kFrames + 3][pitch]
  uint64_t* full = reinterpret_cast<uint64_t*>(win + (kFrames + 3) * pitch);
  uint64_t* empty = full + kStages;

  const int row = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - row * n_tiles) * kFrames;
  const int pad = 2 * hop;  // n_fft / 2
  const int KT = 4 * hb / kBK;  // DFT K slices per chunk

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumers);
    }
    mbar_fence_init();
  }
  // 1. The reflect-padded audio window, each block zero from hop to hb.
  const float* xr = x + static_cast<long long>(row) * L;
  for (int i = threadIdx.x; i < (kFrames + 3) * hb; i += kThreads) {
    const int blk = i / hb, s = i - blk * hb;
    const int p = (t0 + blk) * hop + s;
    float v = 0.f;
    if (s < hop && p < L + 2 * pad) {
      int j = p - pad;
      if (j < 0) j = -j;
      else if (j >= L) j = 2 * L - 2 - j;
      v = __ldg(xr + j);
    }
    win[blk * pitch + s] = v;
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer: one thread streams, chunk by chunk, the maps' K slices and
    // then the chunk's filterbank slices.
    if (threadIdx.x != kConsumers) return;
    int it = 0;
    for (int c = 0; c < kChunks; ++c) {
      for (int kt = 0; kt < KT + kMelSlices; ++kt, ++it) {
        const int s = it % kStages, round = it / kStages;
        if (round > 0) mbar_wait(smem_u32(&empty[s]), (round - 1) & 1);
        const uint32_t dst = smem_u32(ring + s * 2 * kTileB);
        const uint32_t bar = smem_u32(&full[s]);
        if (kt < KT) {
          mbar_expect_tx(bar, 2 * kTileB);
          tma_2d(dst, &map_big, bar, kt * kBK, c * 2 * kBins);
          tma_2d(dst + kTileB, &map_small, bar, kt * kBK, c * 2 * kBins);
        } else {
          const int f0 = c * kBins + (kt - KT) * kBK;
          mbar_expect_tx(bar, 2 * kTileM);
          tma_2d(dst, &mel_big, bar, f0, 0);
          tma_2d(dst + kTileB, &mel_small, bar, f0, 0);
        }
      }
    }
    return;
  }

  // Consumers. Accumulator layout of m64nNk8: warp w of the warpgroup holds
  // rows 16w .. 16w + 15; d[4j + 2i + e] is row lane/4 + 8i, column
  // 8j + 2(lane % 4) + e. The tf32 A fragment: a[0] (row g, column t),
  // a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4).
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = wg * 64 + warp * 16 + g;  // this thread's first frame in the tile

  // A fragments of DFT K slice kt (two k8 steps), split into big and small.
  auto load_a = [&](uint32_t (&ab)[2][4], uint32_t (&as)[2][4], int kt) {
    const int n0 = kt * kBK, band = n0 / hb, s0 = n0 - band * hb;
    const float* a_row = win + (r0 + band) * pitch + s0 + t;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tf32_split(a_row[(e & 1) * 8 * pitch + kk * 8 + (e >> 1) * 4], ab[kk][e], as[kk][e]);
  };
  float d[64], mel[40];
#pragma unroll
  for (int i = 0; i < 40; ++i) mel[i] = 0.f;
  // The three products of DFT stage it, one commit group.
  auto issue = [&](uint32_t (&ab)[2][4], uint32_t (&as)[2][4], int it) {
    const int s = it % kStages;
    mbar_wait(smem_u32(&full[s]), (it / kStages) & 1);
    const uint32_t b_big = smem_u32(ring + s * 2 * kTileB);
    const uint32_t b_small = b_big + kTileB;
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wgmma_tf32_128(d, as[kk], sw64_desc(b_big + kk * 32));
      wgmma_tf32_128(d, ab[kk], sw64_desc(b_small + kk * 32));
      wgmma_tf32_128(d, ab[kk], sw64_desc(b_big + kk * 32));
    }
    wgmma_commit();
  };
  auto release = [&](int it) { mbar_arrive(smem_u32(&empty[it % kStages])); };

  uint32_t a0b[2][4], a0s[2][4], a1b[2][4], a1s[2][4];
  int it = 0;
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    // 2. Two register sets: one slice's products run while the next
    // slice's fragments are loaded; a stage is released once its group is
    // done.
    load_a(a0b, a0s, 0);
    for (int kt = 0; kt < KT; kt += 2, it += 2) {
      issue(a0b, a0s, it);
      if (kt > 0) {
        wgmma_wait<1>();
        release(it - 1);
      }
      load_a(a1b, a1s, kt + 1);
      issue(a1b, a1s, it + 1);
      wgmma_wait<1>();
      release(it);
      if (kt + 2 < KT) load_a(a0b, a0s, kt + 2);
    }
    wgmma_wait<0>();
    fence_regs(d);
    release(it - 1);

    // 3. |X| in registers, then the fold: filterbank slice sm holds bins
    // 16 sm .. 16 sm + 15 of the chunk, the accumulator's columns j = 2 sm,
    // 2 sm + 1 (re) and j + 8 (im).
#pragma unroll
    for (int sm = 0; sm < kMelSlices; ++sm, ++it) {
      uint32_t mb[2][4], ms[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * sm + kk, i = e & 1, col = e >> 1;
          const float re = d[4 * j + 2 * i + col], im = d[4 * (j + 8) + 2 * i + col];
          tf32_split(sqrtf(re * re + im * im), mb[kk][e], ms[kk][e]);
        }
      const int s = it % kStages;
      mbar_wait(smem_u32(&full[s]), (it / kStages) & 1);
      const uint32_t b_big = smem_u32(ring + s * 2 * kTileB);
      const uint32_t b_small = b_big + kTileB;
      fence_regs(mel);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        wgmma_tf32_80(mel, ms[kk], sw64_desc(b_big + kk * 32));
        wgmma_tf32_80(mel, mb[kk], sw64_desc(b_small + kk * 32));
        wgmma_tf32_80(mel, mb[kk], sw64_desc(b_big + kk * 32));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(mel);
      release(it);
    }
  }

  // 4. dB, normalize, clip.
  const float inv_range = 1.f / -min_db;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tf = t0 + r0 + 8 * i;
    if (tf >= n_frames) continue;
    float* o = out + (static_cast<long long>(row) * n_frames + tf) * n_mels;
#pragma unroll
    for (int j = 0; j < kMels / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * j + 2 * t + e;
        if (m >= n_mels) continue;
        const float db = 20.f * log10f(fmaxf(amp_floor, mel[4 * j + 2 * i + e])) - ref_db;
        o[m] = fminf(fmaxf((db - min_db) * inv_range, 0.f), 1.f);
      }
  }
}

template <int kWG, int kStages>
int launch(const CUtensorMap (&maps)[4], const float* x, float* out, int B, int L, int hop,
           int n_frames, int n_mels, float amp_floor, float ref_db, float min_db,
           cudaStream_t stream) {
  const int n_tiles = (n_frames + 64 * kWG - 1) / (64 * kWG);
  const int smem = smem_bytes(64 * kWG, block_width(hop), kStages);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(featurizer_kernel<kWG, kStages>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  featurizer_kernel<kWG, kStages><<<B * n_tiles, 128 * kWG + 32, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], x, out, L, hop, n_frames, n_tiles, n_mels, amp_floor,
      ref_db, min_db);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (B, L) fp32; w_big, w_small (768, 4 hb) fp32, the split maps with each
// hop block zero-padded to hb = hop rounded up to 16, and mel_big,
// mel_small (80, 384) fp32, the split filterbank
// (ops/kernels/featurizer.py:_tc_consts); out (B, L/hop, n_mels). Needs
// n_mels <= 80 and L > 2 hop (checked by the wrapper); a hop above 736,
// whose audio window would not fit in shared memory, returns
// cudaErrorInvalidValue.
int fused_melspec(const float* x, const float* w_big, const float* w_small,
                  const float* mel_big, const float* mel_small, float* out, int B, int L,
                  int hop, int n_mels, float amp_floor, float ref_db, float min_db,
                  void* stream) {
  const int n_frames = L / hop, hb = block_width(hop);
  if (B == 0 || n_frames == 0) return 0;
  CUtensorMap maps[4];
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(4 * hb), 2 * kKept};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(4 * hb) * 4};
  const cuuint32_t box[2] = {kBK, 2 * kBins};
  const cuuint64_t mel_dims[2] = {kKept, kMels};
  const cuuint64_t mel_strides[1] = {kKept * 4};
  const cuuint32_t mel_box[2] = {kBK, kMels};
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_64B;
  int code = encode(&maps[0], f32, 2, w_big, dims, strides, box, sw);
  if (code == 0) code = encode(&maps[1], f32, 2, w_small, dims, strides, box, sw);
  if (code == 0) code = encode(&maps[2], f32, 2, mel_big, mel_dims, mel_strides, mel_box, sw);
  if (code == 0) code = encode(&maps[3], f32, 2, mel_small, mel_dims, mel_strides, mel_box, sw);
  if (code != 0) return code;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const long long wide_ctas = static_cast<long long>(B) * ((n_frames + 127) / 128);
  if (hb <= 256 && wide_ctas >= sms)
    return launch<2, 5>(maps, x, out, B, L, hop, n_frames, n_mels, amp_floor, ref_db, min_db, s);
  if (smem_bytes(64, hb, 5) <= kSmemLimit)  // hop <= 544
    return launch<1, 5>(maps, x, out, B, L, hop, n_frames, n_mels, amp_floor, ref_db, min_db, s);
  return launch<1, 2>(maps, x, out, B, L, hop, n_frames, n_mels, amp_floor, ref_db, min_db, s);
}

// Every library of csrc/ exports error_string (see ops/kernels/_build.py).
const char* error_string(int code) { return hopper::error_string(code); }

}  // extern "C"
