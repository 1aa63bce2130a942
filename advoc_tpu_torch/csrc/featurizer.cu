// Fused featurizer on Hopper: waveform -> r9y9 normalized mel in one launch.
//
// Counterpart of the Pallas kernel fused_melspec / _featurizer_kernel
// (advoc_tpu/ops/pallas/featurizer.py). One CTA per (row, 64-frame tile):
//
//   1. The tile's (64 + 3) * hop samples of the reflect-padded row are read
//      once into shared memory. Padded sample p is x[|p - pad|] on the left,
//      x[2(L-1) - (p - pad)] on the right and 0 past L + 2 pad, so neither
//      the padding nor the frames exist in device memory. Frame t of the
//      tile is the contiguous n_fft-sample window starting at t * hop.
//   2. For each chunk of 64 of the 384 kept bins: re/im[t, f] =
//      sum_n audio[t * hop + n] * W_cos/W_sin[n, f], a (64 x 1024) @
//      (1024 x 128) fp32 product (window folded into the maps). The map
//      columns stream through shared memory in 16-row K slices, double
//      buffered through registers; the maps (3.1 MB) stay in L2. Warp w owns
//      frames 8w .. 8w+7 and lane l bins 2l, 2l+1 of the chunk, real and
//      imaginary, so the audio reads are warp-wide broadcasts and the map
//      reads one conflict-free float2 per lane.
//   3. |.| in registers, staged in shared memory, and folded into the mel
//      sums: thread (tid/16, tid%16) keeps 4 frames x 5 bands in registers
//      across the six chunks.
//   4. dB, normalize and clip; only the (64, n_mels) result is written.
//
// All products are fp32 FMA (the JAX kernel runs its MXU products at
// Precision.HIGHEST for the same reason: the log amplifies the error of
// reduced precision in quiet bins). Each output is computed by one thread in
// a fixed order: no atomics, deterministic.
//
// Bound: operations (2*2*1024*384 + 2*384*80 FLOP per frame against 4 bytes
// of audio per sample); the fp32 CUDA cores are the ceiling of this form.

#include <cuda_runtime.h>

namespace {

constexpr int kTBlk = 64;      // frames per CTA
constexpr int kBins = 64;      // bins per chunk
constexpr int kKept = 384;     // F_KEPT: columns of the DFT maps
constexpr int kMelPad = 128;   // MEL_PAD: row pitch of mel_t
constexpr int kBK = 16;        // K slice of the map stream
constexpr int kThreads = 256;
constexpr int kMagPitch = kBins + 2;
constexpr int kMelsPerThread = 5;  // 16 x 5 = 80 bands

__global__ void __launch_bounds__(kThreads, 2)
featurizer_kernel(const float* __restrict__ x, const float* __restrict__ w_cos,
                  const float* __restrict__ w_sin,
                  const float* __restrict__ mel_t, float* __restrict__ out,
                  int L, int hop, int n_frames, int n_tiles, int n_mels,
                  float amp_floor, float ref_db, float min_db) {
  extern __shared__ __align__(16) float smem[];
  const int win = (kTBlk + 3) * hop;
  float* audio = smem;                        // [win]
  float* bs = audio + win;                    // [2][kBK][2 * kBins]
  float* mag_s = bs + 2 * kBK * 2 * kBins;    // [kTBlk][kMagPitch]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - row * n_tiles) * kTBlk;
  const int pad = 2 * hop;  // n_fft / 2
  const float* xr = x + static_cast<long long>(row) * L;

  // 1. The reflect-padded audio window.
  for (int i = tid; i < win; i += kThreads) {
    const int p = t0 * hop + i;
    float v = 0.f;
    if (p < L + 2 * pad) {
      int j = p - pad;
      if (j < 0) j = -j;
      else if (j >= L) j = 2 * L - 2 - j;
      v = __ldg(xr + j);
    }
    audio[i] = v;
  }

  const int nfft = 4 * hop;
  const int KT = nfft / kBK;
  const int b_row = tid / 16, b_c4 = (tid % 16) * 4;
  const float* a_base = audio + warp * 8 * hop;

  // 3. Mel sums: frames mf0 .. mf0+3, bands mm0 .. mm0+4.
  const int mf0 = (tid / 16) * 4, mm0 = (tid % 16) * kMelsPerThread;
  float mel[4][kMelsPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMelsPerThread; ++j) mel[i][j] = 0.f;

  for (int c0 = 0; c0 < kKept; c0 += kBins) {
    float4 rb_re, rb_im;
    auto load = [&](int kt) {
      const int idx = (kt * kBK + b_row) * kKept + c0 + b_c4;
      rb_re = __ldg(reinterpret_cast<const float4*>(w_cos + idx));
      rb_im = __ldg(reinterpret_cast<const float4*>(w_sin + idx));
    };
    auto store = [&](int buf) {
      float* dst = bs + (buf * kBK + b_row) * 2 * kBins;
      *reinterpret_cast<float4*>(dst + b_c4) = rb_re;
      *reinterpret_cast<float4*>(dst + kBins + b_c4) = rb_im;
    };

    float acc_re[8][2], acc_im[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc_re[i][0] = acc_re[i][1] = 0.f;
      acc_im[i][0] = acc_im[i][1] = 0.f;
    }

    load(0);
    store(0);
    __syncthreads();  // the audio window and the first K slice
    for (int kt = 0; kt < KT; ++kt) {
      const int cur = kt & 1;
      if (kt + 1 < KT) load(kt + 1);
      const float* bk = bs + cur * kBK * 2 * kBins;
      const int n0 = kt * kBK;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 4) {
        float4 a4[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a4[i] = *reinterpret_cast<const float4*>(a_base + i * hop + n0 + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 br = *reinterpret_cast<const float2*>(bk + (kk + j) * 2 * kBins + 2 * lane);
          const float2 bi =
              *reinterpret_cast<const float2*>(bk + (kk + j) * 2 * kBins + kBins + 2 * lane);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float a = j == 0 ? a4[i].x : j == 1 ? a4[i].y : j == 2 ? a4[i].z : a4[i].w;
            acc_re[i][0] = fmaf(a, br.x, acc_re[i][0]);
            acc_re[i][1] = fmaf(a, br.y, acc_re[i][1]);
            acc_im[i][0] = fmaf(a, bi.x, acc_im[i][0]);
            acc_im[i][1] = fmaf(a, bi.y, acc_im[i][1]);
          }
        }
      }
      if (kt + 1 < KT) store(cur ^ 1);
      __syncthreads();
    }

    // |.| of this chunk into shared memory.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float2 m;
      m.x = sqrtf(acc_re[i][0] * acc_re[i][0] + acc_im[i][0] * acc_im[i][0]);
      m.y = sqrtf(acc_re[i][1] * acc_re[i][1] + acc_im[i][1] * acc_im[i][1]);
      *reinterpret_cast<float2*>(mag_s + (warp * 8 + i) * kMagPitch + 2 * lane) = m;
    }
    __syncthreads();

    // Fold the chunk into the mel sums (mel_t rows c0 .. c0+63).
    for (int f = 0; f < kBins; ++f) {
      float w[kMelsPerThread];
#pragma unroll
      for (int j = 0; j < kMelsPerThread; ++j)
        w[j] = mm0 + j < n_mels ? __ldg(mel_t + (c0 + f) * kMelPad + mm0 + j) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float m = mag_s[(mf0 + i) * kMagPitch + f];
#pragma unroll
        for (int j = 0; j < kMelsPerThread; ++j) mel[i][j] = fmaf(m, w[j], mel[i][j]);
      }
    }
    // The next chunk writes mag_s only after its K loop's barriers.
  }

  // 4. dB, normalize, clip.
  const float inv_range = 1.f / -min_db;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + mf0 + i;
    if (t >= n_frames) continue;
    float* o = out + (static_cast<long long>(row) * n_frames + t) * n_mels;
#pragma unroll
    for (int j = 0; j < kMelsPerThread; ++j) {
      if (mm0 + j >= n_mels) continue;
      const float db = 20.f * log10f(fmaxf(amp_floor, mel[i][j])) - ref_db;
      o[mm0 + j] = fminf(fmaxf((db - min_db) * inv_range, 0.f), 1.f);
    }
  }
}

}  // namespace

extern "C" {

// x (B, L) fp32; w_cos, w_sin (4 hop, 384); mel_t (384, 128); out (B, L/hop,
// n_mels). Needs hop % 4 == 0, n_mels <= 80 and L > 2 hop (checked by the
// wrapper).
int fused_melspec(const float* x, const float* w_cos, const float* w_sin,
                  const float* mel_t, float* out, int B, int L, int hop,
                  int n_mels, float amp_floor, float ref_db, float min_db,
                  void* stream) {
  const int n_frames = L / hop;
  const int n_tiles = (n_frames + kTBlk - 1) / kTBlk;
  if (B == 0 || n_tiles == 0) return 0;
  const size_t smem =
      sizeof(float) * ((kTBlk + 3) * hop + 2 * kBK * 2 * kBins + kTBlk * kMagPitch);
  cudaError_t err = cudaFuncSetAttribute(
      featurizer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  featurizer_kernel<<<B * n_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w_cos, w_sin, mel_t, out, L, hop, n_frames, n_tiles, n_mels, amp_floor, ref_db,
      min_db);
  return static_cast<int>(cudaGetLastError());
}

// Every library of csrc/ exports error_string (see ops/kernels/_build.py).
const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
