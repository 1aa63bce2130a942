// Fast Griffin-Lim on Hopper: the two GEMM-shaped launches of one iteration.
//
// Counterpart of the Pallas kernels griffin_lim_pallas and
// griffin_lim_pallas_tiled (advoc_tpu/ops/pallas/griffin_lim.py), which keep
// a chunk's whole state in the TPU's VMEM. Here the state lives in device
// memory and every iteration is two launches spread over all SMs:
//
//   gl_synth_ola        y[b, j, s] = norm[j, s] * sum_{k<4} sum_f
//                         re[b, j-k, f] inv_re[f, hop*k+s] + im[b, j-k, f] inv_im[f, hop*k+s]
//                       a banded GEMM, M = B(T+3) rows, N = hop, K = 4 * 2F;
//                       rows j-k outside [0, T) contribute 0.
//   gl_analyze_project  acc_re[b, t, f] = sum_{k<4} y[b, t+k, :] . fwd_re[hop*k : hop*(k+1), f]
//                       (acc_im likewise; the A row (b, t) is the contiguous
//                       n_fft-float window of y starting at block t), then the
//                       momentum step and the projection onto |mag|:
//                         u = acc + m (acc - pre);  pre = acc;
//                         (re, im) = u * mag * rsqrt(u_re^2 + u_im^2 + 1e-12).
//
// Both are plain fp32 FMA GEMMs with shared-memory tiling: a 128 x 128 block
// tile, a 16-deep K slice double-buffered in shared memory, and an 8 x 8
// register tile per thread. Each output element is written by exactly one
// thread: no atomics, deterministic. The analysis tile's 128 columns are 64
// frequency bins of the real map followed by the same 64 bins of the
// imaginary map, so each thread holds acc_re and acc_im of the same (t, f)
// and the epilogue stays local. F may be n_fft/2 or n_fft/2 + 1; the ragged
// bins are masked, not padded.
//
// hop is a runtime argument (n_fft = 4 hop). Where hop % 4 == 0 the hop
// blocks and map rows are 16-byte aligned and the kernels move float4s
// (kVec); any other hop takes the same kernels with masked scalar loads.

#include <cuda_runtime.h>

namespace {

constexpr int kR = 4;               // frames overlapping one hop block (n_fft / hop)
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int kThreads = 256;
constexpr int kApad = 4;            // keeps float4 alignment of As rows

struct Smem {
  float a[2][BK][BM + kApad];
  float b[2][BK][BN];
};

// One thread's 8 x 8 register tile: rows {ty*4 + i, 64 + ty*4 + i}, cols
// {tx*4 + j, 64 + tx*4 + j}, i, j < 4.
__device__ __forceinline__ void mma_tile(const Smem& sm, int buf, int tx,
                                         int ty, float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float a[8], b[8];
    const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[buf][k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[buf][k][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[buf][k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[buf][k][64 + tx * 4]);
    a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
    a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ int tile_row(int ty, int i) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}

// The n (<= 0 .. >= 4) valid floats from p, zeros past them. With kVec the
// caller guarantees p is 16-byte aligned and n <= 0 or n >= 4.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p, int n) {
  if constexpr (kVec)
    return n > 0 ? __ldg(reinterpret_cast<const float4*>(p))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(n > 0 ? __ldg(p) : 0.f, n > 1 ? __ldg(p + 1) : 0.f,
                     n > 2 ? __ldg(p + 2) : 0.f, n > 3 ? __ldg(p + 3) : 0.f);
}

// ---------------------------------------------------------------------------
// Synthesis + overlap-add + NOLA norm.
// ---------------------------------------------------------------------------

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
synth_ola_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 const float* __restrict__ inv_re,
                 const float* __restrict__ inv_im,
                 const float* __restrict__ norm, float* __restrict__ y,
                 int B, int T, int F, int hop) {
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int nb = T + kR - 1;          // hop blocks per row of y
  const int M = B * nb;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;     // first output sample within the hop
  const int nfc = (F + BK - 1) / BK;  // K slices per (k, re/im) band
  const int KT = kR * 2 * nfc;

  // A: this thread loads rows tid/4 and tid/4 + 64, columns c4 .. c4+3
  // (scalar loads: with F = 513 the rows of re/im are not 16-byte aligned).
  const int c4 = (tid % 4) * 4;
  int a_j[2];      // frame-block index j of the row, or a huge negative
  int a_base[2];   // offset of (b, j, 0) in re/im, i.e. (b*T + j)*F
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gm = m0 + tid / 4 + 64 * r;
    const int b = gm / nb, j = gm - b * nb;
    a_j[r] = gm < M ? j : -(1 << 30);
    a_base[r] = gm < M ? (b * T + j) * F : 0;
  }
  // B: rows tid/32 and tid/32 + 8 of the K slice, columns (tid%32)*4 .. +3
  // (inv rows are n_fft floats long).
  const int b_c4 = (tid % 32) * 4;
  const int nfft = kR * hop;

  float ra[8];
  float4 rb[2];
  auto load = [&](int kt) {
    const int kidx = kt / (2 * nfc);
    const int rem = kt - kidx * 2 * nfc;
    const int part = rem / nfc;
    const int f0 = (rem - part * nfc) * BK;
    const float* src = part ? im : re;
    const float* map = part ? inv_im : inv_re;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = a_j[r] - kidx;
      const bool row_ok = t >= 0 && t < T;
      const float* row = src + a_base[r] - kidx * F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + c4 + j;
        ra[r * 4 + j] = (row_ok && f < F) ? __ldg(row + f) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int fr = f0 + tid / 32 + 8 * r;
      rb[r] = load4<kVec>(map + fr * nfft + kidx * hop + n0 + b_c4,
                          fr < F ? hop - (n0 + b_c4) : 0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.a[buf][c4 + j][tid / 4 + 64 * r] = ra[r * 4 + j];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float4*>(&sm.b[buf][tid / 32 + 8 * r][b_c4]) = rb[r];
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
    mma_tile(sm, cur, tx, ty, acc);
    if (kt + 1 < KT) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + tile_row(ty, i);
    if (gm >= M) continue;
    const int j = gm % nb;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = n0 + h * 64 + tx * 4;
      if (s >= hop) continue;
      const float* w = norm + j * hop + s;
      float* o = y + gm * hop + s;
      if constexpr (kVec) {
        const float4 w4 = *reinterpret_cast<const float4*>(w);
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][h * 4 + 0] * w4.x, acc[i][h * 4 + 1] * w4.y,
                        acc[i][h * 4 + 2] * w4.z, acc[i][h * 4 + 3] * w4.w);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (s + c < hop) o[c] = acc[i][h * 4 + c] * w[c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Analysis + momentum + magnitude projection.
// ---------------------------------------------------------------------------

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
analyze_project_kernel(const float* __restrict__ y,
                       const float* __restrict__ fwd_re,
                       const float* __restrict__ fwd_im,
                       const float* __restrict__ mag, float* __restrict__ re,
                       float* __restrict__ im, float* __restrict__ pre,
                       float* __restrict__ pim, int B, int T, int F,
                       int hop, float momentum) {
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int nb = T + kR - 1;
  const int M = B * T;
  const int m0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * (BN / 2);  // 64 bins, real then imaginary
  const int nfft = kR * hop;
  const int KT = (nfft + BK - 1) / BK;

  // A: rows tid/4 and tid/4 + 64, columns c4 .. c4+3 (one float4 where the
  // hop blocks of y are 16-byte aligned). With kVec, n_fft % BK == 0 and no
  // K slice is ragged: the K masks are left out, which keeps the vector
  // instance free of register spills.
  const int c4 = (tid % 4) * 4;
  int a_base[2];  // offset of y[b, t, 0]; the A row is y's next n_fft floats
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gm = m0 + tid / 4 + 64 * r;
    a_ok[r] = gm < M;
    const int b = gm / T, t = gm - b * T;
    a_base[r] = a_ok[r] ? (b * nb + t) * hop + c4 : 0;
  }
  // B: scalar loads (the maps' rows are F floats, 513 is not aligned).
  const int b_col = tid % BN;
  const int b_f = f0 + (b_col & 63);
  const float* b_map = b_col < 64 ? fwd_re : fwd_im;

  float4 ra[2];
  float rb[8];
  auto load = [&](int kt) {
    const int kk0 = kt * BK;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      ra[r] = load4<kVec>(y + a_base[r] + kk0, !a_ok[r] ? 0 : kVec ? 4 : nfft - kk0 - c4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kk = kk0 + tid / BN + 2 * i;
      rb[i] = b_f < F && (kVec || kk < nfft) ? __ldg(b_map + kk * F + b_f) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = tid / 4 + 64 * r;
      sm.a[buf][c4 + 0][m] = ra[r].x;
      sm.a[buf][c4 + 1][m] = ra[r].y;
      sm.a[buf][c4 + 2][m] = ra[r].z;
      sm.a[buf][c4 + 3][m] = ra[r].w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sm.b[buf][tid / BN + 2 * i][b_col] = rb[i];
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
    mma_tile(sm, cur, tx, ty, acc);
    if (kt + 1 < KT) store(cur ^ 1);
    __syncthreads();
  }

  // Columns tx*4 + j hold the real parts of bins f0 + tx*4 + j and columns
  // 64 + tx*4 + j the imaginary parts of the same bins.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + tile_row(ty, i);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f >= F) continue;
      const int idx = gm * F + f;
      const float ar = acc[i][j], ai = acc[i][4 + j];
      const float ur = ar + momentum * (ar - pre[idx]);
      const float ui = ai + momentum * (ai - pim[idx]);
      pre[idx] = ar;
      pim[idx] = ai;
      const float scale = mag[idx] * rsqrtf(ur * ur + ui * ui + 1e-12f);
      re[idx] = ur * scale;
      im[idx] = ui * scale;
    }
  }
}

}  // namespace

extern "C" {

int gl_synth_ola(const float* re, const float* im, const float* inv_re,
                 const float* inv_im, const float* norm, float* y, int B, int T,
                 int F, int hop, void* stream) {
  const int M = B * (T + kR - 1);
  dim3 grid((M + BM - 1) / BM, (hop + BN - 1) / BN);
  auto s = static_cast<cudaStream_t>(stream);
  if (hop % 4 == 0)
    synth_ola_kernel<true><<<grid, kThreads, 0, s>>>(re, im, inv_re, inv_im,
                                                     norm, y, B, T, F, hop);
  else
    synth_ola_kernel<false><<<grid, kThreads, 0, s>>>(re, im, inv_re, inv_im,
                                                      norm, y, B, T, F, hop);
  return static_cast<int>(cudaGetLastError());
}

int gl_analyze_project(const float* y, const float* fwd_re, const float* fwd_im,
                       const float* mag, float* re, float* im, float* pre,
                       float* pim, int B, int T, int F, int hop,
                       float momentum, void* stream) {
  const int M = B * T;
  dim3 grid((M + BM - 1) / BM, (F + BN / 2 - 1) / (BN / 2));
  auto s = static_cast<cudaStream_t>(stream);
  if (hop % 4 == 0)
    analyze_project_kernel<true><<<grid, kThreads, 0, s>>>(
        y, fwd_re, fwd_im, mag, re, im, pre, pim, B, T, F, hop, momentum);
  else
    analyze_project_kernel<false><<<grid, kThreads, 0, s>>>(
        y, fwd_re, fwd_im, mag, re, im, pre, pim, B, T, F, hop, momentum);
  return static_cast<int>(cudaGetLastError());
}

// Every library of csrc/ exports error_string (see ops/kernels/_build.py).
const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
