// Packed-tail transpose-conv on Hopper: the finest U-Net decoder level's
// k4/s2 ConvTranspose written straight into the packed (B, 2H, W, 2f) layout,
// with the per-(batch, lane) sums GroupNorm needs.
//
// Counterpart of the Pallas kernel packed_up / _packed_up_kernel
// (advoc_tpu/ops/pallas/packed_up.py). The function, for row parity p and
// column parity q (the subpixel map of the transpose):
//
//   z[b, m, n, c] = sum_{u, v in {0,1}} sum_ci x[b, m+p-1+u, n+q-1+v, ci] * wt[2u+p, 2v+q, ci, c]
//   y[b, 2m+p, n, q*f + c] = bf16(bf16(z) + bias[c])      (x outside the image is 0)
//   s1[b, l] = sum_{rows, n} y[b, ., n, l],  s2[b, l] = sum y^2   (f32, of the bf16 y)
//
// Where the TPU kernel folds the column parity into a 3-wide tap window (6
// flat-offset products, 1.5x the minimum work) so that its MXU never shuffles
// lanes, here each CTA owns one parity class (p, q): a GEMM with M = positions
// n, N = f channels and K = 4 taps x cin, the minimum work, on the tensor
// cores (mma.sync m16n8k16, bf16 operands, f32 accumulation). The wrapper
// hands the kernel the weights pre-arranged per class as (4, NP, 4*CP): row
// c, column tap*CP + ci, zero-padded to CP = cin rounded up to 16 and NP = f
// rounded up to 64.
//
// One CTA = (batch b, tm half-resolution rows, 64 positions, 64 channels,
// class (p, q)), 128 threads, each warp a 32 x 32 tile. The CTA's weights
// (64 x 4*CP bf16, 99 KB at cin 192) are read into shared memory once and
// reused over its tm rows. Per row, the two input rows m+p-1, m+p over the
// 66 columns n0-1 .. n0+64 are staged in shared memory (53 KB at cin 192),
// so every A fragment is an ldmatrix at a tap offset. The staging is double
// buffered with cp.async: the next row's inputs are in flight while the
// tensor cores work on this one, so a row does not wait on its ~25 loads
// per thread one after another (with one CTA per SM at cin 192, nothing
// else would hide them). Row pitches are
// padded by 16 bytes so the ldmatrix row addresses fall in distinct bank
// groups. The four classes of one input region are consecutive CTAs, so
// its reads hit L2.
//
// GroupNorm sums: each thread sums the rounded y it writes; lanes and the two
// M warps are combined in a fixed order and each CTA writes one partial per
// (b, part, lane), part = (row chunk, position tile, p). A second launch
// reduces the partials in order. Hopper CTAs run in no order, so this takes
// the place of the TPU kernel's revisited accumulator block; no float
// atomics, the same result on every run.
//
// Bound: at the full-width finest level (B=128, H=W=128, cin 192 = 128 from
// the level below + 64 skip, f 64) 825 GFLOP of bf16 products against
// 1.88 GB of input and output: the tensor cores (0.83 ms at 989 TFLOP/s)
// more than HBM (0.56 ms at 3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;        // positions per CTA
constexpr int kBN = 64;        // channels per CTA
constexpr int kThreads = 128;  // 4 warps, 2 (M) x 2 (N), 32 x 32 each
constexpr int kCols = kBM + 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros where valid is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
packed_up_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ wq,
                 const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ p1,
                 float* __restrict__ p2, int H, int W, int cin, int CP, int f,
                 int NP, int tm, int n_wt, int n_nt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int KP = 4 * CP + 8;  // weight row pitch (elements)
  const int XP = CP + 8;      // input pixel pitch (elements)
  auto* w_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBN][KP]
  __nv_bfloat16* x_s = w_s + kBN * KP;                      // [2 buffers][2 rows][kCols][XP]
  float* red = reinterpret_cast<float*>(x_s + 4 * kCols * XP);  // [2][kBN][2]

  // Block index: class fastest, then channel tile, position tile, row chunk, batch.
  int idx = blockIdx.x;
  const int pq = idx % 4; idx /= 4;
  const int nt = idx % n_nt; idx /= n_nt;
  const int wt_i = idx % n_wt; idx /= n_wt;
  const int n_chunks = H / tm;
  const int chunk = idx % n_chunks;
  const int b = idx / n_chunks;
  const int p = pq >> 1, q = pq & 1;
  const int n0 = wt_i * kBM, c_base = nt * kBN;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane / 4, t = lane % 4;

  // Weights of this class and channel tile, once (the first cp.async group).
  {
    const int vec_per_row = (4 * CP) / 8;
    const __nv_bfloat16* src = wq + (static_cast<long long>(pq) * NP + c_base) * (4 * CP);
    for (int i = tid; i < kBN * vec_per_row; i += kThreads) {
      const int r = i / vec_per_row, v = i - r * vec_per_row;
      cp_async16(w_s + r * KP + v * 8, src + static_cast<long long>(r) * 4 * CP + v * 8, true);
    }
  }
  // The input rows m+p-1, m+p of half-resolution row m into buffer buf.
  const int vec_per_px = CP / 8;
  auto stage = [&](int m, int buf) {
    __nv_bfloat16* dst = x_s + buf * 2 * kCols * XP;
    for (int i = tid; i < 2 * kCols * vec_per_px; i += kThreads) {
      const int px = i / vec_per_px, v = i - px * vec_per_px;
      const int u = px / kCols, j = px - u * kCols;
      const int r = m + p - 1 + u, n = n0 - 1 + j, ci = v * 8;
      const bool ok = r >= 0 && r < H && n >= 0 && n < W && ci < cin;
      cp_async16(dst + px * XP + ci,
                 ok ? x + ((static_cast<long long>(b) * H + r) * W + n) * cin + ci : x, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(chunk * tm, 0);  // commits the weights with the first row

  // Bias of the 8 channels this thread writes: n8 tile j, pair element e.
  const int c_warp = c_base + wn * 32;
  float bias_f[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias_f[j][e] = __bfloat162float(bias[c_warp + j * 8 + 2 * t + e]);

  float s1[4][2], s2[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;

  const int twoF = 2 * f;
  for (int mi = 0; mi < tm; ++mi) {
    const int m = chunk * tm + mi;
    if (mi + 1 < tm) {
      stage(m + 1, (mi + 1) & 1);  // that buffer's last reader finished at the loop's end
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // row m (and the weights) visible to every warp
    const __nv_bfloat16* xb = x_s + (mi & 1) * 2 * kCols * XP;

    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int u = tap >> 1, v = tap & 1;
      // A row (position) i of the warp reads input column j = i + q + v.
      const __nv_bfloat16* a_row =
          xb + (u * kCols + wm * 32 + (lane % 8) + ((lane / 8) % 2) * 8 + q + v) * XP +
          (lane / 16) * 8;
      const __nv_bfloat16* b_row =
          w_s + (wn * 32 + (lane % 8) + (lane / 16) * 8) * KP + tap * CP + ((lane / 8) % 2) * 8;
      for (int kc = 0; kc < CP; kc += 16) {
        uint32_t a[2][4], bb[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], a_row + i * 16 * XP + kc);
#pragma unroll
        for (int j = 0; j < 2; ++j) ldmatrix_x4(bb[j], b_row + j * 16 * KP + kc);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[i][j], a[i], bb[j / 2][(j % 2) * 2], bb[j / 2][(j % 2) * 2 + 1]);
      }
    }

    // Epilogue: round, add the bias in bf16, store the packed row 2m+p, and
    // sum the stored values.
    __nv_bfloat16* y_row = y + ((static_cast<long long>(b) * 2 * H + 2 * m + p) * W) * twoF + q * f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + wm * 32 + i * 16 + g + 8 * h;
        if (n >= W) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c_warp + j * 8 + 2 * t;
          if (c >= f) continue;
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float zr = __bfloat162float(__float2bfloat16(acc[i][j][2 * h + e]));
            o[e] = __bfloat162float(__float2bfloat16(zr + bias_f[j][e]));
            s1[j][e] += o[e];
            s2[j][e] += o[e] * o[e];
          }
          *reinterpret_cast<__nv_bfloat162*>(y_row + static_cast<long long>(n) * twoF + c) =
              __floats2bfloat162_rn(o[0], o[1]);
        }
      }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  if (p1 == nullptr) return;
  // Sums over the 8 lanes that share t, then over the two M warps.
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1[j][e] += __shfl_xor_sync(0xffffffffu, s1[j][e], off);
        s2[j][e] += __shfl_xor_sync(0xffffffffu, s2[j][e], off);
      }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = wn * 32 + j * 8 + 2 * t + e;
        red[(wm * kBN + cl) * 2 + 0] = s1[j][e];
        red[(wm * kBN + cl) * 2 + 1] = s2[j][e];
      }
  }
  __syncthreads();
  const int n_part = n_chunks * n_wt * 2;
  const int part = (chunk * n_wt + wt_i) * 2 + p;
  for (int cl = tid; cl < kBN; cl += kThreads) {
    const int c = c_base + cl;
    if (c >= f) continue;
    const long long o = (static_cast<long long>(b) * n_part + part) * twoF + q * f + c;
    p1[o] = red[cl * 2 + 0] + red[(kBN + cl) * 2 + 0];
    p2[o] = red[cl * 2 + 1] + red[(kBN + cl) * 2 + 1];
  }
}

// s[b, l] = sum over parts, in order, of the partials.
__global__ void reduce_parts_kernel(const float* __restrict__ p1,
                                    const float* __restrict__ p2,
                                    float* __restrict__ s1, float* __restrict__ s2,
                                    int n_part, int lanes) {
  const int b = blockIdx.x;
  for (int l = threadIdx.x; l < lanes; l += blockDim.x) {
    float a1 = 0.f, a2 = 0.f;
    for (int k = 0; k < n_part; ++k) {
      const long long o = (static_cast<long long>(b) * n_part + k) * lanes + l;
      a1 += p1[o];
      a2 += p2[o];
    }
    s1[b * lanes + l] = a1;
    s2[b * lanes + l] = a2;
  }
}

}  // namespace

extern "C" {

// x (B, H, W, cin) bf16; wq (4, NP, 4*CP) bf16; bias (NP,) bf16;
// y (B, 2H, W, 2f) bf16. With p1 non-null also the partials p1, p2
// (B, n_part, 2f) f32 and their sums s1, s2 (B, 2f) f32,
// n_part = (H / tm) * ceil(W / 64) * 2. Needs cin % 8 == 0, f % 8 == 0,
// H % tm == 0 (checked by the wrapper). A cin whose shared memory exceeds
// the card's limit fails in cudaFuncSetAttribute and returns its error.
int packed_up(const __nv_bfloat16* x, const __nv_bfloat16* wq, const __nv_bfloat16* bias,
              __nv_bfloat16* y, float* p1, float* p2, float* s1, float* s2, int B, int H,
              int W, int cin, int CP, int f, int tm, void* stream) {
  const int NP = (f + kBN - 1) / kBN * kBN;
  const int n_wt = (W + kBM - 1) / kBM, n_nt = NP / kBN;
  const long long grid = static_cast<long long>(B) * (H / tm) * n_wt * n_nt * 4;
  if (grid == 0) return 0;
  const int smem =
      static_cast<int>(sizeof(__nv_bfloat16) * (kBN * (4 * CP + 8) + 4 * kCols * (CP + 8)) +
                       sizeof(float) * 2 * kBN * 2);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(packed_up_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_up_kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      x, wq, bias, y, p1, p2, H, W, cin, CP, f, NP, tm, n_wt, n_nt);
  err = cudaGetLastError();
  if (err != cudaSuccess || p1 == nullptr) return static_cast<int>(err);
  reduce_parts_kernel<<<B, 128, 0, s>>>(p1, p2, s1, s2, (H / tm) * n_wt * 2, 2 * f);
  return static_cast<int>(cudaGetLastError());
}

// Every library of csrc/ exports error_string (see ops/kernels/_build.py).
const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
