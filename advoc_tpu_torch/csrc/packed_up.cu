// Packed-tail transpose-conv on Hopper's tensor cores: the finest U-Net
// decoder level's k4/s2 ConvTranspose written straight into the packed
// (B, 2H, W, 2f) layout, with the per-(batch, lane) sums GroupNorm needs.
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
// lanes, here each CTA owns one parity class (p, q): a GEMM with the minimum
// work, K = 4 taps x CP, CP = cin rounded up to 64 (one 128-byte K box).
//
// Design. The GEMM is computed transposed, y^T = W x^T, so that wgmma's N
// is 128 positions: an m64n64k16 (M = positions, N = 64 channels) reads
// 4 KB of shared memory per 32 cycles of tensor-core work, all the
// 128 B/cycle an SM's shared memory gives; an m64n128k16 reads 6 KB per 64.
// One CTA = (batch b, tm half-resolution rows, 128 positions, 64 channels,
// class (p, q)); the four classes of one input region are consecutive
// CTAs, so their reads of x hit L2.
//   A: the class's weights (wrapper: (4, NP, 4 CP) bf16, row c, column
//      tap * CP + ci), loaded once by TMA and resident in shared memory
//      (96 KB at cin 192, 128 KB at 256), 64 channels x 64 ci per tile.
//   B: x boxes from the 4-D tensor map of x (B, H, W, cin), 128-byte
//      swizzle, box (64 ci, 136 positions) at (ci0, n0 + q - 1, m + p - 1 + u,
//      b): one box per input row u serves both column taps v, tap v's
//      descriptor starting v rows (128 v bytes) in; the swizzle phase
//      follows the address, so the shifted view reads right. TMA's zero
//      fill outside the tensor gives the image border, the ragged last
//      position tile and a cin that is not a multiple of 64: the kernel has
//      no masks on its inputs.
// The CTA's rows are split between two consumer warpgroups (rows tm0,
// tm0 + 2, ... and tm0 + 1, ...), each fed by its own producer warp
// through its own ring of x boxes (two stages up to cin 192, one above,
// where the weights leave room for no more), so one warpgroup's epilogue
// overlaps the other's products (bf16 in, f32 accumulator in registers). The
// epilogue rounds, adds the bias, sums y and y^2 in registers, writes the
// tile as (positions, 64 channels) into a swizzled shared buffer and
// stores it with one TMA store through the 5-D map of y viewed as
// (B, 2H, W, 2, f), box (64 c, 1, 128 positions, 1, 1) at (c0, q, n0,
// 2m + p, b); the store drops positions >= W and channels >= f.
//
// GroupNorm sums: a channel's lanes, then the two warpgroups, are combined
// in a fixed order, and each CTA writes one partial per (b, part, lane),
// part = (row chunk, position tile, p). A second launch reduces the
// partials in order. Hopper CTAs run in no order, so this takes the place
// of the TPU kernel's revisited accumulator block; no float atomics, the
// same result on every run.
//
// Bound: at the full-width finest level (B=128, H=W=128, cin 192 = 128 from
// the level below + 64 skip, f 64) 825 GFLOP of bf16 products against
// 1.88 GB of input and output: the tensor cores (0.83 ms at 989 TFLOP/s)
// more than HBM (0.56 ms at 3.35 TB/s). Measured on an H100 at 1.7-1.8 ms
// (PERF.md): the mainloop, not the epilogue or the prologue, holds it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kCh = 64;                    // channels per CTA (wgmma M)
constexpr int kPos = 128;                  // positions per tile (wgmma N)
constexpr int kBK = 64;                    // bf16 per 128-byte swizzled row
constexpr int kTileW = kCh * kBK * 2;      // one weight tile, 8 KB
constexpr int kTileA = (kPos + 8) * 128;   // one x box: 128 positions and the v = 1 shift, 17 KB
constexpr int kTileY = kPos * kCh * 2;     // one output tile, 16 KB
constexpr int kMaxStages = 4;              // x ring per warpgroup, at most
constexpr int kMaxKC = 4;                  // cin <= 256: weights 128 KB
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 64;  // and one producer warp each
constexpr int kSmemLimit = 232448;         // a CTA's shared memory on an H100

int smem_bytes(int kc, int stages) {
  return 4 * kc * kTileW + 2 * stages * kTileA + 2 * kTileY + 2 * kCh * 2 * 4 +
         (4 * kMaxStages + 1) * 8 + 1024;
}

// map_x: x (B, H, W, cin); map_w: weights (4, NP, 4 CP); map_y: y as
// (B, 2H, W, 2, f). Block index: class fastest, then channel tile,
// position tile, row chunk, batch.
__global__ void __launch_bounds__(kThreads, 1)
    packed_up_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_y,
                     const __nv_bfloat16* __restrict__ bias, float* __restrict__ p1,
                     float* __restrict__ p2, int H, int W, int f, int KC, int stages, int tm,
                     int n_wt, int n_nt) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* w_s = smem;                               // [4 KC] weight tiles
  uint8_t* ring = w_s + 4 * KC * kTileW;             // [2 wg][stages] x boxes
  uint8_t* out_s = ring + 2 * stages * kTileA;       // [2 wg] output tiles
  float* red = reinterpret_cast<float*>(out_s + 2 * kTileY);  // [2 wg][kCh][2]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * kCh * 2);  // [2][kMaxStages]
  uint64_t* empty = full + 2 * kMaxStages;                          // [2][kMaxStages]
  uint64_t* wbar = empty + 2 * kMaxStages;

  int idx = blockIdx.x;
  const int pq = idx % 4; idx /= 4;
  const int nt = idx % n_nt; idx /= n_nt;
  const int wt_i = idx % n_wt; idx /= n_wt;
  const int n_chunks = H / tm;
  const int chunk = idx % n_chunks;
  const int b = idx / n_chunks;
  const int p = pq >> 1, q = pq & 1;
  const int n0 = wt_i * kPos, c_base = nt * kCh;
  const int n_w = 4 * KC;  // weight tiles: 4 taps x KC boxes of 64 ci
  const int n_a = 2 * KC;  // x boxes per row: 2 input rows x KC boxes

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * kMaxStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 128);
    }
    mbar_init(smem_u32(wbar), 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer of warpgroup wg: one thread keeps its ring full.
    const int wg = (threadIdx.x - kConsumers) / 32;
    if (threadIdx.x % 32 != 0) return;
    if (wg == 0) {
      const uint32_t bar = smem_u32(wbar);
      mbar_expect_tx(bar, n_w * kTileW);
      for (int i = 0; i < n_w; ++i)  // tile (tap, kc) at column tap * CP + 64 kc
        tma_3d(smem_u32(w_s + i * kTileW), &map_w, bar, i * kBK, c_base, pq);
    }
    int it = 0;
    for (int mi = wg; mi < tm; mi += 2) {
      const int m = chunk * tm + mi;
      for (int i = 0; i < n_a; ++i, ++it) {
        const int s = it % stages, round = it / stages;
        if (round > 0) mbar_wait(smem_u32(&empty[wg * kMaxStages + s]), (round - 1) & 1);
        const uint32_t bar = smem_u32(&full[wg * kMaxStages + s]);
        mbar_expect_tx(bar, kTileA);
        tma_4d(smem_u32(ring + (wg * stages + s) * kTileA), &map_x, bar, (i % KC) * kBK,
               n0 + q - 1, m + p - 1 + i / KC, b);
      }
    }
    return;
  }

  // Consumers. The product is y^T: A = the weights (channels x K), B = the
  // x box (positions x K), so wgmma's N is 128 positions. Accumulator
  // layout of m64nNk16: warp w of the warpgroup holds rows (channels)
  // 16w .. 16w + 15; d[4j + 2i + e] is channel lane/4 + 8i, position
  // 8j + 2(lane % 4) + e.
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const bool lead = tid == 0;

  float bias_f[2], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
  bool ch_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = c_base + warp * 16 + g + 8 * i;
    bias_f[i] = __bfloat162float(bias[c]);  // bias is padded to NP
    ch_ok[i] = c < f;
  }

  mbar_wait(smem_u32(wbar), 0);
  uint8_t* out_tile = out_s + wg * kTileY;
  const uint32_t w_addr = smem_u32(w_s);
  int it = 0;
  for (int mi = wg; mi < tm; mi += 2) {
    const int m = chunk * tm + mi;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    for (int i = 0; i < n_a; ++i, ++it) {
      const int s = it % stages, u = i / KC, kc = i % KC;
      mbar_wait(smem_u32(&full[wg * kMaxStages + s]), (it / stages) & 1);
      const uint32_t a = smem_u32(ring + (wg * stages + s) * kTileA);
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        // Tap (u, v) reads the box from row v: the descriptor starts 128 v
        // bytes in, and the swizzle phase follows the address.
        const uint64_t dx = sw128_desc(a + 128 * v);
        const uint64_t dw = sw128_desc(w_addr + ((2 * u + v) * KC + kc) * kTileW);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) wgmma_128(d, dw + 2 * kk, dx + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d);
      mbar_arrive(smem_u32(&empty[wg * kMaxStages + s]));
    }

    // Epilogue: round, add the bias in bf16, sum the stored values, and
    // stage the tile as (positions, 128-byte rows of channels) with TMA's
    // 128-byte swizzle for one store.
    if (lead) tma_store_wait_read();  // the previous row's store has read the buffer
    bar_sync(1 + wg, 128);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = warp * 16 + g + 8 * i;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * j + 2 * t + e;
          const float o = __bfloat162float(__float2bfloat16(
              __bfloat162float(__float2bfloat16(d[4 * j + 2 * i + e])) + bias_f[i]));
          if (ch_ok[i] && n0 + n < W) {
            s1[i] += o;
            s2[i] += o * o;
          }
          *reinterpret_cast<__nv_bfloat16*>(out_tile + n * 128 + (((c >> 3) ^ (n & 7)) << 4) +
                                            (c & 7) * 2) = __float2bfloat16(o);
        }
    }
    fence_proxy_async();
    bar_sync(1 + wg, 128);
    if (lead) {
      tma_store_5d(&map_y, smem_u32(out_tile), c_base, q, n0, 2 * m + p, b);
      tma_store_commit();
    }
  }
  if (lead) tma_store_wait_all();

  if (p1 == nullptr) return;
  // Sums over the 4 lanes that share a channel, then over the two
  // warpgroups in a fixed order.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
    }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* r = red + (wg * kCh + warp * 16 + g + 8 * i) * 2;
      r[0] = s1[i];
      r[1] = s2[i];
    }
  }
  bar_sync(3, kConsumers);
  if (threadIdx.x < kCh) {
    const int cl = threadIdx.x, c = c_base + cl;
    if (c < f) {
      const int n_part = n_chunks * n_wt * 2;
      const int part = (chunk * n_wt + wt_i) * 2 + p;
      const long long o = (static_cast<long long>(b) * n_part + part) * 2 * f + q * f + c;
      p1[o] = red[cl * 2] + red[(kCh + cl) * 2];
      p2[o] = red[cl * 2 + 1] + red[(kCh + cl) * 2 + 1];
    }
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
// n_part = (H / tm) * ceil(W / 128) * 2. Needs cin % 8 == 0, f % 8 == 0,
// H % tm == 0 (checked by the wrapper) and CP = cin rounded up to 64; a
// CP above 256 (the weights would not fit beside the rings) returns
// cudaErrorInvalidValue.
int packed_up(const __nv_bfloat16* x, const __nv_bfloat16* wq, const __nv_bfloat16* bias,
              __nv_bfloat16* y, float* p1, float* p2, float* s1, float* s2, int B, int H,
              int W, int cin, int CP, int f, int tm, void* stream) {
  const int KC = CP / kBK;
  if (CP % kBK != 0 || KC < 1 || KC > kMaxKC) return static_cast<int>(cudaErrorInvalidValue);
  int stages = kMaxStages;
  while (stages > 1 && smem_bytes(KC, stages) > kSmemLimit) --stages;
  const int NP = (f + kCh - 1) / kCh * kCh;
  const int n_wt = (W + kPos - 1) / kPos, n_nt = NP / kCh;
  const long long grid = static_cast<long long>(B) * (H / tm) * n_wt * n_nt * 4;
  if (grid == 0) return 0;
  using u64 = cuuint64_t;
  CUtensorMap m_x, m_w, m_y;
  const u64 x_dims[4] = {static_cast<u64>(cin), static_cast<u64>(W), static_cast<u64>(H),
                         static_cast<u64>(B)};
  const u64 x_strides[3] = {static_cast<u64>(cin) * 2, static_cast<u64>(W) * cin * 2,
                            static_cast<u64>(H) * W * cin * 2};
  const cuuint32_t x_box[4] = {kBK, kPos + 8, 1, 1};
  const u64 w_dims[3] = {static_cast<u64>(4 * CP), static_cast<u64>(NP), 4};
  const u64 w_strides[2] = {static_cast<u64>(4 * CP) * 2, static_cast<u64>(NP) * 4 * CP * 2};
  const cuuint32_t w_box[3] = {kBK, kCh, 1};
  const u64 y_dims[5] = {static_cast<u64>(f), 2, static_cast<u64>(W), static_cast<u64>(2 * H),
                         static_cast<u64>(B)};
  const u64 y_strides[4] = {static_cast<u64>(f) * 2, static_cast<u64>(2 * f) * 2,
                            static_cast<u64>(W) * 2 * f * 2,
                            static_cast<u64>(2 * H) * W * 2 * f * 2};
  const cuuint32_t y_box[5] = {kCh, 1, kPos, 1, 1};
  int code = encode(&m_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, x_dims, x_strides, x_box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (code == 0)
    code = encode(&m_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, wq, w_dims, w_strides, w_box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (code == 0)
    code = encode(&m_y, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, y, y_dims, y_strides, y_box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (code != 0) return code;
  const int smem = smem_bytes(KC, stages);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(packed_up_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_up_kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      m_x, m_w, m_y, bias, p1, p2, H, W, f, KC, stages, tm, n_wt, n_nt);
  err = cudaGetLastError();
  if (err != cudaSuccess || p1 == nullptr) return static_cast<int>(err);
  reduce_parts_kernel<<<B, 128, 0, s>>>(p1, p2, s1, s2, (H / tm) * n_wt * 2, 2 * f);
  return static_cast<int>(cudaGetLastError());
}

// Every library of csrc/ exports error_string (see ops/kernels/_build.py).
const char* error_string(int code) { return hopper::error_string(code); }

}  // extern "C"
