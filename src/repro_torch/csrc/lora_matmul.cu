// Fused LoRA matmul for Hopper (sm_90a):  y = x·W + scale·(x·A)·B.
//
// Replaces the TPU kernel src/repro/kernels/lora_matmul.py (_kernel,
// lora_matmul_pallas): x (M,K), W (K,N), A (K,r), B (r,N), all bf16; fp32
// accumulation; output cast to bf16.
//
// What bounds it on the H100: at prefill (M = batch·seq, thousands of rows)
// the x·W product is tensor-core work (2·M·K·N operations against
// 2·(M·K + K·N + M·N) bytes: well above the card's ~295 operations per byte),
// so the bound is bf16 tensor-core throughput. At decode (M = batch, a
// handful of rows) every byte of W is read for a few rows of output, so the
// bound is reading W from device memory.
//
// What the design does about it: as on the TPU, the point is that x is read
// once. One block owns a BM x BN output tile and walks over K; each x tile
// staged in shared memory feeds both the frozen-weight product (x·W, bf16
// wmma fragments with fp32 accumulators) and the low-rank product
// u = x·A (BM x r, fp32), so the (M, r) intermediate never goes to device
// memory and x is not read a second time. After the K loop the epilogue
// folds scale·u·B in fp32 (r ≤ 64 multiply-adds per output) and casts.
// Edges on M, N, K and r are masked in the loads (zero fill) and the store,
// so decode (M = 4..8) and ragged shapes need no padded copies. This first
// version is simple on purpose: no cp.async double buffering, no wgmma/TMA,
// one fixed tile shape; making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int NTHREADS = 128;  // 4 warps, 2 x 2 over the output tile
constexpr int XS_LD = BK + 8;  // smem leading dims, padded against bank conflicts
constexpr int WS_LD = BN + 8;
constexpr int CS_LD = BN + 4;

// Copy the ROWS x COLS tile at (r0, c0) of a row-major (nrows x ncols) bf16
// matrix with leading dimension ld into shared memory, zero-filling what lies
// outside the matrix. 16-byte loads where the whole chunk is inside and aligned.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(bf16* dst, int dst_ld, const bf16* __restrict__ src,
                                          int ld, int nrows, int ncols, int r0, int c0,
                                          bool vec_ok) {
  constexpr int CPR = COLS / 8;  // 8-element chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += NTHREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const int gr = r0 + r, gc = c0 + col;
    bf16* d = dst + r * dst_ld + col;
    if (vec_ok && gr < nrows && gc + 8 <= ncols) {
      *reinterpret_cast<uint4*>(d) =
          *reinterpret_cast<const uint4*>(src + (size_t)gr * ld + gc);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = (gr < nrows && gc + j < ncols) ? src[(size_t)gr * ld + gc + j]
                                              : __float2bfloat16(0.f);
    }
  }
}

template <int RF>
constexpr size_t smem_bytes() {
  constexpr int RP = 16 * RF;
  constexpr size_t loop = (size_t)(BM * XS_LD + BK * WS_LD + BK * (RP + 8)) * sizeof(bf16);
  constexpr size_t epi = (size_t)(BM * CS_LD + BM * (RP + 4) + RP * BN) * sizeof(float);
  return loop > epi ? loop : epi;
}

// RF = number of 16-wide fragments covering the rank r (r ≤ 16·RF).
template <int RF>
__global__ void __launch_bounds__(NTHREADS)
lora_matmul_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const bf16* __restrict__ a, const bf16* __restrict__ b,
                   bf16* __restrict__ y, int M, int K, int N, int r, float scale) {
  constexpr int RP = 16 * RF;
  constexpr int AS_LD = RP + 8;
  constexpr int US_LD = RP + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  // K loop
  bf16* xs = reinterpret_cast<bf16*>(smem);  // BM x XS_LD
  bf16* ws = xs + BM * XS_LD;                // BK x WS_LD
  bf16* as = ws + BK * WS_LD;                // BK x AS_LD
  // epilogue: the same bytes, reused once the K loop is over
  float* cs = reinterpret_cast<float*>(smem);  // BM x CS_LD   x·W tile
  float* us = cs + BM * CS_LD;                 // BM x US_LD   u = x·A
  float* bs = us + BM * US_LD;                 // RP x BN      B tile

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
  const bool x_vec = (K % 8 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  const bool w_vec = (N % 8 == 0) && ((reinterpret_cast<uintptr_t>(w) & 15) == 0);
  const bool a_vec = (r % 8 == 0) && ((reinterpret_cast<uintptr_t>(a) & 15) == 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2], uacc[RF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
  for (int f = 0; f < RF; ++f) wmma::fill_fragment(uacc[f], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<BM, BK>(xs, XS_LD, x, K, M, K, m0, k0, x_vec);
    load_tile<BK, BN>(ws, WS_LD, w, N, K, N, k0, n0, w_vec);
    load_tile<BK, RP>(as, AS_LD, a, r, K, r, k0, 0, a_vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2], fx;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xs + (wm * 32 + i * 16) * XS_LD + kk, XS_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fb, ws + kk * WS_LD + wn * 32 + j * 16, WS_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
      // low-rank path from the same staged x tile: warp w owns rows 16w..16w+15 of u
      wmma::load_matrix_sync(fx, xs + warp * 16 * XS_LD + kk, XS_LD);
#pragma unroll
      for (int f = 0; f < RF; ++f) {
        wmma::load_matrix_sync(fb, as + kk * AS_LD + f * 16, AS_LD);
        wmma::mma_sync(uacc[f], fx, fb, uacc[f]);
      }
    }
    __syncthreads();
  }

  // epilogue: y = acc + scale · u·B, in fp32
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * CS_LD + wn * 32 + j * 16, acc[i][j],
                              CS_LD, wmma::mem_row_major);
#pragma unroll
  for (int f = 0; f < RF; ++f)
    wmma::store_matrix_sync(us + warp * 16 * US_LD + f * 16, uacc[f], US_LD,
                            wmma::mem_row_major);
  for (int idx = threadIdx.x; idx < RP * BN; idx += NTHREADS) {
    const int j = idx / BN, n = idx % BN;
    bs[idx] = (j < r && n0 + n < N) ? __bfloat162float(b[(size_t)j * N + n0 + n]) : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += NTHREADS) {
    const int m = idx / BN, n = idx % BN;
    const int gm = m0 + m, gn = n0 + n;
    if (gm < M && gn < N) {
      float delta = 0.f;
#pragma unroll
      for (int j = 0; j < RP; ++j) delta += us[m * US_LD + j] * bs[j * BN + n];
      y[(size_t)gm * N + gn] = __float2bfloat16(cs[m * CS_LD + n] + scale * delta);
    }
  }
}

template <int RF>
cudaError_t launch(const bf16* x, const bf16* w, const bf16* a, const bf16* b, bf16* y, int M,
                   int K, int N, int r, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<RF>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lora_matmul_kernel<RF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  lora_matmul_kernel<RF><<<grid, NTHREADS, smem, stream>>>(x, w, a, b, y, M, K, N, r, scale);
  return cudaGetLastError();
}

}  // namespace

// x (M,K), w (K,N), a (K,r), b (r,N), y (M,N): contiguous row-major bf16.
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int lora_matmul_bf16(const void* x, const void* w, const void* a, const void* b,
                                void* y, int M, int K, int N, int r, float scale,
                                void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || r <= 0 || r > 64 || M > 65535 * BM)
    return (int)cudaErrorInvalidValue;
  const bf16 *xp = static_cast<const bf16*>(x), *wp = static_cast<const bf16*>(w);
  const bf16 *ap = static_cast<const bf16*>(a), *bp = static_cast<const bf16*>(b);
  bf16* yp = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((r + 15) / 16) {
    case 1: return (int)launch<1>(xp, wp, ap, bp, yp, M, K, N, r, scale, st);
    case 2: return (int)launch<2>(xp, wp, ap, bp, yp, M, K, N, r, scale, st);
    case 3: return (int)launch<3>(xp, wp, ap, bp, yp, M, K, N, r, scale, st);
    default: return (int)launch<4>(xp, wp, ap, bp, yp, M, K, N, r, scale, st);
  }
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
