// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (_kernel,
// ssd_scan_pallas). Per (batch b, head h), with la_t = dt_t·A_h and the
// state h (P x N, fp32):
//
//   h_t = exp(la_t)·h_{t-1} + dt_t·x_t ⊗ B_t,      y_t = h_t·C_t
//
// computed chunk by chunk as the TPU kernel does: within a chunk of L steps,
// with cs the inclusive cumulative sum of la over the chunk,
//
//   y_q  = Σ_{s<=q} (C_q·B_s)·exp(cs_q − cs_s)·dt_s·x_s  +  exp(cs_q)·h_0·C_q
//   h_L  = exp(cs_L)·h_0  +  Σ_s exp(cs_L − cs_s)·dt_s·x_s ⊗ B_s
//
// Inputs: x (B,S,H,P) and Bm/Cm (B,S,N) in bf16 or fp32 (Bm/Cm shared by all
// heads), dt (B,S,H) and A (H) fp32, an optional initial state (B,H,P,N)
// fp32. Outputs: y (B,S,H,P) fp32 and the final state (B,H,P,N) fp32. Beyond
// the TPU kernel, it takes an initial state, returns the final one, and masks
// a ragged S inside the kernel (a step past S gets dt = 0, x = B = C = 0,
// which leaves the state unchanged, and its y is not stored).
//
// What bounds it on the H100: the bytes are x, B, C, dt read once, y and the
// states written once (52.8 MB at B=8, S=512, H=24, P=64, N=128, bf16 x/B/C
// with an initial state: 15.8 µs at 3.35 TB/s); the operations, ~2·S·(L·N +
// L·P + 2·P·N) per (b, h) (4.4 GFLOP there), take less at tensor-core rates
// (4.5 µs at 989 TFLOP/s). So the bytes bound it.
//
// Two variants, picked by the wrapper (kernels/ssd_scan.py ``variant``):
//
// * wgmma (bf16 x/B/C, P a multiple of 32, N = 64, 128, 192 or 256, strides
//   and pointers 16-byte aligned; the main path). The TPU grid runs its chunk
//   axis in order and keeps the state in VMEM; blocks on the H100 run in no
//   order, so a block walks its chunks itself. One block per (b, h) gives 192
//   blocks at the main path's shape, too few for 132 SMs; y[:, p] depends
//   only on the state columns h[p, :], so one block owns one (b, h, 32
//   columns of P): 384 blocks, each recomputing the chunk's C·Bᵀ (1 MFLOP on
//   the tensor cores). The fp32 state never leaves the block, so the bytes
//   stay at the bound's. A block is one warpgroup (128 threads) with 61.5 KiB
//   of shared memory at N = 128, so three blocks share an SM and the 384
//   blocks run in one wave: the blocks beside it, not a deeper ring in the
//   block, hide a chunk's loads (at the main path's shape on an H100 80GB
//   HBM3 at 700 W, chip_smoke.py timed a first design with two stages, two
//   blocks per SM and a producer warp at 67 µs of device time, this one at
//   40 µs). Chunks of Q = 64 steps: thread 0
//   loads x (a 32 x 64 box of the strided (B,S,H,P) view) and B and C
//   (64-column boxes of (B,S,N)) by TMA, which zero-fills steps past S; warp
//   0 computes the chunk's dt (0 past S) and cs with shuffles, in the log2
//   domain (exponents on the special-function unit). Four wgmma products a
//   chunk, fp32 accumulators:
//     1. scores C·Bᵀ (64 x 64, K = N), both operands bf16 and exact;
//     2. y += G·x, G = scores ⊙ exp(cs_q − cs_s) ⊙ dt_s masked to s <= q
//        before the exponent (there cs_q − cs_s > 0 could overflow), split
//        in registers into bf16 hi + lo terms (register operand), x MN-major;
//     3. y = exp(cs_q)·(C·h) first: h, the state entering the chunk, written
//        to shared memory by stmatrix as bf16 hi + lo terms; exp(cs_q)
//        scales the accumulator rows, so C is never rounded;
//     4. hᵀ ← exp(cs_L)·hᵀ + Bᵀ·(w⊙x)_hi + Bᵀ·(w⊙x)_lo, w_s = exp(cs_L −
//        cs_s)·dt_s, Bᵀ read MN-major from the B tile; hᵀ (N x 32, fp32)
//        stays in registers for the whole sequence.
//   G is formed while C·h runs, and w⊙x while G·x runs.
//   Precision: the tolerance is 1e-4 of the largest output of the fp32
//   sequential recurrence. G, h and w⊙x are fp32; rounded once to bf16 they
//   miss it by an order of magnitude, so each goes in as two bf16 terms, hi
//   = bf16(v) and lo = bf16(v − hi), whose sum keeps 16 significant bits.
//   kernels/ssd_ref.py ``ssd_scan_split_ref`` is this arithmetic in
//   PyTorch: tests/test_torch_ssm.py holds it to the tolerance against the
//   reference's Pallas kernel and shows that each of the three lo terms is
//   needed. Every sum has a fixed order: reruns are bit-identical.
// * fma (fp32 inputs, other P and N, misaligned views): the first port's
//   kernel. One block per (b, h) loops over chunks of 32 steps with the
//   (P, N) state in shared memory; its products are fp32 FMAs on the CUDA
//   cores out of shared memory, rows padded to an odd stride.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

struct Strides {
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, bm_b, bm_s, cm_b, cm_s;
};

// ===========================================================================
// fma: the first port's kernel, fp32 FMAs on the CUDA cores
// ===========================================================================
namespace simt {

constexpr int L = 32;          // steps per chunk: one warp scans the decay
constexpr int NTHREADS = 256;  // 8 warps
constexpr int NWARPS = NTHREADS / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// out[m, n] for m < M, n < NN, each thread owning the outputs at rows
// warp + i·NWARPS and columns lane + j·32 of each (RM·NWARPS) x (RN·32) tile:
//   acc = Σ_k a(m, k)·b(k, n)  +  Σ_k a2(m, k)·b2(k, n)
// over k < K and k < K2, with a(m, k) = a[m·am + k·ak] and
// b(k, n) = b[k·bk + n·bn] (a2, b2 alike); within a warp a is a broadcast
// and b runs over consecutive n. The sums go to epi(m, n, acc).
struct Operand {
  const float* p;
  int s0, s1;  // strides of its two indices
  __device__ __forceinline__ float operator()(int i, int j) const { return p[i * s0 + j * s1]; }
};

template <int RM, int RN, typename Epi>
__device__ __forceinline__ void smem_gemm(int M, int NN, int K, Operand a, Operand b, int K2,
                                          Operand a2, Operand b2, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m0 = 0; m0 < M; m0 += RM * NWARPS) {
    for (int n0 = 0; n0 < NN; n0 += RN * 32) {
      float acc[RM][RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
      int mi[RM], nj[RN];  // clamped in range; the epilogue drops the clamped ones
#pragma unroll
      for (int i = 0; i < RM; ++i) mi[i] = min(m0 + warp + i * NWARPS, M - 1);
#pragma unroll
      for (int j = 0; j < RN; ++j) nj[j] = min(n0 + lane + j * 32, NN - 1);
      for (int k = 0; k < K; ++k) {
        float av[RM], bv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = a(mi[i], k);
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = b(k, nj[j]);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      for (int k = 0; k < K2; ++k) {
        float av[RM], bv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = a2(mi[i], k);
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = b2(k, nj[j]);
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int m = m0 + warp + i * NWARPS;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int n = n0 + lane + j * 32;
          if (m < M && n < NN) epi(m, n, acc[i][j]);
        }
      }
    }
  }
}

__host__ __device__ constexpr int odd(int n) { return n | 1; }

// Shared memory of one block, in floats: the state h (P x NP), the chunk's
// dt-weighted inputs xw (L x P), B and C (L x NP each), the scores G (L x L),
// and the chunk's decay cs (L).
__host__ __device__ inline size_t smem_floats(int P, int N) {
  const int NP = odd(N);
  return (size_t)P * NP + (size_t)L * P + 2 * (size_t)L * NP + L * L + L;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ h0, float* __restrict__ y, float* __restrict__ hT,
                int S, int H, int P, int N, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const int NP = odd(N);
  float* hs = smem;              // (P, NP): h[p][n]
  float* xw = hs + P * NP;       // (L, P):  dt_s·x_s
  float* bs = xw + L * P;        // (L, NP): B_s, later exp(cs_L − cs_s)·B_s
  float* cs_mat = bs + L * NP;   // (L, NP): C_q, later exp(cs_q)·C_q
  float* g = cs_mat + L * NP;    // (L, L):  masked, decayed C_q·B_s
  float* cs = g + L * L;         // (L):     inclusive cumsum of dt·A

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const float a_h = A[h];
  const size_t state_off = ((size_t)b * H + h) * P * N;

  for (int i = tid; i < P * N; i += NTHREADS) {
    const int p = i / N, n = i % N;
    hs[p * NP + n] = h0 ? h0[state_off + i] : 0.f;
  }

  const T* xb = x + b * st.x_b + h * st.x_h;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const T* bb = Bm + b * st.bm_b;
  const T* cb = Cm + b * st.cm_b;

  for (int t0 = 0; t0 < S; t0 += L) {
    // ---- load the chunk; steps past S are zero (dt = 0: state unchanged)
    if (tid < 32) {
      const int t = t0 + tid;
      const float d = t < S ? dtb[t * st.dt_s] : 0.f;
      float c = d * a_h;  // inclusive warp scan of la
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float v = __shfl_up_sync(0xffffffffu, c, off);
        if (tid >= off) c += v;
      }
      cs[tid] = c;
    }
    for (int i = tid; i < L * P; i += NTHREADS) {
      const int s = i / P, p = i % P, t = t0 + s;
      xw[i] = t < S ? to_float(xb[t * st.x_s + p]) * dtb[t * st.dt_s] : 0.f;
    }
    for (int i = tid; i < L * N; i += NTHREADS) {
      const int s = i / N, n = i % N, t = t0 + s;
      bs[s * NP + n] = t < S ? to_float(bb[t * st.bm_s + n]) : 0.f;
      cs_mat[s * NP + n] = t < S ? to_float(cb[t * st.cm_s + n]) : 0.f;
    }
    __syncthreads();

    // ---- scores: G[q][s] = (C_q·B_s)·exp(cs_q − cs_s) for s <= q, else 0
    const Operand none{nullptr, 0, 0};
    smem_gemm<L / NWARPS, 1>(L, L, N, {cs_mat, NP, 1}, {bs, 1, NP}, 0, none, none,
                             [&](int q, int s, float v) {
                               g[q * L + s] = s <= q ? v * expf(cs[q] - cs[s]) : 0.f;
                             });
    __syncthreads();

    // ---- fold the decays into C (from the chunk start) and B (to its end)
    const float total = cs[L - 1];
    for (int i = tid; i < L * N; i += NTHREADS) {
      const int s = i / N, n = i % N;
      cs_mat[s * NP + n] *= expf(cs[s]);
      bs[s * NP + n] *= expf(total - cs[s]);
    }
    __syncthreads();

    // ---- y_q = Σ_s G[q][s]·xw_s + Σ_n exp(cs_q)·C_q[n]·h[·][n]
    float* yb = y + (((size_t)b * S + t0) * H + h) * P;
    const int rows = min(L, S - t0);
    smem_gemm<L / NWARPS, 2>(rows, P, L, {g, L, 1}, {xw, P, 1}, N, {cs_mat, NP, 1}, {hs, 1, NP},
                             [&](int q, int p, float v) { yb[(size_t)q * H * P + p] = v; });
    __syncthreads();

    // ---- h = exp(cs_L)·h + Σ_s xw_sᵀ·(exp(cs_L − cs_s)·B_s)
    const float decay = expf(total);
    smem_gemm<8, 4>(P, N, L, {xw, 1, P}, {bs, NP, 1}, 0, none, none,
                    [&](int p, int n, float v) { hs[p * NP + n] = fmaf(decay, hs[p * NP + n], v); });
    __syncthreads();
  }

  for (int i = tid; i < P * N; i += NTHREADS) {
    const int p = i / N, n = i % N;
    hT[state_off + i] = hs[p * NP + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
                   const float* h0, float* y, float* hT, int B, int S, int H, int P, int N,
                   const Strides& st, cudaStream_t stream) {
  const size_t smem = smem_floats(P, N) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  // the attribute sticks to the function: raised to the largest size seen
  static size_t allowed = 0;
  if (smem > allowed && smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  dim3 grid(H, B);
  ssd_scan_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm), h0,
      y, hT, S, H, P, N, st);
  return cudaGetLastError();
}

}  // namespace simt

// ===========================================================================
// wgmma: TMA loads + warpgroup MMA with two-term bf16 splits
// ===========================================================================
namespace tc {

constexpr int Q = 64;          // steps per chunk
constexpr int PS = 32;         // columns of P (state rows) per block
constexpr int THREADS = 128;   // one warpgroup: loads, scans and products
constexpr int X_TILE = Q * PS * 2;  // 4 KB: x (s, p), 64-byte rows, 64-byte swizzle
constexpr int BOX = Q * 64 * 2;     // 8 KB: 64 steps x 64 of N, 128-byte rows, 128-byte swizzle
constexpr int H_BOX = PS * 64 * 2;  // 4 KB: h (p, n) for 64 of N, 128-byte rows
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory from a 1024-byte aligned base, N = 64·NB: the chunk's x tile
// and NB boxes each of B and C; h's hi and lo terms; (w⊙x)'s hi and lo
// terms; the chunk's cs and dt; the TMA barrier. 61.5 KiB at N = 128: three
// blocks per SM.
template <int NB>
struct Layout {
  static constexpr int STAGE = X_TILE + 2 * NB * BOX;
  static constexpr int H_TERM = NB * H_BOX;
  static constexpr int OFF_H = STAGE;
  static constexpr int OFF_XW = OFF_H + 2 * H_TERM;
  static constexpr int OFF_SCAL = OFF_XW + 2 * X_TILE;
  static constexpr int OFF_BAR = OFF_SCAL + Q / 2 * 16;
  static constexpr size_t SMEM = 1024 + OFF_BAR + 8;
};

// v = hi + lo + O(2^-16 |v|): hi = bf16(v), lo = bf16(v − hi), two values packed
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int NB>
__global__ void __launch_bounds__(THREADS, 3)
kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
       const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ dt,
       const float* __restrict__ A, const float* __restrict__ h0, float* __restrict__ y,
       float* __restrict__ hT, int S, int H, int P, long long dt_b, long long dt_s,
       long long dt_h) {
  using Lay = Layout<NB>;
  constexpr int N = 64 * NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~1023ull);
  unsigned char* xs = base;                    // x (s, p): MN-major B operand
  unsigned char* bs = xs + X_TILE;             // B (s, n), NB boxes
  unsigned char* cs_tile = bs + NB * BOX;      // C (q, n), NB boxes
  unsigned char* hbuf = base + Lay::OFF_H;     // h hi, then h lo: (p, n), K-major
  unsigned char* xwbuf = base + Lay::OFF_XW;   // (w⊙x) hi, then lo: (s, p), MN-major
  // for each pair of steps (2i, 2i + 1): {cs, cs, dt, dt}
  float4* pairs = reinterpret_cast<float4*>(base + Lay::OFF_SCAL);
  const float* cs_dt = reinterpret_cast<const float*>(pairs);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Lay::OFF_BAR);
  auto cs = [&](int t) { return cs_dt[(t / 2) * 4 + t % 2]; };
  auto dts = [&](int t) { return cs_dt[(t / 2) * 4 + 2 + t % 2]; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int nc = (S + Q - 1) / Q;

  // x, B, C of chunk c by TMA (steps past S arrive as zeros)
  auto load = [&](int c) {
    if (tid == 0) {
      hopper::mbar_arrive_expect_tx(full, Lay::STAGE);
      hopper::tma_load_4d(xs, &tm_x, full, p0, c * Q, h, b);
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        hopper::tma_load_3d(bs + k * BOX, &tm_b, full, 64 * k, c * Q, b);
        hopper::tma_load_3d(cs_tile + k * BOX, &tm_c, full, 64 * k, c * Q, b);
      }
    }
  };
  if (tid == 0) {
    hopper::prefetch_tensormap(&tm_x);
    hopper::prefetch_tensormap(&tm_b);
    hopper::prefetch_tensormap(&tm_c);
    hopper::mbar_init(full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  load(0);

  // warp 0 scans the decay: dt (0 past S) of steps 2·lane and 2·lane + 1 of
  // a chunk, loaded one chunk ahead; la in the log2 domain (exponents are
  // taken base 2 on the special-function unit)
  const float la_h = A[h] * LOG2E;
  const float* dtb = dt + b * dt_b + h * dt_h;
  float d0n = 0.f, d1n = 0.f;
  auto fetch_dt = [&](int c) {
    const int t = c * Q + 2 * lane;
    d0n = t < S ? dtb[t * dt_s] : 0.f;
    d1n = t + 1 < S ? dtb[(t + 1) * dt_s] : 0.f;
  };
  if (warp == 0) fetch_dt(0);

  // lane l of warp w holds, of every 64-row fragment, rows r0 = 16w + l/4
  // and r0 + 8, columns 8j + cq + {0, 1}
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const size_t state_off = ((size_t)b * H + h) * P * N;

  // hᵀ (N x 32, fp32): fragment ti holds n in [64 ti, 64 ti + 64), p in [p0, p0 + 32)
  float hacc[NB][16];
#pragma unroll
  for (int ti = 0; ti < NB; ++ti)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int n = 64 * ti + r0 + 8 * ((e % 4) / 2), p = p0 + 8 * (e / 4) + cq + e % 2;
      hacc[ti][e] = h0 ? h0[state_off + (size_t)p * N + n] : 0.f;
    }
  float sacc[32], yacc[16];
#pragma unroll
  for (int e = 0; e < 32; ++e) sacc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) yacc[e] = 0.f;

  const uint64_t dc = hopper::make_desc(cs_tile, 16, 1024, 1);   // K-major, 128-byte rows
  const uint64_t db = hopper::make_desc(bs, 16, 1024, 1);        // K-major, 128-byte rows
  const uint64_t dh = hopper::make_desc(hbuf, 16, 1024, 1);      // K-major, 128-byte rows
  const uint64_t dx = hopper::make_desc(xs, X_TILE, 512, 2);     // MN-major, 64-byte rows
  const uint64_t dxw = hopper::make_desc(xwbuf, X_TILE, 512, 2); // MN-major, 64-byte rows
  float* yb = y + ((size_t)b * S * H + h) * P + p0;

  for (int c = 0; c < nc; ++c) {
    if (warp == 0) {  // cs, the inclusive sum of la over the chunk
      const float d0 = d0n, d1 = d1n;
      if (c + 1 < nc) fetch_dt(c + 1);
      const float l0 = d0 * la_h, pair = l0 + d1 * la_h;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      pairs[lane] = make_float4(excl + l0, excl + pair, d0, d1);
    }
    // the state entering the chunk as two bf16 terms, h[p][n] with the
    // 128-byte swizzle of a K-major operand (16-byte chunk n/8 ^ p%8), by
    // stmatrix: matrix m of a store holds n in 16w + 8(m%2) + [0, 8) and p in
    // 8(jb + m/2) + [0, 8); lane l gives the address of row p = l%8 of
    // matrix l/8
#pragma unroll
    for (int ti = 0; ti < NB; ++ti)
#pragma unroll
      for (int jb = 0; jb < 4; jb += 2) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int e = 4 * (jb + m / 2) + 2 * (m % 2);
          split2(hacc[ti][e], hacc[ti][e + 1], hi[m], lo[m]);
        }
        const int p = 8 * (jb + lane / 16) + lane % 8, chunk = 2 * warp + (lane / 8) % 2;
        const int off = ti * H_BOX + p * 128 + ((chunk ^ (p & 7)) << 4);
        hopper::stmatrix_x4_trans(hbuf + off, hi[0], hi[1], hi[2], hi[3]);
        hopper::stmatrix_x4_trans(hbuf + Lay::H_TERM + off, lo[0], lo[1], lo[2], lo[3]);
      }
    hopper::fence_proxy_async();
    __syncthreads();
    hopper::mbar_wait(full, c & 1);

    // scores = C·Bᵀ (64 x 64) and y = C·h (64 x 32), K = N: two groups, so
    // that G is formed while C·h runs
    hopper::fence_operand(sacc);
    hopper::fence_operand(yacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
      hopper::wgmma_ss<0>(sacc, hopper::desc_add(dc, off), hopper::desc_add(db, off), kk > 0);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32, hoff = (kk / 4) * H_BOX + (kk % 4) * 32;
      hopper::wgmma_ss<0>(yacc, hopper::desc_add(dc, off), hopper::desc_add(dh, hoff), kk > 0);
      hopper::wgmma_ss<0>(yacc, hopper::desc_add(dc, off),
                          hopper::desc_add(dh, Lay::H_TERM + hoff), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_operand(sacc);

    // G = scores·2^(cs_q − cs_s)·dt_s for s <= q, else 0 (masked before the
    // exponent), as hi + lo terms in the register layout of a wgmma A operand
    const float cs_a = cs(r0), cs_b = cs(r0 + 8);
    uint32_t ghi[4][4], glo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 8 * kk + 2 * e;  // = 4j + i with j = 2kk + e/2, i = 2(e%2)
        const int q = (e & 1) ? r0 + 8 : r0, s0 = 8 * (2 * kk + e / 2) + cq;
        const float csq = (e & 1) ? cs_b : cs_a;
        const float4 v = pairs[s0 / 2];  // cs and dt of steps s0, s0 + 1
        const float g0 = s0 <= q ? sacc[idx] * hopper::exp2_approx(csq - v.x) * v.z : 0.f;
        const float g1 = s0 + 1 <= q ? sacc[idx + 1] * hopper::exp2_approx(csq - v.y) * v.w : 0.f;
        split2(g0, g1, ghi[kk][e], glo[kk][e]);
      }

    // y = 2^(cs_q)·(C·h) + G_hi·x + G_lo·x (x MN-major), issued before w⊙x
    // is formed
    hopper::wgmma_wait<0>();
    hopper::fence_operand(yacc);
    const float ea = hopper::exp2_approx(cs_a), eb = hopper::exp2_approx(cs_b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      yacc[4 * j + 0] *= ea;
      yacc[4 * j + 1] *= ea;
      yacc[4 * j + 2] *= eb;
      yacc[4 * j + 3] *= eb;
    }
    hopper::fence_operand(yacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::wgmma_rs<1>(yacc, ghi[kk], hopper::desc_add(dx, kk * 1024));
      hopper::wgmma_rs<1>(yacc, glo[kk], hopper::desc_add(dx, kk * 1024));
    }
    hopper::wgmma_commit();

    // w⊙x, w_s = 2^(cs_L − cs_s)·dt_s, as hi + lo terms in x's layout
    // (64-byte rows, 16-byte chunk k stored at k ^ (s/2)%4): two chunks a thread
    {
      const int srow = tid / 2;
      const float w = hopper::exp2_approx(cs(Q - 1) - cs(srow)) * dts(srow);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = (tid % 2) * 2 + half;
        const int off = srow * 64 + ((k ^ ((srow >> 1) & 3)) << 4);
        const uint4 raw = *reinterpret_cast<const uint4*>(xs + off);
        const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(xv[e]);
          split2(w * f.x, w * f.y, hi[e], lo[e]);
        }
        *reinterpret_cast<uint4*>(xwbuf + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(xwbuf + X_TILE + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    const float decay = hopper::exp2_approx(cs(Q - 1));
#pragma unroll
    for (int ti = 0; ti < NB; ++ti)
#pragma unroll
      for (int e = 0; e < 16; ++e) hacc[ti][e] *= decay;
    hopper::fence_proxy_async();
    __syncthreads();

    // hᵀ += Bᵀ·(w⊙x)_hi + Bᵀ·(w⊙x)_lo (Bᵀ: the B tile read MN-major)
#pragma unroll
    for (int ti = 0; ti < NB; ++ti) hopper::fence_operand(hacc[ti]);
    hopper::wgmma_fence();
#pragma unroll
    for (int ti = 0; ti < NB; ++ti) {
      const uint64_t dbt = hopper::make_desc(bs + ti * BOX, BOX, 1024, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::wgmma_ss<1, 1>(hacc[ti], hopper::desc_add(dbt, kk * 2048),
                               hopper::desc_add(dxw, kk * 1024));
        hopper::wgmma_ss<1, 1>(hacc[ti], hopper::desc_add(dbt, kk * 2048),
                               hopper::desc_add(dxw, X_TILE + kk * 1024));
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(yacc);
#pragma unroll
    for (int ti = 0; ti < NB; ++ti) hopper::fence_operand(hacc[ti]);

    // every warp's products are done with the chunk's tiles: load the next
    // chunk while this one's y is stored (rows of steps before S)
    __syncthreads();
    if (c + 1 < nc) load(c + 1);
    const int ta = c * Q + r0, tb = ta + 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + cq;
      if (ta < S)
        *reinterpret_cast<float2*>(yb + (size_t)ta * H * P + col) =
            make_float2(yacc[4 * j + 0], yacc[4 * j + 1]);
      if (tb < S)
        *reinterpret_cast<float2*>(yb + (size_t)tb * H * P + col) =
            make_float2(yacc[4 * j + 2], yacc[4 * j + 3]);
    }
  }

#pragma unroll
  for (int ti = 0; ti < NB; ++ti)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int n = 64 * ti + r0 + 8 * ((e % 4) / 2), p = p0 + 8 * (e / 4) + cq + e % 2;
      hT[state_off + (size_t)p * N + n] = hacc[ti][e];
    }
}

// x (B,S,H,P) as a 4-D map {P, S, H, B}, 32 x 64 boxes; Bm, Cm (B,S,N) as
// 3-D maps {N, S, B}, 64 x 64 boxes
template <int NB>
cudaError_t launch(const bf16* x, const float* dt, const float* A, const bf16* Bm,
                   const bf16* Cm, const float* h0, float* y, float* hT, int B, int S, int H,
                   int P, const Strides& st, cudaStream_t stream) {
  constexpr int N = 64 * NB;
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(kernel<NB>, Layout<NB>::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap mx, mb, mc;
  {
    const uint64_t sizes[4] = {(uint64_t)P, (uint64_t)S, (uint64_t)H, (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)st.x_s * 2, (uint64_t)st.x_h * 2,
                                 (uint64_t)st.x_b * 2};
    const uint32_t box[4] = {PS, Q, 1, 1};
    if ((e = hopper::make_tensor_map(&mx, x, 4, sizes, strides, box, 64)) != cudaSuccess)
      return e;
  }
  const bf16* ptrs[2] = {Bm, Cm};
  const long long bst[2][2] = {{st.bm_s, st.bm_b}, {st.cm_s, st.cm_b}};
  CUtensorMap* maps[2] = {&mb, &mc};
  for (int i = 0; i < 2; ++i) {
    const uint64_t sizes[3] = {(uint64_t)N, (uint64_t)S, (uint64_t)B};
    const uint64_t strides[2] = {(uint64_t)bst[i][0] * 2, (uint64_t)bst[i][1] * 2};
    const uint32_t box[3] = {64, Q, 1};
    if ((e = hopper::make_tensor_map(maps[i], ptrs[i], 3, sizes, strides, box, 128)) !=
        cudaSuccess)
      return e;
  }
  dim3 grid(P / PS, H, B);
  kernel<NB><<<grid, THREADS, Layout<NB>::SMEM, stream>>>(mx, mb, mc, dt, A, h0, y, hT, S, H, P,
                                                          st.dt_b, st.dt_s, st.dt_h);
  return cudaGetLastError();
}

}  // namespace tc

bool valid(int B, int S, int H, int P, int N) {
  return B > 0 && S > 0 && H > 0 && P > 0 && N > 0 && B <= 65535 && H <= 65535;
}

Strides strides_of(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9]};
}

}  // namespace

// x (B,S,H,P) with its last dim contiguous; dt (B,S,H) fp32; A (H,) fp32;
// Bm, Cm (B,S,N) with their last dim contiguous; strides (in elements):
// x_b, x_s, x_h, dt_b, dt_s, dt_h, bm_b, bm_s, cm_b, cm_s. h0 (B,H,P,N) fp32
// contiguous, or null for a zero state. y (B,S,H,P) and hT (B,H,P,N): fp32,
// contiguous. Each entry launches one variant on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for what it does not take).

// fma: any P, N whose state fits a block's shared memory; `bf16_inputs` says
// whether x, Bm and Cm are bf16 (else fp32)
extern "C" int ssd_scan_fma(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* h0, void* y, void* hT, int B, int S,
                            int H, int P, int N, const long long* strides, int bf16_inputs,
                            void* stream) {
  if (!valid(B, S, H, P, N)) return (int)cudaErrorInvalidValue;
  const float *dtp = static_cast<const float*>(dt), *ap = static_cast<const float*>(A);
  const float* h0p = static_cast<const float*>(h0);
  float *yp = static_cast<float*>(y), *hp = static_cast<float*>(hT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s = strides_of(strides);
  if (bf16_inputs)
    return (int)simt::launch<bf16>(x, dtp, ap, Bm, Cm, h0p, yp, hp, B, S, H, P, N, s, st);
  return (int)simt::launch<float>(x, dtp, ap, Bm, Cm, h0p, yp, hp, B, S, H, P, N, s, st);
}

// wgmma: bf16 x, Bm, Cm; P a multiple of 32; N in {64, 128, 192, 256}; the
// strides of x, Bm, Cm (but their last) multiples of 8 elements and their
// pointers 16-byte aligned (TMA); `bf16_inputs` must be 1
extern "C" int ssd_scan_wgmma(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* h0, void* y, void* hT, int B, int S,
                              int H, int P, int N, const long long* strides, int bf16_inputs,
                              void* stream) {
  if (!valid(B, S, H, P, N) || !bf16_inputs || P % tc::PS != 0) return (int)cudaErrorInvalidValue;
  const bf16 *xp = static_cast<const bf16*>(x), *bp = static_cast<const bf16*>(Bm);
  const bf16* cp = static_cast<const bf16*>(Cm);
  const float *dtp = static_cast<const float*>(dt), *ap = static_cast<const float*>(A);
  const float* h0p = static_cast<const float*>(h0);
  float *yp = static_cast<float*>(y), *hp = static_cast<float*>(hT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s = strides_of(strides);
  switch (N) {
    case 64: return (int)tc::launch<1>(xp, dtp, ap, bp, cp, h0p, yp, hp, B, S, H, P, s, st);
    case 128: return (int)tc::launch<2>(xp, dtp, ap, bp, cp, h0p, yp, hp, B, S, H, P, s, st);
    case 192: return (int)tc::launch<3>(xp, dtp, ap, bp, cp, h0p, yp, hp, B, S, H, P, s, st);
    case 256: return (int)tc::launch<4>(xp, dtp, ap, bp, cp, h0p, yp, hp, B, S, H, P, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
