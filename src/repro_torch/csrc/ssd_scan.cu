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
// states written once (52.8 MB at B=8, S=512, H=24, P=64, N=128: 15.8 µs at
// 3.35 TB/s); the operations, ~2·S·(L·N + L·P + 2·P·N) per (b, h) (4.4 GFLOP
// there), would take less at tensor-core rates (4.5 µs at 989 TFLOP/s). This
// first version does its products as fp32 FMAs on the CUDA cores (67 TFLOP/s:
// 66 µs at best), so the arithmetic, not the bytes, is what bounds it.
//
// What the design does about the TPU kernel's assumptions: the TPU grid runs
// its chunk axis in order and keeps the state in VMEM between grid steps;
// blocks on the H100 run in no order. So one block owns one (b, h) and loops
// over the chunks itself, with the (P, N) state resident in shared memory
// for the whole sequence: the state never goes to device memory between
// chunks. The TPU's 256-step chunk would need 256x256 fp32 scores (256 KB),
// more than a block's shared memory; the SSD does not depend on the chunk
// length, so the block walks the sequence in chunks of L = 32 (one warp
// computes the cumulative decay with shuffles) and everything of a chunk,
// 80 KB at full width, fits twice on an SM. Each product is a small
// shared-memory GEMM in which a thread owns an RM x RN tile of outputs, with
// rows padded to an odd stride so that no two lanes of a warp hit one bank.
// No tensor cores, no cp.async or TMA: making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

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

struct Strides {
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, bm_b, bm_s, cm_b, cm_s;
};

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
                   const long long* strides, cudaStream_t stream) {
  const size_t smem = smem_floats(P, N) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
             strides[5], strides[6], strides[7], strides[8], strides[9]};
  dim3 grid(H, B);
  ssd_scan_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm), h0,
      y, hT, S, H, P, N, st);
  return cudaGetLastError();
}

}  // namespace

// x (B,S,H,P) with its last dim contiguous; dt (B,S,H) fp32; A (H,) fp32;
// Bm, Cm (B,S,N) with their last dim contiguous; strides (in elements):
// x_b, x_s, x_h, dt_b, dt_s, dt_h, bm_b, bm_s, cm_b, cm_s. h0 (B,H,P,N) fp32
// contiguous, or null for a zero state. y (B,S,H,P) and hT (B,H,P,N): fp32,
// contiguous. `bf16` says whether x, Bm and Cm are bf16 (else fp32).
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, const void* h0, void* y, void* hT, int B, int S, int H,
                        int P, int N, const long long* strides, int bf16_inputs, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const float *dtp = static_cast<const float*>(dt), *ap = static_cast<const float*>(A);
  const float* h0p = static_cast<const float*>(h0);
  float *yp = static_cast<float*>(y), *hp = static_cast<float*>(hT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_inputs)
    return (int)launch<bf16>(x, dtp, ap, Bm, Cm, h0p, yp, hp, B, S, H, P, N, strides, st);
  return (int)launch<float>(x, dtp, ap, Bm, Cm, h0p, yp, hp, B, S, H, P, N, strides, st);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
