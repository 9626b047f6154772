// Flash attention for Hopper (sm_90a): online-softmax attention with causal,
// sliding-window and logit-softcap masking and GQA.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel,
// flash_attention_pallas). Same numerics: scores, running max m, denominator
// l and the output accumulator in fp32; scale 1/sqrt(d) before the softcap
// c·tanh(s/c); masked scores set to -1e30; l clamped at 1e-30. Query head h
// reads kv head h / (H / Kv), with no repeated K/V.
//
// What bounds it on the H100: at the serving path's prefill (S = 512,
// d = 64, causal) the work is ~S/2 score columns per row against d-wide
// rows of Q, K, V and O, i.e. O(S) operations per byte moved: tensor-core
// throughput and the softmax's exp/max on the CUDA cores, not device memory.
//
// What the design does about it: the (S x S) scores never reach device
// memory. One block of 4 warps owns a 64-row query tile of one (batch,
// head) and walks over 64-row KV tiles only up to the causal frontier and
// from the window's start, so fully masked tiles cost nothing. Q·Kᵀ and P·V
// run on bf16 tensor cores (wmma) with fp32 accumulators; P is rounded to
// bf16 for the P·V product, as flash attention does on GPUs (the TPU kernel
// keeps it in fp32: that is the one numerical difference). Each warp keeps its
// 16 rows' scores, P and output accumulator in shared memory, so the per-row
// rescale by exp(m_prev - m_new) needs no knowledge of the fragment layout.
// The kernel reads and writes the model's (B, S, heads, d) layout through
// strides, so no transposed copies are made, and masks ragged Sq/Skv itself.
// Simple on purpose: no cp.async/TMA pipelining and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64, BKV = 64;
constexpr int NTHREADS = 128;  // 4 warps x 16 query rows
constexpr float NEG_INF = -1e30f;

struct Strides {  // element strides of a (batch, head, seq, d) view; d has stride 1
  long long b, h, s;
};

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(3 * 64 * (D + 8) + BQ * (BKV + 8)) * sizeof(bf16) +
         (size_t)(BQ * (BKV + 4) + BQ * (D + 4) + 2 * BQ) * sizeof(float);
}

// rows [r0, r0+64) of a (rows x D) matrix whose row i starts at src + i*stride;
// rows at or past nrows are zero-filled
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, int dst_ld, const bf16* __restrict__ src,
                                          long long stride, int nrows, int r0, bool vec_ok) {
  constexpr int CPR = D / 8;
  for (int c = threadIdx.x; c < 64 * CPR; c += NTHREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const int gr = r0 + r;
    bf16* d = dst + r * dst_ld + col;
    if (gr >= nrows) {
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = __float2bfloat16(0.f);
    } else if (vec_ok) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src + gr * stride + col);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = src[gr * stride + col + j];
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Kv, int Sq,
                       int Skv, Strides qst, Strides kst, Strides vst, Strides ost, int causal,
                       int window, float softcap, float scale) {
  constexpr int QLD = D + 8, PLD = BKV + 8, SLD = BKV + 4, OLD = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);          // BQ x QLD
  bf16* ks = qs + BQ * QLD;                          // BKV x QLD
  bf16* vs = ks + BKV * QLD;                         // BKV x QLD
  bf16* ps = vs + BKV * QLD;                         // BQ x PLD   probabilities
  float* ss = reinterpret_cast<float*>(ps + BQ * PLD);  // BQ x SLD   scores
  float* os = ss + BQ * SLD;                         // BQ x OLD   output accumulator
  float* ms = os + BQ * OLD;                         // BQ         running max
  float* ls = ms + BQ;                               // BQ         running denominator

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // longest causal rows first
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const bf16* qb = q + bi * qst.b + h * qst.h;
  const bf16* kb = k + bi * kst.b + kvh * kst.h;
  const bf16* vb = v + bi * vst.b + kvh * vst.h;
  bf16* ob = o + bi * ost.b + h * ost.h;
  const bool q_vec = (qst.s % 8 == 0) && ((reinterpret_cast<uintptr_t>(qb) & 15) == 0);
  const bool k_vec = (kst.s % 8 == 0) && ((reinterpret_cast<uintptr_t>(kb) & 15) == 0);
  const bool v_vec = (vst.s % 8 == 0) && ((reinterpret_cast<uintptr_t>(vb) & 15) == 0);

  load_rows<D>(qs, QLD, qb, qst.s, Sq, q0, q_vec);
  for (int i = threadIdx.x; i < BQ * OLD; i += NTHREADS) os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    ms[i] = NEG_INF;
    ls[i] = 0.f;
  }
  __syncthreads();

  // KV tiles that hold at least one unmasked key for some row of this tile
  int t_end = (Skv + BKV - 1) / BKV;
  if (causal) t_end = min(t_end, (q0 + BQ - 1) / BKV + 1);
  int t_begin = 0;
  if (window > 0) {
    const int lo = q0 - window - (BKV - 1);
    t_begin = lo < 0 ? 0 : lo / BKV + 1;
  }

  const int row0 = warp * 16;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BKV;
    load_rows<D>(ks, QLD, kb, kst.s, Skv, k0, k_vec);
    load_rows<D>(vs, QLD, vb, vst.s, Skv, k0, v_vec);
    __syncthreads();

    // S = Q·Kᵀ for this warp's 16 rows
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
      wmma::fill_fragment(sacc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
        wmma::load_matrix_sync(fq, qs + row0 * QLD + kk, QLD);
        wmma::load_matrix_sync(fk, ks + j * 16 * QLD + kk, QLD);
        wmma::mma_sync(sacc, fq, fk, sacc);
      }
      wmma::store_matrix_sync(ss + row0 * SLD + j * 16, sacc, SLD, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time; each lane holds two of the 64 columns
    for (int rr = 0; rr < 16; ++rr) {
      const int row = row0 + rr, qpos = q0 + row;
      float s[2];
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = lane + 32 * i, kpos = k0 + c;
        float x = ss[row * SLD + c] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i]);
      }
      mx = warp_max(mx);
      const float m_prev = ms[row];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      ps[row * PLD + lane] = __float2bfloat16(p0);
      ps[row * PLD + lane + 32] = __float2bfloat16(p1);
      const float psum = warp_sum(p0 + p1);
      const float corr = expf(m_prev - m_new);
      for (int c = lane; c < D; c += 32) os[row * OLD + c] *= corr;
      __syncwarp();  // every lane has read ms[row] before it changes
      if (lane == 0) {
        ms[row] = m_new;
        ls[row] = ls[row] * corr + psum;
      }
    }
    __syncwarp();

    // O += P·V for this warp's 16 rows
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, os + row0 * OLD + j * 16, OLD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fp, ps + row0 * PLD + kk, PLD);
        wmma::load_matrix_sync(fv, vs + kk * QLD + j * 16, QLD);
        wmma::mma_sync(oacc, fp, fv, oacc);
      }
      wmma::store_matrix_sync(os + row0 * OLD + j * 16, oacc, OLD, wmma::mem_row_major);
    }
    __syncthreads();  // K/V tiles are overwritten next
  }

  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int row = row0 + rr, qpos = q0 + row;
    if (qpos >= Sq) break;
    const float l = fmaxf(ls[row], 1e-30f);
    for (int c = lane; c < D; c += 32)
      ob[qpos * ost.s + c] = __float2bfloat16(os[row * OLD + c] / l);
  }
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int Kv,
                   int Sq, int Skv, const Strides* st, int causal, int window, float softcap,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      q, k, v, o, H, Kv, Sq, Skv, st[0], st[1], st[2], st[3], causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Kv,Skv,D), o (B,H,Sq,D) as strided bf16 views whose
// last dim is contiguous; strides = 12 element strides (batch, head, seq) of
// q, k, v, o in that order. Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                    int H, int Kv, int Sq, int Skv, int D,
                                    const long long* strides, int causal, int window,
                                    float softcap, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Kv <= 0 || H % Kv != 0 || Sq <= 0 || Skv <= 0 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch<16>(qp, kp, vp, op, B, H, Kv, Sq, Skv, st, causal, window, softcap, scale, s);
    case 32: return (int)launch<32>(qp, kp, vp, op, B, H, Kv, Sq, Skv, st, causal, window, softcap, scale, s);
    case 64: return (int)launch<64>(qp, kp, vp, op, B, H, Kv, Sq, Skv, st, causal, window, softcap, scale, s);
    case 128: return (int)launch<128>(qp, kp, vp, op, B, H, Kv, Sq, Skv, st, causal, window, softcap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
