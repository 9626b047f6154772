// Flash attention for Hopper (sm_90a): online-softmax attention with causal,
// sliding-window and logit-softcap masking and GQA.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel,
// flash_attention_pallas). Same numerics: scores, running max m, denominator
// l and the output accumulator in fp32; scale 1/sqrt(d) before the softcap
// c·tanh(s/c); masked scores set to -1e30 (-inf in the wgmma variant: the
// same weights); l clamped at 1e-30. Query head h reads kv head h / (H / Kv),
// with no repeated K/V. In bf16 P is rounded to bf16 for the P·V product, as
// flash attention does on GPUs (the TPU kernel keeps it in fp32, as the fp32
// variant does: that is the one numerical difference). q, k, v and o are
// read and written in the model's
// (B, S, heads, d) layout through strides, so no transposed copies are
// made, and ragged Sq/Skv are masked in the kernel.
//
// What bounds it on the H100: at the serving path's prefill (S = 512,
// d = 64, causal) the work is ~S/2 score columns per row against d-wide
// rows of Q, K, V and O, O(S) operations per byte moved: tensor-core
// throughput and the softmax's exponentials, not device memory. So is
// gemma2-9b's prefill (S = 8192, d = 256, half its layers windowed to 4096)
// and the other dense configs' (d = 128).
//
// Three variants, picked by the wrapper (kernels/flash_attention.py
// ``variant``):
//
// * wgmma (d = 64, 128, 256 with 16-byte aligned rows; the main path): one
//   block per two query tiles of one (batch, head), tile nq-1-i then tile i,
//   so every block of a causal prefill has the same work and pays the start
//   of its load pipeline once for both; the longest rows run first. A
//   producer loads each Q tile once and K/V tiles through a TMA ring
//   (mbarriers; K and V signalled and freed apart, so Q·Kᵀ starts before V
//   lands and K's slot refills before V's) that runs on across the two
//   tiles, only the tiles up to the causal frontier and from the window's
//   start. Rows wider than 64 bf16 arrive as one TMA
//   box per 64-column block (the 128-byte swizzle's width), so Q·Kᵀ walks
//   the column blocks every 4 k-steps and P·V's B operand (V, MN-major)
//   spans them at one tile's stride. Consumer warpgroups (one at d = 64 and
//   128, two blocks an SM at d = 128; two of 64 rows each at d = 256, whose
//   O takes 128 registers a thread) compute S = Q·Kᵀ with wgmma (both
//   operands in shared memory) into registers and run the online softmax on
//   the accumulator fragment (row max and sum over the 4 lanes of a quad,
//   exp2 with scale·log2(e) folded in, masks only on the tiles at the
//   diagonal, the window's edge and the ragged edge; the softcap as
//   1 - 2/(2^x + 1)). P is converted to bf16 in registers and fed as the
//   register operand of the P·V wgmma (n = d, V from shared memory), which
//   runs while the next tile's softmax does. O stays in registers for the
//   whole KV loop and is written once.
// * wmma (head dims 16 and 32, and any head dim with misaligned strides):
//   the first port's kernel, wmma fragments with the scores and O in shared
//   memory. At d = 256 its tiles take 195,072 bytes of shared memory (Q, K,
//   V 64 x 264 bf16, P 64 x 72 bf16, S 64 x 68 and O 64 x 260 fp32): one
//   block of 4 warps on an SM.
// * fp32 (fp32 inputs, head dims 16, 32, 64, 128, 256, any strides; the
//   smoke configs serve in fp32): 3xTF32 on wgmma, P kept in fp32 as the TPU
//   kernel keeps it (namespace tf32x3). What bounds it is the tensor cores'
//   TF32 rate over three products (165 TFLOP/s of fp32 work). Each fp32
//   operand is split into a TF32 big and small term and three products
//   (small·big, big·small, big·big) are taken, for S = Q·Kᵀ and for O +=
//   P·V, with tc's schedule: one block per two query tiles (nq-1-i, then
//   i) of 64 rows, only the key tiles up to the causal frontier and from the
//   window's start, masks only at the edges, the softcap as tc's. Two
//   producer warpgroups copy Q once a pass and K and V a chunk of 64 keys x
//   64 dims at a time into raw slots by cp.async (16- or 8-byte copies
//   where rows are 16-byte aligned, 4-byte copies otherwise, so every
//   stride takes this variant), split them and write the terms as K-major
//   tiles of the 128-byte swizzle (V transposed); one consumer warpgroup
//   runs the wgmmas,
//   S into registers, the online softmax there, P's terms as the register
//   operand of P·V, each key tile's P·V summed from zero and added into O in
//   fp32 (the tensor cores' sums are not rounded to nearest).
//   kernels/attn_ref.py ``flash_attention_tf32x3_ref`` mirrors its
//   arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

namespace {

struct Strides {  // element strides of a (batch, head, seq, d) view; d has stride 1
  long long b, h, s;
};

// 64-key tiles [begin, end) that hold at least one unmasked key for some row
// of the `rows`-row query tile at q0
__device__ __forceinline__ void kv_range(int q0, int rows, int Skv, int causal, int window,
                                         int& begin, int& end) {
  end = (Skv + 63) / 64;
  if (causal) end = min(end, (q0 + rows - 1) / 64 + 1);
  begin = 0;
  if (window > 0) {
    const int lo = q0 - window - 63;
    begin = lo < 0 ? 0 : lo / 64 + 1;
  }
  // at least one tile: a window that starts past the last key (non-causal,
  // Skv < Sq) leaves the last tile, all masked, and an output of 0
  begin = min(begin, end - 1);
}

// ===========================================================================
// wgmma: TMA + warpgroup MMA, d = 64, 128, 256
// ===========================================================================
namespace tc {

constexpr int BKV = 64;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Per head dim: NWG consumer warpgroups of 64 query rows each (a block's
// query tile is 64·NWG rows), a ring of STAGES K/V tiles, QBUFS query tiles
// (2: both passes' tiles load up front; 1: the second pass's once the first
// is done with it) and MINB blocks an SM, so that another warpgroup's
// products run during one's softmax: at d = 64 three blocks (the launch
// bound holds registers to 136), at d = 128 two (96 KB each), at d = 256 a
// second warpgroup of the block (Q, K and V take 192 KB).
// PWARPS: the producer's warps. At d = 256 it is a whole warpgroup that
// gives its registers to the consumers (REGS: 232 a thread, for O's 128
// accumulators; with a lone producer warp the 9 warps' registers are split
// evenly, 168 a thread, and O spills).
template <int D> struct Cfg;
template <> struct Cfg<64> {
  static constexpr int NWG = 1, STAGES = 3, QBUFS = 2, MINB = 3, PWARPS = 1, REGS = 0;
};
template <> struct Cfg<128> {
  static constexpr int NWG = 1, STAGES = 2, QBUFS = 2, MINB = 2, PWARPS = 1, REGS = 0;
};
template <> struct Cfg<256> {
  static constexpr int NWG = 2, STAGES = 2, QBUFS = 1, MINB = 1, PWARPS = 4, REGS = 232;
};
constexpr int PRODUCER_REGS = 40;  // 128 x 40 + 256 x 232 <= the SM's 65,536

template <int D>
struct Layout {
  static constexpr int NWG = Cfg<D>::NWG, STAGES = Cfg<D>::STAGES, QBUFS = Cfg<D>::QBUFS;
  static constexpr int BQ = 64 * NWG;  // query rows of a block
  // the consumer warpgroups, then the producer
  static constexpr int THREADS = 128 * NWG + 32 * Cfg<D>::PWARPS;
  // A tile of R rows is stored as D/64 column blocks of R rows x 128 bytes
  // (64 bf16, the 128-byte swizzle's width), one TMA box each, 1024-aligned.
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr size_t SMEM = 1024 + QBUFS * Q_BYTES + 2 * STAGES * KV_BYTES + 256;
  static_assert(SMEM <= 227 * 1024, "tiles too large for shared memory");
};

// c·tanh(x·scale/c) in the log2 domain (times log2 e), as 1 - 2/(2^(2x·scale·log2(e)/c) + 1):
// two special-function ops, against a dozen instructions and a branch in
// tanhf. Its absolute error (~1e-7 of c) is what reaches the exponent.
__device__ __forceinline__ float softcap_log2(float x, float cap_in2, float cap_out) {
  return fmaf(-2.f * cap_out, __fdividef(1.f, hopper::exp2_approx(x * cap_in2) + 1.f), cap_out);
}

// S (64 x 64) = Q·Kᵀ for one warpgroup: K-major Q and K with 128-byte rows,
// k-step kk reading 32 bytes of column block kk/4 (column blocks `qblock`
// and one 64-row tile apart)
template <int D>
__device__ __forceinline__ void issue_qk(float (&sacc)[32], uint64_t dq, uint64_t dk, int qblock) {
  hopper::fence_operand(sacc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_ss<0>(sacc, hopper::desc_add(dq, (kk / 4) * qblock + (kk % 4) * 32),
                        hopper::desc_add(dk, (kk / 4) * BKV * 128 + (kk % 4) * 32), kk > 0);
  hopper::wgmma_commit();
}

// O += P·V: P's bf16 fragment as the register operand, V MN-major (its
// column blocks one 64-row tile apart, 8-row groups 1024 bytes)
template <int D>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2], const uint32_t (&pa)[4][4],
                                         const unsigned char* v) {
  const uint64_t dv = hopper::make_desc(v, BKV * 128, 1024, 1);
  hopper::fence_operand(oacc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    hopper::wgmma_rs<1>(oacc, pa[kk], hopper::desc_add(dv, kk * 16 * 128));
  hopper::wgmma_commit();
}

// The online softmax of one 64-key tile (first key k0) on a warpgroup's
// score fragment: the softcap, masks only where the tile crosses an edge of
// the warpgroup's rows (first row q0; the lane's rows ra, rb), the running
// max m and sum l, and P = 2^(s·factor − m) in place. Returns O's rescale
// factors. A masked score is -inf here, not -1e30: scaled inside an FMA,
// -1e30 would leave the rounding error of m (~1e22) in the exponent. Both
// give a weight of exactly 0 in fp32 on any row with an unmasked key; m
// starts at -1e30, so no -inf - -inf arises.
struct Softmax {
  int Skv, causal, window;
  bool capped;
  float factor, cap_in2, cap_out;  // see the consumer's set-up

  __device__ __forceinline__ void tile(float (&sacc)[32], int k0, int q0, int ra, int rb, int q,
                                       float& m_a, float& m_b, float& l_a, float& l_b,
                                       float& corr_a, float& corr_b) const {
    const bool edge = (k0 + BKV > Skv) || (causal && k0 + BKV - 1 > q0) ||
                      (window > 0 && k0 <= q0 + 63 - window);
    if (capped || edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = sacc[4 * j + e];
          if (capped) v = softcap_log2(v, cap_in2, cap_out);
          if (edge) {
            const int col = k0 + 8 * j + 2 * q + (e & 1), row = e < 2 ? ra : rb;
            bool ok = col < Skv;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && col > row - window;
            v = ok ? v : -INFINITY;
          }
          sacc[4 * j + e] = v;
        }
    }
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sacc[4 * j + 0], sacc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a * factor), mn_b = fmaxf(m_b, mx_b * factor);
    corr_a = hopper::exp2_approx(m_a - mn_a);
    corr_b = hopper::exp2_approx(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sacc[4 * j + 0] = hopper::exp2_approx(fmaf(sacc[4 * j + 0], factor, -mn_a));
      sacc[4 * j + 1] = hopper::exp2_approx(fmaf(sacc[4 * j + 1], factor, -mn_a));
      sacc[4 * j + 2] = hopper::exp2_approx(fmaf(sacc[4 * j + 2], factor, -mn_b));
      sacc[4 * j + 3] = hopper::exp2_approx(fmaf(sacc[4 * j + 3], factor, -mn_b));
      sum_a += sacc[4 * j + 0] + sacc[4 * j + 1];
      sum_b += sacc[4 * j + 2] + sacc[4 * j + 3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
  }
};

// P's accumulator fragment is the A operand's register layout
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4], const float (&sacc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = hopper::pack_bf16(sacc[8 * kk + 2 * e], sacc[8 * kk + 2 * e + 1]);
}

// keeps P's registers unchanged until the P·V wgmma that reads them is done
__device__ __forceinline__ void hold(const uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(pa[kk][e]) : "memory");
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::THREADS, Cfg<D>::MINB)
kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
       const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int H, int Kv, int Sq,
       int Skv, Strides ost, int causal, int window, float softcap, float scale) {
  using Lay = Layout<D>;
  constexpr int NWG = Lay::NWG, STAGES = Lay::STAGES, QBUFS = Lay::QBUFS, BQ = Lay::BQ;
  constexpr int QB = Lay::Q_BYTES, KVB = Lay::KV_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~1023ull);
  unsigned char* qs = base;                       // QBUFS query tiles
  unsigned char* ks = base + QBUFS * QB;          // STAGES tiles
  unsigned char* vs = ks + STAGES * KVB;          // STAGES tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + STAGES * KVB);
  uint64_t* qfull = bars;  // QBUFS
  uint64_t* qempty = qfull + QBUFS;
  uint64_t* kfull = qempty + QBUFS;  // STAGES each
  uint64_t* vfull = kfull + STAGES;
  uint64_t* kempty = vfull + STAGES;
  uint64_t* vempty = kempty + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nq = (Sq + BQ - 1) / BQ;
  const int bx = blockIdx.x;
  const int passes = nq - 1 - bx > bx ? 2 : 1;  // the middle tile of an odd nq alone
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (H / Kv);

  if (tid == 0) {
    for (int s = 0; s < QBUFS; ++s) {
      hopper::mbar_init(&qfull[s], 1);
      hopper::mbar_init(&qempty[s], NWG);  // one arrive per consumer warpgroup
    }
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&kfull[s], 1);
      hopper::mbar_init(&vfull[s], 1);
      hopper::mbar_init(&kempty[s], NWG);
      hopper::mbar_init(&vempty[s], NWG);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // producer
    if constexpr (Cfg<D>::REGS > 0) hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 4 * NWG && lane == 0) {
      hopper::prefetch_tensormap(&tm_q);
      hopper::prefetch_tensormap(&tm_k);
      hopper::prefetch_tensormap(&tm_v);
      int i = 0;  // K/V tiles loaded so far, over both passes
      for (int pass = 0; pass < passes; ++pass) {
        const int q0 = (pass == 0 ? nq - 1 - bx : bx) * BQ;
        int t_begin, t_end;
        kv_range(q0, BQ, Skv, causal, window, t_begin, t_end);
        const int slot = pass % QBUFS;
        hopper::mbar_wait(&qempty[slot], ((pass / QBUFS) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&qfull[slot], QB);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          hopper::tma_load_4d(qs + slot * QB + c * BQ * 128, &tm_q, &qfull[slot], 64 * c, q0, h,
                              bi);
        // K and V of a slot are freed apart: K once its Q·Kᵀ is done, V once
        // its P·V is, a tile later
        for (int t = t_begin; t < t_end; ++t, ++i) {
          const int s = i % STAGES, parity = ((i / STAGES) & 1) ^ 1;
          hopper::mbar_wait(&kempty[s], parity);
          hopper::mbar_arrive_expect_tx(&kfull[s], KVB);
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
            hopper::tma_load_4d(ks + s * KVB + c * BKV * 128, &tm_k, &kfull[s], 64 * c, t * BKV,
                                kvh, bi);
          hopper::mbar_wait(&vempty[s], parity);
          hopper::mbar_arrive_expect_tx(&vfull[s], KVB);
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
            hopper::tma_load_4d(vs + s * KVB + c * BKV * 128, &tm_v, &vfull[s], 64 * c, t * BKV,
                                kvh, bi);
        }
      }
    }
    return;
  }

  if constexpr (Cfg<D>::REGS > 0) hopper::setmaxnreg_inc<Cfg<D>::REGS>();
  // consumer warpgroup wg owns rows [64 wg, 64 wg + 64) of the block's query
  // tile: lane l of its warp w holds rows ra = q0 + 16w + l/4 and rb = ra + 8,
  // columns 8j + 2(l%4) + {0, 1} of every fragment
  const int wg = warp / 4, w = warp % 4, q = lane % 4;
  const bool leader = tid % 128 == 0;
  // p = 2^(s·factor − m): raw scores times scale·log2(e) inside the
  // exponent's FMA, or, capped, scores already in the log2 domain
  const bool capped = softcap > 0.f;
  const Softmax sm{Skv, causal, window, capped, capped ? 1.f : scale * LOG2E,
                   capped ? 2.f * LOG2E * scale / softcap : 0.f, softcap * LOG2E};
  float oacc[D / 2], sacc[32];
  uint32_t pa[4][4];
#pragma unroll
  for (int e = 0; e < 32; ++e) sacc[e] = 0.f;
  int i = 0;  // K/V tiles consumed so far, over both passes
  for (int pass = 0; pass < passes; ++pass) {
    const int qb0 = (pass == 0 ? nq - 1 - bx : bx) * BQ;  // the block's first row
    const int q0 = qb0 + 64 * wg;                          // this warpgroup's
    const int ra = q0 + w * 16 + lane / 4, rb = ra + 8;
    int t_begin, t_end;
    kv_range(qb0, BQ, Skv, causal, window, t_begin, t_end);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) oacc[e] = 0.f;
    float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;  // l: this lane's share of the row sum
    float corr_a, corr_b;

    const int slot = pass % QBUFS;
    hopper::mbar_wait_opaque(&qfull[slot], (pass / QBUFS) & 1);
    const uint64_t dq = hopper::make_desc(qs + slot * QB + wg * 64 * 128, 16, 1024, 1);

    // the first tile's scores and P (O is still 0)
    int s = i % STAGES;
    hopper::mbar_wait_opaque(&kfull[s], (i / STAGES) & 1);
    issue_qk<D>(sacc, dq, hopper::make_desc(ks + s * KVB, 16, 1024, 1), BQ * 128);
    hopper::wgmma_wait<0>();
    hopper::fence_operand(sacc);
    if (leader) hopper::mbar_arrive(&kempty[s]);  // K slot s is free (of this warpgroup)
    sm.tile(sacc, t_begin * BKV, q0, ra, rb, q, m_a, m_b, l_a, l_b, corr_a, corr_b);
    pack_p(pa, sacc);
    // Then tile t's softmax runs while the tensor cores do tile t-1's P·V:
    // Q·Kᵀ of tile t and P·V of tile t-1 are issued together, the scores
    // waited for alone, and O rescaled once P·V is done.
    for (int t = t_begin + 1; t < t_end; ++t) {
      const int sp = s;  // tile t-1's slot
      ++i;
      s = i % STAGES;
      hopper::mbar_wait_opaque(&kfull[s], (i / STAGES) & 1);
      hopper::mbar_wait_opaque(&vfull[sp], ((i - 1) / STAGES) & 1);
      issue_qk<D>(sacc, dq, hopper::make_desc(ks + s * KVB, 16, 1024, 1), BQ * 128);
      issue_pv<D>(oacc, pa, vs + sp * KVB);
      hopper::wgmma_wait<1>();  // Q·Kᵀ of tile t is done
      hopper::fence_operand(sacc);
      sm.tile(sacc, t * BKV, q0, ra, rb, q, m_a, m_b, l_a, l_b, corr_a, corr_b);
      hopper::wgmma_wait<0>();  // P·V of tile t-1 is done
      hopper::fence_operand(oacc);
      hold(pa);
      if (leader) {
        hopper::mbar_arrive(&kempty[s]);
        hopper::mbar_arrive(&vempty[sp]);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j + 0] *= corr_a;
        oacc[4 * j + 1] *= corr_a;
        oacc[4 * j + 2] *= corr_b;
        oacc[4 * j + 3] *= corr_b;
      }
      pack_p(pa, sacc);
    }
    // the last tile's P·V
    hopper::mbar_wait_opaque(&vfull[s], (i / STAGES) & 1);
    issue_pv<D>(oacc, pa, vs + s * KVB);
    hopper::wgmma_wait<0>();
    hopper::fence_operand(oacc);
    hold(pa);
    if (leader) hopper::mbar_arrive(&vempty[s]);
    ++i;
    if (leader) hopper::mbar_arrive(&qempty[slot]);  // and so is its part of the Q tile

#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
    bf16* ob = o + bi * ost.b + h * ost.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * q;
      if (ra < Sq)
        *reinterpret_cast<bf162*>(ob + ra * ost.s + col) =
            __floats2bfloat162_rn(oacc[4 * j + 0] * inv_a, oacc[4 * j + 1] * inv_a);
      if (rb < Sq)
        *reinterpret_cast<bf162*>(ob + rb * ost.s + col) =
            __floats2bfloat162_rn(oacc[4 * j + 2] * inv_b, oacc[4 * j + 3] * inv_b);
    }
  }
}

// q (B,H,Sq,D), k/v (B,Kv,Skv,D) as 4-D tensor maps {d, seq, head, batch}
// read in boxes of 64 columns: BQ query rows, 64 key rows
template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int Kv,
                   int Sq, int Skv, const Strides* st, int causal, int window, float softcap,
                   float scale, cudaStream_t stream) {
  using Lay = Layout<D>;
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(kernel<D>, Lay::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap maps[3];
  const bf16* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const uint64_t sizes[4] = {(uint64_t)D, (uint64_t)(i ? Skv : Sq), (uint64_t)(i ? Kv : H),
                               (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)st[i].s * 2, (uint64_t)st[i].h * 2,
                                 (uint64_t)st[i].b * 2};
    const uint32_t box[4] = {64, (uint32_t)(i ? BKV : Lay::BQ), 1, 1};
    if ((e = hopper::make_tensor_map(&maps[i], ptrs[i], 4, sizes, strides, box, 128)) !=
        cudaSuccess)
      return e;
  }
  dim3 grid(((Sq + Lay::BQ - 1) / Lay::BQ + 1) / 2, H, B);
  kernel<D><<<grid, Lay::THREADS, Lay::SMEM, stream>>>(maps[0], maps[1], maps[2], o, H, Kv, Sq,
                                                       Skv, st[3], causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace tc

// ===========================================================================
// wmma: the first port's kernel, for the other head dims
// ===========================================================================
namespace legacy {

constexpr int BQ = 64, BKV = 64;
constexpr int NTHREADS = 128;  // 4 warps x 16 query rows
constexpr float NEG_INF = -1e30f;

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
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(flash_attention_kernel<D>, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      q, k, v, o, H, Kv, Sq, Skv, st[0], st[1], st[2], st[3], causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace legacy

// ===========================================================================
// fp32: 3xTF32 on wgmma, for fp32 inputs
// ===========================================================================
namespace tf32x3 {

constexpr int BKV = 64;         // keys of a tile
constexpr int TILE = 64 * 128;  // a column block of a 64-row term tile: rows of 32 fp32
constexpr size_t SMEM_MAX = 227 * 1024;

// One consumer warpgroup of 64 query rows and two producer warpgroups, and
// their register budgets: a consumer holds O's D/2 accumulators, S's and
// P's 64 and a tile's P·V (PIPE_PV: two of its pieces in flight, below d =
// 256). setmaxnreg moves registers within the block's allocation at launch
// (THREADS x what ptxas may give each at this size), so the budgets must
// fit in it. On the card neither a third or fourth producer warpgroup nor
// a deeper prefetch ran faster; two consumer warpgroups sharing the chunks
// (128 query rows a block, 184-192 registers each) spilled and ran 1.2-2x
// slower.
constexpr int BQ = 64, PT = 256, THREADS = 128 + PT;
constexpr int PRODUCER_REGS = 96, CONSUMER_REGS = 248;
static_assert(PT * PRODUCER_REGS + 128 * CONSUMER_REGS <= THREADS * (65536 / THREADS / 8 * 8),
              "the register budgets exceed the block's allocation");

// Q's terms stay in shared memory for the whole pass; K and V come through a
// ring of STAGES slots of one chunk each: a K chunk is 64 keys x NC dims
// (K-major, as Q), a V chunk NC dims x 64 keys (transposed: TF32 wgmma
// takes K-major operands only), each as its big and its small term. Each
// job (a chunk of Q, K or V) first lands as loaded in one of RS raw slots
// (64 rows x NC fp32). At d = 256 Q's terms take 128 KB: 64-dim chunks keep
// 2 ring slots and 2 raw slots in what is left, and O's 128 accumulators
// leave registers for P·V's sum of a tile in 32-column pieces (VN).
template <int D>
struct Layout {
  static constexpr bool PIPE_PV = D < 256;
  static constexpr int NC = D < 64 ? D : 64;           // dims of a chunk
  static constexpr int NCH = D / NC;                   // chunks of a head dim
  static constexpr int VN = D == 256 ? 32 : NC;        // P·V's columns a wgmma
  static constexpr int Q_TERM = (D + 31) / 32 * TILE;  // one of Q's terms: 64 rows x D
  static constexpr int K_TERM = (NC + 31) / 32 * TILE;  // one of a K chunk's: 64 keys x NC
  static constexpr int V_TERM = NC * 2 * 128;           // one of a V chunk's: NC dims x 64 keys
  static constexpr int SLOT = 2 * (K_TERM > V_TERM ? K_TERM : V_TERM);
  static constexpr int RAW = 64 * NC * 4, RS = D == 256 ? 2 : 3;
  static constexpr int FIT = (int)((SMEM_MAX - 2048 - 2 * Q_TERM - RS * RAW) / SLOT);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr size_t SMEM =
      1024 + 2 * (size_t)Q_TERM + (size_t)STAGES * SLOT + (size_t)RS * RAW + 256;
  static_assert(STAGES >= 2 && SMEM <= SMEM_MAX, "tiles too large for shared memory");
};

// the rows of one (batch, head) of q, k or v: row i at p + i·s, `rows` rows;
// vec: every row 16-byte aligned (16- and 8-byte copies)
struct View {
  const float* p;
  long long s;
  int rows;
  bool vec;
};

// cp.async of n = 4 or 2 values of row `row` at column col (zeros past the
// last row) into dst
template <int N>
__device__ __forceinline__ void copy(float* dst, const View& v, int row, int col) {
  const bool in = row < v.rows;
  const float* src = in ? v.p + row * v.s + col : v.p;
  if (v.vec) {
    if (N == 4) hopper::cp_async16(dst, src, in ? 16 : 0);
    else hopper::cp_async8(dst, src, in ? 8 : 0);
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) hopper::cp_async4(dst + i, in ? src + i : v.p, in ? 4 : 0);
}

// A producer thread's share (pt of PT) of a K-major chunk: rows r0 + [0,
// 64) at columns c0 + [0, NC), 4 columns a copy, into the raw slot (row i
// at raw + i·NC); it reads back only what it copied
template <int NC>
__device__ __forceinline__ void copy_rows(float* raw, const View& v, int r0, int c0, int pt) {
  constexpr int C4 = NC / 4;
#pragma unroll
  for (int e = 0; e < 16 * NC / PT; ++e) {
    const int f = pt + PT * e, row = f / C4, col = 4 * (f % C4);
    copy<4>(raw + row * NC + col, v, r0 + row, c0 + col);
  }
}

// ... its terms into the big and small tiles at row offset rb (column cb +
// [0, NC) of their 128-byte rows of 32 fp32, one column block of 64 rows a
// 32)
template <int NC>
__device__ __forceinline__ void put_rows(unsigned char* big, unsigned char* small,
                                         const float* raw, int cb, int pt) {
  constexpr int C4 = NC / 4;
#pragma unroll
  for (int e = 0; e < 16 * NC / PT; ++e) {
    const int f = pt + PT * e, row = f / C4, col = 4 * (f % C4);
    const float4 x = *reinterpret_cast<const float4*>(raw + row * NC + col);
    uint32_t b[4], s[4];
    hopper::split_tf32(x.x, b[0], s[0]);
    hopper::split_tf32(x.y, b[1], s[1]);
    hopper::split_tf32(x.z, b[2], s[2]);
    hopper::split_tf32(x.w, b[3], s[3]);
    const int at = ((cb + col) / 32) * TILE, c = ((cb + col) % 32) / 4;
    hopper::put_chunk(big + at, row, c, b[0], b[1], b[2], b[3]);
    hopper::put_chunk(small + at, row, c, s[0], s[1], s[2], s[3]);
  }
}

// A V chunk in units u = pt + PT·e < 4·NC: columns c0 + 2·(u % (NC/2)) +
// {0, 1} of keys k0 + 8·(u / (NC/2)) + [0, 8), one 8-key step of two rows
// of the transposed tile, copied into the raw slot (a warp's copies and
// reads run along a key's row)
template <int NC>
__device__ __forceinline__ void copy_cols(float* raw, const View& v, int k0, int c0, int pt) {
#pragma unroll
  for (int e = 0; e < (4 * NC + PT - 1) / PT; ++e) {
    const int u = pt + PT * e;
    if (u >= 4 * NC) return;
    const int col = 2 * (u % (NC / 2)), key = 8 * (u / (NC / 2));
#pragma unroll
    for (int j = 0; j < 8; ++j) copy<2>(raw + (key + j) * NC + col, v, k0 + key + j, c0 + col);
  }
}

// ... into rows (dims) of the transposed tiles (NC rows x 128 bytes per 32
// keys). The P·V wgmma takes P from its accumulator registers, where a
// thread holds keys 2q and 2q + 1 of each 8 (q = lane % 4) but the register
// operand's k index is q and q + 4: so k index q holds key 2q and q + 4 key
// 2q + 1, here as in P's fragment (keys 0, 2, 4, 6 in the step's first 16
// bytes, 1, 3, 5, 7 in its second). A unit writes row 2dp + ((dp/4 + ii) &
// 1) at step ii (dp = u % (NC/2)): a warp's 16-byte writes then cover all 8
// swizzled positions of a 128-byte row (4 wavefronts for 512 bytes).
template <int NC>
__device__ __forceinline__ void put_cols(unsigned char* big, unsigned char* small,
                                         const float* raw, int pt) {
#pragma unroll
  for (int e = 0; e < (4 * NC + PT - 1) / PT; ++e) {
    const int u = pt + PT * e;
    if (u >= 4 * NC) return;
    const int dp = u % (NC / 2), kg = u / (NC / 2), c = 2 * (kg % 4);
    unsigned char* bb = big + (kg / 4) * NC * 128;
    unsigned char* sb = small + (kg / 4) * NC * 128;
    float2 x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[j] = *reinterpret_cast<const float2*>(raw + (8 * kg + j) * NC + 2 * dp);
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const bool odd = ((dp >> 2) + ii) & 1;
      const int n = 2 * dp + odd;
      uint32_t b[8], s[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) hopper::split_tf32(odd ? x[j].y : x[j].x, b[j], s[j]);
      hopper::put_chunk(bb, n, c, b[0], b[2], b[4], b[6]);
      hopper::put_chunk(bb, n, c + 1, b[1], b[3], b[5], b[7]);
      hopper::put_chunk(sb, n, c, s[0], s[2], s[4], s[6]);
      hopper::put_chunk(sb, n, c + 1, s[1], s[3], s[5], s[7]);
    }
  }
}

// keeps P's terms (read by the P·V wgmmas as registers) unchanged until
// those wgmmas are done
__device__ __forceinline__ void hold(const float (&pb)[32], const uint32_t (&ps)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) asm volatile("" ::"f"(pb[e]), "r"(ps[e]) : "memory");
}

// O's columns base + [0, VN) += a tile's P·V piece
template <int D, int VN>
__device__ __forceinline__ void add_piece(float (&oacc)[D / 2], const float (&tacc)[VN / 2],
                                          int base) {
#pragma unroll
  for (int e = 0; e < VN / 2; ++e) oacc[base / 2 + e] += tacc[e];
}

// vec: bit 0, 1, 2: q, k, v rows 16-byte aligned; bit 3: o's 8-byte aligned
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       float* __restrict__ o, int H, int Kv, int Sq, int Skv, Strides qst, Strides kst,
       Strides vst, Strides ost, int causal, int window, float softcap, float scale, int vec) {
  using L = Layout<D>;
  constexpr int NC = L::NC, NCH = L::NCH, VN = L::VN, SUBS = NC / VN, STAGES = L::STAGES;
  constexpr int QT = L::Q_TERM, KT = L::K_TERM, VT = L::V_TERM, SLOT = L::SLOT;
  constexpr bool PIPE_PV = L::PIPE_PV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~1023ull);
  unsigned char* ring = qs + 2 * QT;  // Q's big term, then its small one, then the slots
  float* raw = reinterpret_cast<float*>(ring + STAGES * SLOT);  // then RS raw slots
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * SLOT + L::RS * L::RAW);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;
  uint64_t* qempty = qfull + 1;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nq = (Sq + BQ - 1) / BQ, bx = blockIdx.x;
  const int passes = nq - 1 - bx > bx ? 2 : 1;  // the middle tile of an odd nq alone
  const int h = blockIdx.y, bi = blockIdx.z, kvh = h / (H / Kv);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], PT / 32);  // every producer warp's arrive
      hopper::mbar_init(&empty[s], 1);       // the consumer warpgroup's
    }
    hopper::mbar_init(qfull, PT / 32);
    hopper::mbar_init(qempty, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // pass p's query tile and its key tiles [tb_p, te_p)
  const int q00 = (nq - 1 - bx) * BQ, q01 = bx * BQ;
  int tb0, te0, tb1 = 0, te1 = 0;
  kv_range(q00, BQ, Skv, causal, window, tb0, te0);
  if (passes > 1) kv_range(q01, BQ, Skv, causal, window, tb1, te1);

  if (warp >= 4) {
    // Producers: each job is one chunk (a pass's NCH chunks of Q, then each
    // key tile's NCH chunks of K and NCH of V), shared by the PT threads:
    // cp.async into a raw slot (16- or 8-byte copies where the rows are
    // 16-byte aligned, 4-byte otherwise: every stride takes this path), RS
    // - 1 jobs ahead, then each thread reads back what it copied, splits it
    // and writes the terms. A V job's copies fall on other threads' values
    // of the K job the slot held before, so the producers pass a barrier
    // before a slot is filled again.
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    constexpr int RS = L::RS;
    const int pt = tid - 128;
    const View qv{q + bi * qst.b + h * qst.h, qst.s, Sq, (vec & 1) != 0};
    const View kvw{k + bi * kst.b + kvh * kst.h, kst.s, Skv, (vec & 2) != 0};
    const View vv{v + bi * vst.b + kvh * vst.h, vst.s, Skv, (vec & 4) != 0};
    const int jobs0 = NCH + 2 * NCH * (te0 - tb0);
    const int total = jobs0 + (passes > 1 ? NCH + 2 * NCH * (te1 - tb1) : 0);
    // the terms' writes, visible to the tensor cores, then one arrive a warp
    auto arrive = [&](uint64_t* bar) {
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    auto issue = [&](int g) {  // job g's copies into raw slot g % RS, as one group
      if (g < total) {
        const bool second = g >= jobs0;
        const int j = g - (second ? jobs0 : 0);
        float* dst = raw + (g % RS) * (L::RAW / 4);
        if (j < NCH) {
          copy_rows<NC>(dst, qv, second ? q01 : q00, j * NC, pt);
        } else {
          const int t = (second ? tb1 : tb0) + (j - NCH) / (2 * NCH), c = (j - NCH) % (2 * NCH);
          if (c < NCH) copy_rows<NC>(dst, kvw, t * BKV, c * NC, pt);
          else copy_cols<NC>(dst, vv, t * BKV, (c - NCH) * NC, pt);
        }
      }
      hopper::cp_async_commit();
    };
#pragma unroll
    for (int g = 0; g < RS - 1; ++g) issue(g);
    for (int g = 0; g < total; ++g) {
      hopper::named_sync(1, PT);  // every producer is done with job g - 1's slot
      issue(g + RS - 1);
      hopper::cp_async_wait<RS - 1>();  // job g's copies (this thread's) have landed
      const float* src = raw + (g % RS) * (L::RAW / 4);
      const bool second = g >= jobs0;
      const int j = g - (second ? jobs0 : 0);
      if (j < NCH) {  // Q's chunk j, once the last pass is done with Q
        if (j == 0) hopper::mbar_wait(qempty, second ? 0 : 1);
        put_rows<NC>(qs, qs + QT, src, j * NC, pt);
        if (j == NCH - 1) arrive(qfull);
        continue;
      }
      const int rj = j - NCH + (second ? jobs0 - NCH : 0);  // the ring's job count
      const int s = rj % STAGES;
      hopper::mbar_wait(&empty[s], ((rj / STAGES) & 1) ^ 1);
      unsigned char* slot = ring + s * SLOT;
      if ((j - NCH) % (2 * NCH) < NCH) put_rows<NC>(slot, slot + KT, src, 0, pt);
      else put_cols<NC>(slot, slot + VT, src, pt);
      arrive(&full[s]);
    }
    return;
  }

  // Consumer warpgroup: lane l of warp w holds rows ra = q0 + 16w + l/4 and
  // rb = ra + 8, columns 8j + 2(l%4) + {0, 1} of every fragment. Per key
  // tile: S = Q·Kᵀ in 3xTF32 over the
  // NCH chunks of K (each chunk's wgmmas issued before the last chunk's are
  // waited for), the online softmax on S's registers (tc's), P split in
  // place (its big term where P was, its small term beside), then per V
  // chunk P·V in 3xTF32 into a tile accumulator summed from zero and added
  // into O in fp32 (O = corr·O + tile): the tensor cores' sums are not
  // rounded to nearest, and summed over all of Skv their error would reach
  // the fp32 limit.
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int w = warp, ql = lane % 4;
  const bool leader = tid == 0, capped = softcap > 0.f;
  const tc::Softmax sm{Skv, causal, window, capped, capped ? 1.f : scale * tc::LOG2E,
                       capped ? 2.f * tc::LOG2E * scale / softcap : 0.f, softcap * tc::LOG2E};
  const uint64_t dqb = hopper::make_desc(qs, 16, 1024, 1);
  const uint64_t dqs = hopper::make_desc(qs + QT, 16, 1024, 1);
  float oacc[D / 2], sacc[32], tacc[2][VN / 2];
  uint32_t ps[32];  // P's small terms
#pragma unroll
  for (int e = 0; e < 32; ++e) sacc[e] = 0.f;
  int i = 0;  // ring slots consumed, over both passes
  for (int pass = 0; pass < passes; ++pass) {
    const int q0 = pass ? q01 : q00, ra = q0 + w * 16 + lane / 4, rb = ra + 8;
    const int t_begin = pass ? tb1 : tb0, t_end = pass ? te1 : te0;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) oacc[e] = 0.f;
    float m_a = tc::NEG, m_b = tc::NEG, l_a = 0.f, l_b = 0.f, corr_a, corr_b;
    hopper::mbar_wait_opaque(qfull, pass & 1);
    for (int t = t_begin; t < t_end; ++t) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int s = (i + c) % STAGES;
        hopper::mbar_wait_opaque(&full[s], ((i + c) / STAGES) & 1);
        unsigned char* slot = ring + s * SLOT;
        const uint64_t dkb = hopper::make_desc(slot, 16, 1024, 1);
        const uint64_t dks = hopper::make_desc(slot + KT, 16, 1024, 1);
        hopper::fence_operand(sacc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NC / 8; ++kk) {
          const int kq = c * (NC / 8) + kk;
          const uint32_t oq = (kq / 4) * TILE + (kq % 4) * 32;
          const uint32_t ok = (kk / 4) * TILE + (kk % 4) * 32;
          hopper::wgmma_tf32(sacc, hopper::desc_add(dqs, oq), hopper::desc_add(dkb, ok),
                             c > 0 || kk > 0);
          hopper::wgmma_tf32(sacc, hopper::desc_add(dqb, oq), hopper::desc_add(dks, ok), 1);
          hopper::wgmma_tf32(sacc, hopper::desc_add(dqb, oq), hopper::desc_add(dkb, ok), 1);
        }
        hopper::wgmma_commit();
        if (c > 0) {  // the last chunk's products are done: free its slot
          hopper::wgmma_wait<1>();
          if (leader) hopper::mbar_arrive(&empty[(i + c - 1) % STAGES]);
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operand(sacc);
      if (leader) {
        hopper::mbar_arrive(&empty[(i + NCH - 1) % STAGES]);
        if (t == t_end - 1) hopper::mbar_arrive(qempty);  // Q is read
      }
      i += NCH;
      sm.tile(sacc, t * BKV, q0, ra, rb, ql, m_a, m_b, l_a, l_b, corr_a, corr_b);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        uint32_t b;
        hopper::split_tf32(sacc[e], b, ps[e]);
        sacc[e] = __uint_as_float(b);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j + 0] *= corr_a;
        oacc[4 * j + 1] *= corr_a;
        oacc[4 * j + 2] *= corr_b;
        oacc[4 * j + 3] *= corr_b;
      }
      // P·V: piece p = (chunk c, sub) of VN columns into tacc[p % 2]; with
      // PIPE_PV the next piece's wgmmas are issued before the last piece is
      // added into O
#pragma unroll
      for (int p = 0; p < NCH * SUBS; ++p) {
        const int c = p / SUBS, sub = p % SUBS, s = (i + c) % STAGES;
        if (sub == 0) hopper::mbar_wait_opaque(&full[s], ((i + c) / STAGES) & 1);
        unsigned char* slot = ring + s * SLOT;
        const uint64_t dvb = hopper::make_desc(slot, 16, 1024, 1);
        const uint64_t dvs = hopper::make_desc(slot + VT, 16, 1024, 1);
        float(&acc)[VN / 2] = tacc[PIPE_PV ? p % 2 : 0];
        hopper::fence_operand(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 8; ++kk) {
          const uint32_t off = (kk / 4) * NC * 128 + sub * VN * 128 + (kk % 4) * 32;
          const uint32_t pb4[4] = {__float_as_uint(sacc[4 * kk]), __float_as_uint(sacc[4 * kk + 2]),
                                   __float_as_uint(sacc[4 * kk + 1]),
                                   __float_as_uint(sacc[4 * kk + 3])};
          const uint32_t ps4[4] = {ps[4 * kk], ps[4 * kk + 2], ps[4 * kk + 1], ps[4 * kk + 3]};
          hopper::wgmma_tf32_rs(acc, ps4, hopper::desc_add(dvb, off), kk > 0);
          hopper::wgmma_tf32_rs(acc, pb4, hopper::desc_add(dvs, off), 1);
          hopper::wgmma_tf32_rs(acc, pb4, hopper::desc_add(dvb, off), 1);
        }
        hopper::wgmma_commit();
        if (PIPE_PV && p > 0) {  // the last piece is done: into O
          hopper::wgmma_wait<1>();
          float(&prev)[VN / 2] = tacc[(p + 1) % 2];
          hopper::fence_operand(prev);
          add_piece<D, VN>(oacc, prev, (p - 1) / SUBS * NC + (p - 1) % SUBS * VN);
          if ((p - 1) % SUBS == SUBS - 1 && leader)
            hopper::mbar_arrive(&empty[(i + (p - 1) / SUBS) % STAGES]);
        }
        if (!PIPE_PV) {
          hopper::wgmma_wait<0>();
          hopper::fence_operand(acc);
          add_piece<D, VN>(oacc, acc, c * NC + sub * VN);
          if (sub == SUBS - 1 && leader) hopper::mbar_arrive(&empty[s]);
        }
      }
      if (PIPE_PV) {
        constexpr int p = NCH * SUBS - 1;
        hopper::wgmma_wait<0>();
        float(&last)[VN / 2] = tacc[p % 2];
        hopper::fence_operand(last);
        add_piece<D, VN>(oacc, last, p / SUBS * NC + p % SUBS * VN);
        if (leader) hopper::mbar_arrive(&empty[(i + NCH - 1) % STAGES]);
      }
      hold(sacc, ps);
      i += NCH;
    }

#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
    float* ob = o + bi * ost.b + h * ost.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * ql;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? rb : ra;
        const float inv = r ? inv_b : inv_a;
        if (row >= Sq) continue;
        float* dst = ob + row * ost.s + col;
        const float x0 = oacc[4 * j + 2 * r] * inv, x1 = oacc[4 * j + 2 * r + 1] * inv;
        if (vec & 8) {
          *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
        } else {
          dst[0] = x0;
          dst[1] = x1;
        }
      }
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, int B, int H,
                   int Kv, int Sq, int Skv, const Strides* st, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  using L = Layout<D>;
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(kernel<D>, L::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  auto rows16 = [](const void* p, const Strides& s) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s.b % 4 == 0 && s.h % 4 == 0 &&
           s.s % 4 == 0;
  };
  const int vec = rows16(q, st[0]) | rows16(k, st[1]) << 1 | rows16(v, st[2]) << 2 |
                  ((reinterpret_cast<uintptr_t>(o) & 7) == 0 && st[3].b % 2 == 0 &&
                   st[3].h % 2 == 0 && st[3].s % 2 == 0) << 3;
  dim3 grid(((Sq + BQ - 1) / BQ + 1) / 2, H, B);
  kernel<D><<<grid, THREADS, L::SMEM, stream>>>(q, k, v, o, H, Kv, Sq, Skv, st[0], st[1],
                                                   st[2], st[3], causal, window, softcap, scale,
                                                   vec);
  return cudaGetLastError();
}

}  // namespace tf32x3

bool valid(int B, int H, int Kv, int Sq, int Skv) {
  return B > 0 && H > 0 && Kv > 0 && H % Kv == 0 && Sq > 0 && Skv > 0 && B <= 65535 &&
         H <= 65535;
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Kv,Skv,D), o (B,H,Sq,D) as strided bf16 views whose
// last dim is contiguous; strides = 12 element strides (batch, head, seq) of
// q, k, v, o in that order. Each entry launches one variant on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for what it does not take).

// wgmma: D in {64, 128, 256}; every stride of q, k, v a multiple of 8 and
// their pointers 16-byte aligned (TMA)
extern "C" int flash_attention_wgmma_bf16(const void* q, const void* k, const void* v, void* o,
                                          int B, int H, int Kv, int Sq, int Skv, int D,
                                          const long long* strides, int causal, int window,
                                          float softcap, float scale, void* stream) {
  using namespace tc;
  if (!valid(B, H, Kv, Sq, Skv)) return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch<64>(qp, kp, vp, op, B, H, Kv, Sq, Skv, st, causal, window, softcap, scale, s);
    case 128: return (int)launch<128>(qp, kp, vp, op, B, H, Kv, Sq, Skv, st, causal, window, softcap, scale, s);
    case 256: return (int)launch<256>(qp, kp, vp, op, B, H, Kv, Sq, Skv, st, causal, window, softcap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// wmma: D in {16, 32, 64, 128, 256}, any strides
extern "C" int flash_attention_wmma_bf16(const void* q, const void* k, const void* v, void* o,
                                         int B, int H, int Kv, int Sq, int Skv, int D,
                                         const long long* strides, int causal, int window,
                                         float softcap, float scale, void* stream) {
  using namespace legacy;
  if (!valid(B, H, Kv, Sq, Skv)) return (int)cudaErrorInvalidValue;
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
    case 256: return (int)launch<256>(qp, kp, vp, op, B, H, Kv, Sq, Skv, st, causal, window, softcap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// fp32: fp32 q, k, v, o; D in {16, 32, 64, 128, 256}, any strides
extern "C" int flash_attention_fp32(const void* q, const void* k, const void* v, void* o, int B,
                                    int H, int Kv, int Sq, int Skv, int D,
                                    const long long* strides, int causal, int window,
                                    float softcap, float scale, void* stream) {
  using namespace tf32x3;
  if (!valid(B, H, Kv, Sq, Skv)) return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch<16>(qp, kp, vp, op, B, H, Kv, Sq, Skv, st, causal, window, softcap, scale, s);
    case 32: return (int)launch<32>(qp, kp, vp, op, B, H, Kv, Sq, Skv, st, causal, window, softcap, scale, s);
    case 64: return (int)launch<64>(qp, kp, vp, op, B, H, Kv, Sq, Skv, st, causal, window, softcap, scale, s);
    case 128: return (int)launch<128>(qp, kp, vp, op, B, H, Kv, Sq, Skv, st, causal, window, softcap, scale, s);
    case 256: return (int)launch<256>(qp, kp, vp, op, B, H, Kv, Sq, Skv, st, causal, window, softcap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
