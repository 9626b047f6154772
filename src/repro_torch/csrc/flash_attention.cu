// Flash attention for Hopper (sm_90a): online-softmax attention with causal,
// sliding-window and logit-softcap masking and GQA.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel,
// flash_attention_pallas). Same numerics: scores, running max m, denominator
// l and the output accumulator in fp32; scale 1/sqrt(d) before the softcap
// c·tanh(s/c); masked scores set to -1e30 (-inf in the wgmma variant: the
// same weights); l clamped at 1e-30. Query head h reads kv head h / (H / Kv),
// with no repeated K/V. P is rounded to bf16 for the P·V product, as flash
// attention does on GPUs (the TPU kernel keeps it in fp32: that is the one
// numerical difference). q, k, v and o are read and written in the model's
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
//   smoke configs serve in fp32): SIMT, fp32 FMAs on the CUDA cores, P kept in
//   fp32 as the TPU kernel keeps it. What bounds it is the fp32 CUDA-core
//   rate. One block of 4 warps per 32 query rows of one (batch, head); a
//   warp owns 8 rows. Per 32-key tile (K staged transposed and padded, so
//   the lanes read neighbouring words), lane j computes the scores of key j
//   for the warp's 8 rows (Q rows read as broadcast float4s), the online
//   softmax reduces each row across the warp with shuffles, and P goes
//   through a per-warp shared buffer into O += P·V, each lane holding O for
//   its rows at d/32 columns (two half-warps of 4 rows at d = 16; 8 rows x 8
//   columns, 64 accumulators, at d = 256, 103,424 bytes of shared memory).
//   Only the tiles up to the causal frontier and from the window's start
//   are read.

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
// fp32: SIMT online softmax, for fp32 inputs
// ===========================================================================
namespace simt {

constexpr int BQ = 32, BKV = 32;  // query rows of a block, keys of a tile
constexpr int ROWS = 8;           // query rows of a warp
constexpr int NTHREADS = 128;     // 4 warps
constexpr int KLD = BKV + 1;      // K tile stored transposed (d x keys), padded
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * D + D * KLD + BKV * D + NTHREADS / 32 * ROWS * BKV) * sizeof(float);
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

// 4 consecutive floats of row `row` (base + row·stride, d contiguous) at
// column c; zeros for a row at or past nrows
__device__ __forceinline__ float4 load4(const float* __restrict__ base, long long stride,
                                        int row, int nrows, int c, bool vec) {
  if (row >= nrows) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = base + row * stride + c;
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o, int H, int Kv,
                            int Sq, int Skv, Strides qst, Strides kst, Strides vst, Strides ost,
                            int causal, int window, float softcap, float scale) {
  constexpr int DL = D < 32 ? D : 32;  // lanes across d in P·V
  constexpr int RG = 32 / DL;          // row groups of a warp in P·V (2 at d = 16)
  constexpr int RPL = ROWS / RG;       // rows of a lane in P·V
  constexpr int EPL = D / DL;          // columns of a lane in P·V
  constexpr int C4 = D / 4;            // float4s of a row
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // BQ x D     query rows
  float* kt = qs + BQ * D;                     // D x KLD    K tile, transposed
  float* vs = kt + D * KLD;                    // BKV x D    V tile
  float* ps = vs + BKV * D;                    // 4 warps x ROWS x BKV   probabilities

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // longest causal rows first
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * ROWS;
  float* pw = ps + warp * ROWS * BKV;

  const float* qb = q + bi * qst.b + h * qst.h;
  const float* kb = k + bi * kst.b + kvh * kst.h;
  const float* vb = v + bi * vst.b + kvh * vst.h;
  float* ob = o + bi * ost.b + h * ost.h;
  const bool q_vec = qst.s % 4 == 0 && (reinterpret_cast<uintptr_t>(qb) & 15) == 0;
  const bool k_vec = kst.s % 4 == 0 && (reinterpret_cast<uintptr_t>(kb) & 15) == 0;
  const bool v_vec = vst.s % 4 == 0 && (reinterpret_cast<uintptr_t>(vb) & 15) == 0;

  for (int i = threadIdx.x; i < BQ * C4; i += NTHREADS)
    *reinterpret_cast<float4*>(qs + (i / C4) * D + (i % C4) * 4) =
        load4(qb, qst.s, q0 + i / C4, Sq, (i % C4) * 4, q_vec);

  // KV tiles that hold at least one unmasked key for some row of this block
  int t_end = (Skv + BKV - 1) / BKV;
  if (causal) t_end = min(t_end, (q0 + BQ - 1) / BKV + 1);
  int t_begin = 0;
  if (window > 0) {
    const int lo = q0 - window - (BKV - 1);
    t_begin = lo < 0 ? 0 : lo / BKV + 1;
  }

  // the lane's place in P·V: column dim0 + e·DL (e < EPL) of rows rg·RPL + i (i < RPL)
  const int dim0 = lane % DL, rg = lane / DL;
  float m[ROWS], l[ROWS], acc[RPL][EPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) m[r] = NEG_INF, l[r] = 0.f;
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
  const bool capped = softcap > 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the last tile's K and V are read
    for (int i = threadIdx.x; i < BKV * C4; i += NTHREADS) {
      const int j = i / C4, c = (i % C4) * 4;
      const float4 kv4 = load4(kb, kst.s, k0 + j, Skv, c, k_vec);
      kt[(c + 0) * KLD + j] = kv4.x;
      kt[(c + 1) * KLD + j] = kv4.y;
      kt[(c + 2) * KLD + j] = kv4.z;
      kt[(c + 3) * KLD + j] = kv4.w;
      *reinterpret_cast<float4*>(vs + j * D + c) = load4(vb, vst.s, k0 + j, Skv, c, v_vec);
    }
    __syncthreads();

    // scores of key k0 + lane for the warp's rows
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float k_0 = kt[(c + 0) * KLD + lane], k_1 = kt[(c + 1) * KLD + lane];
      const float k_2 = kt[(c + 2) * KLD + lane], k_3 = kt[(c + 3) * KLD + lane];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (row0 + r) * D + c);
        s[r] = fmaf(qv.x, k_0, s[r]);
        s[r] = fmaf(qv.y, k_1, s[r]);
        s[r] = fmaf(qv.z, k_2, s[r]);
        s[r] = fmaf(qv.w, k_3, s[r]);
      }
    }

    // online softmax, row by row across the warp
    const int kpos = k0 + lane;
    float corr[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + row0 + r;
      float x = s[r] * scale;
      if (capped) x = softcap * tanhf(x / softcap);
      bool ok = kpos < Skv;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      x = ok ? x : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = expf(x - m_new);
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + warp_sum(p);
      m[r] = m_new;
      pw[r * BKV + lane] = p;
    }
    __syncwarp();

    // O = corr·O + P·V for the lane's rows and columns
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      float c;
      if constexpr (RG == 2) c = rg ? corr[RPL + i] : corr[i];
      else c = corr[i];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[i][e] *= c;
    }
#pragma unroll 2
    for (int j = 0; j < BKV; j += 4) {
      float vv[4][EPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < EPL; ++e) vv[jj][e] = vs[(j + jj) * D + dim0 + e * DL];
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const float4 pp = *reinterpret_cast<const float4*>(pw + (rg * RPL + i) * BKV + j);
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          acc[i][e] = fmaf(pp.x, vv[0][e], acc[i][e]);
          acc[i][e] = fmaf(pp.y, vv[1][e], acc[i][e]);
          acc[i][e] = fmaf(pp.z, vv[2][e], acc[i][e]);
          acc[i][e] = fmaf(pp.w, vv[3][e], acc[i][e]);
        }
      }
    }
    __syncwarp();  // P is read before the next tile's scores overwrite it
  }

#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    float li;
    if constexpr (RG == 2) li = rg ? l[RPL + i] : l[i];
    else li = l[i];
    const int qpos = q0 + row0 + rg * RPL + i;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
#pragma unroll
    for (int e = 0; e < EPL; ++e) ob[qpos * ost.s + dim0 + e * DL] = acc[i][e] * inv;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, int B, int H,
                   int Kv, int Sq, int Skv, const Strides* st, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(flash_attention_fp32_kernel<D>, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_fp32_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      q, k, v, o, H, Kv, Sq, Skv, st[0], st[1], st[2], st[3], causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace simt

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
  using namespace simt;
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
