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
// Built with -DREPRO_FLASH_FULL_ONLY (compare_kernels.py --ptxas), the
// copying producers keep only their FULL loops (rows of D columns), so that
// ptxas's report per kernel shows what the served instances' loop costs;
// such a build is wrong at a padded d and is never loaded.
//
// Two variants, picked by the wrapper (kernels/flash_attention.py
// ``variant``), both at every head dim d from 1 to 256: each is compiled at
// the widths 16, 32, 64, 128 and 256, and a d between them runs at the next
// (the wrapper's ``padded_dim``, which it passes to the entries). Its rows
// are read d columns wide and the columns past d arrive as zeros (TMA's
// zero fill past the tensor map's innermost extent d; the copier's and the
// fp32 producers' zero fill past a row's d columns; never the next head's
// values: 0 times a non-finite value is NaN). Zero columns of Q and K leave the scores unchanged, those of V give
// zero columns of O, which go to the padding of an output the wrapper
// allocates padded_dim(d) wide and returns as its first d columns (the
// store stays the compiled width's: a column guard in it made ptxas spill
// in the served instances); the scale is 1/sqrt(d). Padding costs the
// products' share of the work, D/d (1.33x at d = 96, 1.6x at 80).
//
// * wgmma (bf16, any strides; the main path): one
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
//   spans them at one tile's stride; rows of 16 or 32 (32 or 64 bytes) are
//   one block in the 32- or 64-byte swizzle, Q·Kᵀ in d/16 k-steps and P·V
//   as m64n16k16 or m64n32k16. Consumer warpgroups (one at d <= 128, two
//   blocks an SM at d = 128, three at 64, four at 16 and 32; two of 64 rows
//   each at d = 256, whose
//   O takes 128 registers a thread) compute S = Q·Kᵀ with wgmma (both
//   operands in shared memory) into registers and run the online softmax on
//   the accumulator fragment (row max and sum over the 4 lanes of a quad,
//   exp2 with scale·log2(e) folded in, masks only on the tiles at the
//   diagonal, the window's edge and the ragged edge; the softcap as
//   1 - 2/(2^x + 1)). P is converted to bf16 in registers and fed as the
//   register operand of the P·V wgmma (n = d, V from shared memory), which
//   runs while the next tile's softmax does. O stays in registers for the
//   whole KV loop and is written once.
//   Rows TMA cannot read (a pointer off 16 bytes, a stride not a positive
//   multiple of 8 elements, a broadcast batch): the C entry decides operand
//   by operand; the kernel's COPY instance has a producer warpgroup whose
//   issuing warp cp.asyncs each copied 64-row box's rows through a ring of
//   staging slots (hopper.cuh's atile, LoRA's copier) and whose three
//   placing warps shift them into the swizzled tiles; the operands a map
//   reads stay on TMA. The producer gives its registers to the consumers
//   (setmaxnreg), which run as above.
// * fp32 (fp32 inputs, any strides; the smoke configs serve in fp32):
//   3xTF32 on wgmma, P kept in fp32 as the TPU
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
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"

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
// wgmma: TMA + warpgroup MMA, compiled at D = 16, 32, 64, 128, 256
// ===========================================================================
namespace tc {

constexpr int BKV = 64;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NPL = 3;  // placing warps of a copying producer (beside its issuing warp)

// Per head dim: NWG consumer warpgroups of 64 query rows each (a block's
// query tile is 64·NWG rows), a ring of STAGES K/V tiles, QBUFS query tiles
// (2: both passes' tiles load up front; 1: the second pass's once the first
// is done with it) and MINB blocks an SM, so that another warpgroup's
// products run during one's softmax: at d = 16 four blocks (96 registers a
// thread), at d = 32 and 64 three (the launch bound holds registers to
// 136), at d = 128 two (96 KB each), at d = 256 a second warpgroup of the
// block (Q, K and V take 192 KB).
// PWARPS: the producer's warps. At d = 256 it is a whole warpgroup that
// gives its registers to the consumers (REGS: 232 a thread, for O's 128
// accumulators; with a lone producer warp the 9 warps' registers are split
// evenly, 168 a thread, and O spills).
// Where an operand's tiles are copied (COPY: rows TMA cannot read), the
// producer is a warpgroup, one issuing and NPL placing warps, always on a
// budget of its own (setmaxnreg), and the ring, query tiles, staging slots
// (SB, one 64-row box each) and blocks an SM are the C* values.
template <int D> struct Cfg;
template <> struct Cfg<16> {
  static constexpr int NWG = 1, STAGES = 4, QBUFS = 2, MINB = 4, PWARPS = 1, REGS = 0;
  static constexpr int CSTAGES = 4, CQBUFS = 2, SB = 4, CMINB = 2;
};
template <> struct Cfg<32> {
  static constexpr int NWG = 1, STAGES = 4, QBUFS = 2, MINB = 3, PWARPS = 1, REGS = 0;
  static constexpr int CSTAGES = 4, CQBUFS = 2, SB = 4, CMINB = 2;
};
template <> struct Cfg<64> {
  static constexpr int NWG = 1, STAGES = 3, QBUFS = 2, MINB = 3, PWARPS = 1, REGS = 0;
  static constexpr int CSTAGES = 3, CQBUFS = 2, SB = 4, CMINB = 2;
};
template <> struct Cfg<128> {
  static constexpr int NWG = 1, STAGES = 2, QBUFS = 2, MINB = 2, PWARPS = 1, REGS = 0;
  static constexpr int CSTAGES = 2, CQBUFS = 1, SB = 1, CMINB = 2;  // 115 KB: two blocks an SM
};
template <> struct Cfg<256> {
  static constexpr int NWG = 2, STAGES = 2, QBUFS = 1, MINB = 1, PWARPS = 4, REGS = 232;
  static constexpr int CSTAGES = 2, CQBUFS = 1, SB = 3, CMINB = 1;
};

template <int D, bool COPY>
struct Layout {
  using C = Cfg<D>;
  static constexpr int NWG = C::NWG;
  static constexpr int STAGES = COPY ? C::CSTAGES : C::STAGES;
  static constexpr int QBUFS = COPY ? C::CQBUFS : C::QBUFS;
  static constexpr int SB = COPY ? C::SB : 0;
  static constexpr int MINB = COPY ? C::CMINB : C::MINB;
  static constexpr int PWARPS = COPY ? 1 + NPL : C::PWARPS;
  // setmaxnreg budgets (0: none): the producer's and the consumers' (the
  // consumers without copies use 165 registers at d = 128, 126 at d = 64)
  static constexpr int PREGS = COPY ? (NWG == 2 ? 40 : D == 128 ? 80 : 112) : (C::REGS ? 40 : 0);
  static constexpr int CREGS = COPY ? (NWG == 2 ? 232 : D == 128 ? 176 : 144) : C::REGS;
  static constexpr int BQ = 64 * NWG;  // query rows of a block
  // the consumer warpgroups, then the producer
  static constexpr int THREADS = 128 * NWG + 32 * PWARPS;
  // A tile of R rows is stored as D/TW column blocks of R rows x RB bytes
  // (TW columns: the swizzle's width, 64 bf16 at d >= 64, else d), one TMA
  // box each, 1024-aligned; swizzle RB bytes (wgmma's code SWZ)
  static constexpr int TW = D < 64 ? D : 64, RB = 2 * TW, NCB = D / TW;
  static constexpr uint32_t SWZ = TW == 16 ? 3 : TW == 32 ? 2 : 1;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr int STG = hopper::atile::Tile<TW>::STAGING;  // a 64-row box's staging
  static constexpr size_t SMEM =
      1024 + QBUFS * Q_BYTES + 2 * STAGES * KV_BYTES + (size_t)SB * STG + 256;
  static_assert(SMEM <= 227 * 1024, "tiles too large for shared memory");
  // setmaxnreg moves registers within the block's allocation at launch
  static_assert(PREGS == 0 ||
                    128 * PREGS + 128 * NWG * CREGS <= THREADS * (65536 / (THREADS * MINB) / 8 * 8),
                "the register budgets exceed the block's allocation");
};

// The operands whose tiles are copied (bit i of `flags`: q, k, v), with
// their pointers and strides; a copied row has d columns (the head dim, at
// most the compiled width D; the tile's columns past d are zeros)
struct Copied {
  const bf16* p[3];
  Strides st[3];
  int flags, d;
};

// c·tanh(x·scale/c) in the log2 domain (times log2 e), as 1 - 2/(2^(2x·scale·log2(e)/c) + 1):
// two special-function ops, against a dozen instructions and a branch in
// tanhf. Its absolute error (~1e-7 of c) is what reaches the exponent.
__device__ __forceinline__ float softcap_log2(float x, float cap_in2, float cap_out) {
  return fmaf(-2.f * cap_out, __fdividef(1.f, hopper::exp2_approx(x * cap_in2) + 1.f), cap_out);
}

// S (64 x 64) = Q·Kᵀ for one warpgroup: K-major Q and K with RB-byte rows,
// k-step kk reading 32 bytes of column block kk/(TW/16) (column blocks
// `qblock` and one 64-row tile apart)
template <int D>
__device__ __forceinline__ void issue_qk(float (&sacc)[32], uint64_t dq, uint64_t dk, int qblock) {
  constexpr int TW = D < 64 ? D : 64, KPB = TW / 16;
  hopper::fence_operand(sacc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_ss<0>(sacc, hopper::desc_add(dq, (kk / KPB) * qblock + (kk % KPB) * 32),
                        hopper::desc_add(dk, (kk / KPB) * BKV * 2 * TW + (kk % KPB) * 32),
                        kk > 0);
  hopper::wgmma_commit();
}

// O += P·V: P's bf16 fragment as the register operand, V MN-major (its
// column blocks one 64-row tile apart, 8-row groups 8·RB bytes)
template <int D>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2], const uint32_t (&pa)[4][4],
                                         const unsigned char* v) {
  constexpr int RB = D < 64 ? 2 * D : 128;
  constexpr uint32_t SWZ = RB == 32 ? 3 : RB == 64 ? 2 : 1;
  const uint64_t dv = hopper::make_desc(v, BKV * RB, 8 * RB, SWZ);
  hopper::fence_operand(oacc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    hopper::wgmma_rs<1>(oacc, pa[kk], hopper::desc_add(dv, kk * 16 * RB));
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

// The copying producer (COPY): per pass a Q job, then per key tile a K and
// a V job, in the order the consumers take them. The issuing warp (pw 0)
// waits for each job's tile to be free; its lane 0 loads what a tensor map
// reads by TMA (expecting its bytes on the job's full barrier) or arrives
// there; for a copied operand every lane cp.asyncs each 64-row box's rows
// into a staging slot (a ring of SB, each refilled only once the placers
// have arrived on its `sempty`) and the slot's `landed` barrier hears when
// they are in. The placing warps (pw 1..NPL) take the boxes' 32-row groups
// in turn, place them into the swizzled tile, free the staging slot, and
// after a job's last box arrive on its full barrier (1 + NPL arrivals).
// FULL: rows of D columns (d = D), a constant the copier's column masks fold
// away (held at run time they made the copying instances spill 112-316 B);
// else rows of cp.d columns.
template <int D, bool FULL>
struct Producer {
  using L = Layout<D, true>;
  // PART: chunks a placing read pass, to fit the producer's budget
  static constexpr int TW = L::TW, RB = L::RB, PART = L::NWG == 2 ? 1 : 2;
  const Copied& cp;
  int pw, lane, bi, h, kvh, Sq, Skv;
  unsigned char* stg;
  uint64_t *landed, *sempty;
  int sb = 0, g = 0;  // boxes through staging, 32-row groups placed

  __device__ __forceinline__ hopper::atile::Mat mat(int op) const {
    const Strides& s = cp.st[op];
    return {cp.p[op] + bi * s.b + (op ? kvh : h) * s.h, op ? Skv : Sq, FULL ? D : cp.d,
            (int)s.s};
  }

  // job of operand op: `rows` rows from row r0 into `tile` (column blocks
  // rows·RB bytes apart), full barrier `full`; tma() issues its TMA loads
  template <typename Tma>
  __device__ __forceinline__ void job(int op, uint64_t* full, unsigned char* tile, int rows,
                                      int r0, Tma tma) {
    const bool copied = (cp.flags >> op) & 1;
    if (pw == 0 && lane == 0) {
      if (copied) hopper::mbar_arrive(full);
      else tma();
    }
    if (!copied) return;
    const hopper::atile::Mat m = mat(op);
#pragma unroll 1
    for (int c = 0; c < L::NCB; ++c)
#pragma unroll 1
      for (int rr = 0; rr < rows; rr += 64) {
        const int s = sb % L::SB;
        const hopper::atile::Box b{m, r0 + rr, c * TW, 64, TW, tile + c * rows * RB + rr * RB,
                                   stg + s * L::STG, true};
        if (pw == 0) {
          hopper::mbar_wait(&sempty[s], ((sb / L::SB) & 1) ^ 1);
          hopper::atile::issue<TW>(b, lane);
          hopper::atile::cp_async_arrive(&landed[s]);
        } else {
          hopper::mbar_wait(&landed[s], (sb / L::SB) & 1);
          int ra = -1, rb = -1;
          for (int g0 = 0; g0 < 64; g0 += 32, ++g)
            if (g % NPL == pw - 1) (ra < 0 ? ra : rb) = g0 + lane;
          if (L::NWG == 2) {  // one row a call: the producer's 40 registers
            if (ra >= 0) hopper::atile::place<TW, PART>(b, ra, -1);
            if (rb >= 0) hopper::atile::place<TW, PART>(b, rb, -1);
          } else if (ra >= 0) {
            hopper::atile::place<TW, PART>(b, ra, rb);
          }
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&sempty[s]);  // this warp is done with the slot
        }
        ++sb;
      }
    if (pw > 0) {
      hopper::fence_proxy_async();  // the tile's writes, visible to the tensor cores
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(full);
    }
  }
};

template <int D, bool COPY>
__global__ void __launch_bounds__(Layout<D, COPY>::THREADS, Layout<D, COPY>::MINB)
kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
       const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int H, int Kv, int Sq,
       int Skv, Strides ost, int causal, int window, float softcap, float scale,
       const __grid_constant__ Copied cp) {
  using Lay = Layout<D, COPY>;
  constexpr int NWG = Lay::NWG, STAGES = Lay::STAGES, QBUFS = Lay::QBUFS, BQ = Lay::BQ;
  constexpr int QB = Lay::Q_BYTES, KVB = Lay::KV_BYTES, TW = Lay::TW, RB = Lay::RB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~1023ull);
  unsigned char* qs = base;                       // QBUFS query tiles
  unsigned char* ks = base + QBUFS * QB;          // STAGES tiles
  unsigned char* vs = ks + STAGES * KVB;          // STAGES tiles
  unsigned char* stg = vs + STAGES * KVB;         // SB staging slots (COPY)
  uint64_t* bars = reinterpret_cast<uint64_t*>(stg + Lay::SB * Lay::STG);
  uint64_t* qfull = bars;  // QBUFS
  uint64_t* qempty = qfull + QBUFS;
  uint64_t* kfull = qempty + QBUFS;  // STAGES each
  uint64_t* vfull = kfull + STAGES;
  uint64_t* kempty = vfull + STAGES;
  uint64_t* vempty = kempty + STAGES;
  uint64_t* landed = vempty + STAGES;  // SB each (COPY)
  uint64_t* sempty = landed + Lay::SB;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nq = (Sq + BQ - 1) / BQ;
  const int bx = blockIdx.x;
  const int passes = nq - 1 - bx > bx ? 2 : 1;  // the middle tile of an odd nq alone
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (H / Kv);

  if (tid == 0) {
    // a copied operand's full barrier also expects the placers' arrivals
    const int fq = 1 + (COPY && (cp.flags & 1) ? NPL : 0);
    const int fk = 1 + (COPY && (cp.flags & 2) ? NPL : 0);
    const int fv = 1 + (COPY && (cp.flags & 4) ? NPL : 0);
    for (int s = 0; s < QBUFS; ++s) {
      hopper::mbar_init(&qfull[s], fq);
      hopper::mbar_init(&qempty[s], NWG);  // one arrive per consumer warpgroup
    }
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&kfull[s], fk);
      hopper::mbar_init(&vfull[s], fv);
      hopper::mbar_init(&kempty[s], NWG);
      hopper::mbar_init(&vempty[s], NWG);
    }
    for (int s = 0; s < Lay::SB; ++s) {
      hopper::mbar_init(&landed[s], 32);   // every issuing lane's cp.asyncs
      hopper::mbar_init(&sempty[s], NPL);  // every placer is done with the slot
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // producer
    if constexpr (Lay::PREGS > 0) hopper::setmaxnreg_dec<Lay::PREGS>();
    // the Q tile of a pass and the K, V tiles of key tile t by TMA
    auto tma = [&](const CUtensorMap* map, uint64_t* full, unsigned char* tile, int bytes,
                   int rows, int r0, int head) {
      hopper::mbar_arrive_expect_tx(full, bytes);
#pragma unroll
      for (int c = 0; c < Lay::NCB; ++c)
        hopper::tma_load_4d(tile + c * rows * RB, map, full, TW * c, r0, head, bi);
    };
    if constexpr (!COPY) {
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
          tma(&tm_q, &qfull[slot], qs + slot * QB, QB, BQ, q0, h);
          // K and V of a slot are freed apart: K once its Q·Kᵀ is done, V once
          // its P·V is, a tile later
          for (int t = t_begin; t < t_end; ++t, ++i) {
            const int s = i % STAGES, parity = ((i / STAGES) & 1) ^ 1;
            hopper::mbar_wait(&kempty[s], parity);
            tma(&tm_k, &kfull[s], ks + s * KVB, KVB, BKV, t * BKV, kvh);
            hopper::mbar_wait(&vempty[s], parity);
            tma(&tm_v, &vfull[s], vs + s * KVB, KVB, BKV, t * BKV, kvh);
          }
        }
      }
    } else {
      // the copying producer, its column count a constant where d = D
      auto copying = [&](auto whole) {
        Producer<D, decltype(whole)::value> pr{cp, warp - 4 * NWG, lane, bi, h, kvh, Sq, Skv, stg,
                                               landed, sempty};
        const bool issuer = pr.pw == 0;
        if (issuer && lane == 0) {
          if (!(cp.flags & 1)) hopper::prefetch_tensormap(&tm_q);
          if (!(cp.flags & 2)) hopper::prefetch_tensormap(&tm_k);
          if (!(cp.flags & 4)) hopper::prefetch_tensormap(&tm_v);
        }
        // a pass's Q job; with two query buffers the second pass's right
        // after the first's, so that its copy is not late for the consumers
        auto q_job = [&](int pass) {
          const int q0 = (pass == 0 ? nq - 1 - bx : bx) * BQ, slot = pass % QBUFS;
          if (issuer) hopper::mbar_wait(&qempty[slot], ((pass / QBUFS) & 1) ^ 1);
          pr.job(0, &qfull[slot], qs + slot * QB, BQ, q0,
                 [&] { tma(&tm_q, &qfull[slot], qs + slot * QB, QB, BQ, q0, h); });
        };
        int i = 0;
        for (int pass = 0; pass < passes; ++pass) {
          const int q0 = (pass == 0 ? nq - 1 - bx : bx) * BQ;
          int t_begin, t_end;
          kv_range(q0, BQ, Skv, causal, window, t_begin, t_end);
          if (QBUFS == 1 || pass == 0) q_job(pass);
          if (QBUFS == 2 && pass == 0 && passes == 2) q_job(1);
          for (int t = t_begin; t < t_end; ++t, ++i) {
            const int s = i % STAGES, parity = ((i / STAGES) & 1) ^ 1;
            if (issuer) hopper::mbar_wait(&kempty[s], parity);
            pr.job(1, &kfull[s], ks + s * KVB, BKV, t * BKV,
                   [&] { tma(&tm_k, &kfull[s], ks + s * KVB, KVB, BKV, t * BKV, kvh); });
            if (issuer) hopper::mbar_wait(&vempty[s], parity);
            pr.job(2, &vfull[s], vs + s * KVB, BKV, t * BKV,
                   [&] { tma(&tm_v, &vfull[s], vs + s * KVB, KVB, BKV, t * BKV, kvh); });
          }
        }
      };
#ifdef REPRO_FLASH_FULL_ONLY  // the FULL loop alone, for ptxas's report of it
      copying(std::true_type());
#else
      if (cp.d == D) copying(std::true_type());
      else copying(std::false_type());
#endif
    }
    return;
  }

  if constexpr (Lay::CREGS > 0) hopper::setmaxnreg_inc<Lay::CREGS>();
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
    const uint64_t dq = hopper::make_desc(qs + slot * QB + wg * 64 * RB, 16, 8 * RB, Lay::SWZ);

    // the first tile's scores and P (O is still 0)
    int s = i % STAGES;
    hopper::mbar_wait_opaque(&kfull[s], (i / STAGES) & 1);
    issue_qk<D>(sacc, dq, hopper::make_desc(ks + s * KVB, 16, 8 * RB, Lay::SWZ), BQ * RB);
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
      issue_qk<D>(sacc, dq, hopper::make_desc(ks + s * KVB, 16, 8 * RB, Lay::SWZ), BQ * RB);
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

// q (B,H,Sq,d), k/v (B,Kv,Skv,d), d <= D, as 4-D tensor maps {d, seq, head,
// batch} read in boxes of TW columns (columns d..D-1 arrive as zeros): BQ
// query rows, 64 key rows. An operand TMA cannot read is copied (COPY), its
// map left unused. o's rows hold D columns (those past d written too).
template <int D, bool COPY>
cudaError_t launch(const bf16* const* ptrs, bf16* o, int B, int H, int Kv, int Sq, int Skv,
                   int d, const Strides* st, int copied, int causal, int window, float softcap,
                   float scale, cudaStream_t stream) {
  using Lay = Layout<D, COPY>;
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(kernel<D, COPY>, Lay::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap maps[3];
  Copied cp{};
  cp.flags = copied;
  cp.d = d;
  for (int i = 0; i < 3; ++i) {
    cp.p[i] = ptrs[i];
    cp.st[i] = st[i];
    if ((copied >> i) & 1) {
      memset(&maps[i], 0, sizeof(CUtensorMap));
      continue;
    }
    const uint64_t sizes[4] = {(uint64_t)d, (uint64_t)(i ? Skv : Sq), (uint64_t)(i ? Kv : H),
                               (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)st[i].s * 2, (uint64_t)st[i].h * 2,
                                 (uint64_t)st[i].b * 2};
    const uint32_t box[4] = {(uint32_t)Lay::TW, (uint32_t)(i ? BKV : Lay::BQ), 1, 1};
    if ((e = hopper::make_tensor_map(&maps[i], ptrs[i], 4, sizes, strides, box, Lay::RB)) !=
        cudaSuccess)
      return e;
  }
  dim3 grid(((Sq + Lay::BQ - 1) / Lay::BQ + 1) / 2, H, B);
  kernel<D, COPY><<<grid, Lay::THREADS, Lay::SMEM, stream>>>(
      maps[0], maps[1], maps[2], o, H, Kv, Sq, Skv, st[3], causal, window, softcap, scale, cp);
  return cudaGetLastError();
}

// the operands of q, k, v (bits 0, 1, 2) that TMA cannot read
int copied_operands(const bf16* const* ptrs, const Strides* st) {
  int copied = 0;
  for (int i = 0; i < 3; ++i)
    if (!hopper::tma_readable(ptrs[i], {st[i].b, st[i].h, st[i].s})) copied |= 1 << i;
  return copied;
}

// the operands TMA cannot read decide between the kernel with copied tiles
// and the one without
template <int D>
cudaError_t launch_any(const bf16* const* ptrs, bf16* o, int B, int H, int Kv, int Sq, int Skv,
                       int d, const Strides* st, int causal, int window, float softcap,
                       float scale, cudaStream_t stream) {
  const int copied = copied_operands(ptrs, st);
  return copied ? launch<D, true>(ptrs, o, B, H, Kv, Sq, Skv, d, st, copied, causal, window,
                                  softcap, scale, stream)
                : launch<D, false>(ptrs, o, B, H, Kv, Sq, Skv, d, st, 0, causal, window,
                                   softcap, scale, stream);
}

}  // namespace tc

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

// the rows of one (batch, head) of q, k or v: row i at p + i·s, `rows` rows
// of `cols` values (the head dim); vec: every row 16-byte aligned (16- and
// 8-byte copies)
struct View {
  const float* p;
  long long s;
  int rows, cols;
  bool vec;
};

// cp.async of N = 4 or 2 values of row `row` at column col into dst, zeros
// past the last row and (unless FULL: rows of the compiled width) the last
// column
template <int N, bool FULL>
__device__ __forceinline__ void copy(float* dst, const View& v, int row, int col) {
  if constexpr (FULL) {
    const bool in = row < v.rows;
    const float* src = in ? v.p + row * v.s + col : v.p;
    if (v.vec) {
      if (N == 4) hopper::cp_async16(dst, src, in ? 16 : 0);
      else hopper::cp_async8(dst, src, in ? 8 : 0);
      return;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) hopper::cp_async4(dst + i, in ? src + i : v.p, in ? 4 : 0);
  } else {
    const int n = row < v.rows ? max(0, min(N, v.cols - col)) : 0;
    const float* src = n ? v.p + row * v.s + col : v.p;
    if (v.vec) {
      if (N == 4) hopper::cp_async16(dst, src, 4 * n);
      else hopper::cp_async8(dst, src, 4 * n);
      return;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) hopper::cp_async4(dst + i, i < n ? src + i : v.p, i < n ? 4 : 0);
  }
}

// A producer thread's share (pt of PT) of a K-major chunk: rows r0 + [0,
// 64) at columns c0 + [0, NC), 4 columns a copy, into the raw slot (row i
// at raw + i·NC); it reads back only what it copied
template <int NC, bool FULL>
__device__ __forceinline__ void copy_rows(float* raw, const View& v, int r0, int c0, int pt) {
  constexpr int C4 = NC / 4;
#pragma unroll
  for (int e = 0; e < 16 * NC / PT; ++e) {
    const int f = pt + PT * e, row = f / C4, col = 4 * (f % C4);
    copy<4, FULL>(raw + row * NC + col, v, r0 + row, c0 + col);
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
template <int NC, bool FULL>
__device__ __forceinline__ void copy_cols(float* raw, const View& v, int k0, int c0, int pt) {
#pragma unroll
  for (int e = 0; e < (4 * NC + PT - 1) / PT; ++e) {
    const int u = pt + PT * e;
    if (u >= 4 * NC) return;
    const int col = 2 * (u % (NC / 2)), key = 8 * (u / (NC / 2));
#pragma unroll
    for (int j = 0; j < 8; ++j)
      copy<2, FULL>(raw + (key + j) * NC + col, v, k0 + key + j, c0 + col);
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
       float* __restrict__ o, int H, int Kv, int Sq, int Skv, int d, Strides qst, Strides kst,
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
    // FULL: rows of D columns (d = D), copied with no column clamp (held at
    // run time it cost these producers, which pace the kernel, 4-8%)
    auto produce = [&](auto whole) {
      constexpr bool FULL = decltype(whole)::value;
      constexpr int RS = L::RS;
      const int pt = tid - 128;
      const View qv{q + bi * qst.b + h * qst.h, qst.s, Sq, d, (vec & 1) != 0};
      const View kvw{k + bi * kst.b + kvh * kst.h, kst.s, Skv, d, (vec & 2) != 0};
      const View vv{v + bi * vst.b + kvh * vst.h, vst.s, Skv, d, (vec & 4) != 0};
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
            copy_rows<NC, FULL>(dst, qv, second ? q01 : q00, j * NC, pt);
          } else {
            const int t = (second ? tb1 : tb0) + (j - NCH) / (2 * NCH);
            const int c = (j - NCH) % (2 * NCH);
            if (c < NCH) copy_rows<NC, FULL>(dst, kvw, t * BKV, c * NC, pt);
            else copy_cols<NC, FULL>(dst, vv, t * BKV, (c - NCH) * NC, pt);
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
    };
#ifdef REPRO_FLASH_FULL_ONLY  // the FULL loop alone, for ptxas's report of it
    produce(std::true_type());
#else
    if (d == D) produce(std::true_type());
    else produce(std::false_type());
#endif
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
                   int Kv, int Sq, int Skv, int d, const Strides* st, int causal, int window,
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
  kernel<D><<<grid, THREADS, L::SMEM, stream>>>(q, k, v, o, H, Kv, Sq, Skv, d, st[0], st[1],
                                                   st[2], st[3], causal, window, softcap, scale,
                                                   vec);
  return cudaGetLastError();
}

}  // namespace tf32x3

bool valid(int B, int H, int Kv, int Sq, int Skv, int D) {
  return B > 0 && H > 0 && Kv > 0 && H % Kv == 0 && Sq > 0 && Skv > 0 && B <= 65535 &&
         H <= 65535 && D >= 1 && D <= 256;
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Kv,Skv,D), o (B,H,Sq,Dp) as strided views whose last
// dim is contiguous; Dp: the compiled width the caller runs D at and
// allocated o's rows with (kernels/flash_attention.py ``padded_dim``), 16,
// 32, 64, 128 or 256 and at least D (o's columns past D are written too,
// so the store needs no column guard: one made ptxas spill in the served
// instances); strides = 12 element strides (batch, head, seq) of q, k, v, o
// in that order. Each entry launches one variant on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for what it does not take).

// wgmma: any D in 1..256 (run at Dp, the columns past D zeros),
// any strides of q, k, v: what a tensor map reads (a 16-byte aligned pointer,
// strides positive multiples of 8) comes by TMA, the rest is copied by the
// producer warps
extern "C" int flash_attention_wgmma_bf16(const void* q, const void* k, const void* v, void* o,
                                          int B, int H, int Kv, int Sq, int Skv, int D,
                                          int Dp, const long long* strides, int causal, int window,
                                          float softcap, float scale, void* stream) {
  using namespace tc;
  if (!valid(B, H, Kv, Sq, Skv, D) || Dp < D) return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const bf16* ptrs[3] = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v)};
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dp) {
    case 16: return (int)launch_any<16>(ptrs, op, B, H, Kv, Sq, Skv, D, st, causal, window, softcap, scale, s);
    case 32: return (int)launch_any<32>(ptrs, op, B, H, Kv, Sq, Skv, D, st, causal, window, softcap, scale, s);
    case 64: return (int)launch_any<64>(ptrs, op, B, H, Kv, Sq, Skv, D, st, causal, window, softcap, scale, s);
    case 128: return (int)launch_any<128>(ptrs, op, B, H, Kv, Sq, Skv, D, st, causal, window, softcap, scale, s);
    case 256: return (int)launch_any<256>(ptrs, op, B, H, Kv, Sq, Skv, D, st, causal, window, softcap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the operands (bits 0, 1, 2: q, k, v) whose tiles flash_attention_wgmma_bf16
// copies for these pointers and the first 9 of its strides
extern "C" int flash_attention_copied(const void* q, const void* k, const void* v,
                                      const long long* strides) {
  Strides st[3];
  for (int i = 0; i < 3; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const bf16* ptrs[3] = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v)};
  return tc::copied_operands(ptrs, st);
}

// fp32: fp32 q, k, v, o; any D in 1..256 (run at Dp, the columns past D
// zeros), any strides
extern "C" int flash_attention_fp32(const void* q, const void* k, const void* v, void* o, int B,
                                    int H, int Kv, int Sq, int Skv, int D, int Dp,
                                    const long long* strides, int causal, int window,
                                    float softcap, float scale, void* stream) {
  using namespace tf32x3;
  if (!valid(B, H, Kv, Sq, Skv, D) || Dp < D) return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dp) {
    case 16: return (int)launch<16>(qp, kp, vp, op, B, H, Kv, Sq, Skv, D, st, causal, window, softcap, scale, s);
    case 32: return (int)launch<32>(qp, kp, vp, op, B, H, Kv, Sq, Skv, D, st, causal, window, softcap, scale, s);
    case 64: return (int)launch<64>(qp, kp, vp, op, B, H, Kv, Sq, Skv, D, st, causal, window, softcap, scale, s);
    case 128: return (int)launch<128>(qp, kp, vp, op, B, H, Kv, Sq, Skv, D, st, causal, window, softcap, scale, s);
    case 256: return (int)launch<256>(qp, kp, vp, op, B, H, Kv, Sq, Skv, D, st, causal, window, softcap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
