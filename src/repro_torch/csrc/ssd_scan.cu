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
// (4.5 µs at 989 TFLOP/s). So the bytes bound it. In fp32 (x, B, C fp32)
// the operations bound it at three TF32 products' rate (5.64 GFLOP at
// chunks of 64: 34 µs at 165 TFLOP/s, against 18 µs for its 61 MB).
//
// Two variants, picked by the wrapper (kernels/ssd_scan.py ``variant``) from
// the dtype, both at any P, any N and any strides. N is split across blocks:
// ns = ceil(N / 256) slices of Ns = 64·ceil(N / (64·ns)) columns each
// (the wrapper's ``n_slices``, ``slice_width``: it passes ns and Ns, which
// also size its scratch, and the entries check that they cover N and fit a
// block), one slice a block, since a block's state
// (32 columns of P x Ns, fp32) lives in its warpgroup's registers and a
// chunk's B and C tiles grow with N. Every sum over N is linear: the scores
// C·Bᵀ and the state term C·h are sums over the slices, and a slice's
// columns of h are updated from its columns of B alone. So a block runs the
// kernel below on the columns [n0, n0 + Ns) of B, C and the states (TMA's or
// the copier's zero fill past N) and writes its partial y into fp32 scratch
// (ns, B, S, H, P) that the wrapper allocates; a second launch
// (``sum_slices``) adds the partials in slice order (no atomics: reruns stay
// bit-identical). Up to N = 256 there is one slice, y is written directly
// and nothing else runs. Above, each slice's block recomputes the chunk's
// decays and reads x again, and the partials move 2·ns·4 bytes a y element
// beyond the bound's (written, then read by sum_slices).
//
// * wgmma (bf16 x/B/C; the main path). A slice's N is padded to a multiple
//   of 64 and the last 32-column slice of P
//   masked by TMA's zero fill (zero columns of B and C leave C·Bᵀ and the
//   real state unchanged; only real columns are stored); an operand TMA
//   cannot read (a pointer off 16 bytes, a stride not a positive multiple
//   of 8 elements) is copied instead: each warp cp.asyncs its share of the
//   chunk's boxes into staging (hopper.cuh's atile) and every thread places
//   rows of them at the chunk's start (the kernel's COPY instance). The TPU grid runs its chunk
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
// * tf32 (fp32 x/B/C): the same schedule
//   (one warpgroup per (b, h, 32 columns of P), chunks of 64, cs in the
//   log2 domain, hᵀ in registers) with every product in 3xTF32 on wgmma:
//   each fp32 operand a TF32 big and small term, three products a pair
//   (small·big, big·small, big·big; hopper.cuh's split_tf32). TF32 wgmma
//   reads shared-memory operands K-major only, so N is taken 64 columns at
//   a time and the operands are placed for it: C_k, B_kᵀ and G as register
//   fragments (C and G split in registers, B_kᵀ read from B_k's terms), B_k,
//   h_k, xᵀ and (w⊙x)ᵀ as K-major term tiles; G's fragment holds steps 2q
//   and 2q + 1 where the register operand's k index is q and q + 4, so xᵀ,
//   (w⊙x)ᵀ and B_kᵀ take the steps in that order. Each chunk's state update
//   is summed from zero and added to the decayed state in fp32. Raw blocks
//   come by cp.async (16-byte copies where rows are aligned, 4-byte
//   otherwise), each refilled as soon as it is read; 105 KiB of shared
//   memory, two blocks an SM. kernels/ssd_ref.py ``ssd_scan_tf32x3_ref`` is
//   this arithmetic in PyTorch (held against the Pallas kernel; each small
//   term shown needed).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

struct Strides {
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, bm_b, bm_s, cm_b, cm_s;
};

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

// Shared memory from a 1024-byte aligned base, N padded to 64·NB: the
// chunk's x tile and NB boxes each of B and C; h's hi and lo terms; (w⊙x)'s
// hi and lo terms; the chunk's cs and dt; (COPY) the copied boxes' staging;
// the TMA barrier. 61.5 KiB at N = 128: three blocks per SM (103.5 KiB with
// every operand copied: two).
template <int NB, bool COPY>
struct Layout {
  static constexpr int STAGE = X_TILE + 2 * NB * BOX;
  static constexpr int H_TERM = NB * H_BOX;
  static constexpr int OFF_H = STAGE;
  static constexpr int OFF_XW = OFF_H + 2 * H_TERM;
  static constexpr int OFF_SCAL = OFF_XW + 2 * X_TILE;
  static constexpr int OFF_STG = OFF_SCAL + Q / 2 * 16;
  static constexpr int X_STG = hopper::atile::Tile<PS>::STAGING;  // x's 64-step box
  static constexpr int B_STG = hopper::atile::Tile<64>::STAGING;  // a box of B or C
  static constexpr int OFF_BAR = OFF_STG + (COPY ? X_STG + 2 * NB * B_STG : 0);
  static constexpr size_t SMEM = 1024 + OFF_BAR + 8;
};

// The operands TMA cannot read (bit 0: x, 1: Bm, 2: Cm), and their views
struct Views {
  const bf16 *x, *bm, *cm;
  int copied;
};

// a 64-step x 32-column y fragment (rows ta and ta + 8 of the lane, columns
// 8j + cq + {0, 1}) into y (row pitch H·P) at the steps before S and the
// columns below `cols` (P − p0): pairs where P is even (8-byte aligned)
__device__ __forceinline__ void store_y(float* yb, const float (&yacc)[16], int ta, int S, int H,
                                        int P, int cols, int cq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = ta + 8 * r;
    if (t >= S) continue;
    float* row = yb + (size_t)t * H * P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + cq;
      const float v0 = yacc[4 * j + 2 * r], v1 = yacc[4 * j + 2 * r + 1];
      if (P % 2 == 0 && col + 1 < cols) {
        *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
      } else {
        if (col < cols) row[col] = v0;
        if (col + 1 < cols) row[col + 1] = v1;
      }
    }
  }
}

// v = hi + lo + O(2^-16 |v|): hi = bf16(v), lo = bf16(v − hi), two values packed
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int NB, bool COPY>
__global__ void __launch_bounds__(THREADS, 3)
kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
       const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ dt,
       const float* __restrict__ A, const float* __restrict__ h0, float* __restrict__ y,
       float* __restrict__ hT, int S, int H, int P, int N, int nps, long long y_slice,
       const __grid_constant__ Strides st, const __grid_constant__ Views vw) {
  using Lay = Layout<NB, COPY>;
  const long long dt_b = st.dt_b, dt_s = st.dt_s, dt_h = st.dt_h;
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

  // block (P slice, N slice sl, h, b): columns [p0, p0 + 32) of P and
  // [n0, n0 + 64·NB) of N; its y (partial above one slice) y_slice·sl on
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sl = blockIdx.x / nps, p0 = (blockIdx.x % nps) * PS, n0 = sl * 64 * NB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = (S + Q - 1) / Q;

  // x, B, C of chunk c by TMA (steps past S, columns past P and N arrive as
  // zeros); (COPY) box j of the chunk's copied operands (0: x, 1..NB: B's,
  // NB+1..2NB: C's) is cp.asynced by warp j % 4 into its staging, and
  // placed (zeros past S, P, N) at the chunk's start
  const int cp = COPY ? vw.copied : 0;
  unsigned char* stg = base + Lay::OFF_STG;
  auto box = [&](int j, int c) {
    if (j == 0)
      return hopper::atile::Box{{vw.x + b * st.x_b + h * st.x_h, S, P, (int)st.x_s}, c * Q, p0,
                                Q, PS, xs, stg, true};
    const int k = (j - 1) % NB;
    const bool isb = j <= NB;
    return hopper::atile::Box{{isb ? vw.bm + b * st.bm_b : vw.cm + b * st.cm_b, S, N,
                               (int)(isb ? st.bm_s : st.cm_s)},
                              c * Q, n0 + 64 * k, Q, 64, (isb ? bs : cs_tile) + k * BOX,
                              stg + Lay::X_STG + (j - 1) * Lay::B_STG, true};
  };
  auto copied = [&](int j) { return (cp >> (j == 0 ? 0 : j <= NB ? 1 : 2)) & 1; };
  auto load = [&](int c) {
    if (tid == 0) {
      hopper::mbar_arrive_expect_tx(full, (cp & 1 ? 0 : X_TILE) + (cp & 2 ? 0 : NB * BOX) +
                                              (cp & 4 ? 0 : NB * BOX));
      if (!(cp & 1)) hopper::tma_load_4d(xs, &tm_x, full, p0, c * Q, h, b);
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        if (!(cp & 2)) hopper::tma_load_3d(bs + k * BOX, &tm_b, full, n0 + 64 * k, c * Q, b);
        if (!(cp & 4))
          hopper::tma_load_3d(cs_tile + k * BOX, &tm_c, full, n0 + 64 * k, c * Q, b);
      }
    }
    if constexpr (COPY) {
      for (int j = warp; j < 1 + 2 * NB; j += 4) {
        if (!copied(j)) continue;
        const hopper::atile::Box bx = box(j, c);
        if (j == 0) hopper::atile::issue<PS>(bx, lane);
        else hopper::atile::issue<64>(bx, lane);
      }
      hopper::cp_async_commit();
    }
  };
  if (tid == 0) {
    if (!(cp & 1)) hopper::prefetch_tensormap(&tm_x);
    if (!(cp & 2)) hopper::prefetch_tensormap(&tm_b);
    if (!(cp & 4)) hopper::prefetch_tensormap(&tm_c);
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

  // hᵀ (64·NB x 32, fp32): fragment ti holds n in n0 + [64 ti, 64 ti + 64), p
  // in [p0, p0 + 32)
  float hacc[NB][16];
#pragma unroll
  for (int ti = 0; ti < NB; ++ti)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int n = n0 + 64 * ti + r0 + 8 * ((e % 4) / 2), p = p0 + 8 * (e / 4) + cq + e % 2;
      hacc[ti][e] = h0 && p < P && n < N ? h0[state_off + (size_t)p * N + n] : 0.f;
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
  float* yb = y + sl * y_slice + ((size_t)b * S * H + h) * P + p0;

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
    if constexpr (COPY) {  // the chunk's copied boxes, one row a thread at a time
      hopper::cp_async_wait<0>();
      __syncthreads();
      for (int i = tid; i < (1 + 2 * NB) * Q; i += THREADS) {
        const int j = i / Q;
        if (!copied(j)) continue;
        const hopper::atile::Box bx = box(j, c);
        if (j == 0) hopper::atile::place<PS>(bx, i % Q, -1);
        else hopper::atile::place<64>(bx, i % Q, -1);
      }
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
    store_y(yb, yacc, c * Q + r0, S, H, P, P - p0, cq);
  }

#pragma unroll
  for (int ti = 0; ti < NB; ++ti)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int n = n0 + 64 * ti + r0 + 8 * ((e % 4) / 2), p = p0 + 8 * (e / 4) + cq + e % 2;
      if (p < P && n < N) hT[state_off + (size_t)p * N + n] = hacc[ti][e];
    }
}

// the operands of x, Bm, Cm (bits 0, 1, 2) that TMA cannot read
int copied_operands(const void* x, const void* Bm, const void* Cm, const Strides& st) {
  return (hopper::tma_readable(x, {st.x_b, st.x_s, st.x_h}) ? 0 : 1) |
         (hopper::tma_readable(Bm, {st.bm_b, st.bm_s}) ? 0 : 2) |
         (hopper::tma_readable(Cm, {st.cm_b, st.cm_s}) ? 0 : 4);
}

// x (B,S,H,P) as a 4-D map {P, S, H, B}, 32 x 64 boxes; Bm, Cm (B,S,N) as
// 3-D maps {N, S, B}, 64 x 64 boxes (boxes past P and N zero-filled); the
// operands TMA cannot read copied (COPY); ns slices of N (y: their partials,
// y_slice apart, when ns > 1)
template <int NB>
cudaError_t launch(const bf16* x, const float* dt, const float* A, const bf16* Bm,
                   const bf16* Cm, const float* h0, float* y, float* hT, int B, int S, int H,
                   int P, int N, int ns, long long y_slice, const Strides& st,
                   cudaStream_t stream) {
  const Views vw{x, Bm, Cm, copied_operands(x, Bm, Cm, st)};
  CUtensorMap mx, mb, mc;
  memset(&mx, 0, sizeof(mx));
  memset(&mb, 0, sizeof(mb));
  memset(&mc, 0, sizeof(mc));
  cudaError_t e;
  if (!(vw.copied & 1)) {
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
    if (vw.copied & (2 << i)) continue;
    const uint64_t sizes[3] = {(uint64_t)N, (uint64_t)S, (uint64_t)B};
    const uint64_t strides[2] = {(uint64_t)bst[i][0] * 2, (uint64_t)bst[i][1] * 2};
    const uint32_t box[3] = {64, Q, 1};
    if ((e = hopper::make_tensor_map(maps[i], ptrs[i], 3, sizes, strides, box, 128)) !=
        cudaSuccess)
      return e;
  }
  const int nps = (P + PS - 1) / PS;
  dim3 grid(nps * ns, H, B);
  if (vw.copied) {
    static bool smem_set = false;
    if ((e = hopper::allow_smem(kernel<NB, true>, Layout<NB, true>::SMEM, smem_set)) != cudaSuccess)
      return e;
    kernel<NB, true><<<grid, THREADS, Layout<NB, true>::SMEM, stream>>>(
        mx, mb, mc, dt, A, h0, y, hT, S, H, P, N, nps, y_slice, st, vw);
  } else {
    static bool smem_set = false;
    if ((e = hopper::allow_smem(kernel<NB, false>, Layout<NB, false>::SMEM, smem_set)) !=
        cudaSuccess)
      return e;
    kernel<NB, false><<<grid, THREADS, Layout<NB, false>::SMEM, stream>>>(
        mx, mb, mc, dt, A, h0, y, hT, S, H, P, N, nps, y_slice, st, vw);
  }
  return cudaGetLastError();
}

}  // namespace tc

// ===========================================================================
// tf32: fp32 x, B, C in 3xTF32 on warpgroup MMA
// ===========================================================================
namespace tf32 {

constexpr int Q = 64;              // steps per chunk
constexpr int PS = 32;             // columns of P (state rows) per block
constexpr int THREADS = 128;       // one warpgroup
constexpr int TILE = 64 * 128;     // a column block of a 64-row term tile: rows of 32 fp32
constexpr int PTILE = PS * 128;    // ... of a 32-row one
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory from a 1024-byte aligned base. Raw fp32 blocks as loaded
// (rows of 64 values, 16-byte chunk i of row r stored at i ^ (r % 8), so the
// fragments' column reads miss bank conflicts): C's and B's 64 steps x 64
// columns of N, x's 64 steps x 32 columns of P, each refilled for the next
// block as soon as it is read; then the TF32 big and small terms, K-major in
// the 128-byte swizzle (put_chunk): B_k (64 steps x 64 of N), h_k (32 of P x
// 64 of N; at the chunk's end xᵀ in its place), (w⊙x)ᵀ (32 of P x 64
// steps, steps permuted as the scores' fragment holds them); the chunk's cs
// and dt. 105 KiB: two blocks an SM.
struct Layout {
  static constexpr int RAW = Q * 64 * 4, RAW_X = Q * PS * 4;
  static constexpr int BT = 2 * TILE, PT = 2 * PTILE;  // a term of B_k; of h_k, xᵀ, (w⊙x)ᵀ
  static constexpr int OFF_RAWB = RAW, OFF_RAWX = 2 * RAW;
  static constexpr int OFF_B = OFF_RAWX + RAW_X;
  static constexpr int OFF_H = OFF_B + 2 * BT;
  static constexpr int OFF_XW = OFF_H + 2 * PT;
  static constexpr int OFF_SCAL = OFF_XW + 2 * PT;
  static constexpr size_t SMEM = 1024 + OFF_SCAL + Q / 2 * 16;
  static_assert(2 * (SMEM + 1024) <= 228 * 1024, "two blocks must fit an SM");
};

// cp.async of the 4 values of a row at `src` (n of them valid: zeros past
// the row's end or the matrix's last row); vec: 16-byte aligned, else four
// 4-byte copies. `safe` is an address to name where nothing is read.
__device__ __forceinline__ void copy4(float* dst, const float* src, int n, bool vec,
                                      const float* safe) {
  n = max(0, min(4, n));
  if (vec) {
    hopper::cp_async16(dst, n ? src : safe, 4 * n);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) hopper::cp_async4(dst + i, i < n ? src + i : safe, i < n ? 4 : 0);
}

// a value of a raw block (rows of `W` fp32, chunks swizzled by the row)
template <int W>
__device__ __forceinline__ int raw_at(int row, int col) {
  return row * W + ((((col >> 2) ^ (row & 7)) & (W / 4 - 1)) << 2) + (col & 3);
}

// v, opaque to the compiler: indices computed from it are computed where
// they are used, not hoisted out of the chunk loop into registers held
// across it (a thread's fixed offsets, dozens of them, spilled)
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// f(Int<0>()), ..., f(Int<N - 1>()): a loop whose index is a constant in
// each body, so that arrays it indexes stay in registers
template <int V>
struct Int {
  static constexpr int value = V;
};
template <int N, int I = 0, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(Int<I>());
    static_for<N, I + 1>(f);
  }
}

// The register fragments of one half of a 64-deep K (4 k-steps of 8): k-step
// kk's 4 values at 4kk, big and small terms
struct Frags {
  uint32_t b[16], s[16];
};

// keeps the fragments (read by asynchronous wgmmas) unchanged until done
__device__ __forceinline__ void hold(const Frags& f) {
#pragma unroll
  for (int e = 0; e < 16; ++e) asm volatile("" ::"r"(f.b[e]), "r"(f.s[e]) : "memory");
}

// D += A·B in 3xTF32 over half `half` of 64 of K (k-steps 4·half + [0, 4)):
// A's big and small terms as register fragments f; B's as K-major tiles at
// db, ds (column blocks of 32 K `blk` bytes apart); scale0 0: the first
// product overwrites D
template <int M>
__device__ __forceinline__ void mma3(float (&d)[M], const Frags& f, uint64_t db, uint64_t ds,
                                     int blk, int half, int scale0) {
  // opaque to the compiler: else it hoists every descriptor of every call
  // out of the chunk loop, a pair of registers each, and spills
  asm volatile("" : "+l"(db), "+l"(ds));
#pragma unroll
  for (int k4 = 0; k4 < 4; ++k4) {
    const uint32_t ab[4] = {f.b[4 * k4], f.b[4 * k4 + 1], f.b[4 * k4 + 2], f.b[4 * k4 + 3]};
    const uint32_t as[4] = {f.s[4 * k4], f.s[4 * k4 + 1], f.s[4 * k4 + 2], f.s[4 * k4 + 3]};
    const uint32_t off = half * blk + k4 * 32;
    hopper::wgmma_tf32_rs(d, as, hopper::desc_add(db, off), k4 > 0 || scale0);
    hopper::wgmma_tf32_rs(d, ab, hopper::desc_add(ds, off), 1);
    hopper::wgmma_tf32_rs(d, ab, hopper::desc_add(db, off), 1);
  }
}

// xᵀ or (w⊙x)ᵀ (w8: the 8 steps' w, or null) as a K-major term tile (32 rows
// of P, 64 steps), from the raw x block: unit tid takes steps 8·kg + [0, 8)
// of columns 2·dp and 2·dp + 1, and, as the scores' fragment holds steps 2q
// and 2q + 1 of each 8 where the register operand's k index is q and q + 4,
// stores steps 0, 2, 4, 6 in the k-step's first 16 bytes and 1, 3, 5, 7 in
// its second (flash attention's fp32 V tiles)
__device__ __forceinline__ void put_x(unsigned char* big, const float* rx, const float* w8,
                                      int tid) {
  const int dp = tid % 16, kg = tid / 16, c = 2 * (kg % 4);
  big += (kg / 4) * PTILE;
  unsigned char* small = big + Layout::PT;
  float2 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = *reinterpret_cast<const float2*>(rx + raw_at<PS>(8 * kg + j, 2 * dp));
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const bool odd = ((dp >> 2) + ii) & 1;
    const int n = 2 * dp + odd;
    uint32_t b[8], s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      hopper::split_tf32((odd ? v[j].y : v[j].x) * (w8 ? w8[j] : 1.f), b[j], s[j]);
    hopper::put_chunk(big, n, c, b[0], b[2], b[4], b[6]);
    hopper::put_chunk(big, n, c + 1, b[1], b[3], b[5], b[7]);
    hopper::put_chunk(small, n, c, s[0], s[2], s[4], s[6]);
    hopper::put_chunk(small, n, c + 1, s[1], s[3], s[5], s[7]);
  }
}

template <int NB>
__global__ void __launch_bounds__(THREADS, 2)
kernel(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
       const float* __restrict__ Bm, const float* __restrict__ Cm, const float* __restrict__ h0,
       float* __restrict__ y, float* __restrict__ hT, int S, int H, int P, int N, int nps,
       long long y_slice, const __grid_constant__ Strides st, int vec) {
  using L = Layout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~1023ull);
  float* rc = reinterpret_cast<float*>(base);  // C_k, B_k and x as loaded
  float* rb = reinterpret_cast<float*>(base + L::OFF_RAWB);
  float* rx = reinterpret_cast<float*>(base + L::OFF_RAWX);
  unsigned char* bterm = base + L::OFF_B;    // B_k big, then small
  unsigned char* hterm = base + L::OFF_H;    // h_k big, then small; xᵀ at the chunk's end
  unsigned char* xwterm = base + L::OFF_XW;  // (w⊙x)ᵀ big, then small
  // for each pair of steps (2i, 2i + 1): {cs, cs, dt, dt}
  float4* pairs = reinterpret_cast<float4*>(base + L::OFF_SCAL);
  const float* cs_dt = reinterpret_cast<const float*>(pairs);
  auto cs = [&](int t) { return cs_dt[(t / 2) * 4 + t % 2]; };
  auto dts = [&](int t) { return cs_dt[(t / 2) * 4 + 2 + t % 2]; };

  // block (P slice, N slice sl, h, b), as tc's
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sl = blockIdx.x / nps, p0 = (blockIdx.x % nps) * PS, ns0 = sl * 64 * NB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = (S + Q - 1) / Q;
  const float* xb = x + b * st.x_b + h * st.x_h;
  const float* bb = Bm + b * st.bm_b;
  const float* cb = Cm + b * st.cm_b;

  // block u = c·NB + k of B or C (steps c·Q + [0, Q), columns ns0 + 64k + [0,
  // 64) of N, zeros past N), and chunk c's x (columns p0 + [0, 32) of P),
  // each one commit group
  auto load_bc = [&](float* dst, const float* m, long long pitch, int u, bool v) {
    const int t0 = (u / NB) * Q, n0 = ns0 + 64 * (u % NB);
    for (int e = opaque(tid); e < Q * 16; e += THREADS) {
      const int row = e / 16, col = 4 * (e % 16), t = t0 + row, n = n0 + col;
      copy4(dst + raw_at<64>(row, col), m + (size_t)min(t, S - 1) * pitch + min(n, N - 1),
            t < S ? N - n : 0, v, m);
    }
    hopper::cp_async_commit();
  };
  auto load_x = [&](int c) {
    for (int e = opaque(tid); e < Q * 8; e += THREADS) {
      const int row = e / 8, col = 4 * (e % 8), t = c * Q + row, p = p0 + col;
      copy4(rx + raw_at<PS>(row, col), xb + (size_t)min(t, S - 1) * st.x_s + min(p, P - 1),
            t < S ? P - p : 0, vec & 1, xb);
    }
    hopper::cp_async_commit();
  };
  load_x(0);
  load_bc(rb, bb, st.bm_s, 0, vec & 2);
  load_bc(rc, cb, st.cm_s, 0, vec & 4);

  // lane l of warp w holds, of every 64-row fragment, rows r0 = 16w + l/4
  // and r0 + 8, columns 8j + cq + {0, 1}
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4), ql = lane % 4;
  const size_t state_off = ((size_t)b * H + h) * P * N;
  const float la_h = A[h] * LOG2E;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;

  // hᵀ (64·NB x 32, fp32): fragment k holds n in ns0 + [64k, 64k + 64), p in
  // [p0, p0 + 32)
  float hacc[NB][16];
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int n = ns0 + 64 * k + r0 + 8 * ((e % 4) / 2), p = p0 + 8 * (e / 4) + cq + e % 2;
      hacc[k][e] = h0 && p < P && n < N ? h0[state_off + (size_t)p * N + n] : 0.f;
    }
  float sacc[32], yacc[16], tacc[16];
  Frags f, g;  // register operands' big and small terms, half a K at a time
  const uint64_t dbb = hopper::make_desc(bterm, 16, 1024, 1);
  const uint64_t dbs = hopper::make_desc(bterm + L::BT, 16, 1024, 1);
  const uint64_t dhb = hopper::make_desc(hterm, 16, 1024, 1);
  const uint64_t dhs = hopper::make_desc(hterm + L::PT, 16, 1024, 1);
  const uint64_t dwb = hopper::make_desc(xwterm, 16, 1024, 1);
  const uint64_t dws = hopper::make_desc(xwterm + L::PT, 16, 1024, 1);
  float* yb = y + sl * y_slice + ((size_t)b * S * H + h) * P + p0;
  const int total = nc * NB;
  // warp 0's dt of steps 2·lane and 2·lane + 1 of a chunk, one chunk ahead
  float d0n = 0.f, d1n = 0.f;
  auto fetch_dt = [&](int c) {
    const int t = c * Q + 2 * lane;
    d0n = t < S ? dtb[t * st.dt_s] : 0.f;
    d1n = t + 1 < S ? dtb[(t + 1) * st.dt_s] : 0.f;
  };
  if (warp == 0) fetch_dt(0);

  for (int c = 0; c < nc; ++c) {
    // block k of N, k a constant in each (hacc[k] stays in registers)
    static_for<NB>([&](auto kc) {
      constexpr int k = decltype(kc)::value;
      const int u = c * NB + k;
      hopper::cp_async_wait<0>();
      __syncthreads();  // block u's B and C (and at k = 0 chunk c's x) are in
      if (k == 0) {
        if (warp == 0) {  // cs, the inclusive sum of la over the chunk (log2 domain)
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
        __syncthreads();
        // w_s = 2^(cs_L − cs_s)·dt_s for this thread's 8 steps
        const int tq = opaque(tid);
        float w8[8];
        const float cs_last = cs(Q - 1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = 8 * (tq / 16) + j;
          w8[j] = hopper::exp2_approx(cs_last - cs(s)) * dts(s);
        }
        put_x(xwterm, rx, w8, tq);
      }
      // B_k's terms (steps x 64 of N) and h_k's (32 of P x 64 of N), K-major
#pragma unroll 2
      for (int e = opaque(tid); e < Q * 16; e += THREADS) {
        const int row = e / 16, col = 4 * (e % 16);
        const float4 v = *reinterpret_cast<const float4*>(rb + raw_at<64>(row, col));
        uint32_t b4[4], s4[4];
        hopper::split_tf32(v.x, b4[0], s4[0]);
        hopper::split_tf32(v.y, b4[1], s4[1]);
        hopper::split_tf32(v.z, b4[2], s4[2]);
        hopper::split_tf32(v.w, b4[3], s4[3]);
        unsigned char* at = bterm + (col / 32) * TILE;
        hopper::put_chunk(at, row, (col % 32) / 4, b4[0], b4[1], b4[2], b4[3]);
        hopper::put_chunk(at + L::BT, row, (col % 32) / 4, s4[0], s4[1], s4[2], s4[3]);
      }
      {
        const int r0o = opaque(r0), cqo = opaque(cq);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int nl = r0o + 8 * ((e % 4) / 2), pl = 8 * (e / 4) + cqo + e % 2;
          const int off = (nl / 32) * PTILE + pl * 128 + ((((nl % 32) / 4) ^ (pl & 7)) << 4) +
                          (nl % 4) * 4;
          uint32_t hb, hs;
          hopper::split_tf32(hacc[k][e], hb, hs);
          *reinterpret_cast<uint32_t*>(hterm + off) = hb;
          *reinterpret_cast<uint32_t*>(hterm + L::PT + off) = hs;
        }
      }
      hopper::fence_proxy_async();
      __syncthreads();
      if (u + 1 < total) load_bc(rb, bb, st.bm_s, u + 1, vec & 2);  // B_k is in its terms

      // scores += C_k·B_kᵀ and y += C_k·h_kᵀ (h: the state entering the
      // chunk) from C_k's fragments (k-step kk holding C[r][8kk + ql (+ 4)]
      // of rows r0, r0 + 8, split in registers), and hᵀ_k's update B_kᵀ·(w⊙x)
      // from B_kᵀ's (read from B_k's terms, already split; steps permuted as
      // (w⊙x)ᵀ's: k index ql step 8kk + 2ql, ql + 4 step 8kk + 2ql + 1): half
      // the 64 columns of N or steps at a time, the two products' halves in
      // flight together (f: C_k's, g: B_kᵀ's)
      auto c_frags = [&](int half) {
        const int r0o = opaque(r0), qlo = opaque(ql);
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = r0o + 8 * (i % 2), col = 8 * (4 * half + k4) + qlo + 4 * (i / 2);
            hopper::split_tf32(rc[raw_at<64>(row, col)], f.b[4 * k4 + i], f.s[4 * k4 + i]);
          }
      };
      auto bt_frags = [&](int half) {
        const int r0o = opaque(r0), qlo = opaque(ql);
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = r0o + 8 * (i % 2), s = 8 * (4 * half + k4) + 2 * qlo + i / 2;
            const int off = (n / 32) * TILE + s * 128 + ((((n % 32) / 4) ^ (s & 7)) << 4) +
                            (n % 4) * 4;
            g.b[4 * k4 + i] = *reinterpret_cast<const uint32_t*>(bterm + off);
            g.s[4 * k4 + i] = *reinterpret_cast<const uint32_t*>(bterm + L::BT + off);
          }
      };
      auto scores_y = [&](int half) {
        hopper::wgmma_fence();
        mma3(sacc, f, dbb, dbs, TILE, half, k > 0 || half > 0);
        mma3(yacc, f, dhb, dhs, PTILE, half, k > 0 || half > 0);
        hopper::wgmma_commit();
      };
      auto update = [&](int half) {
        hopper::wgmma_fence();
        mma3(tacc, g, dwb, dws, PTILE, half, half);
        hopper::wgmma_commit();
      };
      hopper::fence_operand(sacc);
      hopper::fence_operand(yacc);
      hopper::fence_operand(tacc);
      c_frags(0);
      scores_y(0);
      bt_frags(0);
      update(0);
      hopper::wgmma_wait<1>();  // the first half's scores and y are done with f
      hold(f);
      c_frags(1);
      __syncthreads();  // every thread has read C_k: the next block's C goes there
      if (u + 1 < total) load_bc(rc, cb, st.cm_s, u + 1, vec & 4);
      scores_y(1);
      hopper::wgmma_wait<1>();  // the first half's update is done with g
      hold(g);
      bt_frags(1);
      update(1);
      hopper::wgmma_wait<0>();
      hopper::fence_operand(sacc);
      hopper::fence_operand(yacc);
      hopper::fence_operand(tacc);
      hold(f);
      hold(g);
      const float decay = hopper::exp2_approx(cs(Q - 1));
#pragma unroll
      for (int e = 0; e < 16; ++e) hacc[k][e] = fmaf(decay, hacc[k][e], tacc[e]);
    });

    // xᵀ in h's place (every warp is done with h's terms), then the next
    // chunk's x into its raw block
    __syncthreads();
    put_x(hterm, rx, nullptr, opaque(tid));
    hopper::fence_proxy_async();
    __syncthreads();
    if (c + 1 < nc) load_x(c + 1);

    // y = 2^(cs_q)·(C·h) + G·x, G = scores·2^(cs_q − cs_s)·dt_s for s <= q
    // (masked before the exponent), its fragment in the register operand's
    // order: k index ql holds step 8kk + cq, ql + 4 step 8kk + cq + 1
    const float cs_a = cs(r0), cs_b = cs(r0 + 8);
    const float ea = hopper::exp2_approx(cs_a), eb = hopper::exp2_approx(cs_b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      yacc[4 * j + 0] *= ea;
      yacc[4 * j + 1] *= ea;
      yacc[4 * j + 2] *= eb;
      yacc[4 * j + 3] *= eb;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r0o = opaque(r0), cqo = opaque(cq);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = 4 * half + k4, e = 4 * kk + (i % 2) * 2 + i / 2;  // sacc's for a[i]
          const int q = r0o + 8 * (i % 2), s = 8 * kk + cqo + i / 2;
          const float csq = i % 2 ? cs_b : cs_a;
          const float g = s <= q ? sacc[e] * hopper::exp2_approx(csq - cs(s)) * dts(s) : 0.f;
          hopper::split_tf32(g, f.b[4 * k4 + i], f.s[4 * k4 + i]);
        }
      hopper::fence_operand(yacc);
      hopper::wgmma_fence();
      mma3(yacc, f, dhb, dhs, PTILE, half, 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(yacc);
      hold(f);
    }
    tc::store_y(yb, yacc, c * Q + r0, S, H, P, P - p0, cq);
  }

#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int n = ns0 + 64 * k + r0 + 8 * ((e % 4) / 2), p = p0 + 8 * (e / 4) + cq + e % 2;
      if (p < P && n < N) hT[state_off + (size_t)p * N + n] = hacc[k][e];
    }
}

// rows 16-byte aligned: a 16-byte aligned pointer, strides multiples of 4
inline bool rows16(const void* p, std::initializer_list<long long> strides) {
  if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  for (long long s : strides)
    if (s % 4) return false;
  return true;
}

// ns slices of N (y: their partials, y_slice apart, when ns > 1)
template <int NB>
cudaError_t launch(const float* x, const float* dt, const float* A, const float* Bm,
                   const float* Cm, const float* h0, float* y, float* hT, int B, int S, int H,
                   int P, int N, int ns, long long y_slice, const Strides& st,
                   cudaStream_t stream) {
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(kernel<NB>, Layout::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  const int vec = rows16(x, {st.x_b, st.x_s, st.x_h}) | rows16(Bm, {st.bm_b, st.bm_s}) << 1 |
                  rows16(Cm, {st.cm_b, st.cm_s}) << 2;
  const int nps = (P + PS - 1) / PS;
  dim3 grid(nps * ns, H, B);
  kernel<NB><<<grid, THREADS, Layout::SMEM, stream>>>(x, dt, A, Bm, Cm, h0, y, hT, S, H, P, N,
                                                      nps, y_slice, st, vec);
  return cudaGetLastError();
}

}  // namespace tf32

bool valid(int B, int S, int H, int P, int N) {
  return B > 0 && S > 0 && H > 0 && P > 0 && N > 0 && B <= 65535 && H <= 65535;
}

Strides strides_of(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9]};
}

// y = Σ_s part[s] over ns slices of n values, added in slice order (16-byte
// loads and stores where n % 4 == 0)
__global__ void __launch_bounds__(256)
sum_slices(const float* __restrict__ part, float* __restrict__ y, long long n, int ns) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n % 4 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(part);
    float4* y4 = reinterpret_cast<float4*>(y);
    const long long n4 = n / 4;
    for (long long i = first; i < n4; i += stride) {
      float4 acc = p4[i];
      for (int s = 1; s < ns; ++s) {
        const float4 v = p4[s * n4 + i];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      y4[i] = acc;
    }
    return;
  }
  for (long long i = first; i < n; i += stride) {
    float acc = part[i];
    for (int s = 1; s < ns; ++s) acc += part[s * n + i];
    y[i] = acc;
  }
}

// The scan over N's slices as the caller lays them out (kernels/ssd_scan.py
// ``n_slices``, ``slice_width``): ns slices of Ns = 64·nb columns, nb 1 to 4,
// each starting below N and all together covering it. run(nb, out, ns,
// y_slice) launches the variant's instance nb: at one slice into y, else
// into the partials (ns, B, S, H, P), n = B·S·H·P values apart, which
// sum_slices then adds into y
template <typename Run>
cudaError_t run_split(int N, int ns, int Ns, float* y, float* partial, long long n,
                      cudaStream_t stream, Run run) {
  if (ns < 1 || Ns < 64 || Ns > 256 || Ns % 64 != 0 || (long long)ns * Ns < N ||
      (long long)(ns - 1) * Ns >= N || (ns > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t e = run(Ns / 64, ns > 1 ? partial : y, ns, ns > 1 ? n : 0);
  if (e != cudaSuccess || ns == 1) return e;
  const long long units = (n % 4 == 0 ? n / 4 : n), per = 256;
  const long long blocks = (units + per - 1) / per;
  sum_slices<<<(int)(blocks < 132 * 16 ? blocks : 132 * 16), per, 0, stream>>>(partial, y, n, ns);
  return cudaGetLastError();
}

}  // namespace

// x (B,S,H,P) with its last dim contiguous; dt (B,S,H) fp32; A (H,) fp32;
// Bm, Cm (B,S,N) with their last dim contiguous; strides (in elements):
// x_b, x_s, x_h, dt_b, dt_s, dt_h, bm_b, bm_s, cm_b, cm_s. h0 (B,H,P,N) fp32
// contiguous, or null for a zero state. y (B,S,H,P) and hT (B,H,P,N): fp32,
// contiguous. ns slices of Ns columns of N (``run_split``); partial: fp32
// scratch (ns, B, S, H, P) for ns > 1, else unused (may be null). Each entry
// launches one variant on `stream` (and, above one slice, sum_slices after
// it) and returns cudaGetLastError() (cudaErrorInvalidValue for what it
// does not take).

// wgmma: bf16 x, Bm, Cm; any P and N; any strides: what a tensor map reads
// (a 16-byte aligned pointer, strides positive multiples of 8 elements) by
// TMA, the rest copied; `bf16_inputs` must be 1
extern "C" int ssd_scan_wgmma(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* h0, void* y, void* hT, void* partial,
                              int B, int S, int H, int P, int N, int ns, int Ns,
                              const long long* strides, int bf16_inputs, void* stream) {
  if (!valid(B, S, H, P, N) || !bf16_inputs) return (int)cudaErrorInvalidValue;
  const bf16 *xp = static_cast<const bf16*>(x), *bp = static_cast<const bf16*>(Bm);
  const bf16* cp = static_cast<const bf16*>(Cm);
  const float *dtp = static_cast<const float*>(dt), *ap = static_cast<const float*>(A);
  const float* h0p = static_cast<const float*>(h0);
  float* hp = static_cast<float*>(hT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s = strides_of(strides);
  return (int)run_split(N, ns, Ns, static_cast<float*>(y), static_cast<float*>(partial),
                        (long long)B * S * H * P, st,
                        [&](int nb, float* out, int ns, long long ys) {
    switch (nb) {
      case 1: return tc::launch<1>(xp, dtp, ap, bp, cp, h0p, out, hp, B, S, H, P, N, ns, ys, s, st);
      case 2: return tc::launch<2>(xp, dtp, ap, bp, cp, h0p, out, hp, B, S, H, P, N, ns, ys, s, st);
      case 3: return tc::launch<3>(xp, dtp, ap, bp, cp, h0p, out, hp, B, S, H, P, N, ns, ys, s, st);
      case 4: return tc::launch<4>(xp, dtp, ap, bp, cp, h0p, out, hp, B, S, H, P, N, ns, ys, s, st);
      default: return cudaErrorInvalidValue;
    }
  });
}

// the operands (bits 0, 1, 2: x, Bm, Cm) whose tiles ssd_scan_wgmma copies
// for these pointers and its 10 strides
extern "C" int ssd_scan_copied(const void* x, const void* Bm, const void* Cm,
                               const long long* strides) {
  return tc::copied_operands(x, Bm, Cm, strides_of(strides));
}

// tf32: fp32 x, Bm, Cm; any P and N; any strides (16-byte copies where rows
// are 16-byte aligned, 4-byte otherwise); `bf16_inputs` must be 0
extern "C" int ssd_scan_tf32(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, const void* h0, void* y, void* hT, void* partial,
                             int B, int S, int H, int P, int N, int ns, int Ns,
                             const long long* strides, int bf16_inputs, void* stream) {
  if (!valid(B, S, H, P, N) || bf16_inputs) return (int)cudaErrorInvalidValue;
  const float *xp = static_cast<const float*>(x), *bp = static_cast<const float*>(Bm);
  const float* cp = static_cast<const float*>(Cm);
  const float *dtp = static_cast<const float*>(dt), *ap = static_cast<const float*>(A);
  const float* h0p = static_cast<const float*>(h0);
  float* hp = static_cast<float*>(hT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides s = strides_of(strides);
  return (int)run_split(N, ns, Ns, static_cast<float*>(y), static_cast<float*>(partial),
                        (long long)B * S * H * P, st,
                        [&](int nb, float* out, int ns, long long ys) {
    switch (nb) {
      case 1: return tf32::launch<1>(xp, dtp, ap, bp, cp, h0p, out, hp, B, S, H, P, N, ns, ys, s, st);
      case 2: return tf32::launch<2>(xp, dtp, ap, bp, cp, h0p, out, hp, B, S, H, P, N, ns, ys, s, st);
      case 3: return tf32::launch<3>(xp, dtp, ap, bp, cp, h0p, out, hp, B, S, H, P, N, ns, ys, s, st);
      case 4: return tf32::launch<4>(xp, dtp, ap, bp, cp, h0p, out, hp, B, S, H, P, N, ns, ys, s, st);
      default: return cudaErrorInvalidValue;
    }
  });
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
