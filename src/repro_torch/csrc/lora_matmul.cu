// Fused LoRA matmul for Hopper (sm_90a):  y = x·W + scale·(x·A)·B.
//
// Replaces the TPU kernel src/repro/kernels/lora_matmul.py (_kernel,
// lora_matmul_pallas): x (M,K), W (K,N), A (K,r), B (r,N), all bf16 or all
// fp32; x·W and u = x·A accumulate in fp32 over K, u is folded into the fp32
// accumulator, and y is cast to the inputs' type once. Up to 64 ranks x is
// read once for both products and u is folded without being rounded; above
// 64 ranks (any rank, bf16 and fp32) u is computed once by a launch of its
// own, so that no output tile or slice computes it again: bf16 folds it as
// two bf16 terms h + l of scale·u on the tensor cores (relative error below
// 2^-16 of scale·u, far inside the bf16 output's rounding; kernels/lora_ref.py
// ``lora_matmul_split_ref``), fp32 as fp32 scale·u.
//
// Three variants, picked by the wrapper from the dtype, shapes and alignment
// (kernels/lora_matmul.py ``variant``), never by failure:
//
// * prefill (bf16, M > 16, any shape, rank and alignment): what bounds it
//   is bf16 tensor-core throughput (2·M·K·N operations against 2·(M·K +
//   K·N + M·N) bytes, far above the card's ~295 operations per byte). A
//   producer warp keeps TMA loads of the x, W and A tiles of the next K
//   steps in flight through a ring of up to 4
//   shared-memory stages (mbarriers signal full and empty slots). Two
//   consumer warpgroups, 64 rows of the 128-row tile each, run wgmma for x·W
//   (fp32 accumulators in registers) and, from the same staged x tile, a
//   second wgmma with n = 16 or 64 for u = x·A (A's tile is 32 or 128 bytes
//   wide, so it has its own swizzle and descriptor). The epilogue folds
//   scale·u·B on the tensor cores too: scale·u (fp32, in registers) is split
//   exactly into three bf16 terms whose sum is its value, and three
//   register-operand wgmmas add their products with the TMA-loaded B tile
//   into the fp32 accumulators, so u is never rounded. The bf16 tile goes
//   out through swizzled shared memory and TMA stores. The wrapper picks the
//   tile width (64-256) so that the grid fills the 132 SMs in few waves. TMA
//   zero-fills the ragged edges on load and clips them on store. At r % 8 !=
//   0 A's K-rows are not 16 bytes apart and no tensor map reads them: two
//   producer warps copy A's tiles instead (cp.async into staging, then each
//   8-rank chunk shifted and placed in the swizzled tile; ``atile``, COPY_A). Each
//   tile's u costs r/BN of its x·W, harmless at 16 ranks; above 64 ranks it
//   would cost up to 4x, so there a first launch writes u's two bf16 terms h
//   + l of scale·u once (M x r8 each, r8 = r rounded up to a multiple of 8,
//   zeros past r) and the second is a plain product over a longer K, [x | h
//   | l]·[W; B; B], on the same ring and consumers, its tile up to 256 wide,
//   the blocks rastered in groups of 8 row tiles so that those in flight
//   share W's tiles in L2.
// * decode (bf16, M <= 16, any shape): what bounds it is reading W
//   once from device memory (2·K·N bytes against 2·M·K·N operations). The
//   clusters split N into 64-column slices (128 above N = 2048, to halve the
//   clusters), and a cluster of up to 8 blocks splits K: about one block an
//   SM over all the clusters (the wrapper's choice, from a sweep on the
//   card), so even N = 256 keeps 32 SMs streaming and a wide N few blocks an
//   SM. A producer warp keeps TMA loads of the next K steps in flight
//   through a ring of up to 3-6 stages (mbarriers for full and empty slots;
//   no more than the block has K steps, so a short K leaves room for more
//   blocks on an SM): each stage holds 64 K-rows of the slice's W, of A (64
//   ranks wide, zero past r; copied as the prefill's at r % 8 != 0) and of x
//   (8 or 16 rows, zero past M), so shared memory does not grow with K and
//   two blocks fit on an SM at every K (48-128 KB of W in flight an SM). One
//   consumer warpgroup runs the products on the tensor cores with the
//   operands swapped: yᵀ = Wᵀ·xᵀ and uᵀ = Aᵀ·xᵀ, W's columns and A's ranks
//   as the 64-row MN-major A operand, x as the K-major B operand of n = 8 or
//   16, fp32 accumulators in registers. The blocks of a cluster add their
//   partials of x·W and u through distributed shared memory in a fixed
//   order (no atomics: the result is the same on every run), and each adds
//   scale·u·B (fp32 FMAs, B read from device memory) to its share of the
//   output. Above 64 ranks, A's tile would crowd W's out of the ring, every
//   slice's cluster would read all of A, and the epilogue's r dependent
//   loads of B would dominate, so a first launch (the same kernel, A in W's
//   place and N = r8) writes u's two bf16 terms once (its clusters' sums in
//   the same fixed order), and the second streams x and W alone (as many W
//   bytes in flight as at 64 ranks), then the fold's 2·ceil(r/64) steps, [h
//   | l]·[B; B], through the same ring and wgmmas, each step taken by one
//   block of the cluster.
//   Where a tensor map cannot read an operand (a pointer off 16 bytes, x's
//   rows at K % 8 != 0, W's, B's and the output's at N % 8 != 0), both
//   designs take it through the producers (``atile``, COPY): an issuing
//   warp cp.asyncs each row's 16-byte chunks (aligned down) into staging
//   beside the step's TMA loads, four placing warps shift each 8-element
//   chunk into the swizzled tile the wgmmas read, zeros past the edges; the
//   prefill's B tile is loaded by plain loads, an output TMA cannot write is
//   stored by plain stores, and the operands TMA can read stay on TMA.
// * fp32 (fp32 inputs, any shape, rank and alignment; the smoke configs
//   serve in fp32): TF32 alone would miss the reference's fp32 tolerance.
//   At M <= 16 (``fp32::decode_kernel``) what bounds it is reading W once
//   (4·K·N bytes): the bf16 decode's clusters (64-column slices, up to 8
//   blocks splitting K, about two blocks an SM), W's rows streamed through a
//   ring of up to 6 stages of 32 rows (by TMA where W is TMA-readable, else
//   cp.async), x and A's ranks beside it, fp32 FMAs on the CUDA cores,
//   the warps' and the cluster's partials added in a fixed order, u·B folded
//   by each block into its share. Above 16 rows, launch-bound shapes at up
//   to 16 ranks take a tiled SIMT kernel (``fp32::prefill_kernel``: 128 x
//   128 tiles, a 4-stage cp.async ring, u beside x·W from the same staged x
//   tile), since a second launch costs them more host time than the tensor
//   cores save; larger ones, every rank above 16 and every shape above 64
//   ranks (the decode's too) take two launches, u once and then the
//   product over K + r rows on the tensor cores in 3xTF32 (``fp32::tc_kernel``:
//   each operand a TF32 big and small term, three products a pair, each
//   32-row stage summed apart and added in fp32), within 1e-5 of the largest
//   output.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;
using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

namespace {

constexpr size_t SMEM_MAX = 227 * 1024;  // a block's shared memory on the H100

// Tiles that TMA cannot map are copied by producer warps: hopper.cuh's atile.
namespace atile = hopper::atile;

// How a kernel's producers fill a ring stage: TMA alone; A copied (r % 8 !=
// 0, or forced: one placing warp); or COPY, any operand copied (a pointer
// TMA cannot map, K or N % 8 != 0: NP placing warps), which ones said by
// the launch's flags, and the output stored by plain stores at OUT_PLAIN.
enum Fill { TMA_ALL = 0, COPY_A = 1, COPY = 2 };
enum CopyFlag { CP_X = 1, CP_W = 2, CP_A = 4, CP_B = 8, OUT_PLAIN = 16 };
constexpr int NP = 4;  // placing warps of COPY: x and W's boxes take four, A's one
__host__ __device__ constexpr int placers(int fill) { return fill == COPY ? NP : fill == COPY_A ? 1 : 0; }
constexpr int T64 = atile::Tile<64>::STAGING;  // a 64-row box's staging

// the operands of a launch, as matrices (copied boxes read them) and flags
struct Ops {
  atile::Mat x, w, a, b;
  bf16* y;
  int flags;
};

// ===========================================================================
// prefill: TMA + wgmma
// ===========================================================================
namespace prefill {

constexpr int BM = 128, BK = 64;
constexpr int THREADS = 288;  // warpgroups 0-1 consume (64 rows each), warp 8 produces
// + the placing warps 9, ... where tiles are copied
__host__ __device__ constexpr int threads(int fill) { return THREADS + 32 * placers(fill); }

// COPY_A: staging for A's copied rows after the stage's tiles; COPY: for x's
// two 64-row boxes, W's BN/64 and A's, at xs, ws and as
template <int BN, int RP, int FILL = TMA_ALL>
struct Layout {
  static constexpr int X_BYTES = BM * BK * 2;  // one 128-row box, 128-byte rows
  static constexpr int W_BYTES = BK * BN * 2;  // BN/64 boxes of 64 K-rows x 64 columns
  static constexpr int A_BYTES = BK * RP * 2;  // 64 K-rows x RP ranks
  static constexpr int A_SLOT = (A_BYTES + 1023) / 1024 * 1024;
  static constexpr int TILES = X_BYTES + W_BYTES + A_SLOT;
  static constexpr int A_STAGING = atile::Tile<RP>::STAGING;
  static constexpr int STAGING = FILL == COPY_A ? A_STAGING
                                 : FILL == COPY ? (2 + BN / 64) * T64 + A_STAGING : 0;
  static constexpr int STAGE = TILES + STAGING;
  static constexpr int XS = TILES, WS = XS + 2 * T64, AS = FILL == COPY ? WS + BN / 64 * T64 : TILES;
  static constexpr int B_BYTES = RP * BN * 2;  // the B tile: BN/64 boxes of RP rows x 64 columns
  static constexpr int FIXED = B_BYTES + 256 + 1024;  // + barriers + alignment slack
  static constexpr int FIT = (int)((SMEM_MAX - FIXED) / STAGE);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr size_t SMEM = FIXED + (size_t)STAGES * STAGE;
  static_assert(STAGES >= 2, "tile too large for shared memory");
  static_assert(BM * BN * 2 <= STAGES * STAGE, "the output tile reuses the stages");
  static_assert(BN % 64 == 0 && BN <= 256 && (RP == 16 || RP == 64), "unsupported tile");
  static_assert(FILL != COPY || BN <= 128, "registers: four placing warps beside 256 consumers");
};

// an accumulator fragment of a 64 x BN product (rows m0 + 64 wg of the
// tile) as bf16 by plain, predicated stores (an output TMA cannot map)
template <int BN>
__device__ __forceinline__ void store_plain(const float (&acc)[BN / 2], bf16* y, int M, int N,
                                            int m0, int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = m0 + 64 * (warp / 4) + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = row + 8 * (e / 2), n = n0 + 8 * j + 2 * (lane % 4) + e % 2;
      if (m < M && n < N) y[(size_t)m * N + n] = __float2bfloat16(acc[4 * j + e]);
    }
}

// A's matrix and the copy flags are o's; the y map is unused at OUT_PLAIN
template <int BN, int RP, int FILL>
__global__ void __launch_bounds__(threads(FILL), 1)
kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
       const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
       const __grid_constant__ CUtensorMap tm_y, int K, float scale, Ops o) {
  using L = Layout<BN, RP, FILL>;
  constexpr int STAGES = L::STAGES, NPL = placers(FILL);
  constexpr uint32_t A_SWIZZLE = RP == 16 ? 3 : 1;  // 32-byte rows : 128-byte rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~1023ull);
  unsigned char* bs = base + STAGES * L::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + L::B_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* bfull = empty + STAGES;
  uint64_t* landed = bfull + 1;  // copied tiles of a slot are in

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  const int fl = FILL == COPY ? o.flags : FILL == COPY_A ? CP_A : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1 + NPL);  // the producer's arrive + the bytes, the placers'
      hopper::mbar_init(&empty[s], 2);       // one arrive per consumer warpgroup
      if (NPL) hopper::mbar_init(&landed[s], 32);
    }
    hopper::mbar_init(bfull, FILL == COPY ? 1 + NPL : 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producers: x, W, A (and B) by TMA where they are not copied
    if (tid == 8 * 32) {
      if (!(fl & CP_X)) hopper::prefetch_tensormap(&tm_x);
      if (!(fl & CP_W)) hopper::prefetch_tensormap(&tm_w);
      if (!(fl & CP_A)) hopper::prefetch_tensormap(&tm_a);
    }
    // lane 0 of warp 8: step kt's TMA loads (the B tile, for the epilogue,
    // behind the first stage)
    auto tma = [&](int kt, unsigned char* st, uint64_t* bar) {
      hopper::mbar_arrive_expect_tx(bar, (fl & CP_X ? 0 : L::X_BYTES) +
                                             (fl & CP_W ? 0 : L::W_BYTES) +
                                             (fl & CP_A ? 0 : L::A_BYTES));
      if (!(fl & CP_X)) hopper::tma_load_2d(st, &tm_x, bar, kt * BK, m0);
      if (!(fl & CP_W))
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hopper::tma_load_2d(st + L::X_BYTES + j * BK * 128, &tm_w, bar, n0 + 64 * j, kt * BK);
      if (!(fl & CP_A)) hopper::tma_load_2d(st + L::X_BYTES + L::W_BYTES, &tm_a, bar, 0, kt * BK);
      if (kt == 0) {
        hopper::mbar_arrive_expect_tx(bfull, fl & CP_B ? 0 : L::B_BYTES);
        if (!(fl & CP_B))
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            hopper::tma_load_2d(bs + j * RP * 128, &tm_b, bfull, n0 + 64 * j, 0);
      }
    };
    if constexpr (FILL == TMA_ALL) {
      if (lane == 0)
        for (int kt = 0; kt < nk; ++kt) {
          const int s = kt % STAGES;
          hopper::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
          tma(kt, base + s * L::STAGE, &full[s]);
        }
      return;
    } else {
      // the copied boxes of step kt: x's two 64-row halves, W's 64-column
      // boxes, A's ranks
      auto boxes = [&](int kt, unsigned char* st, auto&& visit) {
        if (fl & CP_X)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            visit(atile::Box{o.x, m0 + 64 * h, kt * BK, 64, 64, st + 64 * 128 * h,
                             st + L::XS + h * T64, true});
        if (fl & CP_W)
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            visit(atile::Box{o.w, kt * BK, n0 + 64 * j, 64, 64, st + L::X_BYTES + j * BK * 128,
                             st + L::WS + j * T64, false});
        if (fl & CP_A)
          visit(atile::Box{o.a, kt * BK, 0, 64, RP, st + L::X_BYTES + L::W_BYTES, st + L::AS,
                           false});
      };
      if (FILL == COPY && warp > 8) {  // the placers load a copied B first, then arrive
        if (fl & CP_B) {
          atile::load_b(bs, o.b, RP, n0, BN / 64, tid - 9 * 32, NPL * 32);
          hopper::fence_proxy_async();
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(bfull);
      }
      atile::producer(warp - 9, NPL, base, L::STAGE, STAGES, full, empty, landed, nk, tma, boxes);
      return;
    }
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4;
  float acc[BN / 2], uacc[RP / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < RP / 2; ++i) uacc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
    unsigned char* st = base + s * L::STAGE;
    // x: K-major, 128-byte rows; W and A: MN-major (N contiguous), groups
    // of 8 K-rows 1024 (W) or 8·2·RP (A) bytes apart, W's 64-column blocks
    // BK·128 bytes apart
    const uint64_t dx = hopper::make_desc(st + wg * 64 * BK * 2, 16, 1024, 1);
    const uint64_t dw = hopper::make_desc(st + L::X_BYTES, BK * 128, 1024, 1);
    const uint64_t da = hopper::make_desc(st + L::X_BYTES + L::W_BYTES, L::A_BYTES, 16 * RP,
                                          A_SWIZZLE);
    hopper::fence_operand(acc);
    hopper::fence_operand(uacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dxk = hopper::desc_add(dx, kk * 32);
      hopper::wgmma_ss<1>(acc, dxk, hopper::desc_add(dw, kk * 16 * 128));
      hopper::wgmma_ss<1>(uacc, dxk, hopper::desc_add(da, kk * 16 * RP * 2));
    }
    hopper::wgmma_commit();
    hopper::fence_operand(acc);
    hopper::fence_operand(uacc);
    hopper::wgmma_wait<1>();  // the previous stage's products are done: free its slot
    if (kt > 0 && tid % 128 == 0) hopper::mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operand(acc);
  hopper::fence_operand(uacc);

  // fold: acc += (scale·u)·B on the tensor cores. Each fp32 value of
  // scale·u is split into three bf16 terms h + m + l that sum to it exactly
  // (8 significant bits each); u's accumulator fragment is the register
  // layout of the A operand, 16 ranks per k-step.
  hopper::mbar_wait(bfull, 0);
  // B: MN-major, 128-byte rows; 64-column blocks RP·128 bytes apart
  const uint64_t db = hopper::make_desc(bs, RP * 128, 1024, 1);
#pragma unroll
  for (int t = 0; t < 3; ++t) {  // h, then m, then l
    uint32_t ua[RP / 16][4];
#pragma unroll
    for (int kk = 0; kk < RP / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float term[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float v = scale * uacc[8 * kk + 2 * e + i];
          const float h = __bfloat162float(__float2bfloat16_rn(v));
          const float m = __bfloat162float(__float2bfloat16_rn(v - h));
          term[i] = t == 0 ? h : t == 1 ? m : v - h - m;
        }
        ua[kk][e] = hopper::pack_bf16(term[0], term[1]);
      }
    hopper::fence_operand(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < RP / 16; ++kk)
      hopper::wgmma_rs<1>(acc, ua[kk], hopper::desc_add(db, kk * 16 * 128));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();  // the next term overwrites the A registers
    hopper::fence_operand(acc);
  }

  if (FILL == COPY && (fl & OUT_PLAIN)) {
    store_plain<BN>(acc, o.y, o.x.rows, o.w.cols, m0, n0);
    return;
  }
  // store: bf16 into 64 x 64 boxes of 128-byte swizzled rows (the stages are
  // free once both warpgroups are done), then one TMA store per box
  hopper::named_sync(1, 256);
  const int q = lane % 4, row = (warp % 4) * 16 + lane / 4;  // and row + 8
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    unsigned char* box = base + (wg * (BN / 64) + j / 8) * 8192;
    const int chunk = ((j % 8) ^ (row % 8)) * 16 + 4 * q;
    *reinterpret_cast<uint32_t*>(box + row * 128 + chunk) =
        hopper::pack_bf16(acc[4 * j + 0], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(box + (row + 8) * 128 + chunk) =
        hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  hopper::fence_proxy_async();
  hopper::named_sync(2 + wg, 128);
  if (tid % 128 == 0) {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      hopper::tma_store_2d(&tm_y, base + (wg * (BN / 64) + j) * 8192, n0 + 64 * j, m0 + 64 * wg);
    hopper::tma_store_commit_and_wait();
  }
}

// ---------------------------------------------------------------------------
// above 64 ranks: two launches. The first (u_kernel) computes u = x·A once
// for every 128-row tile, 64 ranks a block, and writes scale·u as two bf16
// terms h + l (h = bf16(scale·u),
// l = bf16(scale·u − h): 16 significant bits, a relative error below 2^-16)
// into u (2, M, r). The second (wide_kernel) is a plain product over a
// longer K: y = [x | h | l]·[W; B; B], nk K steps of x and W, then
// 2·ceil(r/64) steps of 64 ranks each of h and l, with B's rows of those
// ranks in W's slot (TMA zero-fills the ranks past r). Nothing is computed
// twice, and the accumulators hold the output tile alone, so the tile takes
// the full 256 columns.
// ---------------------------------------------------------------------------

constexpr int GROUP_M = 8;  // row tiles of a raster group: a wave reads W's column tiles once

// STAGING: bytes of a stage after x's and W's slots where copied boxes are
// staged: x's two 64-row halves at xs, then W's (or A's, or B's) boxes
template <int BN, int STAGING = 0>
struct WideLayout {
  static constexpr int X_BYTES = BM * BK * 2;  // a box of x, or of 64 ranks of h or l
  static constexpr int W_BYTES = BK * BN * 2;  // BN/64 boxes of W, A or B: 64 rows x 64 columns
  static constexpr int STAGE = X_BYTES + W_BYTES + STAGING;
  static constexpr int XS = X_BYTES + W_BYTES;
  static constexpr int FIXED = 256 + 1024;  // barriers + alignment slack
  static constexpr int FIT = (int)((SMEM_MAX - FIXED) / STAGE);
  static constexpr int STAGES = FIT < 8 ? FIT : 8;  // one block an SM: as many as fit
  static constexpr size_t SMEM = FIXED + (size_t)STAGES * STAGE;
  static_assert(STAGES >= 2 && BN % 64 == 0 && BN <= 256, "unsupported tile");
  static_assert(BM * BN * 2 <= STAGES * STAGE, "the output tile reuses the stages");
};
// the staging a FILL needs: COPY_A A's box (into W's slot), COPY x's two
// halves and `boxes` 64-column boxes of W's slot
__host__ __device__ constexpr int wide_staging(int fill, int boxes) {
  return fill == COPY_A ? T64 : fill == COPY ? (2 + boxes) * T64 : 0;
}

// The K loop of both launches: a producer warp (8) streams `steps` stages
// through load(step, slot, bar) (which arrives on bar expecting the step's
// TMA bytes), the placing warps (9, ...) place boxes(step, slot, visit)'s
// copied boxes, two consumer warpgroups accumulate 64 rows each of
// x-slot·W-slot into acc. The first product overwrites the accumulators
// (scale_d = 0) instead of a zeroing, which would make ptxas serialize the
// wgmmas (C7515); acc is left undefined when steps is 0.
template <int BN, int FILL, int STAGING, typename Load, typename Boxes>
__device__ __forceinline__ void wide_loop(unsigned char* base, uint64_t* full, uint64_t* empty,
                                          int steps, Load load, Boxes boxes, float (&acc)[BN / 2]) {
  using L = WideLayout<BN, STAGING>;
  constexpr int STAGES = L::STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (warp >= 8 && FILL != TMA_ALL) {  // producers: TMA where not copied, the copied boxes placed
    atile::producer(warp - 9, placers(FILL), base, L::STAGE, STAGES, full, empty, empty + STAGES,
                    steps, load, boxes);
    return;
  }
  if (warp == 8) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < steps; ++kt) {
        const int s = kt % STAGES;
        hopper::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        load(kt, base + s * L::STAGE, &full[s]);
      }
    }
    return;
  }
  const int wg = warp / 4;  // rows [64 wg, 64 wg + 64) of the tile
  for (int kt = 0; kt < steps; ++kt) {
    const int s = kt % STAGES;
    hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
    unsigned char* st = base + s * L::STAGE;
    // the x slot: K-major, 128-byte rows; the W slot: MN-major, groups of 8
    // K-rows 1024 bytes apart, 64-column blocks BK·128 bytes apart
    const uint64_t dx = hopper::make_desc(st + wg * 64 * BK * 2, 16, 1024, 1);
    const uint64_t dw = hopper::make_desc(st + L::X_BYTES, BK * 128, 1024, 1);
    hopper::fence_operand(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_ss<1>(acc, hopper::desc_add(dx, kk * 32), hopper::desc_add(dw, kk * 16 * 128),
                          kt > 0 || kk > 0);
    hopper::wgmma_commit();
    hopper::fence_operand(acc);
    hopper::wgmma_wait<1>();  // the previous stage's products are done: free its slot
    if (kt > 0 && tid % 128 == 0) hopper::mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operand(acc);
}

// np placing warps: the full barriers also expect their arrives, and
// `landed` barriers follow the empty ones
template <int STAGES>
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, int np = 0) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's arrive + the bytes (and the placing warps' arrives)
      hopper::mbar_init(&full[s], 1 + np);
      if (np) hopper::mbar_init(&empty[STAGES + s], 32);
      hopper::mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// x's two 64-row halves at rows m0, m0 + 64, columns k0 of the x slot (COPY)
template <typename Visit>
__device__ __forceinline__ void x_boxes(const atile::Mat& x, int m0, int k0, unsigned char* st,
                                        int xs, Visit&& visit) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    visit(atile::Box{x, m0 + 64 * h, k0, 64, 64, st + 64 * 128 * h, st + xs + h * T64, true});
}

// y = [x | h | l]·[W; B; B] into tm_y (tm_u: u (2, M, r), boxes of 64 ranks
// x 128 rows). The grid is one-dimensional: groups of GROUP_M row tiles,
// column tiles outermost within a group, so that the blocks in flight share
// W's tiles. FILL: TMA_ALL or COPY (o's flags: x, W and B copied, the
// output by plain stores).
template <int BN, int FILL>
__global__ void __launch_bounds__(threads(FILL), 1)
wide_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
            const __grid_constant__ CUtensorMap tm_u, const __grid_constant__ CUtensorMap tm_b,
            const __grid_constant__ CUtensorMap tm_y, int K, int r, int num_m, int num_n, Ops o) {
  constexpr int STAGING = wide_staging(FILL, BN / 64);
  using L = WideLayout<BN, STAGING>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~1023ull);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::STAGES * L::STAGE);
  uint64_t* empty = full + L::STAGES;
  const int per_group = GROUP_M * num_n, first = blockIdx.x / per_group * GROUP_M;
  const int rows = min(num_m - first, GROUP_M), in_group = blockIdx.x % per_group;
  const int m0 = (first + in_group % rows) * BM, n0 = in_group / rows * BN;
  const int nk = (K + BK - 1) / BK, nc = (r + BK - 1) / BK;
  const int fl = FILL == COPY ? o.flags : 0;
  init_barriers<L::STAGES>(full, empty, placers(FILL));
  if (threadIdx.x == 8 * 32) {
    if (!(fl & CP_X)) hopper::prefetch_tensormap(&tm_x);
    if (!(fl & CP_W)) hopper::prefetch_tensormap(&tm_w);
    hopper::prefetch_tensormap(&tm_u);
    if (!(fl & CP_B)) hopper::prefetch_tensormap(&tm_b);
  }
  float acc[BN / 2];
  auto load = [&](int kt, unsigned char* st, uint64_t* bar) {
    if (kt < nk) {
      hopper::mbar_arrive_expect_tx(bar, (fl & CP_X ? 0 : L::X_BYTES) + (fl & CP_W ? 0 : L::W_BYTES));
      if (!(fl & CP_X)) hopper::tma_load_2d(st, &tm_x, bar, kt * BK, m0);
      if (!(fl & CP_W))
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hopper::tma_load_2d(st + L::X_BYTES + j * BK * 128, &tm_w, bar, n0 + 64 * j, kt * BK);
    } else {  // ranks c·64 + [0, 64) of term t (h, then l) and B's rows of them
      const int t = (kt - nk) / nc, c = (kt - nk) % nc;
      hopper::mbar_arrive_expect_tx(bar, L::X_BYTES + (fl & CP_B ? 0 : L::W_BYTES));
      hopper::tma_load_3d(st, &tm_u, bar, c * BK, m0, t);
      if (!(fl & CP_B))
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hopper::tma_load_2d(st + L::X_BYTES + j * BK * 128, &tm_b, bar, n0 + 64 * j, c * BK);
    }
  };
  auto boxes = [&](int kt, unsigned char* st, auto&& visit) {
    const atile::Mat& wb = kt < nk ? o.w : o.b;
    const int copied = kt < nk ? fl & CP_W : fl & CP_B, k0 = (kt < nk ? kt : (kt - nk) % nc) * BK;
    if (kt < nk && (fl & CP_X)) x_boxes(o.x, m0, k0, st, L::XS, visit);
    if (copied)
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        visit(atile::Box{wb, k0, n0 + 64 * j, 64, 64, st + L::X_BYTES + j * BK * 128,
                         st + L::XS + (2 + j) * T64, kt >= nk});
  };
  wide_loop<BN, FILL, STAGING>(base, full, empty, nk + 2 * nc, load, boxes, acc);
  if (threadIdx.x >= 8 * 32) return;  // the producers

  if (FILL == COPY && (fl & OUT_PLAIN)) {
    store_plain<BN>(acc, o.y, o.x.rows, o.w.cols, m0, n0);
    return;
  }
  // store: as the prefill kernel's
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wg = warp / 4;
  const int q = lane % 4, row = (warp % 4) * 16 + lane / 4;  // and row + 8
  hopper::named_sync(1, 256);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    unsigned char* box = base + (wg * (BN / 64) + j / 8) * 8192;
    const int chunk = ((j % 8) ^ (row % 8)) * 16 + 4 * q;
    *reinterpret_cast<uint32_t*>(box + row * 128 + chunk) =
        hopper::pack_bf16(acc[4 * j + 0], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(box + (row + 8) * 128 + chunk) =
        hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  hopper::fence_proxy_async();
  hopper::named_sync(2 + wg, 128);
  if (tid % 128 == 0) {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      hopper::tma_store_2d(&tm_y, base + (wg * (BN / 64) + j) * 8192, n0 + 64 * j, m0 + 64 * wg);
    hopper::tma_store_commit_and_wait();
  }
}

// u = x·A for the 128-row tile blockIdx.y and the 64 ranks blockIdx.x·64 +
// [0, 64), written from the accumulators as the terms of scale·u, two
// adjacent ranks a store, into u (2, M, r8): r8 = r rounded up to a multiple
// of 8, so that the product's tensor map can read it (the ranks past r come
// out as zeros). FILL: COPY_A (A's rows not 16 bytes apart: A's tiles
// copied into W's slot) or COPY (o's flags: x, A copied).
template <int FILL>
__global__ void __launch_bounds__(threads(FILL), 1)
u_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_a,
         bf16* __restrict__ u, int M, int K, int r, float scale, Ops o) {
  constexpr int STAGING = wide_staging(FILL, 1);
  using L = WideLayout<64, STAGING>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~1023ull);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::STAGES * L::STAGE);
  uint64_t* empty = full + L::STAGES;
  const int m0 = blockIdx.y * BM, c0 = blockIdx.x * 64, r8 = (r + 7) / 8 * 8;
  const int fl = FILL == COPY ? o.flags : FILL == COPY_A ? CP_A : 0;
  init_barriers<L::STAGES>(full, empty, placers(FILL));
  if (threadIdx.x == 8 * 32) {
    if (!(fl & CP_X)) hopper::prefetch_tensormap(&tm_x);
    if (!(fl & CP_A)) hopper::prefetch_tensormap(&tm_a);
  }
  float acc[32];
  wide_loop<64, FILL, STAGING>(
      base, full, empty, (K + BK - 1) / BK,
      [&](int kt, unsigned char* st, uint64_t* bar) {
        hopper::mbar_arrive_expect_tx(bar, (fl & CP_X ? 0 : L::X_BYTES) + (fl & CP_A ? 0 : L::W_BYTES));
        if (!(fl & CP_X)) hopper::tma_load_2d(st, &tm_x, bar, kt * BK, m0);
        if (!(fl & CP_A)) hopper::tma_load_2d(st + L::X_BYTES, &tm_a, bar, c0, kt * BK);
      },
      [&](int kt, unsigned char* st, auto&& visit) {
        if (fl & CP_X) x_boxes(o.x, m0, kt * BK, st, L::XS, visit);
        if (fl & CP_A)
          visit(atile::Box{o.a, kt * BK, c0, 64, 64, st + L::X_BYTES,
                           st + L::XS + (FILL == COPY ? 2 * T64 : 0), false});
      },
      acc);
  if (threadIdx.x >= 8 * 32) return;  // the producers
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = m0 + (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;  // and row + 8
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = c0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = row + 8 * i;
      if (m < M && col < r8) {
        const float vx = scale * acc[4 * j + 2 * i], vy = scale * acc[4 * j + 2 * i + 1];
        const float hx = __bfloat162float(__float2bfloat16_rn(vx));
        const float hy = __bfloat162float(__float2bfloat16_rn(vy));
        bf16* dst = u + (size_t)m * r8 + col;
        *reinterpret_cast<uint32_t*>(dst) = hopper::pack_bf16(hx, hy);
        *reinterpret_cast<uint32_t*>(dst + (size_t)M * r8) = hopper::pack_bf16(vx - hx, vy - hy);
      }
    }
  }
}

// u's terms (2, M, r8) of scale·x·A: tiles of 128 rows x 64 ranks
template <int FILL>
cudaError_t u_launch(const Ops& o, bf16* u, float scale, cudaStream_t stream) {
  using L = WideLayout<64, wide_staging(FILL, 1)>;
  const int M = o.x.rows, K = o.x.cols, r = o.a.cols;
  const int fl = FILL == COPY ? o.flags : FILL == COPY_A ? CP_A : 0;
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(u_kernel<FILL>, L::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap tx = {}, ta = {};
  const uint64_t xs[2] = {(uint64_t)K, (uint64_t)M}, xst[1] = {(uint64_t)K * 2};
  const uint64_t as[2] = {(uint64_t)r, (uint64_t)K}, ast[1] = {(uint64_t)r * 2};
  const uint32_t xb[2] = {BK, BM}, ab[2] = {64, BK};
  if (!(fl & CP_X) && (e = hopper::make_tensor_map(&tx, o.x.p, 2, xs, xst, xb, 128)) != cudaSuccess)
    return e;
  if (!(fl & CP_A) && (e = hopper::make_tensor_map(&ta, o.a.p, 2, as, ast, ab, 128)) != cudaSuccess)
    return e;
  dim3 grid((r + 63) / 64, (M + BM - 1) / BM);
  u_kernel<FILL><<<grid, threads(FILL), L::SMEM, stream>>>(tx, ta, u, M, K, r, scale, o);
  return cudaGetLastError();
}

// y = [x | h | l]·[W; B; B], u: the terms (2, M, r8); B's map has r rows
// (TMA zero-fills the ranks past r)
template <int BN, int FILL>
cudaError_t wide_launch(const Ops& o, const bf16* u, cudaStream_t stream) {
  using L = WideLayout<BN, wide_staging(FILL, BN / 64)>;
  const int M = o.x.rows, K = o.x.cols, N = o.w.cols, r = o.a.cols;
  const int fl = FILL == COPY ? o.flags : 0;
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(wide_kernel<BN, FILL>, L::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap tx = {}, tw = {}, tu, tb = {}, ty = {};
  const uint64_t r8 = (uint64_t)(r + 7) / 8 * 8;
  const uint64_t xs[2] = {(uint64_t)K, (uint64_t)M}, xst[1] = {(uint64_t)K * 2};
  const uint64_t ws[2] = {(uint64_t)N, (uint64_t)K}, wst[1] = {(uint64_t)N * 2};
  const uint64_t us[3] = {r8, (uint64_t)M, 2};
  const uint64_t ust[2] = {r8 * 2, (uint64_t)M * r8 * 2};
  const uint64_t bsz[2] = {(uint64_t)N, (uint64_t)r}, ys[2] = {(uint64_t)N, (uint64_t)M};
  const uint32_t xb[2] = {BK, BM}, wb[2] = {64, BK}, ub[3] = {BK, BM, 1}, yb[2] = {64, 64};
  if (!(fl & CP_X) && (e = hopper::make_tensor_map(&tx, o.x.p, 2, xs, xst, xb, 128)) != cudaSuccess)
    return e;
  if (!(fl & CP_W) && (e = hopper::make_tensor_map(&tw, o.w.p, 2, ws, wst, wb, 128)) != cudaSuccess)
    return e;
  if ((e = hopper::make_tensor_map(&tu, u, 3, us, ust, ub, 128)) != cudaSuccess) return e;
  if (!(fl & CP_B) && (e = hopper::make_tensor_map(&tb, o.b.p, 2, bsz, wst, wb, 128)) != cudaSuccess)
    return e;
  if (!(fl & OUT_PLAIN) && (e = hopper::make_tensor_map(&ty, o.y, 2, ys, wst, yb, 128)) != cudaSuccess)
    return e;
  const int num_m = (M + BM - 1) / BM, num_n = (N + BN - 1) / BN;
  wide_kernel<BN, FILL><<<num_m * num_n, threads(FILL), L::SMEM, stream>>>(tx, tw, tu, tb, ty, K, r,
                                                                          num_m, num_n, o);
  return cudaGetLastError();
}

template <int BN, int RP, int FILL>
cudaError_t launch(const Ops& o, float scale, cudaStream_t stream) {
  using L = Layout<BN, RP, FILL>;
  const int M = o.x.rows, K = o.x.cols, N = o.w.cols, r = o.a.cols;
  const int fl = FILL == COPY ? o.flags : FILL == COPY_A ? CP_A : 0;
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(kernel<BN, RP, FILL>, L::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap tx = {}, tw = {}, ta = {}, tb = {}, ty = {};
  const uint64_t xs[2] = {(uint64_t)K, (uint64_t)M}, xst[1] = {(uint64_t)K * 2};
  const uint64_t ws[2] = {(uint64_t)N, (uint64_t)K}, wst[1] = {(uint64_t)N * 2};
  const uint64_t as[2] = {(uint64_t)r, (uint64_t)K}, ast[1] = {(uint64_t)r * 2};
  const uint64_t bsz[2] = {(uint64_t)N, (uint64_t)r}, ys[2] = {(uint64_t)N, (uint64_t)M};
  const uint32_t xb[2] = {BK, BM}, wb[2] = {64, BK}, ab[2] = {RP, BK}, bb[2] = {64, RP};
  const uint32_t yb[2] = {64, 64};
  if (!(fl & CP_X) && (e = hopper::make_tensor_map(&tx, o.x.p, 2, xs, xst, xb, 128)) != cudaSuccess)
    return e;
  if (!(fl & CP_W) && (e = hopper::make_tensor_map(&tw, o.w.p, 2, ws, wst, wb, 128)) != cudaSuccess)
    return e;
  if (!(fl & CP_A) &&
      (e = hopper::make_tensor_map(&ta, o.a.p, 2, as, ast, ab, RP * 2)) != cudaSuccess)
    return e;
  if (!(fl & CP_B) && (e = hopper::make_tensor_map(&tb, o.b.p, 2, bsz, wst, bb, 128)) != cudaSuccess)
    return e;
  if (!(fl & OUT_PLAIN) && (e = hopper::make_tensor_map(&ty, o.y, 2, ys, wst, yb, 128)) != cudaSuccess)
    return e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<BN, RP, FILL><<<grid, threads(FILL), L::SMEM, stream>>>(tx, tw, ta, tb, ty, K, scale, o);
  return cudaGetLastError();
}

// the fused product at r <= 64: RP = 16 or 64 ranks, tile width bn (at
// most 128 under COPY)
template <int FILL>
cudaError_t fused(const Ops& o, float scale, int bn, cudaStream_t st) {
  if (o.a.cols <= 16) {
    switch (bn) {
      case 64: return launch<64, 16, FILL>(o, scale, st);
      case 128: return launch<128, 16, FILL>(o, scale, st);
      case 192: if constexpr (FILL != COPY) return launch<192, 16, FILL>(o, scale, st); break;
      case 256: if constexpr (FILL != COPY) return launch<256, 16, FILL>(o, scale, st); break;
    }
  } else {
    switch (bn) {
      case 64: return launch<64, 64, FILL>(o, scale, st);
      case 128: return launch<128, 64, FILL>(o, scale, st);
      case 192: if constexpr (FILL != COPY) return launch<192, 64, FILL>(o, scale, st); break;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace prefill

// ===========================================================================
// decode: a cluster of up to 8 blocks splits K; TMA ring, swapped wgmma
// ===========================================================================
namespace decode {

constexpr int MAX_SPLIT = 8;   // blocks of a cluster (portable); block `rank` takes K rows rank·kc + [0, kc)
constexpr int BK = 64;         // K rows of a ring slot
constexpr int RANKS = 64;      // the A tile's columns: ranks past r arrive as zeros
constexpr int THREADS = 160;   // warpgroup 0 consumes, warp 4 produces
// + the placing warps 5, ... where tiles are copied
__host__ __device__ constexpr int threads(int fill) { return THREADS + 32 * placers(fill); }
constexpr int MAX_STAGES = 6;
constexpr size_t SM_SMEM = 233472;  // an SM's shared memory; each block also reserves 1 KB

// FUSED (r <= 64, one launch): A's tile rides in the ring beside W's, u =
// x·A beside x·W, the fold (fp32 FMAs) in the epilogue. Above 64 ranks A's
// tile would crowd W out of the ring, every slice of N would read all of A,
// and the epilogue's r dependent loads of B a output would dominate, so two
// launches. UPASS computes u = x·A once (A in W's place, N = r) and writes
// the two bf16 terms h + l of scale·u (as the prefill's) into u (2, M, r);
// UFOLD streams x and W, then the fold's 2·ceil(r/64) steps on the tensor
// cores, [h | l]·[B; B] with the terms in x's slot and B's rows in W's,
// each step taken by one block of the cluster (the last blocks first: they
// have the fewest K rows).
// At r % 8 != 0 (COPY_A) the producer warp copies A's tiles (atile): FUSED's
// into the A slot, UPASS's into W's; UPASS then writes u's terms at r8 = r
// rounded up to a multiple of 8 ranks a row (zeros past r), which UFOLD's
// map reads. Under COPY (o's flags) x's, A's, W's and B's tiles are copied
// where TMA cannot map them, one block an SM (the staging leaves no room
// for two).
enum Mode { FUSED, UPASS, UFOLD };

// MT: rows of x padded to 8 or 16 (the n of the wgmmas); BN: columns of a
// cluster's slice (64 or 128: the wider slice halves the clusters of a wide N)
template <int MT, int BN, int MODE, int FILL = TMA_ALL>
struct Layout {
  static constexpr int X_BYTES = MT * BK * 2;     // x (or a term): MT rows of 64 K-columns, 128-byte rows
  static constexpr int A_BYTES = MODE == FUSED ? BK * RANKS * 2 : 0;  // A: 64 K-rows of 64 ranks
  static constexpr int W_BYTES = BK * BN * 2;     // W (or B): BN/64 boxes of 64 K-rows x 64 columns
  static constexpr int TILES = X_BYTES + A_BYTES + W_BYTES;  // every part 1024-aligned
  // staging: COPY_A A's copied rows; COPY x's rows (at xs), A's (as) and
  // W's or B's boxes (ws)
  static constexpr int X_STAGING = (MT * atile::Tile<64>::SROW + 1023) / 1024 * 1024;
  static constexpr int XS = TILES, AS = FILL == COPY ? XS + X_STAGING : TILES;
  static constexpr int WS = AS + (MODE == UFOLD ? 0 : T64);
  static constexpr int STAGING = FILL == COPY_A ? T64 : FILL == COPY ? WS + BN / 64 * T64 - TILES : 0;
  static constexpr int STAGE = TILES + STAGING;
  // the block's partial of u and the whole u (fp32; FUSED only)
  static constexpr int U_BYTES = MODE == FUSED ? 2 * MT * RANKS * 4 : 0;
  // the slice's partial of x·W, u's, the barriers and the alignment slack
  static constexpr int FIXED = 1024 + MT * BN * 4 + U_BYTES + 256;
  // at most as many stages as leave room for two blocks an SM (one under
  // COPY), at most MAX_STAGES; a block whose K slice is shorter takes one
  // per K step
  static constexpr int MINB = FILL == COPY ? 1 : 2;
  static constexpr int FIT = (int)((SM_SMEM / MINB - 1024 - FIXED) / STAGE);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  // a block's shared memory (mirrored by kernels/lora_matmul.py ``decode_smem_bytes``)
  static constexpr size_t smem(int stages) { return FIXED + (size_t)stages * STAGE; }
  static_assert(STAGES >= 2 && X_BYTES % 1024 == 0, "unsupported tile");
};

// yᵀ = Wᵀ·xᵀ and uᵀ = Aᵀ·xᵀ on the tensor cores, swapped so that the 64-row
// side of the wgmma is W's columns (and A's ranks), not x's few rows: per
// K step, W's and A's tiles are MN-major A operands (their columns
// contiguous) and x's tile is the K-major B operand of n = MT. tm_w: W's
// map (A's at UPASS); tm_a: A's map (FUSED), the terms' (UFOLD: u (2, M,
// r), boxes of 64 ranks x MT rows); y: the output, or u's terms (UPASS: 2 x
// M x N with N = r, or r8 where A is copied). o: the operands as matrices
// (A's at UPASS in w) and, under COPY, which are copied.
template <int MT, int BN, int MODE, int FILL>
__global__ void __launch_bounds__(threads(FILL), Layout<MT, BN, MODE, FILL>::MINB)
kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
       const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
       const bf16* __restrict__ b, bf16* __restrict__ y, int M, int K, int N, int r, int kc,
       int stages, float scale, Ops o) {
  using L = Layout<MT, BN, MODE, FILL>;
  constexpr int NB = BN / 64, NT = threads(FILL), NPL = placers(FILL);
  constexpr bool RING_A = MODE == FUSED;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~1023ull);
  float* part = reinterpret_cast<float*>(base + stages * L::STAGE);  // MT x BN
  float* upart = part + MT * BN;                                      // MT x RANKS (FUSED)
  float* ufull = upart + MT * RANKS;                                  // MT x RANKS (FUSED)
  uint64_t* full = reinterpret_cast<uint64_t*>(part + MT * BN + L::U_BYTES / 4);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = (int)cluster.block_rank(), nc = (int)cluster.num_blocks();
  const int n0 = blockIdx.y * BN;
  const int kbeg = rank * kc, kend = min(K, kbeg + kc);  // kc: a multiple of BK
  const int nkt = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  // UFOLD: fold steps f = nc - 1 - rank + i·nc of the 2·ceil(r/64)
  const int nr = (r + BK - 1) / BK, f0 = nc - 1 - rank;
  const int nf = MODE == UFOLD && f0 < 2 * nr ? (2 * nr - 1 - f0) / nc + 1 : 0;
  // the copied operands (UPASS: A's tiles in W's slot, flagged as A's)
  const int fl = FILL == COPY ? o.flags : FILL == COPY_A ? CP_A : 0;
  const bool w_tma = MODE == UPASS ? !(fl & CP_A) : !(fl & CP_W);

  uint64_t* landed = empty + stages;  // the copied tiles of a slot are in
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // the producer's arrive + the bytes (and the placing warps' arrives)
      hopper::mbar_init(&full[s], 1 + NPL);
      hopper::mbar_init(&empty[s], 1);  // the consumer warpgroup's arrive
      if (NPL) hopper::mbar_init(&landed[s], 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4) {  // producers: the tiles of step t into slot s = t % stages
    if (tid == 4 * 32) {
      if (!(fl & CP_X)) hopper::prefetch_tensormap(&tm_x);
      if (w_tma) hopper::prefetch_tensormap(&tm_w);
      if (MODE == FUSED && !(fl & CP_A)) hopper::prefetch_tensormap(&tm_a);
      if (MODE == UFOLD) hopper::prefetch_tensormap(&tm_a);
      if (MODE == UFOLD && !(fl & CP_B)) hopper::prefetch_tensormap(&tm_b);
    }
    auto tma = [&](int t, unsigned char* st, uint64_t* bar) {
      unsigned char* ws = st + L::X_BYTES + L::A_BYTES;
      if (t < nkt) {  // x, A and W at K rows k + [0, 64)
        const int k = kbeg + t * BK;
        const bool a_tma = RING_A && !(fl & CP_A);
        hopper::mbar_arrive_expect_tx(bar, (fl & CP_X ? 0 : L::X_BYTES) + (a_tma ? L::A_BYTES : 0) +
                                               (w_tma ? L::W_BYTES : 0));
        if (!(fl & CP_X)) hopper::tma_load_2d(st, &tm_x, bar, k, 0);
        if (a_tma) hopper::tma_load_2d(st + L::X_BYTES, &tm_a, bar, 0, k);
        if (w_tma)
#pragma unroll
          for (int j = 0; j < NB; ++j) hopper::tma_load_2d(ws + j * BK * 128, &tm_w, bar, n0 + 64 * j, k);
      } else {  // fold step f: ranks c·64 + [0, 64) of term h or l, and B's rows of them
        const int f = f0 + (t - nkt) * nc, c = f % nr;
        hopper::mbar_arrive_expect_tx(bar, L::X_BYTES + (fl & CP_B ? 0 : L::W_BYTES));
        hopper::tma_load_3d(st, &tm_a, bar, c * BK, 0, f / nr);
        if (!(fl & CP_B))
#pragma unroll
          for (int j = 0; j < NB; ++j)
            hopper::tma_load_2d(ws + j * BK * 128, &tm_b, bar, n0 + 64 * j, c * BK);
      }
    };
    if constexpr (FILL == TMA_ALL) {
      if (lane == 0)
        for (int t = 0, s = 0, phase = 0; t < nkt + nf; ++t) {
          hopper::mbar_wait(&empty[s], phase ^ 1);
          tma(t, base + s * L::STAGE, &full[s]);
          if (++s == stages) s = 0, phase ^= 1;
        }
    } else {
      // the copied boxes of step t: x's MT rows, A's 64 ranks (FUSED: from
      // rank 0 into the A slot; UPASS: from rank n0 into W's), W's (or a
      // fold step's B rows') 64-column boxes
      auto boxes = [&](int t, unsigned char* st, auto&& visit) {
        unsigned char* ws = st + L::X_BYTES + L::A_BYTES;
        if (t < nkt) {
          const int k = kbeg + t * BK;
          if (fl & CP_X) visit(atile::Box{o.x, 0, k, MT, 64, st, st + L::XS, true});
          if (MODE != UFOLD && (fl & CP_A))
            visit(atile::Box{MODE == UPASS ? o.w : o.a, k, MODE == UPASS ? n0 : 0, BK, 64,
                             MODE == UPASS ? ws : st + L::X_BYTES, st + L::AS, false});
          if (MODE != UPASS && (fl & CP_W))
#pragma unroll
            for (int j = 0; j < NB; ++j)
              visit(atile::Box{o.w, k, n0 + 64 * j, BK, 64, ws + j * BK * 128,
                               st + L::WS + j * T64, false});
        } else if (fl & CP_B) {
          const int c = (f0 + (t - nkt) * nc) % nr;
#pragma unroll
          for (int j = 0; j < NB; ++j)
            visit(atile::Box{o.b, c * BK, n0 + 64 * j, BK, 64, ws + j * BK * 128,
                             st + L::WS + j * T64, true});
        }
      };
      atile::producer(warp - 5, NPL, base, L::STAGE, stages, full, empty, landed, nkt + nf, tma,
                      boxes);
    }
  } else {
    // consumer warpgroup: thread (warp w, lane l) holds rows 16w + l/4 + {0, 8}
    // of each 64-row product (W's columns, A's ranks) at x's rows 8j + 2(l%4) + {0, 1}
    float acc[NB][MT / 2], uacc[MT / 2];
#pragma unroll
    for (int e = 0; e < MT / 2; ++e) {
      uacc[e] = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[j][e] = 0.f;
    }
    for (int t = 0, s = 0, phase = 0, prev = 0; t < nkt + nf; ++t) {
      hopper::mbar_wait(&full[s], phase);
      unsigned char* st = base + s * L::STAGE;
      // x: K-major, 128-byte rows; A and W: MN-major, 128-byte rows, groups
      // of 8 K-rows 1024 bytes apart (one 64-column block each)
      const uint64_t dx = hopper::make_desc(st, 16, 1024, 1);
      const uint64_t da = hopper::make_desc(st + L::X_BYTES, BK * 128, 1024, 1);
      const uint64_t dw = hopper::make_desc(st + L::X_BYTES + L::A_BYTES, BK * 128, 1024, 1);
#pragma unroll
      for (int j = 0; j < NB; ++j) hopper::fence_operand(acc[j]);
      if constexpr (RING_A) hopper::fence_operand(uacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dxk = hopper::desc_add(dx, kk * 32);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          hopper::wgmma_ss<0, 1>(acc[j], hopper::desc_add(dw, j * BK * 128 + kk * 2048), dxk);
        if constexpr (RING_A) hopper::wgmma_ss<0, 1>(uacc, hopper::desc_add(da, kk * 2048), dxk);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int j = 0; j < NB; ++j) hopper::fence_operand(acc[j]);
      if constexpr (RING_A) hopper::fence_operand(uacc);
      hopper::wgmma_wait<1>();  // the previous step's products are done: free its slot
      if (t > 0 && tid == 0) hopper::mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == stages) s = 0, phase ^= 1;
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NB; ++j) hopper::fence_operand(acc[j]);
    if constexpr (RING_A) hopper::fence_operand(uacc);

    const int w = warp, q = lane % 4;
#pragma unroll
    for (int jm = 0; jm < MT / 8; ++jm)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * jm + 2 * q + (e & 1), row = 16 * w + lane / 4 + 8 * (e / 2);
#pragma unroll
        for (int j = 0; j < NB; ++j) part[m * BN + 64 * j + row] = acc[j][4 * jm + e];
        if constexpr (RING_A) upart[m * RANKS + row] = uacc[4 * jm + e];
      }
  }
  cluster.sync();  // every block's partials are written
  // (the partials are added in rank order; the zeros past the cluster's
  // blocks leave each sum as it is)
  if constexpr (RING_A) {
    for (int i = tid; i < MT * r; i += NT) {
      const int m = i / r, j = i % r;
      float v[MAX_SPLIT];
#pragma unroll
      for (int c = 0; c < MAX_SPLIT; ++c)
        v[c] = c < nc ? cluster.map_shared_rank(upart, c)[m * RANKS + j] : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < MAX_SPLIT; ++c) sum += v[c];
      ufull[m * RANKS + j] = sum;
    }
    __syncthreads();
  }
  // this block's share of the output slice: y = Σ partials (+ scale · u·B
  // for FUSED); UPASS: the terms of scale · Σ partials
  const int per = (MT * BN + nc - 1) / nc;
  for (int i = tid; i < per; i += NT) {
    const int e = rank * per + i, m = e / BN, n = n0 + e % BN;
    if (e < MT * BN && m < M && n < N) {
      float v[MAX_SPLIT];
#pragma unroll
      for (int c = 0; c < MAX_SPLIT; ++c) v[c] = c < nc ? cluster.map_shared_rank(part, c)[e] : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < MAX_SPLIT; ++c) sum += v[c];
      if constexpr (MODE == FUSED) {
        float d = 0.f;
#pragma unroll 8
        for (int j = 0; j < r; ++j) d += ufull[m * RANKS + j] * __bfloat162float(b[(size_t)j * N + n]);
        sum += scale * d;
      }
      if constexpr (MODE == UPASS) {
        const float su = scale * sum, h = __bfloat162float(__float2bfloat16_rn(su));
        y[(size_t)m * N + n] = __float2bfloat16_rn(h);
        y[(size_t)(M + m) * N + n] = __float2bfloat16_rn(su - h);
      } else {
        y[(size_t)m * N + n] = __float2bfloat16(sum);
      }
    }
  }
  cluster.sync();  // the other blocks read this block's shared memory until here
}


// FUSED: o.a is A; UPASS: o.w is A (N is r8 where A is copied: r is then
// A's ranks), y is u's terms (2, M, N), o.a and b are not read; UFOLD: the
// `a` map reads u's terms (2, M, r8), r8 = r rounded up to a multiple of 8
template <int MT, int BN, int MODE, int FILL>
cudaError_t launch(const Ops& o, const bf16* u, bf16* y, int N, int r, float scale, int split,
                   cudaStream_t stream) {
  using L = Layout<MT, BN, MODE, FILL>;
  const int M = o.x.rows, K = o.x.cols;
  const int fl = FILL == COPY ? o.flags : FILL == COPY_A ? CP_A : 0;
  const bool w_tma = MODE == UPASS ? !(fl & CP_A) : !(fl & CP_W);
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(kernel<MT, BN, MODE, FILL>, L::smem(L::STAGES), smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap tx = {}, tw = {}, ta = {}, tb = {};
  const uint64_t r8 = (uint64_t)(r + 7) / 8 * 8;
  const uint64_t xs[2] = {(uint64_t)K, (uint64_t)M}, xst[1] = {(uint64_t)K * 2};
  const uint64_t ws[2] = {(uint64_t)N, (uint64_t)K}, wst[1] = {(uint64_t)N * 2};
  const uint64_t as[2] = {(uint64_t)r, (uint64_t)K}, ast[1] = {(uint64_t)r * 2};
  const uint64_t us[3] = {r8, (uint64_t)M, 2};
  const uint64_t ust[2] = {r8 * 2, (uint64_t)M * r8 * 2};
  const uint64_t bsz[2] = {(uint64_t)N, (uint64_t)r};
  const uint32_t xb[2] = {BK, MT}, wb[2] = {64, BK}, ab[2] = {RANKS, BK}, ub[3] = {BK, MT, 1};
  if (!(fl & CP_X) && (e = hopper::make_tensor_map(&tx, o.x.p, 2, xs, xst, xb, 128)) != cudaSuccess)
    return e;
  if (w_tma && (e = hopper::make_tensor_map(&tw, o.w.p, 2, ws, wst, wb, 128)) != cudaSuccess)
    return e;
  if (MODE == FUSED && !(fl & CP_A) &&
      (e = hopper::make_tensor_map(&ta, o.a.p, 2, as, ast, ab, 128)) != cudaSuccess)
    return e;
  if (MODE == UFOLD) {
    if ((e = hopper::make_tensor_map(&ta, u, 3, us, ust, ub, 128)) != cudaSuccess) return e;
    if (!(fl & CP_B) && (e = hopper::make_tensor_map(&tb, o.b.p, 2, bsz, wst, wb, 128)) != cudaSuccess)
      return e;
  }
  int kc = ((K + split - 1) / split + BK - 1) / BK * BK;
  // one stage a step of the block with the most, at most L::STAGES: its K
  // steps and (UFOLD) its share of the fold's 2·ceil(r/64)
  const int most = kc / BK + (MODE == UFOLD ? (2 * ((r + BK - 1) / BK) + split - 1) / split : 0);
  int stages = most < L::STAGES ? most : L::STAGES;
  // a cluster of `split` blocks along K for each slice of N
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N + BN - 1) / BN);
  cfg.blockDim = dim3(threads(FILL));
  cfg.dynamicSmemBytes = L::smem(stages);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bf16* b = o.b.p;
  Ops ops = o;
  int Mi = M, Ki = K, Ni = N, ri = r;
  void* args[] = {&tx, &tw, &ta, &tb, &b, &y, &Mi, &Ki, &Ni, &ri, &kc, &stages, &scale, &ops};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel<MT, BN, MODE, FILL>), args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the product at 8 or 16 rows of x (MT) and slices of bn columns
template <int MODE, int FILL>
cudaError_t dispatch(const Ops& o, const bf16* u, int r, float scale, int bn, int split,
                     cudaStream_t stream) {
  const int M = o.x.rows, N = o.w.cols;
  if (bn == 64) {
    if (M <= 8) return launch<8, 64, MODE, FILL>(o, u, o.y, N, r, scale, split, stream);
    return launch<16, 64, MODE, FILL>(o, u, o.y, N, r, scale, split, stream);
  }
  if (M <= 8) return launch<8, 128, MODE, FILL>(o, u, o.y, N, r, scale, split, stream);
  return launch<16, 128, MODE, FILL>(o, u, o.y, N, r, scale, split, stream);
}

// u's terms (2, M, r8) of scale·x·A (UPASS: A in W's place, r8 columns)
template <int FILL>
cudaError_t u_launch(const Ops& o, bf16* u, float scale, int usplit, cudaStream_t stream) {
  const int r = o.a.cols, r8 = (r + 7) / 8 * 8;
  Ops uo = o;
  uo.w = o.a;  // A's tiles in W's place
  return o.x.rows <= 8
             ? launch<8, 64, UPASS, FILL>(uo, nullptr, u, r8, r, scale, usplit, stream)
             : launch<16, 64, UPASS, FILL>(uo, nullptr, u, r8, r, scale, usplit, stream);
}

}  // namespace decode

// ===========================================================================
// fp32: fp32 FMAs on the CUDA cores (no TF32), fed by cp.async rings
// ===========================================================================
namespace fp32 {

using hopper::cp_async4;  // cp.async of 4 bytes (any fp32 address); src_bytes 0 writes a zero

// y = out·([x | xe]·[W; We]) + scale·(x·A)·B, every operand row-major fp32:
// the reduction's rows k < K come from x (M x K) and W (K x N), rows K +
// [0, R) from xe (M x R) and We (R x N): a first launch's scale·u and B
// (R = 0: none). A (K x r) and B (r x N): the fused u (RC > 0 only).
struct Ops {
  const float *x, *w, *xe, *we, *a, *b;
  float* y;
  int M, K, R, N, r;
  float scale, out;
  int wv, av;  // W and We (A) read 16 bytes at a time: N (r) % 4 == 0, 16-byte aligned
};

__device__ __forceinline__ const float* w_row(const Ops& o, int k) {
  return k < o.K ? o.w + (size_t)k * o.N : o.we + (size_t)(k - o.K) * o.N;
}

// rows [k0, k0 + ROWS) and columns [c0, c0 + COLS) of [W; We] into dst
// (ROWS x COLS), zeros at rows from kend and columns from N
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void copy_w(float* dst, const Ops& o, int k0, int c0, int kend) {
  if (o.wv) {
    for (int i = threadIdx.x; i < ROWS * COLS / 4; i += NT) {
      const int row = i / (COLS / 4), col = (i % (COLS / 4)) * 4, k = k0 + row, n = c0 + col;
      const bool in = k < kend && n < o.N;
      hopper::cp_async16(dst + row * COLS + col, in ? w_row(o, k) + n : o.w, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int k = k0 + i / COLS, n = c0 + i % COLS;
      const bool in = k < kend && n < o.N;
      cp_async4(dst + i, in ? w_row(o, k) + n : o.w, in ? 4 : 0);
    }
  }
}

// rows [m0, m0 + MROWS) of [x | xe] at reduction rows [k0, k0 + ROWS) into
// dst transposed (dst[k][m], leading dimension dld), zeros past M and kend;
// consecutive threads read consecutive k
template <int ROWS, int MROWS, int NT>
__device__ __forceinline__ void copy_xt(float* dst, int dld, const Ops& o, int m0, int k0,
                                        int kend) {
  for (int i = threadIdx.x; i < ROWS * MROWS; i += NT) {
    const int m = i / ROWS, kk = i % ROWS, k = k0 + kk, gm = m0 + m;
    const bool in = k < kend && gm < o.M;
    const float* src = !in ? o.x : k < o.K ? o.x + (size_t)gm * o.K + k
                                           : o.xe + (size_t)gm * o.R + (k - o.K);
    cp_async4(dst + kk * dld + m, src, in ? 4 : 0);
  }
}

// A's rows [k0, k0 + ROWS) (below kend <= K), ranks [0, RC), into dst
// (ROWS x RC), zeros past r
template <int ROWS, int RC, int NT>
__device__ __forceinline__ void copy_a(float* dst, const Ops& o, int k0, int kend) {
  if (o.av) {
    for (int i = threadIdx.x; i < ROWS * RC / 4; i += NT) {
      const int row = i / (RC / 4), j = (i % (RC / 4)) * 4, k = k0 + row;
      const bool in = k < kend && j < o.r;
      hopper::cp_async16(dst + row * RC + j, in ? o.a + (size_t)k * o.r + j : o.a, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * RC; i += NT) {
      const int k = k0 + i / RC, j = i % RC;
      const bool in = k < kend && j < o.r;
      cp_async4(dst + i, in ? o.a + (size_t)k * o.r + j : o.a, in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void unpack(float4 v, float* out) {
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}

// ---------------------------------------------------------------------------
// prefill (M > 16) in one launch, for small shapes at up to 16 ranks (the
// smoke configs'), and the first launch's u of two: fp32 FMAs on the CUDA cores (67 TFLOP/s
// against 4·(M·K + K·N + M·N) bytes). A TILE x TILE output tile (TILE =
// 64·G) a block of 16 x 16 threads, each G x G groups of 4 x 4 outputs; a
// ring of STAGES cp.async stages, each 16 K-rows of x (stored k-major: a
// thread's rows are two float4 reads), of W and of A (RC ranks; RC = 0: no
// fused u). u = x·A from the same staged x tile; scale·u·B joins the fp32
// accumulators at the end, u never rounded.
// ---------------------------------------------------------------------------
constexpr int BK = 16, THREADS = 256, STAGES = 4;

template <int G, int RC>
struct Pre {
  static constexpr int TILE = 64 * G;
  static constexpr int XLD = TILE + 4;  // the x tile's rows (k-major), padded
  static constexpr int STAGE = BK * XLD + BK * TILE + BK * RC;  // floats
  static constexpr int FOLD = RC * XLD + RC * TILE;  // scale·u (rank-major) and B's rows
  static constexpr int FLOATS = STAGES * STAGE > FOLD ? STAGES * STAGE : FOLD;
  static constexpr size_t SMEM = (size_t)FLOATS * 4;
};

// RC = 0 (a first launch's u, N = r): two blocks an SM (registers for 128
// a thread)
template <int G, int RC>
__global__ void __launch_bounds__(THREADS, RC == 0 ? 2 : 1) prefill_kernel(Ops o) {
  using P = Pre<G, RC>;
  constexpr int TILE = P::TILE, XLD = P::XLD, RPT = RC / 16 > 0 ? RC / 16 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nk = (o.K + BK - 1) / BK;

  // step kt's stage: K-rows k0 + [0, 16) of x, W and A, zeros past K, M,
  // N and r
  auto load = [&](int kt, int slot) {
    float* st = ring + slot * P::STAGE;
    const int k0 = kt * BK;
    {  // x, k-major: this thread's k, rows tid / 16 + 16·j
      const int kk = tid % BK, mb = tid / BK;
      const bool kin = k0 + kk < o.K;
      const float* src = o.x + (size_t)(m0 + mb) * o.K + k0 + kk;
#pragma unroll
      for (int j = 0; j < TILE / 16; ++j) {
        const bool in = kin && m0 + mb + 16 * j < o.M;
        cp_async4(st + kk * XLD + mb + 16 * j, in ? src + (size_t)16 * j * o.K : o.x, in ? 4 : 0);
      }
    }
    const float* wsrc = o.w + (size_t)k0 * o.N + n0;
    float* wdst = st + BK * XLD;
    if (o.wv) {  // 16-byte chunks: rows tid / (TILE / 4) + (THREADS / (TILE / 4))·j
      constexpr int CPR = TILE / 4, RPP = THREADS / CPR;
      const int c = tid % CPR, rb = tid / CPR;
      const bool cin = n0 + 4 * c < o.N;
#pragma unroll
      for (int j = 0; j < BK / RPP; ++j) {
        const int row = rb + RPP * j;
        const bool in = cin && k0 + row < o.K;
        hopper::cp_async16(wdst + row * TILE + 4 * c, in ? wsrc + (size_t)row * o.N + 4 * c : o.w,
                           in ? 16 : 0);
      }
    } else {
      constexpr int RPP = THREADS / TILE;
      const int c = tid % TILE, rb = tid / TILE;
      const bool cin = n0 + c < o.N;
#pragma unroll
      for (int j = 0; j < BK / RPP; ++j) {
        const int row = rb + RPP * j;
        const bool in = cin && k0 + row < o.K;
        cp_async4(wdst + row * TILE + c, in ? wsrc + (size_t)row * o.N + c : o.w, in ? 4 : 0);
      }
    }
    if constexpr (RC > 0) copy_a<BK, RC, THREADS>(st + BK * XLD + BK * TILE, o, k0, o.K);
  };

  float acc[4 * G][4 * G], u[4 * G][RPT];
#pragma unroll
  for (int i = 0; i < 4 * G; ++i) {
#pragma unroll
    for (int j = 0; j < 4 * G; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < RPT; ++j) u[i][j] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    hopper::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    hopper::cp_async_wait<STAGES - 2>();  // step kt's copies (this thread's) have landed
    __syncthreads();  // everyone's, and step kt - 1's slot is read
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    hopper::cp_async_commit();
    const float* xs = ring + (kt % STAGES) * P::STAGE;
    const float* ws = xs + BK * XLD;
    const float* as = ws + BK * TILE;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float xr[4 * G], wr[4 * G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        unpack(*reinterpret_cast<const float4*>(xs + k * XLD + 64 * g + 4 * ty), xr + 4 * g);
        unpack(*reinterpret_cast<const float4*>(ws + k * TILE + 64 * g + 4 * tx), wr + 4 * g);
      }
#pragma unroll
      for (int i = 0; i < 4 * G; ++i)
#pragma unroll
        for (int j = 0; j < 4 * G; ++j) acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
      if constexpr (RC > 0) {
        float ar[RPT];
#pragma unroll
        for (int j = 0; j < RPT; ++j) ar[j] = as[k * RC + tx * RPT + j];
#pragma unroll
        for (int i = 0; i < 4 * G; ++i)
#pragma unroll
          for (int j = 0; j < RPT; ++j) u[i][j] = fmaf(xr[i], ar[j], u[i][j]);
      }
    }
  }
  hopper::cp_async_wait<0>();

  if constexpr (RC > 0) {  // acc += (scale·u)·B, over the ring
    __syncthreads();
    float* ut = ring;             // RC x XLD
    float* bs = ring + RC * XLD;  // RC x TILE
#pragma unroll
    for (int i = 0; i < 4 * G; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        ut[(tx * RPT + j) * XLD + 64 * (i / 4) + 4 * ty + i % 4] = o.scale * u[i][j];
    for (int i = tid; i < RC * TILE; i += THREADS) {
      const int j = i / TILE, n = n0 + i % TILE;
      bs[i] = j < o.r && n < o.N ? o.b[(size_t)j * o.N + n] : 0.f;
    }
    __syncthreads();
    const int rows = min(RC, o.r);
    for (int j = 0; j < rows; ++j) {
      float ur[4 * G], br[4 * G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        unpack(*reinterpret_cast<const float4*>(ut + j * XLD + 64 * g + 4 * ty), ur + 4 * g);
        unpack(*reinterpret_cast<const float4*>(bs + j * TILE + 64 * g + 4 * tx), br + 4 * g);
      }
#pragma unroll
      for (int i = 0; i < 4 * G; ++i)
#pragma unroll
        for (int jj = 0; jj < 4 * G; ++jj) acc[i][jj] = fmaf(ur[i], br[jj], acc[i][jj]);
    }
  }

  const bool y_vec = o.N % 4 == 0 && (reinterpret_cast<uintptr_t>(o.y) & 15) == 0;
#pragma unroll
  for (int i = 0; i < 4 * G; ++i) {
    const int gm = m0 + 64 * (i / 4) + 4 * ty + i % 4;
    if (gm >= o.M) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int gn = n0 + 64 * g + 4 * tx;
      float* dst = o.y + (size_t)gm * o.N + gn;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = o.out * acc[i][4 * g + j];
      if (y_vec && gn + 4 <= o.N) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < o.N) dst[j] = v[j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// prefill in two launches (large shapes, and any shape above 64 ranks): the
// product on the tensor cores in 3xTF32. Each fp32 operand is split into a
// TF32 big term and the TF32 rounding of the rest (22 of fp32's 24 bits),
// and three products, small·big + big·small + big·big, add into fp32
// registers: the dropped small·small and the split's rounding are below
// 2^-21 of each product. The tensor cores' fp32 sums are not rounded to
// nearest (summed over all of K, the error passed 1e-5 of the largest
// output at K = 2048 on the card), so each 32-row stage's 12 products start
// from zero and the stage's sum joins the accumulators by an fp32 add.
// 128 x 128 output tiles, two warpgroups of 64 rows; per stage the 256
// threads cp.async 32 reduction rows of x and of W (a ring of TC_STAGES),
// then write their big and small terms as K-major tiles (W transposed) of
// 128-byte rows in the 128-byte swizzle that wgmma's descriptors read: TF32
// wgmma takes K-major operands only. The terms are double-buffered: a
// stage's are written while the last stage's wgmmas run. (mma.sync's
// m16n8k8 in 3xTF32 ran no faster than the CUDA cores' FMAs on the card.)
// The split, the TF32 wgmmas and the swizzled chunk writes are hopper.cuh's.
// ---------------------------------------------------------------------------
constexpr int TC_BM = 128, TC_BK = 32, TC_STAGES = 2;
constexpr int TC_XLD = TC_BK + 4;  // the raw x tile's padded rows (floats)
constexpr int TC_XTERM = TC_BM * TC_BK * 4;  // bytes of one of x's terms, K-major

// BN: the output tile's columns, 128 or 64 (the latter where 128-wide tiles
// leave the card's last wave mostly idle)
template <int BN>
struct TcLayout {
  static constexpr int WLD = BN + 4;  // the raw W tile's padded rows (floats)
  static constexpr int RAW = TC_BM * TC_XLD + TC_BK * WLD;  // floats of a raw stage
  static constexpr int WTERM = BN * TC_BK * 4;  // bytes of one of W's terms, K-major
  static constexpr int TERMS = 2 * TC_XTERM + 2 * WTERM;  // a set of the four
  static constexpr size_t SMEM = 1024 + 2 * TERMS + (size_t)TC_STAGES * RAW * 4;
};

// xv, xev: x (xe) read 16 bytes at a time (K (R) % 4 == 0, 16-byte aligned)
template <int BN>
__global__ void __launch_bounds__(THREADS, 1) tc_kernel(Ops o, int xv, int xev) {
  using L = TcLayout<BN>;
  constexpr int WLD = L::WLD, KPT = TC_BK * BN / THREADS;  // W's k's a thread converts
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~1023ull);
  // two sets of x's big and small terms (128 rows x 32 k) and W's (128
  // columns x 32 k, transposed), then the raw ring
  float* raw = reinterpret_cast<float*>(base + 2 * L::TERMS);
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, wg = tid / 128;
  const int nkx = (o.K + TC_BK - 1) / TC_BK, nk = nkx + (o.R + TC_BK - 1) / TC_BK;

  auto load = [&](int kt, int slot) {
    float* xs = raw + slot * L::RAW;
    float* ws = xs + TC_BM * TC_XLD;
    const bool ext = kt >= nkx;
    const int k0 = (ext ? kt - nkx : kt) * TC_BK, kmax = ext ? o.R : o.K;
    const float* xsrc = (ext ? o.xe : o.x) + (size_t)m0 * kmax + k0;
    if (ext ? xev : xv) {
#pragma unroll
      for (int i = tid; i < TC_BM * TC_BK / 4; i += THREADS) {
        const int row = i / (TC_BK / 4), c = 4 * (i % (TC_BK / 4));
        const bool in = m0 + row < o.M && k0 + c < kmax;
        hopper::cp_async16(xs + row * TC_XLD + c, in ? xsrc + (size_t)row * kmax + c : o.x,
                           in ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = tid; i < TC_BM * TC_BK; i += THREADS) {
        const int row = i / TC_BK, c = i % TC_BK;
        const bool in = m0 + row < o.M && k0 + c < kmax;
        cp_async4(xs + row * TC_XLD + c, in ? xsrc + (size_t)row * kmax + c : o.x, in ? 4 : 0);
      }
    }
    const float* wsrc = (ext ? o.we : o.w) + (size_t)k0 * o.N + n0;
    if (o.wv) {
#pragma unroll
      for (int i = tid; i < TC_BK * BN / 4; i += THREADS) {
        const int row = i / (BN / 4), c = 4 * (i % (BN / 4));
        const bool in = k0 + row < kmax && n0 + c < o.N;
        hopper::cp_async16(ws + row * WLD + c, in ? wsrc + (size_t)row * o.N + c : o.w,
                           in ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = tid; i < TC_BK * BN; i += THREADS) {
        const int row = i / BN, c = i % BN;
        const bool in = k0 + row < kmax && n0 + c < o.N;
        cp_async4(ws + row * WLD + c, in ? wsrc + (size_t)row * o.N + c : o.w, in ? 4 : 0);
      }
    }
  };

  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    hopper::cp_async_commit();
  }
  // this thread's share of the terms: x's row tid / 2, k's 16·(tid % 2) +
  // [0, 16); W's column tid % BN, k's KPT·(tid / BN) + [0, KPT)
  const int xr = tid / 2, xk = 16 * (tid % 2), wn = tid % BN, wk = KPT * (tid / BN);
  for (int kt = 0; kt < nk; ++kt) {
    hopper::cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // step kt's raw tiles are in; the raw tiles of kt - 1 are read
    if (kt + TC_STAGES - 1 < nk) load(kt + TC_STAGES - 1, (kt + TC_STAGES - 1) % TC_STAGES);
    hopper::cp_async_commit();
    const float* xs = raw + (kt % TC_STAGES) * L::RAW;
    const float* ws = xs + TC_BM * TC_XLD;
    // this step's terms: the set that step kt - 2's wgmmas read (waited for below at kt - 1)
    unsigned char* xb = base + (kt % 2) * L::TERMS;
    unsigned char* xsm = xb + TC_XTERM;
    unsigned char* wb = xsm + TC_XTERM;
    unsigned char* wsm = wb + L::WTERM;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t b[4], sm[4];
      const float4 v = *reinterpret_cast<const float4*>(xs + xr * TC_XLD + xk + 4 * c);
      hopper::split_tf32(v.x, b[0], sm[0]);
      hopper::split_tf32(v.y, b[1], sm[1]);
      hopper::split_tf32(v.z, b[2], sm[2]);
      hopper::split_tf32(v.w, b[3], sm[3]);
      hopper::put_chunk(xb, xr, xk / 4 + c, b[0], b[1], b[2], b[3]);
      hopper::put_chunk(xsm, xr, xk / 4 + c, sm[0], sm[1], sm[2], sm[3]);
    }
#pragma unroll
    for (int c = 0; c < KPT / 4; ++c) {
      uint32_t b[4], sm[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) hopper::split_tf32(ws[(wk + 4 * c + e) * WLD + wn], b[e], sm[e]);
      hopper::put_chunk(wb, wn, wk / 4 + c, b[0], b[1], b[2], b[3]);
      hopper::put_chunk(wsm, wn, wk / 4 + c, sm[0], sm[1], sm[2], sm[3]);
    }
    hopper::fence_proxy_async();  // the terms' writes, visible to the tensor cores
    if (kt > 0) {  // step kt - 1's products, into the accumulators
      hopper::wgmma_wait<0>();
      hopper::fence_operand(part);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }
    __syncthreads();  // every thread's terms of step kt are written
    const uint64_t da = hopper::make_desc(xb + wg * 64 * 128, 16, 1024, 1);
    const uint64_t das = hopper::make_desc(xsm + wg * 64 * 128, 16, 1024, 1);
    const uint64_t db = hopper::make_desc(wb, 16, 1024, 1);
    const uint64_t dbs = hopper::make_desc(wsm, 16, 1024, 1);
    hopper::fence_operand(part);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 8; ++kk) {
      hopper::wgmma_tf32(part, hopper::desc_add(das, 32 * kk), hopper::desc_add(db, 32 * kk), kk > 0);
      hopper::wgmma_tf32(part, hopper::desc_add(da, 32 * kk), hopper::desc_add(dbs, 32 * kk), 1);
      hopper::wgmma_tf32(part, hopper::desc_add(da, 32 * kk), hopper::desc_add(db, 32 * kk), 1);
    }
    hopper::wgmma_commit();
  }
  if (nk > 0) {
    hopper::wgmma_wait<0>();
    hopper::fence_operand(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  }
  hopper::cp_async_wait<0>();

  // thread (warp w of the warpgroup, lane l) holds acc[4j + i] at row 16w +
  // l/4 + 8(i/2), column 8j + 2(l%4) + i%2
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const bool y_vec = o.N % 2 == 0 && (reinterpret_cast<uintptr_t>(o.y) & 7) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
    if (m >= o.M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      float* dst = o.y + (size_t)m * o.N + n;
      const float v0 = o.out * acc[4 * j + 2 * h], v1 = o.out * acc[4 * j + 2 * h + 1];
      if (y_vec && n + 1 < o.N) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        if (n < o.N) dst[0] = v0;
        if (n + 1 < o.N) dst[1] = v1;
      }
    }
  }
}

template <int BN>
cudaError_t tc_launch(const Ops& o, cudaStream_t stream) {
  using L = TcLayout<BN>;
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(tc_kernel<BN>, L::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int xv = o.K % 4 == 0 && aligned(o.x), xev = o.R % 4 == 0 && aligned(o.xe);
  dim3 grid((o.N + BN - 1) / BN, (o.M + TC_BM - 1) / TC_BM);
  tc_kernel<BN><<<grid, THREADS, L::SMEM, stream>>>(o, xv, xev);
  return cudaGetLastError();
}

template <int G, int RC>
cudaError_t prefill_launch(const Ops& o, cudaStream_t stream) {
  using P = Pre<G, RC>;
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(prefill_kernel<G, RC>, P::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((o.N + P::TILE - 1) / P::TILE, (o.M + P::TILE - 1) / P::TILE);
  prefill_kernel<G, RC><<<grid, THREADS, P::SMEM, stream>>>(o);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// decode (M <= 16): what bounds it is reading W once (4·K·N bytes against
// 2·M·K·N FMAs). Clusters of `split` blocks (up to 8) split the reduction's
// rows for each 64-column slice of N, as the bf16 decode's do; each block
// streams its rows of W, x's MT rows (k-major) and A's RC ranks through a
// ring of cp.async stages of 32 rows (4-16 KB of W in flight a stage, two
// blocks an SM). Its 4 warps take 8 rows of a stage each, a lane 2 of W's
// columns for every row of x (and 2 of A's ranks for 1/KSUB of the warp's
// rows: lanes split the rows where RC < 64); the warps' partials, then the
// cluster's blocks' (through distributed shared memory), are added in a
// fixed order, and each block adds scale·u·B to its share of the slice.
// ---------------------------------------------------------------------------
constexpr int DBK = 32, DBN = 64, DTHREADS = 128, DMAX_STAGES = 6, MAX_SPLIT = 8;
constexpr size_t SM_SMEM = 233472;  // an SM's shared memory; each block also reserves 1 KB

template <int MT, int RC>
struct Dec {
  static constexpr int STAGE = DBK * MT + DBK * DBN + DBK * RC;  // floats: x, W, A
  static constexpr int RED = 4 * MT * DBN + 4 * MT * RC;  // the warps' partials, over the ring
  static constexpr int FIXED = MT * DBN + 2 * MT * RC;  // the block's partials, the whole u
  // as many stages as leave room for two blocks an SM, at most DMAX_STAGES
  static constexpr int FIT = (int)((SM_SMEM / 2 - 1024 - 176 - 4 * FIXED) / (4 * STAGE));
  static constexpr int STAGES = FIT < DMAX_STAGES ? FIT : DMAX_STAGES;
  static constexpr int RING = STAGES * STAGE > RED ? STAGES * STAGE : RED;
  // a block's shared memory: + the slots' barriers (W by TMA) and the slack
  // that aligns the ring to 128 bytes, as TMA's boxes need (mirrored by
  // kernels/lora_matmul.py ``fp32_decode_smem_bytes``)
  static constexpr size_t SMEM = 4 * (size_t)(RING + FIXED) + 8 * DMAX_STAGES + 128;
  static_assert(STAGES >= 2 && MT % 4 == 0 && (RC == 0 || RC == 16 || RC == 32 || RC == 64),
                "unsupported tile");
};

// tma: W's tiles come by TMA through tm_w (boxes of 32 rows x 64 columns;
// R = 0, W 16-byte readable), else by cp.async
template <int MT, int RC>
__global__ void __launch_bounds__(DTHREADS, 2)
decode_kernel(Ops o, int kc, const __grid_constant__ CUtensorMap tm_w, int tma) {
  using D = Dec<MT, RC>;
  constexpr int STAGES = D::STAGES, RP = RC > 0 ? RC : 16, KSUB = 64 / RP, SUBROWS = 8 / KSUB;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  float* ring =
      reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* part = ring + D::RING;    // MT x DBN
  float* upart = part + MT * DBN;  // MT x RC
  float* ufull = upart + MT * RC;  // MT x RC
  uint64_t* full = reinterpret_cast<uint64_t*>(ufull + MT * RC);  // W's slots (tma)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = (int)cluster.block_rank(), nc = (int)cluster.num_blocks();
  const int n0 = blockIdx.y * DBN;
  const int kbeg = rank * kc, kend = min(o.K + o.R, kbeg + kc);  // kc: a multiple of DBK
  const int nk = kend > kbeg ? (kend - kbeg + DBK - 1) / DBK : 0;

  auto load = [&](int t, int slot) {
    float* st = ring + slot * D::STAGE;
    const int k0 = kbeg + t * DBK;
    copy_xt<DBK, MT, DTHREADS>(st, MT, o, 0, k0, kend);
    if (!tma) {
      copy_w<DBK, DBN, DTHREADS>(st + DBK * MT, o, k0, n0, kend);
    } else if (tid == 0) {
      hopper::mbar_arrive_expect_tx(&full[slot], DBK * DBN * 4);
      hopper::tma_load_2d(st + DBK * MT, &tm_w, &full[slot], n0, k0);
    }
    if constexpr (RC > 0) copy_a<DBK, RC, DTHREADS>(st + DBK * MT + DBK * DBN, o, k0, kend);
  };
  if (tma && tid == 0) {
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  float acc[MT][2], uacc[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = uacc[m][0] = uacc[m][1] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    hopper::cp_async_commit();
  }
  const int p = lane % (RP / 2), sub = lane / (RP / 2);  // u: ranks 2p, 2p + 1; rows of sub
  for (int t = 0; t < nk; ++t) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < nk) load(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    hopper::cp_async_commit();
    if (tma) hopper::mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    const float* xs = ring + (t % STAGES) * D::STAGE;
    const float* ws = xs + DBK * MT;
    const float* as = ws + DBK * DBN;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int k = 8 * warp + kk;
      float xr[MT];
#pragma unroll
      for (int m = 0; m < MT; m += 4)
        unpack(*reinterpret_cast<const float4*>(xs + k * MT + m), xr + m);
      const float2 wv = *reinterpret_cast<const float2*>(ws + k * DBN + 2 * lane);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[m][0] = fmaf(xr[m], wv.x, acc[m][0]);
        acc[m][1] = fmaf(xr[m], wv.y, acc[m][1]);
      }
    }
    if constexpr (RC > 0) {
#pragma unroll
      for (int kk = 0; kk < SUBROWS; ++kk) {
        const int k = 8 * warp + sub * SUBROWS + kk;
        float xr[MT];
#pragma unroll
        for (int m = 0; m < MT; m += 4)
          unpack(*reinterpret_cast<const float4*>(xs + k * MT + m), xr + m);
        const float2 av = *reinterpret_cast<const float2*>(as + k * RC + 2 * p);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uacc[m][0] = fmaf(xr[m], av.x, uacc[m][0]);
          uacc[m][1] = fmaf(xr[m], av.y, uacc[m][1]);
        }
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' partials go there

  // the lanes' partials of u over their rows, then the warps', in a fixed order
  float* red = ring;                     // 4 x MT x DBN
  float* ured = ring + 4 * MT * DBN;     // 4 x MT x RC
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    *reinterpret_cast<float2*>(red + (warp * MT + m) * DBN + 2 * lane) =
        make_float2(acc[m][0], acc[m][1]);
    if constexpr (RC > 0) {
#pragma unroll
      for (int off = RC / 2; off < 32; off *= 2) {
        uacc[m][0] += __shfl_xor_sync(0xffffffffu, uacc[m][0], off);
        uacc[m][1] += __shfl_xor_sync(0xffffffffu, uacc[m][1], off);
      }
      if (sub == 0)
        *reinterpret_cast<float2*>(ured + (warp * MT + m) * RC + 2 * p) =
            make_float2(uacc[m][0], uacc[m][1]);
    }
  }
  __syncthreads();
  for (int e = tid; e < MT * DBN; e += DTHREADS)
    part[e] = ((red[e] + red[MT * DBN + e]) + red[2 * MT * DBN + e]) + red[3 * MT * DBN + e];
  for (int e = tid; e < MT * RC; e += DTHREADS)
    upart[e] = ((ured[e] + ured[MT * RC + e]) + ured[2 * MT * RC + e]) + ured[3 * MT * RC + e];

  cluster.sync();  // every block's partials are written
  // (the partials are added in rank order; the zeros past the cluster's
  // blocks leave each sum as it is)
  if constexpr (RC > 0) {
    for (int i = tid; i < MT * o.r; i += DTHREADS) {
      const int m = i / o.r, j = i % o.r;
      float v[MAX_SPLIT];
#pragma unroll
      for (int c = 0; c < MAX_SPLIT; ++c)
        v[c] = c < nc ? cluster.map_shared_rank(upart, c)[m * RC + j] : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < MAX_SPLIT; ++c) sum += v[c];
      ufull[m * RC + j] = sum;
    }
    __syncthreads();
  }
  // this block's share of the slice: y = out · Σ partials + scale · u·B
  const int per = (MT * DBN + nc - 1) / nc;
  for (int i = tid; i < per; i += DTHREADS) {
    const int e = rank * per + i, m = e / DBN, n = n0 + e % DBN;
    if (e < MT * DBN && m < o.M && n < o.N) {
      float v[MAX_SPLIT];
#pragma unroll
      for (int c = 0; c < MAX_SPLIT; ++c) v[c] = c < nc ? cluster.map_shared_rank(part, c)[e] : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < MAX_SPLIT; ++c) sum += v[c];
      sum *= o.out;
      if constexpr (RC > 0) {
        float d = 0.f;
#pragma unroll 8
        for (int j = 0; j < o.r; ++j) d = fmaf(ufull[m * RC + j], o.b[(size_t)j * o.N + n], d);
        sum += o.scale * d;
      }
      o.y[(size_t)m * o.N + n] = sum;
    }
  }
  cluster.sync();  // the other blocks read this block's shared memory until here
}

// tma: W comes by TMA where it can (R = 0, W 16-byte readable), else by
// cp.async
template <int MT, int RC>
cudaError_t decode_launch(const Ops& o, int split, int tma, cudaStream_t stream) {
  using D = Dec<MT, RC>;
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(decode_kernel<MT, RC>, D::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  int kc = ((o.K + o.R + split - 1) / split + DBK - 1) / DBK * DBK;
  CUtensorMap tm_w = {};
  tma = tma && o.R == 0 && o.wv;
  if (tma) {
    const uint64_t ws[2] = {(uint64_t)o.N, (uint64_t)o.K}, wst[1] = {(uint64_t)o.N * 4};
    const uint32_t wb[2] = {DBN, DBK};
    if ((e = hopper::make_tensor_map(&tm_w, o.w, 2, ws, wst, wb, 0,
                                     CU_TENSOR_MAP_DATA_TYPE_FLOAT32)) != cudaSuccess)
      return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (o.N + DBN - 1) / DBN);
  cfg.blockDim = dim3(DTHREADS);
  cfg.dynamicSmemBytes = D::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  Ops ops = o;
  void* args[] = {&ops, &kc, &tm_w, &tma};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(decode_kernel<MT, RC>), args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the fused u's tile: 16, 32 or 64 ranks (r <= 64), or none
template <int MT>
cudaError_t decode_ranks(const Ops& o, int split, int tma, cudaStream_t st) {
  if (o.a == nullptr) return decode_launch<MT, 0>(o, split, tma, st);
  if (o.r <= 16) return decode_launch<MT, 16>(o, split, tma, st);
  if (o.r <= 32) return decode_launch<MT, 32>(o, split, tma, st);
  return decode_launch<MT, 64>(o, split, tma, st);
}

cudaError_t decode(const Ops& o, int split, int tma, cudaStream_t st) {
  if (o.M <= 4) return decode_ranks<4>(o, split, tma, st);
  if (o.M <= 8) return decode_ranks<8>(o, split, tma, st);
  return decode_ranks<16>(o, split, tma, st);
}

}  // namespace fp32

}  // namespace

// x (M,K), w (K,N), a (K,r), b (r,N), y (M,N): contiguous row-major bf16.
// Each entry launches one variant on `stream` and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// the variant does not take).

namespace {

// The operands as matrices and the copy flags of a launch: x, W, A and B
// where a tensor map cannot read them (a pointer off 16 bytes, rows not a
// multiple of 8 elements; A also where copy_a asks), the output by plain
// stores where TMA cannot write it. COPY where any of x, W, B and the
// output needs it, COPY_A where only A does, else TMA_ALL.
Ops operands(const void* x, const void* w, const void* a, const void* b, void* y, int M, int K,
             int N, int r, int copy_a, int& fill) {
  auto tma = [](const void* p, int cols) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && cols % 8 == 0;
  };
  const int flags = (tma(x, K) ? 0 : CP_X) | (tma(w, N) ? 0 : CP_W) |
                    (tma(a, r) && !copy_a ? 0 : CP_A) | (tma(b, N) ? 0 : CP_B) |
                    (tma(y, N) ? 0 : OUT_PLAIN);
  fill = flags & ~CP_A ? COPY : flags ? COPY_A : TMA_ALL;
  const bf16 *xp = static_cast<const bf16*>(x), *wp = static_cast<const bf16*>(w);
  const bf16 *ap = static_cast<const bf16*>(a), *bp = static_cast<const bf16*>(b);
  return Ops{{xp, M, K, K}, {wp, K, N, N}, {ap, K, r, r}, {bp, r, N, N}, static_cast<bf16*>(y),
             flags};
}

}  // namespace

// prefill: any M, K, N, r and pointers; bn = the output tile's width (64,
// 128, 192, 256; 256 not for 16 < r <= 64; where a tile other than A's is
// copied, a wider one asked takes 128); copy_a: the producer warps copy A's tiles even where
// a tensor map could read them; above 64 ranks u is scratch of 2·M·r8 bf16
// (16-byte aligned; r8 = r rounded up to a multiple of 8), else unused.
// Above 64 ranks two launches: u's terms, then the product.
extern "C" int lora_matmul_prefill_bf16(const void* x, const void* w, const void* a,
                                        const void* b, void* y, int M, int K, int N, int r,
                                        float scale, int bn, int copy_a, void* u, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || r <= 0 || M > 65535 * prefill::BM || (r > 64 && u == nullptr))
    return (int)cudaErrorInvalidValue;
  int fill;
  const Ops o = operands(x, w, a, b, y, M, K, N, r, copy_a, fill);
  if (fill == COPY && bn > 128) bn = 128;  // the placing warps leave registers for 128
  bf16* up = static_cast<bf16*>(u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r > 64) {
    if (bn != 64 && bn != 128 && bn != 192 && bn != 256) return (int)cudaErrorInvalidValue;
    cudaError_t e = fill == COPY     ? prefill::u_launch<COPY>(o, up, scale, st)
                    : fill == COPY_A ? prefill::u_launch<COPY_A>(o, up, scale, st)
                                     : prefill::u_launch<TMA_ALL>(o, up, scale, st);
    if (e != cudaSuccess) return (int)e;
    if (fill == COPY)
      return (int)(bn == 64 ? prefill::wide_launch<64, COPY>(o, up, st)
                            : prefill::wide_launch<128, COPY>(o, up, st));
    switch (bn) {
      case 64: return (int)prefill::wide_launch<64, TMA_ALL>(o, up, st);
      case 128: return (int)prefill::wide_launch<128, TMA_ALL>(o, up, st);
      case 192: return (int)prefill::wide_launch<192, TMA_ALL>(o, up, st);
      default: return (int)prefill::wide_launch<256, TMA_ALL>(o, up, st);
    }
  }
  return (int)(fill == COPY     ? prefill::fused<COPY>(o, scale, bn, st)
               : fill == COPY_A ? prefill::fused<COPY_A>(o, scale, bn, st)
                                : prefill::fused<TMA_ALL>(o, scale, bn, st));
}

// decode: M <= 16, any K, N, r and pointers; bn = the columns of a
// cluster's slice (64 or 128), split = the blocks of a cluster, each a
// slice of K (1-8); copy_a as the prefill's; above 64 ranks u is scratch of
// 2·M·r8 bf16 (16-byte aligned) and usplit the blocks of the u launch's
// clusters (1-8), else both are unused. Above 64 ranks two launches: u's
// terms, then the product with its fold.
extern "C" int lora_matmul_decode_bf16(const void* x, const void* w, const void* a,
                                       const void* b, void* y, int M, int K, int N, int r,
                                       float scale, int bn, int split, int usplit, int copy_a,
                                       void* u, void* stream) {
  if (M <= 0 || M > 16 || K <= 0 || N <= 0 || r <= 0 || (bn != 64 && bn != 128) ||
      (N + bn - 1) / bn > 65535 || split < 1 || split > decode::MAX_SPLIT ||
      (r > 64 && (u == nullptr || usplit < 1 || usplit > decode::MAX_SPLIT)))
    return (int)cudaErrorInvalidValue;
  int fill;
  const Ops o = operands(x, w, a, b, y, M, K, N, r, copy_a, fill);
  bf16* up = static_cast<bf16*>(u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r <= 64)
    return (int)(fill == COPY     ? decode::dispatch<decode::FUSED, COPY>(o, nullptr, r, scale, bn, split, st)
                 : fill == COPY_A ? decode::dispatch<decode::FUSED, COPY_A>(o, nullptr, r, scale, bn, split, st)
                                  : decode::dispatch<decode::FUSED, TMA_ALL>(o, nullptr, r, scale, bn, split, st));
  // the u launch copies what it reads of x and A; the product reads x, W,
  // u's aligned terms and B
  cudaError_t e = fill == COPY     ? decode::u_launch<COPY>(o, up, scale, usplit, st)
                  : fill == COPY_A ? decode::u_launch<COPY_A>(o, up, scale, usplit, st)
                                   : decode::u_launch<TMA_ALL>(o, up, scale, usplit, st);
  if (e != cudaSuccess) return (int)e;
  return (int)(fill == COPY ? decode::dispatch<decode::UFOLD, COPY>(o, up, r, 1.f, bn, split, st)
                            : decode::dispatch<decode::UFOLD, TMA_ALL>(o, up, r, 1.f, bn, split, st));
}

// fp32: x, w, a, b, y in fp32, any shape, rank and alignment. split > 0:
// the decode design (M <= 16), clusters of `split` blocks (1-8); split 0:
// the prefill design, in one launch up to 16 ranks. Given u (scratch of M·r
// fp32; needed above 64 ranks, and above 16 at split 0), two launches: the first writes scale·x·A into u (the decode's with
// clusters of usplit blocks, the prefill's in 64 x 64 tiles), and the
// second is the product over K + r rows, [x | scale·u]·[W; B] (the
// prefill's in 3xTF32, tiles of 128 rows and bn = 128 or 64 columns).
// tma: the decode design's launches read W (A in the u launch) by TMA where
// they can; 0: by cp.async (the wrapper always asks for TMA: no slower on
// the card at any size of W).
extern "C" int lora_matmul_fp32(const void* x, const void* w, const void* a, const void* b,
                                void* y, int M, int K, int N, int r, float scale, int split,
                                int usplit, int bn, int tma, void* u, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || r <= 0 || M > 65535 * 64 || split < 0 ||
      split > fp32::MAX_SPLIT || (split > 0 && M > 16) ||
      (r > (split > 0 ? 64 : 16) && u == nullptr) ||
      (u != nullptr && split > 0 && (usplit < 1 || usplit > fp32::MAX_SPLIT)))
    return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fp32::Ops o = {static_cast<const float*>(x), static_cast<const float*>(w), nullptr, nullptr,
                 static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(y),
                 M, K, 0, N, r, scale, 1.f, N % 4 == 0 && aligned(w), r % 4 == 0 && aligned(a)};
  if (u != nullptr) {
    // u = scale·x·A: A in W's place, N = r, nothing fused
    fp32::Ops uo = o;
    uo.w = o.a, uo.N = r, uo.a = nullptr, uo.y = static_cast<float*>(u), uo.out = scale;
    uo.wv = o.av;
    cudaError_t e =
        split > 0 ? fp32::decode(uo, usplit, tma, st) : fp32::prefill_launch<1, 0>(uo, st);
    if (e != cudaSuccess) return (int)e;
    o.xe = static_cast<const float*>(u), o.we = o.b, o.R = r, o.a = nullptr;
    o.wv = o.wv && aligned(b);
  }
  if (split > 0) return (int)fp32::decode(o, split, tma, st);
  if (u == nullptr) return (int)fp32::prefill_launch<2, 16>(o, st);
  return (int)(bn == 64 ? fp32::tc_launch<64>(o, st) : fp32::tc_launch<128>(o, st));
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
