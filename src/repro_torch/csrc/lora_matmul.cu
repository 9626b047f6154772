// Fused LoRA matmul for Hopper (sm_90a):  y = x·W + scale·(x·A)·B.
//
// Replaces the TPU kernel src/repro/kernels/lora_matmul.py (_kernel,
// lora_matmul_pallas): x (M,K), W (K,N), A (K,r), B (r,N), all bf16 or all
// fp32; x·W and u = x·A accumulate in fp32 over K, u is folded into the fp32
// accumulator, and y is cast to the inputs' type once. Up to 64 ranks x is
// read once for both products and u is folded without being rounded; above
// 64 ranks (bf16 prefill and decode, up to 256) u is computed once by a
// launch of its own, so that no output tile or slice computes it again,
// and folded as two bf16 terms h + l of scale·u on the tensor cores
// (relative error below 2^-16 of scale·u, far inside the bf16 output's
// rounding; kernels/lora_ref.py ``lora_matmul_split_ref``).
//
// Four variants, picked by the wrapper from the dtype, shapes and alignment
// (kernels/lora_matmul.py ``variant``), never by failure:
//
// * prefill (M > 16, K, N, r multiples of 8, r <= 256, 16-byte aligned
//   rows): what bounds it is bf16 tensor-core throughput (2·M·K·N operations
//   against 2·(M·K + K·N + M·N) bytes, far above the card's ~295 operations
//   per byte). A producer warp keeps TMA loads of the x, W and A tiles of the
//   next K steps in flight through a ring of up to 4 shared-memory stages
//   (mbarriers signal full and empty slots). Two consumer warpgroups, 64
//   rows of the 128-row tile each, run wgmma for x·W (fp32 accumulators in
//   registers) and, from the same staged x tile, a second wgmma with n = 16
//   or 64 for u = x·A (A's tile is 32 or 128 bytes wide, so it has its own
//   swizzle and descriptor). The epilogue folds scale·u·B on the tensor
//   cores too: scale·u (fp32, in registers) is split exactly into three bf16
//   terms whose sum is its value, and three register-operand wgmmas add
//   their products with the TMA-loaded B tile into the fp32 accumulators, so
//   u is never rounded. The bf16 tile goes out through swizzled shared
//   memory and TMA stores. The wrapper picks the tile width (64-256) so that
//   the grid fills the 132 SMs in few waves. TMA zero-fills the ragged edges
//   on load and clips them on store. Each tile's u costs r/BN of its x·W,
//   harmless at 16 ranks; from 72 to 256 ranks it would cost up to 4x, so
//   there a first launch writes u's two bf16 terms h + l of scale·u once
//   (M x r each) and the second is a plain product over a longer K, [x | h |
//   l]·[W; B; B], on the same ring and consumers, its tile up to 256 wide,
//   the blocks rastered in groups of 8 row tiles so that those in flight
//   share W's tiles in L2.
// * decode (M <= 16): what bounds it is reading W once from device memory
//   (2·K·N bytes against 2·M·K·N operations). The clusters split N into
//   64-column slices (128 above N = 2048, to halve the clusters), and a
//   cluster of up to 8 blocks splits K: about one block an SM over all the
//   clusters (the wrapper's choice, from a sweep on the card), so even N =
//   256 keeps 32 SMs streaming and a wide N few blocks an SM. A producer
//   warp keeps TMA loads of the next K steps in flight through a ring of up
//   to 3-6 stages (mbarriers for full and empty slots; no more than the
//   block has K steps, so a short K leaves room for more blocks on an SM):
//   each stage holds 64 K-rows of the slice's W, of A (64 ranks wide, zero
//   past r) and of x (8 or 16 rows, zero past M), so shared memory does not
//   grow with K and two blocks fit on an SM at every K (48-128 KB of W in
//   flight an SM). One consumer warpgroup runs the products on the tensor
//   cores with the operands swapped: yᵀ = Wᵀ·xᵀ and uᵀ = Aᵀ·xᵀ, W's columns
//   and A's ranks as the 64-row MN-major A operand, x as the K-major B
//   operand of n = 8 or 16, fp32 accumulators in registers. The blocks of a cluster add their
//   partials of x·W and u through distributed shared memory in a fixed
//   order (no atomics: the result is the same on every run), and each adds
//   scale·u·B (fp32 FMAs, B read from device memory) to its share of the
//   output. From 72 to 256 ranks, A's tile would crowd W's out of the ring,
//   every slice's cluster would read all of A, and the epilogue's r
//   dependent loads of B would dominate, so a first launch (the same
//   kernel, A in W's place and N = r) writes u's two bf16 terms once (its
//   clusters' sums in the same fixed order), and the second streams x and
//   W alone (as many W bytes in flight as at 64 ranks), then the fold's
//   2·ceil(r/64) steps, [h | l]·[B; B], through the same ring and wgmmas,
//   each step taken by one block of the cluster.
// * generic (any other bf16 shape: misaligned rows, K, N or r not a
//   multiple of 8, ranks above 256): the first port's kernel, one 64x64x32
//   wmma tile with plain loads, ranks in chunks of up to 64 (a pass over K
//   for each further chunk of u, x re-read, W not); no bf16 shape of a
//   served config reaches it.
// * fp32 (fp32 inputs, any shape and rank; the smoke configs serve in
//   fp32): a tiled SIMT kernel, fp32 FMAs on the CUDA cores (TF32 would miss
//   the reference's fp32 tolerance). What bounds it is the fp32 CUDA-core
//   rate (67 TFLOP/s against 989 bf16 on the tensor cores): 128 x 128 output
//   tiles, 256 threads each computing an 8 x 8 share from k-major x and W
//   tiles in shared memory (float4 reads, two per operand per k), the next
//   K step's tiles loaded into registers during this one's FMAs; u = x·A
//   (up to 64 ranks at a time) from the same staged x tile, and each rank
//   chunk's scale·u·B added into the fp32 accumulators at the end.

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

// ===========================================================================
// prefill: TMA + wgmma
// ===========================================================================
namespace prefill {

constexpr int BM = 128, BK = 64;
constexpr int THREADS = 288;  // warpgroups 0-1 consume (64 rows each), warp 8 produces

template <int BN, int RP>
struct Layout {
  static constexpr int X_BYTES = BM * BK * 2;  // one 128-row box, 128-byte rows
  static constexpr int W_BYTES = BK * BN * 2;  // BN/64 boxes of 64 K-rows x 64 columns
  static constexpr int A_BYTES = BK * RP * 2;  // 64 K-rows x RP ranks
  static constexpr int A_SLOT = (A_BYTES + 1023) / 1024 * 1024;
  static constexpr int STAGE = X_BYTES + W_BYTES + A_SLOT;
  static constexpr int B_BYTES = RP * BN * 2;  // the B tile: BN/64 boxes of RP rows x 64 columns
  static constexpr int FIXED = B_BYTES + 256 + 1024;  // + barriers + alignment slack
  static constexpr int FIT = (int)((SMEM_MAX - FIXED) / STAGE);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr size_t SMEM = FIXED + (size_t)STAGES * STAGE;
  static constexpr uint32_t TX = X_BYTES + W_BYTES + A_BYTES;  // bytes landing per stage
  static_assert(STAGES >= 2, "tile too large for shared memory");
  static_assert(BM * BN * 2 <= STAGES * STAGE, "the output tile reuses the stages");
  static_assert(BN % 64 == 0 && BN <= 256 && (RP == 16 || RP == 64), "unsupported tile");
};

template <int BN, int RP>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
       const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
       const __grid_constant__ CUtensorMap tm_y, int K, float scale) {
  using L = Layout<BN, RP>;
  constexpr int STAGES = L::STAGES;
  constexpr uint32_t A_SWIZZLE = RP == 16 ? 3 : 1;  // 32-byte rows : 128-byte rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~1023ull);
  unsigned char* bs = base + STAGES * L::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + L::B_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* bfull = empty + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);   // the producer's arrive + the bytes
      hopper::mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    hopper::mbar_init(bfull, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      hopper::prefetch_tensormap(&tm_x);
      hopper::prefetch_tensormap(&tm_w);
      hopper::prefetch_tensormap(&tm_a);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        hopper::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        unsigned char* st = base + s * L::STAGE;
        hopper::mbar_arrive_expect_tx(&full[s], L::TX);
        hopper::tma_load_2d(st, &tm_x, &full[s], kt * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          hopper::tma_load_2d(st + L::X_BYTES + j * BK * 128, &tm_w, &full[s], n0 + 64 * j,
                              kt * BK);
        hopper::tma_load_2d(st + L::X_BYTES + L::W_BYTES, &tm_a, &full[s], 0, kt * BK);
        if (kt == 0) {  // the B tile, for the epilogue, behind the first stage
          hopper::mbar_arrive_expect_tx(bfull, L::B_BYTES);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            hopper::tma_load_2d(bs + j * RP * 128, &tm_b, bfull, n0 + 64 * j, 0);
        }
      }
    }
    return;
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

template <int BN>
struct WideLayout {
  static constexpr int X_BYTES = BM * BK * 2;  // a box of x, or of 64 ranks of h or l
  static constexpr int W_BYTES = BK * BN * 2;  // BN/64 boxes of W, A or B: 64 rows x 64 columns
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int FIXED = 256 + 1024;  // barriers + alignment slack
  static constexpr int FIT = (int)((SMEM_MAX - FIXED) / STAGE);
  static constexpr int STAGES = FIT < 8 ? FIT : 8;  // one block an SM: as many as fit
  static constexpr size_t SMEM = FIXED + (size_t)STAGES * STAGE;
  static_assert(STAGES >= 2 && BN % 64 == 0 && BN <= 256, "unsupported tile");
  static_assert(BM * BN * 2 <= STAGES * STAGE, "the output tile reuses the stages");
};

// The K loop of both launches: a producer warp (8) streams `steps` stages
// from load(step, slot, bar), two consumer warpgroups accumulate 64 rows
// each of x-slot·W-slot into acc. The first product overwrites the
// accumulators (scale_d = 0) instead of a zeroing, which would make ptxas
// serialize the wgmmas (C7515); acc is left undefined when steps is 0.
template <int BN, typename Load>
__device__ __forceinline__ void wide_loop(unsigned char* base, uint64_t* full, uint64_t* empty,
                                          int steps, Load load, float (&acc)[BN / 2]) {
  using L = WideLayout<BN>;
  constexpr int STAGES = L::STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (warp == 8) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < steps; ++kt) {
        const int s = kt % STAGES;
        hopper::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], L::STAGE);
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

template <int STAGES>
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);   // the producer's arrive + the bytes
      hopper::mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// y = [x | h | l]·[W; B; B] into tm_y (tm_u: u (2, M, r), boxes of 64 ranks
// x 128 rows). The grid is one-dimensional: groups of GROUP_M row tiles,
// column tiles outermost within a group, so that the blocks in flight share
// W's tiles.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
wide_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
            const __grid_constant__ CUtensorMap tm_u, const __grid_constant__ CUtensorMap tm_b,
            const __grid_constant__ CUtensorMap tm_y, int K, int r, int num_m, int num_n) {
  using L = WideLayout<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~1023ull);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::STAGES * L::STAGE);
  uint64_t* empty = full + L::STAGES;
  const int per_group = GROUP_M * num_n, first = blockIdx.x / per_group * GROUP_M;
  const int rows = min(num_m - first, GROUP_M), in_group = blockIdx.x % per_group;
  const int m0 = (first + in_group % rows) * BM, n0 = in_group / rows * BN;
  const int nk = (K + BK - 1) / BK, nc = (r + BK - 1) / BK;
  init_barriers<L::STAGES>(full, empty);
  if (threadIdx.x == 8 * 32) {
    hopper::prefetch_tensormap(&tm_x);
    hopper::prefetch_tensormap(&tm_w);
    hopper::prefetch_tensormap(&tm_u);
    hopper::prefetch_tensormap(&tm_b);
  }
  float acc[BN / 2];
  wide_loop<BN>(base, full, empty, nk + 2 * nc, [&](int kt, unsigned char* st, uint64_t* bar) {
    if (kt < nk) {
      hopper::tma_load_2d(st, &tm_x, bar, kt * BK, m0);
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        hopper::tma_load_2d(st + L::X_BYTES + j * BK * 128, &tm_w, bar, n0 + 64 * j, kt * BK);
    } else {  // ranks c·64 + [0, 64) of term t (h, then l) and B's rows of them
      const int t = (kt - nk) / nc, c = (kt - nk) % nc;
      hopper::tma_load_3d(st, &tm_u, bar, c * BK, m0, t);
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        hopper::tma_load_2d(st + L::X_BYTES + j * BK * 128, &tm_b, bar, n0 + 64 * j, c * BK);
    }
  }, acc);
  if (threadIdx.x >= 8 * 32) return;  // the producer

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
// adjacent ranks a store.
__global__ void __launch_bounds__(THREADS, 1)
u_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_a,
         bf16* __restrict__ u, int M, int K, int r, float scale) {
  using L = WideLayout<64>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~1023ull);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::STAGES * L::STAGE);
  uint64_t* empty = full + L::STAGES;
  const int m0 = blockIdx.y * BM, c0 = blockIdx.x * 64;
  init_barriers<L::STAGES>(full, empty);
  if (threadIdx.x == 8 * 32) {
    hopper::prefetch_tensormap(&tm_x);
    hopper::prefetch_tensormap(&tm_a);
  }
  float acc[32];
  wide_loop<64>(base, full, empty, (K + BK - 1) / BK,
                [&](int kt, unsigned char* st, uint64_t* bar) {
                  hopper::tma_load_2d(st, &tm_x, bar, kt * BK, m0);
                  hopper::tma_load_2d(st + L::X_BYTES, &tm_a, bar, c0, kt * BK);
                }, acc);
  if (threadIdx.x >= 8 * 32) return;  // the producer
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = m0 + (warp / 4) * 64 + (warp % 4) * 16 + lane / 4;  // and row + 8
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = c0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = row + 8 * i;
      if (m < M && col < r) {
        const float vx = scale * acc[4 * j + 2 * i], vy = scale * acc[4 * j + 2 * i + 1];
        const float hx = __bfloat162float(__float2bfloat16_rn(vx));
        const float hy = __bfloat162float(__float2bfloat16_rn(vy));
        bf16* dst = u + (size_t)m * r + col;
        *reinterpret_cast<uint32_t*>(dst) = hopper::pack_bf16(hx, hy);
        *reinterpret_cast<uint32_t*>(dst + (size_t)M * r) = hopper::pack_bf16(vx - hx, vy - hy);
      }
    }
  }
}

// u's terms (2, M, r) of scale·x·A: tiles of 128 rows x 64 ranks
cudaError_t u_launch(const bf16* x, const bf16* a, bf16* u, int M, int K, int r, float scale,
                     cudaStream_t stream) {
  using L = WideLayout<64>;
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(u_kernel, L::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap tx, ta;
  const uint64_t xs[2] = {(uint64_t)K, (uint64_t)M}, xst[1] = {(uint64_t)K * 2};
  const uint64_t as[2] = {(uint64_t)r, (uint64_t)K}, ast[1] = {(uint64_t)r * 2};
  const uint32_t xb[2] = {BK, BM}, ab[2] = {64, BK};
  if ((e = hopper::make_tensor_map(&tx, x, 2, xs, xst, xb, 128)) != cudaSuccess) return e;
  if ((e = hopper::make_tensor_map(&ta, a, 2, as, ast, ab, 128)) != cudaSuccess) return e;
  dim3 grid((r + 63) / 64, (M + BM - 1) / BM);
  u_kernel<<<grid, THREADS, L::SMEM, stream>>>(tx, ta, u, M, K, r, scale);
  return cudaGetLastError();
}

// y = [x | h | l]·[W; B; B], u: the terms (2, M, r)
template <int BN>
cudaError_t wide_launch(const bf16* x, const bf16* w, const bf16* u, const bf16* b, bf16* y,
                        int M, int K, int N, int r, cudaStream_t stream) {
  using L = WideLayout<BN>;
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(wide_kernel<BN>, L::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap tx, tw, tu, tb, ty;
  const uint64_t xs[2] = {(uint64_t)K, (uint64_t)M}, xst[1] = {(uint64_t)K * 2};
  const uint64_t ws[2] = {(uint64_t)N, (uint64_t)K}, wst[1] = {(uint64_t)N * 2};
  const uint64_t us[3] = {(uint64_t)r, (uint64_t)M, 2};
  const uint64_t ust[2] = {(uint64_t)r * 2, (uint64_t)M * r * 2};
  const uint64_t bsz[2] = {(uint64_t)N, (uint64_t)r}, ys[2] = {(uint64_t)N, (uint64_t)M};
  const uint32_t xb[2] = {BK, BM}, wb[2] = {64, BK}, ub[3] = {BK, BM, 1}, yb[2] = {64, 64};
  if ((e = hopper::make_tensor_map(&tx, x, 2, xs, xst, xb, 128)) != cudaSuccess) return e;
  if ((e = hopper::make_tensor_map(&tw, w, 2, ws, wst, wb, 128)) != cudaSuccess) return e;
  if ((e = hopper::make_tensor_map(&tu, u, 3, us, ust, ub, 128)) != cudaSuccess) return e;
  if ((e = hopper::make_tensor_map(&tb, b, 2, bsz, wst, wb, 128)) != cudaSuccess) return e;
  if ((e = hopper::make_tensor_map(&ty, y, 2, ys, wst, yb, 128)) != cudaSuccess) return e;
  const int num_m = (M + BM - 1) / BM, num_n = (N + BN - 1) / BN;
  wide_kernel<BN><<<num_m * num_n, THREADS, L::SMEM, stream>>>(tx, tw, tu, tb, ty, K, r, num_m,
                                                                 num_n);
  return cudaGetLastError();
}

template <int BN, int RP>
cudaError_t launch(const bf16* x, const bf16* w, const bf16* a, const bf16* b, bf16* y, int M,
                   int K, int N, int r, float scale, cudaStream_t stream) {
  using L = Layout<BN, RP>;
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(kernel<BN, RP>, L::SMEM, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap tx, tw, ta, tb, ty;
  const uint64_t xs[2] = {(uint64_t)K, (uint64_t)M}, xst[1] = {(uint64_t)K * 2};
  const uint64_t ws[2] = {(uint64_t)N, (uint64_t)K}, wst[1] = {(uint64_t)N * 2};
  const uint64_t as[2] = {(uint64_t)r, (uint64_t)K}, ast[1] = {(uint64_t)r * 2};
  const uint64_t bsz[2] = {(uint64_t)N, (uint64_t)r}, ys[2] = {(uint64_t)N, (uint64_t)M};
  const uint32_t xb[2] = {BK, BM}, wb[2] = {64, BK}, ab[2] = {RP, BK}, bb[2] = {64, RP};
  const uint32_t yb[2] = {64, 64};
  if ((e = hopper::make_tensor_map(&tx, x, 2, xs, xst, xb, 128)) != cudaSuccess) return e;
  if ((e = hopper::make_tensor_map(&tw, w, 2, ws, wst, wb, 128)) != cudaSuccess) return e;
  if ((e = hopper::make_tensor_map(&ta, a, 2, as, ast, ab, RP * 2)) != cudaSuccess) return e;
  if ((e = hopper::make_tensor_map(&tb, b, 2, bsz, wst, bb, 128)) != cudaSuccess) return e;
  if ((e = hopper::make_tensor_map(&ty, y, 2, ys, wst, yb, 128)) != cudaSuccess) return e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<BN, RP><<<grid, THREADS, L::SMEM, stream>>>(tx, tw, ta, tb, ty, K, scale);
  return cudaGetLastError();
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
enum Mode { FUSED, UPASS, UFOLD };

// MT: rows of x padded to 8 or 16 (the n of the wgmmas); BN: columns of a
// cluster's slice (64 or 128: the wider slice halves the clusters of a wide N)
template <int MT, int BN, int MODE>
struct Layout {
  static constexpr int X_BYTES = MT * BK * 2;     // x (or a term): MT rows of 64 K-columns, 128-byte rows
  static constexpr int A_BYTES = MODE == FUSED ? BK * RANKS * 2 : 0;  // A: 64 K-rows of 64 ranks
  static constexpr int W_BYTES = BK * BN * 2;     // W (or B): BN/64 boxes of 64 K-rows x 64 columns
  static constexpr int STAGE = X_BYTES + A_BYTES + W_BYTES;  // every part 1024-aligned
  // the block's partial of u and the whole u (fp32; FUSED only)
  static constexpr int U_BYTES = MODE == FUSED ? 2 * MT * RANKS * 4 : 0;
  // the slice's partial of x·W, u's, the barriers and the alignment slack
  static constexpr int FIXED = 1024 + MT * BN * 4 + U_BYTES + 256;
  // at most as many stages as leave room for two blocks an SM, at most
  // MAX_STAGES; a block whose K slice is shorter takes one per K step
  static constexpr int FIT = (int)((SM_SMEM / 2 - 1024 - FIXED) / STAGE);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  // a block's shared memory (mirrored by kernels/lora_matmul.py ``decode_smem_bytes``)
  static constexpr size_t smem(int stages) { return FIXED + (size_t)stages * STAGE; }
  static_assert(STAGES >= 2 && X_BYTES % 1024 == 0, "unsupported tile");
};

// yᵀ = Wᵀ·xᵀ and uᵀ = Aᵀ·xᵀ on the tensor cores, swapped so that the 64-row
// side of the wgmma is W's columns (and A's ranks), not x's few rows: per
// K step, W's and A's tiles are MN-major A operands (their columns
// contiguous) and x's tile is the K-major B operand of n = MT. tm_a: A's
// map (FUSED), the terms' (UFOLD: u (2, M, r), boxes of 64 ranks x MT
// rows); y: the output, or u's terms (UPASS: 2 x M x N with N = r).
template <int MT, int BN, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
       const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
       const bf16* __restrict__ b, bf16* __restrict__ y, int M, int K, int N, int r, int kc,
       int stages, float scale) {
  using L = Layout<MT, BN, MODE>;
  constexpr int NB = BN / 64;
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

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);   // the producer's arrive + the bytes
      hopper::mbar_init(&empty[s], 1);  // the consumer warpgroup's arrive
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer: the tiles of step t into slot s = t % stages
    if (lane == 0) {
      hopper::prefetch_tensormap(&tm_x);
      hopper::prefetch_tensormap(&tm_w);
      if constexpr (MODE != UPASS) hopper::prefetch_tensormap(&tm_a);
      if constexpr (MODE == UFOLD) hopper::prefetch_tensormap(&tm_b);
      for (int t = 0, s = 0, phase = 0; t < nkt + nf; ++t) {
        hopper::mbar_wait(&empty[s], phase ^ 1);
        unsigned char* st = base + s * L::STAGE;
        unsigned char* ws = st + L::X_BYTES + L::A_BYTES;
        hopper::mbar_arrive_expect_tx(&full[s], L::STAGE);
        if (t < nkt) {  // x, A and W at K rows k + [0, 64)
          const int k = kbeg + t * BK;
          hopper::tma_load_2d(st, &tm_x, &full[s], k, 0);
          if constexpr (RING_A) hopper::tma_load_2d(st + L::X_BYTES, &tm_a, &full[s], 0, k);
#pragma unroll
          for (int j = 0; j < NB; ++j)
            hopper::tma_load_2d(ws + j * BK * 128, &tm_w, &full[s], n0 + 64 * j, k);
        } else {  // fold step f: ranks c·64 + [0, 64) of term h or l, and B's rows of them
          const int f = f0 + (t - nkt) * nc, c = f % nr;
          hopper::tma_load_3d(st, &tm_a, &full[s], c * BK, 0, f / nr);
#pragma unroll
          for (int j = 0; j < NB; ++j)
            hopper::tma_load_2d(ws + j * BK * 128, &tm_b, &full[s], n0 + 64 * j, c * BK);
        }
        if (++s == stages) s = 0, phase ^= 1;
      }
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
    for (int i = tid; i < MT * r; i += THREADS) {
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
  for (int i = tid; i < per; i += THREADS) {
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

// FUSED: a is A; UPASS: w is A, N is r, y is u's terms (2, M, r), a and b
// are not read; UFOLD: a is u's terms (2, M, r)
template <int MT, int BN, int MODE>
cudaError_t launch(const bf16* x, const bf16* w, const bf16* a, const bf16* b, bf16* y, int M,
                   int K, int N, int r, float scale, int split, cudaStream_t stream) {
  using L = Layout<MT, BN, MODE>;
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(kernel<MT, BN, MODE>, L::smem(L::STAGES), smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap tx, tw, ta = {}, tb = {};
  const uint64_t xs[2] = {(uint64_t)K, (uint64_t)M}, xst[1] = {(uint64_t)K * 2};
  const uint64_t ws[2] = {(uint64_t)N, (uint64_t)K}, wst[1] = {(uint64_t)N * 2};
  const uint64_t as[2] = {(uint64_t)r, (uint64_t)K}, ast[1] = {(uint64_t)r * 2};
  const uint64_t us[3] = {(uint64_t)r, (uint64_t)M, 2};
  const uint64_t ust[2] = {(uint64_t)r * 2, (uint64_t)M * r * 2};
  const uint64_t bsz[2] = {(uint64_t)N, (uint64_t)r};
  const uint32_t xb[2] = {BK, MT}, wb[2] = {64, BK}, ab[2] = {RANKS, BK}, ub[3] = {BK, MT, 1};
  if ((e = hopper::make_tensor_map(&tx, x, 2, xs, xst, xb, 128)) != cudaSuccess) return e;
  if ((e = hopper::make_tensor_map(&tw, w, 2, ws, wst, wb, 128)) != cudaSuccess) return e;
  if (MODE == FUSED && (e = hopper::make_tensor_map(&ta, a, 2, as, ast, ab, 128)) != cudaSuccess)
    return e;
  if (MODE == UFOLD) {
    if ((e = hopper::make_tensor_map(&ta, a, 3, us, ust, ub, 128)) != cudaSuccess) return e;
    if ((e = hopper::make_tensor_map(&tb, b, 2, bsz, wst, wb, 128)) != cudaSuccess) return e;
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
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::smem(stages);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&tx, &tw, &ta, &tb, &b, &y, &M, &K, &N, &r, &kc, &stages, &scale};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel<MT, BN, MODE>), args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the product at 8 or 16 rows of x (MT) and slices of bn columns
template <int MODE>
cudaError_t dispatch(const bf16* x, const bf16* w, const bf16* a, const bf16* b, bf16* y, int M,
                     int K, int N, int r, float scale, int bn, int split, cudaStream_t stream) {
  if (bn == 64) {
    if (M <= 8) return launch<8, 64, MODE>(x, w, a, b, y, M, K, N, r, scale, split, stream);
    return launch<16, 64, MODE>(x, w, a, b, y, M, K, N, r, scale, split, stream);
  }
  if (M <= 8) return launch<8, 128, MODE>(x, w, a, b, y, M, K, N, r, scale, split, stream);
  return launch<16, 128, MODE>(x, w, a, b, y, M, K, N, r, scale, split, stream);
}

}  // namespace decode

// ===========================================================================
// generic: the first port's kernel (wmma, plain loads), for any other shape
// ===========================================================================
namespace generic {

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

// RF = number of 16-wide fragments of one rank chunk (RP = 16·RF ranks). A
// rank above RP runs in chunks of RP: the first pass over K computes x·W and
// the first chunk of u = x·A from the same staged x tile, each further pass
// re-reads x for the next chunk of u (W is not read again), and each chunk's
// u·B is added to the thread's fp32 share of the delta (registers), so
// scale·u·B joins x·W once, unrounded, as for a single chunk.
template <int RF>
__global__ void __launch_bounds__(NTHREADS)
lora_matmul_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const bf16* __restrict__ a, const bf16* __restrict__ b,
                   bf16* __restrict__ y, int M, int K, int N, int r, float scale) {
  constexpr int RP = 16 * RF;
  constexpr int AS_LD = RP + 8;
  constexpr int US_LD = RP + 4;
  constexpr int PER_THREAD = BM * BN / NTHREADS;  // output elements of one thread
  extern __shared__ __align__(128) unsigned char smem[];
  // K loop
  bf16* xs = reinterpret_cast<bf16*>(smem);  // BM x XS_LD
  bf16* ws = xs + BM * XS_LD;                // BK x WS_LD
  bf16* as = ws + BK * WS_LD;                // BK x AS_LD
  // epilogue: the same bytes, reused once a pass over K is over
  float* cs = reinterpret_cast<float*>(smem);  // BM x CS_LD   x·W tile
  float* us = cs + BM * CS_LD;                 // BM x US_LD   a chunk of u = x·A
  float* bs = us + BM * US_LD;                 // RP x BN      the chunk's rows of B

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
  float delta[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) delta[i] = 0.f;

  const int chunks = (r + RP - 1) / RP;
  for (int c = 0; c < chunks; ++c) {
    const bool first = c == 0;  // the pass that also computes x·W
#pragma unroll
    for (int f = 0; f < RF; ++f) wmma::fill_fragment(uacc[f], 0.f);
    for (int k0 = 0; k0 < K; k0 += BK) {
      load_tile<BM, BK>(xs, XS_LD, x, K, M, K, m0, k0, x_vec);
      if (first) load_tile<BK, BN>(ws, WS_LD, w, N, K, N, k0, n0, w_vec);
      load_tile<BK, RP>(as, AS_LD, a, r, K, r, k0, c * RP, a_vec);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2], fx;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        if (first) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(fa[i], xs + (wm * 32 + i * 16) * XS_LD + kk, XS_LD);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::load_matrix_sync(fb, ws + kk * WS_LD + wn * 32 + j * 16, WS_LD);
#pragma unroll
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
          }
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

    // this chunk's u·B, in fp32, into the thread's share of the delta
#pragma unroll
    for (int f = 0; f < RF; ++f)
      wmma::store_matrix_sync(us + warp * 16 * US_LD + f * 16, uacc[f], US_LD,
                              wmma::mem_row_major);
    for (int idx = threadIdx.x; idx < RP * BN; idx += NTHREADS) {
      const int j = idx / BN, n = idx % BN, gj = c * RP + j;
      bs[idx] = (gj < r && n0 + n < N) ? __bfloat162float(b[(size_t)gj * N + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int idx = threadIdx.x + i * NTHREADS;
      const int m = idx / BN, n = idx % BN;
      float d = 0.f;
#pragma unroll 16
      for (int j = 0; j < RP; ++j) d += us[m * US_LD + j] * bs[j * BN + n];
      delta[i] += d;
    }
    __syncthreads();  // us and bs (over xs, ws, as) are read before the next pass loads
  }

  // epilogue: y = x·W + scale · u·B, in fp32
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * CS_LD + wn * 32 + j * 16, acc[i][j],
                              CS_LD, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    const int m = idx / BN, n = idx % BN;
    const int gm = m0 + m, gn = n0 + n;
    if (gm < M && gn < N)
      y[(size_t)gm * N + gn] = __float2bfloat16(cs[m * CS_LD + n] + scale * delta[i]);
  }
}

template <int RF>
cudaError_t launch(const bf16* x, const bf16* w, const bf16* a, const bf16* b, bf16* y, int M,
                   int K, int N, int r, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<RF>();
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(lora_matmul_kernel<RF>, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  lora_matmul_kernel<RF><<<grid, NTHREADS, smem, stream>>>(x, w, a, b, y, M, K, N, r, scale);
  return cudaGetLastError();
}

}  // namespace generic

// ===========================================================================
// fp32: tiled SIMT kernel, fp32 FMAs on the CUDA cores (no TF32)
// ===========================================================================
namespace fp32 {

constexpr int BM = 128, BN = 128, BK = 16;
constexpr int THREADS = 256;   // 16 x 16 threads, each an 8 x 8 share of the tile
constexpr int XLD = BM + 4;    // x tile stored transposed (k-major), padded rows
constexpr int MAX_RC = 64;     // ranks of u held at once (a chunk)

template <int RC>
constexpr size_t smem_bytes() {
  return (size_t)(BK * XLD + BK * BN + BK * RC + RC * XLD + RC * BN) * sizeof(float);
}

// 4 consecutive floats at (row, col) of a row-major (nrows x ncols) matrix
// with leading dimension ld; zeros outside it. One 16-byte load where the
// four are inside and aligned (vec: ld % 4 == 0 and a 16-byte aligned base).
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int row, int col,
                                        int nrows, int ncols, int ld, bool vec) {
  if (row >= nrows) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* q = p + (size_t)row * ld + col;
  if (vec && col + 4 <= ncols) return *reinterpret_cast<const float4*>(q);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = col + j < ncols ? q[j] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void unpack(float4 v, float* out) {
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}

// The thread's rows (and columns) of the tile: 4 at 4·t and 4 at 64 + 4·t.
__device__ __forceinline__ int half_index(int t, int i) { return (i < 4 ? 0 : 64) + 4 * t + (i & 3); }

// One pass over K: x·W into acc (when WITH_W) and ranks [r0, r0 + RC) of
// u = x·A into u, from the same staged x tile. Global loads of the next K
// step are issued into registers before the FMAs of this one.
template <bool WITH_W, int RC>
__device__ __forceinline__ void k_pass(const float* __restrict__ x, const float* __restrict__ w,
                                       const float* __restrict__ a, float* xs, float* ws,
                                       float* as, int M, int K, int N, int r, int m0, int n0,
                                       int r0, bool x_vec, bool w_vec, bool a_vec,
                                       float (&acc)[8][8], float (&u)[8][RC / 16]) {
  constexpr int RPT = RC / 16;  // ranks of u per thread
  constexpr int A_LOADS = BK * RC / 4;  // float4 loads of one A tile
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float4 px[2], pw[2], pa = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fetch = [&](int k0) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = tid + p * THREADS;
      px[p] = load4(x, m0 + (i >> 2), k0 + (i & 3) * 4, M, K, K, x_vec);
      if (WITH_W) pw[p] = load4(w, k0 + (i >> 5), n0 + (i & 31) * 4, K, N, N, w_vec);
    }
    if (tid < A_LOADS)
      pa = load4(a, k0 + tid / (RC / 4), r0 + (tid % (RC / 4)) * 4, K, r, r, a_vec);
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the last step's tiles are read
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = tid + p * THREADS, m = i >> 2, kq = (i & 3) * 4;
      float v[4];
      unpack(px[p], v);
#pragma unroll
      for (int j = 0; j < 4; ++j) xs[(kq + j) * XLD + m] = v[j];
      if (WITH_W) *reinterpret_cast<float4*>(ws + (i >> 5) * BN + (i & 31) * 4) = pw[p];
    }
    if (tid < A_LOADS)
      *reinterpret_cast<float4*>(as + (tid / (RC / 4)) * RC + (tid % (RC / 4)) * 4) = pa;
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float xr[8], wr[8], ar[RPT];
      unpack(*reinterpret_cast<const float4*>(xs + k * XLD + 4 * ty), xr);
      unpack(*reinterpret_cast<const float4*>(xs + k * XLD + 64 + 4 * ty), xr + 4);
      if (WITH_W) {
        unpack(*reinterpret_cast<const float4*>(ws + k * BN + 4 * tx), wr);
        unpack(*reinterpret_cast<const float4*>(ws + k * BN + 64 + 4 * tx), wr + 4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) ar[j] = as[k * RC + tx * RPT + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j) u[i][j] = fmaf(xr[i], ar[j], u[i][j]);
    }
  }
}

// y = x·W + scale·(x·A)·B for one 128 x 128 tile of y. Ranks go in chunks of
// RC: the first pass over K computes x·W and the first chunk of u, each
// further pass only its chunk of u (re-reading x, not W). Each chunk's
// scale·u is staged in shared memory (transposed) beside its rows of B, and
// its product joins the fp32 accumulators of x·W: u is never rounded below
// fp32.
template <int RC>
__global__ void __launch_bounds__(THREADS, 1)
lora_matmul_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ a, const float* __restrict__ b,
                        float* __restrict__ y, int M, int K, int N, int r, float scale) {
  constexpr int RPT = RC / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // BK x XLD   x tile, k-major
  float* ws = xs + BK * XLD;                   // BK x BN    W tile
  float* as = ws + BK * BN;                    // BK x RC    A tile (one chunk)
  float* ut = as + BK * RC;                    // RC x XLD   scale·u, rank-major
  float* bs = ut + RC * XLD;                   // RC x BN    the chunk's rows of B

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool x_vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool w_vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const bool a_vec = r % 4 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool b_vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int r0 = 0; r0 < r; r0 += RC) {
    float u[8][RPT];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) u[i][j] = 0.f;
    if (r0 == 0)
      k_pass<true, RC>(x, w, a, xs, ws, as, M, K, N, r, m0, n0, r0, x_vec, w_vec, a_vec, acc, u);
    else
      k_pass<false, RC>(x, w, a, xs, ws, as, M, K, N, r, m0, n0, r0, x_vec, w_vec, a_vec, acc, u);

    __syncthreads();  // the last chunk's ut and bs are read
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) ut[(tx * RPT + j) * XLD + half_index(ty, i)] = scale * u[i][j];
    for (int i = tid; i < RC * BN / 4; i += THREADS) {
      const int j = i / (BN / 4), n = (i % (BN / 4)) * 4;
      *reinterpret_cast<float4*>(bs + j * BN + n) = load4(b, r0 + j, n0 + n, r, N, N, b_vec);
    }
    __syncthreads();
    const int rows = min(RC, r - r0);
    for (int j = 0; j < rows; ++j) {
      float ur[8], br[8];
      unpack(*reinterpret_cast<const float4*>(ut + j * XLD + 4 * ty), ur);
      unpack(*reinterpret_cast<const float4*>(ut + j * XLD + 64 + 4 * ty), ur + 4);
      unpack(*reinterpret_cast<const float4*>(bs + j * BN + 4 * tx), br);
      unpack(*reinterpret_cast<const float4*>(bs + j * BN + 64 + 4 * tx), br + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(ur[i], br[jj], acc[i][jj]);
    }
  }

  const bool y_vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + half_index(ty, i);
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + h * 64 + 4 * tx;
      float* dst = y + (size_t)gm * N + gn;
      if (y_vec && gn + 4 <= N) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) dst[j] = acc[i][4 * h + j];
      }
    }
  }
}

template <int RC>
cudaError_t launch(const float* x, const float* w, const float* a, const float* b, float* y,
                   int M, int K, int N, int r, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<RC>();
  static bool smem_set = false;
  cudaError_t e = hopper::allow_smem(lora_matmul_fp32_kernel<RC>, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  lora_matmul_fp32_kernel<RC><<<grid, THREADS, smem, stream>>>(x, w, a, b, y, M, K, N, r, scale);
  return cudaGetLastError();
}

}  // namespace fp32

}  // namespace

// x (M,K), w (K,N), a (K,r), b (r,N), y (M,N): contiguous row-major bf16.
// Each entry launches one variant on `stream` and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// the variant does not take).

// prefill: K, N, r multiples of 8, r <= 256, every pointer 16-byte aligned;
// bn = the output tile's width (64, 128, 192, 256; 256 not for 16 < r <= 64);
// above 64 ranks u is scratch of 2·M·r bf16 (16-byte aligned), else unused.
// Above 64 ranks two launches: u's terms, then the product.
extern "C" int lora_matmul_prefill_bf16(const void* x, const void* w, const void* a,
                                        const void* b, void* y, int M, int K, int N, int r,
                                        float scale, int bn, void* u, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || r <= 0 || r > 256 || K % 8 || N % 8 || r % 8 ||
      M > 65535 * prefill::BM || (r > 64 && u == nullptr))
    return (int)cudaErrorInvalidValue;
  const bf16 *xp = static_cast<const bf16*>(x), *wp = static_cast<const bf16*>(w);
  const bf16 *ap = static_cast<const bf16*>(a), *bp = static_cast<const bf16*>(b);
  bf16 *yp = static_cast<bf16*>(y), *up = static_cast<bf16*>(u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r > 64) {
    if (bn != 64 && bn != 128 && bn != 192 && bn != 256) return (int)cudaErrorInvalidValue;
    cudaError_t e = prefill::u_launch(xp, ap, up, M, K, r, scale, st);
    if (e != cudaSuccess) return (int)e;
    switch (bn) {
      case 64: return (int)prefill::wide_launch<64>(xp, wp, up, bp, yp, M, K, N, r, st);
      case 128: return (int)prefill::wide_launch<128>(xp, wp, up, bp, yp, M, K, N, r, st);
      case 192: return (int)prefill::wide_launch<192>(xp, wp, up, bp, yp, M, K, N, r, st);
      default: return (int)prefill::wide_launch<256>(xp, wp, up, bp, yp, M, K, N, r, st);
    }
  }
  if (r <= 16) {
    switch (bn) {
      case 64: return (int)prefill::launch<64, 16>(xp, wp, ap, bp, yp, M, K, N, r, scale, st);
      case 128: return (int)prefill::launch<128, 16>(xp, wp, ap, bp, yp, M, K, N, r, scale, st);
      case 192: return (int)prefill::launch<192, 16>(xp, wp, ap, bp, yp, M, K, N, r, scale, st);
      case 256: return (int)prefill::launch<256, 16>(xp, wp, ap, bp, yp, M, K, N, r, scale, st);
    }
  } else {
    switch (bn) {
      case 64: return (int)prefill::launch<64, 64>(xp, wp, ap, bp, yp, M, K, N, r, scale, st);
      case 128: return (int)prefill::launch<128, 64>(xp, wp, ap, bp, yp, M, K, N, r, scale, st);
      case 192: return (int)prefill::launch<192, 64>(xp, wp, ap, bp, yp, M, K, N, r, scale, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// decode: M <= 16, K, N and r multiples of 8, r <= 256, every pointer
// 16-byte aligned; bn = the columns of a cluster's slice (64 or 128), split =
// the blocks of a cluster, each a slice of K (1-8); above 64 ranks u is
// scratch of 2·M·r bf16 (16-byte aligned) and usplit the blocks of the u
// launch's clusters (1-8), else both are unused. Above 64 ranks two
// launches: u's terms, then the product with its fold.
extern "C" int lora_matmul_decode_bf16(const void* x, const void* w, const void* a,
                                       const void* b, void* y, int M, int K, int N, int r,
                                       float scale, int bn, int split, int usplit, void* u,
                                       void* stream) {
  if (M <= 0 || M > 16 || K <= 0 || N <= 0 || r <= 0 || r > 256 || K % 8 || N % 8 || r % 8 ||
      (bn != 64 && bn != 128) || (N + bn - 1) / bn > 65535 || split < 1 ||
      split > decode::MAX_SPLIT ||
      (r > 64 && (u == nullptr || usplit < 1 || usplit > decode::MAX_SPLIT)))
    return (int)cudaErrorInvalidValue;
  const bf16 *xp = static_cast<const bf16*>(x), *wp = static_cast<const bf16*>(w);
  const bf16 *ap = static_cast<const bf16*>(a), *bp = static_cast<const bf16*>(b);
  bf16 *yp = static_cast<bf16*>(y), *up = static_cast<bf16*>(u);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r <= 64)
    return (int)decode::dispatch<decode::FUSED>(xp, wp, ap, bp, yp, M, K, N, r, scale, bn, split,
                                                st);
  cudaError_t e =
      M <= 8 ? decode::launch<8, 64, decode::UPASS>(xp, ap, nullptr, nullptr, up, M, K, r, r,
                                                    scale, usplit, st)
             : decode::launch<16, 64, decode::UPASS>(xp, ap, nullptr, nullptr, up, M, K, r, r,
                                                     scale, usplit, st);
  if (e != cudaSuccess) return (int)e;
  return (int)decode::dispatch<decode::UFOLD>(xp, wp, up, bp, yp, M, K, N, r, 1.f, bn, split, st);
}

// generic: any shape and rank (ranks above 64 in chunks of 64)
extern "C" int lora_matmul_generic_bf16(const void* x, const void* w, const void* a,
                                        const void* b, void* y, int M, int K, int N, int r,
                                        float scale, void* stream) {
  using namespace generic;
  if (M <= 0 || K <= 0 || N <= 0 || r <= 0 || M > 65535 * BM) return (int)cudaErrorInvalidValue;
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

// fp32: x, w, a, b, y in fp32, any shape and rank (ranks in chunks of at
// most 64), any alignment
extern "C" int lora_matmul_fp32(const void* x, const void* w, const void* a, const void* b,
                                void* y, int M, int K, int N, int r, float scale, void* stream) {
  using namespace fp32;
  if (M <= 0 || K <= 0 || N <= 0 || r <= 0 || M > 65535 * BM) return (int)cudaErrorInvalidValue;
  const float *xp = static_cast<const float*>(x), *wp = static_cast<const float*>(w);
  const float *ap = static_cast<const float*>(a), *bp = static_cast<const float*>(b);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r <= 16) return (int)launch<16>(xp, wp, ap, bp, yp, M, K, N, r, scale, st);
  if (r <= 32) return (int)launch<32>(xp, wp, ap, bp, yp, M, K, N, r, scale, st);
  return (int)launch<MAX_RC>(xp, wp, ap, bp, yp, M, K, N, r, scale, st);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
