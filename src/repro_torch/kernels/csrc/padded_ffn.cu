// Gated FFN over parallelism-padded weights for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/padded_ffn.py::padded_ffn
// (pl.pallas_call at :95): out = f(x @ gate, x @ up) @ wo over the fused
// wi = [gate | up] (d, 2*ffp) and wo (ffp, d), where each of the `tp`
// shards of the ffp columns holds ff/tp real columns followed by a zero
// tail (paper §4.2, Eq. 2).  Only real columns are visited, so padded and
// unpadded work are equal by construction, as on the TPU.
//
// Bound on the H100: bytes at decode (T = 4: every weight byte is read
// once for a few FLOPs each), operations at prefill (T = 512: 512 FLOPs
// a weight element in bf16 is above the card's ~295 FLOP/byte ridge).
//
// Two products on one stream, each one launch of the bf16 tensor-core
// GEMM below (plus, when its K is split, one deterministic reduce pass):
//   1. gate/up: h (T, ff) = f(x @ gate, x @ up), the activation applied to
//      the two fp32 accumulators in registers, h rounded to bf16 (the
//      type the second product reads) into a compact scratch;
//   2. down: out (T, d) = h @ wo over the ff real rows.
// The TPU kernel keeps a (block_t, d) fp32 accumulator in VMEM across the
// ff grid axis; a Hopper block has no room for that at d = 4096, so h
// goes through device memory between the products.
//
// The bf16 GEMM (namespace tc):
//   * Weights are the 64-row M side of wgmma.m64nNk16 and the tokens its
//     N side (8-64 at decode, 128 or 256 at prefill), so a decode step
//     wastes no tensor-core rows on padding tokens and each weight byte
//     is read once.  The weight tile is MN-major (its columns contiguous
//     in memory: the A transpose bit), the token tile K-major.
//   * The padding skip lives in the tensor maps, not in address
//     arithmetic: wi is described to TMA as (d, 2, tp, ffp/tp) and wo as
//     (tp, ffp/tp, d) with the within-shard extent ff/tp, the real width,
//     and the padded strides.  A box never reads a shard's zero tail; a
//     shard width that 64 does not divide (minicpm-2b at W = 4: 1440)
//     comes back zero-filled past its end.  Tiles walk (shard, tile
//     within shard) and never straddle two shards; h is described as
//     (T, tp, ff/tp) so the down product's K boxes stop at shard ends too.
//   * A producer warp keeps a ring of 4-6 stages of operand tiles in
//     flight by TMA (128-byte swizzle), tracked by mbarriers (expect-tx
//     when full, one arrival a consumer thread when free); consumer
//     warpgroups run wgmma with fp32 accumulators, keeping one product
//     group in flight while the next stage's tiles land.
//   * At decode (T <= DECODE_MAX_T tokens; the wrapper's plan, which this
//     file walks as given, picks the tiling, tiles and splits) one
//     warpgroup owns 64 weight columns and K is split so that about two
//     blocks an SM stream the weights: the down product at T = 4 has only
//     d / 64 = 64 column tiles for 132 SMs.  Splits write fp32 partials,
//     summed in split order by a second pass that applies the activation
//     (gate/up) and writes bf16: no atomics, so a run repeats bit for
//     bit.  At prefill two warpgroups share each token tile (128 weight
//     columns a block; 128 tokens for gate/up with its two accumulators,
//     256 for down).
//   * Precision: one fp32 wgmma accumulator is carried over the whole K
//     (d = 4096 for gate/up, ff = 14336 for down at llama3-8b).  On an
//     H100 it stays within FFN_ROW_TOL (2^-8 = 0.0039) of the row RMS of
//     the fp32 plain version in every chip_smoke.py case, both tilings
//     at 1-512 tokens and six weight seeds at T = 4, 128 and 512, using
//     at most 0.0030 of it beyond one bf16 ulp, so no interval promotion
//     into separate fp32 registers is done.
// fp32 keeps its CUDA-core tile (namespace f32; 256 threads, 4x4 FMAs a
// thread): a tensor-core fp32 product would be TF32, which the fp32
// checks (1e-4) do not allow.
#include "common.cuh"
#include "hopper.cuh"

namespace {

enum { ACT_SWIGLU = 0, ACT_GEGLU = 1, ACT_GELU = 2 };

// real index -> padded index: consecutive shards of `real` entries, each
// followed by a zero tail up to `padded`
struct Map {
  int real, padded;
  __device__ __forceinline__ int operator()(int j) const {
    return (j / real) * padded + j % real;
  }
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float activate(int act, float g, float u) {
  if (act == ACT_SWIGLU) return g / (1.0f + expf(-g)) * u;
  if (act == ACT_GEGLU) return gelu_tanh(g) * u;
  return gelu_tanh(g);
}

// One GEMM tile problem of the fp32 path: C (M, N) = A (M, K) @ B (K, N)
// with A row-major (leading dim lda) and B element (k, n) at
// b[brow(k) * ldb + bcol(n) + op * b_op_off] for operand op < NB.
// NB = 2 is the gated gate/up product, NB = 1 a single product; the
// epilogue applies `act` (act < 0: none) to the one or two results.
struct Prob {
  const void* a;
  const void* b;
  void* c;
  int M, N, K, lda, ldb, ldc;
  long long b_op_off;
  Map brow, bcol;
  int act;
};

// act < 0: no activation (the down product)
__device__ __forceinline__ float epilogue(const Prob& p, float g, float u) {
  return p.act < 0 ? g : activate(p.act, g, u);
}

// ---------------------------------------------------------------- fp32
// ---------------------------------------------------------------- fp32
namespace f32 {
constexpr int THREADS = 256, BM = 64, BN = 64, BK = 16;
constexpr int LDA = BM + 4, LDB = BN + 4;

template <int NB>
__global__ void __launch_bounds__(THREADS) ffn_tile(Prob p) {
  __shared__ __align__(16) float sa[BK * LDA];      // k-major (A^T)
  __shared__ __align__(16) float sb[NB][BK * LDB];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* A = static_cast<const float*>(p.a);
  const float* Bm = static_cast<const float*>(p.b);
  float acc[NB][4][4];
#pragma unroll
  for (int o = 0; o < NB; ++o)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[o][i][j] = 0.0f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    {  // A tile: BM x BK = 256 vectors of 4, stored transposed
      const int row = tid / (BK / 4), kq = (tid % (BK / 4)) * 4;
      const int m = m0 + row, k = k0 + kq;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < p.M && k < p.K)
        val = *reinterpret_cast<const float4*>(A + (long long)m * p.lda + k);
      sa[(kq + 0) * LDA + row] = val.x;
      sa[(kq + 1) * LDA + row] = val.y;
      sa[(kq + 2) * LDA + row] = val.z;
      sa[(kq + 3) * LDA + row] = val.w;
    }
    {  // B tiles: BK x BN = 256 vectors of 4 per operand
      const int row = tid / (BN / 4), cv = (tid % (BN / 4)) * 4;
      const int k = k0 + row, n = n0 + cv;
      const bool ok = k < p.K && n < p.N;
      const long long off =
          ok ? (long long)p.brow(k) * p.ldb + p.bcol(n) : 0;
#pragma unroll
      for (int o = 0; o < NB; ++o) {
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok)
          val = *reinterpret_cast<const float4*>(Bm + off + o * p.b_op_off);
        *reinterpret_cast<float4*>(&sb[o][row * LDB + cv]) = val;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&sa[k * LDA + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int o = 0; o < NB; ++o) {
        const float4 b =
            *reinterpret_cast<const float4*>(&sb[o][k * LDB + tx * 4]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[o][i][j] += av[i] * bv[j];
      }
    }
    __syncthreads();
  }
  float* C = static_cast<float*>(p.c);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < p.M && n < p.N)
        C[(long long)m * p.ldc + n] =
            epilogue(p, acc[0][i][j], acc[NB - 1][i][j]);
    }
}
}  // namespace f32

// ------------------------------------------------ bf16, tensor cores
namespace tc {
using namespace rt::hopper;
using bf16 = __nv_bfloat16;

enum { UP = 0, DOWN = 1 };
constexpr int BM = 64;              // weight columns of a warpgroup
constexpr int BK = 64;              // K of a stage: one 128-byte row
constexpr int A_TILE = BM * BK * 2;  // bytes of a weight tile

struct Args {
  bf16* out;        // UP: h (T, ff); DOWN: out (T, d)
  float* part;      // split K: fp32 partials (S, NB, T, n_out); else null
  int T;
  int n_out;        // columns of an output row: ff (UP) or d (DOWN)
  int cols;         // UP: real columns a shard (ff/tp); DOWN: d
  int col_tiles;    // column tiles a shard (UP) or in all (DOWN)
  int k_tiles;      // 64-deep K tiles of the whole product
  int kts;          // DOWN: K tiles a shard, ceil((ff/tp) / 64)
  int act;          // UP: the activation; DOWN: -1
};

template <int KIND, int WGS, int NT, int NB, int STAGES>
struct Cfg {
  static constexpr int CONSUMERS = WGS * 128;
  static constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
  static constexpr int NN = NT > 128 ? 128 : NT;  // N of one wgmma
  static constexpr int NSUB = NT / NN;
  static constexpr int B_OFF = WGS * NB * A_TILE;
  static constexpr int STAGE = B_OFF + NT * 128;
  static constexpr int BAR = STAGES * STAGE;
  static constexpr int ALLOC = BAR + 16 * STAGES + 1024;  // + alignment
};

template <int KIND, int WGS, int NT, int NB, int STAGES>
__global__ void __launch_bounds__(Cfg<KIND, WGS, NT, NB, STAGES>::THREADS)
    ffn_wgmma(const __grid_constant__ CUtensorMap tm_w,
              const __grid_constant__ CUtensorMap tm_x, const Args a) {
  using C = Cfg<KIND, WGS, NT, NB, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t bars = smem_u32(sm + C::BAR);
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (STAGES + s); };

  const int tid = threadIdx.x;
  // token tiles are the grid's fast axis, so the blocks that read one
  // weight tile run together and it comes from device memory once
  const int t0 = blockIdx.x * NT, z = blockIdx.z, S = gridDim.z;
  // UP: the tile's shard and its first column within the shard;
  // DOWN: shard 0 and the tile's first output column
  const int shard = blockIdx.y / a.col_tiles;
  const int c0 = (blockIdx.y % a.col_tiles) * WGS * BM;
  const int kt0 = (int)((long long)z * a.k_tiles / S);
  const int kt1 = (int)((long long)(z + 1) * a.k_tiles / S);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= C::CONSUMERS) {
    // ---------------------------------------------------- producer warp
    if (tid != C::CONSUMERS) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      mbar_wait(empty_bar(stage), phase ^ 1);
      mbar_expect_tx(full_bar(stage), C::STAGE);
      const uint32_t st = smem_u32(sm + stage * C::STAGE);
      const uint32_t bar = full_bar(stage);
      if (KIND == UP) {
        // wi as (d, 2, tp, ff/tp real of ffp/tp): box (64 k, 1, 1, 64)
#pragma unroll
        for (int w = 0; w < WGS; ++w)
#pragma unroll
          for (int o = 0; o < NB; ++o)
            tma_4d(st + (w * NB + o) * A_TILE, &tm_w, bar, c0 + w * BM,
                   shard, o, kt * BK);
        tma_2d(st + C::B_OFF, &tm_x, bar, kt * BK, t0);
      } else {
        // wo as (tp, ff/tp real of ffp/tp, d), h as (T, tp, ff/tp)
        const int sh = kt / a.kts, kin = (kt % a.kts) * BK;
#pragma unroll
        for (int w = 0; w < WGS; ++w)
          tma_3d(st + w * A_TILE, &tm_w, bar, c0 + w * BM, kin, sh);
        tma_3d(st + C::B_OFF, &tm_x, bar, kin, sh, t0);
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  const int wg = tid / 128, w = (tid % 128) / 32, l = tid % 32;
  float acc[NB][C::NSUB][C::NN / 2];
#pragma unroll
  for (int o = 0; o < NB; ++o)
#pragma unroll
    for (int s = 0; s < C::NSUB; ++s)
#pragma unroll
      for (int i = 0; i < C::NN / 2; ++i) acc[o][s][i] = 0.f;
  int stage = 0, prev = -1;
  uint32_t phase = 0;
  for (int kt = kt0; kt < kt1; ++kt) {
    mbar_wait(full_bar(stage), phase);
    const uint32_t st = smem_u32(sm + stage * C::STAGE);
    wgmma_fence();
#pragma unroll
    for (int o = 0; o < NB; ++o)
#pragma unroll
      for (int s = 0; s < C::NSUB; ++s) fence_regs(acc[o][s]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int o = 0; o < NB; ++o) {
        // weights MN-major: 16 K rows of 128 bytes a step, 8-row groups
        // 1024 bytes apart; tokens K-major: 32 bytes a step
        const uint64_t da =
            sw128_desc(st + (wg * NB + o) * A_TILE + kk * 2048, 8192, 1024);
#pragma unroll
        for (int s = 0; s < C::NSUB; ++s) {
          const uint64_t db = sw128_desc(
              st + C::B_OFF + s * C::NN * 128 + kk * 32, 16, 1024);
          Wgmma<C::NN>::template ss<1, 0>(acc[o][s], da, db, 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done with it
#pragma unroll
    for (int o = 0; o < NB; ++o)
#pragma unroll
      for (int s = 0; s < C::NSUB; ++s) fence_regs(acc[o][s]);
    if (prev >= 0) mbar_arrive(empty_bar(prev));
    prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int o = 0; o < NB; ++o)
#pragma unroll
    for (int s = 0; s < C::NSUB; ++s) fence_regs(acc[o][s]);

  // epilogue: acc[o][s][i] is weight column (i % 4 < 2 ? r0 : r0 + 8)
  // of this warpgroup, token (i / 4) * 8 + (l % 4) * 2 + i % 2 of sub-tile s
  const int r0 = w * 16 + l / 4;
#pragma unroll
  for (int s = 0; s < C::NSUB; ++s)
#pragma unroll
    for (int i = 0; i < C::NN / 2; ++i) {
      const int c = c0 + wg * BM + r0 + (i % 4 < 2 ? 0 : 8);
      const int t = t0 + s * C::NN + (i / 4) * 8 + (l % 4) * 2 + i % 2;
      if (c >= a.cols || t >= a.T) continue;
      const int col = KIND == UP ? shard * a.cols + c : c;
      const size_t e = (size_t)t * a.n_out + col;
      if (a.part) {
        const size_t plane = (size_t)a.T * a.n_out;
#pragma unroll
        for (int o = 0; o < NB; ++o)
          a.part[(size_t)(z * NB + o) * plane + e] = acc[o][s][i];
      } else {
        const float g = acc[0][s][i], u = acc[NB - 1][s][i];
        a.out[e] = __float2bfloat16(a.act < 0 ? g : activate(a.act, g, u));
      }
    }
}

// the split-K second pass: out = f(sum over splits, in split order)
__global__ void ffn_reduce(const float* __restrict__ part,
                           bf16* __restrict__ out, int S, int NB,
                           size_t plane, int act) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < plane;
       e += (size_t)gridDim.x * blockDim.x) {
    float g = 0.f, u = 0.f;
    for (int z = 0; z < S; ++z) {
      g += part[(size_t)(z * NB) * plane + e];
      if (NB == 2) u += part[(size_t)(z * NB + 1) * plane + e];
    }
    out[e] = __float2bfloat16(act < 0 ? g : activate(act, g, NB == 2 ? u : g));
  }
}

template <int KIND, int WGS, int NT, int NB, int STAGES>
int run(const CUtensorMap& tw, const CUtensorMap& tx, const Args& a,
        int tiles, int S, cudaStream_t st) {
  using C = Cfg<KIND, WGS, NT, NB, STAGES>;
  auto kern = ffn_wgmma<KIND, WGS, NT, NB, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::ALLOC);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.T + NT - 1) / NT, tiles, S);
  kern<<<grid, C::THREADS, C::ALLOC, st>>>(tw, tx, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  const size_t plane = (size_t)a.T * a.n_out;
  const int blocks = (int)((plane + 255) / 256 < 1024 ? (plane + 255) / 256
                                                       : 1024);
  ffn_reduce<<<blocks, 256, 0, st>>>(a.part, a.out, S, NB, plane, a.act);
  return (int)cudaGetLastError();
}

// The host's plan (padded_ffn.plan), walked as given: wgs warpgroups of
// 64 weight columns a block (1: the decode tiling, 2: the prefill
// tiling), token tiles of nt_up / nt_down, column tiles a shard (gate/up)
// and of d (down), 64-deep K tiles of d and of a shard, and each
// product's K splits.  Checked only to cover the problem and to name an
// instantiated tiling.
struct Plan {
  int wgs, nt_up, nt_down, col_tiles_up, col_tiles_down, k_tiles_up, kts,
      split_up, split_down;
};

// decode tiling: one warpgroup, tokens padded to 8, 16, 32 or 64;
// prefill tiling: two warpgroups and PRE tokens (128 gate/up, 256 down)
template <int KIND, int NB, int STAGES, int PRE>
int run_tiling(const CUtensorMap& tw, const CUtensorMap& tx, const Args& a,
               int wgs, int nt, int tiles, int S, cudaStream_t st) {
  if (wgs == 2 && nt == PRE)
    return run<KIND, 2, PRE, NB, 4>(tw, tx, a, tiles, S, st);
  if (wgs != 1) return (int)cudaErrorInvalidValue;
  switch (nt) {
    case 8: return run<KIND, 1, 8, NB, STAGES>(tw, tx, a, tiles, S, st);
    case 16: return run<KIND, 1, 16, NB, STAGES>(tw, tx, a, tiles, S, st);
    case 32: return run<KIND, 1, 32, NB, STAGES>(tw, tx, a, tiles, S, st);
    case 64: return run<KIND, 1, 64, NB, STAGES>(tw, tx, a, tiles, S, st);
  }
  return (int)cudaErrorInvalidValue;
}

int ffn(const void* x, const void* wi, const void* wo, void* h, void* out,
        float* part, int T, int d, int ff, int ffp, int tp, int act,
        const Plan& p, cudaStream_t st) {
  const cuuint64_t e = 2;
  const int ffs = ff / tp, pps = ffp / tp, span = p.wgs * BM;
  const int NB = act == ACT_GELU ? 1 : 2;
  if (p.wgs < 1 || p.col_tiles_up * span < ffs ||
      p.col_tiles_down * span < d || p.k_tiles_up * BK < d ||
      p.kts * BK < ffs || p.split_up < 1 || p.split_up > p.k_tiles_up ||
      p.split_down < 1 || p.split_down > tp * p.kts ||
      ((p.split_up > 1 || p.split_down > 1) && !part))
    return (int)cudaErrorInvalidValue;
  CUtensorMap wu, xu, wd, hd;
  {  // gate/up: wi (d, 2, tp, ffs of pps), x (T, d)
    const cuuint64_t dims[4] = {(cuuint64_t)ffs, (cuuint64_t)tp, 2,
                                (cuuint64_t)d};
    const cuuint64_t str[3] = {pps * e, ffp * e, 2 * ffp * e};
    const cuuint32_t box[4] = {BM, 1, 1, BK};
    const cuuint64_t xd[2] = {(cuuint64_t)d, (cuuint64_t)T};
    const cuuint64_t xs[1] = {d * e};
    const cuuint32_t xb[2] = {BK, (cuuint32_t)p.nt_up};
    if (!encode(&wu, wi, 4, dims, str, box) || !encode(&xu, x, 2, xd, xs, xb))
      return (int)cudaErrorInvalidValue;
  }
  {  // down: wo (tp, ffs of pps, d), h (T, tp, ffs)
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)ffs,
                                (cuuint64_t)tp};
    const cuuint64_t str[2] = {d * e, (cuuint64_t)pps * d * e};
    const cuuint32_t box[3] = {BM, BK, 1};
    const cuuint64_t hdm[3] = {(cuuint64_t)ffs, (cuuint64_t)tp,
                               (cuuint64_t)T};
    const cuuint64_t hs[2] = {ffs * e, ff * e};
    const cuuint32_t hb[3] = {BK, 1, (cuuint32_t)p.nt_down};
    if (!encode(&wd, wo, 3, dims, str, box) ||
        !encode(&hd, h, 3, hdm, hs, hb))
      return (int)cudaErrorInvalidValue;
  }
  Args up{static_cast<bf16*>(h), p.split_up > 1 ? part : nullptr, T, ff,
          ffs, p.col_tiles_up, p.k_tiles_up, 0, act};
  Args dn{static_cast<bf16*>(out), p.split_down > 1 ? part : nullptr, T, d,
          d, p.col_tiles_down, tp * p.kts, p.kts, -1};
  const int err =
      NB == 2 ? run_tiling<UP, 2, 4, 128>(wu, xu, up, p.wgs, p.nt_up,
                                          tp * p.col_tiles_up, p.split_up, st)
              : run_tiling<UP, 1, 6, 128>(wu, xu, up, p.wgs, p.nt_up,
                                          tp * p.col_tiles_up, p.split_up, st);
  if (err) return err;
  return run_tiling<DOWN, 1, 6, 256>(wd, hd, dn, p.wgs, p.nt_down,
                                     p.col_tiles_down, p.split_down, st);
}
}  // namespace tc

template <int NB>
int launch_f32(const Prob& p, cudaStream_t stream) {
  dim3 grid((p.N + f32::BN - 1) / f32::BN, (p.M + f32::BM - 1) / f32::BM);
  f32::ffn_tile<NB><<<grid, f32::THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// out (T, d) = f(x @ gate, x @ up) @ wo over the real columns of each of
// the tp shards; h (T, ff) is the caller's scratch.  x, wi, wo, h, out
// share the dtype (0 = fp32, 1 = bf16).  bf16 walks the wrapper's plan
// (struct tc::Plan, field by field) as given; a product whose K splits
// writes its fp32 partials to `part` (at least split_up * 2 * T * ff
// floats for gate/up, split_down * T * d for down).  fp32 ignores the
// plan.
extern "C" int repro_padded_ffn(const void* x, const void* wi, const void* wo,
                                void* h, void* out, void* part, int T, int d,
                                int ff, int ffp, int tp, int act, int dtype,
                                int wgs, int nt_up, int nt_down,
                                int col_tiles_up, int col_tiles_down,
                                int k_tiles_up, int kts, int split_up,
                                int split_down, void* stream) {
  const int vec = dtype == rt::DT_BF16 ? 8 : 4;
  if (T < 1 || tp < 1 || ff % tp || ffp % tp || (ff / tp) % vec ||
      (ffp / tp) % vec || (ffp / tp) < (ff / tp) || d % vec || act < ACT_SWIGLU ||
      act > ACT_GELU || (dtype != rt::DT_F32 && dtype != rt::DT_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DT_BF16)
    return tc::ffn(x, wi, wo, h, out, static_cast<float*>(part), T, d, ff,
                   ffp, tp, act,
                   tc::Plan{wgs, nt_up, nt_down, col_tiles_up, col_tiles_down,
                            k_tiles_up, kts, split_up, split_down},
                   st);
  const Map cols{ff / tp, ffp / tp};
  Prob up{x, wi, h, T, ff, d, d, 2 * ffp, ff, (long long)ffp,
          Map{d, d}, cols, act};
  int err = act == ACT_GELU ? launch_f32<1>(up, st) : launch_f32<2>(up, st);
  if (err) return err;
  Prob down{h, wo, out, T, d, ff, ff, d, d, 0LL, cols, Map{d, d}, -1};
  return launch_f32<1>(down, st);
}
