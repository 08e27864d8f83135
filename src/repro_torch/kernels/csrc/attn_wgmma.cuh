// Tensor-core GQA attention tile for Hopper (sm_90a), bf16 in, fp32
// softmax state, shared by the flash-prefill and chunk-prefill kernels:
// the attention of the TPU kernels repro/kernels/flash_attention.py::
// flash_attention and repro/kernels/chunk_prefill.py::
// chunk_prefill_attention.
//
// It computes what attn_tile.cuh computes (the fp32 path keeps that
// CUDA-core tile): one block owns one (batch row b, kv head g, query
// tile) of 64 query rows = (64 / rep) tokens x the rep query heads of g,
// so each K/V tile serves the whole group.  Keys come from an optional
// PAGED segment (read through the page table of the header-centric pool
// (NP, kvs, 2, P, dh)) and then a CONTIGUOUS segment (B, Sk, kvs, dh).
// Masking is by stored positions (causal, window, empty slots -1,
// padding queries -1) with the reference's finite NEG_INF and its 1e-20
// floor of the normaliser; ragged S is masked.
//
// Bound on the H100: operations (a causal 4096-token prompt is hundreds
// of FLOPs per byte); the cure for the CUDA-core tile's fp32 FMAs is the
// bf16 tensor cores, fed without register or instruction cost:
//   * S = Q.K^T runs as wgmma.m64n64k16 (Q and K K-major in shared
//     memory), O += P.V as wgmma.m64n{dh}k16 with P from registers (the
//     S accumulator fragment is the A fragment of the next product) and
//     V MN-major (transpose bit).  Accumulation is fp32; P is rounded to
//     bf16 for the second product, the row sum l is taken before that.
//   * Mask and online softmax run on the accumulator fragment in
//     registers: log2(e) is folded into the scale, exp2 throughout, row
//     max and sum reduced over the row's four threads by shuffles.
//   * A producer warp walks the key tiles (64 keys), drops every tile
//     none of whose keys any query of the block can see (beyond the
//     causal frontier, wholly before the window, empty slots, padding)
//     before a byte of it is read (reading the positions of 8 tiles at
//     once), and loads the live ones by TMA (128-byte swizzle, the mode
//     the wgmma descriptors name) into a two-stage ring tracked by
//     mbarriers (expect-tx when full, 128 consumer arrivals when free),
//     so the next tile's load overlaps this tile's two products.  A
//     paged tile is 64/P boxes (P <= 64), one a lane, or part of one page
//     (P > 64), at pool rows taken from the page table; boxes past the
//     segment's end come back zero-filled from TMA.
//   * One consumer warpgroup of 128 threads per block and about 82 KB of
//     shared memory at dh = 128, so two blocks share an SM and one's
//     softmax overlaps the other's products.  Blocks start with the
//     latest query tiles, which see the most keys.
// Partials (the chunk kernel on a sequence-parallel shard): with
// Args::part set, the epilogue stores each query row's unnormalised
// state instead of the bf16 output (m in natural-log units, l, and acc
// in fp32, in the layout of paged_attention.cu's combine: m and l (B *
// S, kvs, 1, rep), acc (B * S, kvs, 1, rep, dh)), and Args::skip_self
// drops the contiguous segment (another shard attends the chunk's own
// keys).  The normalised bf16 path is the same code with part null.
// Every head shape of the registered configs: dh in {64, 96, 128, 160,
// 256} and any rep = Hq / kvs up to 64.
//   * A block holds tokens = 64 / rep (rounded down) tokens, tokens * rep
//     live rows; the Q box brings exactly those rows, and the padding
//     rows past them are zeroed before the first product and never
//     stored (rep 3, 5, 40, ... leave 1-4 such rows).
//   * dh 96 and 160 are not whole 64-wide swizzled panels: the tile
//     holds DHP = dh rounded up to 64 columns.  The tensor maps keep the
//     true dh as their inner dimension, so TMA zero-fills the columns
//     past it; Q.K^T runs its k-steps to dh only, P.V runs over DHP
//     columns (zeros past dh) and only dh of them are stored: 33% more
//     P.V work at dh 96, 20% at dh 160.
//   * dh 256: the output fragment is 128 fp32 registers a thread, P.V is
//     two n128 products (one a 128-column half), and the block takes
//     about 162 KB of shared memory, one block an SM.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace rt {
namespace wg {

using namespace hopper;

constexpr int ROWS = 64;       // query rows of a block (one warpgroup tile)
constexpr int BK = 64;         // keys of a tile
constexpr int STAGES = 2;      // K/V ring depth
constexpr int CONSUMERS = 128; // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int PANEL = 64 * 128;          // bytes: 64 rows x 64 bf16, swizzled
constexpr int END = -1;                  // tile info: no more tiles

struct Args {
  const int* q_pos;       // (B, S), or null: position = token index
  __nv_bfloat16* out;     // (B, S, Hq, dh)
  int S, kvs, rep;
  // paged segment (n_pages = 0: none)
  const int* page_table;  // (B, pt_cols)
  const int* kv_pos;      // (B, pt_cols * P)
  int n_pages, pt_cols, P, pool_rows;  // pool_rows = NP * kvs * 2 * P
  // contiguous segment
  const int* k_pos;       // (B, Sk), or null: position = key index
  int Sk;
  int causal, window;
  float scale_log2;       // log2(e) / sqrt(dh)
  // partials instead of the output (null: the normalised output), and
  // whether the contiguous segment is skipped (0: attended)
  float* part;
  int skip_self;
};

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, fp32) (+)= A (64 x 16, smem desc) * B (64 x 16, smem desc)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, smem desc,
// MN-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 registers) * B (16 x 128, smem desc,
// MN-major: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// O (64 x DHP) += P (64 x 16, registers) * V (16 x DHP, the tile's rows
// at v, MN-major): one n64 or n128 product, or an n128 product and one
// for the rest of the columns (the registers of o past 64 are columns
// 128 onward, the fragment's own column order)
template <int DHP>
__device__ __forceinline__ void pv_product(float (&o)[DHP / 2],
                                           const uint32_t (&a)[4],
                                           uint32_t v) {
  const uint64_t lo = sw128_desc(v, PANEL, 1024);
  if constexpr (DHP == 64) {
    wgmma_rs_n64(o, a, lo);
  } else {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[0]), a, lo);
    const uint64_t hi = sw128_desc(v + 2 * PANEL, PANEL, 1024);
    if constexpr (DHP == 192)
      wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(&o[64]), a, hi);
    if constexpr (DHP == 256)
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[64]), a, hi);
  }
}

// ------------------------------------------------------------- layout
// columns of a tile row: dh rounded up to a whole 64-wide panel
template <int DH>
__host__ __device__ constexpr int padded_dh() {
  return (DH + 63) / 64 * 64;
}

// shared memory, from a 1024-byte aligned base (the swizzle atom)
template <int DH>
struct Layout {
  static constexpr int TILE = padded_dh<DH>() * 128;  // 64 rows x DHP bf16
  static constexpr int Q = 0;
  static constexpr int K = Q + TILE;               // STAGES tiles
  static constexpr int V = K + STAGES * TILE;      // STAGES tiles
  static constexpr int BAR = V + STAGES * TILE;    // full, empty, q
  static constexpr int KPOS = BAR + 8 * (2 * STAGES + 2);
  static constexpr int INFO = KPOS + 4 * STAGES * BK;   // (i0, full) each
  static constexpr int QPOS = INFO + 4 * 2 * STAGES;
  static constexpr int BYTES = QPOS + 4 * ROWS;
  static constexpr int ALLOC = BYTES + 1024;       // slack to align
};

__device__ __forceinline__ bool any_visible(int p, int qmin, int qmax,
                                            int causal, int window) {
  return p >= 0 && (!causal || p <= qmax) && (window <= 0 || p > qmin - window);
}

__device__ __forceinline__ bool all_visible(int p, int qmin, int qmax,
                                            int causal, int window) {
  return p >= 0 && (!causal || p <= qmin) && (window <= 0 || p > qmax - window);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, DH <= 128 ? 2 : 1)
    attn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_pool,
                      const Args a) {
  using L = Layout<DH>;
  constexpr int DHP = padded_dh<DH>(), PANELS = DHP / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* qpos = reinterpret_cast<int*>(sm + L::QPOS);
  int* kpos = reinterpret_cast<int*>(sm + L::KPOS);
  int* info = reinterpret_cast<int*>(sm + L::INFO);
  const uint32_t bars = smem_u32(sm + L::BAR);
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t q_bar = bars + 8 * 2 * STAGES;

  const int tid = threadIdx.x;
  const int g = blockIdx.y, b = blockIdx.z;
  const int tokens = ROWS / a.rep, live = tokens * a.rep;
  // heaviest query tiles (latest tokens, most causal keys) first
  const int t0 = (gridDim.x - 1 - blockIdx.x) * tokens;

  // query row r < live: token t0 + r / rep, head g * rep + r % rep; rows
  // past live are padding (no query)
  if (tid < ROWS) {
    const int t = t0 + tid / a.rep;
    qpos[tid] = tid < live && t < a.S
                    ? (a.q_pos ? a.q_pos[(size_t)b * a.S + t] : t)
                    : INT_MIN;
  }
  if (live < ROWS) {
    // the Q box brings the live rows only: zero the padding rows (a
    // whole 128-byte row of every panel, whatever its swizzle) so their
    // products stay finite, and order these generic-proxy stores before
    // the tensor cores' async-proxy reads
    const int4 z = make_int4(0, 0, 0, 0);
    for (int i = tid; i < (ROWS - live) * PANELS * 8; i += THREADS) {
      const int r = live + i / (PANELS * 8), p = i / 8 % PANELS;
      *reinterpret_cast<int4*>(sm + L::Q + p * PANEL + r * 128 +
                               (i % 8) * 16) = z;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), CONSUMERS);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---------------------------------------------------- producer warp
    const int lane = tid - CONSUMERS;
    int qmin = INT_MAX, qmax = INT_MIN;
    for (int r = lane; r < ROWS; r += 32) {
      const int qp = qpos[r];
      if (qp >= 0) {
        qmin = min(qmin, qp);
        qmax = max(qmax, qp);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
      qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
    }
    if (lane == 0) {
      mbar_expect_tx(q_bar, live * DHP * 2);
#pragma unroll
      for (int p = 0; p < PANELS; ++p)
        tma_4d(smem_u32(sm + L::Q + p * PANEL), &tm_q, q_bar, p * 64,
               g * a.rep, t0, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    // Walk tiles [t_lo, t_hi) of a segment whose key i sits at position
    // pos(i) (-1: no key), loading each live one with issue(i0, stage).
    // A round reads the positions of 8 tiles at once (16 coalesced loads
    // a lane, one latency), so a tile no query of the block sees costs a
    // vote and no ring stage.
    auto walk = [&](int t_lo, int t_hi, auto pos, auto issue) {
      constexpr int R = 8;
      for (int tb = t_lo; tb < t_hi; tb += R) {
        int pr[2 * R];  // tile tb + k: key lane at pr[2k], 32 + lane at pr[2k+1]
#pragma unroll
        for (int j = 0; j < 2 * R; ++j)
          pr[j] = tb + j / 2 < t_hi ? pos(tb * BK + 32 * j + lane) : -1;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int p0 = pr[2 * k], p1 = pr[2 * k + 1];
          const bool live = any_visible(p0, qmin, qmax, a.causal, a.window) ||
                            any_visible(p1, qmin, qmax, a.causal, a.window);
          if (!__any_sync(0xffffffffu, live)) continue;
          const int full = __all_sync(
              0xffffffffu, all_visible(p0, qmin, qmax, a.causal, a.window) &&
                               all_visible(p1, qmin, qmax, a.causal, a.window));
          const int i0 = (tb + k) * BK;
          mbar_wait(empty_bar(stage), phase ^ 1);
          // publish the tile's positions and whether every query of the
          // block sees every key, then expect its bytes
          kpos[stage * BK + lane] = p0;
          kpos[stage * BK + 32 + lane] = p1;
          __syncwarp();
          if (lane == 0) {
            info[2 * stage] = i0;
            info[2 * stage + 1] = full;
            mbar_expect_tx(full_bar(stage), 2 * BK * DHP * 2);
          }
          __syncwarp();
          issue(i0, stage);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    };
    if (qmin <= qmax && a.n_pages > 0) {  // paged segment
      const int n = a.n_pages * a.P;
      const int* kvp = a.kv_pos + (size_t)b * a.pt_cols * a.P;
      const int* pt = a.page_table + (size_t)b * a.pt_cols;
      const int boxrows = min(a.P, BK), boxes = BK / boxrows;
      walk(0, (n + BK - 1) / BK,
           [&](int i) { return i < n ? kvp[i] : -1; },
           [&](int i0, int st) {
             // lane j < boxes loads box j: boxrows keys of one page; a
             // box past the segment's end reads as zeros
             const int ik = i0 + lane * boxrows;
             if (lane >= boxes) return;
             const int page = ik < n ? pt[ik / a.P] : -1;
             const int row = page >= 0
                                 ? ((page * a.kvs + g) * 2) * a.P + ik % a.P
                                 : a.pool_rows;
             const int vrow = page >= 0 ? row + a.P : a.pool_rows;
             const uint32_t kd = smem_u32(sm + L::K + st * L::TILE);
             const uint32_t vd = smem_u32(sm + L::V + st * L::TILE);
#pragma unroll
             for (int p = 0; p < PANELS; ++p) {
               const int off = p * PANEL + lane * boxrows * 128;
               tma_2d(kd + off, &tm_pool, full_bar(st), p * 64, row);
               tma_2d(vd + off, &tm_pool, full_bar(st), p * 64, vrow);
             }
           });
    }
    if (qmin <= qmax && !a.skip_self) {  // contiguous segment
      // with positions = indices the causal frontier and the window
      // bound the walk directly
      int lo = 0, hi = a.Sk;
      if (!a.k_pos) {
        if (a.causal) hi = min(hi, qmax + 1);
        if (a.window > 0) lo = max(0, qmin - a.window + 1);
      }
      const int* kp = a.k_pos ? a.k_pos + (size_t)b * a.Sk : nullptr;
      const int Sk = a.Sk;
      walk(lo / BK, (hi + BK - 1) / BK,
           [&](int i) { return i < Sk ? (kp ? kp[i] : i) : -1; },
           [&](int i0, int st) {
             if (lane >= PANELS) return;  // one lane a 64-wide panel
             const int off = lane * PANEL;
             tma_4d(smem_u32(sm + L::K + st * L::TILE) + off, &tm_k,
                    full_bar(st), lane * 64, g, i0, b);
             tma_4d(smem_u32(sm + L::V + st * L::TILE) + off, &tm_v,
                    full_bar(st), lane * 64, g, i0, b);
           });
    }
    mbar_wait(empty_bar(stage), phase ^ 1);
    if (lane == 0) {
      info[2 * stage] = END;
      mbar_arrive(full_bar(stage));
    }
    return;
  }

  // ------------------------------------------------- consumer warpgroup
  const int w = tid / 32, l = tid % 32;
  const int r0 = w * 16 + l / 4, r1 = r0 + 8;  // this thread's two rows
  const int qp0 = qpos[r0], qp1 = qpos[r1];
  float o[DHP / 2];
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const uint32_t q_addr = smem_u32(sm + L::Q);
  mbar_wait(q_bar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(full_bar(stage), phase);
    const int i0 = info[2 * stage];
    if (i0 == END) break;
    const int full = info[2 * stage + 1];
    const uint32_t k_addr = smem_u32(sm + L::K + stage * L::TILE);
    const uint32_t v_addr = smem_u32(sm + L::V + stage * L::TILE);

    // S = Q.K^T: both K-major; a 16-deep step is 32 bytes into a
    // 128-byte swizzled row, four steps to a 64-wide panel; the steps
    // stop at dh (the padded columns are zeros)
    wgmma_fence();
    fence_regs(s);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk / 4) * PANEL + (kk % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(q_addr + off, 16, 1024),
                   sw128_desc(k_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // s[i] is row (i % 4 < 2 ? r0 : r1), key column
    // (i / 4) * 8 + (l % 4) * 2 + i % 2
    if (full) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] *= a.scale_log2;
    } else {
      const int* kp = kpos + stage * BK + (l % 4) * 2;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int2 pp = *reinterpret_cast<const int2*>(kp + j * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const int p = e % 2 ? pp.y : pp.x;
          const int qp = e < 2 ? qp0 : qp1;
          s[i] = qp >= 0 && visible(p, qp, a.causal, a.window)
                     ? s[i] * a.scale_log2
                     : NEG_INF;
        }
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if (i % 4 < 2) mx0 = fmaxf(mx0, s[i]);
      else mx1 = fmaxf(mx1, s[i]);
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if (i % 4 < 2) {
        s[i] = ex2(s[i] - mn0);
        sum0 += s[i];
      } else {
        s[i] = ex2(s[i] - mn1);
        sum1 += s[i];
      }
    }
    l0 = l0 * c0 + sum0;  // this thread's share of the row sums, fp32
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) o[i] *= i % 4 < 2 ? c0 : c1;

    // O += P.V: P's accumulator fragment is the A register fragment of a
    // 16-key step; V is MN-major (dh contiguous), 16 keys = 2048 bytes
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      pv_product<DHP>(o, pa[kk], v_addr + kk * 16 * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(empty_bar(stage));
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // normalise and store: o[i] is row (i % 4 < 2 ? r0 : r1), column
  // (i / 4) * 8 + (l % 4) * 2 + i % 2
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  const int Hq = a.kvs * a.rep;
  if (a.part != nullptr) {
    // the rows' partial states: part index ((b * S + t) * kvs + g) * rep
    // + h, m (log2 units here) as natural log
    const size_t parts = (size_t)gridDim.z * a.S * a.kvs * a.rep;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0, t = t0 + r / a.rep;
      if (r >= live || t >= a.S) continue;
      const size_t i = (((size_t)b * a.S + t) * a.kvs + g) * a.rep + r % a.rep;
      if (l % 4 == 0) {
        a.part[i] = (half ? m1 : m0) * 0.6931471805599453f;
        a.part[parts + i] = half ? l1 : l0;
      }
      float* arow = a.part + 2 * parts + i * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {  // columns past dh are not stored
        const int k = 4 * j + 2 * half;
        *reinterpret_cast<float2*>(arow + j * 8 + (l % 4) * 2) =
            make_float2(o[k], o[k + 1]);
      }
    }
    return;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0, t = t0 + r / a.rep;
    if (r >= live || t >= a.S) continue;
    const float inv = 1.f / fmaxf(half ? l1 : l0, 1e-20f);
    __nv_bfloat16* orow =
        a.out + (((size_t)b * a.S + t) * Hq + g * a.rep + r % a.rep) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {  // columns past dh are not stored
      const int i = 4 * j + 2 * half;
      *reinterpret_cast<uint32_t*>(orow + j * 8 + (l % 4) * 2) =
          pack_bf16(o[i] * inv, o[i + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- host
// q (B, S, kvs*rep, dh); k, v (B, Sk, kvs, dh); pool (NP, kvs, 2, P, dh)
// or null.  Returns a cudaError_t.
template <int DH>
int launch(const Args& a, const void* q, const void* k, const void* v,
           const void* pool, int B, cudaStream_t stream) {
  const cuuint64_t e = 2;  // bytes of a bf16
  const int Hq = a.kvs * a.rep, tokens = ROWS / a.rep;
  CUtensorMap tq, tk, tv, tp;
  memset(&tp, 0, sizeof(tp));
  {
    const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)Hq,
                                (cuuint64_t)a.S, (cuuint64_t)B};
    const cuuint64_t str[3] = {DH * e, Hq * DH * e,
                               (cuuint64_t)a.S * Hq * DH * e};
    const cuuint32_t box[4] = {64, (cuuint32_t)a.rep, (cuuint32_t)tokens, 1};
    if (!encode(&tq, q, 4, dims, str, box)) return (int)cudaErrorInvalidValue;
  }
  {
    const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)a.kvs,
                                (cuuint64_t)a.Sk, (cuuint64_t)B};
    const cuuint64_t str[3] = {DH * e, a.kvs * DH * e,
                               (cuuint64_t)a.Sk * a.kvs * DH * e};
    const cuuint32_t box[4] = {64, 1, BK, 1};
    if (!encode(&tk, k, 4, dims, str, box) ||
        !encode(&tv, v, 4, dims, str, box))
      return (int)cudaErrorInvalidValue;
  }
  if (a.n_pages > 0) {
    const cuuint64_t dims[2] = {(cuuint64_t)DH, (cuuint64_t)a.pool_rows};
    const cuuint64_t str[1] = {DH * e};
    const cuuint32_t box[2] = {64, (cuuint32_t)(a.P < BK ? a.P : BK)};
    if (!encode(&tp, pool, 2, dims, str, box))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      attn_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<DH>::ALLOC);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + tokens - 1) / tokens, a.kvs, B);
  attn_wgmma_kernel<DH><<<grid, THREADS, Layout<DH>::ALLOC, stream>>>(
      tq, tk, tv, tp, a);
  return (int)cudaGetLastError();
}

// the shapes this tile takes: dh in {64, 96, 128, 160, 256}, rep up to
// 64, and a page size that divides 64 or that 64 divides
inline int launch_dh(const Args& a, int dh, const void* q, const void* k,
                     const void* v, const void* pool, int B,
                     cudaStream_t stream) {
  if (a.rep < 1 || a.rep > ROWS) return (int)cudaErrorInvalidValue;
  if (a.n_pages > 0 && a.P > 0 && BK % a.P && a.P % BK)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 64: return launch<64>(a, q, k, v, pool, B, stream);
    case 96: return launch<96>(a, q, k, v, pool, B, stream);
    case 128: return launch<128>(a, q, k, v, pool, B, stream);
    case 160: return launch<160>(a, q, k, v, pool, B, stream);
    case 256: return launch<256>(a, q, k, v, pool, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace rt
