// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::paged_attention
// (pl.pallas_call at :114): one query token per batch row attends over
// the row's pages of the header-centric pool (NP, kvs, 2, P, dh), walked
// in place through the page table (no gather), with an fp32 online
// softmax.  It masks by the POSITIONS stored per slot (pos >= 0,
// pos <= q_pos, window), as the engine's decode does, not by seq_lens:
// decode writes filler into slots that are still prefilling, and those
// must not be attended.
//
// Bound on the H100: bytes.  Each live page's K and V are read once,
// B * ctx * kvs * 2 * dh * bytes in all, and the arithmetic is ~rep FMAs
// per element read — far below the ~295 FLOP/byte ridge.
//
// Two launches on the caller's stream, by dtype:
//   1. split: one block per (kv head g, row b, split s).  At decode batch
//      sizes B * kvs blocks are far too few for the card's 132 SMs, so
//      each row's LIVE page range is cut evenly into the NS splits and
//      each block walks one share.  The block holds the rep query heads
//      of the group, so each page is read once for the whole group.
//      * bf16 (the serving path; namespace bulk): the range is computed
//        on the device from the row's q_pos (the pools put position p in
//        slot p % capacity, so no visible key lies past page q_pos / P,
//        nor before page (q_pos - window + 1) / P when the row has not
//        wrapped; a wrapped row keeps all its pages), so no block walks
//        the empty tail of an 8192-token slot.  A producer warp brings
//        each page with one bulk copy (cp.async.bulk, TMA without a
//        tensor map: a page's K and V of one kv head are 2 * P * dh
//        contiguous elements, 32 KB at P = 64, dh = 128) and its
//        positions with another, into a ring of up to 3 stages of at
//        least 64 keys (several pages when P < 64) tracked by mbarriers,
//        so the next stage lands while this one is scored.  K and V stay
//        bf16 in shared memory.  Four consumer warps take 16-key groups
//        of a stage and score them on the tensor cores (mma.sync, the
//        rep query heads padded to 16 rows, in registers; K read as
//        16-byte rows in a dh order Q shares), keep an fp32 online
//        softmax per warp on the score fragments, and run P.V on the
//        tensor cores too (V by ldmatrix.trans, P as two bf16 terms so
//        that it keeps fp32-like precision); the warps merge at the end.
//      * fp32 (the namespace-level split kernel): capacity splits, one
//        block of dh threads, each page's positions checked and K staged
//        as fp32 before scoring, a page at a time or, where a page does
//        not fit shared memory (dh 256 with 128-token pages), in
//        sub-tiles of it.
//   2. combine: one block per (g, b) merges the splits' partial states
//      - the rescale-and-sum of layers.combine_softmax_partials - and
//      writes the output.
// Sequence-parallel shards (a shard holds pages [page0, page0 + n) of a
// row of n_total pages, with the global positions stored in them) take
// the split launch alone (repro_paged_decode_partials): it writes each
// split's partial state (m in natural-log units, l, unnormalised acc;
// fp32) into a buffer the caller owns, and the bf16 walk cuts the row's
// live range of GLOBAL pages down to the shard's.  The shards' buffers
// are exchanged, and one combine launch (repro_softmax_combine) merges
// any number of part sets a (row, head): the splits of every shard.  The
// chunk-prefill kernel's partials (one split, B * S query rows) go
// through the same combine.  A shard does not combine its own splits
// before the exchange: that would save the exchange NS - 1 of its parts'
// bytes (0.5 MB a layer at the serve shape, a fraction of a microsecond
// of copy) for one more launch a layer and worker, and the decode step
// is bound by launches on the host (PERF.md section 5).
// Head shapes: dh in {64, 96, 128, 160, 256} and rep = Hq / kvs up to 16
// (recurrentgemma-9b's 16 query heads over one kv head).  The bf16
// tensor-core tile holds the rep heads as the rows of its 16-row A
// operand: rows 0-7 when rep <= 8, all 16 (each thread two heads, two
// softmax states) when rep is 9-16.  rep 1-8 at dh 64 and 128 keep
// their own template instances; the other shapes take rep at run time.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int MAX_REP = 16;
constexpr size_t MAX_SMEM = 227 * 1024;

size_t decode_smem_bytes(size_t elem, int dh, int rep, int P) {
  return sizeof(float) * ((size_t)P * (dh + 1) + (size_t)rep * P +
                          (size_t)rep * dh) +
         elem * (size_t)P * dh + sizeof(int) * P;
}

template <typename T, int DH>
__global__ void __launch_bounds__(DH)
    paged_decode_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ pool,
                              const int* __restrict__ page_table,
                              const int* __restrict__ kv_pos,
                              const int* __restrict__ q_pos,
                              float* __restrict__ part_m,
                              float* __restrict__ part_l,
                              float* __restrict__ part_acc, int kvs,
                              int rep, int P, int n, int pps, int window,
                              float scale, int SUB) {
  // a page is taken in P / SUB sub-tiles of SUB keys (SUB = P when it
  // fits shared memory)
  constexpr int NW = DH / 32;               // warps
  constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte load
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* s_v = reinterpret_cast<T*>(s_raw);                        // (SUB, DH)
  float* s_k = reinterpret_cast<float*>(s_v + (size_t)SUB * DH);  // +1 pad
  float* s_sc = s_k + (size_t)SUB * (DH + 1);                  // (rep, SUB)
  float* s_q = s_sc + (size_t)rep * SUB;                       // (rep, DH)
  int* s_pos = reinterpret_cast<int*>(s_q + (size_t)rep * DH);  // (SUB,)
  __shared__ float s_m[MAX_REP], s_l[MAX_REP], s_c[MAX_REP];

  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int NS = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = kvs * rep;
  const int qp = q_pos[b];

  for (int i = tid; i < rep * DH; i += DH)
    s_q[i] = rt::to_f(q[((size_t)b * Hq + g * rep) * DH + i]) * scale;
  if (tid < MAX_REP) {
    s_m[tid] = rt::NEG_INF;
    s_l[tid] = 0.f;
  }
  float acc[MAX_REP] = {};
  __syncthreads();

  const int j0 = split * pps, j1 = min(n, j0 + pps);
  for (int jt = j0 * (P / SUB); jt < j1 * (P / SUB); ++jt) {
    const int j = jt / (P / SUB), p0 = jt % (P / SUB) * SUB;
    const int* pj = kv_pos + ((size_t)b * n + j) * P + p0;
    int live = 0;
    for (int p = tid; p < SUB; p += DH) {
      const int ps = pj[p];
      s_pos[p] = ps;
      live |= rt::visible(ps, qp, 1, window);
    }
    if (!__syncthreads_or(live)) continue;

    const size_t page = page_table[(size_t)b * n + j];
    const T* kb = pool + ((page * kvs + g) * 2) * (size_t)P * DH;
    const int4* k4 = reinterpret_cast<const int4*>(kb + (size_t)p0 * DH);
    const int4* v4 =
        reinterpret_cast<const int4*>(kb + (size_t)(P + p0) * DH);
    const int n4 = SUB * DH / VEC;             // 16-byte chunks of K (or V)
#pragma unroll 4
    for (int i = tid; i < n4; i += DH) {
      const int4 kc = k4[i];
      reinterpret_cast<int4*>(s_v)[i] = v4[i];
      const T* ke = reinterpret_cast<const T*>(&kc);
      const int off = i * VEC, p = off / DH, c = off % DH;
#pragma unroll
      for (int e = 0; e < VEC; ++e) s_k[p * (DH + 1) + c + e] = rt::to_f(ke[e]);
    }
    __syncthreads();

    for (int idx = tid; idx < rep * SUB; idx += DH) {
      const int p = idx % SUB, h = idx / SUB;
      const float* kr = s_k + p * (DH + 1);
      const float* qr = s_q + h * DH;
      float d = 0.f;
#pragma unroll 8
      for (int c = 0; c < DH; ++c) d = fmaf(qr[c], kr[c], d);
      s_sc[h * SUB + p] =
          rt::visible(s_pos[p], qp, 1, window) ? d : rt::NEG_INF;
    }
    __syncthreads();

    for (int h = warp; h < rep; h += NW) {
      float* row = s_sc + h * SUB;
      const float m_old = s_m[h];
      float mx = rt::NEG_INF;
      for (int p = lane; p < SUB; p += 32) mx = fmaxf(mx, row[p]);
      const float m_new = fmaxf(m_old, rt::warp_max(mx));
      float sum = 0.f;
      for (int p = lane; p < SUB; p += 32) {
        const float e = expf(row[p] - m_new);
        row[p] = e;
        sum += e;
      }
      sum = rt::warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_c[h] = corr;
        s_l[h] = s_l[h] * corr + sum;
        s_m[h] = m_new;
      }
    }
    __syncthreads();

    float pv[MAX_REP] = {};
    for (int p = 0; p < SUB; ++p) {
      const float vv = rt::to_f(s_v[p * DH + tid]);
#pragma unroll
      for (int h = 0; h < MAX_REP; ++h)
        if (h < rep) pv[h] = fmaf(s_sc[h * SUB + p], vv, pv[h]);
    }
#pragma unroll
    for (int h = 0; h < MAX_REP; ++h)
      if (h < rep) acc[h] = acc[h] * s_c[h] + pv[h];
    __syncthreads();
  }

  // this split's partial state; a split with no visible key leaves
  // (m, l, acc) = (NEG_INF, 0, 0), which the combine weighs as nothing
  const size_t base = ((size_t)b * kvs + g) * NS + split;
#pragma unroll
  for (int h = 0; h < MAX_REP; ++h) {
    if (h >= rep) break;
    if (tid == 0) {
      part_m[base * rep + h] = s_m[h];
      part_l[base * rep + h] = s_l[h];
    }
    part_acc[(base * rep + h) * DH + tid] = acc[h];
  }
}

// the merge of `sets` sets of NS partial states a (row b, kv head g,
// head h): set z's parts start `set_stride` floats after set z - 1's
template <typename T, int DH>
__global__ void __launch_bounds__(DH)
    paged_decode_combine_kernel(const float* __restrict__ part_m,
                                const float* __restrict__ part_l,
                                const float* __restrict__ part_acc,
                                T* __restrict__ out, int kvs, int rep,
                                int NS, int sets, size_t set_stride) {
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int Hq = kvs * rep;
  const size_t base = ((size_t)b * kvs + g) * NS;
  for (int h = 0; h < rep; ++h) {
    float m = rt::NEG_INF;
    for (int z = 0; z < sets; ++z)
      for (int s = 0; s < NS; ++s)
        m = fmaxf(m, part_m[z * set_stride + (base + s) * rep + h]);
    float l = 0.f, a = 0.f;
    for (int z = 0; z < sets; ++z)
      for (int s = 0; s < NS; ++s) {
        const size_t i = (base + s) * rep + h, o = z * set_stride;
        const float corr = expf(part_m[o + i] - m);
        l += part_l[o + i] * corr;
        a += part_acc[o + i * DH + tid] * corr;
      }
    out[((size_t)b * Hq + g * rep + h) * DH + tid] =
        rt::from_f<T>(a / fmaxf(l, 1e-20f));
  }
}

// the fp32 kernel's sub-tile: the largest divisor of P (a whole page
// first) whose stage fits shared memory; 0 if none does
inline int sub_tile(size_t elem, int dh, int rep, int P) {
  for (int sub = P; sub >= 1; --sub)
    if (P % sub == 0 && (sub * dh) % 4 == 0 &&
        decode_smem_bytes(elem, dh, rep, sub) <= MAX_SMEM)
      return sub;
  return 0;
}

// the split launch (and, with out, the combine of its NS splits); the
// fp32 walk splits the shard's capacity and masks by position, so it
// needs no page offset
template <typename T, int DH>
int launch(const void* q, const void* pool, const int* page_table,
           const int* kv_pos, const int* q_pos, float* part_m,
           float* part_l, float* part_acc, void* out, int B, int kvs,
           int rep, int P, int n, int NS, int window, int page0,
           int n_total, cudaStream_t stream) {
  const int sub = sub_tile(sizeof(T), DH, rep, P);
  const size_t smem = decode_smem_bytes(sizeof(T), DH, rep, sub);
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_split_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int pps = (n + NS - 1) / NS;
  paged_decode_split_kernel<T, DH><<<dim3(kvs, B, NS), DH, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool), page_table,
      kv_pos, q_pos, part_m, part_l, part_acc, kvs, rep, P, n, pps, window,
      1.0f / sqrtf((float)DH), sub);
  e = cudaGetLastError();
  if (e != cudaSuccess || out == nullptr) return (int)e;
  paged_decode_combine_kernel<T, DH><<<dim3(kvs, B), DH, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), kvs, rep, NS, 1, 0);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ bf16, bulk-copied ring
namespace bulk {
using namespace rt::hopper;
using bf16 = __nv_bfloat16;

constexpr int NW = 4;                     // consumer warps
constexpr int THREADS = NW * 32 + 32;     // + the producer warp
constexpr int MIN_KEYS = 64;              // keys of a ring stage, at least
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) as two bf16 pairs whose sum carries about 16 bits of each:
// hi = bf16(x, y), lo = bf16 of the rounding error
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// D (16 x 8, fp32) += A (16 x 16, bf16) * B (16 x 8, bf16): a0 / a2 hold
// rows 0-7 (the first 8 query heads), a1 / a3 rows 8-15 (heads 8-15)
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the same with rows 8-15 of A zero (a1 = a3 = 0): rep <= 8 query heads
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  mma16816(d, a0, 0u, a2, 0u, b0, b1);
}

// four 8x8 bf16 matrices, transposed, from the 16-byte rows whose
// addresses lanes 8i..8i+7 give for matrix i
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The row's live pages [lo, hi) among the shard's n, pages [page0,
// page0 + n) of the row's n_total: the pools put position p in slot
// p % capacity (capacity = n_total * P), so with no wrap (q_pos <
// capacity) a key visible at q_pos sits in a slot <= q_pos, and with a
// window in a slot > q_pos - window; a wrapped row keeps every page.  A
// bound on the walk, not a mask: the masks stay those of the positions.
__device__ __forceinline__ void live_pages(int qp, int n, int P, int window,
                                           int page0, int n_total, int& lo,
                                           int& hi) {
  int glo, ghi;
  if (qp < 0) {
    glo = ghi = 0;
  } else if (qp >= n_total * P) {
    glo = 0;
    ghi = n_total;
  } else {
    ghi = qp / P + 1;
    glo = window > 0 ? max(0, qp - window + 1) / P : 0;
  }
  lo = min(max(glo - page0, 0), n);
  hi = max(min(ghi - page0, n), lo);
}

// split `split` of NS's even share [j0, j1) of the row's live pages
__device__ __forceinline__ void split_range(int qp, int n, int P, int window,
                                            int page0, int n_total,
                                            int split, int NS, int& j0,
                                            int& j1) {
  int lo, hi;
  live_pages(qp, n, P, window, page0, n_total, lo, hi);
  j0 = lo + (int)((long long)split * (hi - lo) / NS);
  j1 = lo + (int)((long long)(split + 1) * (hi - lo) / NS);
}

// the walk alone: each (row, split)'s page range, as the kernel cuts it
__global__ void walk_kernel(const int* __restrict__ q_pos,
                            int* __restrict__ ranges, int B, int n, int P,
                            int window, int page0, int n_total, int NS) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * NS) return;
  split_range(q_pos[i / NS], n, P, window, page0, n_total, i % NS, NS,
              ranges[2 * i], ranges[2 * i + 1]);
}

// bytes of one page in the ring: K and V of one kv head, then the P
// positions; a stage holds max(1, 64 / P) pages
__host__ __device__ inline size_t page_bytes(int dh, int P) {
  return (size_t)P * dh * 4 + (size_t)P * 4;
}
__host__ __device__ inline int pages_per_stage(int P) {
  return P < MIN_KEYS ? MIN_KEYS / P : 1;
}
// bytes of the cross-warp merge (reuses the ring)
__host__ __device__ inline size_t merge_bytes(int dh, int rep) {
  return (size_t)NW * rep * (dh + 2) * 4;
}

// REP: the rep of an instance of its own (1-8 at dh 64 and 128, the
// shapes of the earlier slices), or a run-time rep: ANY_8 (1-8, heads in
// rows 0-7) or ANY_16 (9-16, both row halves)
constexpr int ANY_8 = 0, ANY_16 = -1;

template <int DH, int REP>
__global__ void __launch_bounds__(THREADS,
                                  DH <= 128 && REP >= ANY_8 ? 2 : 1)
    paged_decode_bulk_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ pool,
                             const int* __restrict__ page_table,
                             const int* __restrict__ kv_pos,
                             const int* __restrict__ q_pos,
                             float* __restrict__ part_m,
                             float* __restrict__ part_l,
                             float* __restrict__ part_acc, int kvs, int P,
                             int n, int stages, int window, int page0,
                             int n_total, float scale_log2, int rep_rt) {
  // TWO: heads 8-15 in rows 8-15 of the A operand, a second softmax state
  constexpr bool TWO = REP == ANY_16;
  const int rep = REP > 0 ? REP : rep_rt;
  extern __shared__ __align__(128) uint8_t smem[];
  const int pps = pages_per_stage(P);
  const size_t pb = page_bytes(DH, P), stage_b = pps * pb;
  // the ring (reused by the merge at the end), then the barriers
  const size_t merge_b = merge_bytes(DH, rep);
  const size_t ring_b = stages * stage_b > merge_b ? stages * stage_b
                                                   : merge_b;
  const uint32_t bars = smem_u32(smem + ring_b);
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (stages + s); };

  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int NS = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int qp = q_pos[b];
  // this split's even share of the live range, in stages of pps pages
  int j0, j1;
  split_range(qp, n, P, window, page0, n_total, split, NS, j0, j1);
  const int n_stages = (j1 - j0 + pps - 1) / pps;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), NW * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (w == NW) {
    // ---------------------------------------------------- producer warp
    // one bulk copy a page (K and V of head g are contiguous) and one for
    // its positions; a stage's pages past the split's end repeat its
    // first page (finite bytes) and are masked by the consumers
    if (lane != 0) return;
    const int* pt = page_table + (size_t)b * n;
    for (int i = 0, s = 0, ph = 0; i < n_stages; ++i) {
      mbar_wait(empty_bar(s), ph ^ 1);
      mbar_expect_tx(full_bar(s), (uint32_t)stage_b);
      for (int k = 0; k < pps; ++k) {
        const int j = min(j0 + i * pps + k, j1 - 1);
        const size_t page = pt[j];
        const uint32_t dst = smem_u32(smem + s * stage_b + k * pb);
        bulk_copy(dst, pool + ((page * kvs + g) * 2) * (size_t)P * DH,
                  P * DH * 4, full_bar(s));
        bulk_copy(dst + P * DH * 4, kv_pos + ((size_t)b * n + j) * P,
                  P * 4, full_bar(s));
      }
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // ------------------------------------------------------ consumer warps
  // Tensor cores (mma.sync m16n8k16), the rep query heads as rows 0..7
  // of the A operand (rows 8-15 zero; with TWO, heads 8..15 there).
  // Scoring on the CUDA cores instead (16-byte K reads, lanes splitting
  // dh, the dot products reduced by shuffles) was right but bound by its
  // own instructions, about 7 us a 64-key page a block on an H100 80GB
  // HBM3 (700 W); this walk issues some 150 instructions a page a warp,
  // and the 3/4 of each tensor-core tile that the padding rows waste
  // costs nothing the bytes bound would notice.  Thread (gr = lane / 4,
  // qd = lane % 4) holds head gr.  S = Q.K^T contracts over dh in a
  // permuted order that both operands share: step kk = 2j + s takes dh
  // 8 (qd + 4j) + 4s + {0,1} (A cols / B rows 2qd, 2qd+1) and + {2,3}
  // (2qd+8, 2qd+9), so a thread's K fragment of a key is 16-byte loads
  // of 8 dh each.  O += P.V takes P from the S fragments (FA2's register
  // reuse) and V by ldmatrix.trans.  With TWO the thread also holds head
  // gr + 8 (a1 / a3 of the A fragments, c2 / c3 of the accumulators).
  const int gr = lane / 4, qd = lane % 4;
  constexpr int J = DH / 32;            // 16-byte chunks a thread's key
  constexpr int NT = DH / 8;            // n8 tiles of the output
  const int Hq = kvs * rep;
  uint32_t qa[J][4];                    // (a0, a2) of steps 2j and 2j+1
  uint32_t qb[TWO ? J : 1][4];          // (a1, a3) of them: head gr + 8
#pragma unroll
  for (int j = 0; j < J; ++j) {
    int4 v = make_int4(0, 0, 0, 0);
    if (gr < rep)
      v = *reinterpret_cast<const int4*>(
          q + ((size_t)b * Hq + g * rep + gr) * DH + 8 * (qd + 4 * j));
    qa[j][0] = v.x;
    qa[j][1] = v.y;
    qa[j][2] = v.z;
    qa[j][3] = v.w;
    if constexpr (TWO) {
      int4 w2 = make_int4(0, 0, 0, 0);
      if (gr + 8 < rep)
        w2 = *reinterpret_cast<const int4*>(
            q + ((size_t)b * Hq + g * rep + gr + 8) * DH + 8 * (qd + 4 * j));
      qb[j][0] = w2.x;
      qb[j][1] = w2.y;
      qb[j][2] = w2.z;
      qb[j][3] = w2.w;
    }
  }
  float o[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[t][i] = 0.f;
  float m = rt::NEG_INF, l = 0.f;   // head gr; l is this thread's share
  float m1 = rt::NEG_INF, l1 = 0.f; // head gr + 8 (TWO)

  const int groups = pps * P / 16;      // 16-key groups of a stage
  for (int i = 0, s = 0, ph = 0; i < n_stages; ++i) {
    mbar_wait(full_bar(s), ph);
    const int keys = min(pps, j1 - j0 - i * pps) * P;  // real keys
    const uint8_t* st = smem + s * stage_b;
    for (int grp = w; grp < groups; grp += NW) {
      const int k0 = grp * 16;
      if (k0 >= keys) break;
      const uint8_t* pg = st + (k0 / P) * pb;   // the group's page
      const int r0 = k0 % P;                    // its first key there
      const bf16* K = reinterpret_cast<const bf16*>(pg);
      const int* pos = reinterpret_cast<const int*>(pg + P * DH * 4);
      // scores of keys r0 + {2qd, 2qd+1} (sc[0..1]) and r0 + 8 + ...
      float sc[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int4* kr = reinterpret_cast<const int4*>(
            K + (size_t)(r0 + 8 * h + gr) * DH + 8 * qd);
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) sc[h][i2] = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int4 kv = kr[4 * j];
          if constexpr (TWO) {
            mma16816(sc[h], qa[j][0], qb[j][0], qa[j][1], qb[j][1], kv.x,
                     kv.y);
            mma16816(sc[h], qa[j][2], qb[j][2], qa[j][3], qb[j][3], kv.z,
                     kv.w);
          } else {
            mma16816(sc[h], qa[j][0], qa[j][1], kv.x, kv.y);
            mma16816(sc[h], qa[j][2], qa[j][3], kv.z, kv.w);
          }
        }
      }
      if constexpr (TWO) {
        // two heads a thread: sc[h][0..1] head gr, sc[h][2..3] head gr + 8
        float mx0 = m, mx1 = m1;
        bool vis[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = r0 + 8 * h + 2 * qd + e;
            vis[h][e] = k0 + 8 * h + 2 * qd + e < keys &&
                        rt::visible(pos[r], qp, 1, window);
            sc[h][e] *= scale_log2;
            sc[h][2 + e] *= scale_log2;
            if (vis[h][e]) {
              mx0 = fmaxf(mx0, sc[h][e]);
              mx1 = fmaxf(mx1, sc[h][2 + e]);
            }
          }
#pragma unroll
        for (int o2 = 1; o2 <= 2; o2 <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
        }
        const float corr0 = ex2(m - mx0), corr1 = ex2(m1 - mx1);
        m = mx0;
        m1 = mx1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[h][e] = vis[h][e] ? ex2(sc[h][e] - mx0) : 0.f;
            sc[h][2 + e] = vis[h][e] ? ex2(sc[h][2 + e] - mx1) : 0.f;
            sum0 += sc[h][e];
            sum1 += sc[h][2 + e];
          }
        l = l * corr0 + sum0;
        l1 = l1 * corr1 + sum1;
        // P as bf16 high and low parts, rows gr (a0 / a2) and gr + 8
        // (a1 / a3)
        uint32_t phi[4], plo[4];
        split_bf16(sc[0][0], sc[0][1], phi[0], plo[0]);
        split_bf16(sc[0][2], sc[0][3], phi[1], plo[1]);
        split_bf16(sc[1][0], sc[1][1], phi[2], plo[2]);
        split_bf16(sc[1][2], sc[1][3], phi[3], plo[3]);
        const uint32_t vaddr = smem_u32(
            pg + P * DH * 2 +
            ((size_t)(r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * DH +
             8 * (lane >> 4)) * 2);
#pragma unroll
        for (int t = 0; t < NT; t += 2) {
          uint32_t vb[4];
          ldsm_x4_t(vb, vaddr + t * 16);
#pragma unroll
          for (int i2 = 0; i2 < 4; ++i2) {
            o[t][i2] *= i2 < 2 ? corr0 : corr1;
            o[t + 1][i2] *= i2 < 2 ? corr0 : corr1;
          }
          mma16816(o[t], phi[0], phi[1], phi[2], phi[3], vb[0], vb[1]);
          mma16816(o[t], plo[0], plo[1], plo[2], plo[3], vb[0], vb[1]);
          mma16816(o[t + 1], phi[0], phi[1], phi[2], phi[3], vb[2], vb[3]);
          mma16816(o[t + 1], plo[0], plo[1], plo[2], plo[3], vb[2], vb[3]);
        }
        continue;
      }
      float mx = m;
      bool vis[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + 8 * h + 2 * qd + e;
          vis[h][e] = k0 + 8 * h + 2 * qd + e < keys &&
                      rt::visible(pos[r], qp, 1, window);
          sc[h][e] *= scale_log2;
          if (vis[h][e]) mx = fmaxf(mx, sc[h][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = ex2(m - mx);
      m = mx;
      float sum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[h][e] = vis[h][e] ? ex2(sc[h][e] - mx) : 0.f;
          sum += sc[h][e];
        }
      l = l * corr + sum;
      // P as bf16 high and low parts: rounding P to one bf16 alone would
      // move outputs by more than the one bf16 ulp the checks allow
      uint32_t ph0, pl0, ph2, pl2;
      split_bf16(sc[0][0], sc[0][1], ph0, pl0);
      split_bf16(sc[1][0], sc[1][1], ph2, pl2);
      // V rows r0 + (lane % 8) + 8 * ((lane / 8) & 1), dh + 8 * (lane / 16)
      const uint32_t vaddr = smem_u32(
          pg + P * DH * 2 +
          ((size_t)(r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * DH +
           8 * (lane >> 4)) * 2);
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vaddr + t * 16);
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) {
          o[t][i2] *= corr;
          o[t + 1][i2] *= corr;
        }
        mma16816(o[t], ph0, ph2, vb[0], vb[1]);
        mma16816(o[t], pl0, pl2, vb[0], vb[1]);
        mma16816(o[t + 1], ph0, ph2, vb[2], vb[3]);
        mma16816(o[t + 1], pl0, pl2, vb[2], vb[3]);
      }
    }
    __syncwarp();
    mbar_arrive(empty_bar(s));
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }
  // l: sum the quad's shares
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if constexpr (TWO) {
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  }

  // every consumer is past the ring (each waited for every stage), so the
  // merge of the warps reuses its bytes
  asm volatile("bar.sync 1, %0;\n" ::"n"(NW * 32) : "memory");
  float* sm_m = reinterpret_cast<float*>(smem);       // (NW, rep)
  float* sm_l = sm_m + NW * rep;                      // (NW, rep)
  float* sm_a = sm_l + NW * rep;                      // (NW, rep, DH)
  if (gr < rep) {
    // o[t][0..1]: head gr, dh 8t + 2qd + {0, 1}
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      sm_a[(w * rep + gr) * DH + 8 * t + 2 * qd] = o[t][0];
      sm_a[(w * rep + gr) * DH + 8 * t + 2 * qd + 1] = o[t][1];
    }
    if (qd == 0) {
      sm_m[w * rep + gr] = m;
      sm_l[w * rep + gr] = l;
    }
  }
  if (TWO && gr + 8 < rep) {
    // o[t][2..3]: head gr + 8
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      sm_a[(w * rep + gr + 8) * DH + 8 * t + 2 * qd] = o[t][2];
      sm_a[(w * rep + gr + 8) * DH + 8 * t + 2 * qd + 1] = o[t][3];
    }
    if (qd == 0) {
      sm_m[w * rep + gr + 8] = m1;
      sm_l[w * rep + gr + 8] = l1;
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(NW * 32) : "memory");
  // this split's partial state, m in natural-log units for the combine;
  // a split with no visible key leaves (NEG_INF ln 2, 0, 0), which the
  // combine weighs as nothing
  const size_t base = (((size_t)b * kvs + g) * NS + split) * rep;
  for (int e = tid; e < rep * DH; e += NW * 32) {
    const int h = e / DH, c = e % DH;
    float mx = rt::NEG_INF;
#pragma unroll
    for (int x = 0; x < NW; ++x) mx = fmaxf(mx, sm_m[x * rep + h]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int x = 0; x < NW; ++x) {
      const float cr = ex2(sm_m[x * rep + h] - mx);
      ls += sm_l[x * rep + h] * cr;
      as += sm_a[(x * rep + h) * DH + c] * cr;
    }
    part_acc[(base + h) * DH + c] = as;
    if (c == 0) {
      part_m[base + h] = mx * LN2;
      part_l[base + h] = ls;
    }
  }
}

// threads of a combine block: one per (head, dh element) for an
// instance of its own rep, else 512 walking them
__host__ __device__ constexpr int combine_threads(int dh, int rep) {
  return rep > 0 ? rep * dh : 512;
}

// the merge for bf16 of `sets` sets of NS partial states (set z's parts
// `set_stride` floats after set z - 1's): one block per (kv head, row),
// a thread per (head, dh element), every head at once
template <int DH, int REP>
__global__ void __launch_bounds__(combine_threads(DH, REP))
    combine_kernel(const float* __restrict__ part_m,
                   const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, bf16* __restrict__ out,
                   int kvs, int NS, int rep_rt, int sets,
                   size_t set_stride) {
  const int rep = REP > 0 ? REP : rep_rt;
  const int g = blockIdx.x, b = blockIdx.y;
  const size_t base = ((size_t)b * kvs + g) * NS;
  for (int e = threadIdx.x; e < rep * DH; e += combine_threads(DH, REP)) {
    const int h = e / DH, c = e % DH;
    float m = rt::NEG_INF;
    for (int z = 0; z < sets; ++z)
      for (int s = 0; s < NS; ++s)
        m = fmaxf(m, part_m[z * set_stride + (base + s) * rep + h]);
    float l = 0.f, a = 0.f;
    for (int z = 0; z < sets; ++z)
#pragma unroll 4
      for (int s = 0; s < NS; ++s) {
        const size_t i = (base + s) * rep + h, o = z * set_stride;
        const float corr = expf(part_m[o + i] - m);
        l += part_l[o + i] * corr;
        a += part_acc[o + i * DH + c] * corr;
      }
    out[((size_t)b * kvs * rep + g * rep + h) * DH + c] =
        __float2bfloat16(a / fmaxf(l, 1e-20f));
  }
}

// the ring depth a launch uses: 3 stages, or fewer where a stage is
// large; 0 if even one does not fit
inline int ring_stages(int dh, int rep, int P) {
  const size_t sb = pages_per_stage(P) * page_bytes(dh, P);
  const size_t mb = merge_bytes(dh, rep);
  for (int s = 3; s >= 1; --s)
    if (std::max(s * sb, mb) + 16 * s <= MAX_SMEM) return s;
  return 0;
}

template <int DH, int REP>
int launch(const void* q, const void* pool, const int* pt, const int* kv_pos,
           const int* q_pos, float* pm, float* pl, float* pa, void* out,
           int B, int kvs, int rep, int P, int n, int NS, int window,
           int page0, int n_total, cudaStream_t stream) {
  const int stages = ring_stages(DH, rep, P);
  const size_t smem = std::max(stages * pages_per_stage(P) *
                                   page_bytes(DH, P),
                               merge_bytes(DH, rep)) +
                      16 * stages;
  auto kern = paged_decode_bulk_kernel<DH, REP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(kvs, B, NS), THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pool), pt,
      kv_pos, q_pos, pm, pl, pa, kvs, P, n, stages, window, page0, n_total,
      1.4426950408889634f / sqrtf((float)DH), rep);
  e = cudaGetLastError();
  if (e != cudaSuccess || out == nullptr) return (int)e;
  combine_kernel<DH, REP>
      <<<dim3(kvs, B), combine_threads(DH, REP), 0, stream>>>(
          pm, pl, pa, static_cast<bf16*>(out), kvs, NS, rep, 1, 0);
  return (int)cudaGetLastError();
}

// the combine alone, over `sets` part sets: its own instance for rep 1-8
// at dh 64 and 128, else the run-time rep (any rep)
template <int DH>
int combine(const float* pm, const float* pl, const float* pa, void* out,
            int rows, int kvs, int rep, int NS, int sets, size_t stride,
            cudaStream_t st) {
  if constexpr (DH == 64 || DH == 128) {
    switch (rep) {
#define REPRO_REP(R)                                                       \
  case R:                                                                  \
    combine_kernel<DH, R><<<dim3(kvs, rows), combine_threads(DH, R), 0,    \
                            st>>>(pm, pl, pa, static_cast<bf16*>(out), kvs, \
                                  NS, R, sets, stride);                    \
    return (int)cudaGetLastError();
      REPRO_REP(1) REPRO_REP(2) REPRO_REP(3) REPRO_REP(4)
      REPRO_REP(5) REPRO_REP(6) REPRO_REP(7) REPRO_REP(8)
#undef REPRO_REP
    }
  }
  combine_kernel<DH, ANY_8><<<dim3(kvs, rows), combine_threads(DH, ANY_8),
                              0, st>>>(pm, pl, pa, static_cast<bf16*>(out),
                                       kvs, NS, rep, sets, stride);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_rep(int rep, const void* q, const void* pool, const int* pt,
               const int* kv_pos, const int* q_pos, float* pm, float* pl,
               float* pa, void* out, int B, int kvs, int P, int n, int NS,
               int window, int page0, int n_total, cudaStream_t st) {
  if (rep > 8)
    return launch<DH, ANY_16>(q, pool, pt, kv_pos, q_pos, pm, pl, pa, out,
                              B, kvs, rep, P, n, NS, window, page0, n_total,
                              st);
  if constexpr (DH != 64 && DH != 128) {
    return launch<DH, ANY_8>(q, pool, pt, kv_pos, q_pos, pm, pl, pa, out,
                             B, kvs, rep, P, n, NS, window, page0, n_total,
                             st);
  } else {
    switch (rep) {
#define REPRO_REP(R)                                                       \
  case R:                                                                  \
    return launch<DH, R>(q, pool, pt, kv_pos, q_pos, pm, pl, pa, out, B,   \
                         kvs, R, P, n, NS, window, page0, n_total, st);
      REPRO_REP(1) REPRO_REP(2) REPRO_REP(3) REPRO_REP(4)
      REPRO_REP(5) REPRO_REP(6) REPRO_REP(7) REPRO_REP(8)
#undef REPRO_REP
    }
    return (int)cudaErrorInvalidValue;
  }
}
}  // namespace bulk

// fp32: the CUDA-core split kernel; bf16: the bulk-copied ring
template <int DH>
int launch_dtype(int dtype, const void* q, const void* pool, const int* pt,
                 const int* kv_pos, const int* q_pos, float* pm, float* pl,
                 float* pa, void* out, int B, int kvs, int rep, int P, int n,
                 int NS, int window, int page0, int n_total,
                 cudaStream_t stream) {
  if (dtype == rt::DT_F32)
    return launch<float, DH>(q, pool, pt, kv_pos, q_pos, pm, pl, pa, out, B,
                             kvs, rep, P, n, NS, window, page0, n_total,
                             stream);
  if (dtype == rt::DT_BF16)
    return bulk::launch_rep<DH>(rep, q, pool, pt, kv_pos, q_pos, pm, pl, pa,
                                out, B, kvs, P, n, NS, window, page0,
                                n_total, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_dh(int dtype, int dh, const void* q, const void* pool,
              const int* pt, const int* kv_pos, const int* q_pos, float* pm,
              float* pl, float* pa, void* out, int B, int kvs, int rep,
              int P, int n, int NS, int window, int page0, int n_total,
              cudaStream_t stream) {
  switch (dh) {
#define REPRO_DH(D)                                                         \
  case D:                                                                   \
    return launch_dtype<D>(dtype, q, pool, pt, kv_pos, q_pos, pm, pl, pa,   \
                           out, B, kvs, rep, P, n, NS, window, page0,       \
                           n_total, stream);
    REPRO_DH(64) REPRO_DH(96) REPRO_DH(128) REPRO_DH(160) REPRO_DH(256)
#undef REPRO_DH
  }
  return (int)cudaErrorInvalidValue;
}

template <int DH>
int combine_dtype(int dtype, const float* pm, const float* pl,
                  const float* pa, void* out, int rows, int kvs, int rep,
                  int NS, int sets, size_t stride, cudaStream_t st) {
  if (dtype == rt::DT_F32) {
    paged_decode_combine_kernel<float, DH><<<dim3(kvs, rows), DH, 0, st>>>(
        pm, pl, pa, static_cast<float*>(out), kvs, rep, NS, sets, stride);
    return (int)cudaGetLastError();
  }
  if (dtype == rt::DT_BF16)
    return bulk::combine<DH>(pm, pl, pa, out, rows, kvs, rep, NS, sets,
                             stride, st);
  return (int)cudaErrorInvalidValue;
}

int check_args(int rep, int dh, int P, int n, int NS, int dtype) {
  if (rep < 1 || rep > MAX_REP || NS < 1 || NS > n)
    return (int)cudaErrorInvalidValue;
  if (dtype == rt::DT_F32 && sub_tile(4, dh, rep, P) == 0)
    return (int)cudaErrorInvalidValue;
  // the tensor-core walk takes 16-key groups inside a page
  if (dtype == rt::DT_BF16 && (P % 16 || bulk::ring_stages(dh, rep, P) == 0))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// part_m, part_l: (B, kvs, NS, rep) fp32 scratch; part_acc: (B, kvs, NS,
// rep, dh) fp32 scratch; NS splits of the row's n pages (1 <= NS <= n)
extern "C" int repro_paged_decode(const void* q, const void* pool,
                                  const int* page_table, const int* kv_pos,
                                  const int* q_pos, void* part_m,
                                  void* part_l, void* part_acc, void* out,
                                  int B, int kvs, int rep, int dh, int P,
                                  int n, int NS, int window, int dtype,
                                  void* stream) {
  if (int e = check_args(rep, dh, P, n, NS, dtype)) return e;
  return launch_dh(dtype, dh, q, pool, page_table, kv_pos, q_pos,
                   static_cast<float*>(part_m), static_cast<float*>(part_l),
                   static_cast<float*>(part_acc), out, B, kvs, rep, P, n, NS,
                   window, 0, n, static_cast<cudaStream_t>(stream));
}

// The split launch alone, on a shard holding pages [page0, page0 + n) of
// rows of n_total pages: part_m, part_l (B, kvs, NS, rep) and part_acc
// (B, kvs, NS, rep, dh), fp32, m in natural-log units, acc unnormalised
extern "C" int repro_paged_decode_partials(
    const void* q, const void* pool, const int* page_table,
    const int* kv_pos, const int* q_pos, void* part_m, void* part_l,
    void* part_acc, int B, int kvs, int rep, int dh, int P, int n, int NS,
    int window, int page0, int n_total, int dtype, void* stream) {
  if (int e = check_args(rep, dh, P, n, NS, dtype)) return e;
  if (page0 < 0 || page0 + n > n_total) return (int)cudaErrorInvalidValue;
  return launch_dh(dtype, dh, q, pool, page_table, kv_pos, q_pos,
                   static_cast<float*>(part_m), static_cast<float*>(part_l),
                   static_cast<float*>(part_acc), nullptr, B, kvs, rep, P, n,
                   NS, window, page0, n_total,
                   static_cast<cudaStream_t>(stream));
}

// The merge of `sets` part sets into out (rows, kvs * rep, dh) of the
// dtype: set z is m (rows, kvs, NS, rep), then l, then acc (rows, kvs,
// NS, rep, dh), all fp32, starting set_stride floats after set z - 1
extern "C" int repro_softmax_combine(const void* parts, int sets,
                                     int set_stride, int rows,
                                     int kvs, int rep, int dh, int NS,
                                     void* out, int dtype, void* stream) {
  if (rows < 1 || rows > 65535 || kvs < 1 || rep < 1 || NS < 1 ||
      sets < 1 || set_stride < 1)
    return (int)cudaErrorInvalidValue;
  const float* pm = static_cast<const float*>(parts);
  const size_t n = (size_t)rows * kvs * NS * rep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
#define REPRO_DH(D)                                                          \
  case D:                                                                    \
    return combine_dtype<D>(dtype, pm, pm + n, pm + 2 * n, out, rows, kvs,  \
                            rep, NS, sets, (size_t)set_stride, st);
    REPRO_DH(64) REPRO_DH(96) REPRO_DH(128) REPRO_DH(160) REPRO_DH(256)
#undef REPRO_DH
  }
  return (int)cudaErrorInvalidValue;
}

// ranges: (B, NS, 2) int32, each (row, split)'s pages [j0, j1) as the
// bf16 kernel walks them for the rows' query positions q_pos (B,), on a
// shard holding pages [page0, page0 + n) of rows of n_total pages
extern "C" int repro_decode_walk(const int* q_pos, int* ranges, int B, int n,
                                 int P, int window, int page0, int n_total,
                                 int NS, void* stream) {
  if (B < 1 || n < 1 || P < 1 || NS < 1) return (int)cudaErrorInvalidValue;
  bulk::walk_kernel<<<(B * NS + 127) / 128, 128, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      q_pos, ranges, B, n, P, window, page0, n_total, NS);
  return (int)cudaGetLastError();
}
