// Tiled online-softmax GQA attention shared by the flash-prefill and the
// chunk-prefill kernels for fp32 inputs (bf16 runs on the tensor-core
// tile, attn_wgmma.cuh; tensor cores would not hold the fp32 checks).
//
// One block of 128 threads owns one (batch row b, kv head g, query tile):
// ROWS = 64 query rows, of which (64 / rep) tokens x the rep query heads
// of kv head g are live (rep up to 64; the rows past them, when rep does
// not divide 64, are padding: no query, zero Q, never stored), so every
// key tile loaded into shared memory serves all rep heads of its group.
// dh in {64, 96, 128, 160, 256}.  The block walks its keys in tiles of BK = 32:
// first an optional PAGED segment (keys read through a page table from
// the header-centric pool (NP, kvs, 2, P, dh)), then a CONTIGUOUS
// segment (keys from a (B, Sk, kvs, dh) tensor).  A key tile none of
// whose keys is visible to any query of the tile (beyond the causal
// frontier, outside the window, or empty slots) is skipped before its
// K/V are read.  Scores and the running (m, l, acc) state are fp32; the
// masking constant and the 1e-20 floor of the normaliser are the
// reference's.
//
// With TileArgs::part set the block stores each query row's partial
// state (m in natural-log units, l, unnormalised acc; fp32, in the
// layout of paged_attention.cu's combine) instead of the output, and
// skip_self drops the contiguous segment: the chunk kernel on a
// sequence-parallel shard.
//
// Simple first: CUDA-core FMAs from shared memory (4x4 register tiles
// for Q.K^T, 4 rows x dh/8 columns for P.V), no tensor cores, no TMA.
#pragma once

#include <climits>

#include "common.cuh"

namespace rt {

constexpr int TILE_ROWS = 64;
constexpr int TILE_BK = 32;
constexpr int TILE_THREADS = 128;

template <typename T>
struct TileArgs {
  const T* q;         // (B, S, Hq, dh)
  const int* q_pos;   // (B, S), or null: position = token index
  T* out;             // (B, S, Hq, dh)
  int S, kvs, rep;
  // paged segment: n_pages pages of the row's page table (0 = none)
  const T* pool;      // (NP, kvs, 2, P, dh)
  const int* page_table;  // (B, pt_cols)
  const int* kv_pos;      // (B, pt_cols * P)
  int n_pages, pt_cols, P;
  // contiguous segment
  const T* k;         // (B, Sk, kvs, dh)
  const T* v;
  const int* k_pos;   // (B, Sk), or null: position = key index
  int Sk;
  int causal, window;
  float scale;
  // partials instead of the output (null: the normalised output), and
  // whether the contiguous segment is skipped (0: attended)
  float* part;
  int skip_self;
};

template <int DH>
constexpr size_t tile_smem_bytes() {
  return sizeof(float) * (TILE_ROWS * (DH + 1) + TILE_BK * (DH + 1) +
                          TILE_BK * DH + TILE_ROWS * (TILE_BK + 1) +
                          3 * TILE_ROWS) +
         sizeof(int) * (TILE_BK + TILE_ROWS);
}

// keys of the paged segment of row b, head g
template <typename T, int DH>
struct PagedKeys {
  const TileArgs<T>& a;
  int b, g;
  __device__ int count() const { return a.n_pages * a.P; }
  __device__ int pos(int i) const {
    return a.kv_pos[(size_t)b * a.pt_cols * a.P + i];
  }
  __device__ const T* krow(int i) const {
    const size_t page = a.page_table[(size_t)b * a.pt_cols + i / a.P];
    return a.pool + ((page * a.kvs + g) * 2) * (size_t)a.P * DH +
           (size_t)(i % a.P) * DH;
  }
  __device__ const T* vrow(int i) const { return krow(i) + (size_t)a.P * DH; }
};

// keys of the contiguous segment of row b, head g
template <typename T, int DH>
struct ContigKeys {
  const TileArgs<T>& a;
  int b, g;
  __device__ int count() const { return a.Sk; }
  __device__ int pos(int i) const {
    return a.k_pos ? a.k_pos[(size_t)b * a.Sk + i] : i;
  }
  __device__ const T* krow(int i) const {
    return a.k + (((size_t)b * a.Sk + i) * a.kvs + g) * DH;
  }
  __device__ const T* vrow(int i) const {
    return a.v + (((size_t)b * a.Sk + i) * a.kvs + g) * DH;
  }
};

struct TileSmem {
  float *Qs, *Ks, *Vs, *Ss, *m, *l, *c;
  int *kpos, *qpos;
};

// Walk every key tile of `src`, folding it into the running state.
template <typename T, int DH, typename Src>
__device__ void walk_keys(const Src& src, const TileSmem& sm,
                          float (&acc)[4][DH / 8], int qmin, int qmax,
                          int causal, int window) {
  const int tid = threadIdx.x;
  const int n = src.count();
  for (int i0 = 0; i0 < n; i0 += TILE_BK) {
    int live = 0;
    if (tid < TILE_BK) {
      const int i = i0 + tid;
      const int p = i < n ? src.pos(i) : -1;
      sm.kpos[tid] = p;
      live = p >= 0 && (!causal || p <= qmax) &&
             (window <= 0 || p > qmin - window);
    }
    if (!__syncthreads_or(live)) continue;

    for (int idx = tid; idx < TILE_BK * DH; idx += TILE_THREADS) {
      const int kk = idx / DH, d = idx % DH, i = i0 + kk;
      float kv = 0.f, vv = 0.f;
      if (i < n) {
        kv = to_f(src.krow(i)[d]);
        vv = to_f(src.vrow(i)[d]);
      }
      sm.Ks[kk * (DH + 1) + d] = kv;
      sm.Vs[kk * DH + d] = vv;
    }
    __syncthreads();

    {  // scores: 4 rows x 4 keys per thread
      const int rg = tid / 8, kg = tid % 8;
      float sc[4][4] = {};
      for (int d = 0; d < DH; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sm.Qs[(rg * 4 + i) * (DH + 1) + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = sm.Ks[(kg * 4 + j) * (DH + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
        const int qp = sm.qpos[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = kg * 4 + j;
          const bool ok = qp != INT_MIN &&
                          visible(sm.kpos[kk], qp, causal, window);
          sm.Ss[r * (TILE_BK + 1) + kk] = ok ? sc[i][j] : NEG_INF;
        }
      }
    }
    __syncthreads();

    {  // online softmax: two threads per row, 16 keys each
      const int r = tid / 2, half = tid % 2;
      float* srow = sm.Ss + r * (TILE_BK + 1) + half * (TILE_BK / 2);
      const float m_old = sm.m[r];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TILE_BK / 2; ++j) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TILE_BK / 2; ++j) {
        const float e = expf(srow[j] - m_new);
        srow[j] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) {
        const float corr = expf(m_old - m_new);
        sm.c[r] = corr;
        sm.l[r] = sm.l[r] * corr + sum;
        sm.m[r] = m_new;
      }
    }
    __syncthreads();

    {  // acc = acc * corr + P.V: 4 rows x DH/8 columns per thread
      const int rg = tid / 8, cg = tid % 8;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float corr = sm.c[rg * 4 + i];
#pragma unroll
        for (int c = 0; c < DH / 8; ++c) acc[i][c] *= corr;
      }
      for (int kk = 0; kk < TILE_BK; ++kk) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = sm.Ss[(rg * 4 + i) * (TILE_BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < DH / 8; ++c) {
          const float vv = sm.Vs[kk * DH + cg + 8 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(TILE_THREADS)
    attn_tile_kernel(const TileArgs<T> a) {
  extern __shared__ float smem_raw[];
  TileSmem sm;
  sm.Qs = smem_raw;
  sm.Ks = sm.Qs + TILE_ROWS * (DH + 1);
  sm.Vs = sm.Ks + TILE_BK * (DH + 1);
  sm.Ss = sm.Vs + TILE_BK * DH;
  sm.m = sm.Ss + TILE_ROWS * (TILE_BK + 1);
  sm.l = sm.m + TILE_ROWS;
  sm.c = sm.l + TILE_ROWS;
  sm.kpos = reinterpret_cast<int*>(sm.c + TILE_ROWS);
  sm.qpos = sm.kpos + TILE_BK;

  const int tid = threadIdx.x;
  const int g = blockIdx.y, b = blockIdx.z;
  const int tokens = TILE_ROWS / a.rep, live = tokens * a.rep;
  const int t0 = blockIdx.x * tokens;
  const int Hq = a.kvs * a.rep;

  // query rows: row r < live is token t0 + r / rep, head g * rep + r %
  // rep; rows past live are padding
  for (int r = tid; r < TILE_ROWS; r += TILE_THREADS) {
    const int t = t0 + r / a.rep;
    sm.qpos[r] = r < live && t < a.S
                     ? (a.q_pos ? a.q_pos[(size_t)b * a.S + t] : t)
                     : INT_MIN;
    sm.m[r] = NEG_INF;
    sm.l[r] = 0.f;
  }
  for (int idx = tid; idx < TILE_ROWS * DH; idx += TILE_THREADS) {
    const int r = idx / DH, d = idx % DH, t = t0 + r / a.rep;
    const int h = g * a.rep + r % a.rep;
    sm.Qs[r * (DH + 1) + d] =
        r < live && t < a.S
            ? to_f(a.q[(((size_t)b * a.S + t) * Hq + h) * DH + d]) * a.scale
            : 0.f;
  }
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = 0; r < TILE_ROWS; ++r) {
    const int qp = sm.qpos[r];
    if (qp != INT_MIN) {
      qmin = min(qmin, qp);
      qmax = max(qmax, qp);
    }
  }

  float acc[4][DH / 8] = {};
  if (a.n_pages > 0)
    walk_keys<T, DH>(PagedKeys<T, DH>{a, b, g}, sm, acc, qmin, qmax,
                     a.causal, a.window);
  if (!a.skip_self)
    walk_keys<T, DH>(ContigKeys<T, DH>{a, b, g}, sm, acc, qmin, qmax,
                     a.causal, a.window);

  const int rg = tid / 8, cg = tid % 8;
  if (a.part != nullptr) {
    // part index ((b * S + t) * kvs + g) * rep + h
    const size_t parts = (size_t)gridDim.z * a.S * a.kvs * a.rep;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i, t = t0 + r / a.rep;
      if (r >= live || t >= a.S) continue;
      const size_t k = (((size_t)b * a.S + t) * a.kvs + g) * a.rep + r % a.rep;
      if (cg == 0) {
        a.part[k] = sm.m[r];
        a.part[parts + k] = sm.l[r];
      }
#pragma unroll
      for (int c = 0; c < DH / 8; ++c)
        a.part[2 * parts + k * DH + cg + 8 * c] = acc[i][c];
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i, t = t0 + r / a.rep;
    if (r >= live || t >= a.S) continue;
    const int h = g * a.rep + r % a.rep;
    const float inv = 1.f / fmaxf(sm.l[r], 1e-20f);
    T* o = a.out + (((size_t)b * a.S + t) * Hq + h) * DH;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) o[cg + 8 * c] = from_f<T>(acc[i][c] * inv);
  }
}

template <typename T, int DH>
int launch_tile(const TileArgs<T>& a, int B, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<DH>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_tile_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tokens = TILE_ROWS / a.rep;
  dim3 grid((a.S + tokens - 1) / tokens, a.kvs, B);
  attn_tile_kernel<T, DH><<<grid, TILE_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// head-dim dispatch; an unsupported head dim or rep returns
// cudaErrorInvalidValue (the wrappers check before calling)
template <typename T>
int launch_tile_dh(const TileArgs<T>& a, int dh, int B,
                   cudaStream_t stream) {
  if (a.rep < 1 || a.rep > TILE_ROWS) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 64: return launch_tile<T, 64>(a, B, stream);
    case 96: return launch_tile<T, 96>(a, B, stream);
    case 128: return launch_tile<T, 128>(a, B, stream);
    case 160: return launch_tile<T, 160>(a, B, stream);
    case 256: return launch_tile<T, 256>(a, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace rt
