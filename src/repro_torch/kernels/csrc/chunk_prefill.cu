// Paged chunk-prefill attention with its K/V scatter, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/chunk_prefill.py::chunk_prefill_attention (pl.pallas_call
// at :245): one prefill chunk's queries attend over the chunk's paged
// prefix (walked in place through the page table of the header-centric
// pool (NP, kvs, 2, P, dh)) and then over the chunk itself, and the
// chunk's K/V land in their pool pages at exactly the bytes
// paged/pool.py::write_chunk writes.  Handles ring wrap, sliding
// windows, a trailing partial page and attend_prefix=false.
//
// Bound on the H100: operations.  A chunk of S queries over a prefix of
// L keys does 4 * S * (L + S/2) * Hq * dh FLOPs (causal within the chunk)
// against (L + S) * kvs * 2 * dh bytes of K/V.
//
// Design: TWO launches on the caller's stream.
//   1. attention: one block per (b, kv head, tile of 64/rep query tokens)
//      holding the rep query heads of the group.  It walks the prefix
//      pages (none when attend_prefix=false), masking by the stored slot
//      positions, then the chunk's own K/V straight from k_new / v_new —
//      never from the pool.  Key tiles invisible to the whole query tile
//      (empty slots, beyond the causal frontier, outside the window) are
//      skipped before their bytes are read.  bf16 runs on the tensor-core
//      tile (attn_wgmma.cuh: wgmma products, TMA loads into an mbarrier
//      ring; a paged tile is read as 64/P boxes of P pool rows each, at
//      rows taken from the page table, or as part of one page when P >
//      64); fp32 on the CUDA-core tile (attn_tile.cuh).
//   2. scatter: every (b, token, kv head, K|V) row of the chunk is copied
//      to page_table[b, (q_pos % cap) / P] at in-page offset q_pos % P.
//      Tokens with a negative position (padding) keep the old bytes.
// On a sequence-parallel shard (the pool holds pages [page0, page0 + n)
// of rows of n_total pages), launch 1 writes each query row's partial
// state instead of the output (Args::part: m, l, unnormalised acc in
// fp32, merged across shards by paged_attention.cu's combine), only one
// shard attends the chunk's own keys (skip_self on the others), and
// launch 2 writes only the tokens whose global page the shard holds.
// On the TPU the grid runs in order, so one kernel can attend every
// prefix page and then overwrite it.  Blocks on Hopper run in parallel
// and in no order; stream order between the two launches is what keeps
// "attend the whole prefix, then scatter" on a ring cache, where the
// chunk's writes evict prefix keys its own queries still need.
#include "attn_tile.cuh"
#include "attn_wgmma.cuh"

namespace {

template <typename T>
__global__ void chunk_scatter_kernel(const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     const int* __restrict__ q_pos,
                                     const int* __restrict__ page_table,
                                     T* __restrict__ pool, int B, int S,
                                     int kvs, int dh, int P, int n,
                                     int page0, int n_total) {
  const int cap = n_total * P;
  const size_t total = (size_t)B * S * kvs * 2 * dh;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const int d = idx % dh;
    size_t r = idx / dh;
    const int kv = r % 2;
    r /= 2;
    const int g = r % kvs;
    r /= kvs;
    const int t = r % S;
    const int b = r / S;
    const int qp = q_pos[(size_t)b * S + t];
    if (qp < 0) continue;
    const int slot = qp % cap, j = slot / P - page0;
    if (j < 0 || j >= n) continue;  // a page of another shard
    const size_t page = page_table[(size_t)b * n + j];
    const T* src = kv ? v : k;
    pool[((page * kvs + g) * 2 + kv) * (size_t)P * dh +
         (size_t)(slot % P) * dh + d] =
        src[(((size_t)b * S + t) * kvs + g) * dh + d];
  }
}

int run_attention_f32(const void* q, const void* k_new, const void* v_new,
                      const void* pool, const int* page_table,
                      const int* kv_pos, const int* q_pos, void* out,
                      float* part, int B, int S, int kvs, int rep, int dh,
                      int P, int n, int attend_prefix, int attend_self,
                      int window, cudaStream_t stream) {
  rt::TileArgs<float> a{};
  a.part = part;
  a.skip_self = !attend_self;
  a.q = static_cast<const float*>(q);
  a.q_pos = q_pos;
  a.out = static_cast<float*>(out);
  a.S = S;
  a.kvs = kvs;
  a.rep = rep;
  a.pool = static_cast<const float*>(pool);
  a.page_table = page_table;
  a.kv_pos = kv_pos;
  a.n_pages = attend_prefix ? n : 0;
  a.pt_cols = n;
  a.P = P;
  a.k = static_cast<const float*>(k_new);
  a.v = static_cast<const float*>(v_new);
  a.k_pos = q_pos;
  a.Sk = S;
  a.causal = 1;
  a.window = window;
  a.scale = 1.0f / sqrtf((float)dh);
  return rt::launch_tile_dh<float>(a, dh, B, stream);
}

int run_attention_bf16(const void* q, const void* k_new, const void* v_new,
                       const void* pool, int NP, const int* page_table,
                       const int* kv_pos, const int* q_pos, void* out,
                       float* part, int B, int S, int kvs, int rep, int dh,
                       int P, int n, int attend_prefix, int attend_self,
                       int window, cudaStream_t stream) {
  rt::wg::Args a{};
  a.part = part;
  a.skip_self = !attend_self;
  a.q_pos = q_pos;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.S = S;
  a.kvs = kvs;
  a.rep = rep;
  a.page_table = page_table;
  a.kv_pos = kv_pos;
  a.n_pages = attend_prefix ? n : 0;
  a.pt_cols = n;
  a.P = P;
  a.pool_rows = NP * kvs * 2 * P;
  a.k_pos = q_pos;
  a.Sk = S;
  a.causal = 1;
  a.window = window;
  a.scale_log2 = 1.4426950408889634f / sqrtf((float)dh);
  return rt::wg::launch_dh(a, dh, q, k_new, v_new, pool, B, stream);
}

template <typename T>
int run_scatter(const void* k_new, const void* v_new, const int* q_pos,
                const int* page_table, void* pool, int B, int S, int kvs,
                int dh, int P, int n, int page0, int n_total,
                cudaStream_t stream) {
  const size_t total = (size_t)B * S * kvs * 2 * dh;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads < 65535
                               ? (total + threads - 1) / threads
                               : 65535);
  chunk_scatter_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new), q_pos,
      page_table, static_cast<T*>(pool), B, S, kvs, dh, P, n, page0,
      n_total);
  return (int)cudaGetLastError();
}

}  // namespace

// out (B, S, Hq, dh) the normalised attention, or, with part set (then
// out is unused), the rows' partial states into part: m, l (B * S, kvs,
// 1, rep) and acc (B * S, kvs, 1, rep, dh), fp32, consecutive
extern "C" int repro_chunk_prefill_attention(
    const void* q, const void* k_new, const void* v_new, const void* pool,
    int NP, const int* page_table, const int* kv_pos, const int* q_pos,
    void* out, void* part, int B, int S, int kvs, int rep, int dh, int P,
    int n, int attend_prefix, int attend_self, int window, int dtype,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  if (pt == nullptr && !attend_self) return (int)cudaErrorInvalidValue;
  if (dtype == rt::DT_F32)
    return run_attention_f32(q, k_new, v_new, pool, page_table, kv_pos,
                             q_pos, out, pt, B, S, kvs, rep, dh, P, n,
                             attend_prefix, attend_self, window, st);
  if (dtype == rt::DT_BF16)
    return run_attention_bf16(q, k_new, v_new, pool, NP, page_table, kv_pos,
                              q_pos, out, pt, B, S, kvs, rep, dh, P, n,
                              attend_prefix, attend_self, window, st);
  return (int)cudaErrorInvalidValue;
}

// the chunk's tokens into the pages [page0, page0 + n) of rows of n_total
// pages that this pool holds (page0 = 0, n_total = n: every token)
extern "C" int repro_chunk_scatter(const void* k_new, const void* v_new,
                                   const int* q_pos, const int* page_table,
                                   void* pool, int B, int S, int kvs, int dh,
                                   int P, int n, int page0, int n_total,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (page0 < 0 || page0 + n > n_total) return (int)cudaErrorInvalidValue;
  if (dtype == rt::DT_F32)
    return run_scatter<float>(k_new, v_new, q_pos, page_table, pool, B, S,
                              kvs, dh, P, n, page0, n_total, st);
  if (dtype == rt::DT_BF16)
    return run_scatter<__nv_bfloat16>(k_new, v_new, q_pos, page_table, pool,
                                      B, S, kvs, dh, P, n, page0, n_total,
                                      st);
  return (int)cudaErrorInvalidValue;
}
