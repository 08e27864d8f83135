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
//      holding the rep query heads of the group (attn_tile.cuh).  It
//      walks the prefix pages (none when attend_prefix=false), masking
//      by the stored slot positions, then the chunk's own K/V straight
//      from k_new / v_new — never from the pool.  Key tiles invisible to
//      the whole query tile (empty slots, beyond the causal frontier,
//      outside the window) are skipped before their bytes are read.
//   2. scatter: every (b, token, kv head, K|V) row of the chunk is copied
//      to page_table[b, (q_pos % cap) / P] at in-page offset q_pos % P.
//      Tokens with a negative position (padding) keep the old bytes.
// On the TPU the grid runs in order, so one kernel can attend every
// prefix page and then overwrite it.  Blocks on Hopper run in parallel
// and in no order; stream order between the two launches is what keeps
// "attend the whole prefix, then scatter" on a ring cache, where the
// chunk's writes evict prefix keys its own queries still need.
#include "attn_tile.cuh"

namespace {

template <typename T>
__global__ void chunk_scatter_kernel(const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     const int* __restrict__ q_pos,
                                     const int* __restrict__ page_table,
                                     T* __restrict__ pool, int B, int S,
                                     int kvs, int dh, int P, int n) {
  const int cap = n * P;
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
    const int slot = qp % cap;
    const size_t page = page_table[(size_t)b * n + slot / P];
    const T* src = kv ? v : k;
    pool[((page * kvs + g) * 2 + kv) * (size_t)P * dh +
         (size_t)(slot % P) * dh + d] =
        src[(((size_t)b * S + t) * kvs + g) * dh + d];
  }
}

template <typename T>
int run_attention(const void* q, const void* k_new, const void* v_new,
                  const void* pool, const int* page_table,
                  const int* kv_pos, const int* q_pos, void* out, int B,
                  int S, int kvs, int rep, int dh, int P, int n,
                  int attend_prefix, int window, cudaStream_t stream) {
  rt::TileArgs<T> a{};
  a.q = static_cast<const T*>(q);
  a.q_pos = q_pos;
  a.out = static_cast<T*>(out);
  a.S = S;
  a.kvs = kvs;
  a.rep = rep;
  a.pool = static_cast<const T*>(pool);
  a.page_table = page_table;
  a.kv_pos = kv_pos;
  a.n_pages = attend_prefix ? n : 0;
  a.pt_cols = n;
  a.P = P;
  a.k = static_cast<const T*>(k_new);
  a.v = static_cast<const T*>(v_new);
  a.k_pos = q_pos;
  a.Sk = S;
  a.causal = 1;
  a.window = window;
  a.scale = 1.0f / sqrtf((float)dh);
  return rt::launch_tile_dh<T>(a, dh, B, stream);
}

template <typename T>
int run_scatter(const void* k_new, const void* v_new, const int* q_pos,
                const int* page_table, void* pool, int B, int S, int kvs,
                int dh, int P, int n, cudaStream_t stream) {
  const size_t total = (size_t)B * S * kvs * 2 * dh;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads < 65535
                               ? (total + threads - 1) / threads
                               : 65535);
  chunk_scatter_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new), q_pos,
      page_table, static_cast<T*>(pool), B, S, kvs, dh, P, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_chunk_prefill_attention(
    const void* q, const void* k_new, const void* v_new, const void* pool,
    const int* page_table, const int* kv_pos, const int* q_pos, void* out,
    int B, int S, int kvs, int rep, int dh, int P, int n, int attend_prefix,
    int window, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DT_F32)
    return run_attention<float>(q, k_new, v_new, pool, page_table, kv_pos,
                                q_pos, out, B, S, kvs, rep, dh, P, n,
                                attend_prefix, window, st);
  if (dtype == rt::DT_BF16)
    return run_attention<__nv_bfloat16>(q, k_new, v_new, pool, page_table,
                                        kv_pos, q_pos, out, B, S, kvs, rep,
                                        dh, P, n, attend_prefix, window, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_chunk_scatter(const void* k_new, const void* v_new,
                                   const int* q_pos, const int* page_table,
                                   void* pool, int B, int S, int kvs, int dh,
                                   int P, int n, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DT_F32)
    return run_scatter<float>(k_new, v_new, q_pos, page_table, pool, B, S,
                              kvs, dh, P, n, st);
  if (dtype == rt::DT_BF16)
    return run_scatter<__nv_bfloat16>(k_new, v_new, q_pos, page_table, pool,
                                      B, S, kvs, dh, P, n, st);
  return (int)cudaErrorInvalidValue;
}
