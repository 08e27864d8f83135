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
// Design (simple first): two launches on the caller's stream.
//   1. split: one block of dh threads per (kv head g, row b, split s).
//      At decode batch sizes B * kvs blocks are far too few for the
//      card's 132 SMs, so the row's pages are cut into contiguous splits
//      and each block walks one of them.  The block holds the rep query
//      heads of the group, so each page is read once for the whole
//      group.  Per page it checks the stored positions and skips a page
//      with no visible key before touching its K/V; stages K (as fp32,
//      rows padded to dh+1 floats so a warp reading 32 keys hits 32
//      banks) and V into shared memory with 16-byte loads issued by all
//      threads at once; scores each (head, key) pair with one thread's
//      dot product; one warp per head updates the running (m, l); and
//      each thread folds one column of V into its rep accumulators.  The
//      split's (m, l, acc) go to fp32 scratch.
//   2. combine: one block per (g, b) merges the splits' partial states
//      — the rescale-and-sum of layers.combine_softmax_partials — and
//      writes the output.
// A page's load is not overlapped with the previous page's math (no
// double buffering yet), and no tensor cores are used.
#include "common.cuh"

namespace {

constexpr int MAX_REP = 8;
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
                              float scale) {
  constexpr int NW = DH / 32;               // warps
  constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte load
  extern __shared__ __align__(16) unsigned char s_raw[];
  T* s_v = reinterpret_cast<T*>(s_raw);                        // (P, DH)
  float* s_k = reinterpret_cast<float*>(s_v + (size_t)P * DH);  // (P, DH+1)
  float* s_sc = s_k + (size_t)P * (DH + 1);                    // (rep, P)
  float* s_q = s_sc + (size_t)rep * P;                         // (rep, DH)
  int* s_pos = reinterpret_cast<int*>(s_q + (size_t)rep * DH);  // (P,)
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
  for (int j = j0; j < j1; ++j) {
    const int* pj = kv_pos + ((size_t)b * n + j) * P;
    int live = 0;
    for (int p = tid; p < P; p += DH) {
      const int ps = pj[p];
      s_pos[p] = ps;
      live |= rt::visible(ps, qp, 1, window);
    }
    if (!__syncthreads_or(live)) continue;

    const size_t page = page_table[(size_t)b * n + j];
    const T* kb = pool + ((page * kvs + g) * 2) * (size_t)P * DH;
    const int4* kv4 = reinterpret_cast<const int4*>(kb);
    const int n4 = P * DH / VEC;               // 16-byte chunks of K (or V)
#pragma unroll 4
    for (int i = tid; i < n4; i += DH) {
      const int4 kc = kv4[i];
      reinterpret_cast<int4*>(s_v)[i] = kv4[n4 + i];
      const T* ke = reinterpret_cast<const T*>(&kc);
      const int off = i * VEC, p = off / DH, c = off % DH;
#pragma unroll
      for (int e = 0; e < VEC; ++e) s_k[p * (DH + 1) + c + e] = rt::to_f(ke[e]);
    }
    __syncthreads();

    for (int idx = tid; idx < rep * P; idx += DH) {
      const int p = idx % P, h = idx / P;
      const float* kr = s_k + p * (DH + 1);
      const float* qr = s_q + h * DH;
      float d = 0.f;
#pragma unroll 8
      for (int c = 0; c < DH; ++c) d = fmaf(qr[c], kr[c], d);
      s_sc[h * P + p] =
          rt::visible(s_pos[p], qp, 1, window) ? d : rt::NEG_INF;
    }
    __syncthreads();

    for (int h = warp; h < rep; h += NW) {
      float* row = s_sc + h * P;
      const float m_old = s_m[h];
      float mx = rt::NEG_INF;
      for (int p = lane; p < P; p += 32) mx = fmaxf(mx, row[p]);
      const float m_new = fmaxf(m_old, rt::warp_max(mx));
      float sum = 0.f;
      for (int p = lane; p < P; p += 32) {
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
    for (int p = 0; p < P; ++p) {
      const float vv = rt::to_f(s_v[p * DH + tid]);
#pragma unroll
      for (int h = 0; h < MAX_REP; ++h)
        if (h < rep) pv[h] = fmaf(s_sc[h * P + p], vv, pv[h]);
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

template <typename T, int DH>
__global__ void __launch_bounds__(DH)
    paged_decode_combine_kernel(const float* __restrict__ part_m,
                                const float* __restrict__ part_l,
                                const float* __restrict__ part_acc,
                                T* __restrict__ out, int kvs, int rep,
                                int NS) {
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int Hq = kvs * rep;
  const size_t base = ((size_t)b * kvs + g) * NS;
  for (int h = 0; h < rep; ++h) {
    float m = rt::NEG_INF;
    for (int s = 0; s < NS; ++s) m = fmaxf(m, part_m[(base + s) * rep + h]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < NS; ++s) {
      const size_t i = (base + s) * rep + h;
      const float corr = expf(part_m[i] - m);
      l += part_l[i] * corr;
      a += part_acc[i * DH + tid] * corr;
    }
    out[((size_t)b * Hq + g * rep + h) * DH + tid] =
        rt::from_f<T>(a / fmaxf(l, 1e-20f));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* pool, const int* page_table,
           const int* kv_pos, const int* q_pos, float* part_m,
           float* part_l, float* part_acc, void* out, int B, int kvs,
           int rep, int P, int n, int NS, int window, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(sizeof(T), DH, rep, P);
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_split_kernel<T, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int pps = (n + NS - 1) / NS;
  paged_decode_split_kernel<T, DH><<<dim3(kvs, B, NS), DH, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool), page_table,
      kv_pos, q_pos, part_m, part_l, part_acc, kvs, rep, P, n, pps, window,
      1.0f / sqrtf((float)DH));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_decode_combine_kernel<T, DH><<<dim3(kvs, B), DH, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), kvs, rep, NS);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int dh, const void* q, const void* pool, const int* pt,
              const int* kv_pos, const int* q_pos, float* pm, float* pl,
              float* pa, void* out, int B, int kvs, int rep, int P, int n,
              int NS, int window, cudaStream_t stream) {
  if (dh == 64)
    return launch<T, 64>(q, pool, pt, kv_pos, q_pos, pm, pl, pa, out, B,
                         kvs, rep, P, n, NS, window, stream);
  if (dh == 128)
    return launch<T, 128>(q, pool, pt, kv_pos, q_pos, pm, pl, pa, out, B,
                          kvs, rep, P, n, NS, window, stream);
  return (int)cudaErrorInvalidValue;
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
  const size_t elem = dtype == rt::DT_BF16 ? 2 : 4;
  if (rep < 1 || rep > MAX_REP || NS < 1 || NS > n ||
      (P * dh) % (16 / elem) ||
      decode_smem_bytes(elem, dh, rep, P) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == rt::DT_F32)
    return launch_dh<float>(dh, q, pool, page_table, kv_pos, q_pos, pm, pl,
                            pa, out, B, kvs, rep, P, n, NS, window, st);
  if (dtype == rt::DT_BF16)
    return launch_dh<__nv_bfloat16>(dh, q, pool, page_table, kv_pos, q_pos,
                                    pm, pl, pa, out, B, kvs, rep, P, n, NS,
                                    window, st);
  return (int)cudaErrorInvalidValue;
}
