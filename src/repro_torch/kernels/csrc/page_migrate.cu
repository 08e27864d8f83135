// Header-centric KV page migration for Hopper (sm_90a).
//
// Replaces the TPU kernels of repro/kernels/page_migrate.py:
//   copy_page_slices   (pl.pallas_call at :86) — in-place scatter of
//                      (page, head-slice) segments from one pool into
//                      another; pages it does not name stay untouched;
//   gather_page_slices (pl.pallas_call at :121) — packs (page,
//                      head-slice) segments into a contiguous send buffer.
//
// In the header-centric pool (page, head, kv, token, head_dim) the
// heads [hb*hps, (hb+1)*hps) of one page are ONE contiguous run of
// hps*2*P*dh elements (paper §4.1): a segment.  Both kernels are pure
// copies of whole segments.
//
// Bound on the H100: bytes.  Each segment is read once and written
// once; nothing is computed.  At llama3-8b geometry (P=64, dh=128, four
// heads a slice at TP2) a segment is 128 KB in bf16.
//
// Design (simple first): the TPU grid runs one segment per step with
// scalar-prefetched indices driving the DMA; here blockIdx.x picks the
// segment and each block reads its own four indices, and blockIdx.y
// splits the segment into 16 KB pieces so that a few large segments
// still spread over the SMs.  Each thread moves 16-byte vectors,
// neighbouring threads on neighbouring addresses.  The TPU version
// aliases the destination pool; here the kernel writes into `dst` in
// place and the wrapper returns it.  An index outside its pool copies
// nothing.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VEC_PER_THREAD = 4;          // 4 x 16 B = 64 B a thread
constexpr int VEC_PER_BLOCK = THREADS * VEC_PER_THREAD;

// seg_vec: 16-byte vectors per segment.  src page p, head block hb starts
// at vector (p * src_hblocks_per_page + hb) * seg_vec; likewise dst.
// dst_pages == nullptr means dst segment i is row i of a packed buffer.
__global__ void __launch_bounds__(THREADS)
copy_segments(const int4* __restrict__ src, int4* __restrict__ dst,
              const int* __restrict__ src_pages,
              const int* __restrict__ src_hblocks,
              const int* __restrict__ dst_pages,
              const int* __restrict__ dst_hblocks, int src_np,
              int src_hb_per_page, int dst_np, int dst_hb_per_page,
              long long seg_vec) {
  const int i = blockIdx.x;
  const int sp = src_pages[i], shb = src_hblocks[i];
  long long dseg;
  if (dst_pages == nullptr) {
    dseg = i;
  } else {
    const int dp = dst_pages[i], dhb = dst_hblocks[i];
    if (dp < 0 || dp >= dst_np || dhb < 0 || dhb >= dst_hb_per_page)
      return;
    dseg = (long long)dp * dst_hb_per_page + dhb;
  }
  if (sp < 0 || sp >= src_np || shb < 0 || shb >= src_hb_per_page) return;
  const long long sseg = (long long)sp * src_hb_per_page + shb;
  const int4* s = src + sseg * seg_vec;
  int4* d = dst + dseg * seg_vec;
  const long long base = (long long)blockIdx.y * VEC_PER_BLOCK;
  int4 r[VEC_PER_THREAD];
#pragma unroll
  for (int j = 0; j < VEC_PER_THREAD; ++j) {
    const long long e = base + j * THREADS + threadIdx.x;
    if (e < seg_vec) r[j] = s[e];
  }
#pragma unroll
  for (int j = 0; j < VEC_PER_THREAD; ++j) {
    const long long e = base + j * THREADS + threadIdx.x;
    if (e < seg_vec) d[e] = r[j];
  }
}

int launch(const void* src, void* dst, const int* src_pages,
           const int* src_hblocks, const int* dst_pages,
           const int* dst_hblocks, int n, int src_np, int src_heads,
           int dst_np, int dst_heads, int hps, int P, int dh, int elem,
           cudaStream_t stream) {
  const long long seg_bytes = (long long)hps * 2 * P * dh * elem;
  if (n < 0 || hps < 1 || src_heads % hps || dst_heads % hps ||
      seg_bytes % 16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long seg_vec = seg_bytes / 16;
  const long long pieces = (seg_vec + VEC_PER_BLOCK - 1) / VEC_PER_BLOCK;
  if (pieces > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)n, (unsigned)pieces);
  copy_segments<<<grid, THREADS, 0, stream>>>(
      static_cast<const int4*>(src), static_cast<int4*>(dst), src_pages,
      src_hblocks, dst_pages, dst_hblocks, src_np, src_heads / hps, dst_np,
      dst_heads / hps, seg_vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dst[dst_pages[i], dst_hblocks[i]*hps : +hps] =
//     src[src_pages[i], src_hblocks[i]*hps : +hps], for i < n, in place
extern "C" int repro_copy_page_slices(
    const void* src, void* dst, const int* src_pages, const int* src_hblocks,
    const int* dst_pages, const int* dst_hblocks, int n, int src_np,
    int src_heads, int dst_np, int dst_heads, int hps, int P, int dh,
    int elem, void* stream) {
  return launch(src, dst, src_pages, src_hblocks, dst_pages, dst_hblocks, n,
                src_np, src_heads, dst_np, dst_heads, hps, P, dh, elem,
                static_cast<cudaStream_t>(stream));
}

// out[i] = pool[pages[i], hblocks[i]*hps : +hps], out (n, hps, 2, P, dh)
extern "C" int repro_gather_page_slices(const void* pool, void* out,
                                        const int* pages, const int* hblocks,
                                        int n, int np, int heads, int hps,
                                        int P, int dh, int elem,
                                        void* stream) {
  return launch(pool, out, pages, hblocks, nullptr, nullptr, n, np, heads, n,
                hps, hps, P, dh, elem, static_cast<cudaStream_t>(stream));
}
