// Flash prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (pl.pallas_call at :108): causal (or bidirectional) GQA attention of a
// whole prompt, q (B, S, Hq, dh) against k, v (B, S, Hkv, dh), with an
// optional sliding window, fp32 online softmax.
//
// Bound on the H100: operations.  Causal attention does 4 * S^2/2 * Hq * dh
// FLOPs on S * (Hq + 2 Hkv) * dh inputs; at S = 4096 that is hundreds of
// operations per byte, far above the card's ~295 FLOP/byte ridge.
//
// Design (simple first, see attn_tile.cuh): one block per (b, kv head,
// tile of 64/rep query tokens) holding all rep query heads of the group,
// so each K/V tile is read once per group; key tiles beyond the causal
// frontier or wholly outside the window are skipped before they are
// read (the TPU kernel's pl.when skip).  Unlike the TPU kernel, which
// asserts S % block == 0, ragged S is masked: engine prompts have any
// length.  The FMAs run on CUDA cores in fp32; moving Q.K^T and P.V to
// wgmma with TMA-fed tiles is the work of a later change.
#include "attn_tile.cuh"

namespace {

template <typename T>
int run(const void* q, const void* k, const void* v, void* out, int B,
        int S, int kvs, int rep, int dh, int causal, int window,
        cudaStream_t stream) {
  rt::TileArgs<T> a{};
  a.q = static_cast<const T*>(q);
  a.q_pos = nullptr;
  a.out = static_cast<T*>(out);
  a.S = S;
  a.kvs = kvs;
  a.rep = rep;
  a.n_pages = 0;
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.k_pos = nullptr;
  a.Sk = S;
  a.causal = causal;
  a.window = window;
  a.scale = 1.0f / sqrtf((float)dh);
  return rt::launch_tile_dh<T>(a, dh, B, stream);
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int kvs, int rep, int dh, int causal,
                                     int window, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DT_F32)
    return run<float>(q, k, v, out, B, S, kvs, rep, dh, causal, window, st);
  if (dtype == rt::DT_BF16)
    return run<__nv_bfloat16>(q, k, v, out, B, S, kvs, rep, dh, causal,
                              window, st);
  return (int)cudaErrorInvalidValue;
}
