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
// Design: one block per (b, kv head, tile of 64/rep query tokens) holding
// all rep query heads of the group, so each K/V tile is read once per
// group; key tiles beyond the causal frontier or wholly outside the
// window are never loaded (the TPU kernel's pl.when skip).  Unlike the
// TPU kernel, which asserts S % block == 0, ragged S is masked: engine
// prompts have any length.  Two hand-written tiles, chosen by dtype:
//   * bf16 (the serving path): attn_wgmma.cuh, both products on the
//     tensor cores (wgmma) with K/V tiles brought by TMA into a two-stage
//     mbarrier ring by a producer warp.  The tensor maps are encoded here
//     on the host at every call.
//   * fp32: attn_tile.cuh, FMAs on CUDA cores; bf16 or TF32 tensor cores
//     would not hold the fp32 checks.
#include "attn_tile.cuh"
#include "attn_wgmma.cuh"

namespace {

int run_f32(const void* q, const void* k, const void* v, void* out, int B,
            int S, int kvs, int rep, int dh, int causal, int window,
            cudaStream_t stream) {
  rt::TileArgs<float> a{};
  a.q = static_cast<const float*>(q);
  a.q_pos = nullptr;
  a.out = static_cast<float*>(out);
  a.S = S;
  a.kvs = kvs;
  a.rep = rep;
  a.n_pages = 0;
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.k_pos = nullptr;
  a.Sk = S;
  a.causal = causal;
  a.window = window;
  a.scale = 1.0f / sqrtf((float)dh);
  return rt::launch_tile_dh<float>(a, dh, B, stream);
}

int run_bf16(const void* q, const void* k, const void* v, void* out, int B,
             int S, int kvs, int rep, int dh, int causal, int window,
             cudaStream_t stream) {
  rt::wg::Args a{};
  a.q_pos = nullptr;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.S = S;
  a.kvs = kvs;
  a.rep = rep;
  a.n_pages = 0;
  a.k_pos = nullptr;
  a.Sk = S;
  a.causal = causal;
  a.window = window;
  a.scale_log2 = 1.4426950408889634f / sqrtf((float)dh);
  return rt::wg::launch_dh(a, dh, q, k, v, nullptr, B, stream);
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int kvs, int rep, int dh, int causal,
                                     int window, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::DT_F32)
    return run_f32(q, k, v, out, B, S, kvs, rep, dh, causal, window, st);
  if (dtype == rt::DT_BF16)
    return run_bf16(q, k, v, out, B, S, kvs, rep, dh, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
