// Gated FFN over parallelism-padded weights for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/padded_ffn.py::padded_ffn
// (pl.pallas_call at :95): out = f(x @ gate, x @ up) @ wo over the fused
// wi = [gate | up] (d, 2*ffp) and wo (ffp, d), where each of the `tp`
// shards of the ffp columns holds ff/tp real columns followed by a zero
// tail (paper §4.2, Eq. 2).  Only real columns are visited: real column
// j of shard s = j / (ff/tp) lives at padded column s*(ffp/tp) + j%(ff/tp),
// so padded and unpadded work are equal by construction, as on the TPU.
//
// Bound on the H100: bytes at decode (T = 4: every weight byte is read
// once for a few FLOPs each), operations at prefill (T = 512: 512 FLOPs
// a weight element in bf16 is above the card's ~295 FLOP/byte ridge).
//
// Design (simple first).  Two launches on one stream:
//   1. gate/up: a block computes a (64 tokens x 64 real columns) tile of
//      x @ gate and x @ up over K = d, then applies the activation in its
//      epilogue and writes h = f(g) * u (rounded to the input type, the
//      type the second product reads) into a compact (T, ff) scratch;
//   2. down: a block computes a (64 tokens x 64 outputs) tile of
//      h @ wo over the ff real rows, rows mapped past each shard's tail.
// bf16 runs on the tensor cores through nvcuda::wmma 16x16x16 fragments
// with fp32 accumulation (four warps, 32x32 a warp).  The tensor cores
// accumulate more coarsely than fp32 adds, and over the 4096-14336
// products of a row one carried accumulator drifted visibly from the
// fp32 sum on an H100.  So each 32-deep K tile sums in fresh fragments,
// which the kernel adds into the totals with fp32 adds on the CUDA cores
// (the promotion DeepSeek-V3 describes for FP8 on Hopper).  fp32 runs FMAs
// on CUDA cores (256 threads, 4x4 a thread), since a tensor-core fp32
// product would be TF32.  Tiles are staged through shared memory with
// 16-byte loads; the ragged edges of T, ff and d are masked (the TPU
// kernel asserts that T and the shard width divide its blocks).  The TPU
// kernel keeps a (block_t, d) fp32 accumulator in VMEM across the ff
// grid axis; a Hopper block has no such room for d = 4096, so h goes
// through device memory between the launches.  wgmma with TMA-fed tiles,
// and split-K for the down product at small T, are later work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

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

// One GEMM tile problem: C (M, N) = A (M, K) @ B (K, N) with A row-major
// (leading dim lda) and B element (k, n) at
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

// ---------------------------------------------------------------- bf16
namespace bf {
constexpr int THREADS = 128, BM = 64, BN = 64, BK = 32;
constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
using T = __nv_bfloat16;

// shared bytes: the input tiles, reused by the fp32 epilogue tile
template <int NB>
struct Smem {
  static constexpr int IN = (BM * LDA + NB * BK * LDB) * 2;
  static constexpr int OUT = NB * BM * LDC * 4;
  static constexpr int BYTES = IN > OUT ? IN : OUT;
};

template <int NB>
__global__ void __launch_bounds__(THREADS) ffn_tile(Prob p) {
  __shared__ __align__(128) unsigned char raw[Smem<NB>::BYTES];
  T* sa = reinterpret_cast<T*>(raw);
  T* sb = sa + BM * LDA;                 // operand o at sb + o * BK * LDB
  float* sc = reinterpret_cast<float*>(raw);  // operand o at + o * BM * LDC
  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp / 2, wn = warp % 2;
  const T* A = static_cast<const T*>(p.a);
  const T* Bm = static_cast<const T*>(p.b);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][2][2];
#pragma unroll
  for (int o = 0; o < NB; ++o)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[o][i][j], 0.0f);

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    // the tile's products sum in their own fragments, added into the
    // fp32 totals after the tile (see the note at the top)
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[NB][2][2];
#pragma unroll
    for (int o = 0; o < NB; ++o)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(part[o][i][j], 0.0f);
    // A tile: BM x BK = 256 vectors of 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int v = tid + r * THREADS, row = v / (BK / 8);
      const int k = k0 + (v % (BK / 8)) * 8, m = m0 + row;
      int4 val = make_int4(0, 0, 0, 0);
      if (m < p.M && k < p.K)
        val = *reinterpret_cast<const int4*>(A + (long long)m * p.lda + k);
      *reinterpret_cast<int4*>(&sa[row * LDA + (v % (BK / 8)) * 8]) = val;
    }
    // B tiles: BK x BN = 256 vectors of 8 per operand
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int v = tid + r * THREADS, row = v / (BN / 8);
      const int cv = (v % (BN / 8)) * 8, k = k0 + row, n = n0 + cv;
      const bool ok = k < p.K && n < p.N;
      const long long off =
          ok ? (long long)p.brow(k) * p.ldb + p.bcol(n) : 0;
#pragma unroll
      for (int o = 0; o < NB; ++o) {
        int4 val = make_int4(0, 0, 0, 0);
        if (ok)
          val = *reinterpret_cast<const int4*>(Bm + off + o * p.b_op_off);
        *reinterpret_cast<int4*>(&sb[o * BK * LDB + row * LDB + cv]) = val;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &sa[(wm * 32 + i * 16) * LDA + kk],
                               LDA);
#pragma unroll
      for (int o = 0; o < NB; ++o) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
          wmma::load_matrix_sync(
              fb, &sb[o * BK * LDB + kk * LDB + wn * 32 + j * 16], LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(part[o][i][j], fa[i], fb, part[o][i][j]);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < NB; ++o)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int t = 0; t < part[o][i][j].num_elements; ++t)
            acc[o][i][j].x[t] += part[o][i][j].x[t];
    __syncthreads();
  }
  // epilogue through shared memory (reuses the input tiles' bytes)
#pragma unroll
  for (int o = 0; o < NB; ++o)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            &sc[o * BM * LDC + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16],
            acc[o][i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  T* C = static_cast<T*>(p.c);
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, cc = e % BN, m = m0 + r, n = n0 + cc;
    if (m < p.M && n < p.N) {
      const float g = sc[r * LDC + cc];
      const float u = sc[(NB - 1) * BM * LDC + r * LDC + cc];
      C[(long long)m * p.ldc + n] = rt::from_f<T>(epilogue(p, g, u));
    }
  }
}
}  // namespace bf

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

template <int NB>
int launch_tile(const Prob& p, int dtype, cudaStream_t stream) {
  if (dtype == rt::DT_BF16) {
    dim3 grid((p.N + bf::BN - 1) / bf::BN, (p.M + bf::BM - 1) / bf::BM);
    bf::ffn_tile<NB><<<grid, bf::THREADS, 0, stream>>>(p);
  } else {
    dim3 grid((p.N + f32::BN - 1) / f32::BN, (p.M + f32::BM - 1) / f32::BM);
    f32::ffn_tile<NB><<<grid, f32::THREADS, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out (T, d) = f(x @ gate, x @ up) @ wo over the real columns of each of
// the tp shards; h (T, ff) is the caller's scratch.  x, wi, wo, h, out
// share the dtype (0 = fp32, 1 = bf16).
extern "C" int repro_padded_ffn(const void* x, const void* wi, const void* wo,
                                void* h, void* out, int T, int d, int ff,
                                int ffp, int tp, int act, int dtype,
                                void* stream) {
  const int vec = dtype == rt::DT_BF16 ? 8 : 4;
  if (T < 1 || tp < 1 || ff % tp || ffp % tp || (ff / tp) % vec ||
      (ffp / tp) % vec || (ffp / tp) < (ff / tp) || d % vec || act < ACT_SWIGLU ||
      act > ACT_GELU || (dtype != rt::DT_F32 && dtype != rt::DT_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Map cols{ff / tp, ffp / tp};
  Prob up{x, wi, h, T, ff, d, d, 2 * ffp, ff, (long long)ffp,
          Map{d, d}, cols, act};
  int err = act == ACT_GELU ? launch_tile<1>(up, dtype, st)
                            : launch_tile<2>(up, dtype, st);
  if (err) return err;
  Prob down{h, wo, out, T, d, ff, ff, d, d, 0LL, cols, Map{d, d}, -1};
  return launch_tile<1>(down, dtype, st);
}
