// flash_attention_bwd: the gradients dQ, dK, dV of flash_attention.
//
// There is no TPU kernel to replace: the reference differentiates its
// attention (`blockwise_attention`, a lax.scan, in
// src/repro/models/layers.py) by automatic differentiation, and its Pallas
// forward (src/repro/kernels/flash_attention/kernel.py) has no backward.
// This is the backward of the port's forward (flash_attention.cu), so that
// training runs through the hand-written forward on the card.
//
// The function, per (batch, query head) with S = scale * Q K^T masked as
// the forward masks it (causal, sliding window, keys past the sequence):
//   P  = exp(S - lse)           lse: the forward's row log-sum-exp
//   dV = P^T dO                 summed over the Hq / Hkv heads of a kv head
//   dP = dO V^T
//   dS = P * (dP - D),          D = rowsum(dO * O)
//   dQ = scale * dS K,  dK = scale * dS^T Q   (dK summed like dV)
// A row with nothing to attend to has lse = -inf and P = 0, so its
// gradient is exactly 0.
//
// Three launches, for either type:
// 1. `delta_kernel`: D = rowsum(dO * O), one warp per row, float32.
// 2. dK and dV: one block per (batch * kv head, 64-key tile). K and V
//    stay in shared memory; the block walks every query tile that sees the
//    key tile, for each of the Hq / Hkv query heads that share the kv
//    head, so grouped heads need no atomics and the sums run in one fixed
//    order (deterministic).
// 3. dQ: one block per (batch * q head, 64-query tile), walking the key
//    tiles the forward walks (`key_tiles`). It recomputes S and dP rather
//    than receive dS from step 2, so dQ needs no atomics either: 7
//    products a tile pair where the least is 5. The bound stays the least
//    work, 2.5 times the forward's products.
// Tiles wholly masked are skipped as in the forward: causal query tiles
// above a key tile, and tiles outside every row's window.
//
// What bounds it: operations. The backward does about 2.5 times the
// forward's products (Q K^T again, dO V^T, P^T dO, dS^T Q, dS K against
// Q K^T and P V); the card's bf16 tensor cores do 989 TFLOP/s against 67
// TFLOP/s of float32 on the CUDA cores. Two pairs of kernels, by dtype:
//
// bfloat16: `dkdv_wgmma_kernel` and `dq_wgmma_kernel`, on the tensor cores
// through the forward's building blocks (hopper_tiles.cuh). One warpgroup
// (128 threads) per block; every product is one of the forward's two
// `wgmma` forms:
// * dK/dV computes the transposed tiles, so no shared-memory transpose of
//   P or dS is needed: S^T = K Q^T and dP^T = V dO^T as m64n64k16 from
//   shared memory, both K-major (the forward's Q K^T); then dV += P^T dO
//   and dK += dS^T Q as m64nDk16 with P^T and dS^T from registers (the
//   accumulator fragment is the A fragment, rounded to bf16, as P in the
//   forward) and the dO and Q tiles as the MN-major B (the forward's V).
//   The K and V tiles load once; the (Q, dO) tiles of the query tiles it
//   walks go through a ring of two stages. lse and D belong to the
//   accumulator's columns (queries): the threads stage them per query
//   tile in shared memory, loading the next stage's under the products.
// * dQ: S = Q K^T and dP = dO V^T as m64n64k16, then dQ += dS K with dS
//   from registers and the K tile as MN-major B. The Q and dO tiles load
//   once; the (K, V) tiles go through the ring.
// * Loads are TMA copies over 4-D tensor maps (D, S, heads, batch) built
//   on the host per call and passed as __grid_constant__, so a launch
//   recorded into a CUDA graph carries them by value; rows past S arrive
//   as zeros. Thread 0 issues every load; a stage is refilled once every
//   warp is done with it.
// * P = exp2(S * scale * log2 e - lse * log2 e), with lse read in natural
//   log units as the forward writes it (+inf in place of -inf, so P = 0).
//   P and dS are rounded to bf16 before the products that take them as A,
//   the one deliberate difference from the reference, as in the forward;
//   accumulators, lse, D and the exp stay float32. The element mask runs
//   only on tiles that straddle the diagonal, a window edge or the
//   sequence end.
// * The longest causal walks start first (key tile 0 for dK/dV, the last
//   query tile for dQ), heads innermost, as the forward orders its grid.
// * dQ, dK and dV go out through shared memory as 16-byte stores.
// * Head dims other than 16, 32, 64 and 128 run at the padded width DP of
//   hopper_tiles.cuh: d = 80 and 112 in tiles of 128 columns whose last
//   48 or 16 TMA fills with zeros. S^T, dP^T, S and dP contract over d in
//   ceil(d / 16) k-steps (no waste); dV += P^T dO, dK += dS^T Q and
//   dQ += dS K run at N = 128, 128 / d of their work (1.6x at 80, 1.14x
//   at 112); the stores write d columns.
// * What holds it below the tensor-core rate: each block waits on each
//   product group before the next (the elementwise step between them does
//   not overlap its own products), and at DP = 128 the dK and dV
//   accumulators take 128 of a thread's registers.
// * Head dim 192 (Nemotron-4 340B): one warpgroup's two m64n192 float32
//   accumulators would take 192 registers a thread before S^T and dP^T,
//   so `dkdv_split_kernel` runs two warpgroups a block: warpgroup 0 holds
//   dV (S^T, P, dV += P^T dO) and warpgroup 1 dK (S^T, dP^T, dS, dK +=
//   dS^T Q). Both compute S^T: 5 products a tile pair where one warpgroup
//   does 4. They share the tiles and the ring, six 64 x 192 bf16 tiles,
//   148,480 bytes with the alignment pad: one block an SM. The dQ kernel
//   keeps one warpgroup and one m64n192 accumulator.
//
// float32: `dkdv_kernel` and `dq_kernel`, on the CUDA cores (the
// reference's float32 tolerance rules out TF32). Each product is a 64 x 64
// tile per block, each of 256 threads holding a 4 x 4 register tile (and
// 4 rows x D / 16 columns of each accumulator), operands staged in shared
// memory as float32, transposed to [d][row] with rows padded to 68 floats
// so that a thread reads four rows with one 16-byte load. Built at D = 16,
// 32, 64, 80, 112, 128 and 192 (`f32_head_dims`), a head dim between two
// of them staged with zero columns up to the next; the shared memory (122
// KB at 80, 157 KB at 112) is set per instantiation. At 192 the four
// staged tiles take 209 KB, so P and dS share one [query][LD] buffer in
// turn (dV's sum, then dK's), 226,816 bytes in all.
//
// Inputs: q (B, Hq, S, D), k and v (B, Hkv, S, D), dO (B, Hq, S, D), each
// with element strides over batch, head and position and a contiguous head
// dim (bf16: 16-byte aligned bases and strides, which TMA needs; the
// wrapper checks); O a contiguous (B, Hq, S, D); lse a contiguous float32
// (B, Hq, S). Float32 or bfloat16, all of one type; head dims a multiple
// of 8 up to 128, or 192. Outputs: contiguous dQ (B, Hq, S, D), dK and dV (B, Hkv, S, D) in
// the input type, each written once (no atomics), and the float32
// workspace D (B, Hq, S).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int LD = BQ + 4;    // padded row of every shared tile, floats
constexpr int THREADS = 256;  // 16 row groups x 16 column groups

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int64_t qsb, qsh, qss;
  int64_t ksb, ksh, kss;
  int64_t vsb, vsh, vss;
  int64_t dsb, dsh, dss;  // dO
  int64_t hq, hkv, qpk, seq, window;  // window < 0: no window
  float scale;
  int causal;
  int64_t d;  // head dim (the kernels' padded width >= d)
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Whether query row `row` attends key `col`, as the forward masks.
__device__ __forceinline__ bool attends(const Args& a, int64_t row,
                                        int64_t col) {
  bool ok = row < a.seq && col < a.seq;
  if (a.causal) ok = ok && col <= row;
  if (a.window >= 0) ok = ok && col > row - a.window;
  return ok;
}

// 1. D = rowsum(dO * O): one warp per (batch * q head, row).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    delta_kernel(Args a, int64_t rows, int d) {
  const int64_t row = (int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int64_t bh = row / a.seq;
  const int64_t r = row % a.seq;
  const int64_t b = bh / a.hq;
  const int64_t h = bh % a.hq;
  const T* op = (const T*)a.o + row * d;
  const T* dp = (const T*)a.dout + b * a.dsb + h * a.dsh + r * a.dss;
  float s = 0.0f;
  for (int i = lane; i < d; i += 32) s += load(op + i) * load(dp + i);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.delta[row] = s;
}

// Stages rows r0 .. r0 + 63 of a (S, hd) matrix with row stride `stride`
// into `dst` as float32 [d][row] for d < D (rows padded to LD); rows past
// the sequence end and columns past hd load as zeros. Consecutive threads
// read consecutive values.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t stride,
                                      int64_t r0, int64_t seq, int64_t hd) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
    const int d = idx % D;
    const int row = idx / D;
    const int64_t r = r0 + row;
    dst[d * LD + row] = r < seq && d < hd ? load(src + r * stride + d) : 0.0f;
  }
}

// acc[i][j] = sum_d at[d][4 rg + i] * bt[d][4 cg + j]: one 4 x 4 tile of a
// 64 x 64 product of two staged [d][row] tiles.
template <int D>
__device__ __forceinline__ void tile_product(const float* at, const float* bt,
                                             int rg, int cg, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(at + d * LD + 4 * rg);
    const float4 y = *reinterpret_cast<const float4*>(bt + d * LD + 4 * cg);
    const float xa[4] = {x.x, x.y, x.z, x.w};
    const float ya[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], ya[j], acc[i][j]);
  }
}

// P and dS (scale folded in) of one (64-query, 64-key) tile for this
// thread's rows q0 + 4 rg + i and keys k0 + 4 cg + j, from the staged
// Q, K, dO and V tiles and the rows' lse and D.
template <int D>
__device__ __forceinline__ void probs_and_dscores(
    const Args& a, const float* qt, const float* kt, const float* dot,
    const float* vt, const float* lse_s, const float* del_s, int64_t q0,
    int64_t k0, int rg, int cg, float p[4][4], float ds[4][4]) {
  float dp[4][4];
  tile_product<D>(qt, kt, rg, cg, p);
  tile_product<D>(dot, vt, rg, cg, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + 4 * rg + i;
    const float lse = lse_s[4 * rg + i];
    const float del = del_s[4 * rg + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = lse != -INFINITY && attends(a, row, k0 + 4 * cg + j);
      p[i][j] = ok ? expf(p[i][j] * a.scale - lse) : 0.0f;
      ds[i][j] = p[i][j] * (dp[i][j] - del) * a.scale;
    }
  }
}

// Stages one query tile of head (b, h): Q and dO as [d][row], and the
// rows' lse and D (rows past the end: lse -inf, so P = 0).
template <typename T, int D>
__device__ __forceinline__ void stage_queries(const Args& a, int64_t b,
                                              int64_t h, int64_t q0,
                                              float* qt, float* dot,
                                              float* lse_s, float* del_s) {
  stage<T, D>(qt, (const T*)a.q + b * a.qsb + h * a.qsh, a.qss, q0, a.seq,
              a.d);
  stage<T, D>(dot, (const T*)a.dout + b * a.dsb + h * a.dsh, a.dss, q0,
              a.seq, a.d);
  const int64_t base = (b * a.hq + h) * a.seq;
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool in = q0 + r < a.seq;
    lse_s[r] = in ? a.lse[base + q0 + r] : -INFINITY;
    del_s[r] = in ? a.delta[base + q0 + r] : 0.0f;
  }
}

// [query][LD] buffers for P and dS: two, or at D = 192 (where two would
// pass the 227 KB a block may take) one, which holds P then dS.
template <int D>
constexpr int PBUFS = D > 128 ? 1 : 2;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (4 * (size_t)D * LD + PBUFS<D> * (size_t)BQ * LD + 2 * BQ);
}

// acc[i][j] += sum over the tile's 64 queries of at[query][4 rg + i] *
// bt[cg + 16 j][query]: dV += P^T dO or dK += dS^T Q.
template <int DPT>
__device__ __forceinline__ void accumulate_keys(const float* at,
                                                const float* bt, int rg,
                                                int cg, float acc[4][DPT]) {
  for (int qr = 0; qr < BQ; ++qr) {
    const float4 x = reinterpret_cast<const float4*>(at + qr * LD)[rg];
    const float xa[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const float y = bt[(cg + 16 * j) * LD + qr];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(xa[i], y, acc[i][j]);
    }
  }
}

// 2. dK and dV of one 64-key tile of kv head (b, hk).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(Args a) {
  constexpr int DPT = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;             // [D][LD]
  float* vt = kt + D * LD;      // [D][LD]
  float* qt = vt + D * LD;      // [D][LD]
  float* dot = qt + D * LD;     // [D][LD]
  float* ps = dot + D * LD;     // [query][LD]: P
  float* dss = ps + (PBUFS<D> - 1) * BQ * LD;  // [query][LD]: dS
  float* lse_s = ps + PBUFS<D> * BQ * LD;
  float* del_s = lse_s + BQ;

  const int t = threadIdx.x;
  const int rg = t >> 4;
  const int cg = t & 15;
  const int64_t bk = blockIdx.y;
  const int64_t b = bk / a.hkv;
  const int64_t hk = bk % a.hkv;
  const int64_t k0 = (int64_t)blockIdx.x * BK;
  const int64_t k_last = (k0 + BK < a.seq ? k0 + BK : a.seq) - 1;

  stage<T, D>(kt, (const T*)a.k + b * a.ksb + hk * a.ksh, a.kss, k0, a.seq,
              a.d);
  stage<T, D>(vt, (const T*)a.v + b * a.vsb + hk * a.vsh, a.vss, k0, a.seq,
              a.d);

  // the query tiles that see a key of this tile
  const int64_t n_qt = (a.seq + BQ - 1) / BQ;
  const int64_t qt_begin = a.causal ? k0 / BQ : 0;
  int64_t qt_end = n_qt;
  if (a.window >= 0) {
    const int64_t last = (k_last + a.window - 1) / BQ + 1;
    qt_end = last < n_qt ? last : n_qt;
  }

  float acc_k[4][DPT], acc_v[4][DPT];  // keys 4 rg + i, dims cg + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

  for (int64_t h = hk * a.qpk; h < (hk + 1) * a.qpk; ++h) {
    for (int64_t tile = qt_begin; tile < qt_end; ++tile) {
      const int64_t q0 = tile * BQ;
      __syncthreads();  // the previous tile's readers are done
      stage_queries<T, D>(a, b, h, q0, qt, dot, lse_s, del_s);
      __syncthreads();
      float p[4][4], ds[4][4];
      probs_and_dscores<D>(a, qt, kt, dot, vt, lse_s, del_s, q0, k0, rg, cg,
                           p, ds);
      if constexpr (PBUFS<D> == 1) {  // P, then dS, in the one buffer
#pragma unroll
        for (int i = 0; i < 4; ++i)
          reinterpret_cast<float4*>(ps + (4 * rg + i) * LD)[cg] =
              make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
        __syncthreads();
        accumulate_keys<DPT>(ps, dot, rg, cg, acc_v);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i)
          reinterpret_cast<float4*>(dss + (4 * rg + i) * LD)[cg] =
              make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
        __syncthreads();
        accumulate_keys<DPT>(dss, qt, rg, cg, acc_k);
        continue;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        reinterpret_cast<float4*>(ps + (4 * rg + i) * LD)[cg] =
            make_float4(p[i][0], p[i][1], p[i][2], p[i][3]);
        reinterpret_cast<float4*>(dss + (4 * rg + i) * LD)[cg] =
            make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
      }
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q over the tile's 64 queries
      for (int qr = 0; qr < BQ; ++qr) {
        const float4 pv = reinterpret_cast<const float4*>(ps + qr * LD)[rg];
        const float4 sv = reinterpret_cast<const float4*>(dss + qr * LD)[rg];
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const float dov = dot[(cg + 16 * j) * LD + qr];
          const float qv = qt[(cg + 16 * j) * LD + qr];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][j] = fmaf(pa[i], dov, acc_v[i][j]);
            acc_k[i][j] = fmaf(sa[i], qv, acc_k[i][j]);
          }
        }
      }
    }
  }

  const int64_t hd = a.d;
  T* dk = (T*)a.dk + (bk * a.seq) * hd;
  T* dv = (T*)a.dv + (bk * a.seq) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t key = k0 + 4 * rg + i;
    if (key >= a.seq) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      if (cg + 16 * j >= hd) continue;
      store(dk + key * hd + cg + 16 * j, acc_k[i][j]);
      store(dv + key * hd + cg + 16 * j, acc_v[i][j]);
    }
  }
}

// 3. dQ of one 64-query tile of head (b, h).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(Args a) {
  constexpr int DPT = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;             // [D][LD]
  float* dot = qt + D * LD;     // [D][LD]
  float* kt = dot + D * LD;     // [D][LD]
  float* vt = kt + D * LD;      // [D][LD]
  float* dst = vt + D * LD;     // [key][LD]: dS transposed
  float* lse_s = dst + PBUFS<D> * BQ * LD;
  float* del_s = lse_s + BQ;

  const int t = threadIdx.x;
  const int rg = t >> 4;
  const int cg = t & 15;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / a.hq;
  const int64_t h = bh % a.hq;
  const int64_t hk = h / a.qpk;
  const int64_t q0 = (int64_t)blockIdx.x * BQ;
  const int64_t q_last = (q0 + BQ < a.seq ? q0 + BQ : a.seq) - 1;

  stage_queries<T, D>(a, b, h, q0, qt, dot, lse_s, del_s);

  // the key tiles the forward visits (flash_attention.cu, key_tiles)
  const int64_t kt_end = a.causal ? q_last / BK + 1 : (a.seq + BK - 1) / BK;
  int64_t kt_begin = 0;
  if (a.window >= 0) {
    const int64_t first = q0 - a.window + 1;
    kt_begin = first > 0 ? first / BK : 0;
  }

  float acc[4][DPT];  // rows 4 rg + i, dims cg + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.0f;

  for (int64_t tile = kt_begin; tile < kt_end; ++tile) {
    const int64_t k0 = tile * BK;
    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(kt, (const T*)a.k + b * a.ksb + hk * a.ksh, a.kss, k0,
                a.seq, a.d);
    stage<T, D>(vt, (const T*)a.v + b * a.vsb + hk * a.vsh, a.vss, k0,
                a.seq, a.d);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs_and_dscores<D>(a, qt, kt, dot, vt, lse_s, del_s, q0, k0, rg, cg, p,
                         ds);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      reinterpret_cast<float4*>(dst + (4 * cg + j) * LD)[rg] =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    __syncthreads();
    // dQ += dS K over the tile's 64 keys
    for (int kr = 0; kr < BK; ++kr) {
      const float4 sv = reinterpret_cast<const float4*>(dst + kr * LD)[rg];
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float kv = kt[(cg + 16 * j) * LD + kr];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(sa[i], kv, acc[i][j]);
      }
    }
  }

  const int64_t hd = a.d;
  T* dq = (T*)a.dq + (bh * a.seq) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + 4 * rg + i;
    if (row >= a.seq) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (cg + 16 * j < hd) store(dq + row * hd + cg + 16 * j, acc[i][j]);
  }
}

template <typename T, int D>
int launch(const Args& a, int64_t batch, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static unsigned long long configured = 0;  // one bit a device
  const unsigned long long dev_bit = device_bit();
  if (!(configured & dev_bit)) {
    int err = set_smem(dkdv_kernel<T, D>, bytes);
    if (!err) err = set_smem(dq_kernel<T, D>, bytes);
    if (err) return err;
    configured |= dev_bit;
  }
  const int64_t rows = batch * a.hq * a.seq;
  const unsigned warps = THREADS / 32;
  delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps), THREADS, 0,
                    stream>>>(a, rows, (int)a.d);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const unsigned tiles = (unsigned)((a.seq + BK - 1) / BK);
  dkdv_kernel<T, D><<<dim3(tiles, (unsigned)(batch * a.hkv)), THREADS, bytes,
                      stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  dq_kernel<T, D><<<dim3(tiles, (unsigned)(batch * a.hq)), THREADS, bytes,
                    stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernels.

constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of a tensor-core block: two resident 64-row tiles and a
// ring of STAGES stages of two tiles, from a 1024-byte boundary (the
// swizzle's period). The outputs are staged over the tiles at the end, in
// rows padded to DP + 8 values.
template <int DP>
struct Bwd {
  static constexpr int TILE = Tiles<DP>::Q_TILE;  // 64 rows x DP bf16
  static constexpr int STAGES = 2;
  // dK and dV on two warpgroups (`dkdv_split_kernel`) past DP = 128
  static constexpr bool SPLIT = DP > 128;
  static constexpr size_t SMEM = 1024 + (2 + 2 * STAGES) * (size_t)TILE;
  static constexpr int OUT_ROW = (DP + 8) * 2;
  static_assert(2 * 64 * OUT_ROW <= (2 + 2 * STAGES) * TILE,
                "dK and dV staging fits over the tiles");
};

// Row `row`'s lse in log2 units, +inf where it has nothing to attend to
// (lse = -inf) or lies past the sequence: exp2(s - inf) = 0, so P = 0.
__device__ __forceinline__ float lse_log2(const Args& a, int64_t base,
                                          int64_t row) {
  if (row >= a.seq) return INFINITY;
  const float l = a.lse[base + row];
  return l == -INFINITY ? INFINITY : l * LOG2E;
}

// P and dS of one 64 x 64 tile in this thread's accumulator fragments, in
// place: s (scores) becomes P, dp becomes dS = P (dP - D). Fragment
// element i is (row r0 + 8 * ((i >> 1) & 1), column c0 + 8 * (i >> 2) +
// (i & 1)). KEY_ROWS (dK/dV): rows are keys and columns queries, whose
// lse2 and D are read at column offset 8 * (i >> 2) + (i & 1) of `lse2`
// and `del`; else rows are queries, with lse2[r] and del[r] for r = 0, 1.
// Without DS only s becomes P (dp is neither read nor written).
template <bool KEY_ROWS, bool MASK, bool DS = true>
__device__ __forceinline__ void frag_probs_and_dscores(
    const Args& a, float* s, float* dp, int64_t r0, int64_t c0,
    const float* lse2, const float* del, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hi = (i >> 1) & 1;
    const int cc = 8 * (i >> 2) + (i & 1);
    const float l = KEY_ROWS ? lse2[cc] : lse2[hi];
    const float dd = KEY_ROWS ? del[cc] : del[hi];
    float p = exp2f(s[i] * scale_log2 - l);
    if (MASK) {
      const int64_t row = r0 + 8 * hi;
      const int64_t col = c0 + cc;
      if (!(KEY_ROWS ? attends(a, col, row) : attends(a, row, col)))
        p = 0.0f;
    }
    s[i] = p;
    if (DS) dp[i] = p * (dp[i] - dd);
  }
}

// Packs a 64 x 64 accumulator fragment into the bf16 A-operand fragments
// of the next product (pair by pair, as the forward packs P).
__device__ __forceinline__ void pack_frags(const float* x, uint32_t (*f)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// Writes this thread's rows of a 64 x DP accumulator, times `mul`, as bf16
// into the padded staging rows at `out_s` (row lr + 8 r, its columns).
template <int DP>
__device__ __forceinline__ void stage_out(uint8_t* out_s, const float* acc,
                                          float mul, int lr, int c_lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < DP / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(
          out_s + (lr + 8 * r) * Bwd<DP>::OUT_ROW + (8 * c + c_lane) * 2) =
          __floats2bfloat162_rn(acc[4 * c + 2 * r] * mul,
                                acc[4 * c + 2 * r + 1] * mul);
}

// Copies the first d columns of the staged 64-row outputs (one at out_s
// for out0, and with out1 a second after it) to rows row0 .. row0 + 63
// (those below `seq`) of contiguous (S, d) bf16 matrices, 16 bytes at a
// time, over the block's NT threads.
template <int DP, int NT = 128>
__device__ __forceinline__ void store_out(const uint8_t* out_s,
                                          __nv_bfloat16* out0,
                                          __nv_bfloat16* out1, int64_t row0,
                                          int64_t seq, int64_t d) {
  const int chunks = (int)(d / 8);  // 16-byte pieces per row
  const int n_out = out1 == nullptr ? 1 : 2;
  for (int idx = threadIdx.x; idx < n_out * 64 * chunks; idx += NT) {
    const int which = idx / (64 * chunks);
    const int row = idx / chunks % 64;
    const int c = idx % chunks;
    __nv_bfloat16* dst = which ? out1 : out0;
    if (row0 + row < seq)
      *reinterpret_cast<uint4*>(
          reinterpret_cast<uint8_t*>(dst + (row0 + row) * d) + c * 16) =
          *reinterpret_cast<const uint4*>(
              out_s + (which * 64 + row) * Bwd<DP>::OUT_ROW + c * 16);
  }
}

// 2. dK and dV of one 64-key tile of kv head (b, hk), on the tensor
// cores. A 1-D grid: key tile 0 (the longest causal walk) of every
// (batch, kv head) first. Iteration j of the walk is query tile
// qt_begin + j % n_q of query head hk * qpk + j / n_q; its Q and dO tiles
// sit in ring stage j % 2, its lse2 and D in stats[j % 2], which thread t
// fills (t < 64: lse2 of query t, else D of query t - 64) for iteration
// j + 2 once every warp is done with iteration j.
template <int DP, int KS>
__global__ void __launch_bounds__(128)
    dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, Args a) {
  using B = Bwd<DP>;
  constexpr int TILE = B::TILE;
  constexpr int STAGES = B::STAGES;
  extern __shared__ uint8_t dyn[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];
  __shared__ __align__(16) float stats[STAGES][2][64];
  const uint32_t k_tile = (smem_u32(dyn) + 1023u) & ~1023u;
  const uint32_t v_tile = k_tile + TILE;
  auto q_tile = [&](int st) { return v_tile + TILE + 2 * st * TILE; };
  const uint32_t kv_bar = smem_u32(&bars[0]);
  auto bar = [&](int st) { return smem_u32(&bars[1 + st]); };

  const int64_t n_kt = (a.seq + 63) / 64;
  const int64_t bhkv = gridDim.x / n_kt;
  const int64_t bk = blockIdx.x % bhkv;
  const int64_t k0 = blockIdx.x / bhkv * 64;
  const int b = (int)(bk / a.hkv);
  const int hk = (int)(bk % a.hkv);
  const int64_t k_last = (k0 + 64 < a.seq ? k0 + 64 : a.seq) - 1;
  // the query tiles that see a key of this tile
  const int64_t qt_begin = a.causal ? k0 / 64 : 0;
  int64_t qt_end = n_kt;
  if (a.window >= 0) {
    const int64_t last = (k_last + a.window - 1) / 64 + 1;
    qt_end = last < n_kt ? last : n_kt;
  }
  const int64_t n_q = qt_end > qt_begin ? qt_end - qt_begin : 0;
  const int n = (int)(a.qpk * n_q);
  auto head = [&](int j) { return (int)(hk * a.qpk + j / n_q); };
  auto q0_of = [&](int j) { return (qt_begin + j % n_q) * 64; };
  auto stat = [&](int j, int t) {
    const int64_t base = ((int64_t)b * a.hq + head(j)) * a.seq;
    const int64_t row = q0_of(j) + (t & 63);
    if (t < 64) return lse_log2(a, base, row);
    return row < a.seq ? a.delta[base + row] : 0.0f;
  };

  const int tid = threadIdx.x;
  for (int j = 0; j < STAGES && j < n; ++j)
    stats[j][tid >> 6][tid & 63] = stat(j, tid);
  if (tid == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * TILE);
    load_tile<DP>(k_tile, &tk, (int)k0, hk, b, kv_bar);
    load_tile<DP>(v_tile, &tv, (int)k0, hk, b, kv_bar);
    for (int j = 0; j < STAGES && j < n; ++j) {
      mbar_expect_tx(bar(j), 2 * TILE);
      load_tile<DP>(q_tile(j), &tq, (int)q0_of(j), head(j), b, bar(j));
      load_tile<DP>(q_tile(j) + TILE, &tdo, (int)q0_of(j), head(j), b,
                   bar(j));
    }
  }

  const int lane = tid & 31;
  const int lr = 16 * (tid >> 5) + (lane >> 2);  // key rows lr, lr + 8
  const int c_lane = 2 * (lane & 3);
  const float scale_log2 = a.scale * LOG2E;
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.0f;
  float s[32], dp[32];
  uint32_t pf[4][4], dsf[4][4];

  mbar_wait(kv_bar, 0);
  for (int j = 0; j < n; ++j) {
    const int st = j % STAGES;
    const uint32_t parity = (uint32_t)(j / STAGES) & 1u;
    const int64_t q0 = q0_of(j);
    const bool refill = j + STAGES < n;
    const float next = refill ? stat(j + STAGES, tid) : 0.0f;
    const uint32_t qs = q_tile(st);
    mbar_wait(bar(st), parity);
    issue_scores<DP, KS>(s, k_tile, qs);          // S^T = K Q^T
    issue_scores<DP, KS>(dp, v_tile, qs + TILE);  // dP^T = V dO^T
    wgmma_wait_all();
    reg_fence<32>(s);
    reg_fence<32>(dp);
    const int64_t q_hi = (q0 + 64 < a.seq ? q0 + 64 : a.seq) - 1;
    const float* l2 = &stats[st][0][c_lane];
    const float* dl = &stats[st][1][c_lane];
    if (q0 + 64 > a.seq || k0 + 64 > a.seq || (a.causal && k0 + 63 > q0) ||
        (a.window >= 0 && k0 <= q_hi - a.window))
      frag_probs_and_dscores<true, true>(a, s, dp, k0 + lr, q0 + c_lane, l2,
                                         dl, scale_log2);
    else
      frag_probs_and_dscores<true, false>(a, s, dp, k0 + lr, q0 + c_lane,
                                          l2, dl, scale_log2);
    pack_frags(s, pf);
    pack_frags(dp, dsf);
    issue_values<DP>(dv, pf, qs + TILE);  // dV += P^T dO
    issue_values<DP>(dk, dsf, qs);        // dK += dS^T Q
    wgmma_wait_all();
    reg_fence<DP / 2>(dv);
    reg_fence<DP / 2>(dk);
    __syncthreads();  // every warp is done with stage st and its stats
    if (refill) {
      stats[st][tid >> 6][tid & 63] = next;
      if (tid == 0) {
        const int jn = j + STAGES;
        mbar_expect_tx(bar(st), 2 * TILE);
        load_tile<DP>(qs, &tq, (int)q0_of(jn), head(jn), b, bar(st));
        load_tile<DP>(qs + TILE, &tdo, (int)q0_of(jn), head(jn), b, bar(st));
      }
    }
  }

  // dK = scale * dS^T Q, dV as summed, through padded rows over the tiles
  // (every load has landed and every product has read its tiles).
  uint8_t* out_s = dyn + (k_tile - smem_u32(dyn));
  __syncthreads();
  stage_out<DP>(out_s, dk, a.scale, lr, c_lane);
  stage_out<DP>(out_s + 64 * B::OUT_ROW, dv, 1.0f, lr, c_lane);
  __syncthreads();
  store_out<DP>(out_s, (__nv_bfloat16*)a.dk + bk * a.seq * a.d,
                (__nv_bfloat16*)a.dv + bk * a.seq * a.d, k0, a.seq, a.d);
}

// 2, past DP = 128. dK and dV of one 64-key tile of kv head (b, hk) on two
// warpgroups: warpgroup 0 computes S^T, P and dV += P^T dO, warpgroup 1
// S^T, dP^T, dS and dK += dS^T Q, so each holds one m64nDP accumulator.
// The grid, the walk, the ring and the stats are dkdv_wgmma_kernel's; the
// first 128 threads stage the stats, and a stage is refilled once both
// warpgroups are done with it.
template <int DP, int KS>
__global__ void __launch_bounds__(256, 1)
    dkdv_split_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, Args a) {
  using B = Bwd<DP>;
  constexpr int TILE = B::TILE;
  constexpr int STAGES = B::STAGES;
  extern __shared__ uint8_t dyn[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];
  __shared__ __align__(16) float stats[STAGES][2][64];
  const uint32_t k_tile = (smem_u32(dyn) + 1023u) & ~1023u;
  const uint32_t v_tile = k_tile + TILE;
  auto q_tile = [&](int st) { return v_tile + TILE + 2 * st * TILE; };
  const uint32_t kv_bar = smem_u32(&bars[0]);
  auto bar = [&](int st) { return smem_u32(&bars[1 + st]); };

  const int64_t n_kt = (a.seq + 63) / 64;
  const int64_t bhkv = gridDim.x / n_kt;
  const int64_t bk = blockIdx.x % bhkv;
  const int64_t k0 = blockIdx.x / bhkv * 64;
  const int b = (int)(bk / a.hkv);
  const int hk = (int)(bk % a.hkv);
  const int64_t k_last = (k0 + 64 < a.seq ? k0 + 64 : a.seq) - 1;
  const int64_t qt_begin = a.causal ? k0 / 64 : 0;
  int64_t qt_end = n_kt;
  if (a.window >= 0) {
    const int64_t last = (k_last + a.window - 1) / 64 + 1;
    qt_end = last < n_kt ? last : n_kt;
  }
  const int64_t n_q = qt_end > qt_begin ? qt_end - qt_begin : 0;
  const int n = (int)(a.qpk * n_q);
  auto head = [&](int j) { return (int)(hk * a.qpk + j / n_q); };
  auto q0_of = [&](int j) { return (qt_begin + j % n_q) * 64; };
  auto stat = [&](int j, int t) {
    const int64_t base = ((int64_t)b * a.hq + head(j)) * a.seq;
    const int64_t row = q0_of(j) + (t & 63);
    if (t < 64) return lse_log2(a, base, row);
    return row < a.seq ? a.delta[base + row] : 0.0f;
  };

  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // 0: dV, 1: dK
  const int wt = tid & 127;
  if (tid < 128)
    for (int j = 0; j < STAGES && j < n; ++j)
      stats[j][tid >> 6][tid & 63] = stat(j, tid);
  if (tid == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * TILE);
    load_tile<DP>(k_tile, &tk, (int)k0, hk, b, kv_bar);
    load_tile<DP>(v_tile, &tv, (int)k0, hk, b, kv_bar);
    for (int j = 0; j < STAGES && j < n; ++j) {
      mbar_expect_tx(bar(j), 2 * TILE);
      load_tile<DP>(q_tile(j), &tq, (int)q0_of(j), head(j), b, bar(j));
      load_tile<DP>(q_tile(j) + TILE, &tdo, (int)q0_of(j), head(j), b,
                   bar(j));
    }
  }

  const int lane = wt & 31;
  const int lr = 16 * (wt >> 5) + (lane >> 2);  // key rows lr, lr + 8
  const int c_lane = 2 * (lane & 3);
  const float scale_log2 = a.scale * LOG2E;
  float acc[DP / 2];  // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float s[32], dp[32];
  uint32_t af[4][4];

  mbar_wait(kv_bar, 0);
  for (int j = 0; j < n; ++j) {
    const int st = j % STAGES;
    const uint32_t parity = (uint32_t)(j / STAGES) & 1u;
    const int64_t q0 = q0_of(j);
    const bool refill = j + STAGES < n;
    const float next = refill && tid < 128 ? stat(j + STAGES, tid) : 0.0f;
    const uint32_t qs = q_tile(st);
    mbar_wait(bar(st), parity);
    const int64_t q_hi = (q0 + 64 < a.seq ? q0 + 64 : a.seq) - 1;
    const float* l2 = &stats[st][0][c_lane];
    const float* dl = &stats[st][1][c_lane];
    const bool mask = q0 + 64 > a.seq || k0 + 64 > a.seq ||
                      (a.causal && k0 + 63 > q0) ||
                      (a.window >= 0 && k0 <= q_hi - a.window);
    if (wg == 0) {
      issue_scores<DP, KS>(s, k_tile, qs);  // S^T = K Q^T
      wgmma_wait_all();
      reg_fence<32>(s);
      if (mask)
        frag_probs_and_dscores<true, true, false>(a, s, dp, k0 + lr,
                                                  q0 + c_lane, l2, dl,
                                                  scale_log2);
      else
        frag_probs_and_dscores<true, false, false>(a, s, dp, k0 + lr,
                                                   q0 + c_lane, l2, dl,
                                                   scale_log2);
      pack_frags(s, af);
      issue_values<DP>(acc, af, qs + TILE);  // dV += P^T dO
    } else {
      issue_scores<DP, KS>(s, k_tile, qs);          // S^T = K Q^T
      issue_scores<DP, KS>(dp, v_tile, qs + TILE);  // dP^T = V dO^T
      wgmma_wait_all();
      reg_fence<32>(s);
      reg_fence<32>(dp);
      if (mask)
        frag_probs_and_dscores<true, true>(a, s, dp, k0 + lr, q0 + c_lane,
                                           l2, dl, scale_log2);
      else
        frag_probs_and_dscores<true, false>(a, s, dp, k0 + lr, q0 + c_lane,
                                            l2, dl, scale_log2);
      pack_frags(dp, af);
      issue_values<DP>(acc, af, qs);  // dK += dS^T Q
    }
    wgmma_wait_all();
    reg_fence<DP / 2>(acc);
    __syncthreads();  // both warpgroups are done with stage st and its stats
    if (refill) {
      if (tid < 128) stats[st][tid >> 6][tid & 63] = next;
      if (tid == 0) {
        const int jn = j + STAGES;
        mbar_expect_tx(bar(st), 2 * TILE);
        load_tile<DP>(qs, &tq, (int)q0_of(jn), head(jn), b, bar(st));
        load_tile<DP>(qs + TILE, &tdo, (int)q0_of(jn), head(jn), b, bar(st));
      }
    }
  }

  // dK = scale * dS^T Q (first), dV as summed, through padded rows over
  // the tiles.
  uint8_t* out_s = dyn + (k_tile - smem_u32(dyn));
  __syncthreads();
  if (wg == 1)
    stage_out<DP>(out_s, acc, a.scale, lr, c_lane);
  else
    stage_out<DP>(out_s + 64 * B::OUT_ROW, acc, 1.0f, lr, c_lane);
  __syncthreads();
  store_out<DP, 256>(out_s, (__nv_bfloat16*)a.dk + bk * a.seq * a.d,
                     (__nv_bfloat16*)a.dv + bk * a.seq * a.d, k0, a.seq,
                     a.d);
}

// 3. dQ of one 64-query tile of head (b, h), on the tensor cores. A 1-D
// grid: the last query tile (the longest causal walk) of every (batch,
// head) first. The K and V tiles of the key tiles it walks go through the
// ring.
template <int DP, int KS>
__global__ void __launch_bounds__(128)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, Args a) {
  using B = Bwd<DP>;
  constexpr int TILE = B::TILE;
  constexpr int STAGES = B::STAGES;
  extern __shared__ uint8_t dyn[];
  __shared__ __align__(8) uint64_t bars[1 + STAGES];
  const uint32_t q_tile = (smem_u32(dyn) + 1023u) & ~1023u;
  const uint32_t do_tile = q_tile + TILE;
  auto k_tile = [&](int st) { return do_tile + TILE + 2 * st * TILE; };
  const uint32_t qd_bar = smem_u32(&bars[0]);
  auto bar = [&](int st) { return smem_u32(&bars[1 + st]); };

  const int64_t n_qt = (a.seq + 63) / 64;
  const int64_t bhq = gridDim.x / n_qt;
  const int64_t bh = blockIdx.x % bhq;
  const int64_t q0 = (n_qt - 1 - blockIdx.x / bhq) * 64;
  const int b = (int)(bh / a.hq);
  const int h = (int)(bh % a.hq);
  const int hk = (int)(h / a.qpk);
  const int64_t q_last = (q0 + 64 < a.seq ? q0 + 64 : a.seq) - 1;
  // the key tiles the forward visits (flash_attention.cu, key_tiles)
  const int64_t kt_end = a.causal ? q_last / 64 + 1 : (a.seq + 63) / 64;
  int64_t kt_begin = 0;
  if (a.window >= 0) {
    const int64_t first = q0 - a.window + 1;  // least key row q0 keeps
    kt_begin = first > 0 ? first / 64 : 0;
  }
  const int n = (int)(kt_end - kt_begin);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qd_bar, 2 * TILE);
    load_tile<DP>(q_tile, &tq, (int)q0, h, b, qd_bar);
    load_tile<DP>(do_tile, &tdo, (int)q0, h, b, qd_bar);
    for (int j = 0; j < STAGES && j < n; ++j) {
      const int kn = (int)((kt_begin + j) * 64);
      mbar_expect_tx(bar(j), 2 * TILE);
      load_tile<DP>(k_tile(j), &tk, kn, hk, b, bar(j));
      load_tile<DP>(k_tile(j) + TILE, &tv, kn, hk, b, bar(j));
    }
  }

  const int lane = tid & 31;
  const int lr = 16 * (tid >> 5) + (lane >> 2);  // query rows lr, lr + 8
  const int c_lane = 2 * (lane & 3);
  const float scale_log2 = a.scale * LOG2E;
  const int64_t base = bh * a.seq;
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = q0 + lr + 8 * r;
    lse2[r] = lse_log2(a, base, row);
    del[r] = row < a.seq ? a.delta[base + row] : 0.0f;
  }
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.0f;
  float s[32], dp[32];
  uint32_t dsf[4][4];

  mbar_wait(qd_bar, 0);
  for (int j = 0; j < n; ++j) {
    const int st = j % STAGES;
    const uint32_t parity = (uint32_t)(j / STAGES) & 1u;
    const int64_t k0 = (kt_begin + j) * 64;
    const uint32_t ks = k_tile(st);
    mbar_wait(bar(st), parity);
    issue_scores<DP, KS>(s, q_tile, ks);           // S = Q K^T
    issue_scores<DP, KS>(dp, do_tile, ks + TILE);  // dP = dO V^T
    wgmma_wait_all();
    reg_fence<32>(s);
    reg_fence<32>(dp);
    if (k0 + 64 > a.seq || (a.causal && k0 + 63 > q0) ||
        (a.window >= 0 && k0 <= q_last - a.window))
      frag_probs_and_dscores<false, true>(a, s, dp, q0 + lr, k0 + c_lane,
                                          lse2, del, scale_log2);
    else
      frag_probs_and_dscores<false, false>(a, s, dp, q0 + lr, k0 + c_lane,
                                           lse2, del, scale_log2);
    pack_frags(dp, dsf);
    issue_values<DP>(dq, dsf, ks);  // dQ += dS K
    wgmma_wait_all();
    reg_fence<DP / 2>(dq);
    if (j + STAGES < n) {
      __syncthreads();  // every warp is done with stage st
      if (tid == 0) {
        const int kn = (int)(k0 + STAGES * 64);
        mbar_expect_tx(bar(st), 2 * TILE);
        load_tile<DP>(ks, &tk, kn, hk, b, bar(st));
        load_tile<DP>(ks + TILE, &tv, kn, hk, b, bar(st));
      }
    }
  }

  // dQ = scale * dS K through padded rows over the tiles, once every warp
  // is done with them.
  uint8_t* out_s = dyn + (q_tile - smem_u32(dyn));
  __syncthreads();
  stage_out<DP>(out_s, dq, a.scale, lr, c_lane);
  __syncthreads();
  store_out<DP>(out_s, (__nv_bfloat16*)a.dq + bh * a.seq * a.d, nullptr, q0,
                a.seq, a.d);
}

// One 64-row tile of each product of the dK/dV kernel, through the same
// loads, descriptors and fragments: st = k q^T (64 x 64: K as A, Q as
// K-major B), then with P = st rounded to bf16 and packed from the
// accumulator as the A operand, pd = P do and pq = P q (64 x d: dO and Q
// as MN-major B); float32, row-major. For testing the layouts on the card.
template <int DP, int KS>
__global__ void __launch_bounds__(128)
    bwd_tile_products_kernel(const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             float* st_out, float* pd_out, float* pq_out,
                             int d) {
  constexpr int TILE = Bwd<DP>::TILE;
  extern __shared__ uint8_t dyn[];
  __shared__ __align__(8) uint64_t bar_mem;
  const uint32_t k_tile = (smem_u32(dyn) + 1023u) & ~1023u;
  const uint32_t q_tile = k_tile + TILE;
  const uint32_t do_tile = q_tile + TILE;
  const uint32_t bar = smem_u32(&bar_mem);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 3 * TILE);
    load_tile<DP>(k_tile, &tk, 0, 0, 0, bar);
    load_tile<DP>(q_tile, &tq, 0, 0, 0, bar);
    load_tile<DP>(do_tile, &tdo, 0, 0, 0, bar);
  }
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);
  const int c_lane = 2 * (lane & 3);
  mbar_wait(bar, 0);
  float s[32];
  issue_scores<DP, KS>(s, k_tile, q_tile);
  wgmma_wait_all();
  reg_fence<32>(s);
  uint32_t pf[4][4];
  pack_frags(s, pf);
  float pd[DP / 2], pq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) pd[i] = pq[i] = 0.0f;
  issue_values<DP>(pd, pf, do_tile);
  issue_values<DP>(pq, pf, q_tile);
  wgmma_wait_all();
  reg_fence<DP / 2>(pd);
  reg_fence<DP / 2>(pq);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    st_out[(r0 + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + c_lane + (i & 1)] =
        s[i];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int col = 8 * (i >> 2) + c_lane + (i & 1);
    if (col >= d) continue;
    const int at = (r0 + 8 * ((i >> 1) & 1)) * d + col;
    pd_out[at] = pd[i];
    pq_out[at] = pq[i];
  }
}

template <int DP, int KS>
int launch_bf16(const Args& a, int64_t batch, cudaStream_t stream) {
  using B = Bwd<DP>;
  static unsigned long long configured = 0;  // one bit a device
  const unsigned long long dev_bit = device_bit();
  if (!(configured & dev_bit)) {
    int err;
    if constexpr (B::SPLIT)
      err = set_smem(dkdv_split_kernel<DP, KS>, B::SMEM);
    else
      err = set_smem(dkdv_wgmma_kernel<DP, KS>, B::SMEM);
    if (!err) err = set_smem(dq_wgmma_kernel<DP, KS>, B::SMEM);
    if (err) return err;
    configured |= dev_bit;
  }
  CUtensorMap tq, tk, tv, tdo;
  const int64_t d = a.d;
  if (!make_map<DP>(&tq, a.q, d, a.seq, a.hq, batch, a.qss, a.qsh, a.qsb) ||
      !make_map<DP>(&tk, a.k, d, a.seq, a.hkv, batch, a.kss, a.ksh,
                    a.ksb) ||
      !make_map<DP>(&tv, a.v, d, a.seq, a.hkv, batch, a.vss, a.vsh,
                    a.vsb) ||
      !make_map<DP>(&tdo, a.dout, d, a.seq, a.hq, batch, a.dss, a.dsh,
                    a.dsb))
    return (int)cudaErrorInvalidValue;
  const int64_t rows = batch * a.hq * a.seq;
  const unsigned warps = THREADS / 32;
  delta_kernel<__nv_bfloat16><<<(unsigned)((rows + warps - 1) / warps),
                                THREADS, 0, stream>>>(a, rows, (int)d);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int64_t tiles = (a.seq + 63) / 64;
  if constexpr (B::SPLIT)
    dkdv_split_kernel<DP, KS><<<(unsigned)(tiles * batch * a.hkv), 256,
                               B::SMEM, stream>>>(tq, tk, tv, tdo, a);
  else
    dkdv_wgmma_kernel<DP, KS><<<(unsigned)(tiles * batch * a.hkv), 128,
                               B::SMEM, stream>>>(tq, tk, tv, tdo, a);
  err = (int)cudaGetLastError();
  if (err) return err;
  dq_wgmma_kernel<DP, KS><<<(unsigned)(tiles * batch * a.hq), 128,
                           B::SMEM, stream>>>(tq, tk, tv, tdo, a);
  return (int)cudaGetLastError();
}

template <int DP, int KS>
int launch_tile_products(const void* k, const void* q, const void* dout,
                         void* st_out, void* pd_out, void* pq_out, int64_t d,
                         cudaStream_t stream) {
  constexpr size_t bytes = 1024 + 3 * (size_t)Bwd<DP>::TILE;
  static unsigned long long configured = 0;  // one bit a device
  const unsigned long long dev_bit = device_bit();
  if (!(configured & dev_bit)) {
    const int err = set_smem(bwd_tile_products_kernel<DP, KS>, bytes);
    if (err) return err;
    configured |= dev_bit;
  }
  CUtensorMap tk, tq, tdo;
  if (!make_map<DP>(&tk, k, d, 64, 1, 1, d, 0, 0) ||
      !make_map<DP>(&tq, q, d, 64, 1, 1, d, 0, 0) ||
      !make_map<DP>(&tdo, dout, d, 64, 1, 1, d, 0, 0))
    return (int)cudaErrorInvalidValue;
  bwd_tile_products_kernel<DP, KS><<<1, 128, bytes, stream>>>(
      tk, tq, tdo, (float*)st_out, (float*)pd_out, (float*)pq_out, (int)d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The three launches of the backward on `stream`. Strides are in
// elements over (batch, head, position) for q, k, v and dout; o, lse,
// delta, dq, dk and dv are contiguous. dtype: 0 float32 (the CUDA-core
// kernels), 1 bfloat16 (the tensor-core ones). d: a multiple of 8 up to
// 128, or 192. window < 0: no window. Returns the first launch error, else 0;
// cudaErrorInvalidValue for another head dim.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* delta, void* dq,
                               void* dk, void* dv, int64_t qsb, int64_t qsh,
                               int64_t qss, int64_t ksb, int64_t ksh,
                               int64_t kss, int64_t vsb, int64_t vsh,
                               int64_t vss, int64_t dsb, int64_t dsh,
                               int64_t dss, int64_t batch, int64_t hq,
                               int64_t hkv, int64_t seq, int64_t d,
                               float scale, int causal, int64_t window,
                               int dtype, void* stream) {
  if (batch <= 0 || hq <= 0 || seq <= 0) return (int)cudaGetLastError();
  if (hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, (const float*)lse, (float*)delta, dq, dk, dv,
         qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, dsb, dsh, dss,
         hq, hkv, hq / hkv, seq, window, scale, causal, d};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return f32_head_dims(d, [&](auto dp) {
      return launch<float, decltype(dp)::value>(a, batch, s);
    });
  if (dtype == 1)
    return head_dims(d, [&](auto dp, auto ks) {
      return launch_bf16<decltype(dp)::value, decltype(ks)::value>(a, batch,
                                                                   s);
    });
  return (int)cudaErrorInvalidValue;
}

// One tile of each bf16 product of the dK/dV kernel through its loads and
// wgmma layouts: k, q, dout contiguous (64, d) bf16; st_out = k q^T
// (64, 64), pd_out = bf16(st) dout and pq_out = bf16(st) q (64, d),
// float32.
int flash_attention_bwd_tile_products(const void* k, const void* q,
                                      const void* dout, void* st_out,
                                      void* pd_out, void* pq_out, int64_t d,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return head_dims(d, [&](auto dp, auto ks) {
    return launch_tile_products<decltype(dp)::value, decltype(ks)::value>(
        k, q, dout, st_out, pd_out, pq_out, d, s);
  });
}

}  // extern "C"
