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
// Three launches:
// 1. `delta_kernel`: D = rowsum(dO * O), one warp per row, float32.
// 2. `dkdv_kernel`: one block per (batch * kv head, 64-key tile). K and V
//    stay in shared memory; the block walks every query tile that sees the
//    key tile, for each of the Hq / Hkv query heads that share the kv
//    head, so grouped heads need no atomics and the sums run in one fixed
//    order (deterministic).
// 3. `dq_kernel`: one block per (batch * q head, 64-query tile), walking
//    the key tiles the forward walks (`key_tiles`).
// Tiles wholly masked are skipped as in the forward: causal query tiles
// above a key tile, and tiles outside every row's window.
//
// What bounds it: operations. The backward does about 2.5 times the
// forward's products (Q K^T again, dO V^T, P^T dO, dS^T Q, dS K against
// Q K^T and P V), all here on the CUDA cores in float32 (67 TFLOP/s of
// the card's 989 bf16 on the tensor cores). A first, simple kernel: each
// product is a 64 x 64 tile per block, each of 256 threads holding a
// 4 x 4 register tile (and 4 rows x D / 16 columns of each accumulator),
// operands staged in shared memory as float32, transposed to [d][row]
// with rows padded to 68 floats so that a thread reads four rows with one
// 16-byte load. `wgmma` and TMA are later work.
//
// Inputs: q (B, Hq, S, D), k and v (B, Hkv, S, D), dO (B, Hq, S, D), each
// with element strides over batch, head and position and a contiguous head
// dim; O a contiguous (B, Hq, S, D); lse a contiguous float32 (B, Hq, S).
// Float32 or bfloat16, all of one type; head dims 16, 32, 64, 128.
// Outputs: contiguous dQ (B, Hq, S, D), dK and dV (B, Hkv, S, D) in the
// input type, each written once (no atomics), and the float32 workspace D
// (B, Hq, S).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

// Stages rows r0 .. r0 + 63 of a (S, D) matrix with row stride `stride`
// into `dst` as float32 [d][row] (rows padded to LD); rows past the
// sequence end load as zeros. Consecutive threads read consecutive values.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t stride,
                                      int64_t r0, int64_t seq) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
    const int d = idx % D;
    const int row = idx / D;
    const int64_t r = r0 + row;
    dst[d * LD + row] = r < seq ? load(src + r * stride + d) : 0.0f;
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
  stage<T, D>(qt, (const T*)a.q + b * a.qsb + h * a.qsh, a.qss, q0, a.seq);
  stage<T, D>(dot, (const T*)a.dout + b * a.dsb + h * a.dsh, a.dss, q0,
              a.seq);
  const int64_t base = (b * a.hq + h) * a.seq;
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool in = q0 + r < a.seq;
    lse_s[r] = in ? a.lse[base + q0 + r] : -INFINITY;
    del_s[r] = in ? a.delta[base + q0 + r] : 0.0f;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * (size_t)D * LD + 2 * (size_t)BQ * LD + 2 * BQ);
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
  float* dss = ps + BQ * LD;    // [query][LD]: dS
  float* lse_s = dss + BQ * LD;
  float* del_s = lse_s + BQ;

  const int t = threadIdx.x;
  const int rg = t >> 4;
  const int cg = t & 15;
  const int64_t bk = blockIdx.y;
  const int64_t b = bk / a.hkv;
  const int64_t hk = bk % a.hkv;
  const int64_t k0 = (int64_t)blockIdx.x * BK;
  const int64_t k_last = (k0 + BK < a.seq ? k0 + BK : a.seq) - 1;

  stage<T, D>(kt, (const T*)a.k + b * a.ksb + hk * a.ksh, a.kss, k0, a.seq);
  stage<T, D>(vt, (const T*)a.v + b * a.vsb + hk * a.vsh, a.vss, k0, a.seq);

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

  T* dk = (T*)a.dk + (bk * a.seq) * D;
  T* dv = (T*)a.dv + (bk * a.seq) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t key = k0 + 4 * rg + i;
    if (key >= a.seq) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      store(dk + key * D + cg + 16 * j, acc_k[i][j]);
      store(dv + key * D + cg + 16 * j, acc_v[i][j]);
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
  float* lse_s = dst + 2 * BQ * LD;
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
    stage<T, D>(kt, (const T*)a.k + b * a.ksb + hk * a.ksh, a.kss, k0, a.seq);
    stage<T, D>(vt, (const T*)a.v + b * a.vsb + hk * a.vsh, a.vss, k0, a.seq);
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

  T* dq = (T*)a.dq + (bh * a.seq) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + 4 * rg + i;
    if (row >= a.seq) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) store(dq + row * D + cg + 16 * j, acc[i][j]);
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
int launch(const Args& a, int64_t batch, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    int err = set_smem(dkdv_kernel<T, D>, bytes);
    if (!err) err = set_smem(dq_kernel<T, D>, bytes);
    if (err) return err;
    configured = true;
  }
  const int64_t rows = batch * a.hq * a.seq;
  const unsigned warps = THREADS / 32;
  delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps), THREADS, 0,
                    stream>>>(a, rows, D);
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

template <typename T>
int launch_dims(const Args& a, int64_t batch, int64_t d, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(a, batch, s);
    case 32: return launch<T, 32>(a, batch, s);
    case 64: return launch<T, 64>(a, batch, s);
    case 128: return launch<T, 128>(a, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The three launches of the backward on `stream`. Strides are in
// elements over (batch, head, position) for q, k, v and dout; o, lse,
// delta, dq, dk and dv are contiguous. dtype: 0 float32, 1 bfloat16.
// window < 0: no window. Returns the first launch error, else 0.
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
         hq, hkv, hq / hkv, seq, window, scale, causal};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_dims<float>(a, batch, d, s);
  if (dtype == 1) return launch_dims<__nv_bfloat16>(a, batch, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
