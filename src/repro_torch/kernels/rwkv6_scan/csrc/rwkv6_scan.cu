// rwkv6_scan: the chunked RWKV-6 (Finch) gated linear recurrence.
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6_scan/kernel.py
// (`rwkv6_scan_kernel`, body `_rwkv6_kernel`). There the grid is
// (batch * heads, seq / chunk) with the chunk axis sequential, carrying the
// (dk, dv) state in VMEM scratch from one chunk to the next. Here one block
// of 256 threads owns one (batch, head) pair and walks the chunks in a
// loop, carrying the state in shared memory; at the end it also writes the
// final state, which the decode cache starts from.
//
// Per chunk of L rows (what the Pallas body computes, in float32):
//   c_t   = sum_{s<=t} log w_s                 per channel, inclusive
//   q~_t  = r_t * exp(c_t - log w_t)           decay since the chunk start
//   k~_s  = k_s * exp(-c_s)                    inverse decay to the start
//   P     = q~ k~^T, strictly causal, with r_t . (u * k_t) on the diagonal
//   o     = P V + q~ S
//   S    <- exp(c_L) * (S + k~^T V)            per row of S
//
// What bounds it: at the serving shape (B*H = 128, S = 1024, 64 x 64) the
// ~117 MB of inputs and outputs take ~0.036 ms at 3.35 TB/s. The scan
// cannot do less than q~ S and the state update, 4 dk dv FLOPs per
// position, plus the intra-chunk terms of the best chunk (about 6 rows):
// ~2.3 GFLOP, ~0.035 ms at the float32 rate, so the bytes bind. Chunks
// of 64 do ~3.2 GFLOP. This first version computes on the CUDA cores from
// shared memory with one block per (batch, head); a tensor-core version
// is later work.
//
// Design:
// * Each chunk's r, k, log w, r*u*k and v are loaded once, converted to
//   float32, into [row][channel] tiles padded to 65 columns (no bank
//   conflicts for the column walks below). Rows past the chunk or the
//   sequence load as r = k = v = 0, log w = 0: the identity step.
// * The cumsum runs on 4 threads per channel, 16 rows each: segment sums,
//   then each segment rescans from its offset and overwrites r and k with
//   q~ and k~ in place. The last segment leaves exp(c_L) per channel.
// * Thread t is the 4 x 4 register tile (rg + 16 i, cg + 16 j) of every
//   64 x 64 product, rg = t / 16, cg = t % 16: the scores (summed over
//   dk), the outputs (over the rows, then over dk) and the state update
//   (over the rows).
// * r, k, v, w take any element strides over batch, position and head;
//   the channel dim must be contiguous. w and u are float32, u with
//   strides over batch and head. The output is written through its own strides; the
//   final state is a contiguous (B, H, dk, dv) float32 tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 64;         // longest chunk: rows of a tile
constexpr int DMAX = 64;       // largest dk and dv
constexpr int PAD = DMAX + 1;  // row stride of the [row][channel] tiles
constexpr int PP = CH + 1;     // row stride of the score tile
constexpr int THREADS = 256;   // 16 x 16 register tiles
constexpr int NSEG = 4;        // cumsum segments per channel
constexpr int SEG = CH / NSEG;

// r, k, log w, r*u*k tiles; v; scores; state; segment sums; exp(c_L); u
constexpr int SMEM_FLOATS =
    4 * CH * PAD + CH * DMAX + CH * PP + DMAX * DMAX + NSEG * DMAX + 2 * DMAX;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  void* o;
  float* state;
  int64_t rsb, rss, rsh;
  int64_t ksb, kss, ksh;
  int64_t vsb, vss, vsh;
  int64_t wsb, wss, wsh;
  int64_t osb, oss, osh;
  int64_t usb, ush;
  int64_t heads, seq;
  int dk, dv, chunk;
};

template <typename T, typename O>
__global__ void __launch_bounds__(THREADS) rwkv6_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [CH][PAD]  r, then q~
  float* ks = qs + CH * PAD;      // [CH][PAD]  k, then k~
  float* lw = ks + CH * PAD;      // [CH][PAD]  log w
  float* ub = lw + CH * PAD;      // [CH][PAD]  r * u * k
  float* vs = ub + CH * PAD;      // [CH][DMAX]
  float* ps = vs + CH * DMAX;     // [CH][PP]   scores
  float* st = ps + CH * PP;       // [DMAX][DMAX] state
  float* segs = st + DMAX * DMAX; // [NSEG][DMAX]
  float* dl = segs + NSEG * DMAX; // [DMAX]     exp(c_L)
  float* us = dl + DMAX;          // [DMAX]     u

  const int t = threadIdx.x;
  const int rg = t >> 4;
  const int cg = t & 15;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / a.heads;
  const int64_t h = bh % a.heads;
  const int dk = a.dk, dv = a.dv, L = a.chunk;
  const int64_t seq = a.seq;

  const T* rp = (const T*)a.r + b * a.rsb + h * a.rsh;
  const T* kp = (const T*)a.k + b * a.ksb + h * a.ksh;
  const T* vp = (const T*)a.v + b * a.vsb + h * a.vsh;
  const float* wp = a.w + b * a.wsb + h * a.wsh;
  O* op = (O*)a.o + b * a.osb + h * a.osh;
  const float* up = a.u + b * a.usb + h * a.ush;

  for (int i = t; i < DMAX * DMAX; i += THREADS) st[i] = 0.0f;
  if (t < DMAX) us[t] = t < dk ? up[t] : 0.0f;

  for (int64_t c0 = 0; c0 < seq; c0 += L) {
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = t; idx < CH * DMAX; idx += THREADS) {
      const int i = idx / DMAX;
      const int d = idx % DMAX;
      const int64_t pos = c0 + i;
      const bool row = i < L && pos < seq;
      float rv = 0.0f, kv = 0.0f, lv = 0.0f, vv = 0.0f;
      if (row && d < dk) {
        rv = to_f(rp[pos * a.rss + d]);
        kv = to_f(kp[pos * a.kss + d]);
        lv = logf(wp[pos * a.wss + d]);
      }
      if (row && d < dv) vv = to_f(vp[pos * a.vss + d]);
      qs[i * PAD + d] = rv;
      ks[i * PAD + d] = kv;
      lw[i * PAD + d] = lv;
      ub[i * PAD + d] = rv * us[d] * kv;
      vs[i * DMAX + d] = vv;
    }
    __syncthreads();

    // cumsum of log w: 4 segments of 16 rows per channel
    const bool scanner = t < NSEG * dk;
    const int sd = scanner ? t % dk : 0;
    const int sg = scanner ? t / dk : 0;
    if (scanner) {
      float s = 0.0f;
      for (int i = sg * SEG; i < (sg + 1) * SEG; ++i) s += lw[i * PAD + sd];
      segs[sg * DMAX + sd] = s;
    }
    __syncthreads();
    if (scanner) {
      float c = 0.0f;
      for (int j = 0; j < sg; ++j) c += segs[j * DMAX + sd];
      for (int i = sg * SEG; i < (sg + 1) * SEG; ++i) {
        const float l = lw[i * PAD + sd];
        c += l;
        qs[i * PAD + sd] *= expf(c - l);
        ks[i * PAD + sd] *= expf(-c);
      }
      if (sg == NSEG - 1) dl[sd] = expf(c);
    }
    __syncthreads();

    // scores: strictly causal q~ k~^T, the bonus r . (u * k) on the diagonal
    {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = 0.0f;
      for (int d = 0; d < dk; ++d) {
        float qa[4], ka[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qs[(rg + 16 * i) * PAD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) ka[j] = ks[(cg + 16 * j) * PAD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[i][j] = fmaf(qa[i], ka[j], p[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = cg + 16 * j;
          float val = col < row ? p[i][j] : 0.0f;
          if (col == row) {
            val = 0.0f;
            for (int d = 0; d < dk; ++d) val += ub[row * PAD + d];
          }
          ps[row * PP + col] = val;
        }
      }
    }
    __syncthreads();

    // outputs P V + q~ S, and the state's new rows exp(c_L) (S + k~^T V)
    float o[4][4], sn[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = sn[i][j] = 0.0f;
    for (int s = 0; s < CH; ++s) {
      float pa[4], ka[4], va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = ps[(rg + 16 * i) * PP + s];
        ka[i] = ks[s * PAD + rg + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) va[j] = vs[s * DMAX + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[i][j] = fmaf(pa[i], va[j], o[i][j]);
          sn[i][j] = fmaf(ka[i], va[j], sn[i][j]);
        }
    }
    for (int d = 0; d < dk; ++d) {
      float qa[4], sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(rg + 16 * i) * PAD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) sa[j] = st[d * DMAX + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(qa[i], sa[j], o[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rg + 16 * i;
      const int64_t pos = c0 + row;
      if (row >= L || pos >= seq) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = cg + 16 * j;
        if (e < dv) store_f(op + pos * a.oss + e, o[i][j]);
      }
    }
    __syncthreads();  // every reader of the old state is done
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = rg + 16 * i;
      if (d >= dk) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = cg + 16 * j;
        if (e < dv) st[d * DMAX + e] = dl[d] * (st[d * DMAX + e] + sn[i][j]);
      }
    }
  }
  __syncthreads();
  float* sp = a.state + bh * dk * dv;
  for (int idx = t; idx < dk * dv; idx += THREADS)
    sp[idx] = st[(idx / dv) * DMAX + idx % dv];
}

template <typename T, typename O>
int launch(const Args& a, int64_t nbh, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv6_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  rwkv6_kernel<T, O><<<(unsigned)nbh, THREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_o(const Args& a, int64_t nbh, int out_dtype, cudaStream_t s) {
  if (out_dtype == 0) return launch<T, float>(a, nbh, s);
  if (out_dtype == 1) return launch<T, __nv_bfloat16>(a, nbh, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// r, k, w (B, S, H, dk) and v (B, S, H, dv) with element strides (batch,
// position, head) and a contiguous last dim, w float32; u (B, H, dk)
// float32 with strides (batch, head); o (B, S, H, dv) written through its strides;
// state a contiguous (B, H, dk, dv) float32. dk, dv in 1..64, chunk in
// 1..64. dtypes of r, k, v and of o: 0 float32, 1 bfloat16. Returns cudaGetLastError() after
// the launch.
int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                      const float* w, const float* u, void* o, float* state,
                      int64_t rsb, int64_t rss, int64_t rsh, int64_t ksb,
                      int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                      int64_t vsh, int64_t wsb, int64_t wss, int64_t wsh,
                      int64_t osb, int64_t oss, int64_t osh, int64_t usb,
                      int64_t ush, int64_t batch, int64_t heads,
                      int64_t seq, int dk, int dv, int chunk, int in_dtype,
                      int out_dtype, void* stream) {
  if (dk < 1 || dk > DMAX || dv < 1 || dv > DMAX || chunk < 1 ||
      chunk > CH || seq < 0)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || heads <= 0) return (int)cudaGetLastError();
  Args a{r,   k,   v,   w,   u,   o,   state, rsb, rss, rsh, ksb,
         kss, ksh, vsb, vss, vsh, wsb, wss,   wsh, osb, oss, osh,
         usb, ush, heads, seq, dk, dv, chunk};
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nbh = batch * heads;
  if (in_dtype == 0) return launch_o<float>(a, nbh, out_dtype, s);
  if (in_dtype == 1) return launch_o<__nv_bfloat16>(a, nbh, out_dtype, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
