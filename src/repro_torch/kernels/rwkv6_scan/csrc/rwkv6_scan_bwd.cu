// rwkv6_scan_bwd: the gradient of the chunked RWKV-6 scan (rwkv6_scan.cu).
//
// No Pallas kernel to replace: the reference differentiates its model's
// chunk math (src/repro/models/ssm.py:158-212, `rwkv6_apply`'s `step`)
// by automatic differentiation. Per chunk of L rows, with the
// forward's decays
//   c_t = sum_{s<=t} log w_s,  e_t = c_t - log w_t,  c_L the chunk's total,
//   q~ = r exp(e),  k~ = k exp(-c),  k^ = k exp(c_L - c) = k~ exp(c_L),
//   A  = strictly causal q~ k~^T with the bonus r_t.(u k_t) on the diagonal,
//   o  = A V + q~ S_c,     S_c+1 = diag(exp(c_L)) S_c + k^T V,
// and G_c the gradient of the chunk's end state S_c+1:
//   dA  = dO V^T (strictly causal; its diagonal is the bonus's gradient)
//   dq~ = dA k~ + dO S_c^T      dk~ = dA^T q~      dk^ = V G_c^T
//   dV  = A^T dO + k^ G_c
//   dr  = dq~ exp(e) + dbonus u k          dk = (dk~ + exp(c_L) dk^) exp(-c)
//                                               + dbonus u r
//   d(log w)_j = sum_{t>j} dq~_t q~_t
//                - sum_{s>=j} (dk~_s + exp(c_L) dk^_s) k~_s + dc_L,
//   dc_L = sum_s exp(c_L) dk^_s k~_s + exp(c_L) rowsum(G_c o S_c)
//   dw  = d(log w) / w,   du = sum_t dbonus_t r_t k_t
// and G_c-1 = diag(exp(c_L)) G_c + q~^T dO, from dState (or zeros).
//
// Three kernels on the caller's stream, in order:
//  1. `rwkv6_bwd_states_kernel`, the only serial part: the end-state
//     gradients G_c into a float32 workspace (B, H, n_chunks, dk, dv),
//     walking the chunks from the last. As the forward's first pass, one
//     block of 64 threads owns one (32, 32) tile of G (the decays are per
//     channel, so a tile needs only its channels of r and w and its columns
//     of dO), each thread a 4 x 4 piece in registers.
//  2. `rwkv6_bwd_chunk_kernel`: every chunk at once, one block of 256
//     threads per (batch * head, chunk). It loads the chunk's r, k, v, w,
//     dO, its start state S_c (the forward's workspace, kept by the
//     autograd function) and G_c into shared memory, forms the decays as
//     running products of w (as the forward does), A and dA, then the four
//     products above as 4 x 4 register tiles per thread (rows rg + 16 i,
//     columns cg + 16 j), writes dr, dk, dv, and finally one thread per
//     channel walks the rows backwards for d(log w) and sums du's terms.
//  3. `rwkv6_bwd_du_kernel`: du summed over the chunks, in chunk order
//     (no atomics: the result is the same on every run).
//
// What bounds it: at path M's shape (8, 512, 32, 64, 64), chunks of 64,
// the inputs (r, k, v in bfloat16, w and dO in float32, the 33.5 MB
// start states) and the outputs (dr, dk, dv, dw) move 235 MB, 0.070 ms
// at 3.35 TB/s; the products this chunking needs are 7.0 GFLOP in
// float32 on the CUDA cores (TF32 would break the reference's 1e-4),
// 0.104 ms at 67 TFLOP/s (4.7 GFLOP, 0.070 ms, at the cheapest chunk).
// The operands come from shared memory one float a read (row stride 65,
// so a column walk hits 32 banks), so the products are bound by
// shared-memory bandwidth, and the full 64 x 64 products skip nothing
// above the diagonal. 151 KB of shared memory a block: one block of 8
// warps per SM. A first kernel that is right; its speed is later work.
//
// r, k, v take any element strides over batch, position and head with a
// contiguous channel dim; w, dO float32 likewise; u (B, H, dk) float32
// with strides over batch and head. dState, when given, and both
// workspaces are contiguous float32; dr, dk, dv (in r's dtype), dw
// (float32) are contiguous (B, S, H, d); du contiguous (B, H, dk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 64;     // longest chunk
constexpr int DMAX = 64;   // largest dk and dv
constexpr int T1 = 32;     // pass 1's state tile
constexpr int NT1 = T1 * T1 / 16;
constexpr int NT2 = 256;   // pass 2's threads
constexpr int P = DMAX + 1;  // row stride of pass 2's tiles
constexpr int TILE = CH * P;
// R/q~ (then dq~ q~), K/k~ (then the k~ terms), V, D (then du's terms), W
// (then exp(e)), A (then the dc_L terms), dA, S_c, G_c; bonus, its
// gradient, exp(c_L), u
constexpr size_t SMEM2_BYTES = sizeof(float) * (9 * TILE + 2 * CH + 2 * DMAX);

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void stf(float* p, float x) { *p = x; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* dout;
  const float* dstate;  // null: zeros
  const float* ws;      // the forward's chunk-start states
  float* gws;           // the end-state gradients
  void* dr;
  void* dk;
  void* dv;
  float* dw;
  float* dupart;        // (B * H, n_chunks, dk)
  float* du;
  int64_t rsb, rss, rsh;
  int64_t ksb, kss, ksh;
  int64_t vsb, vss, vsh;
  int64_t wsb, wss, wsh;
  int64_t dsb, dss, dsh;
  int64_t usb, ush;
  int64_t heads, seq, nc;
  int ndk, ndv, chunk;
};

// Pass 1: G_c for every chunk, from the last; one block per (b * h, tile).
template <typename T>
__global__ void __launch_bounds__(NT1)
    rwkv6_bwd_states_kernel(Args a) {
  __shared__ float rs[CH * T1];  // r, then q~ = r exp(e)
  __shared__ float wt[CH * T1];  // w
  __shared__ float ds[CH * T1];  // dO
  __shared__ float dl[T1];       // exp(c_L)

  const int t = threadIdx.x;
  const int dk = a.ndk, dv = a.ndv, L = a.chunk;
  const int bk = min(dk, T1), bv = min(dv, T1);
  const int tiles_v = dv / bv;
  const int ntiles = (dk / bk) * tiles_v;
  const int64_t bh = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  const int i0 = (tile / tiles_v) * bk, j0 = (tile % tiles_v) * bv;
  const int64_t b = bh / a.heads, h = bh % a.heads;
  // this thread's rows si .. si + 3 and columns sj .. sj + 3 of the tile
  const int si = 4 * (t / (T1 / 4)), sj = 4 * (t % (T1 / 4));
  const bool own = si < bk && sj < bv;

  float g[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y)
      g[x][y] = own && a.dstate != nullptr
                    ? a.dstate[(bh * dk + i0 + si + x) * dv + j0 + sj + y]
                    : 0.0f;

  const T* rp = (const T*)a.r + b * a.rsb + h * a.rsh + i0;
  const float* wp = a.w + b * a.wsb + h * a.wsh + i0;
  const float* dp = a.dout + b * a.dsb + h * a.dsh + j0;
  for (int64_t c = a.nc - 1; c >= 0; --c) {
    if (own) {  // G_c, the gradient of the chunk's end state
      float* gp = a.gws + ((bh * a.nc + c) * dk + i0 + si) * dv + j0 + sj;
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) gp[x * dv + y] = g[x][y];
    }
    __syncthreads();  // the previous chunk's readers are done
    const int64_t c0 = c * L;
    // rows past the chunk are r = dO = 0, w = 1
    for (int idx = t; idx < CH * T1; idx += NT1) {
      const int row = idx / T1, col = idx % T1;
      const int64_t pos = c0 + row;
      const bool in = row < L && pos < a.seq;
      rs[idx] = in && col < bk ? ldf(rp + pos * a.rss + col) : 0.0f;
      wt[idx] = in && col < bk ? wp[pos * a.wss + col] : 1.0f;
      ds[idx] = in && col < bv ? dp[pos * a.dss + col] : 0.0f;
    }
    __syncthreads();
    if (t < bk) {  // q~_t = r_t prod_{s<t} w_s; exp(c_L) = prod w
      float before = 1.0f;
      for (int row = 0; row < L; ++row) {
        rs[row * T1 + t] *= before;
        before *= wt[row * T1 + t];
      }
      dl[t] = before;
    }
    __syncthreads();
    if (own) {  // G <- diag(exp(c_L)) G + q~^T dO
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float d = dl[si + x];
#pragma unroll
        for (int y = 0; y < 4; ++y) g[x][y] *= d;
      }
      for (int row = 0; row < L; ++row) {
        float q[4], o[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          q[x] = rs[row * T1 + si + x];
          o[x] = ds[row * T1 + sj + x];
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) g[x][y] = fmaf(q[x], o[y], g[x][y]);
      }
    }
  }
}

// Pass 2: every chunk's gradients; one block per (b * h, chunk).
template <typename T>
__global__ void __launch_bounds__(NT2, 1)
    rwkv6_bwd_chunk_kernel(Args a) {
  extern __shared__ float smem[];
  float* R = smem;          // r, then q~, then dq~ q~
  float* K = R + TILE;      // k, then k~, then -(dk~ + exp(c_L) dk^) k~
  float* V = K + TILE;      // v
  float* D = V + TILE;      // dO, then du's terms dbonus r k
  float* W = D + TILE;      // w, then exp(e)
  float* A = W + TILE;      // A, then exp(c_L) dk^ k~
  float* dA = A + TILE;     // dA
  float* S = dA + TILE;     // S_c  [dk][dv]
  float* G = S + TILE;      // G_c  [dk][dv]
  float* bon = G + TILE;    // [CH] r . (u k)
  float* dbon = bon + CH;   // [CH] dO . v
  float* ecl = dbon + CH;   // [DMAX] exp(c_L)
  float* us = ecl + DMAX;   // [DMAX] u

  const int t = threadIdx.x;
  const int rg = t >> 4, cg = t & 15;
  const int64_t bh = blockIdx.x / a.nc;
  const int64_t c = blockIdx.x % a.nc;
  const int64_t b = bh / a.heads, h = bh % a.heads;
  const int dk = a.ndk, dv = a.ndv, L = a.chunk;
  const int64_t c0 = c * L;

  const T* rp = (const T*)a.r + b * a.rsb + h * a.rsh;
  const T* kp = (const T*)a.k + b * a.ksb + h * a.ksh;
  const T* vp = (const T*)a.v + b * a.vsb + h * a.vsh;
  const float* wp = a.w + b * a.wsb + h * a.wsh;
  const float* dp = a.dout + b * a.dsb + h * a.dsh;
  const float* sp = a.ws + (bh * a.nc + c) * dk * dv;
  const float* gp = a.gws + (bh * a.nc + c) * dk * dv;

  // loads; rows past the chunk or the sequence are 0 (w = 1), and so are
  // the columns past dk or dv
  for (int idx = t; idx < CH * DMAX; idx += NT2) {
    const int row = idx / DMAX, col = idx % DMAX;
    const int at = row * P + col;
    const int64_t pos = c0 + row;
    const bool in = row < L && pos < a.seq;
    const bool ik = in && col < dk, iv = in && col < dv;
    R[at] = ik ? ldf(rp + pos * a.rss + col) : 0.0f;
    K[at] = ik ? ldf(kp + pos * a.kss + col) : 0.0f;
    W[at] = ik ? wp[pos * a.wss + col] : 1.0f;
    V[at] = iv ? ldf(vp + pos * a.vss + col) : 0.0f;
    D[at] = iv ? dp[pos * a.dss + col] : 0.0f;
    const bool is = row < dk && col < dv;
    S[at] = is ? sp[row * dv + col] : 0.0f;
    G[at] = is ? gp[row * dv + col] : 0.0f;
  }
  if (t < DMAX) us[t] = t < dk ? a.u[b * a.usb + h * a.ush + t] : 0.0f;
  __syncthreads();

  // the bonus and its gradient, one row a thread
  if (t < CH) {
    float x = 0.0f;
    for (int d = 0; d < dk; ++d)
      x = fmaf(R[t * P + d] * us[d], K[t * P + d], x);
    bon[t] = x;
  } else if (t < 2 * CH) {
    const int row = t - CH;
    float x = 0.0f;
    for (int e = 0; e < dv; ++e) x = fmaf(D[row * P + e], V[row * P + e], x);
    dbon[row] = x;
  }
  __syncthreads();

  // the decays as running products of w, one channel a thread:
  // exp(e_t) = prod_{s<t} w_s, q~ = r exp(e), k~ = k / prod_{s<=t} w_s
  if (t < dk) {
    float before = 1.0f;
    for (int row = 0; row < L; ++row) {
      const int at = row * P + t;
      const float wv = W[at];
      W[at] = before;
      R[at] *= before;
      before *= wv;
      K[at] *= __frcp_rn(before);
    }
    ecl[t] = before;
  }
  __syncthreads();

  // A (strictly causal q~ k~^T, the bonus on the diagonal) and dA
  // (strictly causal dO V^T)
  {
    float p[4][4], q[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = q[i][j] = 0.0f;
    for (int d = 0; d < dk; ++d) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = R[(rg + 16 * i) * P + d];
        y[i] = K[(cg + 16 * i) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = fmaf(x[i], y[j], p[i][j]);
    }
    for (int e = 0; e < dv; ++e) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = D[(rg + 16 * i) * P + e];
        y[i] = V[(cg + 16 * i) * P + e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) q[i][j] = fmaf(x[i], y[j], q[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cg + 16 * j;
        A[row * P + col] =
            col < row ? p[i][j] : (col == row ? bon[row] : 0.0f);
        dA[row * P + col] = col < row ? q[i][j] : 0.0f;
      }
    }
  }
  __syncthreads();

  // the products, rows rg + 16 i and columns cg + 16 j of each:
  // dq~ (t, d), dk~ (s, d), dk^ (s, d), dV (s, e)
  float dq[4][4], dkt[4][4], dkh[4][4], dvv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dq[i][j] = dkt[i][j] = dkh[i][j] = dvv[i][j] = 0.0f;
  for (int m = 0; m < L; ++m) {  // sums over the chunk's rows
    float xa[4], xt[4], at[4], yk[4], yq[4], yd[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xa[i] = dA[(rg + 16 * i) * P + m];   // dA[t][m]
      xt[i] = dA[m * P + rg + 16 * i];     // dA[m][s]
      at[i] = A[m * P + rg + 16 * i];      // A[m][s]
      yk[i] = K[m * P + cg + 16 * i];      // k~[m][d]
      yq[i] = R[m * P + cg + 16 * i];      // q~[m][d]
      yd[i] = D[m * P + cg + 16 * i];      // dO[m][e]
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dq[i][j] = fmaf(xa[i], yk[j], dq[i][j]);
        dkt[i][j] = fmaf(xt[i], yq[j], dkt[i][j]);
        dvv[i][j] = fmaf(at[i], yd[j], dvv[i][j]);
      }
  }
  for (int e = 0; e < dv; ++e) {  // sums over the value columns
    float xd[4], xv[4], ys[4], yg[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xd[i] = D[(rg + 16 * i) * P + e];    // dO[t][e]
      xv[i] = V[(rg + 16 * i) * P + e];    // v[s][e]
      ys[i] = S[(cg + 16 * i) * P + e];    // S[d][e]
      yg[i] = G[(cg + 16 * i) * P + e];    // G[d][e]
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dq[i][j] = fmaf(xd[i], ys[j], dq[i][j]);
        dkh[i][j] = fmaf(xv[i], yg[j], dkh[i][j]);
      }
  }
  for (int d = 0; d < dk; ++d) {  // k^ G = (k~ exp(c_L)) G
    const float l = ecl[d];
    float xk[4], yg[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xk[i] = K[(rg + 16 * i) * P + d] * l;  // k^[s][d]
      yg[i] = G[d * P + cg + 16 * i];        // G[d][e]
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dvv[i][j] = fmaf(xk[i], yg[j], dvv[i][j]);
  }

  // dr, dk and dV; the d(log w) and du terms kept for the walk below
  T* drp = (T*)a.dr;
  T* dkp = (T*)a.dk;
  T* dvp = (T*)a.dv;
  const int64_t hk = a.heads * dk, hv = a.heads * dv;
  float de[4][4], dc[4][4], dz[4][4], dut[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = rg + 16 * i;
    const int64_t pos = c0 + row;
    const bool in = row < L && pos < a.seq;
    const float db = dbon[row < CH ? row : 0];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = cg + 16 * j;
      de[i][j] = dc[i][j] = dz[i][j] = dut[i][j] = 0.0f;
      if (in && col < dv)
        stf(dvp + (b * a.seq + pos) * hv + h * dv + col, dvv[i][j]);
      if (!(in && col < dk)) continue;
      const int at = row * P + col;
      const float eb = W[at];
      const float rv = ldf(rp + pos * a.rss + col);
      const float kv = ldf(kp + pos * a.kss + col);
      const float wv = wp[pos * a.wss + col];
      const float ec = __frcp_rn(eb * wv);  // exp(-c_t)
      const float tot = dkt[i][j] + ecl[col] * dkh[i][j];
      const int64_t o = (b * a.seq + pos) * hk + h * dk + col;
      stf(drp + o, fmaf(dq[i][j], eb, db * us[col] * kv));
      stf(dkp + o, fmaf(tot, ec, db * us[col] * rv));
      de[i][j] = dq[i][j] * R[at];
      dc[i][j] = -tot * K[at];
      dz[i][j] = ecl[col] * dkh[i][j] * K[at];
      dut[i][j] = db * rv * kv;
    }
  }
  __syncthreads();  // every product has read R, K, A and D
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int at = (rg + 16 * i) * P + cg + 16 * j;
      R[at] = de[i][j];
      K[at] = dc[i][j];
      A[at] = dz[i][j];
      D[at] = dut[i][j];
    }
  __syncthreads();

  // d(log w)_j = sum_{t>j} de_t + sum_{s>=j} dc_s + dc_L, one channel a
  // thread, rows walked from the last; du's terms summed over the chunk
  if (t < dk) {
    float gs = 0.0f;
    for (int e = 0; e < dv; ++e) gs = fmaf(G[t * P + e], S[t * P + e], gs);
    float zs = 0.0f, us_ = 0.0f;
    for (int row = 0; row < L; ++row) {
      zs += A[row * P + t];
      us_ += D[row * P + t];
    }
    const float dcl = fmaf(ecl[t], gs, zs);
    float after_de = 0.0f, from_dc = 0.0f;
    for (int row = L - 1; row >= 0; --row) {
      const int64_t pos = c0 + row;
      from_dc += K[row * P + t];
      const float dl = after_de + from_dc + dcl;
      after_de += R[row * P + t];
      if (pos < a.seq)
        a.dw[(b * a.seq + pos) * hk + h * dk + t] =
            dl / wp[pos * a.wss + t];
    }
    a.dupart[(bh * a.nc + c) * dk + t] = us_;
  }
}

// Pass 3: du, the chunks' terms summed in chunk order.
__global__ void rwkv6_bwd_du_kernel(Args a) {
  const int64_t bh = blockIdx.x;
  const int t = threadIdx.x;
  if (t >= a.ndk) return;
  float x = 0.0f;
  for (int64_t c = 0; c < a.nc; ++c)
    x += a.dupart[(bh * a.nc + c) * a.ndk + t];
  a.du[bh * a.ndk + t] = x;
}

template <typename T>
int run(const Args& a, int64_t nbh, cudaStream_t stream) {
  const int ntiles = (a.ndk / min(a.ndk, T1)) * (a.ndv / min(a.ndv, T1));
  rwkv6_bwd_states_kernel<T><<<(unsigned)(nbh * ntiles), NT1, 0, stream>>>(a);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_bwd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM2_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  if (a.nc > 0)
    rwkv6_bwd_chunk_kernel<T>
        <<<(unsigned)(nbh * a.nc), NT2, SMEM2_BYTES, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  rwkv6_bwd_du_kernel<<<(unsigned)nbh, DMAX, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The backward's three passes in order on one stream: the end-state
// gradients into gws, the chunks' dr, dk, dv, dw and du terms (from ws
// and gws), then du. r, k, v (B, S, H, dk | dv) in `dtype` (0 float32,
// 1 bfloat16) and w, dout float32, each with element strides (batch, position, head)
// and a contiguous last dim; u (B, H, dk) float32 with strides (batch,
// head); dstate a contiguous (B, H, dk, dv) float32 or null (zeros); ws and
// gws contiguous (B, H, ceil(S / chunk), dk, dv) float32; dr, dk, dv
// contiguous in `dtype`, dw contiguous float32, dupart (B, H, n_chunks, dk)
// and du (B, H, dk) float32. dk, dv in 8, 16, 32, 64; chunk in 1..64.
// Returns cudaGetLastError() after its launches.
int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* dout, const float* dstate, const float* ws,
    float* gws, void* dr, void* dk, void* dv, float* dw, float* dupart,
    float* du, int64_t rsb, int64_t rss, int64_t rsh, int64_t ksb,
    int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
    int64_t wsb, int64_t wss, int64_t wsh, int64_t dsb, int64_t dss,
    int64_t dsh, int64_t usb, int64_t ush, int64_t batch, int64_t heads,
    int64_t seq, int ndk, int ndv, int chunk, int dtype, void* stream) {
  const bool dim_ok = (ndk == 8 || ndk == 16 || ndk == 32 || ndk == 64) &&
                      (ndv == 8 || ndv == 16 || ndv == 32 || ndv == 64);
  if (!dim_ok || chunk < 1 || chunk > CH || seq < 0)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || heads <= 0) return (int)cudaGetLastError();
  const int64_t nc = (seq + chunk - 1) / chunk;
  Args a{r,   k,   v,   w,   u,   dout, dstate, ws,  gws, dr,  dk,
         dv,  dw,  dupart, du, rsb, rss, rsh,   ksb, kss, ksh, vsb,
         vss, vsh, wsb, wss, wsh, dsb,  dss,    dsh, usb, ush, heads,
         seq, nc,  ndk, ndv, chunk};
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nbh = batch * heads;
  if (dtype == 0) return run<float>(a, nbh, s);
  if (dtype == 1) return run<__nv_bfloat16>(a, nbh, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
