// rwkv6_scan: the chunked RWKV-6 (Finch) gated linear recurrence, in two
// passes.
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6_scan/kernel.py
// (`rwkv6_scan_kernel`, body `_rwkv6_kernel`). There the grid is
// (batch * heads, seq / chunk) with the chunk axis sequential, carrying the
// (dk, dv) state in VMEM scratch from one chunk to the next. Here the
// carry is split off: `rwkv6_scan_launch` puts two kernels on the caller's
// stream, in order, with a float32 workspace (B, H, n_chunks, dk, dv)
// between them.
//
// Per chunk of L rows (what the Pallas body computes, in float32):
//   c_t   = sum_{s<=t} log w_s                 per channel, inclusive
//   q~_t  = r_t * exp(c_t - log w_t)           decay since the chunk start
//   k~_s  = k_s * exp(-c_s)                    inverse decay to the start
//   P     = q~ k~^T, strictly causal, with r_t . (u * k_t) on the diagonal
//   o     = P V + q~ S_c                       S_c: the state at the start
//   S_c+1 = exp(c_L) S_c + (k * exp(c_L - c_s))^T V      per row of S
//
// Both passes form the decays as running products of w (exp(c_t) is the
// product of w_s over s <= t), with no log or exp, each segment of rows
// walked as two independent halves to halve the chain; both keep the v
// tile in its input type (bfloat16 is exact and half the bytes).
//
// Pass 1, `rwkv6_states_kernel`: the only serial part, the chain of chunk
// states. The update of a (BK, BV) tile of S needs only the tile's BK
// channels of k and w and its BV columns of v (the decays are per
// channel), so one block of 64 threads owns one tile (BK = min(dk, TILE),
// BV = min(dv, TILE), TILE = 32) and walks the chunks without waiting on
// any other block: 512 blocks at the serving shape (B * H = 128, 64 x 64
// state), the tiles of one head at neighbouring block indices so that they
// share k, w and v in L2. Each thread keeps a 4 x 4 piece of the tile in
// registers. Before each chunk the block writes its tile of S_c to the
// workspace, after the last one the final state, which the decode cache
// starts from. The next chunk's k, w and v are loaded, 16 bytes a load,
// into registers while the current chunk's update runs.
//
// Pass 2, `rwkv6_output_kernel`: every chunk at once, one block of 256
// threads per (batch * head, chunk), 2048 blocks at the serving shape.
// Each loads its chunk's r, k, w and v, 16 bytes a load, forms q~, k~ and
// the scores, then P V, then q~ S_c with S_c loaded over k~, and writes o
// through o's strides. Thread t is the 4 x 4 register tile of every 64 x
// 64 product, rows rg + 16 i, rg = t / 16, and columns cg + 16 j (scores)
// or 4 cg + j (outputs), cg = t % 16; 4 x 4 blocks above the diagonal are
// skipped. Operands are read four at a time as float4 from tiles whose row
// stride of 68 floats keeps 16 rows in two wavefronts. The diagonal bonus
// is a warp reduction at load time. 68.3 KiB of shared memory a block, so
// three blocks fit on an SM.
//
// What bounds it: at the serving shape the ~120 MB of inputs and outputs
// take ~0.036 ms at 3.35 TB/s. Chunks of 64 do ~3.2 GFLOP in pass 2
// (0.048 ms at the float32 rate) and ~1.1 GFLOP in pass 1, all float32 on
// the CUDA cores (TF32 would break the reference's 1e-4); the two passes
// move ~254 MB (0.076 ms), with k, w and v read twice and the 33.5 MB
// workspace written and read once. The 4 x 4 register tiles read two
// bytes of shared memory per FMA, and the H100 delivers 128 bytes a cycle
// to an SM's 128 FMA lanes, so the products are bound by shared-memory
// bandwidth before the FMA rate; larger tiles leave too few warps.
//
// r, k, v, w take any element strides over batch, position and head that
// keep each row's 16-byte loads aligned; the channel dim must be
// contiguous. w and u are float32, u with strides over batch and head. The
// final state is a contiguous (B, H, dk, dv) float32 tensor, the workspace
// a contiguous (B, H, n_chunks, dk, dv) one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The bit of the calling thread's current device (devices 0-63). A
// kernel's shared-memory attribute holds on the device it was set on, so
// the launcher sets it once a device, recording the devices in a mask.
inline unsigned long long device_bit() {
  int dev = 0;
  cudaGetDevice(&dev);
  return 1ull << (dev & 63);
}

}  // namespace

namespace {

constexpr int CH = 64;    // longest chunk: rows of a tile
constexpr int DMAX = 64;  // largest dk and dv

// pass 1: a state tile of at most T1 x T1, T1 * T1 / 16 threads, each a
// 4 x 4 piece of it
constexpr int T1 = 32;
constexpr int NT1 = T1 * T1 / 16;
constexpr int NSEG1 = NT1 / T1;       // decay segments per channel
constexpr int SEG1 = CH / NSEG1;

// pass 2
constexpr int NT2 = 256;
constexpr int P2 = DMAX + 4;          // row stride of the float4-read tiles
constexpr int NSEG2 = 4;              // decay segments per channel
constexpr int SEG2 = CH / NSEG2;
// r/q~; k/k~, then S_c; w, then the scores; v; bonus; segment products
constexpr int SMEM2_FLOATS = 3 * CH * P2 + CH * DMAX + CH + NSEG2 * DMAX;
// 68.3 KiB (the v tile counted as float32; bfloat16 v leaves 8 KiB unused)
constexpr size_t SMEM2_BYTES = sizeof(float) * SMEM2_FLOATS;
constexpr int BLOCKS2 = 3;            // pass 2's blocks per SM

// 16 bytes of r, k or v: 4 float32 or 8 bfloat16 values
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};
__device__ __forceinline__ uint4 ld16(const void* p) {
  return *(const uint4*)p;
}
__device__ __forceinline__ void unpack(uint4 x, float* f, float) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack(uint4 x, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// four values of a tile kept in the inputs' own type, as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *(const float4*)p;
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 x = *(const uint2*)p;
  return make_float4(__uint_as_float(x.x << 16),
                     __uint_as_float(x.x & 0xffff0000u),
                     __uint_as_float(x.y << 16),
                     __uint_as_float(x.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *(float4*)p = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *(uint32_t*)&lo;
  x.y = *(uint32_t*)&hi;
  *(uint2*)p = x;
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  void* o;
  float* state;
  float* ws;
  int64_t rsb, rss, rsh;
  int64_t ksb, kss, ksh;
  int64_t vsb, vss, vsh;
  int64_t wsb, wss, wsh;
  int64_t osb, oss, osh;
  int64_t usb, ush;
  int64_t heads, seq, nc;
  int dk, dv, chunk;
};

template <typename T>
__global__ void __launch_bounds__(NT1, 256 / NT1)
    rwkv6_states_kernel(Args a) {
  __shared__ __align__(16) float ks[CH * T1];  // k, then k exp(c_L - c_s)
  __shared__ __align__(16) float ws[CH * T1];  // w
  __shared__ __align__(16) T vs[CH * T1];    // v as loaded: exact
  __shared__ float tot[NSEG1 * T1];            // segment products of w
  __shared__ float dl[T1];                     // exp(c_L)

  const int t = threadIdx.x;
  const int dk = a.dk, dv = a.dv, L = a.chunk;
  const int bk = min(dk, T1), bv = min(dv, T1);
  const int tiles_v = dv / bv;
  const int ntiles = (dk / bk) * tiles_v;
  const int64_t bh = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  const int i0 = (tile / tiles_v) * bk, j0 = (tile % tiles_v) * bv;
  const int64_t b = bh / a.heads, h = bh % a.heads;
  float* wsp = a.ws + bh * a.nc * dk * dv;

  // this thread's rows si .. si + 3 and columns sj .. sj + 3 of the tile
  const int si = 4 * (t / (T1 / 4)), sj = 4 * (t % (T1 / 4));
  const bool own = si < bk && sj < bv;
  float s[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) s[x][y] = 0.0f;

  // a chunk's k, w, v tiles in registers, 16 bytes a load: k and v rows
  // are T1 / VK loads wide, w rows T1 / 4; rows past the chunk or the
  // sequence are k = v = 0, w = 1, the identity step
  constexpr int VK = Vec<T>::N;
  constexpr int KL = T1 / VK, KR = NT1 / KL, NK = CH / KR;  // lanes, rows
  constexpr int WL = T1 / 4, WR = NT1 / WL, NW = CH / WR;   // per load
  const int kc = (t % KL) * VK, kr0 = t / KL;
  const int wc = (t % WL) * 4, wr0 = t / WL;
  const T* kp = (const T*)a.k + b * a.ksb + h * a.ksh + i0 + kc;
  const T* vp = (const T*)a.v + b * a.vsb + h * a.vsh + j0 + kc;
  const float* wp = a.w + b * a.wsb + h * a.wsh + i0 + wc;
  uint4 kr[NK], vr[NK];
  float4 wr[NW];
  auto fetch = [&](int64_t c0) {
#pragma unroll
    for (int q = 0; q < NK; ++q) {
      const int row = kr0 + q * KR;
      const int64_t pos = c0 + row;
      const bool in = row < L && pos < a.seq;
      const uint4 zero = make_uint4(0, 0, 0, 0);
      kr[q] = in && kc < bk ? ld16(kp + pos * a.kss) : zero;
      vr[q] = in && kc < bv ? ld16(vp + pos * a.vss) : zero;
    }
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      const int row = wr0 + q * WR;
      const int64_t pos = c0 + row;
      wr[q] = row < L && pos < a.seq && wc < bk
                  ? *(const float4*)(wp + pos * a.wss)
                  : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    }
  };
  fetch(0);

  const int ci = t % T1, g = t / T1;  // decays: channel, segment of rows
  for (int64_t c = 0; c < a.nc; ++c) {
    if (own) {  // S_c, the state at the chunk's start
#pragma unroll
      for (int x = 0; x < 4; ++x)
        *(float4*)(wsp + (c * dk + i0 + si + x) * dv + j0 + sj) =
            make_float4(s[x][0], s[x][1], s[x][2], s[x][3]);
    }
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int q = 0; q < NK; ++q) {
      const int at = (kr0 + q * KR) * T1 + kc;
      float f[VK];
      unpack(kr[q], f, T());
#pragma unroll
      for (int x = 0; x < VK; x += 4) store4(ks + at + x, f + x);
      *(uint4*)(vs + at) = vr[q];
    }
#pragma unroll
    for (int q = 0; q < NW; ++q)
      *(float4*)(ws + (wr0 + q * WR) * T1 + wc) = wr[q];
    if (c + 1 < a.nc) fetch((c + 1) * L);
    __syncthreads();

    // exp(c_L - c_s) is the product of w after row s: segment products,
    // then each segment walks its rows from the last, its two halves as
    // two independent chains
    constexpr int HALF1 = SEG1 / 2;
    const float* wseg = ws + g * SEG1 * T1 + ci;
    float lo = 1.0f, hi = 1.0f;
#pragma unroll
    for (int x = 0; x < HALF1; ++x) {
      lo *= wseg[x * T1];
      hi *= wseg[(HALF1 + x) * T1];
    }
    tot[g * T1 + ci] = lo * hi;
    __syncthreads();
    float after = 1.0f, total = 1.0f;
#pragma unroll
    for (int x = 0; x < NSEG1; ++x) {
      const float seg = tot[x * T1 + ci];
      total *= seg;
      if (x > g) after *= seg;
    }
    float* kseg = ks + g * SEG1 * T1 + ci;
    float after_lo = after * hi;
#pragma unroll
    for (int x = HALF1 - 1; x >= 0; --x) {
      const int at_lo = x * T1, at_hi = (HALF1 + x) * T1;
      kseg[at_hi] *= after;
      kseg[at_lo] *= after_lo;
      after *= wseg[at_hi];
      after_lo *= wseg[at_lo];
    }
    if (g == 0) dl[ci] = total;
    __syncthreads();

    if (own) {  // S <- diag(exp(c_L)) S + sum_s ks[s]^T v[s]
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float d = dl[si + x];
#pragma unroll
        for (int y = 0; y < 4; ++y) s[x][y] *= d;
      }
#pragma unroll 8
      for (int row = 0; row < L; ++row) {
        const float4 ka = *(const float4*)&ks[row * T1 + si];
        const float4 va = load4(vs + row * T1 + sj);
        const float kx[4] = {ka.x, ka.y, ka.z, ka.w};
        const float vy[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) s[x][y] = fmaf(kx[x], vy[y], s[x][y]);
      }
    }
  }
  if (own) {
    float* sp = a.state + bh * dk * dv;
#pragma unroll
    for (int x = 0; x < 4; ++x)
      *(float4*)(sp + (i0 + si + x) * dv + j0 + sj) =
          make_float4(s[x][0], s[x][1], s[x][2], s[x][3]);
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(NT2, BLOCKS2)
    rwkv6_output_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [CH][P2]   r, then q~
  float* ks = qs + CH * P2;       // [CH][P2]   k, then k~
  float* st = ks;                 // [DMAX][DMAX] S_c, once the scores are in
  float* ps = ks + CH * P2;       // [CH][P2]   w, then the scores
  T* vs = (T*)(ps + CH * P2);     // [CH][DMAX] v as loaded: exact
  float* bon = (float*)(vs + CH * DMAX);  // [CH] r . (u * k)
  float* segs = bon + CH;         // [NSEG2][DMAX]

  const int t = threadIdx.x;
  const int rg = t >> 4;
  const int cg = t & 15;
  const int64_t bh = blockIdx.x / a.nc;
  const int64_t c = blockIdx.x % a.nc;
  const int64_t b = bh / a.heads;
  const int64_t h = bh % a.heads;
  const int dk = a.dk, dv = a.dv, L = a.chunk;
  const int64_t c0 = c * L;

  // the chunk's loads at once, 16 bytes each: r, k, v rows of VT values a
  // load, w rows of 4; rows past the chunk or the sequence are r = k = v =
  // 0, w = 1
  constexpr int VT = Vec<T>::N;
  constexpr int TL = DMAX / VT, TR = NT2 / TL, NR = CH / TR;  // lanes, rows
  constexpr int FL = DMAX / 4, FR = NT2 / FL, NF = CH / FR;   // per load
  const int tc = (t % TL) * VT, tr0 = t / TL;
  const int fc = (t % FL) * 4, fr0 = t / FL;
  const T* rp = (const T*)a.r + b * a.rsb + h * a.rsh + tc;
  const T* kp = (const T*)a.k + b * a.ksb + h * a.ksh + tc;
  const T* vp = (const T*)a.v + b * a.vsb + h * a.vsh + tc;
  const float* wp = a.w + b * a.wsb + h * a.wsh + fc;
  uint4 rr[NR], kr[NR], vr[NR];
  float4 wr[NF];
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    const int i = tr0 + q * TR;
    const int64_t pos = c0 + i;
    const bool row = i < L && pos < a.seq;
    rr[q] = row && tc < dk ? ld16(rp + pos * a.rss) : zero;
    kr[q] = row && tc < dk ? ld16(kp + pos * a.kss) : zero;
    vr[q] = row && tc < dv ? ld16(vp + pos * a.vss) : zero;
  }
#pragma unroll
  for (int q = 0; q < NF; ++q) {
    const int i = fr0 + q * FR;
    const int64_t pos = c0 + i;
    wr[q] = i < L && pos < a.seq && fc < dk
                ? *(const float4*)(wp + pos * a.wss)
                : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  }
  float uf[VT];
  const float* up = a.u + b * a.usb + h * a.ush + tc;
#pragma unroll
  for (int x = 0; x < VT; ++x) uf[x] = tc + x < dk ? up[x] : 0.0f;
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    const int i = tr0 + q * TR;
    float rf[VT], kf[VT];
    unpack(rr[q], rf, T());
    unpack(kr[q], kf, T());
    *(uint4*)(vs + i * DMAX + tc) = vr[q];
    float bv = 0.0f;  // r . (u * k) over this load's channels
#pragma unroll
    for (int x = 0; x < VT; ++x) bv = fmaf(rf[x] * uf[x], kf[x], bv);
#pragma unroll
    for (int x = 0; x < VT; x += 4) {
      store4(qs + i * P2 + tc + x, rf + x);
      store4(ks + i * P2 + tc + x, kf + x);
    }
    // the row's TL lanes are neighbours in the warp: their sum is the bonus
#pragma unroll
    for (int off = TL / 2; off > 0; off >>= 1)
      bv += __shfl_xor_sync(0xffffffffu, bv, off);
    if (t % TL == 0) bon[i] = bv;
  }
#pragma unroll
  for (int q = 0; q < NF; ++q)
    *(float4*)(ps + (fr0 + q * FR) * P2 + fc) = wr[q];
  __syncthreads();

  // the decays as products of w: 4 segments of 16 rows per channel, each
  // walked as two independent halves, then q~_t = r_t prod_{s<t} w_s and
  // k~_t = k_t / prod_{s<=t} w_s
  constexpr int HALF2 = SEG2 / 2;
  const bool scanner = t < NSEG2 * dk;
  const int sd = scanner ? t % dk : 0;
  const int sg = scanner ? t / dk : 0;
  const int at0 = sg * SEG2 * P2 + sd;
  float lo = 1.0f, hi = 1.0f;
  if (scanner) {
#pragma unroll
    for (int x = 0; x < HALF2; ++x) {
      lo *= ps[at0 + x * P2];
      hi *= ps[at0 + (HALF2 + x) * P2];
    }
    segs[sg * DMAX + sd] = lo * hi;
  }
  __syncthreads();
  if (scanner) {
    float before = 1.0f;
    for (int j = 0; j < sg; ++j) before *= segs[j * DMAX + sd];
    float before_hi = before * lo;
#pragma unroll
    for (int x = 0; x < HALF2; ++x) {
      const int at_lo = at0 + x * P2, at_hi = at0 + (HALF2 + x) * P2;
      qs[at_lo] *= before;
      qs[at_hi] *= before_hi;
      before *= ps[at_lo];
      before_hi *= ps[at_hi];
      ks[at_lo] *= __frcp_rn(before);
      ks[at_hi] *= __frcp_rn(before_hi);
    }
  }
  __syncthreads();

  const int lr = (L + 3) & ~3;  // rows read: the chunk, zero-padded to 4

  // scores: strictly causal q~ k~^T, the bonus on the diagonal; a 4 x 4
  // block with j > i lies wholly above the diagonal
  {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < dk; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *(const float4*)&qs[(rg + 16 * i) * P2 + d];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *(const float4*)&ks[(cg + 16 * j) * P2 + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j)
          p[i][j] = fmaf(qa[i].x, ka[j].x,
                         fmaf(qa[i].y, ka[j].y,
                              fmaf(qa[i].z, ka[j].z,
                                   fmaf(qa[i].w, ka[j].w, p[i][j]))));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cg + 16 * j;
        float val = col < row ? p[i][j] : 0.0f;
        if (col == row) val = bon[row];
        ps[row * P2 + col] = val;
      }
    }
  }
  __syncthreads();

  // S_c, loaded while P V runs and stored over k~ after it
  const float* sc = a.ws + (bh * a.nc + c) * dk * dv + fc;
  float4 sr[NF];
#pragma unroll
  for (int q = 0; q < NF; ++q) {
    const int i = fr0 + q * FR;
    sr[q] = i < dk && fc < dv ? *(const float4*)(sc + i * dv)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  // outputs P V + q~ S_c: rows rg + 16 i, columns 4 cg + j
  float o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.0f;
  // P[t][s] = 0 for s > t: columns 16 sb .. 16 sb + 15 reach rows
  // rg + 16 i only for i >= sb
#pragma unroll
  for (int sb = 0; sb < 4; ++sb) {
#pragma unroll
    for (int s = 16 * sb; s < 16 * sb + 16; s += 4) {
      if (s >= lr) break;
      float4 pa[4];
#pragma unroll
      for (int i = sb; i < 4; ++i)
        pa[i] = *(const float4*)&ps[(rg + 16 * i) * P2 + s];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 va = load4(vs + (s + x) * DMAX + 4 * cg);
#pragma unroll
        for (int i = sb; i < 4; ++i) {
          const float pv = x == 0 ? pa[i].x
                           : x == 1 ? pa[i].y
                           : x == 2 ? pa[i].z
                                    : pa[i].w;
          o[i][0] = fmaf(pv, va.x, o[i][0]);
          o[i][1] = fmaf(pv, va.y, o[i][1]);
          o[i][2] = fmaf(pv, va.z, o[i][2]);
          o[i][3] = fmaf(pv, va.w, o[i][3]);
        }
      }
    }
  }
  // q~ S_c over the start state, stored over k~
#pragma unroll
  for (int q = 0; q < NF; ++q)
    *(float4*)(st + (fr0 + q * FR) * DMAX + fc) = sr[q];
  __syncthreads();
#pragma unroll 4
  for (int d = 0; d < dk; d += 4) {
    float4 qa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qa[i] = *(const float4*)&qs[(rg + 16 * i) * P2 + d];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float4 sa = *(const float4*)&st[(d + x) * DMAX + 4 * cg];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = x == 0 ? qa[i].x
                         : x == 1 ? qa[i].y
                         : x == 2 ? qa[i].z
                                  : qa[i].w;
        o[i][0] = fmaf(qv, sa.x, o[i][0]);
        o[i][1] = fmaf(qv, sa.y, o[i][1]);
        o[i][2] = fmaf(qv, sa.z, o[i][2]);
        o[i][3] = fmaf(qv, sa.w, o[i][3]);
      }
    }
  }
  O* op = (O*)a.o + b * a.osb + h * a.osh + 4 * cg;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = rg + 16 * i;
    const int64_t pos = c0 + row;
    if (row < L && pos < a.seq && 4 * cg < dv)
      store4(op + pos * a.oss, o[i]);
  }
}

template <typename T>
int launch_states(const Args& a, int64_t nbh, cudaStream_t stream) {
  const int ntiles = (a.dk / min(a.dk, T1)) * (a.dv / min(a.dv, T1));
  rwkv6_states_kernel<T><<<(unsigned)(nbh * ntiles), NT1, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int launch_output(const Args& a, int64_t nbh, cudaStream_t stream) {
  static unsigned long long configured = 0;  // one bit a device
  const unsigned long long dev_bit = device_bit();
  if (!(configured & dev_bit)) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv6_output_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM2_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured |= dev_bit;
  }
  if (a.nc == 0) return (int)cudaGetLastError();
  rwkv6_output_kernel<T, O>
      <<<(unsigned)(nbh * a.nc), NT2, SMEM2_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

// Pass 1 if `states`, then pass 2 if `output`, on one stream.
template <typename T, typename O>
int run(const Args& a, int64_t nbh, bool states, bool output,
        cudaStream_t stream) {
  if (states) {
    const int err = launch_states<T>(a, nbh, stream);
    if (err != 0) return err;
  }
  return output ? launch_output<T, O>(a, nbh, stream)
                : (int)cudaGetLastError();
}

template <typename T>
int run_o(const Args& a, int64_t nbh, int out_dtype, bool states,
          bool output, cudaStream_t s) {
  if (out_dtype == 0) return run<T, float>(a, nbh, states, output, s);
  if (out_dtype == 1) return run<T, __nv_bfloat16>(a, nbh, states, output, s);
  return (int)cudaErrorInvalidValue;
}

int dispatch(const void* r, const void* k, const void* v, const float* w,
             const float* u, void* o, float* state, float* ws, int64_t rsb,
             int64_t rss, int64_t rsh, int64_t ksb, int64_t kss, int64_t ksh,
             int64_t vsb, int64_t vss, int64_t vsh, int64_t wsb, int64_t wss,
             int64_t wsh, int64_t osb, int64_t oss, int64_t osh, int64_t usb,
             int64_t ush, int64_t batch, int64_t heads, int64_t seq, int dk,
             int dv, int chunk, int in_dtype, int out_dtype, void* stream,
             bool states, bool output) {
  const bool dim_ok = (dk == 8 || dk == 16 || dk == 32 || dk == 64) &&
                      (dv == 8 || dv == 16 || dv == 32 || dv == 64);
  if (!dim_ok || chunk < 1 || chunk > CH || seq < 0)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || heads <= 0) return (int)cudaGetLastError();
  const int64_t nc = (seq + chunk - 1) / chunk;
  Args a{r,   k,   v,   w,   u,   o,   state, ws,    rsb, rss, rsh, ksb,
         kss, ksh, vsb, vss, vsh, wsb, wss,   wsh,   osb, oss, osh, usb,
         ush, heads, seq, nc, dk, dv, chunk};
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t nbh = batch * heads;
  if (in_dtype == 0)
    return run_o<float>(a, nbh, out_dtype, states, output, s);
  if (in_dtype == 1)
    return run_o<__nv_bfloat16>(a, nbh, out_dtype, states, output, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The three entry points take one argument list: r, k, w (B, S, H, dk) and
// v (B, S, H, dv) with element strides (batch, position, head) and a
// contiguous last dim, w float32; u (B, H, dk) float32 with strides (batch,
// head); o (B, S, H, dv) written through its strides; state a contiguous
// (B, H, dk, dv) float32; ws a contiguous (B, H, ceil(S / chunk), dk, dv)
// float32 workspace. dk, dv in 8, 16, 32, 64; chunk in 1..64. dtypes of r,
// k, v and of o: 0 float32, 1 bfloat16. Each returns cudaGetLastError()
// after its launches.
#define RWKV6_PARAMS                                                        \
  const void *r, const void *k, const void *v, const float *w,              \
      const float *u, void *o, float *state, float *ws, int64_t rsb,        \
      int64_t rss, int64_t rsh, int64_t ksb, int64_t kss, int64_t ksh,      \
      int64_t vsb, int64_t vss, int64_t vsh, int64_t wsb, int64_t wss,      \
      int64_t wsh, int64_t osb, int64_t oss, int64_t osh, int64_t usb,      \
      int64_t ush, int64_t batch, int64_t heads, int64_t seq, int dk,       \
      int dv, int chunk, int in_dtype, int out_dtype, void *stream
#define RWKV6_ARGS                                                          \
  r, k, v, w, u, o, state, ws, rsb, rss, rsh, ksb, kss, ksh, vsb, vss, vsh, \
      wsb, wss, wsh, osb, oss, osh, usb, ush, batch, heads, seq, dk, dv,    \
      chunk, in_dtype, out_dtype, stream

extern "C" {

// Both passes: the chunk-start states into ws and the final state, then o.
int rwkv6_scan_launch(RWKV6_PARAMS) {
  return dispatch(RWKV6_ARGS, true, true);
}

// Pass 1 alone (o, r and u unused).
int rwkv6_states_launch(RWKV6_PARAMS) {
  return dispatch(RWKV6_ARGS, true, false);
}

// Pass 2 alone, from the states already in ws (state unused).
int rwkv6_output_launch(RWKV6_PARAMS) {
  return dispatch(RWKV6_ARGS, false, true);
}

}  // extern "C"
