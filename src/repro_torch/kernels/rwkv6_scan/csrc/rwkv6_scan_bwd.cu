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
//     walking the chunks from the last. It has the forward's first pass's
//     structure: one block of 64 threads owns one (32, 32) tile of G (the
//     decays are per channel, so a tile needs only its channels of r and w
//     and its columns of dO), each thread a 4 x 4 piece in registers; the
//     next chunk's r, w and dO are loaded, 16 bytes a load, into registers
//     while the current update runs; the decays are two segments of 32
//     rows per channel, each walked as two independent halves.
//  2. `rwkv6_bwd_chunk_kernel`: every chunk at once, one block of 8 warps
//     per (batch * head, chunk). Its eight products (A, dA, dA k~, dO S_c^T,
//     dA^T q~, V G_c^T, A^T dO, k^ G_c) run on the tensor cores as
//     `mma.sync.m16n8k8` in TF32 with the 3xTF32 split (x_hi = tf32(x),
//     x_lo = tf32(x - x_hi), hi.hi + hi.lo + lo.hi into float32
//     accumulators), which keeps float32's accuracy: dw and du are float32
//     whatever r, k, v are, and one TF32 pass (10-bit mantissa) misses the
//     reference's 1e-4. `wgmma` is not used: it takes TF32 only with both
//     operands K-major, and dA^T q~, A^T dO, k^ G and dA k~ read an
//     operand transposed. Order: the loads (k, w, v, dO, S_c, G_c into
//     shared memory, r into registers; the bonus from registers); the
//     decays; dO S_c^T, V G_c^T and k^ G_c; then q~ over S_c and dA over
//     G_c; then A over v beside dA k~ and dA^T q~; then A^T dO; then dr,
//     dk, dv and the d(log w) and du terms; the reverse sums; dw.
//  3. `rwkv6_bwd_du_kernel`: du summed over the chunks, in chunk order
//     (no atomics: the result is the same on every run).
//
// What bounds it: at path M's shape (8, 512, 32, 64, 64), chunks of 64,
// the inputs (r, k, v in bfloat16, w and dO in float32, the 33.5 MB
// start states) and the outputs (dr, dk, dv, dw) move 235 MB, 0.0701 ms
// at 3.35 TB/s; the least float32 work of any chunking is 4.69 GFLOP,
// 0.0701 ms at 67 TFLOP/s. The chunk kernel's 3xTF32 products are 19.7
// GFLOP of TF32 at chunks of 64, 0.040 ms at 495 TFLOP/s.
//
// What the design does about what held PR 24's kernel back:
//  - Occupancy: six 64 x 64 float tiles (16 KB each, rows of 64 floats)
//    and a few vectors, 100.3 KB a block, are reused as the products free
//    them (S_c's tile takes q~, then du's terms; G_c's takes dA, then the
//    k~ terms; v's takes A, then dq~ and the d(log w) terms), so two
//    blocks of 8 warps share an SM (was one block, 151 KB).
//  - Shared-memory issue: operands are read as m16n8k8 fragments, with the
//    mma's k order permuted (its k = q is our 2q, k = q + 4 our 2q + 1), so
//    that an untransposed operand is one 8-byte read a thread; the tiles'
//    columns are XOR-swizzled by row ((row >> 1) & 3) << 3, which makes
//    both the 8-byte reads and the transposed 4-byte reads free of bank
//    conflicts and keeps aligned groups of 8 columns together for the
//    16-byte loads and stores.
//  - Zeros: the strictly causal products skip every 16 x 8 tile above the
//    diagonal, in forming A and dA (20 of 32 tiles each, two or three a
//    warp) and in every product that reads them (the k steps past the
//    diagonal).
//    The warps' shares are balanced: dA k~ over row tile m pairs with
//    dA^T q~ over it, and A^T dO takes row tiles m and 3 - m.
//  - The walks: the decays are four segments of 16 rows per channel, each
//    two independent halves (the forward's scheme); the reverse sums of
//    the d(log w) terms and du's terms are four segments per channel whose
//    totals are combined in order; the bonus is a warp reduction at load
//    time and its gradient the diagonal of dO V^T. All 256 threads work.
//  - The end states: see kernel 1.
//
// r, k, v take any element strides over batch, position and head that keep
// each row's 16-byte loads aligned, with a contiguous channel dim; w, dO
// float32 likewise; u (B, H, dk) float32 with strides over batch and head.
// dState, when given, and both workspaces are contiguous float32 with a
// 16-byte-aligned base; dr, dk, dv (in r's dtype), dw (float32) are
// contiguous (B, S, H, d); du contiguous (B, H, dk).

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

constexpr int CH = 64;     // longest chunk
constexpr int DMAX = 64;   // largest dk and dv

// pass 1: a (T1, T1) tile of G a block, a 4 x 4 piece of it a thread
constexpr int T1 = 32;
constexpr int NT1 = T1 * T1 / 16;
constexpr int NSEG1 = NT1 / T1;   // decay segments per channel
constexpr int SEG1 = CH / NSEG1;
// blocks an SM keeps: four leave a thread the registers its prefetched
// chunk (80 with bfloat16 r, 96 with float32) and its tile need
constexpr int BLOCKS1 = 4;

// pass 2: 8 warps; 64 x 64 float tiles, rows of DMAX swizzled floats
constexpr int NT2 = 256;
constexpr int TILE = CH * DMAX;
constexpr int NSEG2 = NT2 / DMAX;  // row segments per channel
constexpr int SEG2 = CH / NSEG2;
// six tiles; u, the bonus, its gradient, exp(c_L), rowsum(G o S);
// segment products or sums (twice) and the k~ terms' partial sums
constexpr int SMEM2_FLOATS = 6 * TILE + 5 * DMAX + 3 * NSEG2 * DMAX;
constexpr size_t SMEM2_BYTES = sizeof(float) * SMEM2_FLOATS;
constexpr int BLOCKS2 = 2;

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
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 x = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *(uint32_t*)&x;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *(float4*)p = make_float4(v[0], v[1], v[2], v[3]);
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
__global__ void __launch_bounds__(NT1, BLOCKS1)
    rwkv6_bwd_states_kernel(Args a) {
  __shared__ __align__(16) float rs[CH * T1];  // r, then q~ = r exp(e)
  __shared__ __align__(16) float wt[CH * T1];  // w
  __shared__ __align__(16) float ds[CH * T1];  // dO
  __shared__ float tot[NSEG1 * T1];            // segment products of w
  __shared__ float dl[T1];                     // exp(c_L)

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
  for (int x = 0; x < 4; ++x) {
    const float4 d = own && a.dstate != nullptr
                         ? *(const float4*)(a.dstate +
                                            (bh * dk + i0 + si + x) * dv +
                                            j0 + sj)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    g[x][0] = d.x;
    g[x][1] = d.y;
    g[x][2] = d.z;
    g[x][3] = d.w;
  }

  // a chunk's r, w, dO tiles in registers, 16 bytes a load: r rows are
  // T1 / VK loads wide, w and dO rows T1 / 4; rows past the chunk or the
  // sequence are r = dO = 0, w = 1, the identity step
  constexpr int VK = Vec<T>::N;
  constexpr int KL = T1 / VK, KR = NT1 / KL, NK = CH / KR;  // lanes, rows
  constexpr int WL = T1 / 4, WR = NT1 / WL, NW = CH / WR;   // per load
  const int kc = (t % KL) * VK, kr0 = t / KL;
  const int wc = (t % WL) * 4, wr0 = t / WL;
  const T* rp = (const T*)a.r + b * a.rsb + h * a.rsh + i0 + kc;
  const float* wp = a.w + b * a.wsb + h * a.wsh + i0 + wc;
  const float* dp = a.dout + b * a.dsb + h * a.dsh + j0 + wc;
  uint4 rr[NK];
  float4 wr[NW], dr[NW];
  auto fetch = [&](int64_t c0) {
#pragma unroll
    for (int q = 0; q < NK; ++q) {
      const int row = kr0 + q * KR;
      const int64_t pos = c0 + row;
      const bool in = row < L && pos < a.seq;
      rr[q] = in && kc < bk ? ld16(rp + pos * a.rss) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      const int row = wr0 + q * WR;
      const int64_t pos = c0 + row;
      const bool in = row < L && pos < a.seq;
      wr[q] = in && wc < bk ? *(const float4*)(wp + pos * a.wss)
                            : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
      dr[q] = in && wc < bv ? *(const float4*)(dp + pos * a.dss)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  if (a.nc > 0) fetch((a.nc - 1) * L);

  const int ci = t % T1, sg = t / T1;  // decays: channel, segment of rows
  for (int64_t c = a.nc - 1; c >= 0; --c) {
    if (own) {  // G_c, the gradient of the chunk's end state
      float* gp = a.gws + ((bh * a.nc + c) * dk + i0 + si) * dv + j0 + sj;
#pragma unroll
      for (int x = 0; x < 4; ++x)
        *(float4*)(gp + x * dv) = make_float4(g[x][0], g[x][1], g[x][2],
                                              g[x][3]);
    }
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int q = 0; q < NK; ++q) {
      float f[VK];
      unpack(rr[q], f, T());
#pragma unroll
      for (int x = 0; x < VK; x += 4)
        store4(rs + (kr0 + q * KR) * T1 + kc + x, f + x);
    }
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      *(float4*)(wt + (wr0 + q * WR) * T1 + wc) = wr[q];
      *(float4*)(ds + (wr0 + q * WR) * T1 + wc) = dr[q];
    }
    if (c > 0) fetch((c - 1) * L);
    __syncthreads();

    // q~_t = r_t prod_{s<t} w_s: segment products, then each segment walks
    // its rows from the first, its two halves as two independent chains
    constexpr int HALF1 = SEG1 / 2;
    const float* wseg = wt + sg * SEG1 * T1 + ci;
    float lo = 1.0f, hi = 1.0f;
#pragma unroll
    for (int x = 0; x < HALF1; ++x) {
      lo *= wseg[x * T1];
      hi *= wseg[(HALF1 + x) * T1];
    }
    tot[sg * T1 + ci] = lo * hi;
    __syncthreads();
    float before = 1.0f, total = 1.0f;
#pragma unroll
    for (int x = 0; x < NSEG1; ++x) {
      const float seg = tot[x * T1 + ci];
      total *= seg;
      if (x < sg) before *= seg;
    }
    float* rseg = rs + sg * SEG1 * T1 + ci;
    float before_hi = before * lo;
#pragma unroll
    for (int x = 0; x < HALF1; ++x) {
      const int at_lo = x * T1, at_hi = (HALF1 + x) * T1;
      rseg[at_lo] *= before;
      rseg[at_hi] *= before_hi;
      before *= wseg[at_lo];
      before_hi *= wseg[at_hi];
    }
    if (sg == 0) dl[ci] = total;
    __syncthreads();

    if (own) {  // G <- diag(exp(c_L)) G + q~^T dO
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float d = dl[si + x];
#pragma unroll
        for (int y = 0; y < 4; ++y) g[x][y] *= d;
      }
#pragma unroll 8
      for (int row = 0; row < L; ++row) {
        const float4 qa = *(const float4*)&rs[row * T1 + si];
        const float4 oa = *(const float4*)&ds[row * T1 + sj];
        const float qx[4] = {qa.x, qa.y, qa.z, qa.w};
        const float oy[4] = {oa.x, oa.y, oa.z, oa.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) g[x][y] = fmaf(qx[x], oy[y], g[x][y]);
      }
    }
  }
}

// -- pass 2's tensor-core building blocks ------------------------------------

// (row, col) of a 64 x 64 tile: columns XOR-swizzled by ((row >> 1) & 3) << 3
__device__ __forceinline__ int sw(int row, int col) {
  return row * DMAX + (col ^ (((row >> 1) & 3) << 3));
}

// x's nearest TF32 value (ties away from zero), as the bits the mma reads
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// float32 operands as TF32 hi and lo parts: hi = tf32(x), lo = x - hi
// (exact; the mma reads its top 19 bits), so x = hi + lo + O(2^-21 x). An
// EXACT operand (bfloat16 values) is its own hi, lo = 0.
template <int N, bool EXACT>
__device__ __forceinline__ void split(const float* x, uint32_t* hi,
                                      uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = EXACT ? __float_as_uint(x[i]) : tf32(x[i]);
    lo[i] = EXACT ? 0u : __float_as_uint(x[i] - __uint_as_float(hi[i]));
  }
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b at float32 accuracy: the small terms first, then hi.hi; a term
// with an EXACT operand's lo (zero) is skipped
template <bool AX = false, bool BX = false>
__device__ __forceinline__ void mma3(float* c, const FragA& a,
                                     const FragB& b) {
  if (!AX) mma(c, a.lo, b.hi);
  if (!BX) mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

// A lane's offsets into a swizzled tile. Lane (g, q) of an m16n8k8
// fragment holds rows g, g + 8 and k columns 2q, 2q + 1 of its 8 (the
// mma's k = q and k = q + 4: the k order is permuted, the same for A and
// B). Read untransposed (the tile holds rows of the operand, k along the
// row) that is one 8-byte read a row at `nat` + 8 (k tile ^ `s`); read
// transposed (the tile holds k along the column) two 4-byte reads at
// `trans` + 8 (column tile ^ q), one row apart.
struct Lane {
  int nat, trans, s, q;
};

__device__ __forceinline__ Lane lane_of(int lane) {
  const int g = lane >> 2, q = lane & 3;
  return Lane{g * DMAX + 2 * q, 2 * q * DMAX + g, (g >> 1) & 3, q};
}

// the offset of row tile `row0` (a multiple of 8), k tile kt, untransposed
__device__ __forceinline__ int off_nat(const Lane& l, int row0, int kt) {
  return row0 * DMAX + l.nat + 8 * (kt ^ l.s);
}
// the offset of k tile kt, column tile ct, transposed
__device__ __forceinline__ int off_trans(const Lane& l, int kt, int ct) {
  return kt * 8 * DMAX + l.trans + 8 * (ct ^ l.q);
}

// The A operand (16 x 8): rows 16 mt.., k tile kt. TRANS: the tile holds
// it as s[k][m]. `scale`, if given, multiplies k column kk by scale[kk].
template <bool TRANS, bool EXACT = false>
__device__ __forceinline__ FragA frag_a(const float* s, int mt, int kt,
                                        const Lane& l,
                                        const float* scale = nullptr) {
  float x[4];
  if (TRANS) {
    const int o0 = off_trans(l, kt, 2 * mt), o1 = off_trans(l, kt, 2 * mt + 1);
    x[0] = s[o0];
    x[1] = s[o1];
    x[2] = s[o0 + DMAX];
    x[3] = s[o1 + DMAX];
  } else {
    const int o = off_nat(l, 16 * mt, kt);
    const float2 lo = *(const float2*)&s[o];
    const float2 hi = *(const float2*)&s[o + 8 * DMAX];
    x[0] = lo.x;
    x[1] = hi.x;
    x[2] = lo.y;
    x[3] = hi.y;
  }
  if (scale != nullptr) {
    const float2 sc = *(const float2*)&scale[8 * kt + 2 * l.q];
    x[0] *= sc.x;
    x[1] *= sc.x;
    x[2] *= sc.y;
    x[3] *= sc.y;
  }
  FragA f;
  split<4, EXACT>(x, f.hi, f.lo);
  return f;
}

// The B operand (8 x 8): k tile kt, columns 8 nt... Untransposed the tile
// holds it as s[n][k], TRANS as s[k][n].
template <bool TRANS, bool EXACT = false>
__device__ __forceinline__ FragB frag_b(const float* s, int nt, int kt,
                                        const Lane& l) {
  float x[2];
  if (TRANS) {
    const int o = off_trans(l, kt, nt);
    x[0] = s[o];
    x[1] = s[o + DMAX];
  } else {
    const float2 v = *(const float2*)&s[off_nat(l, 8 * nt, kt)];
    x[0] = v.x;
    x[1] = v.y;
  }
  FragB f;
  split<2, EXACT>(x, f.hi, f.lo);
  return f;
}

// an accumulator's 16 x 8 tile at row tile mt, column tile nt into s:
// lane (g, q) holds rows 16 mt + g (c[0], c[1]) and + 8 (c[2], c[3]),
// columns 8 nt + 2q, + 1
__device__ __forceinline__ void store_c(float* s, int mt, int nt,
                                        const Lane& l, const float* c) {
  const int o = off_nat(l, 16 * mt, nt);
  *(float2*)&s[o] = make_float2(c[0], c[1]);
  *(float2*)&s[o + 8 * DMAX] = make_float2(c[2], c[3]);
}

// The strictly causal L x L products' 16 x 8 tiles on or below the
// diagonal, 20 of 32: tile i's row tile and column tile
__device__ __forceinline__ void causal_tile(int i, int& mt, int& nt) {
  mt = i < 8 ? 3 : i < 14 ? 2 : i < 18 ? 1 : 0;
  nt = i - (i < 8 ? 0 : i < 14 ? 8 : i < 18 ? 14 : 18);
}

// One warp's share of a strictly causal product: tiles warp, warp + 8,
// warp + 16 of the 20 (`causal_tile`), x y^T over nk k tiles, x and y
// untransposed; rows past the chunk's row tiles are skipped
template <bool YX>
__device__ __forceinline__ void causal_product(const float* x,
                                               const float* y, int nk,
                                               int nrt, int warp,
                                               const Lane& l,
                                               float acc[3][4]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int i = warp + 8 * j;
      int mt, nt;
      causal_tile(i, mt, nt);
      if (i >= 20 || mt >= nrt) continue;
      mma3<false, YX>(acc[j], frag_a<false>(x, mt, kt, l),
                      frag_b<false, YX>(y, nt, kt, l));
    }
  }
}

// Pass 2: every chunk's gradients; one block per (b * h, chunk).
template <typename T>
__global__ void __launch_bounds__(NT2, BLOCKS2)
    rwkv6_bwd_chunk_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* K = smem;          // k, then k~
  float* W = K + TILE;      // w, then exp(e); then w again
  float* V = W + TILE;      // v; then A; then dq~; then the d(log w) terms,
                            // then dw
  float* D = V + TILE;      // dO; then dV
  float* R = D + TILE;      // S_c [dk][dv]; then q~; then du's terms
  float* G = R + TILE;      // G_c [dk][dv]; then dA; then dk~ + exp(c_L) dk^,
                            // then dq~ q~
  float* us = G + TILE;     // [DMAX] u
  float* bon = us + DMAX;   // [CH] r . (u k)
  float* dbon = bon + CH;   // [CH] dO . v
  float* ecl = dbon + CH;   // [DMAX] exp(c_L)
  float* gs = ecl + DMAX;   // [DMAX] rowsum(G_c o S_c)
  float* segs = gs + DMAX;  // [NSEG2][DMAX] segment products, then sums
  float* segu = segs + NSEG2 * DMAX;  // [NSEG2][DMAX] du's segment sums
  float* part = segu + NSEG2 * DMAX;  // [4][DMAX] exp(c_L) dk^ k~ by tile

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int64_t bh = blockIdx.x / a.nc;
  const int64_t c = blockIdx.x % a.nc;
  const int64_t b = bh / a.heads, h = bh % a.heads;
  const int dk = a.ndk, dv = a.ndv, L = a.chunk;
  const int64_t c0 = c * L;
  const int nrt = (L + 15) / 16, nkt = (L + 7) / 8;  // row tiles, k steps
  const int ndk = dk / 8, ndv = dv / 8;                // column tiles

  // -- loads, 16 bytes each: r, k, v rows of VT values a load, w and dO
  // rows of 4; rows past the chunk or the sequence are 0 (w = 1)
  constexpr int VT = Vec<T>::N;
  constexpr int TL = DMAX / VT, TR = NT2 / TL, NR = CH / TR;  // lanes, rows
  constexpr int FL = DMAX / 4, FR = NT2 / FL, NF = CH / FR;   // per load
  const int tc = (t % TL) * VT, tr0 = t / TL;
  const int fc = (t % FL) * 4, fr0 = t / FL;
  const T* rp = (const T*)a.r + b * a.rsb + h * a.rsh + tc;
  const T* kp = (const T*)a.k + b * a.ksb + h * a.ksh + tc;
  const T* vp = (const T*)a.v + b * a.vsb + h * a.vsh + tc;
  const float* wp = a.w + b * a.wsb + h * a.wsh + fc;
  const float* dp = a.dout + b * a.dsb + h * a.dsh + fc;
  const float* sp = a.ws + (bh * a.nc + c) * dk * dv;
  const float* gp = a.gws + (bh * a.nc + c) * dk * dv;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  uint4 rr[NR], kr[NR], vr[NR];
  float4 wr[NF], dr[NF];
#pragma unroll
  for (int x = 0; x < NR; ++x) {
    const int i = tr0 + x * TR;
    const int64_t pos = c0 + i;
    const bool in = i < L && pos < a.seq;
    rr[x] = in && tc < dk ? ld16(rp + pos * a.rss) : zero;
    kr[x] = in && tc < dk ? ld16(kp + pos * a.kss) : zero;
    vr[x] = in && tc < dv ? ld16(vp + pos * a.vss) : zero;
  }
#pragma unroll
  for (int x = 0; x < NF; ++x) {
    const int i = fr0 + x * FR;
    const int64_t pos = c0 + i;
    const bool in = i < L && pos < a.seq;
    wr[x] = in && fc < dk ? *(const float4*)(wp + pos * a.wss)
                          : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    dr[x] = in && fc < dv ? *(const float4*)(dp + pos * a.dss) : zero4;
  }
  // S_c and G_c, (dk, dv) row-major: dv / 4 loads a row
  constexpr int NS = DMAX * DMAX / 4 / NT2;
  const int sl = dv / 4;
  float4 sr[NS], gr[NS];
#pragma unroll
  for (int x = 0; x < NS; ++x) {
    const int at = t + x * NT2, row = at / sl, col = 4 * (at % sl);
    const bool in = at < dk * sl;
    sr[x] = in ? *(const float4*)(sp + row * dv + col) : zero4;
    gr[x] = in ? *(const float4*)(gp + row * dv + col) : zero4;
  }
  if (t < DMAX) us[t] = t < dk ? a.u[b * a.usb + h * a.ush + t] : 0.0f;
  float uf[VT];
  const float* up = a.u + b * a.usb + h * a.ush + tc;
#pragma unroll
  for (int x = 0; x < VT; ++x) uf[x] = tc + x < dk ? up[x] : 0.0f;
#pragma unroll
  for (int x = 0; x < NR; ++x) {
    const int i = tr0 + x * TR;
    float rf[VT], kf[VT], vf[VT];
    unpack(rr[x], rf, T());
    unpack(kr[x], kf, T());
    unpack(vr[x], vf, T());
    float bv = 0.0f;  // r . (u k) over this load's channels
#pragma unroll
    for (int y = 0; y < VT; ++y) bv = fmaf(rf[y] * uf[y], kf[y], bv);
#pragma unroll
    for (int y = 0; y < VT; y += 4) {
      store4(K + sw(i, tc + y), kf + y);
      store4(V + sw(i, tc + y), vf + y);
    }
    // the row's TL lanes are neighbours in the warp: their sum is the bonus
#pragma unroll
    for (int off = TL / 2; off > 0; off >>= 1)
      bv += __shfl_xor_sync(0xffffffffu, bv, off);
    if (t % TL == 0) bon[i] = bv;
  }
#pragma unroll
  for (int x = 0; x < NF; ++x) {
    const int i = fr0 + x * FR;
    *(float4*)&W[sw(i, fc)] = wr[x];
    *(float4*)&D[sw(i, fc)] = dr[x];
  }
#pragma unroll
  for (int x = 0; x < NS; ++x) {
    const int at = t + x * NT2, row = at / sl, col = 4 * (at % sl);
    if (at < dk * sl) {
      *(float4*)&R[sw(row, col)] = sr[x];
      *(float4*)&G[sw(row, col)] = gr[x];
    }
  }
  __syncthreads();

  // -- the decays, as products of w: four segments of 16 rows per channel,
  // each two independent halves; exp(e_t) = prod_{s<t} w_s over W and
  // k~_t = k_t / prod_{s<=t} w_s over K. Meanwhile rowsum(G_c o S_c), four
  // lanes a row.
  constexpr int HALF2 = SEG2 / 2;
  const int sd = t % DMAX, sg = t / DMAX;  // channel, segment
  const int r0 = sg * SEG2;
  const bool scanner = sd < dk;
  float lo = 1.0f, hi = 1.0f;
  if (scanner) {
#pragma unroll
    for (int x = 0; x < HALF2; ++x) {
      lo *= W[sw(r0 + x, sd)];
      hi *= W[sw(r0 + HALF2 + x, sd)];
    }
    segs[sg * DMAX + sd] = lo * hi;
  }
  {
    const int d = t >> 2, p = t & 3;
    float x = 0.0f;
    if (d < dk)
      for (int e = p; e < dv; e += 4) x = fmaf(G[sw(d, e)], R[sw(d, e)], x);
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (d < dk && p == 0) gs[d] = x;
  }
  __syncthreads();
  if (scanner) {
    float before = 1.0f, total = 1.0f;
#pragma unroll
    for (int j = 0; j < NSEG2; ++j) {
      const float seg = segs[j * DMAX + sd];
      total *= seg;
      if (j < sg) before *= seg;
    }
    if (sg == 0) ecl[sd] = total;
    float before_hi = before * lo;
#pragma unroll
    for (int x = 0; x < HALF2; ++x) {
      const int at_lo = sw(r0 + x, sd), at_hi = sw(r0 + HALF2 + x, sd);
      const float wl = W[at_lo], wh = W[at_hi];
      W[at_lo] = before;
      W[at_hi] = before_hi;
      before *= wl;
      before_hi *= wh;
      K[at_lo] *= __frcp_rn(before);
      K[at_hi] *= __frcp_rn(before_hi);
    }
  }
  __syncthreads();

  // -- warp tiling of the (rows, channels) products: row tile mi, column
  // tiles 4 nh .. 4 nh + 3; dV's: row tiles mi and 3 - mi, column tiles
  // 2 quad, 2 quad + 1 (so A^T dO's causal work is the same for all)
  const Lane ln = lane_of(lane);
  const int mi = warp & 3, nh = warp >> 2;
  const int quad = (mi >= 2 ? 2 : 0) + nh;
  const bool rows_in = mi < nrt;
  constexpr bool VX = sizeof(T) == 2;  // v's bfloat16 values are TF32
  float dq[4][4], th[4][4], dvv[2][2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dq[j][e] = th[j][e] = 0.0f;
      dvv[j >> 1][j & 1][e] = 0.0f;
    }

  // dq~ = dO S_c^T and dk^ = V G_c^T, sums over the value columns
  if (rows_in) {
    for (int kt = 0; kt < ndv; ++kt) {
      const FragA fd = frag_a<false>(D, mi, kt, ln);
      const FragA fv = frag_a<false, VX>(V, mi, kt, ln);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * nh + j;
        if (n >= ndk) continue;
        mma3(dq[j], fd, frag_b<false>(R, n, kt, ln));
        mma3<VX>(th[j], fv, frag_b<false>(G, n, kt, ln));
      }
    }
  }
  // dV = k^ G_c, k^ = k~ exp(c_L), sums over the key channels
  for (int kt = 0; kt < ndk; ++kt) {
    FragB fg[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) fg[j] = frag_b<true>(G, 2 * quad + j, kt, ln);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int m = x ? 3 - mi : mi;
      if (m >= nrt) continue;
      const FragA fk = frag_a<false>(K, m, kt, ln, ecl);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (2 * quad + j < ndv) mma3(dvv[x][j], fk, fg[j]);
    }
  }
  // exp(c_L) dk^ k~ summed over the warp's 16 rows (dc_L's first term),
  // per column; th becomes exp(c_L) dk^
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = 4 * nh + j;
    const int col = 8 * n + 2 * q;
    float z0 = 0.0f, z1 = 0.0f;
    if (rows_in && n < ndk) {
      const float l0 = ecl[col], l1 = ecl[col + 1];
      th[j][0] *= l0;
      th[j][1] *= l1;
      th[j][2] *= l0;
      th[j][3] *= l1;
      const int o = off_nat(ln, 16 * mi, n);
      const float2 ka = *(const float2*)&K[o];
      const float2 kc = *(const float2*)&K[o + 8 * DMAX];
      z0 = fmaf(th[j][0], ka.x, th[j][2] * kc.x);
      z1 = fmaf(th[j][1], ka.y, th[j][3] * kc.y);
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      z0 += __shfl_xor_sync(0xffffffffu, z0, off);
      z1 += __shfl_xor_sync(0xffffffffu, z1, off);
    }
    if (g == 0 && n < ndk) {
      part[mi * DMAX + col] = z0;
      part[mi * DMAX + col + 1] = z1;
    }
  }
  __syncthreads();  // S_c and G_c are read

  // -- q~ = r exp(e) over S_c
#pragma unroll
  for (int x = 0; x < NR; ++x) {
    const int i = tr0 + x * TR;
    float rf[VT];
    unpack(rr[x], rf, T());
#pragma unroll
    for (int y = 0; y < VT; y += 4) {
      const float4 e = *(const float4*)&W[sw(i, tc + y)];
      const float v4[4] = {rf[y] * e.x, rf[y + 1] * e.y, rf[y + 2] * e.z,
                           rf[y + 3] * e.w};
      store4(R + sw(i, tc + y), v4);
    }
  }
  __syncthreads();

  // -- dA = dO V^T over G_c (strictly causal; its diagonal, the bonus's
  // gradient, into dbon), the 20 16 x 8 tiles on or below the diagonal,
  // each warp three or two
  float acc[3][4];
  causal_product<VX>(D, V, ndv, nrt, warp, ln, acc);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int i = warp + 8 * j;
    int mt, nt;
    causal_tile(i, mt, nt);
    if (i >= 20 || mt >= nrt) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * mt + g + 8 * (e >> 1);
      const int col = 8 * nt + 2 * q + (e & 1);
      if (col == row) dbon[row] = acc[j][e];
      if (col >= row) acc[j][e] = 0.0f;
    }
    store_c(G, mt, nt, ln, acc[j]);
  }
  __syncthreads();  // dA is in; V is read
  float* const dA = G;
  float* const A = V;

  // -- A = q~ k~^T over V (strictly causal, the bonus on its diagonal),
  // beside dq~ += dA k~ (over the rows m < 16 (mi + 1)) and dk~ = dA^T q~
  // (into th; over the rows t >= 16 mi)
  causal_product<false>(R, K, ndk, nrt, warp, ln, acc);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int i = warp + 8 * j;
    int mt, nt;
    causal_tile(i, mt, nt);
    if (i >= 20 || mt >= nrt) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * mt + g + 8 * (e >> 1);
      const int col = 8 * nt + 2 * q + (e & 1);
      if (col >= row) acc[j][e] = col == row ? bon[row] : 0.0f;
    }
    store_c(A, mt, nt, ln, acc[j]);
  }
  if (rows_in) {
    const int kend = min(2 * mi + 2, nkt);
    for (int kt = 0; kt < kend; ++kt) {
      const FragA fa = frag_a<false>(dA, mi, kt, ln);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * nh + j;
        if (n < ndk) mma3(dq[j], fa, frag_b<true>(K, n, kt, ln));
      }
    }
    for (int kt = 2 * mi; kt < nkt; ++kt) {
      const FragA fa = frag_a<true>(dA, mi, kt, ln);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * nh + j;
        if (n < ndk) mma3(th[j], fa, frag_b<true>(R, n, kt, ln));
      }
    }
  }
  __syncthreads();  // A is in

  // -- dV += A^T dO over row tiles mi and 3 - mi, the rows t >= 16 m
  for (int kt = 2 * min(mi, 3 - mi); kt < nkt; ++kt) {
    FragB fo[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) fo[j] = frag_b<true>(D, 2 * quad + j, kt, ln);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int m = x ? 3 - mi : mi;
      if (m >= nrt || kt < 2 * m) continue;
      const FragA fa = frag_a<true>(A, m, kt, ln);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (2 * quad + j < ndv) mma3(dvv[x][j], fa, fo[j]);
    }
  }
  __syncthreads();  // dA, A and dO are read

  // dq~ over A, dk~ + exp(c_L) dk^ over dA, dV over dO
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = 4 * nh + j;
    if (rows_in && n < ndk) {
      store_c(V, mi, n, ln, dq[j]);
      store_c(G, mi, n, ln, th[j]);
    }
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int m = x ? 3 - mi : mi;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (m < nrt && 2 * quad + j < ndv)
        store_c(D, m, 2 * quad + j, ln, dvv[x][j]);
  }
  __syncthreads();

  // -- dr, dk and dv, 16 bytes a load and a store; the d(log w) terms
  // f = dq~ q~ - (dk~ + exp(c_L) dk^) k~ over dq~, dq~ q~ over the k~
  // terms, du's terms dbonus r k over q~, w over exp(e). Rows past the
  // chunk or the sequence leave zeros (w = 1).
  T* drp = (T*)a.dr;
  T* dkp = (T*)a.dk;
  T* dvp = (T*)a.dv;
  const int64_t hk = a.heads * dk, hv = a.heads * dv;
  // r, k and w again (from L2), every row's loads issued before any use
  const float* wq = a.w + b * a.wsb + h * a.wsh + tc;
  float4 wl[NR][VT / 4];
#pragma unroll
  for (int x = 0; x < NR; ++x) {
    const int64_t pos = c0 + tr0 + x * TR;
    const bool in = tr0 + x * TR < L && pos < a.seq && tc < dk;
    rr[x] = in ? ld16(rp + pos * a.rss) : zero;
    kr[x] = in ? ld16(kp + pos * a.kss) : zero;
#pragma unroll
    for (int y = 0; y < VT / 4; ++y)
      wl[x][y] = in ? *(const float4*)(wq + 4 * y + pos * a.wss)
                    : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  }
#pragma unroll
  for (int x = 0; x < NR; ++x) {
    const int i = tr0 + x * TR;
    const int64_t pos = c0 + i;
    const bool in = i < L && pos < a.seq;
    if (tc < dk) {
      float rf[VT], kf[VT], wf[VT];
      unpack(rr[x], rf, T());
      unpack(kr[x], kf, T());
#pragma unroll
      for (int y = 0; y < VT / 4; ++y) {
        wf[4 * y] = wl[x][y].x;
        wf[4 * y + 1] = wl[x][y].y;
        wf[4 * y + 2] = wl[x][y].z;
        wf[4 * y + 3] = wl[x][y].w;
      }
      const float db = dbon[i];
      float drf[VT], dkf[VT];
#pragma unroll
      for (int y = 0; y < VT; y += 4) {
        const int at = sw(i, tc + y);
        const float4 xq = *(const float4*)&V[at];  // dq~
        const float4 xt = *(const float4*)&G[at];  // dk~ + exp(c_L) dk^
        const float4 qt = *(const float4*)&R[at];
        const float4 kt = *(const float4*)&K[at];
        const float4 eb = *(const float4*)&W[at];
        const float xqa[4] = {xq.x, xq.y, xq.z, xq.w};
        const float xta[4] = {xt.x, xt.y, xt.z, xt.w};
        const float qta[4] = {qt.x, qt.y, qt.z, qt.w};
        const float kta[4] = {kt.x, kt.y, kt.z, kt.w};
        const float eba[4] = {eb.x, eb.y, eb.z, eb.w};
        float f[4], de[4], du4[4], w4[4];
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          if (in) {
            const float uk = db * us[tc + y + z];
            const float ec = __frcp_rn(eba[z] * wf[y + z]);  // exp(-c_t)
            drf[y + z] = fmaf(xqa[z], eba[z], uk * kf[y + z]);
            dkf[y + z] = fmaf(xta[z], ec, uk * rf[y + z]);
            de[z] = xqa[z] * qta[z];
            f[z] = fmaf(-xta[z], kta[z], de[z]);
            du4[z] = db * rf[y + z] * kf[y + z];
            w4[z] = wf[y + z];
          } else {
            de[z] = f[z] = du4[z] = 0.0f;
            w4[z] = 1.0f;
          }
        }
        store4(V + at, f);
        store4(G + at, de);
        store4(R + at, du4);
        store4(W + at, w4);
      }
      if (in) {
        const int64_t o = (b * a.seq + pos) * hk + h * dk + tc;
        *(uint4*)(drp + o) = pack(drf, T());
        *(uint4*)(dkp + o) = pack(dkf, T());
      }
    }
    if (in && tc < dv) {
      float vf[VT];
#pragma unroll
      for (int y = 0; y < VT; y += 4) {
        const float4 z = *(const float4*)&D[sw(i, tc + y)];
        vf[y] = z.x;
        vf[y + 1] = z.y;
        vf[y + 2] = z.z;
        vf[y + 3] = z.w;
      }
      *(uint4*)(dvp + (b * a.seq + pos) * hv + h * dv + tc) = pack(vf, T());
    }
  }
  __syncthreads();

  // -- d(log w)_j = sum_{t>=j} f_t - dq~_j q~_j + dc_L: each channel's
  // four segments' sums, then each segment walks its rows from the last;
  // du's terms summed alike
  if (scanner) {
    float sf = 0.0f, su = 0.0f;
#pragma unroll
    for (int x = 0; x < SEG2; ++x) {
      sf += V[sw(r0 + x, sd)];
      su += R[sw(r0 + x, sd)];
    }
    segs[sg * DMAX + sd] = sf;
    segu[sg * DMAX + sd] = su;
  }
  __syncthreads();
  if (scanner) {
    float after = 0.0f;
#pragma unroll
    for (int j = NSEG2 - 1; j >= 0; --j)
      if (j > sg) after += segs[j * DMAX + sd];
    const float dcl =
        fmaf(ecl[sd], gs[sd],
             ((part[sd] + part[DMAX + sd]) + part[2 * DMAX + sd]) +
                 part[3 * DMAX + sd]);
#pragma unroll
    for (int x = SEG2 - 1; x >= 0; --x) {
      const int at = sw(r0 + x, sd);
      after += V[at];
      V[at] = (after - G[at] + dcl) / W[at];
    }
    if (sg == 0)
      a.dupart[(bh * a.nc + c) * dk + sd] =
          ((segu[sd] + segu[DMAX + sd]) + segu[2 * DMAX + sd]) +
          segu[3 * DMAX + sd];
  }
  __syncthreads();

  // -- dw, 16 bytes a store
  if (fc < dk) {
#pragma unroll
    for (int x = 0; x < NF; ++x) {
      const int i = fr0 + x * FR;
      const int64_t pos = c0 + i;
      if (i < L && pos < a.seq)
        *(float4*)(a.dw + (b * a.seq + pos) * hk + h * dk + fc) =
            *(const float4*)&V[sw(i, fc)];
    }
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
  static unsigned long long configured = 0;  // one bit a device
  const unsigned long long dev_bit = device_bit();
  if (!(configured & dev_bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_bwd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM2_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured |= dev_bit;
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
// 1 bfloat16) and w, dout float32, each with element strides (batch,
// position, head) that keep 16-byte loads aligned and a contiguous last
// dim; u (B, H, dk) float32 with strides (batch, head); dstate a
// contiguous (B, H, dk, dv) float32 or null (zeros); ws and gws contiguous
// (B, H, ceil(S / chunk), dk, dv) float32; dr, dk, dv contiguous in
// `dtype`, dw contiguous float32, dupart (B, H, n_chunks, dk) and du (B,
// H, dk) float32; every base 16-byte aligned. dk, dv in 8, 16, 32, 64;
// chunk in 1..64. Returns cudaGetLastError() after its launches.
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
