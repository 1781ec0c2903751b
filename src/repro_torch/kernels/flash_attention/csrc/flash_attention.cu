// flash_attention: blockwise online-softmax attention with grouped-query
// heads, causal and sliding-window masks.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_kernel`, body `_flash_kernel`). There the grid is
// (batch, q_heads, q_blocks, kv_blocks) with the last dimension sequential,
// carrying the running max, sum and accumulator in VMEM scratch from one
// key block to the next. Here one block owns one (batch * q_head, 64-query
// tile) and walks the key tiles in a loop, carrying the same state in
// registers.
//
// What bounds it: operations at long sequences, bytes at short ones.
// Attention does 4 * S_q * S_k * D flops per head (half of that under the
// causal mask) on (S, D) inputs. The card's bf16 tensor cores do 989
// TFLOP/s against 67 TFLOP/s of float32 on the CUDA cores, so the product
// type decides which rate is in reach. Two kernels, chosen by dtype:
//
// bfloat16: `flash_wgmma_kernel`, on the tensor cores.
// * One warpgroup (128 threads) per block owns 64 query rows. Two blocks
//   share an SM at D = 128 (82,944 bytes of shared memory each), so one
//   block's softmax runs under the other's products; at D = 192 (123,904
//   bytes) one block does. Both products are warpgroup `wgmma.mma_async`
//   with float32 accumulators in registers: S = Q K^T as m64n64k16 with Q
//   and the K tile read from shared memory (both K-major, as loaded), then
//   O += P V as m64nDPk16 with P from registers and the V tile from shared
//   memory as the transposed ("MN-major") B operand.
// * Head dims other than 16, 32, 64, 128 and 192 run at the padded width
//   DP of hopper_tiles.cuh: d = 80 and 112 in tiles of 128 columns whose
//   last 48 or 16 TMA fills with zeros. Q K^T takes ceil(d / 16) k-steps
//   (no waste); P V runs at N = 128, 128 / d of its work (1.6x at 80,
//   1.14x at 112); the output stores write d columns.
// * Loads are TMA copies over 4-D tensor maps (D, S, heads, batch) built
//   on the host per call and passed as __grid_constant__ parameters, so a
//   launch recorded into a CUDA graph carries them by value. Tiles land in
//   shared memory in the 128-byte swizzle (64- or 32-byte for DP = 32, 16)
//   that the wgmma descriptors name; rows past S arrive as zeros. K and V
//   tiles of 64 keys go through a ring of two stages with one barrier for
//   each K and each V: thread 0 reloads a stage's K as soon as every
//   warp's Q K^T has read it, and its V after P V, so tile j + 2 loads
//   under tile j's math.
// * Every block reads each K/V tile it needs from L2, so the blocks of a
//   head must run together: the 1-D grid walks groups of heads whose K
//   and V fit in 16 MB, the longest causal query tiles of a group first.
//   In launch order of heads, long sequences thrash L2.
// * The score accumulator becomes P in place: the m64n64 accumulator
//   fragment of a thread is the A-operand fragment of the next product,
//   rounded to bf16. The reference keeps P in float32; rounding it is the
//   one deliberate difference, as in every tensor-core flash kernel. The
//   running max, alpha and the row sums (each thread sums its own columns;
//   the four threads of a row add up at the end) stay float32.
// * The output goes through shared memory (padded rows) and leaves as
//   16-byte stores.
// * What holds it below the tensor-core rate: a block waits on its own
//   K/V loads and does not overlap its softmax with its own products.
//   Sharing tiles between more rows (two warpgroups per block, or
//   multicast within a cluster of two blocks) and overlapping within a
//   warpgroup were slower in this structure; see PERF.md.
//
// float32: `flash_kernel`, on the CUDA cores. The reference's float32
// tolerance (atol 3e-5 / rtol 1e-4) rules out TF32 tensor cores.
// * Q (64 rows) is staged once in shared memory, transposed to [d][row];
//   each K tile (64 keys) transposed to [d][key] and each V tile as
//   [key][d]. Rows and keys past the sequence end load as zeros.
// * Thread t owns rows 4 * (t / 16) .. + 3. For the scores it owns keys
//   4 * (t % 16) .. + 3 (a 4 x 4 register tile, two float4 shared loads
//   per d); for the output it owns dims t % 16 + 16 * i. The 16 threads
//   of a row group are 16 lanes of one warp, so row max and row sum are
//   warp shuffles.
// * Built at DP = 16, 32, 64, 80, 112, 128 and 192 (hopper_tiles.cuh,
//   `f32_head_dims`); a head dim between two of them is staged with zero
//   columns up to the next.
//
// Both, per key tile, exactly what the Pallas body does: scores in
// float32, scaled, masked to -1e30 (col < S, col <= row if causal,
// col > row - window if a window is given), m_new = max(m, rowmax),
// p = exp(s - m_new) zeroed where masked, alpha = exp(m - m_new),
// l = alpha * l + rowsum(p), acc = alpha * acc + p V; the end writes
// acc / l, and exact zeros where l == 0. Key tiles wholly above the
// diagonal or wholly left of every row's window are skipped: they add
// exact zeros (p = 0, alpha = 1). The bf16 kernel evaluates the element
// mask only on tiles that straddle a boundary, computes exp as exp2 of
// log2(e)-scaled scores, and starts the longest causal query tiles first.
// GQA: kv_head = q_head / (Hq / Hkv); grouped heads are never copied.
// Q, K and V take any element strides over batch, head and position with
// a contiguous head dim (bf16: 16-byte aligned base and strides, which TMA
// needs; the wrapper checks). The output is a new contiguous (B, Hq, S, D)
// tensor in q's type. When asked (training), both kernels also write each
// row's float32 log-sum-exp of scale * q k^T in natural-log units, which
// the backward (flash_attention_bwd.cu) recomputes P from; serving passes
// no pointer and writes nothing more.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t qsb, qsh, qss;
  int64_t ksb, ksh, kss;
  int64_t vsb, vsh, vss;
  int64_t hq, qpk, seq, window;  // window < 0: no window
  float scale;
  int causal;
  int64_t group;  // bf16: heads per L2 group of the block order
  float* lse;     // (B, Hq, S) row log-sum-exp, or nullptr
  int64_t d;      // head dim (the kernels' padded width DP >= d)
};

// The key tiles [*begin, *end) of KEYS keys that rows r0 .. r_last visit:
// tiles wholly above the diagonal or wholly left of every row's window
// add exact zeros (p = 0, alpha = 1) and are skipped.
template <int KEYS>
__device__ __forceinline__ void key_tiles(const Args& a, int64_t r0,
                                          int64_t r_last, int64_t* begin,
                                          int64_t* end) {
  *end = a.causal ? r_last / KEYS + 1 : (a.seq + KEYS - 1) / KEYS;
  *begin = 0;
  if (a.window >= 0) {
    const int64_t first = r0 - a.window + 1;  // least column row r0 keeps
    *begin = first > 0 ? first / KEYS : 0;
  }
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel.

constexpr int PS = BK + 4;    // padded row length of the probability tile
constexpr int THREADS = 256;  // 16 row groups x 16 column groups

constexpr size_t smem_bytes(int d) {
  return sizeof(float) * (2 * (size_t)d * BQ + (size_t)BK * d + (size_t)BQ * PS);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(Args a) {
  static_assert(D % 16 == 0 && (D <= 128 || D == 192), "head dim");
  constexpr int DPT = D / 16;  // output dims per thread
  const int64_t hd = a.d;      // the true head dim, <= D
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;            // [D][BQ]
  float* kt = qt + D * BQ;     // [D][BK]
  float* vs = kt + D * BK;     // [BK][D]
  float* ps = vs + BK * D;     // [BQ][PS]

  const int t = threadIdx.x;
  const int rg = t >> 4;  // row group: rows 4 rg .. 4 rg + 3
  const int cg = t & 15;  // key group (scores) / dim group (output)
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / a.hq;
  const int64_t h = bh % a.hq;
  const int64_t hk = h / a.qpk;
  const int64_t seq = a.seq;
  const int64_t q0 = (int64_t)blockIdx.x * BQ;

  const float* qp = (const float*)a.q + b * a.qsb + h * a.qsh;
  const float* kp = (const float*)a.k + b * a.ksb + hk * a.ksh;
  const float* vp = (const float*)a.v + b * a.vsb + hk * a.vsh;

  for (int idx = t; idx < BQ * D; idx += THREADS) {
    const int row = idx & (BQ - 1);
    const int d = idx / BQ;
    const int64_t r = q0 + row;
    qt[d * BQ + row] = r < seq && d < hd ? qp[r * a.qss + d] : 0.0f;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.0f;
  }

  const int64_t q_last = (q0 + BQ < seq ? q0 + BQ : seq) - 1;
  int64_t kt_begin, kt_end;
  key_tiles<BK>(a, q0, q_last, &kt_begin, &kt_end);

  for (int64_t tile = kt_begin; tile < kt_end; ++tile) {
    const int64_t k0 = tile * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = t; idx < BK * D; idx += THREADS) {
      const int key = idx & (BK - 1);
      const int d = idx / BK;
      const int64_t c = k0 + key;
      kt[d * BK + key] = c < seq && d < hd ? kp[c * a.kss + d] : 0.0f;
    }
    for (int idx = t; idx < BK * D; idx += THREADS) {
      const int key = idx / D;
      const int d = idx % D;
      const int64_t c = k0 + key;
      vs[key * D + d] = c < seq && d < hd ? vp[c * a.vss + d] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    const float4* qt4 = reinterpret_cast<const float4*>(qt);
    const float4* kt4 = reinterpret_cast<const float4*>(kt);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = qt4[d * (BQ / 4) + rg];
      const float4 kv = kt4[d * (BK / 4) + cg];
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + 4 * rg + i;
      bool valid[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = k0 + 4 * cg + j;
        bool ok = col < seq;
        if (a.causal) ok = ok && col <= row;
        if (a.window >= 0) ok = ok && col > row - a.window;
        valid[j] = ok;
        s[i][j] = ok ? s[i][j] * a.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = valid[j] ? expf(s[i][j] - m_new) : 0.0f;
        sum += p[j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
      reinterpret_cast<float4*>(ps + (4 * rg + i) * PS)[cg] =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha[i];
    for (int jj = 0; jj < BK; jj += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv =
            reinterpret_cast<const float4*>(ps + (4 * rg + i) * PS)[jj / 4];
        pr[i][0] = pv.x;
        pr[i][1] = pv.y;
        pr[i][2] = pv.z;
        pr[i][3] = pv.w;
      }
#pragma unroll
      for (int js = 0; js < 4; ++js) {
        const float* vrow = vs + (jj + js) * D + cg;
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const float vv = vrow[16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][j] = fmaf(pr[i][js], vv, acc[i][j]);
        }
      }
    }
  }

  float* op = (float*)a.o + bh * seq * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + 4 * rg + i;
    if (row >= seq) continue;
    if (a.lse != nullptr && cg == 0)
      a.lse[bh * seq + row] = l[i] == 0.0f ? -INFINITY : m[i] + logf(l[i]);
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (cg + 16 * j < hd) op[row * hd + cg + 16 * j] = acc[i][j] / denom;
  }
}

template <int D>
int launch_f32(const Args& a, int64_t batch, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes(D);
  static unsigned long long configured = 0;  // one bit a device
  const unsigned long long dev_bit = device_bit();
  if (!(configured & dev_bit)) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured |= dev_bit;
  }
  dim3 grid((unsigned)((a.seq + BQ - 1) / BQ), (unsigned)(batch * a.hq));
  flash_kernel<D><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel, on the wrappers of hopper_tiles.cuh.

// The online-softmax step of one key tile for this thread's two rows (r0
// and r0 + 8) and its KEYS / 4 columns. Fragment element i is (row r0 +
// 8 * ((i >> 1) & 1), column c0 + 8 * (i >> 2) + (i & 1)). Turns s into
// the probabilities, updates m and l, and returns each row's alpha; the
// accumulator is rescaled by the caller once the previous P V is done.
template <int KEYS, bool MASK>
__device__ __forceinline__ void softmax_step(const Args& a, float* s,
                                             float* m, float* l,
                                             float* alpha, int64_t r0,
                                             int64_t c0, float scale_log2) {
  constexpr int N = KEYS / 2;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = s[i] * scale_log2;
    if (MASK) {
      const int64_t row = r0 + 8 * ((i >> 1) & 1);
      const int64_t col = c0 + 8 * (i >> 2) + (i & 1);
      bool ok = col < a.seq;
      if (a.causal) ok = ok && col <= row;
      if (a.window >= 0) ok = ok && col > row - a.window;
      if (!ok) x = -INFINITY;  // never the max (nor is -1e30); p = 0
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    const float e = MASK && s[i] == -INFINITY ? 0.0f : exp2f(s[i] - m[r]);
    l[r] += e;
    s[i] = e;
  }
}

// Rescales this thread's accumulator rows by alpha and packs the
// probabilities in s into P's A-operand fragments: the m64nK accumulator
// fragment of a thread is, pair by pair, its A fragment of the next
// product.
template <int DP, int KEYS>
__device__ __forceinline__ void rescale_and_pack(float* o, const float* alpha,
                                                 const float* s,
                                                 uint32_t (*p)[4]) {
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// A 1-D grid of (query tile, batch * head) blocks in groups of a.group
// heads: a group's K and V stay in L2 while its blocks run, and within a
// group the longest causal query tiles start first, heads innermost. Thread
// 0 issues every TMA load. Barriers: one for Q, and per stage one for K
// and one for V, so a tile's Q K^T starts once its K has landed and K's
// stage is refilled as soon as every warp's Q K^T has read it.
template <int DP, int KS>
__global__ void __launch_bounds__(Tiles<DP>::THREADS)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, Args a) {
  using T = Tiles<DP>;
  constexpr int KEYS = T::KEYS;
  constexpr int STAGES = T::STAGES;
  extern __shared__ uint8_t dyn[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const uint32_t q_tile = (smem_u32(dyn) + 1023u) & ~1023u;
  const uint32_t ring = q_tile + T::Q_TILE;  // stage s: K, then V
  const uint32_t q_bar = smem_u32(&bars[0]);
  auto k_bar = [&](int st) { return smem_u32(&bars[1 + 2 * st]); };
  auto v_bar = [&](int st) { return smem_u32(&bars[2 + 2 * st]); };
  auto k_tile = [&](int st) { return ring + 2 * st * T::KV_TILE; };

  const int64_t n_qt = (a.seq + T::ROWS - 1) / T::ROWS;
  const int64_t span = a.group * n_qt;
  const int64_t g0 = blockIdx.x / span * a.group;
  const int64_t bh_all = gridDim.x / n_qt;
  const int64_t heads = a.group < bh_all - g0 ? a.group : bh_all - g0;
  const int64_t rank = blockIdx.x % span;
  const int64_t bh = g0 + rank % heads;
  const int64_t q0 = (n_qt - 1 - rank / heads) * T::ROWS;
  const int b = (int)(bh / a.hq);
  const int h = (int)(bh % a.hq);
  const int hk = (int)(h / a.qpk);
  const int64_t q_last = (q0 + T::ROWS < a.seq ? q0 + T::ROWS : a.seq) - 1;
  int64_t kt_begin, kt_end;
  key_tiles<KEYS>(a, q0, q_last, &kt_begin, &kt_end);
  const int n_tiles = (int)(kt_end - kt_begin);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * STAGES; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, T::Q_TILE);
    load_tile<DP>(q_tile, &tq, (int)q0, h, b, q_bar);
    for (int j = 0; j < STAGES && j < n_tiles; ++j) {
      const int k0 = (int)((kt_begin + j) * KEYS);
      mbar_expect_tx(k_bar(j), T::KV_TILE);
      load_tile<DP>(k_tile(j), &tk, k0, hk, b, k_bar(j));
      mbar_expect_tx(v_bar(j), T::KV_TILE);
      load_tile<DP>(k_tile(j) + T::KV_TILE, &tv, k0, hk, b, v_bar(j));
    }
  }

  const int lane = tid & 31;
  const int64_t r0 = q0 + 16 * (tid >> 5) + (lane >> 2);
  const int64_t c_lane = 2 * (lane & 3);
  const float scale_log2 = a.scale * 1.4426950408889634f;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};
  float alpha[2];
  float s[KEYS / 2];
  uint32_t p[KEYS / 16][4];

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    const uint32_t parity = (uint32_t)(j / STAGES) & 1u;
    const int64_t k0 = (kt_begin + j) * KEYS;
    const bool refill = j + STAGES < n_tiles;
    const int kn = (int)(k0 + STAGES * KEYS);
    mbar_wait(k_bar(st), parity);
    issue_scores<DP, KS>(s, q_tile, k_tile(st));
    wgmma_wait_all();
    reg_fence<KEYS / 2>(s);
    if (refill) {
      __syncthreads();  // every warp's Q K^T has read this K tile
      if (tid == 0) {
        mbar_expect_tx(k_bar(st), T::KV_TILE);
        load_tile<DP>(k_tile(st), &tk, kn, hk, b, k_bar(st));
      }
    }
    // The element mask matters only on tiles that cross the sequence end,
    // the diagonal or a row's window edge.
    if (k0 + KEYS > a.seq || (a.causal && k0 + KEYS - 1 > q0) ||
        (a.window >= 0 && k0 <= q_last - a.window))
      softmax_step<KEYS, true>(a, s, m, l, alpha, r0, k0 + c_lane,
                               scale_log2);
    else
      softmax_step<KEYS, false>(a, s, m, l, alpha, r0, k0 + c_lane,
                                scale_log2);
    rescale_and_pack<DP, KEYS>(o, alpha, s, p);
    mbar_wait(v_bar(st), parity);
    issue_values<DP>(o, p, k_tile(st) + T::KV_TILE);
    wgmma_wait_all();
    reg_fence<DP / 2>(o);
    if (refill) {
      __syncthreads();  // every warp's P V has read this V tile
      if (tid == 0) {
        mbar_expect_tx(v_bar(st), T::KV_TILE);
        load_tile<DP>(k_tile(st) + T::KV_TILE, &tv, kn, hk, b,
                           v_bar(st));
      }
    }
  }

  // acc / l (exact zeros where l == 0) as bf16 into padded rows over the Q
  // tile and stage 0's K, once every warp is done with them, then 16-byte
  // stores of the first a.d columns.
  uint8_t* out_s = dyn + (q_tile - smem_u32(dyn));
  __syncthreads();
  const int lr = 16 * (tid >> 5) + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = l[r] == 0.0f ? 0.0f : 1.0f / l[r];
    // m is in log2 units of scale * q k^T: lse = ln 2 * (m + log2 l)
    if (a.lse != nullptr && (lane & 3) == 0 && q0 + lr + 8 * r < a.seq)
      a.lse[bh * a.seq + q0 + lr + 8 * r] =
          l[r] == 0.0f ? -INFINITY
                       : (m[r] + log2f(l[r])) * 0.6931471805599453f;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      __nv_bfloat162 v = __floats2bfloat162_rn(o[4 * c + 2 * r] * inv,
                                               o[4 * c + 2 * r + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(
          out_s + (lr + 8 * r) * T::OUT_ROW + (8 * c + c_lane) * 2) = v;
    }
  }
  __syncthreads();
  uint8_t* out_g =
      (uint8_t*)a.o + ((size_t)bh * a.seq + q0) * a.d * sizeof(__nv_bfloat16);
  const int chunks = (int)(a.d / 8);  // 16-byte pieces per row
  for (int idx = tid; idx < T::ROWS * chunks; idx += T::THREADS) {
    const int row = idx / chunks;
    const int c = idx % chunks;
    if (q0 + row < a.seq)
      *reinterpret_cast<uint4*>(out_g + (size_t)row * a.d * 2 + c * 16) =
          *reinterpret_cast<const uint4*>(out_s + row * T::OUT_ROW + c * 16);
  }
}

// One 64-row tile of each product, through the same loads, descriptors
// and fragments as the kernel: s = q k^T (64 x 64) and o = p v (64 x d),
// float32, row-major; p is a row-major 64 x 64 bf16 matrix. For testing
// the layouts on the card.
template <int DP, int KS>
__global__ void __launch_bounds__(128)
    tile_products_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __nv_bfloat16* p, float* s_out, float* o_out,
                         int d) {
  using T = Tiles<DP>;
  constexpr int KEYS = T::KEYS;
  extern __shared__ uint8_t dyn[];
  __shared__ __align__(8) uint64_t bar_mem;
  const uint32_t q_tile = (smem_u32(dyn) + 1023u) & ~1023u;
  const uint32_t k_tile = q_tile + T::Q_TILE;
  const uint32_t v_tile = k_tile + T::KV_TILE;
  const uint32_t bar = smem_u32(&bar_mem);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, T::Q_TILE + 2 * T::KV_TILE);
    load_tile<DP>(q_tile, &tq, 0, 0, 0, bar);
    load_tile<DP>(k_tile, &tk, 0, 0, 0, bar);
    load_tile<DP>(v_tile, &tv, 0, 0, 0, bar);
  }
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);
  const int c_lane = 2 * (lane & 3);
  uint32_t pf[KEYS / 16][4];
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e & 1);
      const int col = 16 * kk + 8 * (e >> 1) + c_lane;
      pf[kk][e] = *reinterpret_cast<const uint32_t*>(p + row * KEYS + col);
    }
  mbar_wait(bar, 0);
  float s[KEYS / 2];
  issue_scores<DP, KS>(s, q_tile, k_tile);
  wgmma_wait_all();
  reg_fence<KEYS / 2>(s);
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  issue_values<DP>(o, pf, v_tile);
  wgmma_wait_all();
  reg_fence<DP / 2>(o);
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i)
    s_out[(r0 + 8 * ((i >> 1) & 1)) * KEYS + 8 * (i >> 2) + c_lane + (i & 1)] =
        s[i];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int col = 8 * (i >> 2) + c_lane + (i & 1);
    if (col < d) o_out[(r0 + 8 * ((i >> 1) & 1)) * d + col] = o[i];
  }
}

template <int DP, int KS>
int launch_bf16(const Args& a, int64_t batch, int64_t hkv,
                cudaStream_t stream) {
  using T = Tiles<DP>;
  static unsigned long long configured = 0;  // one bit a device
  const unsigned long long dev_bit = device_bit();
  if (!(configured & dev_bit)) {
    const int err = set_smem(flash_wgmma_kernel<DP, KS>, T::SMEM);
    if (err) return err;
    configured |= dev_bit;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map<DP>(&tq, a.q, a.d, a.seq, a.hq, batch, a.qss, a.qsh,
                   a.qsb) ||
      !make_map<DP>(&tk, a.k, a.d, a.seq, hkv, batch, a.kss, a.ksh, a.ksb) ||
      !make_map<DP>(&tv, a.v, a.d, a.seq, hkv, batch, a.vss, a.vsh, a.vsb))
    return (int)cudaErrorInvalidValue;
  // Heads per L2 group: as many as keep their K and V (shared by the
  // Hq / Hkv query heads of a group) within 16 MB, a third of the L2.
  const int64_t kv_bytes = 4 * a.seq * a.d / a.qpk;  // K, V per query head
  Args g = a;
  g.group = (int64_t)(16 << 20) / kv_bytes;
  if (g.group < 1) g.group = 1;
  if (g.group > batch * a.hq) g.group = batch * a.hq;
  const int64_t blocks = (a.seq + T::ROWS - 1) / T::ROWS * batch * a.hq;
  flash_wgmma_kernel<DP, KS>
      <<<(unsigned)blocks, T::THREADS, T::SMEM, stream>>>(tq, tk, tv, g);
  return (int)cudaGetLastError();
}

template <int DP, int KS>
int launch_tile_products(const void* q, const void* k, const void* v,
                         const void* p, void* s_out, void* o_out, int64_t d,
                         cudaStream_t stream) {
  using T = Tiles<DP>;
  constexpr size_t bytes = 1024 + T::Q_TILE + 2 * (size_t)T::KV_TILE;
  static unsigned long long configured = 0;  // one bit a device
  const unsigned long long dev_bit = device_bit();
  if (!(configured & dev_bit)) {
    const int err = set_smem(tile_products_kernel<DP, KS>, bytes);
    if (err) return err;
    configured |= dev_bit;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map<DP>(&tq, q, d, 64, 1, 1, d, 0, 0) ||
      !make_map<DP>(&tk, k, d, 64, 1, 1, d, 0, 0) ||
      !make_map<DP>(&tv, v, d, 64, 1, 1, d, 0, 0))
    return (int)cudaErrorInvalidValue;
  tile_products_kernel<DP, KS><<<1, 128, bytes, stream>>>(
      tq, tk, tv, (const __nv_bfloat16*)p, (float*)s_out, (float*)o_out,
      (int)d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Hq, S, D), k and v (B, Hkv, S, D) with element strides (batch,
// head, position) and a contiguous head dim; o a contiguous
// (B, Hq, S, D); lse a contiguous float32 (B, Hq, S) that receives each
// row's log-sum-exp of scale * q k^T over the keys it attends (-inf for a
// row with none), or nullptr. dtype: 0 float32 (the CUDA-core kernel),
// 1 bfloat16 (the tensor-core kernel; 16-byte aligned bases and strides).
// d: a multiple of 8 up to 128, or 192. window < 0: no window. Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for another
// head dim.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, int64_t qsb, int64_t qsh,
                           int64_t qss,
                           int64_t ksb, int64_t ksh, int64_t kss,
                           int64_t vsb, int64_t vsh, int64_t vss,
                           int64_t batch, int64_t hq, int64_t hkv,
                           int64_t seq, int64_t d, float scale, int causal,
                           int64_t window, int dtype, void* stream) {
  if (batch <= 0 || hq <= 0 || seq <= 0) return (int)cudaGetLastError();
  if (hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
         hq, hq / hkv, seq, window, scale, causal, 0, (float*)lse, d};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return f32_head_dims(d, [&](auto dp) {
      return launch_f32<decltype(dp)::value>(a, batch, s);
    });
  if (dtype == 1)
    return head_dims(d, [&](auto dp, auto ks) {
      return launch_bf16<decltype(dp)::value, decltype(ks)::value>(
          a, batch, hkv, s);
    });
  return (int)cudaErrorInvalidValue;
}

// One tile of each bf16 product through the tensor-core kernel's loads
// and wgmma layouts: q, k, v contiguous (64, d) bf16, p contiguous
// (64, 64) bf16; s_out = q k^T (64, 64) and o_out = p v (64, d), float32.
int flash_attention_tile_products(const void* q, const void* k,
                                  const void* v, const void* p, void* s_out,
                                  void* o_out, int64_t d, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return head_dims(d, [&](auto dp, auto ks) {
    return launch_tile_products<decltype(dp)::value, decltype(ks)::value>(
        q, k, v, p, s_out, o_out, d, s);
  });
}

}  // extern "C"
