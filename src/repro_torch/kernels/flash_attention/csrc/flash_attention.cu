// flash_attention: blockwise online-softmax attention with grouped-query
// heads, causal and sliding-window masks.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_kernel`, body `_flash_kernel`). There the grid is
// (batch, q_heads, q_blocks, kv_blocks) with the last dimension sequential,
// carrying the running max, sum and accumulator in VMEM scratch from one
// key block to the next. Here one block of 256 threads owns one
// (batch * q_head, 64-query tile) and walks the key tiles in a loop,
// carrying the same state in registers.
//
// What bounds it: operations. Attention does 4 * S_q * S_k * D flops per
// head (half of that under the causal mask) on (S, D) inputs; at the
// serving shapes that is far above the card's bytes-to-flops balance. This
// first version computes in float32 on the CUDA cores (the card's float32
// rate, not its bf16 tensor-core rate), so it runs well below the bound;
// a tensor-core version is later work.
//
// Design:
// * Q (64 rows) is staged once in shared memory, transposed to [d][row];
//   each K tile (64 keys) transposed to [d][key] and each V tile as
//   [key][d], all converted to float32 on the load. Rows and keys past
//   the sequence end load as zeros.
// * Thread t owns rows 4 * (t / 16) .. + 3. For the scores it owns keys
//   4 * (t % 16) .. + 3 (a 4 x 4 register tile, two float4 shared loads
//   per d); for the output it owns dims t % 16 + 16 * i. The 16 threads
//   of a row group are 16 lanes of one warp, so row max and row sum are
//   warp shuffles.
// * Per key tile, exactly what the Pallas body does: scores in float32,
//   scaled, masked to -1e30 (col < S, col <= row if causal,
//   col > row - window if a window is given), m_new = max(m, rowmax),
//   p = exp(s - m_new) zeroed where masked, alpha = exp(m - m_new),
//   l = alpha * l + rowsum(p), acc = alpha * acc + p V. The end writes
//   acc / l, and exact zeros where l == 0.
// * Key tiles wholly above the diagonal or wholly left of every row's
//   window are skipped: they add exact zeros (p = 0, alpha = 1).
// * GQA: kv_head = q_head / (Hq / Hkv); grouped heads are never copied.
// * Q, K and V take any element strides over batch, head and position;
//   the head dim must be contiguous. The output is a new contiguous
//   (B, Hq, S, D) tensor in q's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int PS = BK + 4;    // padded row length of the probability tile
constexpr int THREADS = 256;  // 16 row groups x 16 column groups
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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
};

constexpr size_t smem_bytes(int d) {
  return sizeof(float) * (2 * (size_t)d * BQ + (size_t)BK * d + (size_t)BQ * PS);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(Args a) {
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  constexpr int DPT = D / 16;  // output dims per thread
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

  const T* qp = (const T*)a.q + b * a.qsb + h * a.qsh;
  const T* kp = (const T*)a.k + b * a.ksb + hk * a.ksh;
  const T* vp = (const T*)a.v + b * a.vsb + hk * a.vsh;

  for (int idx = t; idx < BQ * D; idx += THREADS) {
    const int row = idx & (BQ - 1);
    const int d = idx / BQ;
    const int64_t r = q0 + row;
    qt[d * BQ + row] = r < seq ? to_f(qp[r * a.qss + d]) : 0.0f;
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
  const int64_t n_tiles = (seq + BK - 1) / BK;
  const int64_t kt_end = a.causal ? q_last / BK + 1 : n_tiles;
  int64_t kt_begin = 0;
  if (a.window >= 0) {
    const int64_t first = q0 - a.window + 1;  // least column row q0 keeps
    kt_begin = first > 0 ? first / BK : 0;
  }

  for (int64_t tile = kt_begin; tile < kt_end; ++tile) {
    const int64_t k0 = tile * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = t; idx < BK * D; idx += THREADS) {
      const int key = idx & (BK - 1);
      const int d = idx / BK;
      const int64_t c = k0 + key;
      kt[d * BK + key] = c < seq ? to_f(kp[c * a.kss + d]) : 0.0f;
    }
    for (int idx = t; idx < BK * D; idx += THREADS) {
      const int key = idx / D;
      const int d = idx % D;
      const int64_t c = k0 + key;
      vs[key * D + d] = c < seq ? to_f(vp[c * a.vss + d]) : 0.0f;
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

  T* op = (T*)a.o + bh * seq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + 4 * rg + i;
    if (row >= seq) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      store_f(op + row * D + cg + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const Args& a, int64_t batch, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes(D);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((unsigned)((a.seq + BQ - 1) / BQ), (unsigned)(batch * a.hq));
  flash_kernel<T, D><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, int64_t batch, int64_t d, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(a, batch, s);
    case 32: return launch<T, 32>(a, batch, s);
    case 64: return launch<T, 64>(a, batch, s);
    case 128: return launch<T, 128>(a, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Hq, S, D), k and v (B, Hkv, S, D) with element strides (batch,
// head, position) and a contiguous head dim; o a contiguous
// (B, Hq, S, D). dtype: 0 float32, 1 bfloat16. window < 0: no window.
// Returns cudaGetLastError() after the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int64_t qsb, int64_t qsh, int64_t qss,
                           int64_t ksb, int64_t ksh, int64_t kss,
                           int64_t vsb, int64_t vsh, int64_t vss,
                           int64_t batch, int64_t hq, int64_t hkv,
                           int64_t seq, int64_t d, float scale, int causal,
                           int64_t window, int dtype, void* stream) {
  if (batch <= 0 || hq <= 0 || seq <= 0) return (int)cudaGetLastError();
  if (hkv <= 0 || hq % hkv) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
         hq, hq / hkv, seq, window, scale, causal};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(a, batch, d, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, batch, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
