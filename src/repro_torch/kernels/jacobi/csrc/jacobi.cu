// jacobi: one 5-point Jacobi sweep over halo-extended blocks.
//
// Replaces the Pallas kernel src/repro/kernels/jacobi/kernel.py
// (`jacobi_sweep_kernel`, body `_jacobi_kernel`), which tiles the wide
// column axis (TILE = 512 lanes) and keeps all rows of a tile in VMEM.
//
// What bounds it: bytes. It does 4 adds and 1 multiply per output, far
// below the card's rate, and must read the (rows, W + 2) input once and
// write the (rows, W) output once: the least time is
// (read + write bytes) / 3.35 TB/s.
//
// Design: one thread per output column, for every block of the batch. The
// domain is tall and narrow (8 rows in the paper's runs), so a thread walks
// down its column keeping the centre values of the row above, the row and
// the row below in registers, and reads the left and right neighbours of
// each row. Neighbouring threads read neighbouring addresses, so every load
// and store is coalesced; the three overlapping column reads meet in L1/L2
// and device memory sees the input about once. W need not be a multiple of
// anything: the ragged last block masks its columns.
//
// Arithmetic: out = 0.25 * (((left + right) + up) + down), in that order,
// with Dirichlet zeros above the first and below the last row. float32 is
// computed in float32 and matches the plain version bit for bit. bfloat16
// inputs are widened to float32, summed and scaled in float32 and rounded
// once to bfloat16 on the store; the reference adds in bfloat16, rounding
// after every add, so bfloat16 is held only to 2e-2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
jacobi_kernel(const T* __restrict__ ext, T* __restrict__ out, int64_t rows,
              int64_t w) {
  const int64_t col = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (col >= w) return;
  const int64_t b = blockIdx.y;
  const int64_t in_stride = w + 2;
  const T* in = ext + b * rows * in_stride + col;
  T* o = out + b * rows * w + col;
  float up = 0.0f;
  float centre = load_f(in + 1);
  for (int64_t r = 0; r < rows; ++r) {
    const T* row = in + r * in_stride;
    const float left = load_f(row);
    const float right = load_f(row + 2);
    const float down = (r + 1 < rows) ? load_f(row + in_stride + 1) : 0.0f;
    const float s = ((left + right) + up) + down;
    store_f(o + r * w, 0.25f * s);
    up = centre;
    centre = down;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. ext (batch, rows, w + 2) and
// out (batch, rows, w), both contiguous. Returns cudaGetLastError().
int jacobi_launch(const void* ext, void* out, int64_t batch, int64_t rows,
                  int64_t w, int dtype, void* stream) {
  if (batch > 0 && rows > 0 && w > 0) {
    dim3 grid((unsigned)((w + THREADS - 1) / THREADS), (unsigned)batch);
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) {
      jacobi_kernel<float><<<grid, THREADS, 0, s>>>(
          (const float*)ext, (float*)out, rows, w);
    } else if (dtype == 1) {
      jacobi_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          (const __nv_bfloat16*)ext, (__nv_bfloat16*)out, rows, w);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
