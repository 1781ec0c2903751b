// ring_allgather: bidirectional-ring all-gather of device-stacked shards.
//
// Replaces the Pallas kernel src/repro/kernels/ring_allgather/kernel.py
// (`build_ring_allgather`, body `_ring_ag_kernel`). There, every chip
// copies its shard into its own output slot, then for N-1 steps sends the
// first half of the features of one slot clockwise and the second half of
// another slot counter-clockwise, as two remote DMAs on distinct links.
// On one Hopper card every logical device d is a row of the stacked input
// x: (n, rows, f) and owns the replica out[d]: (n, rows, f) of the gather,
// so a remote DMA becomes a strided copy between two replicas.
//
// Ring schedule (half = f / 2, or f when that is 0; the second direction
// exists only when half < f):
//   phase 0 (init):      out[d, d]                   = x[d]
//   phase s, clockwise:  out[d, (d-s)%n, :, :half]   = out[d-1, (d-s)%n, :, :half]
//   phase s, counter-cw: out[d, (d+s)%n, :, half:]   = out[d+1, (d+s)%n, :, half:]
// Each phase-s copy reads exactly the tile that the phase s-1 copy of the
// neighbour wrote, so the ring is kept: it is the structure that carries
// over to peer pointers once logical devices are distinct GPUs.
//
// What bounds it: bytes. The function reads each shard once and writes n^2
// blocks, (n + n^2) * S bytes for S = rows * f * itemsize; the ring itself
// reads and writes every block once, 2 * n^2 * S. There is no arithmetic.
//
// Design (the pattern of multipath_dma.cu):
// * Work items are (phase, device, direction, tile) in that order, so the
//   item index is computed, not read from a table. A tile is a range of at
//   most `rpt` rows by at most `cc` columns of one direction's half; the
//   tiling is the same in every phase, so an item depends on exactly one
//   item of the previous phase: (phase-1, d-1 or d+1, direction, tile).
// * A persistent grid takes items from a global atomic ticket in index
//   order. A waited-on item has a lower index and was claimed earlier by a
//   running block, so waiting cannot deadlock, whatever the grid size.
// * The waiter spins on the predecessor's flag with an acquire load; a
//   finished item publishes its flag with a fence and a release store.
//   Reads go through L2 (__ldcg), since L1 is not coherent across SMs.
// * Halves are strided: nr segments of w * itemsize bytes, row stride
//   f * itemsize. The 16-byte path is taken only when both pointers, the
//   segment and the stride are multiples of 16, else 4 bytes, else single
//   bytes (odd widths such as f = 7 and bfloat16 halves take the latter).
// * A graph freezes kernel arguments, so the caller zeroes the state words
//   (ticket, completed count, flags) on the same stream before each launch;
//   that zeroing is captured with the launch.
// * state[1] counts completed items: after one launch it equals n_items.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

// nrows segments of `per_row` elements of V, row stride `stride` bytes.
template <typename V>
__device__ __forceinline__ void copy2d(uint8_t* dst, const uint8_t* src,
                                       uint32_t nrows, uint32_t per_row,
                                       int64_t stride) {
  const uint32_t total = nrows * per_row;
  for (uint32_t i = threadIdx.x; i < total; i += blockDim.x) {
    const uint32_t r = i / per_row;
    const uint32_t c = i - r * per_row;
    const int64_t off = (int64_t)r * stride;
    ((V*)(dst + off))[c] = __ldcg((const V*)(src + off) + c);
  }
}

__device__ void copy_rows(uint8_t* dst, const uint8_t* src, int64_t nrows,
                          int64_t seg, int64_t stride) {
  const uintptr_t a = (uintptr_t)dst | (uintptr_t)src | (uintptr_t)seg |
                      (uintptr_t)stride;
  if ((a & 15) == 0) {
    copy2d<uint4>(dst, src, (uint32_t)nrows, (uint32_t)(seg / 16), stride);
  } else if ((a & 3) == 0) {
    copy2d<uint32_t>(dst, src, (uint32_t)nrows, (uint32_t)(seg / 4), stride);
  } else {
    copy2d<uint8_t>(dst, src, (uint32_t)nrows, (uint32_t)seg, stride);
  }
}

struct Ring {
  int64_t n, rows, f, isz;   // devices, shard rows, features, item bytes
  int64_t half, ndir;        // clockwise width, directions (1 or 2)
  int64_t rpt, cc;           // tile rows, tile columns
  int64_t rtiles, ctiles;    // tiles per direction: rtiles * ctiles
};

// state layout (int32): [0] ticket, [1] completed items, [2, 2 + nitems)
// per-item done flags.
__global__ void __launch_bounds__(THREADS)
ring_allgather_kernel(const uint8_t* __restrict__ x, uint8_t* out, int* state,
                      Ring g, int64_t nitems) {
  __shared__ int64_t item_sh;
  int* ticket = state;
  int* completed = state + 1;
  int* flags = state + 2;
  const int64_t tiles = g.rtiles * g.ctiles;
  const int64_t stride = g.f * g.isz;
  while (true) {
    if (threadIdx.x == 0) item_sh = atomicAdd(ticket, 1);
    __syncthreads();
    const int64_t it = item_sh;
    __syncthreads();  // item_sh is rewritten on the next turn
    if (it >= nitems) return;
    // decode (phase, device, direction, tile)
    const int64_t t = it % tiles;
    int64_t q = it / tiles;
    const int64_t dir = q % g.ndir;
    q /= g.ndir;
    const int64_t d = q % g.n;
    const int64_t p = q / g.n;
    const int64_t rt = t / g.ctiles;
    const int64_t ct = t % g.ctiles;
    const int64_t lo = dir ? g.half : 0;
    const int64_t width = dir ? g.f - g.half : g.half;
    const int64_t c0 = ct * g.cc;
    const int64_t r0 = rt * g.rpt;
    const int64_t nr = g.rows - r0 < g.rpt ? g.rows - r0 : g.rpt;
    const int64_t w = c0 >= width ? 0 : (width - c0 < g.cc ? width - c0
                                                            : g.cc);
    // the neighbour this copy reads from, and the block it carries
    const int64_t sd = dir ? (d + 1) % g.n : (d + g.n - 1) % g.n;
    const int64_t b = p == 0 ? d
                    : dir ? (d + p) % g.n : (d + g.n - p % g.n) % g.n;
    if (p > 0) {
      const int64_t pred = (((p - 1) * g.n + sd) * g.ndir + dir) * tiles + t;
      if (threadIdx.x == 0) {
        while (load_acquire(flags + pred) == 0) __nanosleep(64);
      }
      __syncthreads();
    }
    if (w > 0 && nr > 0) {
      const int64_t col = (lo + c0) * g.isz;
      uint8_t* dst = out + ((d * g.n + b) * g.rows + r0) * stride + col;
      const uint8_t* src =
          p == 0 ? x + (d * g.rows + r0) * stride + col
                 : out + ((sd * g.n + b) * g.rows + r0) * stride + col;
      copy_rows(dst, src, nr, w * g.isz, stride);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      store_release(flags + it, 1);
      atomicAdd(completed, 1);
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch.
int ring_allgather_launch(const void* x, void* out, void* state, int64_t n,
                          int64_t rows, int64_t f, int64_t isz, int64_t half,
                          int64_t ndir, int64_t rpt, int64_t cc,
                          int64_t rtiles, int64_t ctiles, int64_t nitems,
                          int grid, void* stream) {
  if (nitems > 0 && grid > 0) {
    Ring g{n, rows, f, isz, half, ndir, rpt, cc, rtiles, ctiles};
    ring_allgather_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, (uint8_t*)out, (int*)state, g, nitems);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
