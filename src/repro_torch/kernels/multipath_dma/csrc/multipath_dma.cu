// multipath_dma: execute one scheduled transfer graph in one launch.
//
// Replaces the Pallas kernel src/repro/kernels/multipath_dma/kernel.py
// (`build_multipath_dma`, body `_multipath_dma_kernel`), which runs one
// TransferPlan as remote DMAs between chips with semaphore waits for the
// hop edges. On one Hopper card every logical device is a row of one
// operand in device memory, so a copy node is a memory-to-memory copy.
//
// What bounds it: bytes. Every byte of the node table is read once and
// written once (fills write only), so the least time is
// (bytes read + bytes written) / 3.35 TB/s. There is no arithmetic.
//
// Design:
// * The host builds a work table (int64, ITEM_COLS columns per row) from
//   the SCHEDULED graph: fill items first (rows that are not a
//   destination, zeroed or copied from the input), then every copy node
//   cut into tiles of at most a few hundred KiB, in the graph's index
//   order. Index order is topological: every hop edge points forward.
// * A persistent grid of blocks takes items one at a time from a global
//   atomic ticket, in table order. An item is claimed only by a block that
//   is already running, and its predecessor has a lower index, so the
//   predecessor was claimed earlier by a running block: waiting on it
//   cannot deadlock, whatever the grid size.
// * A staged hop tile waits on the tile of the previous hop that moved the
//   same bytes (its flag), read with acquire semantics; a finished tile
//   publishes its flag with a fence and a release store. Staging slots are
//   one per non-terminal copy node, so chains of any length work.
// * No barrier between the fill and the copies (the Pallas kernel's global
//   barrier): fill regions and terminal copy regions are disjoint by the
//   graph's disjoint-cover invariant (DESIGN.md §4.5), so nothing orders
//   them. Window edges order replay rounds only; every round has its own
//   output row and staging slots, so they need no wait either.
// * Copies take a 16-byte vector path when source and destination share
//   their alignment mod 16 (head and tail done by single bytes), a 4-byte
//   path when they share it mod 4, else single bytes. Chunk offsets are
//   only element-aligned. All offsets are 64-bit.
// * The kernel's arguments are frozen inside a CUDA graph, so the caller
//   zeroes the state words (ticket, flags, counters) on the same stream
//   before every launch; that zeroing is captured with the launch.
// * state[1] counts completed copy nodes: after one launch it equals the
//   graph's copy-node count (the equal-graph law).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ITEM_COLS = 8;
// item columns
constexpr int C_SRC_SPACE = 0;  // 0 zero, 1 input, 2 output, 3 staging
constexpr int C_SRC_OFF = 1;
constexpr int C_DST_SPACE = 2;
constexpr int C_DST_OFF = 3;
constexpr int C_NBYTES = 4;
constexpr int C_PRED = 5;       // item this one waits on, or -1
constexpr int C_NODE = 6;       // copy node index, or -1 for a fill
constexpr int C_NODE_TILES = 7; // tiles of that copy node

constexpr int THREADS = 512;
constexpr int UNROLL = 4;

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

template <typename V>
__device__ __forceinline__ void copy_body(V* dst, const V* src, int64_t n) {
  // n elements of V; src == nullptr writes zeros.
  const int64_t stride = (int64_t)blockDim.x * UNROLL;
  int64_t i = threadIdx.x;
  if (src == nullptr) {
    const V z{};
    for (; i < n; i += blockDim.x) dst[i] = z;
    return;
  }
  for (; i + (UNROLL - 1) * (int64_t)blockDim.x < n; i += stride) {
    V v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldcg(src + i + u * blockDim.x);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) dst[i + u * blockDim.x] = v[u];
  }
  for (; i < n; i += blockDim.x) dst[i] = __ldcg(src + i);
}

__device__ void copy_bytes(uint8_t* dst, const uint8_t* src, int64_t n) {
  const uintptr_t d = (uintptr_t)dst;
  const uintptr_t s = src ? (uintptr_t)src : d;
  int align = 1;
  if (((d ^ s) & 15) == 0) {
    align = 16;
  } else if (((d ^ s) & 3) == 0) {
    align = 4;
  }
  int64_t head = (int64_t)((align - (d & (align - 1))) & (align - 1));
  if (head > n) head = n;
  const int64_t nvec = (n - head) / align;
  const int64_t body = nvec * align;
  const int64_t tail = n - head - body;
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x)
    dst[i] = src ? __ldcg(src + i) : 0;
  uint8_t* vd = dst + head;
  const uint8_t* vs = src ? src + head : nullptr;
  if (align == 16) {
    copy_body<uint4>((uint4*)vd, (const uint4*)vs, nvec);
  } else if (align == 4) {
    copy_body<uint32_t>((uint32_t*)vd, (const uint32_t*)vs, nvec);
  } else {
    copy_body<uint8_t>(vd, vs, nvec);
  }
  uint8_t* td = vd + body;
  const uint8_t* ts = vs ? vs + body : nullptr;
  for (int64_t i = threadIdx.x; i < tail; i += blockDim.x)
    td[i] = ts ? __ldcg(ts + i) : 0;
}

__device__ __forceinline__ uint8_t* space_ptr(int64_t space, uint8_t* x,
                                              uint8_t* y, uint8_t* s) {
  switch (space) {
    case 1: return x;
    case 2: return y;
    case 3: return s;
    default: return nullptr;
  }
}

// state layout (int32): [0] ticket, [1] completed copy nodes,
// [2, 2 + nitems) per-item done flags, then per-node finished-tile counts.
__global__ void __launch_bounds__(THREADS)
multipath_dma_kernel(const int64_t* __restrict__ items, int64_t nitems,
                     uint8_t* x, uint8_t* y, uint8_t* stage, int* state) {
  __shared__ int64_t item_sh;
  int* ticket = state;
  int* completed = state + 1;
  int* flags = state + 2;
  int* node_tiles = flags + nitems;
  while (true) {
    if (threadIdx.x == 0) item_sh = atomicAdd(ticket, 1);
    __syncthreads();
    const int64_t it = item_sh;
    __syncthreads();  // item_sh is rewritten on the next turn
    if (it >= nitems) return;
    const int64_t* row = items + it * ITEM_COLS;
    const int64_t pred = row[C_PRED];
    if (pred >= 0) {
      if (threadIdx.x == 0) {
        while (load_acquire(flags + pred) == 0) __nanosleep(100);
      }
      __syncthreads();
    }
    uint8_t* sbase = space_ptr(row[C_SRC_SPACE], x, y, stage);
    uint8_t* dbase = space_ptr(row[C_DST_SPACE], x, y, stage);
    copy_bytes(dbase + row[C_DST_OFF],
               sbase ? sbase + row[C_SRC_OFF] : nullptr, row[C_NBYTES]);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      store_release(flags + it, 1);
      const int64_t node = row[C_NODE];
      if (node >= 0) {
        const int done = atomicAdd(node_tiles + node, 1) + 1;
        if (done == (int)row[C_NODE_TILES]) atomicAdd(completed, 1);
      }
    }
  }
}

}  // namespace

extern "C" {

int multipath_dma_item_cols() { return ITEM_COLS; }

// Launch on `stream`; returns cudaGetLastError() after the launch.
int multipath_dma_launch(const void* items, int64_t nitems, void* x, void* y,
                         void* stage, void* state, int grid,
                         void* stream) {
  if (nitems > 0 && grid > 0) {
    multipath_dma_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)items, nitems, (uint8_t*)x, (uint8_t*)y,
        (uint8_t*)stage, (int*)state);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
