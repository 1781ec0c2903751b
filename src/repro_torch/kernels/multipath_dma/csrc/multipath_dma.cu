// multipath_dma: execute one scheduled transfer graph, one launch a card.
//
// Replaces the Pallas kernel src/repro/kernels/multipath_dma/kernel.py
// (`build_multipath_dma`, body `_multipath_dma_kernel`), which runs one
// TransferPlan as remote DMAs between chips with semaphore waits for the
// hop edges. Two layouts of the logical devices:
// * stacked: every logical device is a row of one operand on one card
//   (x, y and stage passed directly, `peer` null), so a copy node is a
//   memory-to-memory copy inside one card;
// * per device: each logical device has its own operand, output and
//   staging buffer, on its own card or on a card it shares with others.
//   `peer` holds every logical device's three base pointers (UVA; with
//   peer access enabled they point into the other cards) and every
//   card's state words. Each card launches once, over the items it
//   executes: a direct or hop-1 tile runs on the message's src, a hop-2
//   tile on its via (the reference's push roles: `my == src` starts hop
//   1, `my == via` waits and starts hop 2, Alg. 2 line 19). A card that
//   receives a terminal tile written by another card runs a wait item on
//   that tile's flag (the reference's `wait_recv`), so when dst's stream
//   passes its launch, its output is complete.
//
// What bounds it: bytes. Every byte of the node table is read once and
// written once (fills write only): on one card (bytes read + written) /
// 3.35 TB/s of HBM; across cards the bytes dst receives over NVLink /
// 450 GB/s, dst's ingress, which every path into dst shares. There is no
// arithmetic.
//
// Why registers and not the Tensor Memory Accelerator: every item's bytes
// go through registers (16-byte vectors when source and destination agree
// mod 16; else 4-byte words or single bytes; the head and tail by bytes).
// A design that moved each item's 16-byte-aligned body through a ring of
// shared-memory stages with bulk loads and bulk stores, one thread issuing
// them, was measured on four H100s (PERF.md §6 has the design, its fences
// and its readings): it tied on a single-path send, where both push dst's
// ingress as far as SM stores go, short of the copy engines' rate; it
// gained little on one card; and it lost on the planner's three-path plan,
// whatever its ring, grid and tiles, most of it in the bulk-stored
// cross-card tiles. So the payload stays in registers.
//
// Design:
// * The host builds a work table (int64, ITEM_COLS columns per row) from
//   the SCHEDULED graph: fill items (outputs that are not a destination,
//   zeroed or copied from the input), then every copy node cut into tiles
//   of at most a few hundred KiB, in the graph's index order. Index order
//   is topological: every hop edge points forward. A card's table keeps
//   its copies in that order, spreads its fills evenly among its copy
//   tiles into other cards (so a src's fill of its own output, HBM writes,
//   runs under its NVLink-bound sends instead of before them; on one card
//   the fills stay first), and ends with its wait items.
// * A persistent grid of blocks takes items one at a time from a global
//   atomic ticket, in table order. An item is claimed only by a block that
//   is already running, and its predecessor has a lower index, so the
//   predecessor was claimed earlier by a running block: waiting on it
//   cannot deadlock, whatever the grid size. Across cards the same holds
//   for the lowest unfinished item of all cards, since every card's
//   launch runs at once.
// * Hop edges are flags. An item that waits (C_WAIT) reads a flag word in
//   its own card's state with acquire semantics; the item it waits on
//   publishes (C_SIG_CARD, C_SIG_IDX) after a fence, with a release
//   store: at gpu scope when the flag is on its own card, at system scope
//   (`__threadfence_system` + `st.release.sys`) when it is on another.
//   A waiter spins with `__nanosleep` and traps after 10 s: a lost flag is
//   an error, not a hang. Why each fence: every thread of the block wrote
//   part of the tile, and only thread 0 stores the flag, so every thread
//   fences at the flag's scope (its own stores ordered before anything it
//   does next, at a scope that reaches the waiter's card) and the barrier
//   after it hands that order to thread 0, whose release store then
//   follows every thread's bytes. On the waiter's side thread 0's acquire
//   load orders its reads after the flag, and the barrier after the wait
//   hands that order to the block's other threads before they read.
// * Flags are never zeroed. A one-block prologue launched before the main
//   kernel zeroes the card's ticket and counters and adds one to its
//   replay epoch; writers store their epoch and waiters wait for their
//   own. Every card of a program runs its prologue once per execution, so
//   the epochs stay in lockstep, and a flag another card writes early for
//   the same execution cannot be wiped by a late zeroing. The caller
//   orders executions across cards (events), so no card starts execution
//   k + 1 while another is still in k.
// * No barrier between the fill and the copies (the Pallas kernel's global
//   barrier after its init copy): fill regions and terminal copy regions
//   are disjoint by the graph's disjoint-cover invariant (DESIGN.md §4.5);
//   per device, a destination's output is covered exactly by its terminal
//   tiles and only the other devices fill. Window edges order replay
//   rounds only; every round has its own output row and staging slots.
// * Copies take a 16-byte vector path when source and destination share
//   their alignment mod 16 (head and tail done by single bytes), a 4-byte
//   path when they share it mod 4, else single bytes. Chunk offsets are
//   only element-aligned. All offsets are 64-bit.
// * state[1] counts the copy nodes the card completed: summed over the
//   cards, after one execution it equals the graph's copy-node count (the
//   equal-graph law).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ITEM_COLS = 14;
// item columns
constexpr int C_SRC_SPACE = 0;   // 0 zero, 1 input, 2 output, 3 staging
constexpr int C_SRC_OFF = 1;
constexpr int C_DST_SPACE = 2;
constexpr int C_DST_OFF = 3;
constexpr int C_NBYTES = 4;
// column 5: the predecessor item in the whole table (host-side only)
constexpr int C_NODE = 6;        // copy node index, or -1
constexpr int C_NODE_TILES = 7;  // tiles of that copy node
constexpr int C_SRC_DEV = 8;     // logical device of the source space
constexpr int C_DST_DEV = 9;     // logical device of the destination space
// column 10: the logical device that executes the item (host-side only)
constexpr int C_WAIT = 11;       // flag of this card to wait on, or -1
constexpr int C_SIG_CARD = 12;   // card whose flag this item sets, or -1
constexpr int C_SIG_IDX = 13;    // that flag's index

// state words (int32) of one card
constexpr int S_TICKET = 0;
constexpr int S_COMPLETED = 1;
constexpr int S_EPOCH = 2;
constexpr int S_NFLAGS = 3;      // written once by the host
constexpr int S_FLAGS = 4;       // flags, then per-node finished tiles

constexpr int THREADS = 512;
constexpr int UNROLL = 4;
constexpr unsigned long long SPIN_LIMIT_NS = 10000000000ull;

__device__ __forceinline__ int load_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ int load_acquire_sys(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release_gpu(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void store_release_sys(int* p, int v) {
  asm volatile("st.release.sys.global.b32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

// Spin until the flag reaches `epoch` (wrap-safe); trap after 10 s.
__device__ void wait_flag(const int* flag, int epoch, bool sys) {
  uint64_t start = 0;
  while (true) {
    const int v = sys ? load_acquire_sys(flag) : load_acquire_gpu(flag);
    if ((int)((unsigned)v - (unsigned)epoch) >= 0) return;
    __nanosleep(100);
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (start == 0)
      start = now;
    else if (now - start > SPIN_LIMIT_NS)
      __trap();
  }
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

// Base of byte space `space` of logical device `dev`: from the per-device
// table when there is one, else the stacked buffers.
__device__ __forceinline__ uint8_t* space_ptr(int64_t space, int64_t dev,
                                              const uint64_t* peer,
                                              uint8_t* x, uint8_t* y,
                                              uint8_t* s) {
  if (space < 1 || space > 3) return nullptr;
  if (peer != nullptr) return (uint8_t*)peer[dev * 3 + space - 1];
  return space == 1 ? x : (space == 2 ? y : s);
}

__global__ void multipath_dma_prologue(int* state, int64_t nstate) {
  if (threadIdx.x == 0) {
    state[S_TICKET] = 0;
    state[S_COMPLETED] = 0;
    state[S_EPOCH] += 1;
  }
  const int64_t first = S_FLAGS + state[S_NFLAGS];
  for (int64_t i = first + threadIdx.x; i < nstate; i += blockDim.x)
    state[i] = 0;
}

// peer: null (stacked), or 3 base pointers per logical device (input,
// output, staging) followed by one state pointer per card; `card` is this
// launch's card in that list.
__global__ void __launch_bounds__(THREADS)
multipath_dma_kernel(const int64_t* __restrict__ items, int64_t nitems,
                     uint8_t* x, uint8_t* y, uint8_t* stage,
                     const uint64_t* __restrict__ peer, int ndev, int card,
                     int* state) {
  __shared__ int64_t item_sh;
  int* ticket = state + S_TICKET;
  int* completed = state + S_COMPLETED;
  int* flags = state + S_FLAGS;
  int* node_tiles = flags + state[S_NFLAGS];
  const int epoch = *(volatile int*)(state + S_EPOCH);
  const bool sys = peer != nullptr;
  while (true) {
    if (threadIdx.x == 0) item_sh = atomicAdd(ticket, 1);
    __syncthreads();
    const int64_t it = item_sh;
    __syncthreads();  // item_sh is rewritten on the next turn
    if (it >= nitems) return;
    const int64_t* row = items + it * ITEM_COLS;
    const int64_t wait = row[C_WAIT];
    if (wait >= 0) {
      if (threadIdx.x == 0) wait_flag(flags + wait, epoch, sys);
      __syncthreads();
    }
    uint8_t* sbase = space_ptr(row[C_SRC_SPACE], row[C_SRC_DEV], peer, x, y,
                               stage);
    uint8_t* dbase = space_ptr(row[C_DST_SPACE], row[C_DST_DEV], peer, x, y,
                               stage);
    copy_bytes(dbase + row[C_DST_OFF],
               sbase ? sbase + row[C_SRC_OFF] : nullptr, row[C_NBYTES]);
    const int64_t sig = row[C_SIG_CARD];
    const bool remote = peer != nullptr && sig != card;
    if (sig >= 0) {
      if (remote)
        __threadfence_system();
      else
        __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      if (sig >= 0) {
        int* target = peer ? (int*)peer[3 * (int64_t)ndev + sig] : state;
        int* flag = target + S_FLAGS + row[C_SIG_IDX];
        if (remote)
          store_release_sys(flag, epoch);
        else
          store_release_gpu(flag, epoch);
      }
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

// The prologue, then the kernel over `nitems` items, on `stream`; returns
// cudaGetLastError() after the launches. `peer` is a device array (see
// the kernel) or null for the stacked layout.
int multipath_dma_launch(const void* items, int64_t nitems, void* x, void* y,
                         void* stage, const void* peer, int ndev, int card,
                         void* state, int64_t nstate, int grid,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  multipath_dma_prologue<<<1, 256, 0, s>>>((int*)state, nstate);
  if (nitems > 0 && grid > 0) {
    multipath_dma_kernel<<<grid, THREADS, 0, s>>>(
        (const int64_t*)items, nitems, (uint8_t*)x, (uint8_t*)y,
        (uint8_t*)stage, (const uint64_t*)peer, ndev, card, (int*)state);
  }
  return (int)cudaGetLastError();
}

// Enable peer access between every pair of the `n` distinct devices
// `devs`. Returns 0, cudaErrorPeerAccessUnsupported when a pair cannot
// reach each other, or the CUDA error of a failed call. The calling
// thread's current device is restored.
int multipath_dma_enable_peers(int n, const int* devs) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      if (i == j) continue;
      int can = 0;
      err = cudaDeviceCanAccessPeer(&can, devs[i], devs[j]);
      if (err != cudaSuccess) return (int)err;
      if (!can) {
        cudaSetDevice(prev);
        return (int)cudaErrorPeerAccessUnsupported;
      }
      err = cudaSetDevice(devs[i]);
      if (err != cudaSuccess) return (int)err;
      err = cudaDeviceEnablePeerAccess(devs[j], 0);
      if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();  // clear the error it left behind
      } else if (err != cudaSuccess) {
        cudaSetDevice(prev);
        return (int)err;
      }
    }
  }
  err = cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"
