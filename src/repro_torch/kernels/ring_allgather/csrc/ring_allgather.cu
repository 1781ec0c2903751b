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
// Across cards the bytes each card receives bound it: (n - 1) * S for each
// logical device it holds, over its NVLink ingress (450 GB/s).
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
//
// Across cards (ring_allgather_peer_launch): logical device d holds its
// shard x[d]: (rows, f) and its replica out[d]: (n, rows, f) in its own
// memory, on its own card or on a card it shares with others. Each card
// launches once, over the items it executes, with a space table of every
// logical device's two base pointers (UVA; with peer access enabled they
// point into the other cards), every card's state words, every logical
// device's card and the card's own logical devices (`mine`).
// * Push, as the reference's remote DMA: item (p, d, dir, tile), p > 0,
//   runs on the card of the sender sd (d - 1 clockwise, d + 1 counter-
//   clockwise) and stores out[sd][b] into out[d][b], in d's memory. Its
//   successor, item (p + 1, d + 1 or d - 1, dir, tile), runs on d's card
//   and reads d's own memory: every read is local. Phase 0 runs on d's
//   own card.
// * A card's items, in ticket order: phase-major, then its own logical
//   devices (as senders; as receivers in phase 0), direction and tile, so
//   every phase has m * ndir * tiles items for m logical devices on the
//   card; after phase n - 1 a wait-only phase n on every last-phase tile
//   that the card's devices receive, so that when the card's stream passes
//   its launch, its replicas are complete. An item waits only on an item
//   of the previous phase, and every card's launch runs at once (the
//   caller orders executions across cards): the lowest unfinished phase
//   always progresses, so waiting cannot deadlock. One card that holds
//   several logical devices runs them all from one launch, in that order.
// * Flags live on the waiter's card: item (p, d, dir, tile) sets flag
//   [its global index] in the state of d's card, the card that runs its
//   successor and the final wait. Across cards the signal is
//   __threadfence_system() then st.release.sys; on the same card
//   __threadfence() then st.release.gpu; waits read with ld.acquire.sys
//   and trap after 10 s: a lost flag is an error, not a hang.
// * Epochs, not zeroing: a one-block prologue zeroes the card's ticket and
//   completed count and adds one to its epoch; flags are never zeroed, a
//   writer stores its epoch and a waiter waits for its own. Every card runs
//   its prologue once an execution, so the epochs stay in lockstep, and a
//   flag a fast card sets for this execution cannot be wiped by a slow
//   card's late zeroing. The caller orders executions across cards.
// * state[1] counts the copy items the card completed: summed over the
//   cards, after one execution it equals n_items.

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

__device__ __forceinline__ int load_acquire_sys(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release_sys(int* p, int v) {
  asm volatile("st.release.sys.global.b32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

constexpr unsigned long long SPIN_LIMIT_NS = 10000000000ull;

// Spin until the flag reaches `epoch` (wrap-safe); trap after 10 s.
__device__ void wait_epoch(const int* flag, int epoch) {
  uint64_t start = 0;
  while (true) {
    const int v = load_acquire_sys(flag);
    if ((int)((unsigned)v - (unsigned)epoch) >= 0) return;
    __nanosleep(64);
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (start == 0)
      start = now;
    else if (now - start > SPIN_LIMIT_NS)
      __trap();
  }
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

// Per-card state words (int32) of the peer form: ticket, completed copy
// items, epoch, one spare, then one flag a global item.
constexpr int S_TICKET = 0;
constexpr int S_COMPLETED = 1;
constexpr int S_EPOCH = 2;
constexpr int S_FLAGS = 4;

__global__ void ring_peer_prologue(int* state) {
  if (threadIdx.x == 0) {
    state[S_TICKET] = 0;
    state[S_COMPLETED] = 0;
    state[S_EPOCH] += 1;
  }
}

// tab (int64): x pointers [n], out pointers [n], state pointers [ncards],
// card of each logical device [n], this card's logical devices [m].
__global__ void __launch_bounds__(THREADS)
ring_allgather_peer_kernel(const int64_t* __restrict__ tab, Ring g,
                           int64_t ncards, int64_t m, int64_t card,
                           int* state) {
  __shared__ int64_t item_sh;
  const int epoch = *(volatile int*)(state + S_EPOCH);
  const int64_t n = g.n;
  const int64_t tiles = g.rtiles * g.ctiles;
  const int64_t per_phase = m * g.ndir * tiles;
  const int64_t ntickets = (n + 1) * per_phase;
  const int64_t stride = g.f * g.isz;
  const int64_t* card_of = tab + 2 * n + ncards;
  const int64_t* mine = card_of + n;
  while (true) {
    if (threadIdx.x == 0) item_sh = atomicAdd(state + S_TICKET, 1);
    __syncthreads();
    const int64_t k = item_sh;
    __syncthreads();  // item_sh is rewritten on the next turn
    if (k >= ntickets) return;
    // decode (phase, own logical device e, direction, tile)
    const int64_t p = k / per_phase;
    const int64_t r = k - p * per_phase;
    const int64_t t = r % tiles;
    const int64_t q = r / tiles;
    const int64_t dir = q % g.ndir;
    const int64_t e = mine[q / g.ndir];
    if (p == n) {
      // wait for the last-phase tile that e receives
      const int64_t last = (((n - 1) * n + e) * g.ndir + dir) * tiles + t;
      if (threadIdx.x == 0) wait_epoch(state + S_FLAGS + last, epoch);
      continue;
    }
    // the receiver d (e itself in phase 0; else e sends to d) and the
    // block b the copy carries
    const int64_t d = p == 0 ? e : (dir ? (e + n - 1) % n : (e + 1) % n);
    const int64_t b = p == 0 ? d : (dir ? (d + p) % n : (d + n - p) % n);
    const int64_t it = ((p * n + d) * g.ndir + dir) * tiles + t;
    if (p > 0) {
      // the predecessor wrote out[e][b]: its flag is on this card
      const int64_t pred = (((p - 1) * n + e) * g.ndir + dir) * tiles + t;
      if (threadIdx.x == 0) wait_epoch(state + S_FLAGS + pred, epoch);
      __syncthreads();
    }
    const int64_t rt = t / g.ctiles;
    const int64_t ct = t % g.ctiles;
    const int64_t lo = dir ? g.half : 0;
    const int64_t width = dir ? g.f - g.half : g.half;
    const int64_t c0 = ct * g.cc;
    const int64_t r0 = rt * g.rpt;
    const int64_t nr = g.rows - r0 < g.rpt ? g.rows - r0 : g.rpt;
    const int64_t w = c0 >= width ? 0 : (width - c0 < g.cc ? width - c0
                                                            : g.cc);
    if (w > 0 && nr > 0) {
      const int64_t col = (lo + c0) * g.isz;
      uint8_t* dst = (uint8_t*)(uintptr_t)tab[n + d] +
                     (b * g.rows + r0) * stride + col;
      const uint8_t* src =
          p == 0 ? (const uint8_t*)(uintptr_t)tab[d] + r0 * stride + col
                 : (const uint8_t*)(uintptr_t)tab[n + e] +
                       (b * g.rows + r0) * stride + col;
      copy_rows(dst, src, nr, w * g.isz, stride);
    }
    const int64_t rc = card_of[d];
    const bool remote = rc != card;
    if (remote)
      __threadfence_system();
    else
      __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      int* flag = (int*)(uintptr_t)tab[2 * n + rc] + S_FLAGS + it;
      if (remote)
        store_release_sys(flag, epoch);
      else
        store_release(flag, epoch);
      atomicAdd(state + S_COMPLETED, 1);
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

// One card's share of the peer form on `stream`: the prologue (a new
// epoch), then the kernel over the card's (n + 1) * m * ndir * tiles
// tickets; returns cudaGetLastError() after the launches. `tab` and
// `state` are device arrays (see the kernel).
int ring_allgather_peer_launch(const void* tab, int64_t ncards, int64_t m,
                               int64_t card, int64_t n, int64_t rows,
                               int64_t f, int64_t isz, int64_t half,
                               int64_t ndir, int64_t rpt, int64_t cc,
                               int64_t rtiles, int64_t ctiles, void* state,
                               int grid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ring_peer_prologue<<<1, 32, 0, s>>>((int*)state);
  if (grid > 0) {
    Ring g{n, rows, f, isz, half, ndir, rpt, cc, rtiles, ctiles};
    ring_allgather_peer_kernel<<<grid, THREADS, 0, s>>>(
        (const int64_t*)tab, g, ncards, m, card, (int*)state);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
