// ring_allgather: all-gather of device-stacked shards, each shard read once
// and pushed straight into every replica.
//
// Replaces the Pallas kernel src/repro/kernels/ring_allgather/kernel.py
// (`build_ring_allgather`, body `_ring_ag_kernel`). There, every chip
// copies its shard into its own output slot, then for N-1 steps sends the
// first half of the features of one slot clockwise and the second half of
// another slot counter-clockwise, as two remote DMAs on distinct links: a
// schedule for a TPU torus, where each chip has one link to each
// neighbour. The function is the same here, bit for bit; the schedule is
// not. On one Hopper card every logical device d is a row of the stacked
// input x: (n, rows, f) and owns the replica out[d]: (n, rows, f); across
// cards (NVLink switches: every card reaches every other directly) a ring
// would only chain waits and read back what a card received.
//
// What bounds it: bytes. The function reads each shard once and writes n^2
// blocks, (n + n^2) * S bytes for S = rows * f * itemsize; this kernel
// moves exactly that. Across cards the bytes each card receives bound it:
// (n - 1) * S for each logical device it holds, over its NVLink ingress
// (450 GB/s). There is no arithmetic.
//
// Design:
// * Work items are (source shard b, chunk c): a contiguous range of at most
//   `chunk` bytes of x[b] (a shard is contiguous, S bytes). The item loads
//   it once and stores it into out[d][b] for every d, receivers in the
//   order d = b, b + 1, ... (mod n), so that senders working at the same
//   pace hit distinct receivers. Every destination is contiguous too: the
//   shard's shape (rows, f) shapes no copy, and (rows, 2) shards copy as
//   plainly as wide ones.
// * Vector width, chosen once an item from the OR of the source, every
//   destination and the length: 16 bytes, else 4, else single bytes.
//   When S % 16 != 0 the replicas' block offsets differ, so the OR covers
//   every destination.
// * Each thread issues UNROLL independent loads (through L2, __ldcg)
//   before its n * UNROLL stores; consecutive threads take consecutive
//   vectors.
// * A persistent grid takes items from a ticket (state[0]); no item waits
//   on another, so any grid size completes. state[1] counts completed
//   items: after one launch it equals n * chunks. A graph freezes kernel
//   arguments, so the caller zeroes both words on the same stream before
//   each launch; that zeroing is captured with the launch.
//
// Across cards (ring_allgather_peer_launch): logical device d holds its
// shard x[d]: (rows, f) and its replica out[d]: (n, rows, f) in its own
// memory, on its own card or on a card it shares with others. Each card
// launches once, over the items of its own logical devices, with a space
// table of every logical device's two base pointers (UVA; with peer access
// enabled they point into the other cards), every card's state words and
// the card's own logical devices (`mine`).
// * Copy tickets, m * chunks for m logical devices on the card: item
//   (e, c) for each own device e stores chunk c of x[e] into out[d][e] for
//   every d, in d's memory. Then every thread fences (__threadfence_system
//   when another card holds a receiver, else __threadfence) and thread 0
//   stores the epoch into flag [e * chunks + c] on every card
//   (st.release.sys into another card, st.release.gpu into its own).
//   Copy items never wait.
// * Wait tickets, after every copy ticket: each covers THREADS of the
//   n * chunks flags on the card, one a thread, waited for with
//   ld.acquire.sys. When the card's stream passes its launch, every
//   replica on the card is complete. Since every copy ticket is claimed
//   before any wait ticket and runs to its end, waiting cannot deadlock,
//   whatever the grid; a lost flag traps after 10 s instead of hanging.
// * Epochs, not zeroing: a one-block prologue zeroes the card's ticket and
//   completed count and adds one to its epoch; flags are never zeroed, a
//   writer stores its epoch and a waiter waits for its own. Every card runs
//   its prologue once an execution, so the epochs stay in lockstep, and a
//   flag a fast card sets for this execution cannot be wiped by a slow
//   card's late zeroing. The caller orders executions across cards.
// * state[1] counts the copy items the card completed: summed over the
//   cards, after one execution it equals n * chunks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int UNROLL = 4;

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

struct Gather {
  int64_t n;       // logical devices
  int64_t shard;   // S, bytes of one shard
  int64_t chunk;   // bytes of a chunk (the last one of a shard may be less)
  int64_t chunks;  // chunks of a shard
};

// (b + j) mod n for b, j in [0, n), without a division.
__device__ __forceinline__ int64_t rotate(int64_t b, int64_t j, int64_t n) {
  const int64_t d = b + j;
  return d >= n ? d - n : d;
}

// Receiver j of an item of shard b, on one card: out[(b + j) % n][b] at
// `base` = out + b * S + offset, replicas `step` = n * S bytes apart.
struct StackedDst {
  uint8_t* base;
  int64_t step, b, n;
  __device__ uint8_t* operator()(int64_t j) const {
    return base + rotate(b, j, n) * step;
  }
};

// Receiver j of an item of sender e across cards: logical device
// d = (e + j) % n's replica, block e, at `offset` = e * S + chunk offset.
struct PeerDst {
  const int64_t* outs;  // every logical device's replica base
  int64_t offset, e, n;
  __device__ uint8_t* operator()(int64_t j) const {
    return (uint8_t*)(uintptr_t)outs[rotate(e, j, n)] + offset;
  }
};

// `len` bytes from src to every receiver, in vectors of V (len, src and
// every receiver are multiples of sizeof(V)).
template <typename V, typename Dst>
__device__ __forceinline__ void push_vec(const uint8_t* src, int64_t len,
                                         int64_t n, const Dst& dst) {
  const int nv = (int)(len / (int64_t)sizeof(V));
  const V* s = (const V*)src;
  for (int base = threadIdx.x; base < nv; base += UNROLL * THREADS) {
    V v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS;
      if (i < nv) v[u] = __ldcg(s + i);
    }
    for (int64_t j = 0; j < n; ++j) {
      V* d = (V*)dst(j);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        if (i < nv) d[i] = v[u];
      }
    }
  }
}

template <typename Dst>
__device__ __forceinline__ void push(const uint8_t* src, int64_t len,
                                     int64_t n, const Dst& dst) {
  uintptr_t a = (uintptr_t)src | (uintptr_t)len;
  for (int64_t j = 0; j < n; ++j) a |= (uintptr_t)dst(j);
  if ((a & 15) == 0)
    push_vec<uint4>(src, len, n, dst);
  else if ((a & 3) == 0)
    push_vec<unsigned int>(src, len, n, dst);
  else
    push_vec<unsigned char>(src, len, n, dst);
}

// Thread 0 takes the next ticket from `ticket`; every thread gets it.
__device__ __forceinline__ int64_t claim(int* ticket) {
  __shared__ int64_t item_sh;
  if (threadIdx.x == 0) item_sh = atomicAdd(ticket, 1);
  __syncthreads();
  const int64_t it = item_sh;
  __syncthreads();  // item_sh is rewritten on the next turn
  return it;
}

// state layout (int32): [0] ticket, [1] completed items.
__global__ void __launch_bounds__(THREADS, 2)
ring_allgather_kernel(const uint8_t* __restrict__ x, uint8_t* out, int* state,
                      Gather g) {
  const int64_t nitems = g.n * g.chunks;
  while (true) {
    const int64_t it = claim(state);
    if (it >= nitems) return;
    const int64_t b = it / g.chunks;
    const int64_t off = (it - b * g.chunks) * g.chunk;
    const int64_t len = g.shard - off < g.chunk ? g.shard - off : g.chunk;
    push(x + b * g.shard + off, len, g.n,
         StackedDst{out + b * g.shard + off, g.n * g.shard, b, g.n});
    if (threadIdx.x == 0) atomicAdd(state + 1, 1);
  }
}

// Per-card state words (int32) of the peer form: ticket, completed copy
// items, epoch, one spare, then one flag a (sender, chunk).
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
// this card's logical devices [m].
__global__ void __launch_bounds__(THREADS, 2)
ring_allgather_peer_kernel(const int64_t* __restrict__ tab, Gather g,
                           int64_t ncards, int64_t m, int64_t card,
                           int* state) {
  const int epoch = *(volatile int*)(state + S_EPOCH);
  const int64_t n = g.n;
  const int64_t copies = m * g.chunks;
  const int64_t nflags = n * g.chunks;
  const int64_t ntickets = copies + (nflags + THREADS - 1) / THREADS;
  const int64_t* states = tab + 2 * n;
  const int64_t* mine = states + ncards;
  while (true) {
    const int64_t k = claim(state + S_TICKET);
    if (k >= ntickets) return;
    if (k >= copies) {
      // a wait ticket: one flag a thread
      const int64_t f = (k - copies) * THREADS + threadIdx.x;
      if (f < nflags) wait_epoch(state + S_FLAGS + f, epoch);
      continue;
    }
    const int64_t e = mine[k / g.chunks];
    const int64_t c = k % g.chunks;
    const int64_t off = c * g.chunk;
    const int64_t len = g.shard - off < g.chunk ? g.shard - off : g.chunk;
    push((const uint8_t*)(uintptr_t)tab[e] + off, len, n,
         PeerDst{tab + n, e * g.shard + off, e, n});
    if (ncards > 1)
      __threadfence_system();
    else
      __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int64_t flag = S_FLAGS + e * g.chunks + c;
      for (int64_t r = 0; r < ncards; ++r) {
        int* p = (int*)(uintptr_t)states[r] + flag;
        if (r == card)
          store_release(p, epoch);
        else
          store_release_sys(p, epoch);
      }
      atomicAdd(state + S_COMPLETED, 1);
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream` over the n * chunks items; returns cudaGetLastError()
// after the launch. `state` holds two zeroed int32 words (see the kernel).
int ring_allgather_launch(const void* x, void* out, void* state, int64_t n,
                          int64_t shard, int64_t chunk, int64_t chunks,
                          int grid, void* stream) {
  if (n * chunks > 0 && grid > 0) {
    Gather g{n, shard, chunk, chunks};
    ring_allgather_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, (uint8_t*)out, (int*)state, g);
  }
  return (int)cudaGetLastError();
}

// One card's share of the peer form on `stream`: the prologue (a new
// epoch), then the kernel over the card's m * chunks copy tickets and its
// wait tickets; returns cudaGetLastError() after the launches. `tab` and
// `state` are device arrays (see the kernel).
int ring_allgather_peer_launch(const void* tab, int64_t ncards, int64_t m,
                               int64_t card, int64_t n, int64_t shard,
                               int64_t chunk, int64_t chunks, void* state,
                               int grid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ring_peer_prologue<<<1, 32, 0, s>>>((int*)state);
  if (grid > 0) {
    Gather g{n, shard, chunk, chunks};
    ring_allgather_peer_kernel<<<grid, THREADS, 0, s>>>(
        (const int64_t*)tab, g, ncards, m, card, (int*)state);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
