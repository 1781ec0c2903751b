// hopper_tiles.cuh: the Hopper building blocks that the attention kernels
// share (flash_attention.cu's forward and flash_attention_bwd.cu's
// backward): mbarrier and TMA wrappers, warpgroup `wgmma` products with
// their shared-memory descriptors, the swizzled 64-row tiles both kernels
// load, and the host-side tensor-map encoder.
//
// Head dims. The kernels are built at a padded width DP (16, 32, 64, 128,
// or 192) and take the true head dim d at run time: a
// tile holds 64 rows x DP bf16, of which TMA fills the first d columns
// from device memory (the tensor map's extent is d) and writes zeros into
// the rest. A product that contracts over d runs KS = ceil(d / 16) k-steps
// and loses nothing; a product whose N is the head dim runs at N = DP and
// wastes DP / d of its work (1.6x at d = 80, 1.14x at 112); stores write
// the first d columns only. So every d that is a multiple of 8 up to 128
// runs, and 192 (`head_dims`; kernel.py's `check_head_dim` states the
// rule for the wrappers).
//
// Tiles of 64 rows x DP bf16 arrive by TMA in the 128-byte swizzle (64- or
// 32-byte for DP = 32, 16), as DP / SWE column blocks of 64 rows x SW
// bytes. One tile serves both operand roles: read with `kmajor_desc` it is
// an A or B operand whose contraction runs over d (Q K^T, K Q^T, dO V^T,
// V dO^T); read with `vmajor_desc` it is the transposed ("MN-major") B
// operand whose contraction runs over its 64 rows (P V, P^T dO, dS^T Q,
// dS K).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Waits for phase `parity` of a barrier. A load that never lands traps
// after 10 s (the launch then fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (start == 0)
      start = now;
    else if (now - start > 10000000000ull)
      __trap();
  }
}

// One TMA tile load of a 4-D map at (d, row, head, batch), completing on
// `bar` with the box's bytes (rows past the map's extent arrive as zeros).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from touching accumulator registers across a
// wgmma.wait_group: every use after it depends on this.
template <int N>
__device__ __forceinline__ void reg_fence(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (in 16-byte units) and the swizzle mode
// (1: 128-byte, 2: 64-byte, 3: 32-byte).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)mode << 62);
}

// D(64 x N, float32) (+)= A(64 x 16) . B(16 x N), both from shared memory,
// both K-major; scale_d = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d);

// D(64 x N, float32) += P(64 x 16, bf16 fragments in registers) .
// B(16 x N) from shared memory, transposed ("MN-major": N contiguous).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The tensor-core kernels' tiles at padded width DP. Each tile of R rows
// is DP / SWE column blocks of R rows x SW bytes, in the SW-byte swizzle
// that TMA writes and the descriptors read, starting on a 1024-byte
// boundary. At DP = 128 a forward block takes 82,944 bytes of shared
// memory, so two blocks (two warpgroups) share an SM; at DP = 192 it takes
// 123,904, one block an SM.
template <int DP>
struct Tiles {
  static_assert(DP == 16 || DP == 32 || DP == 64 || DP == 128 || DP == 192,
                "padded head dim");
  static constexpr int ROWS = 64;    // query rows per block: one warpgroup
  static constexpr int KEYS = 64;    // keys per K/V tile (as many as ROWS)
  static constexpr int STAGES = 2;   // K/V ring
  static constexpr int THREADS = 128;
  static constexpr int SW = DP * 2 < 128 ? DP * 2 : 128;  // bytes per row
  static constexpr int SWE = SW / 2;                       // values per row
  static constexpr int CB = DP / SWE;                      // column blocks
  static constexpr uint32_t MODE = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr int Q_TILE = ROWS * DP * 2;
  static constexpr int KV_TILE = KEYS * DP * 2;
  static constexpr int OUT_ROW = (DP + 8) * 2;  // padded output row, bytes
  static constexpr size_t SMEM =
      1024 + Q_TILE + 2 * STAGES * (size_t)KV_TILE;
  static_assert(ROWS == 64 && KEYS == 64, "64-row tiles throughout");
  static_assert(ROWS * OUT_ROW <= Q_TILE + KV_TILE,
                "output staging fits over Q and stage 0's K");
};

template <int V>
using Int = std::integral_constant<int, V>;

// Calls fn(Int<DP>(), Int<KS>()) for head dim d: DP the padded width a
// tensor-core kernel is built at, KS = ceil(d / 16) the k-steps of a
// product that contracts over d. d is a multiple of 8 up to 128, or 192;
// any other d returns cudaErrorInvalidValue.
template <typename Fn>
int head_dims(int64_t d, Fn fn) {
  if (d >= 8 && d % 8 == 0) {
    switch ((d + 15) / 16) {
      case 1: return fn(Int<16>(), Int<1>());
      case 2: return fn(Int<32>(), Int<2>());
      case 3: return fn(Int<64>(), Int<3>());
      case 4: return fn(Int<64>(), Int<4>());
      case 5: return fn(Int<128>(), Int<5>());
      case 6: return fn(Int<128>(), Int<6>());
      case 7: return fn(Int<128>(), Int<7>());
      case 8: return fn(Int<128>(), Int<8>());
      case 12:
        if (d == 192) return fn(Int<192>(), Int<12>());
        break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The same for the float32 kernels on the CUDA cores: fn(Int<DP>()) with
// DP the least of 16, 32, 64, 80, 112, 128 and 192 that holds d (192
// only for d = 192); the columns past d are staged as zeros.
template <typename Fn>
int f32_head_dims(int64_t d, Fn fn) {
  if (d < 8 || d % 8) return (int)cudaErrorInvalidValue;
  if (d <= 16) return fn(Int<16>());
  if (d <= 32) return fn(Int<32>());
  if (d <= 64) return fn(Int<64>());
  if (d <= 80) return fn(Int<80>());
  if (d <= 112) return fn(Int<112>());
  if (d <= 128) return fn(Int<128>());
  if (d == 192) return fn(Int<192>());
  return (int)cudaErrorInvalidValue;
}

// K-major descriptor (Q as A, K as B of Q K^T) of k-step kk: 16 values
// of d. The stride offset steps over groups of 8 rows; a k-step inside a
// swizzled row moves the start address by its 32 bytes.
template <int DP>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using T = Tiles<DP>;
  constexpr int steps = T::SWE / 16;  // k-steps per column block
  const uint32_t addr = tile + (kk / steps) * (64 * T::SW) + (kk % steps) * 32;
  return make_desc(addr, 16, 8 * T::SW, T::MODE);
}

// MN-major descriptor (V as B of P V) of k-step kk: 16 keys. The leading
// offset steps over column blocks (SWE values of d), the stride offset
// over groups of 8 keys.
template <int DP>
__device__ __forceinline__ uint64_t vmajor_desc(uint32_t tile, int kk) {
  using T = Tiles<DP>;
  return make_desc(tile + kk * 16 * T::SW, T::KEYS * T::SW, 8 * T::SW,
                   T::MODE);
}

// Loads the 64-row tile at (row, head, batch) of `map` into `dst`: every
// column block, those past the map's extent d as zeros.
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          int row, int head, int batch,
                                          uint32_t bar) {
  using T = Tiles<DP>;
#pragma unroll
  for (int cb = 0; cb < T::CB; ++cb)
    tma_load(dst + cb * 64 * T::SW, map, cb * T::SWE, row, head, batch, bar);
}

// Issues S(64 x KEYS) = Q K^T for the Q tile at q_tile and the K tile at
// k_tile, KS k-steps of 16 values of d, as one commit group.
template <int DP, int KS>
__device__ __forceinline__ void issue_scores(float* s, uint32_t q_tile,
                                             uint32_t k_tile) {
  using T = Tiles<DP>;
  static_assert(KS >= 1 && 16 * KS <= DP, "k-steps within the tile");
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss<T::KEYS>(s, kmajor_desc<DP>(q_tile, kk),
                      kmajor_desc<DP>(k_tile, kk), kk > 0);
  wgmma_commit();
}

// Issues O(64 x DP) += P V for P's fragments p[KEYS / 16][4] and the V
// tile at v_tile, as one commit group.
template <int DP>
__device__ __forceinline__ void issue_values(float* o, uint32_t (*p)[4],
                                             uint32_t v_tile) {
  using T = Tiles<DP>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::KEYS / 16; ++kk)
    wgmma_rs<DP>(o, p[kk], vmajor_desc<DP>(v_tile, kk));
  wgmma_commit();
}

// cuTensorMapEncodeTiled, a driver-API function, through the runtime's
// entry-point query (no link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)ptr;
  }
  return fn;
}

// A 4-D bf16 map over (d, seq, heads, batch) with element strides
// (position, head, batch), read in boxes of SWE values x 64 rows; columns
// d .. DP - 1 of a tile lie past the extent and arrive as zeros. A
// dimension of extent 1 gets a stride the map accepts: it is never
// stepped.
template <int DP>
bool make_map(CUtensorMap* map, const void* base, int64_t d, int64_t seq,
              int64_t heads, int64_t batch, int64_t ss, int64_t sh,
              int64_t sb) {
  using T = Tiles<DP>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  if (seq == 1) ss = d;
  if (heads == 1) sh = seq * d;
  if (batch == 1) sb = heads * seq * d;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)seq,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::SWE, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The bit of the calling thread's current device (devices 0-63). A
// kernel's shared-memory attribute holds on the device it was set on, so
// each launcher sets it once a device, recording the devices in a mask.
inline unsigned long long device_bit() {
  int dev = 0;
  cudaGetDevice(&dev);
  return 1ull << (dev & 63);
}

}  // namespace
