// Helpers shared by the port's kernels: fp32 <-> storage-type conversion,
// 16-byte vector packs and the reference's LeakyReLU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace calipsync {

// Storage types the wrappers pass; the C entry points take one of these
// codes and instantiate the matching template.
enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float to T's precision and back: the cast points of the JAX
// kernels (``.astype(dtype)`` between stages) kept in fp32 registers.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// LeakyReLU for 0 <= slope <= 1: v for v >= 0, slope * v below.
__device__ __forceinline__ float leaky(float v, float slope) {
  return fmaxf(v, v * slope);
}

// N contiguous elements moved as one load/store (16 bytes when
// N * sizeof(T) == 16).
template <typename T, int N> struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// ------------------------------------------- tensor-core and copy helpers
// The bf16 kernels' building blocks: mma.sync m16n8k16 (bf16 in, fp32
// sum), ldmatrix fragment loads from shared memory and 16-byte cp.async.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// c += a . b for one 16x8x16 tile: a in the m16k16 row fragment, b in the
// k16n8 col fragment, c in the m16n8 fragment (rows g, g+8; cols 2t, 2t+1
// of lane 4g+t).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b for one 16x8x8 tile (a: rows g, g+8 x cols 2t, 2t+1).
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Two 8x8 bf16 matrices; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l%8 of matrix
// l/8 and receives one 32-bit piece of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes global -> shared without passing through registers; zeros
// instead when !valid (src-size 0 reads nothing from src).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 8 bytes global -> shared, zeros when !valid.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 8 : 0));
}

// 4 bytes global -> shared, zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ------------------------------------------------ warpgroup mma (wgmma)
// Hopper's asynchronous matrix multiply: the four warps of a warpgroup
// multiply a 64-row A by an N-column B, both read from shared memory
// through descriptors, into fp32 sums held in registers with the layout
// of four stacked mma.sync m16n8 C fragments (warp w of the group: rows
// 16w .. 16w + 15).

// Element offset of (row r, column c) in the "interleaved" K-major layout
// that wgmma reads without swizzling: 8-row x 8-column (16-byte rows) core
// matrices of 128 contiguous bytes, kcb of them along K per 8 rows.
__host__ __device__ __forceinline__ int core_offset(int r, int c, int kcb) {
  return (((r >> 3) * kcb + (c >> 3)) << 6) + ((r & 7) << 3) + (c & 7);
}

// Shared-memory matrix descriptor, no swizzle: start address, the byte
// step between core matrices along K (lbo) and along M or N (sbo). For the
// K-major layout of core_offset, lbo = 128 and sbo = kcb x 128.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int lbo,
                                               int sbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Pins accumulator registers in place around a wgmma batch, so the
// compiler moves no instruction that touches them into the batch.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed wgmma groups are in
// flight.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Makes this thread's generic-proxy writes to shared memory (stores,
// cp.async) visible to wgmma's reads, once a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 32, fp32) += A (64 x 16) . B (16 x 32), A and B bf16 K-major in
// shared memory.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b));
}

// d (64 x 128, fp32) += A (64 x 16) . B (16 x 128), both K-major in
// shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
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
      : "l"(a), "l"(b));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 in registers: this warp's 16 rows
// as an mma.sync A fragment) . B (16 x 64, N-major in shared memory).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// ------------------------------------------------- TF32, three passes
// fp32 products on the tensor cores at fp32 accuracy: each operand is
// split into a TF32 high part and a TF32 remainder, v ~ hi + lo to about
// 2^-22 of v, and a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi in fp32 sums
// (the lo.lo term, ~2^-22 of the product, is dropped).

// v rounded to TF32 (10 stored mantissa bits) to nearest, ties away from
// zero, as fp32 bits; cvt leaves the 13 low bits undefined, so they are
// cleared.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// c += a . b for one 16x8x8 TF32 tile: a (rows g, g+8 x cols t, t+4) in
// the m16k8 row fragment, b (rows t, t+4 x col g) in the k8n8 col
// fragment, c in the m16n8 fragment.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offset of (row r, column c) in the K-major layout of
// core_offset for 4-byte elements: 8-row x 4-column core matrices of 128
// contiguous bytes, kcb = K / 4 of them along K per 8 rows.
__host__ __device__ __forceinline__ int core_offset4(int r, int c, int kcb) {
  return (((r >> 3) * kcb + (c >> 2)) << 5) + ((r & 7) << 2) + (c & 3);
}

// d (64 x 16, fp32) += A (64 x 8, TF32 in registers: this warp's 16 rows
// as an mma.sync m16n8k8 A fragment) . B (8 x 16, TF32 K-major in shared
// memory).
__device__ __forceinline__ void wgmma_m64n16k8_tf32_rs(float (&d)[8],
                                                       const uint32_t (&a)[4],
                                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x 32, fp32) += A (64 x 8, TF32 in registers) . B (8 x 32, TF32
// K-major in shared memory), as wgmma_m64n16k8_tf32_rs.
__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[16],
                                                       const uint32_t (&a)[4],
                                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The RS TF32 wgmma of N columns (16 or 32).
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  if constexpr (N == 32)
    wgmma_m64n32k8_tf32_rs(d, a, b);
  else
    wgmma_m64n16k8_tf32_rs(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------- TMA and mbarriers
// A tile copied global -> shared by the Tensor Memory Accelerator, its
// arrival counted on an mbarrier in shared memory: one thread arms the
// barrier with the bytes to expect and issues the copy; the threads that
// read the tile wait for the barrier's phase to complete.

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA);
// a __syncthreads() follows before any thread uses them.
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival, and `bytes` more for the phase to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the barrier's phase of parity `parity` has completed. A copy
// that never lands (a bad tensor map) traps after 2^28 polls, seconds,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t polls = 0; !mbar_try_wait(bar, parity); ++polls) {
    if (polls == (1u << 28)) __trap();
  }
}

// The box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory at dst (128-byte aligned), completing on bar. Coordinates
// may lie outside the tensor; those elements arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

}  // namespace calipsync
