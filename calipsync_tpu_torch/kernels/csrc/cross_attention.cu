// Spatial cross-attention forward: out = softmax(q k^T) v, no 1/sqrt(d)
// scaling, fp32 scores, fp32 probabilities, fp32 accumulation, result in
// v's dtype.
//
// Replaces: calipsync_tpu/kernels/cross_attention.py, _attention_fwd_pallas
// (:55, body _attention_kernel :36), reached via cross_attention (:97).
// Forward only: the backward is plain PyTorch products
// (kernels/cross_attention.py), as the JAX backward is plain XLA.
//
// Bound on the H100: memory. On the serving path q,k are (B,100,64) and v
// (B,100,512); at B=128 bf16 the call must read q, k and v once and write
// out once, 29.5 MB (8.8 us at 3.35 TB/s), and does 1.47 GFLOP (1.5 us at
// the bf16 tensor-core peak). Keeping p at fp32 precision doubles p.v's
// tensor work (below).
//
// bf16 (the serving path): one block of two warpgroups per (image, 128
// query rows); on the serving path N = 100, so one block per image. q and
// k are read once: 16-byte cp.async into 8 x 8 core matrices, and the
// scores against a block of 128 (padded) keys come from one wgmma
// m64n128k16 chain per warpgroup (query rows 64 wg ..), in fp32 registers;
// a product of two bf16 values is exact in fp32, so they equal the fp32
// scores up to the order of the sum. Padded key columns are -inf, as in
// the Pallas body. Softmax runs on those registers (row max and sum by
// quad shuffles), and e = exp(s - max) is split into e_hi = bf16(e) and
// e_lo = bf16(e - e_hi) as register A fragments (FlashAttention-2's reuse
// of the score layout): e keeps ~16 bits (relative error <= 2^-16), as the
// Pallas body's fp32 p does, not the 8 of a bf16 p. v then streams through
// in 64-column slabs, four tiles in flight by cp.async: each slab is two
// wgmma m64n64k16 per 16 keys (e_hi and e_lo against the same v, read
// N-major from shared memory) into one fp32 accumulator, divided by the
// row sum, staged in shared memory and written with 16-byte coalesced
// stores. With N <= 128 the probabilities are computed once and stay in
// registers for every slab, and each image's q, k and v are read from
// device memory exactly once. With N > 128 a slab walks the key blocks
// with a running row max and sum (the sums so far rescaled when the max
// rises), recomputing each block's probabilities; each query tile then
// reads all of k and v. Rows that are not 16-byte aligned (D or C not a
// multiple of 8) take scalar loads and stores.
//
// fp32 (what `infer` and `serve` run by default, at B=8): the CUDA
// cores. One block of 256 threads per (image, 16 query rows); K as fp32 in
// shared memory, one warp per row for scores and softmax, p kept fp32 and
// transposed, V streamed through shared memory in chunks of 32 rows.

#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace calipsync {
namespace {

using bf16 = __nv_bfloat16;

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Max and sum over the 4 lanes of a quad (the lanes holding one row of an
// mma fragment).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Raise a kernel's dynamic shared memory limit to `smem` bytes on the
// current device, once: `limit` holds what was set, one slot a device.
// cudaFuncSetAttribute is not a stream operation, so it must not run
// while a CUDA graph is being captured; a capture's warm-up launch at the
// same size sets it, and the captured launch then calls nothing.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t ensure_smem(Kernel kernel, size_t smem, int* limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int* set = dev < kMaxDevices ? &limit[dev] : nullptr;
  if (set && static_cast<int>(smem) <= *set) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess && set) *set = static_cast<int>(smem);
  return e;
}

// ------------------------------------------------------------ bf16: wgmma

namespace bf16_path {
constexpr int kThreads = 256;   // two warpgroups: a tile's rows 0-63, 64-127
constexpr int kRows = 128;      // query rows per block
constexpr int kKeys = 128;      // keys per key block: the scores' wgmma N
constexpr int kSlab = 64;       // v columns per pass
constexpr int kLO = kSlab + 8;  // row stride of the staged output
constexpr int kStages = 4;      // v tiles in flight

__host__ __device__ inline int key_blocks(int N) {
  return (N + kKeys - 1) / kKeys;
}

// q (the block's kRows query rows) and k (every key block), core matrices
// of dp columns; kStages v tiles (kKeys keys x kSlab columns, core matrices
// with columns contiguous); the output rows of a slab.
size_t smem_bytes(int N, int D) {
  const size_t dp = round16(D);
  return sizeof(bf16) *
         ((kRows + static_cast<size_t>(key_blocks(N)) * kKeys) * dp +
          kStages * kKeys * kSlab + kRows * kLO);
}

// v rows j0 .. j0 + kKeys - 1, columns c0 .. c0 + kSlab - 1 of an image
// into a tile buffer, zero past N and C.
__device__ void stage_v(bf16* vs, const bf16* __restrict__ vb, int N, int C,
                        int j0, int c0, bool vec) {
  const int cw = min(kSlab, C - c0);
  if (vec) {
    for (int i = threadIdx.x; i < kKeys * (kSlab / 8); i += kThreads) {
      const int r = i / (kSlab / 8), c = (i % (kSlab / 8)) * 8;
      const bool ok = j0 + r < N && c < cw;
      const long long off =
          ok ? static_cast<long long>(j0 + r) * C + c0 + c : 0;
      cp_async16(vs + core_offset(r, c, kSlab / 8), vb + off, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kKeys * kSlab; i += kThreads) {
      const int r = i / kSlab, c = i % kSlab;
      vs[core_offset(r, c, kSlab / 8)] =
          j0 + r < N && c < cw
              ? vb[static_cast<long long>(j0 + r) * C + c0 + c]
              : __float2bfloat16_rn(0.f);
    }
  }
}

// Probabilities of a warpgroup's 64 query rows (qw; lane rows g and g + 8
// of each warp's 16) against the key block at key0. The scores come from
// one wgmma m64n128k16 chain, keys >= N at -inf. The running row max m is
// raised to cover them, and the running sum l is rescaled to it (the
// factor goes to rescale, for the p.v sums so far). e = exp(s - m) is
// added to l and split into bf16 A
// fragments, hi = bf16(e) and lo = bf16(e - hi); k step kk holds keys
// key0 + 16 kk ...
__device__ __forceinline__ void probabilities(
    uint32_t (&hi)[8][4], uint32_t (&lo)[8][4], float (&m)[2], float (&l)[2],
    float (&rescale)[2], const bf16* qw, const bf16* ks, int kcb, int key0,
    int N, int t) {
  float sc[64];  // n8 block j: keys key0 + 8j + 2t (+1), rows g (e < 2), g+8
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  fence_operands(sc);
  wgmma_fence();
  for (int kk = 0; kk < kcb; kk += 2)
    wgmma_m64n128k16(
        sc, wgmma_desc(qw + core_offset(0, 8 * kk, kcb), 128, 128 * kcb),
        wgmma_desc(ks + core_offset(key0, 8 * kk, kcb), 128, 128 * kcb));
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(sc);
  const float neg_inf = __int_as_float(0xff800000);
  float b0 = -FLT_MAX, b1 = -FLT_MAX;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (key0 + 8 * j + 2 * t + (e & 1) >= N) sc[4 * j + e] = neg_inf;
      if (e < 2)
        b0 = fmaxf(b0, sc[4 * j + e]);
      else
        b1 = fmaxf(b1, sc[4 * j + e]);
    }
  // every key block holds a key < N, so the new max is finite
  const float m0 = fmaxf(m[0], quad_max(b0)), m1 = fmaxf(m[1], quad_max(b1));
  rescale[0] = __expf(m[0] - m0);
  rescale[1] = __expf(m[1] - m1);
  m[0] = m0;
  m[1] = m1;
  float l0 = l[0] * rescale[0], l1 = l[1] * rescale[1];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = __expf(sc[4 * j + e] - (e < 2 ? m0 : m1));
      sc[4 * j + e] = x;
      if (e < 2)
        l0 += x;
      else
        l1 += x;
    }
  l[0] = l0;
  l[1] = l1;
  // A fragments of k step kk: score blocks 2 kk and 2 kk + 1
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e0 = sc[4 * (2 * kk + (i >> 1)) + 2 * (i & 1)];
      const float e1 = sc[4 * (2 * kk + (i >> 1)) + 2 * (i & 1) + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(e0, e1);
      hi[kk][i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][i] = pack_bf16(e0 - __low2float(h), e1 - __high2float(h));
    }
}

// kKeyBlocks: N > kKeys, so the probabilities do not stay in registers and
// are recomputed for each slab, one key block at a time.
template <bool kKeyBlocks>
__global__ void __launch_bounds__(kThreads, 1)
    kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ out, int N, int D,
           int C, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dp = round16(D), kcb = dp / 8;
  const int nkb = kKeyBlocks ? key_blocks(N) : 1;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // K-major core matrices
  bf16* ks = qs + kRows * dp;
  bf16* vbuf = ks + nkb * kKeys * dp;            // kStages v tiles
  bf16* os = vbuf + kStages * kKeys * kSlab;     // kRows x kLO

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // warp-uniform
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;
  const long long b = blockIdx.y;
  const int r0 = blockIdx.x * kRows, rows = min(kRows, N - r0);
  const bf16* qb = q + (b * N + r0) * D;
  const bf16* kb = k + b * N * D;
  const bf16* vb = v + b * N * C;
  bf16* ob = out + (b * N + r0) * C;
  // work unit u: slab u / nkb (kSlab v columns) against key block u % nkb
  const int nslabs = (C + kSlab - 1) / kSlab, units = nslabs * nkb;

  // q and k, then the first kStages v tiles: all in flight at once
  if (vec) {
    for (int i = tid; i < kRows * kcb; i += kThreads) {
      const int r = i / kcb, c = (i % kcb) * 8;
      const bool ok = r < rows && c < D;
      const long long off = ok ? static_cast<long long>(r) * D + c : 0;
      cp_async16(qs + core_offset(r, c, kcb), qb + off, ok);
    }
    for (int i = tid; i < nkb * kKeys * kcb; i += kThreads) {
      const int r = i / kcb, c = (i % kcb) * 8;
      const bool ok = r < N && c < D;
      const long long off = ok ? static_cast<long long>(r) * D + c : 0;
      cp_async16(ks + core_offset(r, c, kcb), kb + off, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = tid; i < kRows * dp; i += kThreads) {
      const int r = i / dp, c = i % dp;
      qs[core_offset(r, c, kcb)] = r < rows && c < D ? qb[r * D + c] : zero;
    }
    for (int i = tid; i < nkb * kKeys * dp; i += kThreads) {
      const int r = i / dp, c = i % dp;
      ks[core_offset(r, c, kcb)] = r < N && c < D ? kb[r * D + c] : zero;
    }
  }
  cp_async_commit();
  for (int u = 0; u < kStages; ++u) {
    if (u < units)
      stage_v(vbuf + u * kKeys * kSlab, vb, N, C, (u % nkb) * kKeys,
              (u / nkb) * kSlab, vec);
    cp_async_commit();
  }
  cp_async_wait<kStages>();
  fence_proxy_async();
  __syncthreads();  // q and k are in

  // warpgroup wg takes the tile's query rows 64 wg .. 64 wg + 63
  const bool active = 64 * wg < rows;
  const bf16* qw = qs + core_offset(64 * wg, 0, kcb);
  uint32_t hi[8][4], lo[8][4];
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, rescale[2], inv[2];
  // one key block: the probabilities and the rows' 1 / sum once, for every
  // slab, while the first v tiles are in flight
  if (!kKeyBlocks && active) {
    probabilities(hi, lo, m, l, rescale, qw, ks, kcb, 0, N, t);
    inv[0] = 1.f / quad_sum(l[0]);
    inv[1] = 1.f / quad_sum(l[1]);
  }

  // p . v slab by slab and, within a slab, key block by key block (unit
  // u), the next kStages - 1 v tiles streaming in
  const int r = 64 * wg + 16 * wq + g;
  for (int sl = 0, u = 0; sl < nslabs; ++sl) {
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    if (kKeyBlocks) {
      m[0] = m[1] = -FLT_MAX;
      l[0] = l[1] = 0.f;
    }
    for (int kbk = 0; kbk < nkb; ++kbk, ++u) {
      const int key0 = kbk * kKeys;
      bf16* vs = vbuf + (u % kStages) * kKeys * kSlab;
      cp_async_wait<kStages - 1>();
      fence_proxy_async();
      __syncthreads();  // tile u is in; the previous slab's stores are done
      if (active) {
        if (kKeyBlocks) {
          probabilities(hi, lo, m, l, rescale, qw, ks, kcb, key0, N, t);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[4 * j] *= rescale[0];
            o[4 * j + 1] *= rescale[0];
            o[4 * j + 2] *= rescale[1];
            o[4 * j + 3] *= rescale[1];
          }
        }
        fence_operands(o);
        wgmma_fence();
        const int nks = (min(kKeys, N - key0) + 15) / 16;  // steps with keys
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if (kk >= nks) break;
          const uint64_t bv = wgmma_desc(
              vs + core_offset(16 * kk, 0, kSlab / 8), 128 * (kSlab / 8), 128);
          wgmma_m64n64k16_rs(o, hi[kk], bv);
          wgmma_m64n64k16_rs(o, lo[kk], bv);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(o);
        if (kbk == nkb - 1) {
          if (kKeyBlocks) {
            inv[0] = 1.f / quad_sum(l[0]);
            inv[1] = 1.f / quad_sum(l[1]);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            *reinterpret_cast<uint32_t*>(os + r * kLO + 8 * j + 2 * t) =
                pack_bf16(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
            *reinterpret_cast<uint32_t*>(os + (r + 8) * kLO + 8 * j + 2 * t) =
                pack_bf16(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
          }
        }
      }
      __syncthreads();  // vs is read (and, at the last key block, the
                        // slab's rows are staged)
      const int un = u + kStages;
      if (un < units)
        stage_v(vs, vb, N, C, (un % nkb) * kKeys, (un / nkb) * kSlab, vec);
      cp_async_commit();
    }
    const int c0 = sl * kSlab, cw = min(kSlab, C - c0);
    if (vec) {
      for (int i = tid; i < rows * (kSlab / 8); i += kThreads) {
        const int rr = i / (kSlab / 8), c = (i % (kSlab / 8)) * 8;
        if (c < cw)
          *reinterpret_cast<Pack<bf16, 8>*>(
              ob + static_cast<long long>(rr) * C + c0 + c) =
              *reinterpret_cast<const Pack<bf16, 8>*>(os + rr * kLO + c);
      }
    } else {
      for (int i = tid; i < rows * cw; i += kThreads) {
        const int rr = i / cw, c = i % cw;
        ob[static_cast<long long>(rr) * C + c0 + c] = os[rr * kLO + c];
      }
    }
  }
  cp_async_wait<0>();
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int N, int D, int C, cudaStream_t stream) {
  const auto fn = N > kKeys ? kernel<true> : kernel<false>;
  const size_t smem = smem_bytes(N, D);
  static int limit[2][kMaxDevices] = {};
  const cudaError_t e = ensure_smem(fn, smem, limit[N > kKeys]);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = D % 8 == 0 && C % 8 == 0 && a16(q) && a16(k) && a16(v) &&
                  a16(out);
  fn<<<dim3((N + kRows - 1) / kRows, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), N, D, C, vec);
  return launch_status();
}
}  // namespace bf16_path

// ---------------------------------------------------------------- fp32

namespace fp32_path {
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                // query rows per block
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kCols = 2;                 // output columns per thread per pass
constexpr int kCTile = kThreads * kCols; // output columns per pass
constexpr int kVRows = 32;               // V rows staged per step
constexpr int kPT = kRows + 4;           // row stride of p^T: 16-byte rows

size_t smem_bytes(int N, int D) {
  return sizeof(float) * (kVRows * kCTile +
                          static_cast<size_t>(N) * (D + 1) + kRows * D +
                          static_cast<size_t>(kRows) * N +
                          static_cast<size_t>(N) * kPT);
}

__global__ void __launch_bounds__(kThreads)
    kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out, int N,
           int D, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the two buffers read in 16-byte pieces first, at 16-byte offsets
  float* vsh = reinterpret_cast<float*>(smem_raw);  // kVRows x kCTile
  float* pt = vsh + kVRows * kCTile;        // N x kPT
  const int ks = D + 1;                     // padded K row stride
  float* ksh = pt + N * kPT;                // N x ks
  float* qsh = ksh + N * ks;                // kRows x D
  float* psh = qsh + kRows * D;             // kRows x N, scores

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* kb = k + static_cast<long long>(b) * N * D;
  for (int i = tid; i < N * D; i += kThreads)
    ksh[(i / D) * ks + (i % D)] = kb[i];
  const float* qb = q + (static_cast<long long>(b) * N + r0) * D;
  for (int i = tid; i < rows * D; i += kThreads) qsh[i] = qb[i];
  __syncthreads();

  // scores and softmax, one warp per row
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (r >= rows) break;
    const float* qr = qsh + r * D;
    float* pr = psh + r * N;
    float m = -FLT_MAX;
    for (int j = lane; j < N; j += 32) {
      const float* kj = ksh + j * ks;
      float e = 0.f;
      for (int d = 0; d < D; ++d) e += qr[d] * kj[d];
      pr[j] = e;
      m = fmaxf(m, e);
    }
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      s += e;
    }
    for (int o = 16; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    const float inv = 1.f / s;
    for (int j = lane; j < N; j += 32) pt[j * kPT + r] = pr[j] * inv;
  }
  for (int i = tid; i < N * (kRows - rows); i += kThreads)
    pt[(i / (kRows - rows)) * kPT + rows + i % (kRows - rows)] = 0.f;

  // out[r, c] = sum_j p[r, j] v[j, c]
  constexpr int kVec = 4;
  const float* vb = v + static_cast<long long>(b) * N * C;
  const bool vec =
      C % kVec == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  float* ob = out + (static_cast<long long>(b) * N + r0) * C;
  for (int c_base = 0; c_base < C; c_base += kCTile) {
    const int cw = min(kCTile, C - c_base);
    float acc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[r][i] = 0.f;
    for (int j0 = 0; j0 < N; j0 += kVRows) {
      const int jr = min(kVRows, N - j0);
      __syncthreads();  // p is written; the previous chunk's readers done
      if (vec) {
        const int per_row = cw / kVec;
        for (int i = tid; i < jr * per_row; i += kThreads) {
          const int r = i / per_row, c = (i % per_row) * kVec;
          *reinterpret_cast<float4*>(vsh + r * kCTile + c) =
              *reinterpret_cast<const float4*>(
                  vb + static_cast<long long>(j0 + r) * C + c_base + c);
        }
      } else {
        for (int i = tid; i < jr * cw; i += kThreads) {
          const int r = i / cw, c = i % cw;
          vsh[r * kCTile + c] =
              vb[static_cast<long long>(j0 + r) * C + c_base + c];
        }
      }
      __syncthreads();
      for (int jj = 0; jj < jr; ++jj) {
        float vv[kCols];
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          const int c = i * kThreads + tid;
          vv[i] = c < cw ? vsh[jj * kCTile + c] : 0.f;
        }
        const float4* pj =
            reinterpret_cast<const float4*>(pt + (j0 + jj) * kPT);
#pragma unroll
        for (int r4 = 0; r4 < kRows / 4; ++r4) {
          const float4 p = pj[r4];
#pragma unroll
          for (int i = 0; i < kCols; ++i) {
            acc[4 * r4][i] += p.x * vv[i];
            acc[4 * r4 + 1][i] += p.y * vv[i];
            acc[4 * r4 + 2][i] += p.z * vv[i];
            acc[4 * r4 + 3][i] += p.w * vv[i];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = c_base + i * kThreads + tid;
      if (c >= C) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) ob[static_cast<long long>(r) * C + c] = acc[r][i];
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int N, int D, int C, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, D);
  if (smem > 48 * 1024) {
    static int limit[kMaxDevices] = {};
    const cudaError_t e = ensure_smem(kernel, smem, limit);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((N + kRows - 1) / kRows, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), N, D, C);
  return launch_status();
}
}  // namespace fp32_path

}  // namespace
}  // namespace calipsync

// Bytes of dynamic shared memory the kernel asks for at these sizes.
extern "C" long long calipsync_cross_attention_smem(int N, int D,
                                                    int dtype) {
  using namespace calipsync;
  if (dtype != kBFloat16)
    return static_cast<long long>(fp32_path::smem_bytes(N, D));
  return static_cast<long long>(bf16_path::smem_bytes(N, D));
}

// q,k (B,N,D), v and out (B,N,C), all in `dtype`, contiguous.
// Returns the launch status (0 = cudaSuccess).
extern "C" int calipsync_cross_attention(const void* q, const void* k,
                                         const void* v, void* out, int dtype,
                                         int B, int N, int D, int C,
                                         void* stream) {
  using namespace calipsync;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return bf16_path::launch(q, k, v, out, B, N, D, C, s);
  if (dtype == kFloat32) return fp32_path::launch(q, k, v, out, B, N, D, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
