// Fused stride-1 inverted-residual block, eval mode, BN folded:
//   hid = leaky(x w1 + b1)            -> cast to the compute dtype
//   y   = leaky(dw3x3(hid, kd) + bd)  -> cast   (hid zero-padded at edges)
//   out = leaky(y w2 + b2)            -> cast   [+ x]
// fp32 accumulation throughout.
//
// Replaces: calipsync_tpu/kernels/fused_ir.py, fused_inverted_residual
// (:122, body _ir_kernel :76).
//
// Bound on the H100: memory, once the hidden activation stays on chip. At
// B=128 bf16 the largest call (up4.ir1, 160x160, Cin 64, Ch 128, Cout 32)
// must read 419 MB and write 210 MB (~188 us at 3.35 TB/s) and does
// 88 GFLOP (~89 us at the bf16 tensor-core peak). Unfused, the (B,H,W,Ch)
// hidden tensor would cross device memory about six times.
//
// Both designs keep the hidden on the SM: a block stages one tile of output
// pixels plus a one-pixel halo of x in shared memory once, then walks the
// hidden channels in chunks. For each chunk it computes hid on the haloed
// tile, the depthwise taps on the output pixels, and adds y_chunk . w2[chunk]
// into fp32 accumulators. Casts are per element, so chunking keeps the JAX
// cast points. Halo pixels outside the image are zero in the hidden (the
// depthwise conv zero-pads its input), not leaky(b1), on all four edges.
//
//  - bf16 (serving): an 8x16 tile (10x18 haloed pixels, padded to 192 rows)
//    and chunks of 64 hidden channels. Both 1x1 products run on the tensor
//    cores as mma.sync m16n8k16 (bf16 in, fp32 sum) from shared memory,
//    whose rows are padded by 16 bytes so the fragment loads hit 32
//    distinct banks; the projection's accumulators stay in registers, one
//    warp per tile row. Cout <= 128.
//  - fp32 (the reference-precision path): an 8x8 tile and chunks of 32 on
//    the CUDA cores, accumulators in shared memory.

#include <cstdint>

#include "common.cuh"

namespace calipsync {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------------- fp32
// CUDA-core design: 8x8 output tile, hidden chunks of 32, every product an
// fp32 FMA from shared memory.

namespace fp32_path {
constexpr int kTile = 8;                 // output tile side
constexpr int kHalo = kTile + 2;         // haloed tile side
constexpr int kNP = kHalo * kHalo;       // haloed pixels
constexpr int kNO = kTile * kTile;       // output pixels
constexpr int kChunk = 32;               // hidden channels per pass

size_t smem_bytes(int Cin, int Cout) {
  return sizeof(float) * (static_cast<size_t>(Cin) * kChunk +
                          static_cast<size_t>(kChunk) * Cout +
                          kNP * kChunk + kNO * kChunk +
                          static_cast<size_t>(kNO) * Cout +
                          static_cast<size_t>(kNP) * Cin);
}

__global__ void __launch_bounds__(kThreads)
    kernel(const float* __restrict__ x, const float* __restrict__ w1t,
           const float* __restrict__ b1, const float* __restrict__ kd,
           const float* __restrict__ bd, const float* __restrict__ w2t,
           const float* __restrict__ b2, float* __restrict__ out, int H,
           int W, int Cin, int Ch, int Cout, int residual, float slope) {
  extern __shared__ float smem[];
  float* w1s = smem;                     // Cin x kChunk
  float* w2s = w1s + Cin * kChunk;       // kChunk x Cout
  float* hid = w2s + kChunk * Cout;      // kNP x kChunk
  float* ys = hid + kNP * kChunk;        // kNO x kChunk
  float* acc = ys + kNO * kChunk;        // kNO x Cout
  float* xs = acc + kNO * Cout;          // kNP x Cin

  const int tid = threadIdx.x;
  const int tiles_w = (W + kTile - 1) / kTile;
  const int h0 = (blockIdx.x / tiles_w) * kTile;
  const int w0 = (blockIdx.x % tiles_w) * kTile;
  const long long b = blockIdx.y;

  for (int i = tid; i < kNP * Cin; i += kThreads) {
    const int p = i / Cin, c = i % Cin;
    const int hi = h0 - 1 + p / kHalo, wi = w0 - 1 + p % kHalo;
    xs[i] = (hi >= 0 && hi < H && wi >= 0 && wi < W)
                ? x[((b * H + hi) * W + wi) * Cin + c]
                : 0.f;
  }
  for (int i = tid; i < kNO * Cout; i += kThreads) acc[i] = 0.f;

  for (int c0 = 0; c0 < Ch; c0 += kChunk) {
    const int cc = min(kChunk, Ch - c0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < Cin * kChunk; i += kThreads) {
      const int ci = i / kChunk, j = i % kChunk;
      w1s[i] = j < cc ? w1t[(c0 + j) * Cin + ci] : 0.f;
    }
    for (int i = tid; i < kChunk * Cout; i += kThreads) {
      const int j = i / Cout, o = i % Cout;
      w2s[i] = j < cc ? w2t[o * Ch + c0 + j] : 0.f;
    }
    __syncthreads();

    // expand 1x1 on the haloed tile; zero outside the image
    for (int i = tid; i < kNP * kChunk; i += kThreads) {
      const int p = i / kChunk, j = i % kChunk;
      const int hi = h0 - 1 + p / kHalo, wi = w0 - 1 + p % kHalo;
      float h = 0.f;
      if (j < cc && hi >= 0 && hi < H && wi >= 0 && wi < W) {
        float s = b1[c0 + j];
        const float* xp = xs + p * Cin;
        for (int ci = 0; ci < Cin; ++ci) s += xp[ci] * w1s[ci * kChunk + j];
        h = leaky(s, slope);
      }
      hid[i] = h;
    }
    __syncthreads();

    // depthwise 3x3 on the output pixels
    for (int i = tid; i < kNO * kChunk; i += kThreads) {
      const int p = i / kChunk, j = i % kChunk;
      const int oy = p / kTile, ox = p % kTile;
      float y = 0.f;
      if (j < cc) {
        float s = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            s += hid[((oy + dy) * kHalo + ox + dx) * kChunk + j] *
                 kd[(dy * 3 + dx) * Ch + c0 + j];
        y = leaky(s + bd[c0 + j], slope);
      }
      ys[i] = y;
    }
    __syncthreads();

    // project 1x1, accumulated over the chunks; each thread keeps the
    // same accumulator entries in every chunk and in the epilogue
    for (int i = tid; i < kNO * Cout; i += kThreads) {
      const int p = i / Cout, o = i % Cout;
      float s = acc[i];
      const float* yp = ys + p * kChunk;
      for (int j = 0; j < cc; ++j) s += yp[j] * w2s[j * Cout + o];
      acc[i] = s;
    }
  }

  for (int i = tid; i < kNO * Cout; i += kThreads) {
    const int p = i / Cout, o = i % Cout;
    const int oy = p / kTile, ox = p % kTile;
    const int hi = h0 + oy, wi = w0 + ox;
    if (hi >= H || wi >= W) continue;
    float v = leaky(acc[i] + b2[o], slope);
    if (residual) v += xs[((oy + 1) * kHalo + ox + 1) * Cin + o];
    out[((b * H + hi) * W + wi) * Cout + o] = v;
  }
}
}  // namespace fp32_path

// ---------------------------------------------------------------- bf16
// Tensor-core design: 8x16 output tile, hidden chunks of 64, both 1x1
// products as mma.sync m16n8k16 from padded shared-memory rows.

namespace bf16_path {
constexpr int kTH = 8, kTW = 16;         // output tile (rows x cols)
constexpr int kHW = kTW + 2;             // haloed tile width
constexpr int kNP = (kTH + 2) * kHW;     // haloed pixels (180)
constexpr int kMP = 192;                 // kNP rounded up to 16-row m tiles
constexpr int kNO = kTH * kTW;           // output pixels: one m tile a row
constexpr int kKC = 64;                  // hidden channels per pass
constexpr int kHS = kKC + 8;             // row stride of hs, ys and w2s
static_assert(kNO / 16 == kWarps, "one warp per output row");

// Row stride (elements) of the x tile and of the transposed w1 chunk: Cin
// padded to the mma depth of 16, plus 8 so that rows start 16 bytes apart
// in the bank cycle.
__host__ __device__ inline int x_stride(int Cin) {
  return ((Cin + 15) & ~15) + 8;
}

size_t smem_bytes(int Cin, int nt) {
  const size_t xs_ld = x_stride(Cin);
  return sizeof(bf16) * (kMP * xs_ld + kKC * xs_ld + kMP * kHS + kNO * kHS +
                         static_cast<size_t>(8 * nt) * kHS) +
         sizeof(float) * (9 * kKC + 2 * kKC);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of a 16x16 tile stored row-major with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int g, int t) {
  const bf16* p = tile + g * ld + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment of a 16(k) x 8(n) tile stored as [n][k] with row stride ld.
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const bf16* tile,
                                       int ld, int g, int t) {
  const bf16* p = tile + g * ld + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// c += a . b, 16x8x16, bf16 in, fp32 sum.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows of n elements starting at a 16-byte boundary each.
__device__ __forceinline__ bool aligned16(const bf16* base, int n) {
  return n % 8 == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

// Elements k..k+7 of a row of n (one 16-byte load where the row allows),
// zero past n and where !valid.
__device__ __forceinline__ Pack<bf16, 8> load8(const bf16* row, int k, int n,
                                               bool valid, bool vec) {
  Pack<bf16, 8> v;
  if (valid && vec && k + 8 <= n) {
    v = *reinterpret_cast<const Pack<bf16, 8>*>(row + k);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v.v[e] = valid && k + e < n ? row[k + e] : __float2bfloat16_rn(0.f);
  }
  return v;
}

// NT n tiles of 8 output channels: Cout <= 8 * NT.
template <int NT>
__global__ void __launch_bounds__(kThreads)
    kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1t,
           const float* __restrict__ b1, const bf16* __restrict__ kd,
           const float* __restrict__ bd, const bf16* __restrict__ w2t,
           const float* __restrict__ b2, bf16* __restrict__ out, int H, int W,
           int Cin, int Ch, int Cout, int residual, float slope) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cin_p = (Cin + 15) & ~15;
  const int xs_ld = x_stride(Cin);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // kMP x xs_ld
  bf16* w1s = xs + kMP * xs_ld;                  // kKC x xs_ld, w1 chunk^T
  bf16* hs = w1s + kKC * xs_ld;                  // kMP x kHS, hidden
  bf16* ys = hs + kMP * kHS;                     // kNO x kHS, depthwise out
  bf16* w2s = ys + kNO * kHS;                    // 8*NT x kHS, w2 chunk^T
  float* kds = reinterpret_cast<float*>(w2s + 8 * NT * kHS);  // 9 x kKC
  float* b1s = kds + 9 * kKC;
  float* bds = b1s + kKC;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column
  const int tiles_w = (W + kTW - 1) / kTW;
  const int h0 = (blockIdx.x / tiles_w) * kTH;
  const int w0 = (blockIdx.x % tiles_w) * kTW;
  const long long b = blockIdx.y;

  // The haloed x tile, 8 channels at a time; zero outside the image, past
  // Cin and in the pad rows.
  const int groups = cin_p / 8;
  const bool x_vec = aligned16(x, Cin);
  for (int i = tid; i < kMP * groups; i += kThreads) {
    const int p = i / groups, c = (i % groups) * 8;
    const int hi = h0 - 1 + p / kHW, wi = w0 - 1 + p % kHW;
    const bool inside = p < kNP && hi >= 0 && hi < H && wi >= 0 && wi < W;
    *reinterpret_cast<Pack<bf16, 8>*>(xs + p * xs_ld + c) =
        load8(x + ((b * H + hi) * W + wi) * Cin, c, Cin, inside, x_vec);
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const bool w1_vec = aligned16(w1t, Cin), w2_vec = aligned16(w2t, Ch);
  for (int c0 = 0; c0 < Ch; c0 += kKC) {
    __syncthreads();  // the previous chunk's readers are done
    // the chunk's weights as [n][k] rows, 8 at a time: rows c0.. of w1t
    // and columns c0.. of w2t's rows; zero past Ch, Cin and Cout
    for (int i = tid; i < kKC * groups; i += kThreads) {
      const int j = i / groups, k = (i % groups) * 8;
      *reinterpret_cast<Pack<bf16, 8>*>(w1s + j * xs_ld + k) =
          load8(w1t + static_cast<long long>(c0 + j) * Cin, k, Cin,
                c0 + j < Ch, w1_vec);
    }
    for (int i = tid; i < 8 * NT * (kKC / 8); i += kThreads) {
      const int o = i / (kKC / 8), j = (i % (kKC / 8)) * 8;
      *reinterpret_cast<Pack<bf16, 8>*>(w2s + o * kHS + j) =
          load8(w2t + static_cast<long long>(o) * Ch, c0 + j, Ch, o < Cout,
                w2_vec);
    }
    for (int i = tid; i < 9 * kKC; i += kThreads) {
      const int j = i % kKC;
      kds[i] = c0 + j < Ch ? to_float(kd[(i / kKC) * Ch + c0 + j]) : 0.f;
    }
    for (int j = tid; j < kKC; j += kThreads) {
      b1s[j] = c0 + j < Ch ? b1[c0 + j] : 0.f;
      bds[j] = c0 + j < Ch ? bd[c0 + j] : 0.f;
    }
    __syncthreads();

    // expand 1x1 on the haloed tile: a unit is one m tile x 4 n tiles
    for (int u = warp; u < (kMP / 16) * (kKC / 32); u += kWarps) {
      const int m0 = (u >> 1) * 16, n0 = (u & 1) * 32;
      float c[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
      for (int k0 = 0; k0 < cin_p; k0 += 16) {
        uint32_t a[4];
        load_a(a, xs + m0 * xs_ld + k0, xs_ld, g, t);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t bf[2];
          load_b(bf, w1s + (n0 + n * 8) * xs_ld + k0, xs_ld, g, t);
          mma_bf16(c[n], a, bf);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = m0 + g + half * 8;
        const int hi = h0 - 1 + p / kHW, wi = w0 - 1 + p % kHW;
        const bool inside =
            p < kNP && hi >= 0 && hi < H && wi >= 0 && wi < W;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int j = n0 + n * 8 + 2 * t;
          float v0 = 0.f, v1 = 0.f;
          if (inside) {
            v0 = leaky(c[n][2 * half] + b1s[j], slope);
            v1 = leaky(c[n][2 * half + 1] + b1s[j + 1], slope);
          }
          *reinterpret_cast<__nv_bfloat162*>(hs + p * kHS + j) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();

    // depthwise 3x3 + bias + leaky on the output pixels, 2 channels a thread
    for (int i = tid; i < kNO * (kKC / 2); i += kThreads) {
      const int q = i / (kKC / 2), j = (i % (kKC / 2)) * 2;
      const int oy = q / kTW, ox = q % kTW;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float2 h = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  hs + ((oy + dy) * kHW + ox + dx) * kHS + j));
          const float* k = kds + (dy * 3 + dx) * kKC + j;
          s0 += h.x * k[0];
          s1 += h.y * k[1];
        }
      *reinterpret_cast<__nv_bfloat162*>(ys + q * kHS + j) =
          __floats2bfloat162_rn(leaky(s0 + bds[j], slope),
                                leaky(s1 + bds[j + 1], slope));
    }
    __syncthreads();

    // project 1x1: warp w owns output row w of the tile (one m tile)
#pragma unroll
    for (int k0 = 0; k0 < kKC; k0 += 16) {
      uint32_t a[4];
      load_a(a, ys + warp * 16 * kHS + k0, kHS, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bf[2];
        load_b(bf, w2s + n * 8 * kHS + k0, kHS, g, t);
        mma_bf16(acc[n], a, bf);
      }
    }
  }

  // epilogue: bias, leaky, cast [+ x]; fragment rows g and g+8 are output
  // columns, fragment columns are output channels
  const int hi = h0 + warp;
  if (hi >= H) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ox = g + half * 8, wi = w0 + ox;
    if (wi >= W) continue;
    bf16* op = out + ((b * H + hi) * W + wi) * Cout;
    const bf16* xr = xs + ((warp + 1) * kHW + ox + 1) * xs_ld;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = n * 8 + 2 * t + e;
        if (o >= Cout) continue;
        float v = round_to<bf16>(leaky(acc[n][2 * half + e] + b2[o], slope));
        if (residual) v += to_float(xr[o]);
        op[o] = from_float<bf16>(v);
      }
  }
}
}  // namespace bf16_path

// n tiles the bf16 kernel instance uses for Cout; 0 when Cout > 128.
int pick_nt(int Cout) {
  return Cout <= 32 ? 4 : Cout <= 64 ? 8 : Cout <= 128 ? 16 : 0;
}

size_t smem_bytes(int Cin, int Cout, int dtype) {
  return dtype == kBFloat16 ? bf16_path::smem_bytes(Cin, pick_nt(Cout))
                            : fp32_path::smem_bytes(Cin, Cout);
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int NT>
int launch_bf16(const void* x, const void* w1t, const void* b1,
                const void* kd, const void* bd, const void* w2t,
                const void* b2, void* out, int B, int H, int W, int Cin,
                int Ch, int Cout, int residual, float slope,
                cudaStream_t stream) {
  using namespace bf16_path;
  const size_t smem = smem_bytes(Cin, NT);
  const cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(&kernel<NT>), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), B);
  kernel<NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1t),
      static_cast<const float*>(b1), static_cast<const bf16*>(kd),
      static_cast<const float*>(bd), static_cast<const bf16*>(w2t),
      static_cast<const float*>(b2), static_cast<bf16*>(out), H, W, Cin, Ch,
      Cout, residual, slope);
  return launch_status();
}

int launch_fp32(const void* x, const void* w1t, const void* b1,
                const void* kd, const void* bd, const void* w2t,
                const void* b2, void* out, int B, int H, int W, int Cin,
                int Ch, int Cout, int residual, float slope,
                cudaStream_t stream) {
  using namespace fp32_path;
  const size_t smem = smem_bytes(Cin, Cout);
  const cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(&kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile), B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1t),
      static_cast<const float*>(b1), static_cast<const float*>(kd),
      static_cast<const float*>(bd), static_cast<const float*>(w2t),
      static_cast<const float*>(b2), static_cast<float*>(out), H, W, Cin, Ch,
      Cout, residual, slope);
  return launch_status();
}

}  // namespace
}  // namespace calipsync

// Bytes of dynamic shared memory the kernel asks for at these widths; -1
// when the bf16 kernel does not take this Cout (> 128).
extern "C" long long calipsync_fused_ir_smem(int Cin, int Cout, int dtype) {
  using namespace calipsync;
  if (dtype == kBFloat16 && pick_nt(Cout) == 0) return -1;
  return static_cast<long long>(smem_bytes(Cin, Cout, dtype));
}

// x (B,H,W,Cin), out (B,H,W,Cout), w1t (Ch,Cin), kd (9,Ch), w2t (Cout,Ch)
// in `dtype`; b1, bd (Ch,) and b2 (Cout,) fp32; all contiguous. w1t and
// w2t are the block's w1 and w2 transposed, so each chunk's weights are
// contiguous rows. Returns the launch status (0 = cudaSuccess).
extern "C" int calipsync_fused_ir(const void* x, const void* w1t,
                                  const void* b1, const void* kd,
                                  const void* bd, const void* w2t,
                                  const void* b2, void* out, int dtype, int B,
                                  int H, int W, int Cin, int Ch, int Cout,
                                  int residual, float slope, void* stream) {
  using namespace calipsync;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_fp32(x, w1t, b1, kd, bd, w2t, b2, out, B, H, W, Cin, Ch, Cout,
                       residual, slope, s);
  if (dtype == kBFloat16) {
    switch (pick_nt(Cout)) {
      case 4:
        return launch_bf16<4>(x, w1t, b1, kd, bd, w2t, b2, out, B, H, W, Cin,
                              Ch, Cout, residual, slope, s);
      case 8:
        return launch_bf16<8>(x, w1t, b1, kd, bd, w2t, b2, out, B, H, W, Cin,
                              Ch, Cout, residual, slope, s);
      case 16:
        return launch_bf16<16>(x, w1t, b1, kd, bd, w2t, b2, out, B, H, W, Cin,
                               Ch, Cout, residual, slope, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
