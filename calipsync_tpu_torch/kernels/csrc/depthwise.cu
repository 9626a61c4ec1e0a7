// Depthwise 3x3 conv + folded BatchNorm + LeakyReLU, NHWC, pad 1,
// stride 1 or 2, fp32 accumulation, then acc * scale + bias in fp32, the
// LeakyReLU and one cast to x's dtype.
//
// Replaces: calipsync_tpu/kernels/depthwise.py, both depthwise3x3 (:88,
// haloed H tiles by manual DMA) and depthwise3x3_blocked (:193, a whole
// plane per program). They are two TPU tilings of one op, so one kernel
// serves both.
//
// Bound on the H100: memory. Nine multiply-adds per input element read,
// about 4.5 operations per bf16 byte, against ~295 operations per byte
// before the card's arithmetic (989 TFLOP/s bf16 over 3.35 TB/s) would be
// the limit, so tensor cores have nothing to add: the time is the bytes.
// At B=128 bf16 the largest call, (128,160,160,64) stride 2, reads 419 MB
// and writes 105 MB: ~156 us at 3.35 TB/s.
//
// bf16 with C a multiple of 8 and 16-byte-aligned tensors (every launch of
// the generator): dw3x3_tma_kernel. The host planner of
// kernels/depthwise.py (plan_tiles) picks its tiling per shape.
//  - A tile is one image, tile_h x tile_w output pixels and a slab of up
//    to 64 channels (128 bytes, the TMA box's inner extent). One thread
//    loads its haloed input box, ((tile_h-1)*s+3) x ((tile_w-1)*s+3)
//    pixels x slab channels, with one cp.async.bulk.tensor through a 4-D
//    tensor map over NHWC. The box starts at row and column -1; TMA fills
//    what lies outside the image with zeros, which is the pad 1 at both
//    strides, so no thread tests a border. Completion arrives on an
//    mbarrier.
//  - Persistent blocks (a few an SM) walk a contiguous run of tiles, slab
//    outermost, through a ring of 2-4 stages: while the block computes one
//    tile, the next ones' loads are in flight.
//  - A thread owns one 8-channel group (16 bytes) of one output column and
//    walks a run of rows down it. Its 9x8 taps live in fp32 registers,
//    loaded once per slab. Each input row is read from shared memory once
//    (three 16-byte reads, one per tap column), converted once and added
//    into every output row it feeds (three rolling accumulators at stride
//    1, two at stride 2). A quarter warp reads one pixel's 128 contiguous
//    bytes, so the reads have no bank conflicts at either stride.
//  - Outputs leave as 16-byte stores straight from registers (a warp
//    writes 4 pixels x 128 bytes). All index math is 32-bit, done once per
//    tile, but for the tile's 64-bit output base.
// The tensor map is encoded on the host per (pointer, shape, box) and
// cached; it reaches the kernel as a __grid_constant__ parameter.
//
// Everything else (fp32, C not a multiple of 8, unaligned pointers):
// dw3x3_kernel, one thread per (output pixel, group of VEC channels) over
// a grid-stride loop, each tap one vector load through L1/L2.

#include <cuda.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace calipsync {
namespace {

template <typename T, int VEC>
__global__ void dw3x3_kernel(const T* __restrict__ x,
                             const float* __restrict__ taps,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias,
                             T* __restrict__ out, int B, int H, int W, int C,
                             int Ho, int Wo, int stride, float slope) {
  const int groups = C / VEC;
  const long long total = static_cast<long long>(B) * Ho * Wo * groups;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int g = static_cast<int>(idx % groups);
    long long p = idx / groups;
    const int wo = static_cast<int>(p % Wo);
    p /= Wo;
    const int ho = static_cast<int>(p % Ho);
    const int b = static_cast<int>(p / Ho);
    const int c0 = g * VEC;

    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;

#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int hi = ho * stride - 1 + dy;
      if (hi < 0 || hi >= H) continue;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int wi = wo * stride - 1 + dx;
        if (wi < 0 || wi >= W) continue;
        const Pack<T, VEC> xv = *reinterpret_cast<const Pack<T, VEC>*>(
            x + ((static_cast<long long>(b) * H + hi) * W + wi) * C + c0);
        const float* k = taps + (dy * 3 + dx) * C + c0;
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += to_float(xv.v[v]) * k[v];
      }
    }

    Pack<T, VEC> ov;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      ov.v[v] = from_float<T>(
          leaky(acc[v] * scale[c0 + v] + bias[c0 + v], slope));
    }
    *reinterpret_cast<Pack<T, VEC>*>(
        out + ((static_cast<long long>(b) * Ho + ho) * Wo + wo) * C + c0) = ov;
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* taps, const void* scale,
            const void* bias, void* out, int B, int H, int W, int C, int Ho,
            int Wo, int stride, float slope, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * Ho * Wo * (C / VEC);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  const long long max_blocks = 132LL * 64;  // grid-stride beyond this
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  dw3x3_kernel<T, VEC><<<static_cast<int>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(taps),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), B, H, W, C, Ho, Wo, stride, slope);
}

// ------------------------------------------------- the bf16 TMA kernel

constexpr int kTmaThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may ask for

// The tiling of one launch (kernels/depthwise.py, plan_tiles): tiles are
// numbered slab-major, ((slab * images + b) * tiles_h + ty) * tiles_w + tx.
struct TileGrid {
  int tile_h, tile_w, segments, slab, stages;
  int tiles_h, tiles_w, images, tiles;
};

__device__ __forceinline__ void unpack8(const uint4& v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void fma8(float (&a)[8], const float (&x)[8],
                                     const float (&k)[8]) {
#pragma unroll
  for (int v = 0; v < 8; ++v) a[v] = fmaf(x[v], k[v], a[v]);
}

// acc * scale + bias, LeakyReLU, bf16, one 16-byte store.
__device__ __forceinline__ void emit(const float (&a)[8],
                                     const float* __restrict__ scale,
                                     const float* __restrict__ bias,
                                     float slope, __nv_bfloat16* o) {
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(scale) + 1);
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias) + 1);
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  uint4 r;
  r.x = pack_bf16(leaky(a[0] * s[0] + b[0], slope),
                  leaky(a[1] * s[1] + b[1], slope));
  r.y = pack_bf16(leaky(a[2] * s[2] + b[2], slope),
                  leaky(a[3] * s[3] + b[3], slope));
  r.z = pack_bf16(leaky(a[4] * s[4] + b[4], slope),
                  leaky(a[5] * s[5] + b[5], slope));
  r.w = pack_bf16(leaky(a[6] * s[6] + b[6], slope),
                  leaky(a[7] * s[7] + b[7], slope));
  *reinterpret_cast<uint4*>(o) = r;
}

// One thread's run of `rows` output rows at stride 1. `in` points at its
// group in box row 0, column 0 of its taps; `pix` is the bytes a pixel
// takes in the box, `row` a box row. Input row y feeds output rows y-2,
// y-1 and y (taps dy 2, 1, 0): a0, a1, a2 roll down as the rows go by.
// The row is read twice: once to finish a0, which leaves at once, then to
// add into a1 and start a2; so a2 is not yet live while a0's epilogue
// holds scale and bias, and the thread stays within 128 registers.
__device__ __forceinline__ void run_s1(const unsigned char* in, int pix,
                                       int row, int rows,
                                       const float (&w)[9][8],
                                       const float* scale, const float* bias,
                                       float slope, __nv_bfloat16* o,
                                       int out_row) {
  float a0[8], a1[8], a2[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) a0[v] = a1[v] = 0.f;
  for (int y = 0; y < rows + 2; ++y, in += row) {
    if (y >= 2) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float x[8];
        unpack8(*reinterpret_cast<const uint4*>(in + dx * pix), x);
        fma8(a0, x, w[6 + dx]);
      }
      emit(a0, scale, bias, slope, o);
      o += out_row;
    }
    const bool d0 = y < rows, d1 = y >= 1 && y <= rows;
#pragma unroll
    for (int v = 0; v < 8; ++v) a2[v] = 0.f;
    if (d0 || d1) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float x[8];
        unpack8(*reinterpret_cast<const uint4*>(in + dx * pix), x);
        if (d1) fma8(a1, x, w[3 + dx]);
        if (d0) fma8(a2, x, w[dx]);
      }
    }
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      a0[v] = a1[v];
      a1[v] = a2[v];
    }
  }
}

// The same at stride 2: output row k takes input rows 2k, 2k+1, 2k+2.
// q gathers output row k, p waits for its last row (2k+2 = the next even
// row, tap dy 2).
__device__ __forceinline__ void run_s2(const unsigned char* in, int pix,
                                       int row, int rows,
                                       const float (&w)[9][8],
                                       const float* scale, const float* bias,
                                       float slope, __nv_bfloat16* o,
                                       int out_row) {
  float p[8], q[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) p[v] = 0.f;
  for (int k = 0; k <= rows; ++k, in += 2 * row) {
    const bool more = k < rows, last = k >= 1;
#pragma unroll
    for (int v = 0; v < 8; ++v) q[v] = 0.f;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float x[8];
      unpack8(*reinterpret_cast<const uint4*>(in + dx * pix), x);
      if (more) fma8(q, x, w[dx]);
      if (last) fma8(p, x, w[6 + dx]);
    }
    if (last) {
      emit(p, scale, bias, slope, o);
      o += out_row;
    }
    if (more) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float x[8];
        unpack8(*reinterpret_cast<const uint4*>(in + row + dx * pix), x);
        fma8(q, x, w[3 + dx]);
      }
#pragma unroll
      for (int v = 0; v < 8; ++v) p[v] = q[v];
    }
  }
}

// Shared memory of a launch: the stages' boxes (each rounded to 128
// bytes, TMA's alignment), then one mbarrier a stage.
__host__ __device__ inline int tma_smem(const TileGrid& g, int S,
                                        uint32_t* stage_bytes = nullptr) {
  const uint32_t box = ((g.tile_h - 1) * S + 3) * ((g.tile_w - 1) * S + 3) *
                       g.slab * 2;
  const uint32_t stage = (box + 127) & ~127u;
  if (stage_bytes) *stage_bytes = stage;
  return g.stages * (stage + 8);
}

template <int S>
__global__ void __launch_bounds__(kTmaThreads, 2)
    dw3x3_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const float* __restrict__ taps,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int Ho, int Wo, int C,
                     const TileGrid g, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int box_h = (g.tile_h - 1) * S + 3, box_w = (g.tile_w - 1) * S + 3;
  const int pix = g.slab * 2;
  const int row = box_w * pix;
  const uint32_t box_bytes = box_h * row;
  uint32_t stage_bytes;
  const int smem_bytes = tma_smem(g, S, &stage_bytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + smem_bytes - 8 * g.stages);

  // this block's tiles: a contiguous run, so the slab (and the taps in
  // registers) changes rarely and neighbouring tiles share halo rows in L2
  const int per = g.tiles / gridDim.x, extra = g.tiles % gridDim.x;
  const int first = blockIdx.x * per + min(static_cast<int>(blockIdx.x),
                                           extra);
  const int count = per + (static_cast<int>(blockIdx.x) < extra ? 1 : 0);

  // tile -> (slab, image, tile row, tile column)
  auto where = [&](int t, int& slab, int& b, int& ty, int& tx) {
    tx = t % g.tiles_w;
    t /= g.tiles_w;
    ty = t % g.tiles_h;
    t /= g.tiles_h;
    b = t % g.images;
    slab = t / g.images;
  };
  auto issue = [&](int i) {
    int slab, b, ty, tx;
    where(first + i, slab, b, ty, tx);
    const int st = i % g.stages;
    mbar_arrive_expect_tx(&full[st], box_bytes);
    tma_load_4d(smem + st * stage_bytes, &xmap, &full[st], slab * g.slab,
                tx * g.tile_w * S - 1, ty * g.tile_h * S - 1, b);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) mbar_init(&full[s], 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < min(g.stages, count); ++i) issue(i);
  }

  // this thread's unit: channel group, output column, run of rows
  const int gp = g.slab / 8;
  const int grp = threadIdx.x % gp;
  const int col = (threadIdx.x / gp) % g.tile_w;
  const int seg = threadIdx.x / (gp * g.tile_w);
  const int seg_rows = (g.tile_h + g.segments - 1) / g.segments;
  const int r0 = seg * seg_rows;
  const int rows = seg < g.segments ? min(seg_rows, g.tile_h - r0) : 0;
  const int out_row = Wo * C;

  float w[9][8];
  int have = -1;  // the slab whose taps are in w
  for (int i = 0; i < count; ++i) {
    int slab, b, ty, tx;
    where(first + i, slab, b, ty, tx);
    const int c = slab * g.slab + grp * 8;
    const bool live = rows > 0 && c < C;
    if (live && slab != have) {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float4 lo = __ldg(reinterpret_cast<const float4*>(
            taps + k * C + c));
        const float4 hi = __ldg(reinterpret_cast<const float4*>(
            taps + k * C + c) + 1);
        w[k][0] = lo.x, w[k][1] = lo.y, w[k][2] = lo.z, w[k][3] = lo.w;
        w[k][4] = hi.x, w[k][5] = hi.y, w[k][6] = hi.z, w[k][7] = hi.w;
      }
      have = slab;
    }
    const int st = i % g.stages;
    mbar_wait(&full[st], (i / g.stages) & 1);
    if (live) {
      const unsigned char* in = smem + st * stage_bytes +
                                (r0 * S * box_w + col * S) * pix + grp * 16;
      const int ho = ty * g.tile_h + r0, wo = tx * g.tile_w + col;
      __nv_bfloat16* o =
          out + ((static_cast<size_t>(b) * Ho + ho) * Wo + wo) * C + c;
      if (S == 1)
        run_s1(in, pix, row, rows, w, scale + c, bias + c, slope, o,
               out_row);
      else
        run_s2(in, pix, row, rows, w, scale + c, bias + c, slope, o,
               out_row);
    }
    __syncthreads();  // every thread is done with stage st
    if (threadIdx.x == 0 && i + g.stages < count) issue(i + g.stages);
  }
}

// ----------------------------------------------------------- tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the CUDA runtime so the library
// links against no libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

struct MapKey {
  const void* x;
  int B, H, W, C, slab, box_w, box_h;
  bool operator==(const MapKey& o) const {
    return x == o.x && B == o.B && H == o.H && W == o.W && C == o.C &&
           slab == o.slab && box_w == o.box_w && box_h == o.box_h;
  }
};

// The 4-D map over x (C, W, H, B innermost first) with a
// slab x box_w x box_h x 1 box; zeros outside the tensor. Each host thread
// caches its last 64 maps (no lock), the oldest replaced first; the search
// starts at the newest.
bool tensor_map(const MapKey& k, CUtensorMap* map) {
  constexpr int kCache = 64;
  thread_local MapKey keys[kCache];
  thread_local CUtensorMap maps[kCache];
  thread_local int used = 0, next = 0;
  for (int j = 1; j <= used; ++j) {
    const int i = (next - j + kCache) % kCache;
    if (keys[i] == k) {
      *map = maps[i];
      return true;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(k.C),
                              static_cast<cuuint64_t>(k.W),
                              static_cast<cuuint64_t>(k.H),
                              static_cast<cuuint64_t>(k.B)};
  const cuuint64_t strides[3] = {2ull * k.C, 2ull * k.C * k.W,
                                 2ull * k.C * k.W * k.H};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(k.slab),
                             static_cast<cuuint32_t>(k.box_w),
                             static_cast<cuuint32_t>(k.box_h), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  if (encode(&maps[next], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(k.x), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  keys[next] = k;
  *map = maps[next];
  next = (next + 1) % kCache;
  if (used < kCache) ++used;
  return true;
}

template <int S>
int launch_tma(const CUtensorMap& map, const float* taps, const float* scale,
               const float* bias, __nv_bfloat16* out, int Ho, int Wo, int C,
               const TileGrid& g, int threads, int grid, int smem,
               float slope, cudaStream_t stream) {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        dw3x3_tma_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dw3x3_tma_kernel<S>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dw3x3_tma_kernel<S><<<grid, threads, smem, stream>>>(
      map, taps, scale, bias, out, Ho, Wo, C, g, slope);
  return launch_status();
}

}  // namespace
}  // namespace calipsync

// x (B,H,W,C) and out (B,Ho,Wo,C) in `dtype`; taps (9,C), scale (C,),
// bias (C,) fp32. `plan` is null for the simple kernel, or the TMA
// kernel's tiling from kernels/depthwise.py (plan_tiles): {tile_h, tile_w,
// segments, slab, stages, threads, grid, smem bytes}; it takes bf16, C a
// multiple of 8, tiles that divide the output and 16-byte-aligned
// tensors. Returns the launch status (0 = cudaSuccess).
extern "C" int calipsync_depthwise3x3(const void* x, const void* taps,
                                      const void* scale, const void* bias,
                                      void* out, int dtype, int B, int H,
                                      int W, int C, int Ho, int Wo,
                                      int stride, float slope,
                                      const int* plan, void* stream) {
  using namespace calipsync;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (plan != nullptr) {
    TileGrid g{plan[0], plan[1], plan[2], plan[3], plan[4],
               Ho / std::max(plan[0], 1), Wo / std::max(plan[1], 1), B, 0};
    g.tiles = (C + g.slab - 1) / std::max(g.slab, 1) * B * g.tiles_h *
              g.tiles_w;
    const int threads = plan[5], grid = plan[6], smem = plan[7];
    const int box_w = (g.tile_w - 1) * stride + 3;
    const int box_h = (g.tile_h - 1) * stride + 3;
    const bool ok =
        dtype == kBFloat16 && (stride == 1 || stride == 2) && C % 8 == 0 &&
        g.slab % 8 == 0 && g.slab >= 8 && g.slab <= 64 && g.tile_h >= 1 &&
        g.tile_w >= 1 && Ho % g.tile_h == 0 && Wo % g.tile_w == 0 &&
        box_w <= 256 && box_h <= 256 && g.segments >= 1 &&
        g.stages >= 1 && g.stages <= 8 && threads % 32 == 0 &&
        threads <= kTmaThreads &&
        g.slab / 8 * g.tile_w * g.segments <= threads && grid >= 1 &&
        smem <= kMaxSmem && smem >= tma_smem(g, stride) && aligned(x) &&
        aligned(out) && aligned(taps) && aligned(scale) && aligned(bias);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap map;
    if (!tensor_map(MapKey{x, B, H, W, C, g.slab, box_w, box_h}, &map))
      return static_cast<int>(cudaErrorInvalidValue);
    const float* t = static_cast<const float*>(taps);
    const float* sc = static_cast<const float*>(scale);
    const float* bi = static_cast<const float*>(bias);
    auto* o = static_cast<__nv_bfloat16*>(out);
    const int blocks = std::min(grid, g.tiles);
    return stride == 1
               ? launch_tma<1>(map, t, sc, bi, o, Ho, Wo, C, g, threads,
                               blocks, smem, slope, s)
               : launch_tma<2>(map, t, sc, bi, o, Ho, Wo, C, g, threads,
                               blocks, smem, slope, s);
  }
  const bool vec_ok = aligned(x) && aligned(out);
  if (dtype == kBFloat16) {
    if (vec_ok && C % 8 == 0)
      launch<__nv_bfloat16, 8>(x, taps, scale, bias, out, B, H, W, C, Ho, Wo,
                               stride, slope, s);
    else
      launch<__nv_bfloat16, 1>(x, taps, scale, bias, out, B, H, W, C, Ho, Wo,
                               stride, slope, s);
  } else if (dtype == kFloat32) {
    if (vec_ok && C % 4 == 0)
      launch<float, 4>(x, taps, scale, bias, out, B, H, W, C, Ho, Wo, stride,
                       slope, s);
    else
      launch<float, 1>(x, taps, scale, bias, out, B, H, W, C, Ho, Wo, stride,
                       slope, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}
