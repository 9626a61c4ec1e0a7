// Fused stride-1 inverted-residual block, eval mode, BN folded:
//   hid = leaky(x w1 + b1)            -> cast to the compute dtype
//   y   = leaky(dw3x3(hid, kd) + bd)  -> cast   (hid zero-padded at edges)
//   out = leaky(y w2 + b2)            -> cast   [+ x]
// fp32 accumulation throughout.
//
// Replaces: calipsync_tpu/kernels/fused_ir.py, fused_inverted_residual
// (:122, body _ir_kernel :76).
//
// Bound on the H100: memory, once the hidden activation stays on chip, for
// 8 of the 9 launches of a B=128 bf16 forward. The largest (up4.ir1,
// 160x160, Cin 64, Ch 128, Cout 32) must read 419 MB and write 210 MB
// (188 us at 3.35 TB/s) and does 88 GFLOP (89 us at the bf16 tensor-core
// peak); up2.ir1 (40x40, 256 -> 512 -> 64) is bound by its 69 GFLOP.
// Unfused, the (B,H,W,Ch) hidden tensor would cross device memory about
// six times.
//
// Both designs keep the hidden on the SM: a block stages one tile of output
// pixels plus a one-pixel halo of x in shared memory once, then walks the
// hidden channels in chunks. For each chunk it computes hid on the haloed
// tile, the depthwise taps on the output pixels, and adds y_chunk . w2[chunk]
// into fp32 accumulators. Casts are per element, so chunking keeps the JAX
// cast points. Halo pixels outside the image are zero in the hidden (the
// depthwise conv zero-pads its input), not leaky(b1), on all four edges.
//
//  - bf16 (serving): persistent blocks of 256 threads (two warpgroups), as
//    many as the SMs hold (two where shared memory allows), each walking
//    (image, tile) pairs. The host picks the tile (make_plan: 8 or 16
//    columns, as many rows as the projection's register sums and shared
//    memory allow) and whether the weights stay resident (staged once a
//    block) or stream 32 hidden channels at a time through two slots, the
//    next chunk's cp.async in flight while the current one computes
//    (down2.ir2, up2.ir1 and up3.ir1 of a forward). Every copy is a 16-byte cp.async (4-byte for the stem's 6
//    channels) that zero-fills outside the image. Per chunk of 32 hidden
//    channels:
//      expand: wgmma m64n32k16, both operands read by descriptor from
//        shared memory, where the x tile and w1 are stored as 8 x 8 core
//        matrices; each warpgroup keeps two 64-row blocks in flight, so
//        one block's bias + leaky + cast into the hidden chunk overlaps
//        the next one's multiply. The warp index is broadcast from lane 0,
//        so ptxas sees the warpgroup's branches as uniform: a divergent
//        path around a wgmma makes it serialize them.
//      depthwise: mma.sync with a block-diagonal B. For 16 output pixels
//        and 8 channels, A (16 x 72) holds each pixel's 9 window taps x 8
//        channels and B (72 x 8) holds kd on its diagonal blocks, so the
//        tensor cores do the 9 multiply-adds in fp32 (bf16 products are
//        exact). A's rows are shifted rows of the hidden chunk, which
//        ldmatrix reads straight from shared memory, each lane pointing at
//        its own pixel's tap; B's fragments are byte permutes of the taps.
//      project: the depthwise's C fragments (bias, leaky, bf16 cast) are
//        the A fragments of mma.sync m16n8k16 against w2 by ldmatrix; the
//        sums stay in registers across chunks.
//    The output leaves straight from the projection's fragments, the
//    residual read from the x tile. Cout <= 128.
//  - fp32 (the reference-precision path): an 8x8 tile and chunks of 32 on
//    the CUDA cores, accumulators in shared memory.

#include <algorithm>
#include <array>
#include <cstdint>
#include <map>
#include <mutex>

#include "common.cuh"

namespace calipsync {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

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
// Tensor-core design (see the header): persistent blocks, resident or
// streamed weights, hidden chunks of kKC channels.

namespace bf16_path {
constexpr int kKC = 32;          // hidden channels per chunk
constexpr int kLH = kKC + 8;     // row stride of the hidden chunk
// Output m tiles (16 pixels) whose projection sums a warp keeps in
// registers: 64 of them for Cout over 32, 32 for Cout 32.
template <int NT> __host__ __device__ constexpr int mpw() {
  return NT == 4 ? 2 : 16 / NT;
}
constexpr int kBlock = 256;      // threads: two warpgroups
constexpr int kWarps = kBlock / 32;
constexpr int kBlocksPerSM = 2;  // the kernel's launch bounds
constexpr int kMaxSmem = 232448;     // one block's limit on the H100
constexpr int kSmemPerSM = 233472;   // 228 KB, 1 KB of it reserved a block

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// How a launch tiles its work; chosen on the host (make_plan), read by
// the kernel.
struct Plan {
  int th, tw;       // output tile, rows x cols (th even, tw a multiple of 8)
  int mp;           // haloed tile (th + 2) x (tw + 2), rounded up to 64 rows
  int cinp;         // Cin rounded up to 16 (x tile and w1: core matrices)
  int chp;          // Ch rounded up to kKC
  int resident;     // 1: all weights staged once a block; 0: a chunk at a
                    // time, two slots, the next chunk in flight
  int rows1;        // hidden channels a weight slot holds (chp or kKC)
  int hs_elems;     // bf16 elements of hs, the hidden chunk
  int slot_bytes;   // bytes of one weight slot
  int smem;         // dynamic shared memory, bytes
  int occupancy;    // blocks an SM holds (by shared memory, at most 2)
};

// One weight slot: w1 (rows1 hidden channels x cinp, core matrices),
// w2 rows (out channel, 8 NT of them) x (rows1 + 8), bf16 taps
// (9 x rows1), then fp32 b1 and bd.
struct Slot {
  bf16* w1;
  bf16* w2;
  bf16* kd;
  float* b1;
  float* bd;
};

template <int NT>
__host__ __device__ inline int slot_bytes(int rows1, int cinp) {
  return 2 * (rows1 * cinp + 8 * NT * (rows1 + 8) + 9 * rows1) +
         4 * 2 * rows1;
}

template <int NT>
__device__ __forceinline__ Slot slot_at(unsigned char* base, const Plan& p) {
  Slot s;
  s.w1 = reinterpret_cast<bf16*>(base);
  s.w2 = s.w1 + p.rows1 * p.cinp;
  s.kd = s.w2 + 8 * NT * (p.rows1 + 8);
  s.b1 = reinterpret_cast<float*>(s.kd + 9 * p.rows1);
  s.bd = s.b1 + p.rows1;
  return s;
}

// Which of the optional 16-byte paths a launch's pointers and widths
// allow.
struct VecPaths {
  bool x, x_words, w1, w2, kd, bias;
};

// Hidden channels j0 .. j0 + rows1 of the weights into a slot, zero past
// Ch, Cin and Cout; 16-byte cp.async where rows allow, else scalar loads.
template <int NT>
__device__ void stage_weights(const Slot& s, const Plan& p, int j0,
                              const bf16* __restrict__ w1t,
                              const float* __restrict__ b1,
                              const bf16* __restrict__ kd,
                              const float* __restrict__ bd,
                              const bf16* __restrict__ w2t, int Cin, int Ch,
                              int Cout, const VecPaths& vp) {
  const int tid = threadIdx.x, rows1 = p.rows1, lw2 = rows1 + 8;
  const bf16 zero = __float2bfloat16_rn(0.f);
  const int g1 = p.cinp / 8;
  for (int i = tid; i < rows1 * g1; i += kBlock) {
    const int r = i / g1, c = (i % g1) * 8;
    const bf16* src = w1t + static_cast<long long>(j0 + r) * Cin + c;
    bf16* dst = s.w1 + core_offset(r, c, g1);
    if (vp.w1) {
      const bool ok = j0 + r < Ch && c < Cin;
      cp_async16(dst, ok ? src : w1t, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = j0 + r < Ch && c + e < Cin ? src[e] : zero;
    }
  }
  const int g2 = rows1 / 8;
  for (int i = tid; i < 8 * NT * g2; i += kBlock) {
    const int o = i / g2, c = (i % g2) * 8;
    const bf16* src = w2t + static_cast<long long>(o) * Ch + j0 + c;
    bf16* dst = s.w2 + o * lw2 + c;
    if (vp.w2) {
      const bool ok = o < Cout && j0 + c < Ch;
      cp_async16(dst, ok ? src : w2t, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = o < Cout && j0 + c + e < Ch ? src[e] : zero;
    }
  }
  if (vp.kd) {
    for (int i = tid; i < 9 * (rows1 / 8); i += kBlock) {
      const int tap = i / (rows1 / 8), j = (i % (rows1 / 8)) * 8;
      const bool ok = j0 + j < Ch;
      cp_async16(s.kd + tap * rows1 + j, ok ? kd + tap * Ch + j0 + j : kd,
                 ok);
    }
  } else {
    for (int i = tid; i < 9 * rows1; i += kBlock) {
      const int tap = i / rows1, j = j0 + i % rows1;
      s.kd[i] = j < Ch ? kd[tap * Ch + j] : zero;
    }
  }
  if (vp.bias) {
    for (int r = 4 * tid; r < rows1; r += 4 * kBlock) {
      const bool ok = j0 + r < Ch;
      cp_async16(s.b1 + r, ok ? b1 + j0 + r : b1, ok);
      cp_async16(s.bd + r, ok ? bd + j0 + r : bd, ok);
    }
  } else {
    for (int r = tid; r < rows1; r += kBlock) {
      s.b1[r] = j0 + r < Ch ? b1[j0 + r] : 0.f;
      s.bd[r] = j0 + r < Ch ? bd[j0 + r] : 0.f;
    }
  }
}

// The haloed x tile at output origin (h0, w0): mp rows of Cin channels
// padded to cinp, as core matrices; zero outside the image, past Cin and
// in the pad rows.
__device__ void stage_x(bf16* xs, const Plan& p, const bf16* __restrict__ x,
                        long long b, int h0, int w0, int H, int W, int Cin,
                        const VecPaths& vp) {
  const int tid = threadIdx.x, hw = p.tw + 2, np = (p.th + 2) * hw;
  const int cinp = p.cinp, kcb = cinp / 8;
  if (vp.x) {
    const int groups = cinp / 8;
    for (int i = tid; i < p.mp * groups; i += kBlock) {
      const int pix = i / groups, c = (i % groups) * 8;
      const int hi = h0 - 1 + pix / hw, wi = w0 - 1 + pix % hw;
      const bool ok = pix < np && hi >= 0 && hi < H && wi >= 0 && wi < W &&
                      c < Cin;
      cp_async16(xs + core_offset(pix, c, kcb),
                 ok ? x + ((b * H + hi) * W + wi) * Cin + c : x, ok);
    }
  } else if (vp.x_words) {
    // rows of Cin/2 32-bit words (the stem's 6 channels); the pad columns
    // were zeroed once, before the first tile
    const int words = Cin / 2;
    for (int i = tid; i < p.mp * words; i += kBlock) {
      const int pix = i / words, c = (i % words) * 2;
      const int hi = h0 - 1 + pix / hw, wi = w0 - 1 + pix % hw;
      const bool ok = pix < np && hi >= 0 && hi < H && wi >= 0 && wi < W;
      cp_async4(xs + core_offset(pix, c, kcb),
                ok ? x + ((b * H + hi) * W + wi) * Cin + c : x, ok);
    }
  } else {
    for (int i = tid; i < p.mp * cinp; i += kBlock) {
      const int pix = i / cinp, c = i % cinp;
      const int hi = h0 - 1 + pix / hw, wi = w0 - 1 + pix % hw;
      const bool ok = pix < np && hi >= 0 && hi < H && wi >= 0 && wi < W &&
                      c < Cin;
      xs[core_offset(pix, c, kcb)] = ok ? x[((b * H + hi) * W + wi) * Cin + c]
                                        : __float2bfloat16_rn(0.f);
    }
  }
}

// NT n tiles of 8 output channels (Cout <= 8 NT), MPW = mpw<NT>() output
// m tiles a warp. STOP < 3 builds a bisect variant that stops
// after a stage (0: x tile in, out stored; 1: + expand; 2: + depthwise);
// the main path runs STOP = 3. STOP = 4 is the full kernel with warp 0's
// clock64() time in each phase (x load wait, expand, depthwise and
// projection, epilogue and store; barrier waits included) added to
// stamps[0..3].
template <int NT, int STOP = 3>
__global__ void __launch_bounds__(kBlock, kBlocksPerSM)
    kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1t,
           const float* __restrict__ b1, const bf16* __restrict__ kd,
           const float* __restrict__ bd, const bf16* __restrict__ w2t,
           const float* __restrict__ b2, bf16* __restrict__ out, int B,
           int H, int W, int Cin, int Ch, int Cout, int residual,
           float slope, const Plan p, unsigned long long* stamps) {
  constexpr int MPW = mpw<NT>();
  unsigned long long t_last = STOP == 4 ? clock64() : 0;
  unsigned long long t_phase[4] = {0, 0, 0, 0};
  auto stamp = [&](int phase) {
    if (STOP == 4 && threadIdx.x == 0) {
      const unsigned long long now = clock64();
      t_phase[phase] += now - t_last;
      t_last = now;
    }
  };
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // mp x cinp, core matrices
  bf16* hs = xs + p.mp * p.cinp;                 // mp x kLH
  unsigned char* wbase = reinterpret_cast<unsigned char*>(hs + p.hs_elems);
  const Slot slot0 = slot_at<NT>(wbase, p);
  float* b2s = reinterpret_cast<float*>(wbase + (p.resident ? 1 : 2) *
                                                    p.slot_bytes);

  // warp broadcast from lane 0, so that the compiler sees it uniform
  // across the warp: branches on the warp and warpgroup do not diverge, and
  // ptxas keeps the expand's wgmma asynchronous (a divergent path around a
  // wgmma makes it serialize them)
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column
  const int th = p.th, tw = p.tw, hw = tw + 2, kcb = p.cinp / 8;
  const int np = (th + 2) * hw;
  const int lw2 = p.rows1 + 8;
  const int tiles_w = (W + tw - 1) / tw, tiles_h = (H + th - 1) / th;
  const int per_img = tiles_w * tiles_h;
  const long long total = static_cast<long long>(B) * per_img;
  const int nchunks = p.chp / kKC;
  const int nom = th * tw / 16;  // output m tiles: 16 pixels in tile order
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp in it
  auto a16 = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  VecPaths vp;
  vp.x = Cin % 8 == 0 && a16(x);
  vp.x_words =
      !vp.x && Cin % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  vp.w1 = Cin % 8 == 0 && a16(w1t);
  vp.w2 = Ch % 8 == 0 && a16(w2t);
  vp.kd = Ch % 8 == 0 && a16(kd);
  vp.bias = Ch % 4 == 0 && a16(b1) && a16(bd);
  // The depthwise stage as an mma: for 16 output pixels and 8 channels,
  // A (16 x 72) holds each pixel's 9 window taps x 8 channels and B
  // (72 x 8) is block-diagonal, B[tap * 8 + c][c] = kd[tap][c]; taps 0-7
  // are four k16 steps, tap 8 one k8 step. A row is a shifted row of the
  // hidden chunk, so ldmatrix reads A straight from hs: in k step s lane l
  // points at tap 2s + l / 16 of pixel l % 16, toff[s] hidden rows from
  // the pixel's window origin.
  int toff[5];
#pragma unroll
  for (int s5 = 0; s5 < 5; ++s5) {
    const int tap = min(2 * s5 + (lane >> 4), 8);
    toff[s5] = (tap / 3) * hw + tap % 3;
  }
  // byte permute that puts a bf16 tap in the low half (lane with g = 2t),
  // the high half (g = 2t + 1), or gives 0
  const uint32_t kd_sel =
      g == 2 * t ? 0x4410u : g == 2 * t + 1 ? 0x1044u : 0x4444u;

  for (int o = tid; o < 8 * NT; o += kBlock) b2s[o] = o < Cout ? b2[o] : 0.f;
  if (vp.x_words)
    for (int i = tid; i < p.mp * p.cinp; i += kBlock)
      xs[i] = __float2bfloat16_rn(0.f);
  if (p.resident)
    stage_weights<NT>(slot0, p, 0, w1t, b1, kd, bd, w2t, Cin, Ch, Cout, vp);

  for (long long tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const long long b = tile / per_img;
    const int tr = static_cast<int>(tile % per_img);
    const int h0 = (tr / tiles_w) * th, w0 = (tr % tiles_w) * tw;
    // the haloed tile lies inside the image: no per-pixel edge test
    const bool interior = h0 >= 1 && w0 >= 1 && h0 + th + 1 <= H &&
                          w0 + tw + 1 <= W;
    stamp(3);
    __syncthreads();  // the previous tile's readers of xs, hs, slots done
    stage_x(xs, p, x, b, h0, w0, H, W, Cin, vp);
    if (!p.resident)
      stage_weights<NT>(slot0, p, 0, w1t, b1, kd, bd, w2t, Cin, Ch, Cout, vp);
    cp_async_commit();

    float acc[MPW][NT][4];
#pragma unroll
    for (int i = 0; i < MPW; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = b2s[n * 8 + 2 * t + (e & 1)];

    for (int c = 0; STOP >= 1 && c < nchunks; ++c) {
      cp_async_wait<0>();
      fence_proxy_async();  // for wgmma's reads of x and w1
      __syncthreads();      // x and chunk c's weights in; hs free
      if (c == 0)
        stamp(0);
      else
        stamp(2);
      if (!p.resident && c + 1 < nchunks) {
        stage_weights<NT>(slot_at<NT>(wbase + ((c + 1) & 1) * p.slot_bytes,
                                      p),
                          p, (c + 1) * kKC, w1t, b1, kd, bd, w2t, Cin, Ch,
                          Cout, vp);
        cp_async_commit();
      }
      const Slot w =
          slot_at<NT>(wbase + (p.resident ? 0 : (c & 1) * p.slot_bytes), p);
      const int jw = p.resident ? c * kKC : 0;  // chunk's row in the slot
      const int kc = min(kKC, Ch - c * kKC);    // channels of the chunk

      // expand 1x1 on the haloed tile: warpgroup wg multiplies 64-row
      // blocks wg, wg + 2, ... of x by the chunk's 32 columns of w1 with
      // wgmma, both read from shared memory; zero outside the image and
      // in the pad rows
      {
        float bias[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          bias[n][0] = w.b1[jw + n * 8 + 2 * t];
          bias[n][1] = w.b1[jw + n * 8 + 2 * t + 1];
        }
        // two 64-row blocks in flight: the second block's wgmma runs while
        // the first one's epilogue writes hs
        const int nmb = p.mp / 64;
        auto epilogue = [&](const float (&d)[16], int mb) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int pix = 64 * mb + 16 * wq + g + 8 * half;
            if (pix >= np) continue;  // pad rows: never read
            bool inside = true;
            if (!interior) {
              const int hi = h0 - 1 + pix / hw, wi = w0 - 1 + pix % hw;
              inside = hi >= 0 && hi < H && wi >= 0 && wi < W;
            }
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const float v0 = leaky(d[4 * n + 2 * half], slope);
              const float v1 = leaky(d[4 * n + 2 * half + 1], slope);
              *reinterpret_cast<uint32_t*>(hs + pix * kLH + n * 8 + 2 * t) =
                  inside ? pack_bf16(v0, v1) : 0u;
            }
          }
        };
        for (int mb = wg; mb < nmb; mb += 4) {  // blocks mb and mb + 2
          const bool two = mb + 2 < nmb;
          float d[2][16];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) d[i][4 * n + e] = bias[n][e & 1];
          fence_operands(d[0]);
          fence_operands(d[1]);
          wgmma_fence();
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (i == 0 || two)
              for (int kk = 0; kk < kcb; kk += 2)
                wgmma_m64n32k16(
                    d[i],
                    wgmma_desc(xs + core_offset(64 * (mb + 2 * i), 8 * kk, kcb),
                               128, 128 * kcb),
                    wgmma_desc(w.w1 + core_offset(jw, 8 * kk, kcb), 128,
                               128 * kcb));
            wgmma_commit();
          }
          wgmma_wait<1>();
          fence_operands(d[0]);
          epilogue(d[0], mb);
          wgmma_wait<0>();
          fence_operands(d[1]);
          if (two) epilogue(d[1], mb + 2);
        }
      }
      __syncthreads();  // the hidden chunk is in hs
      stamp(1);
      if (STOP < 2) continue;

      // depthwise 3x3 + bias + leaky (cast to bf16) on the tensor cores,
      // its C fragments turned straight into the projection's A
      // fragments (the 16 channels of a k step are the depthwise's two n
      // tiles); the projection's sums stay in registers across chunks.
      // Warp w owns the output m tiles w, w + 8, ... (16 pixels in tile
      // order).
      for (int ks = 0; ks < (kc + 15) / 16; ++ks) {
        // B fragments of the two n tiles: lane (g, t) holds kd[tap][g] in
        // the half of k = tap * 8 + g it covers, zero elsewhere; kd is
        // bf16-exact fp32, so a byte permute of its bits is the bf16
        uint32_t bdw[2][9];
        float bias[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int cj = jw + ks * 16 + 8 * j;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap)
            bdw[j][tap] = __byte_perm(
                *reinterpret_cast<const uint16_t*>(w.kd + tap * p.rows1 + cj +
                                                   g),
                0, kd_sel);
          bias[j][0] = w.bd[cj + 2 * t];
          bias[j][1] = w.bd[cj + 2 * t + 1];
        }
        const bf16* w2f = w.w2 + ((lane & 7) + (lane >> 4) * 8) * lw2 + jw +
                          ks * 16 + ((lane >> 3) & 1) * 8;
        const bf16* hp[MPW];
        float cd[MPW][2][4];
#pragma unroll
        for (int i = 0; i < MPW; ++i) {
          const int q = min(warp + kWarps * i, nom - 1) * 16 + (lane & 15);
          hp[i] = hs + ((q / tw) * hw + q % tw) * kLH + ks * 16;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) cd[i][j][e] = bias[j][e & 1];
        }
        // taps 0-7 as four k16 steps, tap 8 as one k8 step; the m tiles'
        // mma chains interleave
        // taps 0-3 into cd, 4-8 into ce (two shorter mma chains)
        float ce[MPW][2][4];
#pragma unroll
        for (int i = 0; i < MPW; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) ce[i][j][e] = 0.f;
#pragma unroll
        for (int s5 = 0; s5 < 2; ++s5)
#pragma unroll
          for (int i = 0; i < MPW; ++i) {
            if (warp + kWarps * i >= nom) break;
#pragma unroll
            for (int hlf = 0; hlf < 2; ++hlf) {
              const int sk = s5 + 2 * hlf;
              uint32_t a[2][4];
              ldmatrix_x4(a[0], hp[i] + toff[sk] * kLH);
              ldmatrix_x4(a[1], hp[i] + toff[sk] * kLH + 8);
#pragma unroll
              for (int j = 0; j < 2; ++j)
                mma_bf16(hlf ? ce[i][j] : cd[i][j], a[j], bdw[j][2 * sk],
                         bdw[j][2 * sk + 1]);
            }
          }
#pragma unroll
        for (int i = 0; i < MPW; ++i) {
          if (warp + kWarps * i >= nom) break;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t a[2];
            ldmatrix_x2(a, hp[i] + toff[4] * kLH + 8 * j);
            mma_bf16_k8(ce[i][j], a[0], a[1], bdw[j][8]);
#pragma unroll
            for (int e = 0; e < 4; ++e) cd[i][j][e] += ce[i][j][e];
          }
        }
#pragma unroll
        for (int i = 0; i < MPW; ++i) {
          if (warp + kWarps * i >= nom) break;
          uint32_t ya[4];  // rows g, g+8 x channels 2t.., 8+2t..
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            ya[2 * j] = pack_bf16(leaky(cd[i][j][0], slope),
                                  leaky(cd[i][j][1], slope));
            ya[2 * j + 1] = pack_bf16(leaky(cd[i][j][2], slope),
                                      leaky(cd[i][j][3], slope));
          }
          if (STOP == 2) {  // keep the depthwise alive without the project
            acc[i][0][0] += __uint_as_float(ya[0] ^ ya[1] ^ ya[2] ^ ya[3]);
            continue;
          }
#pragma unroll
          for (int n2 = 0; n2 < NT / 2; ++n2) {
            uint32_t bw[4];
            ldmatrix_x4(bw, w2f + n2 * 16 * lw2);
            mma_bf16(acc[i][2 * n2], ya, bw[0], bw[1]);
            mma_bf16(acc[i][2 * n2 + 1], ya, bw[2], bw[3]);
          }
        }
      }
    }
    if (STOP == 0) {  // no chunk waited for this tile's x
      cp_async_wait<0>();
      __syncthreads();
    }
    stamp(2);

    // epilogue: bias, leaky, cast [+ x], stored straight from the
    // fragments (lanes 4g .. 4g+3 write a pixel's 8 channels of an n tile
    // as one 16-byte piece; measured faster than staging the tile in
    // shared memory for 16-byte-a-lane stores)
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      const int mt = warp + kWarps * i;
      if (mt >= nom) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = mt * 16 + g + 8 * half;
        const int hi = h0 + q / tw, wi = w0 + q % tw;
        if (hi >= H || wi >= W) continue;
        const bf16* xr = xs + core_offset((q / tw + 1) * hw + q % tw + 1, 0,
                                          kcb);
        bf16* op = out + ((b * H + hi) * W + wi) * Cout;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int o = n * 8 + 2 * t;
          if (o >= Cout) break;
          float v0 = round_to<bf16>(leaky(acc[i][n][2 * half], slope));
          float v1 = round_to<bf16>(leaky(acc[i][n][2 * half + 1], slope));
          if (residual) {  // channels o, o + 1 share a core-matrix row
            v0 += to_float(xr[core_offset(0, o, kcb)]);
            v1 += to_float(xr[core_offset(0, o + 1, kcb)]);
          }
          if (Cout % 2 == 0) {
            *reinterpret_cast<uint32_t*>(op + o) = pack_bf16(v0, v1);
          } else {
            op[o] = __float2bfloat16_rn(v0);
            if (o + 1 < Cout) op[o + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
  stamp(3);
  if (STOP == 4 && threadIdx.x == 0)
    for (int i = 0; i < 4; ++i) atomicAdd(stamps + i, t_phase[i]);
}

// Shared memory of a plan with tile (th, tw) and the residency given;
// fills the derived fields.
template <int NT>
void size_plan(Plan& p, int Cin, int Ch, int Cout) {
  p.mp = round_up((p.th + 2) * (p.tw + 2), 64);
  p.cinp = round_up(Cin, 16);
  p.chp = round_up(Ch, kKC);
  p.rows1 = p.resident ? p.chp : kKC;
  p.hs_elems = p.mp * kLH;
  p.slot_bytes = slot_bytes<NT>(p.rows1, p.cinp);
  const long long smem =
      2LL * (p.mp * p.cinp + p.hs_elems) +
      static_cast<long long>(p.resident ? 1 : 2) * p.slot_bytes + 4 * 8 * NT;
  p.smem = smem > kMaxSmem ? kMaxSmem + 1 : static_cast<int>(smem);
  p.occupancy = std::min(kBlocksPerSM, kSmemPerSM / (p.smem + 1024));
}

// A tile's fixed cost (barriers, the exposed x load), counted as this many
// haloed rows in make_plan's score.
constexpr int kTileCostRows = 160;

// The tiling with the most useful work per byte staged: over tile widths
// 8 and 16 and even heights, with resident or streamed weights, the
// largest occupancy^2 x output pixels / (haloed rows + streamed weights
// in rows + kTileCostRows) x share of the covered pixels inside the image.
// Occupancy counts twice: a second block on the SM runs while the first
// waits at its barriers, which the staging cost does not show (measured:
// down2.ir2 and up3.ir1 run ~12% faster streamed at two blocks an SM
// than resident at one). The projection sums bound a tile to
// 16 x kWarps x MPW pixels.
template <int NT>
Plan make_plan(int H, int W, int Cin, int Ch, int Cout) {
  const int max_px = 16 * kWarps * mpw<NT>();
  Plan best{};
  double best_score = -1.0;
  for (int tw = W > 8 ? 16 : 8; tw >= 8; tw -= 8) {
    for (int th = 2; th <= round_up(H, 2) && th * tw <= max_px; th += 2) {
      for (int resident = 0; resident < 2; ++resident) {
        Plan p{};
        p.th = th;
        p.tw = tw;
        p.resident = resident;
        size_plan<NT>(p, Cin, Ch, Cout);
        if (p.smem > kMaxSmem || p.occupancy < 1) continue;
        // streamed weights cross into the block again for every tile:
        // count their bytes as that many more haloed rows of x
        const double w_rows =
            resident ? 0.0
                     : double(p.chp / kKC) * p.slot_bytes / (2 * p.cinp);
        const double covered = static_cast<double>(round_up(H, th)) *
                               round_up(W, tw);
        const double score = p.occupancy * p.occupancy * (th * tw) /
                             (p.mp + w_rows + kTileCostRows) *
                             (double(H) * W / covered);
        if (score > best_score) {
          best_score = score;
          best = p;
        }
      }
    }
  }
  return best;  // smem 0 when nothing fits
}
}  // namespace bf16_path

// n tiles the bf16 kernel instance uses for Cout; 0 when Cout > 128.
int pick_nt(int Cout) {
  return Cout <= 32 ? 4 : Cout <= 64 ? 8 : Cout <= 128 ? 16 : 0;
}

// make_plan's result, remembered per shape: the planner's search costs
// host time that every launch would otherwise pay again.
bf16_path::Plan plan_bf16(int H, int W, int Cin, int Ch, int Cout) {
  using namespace bf16_path;
  static std::mutex mu;
  static std::map<std::array<int, 5>, Plan> plans;
  const std::array<int, 5> key{H, W, Cin, Ch, Cout};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = plans.find(key);
  if (it != plans.end()) return it->second;
  Plan p{};
  switch (pick_nt(Cout)) {
    case 4: p = make_plan<4>(H, W, Cin, Ch, Cout); break;
    case 8: p = make_plan<8>(H, W, Cin, Ch, Cout); break;
    case 16: p = make_plan<16>(H, W, Cin, Ch, Cout); break;
  }
  plans.emplace(key, p);
  return p;
}

// Lets the kernel take `smem` bytes of dynamic shared memory, with the
// SM's unified L1/shared storage split for shared memory first, so that
// as many blocks fit on an SM as the plan counts on.
cudaError_t allow_smem(const void* kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess || smem <= 48 * 1024) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <int NT, int STOP = 3>
int launch_bf16(const void* x, const void* w1t, const void* b1,
                const void* kd, const void* bd, const void* w2t,
                const void* b2, void* out, int B, int H, int W, int Cin,
                int Ch, int Cout, int residual, float slope,
                cudaStream_t stream, unsigned long long* stamps = nullptr) {
  using namespace bf16_path;
  const Plan p = plan_bf16(H, W, Cin, Ch, Cout);
  if (p.smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(&kernel<NT, STOP>);
  cudaError_t e = allow_smem(fn, p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kBlock,
                                                    p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = static_cast<long long>(B) *
                          ((H + p.th - 1) / p.th) * ((W + p.tw - 1) / p.tw);
  const long long slots =
      static_cast<long long>(std::max(per_sm, 1)) * std::max(sm_count(), 1);
  const int grid = static_cast<int>(std::min(tiles, slots));
  kernel<NT, STOP><<<grid, kBlock, p.smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1t),
      static_cast<const float*>(b1), static_cast<const bf16*>(kd),
      static_cast<const float*>(bd), static_cast<const bf16*>(w2t),
      static_cast<const float*>(b2), static_cast<bf16*>(out), B, H, W, Cin,
      Ch, Cout, residual, slope, p, stamps);
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

// Bytes of dynamic shared memory the kernel asks for at these sizes; -1
// when the bf16 kernel does not take this Cout (> 128), -2 when no tiling
// of it fits in a block's shared memory.
extern "C" long long calipsync_fused_ir_smem(int H, int W, int Cin, int Ch,
                                             int Cout, int dtype) {
  using namespace calipsync;
  if (dtype != kBFloat16)
    return static_cast<long long>(fp32_path::smem_bytes(Cin, Cout));
  if (pick_nt(Cout) == 0) return -1;
  const bf16_path::Plan p = plan_bf16(H, W, Cin, Ch, Cout);
  return p.smem == 0 ? -2 : p.smem;
}

// The bf16 tiling of a launch, for reports: fills out[0..6] with the tile
// rows and columns, haloed rows, resident weights (0/1), shared memory
// bytes and blocks an SM holds by it, and Cout's n tiles. Returns -1 when
// no tiling fits.
extern "C" int calipsync_fused_ir_plan(int H, int W, int Cin, int Ch,
                                       int Cout, int* out) {
  using namespace calipsync;
  const bf16_path::Plan p = plan_bf16(H, W, Cin, Ch, Cout);
  if (p.smem == 0) return -1;
  const int v[7] = {p.th, p.tw, p.mp, p.resident, p.smem, p.occupancy,
                    pick_nt(Cout)};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
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

#ifdef CALIPSYNC_FUSED_IR_BISECT
// The bf16 kernel stopped after stage `stop` (0-2; 3 is the full kernel;
// 4 the full kernel adding its per-phase clock64() cycles to stamps[0..3]),
// for timing where a launch spends its time. Built only into the bisect
// library (kernels/bench.py --bisect), never into the main path's.
extern "C" int calipsync_fused_ir_bisect(const void* x, const void* w1t,
                                         const void* b1, const void* kd,
                                         const void* bd, const void* w2t,
                                         const void* b2, void* out, int B,
                                         int H, int W, int Cin, int Ch,
                                         int Cout, int residual, float slope,
                                         int stop, void* stamps,
                                         void* stream) {
  using namespace calipsync;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* st = static_cast<unsigned long long*>(stamps);
#define CALIPSYNC_CASE(NT, STOP)                                            \
  case STOP:                                                                \
    return launch_bf16<NT, STOP>(x, w1t, b1, kd, bd, w2t, b2, out, B, H, W, \
                                 Cin, Ch, Cout, residual, slope, s, st);
#define CALIPSYNC_STOPS(NT)                                                 \
  switch (stop) {                                                           \
    CALIPSYNC_CASE(NT, 0)                                                   \
    CALIPSYNC_CASE(NT, 1)                                                   \
    CALIPSYNC_CASE(NT, 2)                                                   \
    CALIPSYNC_CASE(NT, 3)                                                   \
    CALIPSYNC_CASE(NT, 4)                                                   \
  }                                                                         \
  break;
  switch (pick_nt(Cout)) {
    case 4: CALIPSYNC_STOPS(4)
    case 8: CALIPSYNC_STOPS(8)
    case 16: CALIPSYNC_STOPS(16)
  }
#undef CALIPSYNC_STOPS
#undef CALIPSYNC_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif
