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
//  - fp32 (what `infer` and `serve` run by default, at B=8): the same
//    structure on the tensor cores at fp32 accuracy. A TF32 product keeps
//    ~3 digits, so each 1x1 product is three passes: every operand split
//    by cvt.rna into a TF32 high part and a TF32 remainder, and
//    a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in fp32 sums (the lo.lo term,
//    ~2^-22 of the product, dropped). On the CUDA cores a B=128 forward's
//    fused IR FLOPs take at least 4.98 ms at 67 TFLOP/s; three TF32 passes
//    at 495 TFLOP/s at least 2.02. Persistent blocks of 256 threads, one
//    an SM (up to 255 registers a thread: a version held to 128, for two
//    blocks an SM, spilled and ran slower), walk (image, tile) pairs; the
//    host picks the tile per shape, the batch included (make_plan: 8 or
//    16 columns, the estimated waves over the SMs times a tile's staging
//    cost), and resident or streamed weights (two slots, the next
//    chunk's cp.async in flight), as in bf16; streamed chunks are 32
//    hidden channels, or 16 for Cout 33-64 (an instance of its own), which
//    leaves the Cin 256 launch a tile twice as large. The x tile (16- or
//    8-byte cp.async, zero-filled outside the image, Cin padded to the
//    mma's k of 8) stays unsplit in shared memory, so Cin 256 fits a
//    tile: a split copy would double it. Per chunk:
//      w1: staged unsplit, then split in place into high and low core
//        matrices (once a block when resident, once a chunk streamed);
//      expand: wgmma m64n32k8 TF32 (m64n16k8 for a 16-channel chunk), A
//        from registers (x loaded from the tile and split there, four k
//        steps' fragments in flight as the wgmma groups complete), B the
//        w1 halves K-major in shared memory; the warpgroups take 64-row
//        blocks in pairs, an odd last one split by columns; the cross
//        terms sum apart from hi.hi, so consecutive wgmmas do not all
//        wait on one accumulator; bias, leaky, zero outside the image,
//        into the fp32 hidden chunk;
//      depthwise: fp32 FMA on the CUDA cores, 9 taps in order (~3% of the
//        block's FLOPs); a warp's m tiles are consecutive output rows, so
//        each hidden row a thread loads serves up to three of its
//        outputs; each output is split straight into the A fragment of
//        mma.sync m16n8k8 TF32;
//      project: three mma.sync per fragment against w2 split as its B
//        fragments are loaded; the sums stay in registers across chunks.
//        Where a tile has fewer m tiles than warps, the warps split
//        Cout's n tiles between them (each recomputing its m tiles'
//        depthwise), so none idles.
//    Cout <= 128, as in bf16.

#include <algorithm>
#include <array>
#include <type_traits>
#include <cstdint>
#include <map>
#include <mutex>

#include "common.cuh"

namespace calipsync {
namespace {

using bf16 = __nv_bfloat16;

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

// ---------------------------------------------------------------- fp32
// Tensor-core design at fp32 accuracy (see the header): persistent
// blocks, resident or streamed weights, hidden chunks of KC channels,
// both 1x1 products in three TF32 passes, the depthwise on the CUDA cores.

namespace fp32_path {
constexpr int kABuf = 4;         // k steps in flight in the expand
#ifdef CALIPSYNC_FP32_STAMPS
__device__ unsigned long long g_stamps[8];
#endif
constexpr int kKC = 32;          // hidden channels per chunk, at most
constexpr int kLH = kKC + 4;     // row stride of the hidden chunk (floats)
constexpr int kBlock = 256;      // threads: two warpgroups
constexpr int kWarps = kBlock / 32;
constexpr int kMaxSmem = 232448;     // one block's limit on the H100
// Output m tiles (16 pixels) whose projection sums a warp keeps in
// registers: 64 sums a thread for every Cout.
template <int NT> __host__ __device__ constexpr int mpw() { return 16 / NT; }
// Streamed chunks of 16 hidden channels, an instance of its own
// (kernel<8, 16>), are compiled for Cout 33-64 only: the one width whose
// streamed weights crowd the tile (Cin 256 at 40x40).
template <int NT> __host__ __device__ constexpr bool takes_kc16() {
  return NT == 8;
}

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// How a launch tiles its work; chosen on the host (make_plan), read by
// the kernel.
struct Plan {
  int th, tw;       // output tile, rows x cols (th even, tw 8 or 16)
  int np;           // haloed pixels, (th + 2) x (tw + 2)
  int mp;           // np rounded up to 64 (the expand's row blocks)
  int cinp;         // Cin rounded up to 8 (the TF32 mma's k)
  int lx;           // row stride of the x tile, cinp + 4 (floats)
  int kc;           // hidden channels per chunk: 32, or 16 where streamed
                    // weights leave a larger tile room (takes_kc16)
  int chp;          // Ch rounded up to kc
  int resident;     // 1: all weights staged once a block; 0: a chunk at a
                    // time, two slots, the next chunk in flight
  int rows1;        // hidden channels a weight slot holds (chp or kc)
  int nsplit;       // n-tile groups the projection's warps split Cout into
  int slot_bytes;   // bytes of one weight slot
  int smem;         // dynamic shared memory, bytes
};

// One weight slot: w1 split into TF32 high and low parts (rows1 hidden
// channels x cinp, core matrices of core_offset4), w2 rows (out channel,
// 8 NT of them) x (rows1 + 4), the taps (9 x rows1), b1 and bd; fp32.
struct Slot {
  float* w1h;
  float* w1l;
  float* w2;
  float* kd;
  float* b1;
  float* bd;
};

template <int NT>
__host__ __device__ inline int slot_bytes(int rows1, int cinp) {
  return 4 * (2 * rows1 * cinp + 8 * NT * (rows1 + 4) + 11 * rows1);
}

template <int NT>
__device__ __forceinline__ Slot slot_at(unsigned char* base, const Plan& p) {
  Slot s;
  s.w1h = reinterpret_cast<float*>(base);
  s.w1l = s.w1h + p.rows1 * p.cinp;
  s.w2 = s.w1l + p.rows1 * p.cinp;
  s.kd = s.w2 + 8 * NT * (p.rows1 + 4);
  s.b1 = s.kd + 9 * p.rows1;
  s.bd = s.b1 + p.rows1;
  return s;
}

// Which of the optional vector paths a launch's pointers and widths
// allow: x in 16-byte (Cin % 4 == 0) or 8-byte (the stem's Cin of 6)
// pieces, the weights in 16-byte pieces.
struct VecPaths {
  bool x16, x8, w1, w2, kd, bias;
};

// Hidden channels j0 .. j0 + rows1 of the weights into a slot, zero past
// Ch, Cin and Cout; 16-byte cp.async where rows allow, else scalar loads.
// w1 lands unsplit in w1h; split_w1 splits it in place.
template <int NT>
__device__ void stage_weights(const Slot& s, const Plan& p, int j0,
                              const float* __restrict__ w1t,
                              const float* __restrict__ b1,
                              const float* __restrict__ kd,
                              const float* __restrict__ bd,
                              const float* __restrict__ w2t, int Cin, int Ch,
                              int Cout, const VecPaths& vp) {
  const int tid = threadIdx.x, rows1 = p.rows1, lw2 = rows1 + 4;
  const int g1 = p.cinp / 4, kcb = p.cinp / 4;
  for (int i = tid; i < rows1 * g1; i += kBlock) {
    const int r = i / g1, c = (i % g1) * 4;
    const float* src = w1t + static_cast<long long>(j0 + r) * Cin + c;
    float* dst = s.w1h + core_offset4(r, c, kcb);
    if (vp.w1) {
      const bool ok = j0 + r < Ch && c < Cin;
      cp_async16(dst, ok ? src : w1t, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[e] = j0 + r < Ch && c + e < Cin ? src[e] : 0.f;
    }
  }
  const int g2 = rows1 / 4;
  for (int i = tid; i < 8 * NT * g2; i += kBlock) {
    const int o = i / g2, c = (i % g2) * 4;
    const float* src = w2t + static_cast<long long>(o) * Ch + j0 + c;
    float* dst = s.w2 + o * lw2 + c;
    if (vp.w2) {
      const bool ok = o < Cout && j0 + c < Ch;
      cp_async16(dst, ok ? src : w2t, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[e] = o < Cout && j0 + c + e < Ch ? src[e] : 0.f;
    }
  }
  if (vp.kd) {
    for (int i = tid; i < 9 * g2; i += kBlock) {
      const int tap = i / g2, j = (i % g2) * 4;
      const bool ok = j0 + j < Ch;
      cp_async16(s.kd + tap * rows1 + j, ok ? kd + tap * Ch + j0 + j : kd,
                 ok);
    }
  } else {
    for (int i = tid; i < 9 * rows1; i += kBlock) {
      const int tap = i / rows1, j = j0 + i % rows1;
      s.kd[i] = j < Ch ? kd[tap * Ch + j] : 0.f;
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

// The slot's w1, staged unsplit in w1h, split into its TF32 high part
// (in place) and remainder (w1l), once per staging.
__device__ void split_w1(const Slot& s, const Plan& p) {
  const int n = p.rows1 * p.cinp;
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kBlock) {
    const float4 v = *reinterpret_cast<const float4*>(s.w1h + i);
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(s.w1h + i) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(s.w1l + i) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The haloed x tile at output origin (h0, w0), unsplit: np rows of Cin
// channels padded to cinp, row stride lx; zero outside the image and past
// Cin (the expand reads the pad rows up to mp as zeros in registers).
__device__ void stage_x(float* xs, const Plan& p, const float* __restrict__ x,
                        long long b, int h0, int w0, int H, int W, int Cin,
                        const VecPaths& vp) {
  const int tid = threadIdx.x, hw = p.tw + 2, np = p.np, lx = p.lx;
  const int piece = vp.x16 ? 4 : vp.x8 ? 2 : 1;
  const int groups = p.cinp / piece;
  for (int i = tid; i < np * groups; i += kBlock) {
    const int pix = i / groups, c = (i % groups) * piece;
    const int hi = h0 - 1 + pix / hw, wi = w0 - 1 + pix % hw;
    const bool ok = hi >= 0 && hi < H && wi >= 0 && wi < W && c < Cin;
    const float* src = ok ? x + ((b * H + hi) * W + wi) * Cin + c : x;
    if (piece == 4)
      cp_async16(xs + pix * lx + c, src, ok);
    else if (piece == 2)
      cp_async8(xs + pix * lx + c, src, ok);
    else
      xs[pix * lx + c] = ok ? *src : 0.f;
  }
}

// NT n tiles of 8 output channels (Cout <= 8 NT). Per chunk of KC hidden
// channels: the expand on the tensor cores (warpgroup wg computes the
// chunk's columns 16 wg .. 16 wg + 15 for every 64-row block of the
// haloed tile), then each warp's depthwise outputs, split, as the A
// fragments of the projection's mma.sync.
template <int NT, int KC>
__global__ void __launch_bounds__(kBlock, 1)
    kernel(const float* __restrict__ x, const float* __restrict__ w1t,
           const float* __restrict__ b1, const float* __restrict__ kd,
           const float* __restrict__ bd, const float* __restrict__ w2t,
           const float* __restrict__ b2, float* __restrict__ out, int B,
           int H, int W, int Cin, int Ch, int Cout, int residual,
           float slope, const Plan p) {
  constexpr int MPW = mpw<NT>();
#ifdef CALIPSYNC_FP32_STAMPS
  // warp 0's clock64() cycles by phase: 0 chunk wait + barrier, 1 fence
  // and barrier after the split, 2 expand, 3 depthwise + project, 4
  // epilogue and x staging, 5 the barrier after the expand, 6 the next
  // chunk's weight copies issued, 7 the split
  unsigned long long t_last = clock64(), t_ph[8] = {};
#define STAMP(ph)                                      \
  do {                                                 \
    if (threadIdx.x == 0) {                            \
      const unsigned long long now = clock64();        \
      t_ph[ph] += now - t_last;                        \
      t_last = now;                                    \
    }                                                  \
  } while (0)
#else
#define STAMP(ph) \
  do {            \
  } while (0)
#endif
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // np x lx
  float* hs = xs + p.np * p.lx;                    // np x kLH
  unsigned char* wbase = reinterpret_cast<unsigned char*>(hs + p.np * kLH);
  float* b2s = reinterpret_cast<float*>(wbase + (p.resident ? 1 : 2) *
                                                    p.slot_bytes);

  // warp broadcast from lane 0, so that the compiler sees it uniform
  // across the warp (see the bf16 kernel)
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp in it
  const int th = p.th, tw = p.tw, hw = tw + 2, np = p.np, lx = p.lx;
  const int lw2 = p.rows1 + 4, kcb = p.cinp / 4, nks = p.cinp / 8;
  const int tiles_w = (W + tw - 1) / tw, tiles_h = (H + th - 1) / th;
  const int per_img = tiles_w * tiles_h;
  const long long total = static_cast<long long>(B) * per_img;
  const int nchunks = p.chp / KC;
  const int nom = th * tw / 16;  // output m tiles: 16 pixels in tile order
  // the projection's split: nsplit groups of NT / nsplit n tiles, G warps
  // a group; warp w takes n tiles n0 .. n0 + ntl of m tiles wm, wm + G, ..
  const int G = kWarps / p.nsplit, ntl = NT / p.nsplit;
  const int wm = warp % G, n0 = (warp / G) * ntl;
  // this warp's m tiles: nmt consecutive ones from mt0, so that its
  // output rows are consecutive and the depthwise reuses each hidden row
  // it loads for up to three of them
  const int per = (nom + G - 1) / G;
  const int mt0 = wm * per, nmt = max(0, min(per, nom - mt0));
  auto a16 = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  VecPaths vp;
  vp.x16 = Cin % 4 == 0 && a16(x);
  vp.x8 = !vp.x16 && Cin % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  vp.w1 = Cin % 4 == 0 && a16(w1t);
  vp.w2 = Ch % 4 == 0 && a16(w2t);
  vp.kd = Ch % 4 == 0 && a16(kd);
  vp.bias = Ch % 4 == 0 && a16(b1) && a16(bd);
  const bool out2 = Cout % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;

  for (int o = tid; o < 8 * NT; o += kBlock) b2s[o] = o < Cout ? b2[o] : 0.f;
  const Slot slot0 = slot_at<NT>(wbase, p);
  if (p.resident) {
    stage_weights<NT>(slot0, p, 0, w1t, b1, kd, bd, w2t, Cin, Ch, Cout, vp);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    split_w1(slot0, p);  // visible to wgmma after a chunk's fence + barrier
  }

  for (long long tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const long long b = tile / per_img;
    const int tr = static_cast<int>(tile % per_img);
    const int h0 = (tr / tiles_w) * th, w0 = (tr % tiles_w) * tw;
    // the haloed tile lies inside the image: no per-pixel edge test
    const bool interior = h0 >= 1 && w0 >= 1 && h0 + th + 1 <= H &&
                          w0 + tw + 1 <= W;
    STAMP(4);
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
        for (int e = 0; e < 4; ++e)
          acc[i][n][e] = n < ntl ? b2s[(n0 + n) * 8 + 2 * t + (e & 1)] : 0.f;

    for (int c = 0; c < nchunks; ++c) {
      STAMP(c == 0 ? 4 : 3);
      cp_async_wait<0>();
      __syncthreads();  // x and chunk c's weights in; hs free
      STAMP(0);
      if (!p.resident && c + 1 < nchunks) {
        stage_weights<NT>(slot_at<NT>(wbase + ((c + 1) & 1) * p.slot_bytes,
                                      p),
                          p, (c + 1) * KC, w1t, b1, kd, bd, w2t, Cin, Ch,
                          Cout, vp);
        cp_async_commit();
      }
      STAMP(6);
      const Slot w =
          slot_at<NT>(wbase + (p.resident ? 0 : (c & 1) * p.slot_bytes), p);
      const int jw = p.resident ? c * KC : 0;  // chunk's row in the slot
      const int kc = min(KC, Ch - c * KC);     // channels of the chunk
      if (!p.resident) split_w1(w, p);
      STAMP(7);
      fence_proxy_async();  // the split w1 -> wgmma's reads
      __syncthreads();
      STAMP(1);

      // expand 1x1 on the haloed tile, A from registers (x split there),
      // B (w1 high and low) from shared memory; bias, leaky, zero outside
      // the image, into hs. One call: columns col0 .. col0 + N - 1 of the
      // chunk for 64-row block mb; the cross terms (lo.hi + hi.lo) sum
      // apart from hi.hi, so consecutive wgmmas do not all wait on one
      // accumulator.
      auto expand = [&](auto ncols, int mb, int col0) {
        constexpr int N = decltype(ncols)::value;
        const int jc = jw + col0;  // the first w1 row
        float dh[N / 2], dl[N / 2];
#pragma unroll
        for (int n = 0; n < N / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dh[4 * n + e] = w.b1[jc + n * 8 + 2 * t + (e & 1)];
            dl[4 * n + e] = 0.f;
          }
        // rows r0 and r0 + 8 of the tile (zero past np), columns t and
        // t + 4 of a k step
        const int r0 = 64 * mb + 16 * wq + g;
        const bool ok0 = r0 < np, ok1 = r0 + 8 < np;
        const float* xa = xs + r0 * lx + t;
        // kABuf k steps' A fragments in flight: a step's registers are
        // refilled once its wgmma group has completed
        uint32_t ah[kABuf][4], al[kABuf][4];
        fence_operands(dh);
        fence_operands(dl);
        for (int s0 = 0; s0 < nks; s0 += kABuf) {
#pragma unroll
          for (int j = 0; j < kABuf; ++j) {
            const int s = s0 + j;
            if (s >= nks) break;
            if (s >= kABuf) wgmma_wait<kABuf - 1>();
            split_tf32(ok0 ? xa[8 * s] : 0.f, ah[j][0], al[j][0]);
            split_tf32(ok1 ? xa[8 * lx + 8 * s] : 0.f, ah[j][1], al[j][1]);
            split_tf32(ok0 ? xa[8 * s + 4] : 0.f, ah[j][2], al[j][2]);
            split_tf32(ok1 ? xa[8 * lx + 8 * s + 4] : 0.f, ah[j][3],
                       al[j][3]);
            const int off = core_offset4(jc, 8 * s, kcb);
            const uint64_t bh = wgmma_desc(w.w1h + off, 128, 128 * kcb);
            const uint64_t bl = wgmma_desc(w.w1l + off, 128, 128 * kcb);
            wgmma_fence();
            wgmma_tf32_rs<N>(dl, al[j], bh);
            wgmma_tf32_rs<N>(dh, ah[j], bh);
            wgmma_tf32_rs<N>(dl, ah[j], bl);
            wgmma_commit();
          }
        }
        wgmma_wait<0>();
        fence_operands(dh);
        fence_operands(dl);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pix = r0 + 8 * half;
          if (pix >= np) continue;  // pad rows
          bool inside = true;
          if (!interior) {
            const int hi = h0 - 1 + pix / hw, wi = w0 - 1 + pix % hw;
            inside = hi >= 0 && hi < H && wi >= 0 && wi < W;
          }
#pragma unroll
          for (int n = 0; n < N / 8; ++n) {
            const int e = 4 * n + 2 * half;
            const float v0 = leaky(dh[e] + dl[e], slope);
            const float v1 = leaky(dh[e + 1] + dl[e + 1], slope);
            *reinterpret_cast<float2*>(hs + pix * kLH + col0 + n * 8 +
                                       2 * t) =
                inside ? make_float2(v0, v1) : make_float2(0.f, 0.f);
          }
        }
      };
      {
        const int nmb = p.mp / 64;
        // pairs of row blocks, one a warpgroup, all the chunk's columns;
        // an odd last block of a 32-channel chunk split by columns between
        // the warpgroups
        if constexpr (KC == 32) {
          for (int mb = 0; mb + 1 < nmb; mb += 2)
            expand(std::integral_constant<int, 32>(), mb + wg, 0);
          if (nmb & 1)
            expand(std::integral_constant<int, 16>(), nmb - 1, 16 * wg);
        } else {  // chunks of 16: an odd last block on warpgroup 0
          for (int mb = 0; mb + 1 < nmb; mb += 2)
            expand(std::integral_constant<int, 16>(), mb + wg, 0);
          if ((nmb & 1) && wg == 0)
            expand(std::integral_constant<int, 16>(), nmb - 1, 0);
        }
      }
      STAMP(2);
      __syncthreads();  // the hidden chunk is in hs
      STAMP(5);

      // depthwise 3x3 + bias + leaky on the CUDA cores (fp32 FMA, taps in
      // order), each output split into the A fragment of the projection's
      // mma.sync (rows g, g + 8 = pixels, columns t, t + 4 = channels of a
      // k step); the projection's sums stay in registers across chunks.
      // A thread's outputs lie in vertical strips (16-wide tiles: columns
      // g and g + 8, one row an m tile; 8-wide: column g, two rows an m
      // tile), so each hidden row it loads serves every output of its
      // strip within reach.
      for (int ks = 0; ks < kKC / 8; ++ks) {
        if (8 * ks >= kc || nmt == 0) break;
        const int c0 = 8 * ks + t;  // the chunk's channels c0 and c0 + 4
        float k0[9], k1[9];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          k0[tap] = w.kd[tap * p.rows1 + jw + c0];
          k1[tap] = w.kd[tap * p.rows1 + jw + c0 + 4];
        }
        // sums of output j (strip order) of strip half, channels c0, c0 + 4
        float acc0[2][2 * MPW], acc1[2][2 * MPW];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2 * MPW; ++j) acc0[h][j] = acc1[h][j] = 0.f;
        // one hidden row (hr, hidden row r of the strip) into the outputs
        // j of strip h whose window holds it
        auto taps = [&](int h, int r, int hr, int col, int nout) {
          const float* hp = hs + (hr * hw + col) * kLH + c0;
          float v0[3], v1[3];
#pragma unroll
          for (int dc = 0; dc < 3; ++dc) {
            v0[dc] = hp[dc * kLH];
            v1[dc] = hp[dc * kLH + 4];
          }
#pragma unroll
          for (int j = 0; j < 2 * MPW; ++j) {
            const int dy = r - j;
            if (j >= nout || dy < 0 || dy > 2) continue;
#pragma unroll
            for (int dc = 0; dc < 3; ++dc) {
              acc0[h][j] = fmaf(v0[dc], k0[dy * 3 + dc], acc0[h][j]);
              acc1[h][j] = fmaf(v1[dc], k1[dy * 3 + dc], acc1[h][j]);
            }
          }
        };
        if (tw == 16) {  // strips at columns g, g + 8: rows mt0 ..
#pragma unroll
          for (int r = 0; r < MPW + 2; ++r) {
            if (r >= nmt + 2) break;
            taps(0, r, mt0 + r, g, nmt);
            taps(1, r, mt0 + r, g + 8, nmt);
          }
        } else {  // one strip at column g: rows 2 mt0 ..
#pragma unroll
          for (int r = 0; r < 2 * MPW + 2; ++r) {
            if (r >= 2 * nmt + 2) break;
            taps(0, r, 2 * mt0 + r, g, 2 * nmt);
          }
        }
        uint32_t yh[MPW][4], yl[MPW][4];
        const float bd0 = w.bd[jw + c0], bd1 = w.bd[jw + c0 + 4];
#pragma unroll
        for (int i = 0; i < MPW; ++i) {
          if (i >= nmt) break;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            // m tile i, row g (+ 8 for half 1): output i of strip half
            // (16 wide) or output 2 i + half of the one strip (8 wide)
            const bool w16 = tw == 16;
            split_tf32(leaky((w16 ? acc0[half][i] : acc0[0][2 * i + half]) +
                                 bd0, slope),
                       yh[i][half], yl[i][half]);
            split_tf32(leaky((w16 ? acc1[half][i] : acc1[0][2 * i + half]) +
                                 bd1, slope),
                       yh[i][2 + half], yl[i][2 + half]);
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n >= ntl) break;
          // B fragment: w2[c0 (+4)][out (n0 + n) * 8 + g], split
          const float* wp = w.w2 + ((n0 + n) * 8 + g) * lw2 + jw + c0;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(wp[0], bh0, bl0);
          split_tf32(wp[4], bh1, bl1);
#pragma unroll
          for (int i = 0; i < MPW; ++i) {
            if (i >= nmt) break;
            mma_tf32(acc[i][n], yl[i], bh0, bh1);
            mma_tf32(acc[i][n], yh[i], bl0, bl1);
            mma_tf32(acc[i][n], yh[i], bh0, bh1);
          }
        }
      }
    }

    STAMP(3);
    // epilogue: bias (the sums' start), leaky [+ x], stored straight from
    // the fragments; the residual read from the x tile
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      if (i >= nmt) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = (mt0 + i) * 16 + g + 8 * half;
        const int hi = h0 + q / tw, wi = w0 + q % tw;
        if (hi >= H || wi >= W) continue;
        const float* xr = xs + ((q / tw + 1) * hw + q % tw + 1) * lx;
        float* op = out + ((b * H + hi) * W + wi) * Cout;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int o = (n0 + n) * 8 + 2 * t;
          if (n >= ntl || o >= Cout) break;
          float v0 = leaky(acc[i][n][2 * half], slope);
          float v1 = leaky(acc[i][n][2 * half + 1], slope);
          if (residual) {  // column o + 1 <= Cout < lx: a pad column at most
            v0 += xr[o];
            v1 += xr[o + 1];
          }
          if (out2) {
            *reinterpret_cast<float2*>(op + o) = make_float2(v0, v1);
          } else {
            op[o] = v0;
            if (o + 1 < Cout) op[o + 1] = v1;
          }
        }
      }
    }
  }
  STAMP(4);
#ifdef CALIPSYNC_FP32_STAMPS
  if (threadIdx.x == 0)
    for (int i = 0; i < 8; ++i) atomicAdd(g_stamps + i, t_ph[i]);
#endif
#undef STAMP
}

// Shared memory of a plan with tile (th, tw) and the residency given;
// fills the derived fields.
template <int NT>
void size_plan(Plan& p, int Cin, int Ch) {
  p.np = (p.th + 2) * (p.tw + 2);
  p.mp = round_up(p.np, 64);
  p.cinp = round_up(Cin, 8);
  p.lx = p.cinp + 4;
  p.chp = round_up(Ch, p.kc);
  p.rows1 = p.resident ? p.chp : p.kc;
  p.slot_bytes = slot_bytes<NT>(p.rows1, p.cinp);
  const long long smem = 4LL * p.np * (p.lx + kLH) +
                         static_cast<long long>(p.resident ? 1 : 2) *
                             p.slot_bytes +
                         4 * 8 * NT;
  p.smem = smem > kMaxSmem ? kMaxSmem + 1 : static_cast<int>(smem);
}

// A tile's fixed cost (barriers, the exposed x load), counted as this many
// haloed rows in make_plan's estimate.
constexpr int kTileCostRows = 160;
// A chunk's fixed cost (its barriers and copies issued), in haloed rows.
constexpr int kChunkCostRows = 32;

// The projection's split for nom m tiles: the n-tile groups (1, 2, 4 or
// 8, dividing NT) that give the warp with the most work the least, a
// depthwise m tile counted as 4 n tiles of projection; a warp holds at
// most mpw<NT>() m tiles.
template <int NT>
int pick_nsplit(int nom) {
  int best = 0, best_cost = 0;
  for (int ns = 1; ns <= kWarps && ns <= NT; ns *= 2) {
    const int per_warp = (nom + kWarps / ns - 1) / (kWarps / ns);
    if (per_warp > mpw<NT>()) continue;
    const int cost = per_warp * (4 + NT / ns);
    if (best == 0 || cost < best_cost) {
      best = ns;
      best_cost = cost;
    }
  }
  return best;  // 0 when the tile has more m tiles than the warps hold
}

// The tiling with the least estimated time: over tile widths 8 and 16
// and even heights, resident weights or streamed ones in chunks of 32 or
// (takes_kc16) 16, the waves of tiles over the SMs times a tile's cost in
// haloed rows: the rows of x, the streamed weights' bytes as that many
// rows, kChunkCostRows a chunk, and kTileCostRows; B images of H x W, one
// block an SM.
template <int NT>
Plan make_plan(int B, int H, int W, int Cin, int Ch, int sms) {
  Plan best{};
  double best_time = -1.0;
  for (int tw = W > 8 ? 16 : 8; tw >= 8; tw -= 8) {
    for (int th = 2; th <= round_up(H, 2) && th * tw <= 16 * kWarps * mpw<NT>();
         th += 2) {
      // resident; streamed in chunks of 32; streamed in chunks of 16
      for (int mode = 0; mode < (takes_kc16<NT>() ? 3 : 2); ++mode) {
        Plan p{};
        p.th = th;
        p.tw = tw;
        p.resident = mode == 0;
        p.kc = mode == 2 ? 16 : kKC;
        size_plan<NT>(p, Cin, Ch);
        p.nsplit = pick_nsplit<NT>(th * tw / 16);
        if (p.smem > kMaxSmem || p.nsplit == 0) continue;
        const int nchunks = p.chp / p.kc;
        const double w_rows =
            p.resident ? 0.0
                       : double(nchunks) * p.slot_bytes / (4.0 * p.lx);
        const long long tiles = static_cast<long long>(B) *
                                ((H + th - 1) / th) * ((W + tw - 1) / tw);
        const double waves = double((tiles + sms - 1) / sms);
        const double time = waves * (p.mp + w_rows +
                                     nchunks * kChunkCostRows +
                                     kTileCostRows);
        if (best_time < 0 || time < best_time) {
          best_time = time;
          best = p;
        }
      }
    }
  }
  return best;  // smem 0 when nothing fits
}
}  // namespace fp32_path

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

// make_plan's result for the fp32 kernel, remembered per shape (the batch
// included: it sets how many waves of tiles fill the SMs).
fp32_path::Plan plan_fp32(int B, int H, int W, int Cin, int Ch, int Cout) {
  using namespace fp32_path;
  static std::mutex mu;
  static std::map<std::array<int, 6>, Plan> plans;
  const std::array<int, 6> key{B, H, W, Cin, Ch, Cout};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = plans.find(key);
  if (it != plans.end()) return it->second;
  const int sms = std::max(sm_count(), 1);
  Plan p{};
  switch (pick_nt(Cout)) {
    case 4: p = make_plan<4>(B, H, W, Cin, Ch, sms); break;
    case 8: p = make_plan<8>(B, H, W, Cin, Ch, sms); break;
    case 16: p = make_plan<16>(B, H, W, Cin, Ch, sms); break;
  }
  plans.emplace(key, p);
  return p;
}

template <int NT, int KC>
int launch_fp32_kc(const fp32_path::Plan& p, const void* x, const void* w1t,
                   const void* b1, const void* kd, const void* bd,
                   const void* w2t, const void* b2, void* out, int B, int H,
                   int W, int Cin, int Ch, int Cout, int residual,
                   float slope, cudaStream_t stream) {
  using namespace fp32_path;
  const void* fn = reinterpret_cast<const void*>(&kernel<NT, KC>);
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
  kernel<NT, KC><<<grid, kBlock, p.smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1t),
      static_cast<const float*>(b1), static_cast<const float*>(kd),
      static_cast<const float*>(bd), static_cast<const float*>(w2t),
      static_cast<const float*>(b2), static_cast<float*>(out), B, H, W, Cin,
      Ch, Cout, residual, slope, p);
  return launch_status();
}

template <int NT>
int launch_fp32(const void* x, const void* w1t, const void* b1,
                const void* kd, const void* bd, const void* w2t,
                const void* b2, void* out, int B, int H, int W, int Cin,
                int Ch, int Cout, int residual, float slope,
                cudaStream_t stream) {
  using namespace fp32_path;
  const Plan p = plan_fp32(B, H, W, Cin, Ch, Cout);
  if (p.smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (takes_kc16<NT>()) {
    if (p.kc == 16)
      return launch_fp32_kc<NT, 16>(p, x, w1t, b1, kd, bd, w2t, b2, out, B,
                                    H, W, Cin, Ch, Cout, residual, slope,
                                    stream);
  }
  return launch_fp32_kc<NT, kKC>(p, x, w1t, b1, kd, bd, w2t, b2, out, B, H,
                                 W, Cin, Ch, Cout, residual, slope, stream);
}

}  // namespace
}  // namespace calipsync

// Bytes of dynamic shared memory the kernel asks for at these sizes; -1
// when the kernel does not take this Cout (> 128), -2 when no tiling of it
// fits in a block's shared memory.
extern "C" long long calipsync_fused_ir_smem(int B, int H, int W, int Cin,
                                             int Ch, int Cout, int dtype) {
  using namespace calipsync;
  if (pick_nt(Cout) == 0) return -1;
  const int smem = dtype == kFloat32 ? plan_fp32(B, H, W, Cin, Ch, Cout).smem
                                     : plan_bf16(H, W, Cin, Ch, Cout).smem;
  return smem == 0 ? -2 : smem;
}

// The tiling of a launch in `dtype`, for reports: fills out[0..8] with the
// tile rows and columns, haloed rows (rounded up to the expand's 64-row
// blocks), resident weights (0/1), shared memory bytes and blocks an SM
// holds by it, Cout's n tiles, and, for fp32 (1 and 32 in bf16), the
// n-tile groups the projection's warps split them into and the hidden
// channels a chunk. Returns -1 when no tiling fits.
extern "C" int calipsync_fused_ir_plan(int B, int H, int W, int Cin, int Ch,
                                       int Cout, int dtype, int* out) {
  using namespace calipsync;
  if (pick_nt(Cout) == 0) return -1;
  if (dtype == kFloat32) {
    const fp32_path::Plan p = plan_fp32(B, H, W, Cin, Ch, Cout);
    if (p.smem == 0) return -1;
    const int v[9] = {p.th, p.tw, p.mp, p.resident, p.smem, 1,
                      pick_nt(Cout), p.nsplit, p.kc};
    std::copy(v, v + 9, out);
  } else {
    const bf16_path::Plan p = plan_bf16(H, W, Cin, Ch, Cout);
    if (p.smem == 0) return -1;
    const int v[9] = {p.th, p.tw, p.mp, p.resident, p.smem, p.occupancy,
                      pick_nt(Cout), 1, bf16_path::kKC};
    std::copy(v, v + 9, out);
  }
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
  if (dtype == kFloat32) {
    switch (pick_nt(Cout)) {
      case 4:
        return launch_fp32<4>(x, w1t, b1, kd, bd, w2t, b2, out, B, H, W, Cin,
                              Ch, Cout, residual, slope, s);
      case 8:
        return launch_fp32<8>(x, w1t, b1, kd, bd, w2t, b2, out, B, H, W, Cin,
                              Ch, Cout, residual, slope, s);
      case 16:
        return launch_fp32<16>(x, w1t, b1, kd, bd, w2t, b2, out, B, H, W, Cin,
                               Ch, Cout, residual, slope, s);
    }
  }
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

#ifdef CALIPSYNC_FP32_STAMPS
// The fp32 kernel's clock64() cycles by phase (warp 0 of every block,
// barrier waits included) summed since the last call, then zeroed:
// 0 chunk wait + barrier, 1 fence and barrier after the split, 2
// expand, 3 depthwise + project, 4 epilogue and x staging, 5 the barrier
// after the expand, 6 the next chunk's weight copies issued, 7 the split. Built only into the phase library (kernels/bench.py
// --fp32-phases), never into the main path's.
extern "C" int calipsync_fused_ir_fp32_stamps(unsigned long long* host) {
  using namespace calipsync;
  cudaError_t e = cudaMemcpyFromSymbol(host, fp32_path::g_stamps,
                                       8 * sizeof(unsigned long long));
  const unsigned long long zero[8] = {};
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(fp32_path::g_stamps, zero, sizeof(zero));
  return static_cast<int>(e);
}
#endif

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
