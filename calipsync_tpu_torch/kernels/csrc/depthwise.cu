// Depthwise 3x3 conv + folded BatchNorm + LeakyReLU, NHWC, pad 1,
// stride 1 or 2, fp32 accumulation.
//
// Replaces: calipsync_tpu/kernels/depthwise.py, both depthwise3x3 (:88,
// haloed H tiles by manual DMA) and depthwise3x3_blocked (:193, a whole
// plane per program). They are two TPU tilings of one op, so one kernel
// serves both.
//
// Bound on the H100: memory. Nine multiply-adds per input element read
// (about 4.5 operations per bf16 byte) against ~295 operations per byte
// before the card's arithmetic is the limit. At B=128 bf16 the largest
// call, (128,160,160,64) stride 2, reads 419 MB and writes 105 MB:
// ~156 us at 3.35 TB/s.
//
// Design: one thread per (output pixel, group of VEC channels). C is the
// contiguous NHWC axis, so each tap is one 16-byte load (8 bf16 or 4 fp32
// channels) and neighbouring threads read neighbouring addresses; the
// nine taps of neighbouring pixels overlap and are served by L1/L2, so
// device memory sees each input byte about once. Taps, scale and bias are
// fp32 per channel (a few KB, cache resident). Channel counts that are not
// a multiple of VEC take the VEC=1 instance.

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

}  // namespace
}  // namespace calipsync

// x (B,H,W,C) and out (B,Ho,Wo,C) in `dtype`; taps (9,C), scale (C,),
// bias (C,) fp32. Returns the launch status (0 = cudaSuccess).
extern "C" int calipsync_depthwise3x3(const void* x, const void* taps,
                                      const void* scale, const void* bias,
                                      void* out, int dtype, int B, int H,
                                      int W, int C, int Ho, int Wo,
                                      int stride, float slope,
                                      void* stream) {
  using namespace calipsync;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (dtype == kBFloat16) {
    if (aligned && C % 8 == 0)
      launch<__nv_bfloat16, 8>(x, taps, scale, bias, out, B, H, W, C, Ho, Wo,
                               stride, slope, s);
    else
      launch<__nv_bfloat16, 1>(x, taps, scale, bias, out, B, H, W, C, Ho, Wo,
                               stride, slope, s);
  } else if (dtype == kFloat32) {
    if (aligned && C % 4 == 0)
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
