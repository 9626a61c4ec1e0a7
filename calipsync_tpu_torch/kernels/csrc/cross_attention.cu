// Spatial cross-attention forward: out = softmax(q k^T) v, no 1/sqrt(d)
// scaling, fp32 scores, fp32 probabilities, fp32 accumulation, result in
// v's dtype.
//
// Replaces: calipsync_tpu/kernels/cross_attention.py, _attention_fwd_pallas
// (:55, body _attention_kernel :36), reached via cross_attention (:97).
// Forward only: serving never takes the gradient.
//
// Bound on the H100: memory. On the serving path q,k are (B,100,64) and v
// (B,100,512); at B=128 bf16 the call moves ~29.5 MB (~9 us at 3.35 TB/s)
// and does 1.47 GFLOP (~1.5 us even on the fp32 CUDA cores' 67 TFLOP/s).
//
// Design: one block of 256 threads per (image, group of ROWS query rows).
// The image's K (N x D) is staged in shared memory as fp32 with a padded
// row stride (D+1) so lanes reading different keys hit different banks;
// the block's q rows are staged beside it. Each warp owns ROWS/8 rows: its
// lanes take the keys of one row, a warp max and a warp sum give the
// max-subtracted softmax, and the probabilities stay in shared memory as
// fp32 (the Pallas body keeps p fp32; it does not cast p to v's dtype),
// transposed so that one key's ROWS probabilities are four 16-byte loads.
// For p.v each thread owns output columns and accumulates all ROWS rows in
// registers, while V passes through shared memory in chunks of V_ROWS rows
// x 512 columns, loaded by the whole block in 16-byte pieces, so many
// loads are in flight at once instead of one dependent load per key row.
// V is read once per block (from L2 for every block after the first of an
// image), never staged whole (512 fp32 columns x 100 rows would be 200 KB).

#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace calipsync {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                // query rows per block
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kCols = 2;                 // output columns per thread per pass
constexpr int kCTile = kThreads * kCols; // output columns per pass
constexpr int kVRows = 32;               // V rows staged per step
constexpr int kPT = kRows + 4;           // row stride of p^T: 16-byte rows

size_t smem_bytes(int N, int D, size_t itemsize) {
  return itemsize * kVRows * kCTile +
         sizeof(float) * (static_cast<size_t>(N) * (D + 1) + kRows * D +
                          static_cast<size_t>(kRows) * N +
                          static_cast<size_t>(N) * kPT);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int N,
                     int D, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the two buffers read in 16-byte pieces first, at 16-byte offsets
  T* vsh = reinterpret_cast<T*>(smem_raw);  // kVRows x kCTile
  float* pt = reinterpret_cast<float*>(vsh + kVRows * kCTile);  // N x kPT
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

  const T* kb = k + static_cast<long long>(b) * N * D;
  for (int i = tid; i < N * D; i += kThreads)
    ksh[(i / D) * ks + (i % D)] = to_float(kb[i]);
  const T* qb = q + (static_cast<long long>(b) * N + r0) * D;
  for (int i = tid; i < rows * D; i += kThreads) qsh[i] = to_float(qb[i]);
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
  constexpr int kVec = 16 / sizeof(T);
  const T* vb = v + static_cast<long long>(b) * N * C;
  const bool vec =
      C % kVec == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  T* ob = out + (static_cast<long long>(b) * N + r0) * C;
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
          *reinterpret_cast<Pack<T, kVec>*>(vsh + r * kCTile + c) =
              *reinterpret_cast<const Pack<T, kVec>*>(
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
          vv[i] = c < cw ? to_float(vsh[jj * kCTile + c]) : 0.f;
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
        if (r < rows)
          ob[static_cast<long long>(r) * C + c] = from_float<T>(acc[r][i]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int N, int D, int C, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, D, sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((N + kRows - 1) / kRows, B);
  attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), N, D, C);
  return launch_status();
}

}  // namespace
}  // namespace calipsync

// Bytes of dynamic shared memory the kernel asks for at these sizes.
extern "C" long long calipsync_cross_attention_smem(int N, int D,
                                                    int dtype) {
  return static_cast<long long>(calipsync::smem_bytes(
      N, D, dtype == calipsync::kBFloat16 ? 2 : 4));
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
    return launch<__nv_bfloat16>(q, k, v, out, B, N, D, C, s);
  if (dtype == kFloat32) return launch<float>(q, k, v, out, B, N, D, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
