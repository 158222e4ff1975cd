// LayerNorm over the last axis, forward and backward, hand-written for
// Hopper.
//
// Forward: replaces the TPU kernel mxnet_tpu/ops/pallas_norm.py ::
// _fwd_call -> pallas_layer_norm_fwd. Same arithmetic: statistics in
// f32, two-pass variance E[(x - mean)^2], rsqrt(var + eps), then
// ((x - mean) * inv) * gamma + beta with gamma/beta read as f32, output
// rounded to x's dtype.
//
// Bound: bytes. The kernel reads x once from device memory and writes
// y once (M*C elements each way); it does ~8 flops per element, far
// below the card's ratio of operations to bytes. Design: one warp per
// row, eight rows per block. The two statistics passes and the output
// pass re-read the row, which stays in L1 after the first pass, so
// device memory sees one read of x.
//
// Backward: replaces mxnet_tpu/ops/pallas_norm.py :: _bwd_call ->
// pallas_layer_norm_bwd. Same arithmetic: the row statistics re-derived
// from x (the forward saves none), xhat = (x - mean) * inv, dyg = dy *
// gamma, m1 = mean(dyg), m2 = mean(dyg * xhat), dx = inv * (dyg - m1 -
// xhat * m2) rounded to x's dtype; dgamma = sum(dy * xhat) and dbeta =
// sum(dy) over the rows in f32, rounded to gamma's dtype at the end.
// Bound: bytes (dy and x read once, dx written once: 3 * M * C
// elements). The TPU kernel carries dgamma/dbeta across its sequential
// grid steps; Hopper blocks run in no order, so here each block of 4
// warps takes 32 rows (8 per warp, one row at a time, lanes along the
// columns), each lane keeps its columns' dgamma/dbeta sums in
// registers, the warps' sums are added in a fixed order in shared memory
// and written as one f32 partial row per block; a second small kernel
// adds the partial rows in block order. Deterministic, no atomics. Rows
// wider than 1024 columns are swept in 1024-column chunks, each chunk
// re-deriving the row statistics.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    layer_norm_fwd_kernel(const T* __restrict__ x,
                          const void* __restrict__ gamma,
                          const void* __restrict__ beta, int param_dtype,
                          T* __restrict__ y, int64_t M, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + row * C;
  T* yr = y + row * C;

  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
  const float mean = warp_sum(s) / static_cast<float>(C);

  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f32(xr[c]) - mean;
    v += d * d;
  }
  const float inv = rsqrtf(warp_sum(v) / static_cast<float>(C) + eps);

  for (int c = lane; c < C; c += 32) {
    const float xhat = (to_f32(xr[c]) - mean) * inv;
    yr[c] = from_f32<T>(xhat * load_f32(gamma, c, param_dtype) +
                        load_f32(beta, c, param_dtype));
  }
}

template <typename T>
void launch(const void* x, const void* gamma, const void* beta,
            int param_dtype, void* y, int64_t M, int C, float eps,
            cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((M + kWarps - 1) / kWarps);
  layer_norm_fwd_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, param_dtype, static_cast<T*>(y),
      M, C, eps);
}

constexpr int kBwdWarps = 4;
constexpr int kBwdRowsPerWarp = 8;
constexpr int kBwdRows = kBwdWarps * kBwdRowsPerWarp;  // rows per block
constexpr int kCpl = 32;                 // columns per lane in a chunk
constexpr int kChunk = 32 * kCpl;        // columns per chunk

// part: (gridDim.x, 2, C) f32 — each block's dgamma and dbeta row sums
template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
    layer_norm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                          const void* __restrict__ gamma, int param_dtype,
                          T* __restrict__ dx, float* __restrict__ part,
                          int64_t M, int C, float eps) {
  __shared__ float red[kBwdWarps][2][kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 =
      static_cast<int64_t>(blockIdx.x) * kBwdRows + warp * kBwdRowsPerWarp;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    float ag[kCpl], ab[kCpl];
#pragma unroll
    for (int k = 0; k < kCpl; ++k) ag[k] = ab[k] = 0.f;

    for (int r = 0; r < kBwdRowsPerWarp; ++r) {
      const int64_t row = row0 + r;
      if (row >= M) break;
      const T* xr = x + row * C;
      const T* dyr = dy + row * C;
      T* dxr = dx + row * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
      const float mean = warp_sum(s) / static_cast<float>(C);
      float v = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f32(xr[c]) - mean;
        v += d * d;
      }
      const float inv = rsqrtf(warp_sum(v) / static_cast<float>(C) + eps);
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float xhat = (to_f32(xr[c]) - mean) * inv;
        const float dyg = to_f32(dyr[c]) * load_f32(gamma, c, param_dtype);
        s1 += dyg;
        s2 += dyg * xhat;
      }
      const float m1 = warp_sum(s1) / static_cast<float>(C);
      const float m2 = warp_sum(s2) / static_cast<float>(C);
#pragma unroll
      for (int k = 0; k < kCpl; ++k) {
        const int c = c0 + lane + 32 * k;
        if (c < C) {
          const float dyv = to_f32(dyr[c]);
          const float xhat = (to_f32(xr[c]) - mean) * inv;
          const float dyg = dyv * load_f32(gamma, c, param_dtype);
          dxr[c] = from_f32<T>(inv * (dyg - m1 - xhat * m2));
          ag[k] += dyv * xhat;
          ab[k] += dyv;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kCpl; ++k) {
      red[warp][0][lane + 32 * k] = ag[k];
      red[warp][1][lane + 32 * k] = ab[k];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk && c0 + i < C; i += blockDim.x) {
      float g = 0.f, b = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) {
        g += red[w][0][i];
        b += red[w][1][i];
      }
      part[(static_cast<int64_t>(blockIdx.x) * 2) * C + c0 + i] = g;
      part[(static_cast<int64_t>(blockIdx.x) * 2 + 1) * C + c0 + i] = b;
    }
    __syncthreads();
  }
}

// dgamma[c] = sum over blocks of part[b][0][c], dbeta likewise, in block
// order, written in the parameters' dtype
__global__ void layer_norm_bwd_reduce(const float* __restrict__ part,
                                      int blocks, int C, void* dgamma,
                                      void* dbeta, int param_dtype) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float g = 0.f, b = 0.f;
  for (int i = 0; i < blocks; ++i) {
    g += part[(static_cast<int64_t>(i) * 2) * C + c];
    b += part[(static_cast<int64_t>(i) * 2 + 1) * C + c];
  }
  store_f32(dgamma, c, param_dtype, g);
  store_f32(dbeta, c, param_dtype, b);
}

template <typename T>
void launch_bwd(const void* dy, const void* x, const void* gamma,
                int param_dtype, void* dx, float* part, void* dgamma,
                void* dbeta, int64_t M, int C, float eps,
                cudaStream_t stream) {
  const int blocks = static_cast<int>((M + kBwdRows - 1) / kBwdRows);
  layer_norm_bwd_kernel<T><<<blocks, kBwdWarps * 32, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), gamma,
      param_dtype, static_cast<T*>(dx), part, M, C, eps);
  layer_norm_bwd_reduce<<<(C + 255) / 256, 256, 0, stream>>>(
      part, blocks, C, dgamma, dbeta, param_dtype);
}

}  // namespace

// rows per block of the backward: part holds ceil(M / this) x 2 x C f32
MXT_EXPORT int mxt_layer_norm_bwd_rows() { return kBwdRows; }

// dy, x, dx: (M, C) contiguous, dtype code `dtype`; gamma, dgamma,
// dbeta: (C,) of dtype code `param_dtype`; part: f32 scratch of
// ceil(M / mxt_layer_norm_bwd_rows()) * 2 * C.
MXT_EXPORT int mxt_layer_norm_bwd(const void* dy, const void* x,
                                  const void* gamma, void* dx, void* part,
                                  void* dgamma, void* dbeta, int64_t M,
                                  int C, float eps, int dtype,
                                  int param_dtype, cudaStream_t stream) {
  if (M < 1 || C < 1 || (M + kBwdRows - 1) / kBwdRows > 0x7fffffff)
    return cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  switch (dtype) {
    case kF32:
      launch_bwd<float>(dy, x, gamma, param_dtype, dx, p, dgamma, dbeta, M,
                        C, eps, stream);
      break;
    case kBF16:
      launch_bwd<__nv_bfloat16>(dy, x, gamma, param_dtype, dx, p, dgamma,
                                dbeta, M, C, eps, stream);
      break;
    case kF16:
      launch_bwd<__half>(dy, x, gamma, param_dtype, dx, p, dgamma, dbeta, M,
                         C, eps, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (M, C) contiguous, dtype code `dtype`; gamma, beta: (C,) of
// dtype code `param_dtype`.
MXT_EXPORT int mxt_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, int64_t M,
                                  int C, float eps, int dtype,
                                  int param_dtype, cudaStream_t stream) {
  if (M < 1 || C < 1 || (M + kWarps - 1) / kWarps > 0x7fffffff)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      launch<float>(x, gamma, beta, param_dtype, y, M, C, eps, stream);
      break;
    case kBF16:
      launch<__nv_bfloat16>(x, gamma, beta, param_dtype, y, M, C, eps,
                            stream);
      break;
    case kF16:
      launch<__half>(x, gamma, beta, param_dtype, y, M, C, eps, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
