// Dense epilogues, hand-written for Hopper: bias + GeLU forward and
// backward, bias + residual forward.
//
// Replace the TPU kernels mxnet_tpu/ops/pallas_epilogue.py ::
// _bias_gelu_fwd_call -> pallas_bias_gelu_fwd and
// _residual_fwd_call -> pallas_residual_fwd. Same arithmetic, f32
// inside:
//   gelu:     z = x + b;  y = 0.5 * z * (1 + erf(z / sqrt(2)))
//   residual: y = (x + b) + r
// with the bias read as f32 and y rounded to x's dtype.
//
// Bound: bytes. Each element is read once (x, and r for the residual)
// and written once; erff costs a few dozen flops, still far below the
// card's ratio of operations to bytes. Design: one grid-stride
// elementwise pass, the bias row indexed by column.
//
// bias + GeLU backward: replaces mxnet_tpu/ops/pallas_epilogue.py ::
// _bias_gelu_bwd_call -> pallas_bias_gelu_bwd. Same arithmetic, f32:
//   z = x + b;  dz = dy * (Phi(z) + z * phi(z))
// with Phi(z) = 0.5 * (1 + erf(z / sqrt(2))) and phi(z) = exp(-z^2 / 2)
// / sqrt(2 pi); dx = dz rounded to x's dtype, db = sum of dz over the
// rows in f32, rounded to the bias's dtype at the end. Bound: bytes (dy
// and x read once, dx written once). The TPU kernel adds db across its
// sequential grid steps; here each block takes 256 columns (one per
// thread, so a warp reads 32 neighbouring elements of a row) by a
// strip of rows, keeps its columns' db sums in registers and writes
// them as one f32 partial row; a second small kernel adds the partial
// rows in order. Deterministic, no atomics. The bias + residual
// backward, (dy, sum(dy), dy), has no kernel, as in the reference.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;
constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;
constexpr int kBwdCols = 256;   // columns (threads) per backward block

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bias_gelu_fwd_kernel(const T* __restrict__ x,
                         const void* __restrict__ bias, int bias_dtype,
                         T* __restrict__ y, int64_t n, int C) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const float z = to_f32(x[i]) + load_f32(bias, i % C, bias_dtype);
    y[i] = from_f32<T>(0.5f * z * (1.0f + erff(z * kInvSqrt2)));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bias_residual_fwd_kernel(const T* __restrict__ x,
                             const void* __restrict__ bias, int bias_dtype,
                             const T* __restrict__ r, T* __restrict__ y,
                             int64_t n, int C) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const float z = to_f32(x[i]) + load_f32(bias, i % C, bias_dtype);
    y[i] = from_f32<T>(z + to_f32(r[i]));
  }
}

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename T>
void launch_gelu(const void* x, const void* bias, int bias_dtype, void* y,
                 int64_t n, int C, cudaStream_t stream) {
  bias_gelu_fwd_kernel<T><<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<const T*>(x), bias, bias_dtype, static_cast<T*>(y), n, C);
}

template <typename T>
void launch_residual(const void* x, const void* bias, int bias_dtype,
                     const void* r, void* y, int64_t n, int C,
                     cudaStream_t stream) {
  bias_residual_fwd_kernel<T><<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<const T*>(x), bias, bias_dtype, static_cast<const T*>(r),
      static_cast<T*>(y), n, C);
}

// grid (row strips, column tiles); part: (gridDim.x, C) f32
template <typename T>
__global__ void __launch_bounds__(kBwdCols)
    bias_gelu_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                         const void* __restrict__ bias, int bias_dtype,
                         T* __restrict__ dx, float* __restrict__ part,
                         int64_t M, int C, int rows) {
  const int c = blockIdx.y * kBwdCols + threadIdx.x;
  if (c >= C) return;
  const float b = load_f32(bias, c, bias_dtype);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t r1 = r0 + rows < M ? r0 + rows : M;
  float acc = 0.f;
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t i = r * C + c;
    const float z = to_f32(x[i]) + b;
    const float cdf = 0.5f * (1.0f + erff(z * kInvSqrt2));
    const float pdf = expf(-0.5f * z * z) * kInvSqrt2Pi;
    const float dz = to_f32(dy[i]) * (cdf + z * pdf);
    dx[i] = from_f32<T>(dz);
    acc += dz;
  }
  part[static_cast<int64_t>(blockIdx.x) * C + c] = acc;
}

// db[c] = sum over strips of part[s][c], in strip order, in db's dtype
__global__ void bias_gelu_bwd_reduce(const float* __restrict__ part,
                                     int strips, int C, void* db,
                                     int bias_dtype) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float acc = 0.f;
  for (int i = 0; i < strips; ++i)
    acc += part[static_cast<int64_t>(i) * C + c];
  store_f32(db, c, bias_dtype, acc);
}

template <typename T>
void launch_gelu_bwd(const void* dy, const void* x, const void* bias,
                     int bias_dtype, void* dx, float* part, void* db,
                     int64_t M, int C, int rows, int strips,
                     cudaStream_t stream) {
  const dim3 grid(strips, (C + kBwdCols - 1) / kBwdCols);
  bias_gelu_bwd_kernel<T><<<grid, kBwdCols, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), bias, bias_dtype,
      static_cast<T*>(dx), part, M, C, rows);
  bias_gelu_bwd_reduce<<<(C + 255) / 256, 256, 0, stream>>>(
      part, strips, C, db, bias_dtype);
}

}  // namespace

// dy, x, dx: (M, C) contiguous of dtype code `dtype`; bias, db: (C,) of
// dtype code `bias_dtype`; part: f32 scratch of strips * C, where
// strips = ceil(M / rows).
MXT_EXPORT int mxt_bias_gelu_bwd(const void* dy, const void* x,
                                 const void* bias, void* dx, void* part,
                                 void* db, int64_t M, int C, int rows,
                                 int dtype, int bias_dtype,
                                 cudaStream_t stream) {
  if (M < 1 || C < 1 || rows < 1) return cudaErrorInvalidValue;
  const int64_t strips = (M + rows - 1) / rows;
  if (strips > 0x7fffffff || (C + kBwdCols - 1) / kBwdCols > 65535)
    return cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  const int s = static_cast<int>(strips);
  switch (dtype) {
    case kF32:
      launch_gelu_bwd<float>(dy, x, bias, bias_dtype, dx, p, db, M, C, rows,
                             s, stream);
      break;
    case kBF16:
      launch_gelu_bwd<__nv_bfloat16>(dy, x, bias, bias_dtype, dx, p, db, M,
                                     C, rows, s, stream);
      break;
    case kF16:
      launch_gelu_bwd<__half>(dy, x, bias, bias_dtype, dx, p, db, M, C, rows,
                              s, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (M, C) contiguous of dtype code `dtype`; bias: (C,) of dtype
// code `bias_dtype`.
MXT_EXPORT int mxt_bias_gelu_fwd(const void* x, const void* bias, void* y,
                                 int64_t M, int C, int dtype, int bias_dtype,
                                 cudaStream_t stream) {
  if (M < 1 || C < 1) return cudaErrorInvalidValue;
  const int64_t n = M * C;
  switch (dtype) {
    case kF32:
      launch_gelu<float>(x, bias, bias_dtype, y, n, C, stream);
      break;
    case kBF16:
      launch_gelu<__nv_bfloat16>(x, bias, bias_dtype, y, n, C, stream);
      break;
    case kF16:
      launch_gelu<__half>(x, bias, bias_dtype, y, n, C, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// x, r, y: (M, C) contiguous of dtype code `dtype`; bias: (C,).
MXT_EXPORT int mxt_bias_residual_fwd(const void* x, const void* bias,
                                     const void* r, void* y, int64_t M,
                                     int C, int dtype, int bias_dtype,
                                     cudaStream_t stream) {
  if (M < 1 || C < 1) return cudaErrorInvalidValue;
  const int64_t n = M * C;
  switch (dtype) {
    case kF32:
      launch_residual<float>(x, bias, bias_dtype, r, y, n, C, stream);
      break;
    case kBF16:
      launch_residual<__nv_bfloat16>(x, bias, bias_dtype, r, y, n, C,
                                     stream);
      break;
    case kF16:
      launch_residual<__half>(x, bias, bias_dtype, r, y, n, C, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
