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
// bias + GeLU backward: replaces mxnet_tpu/ops/pallas_epilogue.py ::
// _bias_gelu_bwd_call -> pallas_bias_gelu_bwd. Same arithmetic, f32:
//   z = x + b;  dz = dy * (Phi(z) + z * phi(z))
// with Phi(z) = 0.5 * (1 + erf(z / sqrt(2))) and phi(z) = exp(-z^2 / 2)
// / sqrt(2 pi); dx = dz rounded to x's dtype, db = sum of dz over the
// rows in f32, rounded to the bias's dtype at the end. The bias +
// residual backward, (dy, sum(dy), dy), has no kernel, as in the
// reference.
//
// Bound: bytes (each element read once, x and dy, and written once), with
// the full-precision erff and expf close behind: about 31 (forward) and
// 48 (backward) instructions an element, issued over the card's 132 x
// 128 lanes, take 77% and 80% as long as the bytes at BERT's shapes
// (PERF.md), so every instruction that is not math comes off the time,
// and the loads must stay in flight while the math issues. bias +
// residual moves three streams (x, r in; y out) for two adds an element.
// Design of all three kernels: a grid of a few blocks an SM (from the SM
// count), each a strip of rows by a tile of columns; each thread owns one
// 16-byte vector of columns (8 bf16 or f16, 4 f32) with its slice of the
// bias in registers, read once, and walks the strip's rows kRowLanes
// apart, holding a few rows at a time: it issues the 16-byte loads of the
// next rows before the arithmetic of the rows it holds, and writes
// 16-byte vectors. The row's offset is one 64-bit product, the offset
// inside a row 32-bit. Rows that are not a whole number of aligned
// 16-byte vectors (C % 8 in bf16, or a pointer off 16-byte alignment)
// take the element path: the same kernels with one element a thread.
// The two forwards are one kernel, bias_fwd_kernel, over its epilogue
// (bias_gelu_fwd on one input stream, bias_residual_fwd on two).
//
// The TPU kernel adds db across its sequential grid steps. Here a
// backward thread keeps its columns' db in f32 registers over its rows,
// the block adds its row lanes in lane order and writes one f32 partial
// row, and ordered_col_sum adds the partial rows in strip order.
// Deterministic, no atomics. The scratch's row count is bwd_strips (twin:
// ops/cuda_epilogue.py :: bwd_scratch_shape).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

// blocks: kVecCols threads along the row, each a 16-byte vector of
// columns (or one column on the element path), by kRowLanes threads down
// the rows
constexpr int kVecCols = 64;
constexpr int kRowLanes = kThreads / kVecCols;
// rows a thread holds at once (it loads the next ones while it computes
// these) and blocks an SM, of the forward and the backward
constexpr int kFwdRows = 2;
constexpr int kFwdBlocksPerSm = 3;
constexpr int kBwdRows = 2;
constexpr int kBwdBlocksPerSm = 2;
// runs of ordered_col_sum over the backward's partial rows: a few dozen
// rows, so 16 runs of a few rows each, and 32 columns a block
constexpr int kDbRuns = 16;

// the thread's kV bias values from column c, read `shift` columns off
// (0, but for chip_smoke.py's planted fault)
template <int kV>
__device__ __forceinline__ void load_bias(const void* bias, int dtype, int c,
                                          int C, int shift, float* b) {
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const int j = c + k + shift;
    b[k] = load_f32(bias, j < C ? j : j - C, dtype);
  }
}

// rows r, r + kRowLanes, ... (kN of them, those below r1) of column c
template <typename T, int kV, int kN>
__device__ __forceinline__ void load_rows(const T* __restrict__ p, int64_t r,
                                          int64_t r1, int C, int c,
                                          Raw<T, kV>* out) {
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    const int64_t ru = r + u * kRowLanes;
    if (ru < r1) out[u] = *reinterpret_cast<const Raw<T, kV>*>(p + ru * C + c);
  }
}

// the forward kernel's epilogues, y = op(x + b, r), each named for the
// kernel it makes, so that a profile of bias_fwd_kernel shows whose it is
struct bias_gelu_fwd {
  static constexpr bool kResidual = false;
  __device__ static float op(float z, float) {
    return 0.5f * z * (1.0f + erff(z * kInvSqrt2));
  }
};

struct bias_residual_fwd {
  static constexpr bool kResidual = true;
  __device__ static float op(float z, float r) { return z + r; }
};

// grid (row strips of `rows`, column tiles); a thread takes rows
// kRowLanes apart; res: the residual (Epi::kResidual), else unread. It
// comes last: second, it cost the GeLU instance about 0.5% at BERT's
// served shape on an H100 (PERF.md).
template <typename T, int kV, typename Epi>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm)
    bias_fwd_kernel(const T* __restrict__ x,
                    const void* __restrict__ bias, int bias_dtype,
                    T* __restrict__ y, int64_t M, int C, int64_t rows,
                    int shift, const T* __restrict__ res) {
  constexpr int kStep = kRowLanes * kFwdRows;
  const int c = (blockIdx.y * kVecCols + threadIdx.x % kVecCols) * kV;
  if (c >= C) return;
  float b[kV];
  load_bias<kV>(bias, bias_dtype, c, C, shift, b);
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t r1 = s0 + rows < M ? s0 + rows : M;
  const int64_t r0 = s0 + threadIdx.x / kVecCols;
  Raw<T, kV> cur[kFwdRows], next[kFwdRows], rcur[kFwdRows], rnext[kFwdRows];
  load_rows<T, kV, kFwdRows>(x, r0, r1, C, c, cur);
  if constexpr (Epi::kResidual)
    load_rows<T, kV, kFwdRows>(res, r0, r1, C, c, rcur);
  for (int64_t r = r0; r < r1; r += kStep) {
    load_rows<T, kV, kFwdRows>(x, r + kStep, r1, C, c, next);
    if constexpr (Epi::kResidual)
      load_rows<T, kV, kFwdRows>(res, r + kStep, r1, C, c, rnext);
#pragma unroll
    for (int u = 0; u < kFwdRows; ++u) {
      const int64_t ru = r + u * kRowLanes;
      if (ru >= r1) break;
      float f[kV], q[kV] = {};
      unpack<T, kV>(cur[u], f);
      if constexpr (Epi::kResidual) unpack<T, kV>(rcur[u], q);
#pragma unroll
      for (int k = 0; k < kV; ++k) f[k] = Epi::op(f[k] + b[k], q[k]);
      *reinterpret_cast<Raw<T, kV>*>(y + ru * C + c) = pack<T, kV>(f);
    }
#pragma unroll
    for (int u = 0; u < kFwdRows; ++u) {
      cur[u] = next[u];
      if constexpr (Epi::kResidual) rcur[u] = rnext[u];
    }
  }
}

// grid (row strips of `rows`, column tiles), a thread taking rows
// kRowLanes apart; part: (gridDim.x, C) f32
template <typename T, int kV>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
    bias_gelu_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                         const void* __restrict__ bias, int bias_dtype,
                         T* __restrict__ dx, float* __restrict__ part,
                         int64_t M, int C, int64_t rows, int shift) {
  __shared__ float red[kRowLanes - 1][kVecCols * kV];
  const int tx = threadIdx.x % kVecCols, lane = threadIdx.x / kVecCols;
  const int c = (blockIdx.y * kVecCols + tx) * kV;
  const bool live = c < C;
  float b[kV], acc[kV];
#pragma unroll
  for (int k = 0; k < kV; ++k) acc[k] = 0.f;
  if (live) {
    constexpr int kStep = kRowLanes * kBwdRows;
    load_bias<kV>(bias, bias_dtype, c, C, shift, b);
    const int64_t s0 = static_cast<int64_t>(blockIdx.x) * rows;
    const int64_t r1 = s0 + rows < M ? s0 + rows : M;
    const int64_t r0 = s0 + lane;
    Raw<T, kV> cd[kBwdRows], cx[kBwdRows], nd[kBwdRows], nx[kBwdRows];
    load_rows<T, kV, kBwdRows>(dy, r0, r1, C, c, cd);
    load_rows<T, kV, kBwdRows>(x, r0, r1, C, c, cx);
    for (int64_t r = r0; r < r1; r += kStep) {
      load_rows<T, kV, kBwdRows>(dy, r + kStep, r1, C, c, nd);
      load_rows<T, kV, kBwdRows>(x, r + kStep, r1, C, c, nx);
#pragma unroll
      for (int u = 0; u < kBwdRows; ++u) {
        const int64_t ru = r + u * kRowLanes;
        if (ru >= r1) break;
        float d[kV], xv[kV];
        unpack<T, kV>(cd[u], d);
        unpack<T, kV>(cx[u], xv);
#pragma unroll
        for (int k = 0; k < kV; ++k) {
          const float z = xv[k] + b[k];
          const float cdf = 0.5f * (1.0f + erff(z * kInvSqrt2));
          const float pdf = expf(-0.5f * z * z) * kInvSqrt2Pi;
          d[k] = d[k] * (cdf + z * pdf);
          acc[k] += d[k];
        }
        *reinterpret_cast<Raw<T, kV>*>(dx + ru * C + c) = pack<T, kV>(d);
      }
#pragma unroll
      for (int u = 0; u < kBwdRows; ++u) {
        cd[u] = nd[u];
        cx[u] = nx[u];
      }
    }
  }
  // the block's row lanes, added in lane order, as one partial row
  if (live && lane > 0) {
#pragma unroll
    for (int k = 0; k < kV; ++k) red[lane - 1][tx * kV + k] = acc[k];
  }
  __syncthreads();
  if (!live || lane > 0) return;
#pragma unroll
  for (int l = 0; l < kRowLanes - 1; ++l) {
#pragma unroll
    for (int k = 0; k < kV; ++k) acc[k] += red[l][tx * kV + k];
  }
  float* pr = part + static_cast<int64_t>(blockIdx.x) * C + c;
  if constexpr (kV % 4 == 0) {
#pragma unroll
    for (int k = 0; k < kV; k += 4)
      *reinterpret_cast<float4*>(pr + k) =
          make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < kV; ++k) pr[k] = acc[k];
  }
}

// ordered_col_sum's writer: db[n] in the bias's dtype (named for the
// kernel, so that a profile of the reduction shows whose it is)
struct bias_gelu_bwd_sums {
  void* db;
  int dtype;
  __device__ void operator()(int64_t n, float v) const {
    store_f32(db, n, dtype, v);
  }
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// elements a thread of any of the three kernels takes along the row, the
// pointers aligned to 16 bytes: a 16-byte vector where the rows hold a
// whole number of them, else one (the element path)
int col_vector(int C, int bytes) {
  const int e = 16 / bytes;
  return C % e == 0 ? e : 1;
}

int64_t col_tiles(int C, int vec) {
  return (C / vec + kVecCols - 1) / kVecCols;
}

// row strips: per_sm blocks an SM over the column tiles, at least
// kRowLanes * held rows a strip, and no empty strip
int64_t row_strips(int64_t M, int C, int vec, int sms, int per_sm,
                   int held) {
  const int64_t most = (M + kRowLanes * held - 1) / (kRowLanes * held);
  int64_t s = static_cast<int64_t>(per_sm) * sms / col_tiles(C, vec);
  s = s < 1 ? 1 : s > most ? most : s;
  const int64_t rows = (M + s - 1) / s;
  return (M + rows - 1) / rows;
}

int64_t bwd_strips(int64_t M, int C, int vec, int sms) {
  return row_strips(M, C, vec, sms, kBwdBlocksPerSm, kBwdRows);
}

// res: the residual where Epi takes one, else nullptr
template <typename T, typename Epi>
int launch_fwd(const void* x, const void* res, const void* bias,
               int bias_dtype, void* y, int64_t M, int C, int sms, int shift,
               cudaStream_t stream) {
  const bool aligned = aligned16(x) && aligned16(y) &&
                       (!Epi::kResidual || aligned16(res));
  const int vec = aligned ? col_vector(C, sizeof(T)) : 1;
  const int64_t tiles = col_tiles(C, vec);
  const int64_t strips = row_strips(M, C, vec, sms, kFwdBlocksPerSm,
                                    kFwdRows);
  if (tiles > 65535 || strips > 0x7fffffff) return cudaErrorInvalidValue;
  const int64_t rows = (M + strips - 1) / strips;
  const dim3 grid(static_cast<unsigned>(strips),
                  static_cast<unsigned>(tiles));
  const T* xs = static_cast<const T*>(x);
  const T* rs = static_cast<const T*>(res);
  T* ys = static_cast<T*>(y);
  if (vec > 1)
    bias_fwd_kernel<T, 16 / sizeof(T), Epi><<<grid, kThreads, 0, stream>>>(
        xs, bias, bias_dtype, ys, M, C, rows, shift, rs);
  else
    bias_fwd_kernel<T, 1, Epi><<<grid, kThreads, 0, stream>>>(
        xs, bias, bias_dtype, ys, M, C, rows, shift, rs);
  return cudaSuccess;
}

template <typename T>
int launch_gelu_bwd(const void* dy, const void* x, const void* bias,
                    int bias_dtype, void* dx, float* part, int64_t strips,
                    void* db, int64_t M, int C, int sms, int shift,
                    cudaStream_t stream) {
  const int vec = aligned16(dy) && aligned16(x) && aligned16(dx)
                      ? col_vector(C, sizeof(T))
                      : 1;
  const int64_t tiles = col_tiles(C, vec);
  if (strips != bwd_strips(M, C, vec, sms) || tiles > 65535 ||
      strips > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int64_t rows = (M + strips - 1) / strips;
  const dim3 grid(static_cast<unsigned>(strips),
                  static_cast<unsigned>(tiles));
  const T* dys = static_cast<const T*>(dy);
  const T* xs = static_cast<const T*>(x);
  T* dxs = static_cast<T*>(dx);
  if (vec > 1)
    bias_gelu_bwd_kernel<T, 16 / sizeof(T)><<<grid, kThreads, 0, stream>>>(
        dys, xs, bias, bias_dtype, dxs, part, M, C, rows, shift);
  else
    bias_gelu_bwd_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        dys, xs, bias, bias_dtype, dxs, part, M, C, rows, shift);
  launch_col_sum(part, strips, C, bias_gelu_bwd_sums{db, bias_dtype},
                 stream, kDbRuns);
  return cudaSuccess;
}

template <typename Epi>
int fwd(const void* x, const void* res, const void* bias, void* y, int64_t M,
        int C, int sms, int dtype, int bias_dtype, int shift,
        cudaStream_t stream) {
  if (M < 1 || C < 1 || sms < 1) return cudaErrorInvalidValue;
  int rc;
  switch (dtype) {
    case kF32:
      rc = launch_fwd<float, Epi>(x, res, bias, bias_dtype, y, M, C, sms,
                                  shift, stream);
      break;
    case kBF16:
      rc = launch_fwd<__nv_bfloat16, Epi>(x, res, bias, bias_dtype, y, M, C,
                                          sms, shift, stream);
      break;
    case kF16:
      rc = launch_fwd<__half, Epi>(x, res, bias, bias_dtype, y, M, C, sms,
                                   shift, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return rc != cudaSuccess ? rc : static_cast<int>(cudaGetLastError());
}

int gelu_bwd(const void* dy, const void* x, const void* bias, void* dx,
             void* part, int64_t strips, void* db, int64_t M, int C, int sms,
             int dtype, int bias_dtype, int shift, cudaStream_t stream) {
  if (M < 1 || C < 1 || sms < 1) return cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  int rc;
  switch (dtype) {
    case kF32:
      rc = launch_gelu_bwd<float>(dy, x, bias, bias_dtype, dx, p, strips, db,
                                  M, C, sms, shift, stream);
      break;
    case kBF16:
      rc = launch_gelu_bwd<__nv_bfloat16>(dy, x, bias, bias_dtype, dx, p,
                                          strips, db, M, C, sms, shift,
                                          stream);
      break;
    case kF16:
      rc = launch_gelu_bwd<__half>(dy, x, bias, bias_dtype, dx, p, strips,
                                   db, M, C, sms, shift, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return rc != cudaSuccess ? rc : static_cast<int>(cudaGetLastError());
}

}  // namespace

// Elements a thread of the three kernels takes along a row of C elements
// of dtype code `dtype` when the pointers are 16-byte aligned: 16 /
// element size, or 1 for the element path (twin:
// cuda_epilogue.col_vector).
MXT_EXPORT int mxt_bias_col_vector(int C, int dtype) {
  return col_vector(C, dtype == kF32 ? 4 : 2);
}

// Row strips of the backward, the rows of its f32 scratch, for (M, C)
// rows taken `vec` elements a thread on a card of `sms` SMs (twin:
// cuda_epilogue.bwd_scratch_shape).
MXT_EXPORT int64_t mxt_bias_gelu_bwd_strips(int64_t M, int C, int vec,
                                            int sms) {
  if (M < 1 || C < 1 || vec < 1 || sms < 1) return 0;
  return bwd_strips(M, C, vec, sms);
}

// dy, x, dx: (M, C) contiguous of dtype code `dtype`; bias, db: (C,) of
// dtype code `bias_dtype`; part: f32 scratch of strips * C, where strips
// is mxt_bias_gelu_bwd_strips for this call (refused otherwise); sms: the
// card's SM count.
MXT_EXPORT int mxt_bias_gelu_bwd(const void* dy, const void* x,
                                 const void* bias, void* dx, void* part,
                                 int64_t strips, void* db, int64_t M, int C,
                                 int sms, int dtype, int bias_dtype,
                                 cudaStream_t stream) {
  return gelu_bwd(dy, x, bias, dx, part, strips, db, M, C, sms, dtype,
                  bias_dtype, 0, stream);
}

// x, y: (M, C) contiguous of dtype code `dtype`; bias: (C,) of dtype
// code `bias_dtype`; sms: the card's SM count.
MXT_EXPORT int mxt_bias_gelu_fwd(const void* x, const void* bias, void* y,
                                 int64_t M, int C, int sms, int dtype,
                                 int bias_dtype, cudaStream_t stream) {
  return fwd<bias_gelu_fwd>(x, nullptr, bias, y, M, C, sms, dtype,
                            bias_dtype, 0, stream);
}

// The two kernels with the bias read `shift` columns off: chip_smoke.py's
// planted fault, which its parity check must catch. Not for use.
MXT_EXPORT int mxt_bias_gelu_fwd_bias_shift(const void* x, const void* bias,
                                            void* y, int64_t M, int C,
                                            int sms, int dtype,
                                            int bias_dtype, int shift,
                                            cudaStream_t stream) {
  return fwd<bias_gelu_fwd>(x, nullptr, bias, y, M, C, sms, dtype,
                            bias_dtype, shift, stream);
}

MXT_EXPORT int mxt_bias_gelu_bwd_bias_shift(
    const void* dy, const void* x, const void* bias, void* dx, void* part,
    int64_t strips, void* db, int64_t M, int C, int sms, int dtype,
    int bias_dtype, int shift, cudaStream_t stream) {
  return gelu_bwd(dy, x, bias, dx, part, strips, db, M, C, sms, dtype,
                  bias_dtype, shift, stream);
}

// x, r, y: (M, C) contiguous of dtype code `dtype`; bias: (C,) of dtype
// code `bias_dtype`; sms: the card's SM count.
MXT_EXPORT int mxt_bias_residual_fwd(const void* x, const void* bias,
                                     const void* r, void* y, int64_t M,
                                     int C, int sms, int dtype,
                                     int bias_dtype, cudaStream_t stream) {
  return fwd<bias_residual_fwd>(x, r, bias, y, M, C, sms, dtype, bias_dtype,
                                0, stream);
}

// bias + residual with the bias read `shift` columns off: chip_smoke.py's
// planted fault, as for bias + GeLU above. Not for use.
MXT_EXPORT int mxt_bias_residual_fwd_bias_shift(
    const void* x, const void* bias, const void* r, void* y, int64_t M,
    int C, int sms, int dtype, int bias_dtype, int shift,
    cudaStream_t stream) {
  return fwd<bias_residual_fwd>(x, r, bias, y, M, C, sms, dtype, bias_dtype,
                                shift, stream);
}
