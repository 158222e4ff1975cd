// LayerNorm over the last axis, forward and backward, hand-written for
// Hopper.
//
// Forward: replaces the TPU kernel mxnet_tpu/ops/pallas_norm.py ::
// _fwd_call -> pallas_layer_norm_fwd. Same arithmetic: statistics in
// f32, mean = sum(x) / C, two-pass variance sum((x - mean)^2) / C,
// inv = rsqrt(var + eps), then ((x - mean) * inv) * gamma + beta with
// gamma/beta read as f32, output rounded to x's dtype. Each product is
// rounded before the next add, as in the plain version (no multiply-add
// contraction), so the two differ only in the order of the row sums.
//
// Bound: bytes. The kernel reads x once from device memory and writes y
// once (M * C elements each way, 0.94 us at BERT's served (1024, 768)
// bf16 on an H100); it does ~8 flops an element, far below the card's
// ratio of operations to bytes. At 1024 rows the time is a launch and
// one row's latency (load, two warp sums, store), so every load of a
// row has to be in flight at once and every SM must hold rows. Design:
//   - Register path (the row a whole number of 16-byte vectors, at most
//     kRegCols columns; x, y, gamma and beta 16-byte aligned): a warp a
//     row, blocks of kFwdWarps warps walking the rows with a grid stride,
//     at most kFwdBlocksPerSm blocks an SM (grid from the SM count). Each
//     lane loads its kNV 16-byte vectors of x once (3 at BERT's 768 in
//     bf16, all in flight together) and issues the next row's loads
//     before this row's arithmetic; the mean, the variance and y come
//     from those registers, so device memory sees x once and nothing is
//     re-read. gamma and beta are widened to f32 once per lane, for its
//     columns, with 16-byte loads, and stay in registers. y leaves as
//     16-byte stores, with the default cache policy: the next kernel
//     reads it. Offsets inside a row are 32-bit.
//   - Grid: at BERT's 4096 rows a warp takes two rows, the second's loads
//     in flight during the first's arithmetic; at 1024 rows one. One row
//     a warp on a full grid was slower on an H100 (PERF.md): 96
//     registers leave room for 5 blocks an SM, so a second wave.
//   - Chunked path (wider rows, or rows that are not whole aligned
//     vectors, such as C = 100 in bf16 or a view 2 bytes off alignment):
//     a warp a row, eight rows a block, element loads, three passes over
//     the row (L1 holds it after the first).
//
// Backward: its notes stand with its kernels, after the forward's.
#include "common.cuh"

namespace {

constexpr int kRegCols = 1024;  // widest row of the register path

// 16 bytes of T: kE elements, widened to f32 and rounded back
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kE = 4;
  __device__ static void load(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kE = 8;
  __device__ static void load(const uint4& v, float* f) {
    unpack_bf16x8(v, f);
  }
  __device__ static uint4 pack(const float* f) { return pack_bf16x8(f); }
};

template <>
struct Vec16<__half> {
  static constexpr int kE = 8;
  __device__ static void load(const uint4& v, float* f) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t w = word(v, k);
      f[2 * k] = __half2float(__ushort_as_half(static_cast<unsigned short>(w)));
      f[2 * k + 1] =
          __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
    }
  }
  __device__ static uint32_t two(float lo, float hi) {
    return static_cast<uint32_t>(__half_as_ushort(__float2half_rn(lo))) |
           (static_cast<uint32_t>(__half_as_ushort(__float2half_rn(hi))) << 16);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(two(f[0], f[1]), two(f[2], f[3]), two(f[4], f[5]),
                      two(f[6], f[7]));
  }
};

// 16-byte vectors per lane of the register path, forward and backward,
// for rows of C elements of `bytes` each, or 0 where the chunked path
// takes the rows (alignment of the pointers aside)
int reg_vectors(int C, int bytes) {
  const int e = 16 / bytes;
  if (C % e != 0 || C > kRegCols) return 0;
  const int nv = (C + 32 * e - 1) / (32 * e);
  return nv <= 4 ? nv : nv <= 6 ? 6 : 8;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---- forward -----------------------------------------------------------
constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdBlocksPerSm = 4;
constexpr int kChunkWarps = 8;  // chunked path: rows (warps) a block

// kE elements of P at p, in f32: one or two 16-byte loads, or one 8-byte
// load (p aligned to kE * sizeof(P) bytes)
template <typename P, int kE>
__device__ __forceinline__ void load_cols(const P* p, float* f) {
  using V = Vec16<P>;
  const uint4* q = reinterpret_cast<const uint4*>(p);
  if constexpr (kE == V::kE) {
    V::load(__ldg(q), f);
  } else if constexpr (kE == 2 * V::kE) {
    V::load(__ldg(q), f);
    V::load(__ldg(q + 1), f + V::kE);
  } else {
    static_assert(2 * kE == V::kE, "kE elements of P");
    const uint2 h = __ldg(reinterpret_cast<const uint2*>(p));
    float t[V::kE];
    V::load(make_uint4(h.x, h.y, 0u, 0u), t);
#pragma unroll
    for (int k = 0; k < kE; ++k) f[k] = t[k];
  }
}

// the kE values of columns [c, c + kE) of a parameter vector (gamma,
// beta) of dtype code `dtype`, in f32; read `shift` columns off (0, but
// for chip_smoke.py's planted fault) one element at a time
template <int kE>
__device__ __forceinline__ void load_params(const void* p, int dtype, int c,
                                            int C, int shift, float* f) {
  if (shift != 0) {
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int j = c + k + shift;
      f[k] = load_f32(p, j < C ? j : j - C, dtype);
    }
    return;
  }
  switch (dtype) {
    case kBF16:
      load_cols<__nv_bfloat16, kE>(
          static_cast<const __nv_bfloat16*>(p) + c, f);
      break;
    case kF16:
      load_cols<__half, kE>(static_cast<const __half*>(p) + c, f);
      break;
    default:
      load_cols<float, kE>(static_cast<const float*>(p) + c, f);
  }
}

template <typename T, int kNV>
__global__ void __launch_bounds__(kFwdThreads)
    layer_norm_fwd_rows(const T* __restrict__ x,
                        const void* __restrict__ gamma,
                        const void* __restrict__ beta, int param_dtype,
                        T* __restrict__ y, int64_t M, int C, float eps,
                        int shift) {
  using V = Vec16<T>;
  constexpr int kE = V::kE, kN = kNV * kE;
  const int lane = threadIdx.x & 31;
  const float fc = static_cast<float>(C);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kFwdWarps;
  int64_t row = static_cast<int64_t>(blockIdx.x) * kFwdWarps +
                (threadIdx.x >> 5);
  if (row >= M) return;
  int col[kNV];
  bool ok[kNV];
  uint4 cur[kNV], nxt[kNV];
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < kNV; ++j) {
    col[j] = (j * 32 + lane) * kE;
    ok[j] = col[j] < C;
    cur[j] = ok[j] ? *reinterpret_cast<const uint4*>(x + row * C + col[j])
                   : z;
  }
  float g[kN], b[kN];
#pragma unroll
  for (int j = 0; j < kNV; ++j) {
    if (ok[j]) {
      load_params<kE>(gamma, param_dtype, col[j], C, shift, g + j * kE);
      load_params<kE>(beta, param_dtype, col[j], C, 0, b + j * kE);
    }
  }
  for (; row < M; row += stride) {
    const int64_t next = row + stride;
#pragma unroll
    for (int j = 0; j < kNV; ++j)
      nxt[j] = ok[j] && next < M
                   ? *reinterpret_cast<const uint4*>(x + next * C + col[j])
                   : z;
    float f[kN];
#pragma unroll
    for (int j = 0; j < kNV; ++j) V::load(cur[j], f + j * kE);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kN; ++k) s += f[k];
    const float mean = warp_sum(s) / fc;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < kNV; ++j) {
      if (!ok[j]) continue;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float d = f[j * kE + e] - mean;
        v = __fadd_rn(v, __fmul_rn(d, d));
      }
    }
    const float inv = rsqrtf(warp_sum(v) / fc + eps);
    T* yr = y + row * C;
#pragma unroll
    for (int j = 0; j < kNV; ++j) {
      if (!ok[j]) continue;
      float o[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int k = j * kE + e;
        o[e] = __fadd_rn(__fmul_rn((f[k] - mean) * inv, g[k]), b[k]);
      }
      *reinterpret_cast<uint4*>(yr + col[j]) = V::pack(o);
    }
#pragma unroll
    for (int j = 0; j < kNV; ++j) cur[j] = nxt[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kChunkWarps * 32)
    layer_norm_fwd_chunked(const T* __restrict__ x,
                           const void* __restrict__ gamma,
                           const void* __restrict__ beta, int param_dtype,
                           T* __restrict__ y, int64_t M, int C, float eps,
                           int shift) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kChunkWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + row * C;
  T* yr = y + row * C;

  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
  const float mean = warp_sum(s) / static_cast<float>(C);

  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f32(xr[c]) - mean;
    v = __fadd_rn(v, __fmul_rn(d, d));
  }
  const float inv = rsqrtf(warp_sum(v) / static_cast<float>(C) + eps);

  for (int c = lane; c < C; c += 32) {
    const int cg = c + shift < C ? c + shift : c + shift - C;
    const float xhat = (to_f32(xr[c]) - mean) * inv;
    yr[c] = from_f32<T>(__fadd_rn(
        __fmul_rn(xhat, load_f32(gamma, cg, param_dtype)),
        load_f32(beta, c, param_dtype)));
  }
}

// blocks of the forward's grid: on the register path (nv > 0)
// kFwdBlocksPerSm blocks of kFwdWarps warps on each of the card's sms SMs,
// fewer where the rows run out (a warp takes a row at a time); on the
// chunked path a block of kChunkWarps rows
int64_t fwd_blocks(int64_t M, int nv, int sms) {
  if (nv == 0) return (M + kChunkWarps - 1) / kChunkWarps;
  const int64_t need = (M + kFwdWarps - 1) / kFwdWarps;
  const int64_t most = static_cast<int64_t>(kFwdBlocksPerSm) * sms;
  return need < most ? need : most;
}

template <typename T, int kNV>
void launch_fwd_rows(const void* x, const void* gamma, const void* beta,
                     int param_dtype, void* y, int64_t M, int C, float eps,
                     unsigned blocks, int shift, cudaStream_t stream) {
  layer_norm_fwd_rows<T, kNV><<<blocks, kFwdThreads, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, param_dtype, static_cast<T*>(y),
      M, C, eps, shift);
}

// blocks: 0 for the grid from the SM count (fwd_blocks), else the grid of
// the register path, 1 to a block for each kFwdWarps rows; the chunked
// path's grid is fixed (a block for each kChunkWarps rows)
template <typename T>
int launch_fwd(const void* x, const void* gamma, const void* beta,
               int param_dtype, void* y, int64_t M, int C, float eps,
               int sms, int64_t blocks_in, int shift, cudaStream_t stream) {
  int nv = reg_vectors(C, sizeof(T));
  if (!(aligned16(x) && aligned16(y) && aligned16(gamma) && aligned16(beta)))
    nv = 0;
  const int64_t dflt = fwd_blocks(M, nv, sms);
  const int64_t most = nv ? (M + kFwdWarps - 1) / kFwdWarps : dflt;
  if (blocks_in < 0 || blocks_in > most || blocks_in > 0x7fffffff ||
      (nv == 0 && blocks_in != 0 && blocks_in != dflt))
    return cudaErrorInvalidValue;
  const unsigned blocks =
      static_cast<unsigned>(blocks_in ? blocks_in : dflt);
  void (*rows)(const void*, const void*, const void*, int, void*, int64_t,
               int, float, unsigned, int, cudaStream_t) = nullptr;
  switch (nv) {
    case 1: rows = launch_fwd_rows<T, 1>; break;
    case 2: rows = launch_fwd_rows<T, 2>; break;
    case 3: rows = launch_fwd_rows<T, 3>; break;
    case 4: rows = launch_fwd_rows<T, 4>; break;
    default:
      if constexpr (sizeof(T) == 4)
        if (nv) rows = nv == 6 ? launch_fwd_rows<T, 6> : launch_fwd_rows<T, 8>;
  }
  if (rows != nullptr)
    rows(x, gamma, beta, param_dtype, y, M, C, eps, blocks, shift, stream);
  else
    layer_norm_fwd_chunked<T><<<blocks, kChunkWarps * 32, 0, stream>>>(
        static_cast<const T*>(x), gamma, beta, param_dtype,
        static_cast<T*>(y), M, C, eps, shift);
  return cudaSuccess;
}

int fwd(const void* x, const void* gamma, const void* beta, void* y,
        int64_t M, int C, float eps, int dtype, int param_dtype, int sms,
        int64_t blocks, int shift, cudaStream_t stream) {
  if (M < 1 || C < 1 || sms < 1 || shift < 0 || shift >= C ||
      (M + kChunkWarps - 1) / kChunkWarps > 0x7fffffff)
    return cudaErrorInvalidValue;
  int rc;
  switch (dtype) {
    case kF32:
      rc = launch_fwd<float>(x, gamma, beta, param_dtype, y, M, C, eps, sms,
                             blocks, shift, stream);
      break;
    case kBF16:
      rc = launch_fwd<__nv_bfloat16>(x, gamma, beta, param_dtype, y, M, C,
                                     eps, sms, blocks, shift, stream);
      break;
    case kF16:
      rc = launch_fwd<__half>(x, gamma, beta, param_dtype, y, M, C, eps, sms,
                              blocks, shift, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return rc != cudaSuccess ? rc : static_cast<int>(cudaGetLastError());
}

// ---- backward ----------------------------------------------------------
// Backward: replaces mxnet_tpu/ops/pallas_norm.py :: _bwd_call ->
// pallas_layer_norm_bwd. Same arithmetic: the row statistics re-derived
// from x (the forward saves none), two-pass variance, xhat = (x - mean) *
// inv, dyg = dy * gamma, m1 = mean(dyg), m2 = mean(dyg * xhat), dx = inv *
// (dyg - m1 - xhat * m2) rounded to x's dtype; dgamma = sum(dy * xhat) and
// dbeta = sum(dy) over the rows in f32, rounded to gamma's dtype at the
// end.
// Bound: bytes (dy and x read once, dx written once: 3 * M * C elements,
// 5.6 us at BERT's (4096, 768) bf16 on an H100). The TPU kernel carries
// dgamma/dbeta across its sequential grid steps; Hopper blocks run in no
// order. Design:
//   - Persistent blocks of 8 warps walk the rows with a grid stride, a
//     warp a row at a time; the wrapper sizes the grid from the SM count
//     (two blocks, 16 warps, an SM), so every SM has loads in flight.
//   - Register path (the row a whole number of 16-byte vectors, at most
//     kRegCols columns, 16-byte aligned): each lane loads its kNV vectors of
//     x and dy once, with 16-byte loads, and computes the statistics, m1,
//     m2 and dx from those registers: device memory sees x and dy once. The
//     lane's dgamma/dbeta sums stay in registers across every row the warp
//     takes; gamma, read once per block, sits in shared memory as f32 (in
//     registers too it pushed BERT's rows past the 128 registers that two
//     blocks an SM allow, into spills); dx leaves as 16-byte stores.
//   - Chunked path (wider rows, or rows that are not 16-byte aligned, such
//     as C = 100 in bf16): element loads, kChunk columns a sweep, each sweep
//     re-deriving the row statistics from the whole row.
//   - Each block adds its warps' dgamma/dbeta sums in a fixed tree order in
//     shared memory and writes one f32 partial row; ordered_col_sum
//     (common.cuh) then adds the partial rows in block order, up to 16 runs
//     of consecutive blocks in parallel. Deterministic, no atomics.
//   Staging the next row with cp.async while a row's arithmetic runs was
//   slower here (a warp takes about two of BERT's 4096 rows).
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kChunkCpl = 32;            // chunked path: columns per lane
constexpr int kChunk = 32 * kChunkCpl;   // columns per sweep

// The block's dgamma/dbeta sums: warp w's kN sums (at shared columns
// idx(k)) added into warp 0's in a fixed tree order, warps [4, 8) onto
// [0, 4), then [2, 4) onto [0, 2), then 1 onto 0. red: [4][2][stride].
template <int kN, typename Idx>
__device__ __forceinline__ void block_tree_sum(float* ag, float* ab,
                                               float* red, int stride,
                                               Idx idx) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = kBwdWarps / 2; s >= 1; s >>= 1) {
    if (warp >= s && warp < 2 * s) {
      float* r = red + (warp - s) * 2 * stride;
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        r[idx(k)] = ag[k];
        r[stride + idx(k)] = ab[k];
      }
    }
    __syncthreads();
    if (warp < s) {
      const float* r = red + warp * 2 * stride;
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        ag[k] += r[idx(k)];
        ab[k] += r[stride + idx(k)];
      }
    }
    __syncthreads();
  }
}

// part: (gridDim.x, 2, C) f32, each block's dgamma and dbeta row sums
template <typename T, int kNV>
__global__ void __launch_bounds__(kBwdThreads,
                                  kNV * Vec16<T>::kE <= 24 ? 2 : 1)
    layer_norm_bwd_rows(const T* __restrict__ dy, const T* __restrict__ x,
                        const void* __restrict__ gamma, int param_dtype,
                        T* __restrict__ dx, float* __restrict__ part,
                        int64_t M, int C, float eps) {
  using V = Vec16<T>;
  constexpr int kE = V::kE, kN = kNV * kE, kCols = kNV * 32 * kE;
  __shared__ __align__(16) float red[kBwdWarps / 2][2][kCols];
  __shared__ __align__(16) float gam[kCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float fc = static_cast<float>(C);
  for (int c = threadIdx.x; c < kCols; c += kBwdThreads)
    gam[c] = c < C ? load_f32(gamma, c, param_dtype) : 0.f;
  int col[kNV];
  bool ok[kNV];
  float ag[kN], ab[kN];
#pragma unroll
  for (int j = 0; j < kNV; ++j) {
    col[j] = (j * 32 + lane) * kE;
    ok[j] = col[j] < C;
#pragma unroll
    for (int e = 0; e < kE; ++e) ag[j * kE + e] = ab[j * kE + e] = 0.f;
  }
  __syncthreads();
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kBwdWarps + warp;
       row < M; row += static_cast<int64_t>(gridDim.x) * kBwdWarps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * C);
    const uint4* dyr = reinterpret_cast<const uint4*>(dy + row * C);
    uint4 xv[kNV], dv[kNV];
#pragma unroll
    for (int j = 0; j < kNV; ++j) {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      xv[j] = ok[j] ? __ldcs(xr + col[j] / kE) : z;
      dv[j] = ok[j] ? __ldcs(dyr + col[j] / kE) : z;
    }
    float f[kE], g[kE];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kNV; ++j) {
      V::load(xv[j], f);
#pragma unroll
      for (int e = 0; e < kE; ++e) s += f[e];
    }
    const float mean = warp_sum(s) / fc;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < kNV; ++j) {
      if (!ok[j]) continue;
      V::load(xv[j], f);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float d = f[e] - mean;
        v += d * d;
      }
    }
    const float inv = rsqrtf(warp_sum(v) / fc + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kNV; ++j) {
      V::load(xv[j], f);
      V::load(dv[j], g);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float dyg = g[e] * gam[col[j] + e];
        s1 += dyg;
        s2 += dyg * ((f[e] - mean) * inv);
      }
    }
    const float m1 = warp_sum(s1) / fc;
    const float m2 = warp_sum(s2) / fc;
    T* dxr = dx + row * C;
#pragma unroll
    for (int j = 0; j < kNV; ++j) {
      if (!ok[j]) continue;
      V::load(xv[j], f);
      V::load(dv[j], g);
      float o[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float xhat = (f[e] - mean) * inv;
        const float dyg = g[e] * gam[col[j] + e];
        o[e] = inv * (dyg - m1 - xhat * m2);
        ag[j * kE + e] += g[e] * xhat;
        ab[j * kE + e] += g[e];
      }
      __stcs(reinterpret_cast<uint4*>(dxr + col[j]), V::pack(o));
    }
  }
  block_tree_sum<kN>(ag, ab, &red[0][0][0], kCols,
                     [&](int k) { return col[k / kE] + k % kE; });
  if (warp != 0) return;
  float* pg = part + static_cast<int64_t>(blockIdx.x) * 2 * C;
#pragma unroll
  for (int j = 0; j < kNV; ++j) {
    if (!ok[j]) continue;
#pragma unroll
    for (int e = 0; e < kE; e += 4) {
      const int k = j * kE + e;
      *reinterpret_cast<float4*>(pg + col[j] + e) =
          make_float4(ag[k], ag[k + 1], ag[k + 2], ag[k + 3]);
      *reinterpret_cast<float4*>(pg + C + col[j] + e) =
          make_float4(ab[k], ab[k + 1], ab[k + 2], ab[k + 3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 2)
    layer_norm_bwd_chunked(const T* __restrict__ dy, const T* __restrict__ x,
                           const void* __restrict__ gamma, int param_dtype,
                           T* __restrict__ dx, float* __restrict__ part,
                           int64_t M, int C, float eps) {
  __shared__ float red[kBwdWarps / 2][2][kChunk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float fc = static_cast<float>(C);
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    float ag[kChunkCpl], ab[kChunkCpl];
#pragma unroll
    for (int k = 0; k < kChunkCpl; ++k) ag[k] = ab[k] = 0.f;
    for (int64_t row = static_cast<int64_t>(blockIdx.x) * kBwdWarps + warp;
         row < M; row += static_cast<int64_t>(gridDim.x) * kBwdWarps) {
      const T* xr = x + row * C;
      const T* dyr = dy + row * C;
      T* dxr = dx + row * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
      const float mean = warp_sum(s) / fc;
      float v = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f32(xr[c]) - mean;
        v += d * d;
      }
      const float inv = rsqrtf(warp_sum(v) / fc + eps);
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float xhat = (to_f32(xr[c]) - mean) * inv;
        const float dyg = to_f32(dyr[c]) * load_f32(gamma, c, param_dtype);
        s1 += dyg;
        s2 += dyg * xhat;
      }
      const float m1 = warp_sum(s1) / fc;
      const float m2 = warp_sum(s2) / fc;
#pragma unroll
      for (int k = 0; k < kChunkCpl; ++k) {
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
    block_tree_sum<kChunkCpl>(ag, ab, &red[0][0][0], kChunk,
                              [&](int k) { return lane + 32 * k; });
    if (warp == 0) {
      float* pg = part + static_cast<int64_t>(blockIdx.x) * 2 * C;
#pragma unroll
      for (int k = 0; k < kChunkCpl; ++k) {
        const int c = c0 + lane + 32 * k;
        if (c < C) {
          pg[c] = ag[k];
          pg[C + c] = ab[k];
        }
      }
    }
  }
}

// ordered_col_sum's writer: column n < C of the partial rows is dgamma[n],
// column C + n is dbeta[n], in the parameters' dtype (named for the
// kernel, so that a profile of the reduction shows whose it is)
struct layer_norm_bwd_sums {
  void* dgamma;
  void* dbeta;
  int C, dtype;
  __device__ void operator()(int64_t n, float v) const {
    if (n < C)
      store_f32(dgamma, n, dtype, v);
    else
      store_f32(dbeta, n - C, dtype, v);
  }
};

template <typename T, int kNV>
void launch_rows(const void* dy, const void* x, const void* gamma,
                 int param_dtype, void* dx, float* part, int64_t M, int C,
                 float eps, int blocks, cudaStream_t stream) {
  layer_norm_bwd_rows<T, kNV><<<blocks, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), gamma,
      param_dtype, static_cast<T*>(dx), part, M, C, eps);
}

template <typename T>
void launch_bwd(const void* dy, const void* x, const void* gamma,
                int param_dtype, void* dx, float* part, void* dgamma,
                void* dbeta, int64_t M, int C, float eps, int blocks,
                cudaStream_t stream) {
  int nv = reg_vectors(C, sizeof(T));
  if (!(aligned16(dy) && aligned16(x) && aligned16(dx))) nv = 0;
  void (*rows)(const void*, const void*, const void*, int, void*, float*,
               int64_t, int, float, int, cudaStream_t) = nullptr;
  switch (nv) {
    case 1: rows = launch_rows<T, 1>; break;
    case 2: rows = launch_rows<T, 2>; break;
    case 3: rows = launch_rows<T, 3>; break;
    case 4: rows = launch_rows<T, 4>; break;
    default:
      if constexpr (sizeof(T) == 4)
        if (nv) rows = nv == 6 ? launch_rows<T, 6> : launch_rows<T, 8>;
  }
  if (rows != nullptr)
    rows(dy, x, gamma, param_dtype, dx, part, M, C, eps, blocks, stream);
  else
    layer_norm_bwd_chunked<T><<<blocks, kBwdThreads, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), gamma,
        param_dtype, static_cast<T*>(dx), part, M, C, eps);
  launch_col_sum(part, blocks, 2 * static_cast<int64_t>(C),
                 layer_norm_bwd_sums{dgamma, dbeta, C, param_dtype}, stream);
}

}  // namespace

// 16-byte vectors per lane of the register path, forward and backward,
// for rows of C elements of dtype code `dtype` whose pointers are 16-byte
// aligned, or 0 where the chunked path takes them (twin:
// cuda_norm.reg_vectors)
MXT_EXPORT int mxt_layer_norm_vectors(int C, int dtype) {
  return reg_vectors(C, dtype == kF32 ? 4 : 2);
}

// Blocks of the forward's grid for (M, C) rows of dtype code `dtype`, the
// pointers 16-byte aligned or not, on a card of `sms` SMs (twin:
// cuda_norm.fwd_blocks)
MXT_EXPORT int64_t mxt_layer_norm_fwd_blocks(int64_t M, int C, int dtype,
                                             int aligned, int sms) {
  if (M < 1 || C < 1 || sms < 1) return 0;
  return fwd_blocks(M, aligned ? reg_vectors(C, dtype == kF32 ? 4 : 2) : 0,
                    sms);
}

// dy, x, dx: (M, C) contiguous, dtype code `dtype`; gamma, dgamma,
// dbeta: (C,) of dtype code `param_dtype`; part: f32 scratch of
// blocks * 2 * C, blocks the persistent grid (>= 1).
MXT_EXPORT int mxt_layer_norm_bwd(const void* dy, const void* x,
                                  const void* gamma, void* dx, void* part,
                                  void* dgamma, void* dbeta, int64_t M,
                                  int C, float eps, int dtype,
                                  int param_dtype, int blocks,
                                  cudaStream_t stream) {
  if (M < 1 || C < 1 || blocks < 1) return cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  switch (dtype) {
    case kF32:
      launch_bwd<float>(dy, x, gamma, param_dtype, dx, p, dgamma, dbeta, M,
                        C, eps, blocks, stream);
      break;
    case kBF16:
      launch_bwd<__nv_bfloat16>(dy, x, gamma, param_dtype, dx, p, dgamma,
                                dbeta, M, C, eps, blocks, stream);
      break;
    case kF16:
      launch_bwd<__half>(dy, x, gamma, param_dtype, dx, p, dgamma, dbeta, M,
                         C, eps, blocks, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (M, C) contiguous, dtype code `dtype`; gamma, beta: (C,) of
// dtype code `param_dtype`; sms: the card's SM count; blocks: 0 for the
// grid from sms, else the register path's grid, from 1 to a block for
// each kFwdWarps rows (the chunked path takes only its own grid; any
// other value is refused).
MXT_EXPORT int mxt_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, int64_t M,
                                  int C, float eps, int dtype,
                                  int param_dtype, int sms, int64_t blocks,
                                  cudaStream_t stream) {
  return fwd(x, gamma, beta, y, M, C, eps, dtype, param_dtype, sms, blocks,
             0, stream);
}

// The forward with gamma read `shift` columns off (0 < shift < C):
// chip_smoke.py's planted fault, which its parity check must catch. Not
// for use.
MXT_EXPORT int mxt_layer_norm_fwd_gamma_shift(const void* x,
                                              const void* gamma,
                                              const void* beta, void* y,
                                              int64_t M, int C, float eps,
                                              int dtype, int param_dtype,
                                              int sms, int shift,
                                              cudaStream_t stream) {
  return fwd(x, gamma, beta, y, M, C, eps, dtype, param_dtype, sms, 0,
             shift, stream);
}
