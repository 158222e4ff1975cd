// Fused BN backward + dual matmul of a 1x1 convolution, hand-written for
// Hopper.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_fused.py :: _dual_bwd (the
// `kernel` of its pallas_call). Same arithmetic, per element (m, o) of
// the [M, O] view:
//   jg  = jg[m, o], masked by relu: none, scale_shift (y*scale + shift
//         > 0) or out (mask > 0, compared in f32); written as bf16 when
//         jgout is given;
//   cdy = bf16(jg * a + y * b_c + c_c), rounded ONCE: the same bits feed
//         both products;
//   dx  = cdy . W^T in f32 (+ addend in f32), then rounded to bf16;
//         with y3p (emit_next) dx is first masked by x > 0, and the sums
//         S1 = sum_m dx, S2 = sum_m dx * (y3p - mprev) are taken from the
//         bf16-rounded dx;
//   dW  = sum_m x^T . cdy in f32.
// Products are bf16 x bf16 with f32 accumulation (mma.sync m16n8k16).
// The f32 elementwise operations use __fmul_rn / __fadd_rn so nvcc does
// not contract them into FMAs: their order and roundings are the plain
// version's (ops/cuda_fused.py :: dual_bwd_plain).
//
// Bound: at ResNet-50's shapes, bytes (an operand is read once and the
// outputs written once: about 231 MB for stage 1's tail at batch 32, 69
// us at 3.35 TB/s, against 6.6 GFLOP, 6.7 us at the bf16 tensor peak).
// Design, right and simple first: ONE launch whose blocks take one of two
// roles.
//   dx blocks: a 128-row x 64-column tile of dx; the loop over O builds
//     each 128 x 32 tile of cdy in shared memory from jg, y (and the
//     mask) and multiplies it with the matching 64 x 32 tile of W. The
//     column-0 blocks also write the masked jg. With emit_next each block
//     writes one partial row of S1 and S2 (its 128 rows, summed in a
//     fixed order).
//   dW blocks: a 64 (I) x 128 (O) tile of dW over one split of the rows;
//     x^T and cdy^T tiles are built in shared memory (cdy recomputed with
//     the same f32 operations, so its bits are the dx blocks' bits), and
//     each block writes an f32 partial of its split.
// The TPU kernel adds dW and the sums across sequential grid steps;
// Hopper blocks run in no order, so a second small kernel adds the
// partials in split (row-block) order: deterministic, no atomics.
// Both launches are one call of mxt_dual_bwd (counted once, as the
// reductions of layer_norm.cu and epilogue.cu are). Not yet: cp.async or
// TMA pipelining, wgmma, ldmatrix; cdy is rebuilt once per 64 columns of
// dx and once per 64 rows of dW.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // 8 warps, each a 32 x 32 output tile
constexpr int kBK = 32;            // depth of one shared-memory tile
constexpr int kLd = kBK + 8;       // padded row: conflict-free fragments
constexpr int kDxRows = 128;       // dx tile: 128 rows x 64 columns of I
constexpr int kDxCols = 64;
constexpr int kDwI = 64;           // dW tile: 64 (I) x 128 (O)
constexpr int kDwO = 128;

enum MaskMode { kMaskNone = 0, kMaskScaleShift = 1, kMaskOut = 2 };

struct DualArgs {
  const __nv_bfloat16* jg;
  const __nv_bfloat16* y;
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const float* coef;               // [8, O]: a, b_c, c_c, scale, shift
  const __nv_bfloat16* mask;       // [M, O] or null
  const __nv_bfloat16* addend;     // [M, I] or null
  const __nv_bfloat16* y3p;        // [M, I] or null (emit_next)
  const float* mprev;              // [I] or null
  __nv_bfloat16* dx;               // [M, I]
  __nv_bfloat16* jgout;            // [M, O] or null
  float* part_dw;                  // [splits, I, O]
  float* part_sums;                // [tiles_m, 2, I] or null
  int64_t M;
  int I, O, mask_mode;
  int64_t rows_per_split;
  int tiles_i_dx, n_dx, tiles_i_dw, tiles_o;
};

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// cdy of element (m, o) in f32 before its rounding; *jgm gets the masked
// jg. The plain version: jg*a + y*b_c + c_c, left to right.
__device__ __forceinline__ float cdy_of(const DualArgs& a, int64_t m, int o,
                                        float* jgm) {
  const int64_t e = m * a.O + o;
  float jg = bf(a.jg[e]);
  const float yv = bf(a.y[e]);
  if (a.mask_mode == kMaskScaleShift) {
    const float z = __fadd_rn(__fmul_rn(yv, a.coef[3 * a.O + o]),
                              a.coef[4 * a.O + o]);
    if (!(z > 0.f)) jg = 0.f;
  } else if (a.mask_mode == kMaskOut) {
    if (!(bf(a.mask[e]) > 0.f)) jg = 0.f;
  }
  *jgm = jg;
  return __fadd_rn(__fadd_rn(__fmul_rn(jg, a.coef[o]),
                             __fmul_rn(yv, a.coef[a.O + o])),
                   a.coef[2 * a.O + o]);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc += As[rows of this warp][0:kBK] . Bs[cols of this warp][0:kBK]^T,
// both tiles K-contiguous with row stride kLd. The warp's tile is rows
// [wm*32, wm*32+32) x cols [wn*32, wn*32+32): 2 x 4 mma tiles.
// acc[mi][ni][r] holds row wm*32 + mi*16 + g + 8*(r >> 1), col wn*32 +
// ni*8 + 2*t + (r & 1), with g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void warp_mma(const __nv_bfloat16* As,
                                         const __nv_bfloat16* Bs, int wm,
                                         int wn, float acc[2][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t af[2][4], bfr[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const __nv_bfloat16* p = As + (wm * 32 + mi * 16 + g) * kLd + kk + 2 * t;
      af[mi][0] = ld32(p);
      af[mi][1] = ld32(p + 8 * kLd);
      af[mi][2] = ld32(p + 8);
      af[mi][3] = ld32(p + 8 * kLd + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const __nv_bfloat16* p = Bs + (wn * 32 + ni * 8 + g) * kLd + kk + 2 * t;
      bfr[ni][0] = ld32(p);
      bfr[ni][1] = ld32(p + 8);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma16816(acc[mi][ni], af[mi], bfr[ni]);
  }
}

// dx tile (tm, ti): rows [tm*128, +128) x columns [ti*64, +64) of I.
__device__ void dx_block(const DualArgs& a, int bid, __nv_bfloat16* As,
                         __nv_bfloat16* Bs, float (*red)[kDxCols][2]) {
  const int tm = bid / a.tiles_i_dx, ti = bid % a.tiles_i_dx;
  const int64_t m0 = static_cast<int64_t>(tm) * kDxRows;
  const int i0 = ti * kDxCols;
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  const bool write_jg = a.jgout != nullptr && ti == 0;
  float acc[2][4][4] = {};
  for (int k0 = 0; k0 < a.O; k0 += kBK) {
    for (int e = threadIdx.x; e < kDxRows * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int64_t m = m0 + r;
      const int o = k0 + c;
      float v = 0.f;
      if (m < a.M && o < a.O) {
        float jgm;
        v = cdy_of(a, m, o, &jgm);
        if (write_jg) a.jgout[m * a.O + o] = __float2bfloat16_rn(jgm);
      }
      As[r * kLd + c] = __float2bfloat16_rn(v);
    }
    for (int e = threadIdx.x; e < kDxCols * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int i = i0 + r, o = k0 + c;
      Bs[r * kLd + c] = (i < a.I && o < a.O)
                            ? a.w[static_cast<int64_t>(i) * a.O + o]
                            : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    warp_mma(As, Bs, wm, wn, acc);
    __syncthreads();
  }

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool emit_next = a.y3p != nullptr;
  float cs1[4][2] = {}, cs2[4][2] = {};
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int64_t m = m0 + wm * 32 + mi * 16 + g + 8 * (r >> 1);
        const int i = i0 + wn * 32 + ni * 8 + 2 * t + (r & 1);
        if (m >= a.M || i >= a.I) continue;
        const int64_t e = m * a.I + i;
        float v = acc[mi][ni][r];
        if (a.addend != nullptr) v = __fadd_rn(v, bf(a.addend[e]));
        if (emit_next) {
          if (!(bf(a.x[e]) > 0.f)) v = 0.f;
          const __nv_bfloat16 q = __float2bfloat16_rn(v);
          a.dx[e] = q;
          const float qf = bf(q);
          cs1[ni][r & 1] += qf;
          cs2[ni][r & 1] += __fmul_rn(qf, __fsub_rn(bf(a.y3p[e]), a.mprev[i]));
        } else {
          a.dx[e] = __float2bfloat16_rn(v);
        }
      }
  if (!emit_next) return;
  // column sums: over the 8 lanes of one t (same columns), then over the
  // 4 warps of one wn, in a fixed order
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cs1[ni][j] += __shfl_xor_sync(0xffffffffu, cs1[ni][j], off);
        cs2[ni][j] += __shfl_xor_sync(0xffffffffu, cs2[ni][j], off);
      }
  if (g == 0) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 32 + ni * 8 + 2 * t + j;
        red[wm][c][0] = cs1[ni][j];
        red[wm][c][1] = cs2[ni][j];
      }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kDxCols; c += kThreads) {
    const int i = i0 + c;
    if (i >= a.I) continue;
    float s1 = 0.f, s2 = 0.f;
    for (int q = 0; q < kDxRows / 32; ++q) {
      s1 += red[q][c][0];
      s2 += red[q][c][1];
    }
    float* row = a.part_sums + static_cast<int64_t>(tm) * 2 * a.I;
    row[i] = s1;
    row[a.I + i] = s2;
  }
}

// dW partial of tile (ti, to) over the rows of one split.
__device__ void dw_block(const DualArgs& a, int bid, __nv_bfloat16* As,
                         __nv_bfloat16* Bs) {
  const int per_split = a.tiles_i_dw * a.tiles_o;
  const int split = bid / per_split, rest = bid % per_split;
  const int ti = rest / a.tiles_o, to = rest % a.tiles_o;
  const int i0 = ti * kDwI, o0 = to * kDwO;
  const int64_t r0 = static_cast<int64_t>(split) * a.rows_per_split;
  const int64_t r1 =
      r0 + a.rows_per_split < a.M ? r0 + a.rows_per_split : a.M;
  const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  float acc[2][4][4] = {};
  for (int64_t k0 = r0; k0 < r1; k0 += kBK) {
    // As[i][k] = x[k0 + k][i0 + i]: x^T, neighbouring threads read
    // neighbouring columns of one row of x
    for (int e = threadIdx.x; e < kDwI * kBK; e += kThreads) {
      const int k = e / kDwI, il = e % kDwI;
      const int64_t m = k0 + k;
      const int i = i0 + il;
      As[il * kLd + k] = (m < r1 && i < a.I) ? a.x[m * a.I + i]
                                             : __float2bfloat16_rn(0.f);
    }
    // Bs[o][k] = cdy[k0 + k][o0 + o]
    for (int e = threadIdx.x; e < kDwO * kBK; e += kThreads) {
      const int k = e / kDwO, ol = e % kDwO;
      const int64_t m = k0 + k;
      const int o = o0 + ol;
      float v = 0.f;
      if (m < r1 && o < a.O) {
        float jgm;
        v = cdy_of(a, m, o, &jgm);
      }
      Bs[ol * kLd + k] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    warp_mma(As, Bs, wm, wn, acc);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* part = a.part_dw + static_cast<int64_t>(split) * a.I * a.O;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + wm * 32 + mi * 16 + g + 8 * (r >> 1);
        const int o = o0 + wn * 32 + ni * 8 + 2 * t + (r & 1);
        if (i < a.I && o < a.O)
          part[static_cast<int64_t>(i) * a.O + o] = acc[mi][ni][r];
      }
}

__global__ void __launch_bounds__(kThreads) dual_bwd_kernel(DualArgs a) {
  // dx blocks: As 128 x kLd, Bs 64 x kLd; dW blocks: As 64, Bs 128 rows
  __shared__ __align__(16) __nv_bfloat16 smem[(kDxRows + kDxCols) * kLd];
  __shared__ float red[kDxRows / 32][kDxCols][2];
  if (static_cast<int>(blockIdx.x) < a.n_dx)
    dx_block(a, blockIdx.x, smem, smem + kDxRows * kLd, red);
  else
    dw_block(a, blockIdx.x - a.n_dx, smem, smem + kDwI * kLd);
}

// dW = sum over splits of part_dw, and the chaining sums over row tiles,
// each in order
__global__ void dual_bwd_reduce(const float* __restrict__ part_dw,
                                int splits, int64_t n_dw, float* dw,
                                const float* __restrict__ part_sums,
                                int tiles_m, int two_i, float* sums) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx < n_dw) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part_dw[s * n_dw + idx];
    dw[idx] = acc;
  } else if (part_sums != nullptr && idx < n_dw + two_i) {
    const int j = static_cast<int>(idx - n_dw);
    float acc = 0.f;
    for (int q = 0; q < tiles_m; ++q)
      acc += part_sums[static_cast<int64_t>(q) * two_i + j];
    sums[j] = acc;
  }
}

}  // namespace

// jg, y: [M, O] bf16; x: [M, I] bf16; w: [I, O] bf16; coef: [8, O] f32;
// mask: [M, O] bf16 for mask_mode 2, else null; addend: [M, I] bf16 or
// null; y3p: [M, I] bf16 and mprev: [I] f32, or both null; outputs dx
// [M, I] bf16, dw [I, O] f32, jgout [M, O] bf16 or null, sums [2, I] f32
// (with y3p). Scratch: part_dw [splits, I, O] f32 with splits *
// rows_per_split >= M and rows_per_split a multiple of 32; part_sums
// [ceil(M / 128), 2, I] f32 with y3p. All contiguous.
MXT_EXPORT int mxt_dual_bwd(const void* jg, const void* y, const void* x,
                            const void* w, const void* coef,
                            const void* mask, const void* addend,
                            const void* y3p, const void* mprev, void* dx,
                            void* dw, void* jgout, void* sums,
                            void* part_dw, void* part_sums, int64_t M, int I,
                            int O, int mask_mode, int splits,
                            int64_t rows_per_split, cudaStream_t stream) {
  if (M < 1 || I < 1 || O < 1 || splits < 1 || rows_per_split < 1 ||
      rows_per_split % kBK != 0 ||
      static_cast<int64_t>(splits) * rows_per_split < M)
    return cudaErrorInvalidValue;
  if (mask_mode < kMaskNone || mask_mode > kMaskOut ||
      (mask_mode == kMaskOut) != (mask != nullptr) ||
      (y3p == nullptr) != (mprev == nullptr) ||
      (y3p == nullptr) != (sums == nullptr) ||
      (y3p == nullptr) != (part_sums == nullptr))
    return cudaErrorInvalidValue;
  DualArgs a;
  a.jg = static_cast<const __nv_bfloat16*>(jg);
  a.y = static_cast<const __nv_bfloat16*>(y);
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.coef = static_cast<const float*>(coef);
  a.mask = static_cast<const __nv_bfloat16*>(mask);
  a.addend = static_cast<const __nv_bfloat16*>(addend);
  a.y3p = static_cast<const __nv_bfloat16*>(y3p);
  a.mprev = static_cast<const float*>(mprev);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.jgout = static_cast<__nv_bfloat16*>(jgout);
  a.part_dw = static_cast<float*>(part_dw);
  a.part_sums = static_cast<float*>(part_sums);
  a.M = M;
  a.I = I;
  a.O = O;
  a.mask_mode = mask_mode;
  a.rows_per_split = rows_per_split;
  const int64_t tiles_m = (M + kDxRows - 1) / kDxRows;
  a.tiles_i_dx = (I + kDxCols - 1) / kDxCols;
  a.tiles_i_dw = (I + kDwI - 1) / kDwI;
  a.tiles_o = (O + kDwO - 1) / kDwO;
  const int64_t n_dx = tiles_m * a.tiles_i_dx;
  const int64_t n_dw =
      static_cast<int64_t>(a.tiles_i_dw) * a.tiles_o * splits;
  if (n_dx + n_dw > 0x7fffffff) return cudaErrorInvalidValue;
  a.n_dx = static_cast<int>(n_dx);
  dual_bwd_kernel<<<static_cast<unsigned>(n_dx + n_dw), kThreads, 0,
                    stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_w = static_cast<int64_t>(I) * O;
  const int two_i = y3p != nullptr ? 2 * I : 0;
  const int64_t total = n_w + two_i;
  dual_bwd_reduce<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                    stream>>>(static_cast<const float*>(part_dw), splits, n_w,
                              static_cast<float*>(dw),
                              static_cast<const float*>(part_sums),
                              static_cast<int>(tiles_m), two_i,
                              static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}
