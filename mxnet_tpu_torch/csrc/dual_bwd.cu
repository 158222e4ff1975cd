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
// The TPU kernel adds dW and the sums across sequential grid steps;
// Hopper blocks run in no order. Design, one call of mxt_dual_bwd
// (counted once) of up to five launches:
//   1. dual_bwd_cdy: one pass over jg, y (and the mask), 16-byte loads and
//      stores, forms cdy once per element into a bf16 [M, O] scratch, and
//      writes the masked jg; the block's slice of the coefficients sits in
//      shared memory. Both products then read cdy, so neither rebuilds it
//      tile by tile (the TPU kernel rebuilds it for every block of each
//      product).
//   2. dual_bwd_main: one launch, blocks in one of two roles. Both feed
//      mma.sync from ldmatrix, out of a kStages-deep ring of tiles in
//      shared memory that 16-byte cp.async fills ahead of the products
//      (zero-filled past the edges):
//      dx blocks: a 128 x 64 tile of dx = cdy . W^T over one slice of O.
//        Where the dx tiles alone would give fewer than about two blocks an
//        SM, the wrapper splits the O depth into slices and each block
//        writes an f32 partial tile; otherwise the block runs the epilogue
//        itself (addend, x > 0 mask, bf16 rounding, one partial row of S1
//        and S2 per 128 rows). Either way the tile passes through shared
//        memory first, so that its loads and stores move 16 bytes a
//        thread, neighbouring threads on neighbouring addresses.
//      dW blocks: a 64 (I) x 128 (O) tile of dW = x^T . cdy over one split
//        of the rows, ldmatrix.trans giving both x^T and cdy from their
//        row-major tiles; one f32 partial per split.
//   3. dual_bwd_dx_epilogue (split dx only): adds the slices in slice
//      order, then the same epilogue, 32 x 64 a block, one partial row of
//      S1 and S2 per block.
//   4, 5. ordered_col_sum (common.cuh): dW's splits, then the S1/S2 rows,
//      added in a fixed order. Deterministic, no atomics.
// Where I <= 64 and 128 < O <= 256 without the chaining sums (stage 1's
// tails and downsample) one launch, dual_bwd_fused, takes both products in
// one block (see there), then the ordered sum of dW. Wider calls, whose W
// or dW outgrows a block, keep the cdy pass, and so do narrower O, where
// the cdy pass is as fast (the wrapper's plan; PERF.md, Findings, holds
// the measured cut-over).
// Shapes whose I or O is not a multiple of 8, or pointers not 16-byte
// aligned, take element loads and stores in place of the 16-byte ones.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;      // 8 warps, each a 32 x 32 output tile
constexpr int kBK = 32;            // depth of one step of the products
constexpr int kStages = 3;         // tiles in flight in the ring
constexpr int kDxRows = 128;       // dx tile: 128 rows x 64 columns of I
constexpr int kDxCols = 64;
constexpr int kDwI = 64;           // dW tile: 64 (I) x 128 (O)
constexpr int kDwO = 128;
constexpr int kLdK = kBK + 8;      // dx tiles [row][k], padded rows
constexpr int kLdX = kDwI + 8;     // dW tiles [k][i] and [k][o]
constexpr int kLdC = kDwO + 8;
constexpr int kDxStage = (kDxRows + kDxCols) * kLdK;
constexpr int kDwStage = kBK * (kLdX + kLdC);
constexpr int kStage = kDxStage > kDwStage ? kDxStage : kDwStage;
constexpr int kLdT = kDxCols + 8;  // the dx tile in f32 for its epilogue
constexpr int kEpiRows = 32;       // rows of one split-dx epilogue block
// the dx tile in f32, and then the S1/S2 rows, reuse the ring
static_assert(kDxRows * kLdT * 4 <= kStages * kStage * 2 &&
                  (kThreads / 8) * kDxCols * 2 * 4 <= kStages * kStage * 2,
              "the dx epilogue's tiles must fit the ring");
constexpr int kPreCols = 512;      // columns of one cdy block

enum MaskMode { kMaskNone = 0, kMaskScaleShift = 1, kMaskOut = 2 };

struct DualArgs {
  const bf16* jg;
  const bf16* y;
  const bf16* x;
  const bf16* w;
  const float* coef;               // [8, O]: a, b_c, c_c, scale, shift
  const bf16* mask;                // [M, O] or null
  const bf16* addend;              // [M, I] or null
  const bf16* y3p;                 // [M, I] or null (emit_next)
  const float* mprev;              // [I] or null
  bf16* dx;                        // [M, I]
  bf16* jgout;                     // [M, O] or null
  bf16* cdy;                       // [M, O] scratch
  float* part_dw;                  // [splits_w, I, O]
  float* part_dx;                  // [splits_x, M, I] or null (one slice)
  float* part_sums;                // [sum tiles, 2, I] or null
  int64_t M;
  int I, O, mask_mode;
  int64_t rows_w;                  // rows of one dW split
  int depth_x, splits_x;           // O depth of one dx slice, slices
  int tiles_i_dx, tiles_dx, tiles_i_dw, tiles_o, n_dx;
  bool vec;                        // 16-byte loads and stores
};

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// cdy of one element in f32 before its rounding, from its jg, y and mask
// and its column's coefficients cf[0..4]; *jgm gets the masked jg. The
// plain version: jg*a + y*b_c + c_c, left to right.
__device__ __forceinline__ float cdy_of(float jg, float yv, float maskv,
                                        int mode, const float* cf, int ld,
                                        float* jgm) {
  if (mode == kMaskScaleShift) {
    if (!(__fadd_rn(__fmul_rn(yv, cf[3 * ld]), cf[4 * ld]) > 0.f)) jg = 0.f;
  } else if (mode == kMaskOut) {
    if (!(maskv > 0.f)) jg = 0.f;
  }
  *jgm = jg;
  return __fadd_rn(__fadd_rn(__fmul_rn(jg, cf[0]), __fmul_rn(yv, cf[ld])),
                   cf[2 * ld]);
}

// ---- 1. cdy and the masked jg -----------------------------------------
// grid (row blocks, ceil(O / kPreCols)): a block takes kPreCols columns
// and walks the rows with a grid stride; a thread 8 columns of a row.
__global__ void __launch_bounds__(kThreads) dual_bwd_cdy(DualArgs a) {
  __shared__ float cf[5][kPreCols];
  const int c0 = blockIdx.y * kPreCols;
  const int cols = a.O - c0 < kPreCols ? a.O - c0 : kPreCols;
  for (int e = threadIdx.x; e < 5 * cols; e += kThreads)
    cf[e / cols][e % cols] = a.coef[(e / cols) * a.O + c0 + e % cols];
  __syncthreads();
  const int mode = a.mask_mode;
  if (a.vec) {
    const int vpr = cols / 8, rows = kThreads / vpr;
    const int tr = threadIdx.x / vpr, cl = (threadIdx.x % vpr) * 8;
    if (tr >= rows) return;
    for (int64_t m = static_cast<int64_t>(blockIdx.x) * rows + tr; m < a.M;
         m += static_cast<int64_t>(gridDim.x) * rows) {
      const int64_t e = m * a.O + c0 + cl;
      float jf[8], yf[8], mf[8], cd[8], jm[8];
      unpack_bf16x8(__ldcs(reinterpret_cast<const uint4*>(a.jg + e)), jf);
      unpack_bf16x8(__ldcs(reinterpret_cast<const uint4*>(a.y + e)), yf);
      if (mode == kMaskOut)
        unpack_bf16x8(__ldcs(reinterpret_cast<const uint4*>(a.mask + e)), mf);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        cd[k] = cdy_of(jf[k], yf[k], mode == kMaskOut ? mf[k] : 0.f, mode,
                       &cf[0][cl + k], kPreCols, &jm[k]);
      *reinterpret_cast<uint4*>(a.cdy + e) = pack_bf16x8(cd);
      if (a.jgout != nullptr)
        __stcs(reinterpret_cast<uint4*>(a.jgout + e), pack_bf16x8(jm));
    }
  } else {
    const int64_t n = a.M * cols;
    for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x;
         q < n; q += static_cast<int64_t>(gridDim.x) * kThreads) {
      const int64_t m = q / cols;
      const int c = static_cast<int>(q % cols);
      const int64_t e = m * a.O + c0 + c;
      float jm;
      const float v = cdy_of(bf(a.jg[e]), bf(a.y[e]),
                             mode == kMaskOut ? bf(a.mask[e]) : 0.f, mode,
                             &cf[0][c], kPreCols, &jm);
      a.cdy[e] = __float2bfloat16_rn(v);
      if (a.jgout != nullptr) a.jgout[e] = __float2bfloat16_rn(jm);
    }
  }
}

// ---- 2. the products ----------------------------------------------------
// 8 elements at src into dst, the first ok_n of them in range and the
// rest zeros: one 16-byte cp.async where vec (ok_n is then 0 or 8; base,
// the array's start, stands in as the address of a copy of no bytes),
// else element by element
__device__ __forceinline__ void stage16(bf16* dst, const bf16* src,
                                        const bf16* base, bool vec,
                                        int ok_n) {
  if (vec) {
    cp_async16(dst, ok_n > 0 ? src : base, ok_n > 0 ? 16 : 0);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[j] = j < ok_n ? src[j] : __float2bfloat16_rn(0.f);
  }
}

__device__ __forceinline__ int in_range(int64_t idx, int64_t end) {
  const int64_t n = end - idx;
  return n <= 0 ? 0 : n >= 8 ? 8 : static_cast<int>(n);
}

// The dx epilogue of columns [i, i + n) (n <= 8) of row m from their f32
// sums v: the addend, then with emit_next the x > 0 mask, the bf16
// rounding and S1/S2 into s1, s2; 16-byte loads and stores where vec
// (n is then 8).
__device__ __forceinline__ void dx_oct(const DualArgs& a, int64_t m, int i,
                                       int n, float* v, float* s1,
                                       float* s2) {
  const int64_t e = m * a.I + i;
  if (a.addend != nullptr) {
    float ad[8];
    if (a.vec) {
      unpack_bf16x8(__ldcs(reinterpret_cast<const uint4*>(a.addend + e)), ad);
    } else {
      for (int j = 0; j < n; ++j) ad[j] = bf(a.addend[e + j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) v[j] = __fadd_rn(v[j], ad[j]);
  }
  if (a.y3p != nullptr) {
    float xv[8], yv[8], mp[8];
    if (a.vec) {
      unpack_bf16x8(__ldcs(reinterpret_cast<const uint4*>(a.x + e)), xv);
      unpack_bf16x8(__ldcs(reinterpret_cast<const uint4*>(a.y3p + e)), yv);
      const float4 p0 = *reinterpret_cast<const float4*>(a.mprev + i);
      const float4 p1 = *reinterpret_cast<const float4*>(a.mprev + i + 4);
      mp[0] = p0.x, mp[1] = p0.y, mp[2] = p0.z, mp[3] = p0.w;
      mp[4] = p1.x, mp[5] = p1.y, mp[6] = p1.z, mp[7] = p1.w;
    } else {
      for (int j = 0; j < n; ++j) {
        xv[j] = bf(a.x[e + j]);
        yv[j] = bf(a.y3p[e + j]);
        mp[j] = a.mprev[i + j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= n) continue;
      if (!(xv[j] > 0.f)) v[j] = 0.f;
      const float q = bf(__float2bfloat16_rn(v[j]));
      s1[j] += q;
      s2[j] += __fmul_rn(q, __fsub_rn(yv[j], mp[j]));
    }
  }
  if (a.vec) {
    *reinterpret_cast<uint4*>(a.dx + e) = pack_bf16x8(v);
  } else {
    for (int j = 0; j < n; ++j) a.dx[e + j] = __float2bfloat16_rn(v[j]);
  }
}

// The dx epilogue of rows [m0, m0 + kRows) x columns [i0, i0 + 64), 256
// threads: thread t takes columns (t % 8) * 8.. of rows t / 8 + 32 k, their
// f32 sums from val(r, c, v). With emit_next the tile's S1/S2 row goes to
// part_sums[tile]: each thread's rows in order, then the 32 threads of a
// column in order, through buf ([32][64][2] floats, free on entry).
template <int kRows, typename Val>
__device__ __forceinline__ void dx_epilogue(const DualArgs& a, int64_t m0,
                                            int i0, int64_t tile, Val val,
                                            float* buf) {
  const int c = (threadIdx.x & 7) * 8, i = i0 + c;
  const int n = a.I - i < 8 ? a.I - i : 8;
  float s1[8] = {}, s2[8] = {};
  for (int r = threadIdx.x >> 3; r < kRows; r += kThreads / 8) {
    const int64_t m = m0 + r;
    if (m >= a.M || n <= 0) continue;
    float v[8];
    val(r, c, v);
    dx_oct(a, m, i, n, v, s1, s2);
  }
  if (a.y3p == nullptr) return;
  __syncthreads();   // buf may be where val reads from
  float* mine = buf + (threadIdx.x >> 3) * kDxCols * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mine[(c + j) * 2] = s1[j];
    mine[(c + j) * 2 + 1] = s2[j];
  }
  __syncthreads();
  if (threadIdx.x < kDxCols && i0 + static_cast<int>(threadIdx.x) < a.I) {
    float t1 = 0.f, t2 = 0.f;
    for (int q = 0; q < kThreads / 8; ++q) {
      t1 += buf[(q * kDxCols + threadIdx.x) * 2];
      t2 += buf[(q * kDxCols + threadIdx.x) * 2 + 1];
    }
    float* row = a.part_sums + tile * 2 * a.I + i0 + threadIdx.x;
    row[0] = t1;
    row[a.I] = t2;
  }
}

// The kStages-deep ring: load(slot, step) stages step `step` of the
// block's nk steps into the ring slot at `slot`; compute(slot) multiplies
// a staged step. Each step waits for its own copies, then issues those of
// step + kStages - 1 before its products.
template <typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int nk, bf16* sm, Load load,
                                         Compute compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(sm + s * kStage, s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load(sm + (nxt % kStages) * kStage, nxt);
    cp_commit();
    compute(sm + (kt % kStages) * kStage);
  }
}

// dx tile (tm, ti) of slice `split`: rows [tm*128, +128) x columns
// [ti*64, +64) of I, over O columns [split*depth_x, +depth_x).
__device__ void dx_block(const DualArgs& a, int bid, bf16* sm) {
  const int split = bid / a.tiles_dx, rest = bid % a.tiles_dx;
  const int tm = rest / a.tiles_i_dx, ti = rest % a.tiles_i_dx;
  const int64_t m0 = static_cast<int64_t>(tm) * kDxRows;
  const int i0 = ti * kDxCols;
  const int kb = split * a.depth_x;
  const int ke = kb + a.depth_x < a.O ? kb + a.depth_x : a.O;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  float acc[2][4][4] = {};
  pipeline(
      (ke - kb + kBK - 1) / kBK, sm,
      [&](bf16* st, int step) {
        const int k0 = kb + step * kBK;
        bf16* As = st;
        bf16* Bs = st + kDxRows * kLdK;
        for (int e = threadIdx.x; e < (kDxRows + kDxCols) * (kBK / 8);
             e += kThreads) {
          const int r = e / (kBK / 8), c = (e % (kBK / 8)) * 8;
          const int k = k0 + c;
          if (r < kDxRows) {
            const int64_t m = m0 + r;
            stage16(As + r * kLdK + c, a.cdy + m * a.O + k, a.cdy, a.vec,
                    m < a.M ? in_range(k, ke) : 0);
          } else {
            const int i = i0 + r - kDxRows;
            stage16(Bs + (r - kDxRows) * kLdK + c,
                    a.w + static_cast<int64_t>(i) * a.O + k, a.w, a.vec,
                    i < a.I ? in_range(k, ke) : 0);
          }
        }
      },
      [&](const bf16* st) {
        const bf16* As = st;
        const bf16* Bs = st + kDxRows * kLdK;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          uint32_t af[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            ldsm4(af[mi], As + (wm * 32 + mi * 16 + (lane & 15)) * kLdK + kk +
                              (lane >> 4) * 8);
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t b[4];
            ldsm4(b, Bs + (wn * 32 + jp * 16 + (lane & 7) +
                           ((lane >> 4) << 3)) * kLdK +
                         kk + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma16816(acc[mi][2 * jp], af[mi], b[0], b[1]);
              mma16816(acc[mi][2 * jp + 1], af[mi], b[2], b[3]);
            }
          }
        }
      });

  // the accumulators through shared memory (the ring is free once every
  // warp is past its last step), so that the epilogue moves 16 bytes a
  // thread
  __syncthreads();
  float* tile = reinterpret_cast<float*>(sm);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            tile + (wm * 32 + mi * 16 + g + 8 * h) * kLdT + wn * 32 +
            ni * 8 + 2 * t) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  __syncthreads();
  const auto val = [&](int r, int c, float* v) {
    const float4 v0 = *reinterpret_cast<const float4*>(tile + r * kLdT + c);
    const float4 v1 =
        *reinterpret_cast<const float4*>(tile + r * kLdT + c + 4);
    v[0] = v0.x, v[1] = v0.y, v[2] = v0.z, v[3] = v0.w;
    v[4] = v1.x, v[5] = v1.y, v[6] = v1.z, v[7] = v1.w;
  };
  if (a.splits_x == 1) {
    dx_epilogue<kDxRows>(a, m0, i0, tm, val, tile);
    return;
  }
  float* part = a.part_dx + static_cast<int64_t>(split) * a.M * a.I;
  const int c = (threadIdx.x & 7) * 8, i = i0 + c;
  const int n = a.I - i < 8 ? a.I - i : 8;
  for (int r = threadIdx.x >> 3; r < kDxRows; r += kThreads / 8) {
    const int64_t m = m0 + r;
    if (m >= a.M || n <= 0) continue;
    float v[8];
    val(r, c, v);
    float* p = part + m * a.I + i;
    if (a.vec) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      for (int j = 0; j < n; ++j) p[j] = v[j];
    }
  }
}

// dW partial of tile (ti, to) over the rows of one split.
__device__ void dw_block(const DualArgs& a, int bid, bf16* sm) {
  const int per_split = a.tiles_i_dw * a.tiles_o;
  const int split = bid / per_split, rest = bid % per_split;
  const int ti = rest / a.tiles_o, to = rest % a.tiles_o;
  const int i0 = ti * kDwI, o0 = to * kDwO;
  const int64_t r0 = static_cast<int64_t>(split) * a.rows_w;
  const int64_t r1 = r0 + a.rows_w < a.M ? r0 + a.rows_w : a.M;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  float acc[2][4][4] = {};
  pipeline(
      static_cast<int>((r1 - r0 + kBK - 1) / kBK), sm,
      [&](bf16* st, int step) {
        const int64_t k0 = r0 + static_cast<int64_t>(step) * kBK;
        bf16* Xs = st;                  // [k][i]: x rows, row-major
        bf16* Cs = st + kBK * kLdX;     // [k][o]: cdy rows, row-major
        for (int e = threadIdx.x; e < kBK * (kDwI + kDwO) / 8;
             e += kThreads) {
          if (e < kBK * kDwI / 8) {
            const int k = e / (kDwI / 8), c = (e % (kDwI / 8)) * 8;
            const int64_t m = k0 + k;
            stage16(Xs + k * kLdX + c, a.x + m * a.I + i0 + c, a.x, a.vec,
                    m < r1 ? in_range(i0 + c, a.I) : 0);
          } else {
            const int q = e - kBK * kDwI / 8;
            const int k = q / (kDwO / 8), c = (q % (kDwO / 8)) * 8;
            const int64_t m = k0 + k;
            stage16(Cs + k * kLdC + c, a.cdy + m * a.O + o0 + c, a.cdy,
                    a.vec,
                    m < r1 ? in_range(o0 + c, a.O) : 0);
          }
        }
      },
      [&](const bf16* st) {
        const bf16* Xs = st;
        const bf16* Cs = st + kBK * kLdX;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          uint32_t af[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            ldsm4t(af[mi], Xs + (kk + (lane & 7) + 8 * (lane >> 4)) * kLdX +
                               wm * 32 + mi * 16 + 8 * ((lane >> 3) & 1));
#pragma unroll
          for (int jd = 0; jd < 2; ++jd) {
            uint32_t b[4];
            ldsm4t(b, Cs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdC +
                          wn * 32 + jd * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma16816(acc[mi][2 * jd], af[mi], b[0], b[1]);
              mma16816(acc[mi][2 * jd + 1], af[mi], b[2], b[3]);
            }
          }
        }
      });
  const int g = lane >> 2, t = lane & 3;
  float* part = a.part_dw + static_cast<int64_t>(split) * a.I * a.O;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + wm * 32 + mi * 16 + g + 8 * h;
        const int o = o0 + wn * 32 + ni * 8 + 2 * t;
        if (i >= a.I || o >= a.O) continue;
        float* p = part + static_cast<int64_t>(i) * a.O + o;
        if (a.vec) {
          *reinterpret_cast<float2*>(p) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        } else {
          p[0] = acc[mi][ni][2 * h];
          if (o + 1 < a.O) p[1] = acc[mi][ni][2 * h + 1];
        }
      }
}

__global__ void __launch_bounds__(kThreads, 2) dual_bwd_main(DualArgs a) {
  __shared__ __align__(16) bf16 sm[kStages * kStage];
  if (static_cast<int>(blockIdx.x) < a.n_dx)
    dx_block(a, blockIdx.x, sm);
  else
    dw_block(a, blockIdx.x - a.n_dx, sm);
}

// ---- 2'. both products in one block, for I <= 64 and O <= 256 ---------
// Stage 1's tails and downsample (I = 64, O = 256) move
// far more bytes through jg, y and the mask than through x, and their dW
// is small enough to stay in registers: a persistent block (two an SM)
// takes the rows of one dW split, kFuseRows at a time, its jg, y, mask, x
// and addend staged by 16-byte cp.async two tiles deep; forms each tile's
// cdy once into shared memory (and writes the masked jg); multiplies it
// with W (resident in shared memory) into the tile's dx and with x^T into
// the block's dW, which ends as one f32 partial. No cdy scratch, and every
// operand is read from device memory once.
constexpr int kFuseRows = 16;
constexpr int kFuseI = 64;
constexpr int kFuseO = 256;

struct Fuse {
  static constexpr int kO = kFuseO;
  static constexpr int kLdO = kO + 8;          // cdy and W rows, padded
  static constexpr int kLdI = kFuseI + 8;      // x rows, padded
  static constexpr int kJg = kFuseRows * kO;   // one raw [rows][kO] tile
  static constexpr int kX = 3 * kJg;           // x [rows][kLdI], then the
  static constexpr int kAd = kX + kFuseRows * kLdI;   // addend [rows][64]
  static constexpr int kRaw = kAd + kFuseRows * kFuseI;
  static constexpr int kW = kFuseI * kLdO;
  static constexpr int kCdy = kFuseRows * kLdO;
  static constexpr int kBytes = (2 * kRaw + kW + kCdy) * 2 + 5 * kO * 4;
};

__global__ void __launch_bounds__(kThreads, 2) dual_bwd_fused(DualArgs a) {
  using F = Fuse;
  constexpr int kO = F::kO;
  extern __shared__ __align__(16) unsigned char fsm[];
  bf16* raw = reinterpret_cast<bf16*>(fsm);                // [2][kRaw]
  bf16* Ws = raw + 2 * F::kRaw;                            // [kFuseI][kLdO]
  bf16* Cs = Ws + F::kW;                                   // [rows][kLdO]
  float* cf = reinterpret_cast<float*>(Cs + F::kCdy);      // [5][kO]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * a.rows_w;
  const int64_t r1 = r0 + a.rows_w < a.M ? r0 + a.rows_w : a.M;
  const int nt = static_cast<int>((r1 - r0 + kFuseRows - 1) / kFuseRows);
  const int mode = a.mask_mode;

  const auto load = [&](int slot, int tile) {
    bf16* st = raw + slot * F::kRaw;
    const int64_t m0 = r0 + static_cast<int64_t>(tile) * kFuseRows;
    constexpr int kV = kFuseRows * (kO / 8);   // vectors of one raw tile
    constexpr int kVi = kFuseRows * (kFuseI / 8);
    for (int e = threadIdx.x; e < 3 * kV + 2 * kVi; e += kThreads) {
      if (e < 3 * kV) {
        const int which = e / kV, q = e % kV;
        const int r = q / (kO / 8), c = (q % (kO / 8)) * 8;
        const int64_t m = m0 + r;
        const bf16* src = which == 0 ? a.jg : which == 1 ? a.y : a.mask;
        const bool ok = m < r1 && c < a.O && (which < 2 || mode == kMaskOut);
        cp_async16(st + which * F::kJg + r * kO + c,
                   ok ? src + m * a.O + c : a.jg, ok ? 16 : 0);
      } else {
        const int q = (e - 3 * kV) % kVi;
        const bool ad = e - 3 * kV >= kVi;   // the addend's rows, else x's
        const int r = q / (kFuseI / 8), c = (q % (kFuseI / 8)) * 8;
        const int64_t m = m0 + r;
        const bf16* src = ad ? a.addend : a.x;
        const bool ok = m < r1 && c < a.I && src != nullptr;
        cp_async16(ad ? st + F::kAd + r * kFuseI + c
                      : st + F::kX + r * F::kLdI + c,
                   ok ? src + m * a.I + c : a.x, ok ? 16 : 0);
      }
    }
    cp_commit();
  };
  // W and the coefficients once (W's copies join the first tile's group)
  for (int e = threadIdx.x; e < kFuseI * (kO / 8); e += kThreads) {
    const int i = e / (kO / 8), c = (e % (kO / 8)) * 8;
    const bool ok = i < a.I && c < a.O;
    cp_async16(Ws + i * F::kLdO + c,
               ok ? a.w + static_cast<int64_t>(i) * a.O + c : a.w,
               ok ? 16 : 0);
  }
  for (int e = threadIdx.x; e < 5 * kO; e += kThreads)
    cf[e] = e % kO < a.O ? a.coef[(e / kO) * a.O + e % kO] : 0.f;
  if (nt > 0) {
    load(0, 0);
  } else {   // no rows (the wrapper gives every split some): W's copies
    cp_commit();
    cp_wait<0>();
  }

  // dW: warp (wm, wn) holds rows [wm*32, +32) of I x columns
  // [wn*kO/4, +kO/4) of O; dx: warps 0-3 take the tile's 16 rows x
  // columns [warp*16, +16) of I
  constexpr int kNi = kO / 32;
  const int wm = warp >> 2, wn = warp & 3;
  float dw[2][kNi][4] = {};
  for (int tile = 0; tile < nt; ++tile) {
    cp_wait<0>();
    __syncthreads();   // the tile landed; the previous tile is done with
    if (tile + 1 < nt) load((tile + 1) & 1, tile + 1);
    const bf16* st = raw + (tile & 1) * F::kRaw;
    const int64_t m0 = r0 + static_cast<int64_t>(tile) * kFuseRows;
    // cdy once per element, and the masked jg
    for (int q = threadIdx.x; q < kFuseRows * (kO / 8); q += kThreads) {
      const int r = q / (kO / 8), c = (q % (kO / 8)) * 8;
      const int64_t m = m0 + r;
      float jf[8], yf[8], mf[8], cd[8], jm[8];
      unpack_bf16x8(*reinterpret_cast<const uint4*>(st + r * kO + c), jf);
      unpack_bf16x8(*reinterpret_cast<const uint4*>(st + F::kJg + r * kO + c),
                    yf);
      unpack_bf16x8(
          *reinterpret_cast<const uint4*>(st + 2 * F::kJg + r * kO + c), mf);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        cd[k] = cdy_of(jf[k], yf[k], mf[k], mode, cf + c + k, kO, &jm[k]);
        if (m >= r1) cd[k] = 0.f;
      }
      *reinterpret_cast<uint4*>(Cs + r * F::kLdO + c) = pack_bf16x8(cd);
      if (a.jgout != nullptr && m < r1 && c < a.O)
        __stcs(reinterpret_cast<uint4*>(a.jgout + m * a.O + c),
               pack_bf16x8(jm));
    }
    __syncthreads();
    // dx = cdy . W^T over O
    float dxa[2][4] = {};
    if (warp < 4) {
#pragma unroll
      for (int kk = 0; kk < kO; kk += 16) {
        uint32_t af[4], b[4];
        ldsm4(af, Cs + (lane & 15) * F::kLdO + kk + (lane >> 4) * 8);
        ldsm4(b, Ws + (warp * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                          F::kLdO +
                     kk + ((lane >> 3) & 1) * 8);
        mma16816(dxa[0], af, b[0], b[1]);
        mma16816(dxa[1], af, b[2], b[3]);
      }
    }
    // dW += x^T . cdy over the tile's rows
    const bf16* Xs = st + F::kX;
#pragma unroll
    for (int kk = 0; kk < kFuseRows; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm4t(af[mi], Xs + (kk + (lane & 7) + 8 * (lane >> 4)) * F::kLdI +
                           wm * 32 + mi * 16 + 8 * ((lane >> 3) & 1));
#pragma unroll
      for (int jd = 0; jd < kNi / 2; ++jd) {
        uint32_t b[4];
        ldsm4t(b, Cs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * F::kLdO +
                      wn * (kO / 4) + jd * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(dw[mi][2 * jd], af[mi], b[0], b[1]);
          mma16816(dw[mi][2 * jd + 1], af[mi], b[2], b[3]);
        }
      }
    }
    // the tile's dx: the addend in f32, one rounding, bf16x2 stores
    if (warp < 4) {
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h, i = warp * 16 + ni * 8 + 2 * t4;
          const int64_t m = m0 + r;
          if (m >= r1 || i >= a.I) continue;
          float v0 = dxa[ni][2 * h], v1 = dxa[ni][2 * h + 1];
          if (a.addend != nullptr) {
            const float2 ad = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    st + F::kAd + r * kFuseI + i));
            v0 = __fadd_rn(v0, ad.x);
            v1 = __fadd_rn(v1, ad.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(a.dx + m * a.I + i) =
              __floats2bfloat162_rn(v0, v1);
        }
    }
  }
  float* part = a.part_dw + static_cast<int64_t>(blockIdx.x) * a.I * a.O;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = wm * 32 + mi * 16 + g + 8 * h;
        const int o = wn * (kO / 4) + ni * 8 + 2 * t4;
        if (i < a.I && o < a.O)
          *reinterpret_cast<float2*>(part + static_cast<int64_t>(i) * a.O + o) =
              make_float2(dw[mi][ni][2 * h], dw[mi][ni][2 * h + 1]);
      }
}

cudaError_t launch_fused(const DualArgs& a, int blocks, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      dual_bwd_fused, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Fuse::kBytes);
  if (err != cudaSuccess) return err;
  dual_bwd_fused<<<blocks, kThreads, Fuse::kBytes, stream>>>(a);
  return cudaGetLastError();
}

// ---- 3. the epilogue of a split dx -------------------------------------
// grid (ceil(I / 64), ceil(M / kEpiRows)), 256 threads: the slices of a
// tile of kEpiRows x 64 added in slice order, then the epilogue; with
// emit_next the block's S1/S2 row goes to part_sums.
__global__ void __launch_bounds__(kThreads) dual_bwd_dx_epilogue(DualArgs a) {
  __shared__ __align__(16) float buf[kThreads / 8][kDxCols][2];
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kEpiRows;
  const int i0 = blockIdx.x * kDxCols;
  const int64_t slice = a.M * a.I;
  dx_epilogue<kEpiRows>(
      a, m0, i0, blockIdx.y,
      [&](int r, int c, float* v) {
        const float* p = a.part_dx + (m0 + r) * a.I + i0 + c;
        const int n = a.I - i0 - c < 8 ? a.I - i0 - c : 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
        for (int s = 0; s < a.splits_x; ++s, p += slice) {
          if (a.vec) {
            const float4 f0 = *reinterpret_cast<const float4*>(p);
            const float4 f1 = *reinterpret_cast<const float4*>(p + 4);
            v[0] += f0.x, v[1] += f0.y, v[2] += f0.z, v[3] += f0.w;
            v[4] += f1.x, v[5] += f1.y, v[6] += f1.z, v[7] += f1.w;
          } else {
            for (int j = 0; j < n; ++j) v[j] += p[j];
          }
        }
      },
      &buf[0][0][0]);
}

// ordered_col_sum's writer (named for the kernel, so that a profile of the
// reductions shows whose they are)
struct dual_bwd_sums {
  float* out;
  __device__ void operator()(int64_t n, float v) const { out[n] = v; }
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// jg, y: [M, O] bf16; x: [M, I] bf16; w: [I, O] bf16; coef: [8, O] f32;
// mask: [M, O] bf16 for mask_mode 2, else null; addend: [M, I] bf16 or
// null; y3p: [M, I] bf16 and mprev: [I] f32, or both null; outputs dx
// [M, I] bf16, dw [I, O] f32, jgout [M, O] bf16 or null, sums [2, I] f32
// (with y3p). fused (I <= 64, O <= 256, no y3p, one dx slice, 16-byte
// aligned, I and O multiples of 8): both products in one block per dW
// split, no cdy. Scratch: cdy [M, O] bf16 (null when fused); part_dw
// [splits_w, I, O] f32 with
// splits_w * rows_w >= M and rows_w a multiple of 32; part_dx [splits_x,
// M, I] f32 when splits_x > 1 (else null), splits_x * depth_x >= O and
// depth_x a multiple of 32; part_sums [ceil(M / R), 2, I] f32 with y3p, R
// = 32 when splits_x > 1, else 128. sms: the card's SM count, which sizes
// the cdy pass's grid. All contiguous.
MXT_EXPORT int mxt_dual_bwd(const void* jg, const void* y, const void* x,
                            const void* w, const void* coef,
                            const void* mask, const void* addend,
                            const void* y3p, const void* mprev, void* dx,
                            void* dw, void* jgout, void* sums, void* cdy,
                            void* part_dw, void* part_dx, void* part_sums,
                            int64_t M, int I, int O, int mask_mode,
                            int splits_w, int64_t rows_w, int splits_x,
                            int depth_x, int fused, int sms,
                            cudaStream_t stream) {
  if (M < 1 || I < 1 || O < 1 || splits_w < 1 || rows_w < 1 ||
      rows_w % kBK != 0 || static_cast<int64_t>(splits_w) * rows_w < M ||
      splits_x < 1 || depth_x < 1 || depth_x % kBK != 0 ||
      static_cast<int64_t>(splits_x) * depth_x < O || sms < 1 ||
      (cdy == nullptr) != (fused != 0))
    return cudaErrorInvalidValue;
  if (mask_mode < kMaskNone || mask_mode > kMaskOut ||
      (mask_mode == kMaskOut) != (mask != nullptr) ||
      (y3p == nullptr) != (mprev == nullptr) ||
      (y3p == nullptr) != (sums == nullptr) ||
      (y3p == nullptr) != (part_sums == nullptr) ||
      (splits_x > 1) != (part_dx != nullptr))
    return cudaErrorInvalidValue;
  DualArgs a;
  a.jg = static_cast<const bf16*>(jg);
  a.y = static_cast<const bf16*>(y);
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.coef = static_cast<const float*>(coef);
  a.mask = static_cast<const bf16*>(mask);
  a.addend = static_cast<const bf16*>(addend);
  a.y3p = static_cast<const bf16*>(y3p);
  a.mprev = static_cast<const float*>(mprev);
  a.dx = static_cast<bf16*>(dx);
  a.jgout = static_cast<bf16*>(jgout);
  a.cdy = static_cast<bf16*>(cdy);
  a.part_dw = static_cast<float*>(part_dw);
  a.part_dx = static_cast<float*>(part_dx);
  a.part_sums = static_cast<float*>(part_sums);
  a.M = M;
  a.I = I;
  a.O = O;
  a.mask_mode = mask_mode;
  a.rows_w = rows_w;
  a.depth_x = depth_x;
  a.splits_x = splits_x;
  a.vec = I % 8 == 0 && O % 8 == 0;
  const void* ptrs[] = {jg, y, x, w, mask, addend, y3p, mprev, dx, jgout,
                        cdy, part_dw, part_dx};
  for (const void* p : ptrs)
    if (p != nullptr && !aligned16(p)) a.vec = false;
  const int64_t tiles_m = (M + kDxRows - 1) / kDxRows;
  a.tiles_i_dx = (I + kDxCols - 1) / kDxCols;
  a.tiles_i_dw = (I + kDwI - 1) / kDwI;
  a.tiles_o = (O + kDwO - 1) / kDwO;
  const int64_t tiles_dx = tiles_m * a.tiles_i_dx;
  const int64_t n_dx = tiles_dx * splits_x;
  const int64_t n_dw =
      static_cast<int64_t>(a.tiles_i_dw) * a.tiles_o * splits_w;
  if (n_dx + n_dw > 0x7fffffff) return cudaErrorInvalidValue;
  a.tiles_dx = static_cast<int>(tiles_dx);
  a.n_dx = static_cast<int>(n_dx);
  cudaError_t err;
  if (fused) {
    // 2'. both products in one block: the dW splits are its blocks
    if (I > kFuseI || O > kFuseO || y3p != nullptr || splits_x != 1 ||
        !a.vec)
      return cudaErrorInvalidValue;
    err = launch_fused(a, splits_w, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    launch_col_sum(static_cast<const float*>(part_dw), splits_w,
                   static_cast<int64_t>(I) * O,
                   dual_bwd_sums{static_cast<float*>(dw)}, stream);
    return static_cast<int>(cudaGetLastError());
  }

  // 1. cdy: about 8 blocks an SM, each walking its rows
  const int chunks = (O + kPreCols - 1) / kPreCols;
  const int64_t rows_per = a.vec
      ? kThreads / ((O < kPreCols ? O : kPreCols) / 8) : kThreads;
  int64_t pre = (M + rows_per - 1) / rows_per;
  const int64_t fill = (8 * static_cast<int64_t>(sms) + chunks - 1) / chunks;
  if (pre > fill) pre = fill;
  dual_bwd_cdy<<<dim3(static_cast<unsigned>(pre), chunks), kThreads, 0,
                 stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // 2. the products
  dual_bwd_main<<<static_cast<unsigned>(n_dx + n_dw), kThreads, 0, stream>>>(
      a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // 3. the split dx's epilogue
  int64_t sum_tiles = tiles_m;
  if (splits_x > 1) {
    sum_tiles = (M + kEpiRows - 1) / kEpiRows;
    if (sum_tiles > 65535) return cudaErrorInvalidValue;
    const unsigned gx = (I + kDxCols - 1) / kDxCols;
    dual_bwd_dx_epilogue<<<dim3(gx, static_cast<unsigned>(sum_tiles)),
                           kThreads, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 4, 5. dW over the splits, the sums over the row tiles
  launch_col_sum(static_cast<const float*>(part_dw), splits_w,
                 static_cast<int64_t>(I) * O,
                 dual_bwd_sums{static_cast<float*>(dw)}, stream);
  if (y3p != nullptr)
    launch_col_sum(static_cast<const float*>(part_sums), sum_tiles,
                   2 * static_cast<int64_t>(I),
                   dual_bwd_sums{static_cast<float*>(sums)}, stream);
  return static_cast<int>(cudaGetLastError());
}
