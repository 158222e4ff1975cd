// Inverted dropout with the mask generated inside the kernel, forward and
// backward, hand-written for Hopper.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_dropout.py :: _drop_call
// -> pallas_dropout_kernel. Same contract: an element is kept iff its
// 32 random bits >= min(int(p * 2^32), 2^32 - 1), and y = keep ? x *
// (1 / (1 - p)) : 0 in f32, rounded to x's dtype. The backward is the
// same kernel applied to dy with the same seed, so the mask is
// regenerated, never stored. The TPU draws its bits from the hardware
// generator, which Hopper does not have: here the bits are the counter
// hash of the reference's attention kernel (mxt_hash in common.cuh) of
// the element's linear index (its low 32 bits; the high bits are added
// to the seed) and one seed per call, read from device memory so that
// drawing it needs no host sync. The plain PyTorch version computes the
// same bits.
//
// Bound: bytes (x read once, y written once); the hash is about a dozen
// integer operations an element, which the card issues in less time than
// the bytes take. Two things keep a one-element-a-thread pass from the
// bound. Bytes in flight: keeping 3.35 TB/s busy over a DRAM latency of
// about 0.6 us needs about 2 MB in flight, some 15 KB an SM, where one
// 2- or 4-byte load a thread gives 4-8 KB. And a fixed cost: a launch and
// one trip to DRAM and back, which at small tensors is most of the time.
// Design: each access moves 16 bytes (4 f32 or 8 bf16/f16 elements), and a
// thread issues all its loads, kU of them, before it hashes and stores
// any; the seed's load goes out beside them. The grid comes from the card
// (ops/cuda_dropout.py :: launch_plan, from the SM count): a tensor that
// a full wave of blocks covers takes one pass with the fewest accesses a
// thread that fit in that wave, so every SM has loads in flight at once
// and no thread loops; a larger one loops over chunks on a wave of
// blocks, four accesses a thread at a time. The tensor is cut into pieces
// of 2^32 elements (grid.y), so an element's index inside its piece is
// 32-bit and the piece number is added to the seed once. The n % V
// elements after the last whole vector go to block 0's first threads. An
// x or y off 16-byte alignment takes the same kernel with one element an
// access (V = 1), which the wrapper counts apart.
#include "common.cuh"

namespace {

// launch_plan's THREADS
constexpr int kThreads = 256;
constexpr int64_t kPiece = int64_t(1) << 32;

// grid (blocks, pieces): piece blockIdx.y is elements [y * 2^32,
// min((y + 1) * 2^32, n)). Block b takes chunks b, b + gridDim.x, ... of
// kThreads * kU accesses of kV elements; a thread's kU accesses are
// kThreads apart, so a warp's are contiguous.
template <typename T, int kV, int kU>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const int* __restrict__ seed, int64_t n, uint32_t thresh,
                   float scale) {
  using R = Raw<T, kV>;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * kPiece;
  const int64_t len = n - base < kPiece ? n - base : kPiece;
  const int64_t nvec = len / kV;
  const R* __restrict__ xv = reinterpret_cast<const R*>(x + base);
  R* __restrict__ yv = reinterpret_cast<R*>(y + base);
  const uint32_t s = static_cast<uint32_t>(__ldg(seed)) + blockIdx.y;
  constexpr int64_t kChunk = static_cast<int64_t>(kThreads) * kU;
  for (int64_t c = blockIdx.x * kChunk + threadIdx.x; c < nvec;
       c += static_cast<int64_t>(gridDim.x) * kChunk) {
    R r[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (c + u * kThreads < nvec) r[u] = __ldg(xv + c + u * kThreads);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t v = c + u * kThreads;
      if (v < nvec) {
        // the index of the access's first element inside the piece
        const uint32_t e = static_cast<uint32_t>(v) * kV;
        float f[kV];
        unpack<T, kV>(r[u], f);
#pragma unroll
        for (int k = 0; k < kV; ++k)
          f[k] = mxt_hash(e + k, s) >= thresh ? f[k] * scale : 0.f;
        yv[v] = pack<T, kV>(f);
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < len - nvec * kV) {
    const uint32_t e = static_cast<uint32_t>(nvec * kV) + threadIdx.x;
    const float f = to_f32(x[base + e]);
    y[base + e] = from_f32<T>(mxt_hash(e, s) >= thresh ? f * scale : 0.f);
  }
}

template <typename T>
using Kernel = void (*)(const T*, T*, const int*, int64_t, uint32_t, float);

template <typename T, int kV>
Kernel<T> kernel_of(int units) {
  switch (units) {
    case 1:
      return dropout_kernel<T, kV, 1>;
    case 2:
      return dropout_kernel<T, kV, 2>;
    case 4:
      return dropout_kernel<T, kV, 4>;
    default:
      return nullptr;
  }
}

template <typename T>
Kernel<T> kernel_of(int vector, int units) {
  return vector ? kernel_of<T, 16 / sizeof(T)>(units)
                : kernel_of<T, 1>(units);
}

template <typename T>
int launch(const void* x, void* y, const int* seed, int64_t n,
           uint32_t thresh, float scale, int vector, int units, int blocks,
           int pieces, cudaStream_t stream) {
  const Kernel<T> k = kernel_of<T>(vector, units);
  if (k == nullptr) return cudaErrorInvalidValue;
  if (vector &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16)
    return cudaErrorMisalignedAddress;
  k<<<dim3(blocks, pieces), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), seed, n, thresh, scale);
  return cudaSuccess;
}

template <typename T>
int blocks_per_sm(int vector, int units) {
  const Kernel<T> k = kernel_of<T>(vector, units);
  if (k == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int nb = 0;
  const cudaError_t rc =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, k, kThreads, 0);
  return rc == cudaSuccess ? nb : -static_cast<int>(rc);
}

}  // namespace

// x, y: n contiguous elements of dtype code `dtype`; seed: one int32 on
// the device; thresh: min(int(p * 2^32), 2^32 - 1); scale: f32(1 / (1 - p)).
// vector (16-byte accesses; x and y 16-byte aligned, else one element an
// access), units (1, 2 or 4 accesses a thread at a time), blocks and
// pieces: ops/cuda_dropout.py :: launch_plan.
MXT_EXPORT int mxt_dropout(const void* x, void* y, const void* seed,
                           int64_t n, uint32_t thresh, float scale, int dtype,
                           int vector, int units, int blocks, int pieces,
                           cudaStream_t stream) {
  if (n < 1 || blocks < 1 || pieces != (n + kPiece - 1) / kPiece)
    return cudaErrorInvalidValue;
  const int* sd = static_cast<const int*>(seed);
  int rc;
  switch (dtype) {
    case kF32:
      rc = launch<float>(x, y, sd, n, thresh, scale, vector, units, blocks,
                         pieces, stream);
      break;
    case kBF16:
      rc = launch<__nv_bfloat16>(x, y, sd, n, thresh, scale, vector, units,
                                 blocks, pieces, stream);
      break;
    case kF16:
      rc = launch<__half>(x, y, sd, n, thresh, scale, vector, units, blocks,
                          pieces, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

// blocks of one SM that the variant (vector, units) of dtype code `dtype`
// keeps resident at once, from which launch_plan sizes a wave; a negative
// cudaError_t on failure
MXT_EXPORT int mxt_dropout_blocks_per_sm(int dtype, int vector, int units) {
  switch (dtype) {
    case kF32:
      return blocks_per_sm<float>(vector, units);
    case kBF16:
      return blocks_per_sm<__nv_bfloat16>(vector, units);
    case kF16:
      return blocks_per_sm<__half>(vector, units);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}
