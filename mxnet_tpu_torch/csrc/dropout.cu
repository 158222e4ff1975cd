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
// Bound: bytes (x read once, y written once); the hash is a dozen
// integer operations an element. Design: one grid-stride elementwise
// pass.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
                   const int* __restrict__ seed, int64_t n, uint32_t thresh,
                   float scale) {
  const uint32_t s = static_cast<uint32_t>(*seed);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const uint32_t bits = mxt_hash(static_cast<uint32_t>(i),
                                   s + static_cast<uint32_t>(i >> 32));
    y[i] = bits >= thresh ? from_f32<T>(to_f32(x[i]) * scale)
                          : from_f32<T>(0.f);
  }
}

template <typename T>
void launch(const void* x, void* y, const int* seed, int64_t n,
            uint32_t thresh, float scale, cudaStream_t stream) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dropout_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), seed, n, thresh, scale);
}

}  // namespace

// x, y: n contiguous elements of dtype code `dtype`; seed: one int32 on
// the device; thresh: min(int(p * 2^32), 2^32 - 1); scale: f32(1 / (1 - p)).
MXT_EXPORT int mxt_dropout(const void* x, void* y, const void* seed,
                           int64_t n, uint32_t thresh, float scale, int dtype,
                           cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const int* sd = static_cast<const int*>(seed);
  switch (dtype) {
    case kF32:
      launch<float>(x, y, sd, n, thresh, scale, stream);
      break;
    case kBF16:
      launch<__nv_bfloat16>(x, y, sd, n, thresh, scale, stream);
      break;
    case kF16:
      launch<__half>(x, y, sd, n, thresh, scale, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
