// The batched Paeth three-shear rotation on Hopper (sm_90a): an exact
// quarter turn, then three shears, for square images [B, S, S, C] uint8.
//
// Replaces the TPU kernels
//   image_processor_pipeline_tpu/ops/pallas/rotate.py:_shear_kernel_packed
//     (C = 3 and 4; the TPU pads RGB to packed RGBA for its 32-bit lanes)
//   image_processor_pipeline_tpu/ops/pallas/rotate.py:_shear_kernel
//     (any other C, channel-interleaved lanes)
// together with the XLA quarter turn around them (rotate.py:181-193) and
// the RGB alpha pad and strip (rotate.py:226-229).  Byte-identical to the
// plain PyTorch version, ops/geometry.py:rotate_square_shear_by, given the
// same (quad, sh1, sh2).  Unlike _shear_kernel, whose fixed 9-bit offset
// clips shifts on canvases above 720 px, every shift is applied in full.
//
// Layout.  The TPU kernels shear with bit-decomposed roll+select passes
// (27 passes over the image) because Mosaic has no gather and lane rolls
// need 32-bit lanes.  Here each output pixel walks back through the three
// shears and the quarter turn (shear_walk.cuh) to its one source pixel and
// copies it: one launch, one thread per output pixel, no passes.  The
// pixel is moved as one 32-bit word for C = 4, as three bytes for C = 3
// (no pad, no strip) and with a byte loop for any other C.
//
// Bound.  Memory bandwidth: one read and one write of S*S*C bytes per
// image against a dozen integer operations per pixel.  Writes are
// coalesced; reads follow the rotated row, and a quarter turn with a
// transpose reads down a column, so a warp touches up to 32 sectors per
// load.  Vector loads and tiled reads through shared memory are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shear_walk.cuh"

namespace {

constexpr int kThreads = 256;

// kBytes: bytes per pixel, 4 (one word), 3, or 0 for a runtime count C.
template <int kBytes>
__global__ void __launch_bounds__(kThreads) shear_rotate_kernel(
    const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
    const int32_t* __restrict__ codes, const int32_t* __restrict__ sh1,
    const int32_t* __restrict__ sh2, int S, int C) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= S * S) return;
  const int y = idx / S;
  const int x = idx - y * S;
  int row, col;
  const bool hit = ipp::shear_source(sh1 + (size_t)b * S, sh2 + (size_t)b * S,
                                     codes[b], y, x, S, row, col);
  const size_t base = (size_t)b * S * S;
  const size_t o = base + idx;
  const size_t i = base + (size_t)row * S + col;
  if constexpr (kBytes == 4) {
    reinterpret_cast<uint32_t*>(dst)[o] =
        hit ? reinterpret_cast<const uint32_t*>(src)[i] : 0u;
  } else {
    const int c = kBytes ? kBytes : C;
    for (int k = 0; k < c; ++k) dst[o * c + k] = hit ? src[i * c + k] : 0;
  }
}

}  // namespace

// src, dst: [B, S, S, C] uint8, contiguous; codes: [B] int32 D4 code of
// each image's quarter turn (ops/augment.py:_D4_CODES[quad * 4]); sh1,
// sh2: [B, S] int32.  Returns cudaGetLastError() after launching.
extern "C" int ipp_shear_rotate(const uint8_t* src, uint8_t* dst,
                                const int32_t* codes, const int32_t* sh1,
                                const int32_t* sh2, int B, int S, int C,
                                void* stream) {
  if (B < 1 || B > 65535 || S < 1 || S > 46340 || C < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S * S + kThreads - 1) / kThreads, B);
  const bool words = C == 4 && (reinterpret_cast<uintptr_t>(src) & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(dst) & 3) == 0;
  if (words)
    shear_rotate_kernel<4><<<grid, kThreads, 0, st>>>(src, dst, codes, sh1,
                                                      sh2, S, C);
  else if (C == 3)
    shear_rotate_kernel<3><<<grid, kThreads, 0, st>>>(src, dst, codes, sh1,
                                                      sh2, S, C);
  else
    shear_rotate_kernel<0><<<grid, kThreads, 0, st>>>(src, dst, codes, sh1,
                                                      sh2, S, C);
  return (int)cudaGetLastError();
}
