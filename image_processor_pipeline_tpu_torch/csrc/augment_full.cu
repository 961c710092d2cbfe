// The flagship augment chain on Hopper (sm_90a): crop, user flip, exact
// quarter turn, Paeth 3-shear rotation, cv2 HSV colour mask into alpha and
// PIL-exact enhance, for a batch of packed RGBA images (ipp_augment_full),
// and the same chain after the crop for a batch of RGB crops
// (ipp_augment_fused).
//
// ipp_augment_full replaces the TPU kernel
//   image_processor_pipeline_tpu/ops/pallas/augment.py:_augment_full_kernel
// together with the XLA flip epilogue of augment_fused_pallas_full.
// Byte-identical to the plain PyTorch version, ops/augment.py:
// augment_full_reference, given the same shift vectors.
//
// ipp_augment_fused replaces the TPU kernel
//   image_processor_pipeline_tpu/ops/pallas/augment.py:_augment_kernel
// together with the XLA RGB->RGBA pack and D4 passes (_dihedral_batch)
// before it in augment_fused_pallas.  Byte-identical to ops/augment.py:
// augment_finish_reference, given the same shift vectors.  It is the first
// one's computation with no crop: pass 1 reads the RGB crop's three bytes
// per pixel directly, and the D4 element comes from the quarter turn and
// the user flip.
//
// Layout.  The TPU kernels shear with bit-decomposed roll+select passes,
// transpose around them and conjugate the flips through the shift vectors,
// because Mosaic has no reverse and lane rolls are slow.  None of that binds
// here: every output pixel (b, y, x) walks back through the three shears
// and the D4 element (shear_walk.cuh), then the crop offset (clamped to the
// canvas like lax.dynamic_slice), to its one source pixel.  The quarter
// turn and user flip compose into one D4 element (out = Fx^fx Fy^fy T^t of
// the crop, ops/augment.py:_D4_TABLE).  The mask zones are in output
// coordinates, so no zone needs adjusting.
//
// Bound.  Memory bandwidth: about 1.2 MB read (the crop's pixels, at sector
// granularity) and 1 MB written per 512 px image, against a few dozen
// integer and float operations per pixel.  Contrast needs each image's exact
// luma sum over all S*S pixels before any pixel can finish, and blocks run in
// no order, so the chain takes two launches: pass 1 gathers, writes the raw
// rotated pixel into the output buffer and adds its post-brightness luma into
// a 64-bit per-image sum; pass 2 reads that buffer back coalesced and
// finishes in place.  That is one extra 1 MB write and read per image over a
// single pass; making it faster (one persistent pass per image, vector loads)
// is later work.
//
// Floats.  Built with --fmad=false and written with _rn intrinsics, so no
// multiply-add is contracted; IEEE division for the HSV tables; rintf is
// round-half-even like torch.round, floorf like torch.floor.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shear_walk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFilters = 8;

struct FilterStack {
  int n;
  int lo[kMaxFilters][3];    // saturate-rounded H, S, V lower bounds
  int hi[kMaxFilters][3];
  int zone[kMaxFilters][4];  // top, bottom, left, right margins
};

// lax.dynamic_slice's index rule: a negative offset counts from the end,
// then the window is clamped into the canvas.
__device__ __forceinline__ int crop_offset(int off, int S, int SIN) {
  if (off < 0) off += SIN;
  return min(max(off, 0), SIN - S);
}

// Pass 1's sources.  load(b, item, row, col, S) is the pixel at (row, col)
// of item b's S x S crop, packed R | G << 8 | B << 16; pass 2 ignores any
// alpha byte and writes its own.
//
// The packed RGBA canvases [B, SIN, SIN] int32, cropped at the item's
// offsets (item.x, item.y).
struct PackedCanvas {
  const int32_t* img;
  int SIN;
  __device__ __forceinline__ int32_t load(int b, int4 item, int row, int col,
                                          int S) const {
    const int y0 = crop_offset(item.x, S, SIN);
    const int x0 = crop_offset(item.y, S, SIN);
    return img[((size_t)b * SIN + (y0 + row)) * SIN + (x0 + col)];
  }
};

// The RGB crops [B, S, S, 3] uint8, read three bytes per pixel.
struct RgbCrop {
  const uint8_t* img;
  __device__ __forceinline__ int32_t load(int b, int4, int row, int col,
                                          int S) const {
    const uint8_t* p = img + (((size_t)b * S + row) * S + col) * 3;
    return (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
  }
};

__device__ __forceinline__ float brighten(int ch, float fb) {
  return floorf(fminf(__fmul_rn((float)ch, fb), 255.f));
}

__device__ __forceinline__ int luma(float r, float g, float b) {
  return ((int)r * 19595 + (int)g * 38470 + (int)b * 7471 + 0x8000) >> 16;
}

// PIL Image.blend: deg + f*(x - deg), truncated.
__device__ __forceinline__ float blend(float deg, float x, float f) {
  const float t = __fadd_rn(deg, __fmul_rn(f, __fsub_rn(x, deg)));
  return floorf(fminf(fmaxf(t, 0.f), 255.f));
}

template <class Source>
__global__ void __launch_bounds__(kThreads) gather_luma_kernel(
    const Source src, const int4* __restrict__ items,
    const int32_t* __restrict__ sh1, const int32_t* __restrict__ sh2,
    const float* __restrict__ params, int32_t* __restrict__ out,
    unsigned long long* __restrict__ lum_sums, int S) {
  const int b = blockIdx.y;
  const int n = S * S;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  unsigned int lum = 0;
  if (idx < n) {
    const int y = idx / S;
    const int x = idx - y * S;
    const int4 item = items[b];
    int row, col;
    const int32_t v =
        ipp::shear_source(sh1 + (size_t)b * S, sh2 + (size_t)b * S, item.z, y,
                          x, S, row, col)
            ? src.load(b, item, row, col, S)
            : 0;
    out[(size_t)b * n + idx] = v;
    const float fb = fmaxf(params[b * 8 + 0], 0.f);
    lum = luma(brighten(v & 0xFF, fb), brighten((v >> 8) & 0xFF, fb),
               brighten((v >> 16) & 0xFF, fb));
  }
  // block sum (at most 255 * kThreads), then one 64-bit atomic per block
  for (int o = 16; o > 0; o >>= 1) lum += __shfl_down_sync(0xffffffffu, lum, o);
  __shared__ unsigned int warp_sums[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = lum;
  __syncthreads();
  if (threadIdx.x < 32) {
    lum = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0u;
    for (int o = 16; o > 0; o >>= 1)
      lum += __shfl_down_sync(0xffffffffu, lum, o);
    if (threadIdx.x == 0 && lum != 0)
      atomicAdd(&lum_sums[b], (unsigned long long)lum);
  }
}

__global__ void __launch_bounds__(kThreads) finish_kernel(
    int32_t* __restrict__ out, const unsigned long long* __restrict__ lum_sums,
    const float* __restrict__ params, const FilterStack filters, int S) {
  const int b = blockIdx.y;
  const int n = S * S;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int y = idx / S;
  const int x = idx - y * S;
  int32_t* px = out + (size_t)b * n + idx;
  const int32_t v = *px;
  const int r = v & 0xFF, g = (v >> 8) & 0xFF, bl = (v >> 16) & 0xFF;

  // ---- cv2 8U HSV (hsv_shift = 12) on the pre-enhance pixel -------------
  const int vmax = max(max(r, g), bl);
  const int diff = vmax - min(min(r, g), bl);
  const int sdiv = (int)rintf(__fdiv_rn(1044480.f, (float)max(vmax, 1)));
  const int s8 = (diff * sdiv + 2048) >> 12;
  const int hnum = vmax == r ? g - bl
                 : vmax == g ? bl - r + 2 * diff : r - g + 4 * diff;
  const int hdiv = (int)rintf(__fdiv_rn(122880.f, (float)max(diff, 1)));
  int h8 = (hnum * hdiv + 2048) >> 12;  // arithmetic shift, as in the TPU kernel
  if (h8 < 0) h8 += 180;
  bool masked = false;
#pragma unroll
  for (int f = 0; f < kMaxFilters; ++f) {
    if (f >= filters.n) break;
    const int* lo = filters.lo[f];
    const int* hi = filters.hi[f];
    const int* zn = filters.zone[f];
    masked |= h8 >= lo[0] && h8 <= hi[0] && s8 >= lo[1] && s8 <= hi[1] &&
              vmax >= lo[2] && vmax <= hi[2] && y >= zn[0] && y < S - zn[1] &&
              x >= zn[2] && x < S - zn[3];
  }

  // ---- PIL enhance: brightness, contrast, color, gains ------------------
  const float* prm = params + b * 8;
  const float fb = fmaxf(prm[0], 0.f), fc = prm[1], fcol = prm[2];
  float rf = brighten(r, fb), gf = brighten(g, fb), bf = brighten(bl, fb);
  // round-half-up mean of the luma sum T over n pixels: floor((2T+n)/(2n))
  const long long total = (long long)lum_sums[b];
  const float mean = (float)((2 * total + n) / (2 * (long long)n));
  rf = blend(mean, rf, fc);
  gf = blend(mean, gf, fc);
  bf = blend(mean, bf, fc);
  const float l2 = (float)luma(rf, gf, bf);
  rf = blend(l2, rf, fcol);
  gf = blend(l2, gf, fcol);
  bf = blend(l2, bf, fcol);
  rf = fminf(rintf(__fmul_rn(rf, fmaxf(prm[3], 0.f))), 255.f);
  gf = fminf(rintf(__fmul_rn(gf, fmaxf(prm[4], 0.f))), 255.f);
  bf = fminf(rintf(__fmul_rn(bf, fmaxf(prm[5], 0.f))), 255.f);
  *px = (int32_t)((unsigned)rf | ((unsigned)gf << 8) | ((unsigned)bf << 16) |
                  (masked ? 0u : 0xFF000000u));
}

// The two launches of both entry points: gather + luma sums, then finish.
template <class Source>
int launch_chain(const Source src, int32_t* out,
                 unsigned long long* lum_sums, const int32_t* items,
                 const int32_t* sh1, const int32_t* sh2, const float* params,
                 const int32_t* filters_host, int n_filters, int B, int S,
                 void* stream) {
  if (n_filters < 0 || n_filters > kMaxFilters || B < 1 || B > 65535 ||
      S < 1 || S > 46340)
    return (int)cudaErrorInvalidValue;
  FilterStack fs{};
  fs.n = n_filters;
  for (int f = 0; f < n_filters; ++f) {
    const int32_t* row = filters_host + 10 * f;
    for (int k = 0; k < 3; ++k) {
      fs.lo[f][k] = row[k];
      fs.hi[f][k] = row[3 + k];
    }
    for (int k = 0; k < 4; ++k) fs.zone[f][k] = row[6 + k];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(lum_sums, 0, sizeof(unsigned long long) * B, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S * S + kThreads - 1) / kThreads, B);
  gather_luma_kernel<Source><<<grid, kThreads, 0, st>>>(
      src, reinterpret_cast<const int4*>(items), sh1, sh2, params, out,
      lum_sums, S);
  finish_kernel<<<grid, kThreads, 0, st>>>(out, lum_sums, params, fs, S);
  return (int)cudaGetLastError();
}

}  // namespace

// items: [B] of (y0, x0, d4 code, unused) int32; sh1, sh2: [B, S] int32;
// params: [B, 8] float32; filters_host: host int32 [n_filters, 10] rows of
// (lo h s v, hi h s v, top bottom left right); out: [B, S, S] int32;
// lum_sums: [B] 64-bit scratch.  Returns cudaGetLastError() after launching.
extern "C" int ipp_augment_full(const int32_t* packed, int32_t* out,
                                unsigned long long* lum_sums,
                                const int32_t* items, const int32_t* sh1,
                                const int32_t* sh2, const float* params,
                                const int32_t* filters_host, int n_filters,
                                int B, int SIN, int S, void* stream) {
  if (SIN < S) return (int)cudaErrorInvalidValue;
  return launch_chain(PackedCanvas{packed, SIN}, out, lum_sums, items, sh1,
                      sh2, params, filters_host, n_filters, B, S, stream);
}

// rgb: [B, S, S, 3] uint8 crops; items: [B] of (0, 0, d4 code, unused)
// int32; the other arguments as for ipp_augment_full.
extern "C" int ipp_augment_fused(const uint8_t* rgb, int32_t* out,
                                 unsigned long long* lum_sums,
                                 const int32_t* items, const int32_t* sh1,
                                 const int32_t* sh2, const float* params,
                                 const int32_t* filters_host, int n_filters,
                                 int B, int S, void* stream) {
  return launch_chain(RgbCrop{rgb}, out, lum_sums, items, sh1, sh2, params,
                      filters_host, n_filters, B, S, stream);
}

extern "C" const char* ipp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
