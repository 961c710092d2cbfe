// The batched Paeth three-shear rotation on Hopper (sm_90a): an exact
// quarter turn, then three shears, of square images [B, S, S, C] uint8, or
// of an S x S crop of uint8 canvases [B, H, W, Cin] (ipp_shear_rotate).
//
// Replaces the TPU kernels
//   image_processor_pipeline_tpu/ops/pallas/rotate.py:_shear_kernel_packed
//     (C = 3 and 4; the TPU pads RGB to packed RGBA for its 32-bit lanes)
//   image_processor_pipeline_tpu/ops/pallas/rotate.py:_shear_kernel
//     (any other C, channel-interleaved lanes)
// together with the XLA quarter turn around them (rotate.py:181-193), the
// RGB alpha pad and strip (rotate.py:226-229), the shift clip and quarter
// turn normalisation of ops/geometry.py:applied_shifts, and, for the chain
// mode cuda_shear, the crop in front of them (lax.dynamic_slice's rule).
// Byte-identical to the plain PyTorch version, ops/geometry.py:
// rotate_square_shear_by (after ops/augment.py:_crop for a crop), given the
// same (quad, sh1, sh2), for any vectors.  Unlike _shear_kernel, whose
// fixed 9-bit offset clips shifts on canvases above 720 px, every shift is
// applied in full.
//
// Layout.  The TPU kernels shear with bit-decomposed roll+select passes
// (27 passes over the image) because Mosaic has no gather.  Here each
// output pixel walks back through the three shears and the quarter turn to
// its one source pixel (the walk of shear_walk.cuh, on vectors staged with
// a margin).  One CTA of 256 threads makes one tile of kTileH x kTW output
// pixels (64 x 128 for a one-byte canvas pixel, else 64 x 64: tile_width,
// the faster of the two for each on an H100); a warp takes 32
// neighbouring pixels of an output row at a time, kTW / 32 of them a row,
// 8 rows apart, so that every shared-memory read of a warp falls in
// distinct banks or is a broadcast.  A CTA stages the part of its image's
// shift vectors that its tile can reach (clipped as applied), walks each
// pixel once, keeping its source (y1, x1) in a register as two 16-bit
// halves, and takes the exact bounding box of the tile's sources (16x2
// min/max, then a block reduction).  Then, on one of two paths:
//
//   tiled:  the box fits the window buffer (sized for any shear_params
//           vectors: at |phi| <= 45 degrees after the quarter turn, a 64 x
//           64 tile's sources span at most 91 x 91 pixels): every line of
//           the box is copied from device memory into shared memory once,
//           as the aligned 16-byte blocks that hold it (each thread issues
//           several loads before it stores them), placed so that a crop
//           pixel's byte in the window is affine in (row, col).  Lines are
//           an odd number of blocks apart, so a column of the window, which
//           a transposing quarter turn reads along an output row, lies in 8
//           banks.  Each pixel then reads its source's bytes from there.
//   direct: the box does not fit (arbitrary vectors only), or the caller
//           forces it: every pixel reads its source from device memory.
//           Each such tile adds one to an optional counter.
//
// Stores: a warp writes its 32 pixels as one contiguous run: bytes (C = 1),
// words (C = 4), or, for C = 3, 24 words packed across the warp by
// shuffles where the row's address allows it.  Uncovered pixels are 0.
//
// Bound.  Memory bandwidth: one read of the crop and one write of the
// output, S*S*C bytes each per image.  On an H100 the instructions a
// pixel (the walk, the box, the staging, the gather and the store) hold
// the kernel back first, then the window's L2 traffic (up to 2.2x the
// tile's bytes); PERF.md has the numbers.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "shear_walk.cuh"

namespace {

constexpr int kThreads = 256;   // a CTA: 8 warps
constexpr int kTileH = 64;      // output rows a tile
constexpr int kWinMargin = 4;   // window side beyond the rotated tile's
constexpr int kSmemLimit = 232448;  // shared memory a block may use, sm_90
constexpr int kMaxC = 4096;
constexpr int kVecLoads = 4;    // shift entries a thread loads at once
// bytes a window load moves (one aligned uint4), and its words
constexpr int kCopy = 16;
constexpr int kCopyWords = kCopy / 4;
// sh1 staged past the image: it moves x1 out of [0, S), so that one range
// check covers y1 as well
constexpr int kOffImage = 1 << 20;

// Output columns a tile for kIn bytes a canvas pixel: 128 for one, else 64,
// the faster of the two widths for each on an H100 (PERF.md).
__host__ __device__ constexpr int tile_width(int kIn) {
  return kIn == 1 ? 128 : 64;
}

// ops/augment.py:_D4_CODES[quad * 4], the D4 code of each quarter turn,
// as the nibbles of one word: quad q's code is kQuadD4 >> 4q & 15
constexpr unsigned kQuadD4 = 0x5360;

struct Shape {
  int S, H, W, C;     // crop side; canvas rows, columns, channels
  int lim1, lim2;     // |sh1| and |sh2| as applied (applied_shifts)
  int tiles_x;        // tiles along a row
  int pitch, lines;   // the window buffer: lines of pitch words
  int direct;         // 1: every tile gathers from device memory
};

// Entries of the shift vectors a CTA stages: sh1 over the rows [ty - lim2,
// ty + kTileH + lim2), sh2 over the columns [tx - lim1, tx + tile_w +
// lim1).  Every index the walk of a tile pixel forms lies in them.
__host__ __device__ __forceinline__ int sh1_len(int lim2) {
  return kTileH + 2 * lim2;
}
__host__ __device__ __forceinline__ int sh2_len(int tile_w, int lim1) {
  return tile_w + 2 * lim1;
}

// Words of the window buffer: line l starts at word l * pitch + kCopyWords
// * ((o0 + l * (line bytes % kCopy)) / kCopy) <= l * (pitch + kCopyWords),
// and a 3-byte read takes the word after its first.
__host__ __device__ __forceinline__ long long window_words(int pitch,
                                                           int lines) {
  return lines ? (long long)lines * (pitch + kCopyWords) + 1 : 0;
}

// Words before the window in shared memory: the box (4 words) and the
// two vectors, rounded up to a copy unit.
__host__ __device__ __forceinline__ int window_at(int tile_w, int lim1,
                                                  int lim2) {
  const int n = 4 + sh1_len(lim2) + sh2_len(tile_w, lim1);
  return (n + kCopyWords - 1) / kCopyWords * kCopyWords;
}

// Dynamic shared memory: the box, the two vectors and the window.
inline long long smem_bytes(int tile_w, int lim1, int lim2, int pitch,
                            int lines) {
  return 4 * (window_at(tile_w, lim1, lim2) + window_words(pitch, lines));
}

// Words a window line of w pixels needs: its w*C bytes from up to kCopy -
// 1 bytes into its first copy unit, in whole units.
__host__ __device__ __forceinline__ long long line_words(int w, int C) {
  return ((long long)w * C + 2 * kCopy - 2) / kCopy * kCopyWords;
}

// The buffer's pitch: the words of the widest box's line, an odd number of
// copy units, so that a column of the window lies in 32 / kCopyWords
// different banks.
inline long long window_pitch(int side, int C) {
  return (line_words(side, C) / kCopyWords | 1) * kCopyWords;
}

// The side of the window buffer: the most a tile's sources can span at
// |phi| <= 45 degrees, sqrt(kTileH^2 + tile_w^2), with room for rounding.
inline int window_side(int tile_w) {
  return (int)ceil(sqrt((double)(kTileH * kTileH + tile_w * tile_w))) +
         kWinMargin;
}

// n / d for n * d < 2^32: one multiply-high by m = 0xFFFFFFFF / d + 1.
__device__ __forceinline__ int div_by(int n, unsigned m) {
  return (int)__umulhi((unsigned)n, m);
}

template <bool B>
struct Path {
  static constexpr bool kTiled = B;
};

// kIn: bytes a canvas pixel, 1, 3 or 4, or 0 for the runtime count sh.C.
// kOut: bytes an output pixel (kIn, or 3 from a 4-channel canvas; 0 with
// kIn = 0).
template <int kIn, int kOut>
__global__ void __launch_bounds__(kThreads, tile_width(kIn) == 64 ? 5 : 4)
    shear_tile_kernel(const uint8_t* __restrict__ src,
                      uint8_t* __restrict__ dst,
                      const int32_t* __restrict__ y0s,
                      const int32_t* __restrict__ x0s,
                      const int32_t* __restrict__ quads,
                      const int32_t* __restrict__ sh1g,
                      const int32_t* __restrict__ sh2g,
                      int32_t* __restrict__ direct_tiles, const Shape sh) {
  constexpr int kTW = tile_width(kIn);            // output columns a tile
  constexpr int kNJ = kTW / 32;                   // pixels a row a thread
  constexpr int kNK = kTileH / (kThreads / 32);   // rows a thread, 8 apart
  extern __shared__ __align__(16) int smem[];
  const int S = sh.S, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int C = kIn ? kIn : sh.C;     // bytes a canvas pixel
  const int CO = kOut ? kOut : sh.C;  // bytes an output pixel
  const int ty = (blockIdx.x / sh.tiles_x) * kTileH;
  const int tx = (blockIdx.x % sh.tiles_x) * kTW;
  const int ylo = ty - sh.lim2, xlo = tx - sh.lim1;
  const int n1 = sh1_len(sh.lim2), n2 = sh2_len(kTW, sh.lim1);
  // min y1, max y1, min x1, max x1 of the tile's sources
  unsigned* box = reinterpret_cast<unsigned*>(smem);
  int* s1 = smem + 4;  // s1[i]: sh1[ylo + i]
  int* s2 = s1 + n1;   // s2[i]: sh2[xlo + i]
  uint32_t* win =
      reinterpret_cast<uint32_t*>(smem + window_at(kTW, sh.lim1, sh.lim2));
  const uint8_t* smem8 = reinterpret_cast<const uint8_t*>(smem);

  // ---- the shift vectors as applied, the quarter turn's D4 code ---------
  // (s2 follows s1: entry i < n1 + n2 of s1 is sh1[ylo + i] or sh2[xlo +
  // i - n1]); each thread's loads are all issued before its first store
  const int q = __ldg(quads + b);
  const int32_t* g1 = sh1g + (size_t)b * S;
  const int32_t* g2 = sh2g + (size_t)b * S;
  for (int i0 = 0; i0 < n1 + n2; i0 += kThreads * kVecLoads) {
    int v[kVecLoads];
#pragma unroll
    for (int u = 0; u < kVecLoads; ++u) {
      const int i = i0 + u * kThreads + tid;
      const bool one = i < n1;
      const int at = one ? ylo + i : xlo + i - n1;
      const int lim = one ? sh.lim1 : sh.lim2;
      v[u] = i >= n1 + n2 ? 0
             : (unsigned)at < (unsigned)S
                 ? min(max(__ldg((one ? g1 : g2) + at), -lim), lim)
                 : one ? -kOffImage : 0;
    }
#pragma unroll
    for (int u = 0; u < kVecLoads; ++u) {
      const int i = i0 + u * kThreads + tid;
      if (i < n1 + n2) s1[i] = v[u];
    }
  }
  if (tid < 4) box[tid] = tid & 1 ? 0u : UINT_MAX;
  const int d4 = (unsigned)q < 4u ? kQuadD4 >> 4 * q & 15 : 0;
  __syncthreads();

  // ---- the walk (shear_walk.cuh:shear_back): each pixel's (y1, x1) as
  // y1 << 16 | x1, ~0 for none, and the box of the tile's sources --------
  // pixel (k, j): row ty + warp + 8k, column tx + lane + 32j
  const int x = tx + lane;
  uint32_t yx[kNK][kNJ];
  uint32_t lo = ~0u, hi = 0u;  // 16x2 min and max of (y1, x1)
#pragma unroll
  for (int k = 0; k < kNK; ++k) {
    const int y = ty + warp + 8 * k;
    const int yc = min(y, S - 1);  // rows past the image walk row S-1
    const int x2b = x - s1[yc - ylo];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int x2 = x2b + 32 * j;
      const int y1 = yc - s2[x2 - xlo];
      const int x1 = x2 - s1[y1 - ylo];  // off [0, S) where y1 is
      const bool hit = y < S && x + 32 * j < S &&
                       (unsigned)x2 < (unsigned)S &&
                       (unsigned)x1 < (unsigned)S;
      const uint32_t v = hit ? __byte_perm(x1, y1, 0x5410) : ~0u;
      yx[k][j] = v;
      lo = __vminu2(lo, v);
      hi = __vmaxu2(hi, hit ? v : 0u);
    }
  }
  {
    const unsigned ya = __reduce_min_sync(~0u, lo >> 16);
    const unsigned yb = __reduce_max_sync(~0u, hi >> 16);
    const unsigned xa = __reduce_min_sync(~0u, lo & 0xFFFFu);
    const unsigned xb = __reduce_max_sync(~0u, hi & 0xFFFFu);
    if (lane == 0) {
      atomicMin(&box[0], ya);
      atomicMax(&box[1], yb);
      atomicMin(&box[2], xa);
      atomicMax(&box[3], xb);
    }
  }
  __syncthreads();

  // ---- the box in the crop's (row, col), and which path the tile takes --
  // crop (row, col) = T^t (a, c) with a = fy ? S-1-y1 : y1, c likewise:
  // row = y1 * ry + x1 * rx + rk, col = y1 * cy + x1 * cx + ck
  const bool tr = d4 & 4;
  const int as = (d4 & 2) ? -1 : 1, ak = (d4 & 2) ? S - 1 : 0;
  const int cs = (d4 & 1) ? -1 : 1, ck0 = (d4 & 1) ? S - 1 : 0;
  const int ry = tr ? 0 : as, rx = tr ? cs : 0, rk = tr ? ck0 : ak;
  const int cy = tr ? as : 0, cx = tr ? 0 : cs, ck = tr ? ak : ck0;
  const bool any = box[0] <= box[1];  // a source exists; else all 0
  int rlo = 0, clo = 0, h = 1, w = 1;
  if (any) {
    const int y1lo = box[0], y1hi = box[1], x1lo = box[2], x1hi = box[3];
    const int alo = (d4 & 2) ? S - 1 - y1hi : y1lo;
    const int ahi = (d4 & 2) ? S - 1 - y1lo : y1hi;
    const int blo = (d4 & 1) ? S - 1 - x1hi : x1lo;
    const int bhi = (d4 & 1) ? S - 1 - x1lo : x1hi;
    rlo = tr ? blo : alo;
    clo = tr ? alo : blo;
    h = (tr ? bhi : ahi) - rlo + 1;
    w = (tr ? ahi : bhi) - clo + 1;
  }
  const bool tiled = any && !sh.direct && h <= sh.lines &&
                     line_words(w, C) <= sh.pitch;
  if (any && !tiled && direct_tiles != nullptr && tid == 0)
    atomicAdd(direct_tiles, 1);

  // the crop's pixel (0, 0) in the canvas, and the bytes between its rows
  const int yo = y0s ? ipp::crop_offset(y0s[b], S, sh.H) : 0;
  const int xo = x0s ? ipp::crop_offset(x0s[b], S, sh.W) : 0;
  const size_t line = (size_t)sh.W * C;
  const uint8_t* img = src + ((size_t)b * sh.H + yo) * line + (size_t)xo * C;

  // ---- tiled: copy the box's lines into shared memory ------------------
  // Line l (crop row rlo + l) is copied from the aligned 16 bytes holding
  // its first byte, at a0 + l * line, to word l * pitch + kCopyWords * ((o0
  // + l * lm) / kCopy) of the window, so that crop pixel (row, col) lies at
  // byte (row - rlo) * qb + o0 + (col - clo) * C, qb = 4 * pitch + lm.
  // Work item (l, j) is the line's 16 bytes j; a thread issues the loads
  // of kStageLoads items before it stores them.
  const uintptr_t a0 =
      reinterpret_cast<uintptr_t>(img + (size_t)rlo * line + (size_t)clo * C);
  const int o0 = (int)(a0 % kCopy), lm = (int)(line % kCopy);
  const int qb = 4 * sh.pitch + lm;
  if (tiled) {  // the same for every thread of the CTA
    constexpr int kStageLoads = kTW == 64 ? 4 : 2;
    const int units = (int)(line_words(w, C) / kCopyWords);
    const int n = h * units;
    const unsigned m = 0xFFFFFFFFu / units + 1;
    for (int i0 = 0; i0 < n; i0 += kThreads * kStageLoads) {
      uint4 v[kStageLoads];
      int to[kStageLoads];
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u) {
        const int i = i0 + u * kThreads + tid;
        const int l = div_by(i, m), j = i - l * units;
        const uintptr_t a = a0 + (uintptr_t)l * line;
        const int need = (int)(a % kCopy + w * C + kCopy - 1) / kCopy;
        to[u] = i < n && j < need
                    ? l * sh.pitch + kCopyWords * ((o0 + l * lm) / kCopy + j)
                    : -1;
        if (to[u] >= 0)
          v[u] = __ldg(reinterpret_cast<const uint4*>(a - a % kCopy) + j);
      }
#pragma unroll
      for (int u = 0; u < kStageLoads; ++u)
        if (to[u] >= 0) *reinterpret_cast<uint4*>(win + to[u]) = v[u];
    }
    __syncthreads();
  }

  // ---- the gather and the stores, from the window or the canvas ---------
  auto gather = [&](auto path) {
    constexpr bool kTiled = decltype(path)::kTiled;
    // the source's first byte: at smem8 + (y1 * ky + x1 * kx + kb) in the
    // window (unsigned: the terms may wrap, their sum does not), or at img
    // + y1 * gy + x1 * gx + gb in the canvas
    const unsigned ky = ry * qb + cy * C, kx = rx * qb + cx * C;
    const unsigned kb = (unsigned)(rk - rlo) * qb +
                        (unsigned)(ck - clo) * C + o0 +
                        (unsigned)(reinterpret_cast<const uint8_t*>(win) -
                                   smem8);
    const long long gy = ry * (long long)line + cy * C;
    const long long gx = rx * (long long)line + cx * C;
    const long long gb = rk * (long long)line + ck * C;
#pragma unroll
    for (int k = 0; k < kNK; ++k) {
      const int y = ty + warp + 8 * k;
      if (y >= S) break;  // the same for the whole warp
      uint8_t* out = dst + ((size_t)b * S + y) * S * CO;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const uint32_t v = yx[k][j];
        const bool hit = v != ~0u;
        const unsigned y1 = v >> 16, x1 = v & 0xFFFFu;
        const unsigned at = y1 * ky + x1 * kx + kb;
        const uint8_t* p =
            img + ((long long)y1 * gy + (long long)x1 * gx + gb);
        const int xj = x + 32 * j;
        if constexpr (kOut == 0) {
          if (xj < S)
            for (int c = 0; c < CO; ++c)
              out[(size_t)xj * CO + c] =
                  !hit ? 0 : kTiled ? smem8[at + c] : p[c];
        } else if constexpr (kIn == 1) {
          const uint8_t px = !hit ? 0 : kTiled ? smem8[at] : __ldg(p);
          if (xj < S) out[xj] = px;
        } else {
          uint32_t px = 0u;  // the pixel's bytes, R lowest
          if (hit) {
            if constexpr (kTiled) {
              const uint32_t* wp =
                  reinterpret_cast<const uint32_t*>(smem8 + (at & ~3u));
              px = __funnelshift_r(wp[0], wp[1], 8 * (at & 3));
            } else if (kIn == 4 &&
                       (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
              px = __ldg(reinterpret_cast<const uint32_t*>(p));
            } else {
              px = __ldg(p) | __ldg(p + 1) << 8 | __ldg(p + 2) << 16 |
                   (kIn == 4 ? (uint32_t)__ldg(p + 3) << 24 : 0u);
            }
          }
          if constexpr (kOut == 4) {
            if (xj < S) reinterpret_cast<uint32_t*>(out)[xj] = px;
          } else if (S - (tx + 32 * j) >= 32 && (S & 3) == 0) {
            // the warp's 96 bytes as 24 words: word i takes bytes 4i ..
            // 4i+3, from pixels i4 = 4i / 3 and i4 + 1
            const int i4 = min(4 * lane / 3, 30), o = 4 * lane - 3 * i4;
            const uint32_t pa = __shfl_sync(~0u, px, i4);
            const uint32_t pb = __shfl_sync(~0u, px, i4 + 1);
            const uint32_t word = __byte_perm(
                pa, pb, o == 0 ? 0x4210 : o == 1 ? 0x5421 : 0x6542);
            if (lane < 24)
              reinterpret_cast<uint32_t*>(out + (size_t)(tx + 32 * j) * 3)
                  [lane] = word;
          } else if (xj < S) {
            out[3 * xj] = (uint8_t)px;
            out[3 * xj + 1] = (uint8_t)(px >> 8);
            out[3 * xj + 2] = (uint8_t)(px >> 16);
          }
        }
      }
    }
  };
  if (tiled)
    gather(Path<true>{});
  else
    gather(Path<false>{});
}

// Shared memory above 48 KB for one instantiation, once per device:
// setting a function attribute costs host time.
template <int kIn, int kOut>
cudaError_t tile_kernel_ready() {
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && ready[dev])) return err;
  err = cudaFuncSetAttribute(shear_tile_kernel<kIn, kOut>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev] = true;
  return err;
}

template <int kIn, int kOut>
cudaError_t launch(const uint8_t* src, uint8_t* dst, const int32_t* y0s,
                   const int32_t* x0s, const int32_t* quads,
                   const int32_t* sh1, const int32_t* sh2,
                   int32_t* direct_tiles, Shape sh, int B, cudaStream_t st) {
  constexpr int kTW = tile_width(kIn);
  // the staged vectors must fit a block's shared memory: S up to some
  // 39,000
  const long long fixed = smem_bytes(kTW, sh.lim1, sh.lim2, 0, 0);
  if (fixed > kSmemLimit) return cudaErrorInvalidValue;
  // the window buffer: window_side lines of the pitch its widest box
  // needs, or as many lines as fit beside the vectors (none for a large C)
  const int side = window_side(kTW);
  const long long pitch = window_pitch(side, sh.C);
  const long long room = (kSmemLimit - fixed) / 4 - 1;
  const long long fit = room / (pitch + kCopyWords);
  sh.pitch = (int)(pitch < INT_MAX ? pitch : INT_MAX);
  sh.lines = (int)(fit < side ? fit : side);
  const int smem =
      (int)smem_bytes(kTW, sh.lim1, sh.lim2, sh.pitch, sh.lines);
  cudaError_t err = tile_kernel_ready<kIn, kOut>();
  if (err != cudaSuccess) return err;
  sh.tiles_x = (sh.S + kTW - 1) / kTW;
  const dim3 grid(((sh.S + kTileH - 1) / kTileH) * sh.tiles_x, B);
  shear_tile_kernel<kIn, kOut><<<grid, kThreads, smem, st>>>(
      src, dst, y0s, x0s, quads, sh1, sh2, direct_tiles, sh);
  return cudaGetLastError();
}

// geometry.shift_bits_for(size) (k = 0.35356) and shear13_bits_for(size)
// (k = 0.20711): bits so the shift offset covers k * size.
int shift_bits(int size, double k) {
  const int need = (int)(k * size) + 2;
  int bits = 1;
  while ((1 << (bits - 1)) < need) ++bits;
  return bits > 4 ? bits : 4;
}

}  // namespace

// src: uint8 [B, H, W, Cin], contiguous; dst: uint8 [B, S, S, C], 4-byte
// aligned.  y0s, x0s: [B] int32 crop offsets (lax.dynamic_slice's rule), or
// both null for the whole image (H = W = S).  C = Cin, or C = 3 from Cin =
// 4.  quads: [B] int32 quarter turns (outside [0, 4): none); sh1, sh2: [B,
// S] int32 shifts, clipped here as rotate_square_shear_by clips them.
// direct_tiles: an int32 to which each tile gathered from device memory
// adds one, or null.  direct = 1 sends every tile to the direct path.
// Returns cudaErrorInvalidValue for shapes it does not take (S beyond the
// shared memory its staged vectors need, some 39,000), else
// cudaGetLastError() after launching.
extern "C" int ipp_shear_rotate(const uint8_t* src, uint8_t* dst,
                                const int32_t* y0s, const int32_t* x0s,
                                const int32_t* quads, const int32_t* sh1,
                                const int32_t* sh2, int32_t* direct_tiles,
                                int B, int H, int W, int Cin, int S, int C,
                                int direct, void* stream) {
  if (S < 1 || S > 65535 || B < 1 || B > 65535 || H < S || W < S ||
      Cin < 1 || Cin > kMaxC || (C != Cin && !(C == 3 && Cin == 4)) ||
      ((y0s == nullptr) != (x0s == nullptr)) ||
      (y0s == nullptr && (H != S || W != S)) ||
      (reinterpret_cast<uintptr_t>(dst) & 3))
    return (int)cudaErrorInvalidValue;
  Shape sh{};
  sh.S = S;
  sh.H = H;
  sh.W = W;
  sh.C = Cin;
  sh.lim1 = (1 << (shift_bits(S, 0.20711) - 1)) - 1;
  sh.lim2 = (1 << (shift_bits(S, 0.35356) - 1)) - 1;
  sh.direct = direct != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cin == 4 && C == 4)
    return (int)launch<4, 4>(src, dst, y0s, x0s, quads, sh1, sh2,
                             direct_tiles, sh, B, st);
  if (Cin == 4)
    return (int)launch<4, 3>(src, dst, y0s, x0s, quads, sh1, sh2,
                             direct_tiles, sh, B, st);
  if (Cin == 3)
    return (int)launch<3, 3>(src, dst, y0s, x0s, quads, sh1, sh2,
                             direct_tiles, sh, B, st);
  if (Cin == 1)
    return (int)launch<1, 1>(src, dst, y0s, x0s, quads, sh1, sh2,
                             direct_tiles, sh, B, st);
  return (int)launch<0, 0>(src, dst, y0s, x0s, quads, sh1, sh2, direct_tiles,
                           sh, B, st);
}
