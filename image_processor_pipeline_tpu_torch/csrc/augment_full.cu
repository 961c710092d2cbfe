// The flagship augment chain on Hopper (sm_90a): crop, user flip, exact
// quarter turn, Paeth 3-shear rotation, cv2 HSV colour mask into alpha and
// PIL-exact enhance, for a batch of uint8 canvases [B, SIN, SIN, C] with
// C in {3, 4} (ipp_augment_full).
//
// ipp_augment_full replaces two TPU kernels:
//   image_processor_pipeline_tpu/ops/pallas/augment.py:_augment_full_kernel
//     together with the XLA flip epilogue of augment_fused_pallas_full.  A
//     packed int32 [B, SIN, SIN] canvas (the JAX contract) is the C = 4
//     canvas reinterpreted; any alpha byte is ignored.  Byte-identical to
//     the plain PyTorch version, ops/augment.py:augment_full_reference,
//     given the same shift vectors.
//   image_processor_pipeline_tpu/ops/pallas/augment.py:_augment_kernel
//     together with the XLA RGB->RGBA pack and D4 passes (_dihedral_batch)
//     before it in augment_fused_pallas: there the canvas is the RGB crop
//     [B, S, S, 3] itself (SIN = S, offsets 0).  Byte-identical to
//     ops/augment.py:augment_finish_reference, given the same shift vectors.
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
// Bound.  The bytes: 3 (or 4) read per crop pixel and 4 written, 1.8 MB
// per 512 px RGB image, 35 us for 64 images at 3.35 TB/s.  The operations
// bind first: some 180 SASS instructions a pixel on the cluster path (two
// walks, the HSV mask, three float blends and a dozen table reads), so the
// instruction issue of the SMs, not memory, sets its time (PERF.md).
// Contrast needs each image's exact luma sum over all S*S pixels before
// any pixel can finish.
//
// The cluster path (chain_cluster_kernel, one launch): one thread-block
// cluster of K CTAs per image (K = 16 by default, ops/augment.py:CLUSTER,
// two CTAs of 256 threads an SM).  The crop is staged across the cluster's
// shared memory, indexed [a][c] by the walk's coordinates before
// the transpose (crop rows for a D4 element without one, crop columns with
// one), CTA r holding lines [r*band, (r+1)*band), band = ceil(S/K), at 4
// bytes a pixel, S + 1 words apart.  Each crop byte is read from device
// memory once, 16 pixels a work item through aligned 16-byte loads shifted
// into place.  While staging, each CTA sums the luma after brightness of
// its pixels whose forward walk stays on the canvas: each shows in exactly
// one output pixel and every other output pixel is 0, so the K partials
// add up to the image's exact sum, with no gather, no atomics and no
// memset.  After a cluster barrier every CTA takes the mean from the K
// partials and finishes its own output rows: each output pixel walks back
// and reads its source word from the shared memory of the CTA that staged
// it (distributed shared memory).  Along an output row c runs on and a
// moves slowly, so the 32 threads of a warp, on 32 neighbouring output
// pixels, read a few runs of neighbouring words (the staged lines are S + 1
// words apart, so a column is bank-conflict free as well), and store 128
// contiguous bytes.  A last cluster.sync() keeps every CTA's shared memory
// alive until no other CTA reads it.  Every step that is a function of one
// byte is a 256-entry table in shared memory, computed per CTA with exactly
// the per-pixel expression it replaces (the cv2 sdiv and hdiv quotients,
// brightness, contrast after brightness once the mean is known, the three
// gains), so the tables are byte-identical by construction; the filter
// tests become one bit a filter in tables of H, S, V, row and column.  The
// colour blend depends on two bytes and stays per pixel.  The staged band
// must fit in one CTA's shared memory, which bounds S (cluster_smem_bytes;
// ops/augment.py:chain_path mirrors it).
//
// The two-pass path (other S): gather_luma_kernel gathers, writes the raw
// rotated pixel into the output buffer and adds its post-brightness luma
// into a 64-bit per-image sum; finish_kernel reads that buffer back and
// finishes in place.  The wrapper picks the path from S alone.
//
// Floats.  Built with --fmad=false and written with _rn intrinsics, so no
// multiply-add is contracted; IEEE division for the HSV tables; rintf is
// round-half-even like torch.round, floorf like torch.floor.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shear_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;         // two-pass kernels
constexpr int kClusterThreads = 256;  // cluster kernel
constexpr int kMaxCluster = 16;
constexpr int kMaxFilters = 8;
// shared memory a block may use on sm_90 (227 KB)
constexpr int kSmemLimit = 232448;
// the cluster kernel's fixed shared memory: partial sum (16), warp sums
// (32 x 4), sdiv and hdiv (2 x 256 int32), brightness, contrast after
// brightness, three gains and the H, S and V filter masks (8 x 256 bytes)
constexpr int kFixedSmem = 16 + 128 + 2048 + 2048;
static_assert(kFixedSmem % 16 == 0, "keep the staged band 16-byte aligned");

struct FilterStack {
  int n;
  int lo[kMaxFilters][3];    // saturate-rounded H, S, V lower bounds
  int hi[kMaxFilters][3];
  int zone[kMaxFilters][4];  // top, bottom, left, right margins
};

// Dynamic shared memory of the cluster kernel: the fixed part, then three
// S-long 32-bit rows (sh1, sh2, row addresses) and two S-long byte rows
// (the zone masks) rounded up to 16 bytes, then
// the staged band of ceil(S/K) crop rows at 4 bytes a pixel, S + 1 words
// apart.
inline int cluster_smem_bytes(int S, int K) {
  const int band = (S + K - 1) / K;
  return kFixedSmem + ((14 * S + 15) & ~15) + 4 * band * (S + 1);
}

__device__ __forceinline__ float brighten(int ch, float fb) {
  return floorf(fminf(__fmul_rn((float)ch, fb), 255.f));
}

__device__ __forceinline__ int luma(int r, int g, int b) {
  return (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16;
}

// PIL Image.blend: deg + f*(x - deg), truncated.
__device__ __forceinline__ float blend(float deg, float x, float f) {
  const float t = __fadd_rn(deg, __fmul_rn(f, __fsub_rn(x, deg)));
  return floorf(fminf(fmaxf(t, 0.f), 255.f));
}

// cv2's 8U HSV quotient tables (hsv_shift = 12), entry i for a max or a
// range of i.
__device__ __forceinline__ int sdiv_entry(int vmax) {
  return (int)rintf(__fdiv_rn(1044480.f, (float)max(vmax, 1)));
}
__device__ __forceinline__ int hdiv_entry(int diff) {
  return (int)rintf(__fdiv_rn(122880.f, (float)max(diff, 1)));
}

// The gain step: x * max(gain, 0), rounded half to even, capped at 255.
__device__ __forceinline__ float gain_step(float x, float gain) {
  return fminf(rintf(__fmul_rn(x, fmaxf(gain, 0.f))), 255.f);
}

// True where the pixel (y, x) of HSV (h8, s8, vmax) falls in any filter's
// ranges inside its zone: alpha 0 there.
__device__ __forceinline__ bool in_filters(const FilterStack& filters, int h8,
                                           int s8, int vmax, int y, int x,
                                           int S) {
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
  return masked;
}

// cv2 8U HSV of the pre-enhance pixel (r, g, bl): s8 and h8, with the two
// quotients given.
__device__ __forceinline__ void hsv(int r, int g, int bl, int vmax, int diff,
                                    int sdiv, int hdiv, int& h8, int& s8) {
  s8 = (diff * sdiv + 2048) >> 12;
  const int hnum = vmax == r ? g - bl
                 : vmax == g ? bl - r + 2 * diff : r - g + 4 * diff;
  h8 = (hnum * hdiv + 2048) >> 12;  // arithmetic shift, as in the TPU kernel
  if (h8 < 0) h8 += 180;
}

// ---- the cluster path ----------------------------------------------------

// The shared memory of one CTA of the cluster kernel; every CTA has the
// same layout, so an offset into one names the same object in another.
struct ClusterSmem {
  unsigned long long* partial;  // this CTA's luma sum
  unsigned* warp_sums;
  int* sdiv;
  int* hdiv;
  uint8_t* bright;
  uint8_t* bc;        // contrast after brightness, once the mean is known
  uint8_t* gain;      // [3][256]
  uint8_t* hsv_mask;  // [3][256]: bit f where H (S, V) is in filter f's range
  uint8_t* row_mask;  // [S]: bit f where the row is in filter f's zone
  uint8_t* col_mask;  // [S]: bit f where the column is
  int* sh1;
  int* sh2;
  uint32_t* rowtab;   // crop row -> shared::cluster address of its staged copy
  uint32_t* px;       // the staged band, one 0x??BBGGRR word a pixel

  __device__ ClusterSmem(char* base, int S) {
    partial = reinterpret_cast<unsigned long long*>(base);
    warp_sums = reinterpret_cast<unsigned*>(base + 16);
    sdiv = reinterpret_cast<int*>(base + 16 + 128);
    hdiv = sdiv + 256;
    bright = reinterpret_cast<uint8_t*>(hdiv + 256);
    bc = bright + 256;
    gain = bc + 256;
    hsv_mask = gain + 768;
    sh1 = reinterpret_cast<int*>(base + kFixedSmem);
    sh2 = sh1 + S;
    rowtab = reinterpret_cast<uint32_t*>(sh2 + S);
    row_mask = reinterpret_cast<uint8_t*>(rowtab + S);
    col_mask = row_mask + S;
    px = reinterpret_cast<uint32_t*>(base + kFixedSmem +
                                     ((14 * S + 15) & ~15));
  }
};

// The shared::cluster address of the word at CTA-local shared address a in
// the CTA of rank r, and a load from such an address.
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t r) {
  uint32_t d;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(r));
  return d;
}
__device__ __forceinline__ uint32_t ld_cluster(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

// 16 pixels of a crop row, starting at byte src of the canvas: the C*16
// bytes from C + 1 aligned 16-byte loads (C when src is aligned), each of
// which holds at least one of them, as loaded (load16), then shifted into
// place as one word a pixel (pixels; the byte above B is left undefined).
template <int C>
struct Chunk {
  uint32_t w[4 * C + 4];
  int s;  // src's offset in its aligned block

  __device__ __forceinline__ void load16(const uint8_t* src) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    s = (int)(a & 15);
    const uint4* blk = reinterpret_cast<const uint4*>(a - s);
#pragma unroll
    for (int i = 0; i <= C; ++i) {
      const uint4 q = i < C || s ? __ldg(blk + i) : make_uint4(0, 0, 0, 0);
      w[4 * i] = q.x;
      w[4 * i + 1] = q.y;
      w[4 * i + 2] = q.z;
      w[4 * i + 3] = q.w;
    }
  }

  __device__ __forceinline__ void pixels(uint32_t px[16]) const {
    // drop the s bytes before src: whole words by selects, then a funnel
    const int q = s >> 2, sh = 8 * (s & 3);
    uint32_t v[4 * C + 1];
#pragma unroll
    for (int i = 0; i <= 4 * C; ++i)
      v[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
    uint32_t u[4 * C];
#pragma unroll
    for (int i = 0; i < 4 * C; ++i) u[i] = __funnelshift_r(v[i], v[i + 1], sh);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (C == 4) {
        px[k] = u[k];
      } else {  // bytes 3k .. 3k+2 of u
        const int j = 3 * k / 4, o = 3 * k % 4;
        px[k] = __byte_perm(u[j], j + 1 < 4 * C ? u[j + 1] : 0u,
                            o | (o + 1) << 4 | (o + 2) << 8);
      }
    }
  }
};

// The 0x00BBGGRR crop pixel that output pixel (y, x) shows, read from the
// shared memory of the CTA that staged its line (distributed shared
// memory); 0 where it has no source.  The staged crop is indexed [a][c]
// by the walk's (a, c), before the transpose: along an output row c runs
// on and a moves slowly, so the 32 threads of a warp, on 32 neighbouring
// output pixels, read a few runs of neighbouring words.
__device__ __forceinline__ uint32_t gather(const ClusterSmem& sm, int d4,
                                           int y, int x, int S) {
  int y1, x1;  // (0, 0) where there is no source
  const bool hit = ipp::shear_back(sm.sh1, sm.sh2, y, x, S, y1, x1);
  const int a = (d4 & 2) ? S - 1 - y1 : y1;
  const int c = (d4 & 1) ? S - 1 - x1 : x1;
  const uint32_t w = ld_cluster(sm.rowtab[a] + 4u * c);
  return hit ? w & 0xFFFFFFu : 0u;
}

// The luma after brightness of the staged pixel v at (a, c) where its
// forward walk stays on the canvas, else 0.  Such a pixel shows in exactly
// one output pixel and every other output pixel is 0 (luma 0), so these
// summed over the staged crop are the image's luma sum: no gather needed.
__device__ __forceinline__ unsigned staged_luma(const ClusterSmem& sm, int d4,
                                                int a, int c, int S,
                                                uint32_t v) {
  // branch-free: a step that leaves [0, S) reads entry 0 and misses
  const int y1 = (d4 & 2) ? S - 1 - a : a;
  const int x2 = ((d4 & 1) ? S - 1 - c : c) + sm.sh1[y1];
  const bool in2 = (unsigned)x2 < (unsigned)S;
  const int y = y1 + sm.sh2[in2 ? x2 : 0];
  const bool in3 = in2 && (unsigned)y < (unsigned)S;
  const int x = x2 + sm.sh1[in3 ? y : 0];
  const unsigned l = luma(sm.bright[v & 0xFF], sm.bright[(v >> 8) & 0xFF],
                          sm.bright[(v >> 16) & 0xFF]);
  return in3 && (unsigned)x < (unsigned)S ? l : 0u;
}

// n / S for n * S < 2^32: one multiply-high by m = ceil(2^32 / S), the
// quotient's error n * (m * S - 2^32) / 2^32 staying below 1 / S.
__device__ __forceinline__ int div_by(int n, unsigned m) {
  return (int)__umulhi((unsigned)n, m);
}

// Mask and enhance one raw pixel v at (y, x) with the CTA's tables.
__device__ __forceinline__ uint32_t finish_px(const ClusterSmem& sm,
                                              uint32_t v, int y, int x,
                                              float fcol) {
  const int r = v & 0xFF, g = (v >> 8) & 0xFF, bl = v >> 16;
  const int vmax = max(max(r, g), bl);
  const int diff = vmax - min(min(r, g), bl);
  int h8, s8;
  hsv(r, g, bl, vmax, diff, sm.sdiv[vmax], sm.hdiv[diff], h8, s8);
  // in_filters as five table reads: one bit a filter
  const bool masked = sm.hsv_mask[h8] & sm.hsv_mask[256 + s8] &
                      sm.hsv_mask[512 + vmax] & sm.row_mask[y] &
                      sm.col_mask[x];
  const int rc = sm.bc[r], gc = sm.bc[g], bc = sm.bc[bl];
  const float l2 = (float)luma(rc, gc, bc);
  return (uint32_t)sm.gain[(int)blend(l2, (float)rc, fcol)] |
         ((uint32_t)sm.gain[256 + (int)blend(l2, (float)gc, fcol)] << 8) |
         ((uint32_t)sm.gain[512 + (int)blend(l2, (float)bc, fcol)] << 16) |
         (masked ? 0u : 0xFF000000u);
}

template <int C>
__global__ void __launch_bounds__(kClusterThreads, 1) chain_cluster_kernel(
    const uint8_t* __restrict__ canvas, const int4* __restrict__ items,
    const int32_t* __restrict__ sh1g, const int32_t* __restrict__ sh2g,
    const float* __restrict__ params, int32_t* __restrict__ out,
    const FilterStack filters, int SIN, int S) {
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / K;
  const int band = (S + K - 1) / K;
  const int r_lo = min(S, rank * band), r_hi = min(S, r_lo + band);
  const int tid = threadIdx.x;
  const ClusterSmem sm(smem, S);
  const int4 item = items[b];
  const float* prm = params + b * 8;
  const float fb = fmaxf(prm[0], 0.f), fc = prm[1], fcol = prm[2];

  // ---- tables, shift vectors, row addresses -----------------------------
  if (tid < 256) {
    sm.sdiv[tid] = sdiv_entry(tid);
    sm.hdiv[tid] = hdiv_entry(tid);
    sm.bright[tid] = (uint8_t)brighten(tid, fb);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      sm.gain[c * 256 + tid] = (uint8_t)gain_step((float)tid, prm[3 + c]);
    unsigned hm = 0, sm_ = 0, vm = 0;
    for (int f = 0; f < filters.n; ++f) {
      const int* lo = filters.lo[f];
      const int* hi = filters.hi[f];
      hm |= (unsigned)(tid >= lo[0] && tid <= hi[0]) << f;
      sm_ |= (unsigned)(tid >= lo[1] && tid <= hi[1]) << f;
      vm |= (unsigned)(tid >= lo[2] && tid <= hi[2]) << f;
    }
    sm.hsv_mask[tid] = (uint8_t)hm;
    sm.hsv_mask[256 + tid] = (uint8_t)sm_;
    sm.hsv_mask[512 + tid] = (uint8_t)vm;
  }
  const uint32_t px_local = (uint32_t)__cvta_generic_to_shared(sm.px);
  for (int i = tid; i < S; i += kClusterThreads) {
    sm.sh1[i] = sh1g[(size_t)b * S + i];
    sm.sh2[i] = sh2g[(size_t)b * S + i];
    const int owner = i / band;
    // staged rows are S + 1 words apart, so a column is bank-conflict free
    sm.rowtab[i] =
        mapa(px_local + 4u * (uint32_t)((i - owner * band) * (S + 1)), owner);
    unsigned rm = 0, cm = 0;
    for (int f = 0; f < filters.n; ++f) {
      const int* zn = filters.zone[f];
      rm |= (unsigned)(i >= zn[0] && i < S - zn[1]) << f;
      cm |= (unsigned)(i >= zn[2] && i < S - zn[3]) << f;
    }
    sm.row_mask[i] = (uint8_t)rm;
    sm.col_mask[i] = (uint8_t)cm;
  }

  // ---- stage lines [r_lo, r_hi) of the crop and sum their luma ---------
  // item is (y0, x0, D4 code, unused): item.x is the row offset.  The
  // staged crop is indexed [a][c] (gather): by crop row for a D4 element
  // without transpose, by crop column with one (d4 & 4).
  const int d4 = item.z;
  const int y0 = ipp::crop_offset(item.x, S, SIN);
  const int x0 = ipp::crop_offset(item.y, S, SIN);
  const bool tr = d4 & 4;
  // line l: `len` pixels of crop row row0 + l from crop column col0, its
  // pixel k staged at px[l * lstride + k * step]
  const int nb = r_hi - r_lo;
  const int lines = tr ? S : nb, len = tr ? nb : S;
  const int col0 = tr ? r_lo : 0, row0 = tr ? 0 : r_lo;
  const int lstride = tr ? 1 : S + 1, step = tr ? S + 1 : 1;
  const int chunks = len >> 4, per_line = chunks + (len & 15);
  const int work = lines * per_line;
  __syncthreads();  // sh1, sh2 and the tables, for the luma walk
  // work item i: 16 pixels of a line, or one of its last len % 16; pixel k
  // of line l is at (a, c) = (r_lo + l, k), or (r_lo + k, l) transposed
  unsigned lum = 0;
  for (int i = tid; i < work; i += kClusterThreads) {
    const int l = i / per_line, j = i - l * per_line;
    const int k0 = j < chunks ? 16 * j : 16 * chunks + j - chunks;
    const uint8_t* src =
        canvas +
        (((size_t)b * SIN + (y0 + row0 + l)) * SIN + x0 + col0 + k0) * C;
    uint32_t* dst = sm.px + l * lstride + k0 * step;
    const int a = r_lo + (tr ? k0 : l), c = tr ? l : k0;
    if (j < chunks) {
      Chunk<C> chunk;
      chunk.load16(src);
      uint32_t px[16];
      chunk.pixels(px);
#pragma unroll
      for (int k = 0; k < 16; ++k)
        lum += staged_luma(sm, d4, a + (tr ? k : 0), c + (tr ? 0 : k), S,
                           px[k]);
#pragma unroll
      for (int k = 0; k < 16; ++k) dst[k * step] = px[k];
    } else {
      const uint32_t v = src[0] | src[1] << 8 | src[2] << 16;
      lum += staged_luma(sm, d4, a, c, S, v);
      *dst = v;
    }
  }

  // block sum (at most 255 * band * S < 2^32); the cluster barrier after it
  // also makes every CTA's staged band visible to the others

  for (int o = 16; o > 0; o >>= 1) lum += __shfl_down_sync(0xffffffffu, lum, o);
  if ((tid & 31) == 0) sm.warp_sums[tid >> 5] = lum;
  __syncthreads();
  if (tid < 32) {
    lum = tid < kClusterThreads / 32 ? sm.warp_sums[tid] : 0u;
    for (int o = 16; o > 0; o >>= 1)
      lum += __shfl_down_sync(0xffffffffu, lum, o);
    if (tid == 0) *sm.partial = lum;
  }
  cluster.sync();

  // ---- the image's mean, then contrast after brightness as a table -------
  if (tid < 256) {
    unsigned long long total = 0;
    for (int r = 0; r < K; ++r)
      total += *cluster.map_shared_rank(sm.partial, r);
    // round-half-up mean of the luma sum T over n pixels: floor((2T+n)/(2n))
    const long long n = (long long)S * S;
    const float mean = (float)((2 * (long long)total + n) / (2 * n));
    sm.bc[tid] = (uint8_t)blend(mean, (float)sm.bright[tid], fc);
  }
  __syncthreads();

  // ---- finish: mask, enhance, store ------------------------------------
  // four output pixels a step, kClusterThreads apart: a warp gathers 32
  // neighbouring pixels a load and stores them as 128 contiguous bytes
  int32_t* img_out = out + (size_t)b * S * S + (size_t)r_lo * S;
  const int n_out = nb * S;
  const unsigned m_s = 0xFFFFFFFFu / S + 1;
  for (int i = tid; i < n_out; i += 4 * kClusterThreads) {
    int ys[4], xs[4];
    uint32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // past the end: the first pixel of the band, gathered and not stored
      const int j = i + k * kClusterThreads, idx = j < n_out ? j : 0;
      const int ly = div_by(idx, m_s);
      ys[k] = r_lo + ly;
      xs[k] = idx - ly * S;
      v[k] = gather(sm, d4, ys[k], xs[k], S);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i + k * kClusterThreads >= n_out) break;
      img_out[i + k * kClusterThreads] =
          (int32_t)finish_px(sm, v[k], ys[k], xs[k], fcol);
    }
  }
  // no CTA leaves while another may still read its band
  cluster.sync();
}

// ---- the two-pass path ---------------------------------------------------

// The uint8 canvases [B, SIN, SIN, C], cropped at the item's offsets
// (item.x, item.y): load(b, item, row, col, S) is the pixel at (row, col)
// of item b's S x S crop as R | G << 8 | B << 16 (or with C = 4 its alpha
// byte on top, which finish_kernel ignores).
struct Canvas {
  const uint8_t* img;
  int SIN, C;
  __device__ __forceinline__ int32_t load(int b, int4 item, int row, int col,
                                          int S) const {
    const int y0 = ipp::crop_offset(item.x, S, SIN);
    const int x0 = ipp::crop_offset(item.y, S, SIN);
    const uint8_t* p =
        img + (((size_t)b * SIN + (y0 + row)) * SIN + (x0 + col)) * C;
    if (C == 4 && (reinterpret_cast<uintptr_t>(p) & 3) == 0)
      return *reinterpret_cast<const int32_t*>(p);
    return (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
  }
};

__global__ void __launch_bounds__(kThreads) gather_luma_kernel(
    const Canvas src, const int4* __restrict__ items,
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
    lum = luma((int)brighten(v & 0xFF, fb), (int)brighten((v >> 8) & 0xFF, fb),
               (int)brighten((v >> 16) & 0xFF, fb));
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

  const int vmax = max(max(r, g), bl);
  const int diff = vmax - min(min(r, g), bl);
  int h8, s8;
  hsv(r, g, bl, vmax, diff, sdiv_entry(vmax), hdiv_entry(diff), h8, s8);
  const bool masked = in_filters(filters, h8, s8, vmax, y, x, S);

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
  const float l2 = (float)luma((int)rf, (int)gf, (int)bf);
  rf = gain_step(blend(l2, rf, fcol), prm[3]);
  gf = gain_step(blend(l2, gf, fcol), prm[4]);
  bf = gain_step(blend(l2, bf, fcol), prm[5]);
  *px = (int32_t)((unsigned)rf | ((unsigned)gf << 8) | ((unsigned)bf << 16) |
                  (masked ? 0u : 0xFF000000u));
}

FilterStack make_filters(const int32_t* filters_host, int n_filters) {
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
  return fs;
}

// The cluster kernel for C channels, once per device: shared memory up to
// a block's limit and non-portable cluster sizes (above 8) allowed.
// Setting a function attribute costs host time, so it is done once.
template <int C>
cudaError_t cluster_kernel_ready() {
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && ready[dev])) return err;
  err = cudaFuncSetAttribute(chain_cluster_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chain_cluster_kernel<C>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev] = true;
  return err;
}

// cfg for a launch of the cluster kernel over B images of crop size S,
// K CTAs an image (the staged band within a block's limit).
template <int C>
cudaError_t cluster_config(int B, int S, int K, cudaStream_t st,
                           cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  if (K < 1 || K > kMaxCluster || cluster_smem_bytes(S, K) > kSmemLimit)
    return cudaErrorInvalidValue;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(B * K);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = cluster_smem_bytes(S, K);
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = K;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cluster_kernel_ready<C>();
}

template <int C>
cudaError_t launch_cluster(const uint8_t* canvas, int32_t* out,
                           const int32_t* items, const int32_t* sh1,
                           const int32_t* sh2, const float* params,
                           const FilterStack& fs, int B, int SIN, int S,
                           int K, cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<C>(B, S, K, st, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, chain_cluster_kernel<C>, canvas,
                            reinterpret_cast<const int4*>(items), sh1, sh2,
                            params, out, fs, SIN, S);
}

}  // namespace

// canvas: [B, SIN, SIN, C] uint8, C in {3, 4}; items: [B] of (y0, x0, d4
// code, unused) int32; sh1, sh2: [B, S] int32; params: [B, 8] float32;
// filters_host: host int32 [n_filters, 10] rows of (lo h s v, hi h s v,
// top bottom left right); out: [B, S, S] int32.  cluster = K > 0 takes the
// cluster path with K CTAs an image (lum_sums unused); cluster = 0 the
// two-pass path, with lum_sums a [B] 64-bit scratch.  Returns the launch's
// error, then cudaGetLastError().
extern "C" int ipp_augment_full(const uint8_t* canvas, int32_t* out,
                                unsigned long long* lum_sums,
                                const int32_t* items, const int32_t* sh1,
                                const int32_t* sh2, const float* params,
                                const int32_t* filters_host, int n_filters,
                                int B, int SIN, int C, int S, int cluster,
                                void* stream) {
  if (n_filters < 0 || n_filters > kMaxFilters || B < 1 || B > 65535 ||
      S < 1 || S > 46340 || SIN < S || (C != 3 && C != 4) || cluster < 0)
    return (int)cudaErrorInvalidValue;
  const FilterStack fs = make_filters(filters_host, n_filters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cluster > 0) {
    err = C == 3 ? launch_cluster<3>(canvas, out, items, sh1, sh2, params, fs,
                                     B, SIN, S, cluster, st)
                 : launch_cluster<4>(canvas, out, items, sh1, sh2, params, fs,
                                     B, SIN, S, cluster, st);
  } else {
    err = cudaMemsetAsync(lum_sums, 0, sizeof(unsigned long long) * B, st);
    if (err == cudaSuccess) {
      const dim3 grid((S * S + kThreads - 1) / kThreads, B);
      const int4* it = reinterpret_cast<const int4*>(items);
      gather_luma_kernel<<<grid, kThreads, 0, st>>>(
          Canvas{canvas, SIN, C}, it, sh1, sh2, params, out, lum_sums, S);
      finish_kernel<<<grid, kThreads, 0, st>>>(out, lum_sums, params, fs, S);
    }
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The most clusters of K CTAs at crop size S that the card runs at once
// (cudaOccupancyMaxActiveClusters), into *n.
extern "C" int ipp_augment_max_active_clusters(int C, int S, int K, int* n) {
  if (C != 3 && C != 4) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = C == 3 ? cluster_config<3>(1, S, K, 0, cfg, attr)
                           : cluster_config<4>(1, S, K, 0, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  return (int)(C == 3 ? cudaOccupancyMaxActiveClusters(
                            n, chain_cluster_kernel<3>, &cfg)
                      : cudaOccupancyMaxActiveClusters(
                            n, chain_cluster_kernel<4>, &cfg));
}

extern "C" const char* ipp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
