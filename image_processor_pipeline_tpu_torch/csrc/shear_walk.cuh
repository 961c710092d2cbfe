// The inverse walk of the Paeth three-shear rotation and the crop offset
// rule, shared by the port's gather kernels: augment_full.cu walks with
// shear_back and shear_source; shear_rotate.cu takes the same three steps
// inline on the vectors it stages with a margin (no range check between
// the steps); both place their crops with crop_offset.
//
// The forward rotation of an S x S image is: a D4 element (quarter turn,
// and in the augment chain the user flip), then shear 1 (x by sh1 per
// row), shear 2 (y by sh2 per column), shear 3 (x by sh1 per row), each
// zero-filling what it uncovers (ops/geometry.py:rotate_square_shear_by).
// Each output pixel has at most one source pixel, found backwards:
//   shear 3 (per row y):       x2 = x  - sh1[y]    in [0, S) or no source
//   shear 2 (per column x2):   y1 = y  - sh2[x2]   in [0, S) or none
//   shear 1 (per row y1):      x1 = x2 - sh1[y1]   in [0, S) or none
// then (y1, x1) back through the D4 element out = Fx^fx Fy^fy T^t (in),
// coded as transpose<<2 | fy<<1 | fx (ops/augment.py:_D4_CODES).

#pragma once

#include <stdint.h>

namespace ipp {

// Sets (y1, x1), the pixel before the three shears that output pixel
// (y, x) shows, and returns true; returns false (y1 = x1 = 0) where the
// output pixel is 0.  The forward map, x2 = x1 + sh1[y1], y = y1 + sh2[x2],
// x = x2 + sh1[y], every step in [0, S), is its exact inverse.
__device__ __forceinline__ bool shear_back(
    const int32_t* __restrict__ sh1, const int32_t* __restrict__ sh2,
    int y, int x, int S, int& y1, int& x1) {
  // branch-free: a step that leaves [0, S) reads entry 0 and misses
  const int x2 = x - sh1[y];
  const bool in2 = (unsigned)x2 < (unsigned)S;
  const int yy = y - sh2[in2 ? x2 : 0];
  const bool in1 = in2 && (unsigned)yy < (unsigned)S;
  const int xx = x2 - sh1[in1 ? yy : 0];
  const bool hit = in1 && (unsigned)xx < (unsigned)S;
  y1 = hit ? yy : 0;
  x1 = hit ? xx : 0;
  return hit;
}

// Sets (row, col), the input pixel that output pixel (y, x) shows, and
// returns true; returns false (row = col = 0) where the output pixel is 0.
__device__ __forceinline__ bool shear_source(
    const int32_t* __restrict__ sh1, const int32_t* __restrict__ sh2,
    int d4, int y, int x, int S, int& row, int& col) {
  int y1, x1;
  const bool hit = shear_back(sh1, sh2, y, x, S, y1, x1);
  const int a = (d4 & 2) ? S - 1 - y1 : y1;
  const int c = (d4 & 1) ? S - 1 - x1 : x1;
  row = (d4 & 4) ? c : a;
  col = (d4 & 4) ? a : c;
  if (!hit) row = col = 0;
  return hit;
}

// lax.dynamic_slice's index rule for a crop of side S at offset off of a
// canvas side SIN: a negative offset counts from the end, then the window
// is clamped into the canvas.
__device__ __forceinline__ int crop_offset(int off, int S, int SIN) {
  if (off < 0) off += SIN;
  return min(max(off, 0), SIN - S);
}

}  // namespace ipp
