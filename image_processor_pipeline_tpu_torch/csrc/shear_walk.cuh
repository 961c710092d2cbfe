// The inverse walk of the Paeth three-shear rotation, shared by the port's
// gather kernels (augment_full.cu, shear_rotate.cu).
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

// Sets (row, col), the input pixel that output pixel (y, x) shows, and
// returns true; returns false (row = col = 0) where the output pixel is 0.
__device__ __forceinline__ bool shear_source(
    const int32_t* __restrict__ sh1, const int32_t* __restrict__ sh2,
    int d4, int y, int x, int S, int& row, int& col) {
  row = col = 0;
  const int x2 = x - sh1[y];
  if (x2 < 0 || x2 >= S) return false;
  const int y1 = y - sh2[x2];
  if (y1 < 0 || y1 >= S) return false;
  const int x1 = x2 - sh1[y1];
  if (x1 < 0 || x1 >= S) return false;
  const int a = (d4 & 2) ? S - 1 - y1 : y1;
  const int c = (d4 & 1) ? S - 1 - x1 : x1;
  row = (d4 & 4) ? c : a;
  col = (d4 & 4) ? a : c;
  return true;
}

}  // namespace ipp
