// Four data moves of one int32 block [rows, cols] on Hopper (sm_90a): a
// plain copy, a circular roll along the columns, a reverse along the
// columns and a reverse along the rows (ipp_rev_probe).
//
// Replaces the four TPU probe kernels of benchmarks/rev_probe.py
// (k_copy, k_roll, k_rev_lane, k_rev_sublane), which ask whether the TPU
// compiler lowers a reverse inside a kernel and what it costs next to a
// copy and a roll.  On a GPU every one of them is a gather by index, so the
// probe's question here is only what a launch this small costs.
//
// Layout.  One thread moves one 16-byte vector of four neighbouring
// columns where the move keeps the four together and the rows allow it
// (cols a multiple of 4, both pointers 16-byte aligned): copy and rev_rows
// move the vector as it is, rev_cols takes the mirrored vector and
// reverses its four words.  The roll shifts by any amount, which splits
// vectors, so it moves single words; so does every move of a block whose
// rows are not whole vectors.  Grid-stride loops, 256 threads a CTA.
//
// Bound.  Memory bandwidth: the block read once and written once.  At the
// probe's 512 x 512 block that is 2 MiB, under a microsecond of device
// memory time: a launch this small is set by launch latency, not bytes.
// ipp_empty_launch launches a kernel that does nothing, so that a caller
// can time what a launch alone costs on the card and hold the moves
// against that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Move { kCopy = 0, kRoll = 1, kRevCols = 2, kRevRows = 3 };

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 CTAs for each SM of an H100

// One int4 (four columns) a thread; cols4 = cols / 4.
template <int MOVE>
__global__ void rev_probe_vec_kernel(const int4* __restrict__ src,
                                     int4* __restrict__ dst, int rows,
                                     int cols4) {
  const size_t n = (size_t)rows * cols4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    if (MOVE == kCopy) {
      dst[i] = src[i];
    } else {
      const int r = (int)(i / cols4);
      const int c = (int)(i - (size_t)r * cols4);
      if (MOVE == kRevRows) {
        dst[i] = src[(size_t)(rows - 1 - r) * cols4 + c];
      } else {  // kRevCols: the mirrored vector, its words reversed
        const int4 v = src[(size_t)r * cols4 + (cols4 - 1 - c)];
        dst[i] = make_int4(v.w, v.z, v.y, v.x);
      }
    }
  }
}

// One word a thread; shift is already in [0, cols).
template <int MOVE>
__global__ void rev_probe_word_kernel(const int32_t* __restrict__ src,
                                      int32_t* __restrict__ dst, int rows,
                                      int cols, int shift) {
  const size_t n = (size_t)rows * cols;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(i / cols);
    const int c = (int)(i - (size_t)r * cols);
    size_t from = i;
    if (MOVE == kRoll) {
      const int sc = c - shift;
      from = (size_t)r * cols + (sc < 0 ? sc + cols : sc);
    } else if (MOVE == kRevCols) {
      from = (size_t)r * cols + (cols - 1 - c);
    } else if (MOVE == kRevRows) {
      from = (size_t)(rows - 1 - r) * cols + c;
    }
    dst[i] = src[from];
  }
}

__global__ void empty_kernel() {}

int blocks_for(size_t n) {
  const size_t want = (n + kThreads - 1) / kThreads;
  return (int)(want < (size_t)kMaxBlocks ? want : (size_t)kMaxBlocks);
}

template <int MOVE>
void launch(const int32_t* src, int32_t* dst, int rows, int cols, int shift,
            cudaStream_t stream) {
  const bool vectors =
      MOVE != kRoll && cols % 4 == 0 &&
      ((uintptr_t)src % 16 == 0) && ((uintptr_t)dst % 16 == 0);
  if (vectors) {
    const size_t n = (size_t)rows * (cols / 4);
    rev_probe_vec_kernel<MOVE><<<blocks_for(n), kThreads, 0, stream>>>(
        reinterpret_cast<const int4*>(src), reinterpret_cast<int4*>(dst),
        rows, cols / 4);
  } else {
    const size_t n = (size_t)rows * cols;
    rev_probe_word_kernel<MOVE><<<blocks_for(n), kThreads, 0, stream>>>(
        src, dst, rows, cols, shift);
  }
}

}  // namespace

// dst = move(src) for one int32 block [rows, cols], row-major, src and dst
// distinct device buffers.  move: 0 copy, 1 roll by ``shift`` along the
// columns (dst[r, c] = src[r, (c - shift) mod cols], any integer shift),
// 2 reverse along the columns, 3 reverse along the rows; ``shift`` is read
// by the roll alone.  Returns cudaErrorInvalidValue for an argument it does
// not take, else cudaGetLastError() after launching.
extern "C" int ipp_rev_probe(const int32_t* src, int32_t* dst, int rows,
                             int cols, int move, int shift,
                             cudaStream_t stream) {
  if (!src || !dst || src == dst || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  shift %= cols;
  if (shift < 0) shift += cols;
  switch (move) {
    case kCopy: launch<kCopy>(src, dst, rows, cols, 0, stream); break;
    case kRoll: launch<kRoll>(src, dst, rows, cols, shift, stream); break;
    case kRevCols: launch<kRevCols>(src, dst, rows, cols, 0, stream); break;
    case kRevRows: launch<kRevRows>(src, dst, rows, cols, 0, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Launches ``blocks`` CTAs of kThreads threads that do nothing: the cost of
// a launch alone.  Returns cudaErrorInvalidValue unless 1 <= blocks <=
// kMaxBlocks, else cudaGetLastError() after launching.
extern "C" int ipp_empty_launch(int blocks, cudaStream_t stream) {
  if (blocks < 1 || blocks > kMaxBlocks) return (int)cudaErrorInvalidValue;
  empty_kernel<<<blocks, kThreads, 0, stream>>>();
  return (int)cudaGetLastError();
}
