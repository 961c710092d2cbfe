// The flagship chain's per-item host draws (models/chains.py:_crop_params
// and _flip_and_params) in one pass over the batch, the exact part of the
// shear factors of their angles (ipp_chain_angles), and the pack of a
// call's rows for K1 (ipp_chain_pack).  The draws are the Threefry-2x32
// draws of ``jax.random`` under partitionable counters, bit for bit those
// of random.py, the numpy twin that the tests hold this file to.
//
//   key(seed)        (seed >> 32, seed & 0xFFFFFFFF)       PRNGKey
//   row i of split   the hash of the counter pair (0, i)  split(k, n)[i]
//   bits(k, c)       the two words of hash(k, (0, c)) xor'd  random_bits
//   randint          split(k) into two keys, one word of bits each,
//                    reduced as jax reduces them: span, mult, offset in
//                    uint64, then the int32 wrap
//   uniform          23 bits of mantissa in [1, 2), minus 1, then one
//                    fused multiply-add into [lo, hi) (XLA contracts the
//                    jitted draw into an FMA: random.py:_fma_f32)
//
// Items go through the draws in chunks of kChunk, one hash level at a time
// over the chunk: each level is a loop of independent hashes, which the
// compiler vectorises across items.  Each entry point runs on the calling
// thread.
//
// Every float32 operation is rounded on its own: built with
// -ffp-contract=off, never -ffast-math (ops/native_draws.py).  C++17 and
// the standard library only.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kChunk = 64;

// the draws' bounds as numpy makes them: Python's double, then float32
constexpr float kAngleLo = static_cast<float>(1.0),
                kAngleHi = static_cast<float>(359.0),
                kEnhanceLo = static_cast<float>(0.7),
                kEnhanceHi = static_cast<float>(1.3),
                kGainLo = static_cast<float>(0.75),
                kGainHi = static_cast<float>(1.25);

// geometry.py's float32 constants of the rotation: numpy's float32 of
// Python's double
constexpr float kDeg2Rad = static_cast<float>(3.141592653589793 / 180),
                kTwoPi = static_cast<float>(2 * 3.141592653589793),
                kPi4 = static_cast<float>(3.141592653589793 / 4),
                kPi2 = static_cast<float>(3.141592653589793 / 2);

inline uint32_t rotl(uint32_t x, int d) { return (x << d) | (x >> (32 - d)); }

// Threefry-2x32, 20 rounds, of the counter pair (0, x2) under the key (k1,
// k2) (random.py:threefry2x32); the two output words.
inline void threefry(uint32_t k1, uint32_t k2, uint32_t x2, uint32_t& o1,
                     uint32_t& o2) {
  static constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  uint32_t x0 = ks[0], x1 = x2 + ks[1];
  for (int i = 0; i < 5; ++i) {
    for (int r : kRot[i % 2]) {
      x0 += x1;
      x1 = x0 ^ rotl(x1, r);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  o1 = x0;
  o2 = x1;
}

// the keys of one chunk of items
struct Keys {
  uint32_t a[kChunk], b[kChunk];
};

// out[j] = split(k[j], num)[i] for j < n
inline void split_row(const Keys& k, uint32_t i, int n, Keys& out) {
  for (int j = 0; j < n; ++j) threefry(k.a[j], k.b[j], i, out.a[j], out.b[j]);
}

// out[j] = random_bits(k[j], shape)[c] for j < n
inline void random_bits(const Keys& k, uint32_t c, int n, uint32_t* out) {
  for (int j = 0; j < n; ++j) {
    uint32_t o1, o2;
    threefry(k.a[j], k.b[j], c, o1, o2);
    out[j] = o1 ^ o2;
  }
}

inline int64_t clip_i32(int64_t v) {
  return std::min<int64_t>(std::max<int64_t>(v, INT32_MIN), INT32_MAX);
}

// randint's reduction of its two words of bits into [lo, hi), int32
// (random.py:randint)
inline int32_t reduce(uint64_t higher, uint64_t lower, int64_t lo,
                      int64_t hi) {
  lo = clip_i32(lo);
  hi = clip_i32(hi);
  // 1 when the range is empty, so that lo comes back
  const uint64_t span =
      hi <= lo ? 1 : static_cast<uint64_t>(hi - lo) & 0xFFFFFFFFu;
  const uint64_t r16 = (uint64_t{1} << 16) % span;
  const uint64_t mult = ((r16 * r16) & 0xFFFFFFFFu) % span;
  uint64_t offset = (((higher % span) * mult) & 0xFFFFFFFFu) + lower % span;
  offset = (offset & 0xFFFFFFFFu) % span;
  // the int32 wrap of lo + offset
  return static_cast<int32_t>(
      static_cast<uint32_t>(static_cast<uint64_t>(lo) + offset));
}

// out[j] = randint(k[j], (), lo[j], hi[j]) for j < n
void randint(const Keys& k, const int64_t* lo, const int64_t* hi, int n,
             int32_t* out) {
  Keys s;
  uint32_t higher[kChunk], lower[kChunk];
  split_row(k, 0, n, s);
  random_bits(s, 0, n, higher);
  split_row(k, 1, n, s);
  random_bits(s, 0, n, lower);
  for (int j = 0; j < n; ++j) out[j] = reduce(higher[j], lower[j], lo[j], hi[j]);
}

// out[j * stride] = uniform(k[j], shape, lo, hi)[c] in float32 for j < n
// (random.py:uniform)
void uniform(const Keys& k, uint32_t c, float lo, float hi, int n,
             float* out, int stride) {
  uint32_t bits[kChunk];
  random_bits(k, c, n, bits);
  for (int j = 0; j < n; ++j) {
    const uint32_t mant = (bits[j] >> 9) | 0x3F800000u;
    float f;
    std::memcpy(&f, &mant, sizeof f);
    f -= 1.0f;
    out[j * stride] = std::max(lo, std::fma(f, hi - lo, lo));
  }
}

// PRNGKey of items [i0, i0 + n)
inline void prng_keys(const uint64_t* seeds, int i0, int n, Keys& key) {
  for (int j = 0; j < n; ++j) {
    key.a[j] = static_cast<uint32_t>(seeds[i0 + j] >> 32);
    key.b[j] = static_cast<uint32_t>(seeds[i0 + j]);
  }
}

// float32 to int32 as torch's Tensor.to(torch.int32) gives it on x86:
// toward zero, and INT32_MIN for NaN and values out of range
inline int64_t trunc_i32(float v) {
  if (!(v >= -2147483648.0f && v < 2147483648.0f)) return INT32_MIN;
  return static_cast<int32_t>(v);
}

// One shift vector of ipp_chain_pack: clamp(to_int32(rint(f * (k - c))),
// -lim, lim) for k in [0, S), where to_int32 is trunc_i32's conversion
// (the loop stays in int32 so that it vectorises).
inline void shift_row(float f, float c, int S, int32_t lim, int32_t* out) {
  for (int k = 0; k < S; ++k) {
    const float r = std::nearbyint(f * (static_cast<float>(k) - c));
    const int32_t v = r >= -2147483648.0f && r < 2147483648.0f
                          ? static_cast<int32_t>(r)
                          : INT32_MIN;
    out[k] = std::min(std::max(v, -lim), lim);
  }
}

}  // namespace

extern "C" {

// _crop_params' draws: keys split(PRNGKey(seed), 3); x0 = randint(key 0),
// y0 = randint(key 1) over the bbox-containing placements, angle =
// uniform(key 2, 1, 359).  xywhn [B, 4] normalised centre boxes; the
// corners are ops/bbox.py:xywhn2xyxy's float32 w * (cx - bw / 2) + 0.
void ipp_chain_crop_draws(const uint64_t* seeds, const float* xywhn, int B,
                          int H, int W, int crop, int32_t* y0, int32_t* x0,
                          float* angle) {
  const float wf = static_cast<float>(W), hf = static_cast<float>(H);
  Keys key, k;
  int64_t lo_x[kChunk], hi_x[kChunk], lo_y[kChunk], hi_y[kChunk];
  for (int i0 = 0; i0 < B; i0 += kChunk) {
    const int n = std::min(kChunk, B - i0);
    for (int j = 0; j < n; ++j) {
      const float* box = xywhn + 4 * static_cast<int64_t>(i0 + j);
      const float cx = box[0], cy = box[1], bw = box[2], bh = box[3];
      const int64_t x1 = trunc_i32(wf * (cx - bw / 2.0f) + 0.0f);
      const int64_t y1 = trunc_i32(hf * (cy - bh / 2.0f) + 0.0f);
      const int64_t x2 = trunc_i32(wf * (cx + bw / 2.0f) + 0.0f);
      const int64_t y2 = trunc_i32(hf * (cy + bh / 2.0f) + 0.0f);
      // randint's maxval is the last placement + 1
      lo_x[j] = std::max<int64_t>(0, x2 - crop);
      hi_x[j] = std::max(lo_x[j], std::min<int64_t>(x1, W - crop)) + 1;
      lo_y[j] = std::max<int64_t>(0, y2 - crop);
      hi_y[j] = std::max(lo_y[j], std::min<int64_t>(y1, H - crop)) + 1;
    }
    prng_keys(seeds, i0, n, key);
    split_row(key, 0, n, k);
    randint(k, lo_x, hi_x, n, x0 + i0);
    split_row(key, 1, n, k);
    randint(k, lo_y, hi_y, n, y0 + i0);
    split_row(key, 2, n, k);
    uniform(k, 0, kAngleLo, kAngleHi, n, angle + i0, 1);
  }
}

// _flip_and_params' draws: keys 3 and 4 of split(PRNGKey(seed), 5); flips
// = randint(key 3, 0, 4); (kb, kc, kcol, krgb) = split(key 4, 4); prm
// [B, 8] = uniform(0.7, 1.3) from kb, kc, kcol, uniform(krgb, (3,), 0.75,
// 1.25), 0, 0.
void ipp_chain_flip_draws(const uint64_t* seeds, int B, int32_t* flips,
                          float* prm) {
  int64_t lo[kChunk], hi[kChunk];
  std::fill(lo, lo + kChunk, 0);
  std::fill(hi, hi + kChunk, 4);
  Keys key, k, k4;
  for (int i0 = 0; i0 < B; i0 += kChunk) {
    const int n = std::min(kChunk, B - i0);
    float* p = prm + 8 * static_cast<int64_t>(i0);
    prng_keys(seeds, i0, n, key);
    split_row(key, 3, n, k);
    randint(k, lo, hi, n, flips + i0);
    split_row(key, 4, n, k4);
    for (uint32_t i = 0; i < 3; ++i) {
      split_row(k4, i, n, k);
      uniform(k, 0, kEnhanceLo, kEnhanceHi, n, p + i, 8);
    }
    split_row(k4, 3, n, k);
    for (uint32_t c = 0; c < 3; ++c)
      uniform(k, c, kGainLo, kGainHi, n, p + 3 + c, 8);
    for (int j = 0; j < n; ++j) p[8 * j + 6] = p[8 * j + 7] = 0.0f;
  }
}

// geometry.shear_factors' exact float32 and integer work for B angles in
// degrees, each operation rounded on its own, in torch's order:
//   theta = fmod(angle * deg2rad, 2 pi), plus 2 pi where negative
//   quad  = remainder(to_int32(floor((theta + pi/4) / (pi/2))), 4)
//   phi   = theta - float(quad) * (pi/2)
// writing quad, phi / 2 and phi; the caller takes tan(phi / 2) and
// sin(phi) from torch, as the reference does.  to_int32 is trunc_i32's
// conversion, and & 3 is torch.remainder(., 4) in two's complement.
void ipp_chain_angles(int B, const float* angles, int32_t* quad,
                      float* half_phi, float* phi) {
  for (int i = 0; i < B; ++i) {
    float theta = std::fmod(angles[i] * kDeg2Rad, kTwoPi);
    if (theta < 0.0f) theta = theta + kTwoPi;
    const int32_t q = static_cast<int32_t>(
        trunc_i32(std::floor((theta + kPi4) / kPi2)) & 3);
    const float p = theta - static_cast<float>(q) * kPi2;
    quad[i] = q;
    half_phi[i] = p / 2.0f;
    phi[i] = p;
  }
}

// The rows K1 reads for one chain call (models/chains.py:_packed_call),
// written into one host buffer that goes to the card in one copy; the
// caller places each section (ops/native_draws.py:pack_layout):
//   items [B, 4] int32   y0, x0, d4[quad * 4 + clamp(flip, 0, 3)], 0
//                        (ops/augment.py:item_codes, chain_args)
//   enh   [B, 8] float32 the enhance rows as drawn
//   sh1, sh2 [B, S] int32  geometry.shear_params' vectors from its
//                        per-item factors a = tan(phi / 2) and b = -sin(phi)
//                        (geometry.shear_factors; b comes as sin(phi) and
//                        is negated here, exactly): rint(a * iy),
//                        iy = k - (S - 1) / 2, in float32,
//                        rounded half to even as torch.round rounds,
//                        converted as Tensor.to(torch.int32) converts, then
//                        clipped to +-lim1 and +-lim2 (geometry.shift_limits)
// quad in [0, 4) as torch.remainder(., 4) gives it.  Exact integer and
// IEEE float32 work, so the rows equal the torch glue's bit for bit.
void ipp_chain_pack(int B, int S, const int32_t* y0, const int32_t* x0,
                    const int32_t* flips, const float* prm,
                    const int32_t* quad, const float* a,
                    const float* sin_phi,
                    const int32_t* d4, int lim1, int lim2, int32_t* items,
                    float* enh, int32_t* sh1, int32_t* sh2) {
  for (int i = 0; i < B; ++i) {
    int32_t* row = items + 4 * static_cast<int64_t>(i);
    row[0] = y0[i];
    row[1] = x0[i];
    row[2] = d4[(quad[i] & 3) * 4 + std::min(std::max(flips[i], 0), 3)];
    row[3] = 0;
  }
  std::memcpy(enh, prm, sizeof(float) * 8 * static_cast<size_t>(B));
  const float c = (static_cast<float>(S) - 1.0f) / 2.0f;
  for (int i = 0; i < B; ++i) {
    const int64_t at = static_cast<int64_t>(i) * S;
    shift_row(a[i], c, S, lim1, sh1 + at);
    shift_row(-sin_phi[i], c, S, lim2, sh2 + at);
  }
}

}  // extern "C"
