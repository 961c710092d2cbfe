// Native IO engine: threaded JPEG/PNG decode + encode + YOLO label parse.
//
// Replaces the role the reference delegates to OpenCV/Pillow C cores
// (reference crop_square.py:34 cv2.imread, utils/utils.py:95 cv2.imwrite):
// the host-side feeder of the device pipeline.  Exposed through a plain C
// ABI consumed via ctypes (io/native.py), which builds it at first use.
//
// Decoding writes directly into caller-provided zero-padded canvas buffers
// (the batch layout the device program consumes), so batch assembly is a
// single pass with no intermediate numpy copies.
//
// The JPEG coefficient reader and writer of the coefficient transports are
// not here: ipp_jcoef.cpp holds them, with no codec library.

#include <cstdint>
#include <cstdio>

#if defined(__linux__)
#include <fcntl.h>   // posix_fadvise readahead hints
#endif
#include <cstring>
#include <csetjmp>
#include <atomic>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <libdeflate.h>
#include <png.h>
#include <zlib.h>

namespace {

// Hint the kernel to read the whole file ahead sequentially — on cold
// caches this overlaps disk latency with decode across the thread pool
// (fadvise is the portable part of an io_uring readahead, with none of
// its plumbing).
void advise_sequential(FILE* f) {
#if defined(__linux__)
  const int fd = fileno(f);
  if (fd >= 0) {
    posix_fadvise(fd, 0, 0, POSIX_FADV_SEQUENTIAL);
    posix_fadvise(fd, 0, 0, POSIX_FADV_WILLNEED);
  }
#else
  (void)f;
#endif
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// decode a JPEG file into buf (canvas cap_h x cap_w x channels, zero padded)
int decode_jpeg(FILE* f, uint8_t* buf, int cap_h, int cap_w, int channels,
                int* out_h, int* out_w, int* out_c) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  const int w = static_cast<int>(cinfo.output_width);
  const int h = static_cast<int>(cinfo.output_height);
  if (h > cap_h || w > cap_w) {
    jpeg_destroy_decompress(&cinfo);
    return -3;  // canvas too small
  }
  std::vector<uint8_t> row(static_cast<size_t>(w) * 3);
  uint8_t* rowp = row.data();
  while (cinfo.output_scanline < cinfo.output_height) {
    const int y = static_cast<int>(cinfo.output_scanline);
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    uint8_t* dst = buf + (static_cast<size_t>(y) * cap_w) * channels;
    if (channels == 3) {
      memcpy(dst, rowp, static_cast<size_t>(w) * 3);
    } else {
      for (int x = 0; x < w; ++x) {
        dst[x * channels + 0] = rowp[x * 3 + 0];
        dst[x * channels + 1] = rowp[x * 3 + 1];
        dst[x * channels + 2] = rowp[x * 3 + 2];
        if (channels == 4) dst[x * channels + 3] = 255;
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_h = h;
  *out_w = w;
  *out_c = 3;
  return 0;
}

int decode_png(FILE* f, uint8_t* buf, int cap_h, int cap_w, int channels,
               int* out_h, int* out_w, int* out_c) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -2;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -2;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -2;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  const int w = static_cast<int>(png_get_image_width(png, info));
  const int h = static_cast<int>(png_get_image_height(png, info));
  if (h > cap_h || w > cap_w) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  // normalize to 8-bit RGB or RGBA
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  const int nch = static_cast<int>(png_get_channels(png, info));

  std::vector<uint8_t> row(static_cast<size_t>(w) * nch);
  uint8_t* rowp = row.data();
  for (int y = 0; y < h; ++y) {
    png_read_row(png, rowp, nullptr);
    uint8_t* dst = buf + (static_cast<size_t>(y) * cap_w) * channels;
    for (int x = 0; x < w; ++x) {
      const uint8_t r = rowp[x * nch + 0];
      const uint8_t g = rowp[x * nch + 1];
      const uint8_t b = rowp[x * nch + 2];
      const uint8_t a = (nch == 4) ? rowp[x * nch + 3] : 255;
      dst[x * channels + 0] = r;
      if (channels >= 3) {
        dst[x * channels + 1] = g;
        dst[x * channels + 2] = b;
      }
      if (channels == 4) dst[x * channels + 3] = a;
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  *out_h = h;
  *out_w = w;
  *out_c = nch;
  return 0;
}

// header-only dims probe (no pixel decode)
int probe_jpeg(FILE* f, int* out_h, int* out_w, int* out_c) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *out_h = static_cast<int>(cinfo.image_height);
  *out_w = static_cast<int>(cinfo.image_width);
  *out_c = static_cast<int>(cinfo.num_components);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int probe_png(FILE* f, int* out_h, int* out_w, int* out_c) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -2;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -2;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -2;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  *out_h = static_cast<int>(png_get_image_height(png, info));
  *out_w = static_cast<int>(png_get_image_width(png, info));
  // channel count AFTER the normalizations decode_png applies (RGB/RGBA):
  // report 4 when an alpha channel or tRNS transparency will materialize.
  const png_byte color = png_get_color_type(png, info);
  const bool has_alpha = (color & PNG_COLOR_MASK_ALPHA) ||
                         png_get_valid(png, info, PNG_INFO_tRNS);
  *out_c = has_alpha ? 4 : 3;
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

}  // namespace

extern "C" {

// Probe image dimensions without decoding pixels.  out_c is the channel
// count the decoder will produce (3 or 4).  Returns 0 ok, -1 open/magic
// failure, -2 codec failure.
int ipp_probe(const char* path, int* out_h, int* out_w, int* out_c) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char magic[8] = {0};
  const size_t got = fread(magic, 1, 8, f);
  rewind(f);
  int rc = -1;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    rc = probe_jpeg(f, out_h, out_w, out_c);
    if (rc == 0) *out_c = 3;  // decode_jpeg always emits RGB
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    rc = probe_png(f, out_h, out_w, out_c);
  }
  fclose(f);
  return rc;
}

// Band-safe probe for transforms that keep NATIVE bands (PIL mode=None
// semantics): reports dims plus out_kind = 3 (decodes as RGB identically
// under PIL and the native engine: 3-component JPEG, or color-type-2 PNG
// without tRNS), 4 (RGBA: color-type-6 PNG), or 0 (anything else —
// grayscale, palette, 16-bit, tRNS — caller must use its per-item PIL
// path).  Returns 0 ok, -1 open/magic failure, -2 codec failure.
int ipp_probe_bands(const char* path, int* out_h, int* out_w,
                    int* out_kind) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char magic[8] = {0};
  const size_t got = fread(magic, 1, 8, f);
  rewind(f);
  int rc = -1;
  *out_kind = 0;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    int c = 0;
    rc = probe_jpeg(f, out_h, out_w, &c);
    if (rc == 0 && c == 3) *out_kind = 3;
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    png_infop info = png ? png_create_info_struct(png) : nullptr;
    if (!png || !info) {
      if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
      fclose(f);
      return -2;
    }
    if (setjmp(png_jmpbuf(png))) {
      png_destroy_read_struct(&png, &info, nullptr);
      fclose(f);
      return -2;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    *out_h = static_cast<int>(png_get_image_height(png, info));
    *out_w = static_cast<int>(png_get_image_width(png, info));
    const png_byte color = png_get_color_type(png, info);
    const png_byte depth = png_get_bit_depth(png, info);
    const bool trns = png_get_valid(png, info, PNG_INFO_tRNS) != 0;
    if (depth == 8 && color == PNG_COLOR_TYPE_RGB && !trns) *out_kind = 3;
    if (depth == 8 && color == PNG_COLOR_TYPE_RGBA) *out_kind = 4;
    png_destroy_read_struct(&png, &info, nullptr);
    rc = 0;
  }
  fclose(f);
  return rc;
}

// Decode one JPEG/PNG (sniffed by magic bytes) into a zero-padded canvas.
// Returns 0 ok, -1 open/magic failure, -2 codec failure, -3 canvas too
// small, -4 unsupported channel count.
int ipp_decode(const char* path, uint8_t* buf, int cap_h, int cap_w,
               int channels, int* out_h, int* out_w, int* out_c) {
  // This is an exported C ABI: reject channel counts the pixel loops can't
  // fill — the JPEG loop writes 3 bytes per pixel unconditionally, so
  // channels < 3 would overflow each row buffer.
  if (channels != 3 && channels != 4) return -4;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  advise_sequential(f);
  unsigned char magic[8] = {0};
  const size_t got = fread(magic, 1, 8, f);
  rewind(f);
  int rc = -1;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    rc = decode_jpeg(f, buf, cap_h, cap_w, channels, out_h, out_w, out_c);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    rc = decode_png(f, buf, cap_h, cap_w, channels, out_h, out_w, out_c);
  }
  fclose(f);
  return rc;
}

// Parallel batch decode: n images into one [n, cap_h, cap_w, channels]
// buffer, out_dims[i*3..] = (h, w, native_channels) or (-1,..) on error.
void ipp_decode_batch(const char** paths, int n, uint8_t* bufs, int cap_h,
                      int cap_w, int channels, int* out_dims, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  const size_t stride =
      static_cast<size_t>(cap_h) * cap_w * channels;
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      int h = -1, w = -1, c = -1;
      const int rc = ipp_decode(paths[i], bufs + stride * i, cap_h, cap_w,
                                channels, &h, &w, &c);
      out_dims[i * 3 + 0] = (rc == 0) ? h : rc;
      out_dims[i * 3 + 1] = w;
      out_dims[i * 3 + 2] = c;
    }
  };
  std::vector<std::thread> pool;
  const int nt = n_threads < n ? n_threads : n;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Encode RGB rows as JPEG.  `stride` is the SIGNED row pitch in BYTES
// (|stride| >= w*3) — canvas crops AND vertically-flipped views (negative
// pitch) encode zero-copy without an ascontiguousarray pass.  `flip_x`
// reverses each row's pixels while feeding the codec (the horizontally-
// flipped view never materializes); the caller normalizes the pointer so
// row k starts at rgb + k*stride with pixels in MEMORY order.
int ipp_encode_jpeg(const char* path, const uint8_t* rgb, int h, int w,
                    int stride, int quality, int flip_x) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  // thread_local: longjmp from the error handler must not leak a live
  // std::vector frame
  static thread_local std::vector<uint8_t> rev;
  if (flip_x) rev.resize((size_t)w * 3);
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    fclose(f);
    return -2;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    const uint8_t* src =
        rgb + static_cast<ptrdiff_t>(cinfo.next_scanline) * stride;
    JSAMPROW row;
    if (flip_x) {
      for (int x = 0; x < w; ++x)
        memcpy(rev.data() + 3 * (size_t)x, src + 3 * (size_t)(w - 1 - x), 3);
      row = rev.data();
    } else {
      row = const_cast<uint8_t*>(src);
    }
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(f);
  return 0;
}

// Encode 1/3/4-channel rows as PNG (cv2 byte-parity mode).  `stride` is
// the SIGNED row pitch in bytes (|stride| >= w*channels); `flip_x`
// reverses each row's pixels while feeding libpng (see ipp_encode_jpeg).
int ipp_encode_png(const char* path, const uint8_t* data, int h, int w,
                   int stride, int channels, int flip_x) {
  static thread_local std::vector<uint8_t> rev;  // longjmp-safe scratch
  if (flip_x) rev.resize((size_t)w * channels);
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_write_struct(&png, info ? &info : nullptr);
    fclose(f);
    return -2;
  }
  png_init_io(png, f);
  // cv2.imwrite's PNG defaults (modules/imgcodecs/src/grfmt_png.cpp, the
  // reference's encoder): compression level Z_BEST_SPEED (1), strategy
  // IMWRITE_PNG_STRATEGY_RLE (Z_RLE), filter SUB.  libpng's own defaults
  // (level 6, adaptive 5-filter trials) are both slower and different;
  // matching cv2 exactly makes encode ~25% faster and byte-compatible.
  png_set_compression_level(png, 1);
  png_set_compression_strategy(png, 3 /* Z_RLE */);
  png_set_filter(png, PNG_FILTER_TYPE_BASE, PNG_FILTER_SUB);
  const int type = channels == 4   ? PNG_COLOR_TYPE_RGBA
                   : channels == 3 ? PNG_COLOR_TYPE_RGB
                                   : PNG_COLOR_TYPE_GRAY;
  png_set_IHDR(png, info, w, h, 8, type, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = data + static_cast<ptrdiff_t>(y) * stride;
    if (flip_x) {
      for (int x = 0; x < w; ++x)
        memcpy(rev.data() + (size_t)x * channels,
               src + (size_t)(w - 1 - x) * channels, channels);
      png_write_row(png, rev.data());
    } else {
      png_write_row(png, const_cast<uint8_t*>(src));
    }
  }
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  fclose(f);
  return 0;
}

// SUB-filter rows [y0, y1) of a (possibly negative-stride / x-flipped)
// pixel buffer into the PNG raw stream layout (1 filter byte + filtered
// row).  Row-local (the SUB reference is the previous pixel of the SAME
// row), so disjoint row bands can be filtered concurrently.
static void sub_filter_rows(const uint8_t* data, int w, int stride,
                            int channels, int flip_x, int y0, int y1,
                            uint8_t* raw) {
  const size_t rowb = (size_t)w * channels;
  for (int y = y0; y < y1; ++y) {
    const uint8_t* src = data + (ptrdiff_t)y * stride;
    uint8_t* dst = raw + (size_t)y * (rowb + 1);
    *dst++ = 1;  // SUB filter
    if (flip_x) {
      // reversed-pixel row assembly fused into the filter pass: output
      // pixel x = memory pixel (w-1-x); SUB reference = output pixel x-1
      for (int px = 0; px < w; ++px)
        for (int ch = 0; ch < channels; ++ch) {
          const uint8_t v = src[(size_t)(w - 1 - px) * channels + ch];
          const uint8_t prev =
              px ? src[(size_t)(w - px) * channels + ch] : 0;
          dst[(size_t)px * channels + ch] = (uint8_t)(v - prev);
        }
    } else {
      for (size_t x = 0; x < rowb; ++x)
        dst[x] = (uint8_t)(src[x] - (x >= (size_t)channels
                                         ? src[x - channels] : 0));
    }
  }
}

// Write the PNG container by hand (signature / IHDR / one IDAT / IEND,
// CRCs via libdeflate_crc32) around an already-compressed zlib stream.
static int write_png_container(const char* path, int h, int w, int channels,
                               const uint8_t* idat, size_t idat_len) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  auto be32 = [](uint8_t* p, uint32_t v) {
    p[0] = (uint8_t)(v >> 24);
    p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);
    p[3] = (uint8_t)v;
  };
  auto chunk = [&](const char type[4], const uint8_t* payload,
                   size_t n) -> bool {
    uint8_t head[8];
    be32(head, (uint32_t)n);
    memcpy(head + 4, type, 4);
    uint32_t crc = libdeflate_crc32(0, head + 4, 4);
    if (n) crc = libdeflate_crc32(crc, payload, n);
    uint8_t tail[4];
    be32(tail, crc);
    return fwrite(head, 1, 8, f) == 8 &&
           (n == 0 || fwrite(payload, 1, n, f) == n) &&
           fwrite(tail, 1, 4, f) == 4;
  };
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                 '\n'};
  uint8_t ihdr[13];
  be32(ihdr, (uint32_t)w);
  be32(ihdr + 4, (uint32_t)h);
  ihdr[8] = 8;  // bit depth
  ihdr[9] = channels == 4 ? 6 : channels == 3 ? 2 : 0;  // color type
  ihdr[10] = ihdr[11] = ihdr[12] = 0;  // deflate / adaptive / no interlace
  const bool ok = fwrite(sig, 1, 8, f) == 8 && chunk("IHDR", ihdr, 13) &&
                  chunk("IDAT", idat, idat_len) &&
                  chunk("IEND", nullptr, 0);
  fclose(f);
  return ok ? 0 : -1;
}

// Fast PNG encode: SUB-filter rows, compress the whole stream with
// libdeflate (2-4x faster than zlib's deflate at better ratios), write the
// container by hand.  Output is a standards-valid PNG that decodes to the
// SAME pixels as ipp_encode_png — only the compressed byte stream differs
// from cv2's zlib output, so this is the default engine encoder while
// ipp_encode_png remains the cv2 byte-parity mode.
int ipp_encode_png_fast(const char* path, const uint8_t* data, int h, int w,
                        int stride, int channels, int level, int flip_x) {
  const size_t rowb = (size_t)w * channels;
  const size_t raw_len = (size_t)h * (rowb + 1);
  std::vector<uint8_t> raw(raw_len);
  sub_filter_rows(data, w, stride, channels, flip_x, 0, h, raw.data());
  libdeflate_compressor* comp = libdeflate_alloc_compressor(level);
  if (!comp) return -2;
  std::vector<uint8_t> zbuf(libdeflate_zlib_compress_bound(comp, raw_len));
  const size_t zlen = libdeflate_zlib_compress(comp, raw.data(), raw_len,
                                               zbuf.data(), zbuf.size());
  libdeflate_free_compressor(comp);
  if (zlen == 0) return -2;
  return write_png_container(path, h, w, channels, zbuf.data(), zlen);
}

// The largest piece of a buffer handed to zlib in one call: its byte
// counts (avail_in, avail_out, adler32's length) are 32-bit uInt, so a
// tiled-PNG band of 4 GiB or more is fed in pieces rather than truncated.
// ipp_set_zlib_piece lowers the limit so the piecewise path can be
// exercised on small images (to no less than 64 bytes: a flush needs more
// than six bytes of output room per call); 0 restores the default.
static size_t g_zlib_piece = (size_t)1 << 30;

size_t ipp_zlib_piece(size_t remaining) {
  return remaining < g_zlib_piece ? remaining : g_zlib_piece;
}

void ipp_set_zlib_piece(size_t limit) {
  g_zlib_piece = limit ? (limit < 64 ? 64 : limit) : (size_t)1 << 30;
}

// Tiled parallel PNG encode (the pigz construction): rows split into
// `threads` contiguous bands; each band is SUB-filtered and raw-deflated
// (zlib, windowBits=-15) in its own thread.  Non-final bands end on a
// Z_FULL_FLUSH byte boundary (no BFINAL bit, empty stored block aligns
// the stream), so the plain concatenation of the band outputs is ONE
// valid deflate stream — the last band carries BFINAL via Z_FINISH.  The
// zlib wrapper is reassembled by hand: the 2-byte 0x78 0x01 header plus
// adler32_combine() of the per-band checksums.  Decodes to the SAME
// pixels as ipp_encode_png_fast; the byte stream differs (fresh per-band
// dictionaries cost <1% ratio on photographic content).  Worth it only
// when threads x zlib-rate > 1 x libdeflate-rate (~3x per byte), i.e.
// >= 4 cores — io/native.py gates the auto mode on that.
int ipp_encode_png_tiled(const char* path, const uint8_t* data, int h,
                         int w, int stride, int channels, int level,
                         int flip_x, int threads) {
  const size_t rowb = (size_t)w * channels;
  if (threads > h) threads = h;
  if (threads < 1) threads = 1;
  if (threads == 1)
    return ipp_encode_png_fast(path, data, h, w, stride, channels, level,
                               flip_x);
  std::vector<uint8_t> raw((size_t)h * (rowb + 1));
  std::vector<std::vector<uint8_t>> zparts(threads);
  std::vector<size_t> zlens(threads, 0);
  std::vector<uint32_t> adlers(threads, 1);  // adler32 of the empty string
  std::vector<size_t> blens(threads, 0);
  std::atomic<int> failed{0};
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) {
    const int y0 = (int)((int64_t)h * t / threads);
    const int y1 = (int)((int64_t)h * (t + 1) / threads);
    pool.emplace_back([&, t, y0, y1]() {
      sub_filter_rows(data, w, stride, channels, flip_x, y0, y1,
                      raw.data());
      const uint8_t* band = raw.data() + (size_t)y0 * (rowb + 1);
      const size_t blen = (size_t)(y1 - y0) * (rowb + 1);
      blens[t] = blen;
      // zlib counts bytes in 32-bit uInt: a band is fed in pieces of at
      // most ipp_zlib_piece() bytes, never cast whole
      uint32_t adler = 1;
      for (size_t off = 0; off < blen;) {
        const size_t n = ipp_zlib_piece(blen - off);
        adler = (uint32_t)adler32(adler, band + off, (uInt)n);
        off += n;
      }
      adlers[t] = adler;
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      // windowBits=-15: raw deflate, no zlib wrapper (hand-assembled)
      if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                       Z_DEFAULT_STRATEGY) != Z_OK) {
        failed.store(1);
        return;
      }
      zparts[t].resize(deflateBound(&zs, (uLong)blen) + 16);
      const int flush = (t == threads - 1) ? Z_FINISH : Z_FULL_FLUSH;
      size_t in_off = 0, out_off = 0;
      int rc = Z_OK;
      // the buffer bounds the whole band, so the pieces must complete it
      bool done = false;
      while (!done) {
        const size_t in_n = ipp_zlib_piece(blen - in_off);
        const bool last = in_off + in_n == blen;
        zs.next_in = const_cast<Bytef*>(band + in_off);
        zs.avail_in = (uInt)in_n;
        do {
          const size_t room = ipp_zlib_piece(zparts[t].size() - out_off);
          zs.next_out = zparts[t].data() + out_off;
          zs.avail_out = (uInt)room;
          rc = deflate(&zs, last ? flush : Z_NO_FLUSH);
          // no progress possible (a flush that already ended exactly at
          // a piece boundary): not an error
          if (rc == Z_BUF_ERROR) rc = Z_OK;
          out_off += room - zs.avail_out;
          if (rc == Z_STREAM_ERROR || room == 0) break;
        } while (zs.avail_in != 0 || (last && zs.avail_out == 0 &&
                                      rc != Z_STREAM_END));
        in_off += in_n - zs.avail_in;
        if (rc == Z_STREAM_ERROR || zs.avail_in != 0) break;
        done = last;
      }
      if (!done || (flush == Z_FINISH && rc != Z_STREAM_END) ||
          (flush == Z_FULL_FLUSH && rc != Z_OK))
        failed.store(1);
      zlens[t] = zs.total_out;
      deflateEnd(&zs);
    });
  }
  for (auto& th : pool) th.join();
  if (failed.load()) return -2;
  size_t zlen = 2 + 4;  // zlib header + adler trailer
  for (int t = 0; t < threads; ++t) zlen += zlens[t];
  std::vector<uint8_t> zbuf(zlen);
  zbuf[0] = 0x78;  // CMF: deflate, 32K window
  zbuf[1] = 0x01;  // FLG: FLEVEL=fastest, FCHECK makes 0x7801 % 31 == 0
  size_t off = 2;
  uint32_t adler = 1;
  for (int t = 0; t < threads; ++t) {
    memcpy(zbuf.data() + off, zparts[t].data(), zlens[t]);
    off += zlens[t];
    adler = (uint32_t)adler32_combine(adler, adlers[t], (z_off_t)blens[t]);
  }
  zbuf[off] = (uint8_t)(adler >> 24);
  zbuf[off + 1] = (uint8_t)(adler >> 16);
  zbuf[off + 2] = (uint8_t)(adler >> 8);
  zbuf[off + 3] = (uint8_t)adler;
  return write_png_container(path, h, w, channels, zbuf.data(), zlen);
}

// Parse a YOLO label file: lines of "cls cx cy w h".  Writes up to max_boxes
// rows into cls[max] and xywhn[max*4]; returns the box count or -1.
int ipp_parse_yolo(const char* path, int* cls, float* xywhn, int max_boxes) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  int n = 0;
  while (n < max_boxes) {
    int c;
    float a, b, w, h;
    const int got = fscanf(f, "%d %f %f %f %f", &c, &a, &b, &w, &h);
    if (got != 5) break;
    cls[n] = c;
    xywhn[n * 4 + 0] = a;
    xywhn[n * 4 + 1] = b;
    xywhn[n * 4 + 2] = w;
    xywhn[n * 4 + 3] = h;
    ++n;
  }
  fclose(f);
  return n;
}

}  // extern "C"
