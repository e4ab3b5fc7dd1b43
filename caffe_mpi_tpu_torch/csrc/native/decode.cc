// Native image decode plane — JPEG/PNG bytes -> BGR planar CHW uint8, and
// the fused decode->transform ingestion entry point.
//
// Role in the framework: the reference decodes encoded Datums with OpenCV
// inside its C++ reader/transformer threads (io.cpp DecodeDatumToCVMat +
// data_transformer.cpp Transform), so its host pipeline never touches an
// interpreter. Our Python path decodes per record with PIL — the last
// Python stage in an otherwise-native pipeline, and the slowest
// (data/datasets.py parse_datum). This file wraps the system
// libjpeg/libpng behind the plain C interface ops/build.py compiles, so the
// Feeder can decode a whole batch in ONE ctypes call with the GIL
// released:
//
//   caffe_tpu_decode_probe            header-only (h, w) of one image
//   caffe_tpu_decode_image            one image -> BGR planar CHW uint8
//   caffe_tpu_decode_resize           decode + bilinear resize (the
//                                     ImageData layer's new_height/width,
//                                     cv::resize INTER_LINEAR convention)
//   caffe_tpu_decode_transform_batch  decode -> crop -> mirror ->
//                                     mean/scale -> f32 for a RANGE of
//                                     records, threaded, with per-record
//                                     status and optional decoded uint8
//                                     side-outputs (the decoded-record
//                                     cache fill)
//
// Parity contract (tests/test_torch_native_decode.py): PNG decode is bitwise
// equal to PIL (lossless format — any correct decoder agrees); JPEG is
// within 1 LSB per pixel (IDCT implementation variance between the system
// libjpeg and PIL's bundled copy). Pixel order matches the Python
// reference path exactly: BGR (OpenCV/reference convention), planar CHW.
// Unsupported variants (CMYK JPEG, alpha/16-bit PNG, other formats)
// return a status instead of guessing, and the Python caller falls back
// to PIL — never a hard failure, never a silent mismatch.
//
// The transform arithmetic is transform_core.h's transform_one — the SAME
// inline code transform.cc runs — so fused output is bitwise-identical to
// decode-then-transform_batch for the same (seed, record_id) keys.
//
// Error containment: libjpeg's default error handler calls exit(); a
// corrupt record must surface as a per-record status code the Python side
// turns into RecordIntegrityError -> quarantine, not a process death. The
// setjmp error manager below guarantees that, and warning output is
// suppressed (a rotten LMDB would otherwise spam stderr per record).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "transform_core.h"

// status codes shared with the Python binding (native/__init__.py)
enum {
  kOk = 0,
  kUnknownFormat = 1,   // not JPEG/PNG magic -> PIL fallback
  kDecodeError = 2,     // corrupt bytes or unsupported variant -> PIL
  kGeometryMismatch = 3,// dims incompatible with crop/expected shape
  kBufferTooSmall = 4,  // caller buffer under 3*h*w
  kUnavailable = 5      // library built without codecs
};

#ifndef CAFFE_TPU_NO_CODEC

#include <csetjmp>
#include <cstddef>
#include <cstdio>

// jpeglib.h uses unqualified size_t/FILE and must see them first (the
// classic IJG header quirk) — keep <cstddef>/<cstdio> above it
#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------------------
// libjpeg plumbing: setjmp error manager + silence, memory source
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jump, 1);
}

void jpeg_silence(j_common_ptr, int) {}
void jpeg_silence_msg(j_common_ptr) {}

// Memory source manager written out by hand: jpeg_mem_src only exists in
// libjpeg >= 8 / turbo builds, and this file must link against any
// system libjpeg ops/build.py finds.
struct JpegMemSrc {
  jpeg_source_mgr pub;
  const uint8_t* data;
  size_t len;
};

void src_init(j_decompress_ptr) {}
boolean src_fill(j_decompress_ptr cinfo) {
  // past the end of the buffer: synthesize an EOI so the decoder
  // terminates; truncated entropy data shows up as an error/garbage the
  // caller's parity/integrity checks catch
  static const JOCTET eoi[2] = {0xFF, JPEG_EOI};
  cinfo->src->next_input_byte = eoi;
  cinfo->src->bytes_in_buffer = 2;
  return TRUE;
}
void src_skip(j_decompress_ptr cinfo, long n) {
  jpeg_source_mgr* src = cinfo->src;
  if (n <= 0) return;
  while ((size_t)n > src->bytes_in_buffer) {
    n -= (long)src->bytes_in_buffer;
    src->fill_input_buffer(cinfo);
  }
  src->next_input_byte += n;
  src->bytes_in_buffer -= n;
}
void src_term(j_decompress_ptr) {}

void set_mem_src(j_decompress_ptr cinfo, JpegMemSrc* src,
                 const uint8_t* data, int64_t len) {
  src->pub.init_source = src_init;
  src->pub.fill_input_buffer = src_fill;
  src->pub.skip_input_data = src_skip;
  src->pub.resync_to_restart = jpeg_resync_to_restart;
  src->pub.term_source = src_term;
  src->pub.next_input_byte = data;
  src->pub.bytes_in_buffer = (size_t)len;
  cinfo->src = &src->pub;
}

inline bool is_jpeg(const uint8_t* d, int64_t n) {
  return n >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF;
}

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};

inline bool is_png(const uint8_t* d, int64_t n) {
  return n >= 8 && std::memcmp(d, kPngSig, 8) == 0;
}

// ---------------------------------------------------------------------------
// decoders: bytes -> planar BGR CHW uint8 (always 3 channels — the Python
// reference path is PIL convert("RGB"), grayscale sources replicate)
// ---------------------------------------------------------------------------

int jpeg_dims(const uint8_t* data, int64_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = jpeg_err_exit;
  err.pub.emit_message = jpeg_silence;
  err.pub.output_message = jpeg_silence_msg;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return kDecodeError;
  }
  jpeg_create_decompress(&cinfo);
  JpegMemSrc src;
  set_mem_src(&cinfo, &src, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return kDecodeError;
  }
  *h = (int)cinfo.image_height;
  *w = (int)cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return kOk;
}

// out: 3*h*w planar BGR; h/w must match the real image (probe first) —
// they are re-derived here and checked so a stale probe cannot overflow.
int jpeg_decode_chw(const uint8_t* data, int64_t len, uint8_t* out,
                    int64_t cap, int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = jpeg_err_exit;
  err.pub.emit_message = jpeg_silence;
  err.pub.output_message = jpeg_silence_msg;
  std::vector<uint8_t> row;  // destroyed after longjmp target returns
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return kDecodeError;
  }
  jpeg_create_decompress(&cinfo);
  JpegMemSrc src;
  set_mem_src(&cinfo, &src, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return kDecodeError;
  }
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    // PIL applies its own CMYK inversion heuristics; don't guess
    jpeg_destroy_decompress(&cinfo);
    return kDecodeError;
  }
  cinfo.out_color_space = JCS_RGB;  // gray sources expand to RGB like PIL
  jpeg_start_decompress(&cinfo);
  const int h = (int)cinfo.output_height;
  const int w = (int)cinfo.output_width;
  if (cinfo.output_components != 3 || (int64_t)3 * h * w > cap) {
    jpeg_destroy_decompress(&cinfo);
    return cinfo.output_components != 3 ? kDecodeError : kBufferTooSmall;
  }
  row.resize((size_t)w * 3);
  uint8_t* rowp = row.data();
  const int64_t plane = (int64_t)h * w;
  while (cinfo.output_scanline < cinfo.output_height) {
    const int y = (int)cinfo.output_scanline;
    JSAMPROW rows[1] = {rowp};
    jpeg_read_scanlines(&cinfo, rows, 1);
    // scatter interleaved RGB scanline into planar BGR
    uint8_t* b = out + (int64_t)y * w;
    uint8_t* g = b + plane;
    uint8_t* r = g + plane;
    for (int x = 0; x < w; ++x) {
      r[x] = rowp[3 * x];
      g[x] = rowp[3 * x + 1];
      b[x] = rowp[3 * x + 2];
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_h = h;
  *out_w = w;
  return kOk;
}

int png_dims(const uint8_t* data, int64_t len, int* h, int* w) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data, (size_t)len)) {
    png_image_free(&image);
    return kDecodeError;
  }
  *h = (int)image.height;
  *w = (int)image.width;
  png_image_free(&image);
  return kOk;
}

int png_decode_chw(const uint8_t* data, int64_t len, uint8_t* out,
                   int64_t cap, int* out_h, int* out_w) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data, (size_t)len)) {
    png_image_free(&image);
    return kDecodeError;
  }
  if ((image.format & PNG_FORMAT_FLAG_ALPHA) ||
      (image.format & PNG_FORMAT_FLAG_LINEAR)) {
    // alpha compositing / 16-bit scaling choices differ between
    // libraries; PIL owns those records (parity over coverage)
    png_image_free(&image);
    return kDecodeError;
  }
  const int h = (int)image.height;
  const int w = (int)image.width;
  if ((int64_t)3 * h * w > cap) {
    png_image_free(&image);
    return kBufferTooSmall;
  }
  image.format = PNG_FORMAT_BGR;  // palette/gray expand, byte order BGR
  std::vector<uint8_t> hwc((size_t)3 * h * w);
  if (!png_image_finish_read(&image, nullptr, hwc.data(), 0, nullptr)) {
    png_image_free(&image);
    return kDecodeError;
  }
  const int64_t plane = (int64_t)h * w;
  const uint8_t* p = hwc.data();
  for (int64_t i = 0; i < plane; ++i) {
    out[i] = p[3 * i];                  // B
    out[plane + i] = p[3 * i + 1];      // G
    out[2 * plane + i] = p[3 * i + 2];  // R
  }
  *out_h = h;
  *out_w = w;
  return kOk;
}

int decode_chw(const uint8_t* data, int64_t len, uint8_t* out, int64_t cap,
               int* h, int* w) {
  if (is_jpeg(data, len)) return jpeg_decode_chw(data, len, out, cap, h, w);
  if (is_png(data, len)) return png_decode_chw(data, len, out, cap, h, w);
  return kUnknownFormat;
}

// ---------------------------------------------------------------------------
// bilinear resize, cv::resize INTER_LINEAR convention (the reference
// resizes with OpenCV: io.cpp ReadImageToCVMat new_height/new_width) —
// half-pixel-centered sampling, clamped edges, round-to-nearest uint8
// ---------------------------------------------------------------------------

void resize_plane_bilinear(const uint8_t* src, int h, int w, uint8_t* dst,
                           int oh, int ow) {
  const float sy = (float)h / (float)oh;
  const float sx = (float)w / (float)ow;
  for (int y = 0; y < oh; ++y) {
    float fy = ((float)y + 0.5f) * sy - 0.5f;
    if (fy < 0.f) fy = 0.f;
    int y0 = (int)fy;
    if (y0 > h - 1) y0 = h - 1;
    const int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    const float wy = fy - (float)y0;
    const uint8_t* r0 = src + (int64_t)y0 * w;
    const uint8_t* r1 = src + (int64_t)y1 * w;
    uint8_t* drow = dst + (int64_t)y * ow;
    for (int x = 0; x < ow; ++x) {
      float fx = ((float)x + 0.5f) * sx - 0.5f;
      if (fx < 0.f) fx = 0.f;
      int x0 = (int)fx;
      if (x0 > w - 1) x0 = w - 1;
      const int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      const float wx = fx - (float)x0;
      const float top = (float)r0[x0] + wx * ((float)r0[x1] - (float)r0[x0]);
      const float bot = (float)r1[x0] + wx * ((float)r1[x1] - (float)r1[x0]);
      const float v = top + wy * (bot - top);
      drow[x] = (uint8_t)(v + 0.5f);
    }
  }
}

}  // namespace

extern "C" {

int caffe_tpu_decode_available() { return 1; }

// Header-only dimensions (always 3 output channels — BGR). Returns a
// status code; h/w valid only on kOk.
int caffe_tpu_decode_probe(const uint8_t* data, int64_t len, int* h,
                           int* w) {
  if (data == nullptr || len < 8 || h == nullptr || w == nullptr)
    return kDecodeError;
  if (is_jpeg(data, len)) return jpeg_dims(data, len, h, w);
  if (is_png(data, len)) return png_dims(data, len, h, w);
  return kUnknownFormat;
}

// One image -> planar BGR CHW uint8 into `out` (capacity `cap` bytes).
// h/w report the decoded dims (probe first to size the buffer).
int caffe_tpu_decode_image(const uint8_t* data, int64_t len, uint8_t* out,
                           int64_t cap, int* h, int* w) {
  if (data == nullptr || out == nullptr || len < 8) return kDecodeError;
  return decode_chw(data, len, out, cap, h, w);
}

// Decode + bilinear resize to (out_h, out_w), planar BGR CHW into `out`
// (capacity >= 3*out_h*out_w).
int caffe_tpu_decode_resize(const uint8_t* data, int64_t len, int out_h,
                            int out_w, uint8_t* out, int64_t cap) {
  if (data == nullptr || out == nullptr || len < 8 || out_h <= 0 ||
      out_w <= 0)
    return kDecodeError;
  if ((int64_t)3 * out_h * out_w > cap) return kBufferTooSmall;
  int h = 0, w = 0;
  int rc = caffe_tpu_decode_probe(data, len, &h, &w);
  if (rc != kOk) return rc;
  std::vector<uint8_t> chw((size_t)3 * h * w);
  rc = decode_chw(data, len, chw.data(), (int64_t)chw.size(), &h, &w);
  if (rc != kOk) return rc;
  if (h == out_h && w == out_w) {
    std::memcpy(out, chw.data(), chw.size());
    return kOk;
  }
  for (int c = 0; c < 3; ++c)
    resize_plane_bilinear(chw.data() + (int64_t)c * h * w, h, w,
                          out + (int64_t)c * out_h * out_w, out_h, out_w);
  return kOk;
}

// Fused ingestion: decode -> crop -> mirror -> mean/scale -> f32 for n
// records in one call (the Feeder's one-ctypes-call batch path).
//
//   srcs/lens      n encoded byte buffers
//   record_ids     augmentation keys (seed ^ id splitmix64 streams —
//                  IDENTICAL to caffe_tpu_transform_batch's)
//   crop..seed     transform_core.h semantics; mean_mode 2 (full-image
//                  mean) is rejected: decoded dims vary per record
//   out_h/out_w    post-transform dims when `out` is set (crop, crop
//                  when crop > 0); REQUIRED decoded dims when `out` is
//                  null (decode-only mode, the device-transform staging
//                  fill — rows of a uniform uint8 batch)
//   out            n * 3 * out_h * out_w f32, or null for decode-only
//   decoded_out    optional n pointers (each may be null): planar CHW
//                  uint8 side-output of the decode, capacity
//                  decoded_caps[i] — the decoded-record cache fill
//   status         n per-record status codes (kOk/kUnknownFormat/...);
//                  failed records leave their out rows untouched and the
//                  caller re-reads them through the Python fallback +
//                  quarantine path
//
// Returns 0 when the call ran (inspect status per record), nonzero only
// for argument errors.
int caffe_tpu_decode_transform_batch(
    const uint8_t* const* srcs, const int64_t* lens,
    const int64_t* record_ids, int n, int crop, const float* mean,
    int mean_mode, float scale, int train, int mirror, uint64_t seed,
    int out_h, int out_w, float* out, uint8_t* const* decoded_out,
    const int64_t* decoded_caps, int32_t* status, int num_threads) {
  if (srcs == nullptr || lens == nullptr || record_ids == nullptr ||
      status == nullptr || n <= 0 || out_h <= 0 || out_w <= 0)
    return 1;
  if (mean_mode != 0 && mean == nullptr) return 1;
  if (mean_mode == 2) return 3;  // full-image mean: dims vary per record
  if (out != nullptr && crop > 0 && (out_h != crop || out_w != crop))
    return 1;
  if (decoded_out != nullptr && decoded_caps == nullptr) return 1;

  auto decode_range = [&](int begin, int end) {
    std::vector<uint8_t> scratch;
    for (int i = begin; i < end; ++i) {
      int h = 0, w = 0;
      int rc = caffe_tpu_decode_probe(srcs[i], lens[i], &h, &w);
      if (rc != kOk) {
        status[i] = rc;
        continue;
      }
      if (out != nullptr) {
        if (crop > 0 ? (h < crop || w < crop) : (h != out_h || w != out_w)) {
          status[i] = kGeometryMismatch;
          continue;
        }
      } else if (h != out_h || w != out_w) {
        status[i] = kGeometryMismatch;
        continue;
      }
      uint8_t* dst;
      if (decoded_out != nullptr && decoded_out[i] != nullptr) {
        if ((int64_t)3 * h * w > decoded_caps[i]) {
          status[i] = kBufferTooSmall;
          continue;
        }
        dst = decoded_out[i];  // decode straight into the cache buffer
      } else {
        scratch.resize((size_t)3 * h * w);
        dst = scratch.data();
      }
      rc = decode_chw(srcs[i], lens[i], dst, (int64_t)3 * h * w, &h, &w);
      if (rc != kOk) {
        status[i] = rc;
        continue;
      }
      if (out != nullptr)
        caffe_tpu::transform_one(dst, 3, h, w, crop, mean, mean_mode, scale,
                                 train, mirror, seed, record_ids[i],
                                 out + (int64_t)i * 3 * out_h * out_w);
      status[i] = kOk;
    }
  };

  if (num_threads <= 1 || n == 1) {
    decode_range(0, n);
    return 0;
  }
  int nt = num_threads < n ? num_threads : n;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  int chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int begin = t * chunk;
    int end = begin + chunk < n ? begin + chunk : n;
    if (begin >= end) break;
    threads.emplace_back([&decode_range, begin, end] {
      decode_range(begin, end);
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"

#else  // CAFFE_TPU_NO_CODEC — dev headers absent at build time: every
       // entry point degrades to "unavailable" and Python stays on PIL
       // (ops/build.py probes the headers and sets the define)

extern "C" {

int caffe_tpu_decode_available() { return 0; }

int caffe_tpu_decode_probe(const uint8_t*, int64_t, int*, int*) {
  return kUnavailable;
}

int caffe_tpu_decode_image(const uint8_t*, int64_t, uint8_t*, int64_t,
                           int*, int*) {
  return kUnavailable;
}

int caffe_tpu_decode_resize(const uint8_t*, int64_t, int, int, uint8_t*,
                            int64_t) {
  return kUnavailable;
}

int caffe_tpu_decode_transform_batch(const uint8_t* const*, const int64_t*,
                                     const int64_t*, int, int, const float*,
                                     int, float, int, int, uint64_t, int,
                                     int, float*, uint8_t* const*,
                                     const int64_t*, int32_t*, int) {
  return kUnavailable;
}

}  // extern "C"

#endif  // CAFFE_TPU_NO_CODEC

// ---------------------------------------------------------------------------
// Serving request preprocess — OUTSIDE the codec gate: it
// operates on already-decoded arrays (native- or PIL-decoded alike), so
// a transform-only build still fuses the serving window's preprocessing.
// ---------------------------------------------------------------------------

extern "C" {

// Window-fused serving preprocess: n pre-decoded planar-CHW uint8 images
// (per-record dims in `dims` as (h, w) pairs; channel storage order is
// the caller's — `swap` composes it with the Transformer channel_swap)
// -> n f32 rows of (channels, crop_h, crop_w), each the BITWISE result
// of the Python per-request chain (transform_core.h serve_preprocess_one:
// u8/255 -> PIL-convention resize to (img_h, img_w) -> center crop ->
// * raw_scale - mean[ch] * input_scale). Threaded across records, GIL
// released for the whole window. `status` is per-record (0 ok, nonzero
// geometry/argument trouble — the caller re-runs those records through
// the Python fallback). Returns nonzero only for argument errors.
int caffe_tpu_serve_preprocess_batch(
    const uint8_t* const* srcs, const int32_t* dims, int n, int channels,
    int img_h, int img_w, int crop_h, int crop_w, const int32_t* swap,
    int has_raw, float raw_scale, const float* mean, int has_iscale,
    float input_scale, float* out, int32_t* status, int num_threads) {
  if (srcs == nullptr || dims == nullptr || swap == nullptr ||
      out == nullptr || status == nullptr || n <= 0 || channels <= 0 ||
      img_h <= 0 || img_w <= 0 || crop_h <= 0 || crop_w <= 0)
    return 1;
  const int64_t row = (int64_t)channels * crop_h * crop_w;
  auto preprocess_range = [&](int begin, int end) {
    for (int i = begin; i < end; ++i) {
      status[i] = (int32_t)caffe_tpu::serve_preprocess_one(
          srcs[i], channels, (int)dims[2 * i], (int)dims[2 * i + 1], img_h,
          img_w, crop_h, crop_w, swap, has_raw, raw_scale, mean, has_iscale,
          input_scale, out + i * row);
    }
  };
  if (num_threads <= 1 || n == 1) {
    preprocess_range(0, n);
    return 0;
  }
  int nt = num_threads < n ? num_threads : n;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  int chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int begin = t * chunk;
    int end = begin + chunk < n ? begin + chunk : n;
    if (begin >= end) break;
    threads.emplace_back([&preprocess_range, begin, end] {
      preprocess_range(begin, end);
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
