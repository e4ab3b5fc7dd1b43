// Shared per-image transform core — the one arithmetic both entry points
// run (reference data_transformer.cpp Transform()).
//
// transform.cc (uint8 batch -> f32 batch) and decode.cc (encoded bytes ->
// decode -> f32 batch, the fused ingestion path) must produce
// BITWISE-identical output for the same decoded pixels and the same
// (seed, record_id) augmentation keys. Keeping the crop/mirror/mean/scale
// inner loop in ONE inline function is what holds that contract — a copy
// in each .cc would drift.
//
// Augmentation randomness is counter-based splitmix64 keyed on
// seed ^ record_id, deterministic per record regardless of thread
// scheduling (the native analogue of the Python path's per-record Philox
// streams; values differ between paths, determinism within a path is the
// contract, as with the reference's per-thread RNGs).

#ifndef CAFFE_TPU_NATIVE_TRANSFORM_CORE_H_
#define CAFFE_TPU_NATIVE_TRANSFORM_CORE_H_

#include <cmath>
#include <cstdint>
#include <vector>

namespace caffe_tpu {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

// Transform ONE planar-CHW uint8 image into planar-CHW float32.
// Semantics mirror data_transformer.cpp Transform(): TEST phase (train=0)
// -> center crop, no mirror; TRAIN -> uniform random crop offset + 50%
// mirror; out = (pixel - mean) * scale; mean_mode 0 none, 1 per-channel
// (c floats), 2 full image (c*h*w floats, subtracted at the same crop
// window). dst must hold c * oh * ow floats where oh = ow = crop when
// crop > 0, else oh = h, ow = w.
inline void transform_one(const uint8_t* src, int c, int h, int w, int crop,
                          const float* mean, int mean_mode, float scale,
                          int train, int mirror, uint64_t seed,
                          int64_t record_id, float* dst) {
  const int oh = crop ? crop : h;
  const int ow = crop ? crop : w;
  const int64_t in_plane = (int64_t)h * w;
  const int64_t out_plane = (int64_t)oh * ow;
  int off_h = 0, off_w = 0, do_mirror = 0;
  if (crop) {
    if (train) {
      uint64_t r = splitmix64(seed ^ (uint64_t)record_id);
      off_h = (int)(r % (uint64_t)(h - crop + 1));
      r = splitmix64(r);
      off_w = (int)(r % (uint64_t)(w - crop + 1));
      if (mirror) {
        r = splitmix64(r);
        do_mirror = (int)(r & 1);
      }
    } else {
      off_h = (h - crop) / 2;
      off_w = (w - crop) / 2;
    }
  } else if (train && mirror) {
    uint64_t r = splitmix64(seed ^ (uint64_t)record_id);
    do_mirror = (int)(r & 1);
  }
  for (int ch = 0; ch < c; ++ch) {
    const uint8_t* splane = src + ch * in_plane;
    const float* mplane = mean_mode == 2 ? mean + ch * in_plane : nullptr;
    const float mch = mean_mode == 1 ? mean[ch] : 0.f;
    float* dplane = dst + ch * out_plane;
    for (int y = 0; y < oh; ++y) {
      const uint8_t* srow = splane + (int64_t)(y + off_h) * w + off_w;
      const float* mrow =
          mplane ? mplane + (int64_t)(y + off_h) * w + off_w : nullptr;
      float* drow = dplane + (int64_t)y * ow;
      if (do_mirror) {
        for (int x = 0; x < ow; ++x) {
          const float m = mrow ? mrow[x] : mch;
          drow[ow - 1 - x] = ((float)srow[x] - m) * scale;
        }
      } else {
        for (int x = 0; x < ow; ++x) {
          const float m = mrow ? mrow[x] : mch;
          drow[x] = ((float)srow[x] - m) * scale;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Serving request preprocess — the per-request Python chain
// (caffe_io.resize_center_crop + Transformer.preprocess) replicated
// BITWISE for pre-decoded uint8 images, so the batcher can fuse a whole
// dispatch window's preprocessing into one GIL-released native call and
// scores stay row-identical to the classic per-request path.
//
// The resize is Pillow's ImagingResample for 32bpc ("F" mode) with the
// BILINEAR (triangle, support=1) filter — what caffe_io.resize_image
// runs per channel: coefficients computed in double, horizontal pass
// then vertical, double accumulation, float32 intermediate and result.
// Its caller, serving's request ingest, is not ported yet (ROADMAP.md
// section 1 item 5).
// ---------------------------------------------------------------------------

struct PilCoeffs {
  std::vector<int> bounds;  // per output index: (min, count) pairs
  std::vector<double> kk;   // out_size * ksize normalized weights
  int ksize = 0;
};

// Pillow precompute_coeffs (Resample.c) for the full-image box with the
// triangle filter: same rounding, same normalization order.
inline void pil_precompute(int in_size, int out_size, PilCoeffs* c) {
  const double scale = (double)in_size / (double)out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = filterscale;  // BILINEAR filter support = 1.0
  const int ksize = (int)std::ceil(support) * 2 + 1;
  c->ksize = ksize;
  c->bounds.assign((size_t)out_size * 2, 0);
  c->kk.assign((size_t)out_size * ksize, 0.0);
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &c->kk[(size_t)xx * ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double v = (x + xmin - center + 0.5) * ss;
      if (v < 0.0) v = -v;
      const double w = v < 1.0 ? 1.0 - v : 0.0;
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    c->bounds[(size_t)xx * 2] = xmin;
    c->bounds[(size_t)xx * 2 + 1] = xmax;
  }
}

// One f32 plane h*w -> oh*ow, horizontal then vertical like Pillow
// (each pass skipped when its dim is unchanged — Pillow's
// need_horizontal/need_vertical). cx/cy are precomputed for (w->ow) and
// (h->oh); tmp/out are caller scratch, resized here.
inline const float* pil_resample_plane(const float* in, int h, int w, int oh,
                                       int ow, const PilCoeffs& cx,
                                       const PilCoeffs& cy,
                                       std::vector<float>* tmp,
                                       std::vector<float>* out) {
  const float* cur = in;
  int cur_w = w;
  if (w != ow) {
    tmp->resize((size_t)h * ow);
    for (int y = 0; y < h; ++y) {
      const float* row = cur + (int64_t)y * w;
      float* drow = tmp->data() + (int64_t)y * ow;
      for (int xx = 0; xx < ow; ++xx) {
        const int xmin = cx.bounds[(size_t)xx * 2];
        const int xmax = cx.bounds[(size_t)xx * 2 + 1];
        const double* k = &cx.kk[(size_t)xx * cx.ksize];
        double s = 0.0;
        for (int x = 0; x < xmax; ++x) s += (double)row[x + xmin] * k[x];
        drow[xx] = (float)s;
      }
    }
    cur = tmp->data();
    cur_w = ow;
  }
  if (h != oh) {
    out->resize((size_t)oh * ow);
    for (int yy = 0; yy < oh; ++yy) {
      const int ymin = cy.bounds[(size_t)yy * 2];
      const int ymax = cy.bounds[(size_t)yy * 2 + 1];
      const double* k = &cy.kk[(size_t)yy * cy.ksize];
      float* drow = out->data() + (int64_t)yy * ow;
      for (int xx = 0; xx < ow; ++xx) {
        double s = 0.0;
        for (int y = 0; y < ymax; ++y)
          s += (double)cur[(int64_t)(y + ymin) * cur_w + xx] * k[y];
        drow[xx] = (float)s;
      }
    }
    cur = out->data();
  }
  return cur;
}

// One decoded planar-CHW uint8 image -> the net's f32 input row,
// mirroring the Python per-request chain bitwise for the same decoded
// pixels: float = u8/255 (the decode-time conversion), resize to
// (img_h, img_w) when dims differ, center-crop to (crop_h, crop_w),
// then per output channel j: pick source plane swap[j] (the composed
// storage-order + Transformer channel_swap permutation),
// v = v * raw_scale, v -= mean[j], v *= input_scale — each op rounding
// float32 in the numpy order. Returns 0, or nonzero on bad geometry.
inline int serve_preprocess_one(const uint8_t* src, int c, int h, int w,
                                int img_h, int img_w, int crop_h, int crop_w,
                                const int32_t* swap, int has_raw,
                                float raw_scale, const float* mean,
                                int has_iscale, float input_scale,
                                float* dst) {
  if (h <= 0 || w <= 0 || img_h <= 0 || img_w <= 0) return 1;
  if (crop_h <= 0 || crop_w <= 0 || crop_h > img_h || crop_w > img_w)
    return 1;
  const int off_h = (img_h - crop_h) / 2;
  const int off_w = (img_w - crop_w) / 2;
  const bool need_resize = (h != img_h) || (w != img_w);
  PilCoeffs cx, cy;
  if (need_resize) {
    pil_precompute(w, img_w, &cx);
    pil_precompute(h, img_h, &cy);
  }
  std::vector<float> fplane((size_t)h * w);
  std::vector<float> tmp, rplane;
  for (int j = 0; j < c; ++j) {
    const int sp = (int)swap[j];
    if (sp < 0 || sp >= c) return 1;
    const uint8_t* splane = src + (int64_t)sp * h * w;
    for (int64_t i = 0; i < (int64_t)h * w; ++i)
      fplane[i] = (float)splane[i] / 255.0f;
    const float* rp = fplane.data();
    if (need_resize)
      rp = pil_resample_plane(fplane.data(), h, w, img_h, img_w, cx, cy,
                              &tmp, &rplane);
    const float m = mean ? mean[j] : 0.f;
    float* dplane = dst + (int64_t)j * crop_h * crop_w;
    for (int y = 0; y < crop_h; ++y) {
      const float* srow = rp + (int64_t)(y + off_h) * img_w + off_w;
      float* drow = dplane + (int64_t)y * crop_w;
      for (int x = 0; x < crop_w; ++x) {
        float v = srow[x];
        if (has_raw) v = v * raw_scale;
        if (mean) v = v - m;
        if (has_iscale) v = v * input_scale;
        drow[x] = v;
      }
    }
  }
  return 0;
}

}  // namespace caffe_tpu

#endif  // CAFFE_TPU_NATIVE_TRANSFORM_CORE_H_
