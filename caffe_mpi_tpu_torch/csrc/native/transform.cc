// Native batch transformer — the hot host-side loop of the data pipeline.
//
// Role in the framework: the reference implements its DataTransformer and
// batch assembly in C++/CUDA (src/caffe/data_transformer.cpp, 753 LoC, plus
// transformer threads in base_data_layer.cpp). Where the card transforms
// (use_gpu_transform) the host ships raw uint8; otherwise the HOST side —
// decode -> crop -> mirror -> mean/scale -> float32 batch — must keep up
// with the card. This library does that work in multithreaded C++, called
// from the Python Feeder via ctypes (GIL released during the call).
//
// The per-image crop/mirror/mean/scale arithmetic (and its counter-based
// splitmix64 augmentation keying) lives in transform_core.h, shared with
// decode.cc's fused decode->transform entry point so the two
// paths stay bitwise-identical for the same decoded pixels.

#include <cstdint>
#include <thread>
#include <vector>

#include "transform_core.h"

namespace {

struct TransformArgs {
  const uint8_t* const* srcs;  // n pointers to CHW uint8 images
  const int64_t* record_ids;   // n global record indices (RNG keys)
  int n, c, h, w;              // input geometry
  int crop;                    // 0 = no crop; output is crop x crop otherwise
  const float* mean;           // nullptr | c floats | c*h*w floats
  int mean_mode;               // 0 none, 1 per-channel, 2 full image
  float scale;
  int train;                   // 1 = random crop + mirror; 0 = center crop
  int mirror;                  // mirror enabled (train only)
  uint64_t seed;
  float* out;                  // n x c x oh x ow
};

void transform_range(const TransformArgs& a, int begin, int end) {
  const int oh = a.crop ? a.crop : a.h;
  const int ow = a.crop ? a.crop : a.w;
  const int64_t out_plane = (int64_t)oh * ow;
  for (int i = begin; i < end; ++i) {
    caffe_tpu::transform_one(a.srcs[i], a.c, a.h, a.w, a.crop, a.mean,
                             a.mean_mode, a.scale, a.train, a.mirror, a.seed,
                             a.record_ids[i],
                             a.out + (int64_t)i * a.c * out_plane);
  }
}

}  // namespace

extern "C" {

// Returns 0 on success.
int caffe_tpu_transform_batch(const uint8_t* const* srcs,
                              const int64_t* record_ids, int n, int c, int h,
                              int w, int crop, const float* mean,
                              int mean_mode, float scale, int train,
                              int mirror, uint64_t seed, float* out,
                              int num_threads) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0) return 1;
  if (crop < 0 || crop > h || crop > w) return 2;
  if (mean_mode != 0 && mean == nullptr) return 3;
  TransformArgs a{srcs, record_ids, n,     c,      h,    w,    crop,
                  mean, mean_mode,  scale, train,  mirror, seed, out};
  if (num_threads <= 1 || n == 1) {
    transform_range(a, 0, n);
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
    threads.emplace_back([&a, begin, end] { transform_range(a, begin, end); });
  }
  for (auto& th : threads) th.join();
  return 0;
}

// 2: the port's library, which adds the raw-batch gathers
// (caffe_tpu_lmdb_gather_raw, caffe_tpu_db_gather_raw) and
// caffe_tpu_crc32c to the JAX package's version 1; 3 adds
// caffe_tpu_crc32c_extend.
int caffe_tpu_native_abi_version() { return 3; }

}  // extern "C"
