// Datum wire walk shared by the raw-batch gathers of lmdb_reader.cc and
// datumdb.cc: one record's protobuf wire format (reference caffe.proto
// Datum: 1=channels 2=height 3=width 4=data(bytes) 5=label
// 6=float_data 7=encoded) read in place, and the gather loop that copies
// each raw record of a batch into one uint8 stack.
//
// The walk is conservative: it accepts only a record that the Python
// parser (data/datasets.py parse_datum_fields + materialize_datum) reads
// as a raw uint8 Datum of the expected (c, h, w), with the same fields
// (the last occurrence of a field wins, as there). Anything else — an
// encoded or float record, a malformed or unusual wire, another shape —
// gets a nonzero status and the caller re-reads that record on the
// Python path, which owns the error, the PIL decode and the quarantine.
// So an accepted record's pixels and label are the Python path's bit for
// bit, and a declined one costs one per-record read.

#ifndef CAFFE_TPU_NATIVE_DATUM_WIRE_H_
#define CAFFE_TPU_NATIVE_DATUM_WIRE_H_

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace caffe_tpu {

// per-record statuses of the raw gathers (native/__init__.py GATHER_*)
enum {
  kGatherOk = 0,
  kGatherIndex = 1,     // index out of range
  kGatherCrc = 2,       // crc32c differs from the sidecar's
  kGatherWire = 3,      // malformed or unusual wire: Python decides
  kGatherNotRaw = 4,    // encoded, float, or another shape
};

// a varint of at most 64 bits; false past the buffer or past 64 bits
inline bool wire_varint(const uint8_t* buf, int64_t size, int64_t& pos,
                        uint64_t& out) {
  out = 0;
  for (int shift = 0; shift < 64 && pos < size; shift += 7) {
    const uint8_t b = buf[pos++];
    if (shift == 63 && (b & 0x7E)) return false;  // bits past 64
    out |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) return true;
  }
  return false;
}

// Walk one Datum. kGatherOk with `data` pointing into `buf` when it is a
// raw uint8 Datum of exactly (c, h, w); the label is the int64 the
// Python parser gives (a varint >= 2^63 read as negative).
inline int walk_raw_datum(const uint8_t* buf, int64_t size, int c, int h,
                          int w, const uint8_t** data, int64_t* label) {
  uint64_t dims[3] = {0, 0, 0};
  uint64_t lab = 0;
  const uint8_t* payload = nullptr;
  int64_t payload_len = 0;
  bool encoded = false;
  int64_t pos = 0;
  while (pos < size) {
    uint64_t tag;
    if (!wire_varint(buf, size, pos, tag)) return kGatherWire;
    const uint64_t field = tag >> 3, wire = tag & 7;
    if (wire == 0) {
      uint64_t val;
      if (!wire_varint(buf, size, pos, val)) return kGatherWire;
      if (field >= 1 && field <= 3) dims[field - 1] = val;
      else if (field == 5) lab = val;
      else if (field == 7) encoded = val != 0;
    } else if (wire == 2) {
      uint64_t len;
      if (!wire_varint(buf, size, pos, len)) return kGatherWire;
      if (len > (uint64_t)(size - pos)) return kGatherWire;
      if (field == 6) return kGatherNotRaw;  // float_data: Python path
      if (field == 4) {
        payload = buf + pos;
        payload_len = (int64_t)len;
      }
      pos += (int64_t)len;
    } else if (wire == 5) {
      if (field == 6) return kGatherNotRaw;
      if (size - pos < 4) return kGatherWire;
      pos += 4;
    } else if (wire == 1) {
      if (size - pos < 8) return kGatherWire;
      pos += 8;
    } else {
      return kGatherWire;  // the Python parser raises on these
    }
  }
  if (encoded || payload == nullptr || payload_len == 0) return kGatherNotRaw;
  if (dims[0] != (uint64_t)c || dims[1] != (uint64_t)h ||
      dims[2] != (uint64_t)w || payload_len != (int64_t)c * h * w)
    return kGatherNotRaw;
  *data = payload;
  *label = (int64_t)lab;
  return kGatherOk;
}

// Run fn(i) for i in [0, n) on up to num_threads threads, in contiguous
// chunks.
template <typename Fn>
inline void parallel_records(int n, int num_threads, Fn fn) {
  if (num_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  const int nt = num_threads < n ? num_threads : n;
  const int chunk = (n + nt - 1) / nt;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    const int begin = t * chunk;
    const int end = begin + chunk < n ? begin + chunk : n;
    if (begin >= end) break;
    threads.emplace_back([&fn, begin, end] {
      for (int i = begin; i < end; ++i) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace caffe_tpu

#endif  // CAFFE_TPU_NATIVE_DATUM_WIRE_H_
