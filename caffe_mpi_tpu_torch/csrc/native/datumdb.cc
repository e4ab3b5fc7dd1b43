// Native datumfile reader — mmap'd zero-copy record access.
//
// Completes the native data plane: the reference's record path is C++ end
// to end (db_lmdb.cpp cursors -> data_reader.cpp parser threads ->
// data_transformer.cpp). Here the datumfile container (see
// data/datasets.py DatumFileDataset for the layout: MAGIC, raw Datum
// messages, [count][off,size pairs][index_off] footer) is mmap'd once; a
// batch read walks each record's protobuf wire format in place and hands
// raw CHW uint8 pointers straight to the transform kernel — one C call,
// GIL released, no per-record Python or memcpy.
//
// Datum wire fields (reference caffe.proto Datum): 1=channels 2=height
// 3=width 4=data(bytes) 5=label. Encoded (JPEG) datums are rejected here
// (field 7) — those decode on the Python path.
//
// caffe_tpu_db_gather_raw reads a batch of raw Datums in one call, through
// the conservative wire walk of datum_wire.h, into the caller's stack.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include "datum_wire.h"

namespace {

constexpr char kMagic[] = "CAFFEDATUMv1";
constexpr int kMagicLen = 12;

struct Record {
  int64_t offset;
  int64_t size;
};

struct DatumDB {
  const uint8_t* base = nullptr;
  size_t length = 0;
  const Record* records = nullptr;
  int64_t count = 0;
  int fd = -1;
};

inline bool read_varint(const uint8_t* buf, int64_t size, int64_t& pos,
                        uint64_t& out) {
  out = 0;
  int shift = 0;
  while (pos < size && shift < 64) {
    uint8_t b = buf[pos++];
    out |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) return true;
    shift += 7;
  }
  return false;
}

}  // namespace

extern "C" {

// Returns an opaque handle or nullptr.
void* caffe_tpu_db_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < kMagicLen + 16) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* db = new DatumDB;
  db->base = (const uint8_t*)mem;
  db->length = st.st_size;
  db->fd = fd;
  if (memcmp(db->base, kMagic, kMagicLen) != 0) {
    munmap(mem, st.st_size);
    close(fd);
    delete db;
    return nullptr;
  }
  int64_t index_off;
  memcpy(&index_off, db->base + db->length - 8, 8);
  if (index_off < kMagicLen || (size_t)index_off + 8 > db->length) {
    munmap(mem, st.st_size);
    close(fd);
    delete db;
    return nullptr;
  }
  memcpy(&db->count, db->base + index_off, 8);
  db->records = (const Record*)(db->base + index_off + 8);
  return db;
}

int64_t caffe_tpu_db_count(void* handle) {
  return handle ? ((DatumDB*)handle)->count : -1;
}

// Parse record `index`; returns 0 on success and fills pointers.
// data_out points INTO the mmap (valid until close).
int caffe_tpu_db_get(void* handle, int64_t index, const uint8_t** data_out,
                     int* channels, int* height, int* width, int* label) {
  auto* db = (DatumDB*)handle;
  if (!db || index < 0 || index >= db->count) return 1;
  const Record& rec = db->records[index];
  if (rec.offset < 0 || rec.offset + rec.size > (int64_t)db->length) return 2;
  const uint8_t* buf = db->base + rec.offset;
  int64_t size = rec.size, pos = 0;
  *data_out = nullptr;
  *channels = *height = *width = *label = 0;
  while (pos < size) {
    uint64_t tag;
    if (!read_varint(buf, size, pos, tag)) return 3;
    uint32_t field = tag >> 3, wire = tag & 7;
    if (wire == 0) {
      uint64_t val;
      if (!read_varint(buf, size, pos, val)) return 3;
      switch (field) {
        case 1: *channels = (int)val; break;
        case 2: *height = (int)val; break;
        case 3: *width = (int)val; break;
        case 5: *label = (int)val; break;
        case 7:
          if (val) return 4;  // encoded datum: python path decodes
          break;
      }
    } else if (wire == 2) {
      uint64_t len;
      if (!read_varint(buf, size, pos, len)) return 3;
      if (pos + (int64_t)len > size) return 3;
      if (field == 4) *data_out = buf + pos;
      pos += len;
    } else if (wire == 5) {
      pos += 4;
    } else if (wire == 1) {
      pos += 8;
    } else {
      return 3;
    }
  }
  if (*data_out == nullptr) return 5;  // float_data datums: python path
  return 0;
}

// Raw-batch gather: records idx[0..n) -> out, n x (c*h*w) uint8, and
// labels[i]; status[i] as caffe_tpu_lmdb_gather_raw's (the datumfile has
// no checksums). Returns 0 when the call ran.
int caffe_tpu_db_gather_raw(void* handle, const int64_t* idx, int n, int c,
                            int h, int w, uint8_t* out, int64_t* labels,
                            int32_t* status, int num_threads) {
  auto* db = (DatumDB*)handle;
  if (!db || idx == nullptr || out == nullptr || labels == nullptr ||
      status == nullptr || n <= 0 || c <= 0 || h <= 0 || w <= 0)
    return 1;
  const int64_t row = (int64_t)c * h * w;
  caffe_tpu::parallel_records(n, num_threads, [&](int i) {
    const int64_t k = idx[i];
    if (k < 0 || k >= db->count) {
      status[i] = caffe_tpu::kGatherIndex;
      return;
    }
    const Record& rec = db->records[k];
    if (rec.offset < 0 || rec.size < 0 ||
        rec.offset + rec.size > (int64_t)db->length) {
      status[i] = caffe_tpu::kGatherWire;
      return;
    }
    const uint8_t* data = nullptr;
    int64_t label = 0;
    const int rc = caffe_tpu::walk_raw_datum(db->base + rec.offset, rec.size,
                                             c, h, w, &data, &label);
    if (rc == caffe_tpu::kGatherOk) {
      std::memcpy(out + (int64_t)i * row, data, (size_t)row);
      labels[i] = label;
    }
    status[i] = rc;
  });
  return 0;
}

void caffe_tpu_db_close(void* handle) {
  auto* db = (DatumDB*)handle;
  if (!db) return;
  munmap((void*)db->base, db->length);
  close(db->fd);
  delete db;
}

}  // extern "C"
