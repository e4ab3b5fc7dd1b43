// Native LMDB reader — mmap'd zero-copy record access, no liblmdb.
//
// Counterpart of data/lmdb_io.py's pure-Python reader (the behavioral
// reference; see its docstring for the on-disk layout: LMDB 0.9 B+tree,
// struct offsets per mdb.c on LP64). The reference's record path is C++
// (db_lmdb.cpp over liblmdb); here the format itself is parsed so the
// hot path — per-record value fetch during training — is one C call
// handing back a pointer into the mapping, no per-record Python.
//
// Open walks the tree once and builds a flat (key, value) locator table
// in key order; values larger than the node budget resolve through
// F_BIGDATA overflow pages (data contiguous across pages, so a direct
// pointer still works). Scope: read-only, single main DB, no DUPSORT —
// exactly what Caffe datasets are (write-once, unique "%08d..." keys).
//
// caffe_tpu_lmdb_gather_raw reads a whole batch of raw Datums in one call:
// for each index, crc32c over the value in the mapping (against the
// sidecar's, when given), the Datum wire walk of datum_wire.h, and one
// copy of the pixels into the caller's uint8 stack — threaded, with the
// GIL released, no per-record Python.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#if defined(__x86_64__)
#include <nmmintrin.h>
#endif

#include "datum_wire.h"

namespace {

constexpr uint32_t kMagic = 0xBEEFC0DE;
constexpr uint32_t kVersion = 1;
constexpr uint64_t kInvalid = ~0ULL;
constexpr int kPageHdr = 16;
constexpr uint16_t kPBranch = 0x01, kPLeaf = 0x02, kPOverflow = 0x04,
                   kPMeta = 0x08;
constexpr uint16_t kFBigData = 0x01;

struct Rec {
  const uint8_t* key;
  int64_t klen;
  const uint8_t* val;
  int64_t vlen;
};

struct LmdbDB {
  const uint8_t* base = nullptr;
  size_t length = 0;
  size_t psize = 4096;
  std::vector<Rec> recs;
  int fd = -1;
};

inline uint16_t u16(const uint8_t* p) { uint16_t v; memcpy(&v, p, 2); return v; }
inline uint32_t u32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
inline uint64_t u64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }

// crc32c (Castagnoli), slice-by-8 — the record-integrity checksum the
// crc sidecar scheme verifies on the read path (data/lmdb_io.py
// crc32c, which writes the sidecar, calls caffe_tpu_crc32c here too);
// computed directly over the mmap so the native value path verifies
// without first copying the bytes into Python.
struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    const uint32_t poly = 0x82F63B78u;
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
      t[0][i] = c;
    }
    for (int k = 1; k < 8; ++k)
      for (uint32_t i = 0; i < 256; ++i)
        t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

const Crc32cTables kCrc;

// `seed` is the crc32c of the bytes before p (0 for none): a file's crc
// is the crcs of its chunks chained through it.
uint32_t crc32c_table(const uint8_t* p, size_t n, uint32_t seed = 0) {
  uint32_t crc = seed ^ 0xFFFFFFFFu;
  size_t n8 = n - (n % 8);
  for (size_t i = 0; i < n8; i += 8) {
    crc ^= u32(p + i);
    crc = kCrc.t[7][crc & 0xFF] ^ kCrc.t[6][(crc >> 8) & 0xFF] ^
          kCrc.t[5][(crc >> 16) & 0xFF] ^ kCrc.t[4][crc >> 24] ^
          kCrc.t[3][p[i + 4]] ^ kCrc.t[2][p[i + 5]] ^
          kCrc.t[1][p[i + 6]] ^ kCrc.t[0][p[i + 7]];
  }
  for (size_t i = n8; i < n; ++i)
    crc = kCrc.t[0][(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

#if defined(__x86_64__)
// The same crc32c by SSE4.2's crc32 instruction (the Castagnoli
// polynomial in hardware), eight bytes an instruction; chosen at run time
// where the CPU has it.
__attribute__((target("sse4.2"))) uint32_t crc32c_hw(const uint8_t* p,
                                                     size_t n,
                                                     uint32_t seed = 0) {
  uint64_t crc = seed ^ 0xFFFFFFFFu;
  size_t i = 0;
  for (; i + 8 <= n; i += 8) crc = _mm_crc32_u64(crc, u64(p + i));
  uint32_t c32 = (uint32_t)crc;
  for (; i < n; ++i) c32 = _mm_crc32_u8(c32, p[i]);
  return c32 ^ 0xFFFFFFFFu;
}

const bool kHwCrc = __builtin_cpu_supports("sse4.2");
#else
const bool kHwCrc = false;
uint32_t crc32c_hw(const uint8_t* p, size_t n, uint32_t seed = 0) {
  return crc32c_table(p, n, seed);
}
#endif

inline uint32_t crc32c(const uint8_t* p, size_t n, uint32_t seed = 0) {
  return kHwCrc ? crc32c_hw(p, n, seed) : crc32c_table(p, n, seed);
}

// meta page -> (ok, psize, root, txnid)
bool parse_meta(const uint8_t* base, size_t len, size_t off, size_t* psize,
                uint64_t* root, uint64_t* txnid) {
  if (off + 160 > len) return false;
  const uint8_t* pg = base + off;
  if (!(u16(pg + 10) & kPMeta)) return false;
  if (u32(pg + 16) != kMagic || u32(pg + 20) != kVersion) return false;
  size_t ps = u32(pg + 40);  // mm_dbs[0].md_pad carries the page size
  *psize = ps ? ps : 4096;
  if (u16(pg + 88 + 4) != 0) return false;  // main-DB flags must be 0
  *root = u64(pg + 88 + 40);
  *txnid = u64(pg + 144);
  return true;
}

bool walk(LmdbDB* db, uint64_t pgno, int depth) {
  if (depth > 64) return false;  // corrupt cycle guard
  size_t off = pgno * db->psize;
  if (off + db->psize > db->length) return false;
  const uint8_t* pg = db->base + off;
  uint16_t flags = u16(pg + 10);
  int n = (u16(pg + 12) - kPageHdr) >> 1;
  if (n < 0) return false;
  for (int i = 0; i < n; ++i) {
    uint16_t ptr = u16(pg + kPageHdr + 2 * i);
    if (off + ptr + 8 > db->length) return false;
    const uint8_t* node = pg + ptr;
    uint16_t lo = u16(node), hi = u16(node + 2), nflags = u16(node + 4),
             ksize = u16(node + 6);
    if (flags & kPBranch) {
      uint64_t child =
          (uint64_t)lo | ((uint64_t)hi << 16) | ((uint64_t)nflags << 32);
      if (!walk(db, child, depth + 1)) return false;
    } else if (flags & kPLeaf) {
      Rec r;
      // full-extent bounds checks: a truncated/corrupt file must fail
      // open() with nullptr, not SIGSEGV later in record()
      if (off + ptr + 8 + (size_t)ksize > db->length) return false;
      r.key = node + 8;
      r.klen = ksize;
      int64_t dsize = (int64_t)lo | ((int64_t)hi << 16);
      if (nflags & kFBigData) {
        if (off + ptr + 8 + (size_t)ksize + 8 > db->length) return false;
        uint64_t ov = u64(node + 8 + ksize);
        size_t ovoff = ov * db->psize;
        if (ovoff + kPageHdr + (size_t)dsize > db->length) return false;
        if (!(u16(db->base + ovoff + 10) & kPOverflow)) return false;
        r.val = db->base + ovoff + kPageHdr;
      } else {
        if (off + ptr + 8 + (size_t)ksize + (size_t)dsize > db->length)
          return false;
        r.val = node + 8 + ksize;
      }
      r.vlen = dsize;
      db->recs.push_back(r);
    } else {
      return false;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Returns an opaque handle or nullptr. `path` is the environment dir
// (containing data.mdb) or the data file itself.
void* caffe_tpu_lmdb_open(const char* path) {
  std::string p(path);
  struct stat st;
  if (stat(p.c_str(), &st) != 0) return nullptr;
  if (S_ISDIR(st.st_mode)) {
    p += "/data.mdb";
    if (stat(p.c_str(), &st) != 0) return nullptr;
  }
  int fd = open(p.c_str(), O_RDONLY);
  if (fd < 0) return nullptr;
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* db = new LmdbDB;
  db->base = (const uint8_t*)map;
  db->length = st.st_size;
  db->fd = fd;

  size_t ps0 = 0, ps1 = 0;
  uint64_t root0 = kInvalid, root1 = kInvalid, txn0 = 0, txn1 = 0;
  bool ok0 = parse_meta(db->base, db->length, 0, &ps0, &root0, &txn0);
  bool ok1 = ok0 && parse_meta(db->base, db->length, ps0, &ps1, &root1, &txn1);
  if (!ok0) {
    munmap(map, st.st_size);
    close(fd);
    delete db;
    return nullptr;
  }
  uint64_t root = (ok1 && txn1 > txn0) ? root1 : root0;
  db->psize = ps0;
  if (root != kInvalid && !walk(db, root, 0)) {
    munmap(map, st.st_size);
    close(fd);
    delete db;
    return nullptr;
  }
  return db;
}

int64_t caffe_tpu_lmdb_count(void* h) {
  return h ? (int64_t)((LmdbDB*)h)->recs.size() : -1;
}

// Zero-copy pointers into the mapping for record `idx` (key order).
int caffe_tpu_lmdb_record(void* h, int64_t idx, const uint8_t** key,
                          int64_t* klen, const uint8_t** val, int64_t* vlen) {
  if (!h) return -1;
  auto* db = (LmdbDB*)h;
  if (idx < 0 || idx >= (int64_t)db->recs.size()) return -1;
  const Rec& r = db->recs[(size_t)idx];
  *key = r.key;
  *klen = r.klen;
  *val = r.val;
  *vlen = r.vlen;
  return 0;
}

// Every record's key and value as (offset, length) in the mapped file,
// key order, into four arrays of caffe_tpu_lmdb_count entries: the Python
// side maps the file too and reads records by slicing, with no call a
// record. Returns 0.
int caffe_tpu_lmdb_spans(void* h, int64_t* koff, int64_t* klen,
                         int64_t* voff, int64_t* vlen) {
  if (!h || koff == nullptr || klen == nullptr || voff == nullptr ||
      vlen == nullptr)
    return 1;
  auto* db = (LmdbDB*)h;
  for (size_t i = 0; i < db->recs.size(); ++i) {
    const Rec& r = db->recs[i];
    koff[i] = (int64_t)(r.key - db->base);
    klen[i] = r.klen;
    voff[i] = (int64_t)(r.val - db->base);
    vlen[i] = r.vlen;
  }
  return 0;
}

// crc32c of record `idx`'s VALUE bytes, computed over the mapping
// (zero-copy) — the read-path integrity check against the crc sidecar
// (data/lmdb_io.py write_crc_sidecar). Returns -1 on a bad handle/index
// so the int64 return can carry the full u32 range.
int64_t caffe_tpu_lmdb_value_crc32c(void* h, int64_t idx) {
  if (!h) return -1;
  auto* db = (LmdbDB*)h;
  if (idx < 0 || idx >= (int64_t)db->recs.size()) return -1;
  const Rec& r = db->recs[(size_t)idx];
  return (int64_t)crc32c(r.val, (size_t)r.vlen);
}

// crc32c of `n` bytes, by the table (hw = 0) or, where the CPU has it,
// the crc32 instruction (hw = 1): the tests hold both against each other.
int64_t caffe_tpu_crc32c(const uint8_t* p, int64_t n, int hw) {
  if (p == nullptr && n > 0) return -1;
  return (int64_t)(hw && kHwCrc ? crc32c_hw(p, (size_t)n)
                                : crc32c_table(p, (size_t)n));
}

// crc32c of the `n` bytes at p following bytes whose crc32c is `seed`
// (google_crc32c's extend): the snapshot manifests' file crcs, a chunk
// at a time.
int64_t caffe_tpu_crc32c_extend(int64_t seed, const uint8_t* p, int64_t n) {
  if ((p == nullptr && n > 0) || seed < 0 || seed > 0xFFFFFFFFll) return -1;
  return (int64_t)crc32c(p, (size_t)n, (uint32_t)seed);
}

// Raw-batch gather: records idx[0..n) (key order) -> out, n x (c*h*w)
// uint8, and labels[i]. expect_crcs (nullable) holds each record's
// sidecar crc32c, checked over the value in the mapping before the walk.
// status[i] is caffe_tpu::kGather*: a record not kGatherOk leaves its row
// and label untouched, for the caller to re-read on its Python path.
// Returns 0 when the call ran, nonzero for argument errors.
int caffe_tpu_lmdb_gather_raw(void* h, const int64_t* idx, int n,
                              const uint32_t* expect_crcs, int c, int hgt,
                              int w, uint8_t* out, int64_t* labels,
                              int32_t* status, int num_threads) {
  if (!h || idx == nullptr || out == nullptr || labels == nullptr ||
      status == nullptr || n <= 0 || c <= 0 || hgt <= 0 || w <= 0)
    return 1;
  auto* db = (LmdbDB*)h;
  const int64_t row = (int64_t)c * hgt * w;
  caffe_tpu::parallel_records(n, num_threads, [&](int i) {
    const int64_t k = idx[i];
    if (k < 0 || k >= (int64_t)db->recs.size()) {
      status[i] = caffe_tpu::kGatherIndex;
      return;
    }
    const Rec& r = db->recs[(size_t)k];
    if (expect_crcs != nullptr &&
        crc32c(r.val, (size_t)r.vlen) != expect_crcs[i]) {
      status[i] = caffe_tpu::kGatherCrc;
      return;
    }
    const uint8_t* data = nullptr;
    int64_t label = 0;
    const int rc =
        caffe_tpu::walk_raw_datum(r.val, r.vlen, c, hgt, w, &data, &label);
    if (rc == caffe_tpu::kGatherOk) {
      std::memcpy(out + (int64_t)i * row, data, (size_t)row);
      labels[i] = label;
    }
    status[i] = rc;
  });
  return 0;
}

void caffe_tpu_lmdb_close(void* h) {
  if (!h) return;
  auto* db = (LmdbDB*)h;
  if (db->base) munmap((void*)db->base, db->length);
  if (db->fd >= 0) close(db->fd);
  delete db;
}

}  // extern "C"
