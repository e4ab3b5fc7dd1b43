// crc32c (Castagnoli, reflected polynomial 0x82F63B78) for the LMDB crc
// sidecar, host code with a plain C interface, built by the host C++
// compiler (ops/build.py) and bound through ctypes by data/lmdb_io.py. No
// kernel: the data plane verifies every record it reads on the host.
//
// Slice-by-8: eight 256-entry tables fold eight input bytes into the
// register a step (the same tables as the JAX package's
// caffe_mpi_tpu/data/leveldb_io.py _crc32c_py, in C).

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (int k = 1; k < 8; ++k)
      for (int i = 0; i < 256; ++i)
        t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

const Tables kTables;

}  // namespace

extern "C" uint32_t caffe_crc32c(const unsigned char* data, size_t n) {
  const auto& T = kTables.t;
  uint32_t crc = 0xFFFFFFFFu;
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint32_t lo;
    std::memcpy(&lo, data + i, 4);  // little-endian host, as x86-64
    crc ^= lo;
    crc = T[7][crc & 0xFF] ^ T[6][(crc >> 8) & 0xFF] ^
          T[5][(crc >> 16) & 0xFF] ^ T[4][crc >> 24] ^ T[3][data[i + 4]] ^
          T[2][data[i + 5]] ^ T[1][data[i + 6]] ^ T[0][data[i + 7]];
  }
  for (; i < n; ++i) crc = T[0][(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}
