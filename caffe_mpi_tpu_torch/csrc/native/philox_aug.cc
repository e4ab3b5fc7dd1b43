// The device transform's augmentation decisions in C: for each record of a
// batch, the crop offsets and the mirror that data/device_transform.py
// compute_aug draws from numpy's Generator(Philox(key=(seed << 32) ^
// flat)), replayed bit for bit, so a batch's decisions cost one call and
// no per-record Python.
//
// numpy's Philox is Random123's philox4x64 with 10 rounds: a 256-bit
// counter, starting at 0 and incremented before each block, a 128-bit key
// (the Python int's low word first), four 64-bit outputs a block; its
// 32-bit draws split a 64-bit output, low half first. Generator.integers
// (0, high) draws in [0, high - 1] by Lemire's multiply-and-reject on
// 32-bit draws (high - 1 < 2^32 - 1), and draws nothing when high is 1.
// tests/test_torch_native.py holds this against numpy over many keys and
// ranges.

#include <cstdint>

namespace {

constexpr uint64_t kM0 = 0xD2E7470EE14C6C93ull;
constexpr uint64_t kM1 = 0xCA5A826395121157ull;
constexpr uint64_t kW0 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kW1 = 0xBB67AE8584CAA73Bull;

inline uint64_t mulhilo(uint64_t a, uint64_t b, uint64_t* hi) {
  const unsigned __int128 p = (unsigned __int128)a * b;
  *hi = (uint64_t)(p >> 64);
  return (uint64_t)p;
}

struct Philox {
  uint64_t ctr[4] = {0, 0, 0, 0};
  uint64_t key[2];
  uint64_t buf[4] = {0, 0, 0, 0};
  int pos = 4;
  bool has32 = false;
  uint32_t u32 = 0;

  Philox(uint64_t key_lo, uint64_t key_hi) : key{key_lo, key_hi} {}

  uint64_t next64() {
    if (pos < 4) return buf[pos++];
    if (++ctr[0] == 0 && ++ctr[1] == 0 && ++ctr[2] == 0) ++ctr[3];
    uint64_t c[4] = {ctr[0], ctr[1], ctr[2], ctr[3]};
    uint64_t k0 = key[0], k1 = key[1];
    for (int r = 0; r < 10; ++r) {
      if (r > 0) {
        k0 += kW0;
        k1 += kW1;
      }
      uint64_t hi0, hi1;
      const uint64_t lo0 = mulhilo(kM0, c[0], &hi0);
      const uint64_t lo1 = mulhilo(kM1, c[2], &hi1);
      const uint64_t n0 = hi1 ^ c[1] ^ k0;
      const uint64_t n2 = hi0 ^ c[3] ^ k1;
      c[0] = n0;
      c[1] = lo1;
      c[2] = n2;
      c[3] = lo0;
    }
    for (int i = 0; i < 4; ++i) buf[i] = c[i];
    pos = 1;
    return buf[0];
  }

  uint32_t next32() {
    if (has32) {
      has32 = false;
      return u32;
    }
    const uint64_t v = next64();
    has32 = true;
    u32 = (uint32_t)(v >> 32);
    return (uint32_t)v;
  }

  // integers(0, rng + 1): a draw in [0, rng], rng < 2^32
  uint32_t bounded(uint32_t rng) {
    if (rng == 0) return 0;
    if (rng == 0xFFFFFFFFu) return next32();
    const uint32_t excl = rng + 1;
    uint64_t m = (uint64_t)next32() * excl;
    uint32_t leftover = (uint32_t)m;
    if (leftover < excl) {
      const uint32_t threshold = (0xFFFFFFFFu - rng) % excl;
      while (leftover < threshold) {
        m = (uint64_t)next32() * excl;
        leftover = (uint32_t)m;
      }
    }
    return (uint32_t)(m >> 32);
  }
};

}  // namespace

extern "C" {

// TRAIN decisions of n records: out[i] = (off_h, off_w, mirror), int32,
// drawn as compute_aug draws them (off_h, off_w when crop > 0, then the
// mirror when mirror != 0) from the stream keyed (seed << 32) ^ flats[i]
// (a 128-bit key). Returns 0, or nonzero when crop exceeds the record
// (numpy raises there; the caller's plain version says so).
int caffe_tpu_philox_aug(const int64_t* flats, int n, uint64_t seed, int h,
                         int w, int crop, int mirror, int32_t* out) {
  if (flats == nullptr || out == nullptr || n < 0 || crop < 0 || crop > h ||
      crop > w)
    return 1;
  const uint64_t key_hi = seed >> 32;
  for (int i = 0; i < n; ++i) {
    Philox g((seed << 32) ^ (uint64_t)flats[i], key_hi);
    int32_t* o = out + 3 * (int64_t)i;
    o[0] = o[1] = o[2] = 0;
    if (crop) {
      o[0] = (int32_t)g.bounded((uint32_t)(h - crop));
      o[1] = (int32_t)g.bounded((uint32_t)(w - crop));
    }
    if (mirror) o[2] = (int32_t)g.bounded(1);
  }
  return 0;
}

}  // extern "C"
