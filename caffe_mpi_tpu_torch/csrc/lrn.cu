// Across-channel LRN, forward (K1) and backward (K2), for Hopper (sm_90a).
//
// K1 replaces the TPU kernel caffe_mpi_tpu/ops/lrn.py:_fwd_kernel (Pallas),
// which computes, for x viewed as (N, C, H*W):
//
//     s_c = k + (alpha/n) * sum_{j = c-half .. c+half, 0 <= j < C} x_j^2
//     y_c = x_c * exp(-beta * log(s_c))
//
// K2 replaces caffe_mpi_tpu/ops/lrn.py:_bwd_kernel. It reads x and dy,
// recomputes the scale (no stored scale, as the TPU kernel), and writes
//
//     inv_j   = exp(-beta * log(s_j))
//     ratio_j = dy_j * x_j * inv_j / s_j
//     dx_c    = dy_c * inv_c - (2*alpha*beta/n) * x_c * sum_{W(c)} ratio_j
//
// What bounds them on this card: bytes. K1 does ~n+6 flops per element and
// must read x once and write y once, 2*N*C*H*W*itemsize bytes; K2 reads x
// and dy and writes dx, 3*N*C*H*W*itemsize bytes, for ~(n+2)*(n+4) flops an
// element. At AlexNet's widths both sit far below the card's flops per byte,
// so the least time is those bytes over the memory rate (K1: 177.5 us for
// norm1 at batch 256 in f32; K2: 266.3 us).
//
// The grid. The TPU kernels held a (1, C, 128) tile of all channels in
// VMEM; none of that tiling carries over. Here a thread owns one spatial
// position of one image and a run of R channels of it. The grid has one
// axis: block b takes channel run b % runs, position block
// (b / runs) % pos_blocks and image b / (runs * pos_blocks) (`locate`).
// That axis holds 2^31 - 1 blocks, so any image count an int holds fits
// (the wrapper cuts a launch that would pass it), where a second grid axis
// would stop at 65,535 images. With the runs fastest, the blocks that share
// a halo run at about the same time, and the halo's second read mostly
// hits L2. Neighbouring threads take neighbouring positions, so every load
// and store of a warp is one contiguous run of addresses. Cutting the
// channels into runs is what keeps enough loads in flight: with one thread
// walking all C channels (96 or 256 in AlexNet) too few threads each had
// one load at a time outstanding, and that kernel ran at a tenth of an H100
// SXM's memory rate (PERF.md).
//
// K1 (second design). The first design re-read the whole window and x_c
// for each of a thread's 8 outputs (48 loads for 8 outputs at size 5), in
// a loop whose trip count is known only at run time, so little was in
// flight and the load pipe and L1, not device memory, set its pace (49% of
// the bytes bound at norm1, batch 256, f32, on an H100). Now a thread loads
// x over channels [c0 - h, c0 + R - 1 + h] (h = (size - 1) / 2, zeros past
// the edges) once into registers, all R + 2h loads issued before any math.
// It forms each square once and each output's window sum from those
// registers in ascending order, 0 + x_{c-h}^2 + ... + x_{c+h}^2: the plain
// version's order, so K1 stays bitwise equal to it. x_c comes from the
// registers too. A thread holds about 2(R + 2h) floats. The run R is the
// longest of 32, 16 and 8 channels whose grid still gives every SM
// kFwdWaves = 8 blocks, else 8 in blocks of 128 positions (`pick_fwd`):
// runs of 32 at AlexNet's training batch 256 (20% of the loads are halo,
// against 25% at 16), runs of 8 at serving's batches 1-10, where more
// blocks beat fewer halo loads. On an H100 SXM (700 W) that took norm1 at
// batch 256 from 363 to 220 us in f32 (81% of the bytes bound) and its
// serving batches from 10.5-22.2 to 7.1-15.4 us; runs of 16 everywhere,
// runs of 8, a threshold of 2 blocks an SM, or 4 blocks an SM forced by
// launch bounds were each as fast or slower (flash_variants.py k1_*).
// In bf16 K1 is no faster than in f32 (211 us): the bytes halve, but the
// log, exp, window sum and address math of each element do not.
//
// K2 (second design). Its bound is the same bytes: x and dy read
// once, dx written once. The first design re-read 5 values of x for each of
// a run's 12 window positions (about 84 loads of x and dy for 8 outputs),
// so the load pipe and L1, not device memory, set its pace (a quarter of
// the memory rate). Now a thread loads each element of x and dy it needs
// from device memory once, into registers: x over channels
// [c0 - 2h, c0 + R - 1 + 2h] and dy over [c0 - h, c0 + R - 1 + h] (zeros
// past the edges), all loads issued before any math, so each thread keeps
// 2R + 6h loads in flight. It forms the squares once, each window
// position's scale and ratio once, and each output's window sums from
// those registers in ascending order, as K1 and the plain version take
// them: no running add/subtract sum, so K2 stays equal to its plain
// version. The run length R = kRun = 16 channels: a run costs 2R + 6h
// loads against the ideal 2R (44 for 32 at size 5); a longer run wastes
// fewer loads on the halo but holds more registers (about 4R + 10h floats
// live). R = 16 takes 80 registers at size 5 (each thread 44 loads in
// flight); R = 8 was 5% slower in f32 on an H100, R = 32 37-48% slower
// (flash_variants.py lrn_r8, lrn_r32). What bounds K2 now is latency, not
// bytes: it reaches 67% of the bytes bound in f32 on the one-axis grid
// (58% when the runs were the slowest grid axis) and is no faster in
// bf16, each thread's loads followed by a chain of log, exp and an IEEE
// divide a window position.
//
// Window widths. Both register kernels take the half-width h as a template
// argument, 0..kMaxHalf = 7 (local_size 1..15), so every register index is
// a constant. A wider window takes a runtime-window kernel, the first
// design of each (lrn_fwd_any_kernel, lrn_bwd_any_kernel): runs of 8
// channels, each window read again from memory. The shape picks the
// kernel; both are counted launches of the same C function.
//
// Math is f32 whatever the I/O type; float32 and bfloat16 are stored
// through the conversion intrinsics. The C functions return the launch's
// cudaGetLastError() so the ctypes wrapper can raise on a refused launch.

#include <climits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;   // positions per block (at most)
constexpr int kSmallRun = 8;    // K1's shortest run; the runtime windows
constexpr int kFwdWaves = 8;    // K1's least blocks an SM (pick_fwd)
constexpr int kRun = 16;        // channels per thread (K2)
constexpr int kMaxHalf = 7;     // the widest templated window half-width

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// This thread's element offset of (image, channel 0, position) and first
// channel c0, from the one-axis grid (run fastest, then position block,
// then image, in runs of `run` channels); false past the last position.
__device__ __forceinline__ bool locate(int C, int HW, int run, size_t& base,
                                       int& c0) {
  const unsigned runs = (C + run - 1) / run;
  const unsigned pos_blocks = (HW + blockDim.x - 1) / blockDim.x;
  const unsigned rest = blockIdx.x / runs;
  const int p = (rest % pos_blocks) * blockDim.x + threadIdx.x;
  if (p >= HW) return false;
  base = static_cast<size_t>(rest / pos_blocks) * C * HW + p;
  c0 = (blockIdx.x % runs) * run;
  return true;
}

// 0 + x_lo^2 + ... + x_hi^2 in ascending order, read from memory
template <typename T>
__device__ __forceinline__ float window_sq(const T* xn, int lo, int hi,
                                           int HW) {
  float s = 0.f;
  for (int j = lo; j <= hi; ++j) {
    const float v = load(xn + static_cast<size_t>(j) * HW);
    s = __fadd_rn(s, __fmul_rn(v, v));
  }
  return s;
}

template <typename T, int H, int R>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int C, int HW,
               float alpha_over_n, float beta, float k) {
  constexpr int NX = R + 2 * H;
  size_t base;
  int c0;
  if (!locate(C, HW, R, base, c0)) return;
  // xv[i], sq[i]: channel c0 - H + i
  float xv[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    const int c = c0 - H + i;
    xv[i] = (c >= 0 && c < C) ? load(x + base + static_cast<size_t>(c) * HW)
                              : 0.f;
  }
  float sq[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) sq[i] = __fmul_rn(xv[i], xv[i]);
  T* yn = y + base;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = c0 + i;
    if (c >= C) break;
    float s = 0.f;  // the window of channel c: sq[i .. i + 2H]
#pragma unroll
    for (int d = 0; d <= 2 * H; ++d) s = __fadd_rn(s, sq[i + d]);
    const float scale = __fadd_rn(k, __fmul_rn(s, alpha_over_n));
    store(yn + static_cast<size_t>(c) * HW,
          __fmul_rn(xv[i + H], expf(__fmul_rn(-beta, logf(scale)))));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_any_kernel(const T* __restrict__ x, T* __restrict__ y, int C,
                   int HW, int size, float alpha_over_n, float beta,
                   float k) {
  size_t base;
  int c0;
  if (!locate(C, HW, kSmallRun, base, c0)) return;
  const T* xn = x + base;
  T* yn = y + base;
  const int half = (size - 1) / 2;
#pragma unroll
  for (int i = 0; i < kSmallRun; ++i) {
    const int c = c0 + i;
    if (c >= C) break;
    const float s = window_sq(xn, max(c - half, 0), min(c + half, C - 1), HW);
    const float scale = __fadd_rn(k, __fmul_rn(s, alpha_over_n));
    const float xc = load(xn + static_cast<size_t>(c) * HW);
    store(yn + static_cast<size_t>(c) * HW,
          __fmul_rn(xc, expf(__fmul_rn(-beta, logf(scale)))));
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               T* __restrict__ dx, int C, int HW, float alpha_over_n,
               float beta, float k, float coef) {
  constexpr int R = kRun, NX = R + 4 * H, NJ = R + 2 * H;
  size_t base;
  int c0;
  if (!locate(C, HW, R, base, c0)) return;
  // xv[i]: channel c0 - 2H + i; dv[j], ratio[j]: channel c0 - H + j
  float xv[NX], dv[NJ];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    const int c = c0 - 2 * H + i;
    xv[i] = (c >= 0 && c < C) ? load(x + base + static_cast<size_t>(c) * HW)
                              : 0.f;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = c0 - H + j;
    dv[j] = (c >= 0 && c < C) ? load(dy + base + static_cast<size_t>(c) * HW)
                              : 0.f;
  }
  float sq[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) sq[i] = __fmul_rn(xv[i], xv[i]);
  float ratio[NJ], dy_inv[R];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = c0 - H + j;
    float s = 0.f;  // the window of channel c: xv[j .. j + 2H]
#pragma unroll
    for (int d = 0; d <= 2 * H; ++d) s = __fadd_rn(s, sq[j + d]);
    const float scale = __fadd_rn(k, __fmul_rn(s, alpha_over_n));
    const float inv = expf(__fmul_rn(-beta, logf(scale)));
    // past the edges the ratio is the plain version's zero padding
    ratio[j] = (c >= 0 && c < C)
                   ? __fdiv_rn(__fmul_rn(__fmul_rn(dv[j], xv[j + H]), inv),
                               scale)
                   : 0.f;
    if (j >= H && j < H + R) dy_inv[j - H] = __fmul_rn(dv[j], inv);
  }
  T* dxn = dx + base;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = c0 + i;
    if (c >= C) break;
    float acc = 0.f;  // the window of output c: ratio[i .. i + 2H]
#pragma unroll
    for (int d = 0; d <= 2 * H; ++d) acc = __fadd_rn(acc, ratio[i + d]);
    store(dxn + static_cast<size_t>(c) * HW,
          __fsub_rn(dy_inv[i], __fmul_rn(__fmul_rn(coef, xv[i + 2 * H]), acc)));
  }
}

// A thread takes kSmallRun channels and walks every window position of its
// run in ascending order, each position's scale from its window read again;
// a position's ratio joins the sums of the outputs whose window holds it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_any_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   T* __restrict__ dx, int C, int HW, int size,
                   float alpha_over_n, float beta, float k, float coef) {
  size_t base;
  int c0;
  if (!locate(C, HW, kSmallRun, base, c0)) return;
  const T* xn = x + base;
  const T* dyn = dy + base;
  T* dxn = dx + base;
  const int half = (size - 1) / 2;
  float acc[kSmallRun], dy_inv[kSmallRun], xc[kSmallRun];
#pragma unroll
  for (int i = 0; i < kSmallRun; ++i) {
    acc[i] = 0.f;
    dy_inv[i] = 0.f;
    xc[i] = 0.f;
  }
  const int j_lo = max(c0 - half, 0);
  const int j_hi = min(c0 + kSmallRun - 1 + half, C - 1);
  for (int j = j_lo; j <= j_hi; ++j) {
    const float s = window_sq(xn, max(j - half, 0), min(j + half, C - 1), HW);
    const float scale = __fadd_rn(k, __fmul_rn(s, alpha_over_n));
    const float inv = expf(__fmul_rn(-beta, logf(scale)));
    const float xj = load(xn + static_cast<size_t>(j) * HW);
    const float dyj = load(dyn + static_cast<size_t>(j) * HW);
    const float ratio = __fdiv_rn(__fmul_rn(__fmul_rn(dyj, xj), inv), scale);
#pragma unroll
    for (int i = 0; i < kSmallRun; ++i) {
      const int c = c0 + i;
      if (j >= c - half && j <= c + half) acc[i] = __fadd_rn(acc[i], ratio);
      if (j == c) {
        dy_inv[i] = __fmul_rn(dyj, inv);
        xc[i] = xj;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kSmallRun; ++i) {
    const int c = c0 + i;
    if (c >= C) break;
    store(dxn + static_cast<size_t>(c) * HW,
          __fsub_rn(dy_inv[i], __fmul_rn(__fmul_rn(coef, xc[i]), acc[i])));
  }
}

inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Blocks of the one-axis grid: images x channel runs x position blocks.
inline long long blocks(int N, int C, int HW, int run, int threads) {
  return static_cast<long long>(N) * ((C + run - 1) / run) *
         ((HW + threads - 1) / threads);
}

inline int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

// K1's run length and block width: the first of (32, 256), (16, 256),
// (8, 256), (8, 128) (channels a thread, positions a block) whose grid
// gives every SM kFwdWaves blocks, else the last. A longer run reads fewer
// halo channels twice; more blocks keep the SMs busy at serving's small
// batches.
struct FwdShape {
  int run, threads;
};

inline FwdShape pick_fwd(int N, int C, int HW) {
  const FwdShape order[] = {{32, kThreads},
                            {16, kThreads},
                            {kSmallRun, kThreads},
                            {kSmallRun, kThreads / 2}};
  for (const FwdShape& s : order)
    if (blocks(N, C, HW, s.run, s.threads) >=
        static_cast<long long>(kFwdWaves) * num_sms())
      return s;
  return order[3];
}

template <typename T, int H, int R>
int launch_fwd_h(const void* x, void* y, int C, int HW, unsigned nb,
                 int threads, float alpha_over_n, float beta, float k,
                 cudaStream_t st) {
  lrn_fwd_kernel<T, H, R><<<nb, threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(y), C, HW, alpha_over_n,
      beta, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int R>
int launch_fwd_r(int half, const void* x, void* y, int C, int HW,
                 unsigned nb, int threads, float alpha_over_n, float beta,
                 float k, cudaStream_t st) {
  switch (half) {
#define LRN_FWD_CASE(H) \
  case H:               \
    return launch_fwd_h<T, H, R>(x, y, C, HW, nb, threads, alpha_over_n, \
                                 beta, k, st);
    LRN_FWD_CASE(0) LRN_FWD_CASE(1) LRN_FWD_CASE(2) LRN_FWD_CASE(3)
    LRN_FWD_CASE(4) LRN_FWD_CASE(5) LRN_FWD_CASE(6) LRN_FWD_CASE(7)
#undef LRN_FWD_CASE
    default:
      return invalid();
  }
}

template <typename T>
int launch_fwd(const void* x, void* y, int N, int C, int HW, int size,
               float alpha_over_n, float beta, float k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int half = (size - 1) / 2;
  if (half > kMaxHalf) {  // K1's runtime window
    const long long nb = blocks(N, C, HW, kSmallRun, kThreads);
    if (nb > INT_MAX) return invalid();
    lrn_fwd_any_kernel<T><<<static_cast<unsigned>(nb), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(y), C, HW, size,
        alpha_over_n, beta, k);
    return static_cast<int>(cudaGetLastError());
  }
  const FwdShape s = pick_fwd(N, C, HW);
  const long long nb = blocks(N, C, HW, s.run, s.threads);
  if (nb > INT_MAX) return invalid();
  const unsigned grid = static_cast<unsigned>(nb);
  switch (s.run) {
    case 32:
      return launch_fwd_r<T, 32>(half, x, y, C, HW, grid, s.threads,
                                 alpha_over_n, beta, k, st);
    case 16:
      return launch_fwd_r<T, 16>(half, x, y, C, HW, grid, s.threads,
                                 alpha_over_n, beta, k, st);
    default:
      return launch_fwd_r<T, kSmallRun>(half, x, y, C, HW, grid, s.threads,
                                        alpha_over_n, beta, k, st);
  }
}

template <typename T, int H>
int launch_bwd_h(const void* x, const void* dy, void* dx, int C, int HW,
                 unsigned nb, float alpha_over_n, float beta, float k,
                 float coef, cudaStream_t st) {
  lrn_bwd_kernel<T, H><<<nb, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
      C, HW, alpha_over_n, beta, k, coef);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* dy, void* dx, int N, int C, int HW,
               int size, float alpha_over_n, float beta, float k, float coef,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int half = (size - 1) / 2;
  if (half > kMaxHalf) {  // K2's runtime window
    const long long nb = blocks(N, C, HW, kSmallRun, kThreads);
    if (nb > INT_MAX) return invalid();
    lrn_bwd_any_kernel<T><<<static_cast<unsigned>(nb), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy),
        static_cast<T*>(dx), C, HW, size, alpha_over_n, beta, k, coef);
    return static_cast<int>(cudaGetLastError());
  }
  const long long nb = blocks(N, C, HW, kRun, kThreads);
  if (nb > INT_MAX) return invalid();
  switch (half) {
#define LRN_BWD_CASE(H)                                                     \
  case H:                                                                   \
    return launch_bwd_h<T, H>(x, dy, dx, C, HW, static_cast<unsigned>(nb), \
                              alpha_over_n, beta, k, coef, st);
    LRN_BWD_CASE(0) LRN_BWD_CASE(1) LRN_BWD_CASE(2) LRN_BWD_CASE(3)
    LRN_BWD_CASE(4) LRN_BWD_CASE(5) LRN_BWD_CASE(6) LRN_BWD_CASE(7)
#undef LRN_BWD_CASE
    default:
      return invalid();
  }
}

}  // namespace

extern "C" int lrn_fwd_f32(const void* x, void* y, int N, int C, int HW,
                           int size, float alpha_over_n, float beta, float k,
                           void* stream) {
  return launch_fwd<float>(x, y, N, C, HW, size, alpha_over_n, beta, k,
                           stream);
}

extern "C" int lrn_fwd_bf16(const void* x, void* y, int N, int C, int HW,
                            int size, float alpha_over_n, float beta, float k,
                            void* stream) {
  return launch_fwd<__nv_bfloat16>(x, y, N, C, HW, size, alpha_over_n, beta,
                                   k, stream);
}

extern "C" int lrn_bwd_f32(const void* x, const void* dy, void* dx, int N,
                           int C, int HW, int size, float alpha_over_n,
                           float beta, float k, float coef, void* stream) {
  return launch_bwd<float>(x, dy, dx, N, C, HW, size, alpha_over_n, beta, k,
                           coef, stream);
}

extern "C" int lrn_bwd_bf16(const void* x, const void* dy, void* dx, int N,
                            int C, int HW, int size, float alpha_over_n,
                            float beta, float k, float coef, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, dy, dx, N, C, HW, size, alpha_over_n,
                                   beta, k, coef, stream);
}
