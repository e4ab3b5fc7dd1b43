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
// so the least time is those bytes over the memory rate (K1: about 7 us for
// norm1 at batch 10 in f32; K2: about 266 us for norm1 at batch 256).
// The TPU kernels held a (1, C, 128) tile of all channels in VMEM; none of
// that tiling carries over. Here a thread owns one spatial position of one
// image and a run of channels of it (K1: kChannels = 8): the grid is
// (positions / 256, images, channels / run). Neighbouring threads take
// neighbouring positions, so every load and store of a warp is one
// contiguous run of addresses. A thread reads its channels and the halo on
// each side from device memory; the other reads of each window hit L1, and
// the halo shared with the next run of channels mostly L2. Cutting the
// channels into runs is what keeps enough loads in flight: with one thread
// walking all C channels (96 or 256 in AlexNet) only 30,720 threads (norm1,
// batch 10) each had one load at a time outstanding, and that kernel ran at
// a tenth of an H100 SXM's memory rate (PERF.md).
//
// K2 (second design). Its bound is the same bytes: x and dy read
// once, dx written once (266.3 us at norm1, batch 256, f32, at 3.35 TB/s).
// The first design re-read 5 values of x for each of a run's 12 window
// positions (about 84 loads of x and dy for 8 outputs), so the load pipe
// and L1, not device memory, set its pace (a quarter of the memory rate).
// Now a thread loads each element of x and dy it needs from device memory
// once, into registers: x over channels [c0 - 2h, c0 + R - 1 + 2h] and dy
// over [c0 - h, c0 + R - 1 + h] (h = (size - 1) / 2, zeros past the
// edges), all loads issued before any math, so each thread keeps 2R + 6h
// loads in flight. It forms the squares once, each window position's scale
// and ratio once, and each output's window sums from those registers in
// ascending order, as K1 and the plain version take them: no running
// add/subtract sum, so K2 stays equal to its plain version. The run length
// R = kRun = 16 channels: a run costs 2R + 6h loads against the ideal 2R
// (44 for 32 at size 5); a longer run wastes fewer loads on the halo but
// holds more registers (about 4R + 10h floats live). R = 16 takes 106
// registers at size 5 (16 warps an SM, each thread 44 loads in flight);
// R = 8 (64 registers) was 5% slower in f32 on an H100, R = 32 (138-196)
// 37-48% slower (flash_variants.py lrn_r8, lrn_r32). What bounds K2 now is
// latency, not bytes: it reaches 58% of the bytes bound in f32 and is no
// faster in bf16, each thread's loads followed by a chain of log, exp and
// an IEEE divide a window position. The window is a template argument (h = 0..7, local_size
// 1..15; the wrapper raises beyond), so every register index is a
// constant.
//
// Math is f32 whatever the I/O type; float32 and bfloat16 are stored
// through the conversion intrinsics. The C functions return the launch's
// cudaGetLastError() so the ctypes wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;   // positions per block
constexpr int kChannels = 8;    // channels per thread (K1)
constexpr int kRun = 16;        // channels per thread (K2)

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int C, int HW,
               int size, float alpha_over_n, float beta, float k) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * C * HW + p;
  const T* xn = x + base;
  T* yn = y + base;
  const int half = (size - 1) / 2;
  const int c0 = blockIdx.z * kChannels;
#pragma unroll
  for (int i = 0; i < kChannels; ++i) {
    const int c = c0 + i;
    if (c >= C) break;
    const int lo = max(c - half, 0);
    const int hi = min(c + half, C - 1);
    float s = 0.f;
    for (int j = lo; j <= hi; ++j) {
      const float v = load(xn + static_cast<size_t>(j) * HW);
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
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
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * C * HW + p;
  const int c0 = blockIdx.z * R;
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

template <typename T>
int launch(const void* x, void* y, int N, int C, int HW, int size,
           float alpha_over_n, float beta, float k, void* stream) {
  dim3 grid((HW + kThreads - 1) / kThreads, N,
            (C + kChannels - 1) / kChannels);
  lrn_fwd_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), C, HW, size,
      alpha_over_n, beta, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int H>
int launch_bwd_h(const void* x, const void* dy, void* dx, int N, int C,
                 int HW, float alpha_over_n, float beta, float k, float coef,
                 cudaStream_t st) {
  dim3 grid((HW + kThreads - 1) / kThreads, N, (C + kRun - 1) / kRun);
  lrn_bwd_kernel<T, H><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
      C, HW, alpha_over_n, beta, k, coef);
  return static_cast<int>(cudaGetLastError());
}

// Window half-widths 0..7 (local_size 1..15) as template arguments; the
// wrapper raises beyond.
template <typename T>
int launch_bwd(const void* x, const void* dy, void* dx, int N, int C, int HW,
               int size, float alpha_over_n, float beta, float k, float coef,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((size - 1) / 2) {
#define LRN_BWD_CASE(H) \
  case H:               \
    return launch_bwd_h<T, H>(x, dy, dx, N, C, HW, alpha_over_n, beta, k, \
                              coef, st);
    LRN_BWD_CASE(0) LRN_BWD_CASE(1) LRN_BWD_CASE(2) LRN_BWD_CASE(3)
    LRN_BWD_CASE(4) LRN_BWD_CASE(5) LRN_BWD_CASE(6) LRN_BWD_CASE(7)
#undef LRN_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int lrn_fwd_f32(const void* x, void* y, int N, int C, int HW,
                           int size, float alpha_over_n, float beta, float k,
                           void* stream) {
  return launch<float>(x, y, N, C, HW, size, alpha_over_n, beta, k, stream);
}

extern "C" int lrn_fwd_bf16(const void* x, void* y, int N, int C, int HW,
                            int size, float alpha_over_n, float beta, float k,
                            void* stream) {
  return launch<__nv_bfloat16>(x, y, N, C, HW, size, alpha_over_n, beta, k,
                               stream);
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
