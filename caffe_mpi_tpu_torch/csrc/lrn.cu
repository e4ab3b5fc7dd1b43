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
// image and a run of kChannels channels of it: the grid is (positions /
// 256, images, channels / kChannels). Neighbouring threads take
// neighbouring positions, so every load and store of a warp is one
// contiguous run of addresses. A thread reads its channels and the halo on
// each side from device memory; the other reads of each window hit L1, and
// the halo shared with the next run of channels mostly L2. Cutting the
// channels into runs is what keeps enough loads in flight: with one thread
// walking all C channels (96 or 256 in AlexNet) only 30,720 threads (norm1,
// batch 10) each had one load at a time outstanding, and that kernel ran at
// a tenth of an H100 SXM's memory rate (PERF.md).
// K2 walks the run's window positions j = c0-half .. c0+kChannels-1+half in
// ascending order, forms ratio_j once, and adds it into a register
// accumulator of every output channel whose window holds j: each output's
// window sum is thus taken in the plain version's order, and each ratio is
// computed once, not once per output that reads it.
// Window sums are taken afresh per channel (no running add/subtract sum,
// whose cancellation would drift from the plain version), in the plain
// version's order, with rounded multiplies, adds and divides so that the
// compiler fuses nothing the plain version does not.
//
// Math is f32 whatever the I/O type; float32 and bfloat16 are stored
// through the conversion intrinsics. The C functions return the launch's
// cudaGetLastError() so the ctypes wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;   // positions per block
constexpr int kChannels = 8;    // channels per thread

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

// Window sum of x^2 over [lo, hi] in ascending order, as K1 takes it.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               T* __restrict__ dx, int C, int HW, int size,
               float alpha_over_n, float beta, float k, float coef) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * C * HW + p;
  const T* xn = x + base;
  const T* dyn = dy + base;
  T* dxn = dx + base;
  const int half = (size - 1) / 2;
  const int c0 = blockIdx.z * kChannels;
  float acc[kChannels], dy_inv[kChannels], xc[kChannels];
#pragma unroll
  for (int i = 0; i < kChannels; ++i) {
    acc[i] = 0.f;
    dy_inv[i] = 0.f;
    xc[i] = 0.f;
  }
  const int j_lo = max(c0 - half, 0);
  const int j_hi = min(c0 + kChannels - 1 + half, C - 1);
  for (int j = j_lo; j <= j_hi; ++j) {
    const float s = window_sq(xn, max(j - half, 0), min(j + half, C - 1), HW);
    const float scale = __fadd_rn(k, __fmul_rn(s, alpha_over_n));
    const float inv = expf(__fmul_rn(-beta, logf(scale)));
    const float xj = load(xn + static_cast<size_t>(j) * HW);
    const float dyj = load(dyn + static_cast<size_t>(j) * HW);
    const float ratio = __fdiv_rn(__fmul_rn(__fmul_rn(dyj, xj), inv), scale);
#pragma unroll
    for (int i = 0; i < kChannels; ++i) {
      const int c = c0 + i;
      if (j >= c - half && j <= c + half) acc[i] = __fadd_rn(acc[i], ratio);
      if (j == c) {
        dy_inv[i] = __fmul_rn(dyj, inv);
        xc[i] = xj;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kChannels; ++i) {
    const int c = c0 + i;
    if (c >= C) break;
    store(dxn + static_cast<size_t>(c) * HW,
          __fsub_rn(dy_inv[i], __fmul_rn(__fmul_rn(coef, xc[i]), acc[i])));
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

template <typename T>
int launch_bwd(const void* x, const void* dy, void* dx, int N, int C, int HW,
               int size, float alpha_over_n, float beta, float k, float coef,
               void* stream) {
  dim3 grid((HW + kThreads - 1) / kThreads, N,
            (C + kChannels - 1) / kChannels);
  lrn_bwd_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
      C, HW, size, alpha_over_n, beta, k, coef);
  return static_cast<int>(cudaGetLastError());
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
