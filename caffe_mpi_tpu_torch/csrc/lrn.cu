// Across-channel LRN forward for Hopper (sm_90a).
//
// Replaces the TPU kernel caffe_mpi_tpu/ops/lrn.py:_fwd_kernel (Pallas),
// which computes, for x viewed as (N, C, H*W):
//
//     s_c = k + (alpha/n) * sum_{j = c-half .. c+half, 0 <= j < C} x_j^2
//     y_c = x_c * exp(-beta * log(s_c))
//
// What bounds it on this card: bytes. It does ~n+6 flops per element and
// must read x once and write y once, 2*N*C*H*W*itemsize bytes, so the
// least time is those bytes over the memory rate (about 7 us for AlexNet's
// norm1 at batch 10 in f32). The TPU kernel held a (1, C, 128) tile of all
// channels in VMEM; none of that tiling carries over. Here a thread owns
// one spatial position of one image and a run of kChannels channels of it:
// the grid is (positions / 256, images, channels / kChannels). Neighbouring
// threads take neighbouring positions, so every load and store of a warp
// is one contiguous run of addresses. A thread reads its channels and the
// half-window on each side once from device memory; the n-1 other reads of
// each window hit L1, and the halo shared with the next run of channels
// mostly L2. Cutting the channels into runs is what keeps enough loads in
// flight: with one thread walking all C channels (96 or 256 in AlexNet)
// only 30,720 threads (norm1, batch 10) each had one load at a time
// outstanding, and that kernel ran at a tenth of an H100 SXM's memory
// rate (PERF.md).
// The window sum is taken afresh per channel (no running add/subtract
// sum, whose cancellation would drift from the plain version), in the
// plain version's order, with rounded multiplies and adds so that the
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
