// Flash attention for Hopper (sm_90a): the forward (K3) and the two
// backward kernels, dQ (K4) and dK/dV (K5).
//
// K3 replaces the TPU kernel caffe_mpi_tpu/ops/flash_attention.py:
// _fwd_kernel (Pallas), K4 `_bwd_dq_kernel` and K5 `_bwd_dkv_kernel`. On
// (BH, S, D) tensors, with scale = 1/sqrt(D), an optional f32 key bias b
// (Sk,) and the mask M (key column < sk_valid, and row >= column when
// causal):
//
//   K3:  s = (q . k) * scale + b,  masked to -inf outside M
//        O = softmax(s) V, lse = log sum exp(s), by an online softmax over
//        key tiles; a row with no unmasked key gives O = 0 and
//        lse = log(1e-30) (l clamped to 1e-30, m taken as 0), with no NaN.
//   K4:  P = exp(s - lse) on M (0 elsewhere), dP = dO . V^T,
//        dS = P * (dP - delta), dQ = scale * dS K
//   K5:  the same P and dS with the causal mask only (NO sk_valid mask: a
//        padded query row carries dO = 0, and padded key rows are sliced
//        off by the caller, as in the TPU kernel), dV = P^T dO,
//        dK = scale * dS^T Q
//
// delta = rowsum(dO * O) in f32 comes from the caller (torch ops). Blocks
// are read as f32 whatever the I/O type (float32 or bfloat16); O, dQ, dK,
// dV are stored in the input type, lse in f32.
//
// What bounds them on this card: at the training path's shape (BH = 32,
// S = 64, D = 32) each kernel does well under a microsecond of work, so a
// launch sets its time. At long sequences they are bound by operations
// (4, 6 and 8 BH*Sq*Sk*D flops over the unmasked pairs for K3, K4, K5,
// against a few bytes per row), which this first design does in f32 FMA
// on the CUDA cores, not on the tensor cores (no wgmma, no TMA; a later
// PR's work).
//
// Design. The TPU kernels hold a 128-row Q tile and all of K and V in
// VMEM and loop over 128-wide key tiles inside one grid step. Here a block
// of 256 threads owns a 64-row tile: of queries for K3 and K4, of keys for
// K5, and loops over the other side's 64-row tiles, staging them in shared
// memory as f32 (row stride D|1, odd, so that neighbouring threads reading
// neighbouring rows hit different banks). Thread (ty, tx), ty and tx in
// 0..15, computes the 4 x 4 scores of rows ty + 16i and columns tx + 16j,
// so a row of the score tile lies in one half-warp and its max and sum are
// taken with four xor shuffles. The probabilities go through shared memory
// to the product with V (or, in the backward, K, Q and dO); each thread
// accumulates rows ty + 16i, columns tx + 16c of its output in registers,
// c < ceil(D/16) (a template parameter: D up to 128). K4 and K5 are
// separate kernels, as in the JAX package, so no block writes another's
// rows: no atomics, and the results are deterministic.
//
// Tile skip, derived for 64-row tiles: causal K3/K4 visit the key tiles
// that hold a column <= the tile's last row, and never the tiles past
// sk_valid; causal K5 starts at the query tile holding its first key. A
// skipped tile is fully masked, so skipping it changes nothing.
//
// The online softmax keeps m = -inf until a row meets an unmasked score,
// and exponentiates against m_use = (m == -inf ? 0 : m), so no -inf - -inf
// is ever formed; a masked score is -inf and gives exp(-inf) = 0.
// Score, scale and bias are rounded as the plain version rounds them
// (q.k summed in f32, then times scale, then plus the bias); no fast-math.
//
// The C functions return the launch's cudaGetLastError() (or the error of
// setting the kernel's shared-memory size) so the ctypes wrapper can raise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTile = 64;         // rows of a query or key tile
constexpr int kThreads = 256;     // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kPLD = kTile + 1;   // row stride of a score tile in smem

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Rows [r0, r0 + kTile) of a (n, D) matrix into shared memory as f32 with
// row stride ld; rows at or past n are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int n,
                                      int D, int ld) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[r * ld + c] =
        (r0 + r < n) ? load(src + static_cast<size_t>(r0 + r) * D + c) : 0.f;
  }
}

// Max and sum over the 16 threads of a half-warp (one score row).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Key tiles a query tile visits: those below sk_valid and, when causal,
// those holding a column <= the tile's last row.
__device__ __forceinline__ int key_tiles(int q0, int Sq, int sk_valid,
                                         int causal) {
  const int n_k = (sk_valid + kTile - 1) / kTile;
  if (!causal) return n_k;
  return min(n_k, (min(q0 + kTile, Sq) - 1) / kTile + 1);
}

// The scaled, biased score; the caller masks it.
__device__ __forceinline__ float score(float dot, float scale,
                                       const float* bias, int col, int Sk) {
  float v = __fmul_rn(dot, scale);
  if (bias != nullptr && col < Sk) v = __fadd_rn(v, bias[col]);
  return v;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk,
                 int D, int sk_valid, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = D | 1;
  float* sQ = smem;
  float* sK = sQ + kTile * ld;
  float* sV = sK + kTile * ld;
  float* sP = sV + kTile * ld;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const T* kb = k + static_cast<size_t>(bh) * Sk * D;
  const T* vb = v + static_cast<size_t>(bh) * Sk * D;
  stage(sQ, q + static_cast<size_t>(bh) * Sq * D, q0, Sq, D, ld);

  float acc[4][NC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int n_iter = key_tiles(q0, Sq, sk_valid, causal);
  for (int j = 0; j < n_iter; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    stage(sK, kb, k0, Sk, D, ld);
    stage(sV, vb, k0, Sk, D, ld);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = sK[(tx + 16 * jj) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float tmax = neg_inf();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = k0 + tx + 16 * jj;
        const bool ok = col < sk_valid && (!causal || row >= col);
        s[i][jj] = ok ? score(s[i][jj], scale, bias, col, Sk) : neg_inf();
        tmax = fmaxf(tmax, s[i][jj]);
      }
      tmax = row_max(tmax);
      const float m_new = fmaxf(m[i], tmax);
      const float m_use = (m_new == neg_inf()) ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);  // 0 while m[i] is -inf
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_use);  // masked: exp(-inf) = 0
        sP[(ty + 16 * i) * kPLD + tx + 16 * jj] = p;
        rs = __fadd_rn(rs, p);
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), row_sum(rs));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
    }
    __syncthreads();
    const int kn = min(kTile, Sk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * kPLD + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float vv = sV[kk * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }
  const size_t base = static_cast<size_t>(bh) * Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D)
        store(o + (base + row) * D + col, __fdiv_rn(acc[i][c], l_safe));
    }
    if (tx == 0) {
      const float m_use = (m[i] == neg_inf()) ? 0.f : m[i];
      lse[base + row] = __fadd_rn(m_use, logf(l_safe));
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias, T* __restrict__ dq,
                    int Sq, int Sk, int D, int sk_valid, int causal,
                    float scale) {
  extern __shared__ float smem[];
  const int ld = D | 1;
  float* sQ = smem;
  float* sdO = sQ + kTile * ld;
  float* sK = sdO + kTile * ld;
  float* sV = sK + kTile * ld;
  float* sS = sV + kTile * ld;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * Sq;
  const T* kb = k + static_cast<size_t>(bh) * Sk * D;
  const T* vb = v + static_cast<size_t>(bh) * Sk * D;
  stage(sQ, q + base * D, q0, Sq, D, ld);
  stage(sdO, dout + base * D, q0, Sq, D, ld);
  float lr[4], dr[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lr[i] = row < Sq ? lse[base + row] : 0.f;
    dr[i] = row < Sq ? delta[base + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int n_iter = key_tiles(q0, Sq, sk_valid, causal);
  for (int j = 0; j < n_iter; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    stage(sK, kb, k0, Sk, D, ld);
    stage(sV, vb, k0, Sk, D, ld);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty + 16 * i) * ld + d];
        dov[i] = sdO[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        kv[jj] = sK[(tx + 16 * jj) * ld + d];
        vv[jj] = sV[(tx + 16 * jj) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
          dp[i][jj] = fmaf(dov[i], vv[jj], dp[i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = k0 + tx + 16 * jj;
        const bool ok = col < sk_valid && (!causal || row >= col);
        // a padded column's p = exp(0 - lse) can overflow: never formed
        const float p =
            ok ? expf(score(s[i][jj], scale, bias, col, Sk) - lr[i]) : 0.f;
        sS[(ty + 16 * i) * kPLD + tx + 16 * jj] =
            __fmul_rn(p, __fsub_rn(dp[i][jj], dr[i]));
      }
    }
    __syncthreads();
    const int kn = min(kTile, Sk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sS[(ty + 16 * i) * kPLD + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float kv = sK[kk * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) store(dq + (base + row) * D + col, __fmul_rn(acc[i][c], scale));
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int D, int causal,
                     float scale) {
  extern __shared__ float smem[];
  const int ld = D | 1;
  float* sK = smem;
  float* sV = sK + kTile * ld;
  float* sQ = sV + kTile * ld;
  float* sdO = sQ + kTile * ld;
  float* sP = sdO + kTile * ld;
  float* sS = sP + kTile * kPLD;
  float* sL = sS + kTile * kPLD;
  float* sD = sL + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const size_t qbase = static_cast<size_t>(bh) * Sq;
  const size_t kbase = static_cast<size_t>(bh) * Sk;
  stage(sK, k + kbase * D, k0, Sk, D, ld);
  stage(sV, v + kbase * D, k0, Sk, D, ld);
  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.f;
  const int n_q = (Sq + kTile - 1) / kTile;
  // causal: query tiles before the one holding this tile's first key are
  // fully masked
  const int start = causal ? k0 / kTile : 0;
  for (int t = start; t < n_q; ++t) {
    const int q0 = t * kTile;
    __syncthreads();
    stage(sQ, q + qbase * D, q0, Sq, D, ld);
    stage(sdO, dout + qbase * D, q0, Sq, D, ld);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      sL[r] = q0 + r < Sq ? lse[qbase + q0 + r] : 0.f;
      sD[r] = q0 + r < Sq ? delta[qbase + q0 + r] : 0.f;
    }
    __syncthreads();
    // rows: keys ty + 16i; columns: queries tx + 16jj
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(ty + 16 * i) * ld + d];
        vv[i] = sV[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        qv[jj] = sQ[(tx + 16 * jj) * ld + d];
        dov[jj] = sdO[(tx + 16 * jj) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(qv[jj], kv[i], s[i][jj]);
          dp[i][jj] = fmaf(dov[jj], vv[i], dp[i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = k0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qc = tx + 16 * jj;
        const bool ok = q0 + qc < Sq && (!causal || q0 + qc >= kr);
        const float p =
            ok ? expf(score(s[i][jj], scale, bias, kr, Sk) - sL[qc]) : 0.f;
        sP[(ty + 16 * i) * kPLD + qc] = p;
        sS[(ty + 16 * i) * kPLD + qc] = __fmul_rn(p, __fsub_rn(dp[i][jj], sD[qc]));
      }
    }
    __syncthreads();
    const int qn = min(kTile, Sq - q0);
    for (int qq = 0; qq < qn; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[(ty + 16 * i) * kPLD + qq];
        dsv[i] = sS[(ty + 16 * i) * kPLD + qq];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float dov = sdO[qq * ld + col];
          const float qv = sQ[qq * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[i][c] = fmaf(pv[i], dov, dva[i][c]);
            dka[i][c] = fmaf(dsv[i], qv, dka[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        store(dk + (kbase + kr) * D + col, __fmul_rn(dka[i][c], scale));
        store(dv + (kbase + kr) * D + col, dva[i][c]);
      }
    }
  }
}

// Shared memory of each kernel, in floats.
inline size_t fwd_smem(int D) {
  return (3 * kTile * (D | 1) + kTile * kPLD) * sizeof(float);
}
inline size_t dq_smem(int D) {
  return (4 * kTile * (D | 1) + kTile * kPLD) * sizeof(float);
}
inline size_t dkv_smem(int D) {
  return (4 * kTile * (D | 1) + 2 * kTile * kPLD + 2 * kTile) * sizeof(float);
}

template <typename K>
int prepare(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T, int NC>
int fwd_nc(const void* q, const void* k, const void* v, const float* bias,
           void* o, float* lse, int BH, int Sq, int Sk, int D, int sk_valid,
           int causal, float scale, cudaStream_t st) {
  const size_t bytes = fwd_smem(D);
  auto kern = flash_fwd_kernel<T, NC>;
  if (int e = prepare(kern, bytes)) return e;
  dim3 grid((Sq + kTile - 1) / kTile, BH);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), lse, Sq, Sk, D,
      sk_valid, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NC>
int dq_nc(const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* delta, const float* bias, void* dq,
          int BH, int Sq, int Sk, int D, int sk_valid, int causal,
          float scale, cudaStream_t st) {
  const size_t bytes = dq_smem(D);
  auto kern = flash_bwd_dq_kernel<T, NC>;
  if (int e = prepare(kern, bytes)) return e;
  dim3 grid((Sq + kTile - 1) / kTile, BH);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, bias,
      static_cast<T*>(dq), Sq, Sk, D, sk_valid, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NC>
int dkv_nc(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const float* bias, void* dk,
           void* dv, int BH, int Sq, int Sk, int D, int causal, float scale,
           cudaStream_t st) {
  const size_t bytes = dkv_smem(D);
  auto kern = flash_bwd_dkv_kernel<T, NC>;
  if (int e = prepare(kern, bytes)) return e;
  dim3 grid((Sk + kTile - 1) / kTile, BH);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, bias,
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// Head dims up to 128, in four register widths; the wrapper raises beyond.
#define FLASH_DISPATCH(FN, T, ...)                                    \
  if (D < 1 || D > 128) return static_cast<int>(cudaErrorInvalidValue); \
  if (D <= 16) return FN<T, 1>(__VA_ARGS__);                          \
  if (D <= 32) return FN<T, 2>(__VA_ARGS__);                          \
  if (D <= 64) return FN<T, 4>(__VA_ARGS__);                          \
  return FN<T, 8>(__VA_ARGS__);

template <typename T>
int fwd(const void* q, const void* k, const void* v, const float* bias,
        void* o, float* lse, int BH, int Sq, int Sk, int D, int sk_valid,
        int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(fwd_nc, T, q, k, v, bias, o, lse, BH, Sq, Sk, D, sk_valid,
                 causal, scale, st)
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const float* bias, void* dq,
           int BH, int Sq, int Sk, int D, int sk_valid, int causal,
           float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dq_nc, T, q, k, v, dout, lse, delta, bias, dq, BH, Sq, Sk, D,
                 sk_valid, causal, scale, st)
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, const float* bias, void* dk,
            void* dv, int BH, int Sq, int Sk, int D, int causal, float scale,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dkv_nc, T, q, k, v, dout, lse, delta, bias, dk, dv, BH, Sq,
                 Sk, D, causal, scale, st)
}

}  // namespace

extern "C" {

int flash_fwd_f32(const void* q, const void* k, const void* v,
                  const float* bias, void* o, float* lse, int BH, int Sq,
                  int Sk, int D, int sk_valid, int causal, float scale,
                  void* stream) {
  return fwd<float>(q, k, v, bias, o, lse, BH, Sq, Sk, D, sk_valid, causal,
                    scale, stream);
}

int flash_fwd_bf16(const void* q, const void* k, const void* v,
                   const float* bias, void* o, float* lse, int BH, int Sq,
                   int Sk, int D, int sk_valid, int causal, float scale,
                   void* stream) {
  return fwd<__nv_bfloat16>(q, k, v, bias, o, lse, BH, Sq, Sk, D, sk_valid,
                            causal, scale, stream);
}

int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const float* bias, void* dq, int BH, int Sq, int Sk,
                     int D, int sk_valid, int causal, float scale,
                     void* stream) {
  return bwd_dq<float>(q, k, v, dout, lse, delta, bias, dq, BH, Sq, Sk, D,
                       sk_valid, causal, scale, stream);
}

int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* bias, void* dq, int BH, int Sq, int Sk,
                      int D, int sk_valid, int causal, float scale,
                      void* stream) {
  return bwd_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, bias, dq, BH, Sq,
                               Sk, D, sk_valid, causal, scale, stream);
}

int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* bias, void* dk, void* dv, int BH, int Sq,
                      int Sk, int D, int causal, float scale, void* stream) {
  return bwd_dkv<float>(q, k, v, dout, lse, delta, bias, dk, dv, BH, Sq, Sk,
                        D, causal, scale, stream);
}

int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const float* bias, void* dk, void* dv, int BH, int Sq,
                       int Sk, int D, int causal, float scale, void* stream) {
  return bwd_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, bias, dk, dv, BH,
                                Sq, Sk, D, causal, scale, stream);
}

}  // extern "C"
