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
// delta = rowsum(dO * O) in f32 comes from the caller (torch ops). O, dQ,
// dK, dV are stored in the input type (float32 or bfloat16), lse in f32.
// The C functions return the launch's cudaGetLastError() (or the error of
// setting the kernel's shared-memory size) so the ctypes wrapper can raise.
//
// K3 (second design, on the tensor cores). What bounds it: at S >=
// 1024 operations (4 x D flops an unmasked pair: 34.4 GFLOP at (BH 32, S
// 2048, D 128) causal), so both products must run on the tensor cores (the
// first design's f32 FMA on the CUDA cores ran 28x slower than cuDNN in
// bf16 there); at the training path's shape (32, 64, 32) launch and one
// warp's serial chain. The design is K4's machinery (below):
// - S = Q K^T and O += P V are mma.sync: 3xTF32 for f32 inputs, bf16 Q K^T
//   as it is, and P, an f32 C fragment, split into bf16 hi and lo parts
//   against bf16 V, so P is never rounded to bf16 once.
// - The online softmax runs on the C fragments in registers: a lane holds
//   rows g and g + 8, columns 2t and 2t + 1 of each 8-wide tile, so a
//   row's max and sum take two xor shuffles over the four lanes of g; P
//   goes from accumulator to A operand without shared memory.
// - Each key tile's P V goes into a zeroed fragment and O = O alpha +
//   tile, an f32 multiply and add rounded to nearest: the tensor cores'
//   truncating accumulation never sums more than one tile.
// - A warp owns 16 query rows, a block W of them (pick_warps: the largest
//   of 8, 4, 2, 1 whose grid gives every SM a block; W is a launch
//   argument, so K3 has 18 instantiations). At W = 1 (the path's 128 row
//   groups for 132 SMs) two warps share a row group, each takes half of
//   every key tile with its own (m, l, O), and the two states are merged
//   through shared memory in a fixed order, rescaled to their common max:
//   no atomics, deterministic.
// - Q is copied once to shared memory and read as fragments at each
//   k-step; K, V and the key bias come in tiles of BN x SPLIT keys (BN 64,
//   or 32 a warp when split), double-buffered with cp.async
//   (zero fill past D and Sk). bf16 fragments are read with ldmatrix: x4
//   for Q and K, x4.trans for V as the B operand of P V; f32 ones as
//   values, which the 3xTF32 split needs.
// - The forward's contract is the first design's: masks (causal,
//   sk_valid, the f32 key bias), causal tile skips, no tile past
//   sk_valid, a warp with nothing unmasked in a tile skips it; m stays
//   -inf until a row meets an unmasked score and exponents are taken
//   against m_use = (m == -inf ? 0 : m), so no -inf - -inf is formed; a
//   fully masked row gives O = 0 and lse = log(1e-30).
// Shared memory a block (bytes): (16 W + 4 BN SPLIT) x (DK + 4) x 4 in f32,
// x (DK + 8) x 2 in bf16, plus 8 BN SPLIT of key bias; at D 128, W 8:
// 203,264 (f32: one block an SM) and 104,960 (bf16). Registers (nvcc
// -Xptxas -v): at D 128 with one warp a row group 179 (f32) and 128 (bf16,
// 24 bytes spilled), no spills in the other 16 instantiations.
//
// K4 and K5 (second design, on the tensor cores). What bounds them: at
// the training path's shape (BH 32, S 64, D 32) a kernel moves under half
// a microsecond of bytes, so launch and the serial chain of one warp set
// its time, and the warps in flight matter most; at S >= 1024 operations
// bound them (6 and 8 x D flops an unmasked pair), and the products must
// run on the tensor cores. The design:
// - Every product is mma.sync. f32 inputs: m16n8k8 TF32 in the 3xTF32
//   split — the scheme of PyTorch's own f32 attention
//   (OpMultiplyAddFastF32), f32-level error: big = x with its low 13
//   mantissa bits cleared (exact), small = x - big rounded to nearest TF32
//   (cvt.rna's rounding, as an integer add and mask: both are TF32 values,
//   so the tensor cores, which truncate, take them as they are), acc +=
//   small.big' + big.small' + big.big' in f32. bf16 inputs: m16n8k16 with
//   f32 accumulators; Q K^T and dO V^T multiply bf16 as they are (exact
//   products); an f32 operand (P or dS) meeting a bf16 one is split into
//   two bf16 parts, hi = bf16(x), lo = bf16(x - hi), two products, so P is
//   never rounded to bf16.
// - The tensor cores' accumulation rounds toward zero. Summed into one
//   register over 2048 keys or queries, that bias put f32 dK and dV 2.5-3x
//   past FLASH_TOL, and dQ near it (flash_variants.py one_sum); so in f32
//   each tile's products of dS,
//   P^T or dS^T go into a zeroed fragment, added to dQ, dK or dV once by
//   an f32 add, rounded to nearest.
// - A block owns 16 W rows (W = 8, 4, 2 or 1 row groups of 16): queries
//   for K4, keys for K5. It walks the other side's tiles, copying tile
//   j + 1 with cp.async (16 bytes a thread where the row's bytes and the
//   pointers allow, 8 or 4 else, single elements for a bf16 row of odd
//   width) into the second of two buffers while tile j multiplies. A warp
//   takes BN rows of a tile: 64, or 32 from DK 64 up (registers and shared
//   memory) and in split row groups. The launcher takes the largest W
//   whose grid still gives every SM a block; at W = 1 (a small grid, as
//   the path's 128 blocks) two warps share a row group and split each
//   tile, then add their partial sums through shared memory in a fixed
//   order.
// - Shared tiles hold the input type, rows of DK (the head dim padded to
//   16, 24 (f32 only), 32, 64 or 128: a multiple of the mma's k) at a
//   stride 4 words past a multiple of 8, so a fragment load touches 32
//   banks. The copies write whole DK-wide rows: columns past D and rows
//   past the length come from cp.async's zero fill, so D 20 and S 100 read
//   zeros and no pass zeroes the tiles first.
// - Operands stay in registers: K4 computes S and dP for its 16 rows as C
//   fragments, forms dS there and feeds it as the A operand of dQ += dS K.
//   K5 computes S^T = K Q^T and dP^T = V dO^T with keys as rows, so P^T and
//   dS^T are C fragments that feed dV += P^T dO and dK += dS^T Q. No score
//   tile passes through shared memory. For f32, a C fragment's columns
//   (2t, 2t+1) serve as the A fragment's k positions (t, t+4), and the B
//   operand's rows are read in the same order (a sum over k in any order);
//   for bf16 two C tiles are an A fragment as they stand.
// - Masks come from the C fragment's (row, column), lane = 4g + t: rows g
//   and g + 8 of the warp's 16, columns 2t and 2t + 1 of each 8-wide tile.
//   K4 never forms exp(0 - lse) at a padded column; K5 masks a query past
//   Sq whatever its lse.
// - Tile skip: causal K4 visits the key tiles holding a column <= the
//   block's last row; causal K5 starts at the query tile holding its first
//   key. Inside a visited tile, a warp whose rows are all masked skips its
//   products (a branch around the whole product: branches inside the
//   unrolled loops cost more than they saved).
// - Separate kernels, each block writing its own rows: no atomics, and the
//   results are deterministic.
// Shared memory a block (bytes): (32 W + 4 BN SPLIT) x (DK + 4) x 4 for
// f32, x (DK + 8) x 2 for bf16, plus 8 BN SPLIT (K4's key bias) or 16 BN
// SPLIT (K5's lse and delta); at D 128, W 8: 203,008 (K4) and 203,264
// (K5) in f32, 104,704 and 104,960 in bf16 — one block of 8 warps an SM
// in f32. Registers (nvcc -Xptxas -v) at D 128, W 8: K4 173 (f32) and 130
// (bf16), K5 255 and 236, no spills; 5 of the 72 instantiations (none
// with 8 row groups) spill 4-24 bytes.
//
// Scores are rounded as the plain version rounds them (the dot product,
// then times scale, then plus the bias); no fast-math.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// Tensor-core products (mma.sync) and cp.async staging, shared by K3-K5.

// cp.async of `vec` bytes (16, 8 or 4) from global to shared memory; a
// copy that is not `live` reads nothing and writes zeros (zero fill).
__device__ __forceinline__ void cp_async(void* dst, const void* src, int vec,
                                         bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = live ? vec : 0;
  if (vec == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n) : "memory");
  else if (vec == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + rows) of a (n, D) matrix into shared memory, row stride
// ld, each row written out to DK columns: columns D..DK and rows at or
// past n land as zeros (cp.async's zero fill), so the mma's padded k reads
// zeros and no pass zeroes the tiles first. `vec` is the copy width in
// bytes (16, 8 or 4, dividing D's bytes; 0 for single elements, a bf16
// row of odd width). The lanes of a warp split a row into chunks, rows go
// to warps in turn: no division a chunk.
template <typename T, int DK>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int r0,
                                           int n, int rows, int D, int ld,
                                           int vec, int nt) {
  if (vec == 0) {  // element copies, synchronous: four loads in flight
    // a lane; the tile's rows are one contiguous run of rows * D elements
    const size_t first = static_cast<size_t>(r0) * D;
    const int live = max(0, min(rows, n - r0));
    for (int i0 = threadIdx.x; i0 < rows * DK; i0 += 4 * nt) {
      T val[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * nt, r = i / DK, c = i % DK;
        val[u] = (r < live && c < D) ? src[first + r * D + c] : T(0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * nt;
        if (i < rows * DK) dst[(i / DK) * ld + i % DK] = val[u];
      }
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = nt / 32;
  const int per = vec / static_cast<int>(sizeof(T));  // elements a chunk
  const int cpr = D / per, cpr_all = DK / per;        // chunks a row
  // lanes a row: the least power of two >= cpr_all, at most 32
  int shift = 0;
  while ((1 << shift) < cpr_all && shift < 5) ++shift;
  const int sub = lane >> shift, c0 = lane & ((1 << shift) - 1);
  const int step = warps * (32 >> shift);
  for (int r = warp * (32 >> shift) + sub; r < rows; r += step) {
    const bool live = r0 + r < n;
    const T* row = src + static_cast<size_t>(live ? r0 + r : 0) * D;
    for (int c = c0; c < cpr_all; c += (1 << shift))
      cp_async(dst + r * ld + c * per, row + (c < cpr ? c * per : 0), vec,
               live && c < cpr);
  }
}

// f32 values a float: (n, 1) vectors such as lse and delta, zero past n
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int r0, int n, int rows, int nt) {
  for (int r = threadIdx.x; r < rows; r += nt) {
    const bool live = r0 + r < n;
    cp_async(dst + r, src + (live ? r0 + r : 0), 4, live);
  }
}

// mma.sync fragments, lane = 4 g + t. C (16 x 8, f32): c0 (g, 2t),
// c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: x = big + small, each a TF32 value that the tensor cores take
// as it is (they truncate what is not TF32): big keeps x's sign, exponent
// and top 10 mantissa bits (its low 13 bits cleared: exact), small =
// x - big (exact in f32) rounded to the nearest TF32, ties away from zero
// — cvt.rna's rounding, done as an integer add and mask (rounding both
// parts with cvt.rna made K4 and K5 1.3x slower at S 2048, D 128 on an
// H100: flash_variants.py cvt_rna). x - big - small is at most 2^-22 of
// |x|. The product
// keeps big*big' + big*small' + small*big', summed in f32, small terms
// first.
template <int N>
__device__ __forceinline__ void split_tf32(const float* x, unsigned* big,
                                           unsigned* small) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    big[i] = __float_as_uint(x[i]) & 0xffffe000u;
    small[i] =
        (__float_as_uint(x[i] - __uint_as_float(big[i])) + 0x1000u) &
        0xffffe000u;
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ unsigned pack_raw(unsigned short lo,
                                             unsigned short hi) {
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

// Operand fragments by input type. Shared tiles hold the input type as it
// is (f32 or bf16), rows of DK (the head dim padded to 16, zeros past D)
// at stride ld = DK + 4 floats or DK + 8 bf16: 4 words past a multiple of
// 8, so the 8 rows x 4 columns a fragment load touches fall in 32
// different banks. Three products per kernel step:
//   Ss: acc += A . B^T, A rows from shared memory (16 x KS), B rows
//       from shared memory (8 rows n, k along the row): Q K^T, dO V^T in
//       K4; K Q^T, V dO^T in K5.
//   Cs: acc += A . B, A an f32 C fragment the warp computed (P, dS, or
//       their transposes) and B[k][n] = smem[k][n]: dS K in K4, P^T dO and
//       dS^T Q in K5. For f32 the C fragment's columns (2t, 2t+1) serve as
//       the A fragment's k positions (t, t+4) unchanged — a product sums
//       over k in any order, so B's rows are read in that same order; for
//       bf16 two C tiles are the A fragment as they stand.
template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static constexpr int KS = 8;  // k of m16n8k8
  static constexpr int kPad = 4;
  struct A { unsigned big[4], small[4]; };
  struct B { unsigned big[2], small[2]; };
  // A rows [0, 16) of `s` (row stride ld), columns k0..k0+7
  static __device__ __forceinline__ void load_a(A& a, const float* s, int ld,
                                                int g, int t) {
    const float x[4] = {s[g * ld + t], s[(g + 8) * ld + t],
                        s[g * ld + t + 4], s[(g + 8) * ld + t + 4]};
    split_tf32<4>(x, a.big, a.small);
  }
  // B[k][n] = s[n][k], rows n 0..7
  static __device__ __forceinline__ void load_b(B& b, const float* s, int ld,
                                                int g, int t) {
    const float x[2] = {s[g * ld + t], s[g * ld + t + 4]};
    split_tf32<2>(x, b.big, b.small);
  }
  // B[k][n] = s[k][n], k positions t, t+4 read from rows 2t, 2t+1
  static __device__ __forceinline__ void load_bt(B& b, const float* s, int ld,
                                                 int g, int t) {
    const float x[2] = {s[2 * t * ld + g], s[(2 * t + 1) * ld + g]};
    split_tf32<2>(x, b.big, b.small);
  }
  // the A fragment of k-step j from C tile j (8 columns): k positions
  // (t, t+4) hold columns (2t, 2t+1)
  static __device__ __forceinline__ void a_from_c(A& a, const float* c) {
    const float x[4] = {c[0], c[2], c[1], c[3]};
    split_tf32<4>(x, a.big, a.small);
  }
  static __device__ __forceinline__ void mma(float* acc, const A& a,
                                             const B& b) {
    mma_tf32(acc, a.small, b.big);
    mma_tf32(acc, a.big, b.small);
    mma_tf32(acc, a.big, b.big);
  }
  // a C fragment times shared memory: the same three products
  static __device__ __forceinline__ void mma_c(float* acc, const A& a,
                                               const B& b) {
    mma(acc, a, b);
  }
};

template <>
struct Ops<__nv_bfloat16> {
  static constexpr int KS = 16;  // k of m16n8k16
  static constexpr int kPad = 8;
  // from shared memory only `hi` is used (bf16 inputs are exact); from an
  // f32 C fragment, x = hi + lo, both bf16, two products
  struct A { unsigned hi[4], lo[4]; };
  struct B { unsigned v[2]; };
  static __device__ __forceinline__ unsigned word(const __nv_bfloat16* p) {
    return *reinterpret_cast<const unsigned*>(p);
  }
  static __device__ __forceinline__ void load_a(A& a,
                                                const __nv_bfloat16* s,
                                                int ld, int g, int t) {
    a.hi[0] = word(s + g * ld + 2 * t);
    a.hi[1] = word(s + (g + 8) * ld + 2 * t);
    a.hi[2] = word(s + g * ld + 2 * t + 8);
    a.hi[3] = word(s + (g + 8) * ld + 2 * t + 8);
  }
  static __device__ __forceinline__ void load_b(B& b, const __nv_bfloat16* s,
                                                int ld, int g, int t) {
    b.v[0] = word(s + g * ld + 2 * t);
    b.v[1] = word(s + g * ld + 2 * t + 8);
  }
  static __device__ __forceinline__ void load_bt(B& b,
                                                 const __nv_bfloat16* s,
                                                 int ld, int g, int t) {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(s);
    b.v[0] = pack_raw(u[2 * t * ld + g], u[(2 * t + 1) * ld + g]);
    b.v[1] = pack_raw(u[(2 * t + 8) * ld + g], u[(2 * t + 9) * ld + g]);
  }
  // the A fragment of k-step j from C tiles 2j, 2j+1 (c[0..7])
  static __device__ __forceinline__ void a_from_c(A& a, const float* c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = c[2 * i], x1 = c[2 * i + 1];
      __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      a.hi[i] = *reinterpret_cast<unsigned*>(&h);
      a.lo[i] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
    }
    // c[0..3] is tile 2j: (g, 2t..), (g+8, 2t..); c[4..7] tile 2j+1:
    // columns 8 + 2t.. — the A order is (g, k 2t), (g+8, 2t), (g, 2t+8),
    // (g+8, 2t+8), which is the order of the pairs above
  }
  static __device__ __forceinline__ void mma(float* acc, const A& a,
                                             const B& b) {
    mma_bf16(acc, a.hi, b.v);
  }
  static __device__ __forceinline__ void mma_c(float* acc, const A& a,
                                               const B& b) {
    mma_bf16(acc, a.lo, b.v);
    mma_bf16(acc, a.hi, b.v);
  }
};

// acc += c . b for one warp and one tile of BN rows (keys in K4, queries
// in K5), k running over the tile's rows: `c` the warp's C fragments (dS;
// P^T or dS^T), `b` the tile's rows in shared memory (K; dO or Q). f32:
// each n-tile's products summed over the tile into a zeroed fragment,
// then added to the accumulator once, rounded to nearest — the tensor
// cores' accumulation truncates, and summed in one register over 2048
// keys or queries that bias put dQ, dK and dV past FLASH_TOL; the tile's
// A fragments are split first. bf16: k-steps outside, one A fragment
// live at a time.
template <typename T, int BN, int ND>
__device__ __forceinline__ void c_products(float (*acc)[4],
                                           const float (*c)[4], const T* b,
                                           int ld, int g, int t) {
  using O = Ops<T>;
  if constexpr (std::is_same<T, float>::value) {
    typename O::A a[BN / O::KS];
#pragma unroll
    for (int kk = 0; kk < BN; kk += O::KS)
      O::a_from_c(a[kk / O::KS], c[kk / 8]);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < BN; kk += O::KS) {
        typename O::B bf;
        O::load_bt(bf, b + kk * ld + n * 8, ld, g, t);
        O::mma_c(part, a[kk / O::KS], bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = __fadd_rn(acc[n][e], part[e]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < BN; kk += O::KS) {
      typename O::A a;
      O::a_from_c(a, c[kk / 8]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        typename O::B bf;
        O::load_bt(bf, b + kk * ld + n * 8, ld, g, t);
        O::mma_c(acc[n], a, bf);
      }
    }
  }
}


// ---------------------------------------------------------------------------
// K3: the forward on the tensor cores.

// ldmatrix: four 8 x 8 matrices of 16-bit values from shared memory, lane
// l giving the address of row l % 8 of matrix l / 8 (16 bytes, aligned);
// lane 4g + t receives row g, columns 2t and 2t + 1 of each, or with
// .trans rows 2t and 2t + 1 of column g.
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// K3 reads its bf16 fragments with ldmatrix (flash_variants.py
// no_ldmatrix: the scalar 16-bit loads of K4 and K5 instead); f32
// fragments are read as values, which the 3xTF32 split needs anyway.
constexpr bool kFwdLdmatrix = true;
template <typename T>
constexpr bool kLdsm = kFwdLdmatrix && std::is_same<T, __nv_bfloat16>::value;

// Max and sum of a score row: the four lanes 4g .. 4g + 3 hold it.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// s = Q K^T for one warp: Q's 16 rows (`sq`, row stride ld) against BN
// key rows (`ck`), as NS = BN / 8 C fragments.
template <typename T, int BN, int DK>
__device__ __forceinline__ void fwd_scores(float (*s)[4], const T* sq,
                                           const T* ck, int ld, int lane) {
  using O = Ops<T>;
  constexpr int NS = BN / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DK; kk += O::KS) {
    typename O::A aq;
    if constexpr (kLdsm<T>) {
      // A: rows lane % 16, columns kk + 8 (lane / 16)
      ldsm_x4(aq.hi, sq + (lane & 15) * ld + kk + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        // B of key tiles n and n + 1: key rows n * 8 + lane % 8 (+ 8 for
        // lanes 16-31), columns kk + 8 ((lane / 8) % 2)
        unsigned r[4];
        ldsm_x4(r, ck + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * ld + kk +
                       ((lane >> 3) & 1) * 8);
        typename O::B b0, b1;
        b0.v[0] = r[0];
        b0.v[1] = r[1];
        b1.v[0] = r[2];
        b1.v[1] = r[3];
        O::mma(s[n], aq, b0);
        O::mma(s[n + 1], aq, b1);
      }
    } else {
      O::load_a(aq, sq + kk, ld, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        typename O::B bk;
        O::load_b(bk, ck + n * 8 * ld + kk, ld, g, t);
        O::mma(s[n], aq, bk);
      }
    }
  }
}

// acc = acc * alpha + P V for one warp and one tile: P the warp's C
// fragments (16 x BN, as A operands: 3xTF32 for f32, hi + lo bf16 parts
// for bf16, so P is never rounded once), V the tile's BN rows in shared
// memory. Each n-tile's products go into a zeroed fragment, then one
// rescale and one f32 add, both rounded to nearest: the tensor cores'
// accumulation truncates, and the rescale gives this shape for free.
template <typename T, int BN, int ND>
__device__ __forceinline__ void fwd_pv(float (*acc)[4], const float (*p)[4],
                                       const T* cv, int ld, int lane,
                                       const float* alpha) {
  using O = Ops<T>;
  const int g = lane >> 2, t = lane & 3;
  typename O::A a[BN / O::KS];
#pragma unroll
  for (int kk = 0; kk < BN; kk += O::KS) O::a_from_c(a[kk / O::KS], p[kk / 8]);
  if constexpr (kLdsm<T>) {
#pragma unroll
    for (int n = 0; n < ND; n += 2) {
      float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < BN; kk += O::KS) {
        // B of V's columns n * 8 .. n * 8 + 15 (two n-tiles), rows kk +
        // lane % 16, transposed
        unsigned r[4];
        ldsm_x4_trans(r, cv + (kk + (lane & 15)) * ld + n * 8 +
                             (lane >> 4) * 8);
        typename O::B b0, b1;
        b0.v[0] = r[0];
        b0.v[1] = r[1];
        b1.v[0] = r[2];
        b1.v[1] = r[3];
        O::mma_c(part[0], a[kk / O::KS], b0);
        O::mma_c(part[1], a[kk / O::KS], b1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n + h][e] =
              __fadd_rn(__fmul_rn(acc[n + h][e], alpha[e >> 1]), part[h][e]);
    }
  } else {
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < BN; kk += O::KS) {
        typename O::B bv;
        O::load_bt(bv, cv + kk * ld + n * 8, ld, g, t);
        O::mma_c(part, a[kk / O::KS], bv);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = __fadd_rn(__fmul_rn(acc[n][e], alpha[e >> 1]), part[e]);
    }
  }
}

// Key tiles of `bk` keys a query tile of `bm` rows visits: those below
// sk_valid and, when causal, those holding a column <= the tile's last row.
__device__ __forceinline__ int key_tiles(int q0, int bm, int bk, int Sq,
                                         int sk_valid, int causal) {
  const int n_k = (sk_valid + bk - 1) / bk;
  if (!causal) return n_k;
  return min(n_k, (min(q0 + bm, Sq) - 1) / bk + 1);
}

// K3. A block owns W row groups of 16 query rows (W = blockDim / (32
// SPLIT), chosen by the launcher), a warp one row group; at SPLIT 2 (one
// row group, a small grid) two warps share it and take the two halves of
// every key tile, each with its own (m, l, O), merged at the end. Q is
// copied once into shared memory; the key tiles of BN x SPLIT keys (K, V
// and the key bias) are double-buffered with cp.async, tile j + 1 copied
// while tile j multiplies. A warp computes its 16 x BN scores on the
// tensor cores, masks them in the C fragments (rows g, g + 8; columns 2t,
// 2t + 1), runs the online softmax there (m stays -inf until a row meets
// an unmasked score; exponents against m_use = (m == -inf ? 0 : m), so no
// -inf - -inf is formed) and feeds P as the A operand of O += P V; O
// (16 x DK a warp) stays in registers.
template <typename T, int SPLIT, int DK, int BN>
__global__ void __launch_bounds__(256)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk,
                 int D, int sk_valid, int causal, float scale, int vec) {
  using O = Ops<T>;
  constexpr int BK = BN * SPLIT, ld = DK + O::kPad;  // keys a block tile
  constexpr int NS = BN / 8, ND = DK / 8;
  const int nt = blockDim.x, W = nt / (32 * SPLIT), BM = 16 * W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BM * ld;  // two buffers of BK rows
  T* sV = sK + 2 * BK * ld;
  float* sB = reinterpret_cast<float*>(sV + 2 * BK * ld);  // two of BK
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % W, part = warp / W;  // row group, key half
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int wr0 = q0 + rg * 16;  // the warp's first row
  const size_t base = static_cast<size_t>(bh) * Sq;
  const T* kb = k + static_cast<size_t>(bh) * Sk * D;
  const T* vb = v + static_cast<size_t>(bh) * Sk * D;
  stage_rows<T, DK>(sQ, q + base * D, q0, Sq, BM, D, ld, vec, nt);
  const int n_iter = key_tiles(q0, BM, BK, Sq, sk_valid, causal);
  if (n_iter > 0) {
    stage_rows<T, DK>(sK, kb, 0, Sk, BK, D, ld, vec, nt);
    stage_rows<T, DK>(sV, vb, 0, Sk, BK, D, ld, vec, nt);
    if (bias != nullptr) stage_vec(sB, bias, 0, Sk, BK, nt);
  }
  cp_commit();

  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_iter; ++j) {
    if (j + 1 < n_iter) {
      const int nb = (j + 1) & 1, k1 = (j + 1) * BK;
      stage_rows<T, DK>(sK + nb * BK * ld, kb, k1, Sk, BK, D, ld, vec, nt);
      stage_rows<T, DK>(sV + nb * BK * ld, vb, k1, Sk, BK, D, ld, vec, nt);
      if (bias != nullptr) stage_vec(sB + nb * BK, bias, k1, Sk, BK, nt);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // this warp's BN keys of the block tile
    const int k0 = j * BK + part * BN;
    const T* cK = sK + ((j & 1) * BK + part * BN) * ld;
    const T* cV = sV + ((j & 1) * BK + part * BN) * ld;
    const float* cB =
        bias != nullptr ? sB + (j & 1) * BK + part * BN : nullptr;
    // a warp whose 16 rows are all above its first key, or past Sq, or
    // whose keys are all past sk_valid, has nothing unmasked here
    if (wr0 < Sq && k0 < sk_valid && !(causal && k0 > wr0 + 15)) {
      float s[NS][4];
      fwd_scores<T, BN, DK>(s, sQ + rg * 16 * ld, cK, ld, lane);
      float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wr0 + g + 8 * (e >> 1);
          const int c = n * 8 + 2 * t + (e & 1);
          const int col = k0 + c;
          const bool ok = col < sk_valid && (!causal || row >= col);
          float sc = __fmul_rn(s[n][e], scale);
          if (cB != nullptr) sc = __fadd_rn(sc, cB[c]);
          s[n][e] = ok ? sc : neg_inf();
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      float alpha[2], m_use[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        m_use[h] = (m_new == neg_inf()) ? 0.f : m_new;
        alpha[h] = expf(m[h] - m_use[h]);  // 0 while m[h] is -inf
        m[h] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(s[n][e] - m_use[e >> 1]);  // masked: exp(-inf) = 0
          rs[e >> 1] = __fadd_rn(rs[e >> 1], s[n][e]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l[h] = __fadd_rn(__fmul_rn(l[h], alpha[h]), quad_sum(rs[h]));
      fwd_pv<T, BN, ND>(acc, s, cV, ld, lane, alpha);
    }
    __syncthreads();  // this buffer is the next copy's target
  }
  if constexpr (SPLIT > 1) {
    // the second warp's (m, l, O) into the first's, rescaled to their
    // common max, in a fixed order through shared memory
    constexpr int kF = ND * 4 + 4;  // floats a lane
    float* red = reinterpret_cast<float*>(smem_raw) + rg * kF * 32;
    __syncthreads();
    if (part == 1) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(n * 4 + e) * 32 + lane] = acc[n][e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        red[(ND * 4 + h) * 32 + lane] = m[h];
        red[(ND * 4 + 2 + h) * 32 + lane] = l[h];
      }
    }
    __syncthreads();
    if (part == 0) {
      float a0[2], a1[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m1 = red[(ND * 4 + h) * 32 + lane];
        const float l1 = red[(ND * 4 + 2 + h) * 32 + lane];
        const float m_new = fmaxf(m[h], m1);
        const float mu = (m_new == neg_inf()) ? 0.f : m_new;
        a0[h] = expf(m[h] - mu);
        a1[h] = expf(m1 - mu);
        l[h] = __fadd_rn(__fmul_rn(l[h], a0[h]), __fmul_rn(l1, a1[h]));
        m[h] = m_new;
      }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] =
              __fadd_rn(__fmul_rn(acc[n][e], a0[e >> 1]),
                        __fmul_rn(red[(n * 4 + e) * 32 + lane], a1[e >> 1]));
    }
  }
  if (part > 0) return;
  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) l_safe[h] = fmaxf(l[h], 1e-30f);
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = wr0 + g + 8 * (e >> 1);
      const int col = n * 8 + 2 * t + (e & 1);
      if (row < Sq && col < D)
        store(o + (base + row) * D + col, __fdiv_rn(acc[n][e], l_safe[e >> 1]));
    }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wr0 + g + 8 * h;
      if (row < Sq) {
        const float m_use = (m[h] == neg_inf()) ? 0.f : m[h];
        lse[base + row] = __fadd_rn(m_use, logf(l_safe[h]));
      }
    }
  }
}

// Key tiles of BN a query tile of BM rows visits: those below sk_valid
// and, when causal, those holding a column <= the tile's last row.
template <int BM, int BN>
__device__ __forceinline__ int dq_key_tiles(int q0, int Sq, int sk_valid,
                                            int causal) {
  const int n_k = (sk_valid + BN - 1) / BN;
  if (!causal) return n_k;
  return min(n_k, (min(q0 + BM, Sq) - 1) / BN + 1);
}

// The split warps' partial sums into the first split's registers, in a
// fixed order through shared memory (`red`, after the tiles are done):
// acc[ND][4] of each of the SPLIT warps of row group rg, lane by lane.
template <int WARPS, int SPLIT, int ND>
__device__ __forceinline__ void reduce_split(float (*acc)[4], float* red,
                                             int rg, int part, int lane) {
  if (SPLIT == 1) return;
  constexpr int kFrag = ND * 4 * 32;  // floats a warp
  if (part > 0) {
    float* dst = red + ((part - 1) * WARPS + rg) * kFrag;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[(n * 4 + e) * 32 + lane] = acc[n][e];
  }
  __syncthreads();
  if (part == 0) {
#pragma unroll
    for (int p = 1; p < SPLIT; ++p) {
      const float* src = red + ((p - 1) * WARPS + rg) * kFrag;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = __fadd_rn(acc[n][e], src[(n * 4 + e) * 32 + lane]);
    }
  }
}

// K4. A block owns BM = 16 WARPS query rows, 16 a row group of SPLIT
// warps (SPLIT 2 only for one row group, where the grid is small: the
// two warps take the two halves of every key tile and add their partial
// dQ at the end, in a fixed order). It walks the key tiles of BN x SPLIT
// keys, tile j + 1 copied in (cp.async, double buffer) while tile j
// multiplies. A warp computes its 16 x BN scores S and dP on the tensor
// cores, turns them into dS in registers (the C fragment's own rows and
// columns carry the mask), and feeds dS as the A operand of dQ += dS K;
// dQ (16 x DK a warp) stays in registers.
template <typename T, int WARPS, int SPLIT, int DK, int BN>
__global__ void __launch_bounds__(WARPS * SPLIT * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias, T* __restrict__ dq,
                    int Sq, int Sk, int D, int sk_valid, int causal,
                    float scale, int vec) {
  using O = Ops<T>;
  constexpr int BM = 16 * WARPS, NT = 32 * WARPS * SPLIT;
  constexpr int BK = BN * SPLIT, ld = DK + O::kPad;  // keys a block tile
  constexpr int NS = BN / 8, ND = DK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + BM * ld;
  T* sK = sdO + BM * ld;  // two buffers of BK rows
  T* sV = sK + 2 * BK * ld;
  float* sB = reinterpret_cast<float*>(sV + 2 * BK * ld);  // two of BK
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % WARPS, part = warp / WARPS;  // row group, key half
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int wr0 = q0 + rg * 16;  // the warp's first row
  const size_t base = static_cast<size_t>(bh) * Sq;
  const T* kb = k + static_cast<size_t>(bh) * Sk * D;
  const T* vb = v + static_cast<size_t>(bh) * Sk * D;
  stage_rows<T, DK>(sQ, q + base * D, q0, Sq, BM, D, ld, vec, NT);
  stage_rows<T, DK>(sdO, dout + base * D, q0, Sq, BM, D, ld, vec, NT);
  const int n_iter = dq_key_tiles<BM, BK>(q0, Sq, sk_valid, causal);
  if (n_iter > 0) {
    stage_rows<T, DK>(sK, kb, 0, Sk, BK, D, ld, vec, NT);
    stage_rows<T, DK>(sV, vb, 0, Sk, BK, D, ld, vec, NT);
    if (bias != nullptr) stage_vec(sB, bias, 0, Sk, BK, NT);
  }
  cp_commit();

  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr0 + g + 8 * h;
    lr[h] = row < Sq ? lse[base + row] : 0.f;
    dr[h] = row < Sq ? delta[base + row] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_iter; ++j) {
    if (j + 1 < n_iter) {
      const int nb = (j + 1) & 1, k1 = (j + 1) * BK;
      stage_rows<T, DK>(sK + nb * BK * ld, kb, k1, Sk, BK, D, ld, vec, NT);
      stage_rows<T, DK>(sV + nb * BK * ld, vb, k1, Sk, BK, D, ld, vec, NT);
      if (bias != nullptr)
        stage_vec(sB + nb * BK, bias, k1, Sk, BK, NT);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // this warp's BN keys of the block tile
    const int k0 = j * BK + part * BN;
    const T* cK = sK + ((j & 1) * BK + part * BN) * ld;
    const T* cV = sV + ((j & 1) * BK + part * BN) * ld;
    const float* cB =
        bias != nullptr ? sB + (j & 1) * BK + part * BN : nullptr;
    // a warp whose 16 rows are all above its first key, or past Sq, or
    // whose keys are all past sk_valid, has nothing unmasked here
    if (wr0 < Sq && k0 < sk_valid && !(causal && k0 > wr0 + 15)) {
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; kk += O::KS) {
        typename O::A aq, ado;
        O::load_a(aq, sQ + rg * 16 * ld + kk, ld, g, t);
        O::load_a(ado, sdO + rg * 16 * ld + kk, ld, g, t);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          typename O::B bk, bv;
          O::load_b(bk, cK + n * 8 * ld + kk, ld, g, t);
          O::load_b(bv, cV + n * 8 * ld + kk, ld, g, t);
          O::mma(s[n], aq, bk);
          O::mma(dp[n], ado, bv);
        }
      }
      // dS in place of s; a masked (or padded) column's p is never formed
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wr0 + g + 8 * (e >> 1);
          const int c = n * 8 + 2 * t + (e & 1);
          const int col = k0 + c;
          const bool ok = row < Sq && col < sk_valid && (!causal || row >= col);
          float sc = __fmul_rn(s[n][e], scale);
          if (cB != nullptr) sc = __fadd_rn(sc, cB[c]);
          const float p = ok ? expf(sc - lr[e >> 1]) : 0.f;
          s[n][e] = __fmul_rn(p, __fsub_rn(dp[n][e], dr[e >> 1]));
        }
      // dQ += dS K: k runs over this warp's keys
      c_products<T, BN, ND>(acc, s, cK, ld, g, t);
    }
    __syncthreads();  // this buffer is the next copy's target
  }
  reduce_split<WARPS, SPLIT, ND>(acc, reinterpret_cast<float*>(smem_raw), rg,
                                 part, lane);
  if (part > 0) return;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = wr0 + g + 8 * (e >> 1);
      const int col = n * 8 + 2 * t + (e & 1);
      if (row < Sq && col < D)
        store(dq + (base + row) * D + col, __fmul_rn(acc[n][e], scale));
    }
}

// K5. A block owns BM = 16 WARPS key rows, 16 a row group of SPLIT warps
// (SPLIT 2 only for one row group: the two warps take the two halves of
// every query tile and add their partial dK and dV at the end, in a fixed
// order). It walks the query tiles of BN x SPLIT queries (Q, dO, lse and
// delta copied in by cp.async, double buffer). With keys as rows, a warp
// computes S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out as C
// fragments in registers and feed dV += P^T dO and dK += dS^T Q as A
// operands, with no pass through shared memory; dK and dV (16 x DK each a
// warp) stay in registers. The causal mask only, as the TPU kernel.
template <typename T, int WARPS, int SPLIT, int DK, int BN>
__global__ void __launch_bounds__(WARPS * SPLIT * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int D, int causal,
                     float scale, int vec) {
  using O = Ops<T>;
  constexpr int BM = 16 * WARPS, NT = 32 * WARPS * SPLIT;
  constexpr int BQ = BN * SPLIT, ld = DK + O::kPad;  // queries a block tile
  constexpr int NS = BN / 8, ND = DK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + BM * ld;
  T* sQ = sV + BM * ld;  // two buffers of BQ rows
  T* sdO = sQ + 2 * BQ * ld;
  float* sL = reinterpret_cast<float*>(sdO + 2 * BQ * ld);  // two of BQ
  float* sD = sL + 2 * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % WARPS, part = warp / WARPS;  // row group, query half
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BM;
  const int kw0 = k0 + rg * 16;  // the warp's first key
  const size_t qbase = static_cast<size_t>(bh) * Sq;
  const size_t kbase = static_cast<size_t>(bh) * Sk;
  const T* qb = q + qbase * D;
  const T* db = dout + qbase * D;
  stage_rows<T, DK>(sK, k + kbase * D, k0, Sk, BM, D, ld, vec, NT);
  stage_rows<T, DK>(sV, v + kbase * D, k0, Sk, BM, D, ld, vec, NT);
  const int n_q = (Sq + BQ - 1) / BQ;
  // causal: query tiles before the one holding this block's first key are
  // fully masked
  const int start = causal ? min(k0 / BQ, n_q) : 0;
  if (start < n_q) {
    const int q0 = start * BQ;
    stage_rows<T, DK>(sQ, qb, q0, Sq, BQ, D, ld, vec, NT);
    stage_rows<T, DK>(sdO, db, q0, Sq, BQ, D, ld, vec, NT);
    stage_vec(sL, lse + qbase, q0, Sq, BQ, NT);
    stage_vec(sD, delta + qbase, q0, Sq, BQ, NT);
  }
  cp_commit();

  float kbias[2];  // the key bias of the lane's rows g, g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = kw0 + g + 8 * h;
    kbias[h] = (bias != nullptr && kr < Sk) ? bias[kr] : 0.f;
  }
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = start; it < n_q; ++it) {
    const int b = (it - start) & 1;
    if (it + 1 < n_q) {
      const int nb = b ^ 1, q1 = (it + 1) * BQ;
      stage_rows<T, DK>(sQ + nb * BQ * ld, qb, q1, Sq, BQ, D, ld, vec,
                        NT);
      stage_rows<T, DK>(sdO + nb * BQ * ld, db, q1, Sq, BQ, D, ld, vec,
                        NT);
      stage_vec(sL + nb * BQ, lse + qbase, q1, Sq, BQ, NT);
      stage_vec(sD + nb * BQ, delta + qbase, q1, Sq, BQ, NT);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // this warp's BN queries of the block tile
    const int q0 = it * BQ + part * BN;
    const T* cQ = sQ + (b * BQ + part * BN) * ld;
    const T* cdO = sdO + (b * BQ + part * BN) * ld;
    const float* cL = sL + b * BQ + part * BN;
    const float* cD = sD + b * BQ + part * BN;
    // a warp whose 16 keys all come after its last query, or lie past Sk,
    // or whose queries are all past Sq, has nothing unmasked here
    if (kw0 < Sk && q0 < Sq && !(causal && q0 + BN - 1 < kw0)) {
      float st[NS][4], dpt[NS][4];  // rows: keys; columns: queries
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; kk += O::KS) {
        typename O::A ak, av;
        O::load_a(ak, sK + rg * 16 * ld + kk, ld, g, t);
        O::load_a(av, sV + rg * 16 * ld + kk, ld, g, t);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          typename O::B bq, bdo;
          O::load_b(bq, cQ + n * 8 * ld + kk, ld, g, t);
          O::load_b(bdo, cdO + n * 8 * ld + kk, ld, g, t);
          O::mma(st[n], ak, bq);
          O::mma(dpt[n], av, bdo);
        }
      }
      // P^T in st, dS^T in dpt; a query row past Sq stays masked
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = kw0 + g + 8 * (e >> 1);
          const int qc = n * 8 + 2 * t + (e & 1);
          const bool ok = q0 + qc < Sq && (!causal || q0 + qc >= kr);
          float sc = __fmul_rn(st[n][e], scale);
          if (bias != nullptr) sc = __fadd_rn(sc, kbias[e >> 1]);
          const float p = ok ? expf(sc - cL[qc]) : 0.f;
          st[n][e] = p;
          dpt[n][e] = __fmul_rn(p, __fsub_rn(dpt[n][e], cD[qc]));
        }
      // dV += P^T dO, then dK += dS^T Q
      c_products<T, BN, ND>(dva, st, cdO, ld, g, t);
      c_products<T, BN, ND>(dka, dpt, cQ, ld, g, t);
    }
    __syncthreads();  // this buffer is the next copy's target
  }
  float* red = reinterpret_cast<float*>(smem_raw);
  reduce_split<WARPS, SPLIT, ND>(dva, red, rg, part, lane);
  __syncthreads();  // dV's partials are read before dK's are written
  reduce_split<WARPS, SPLIT, ND>(dka, red, rg, part, lane);
  if (part > 0) return;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = kw0 + g + 8 * (e >> 1);
      const int col = n * 8 + 2 * t + (e & 1);
      if (kr < Sk && col < D) {
        store(dk + (kbase + kr) * D + col, __fmul_rn(dka[n][e], scale));
        store(dv + (kbase + kr) * D + col, dva[n][e]);
      }
    }
}

template <typename K>
int prepare(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// -- K4 and K5 launchers ----------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *bias;
  void *dq, *dk, *dv;
  int BH, Sq, Sk, D, sk_valid, causal;
  float scale;
  int vec;
  cudaStream_t st;
};

// BN, the keys (K4) or queries (K5) a warp takes in one tile: 32 from DK
// 64 up, where registers and shared memory are scarce, and for split row
// groups (so that both warps have work at S 64), else 64.
template <int SPLIT, int DK>
constexpr int bwd_bn() { return (DK >= 64 || SPLIT > 1) ? 32 : 64; }

// Shared memory of K4 and K5, in bytes: the input-type tiles (16 W rows
// of two operands, two buffers of BN x SPLIT rows of two more), then f32
// vectors: two buffers of BN x SPLIT key-bias values (K4), or of lse and
// delta (K5).
template <typename T, int W, int SPLIT, int DK, int BN, int NVEC>
constexpr size_t bwd_smem() {
  return (2 * 16 * W + 4 * BN * SPLIT) * (DK + Ops<T>::kPad) * sizeof(T) +
         NVEC * 2 * BN * SPLIT * sizeof(float);
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

// Row groups a block (16 rows each) over `rows` rows of BH heads: the
// largest of 8, 4, 2, 1 whose grid still gives every SM a block. One row
// group takes two warps that split the other side's tiles between them
// (SPLIT 2), so that a small grid has twice the warps in flight. (Two
// blocks an SM, the first rule tried, took 4-row-group blocks at S 1024
// and lost to one block of 8: shared memory holds one block of either at
// D 128 in f32.)
inline int pick_warps(int rows, int BH) {
  const long sms = num_sms();
  for (int w = 8; w > 1; w >>= 1) {
    const long blocks = static_cast<long>((rows + 16 * w - 1) / (16 * w)) * BH;
    if (blocks >= sms) return w;
  }
  return 1;
}

// The widest cp.async (16, 8 or 4 bytes) that divides a row of D
// elements and every base pointer (`any`, their bits or-ed); 0 for
// element copies.
inline int copy_vec(int D, size_t isz, uintptr_t any) {
  const size_t row = static_cast<size_t>(D) * isz;
  for (int vec = 16; vec >= 4; vec >>= 1)
    if (row % vec == 0 && any % vec == 0) return vec;
  return 0;
}

inline uintptr_t bits(const void* p) { return reinterpret_cast<uintptr_t>(p); }

template <typename T, int W, int DK>
int dq_launch(const BwdArgs& a) {
  constexpr int SPLIT = W == 1 ? 2 : 1, BN = bwd_bn<SPLIT, DK>();
  constexpr size_t bytes = bwd_smem<T, W, SPLIT, DK, BN, 1>();
  auto kern = flash_bwd_dq_kernel<T, W, SPLIT, DK, BN>;
  if (int e = prepare(kern, bytes)) return e;
  dim3 grid((a.Sq + 16 * W - 1) / (16 * W), a.BH);
  kern<<<grid, 32 * W * SPLIT, bytes, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.bias, static_cast<T*>(a.dq), a.Sq, a.Sk, a.D, a.sk_valid,
      a.causal, a.scale, a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W, int DK>
int dkv_launch(const BwdArgs& a) {
  constexpr int SPLIT = W == 1 ? 2 : 1, BN = bwd_bn<SPLIT, DK>();
  constexpr size_t bytes = bwd_smem<T, W, SPLIT, DK, BN, 2>();
  auto kern = flash_bwd_dkv_kernel<T, W, SPLIT, DK, BN>;
  if (int e = prepare(kern, bytes)) return e;
  dim3 grid((a.Sk + 16 * W - 1) / (16 * W), a.BH);
  kern<<<grid, 32 * W * SPLIT, bytes, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.bias, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Sq,
      a.Sk, a.D, a.causal, a.scale, a.vec);
  return static_cast<int>(cudaGetLastError());
}

// The launchers by head dim, DK: D padded to 16, 24 (f32 only: the bf16
// mma's k is 16), 32, 64 or 128 — then by the warps a block.
struct DqLaunch {
  template <typename T, int W, int DK>
  static int run(const BwdArgs& a) { return dq_launch<T, W, DK>(a); }
};
struct DkvLaunch {
  template <typename T, int W, int DK>
  static int run(const BwdArgs& a) { return dkv_launch<T, W, DK>(a); }
};

template <class L, typename T, int W>
int by_dk(const BwdArgs& a) {
  if (a.D <= 16) return L::template run<T, W, 16>(a);
  if constexpr (std::is_same<T, float>::value)
    if (a.D <= 24) return L::template run<T, W, 24>(a);
  if (a.D <= 32) return L::template run<T, W, 32>(a);
  if (a.D <= 64) return L::template run<T, W, 64>(a);
  return L::template run<T, W, 128>(a);
}

template <class L, typename T>
int by_warps(BwdArgs& a, int rows) {
  if (a.D < 1 || a.D > 128) return static_cast<int>(cudaErrorInvalidValue);
  a.vec = copy_vec(a.D, sizeof(T),
                   bits(a.q) | bits(a.k) | bits(a.v) | bits(a.dout));
  switch (pick_warps(rows, a.BH)) {
    case 8: return by_dk<L, T, 8>(a);
    case 4: return by_dk<L, T, 4>(a);
    case 2: return by_dk<L, T, 2>(a);
    default: return by_dk<L, T, 1>(a);
  }
}

// -- K3 launcher -------------------------------------------------------------

struct FwdArgs {
  const void *q, *k, *v;
  const float* bias;
  void* o;
  float* lse;
  int BH, Sq, Sk, D, sk_valid, causal;
  float scale;
  int vec;
  cudaStream_t st;
};

// Shared memory of K3, in bytes: Q's 16 W rows and two buffers of BN x
// SPLIT rows of K and of V in the input type, two of the key bias; at
// SPLIT 2 at least the merge's (O, m, l) of the second warps.
template <typename T, int SPLIT, int DK, int BN>
size_t fwd_smem(int W) {
  const size_t tiles =
      (16 * W + 4 * BN * SPLIT) * (DK + Ops<T>::kPad) * sizeof(T) +
      2 * BN * SPLIT * sizeof(float);
  const size_t merge =
      SPLIT > 1 ? static_cast<size_t>(W) * 32 * (DK / 2 + 4) * sizeof(float)
                : 0;
  return tiles > merge ? tiles : merge;
}

// W row groups a block (pick_warps); one row group takes two warps that
// split every key tile (SPLIT 2), 32 keys each so that both have work at
// S 64. One warp a row group takes 64 keys a tile at every head dim:
// against 32 from DK 64 up, as K4 and K5, 1.11-1.13x faster at S 2048,
// DK 128 in f32 and bf16 on an H100 (flash_variants.py k3_bn32).
template <typename T, int DK>
int fwd_launch(const FwdArgs& a, int W) {
  if (W == 1) {
    constexpr int SPLIT = 2, BN = 32;
    auto kern = flash_fwd_kernel<T, SPLIT, DK, BN>;
    const size_t bytes = fwd_smem<T, SPLIT, DK, BN>(W);
    if (int e = prepare(kern, bytes)) return e;
    dim3 grid((a.Sq + 15) / 16, a.BH);
    kern<<<grid, 32 * SPLIT, bytes, a.st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.bias, static_cast<T*>(a.o), a.lse,
        a.Sq, a.Sk, a.D, a.sk_valid, a.causal, a.scale, a.vec);
  } else {
    constexpr int SPLIT = 1, BN = 64;
    auto kern = flash_fwd_kernel<T, SPLIT, DK, BN>;
    const size_t bytes = fwd_smem<T, SPLIT, DK, BN>(W);
    if (int e = prepare(kern, bytes)) return e;
    dim3 grid((a.Sq + 16 * W - 1) / (16 * W), a.BH);
    kern<<<grid, 32 * W, bytes, a.st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.bias, static_cast<T*>(a.o), a.lse,
        a.Sq, a.Sk, a.D, a.sk_valid, a.causal, a.scale, a.vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// By head dim, padded as by_dk: 16, 24 (f32 only), 32, 64 or 128. The
// warps a block are a launch argument, not a template one: 18
// instantiations.
template <typename T>
int fwd(const void* q, const void* k, const void* v, const float* bias,
        void* o, float* lse, int BH, int Sq, int Sk, int D, int sk_valid,
        int causal, float scale, void* stream) {
  if (D < 1 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{q, k, v, bias, o, lse, BH, Sq, Sk, D, sk_valid, causal, scale,
            copy_vec(D, sizeof(T), bits(q) | bits(k) | bits(v)),
            static_cast<cudaStream_t>(stream)};
  const int W = pick_warps(Sq, BH);
  if (D <= 16) return fwd_launch<T, 16>(a, W);
  if constexpr (std::is_same<T, float>::value)
    if (D <= 24) return fwd_launch<T, 24>(a, W);
  if (D <= 32) return fwd_launch<T, 32>(a, W);
  if (D <= 64) return fwd_launch<T, 64>(a, W);
  return fwd_launch<T, 128>(a, W);
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const float* bias, void* dq,
           int BH, int Sq, int Sk, int D, int sk_valid, int causal,
           float scale, void* stream) {
  BwdArgs a{q, k, v, dout, lse, delta, bias, dq, nullptr, nullptr,
            BH, Sq, Sk, D, sk_valid, causal, scale, 0,
            static_cast<cudaStream_t>(stream)};
  return by_warps<DqLaunch, T>(a, Sq);
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, const float* bias, void* dk,
            void* dv, int BH, int Sq, int Sk, int D, int causal, float scale,
            void* stream) {
  BwdArgs a{q, k, v, dout, lse, delta, bias, nullptr, dk, dv,
            BH, Sq, Sk, D, Sk, causal, scale, 0,
            static_cast<cudaStream_t>(stream)};
  return by_warps<DkvLaunch, T>(a, Sk);
}
// -- Wide heads (D > 128): K3, K4 and K5, one warp a row ---------------------
//
// The tensor-core kernels above hold a row group's accumulators in
// registers and take D <= 128. These three take any D (up to what shared
// memory holds: 8 x D floats a warp for K5, with W warps a block), for
// the same function and masks, by a simple design that is right first
// and slow: it runs on the CUDA cores in f32 (bf16 inputs are widened
// once), and its times are in PERF.md. What bounds it: the serial chain
// of dot products, each D / 32 FMAs a lane and a five-step xor shuffle
// (whose result is the same bit for bit on every lane, so every branch
// on a score is warp-uniform).
// - One warp owns one query row (K3, K4) or one key row (K5); its lanes
//   take the row's columns d = lane, lane + 32, ...
// - The warp's own row(s) are widened to f32 once into its slice of
//   shared memory, beside its f32 accumulators (O; dQ; dK and dV). Each
//   lane owns its columns of them: no atomics, no block-wide sync, and
//   the results are deterministic.
// - K3 takes two passes over the keys: the row's max m and sum l first
//   (an online max over scalars), lse = m + log(l), then O = sum of
//   exp(s - lse) v over the keys, already normalised, so O is never
//   rescaled. A row with nothing unmasked gives O = 0 and lse =
//   log(1e-30), as above.
// - K4 visits the keys of K3's mask (< sk_valid, <= the row when
//   causal), K5 the queries of the causal mask only (every query at or
//   past the key when causal); a zero probability skips the key's or
//   query's products.
// - W = 4 warps a block, halved while the block's shared memory would
//   pass the card's 227 KB.

template <typename T>
__device__ __forceinline__ float widen(T x);
template <>
__device__ __forceinline__ float widen<float>(float x) { return x; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// sum over the warp of `x`; every lane gets the same bits
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// <a, b> over D columns: `a` widened in shared memory, `b` a row in memory
template <typename T>
__device__ __forceinline__ float row_dot(const float* a, const T* b, int D,
                                         int lane) {
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += a[d] * widen(b[d]);
  return warp_sum(acc);
}

template <typename T>
__device__ __forceinline__ void widen_row(float* dst, const T* src, int D,
                                          int lane) {
  for (int d = lane; d < D; d += 32) dst[d] = widen(src[d]);
}

// the score of (row, key j) as the plain version rounds it: the dot
// product, times scale, plus the key bias
template <typename T>
__device__ __forceinline__ float wide_score(const float* qrow, const T* krow,
                                            const float* bias, int j, int D,
                                            int lane, float scale) {
  float s = row_dot(qrow, krow, D, lane) * scale;
  if (bias != nullptr) s += bias[j];
  return s;
}

template <typename T>
__global__ void flash_fwd_wide_kernel(const T* __restrict__ q,
                                      const T* __restrict__ k,
                                      const T* __restrict__ v,
                                      const float* __restrict__ bias,
                                      T* __restrict__ o,
                                      float* __restrict__ lse, int Sq,
                                      int Sk, int D, int sk_valid,
                                      int causal, float scale) {
  extern __shared__ float wide_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= Sq) return;
  const size_t bh = blockIdx.y;
  float* qs = wide_smem + static_cast<size_t>(warp) * 2 * D;
  float* os = qs + D;
  widen_row(qs, q + (bh * Sq + row) * D, D, lane);
  for (int d = lane; d < D; d += 32) os[d] = 0.f;
  __syncwarp();
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  int n = sk_valid < Sk ? sk_valid : Sk;
  if (causal && row + 1 < n) n = row + 1;
  float m = neg_inf(), l = 0.f;
  for (int j = 0; j < n; ++j) {
    const float s = wide_score(qs, kb + static_cast<size_t>(j) * D, bias, j,
                               D, lane, scale);
    if (s == neg_inf()) continue;
    if (s > m) {
      l = l * expf(m - s) + 1.f;
      m = s;
    } else {
      l += expf(s - m);
    }
  }
  const float row_lse = (m == neg_inf() ? 0.f : m) + logf(fmaxf(l, 1e-30f));
  for (int j = 0; j < n; ++j) {
    const float s = wide_score(qs, kb + static_cast<size_t>(j) * D, bias, j,
                               D, lane, scale);
    const float p = expf(s - row_lse);
    if (p == 0.f) continue;
    const T* vr = vb + static_cast<size_t>(j) * D;
    for (int d = lane; d < D; d += 32) os[d] += p * widen(vr[d]);
  }
  T* orow = o + (bh * Sq + row) * D;
  for (int d = lane; d < D; d += 32) store(orow + d, os[d]);
  if (lane == 0) lse[bh * Sq + row] = row_lse;
}

template <typename T>
__global__ void flash_bwd_dq_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ bias,
    T* __restrict__ dq, int Sq, int Sk, int D, int sk_valid, int causal,
    float scale) {
  extern __shared__ float wide_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= Sq) return;
  const size_t bh = blockIdx.y;
  float* qs = wide_smem + static_cast<size_t>(warp) * 3 * D;
  float* dos = qs + D;
  float* acc = dos + D;
  widen_row(qs, q + (bh * Sq + row) * D, D, lane);
  widen_row(dos, dout + (bh * Sq + row) * D, D, lane);
  for (int d = lane; d < D; d += 32) acc[d] = 0.f;
  __syncwarp();
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  const float row_lse = lse[bh * Sq + row], row_delta = delta[bh * Sq + row];
  int n = sk_valid < Sk ? sk_valid : Sk;
  if (causal && row + 1 < n) n = row + 1;
  for (int j = 0; j < n; ++j) {
    const T* kr = kb + static_cast<size_t>(j) * D;
    const float p =
        expf(wide_score(qs, kr, bias, j, D, lane, scale) - row_lse);
    if (p == 0.f) continue;
    const float dp = row_dot(dos, vb + static_cast<size_t>(j) * D, D, lane);
    const float ds = p * (dp - row_delta);
    for (int d = lane; d < D; d += 32) acc[d] += ds * widen(kr[d]);
  }
  T* out = dq + (bh * Sq + row) * D;
  for (int d = lane; d < D; d += 32) store(out + d, acc[d] * scale);
}

template <typename T>
__global__ void flash_bwd_dkv_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ bias,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int D,
    int causal, float scale) {
  extern __shared__ float wide_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key = blockIdx.x * (blockDim.x >> 5) + warp;
  if (key >= Sk) return;
  const size_t bh = blockIdx.y;
  float* ks = wide_smem + static_cast<size_t>(warp) * 4 * D;
  float* vs = ks + D;
  float* dks = vs + D;
  float* dvs = dks + D;
  widen_row(ks, k + (bh * Sk + key) * D, D, lane);
  widen_row(vs, v + (bh * Sk + key) * D, D, lane);
  for (int d = lane; d < D; d += 32) dks[d] = dvs[d] = 0.f;
  __syncwarp();
  const T* qb = q + bh * Sq * D;
  const T* db = dout + bh * Sq * D;
  const float kbias = bias != nullptr ? bias[key] : 0.f;
  for (int i = causal ? key : 0; i < Sq; ++i) {
    const T* qr = qb + static_cast<size_t>(i) * D;
    float s = row_dot(ks, qr, D, lane) * scale;
    if (bias != nullptr) s += kbias;
    const float p = expf(s - lse[bh * Sq + i]);
    if (p == 0.f) continue;
    const T* dr = db + static_cast<size_t>(i) * D;
    const float dp = row_dot(vs, dr, D, lane);
    const float ds = p * (dp - delta[bh * Sq + i]);
    for (int d = lane; d < D; d += 32) {
      dvs[d] += p * widen(dr[d]);
      dks[d] += ds * widen(qr[d]);
    }
  }
  T* dkr = dk + (bh * Sk + key) * D;
  T* dvr = dv + (bh * Sk + key) * D;
  for (int d = lane; d < D; d += 32) {
    store(dkr + d, dks[d] * scale);
    store(dvr + d, dvs[d]);
  }
}

// W warps a block for `rows_per_warp` f32 rows of D a warp: 4, halved
// while the block's shared memory would pass the card's 227 KB; 0 when
// even one warp's does not fit.
inline int wide_warps(int D, int rows_per_warp, size_t* bytes) {
  for (int w = 4; w >= 1; w >>= 1) {
    *bytes = static_cast<size_t>(w) * rows_per_warp * D * sizeof(float);
    if (*bytes <= 232448) return w;
  }
  return 0;
}

template <typename K>
int wide_launch(K kern, int rows, int BH, int D, int rows_per_warp,
                dim3* grid, int* threads, size_t* bytes) {
  const int w = wide_warps(D, rows_per_warp, bytes);
  if (w == 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (int e = prepare(kern, *bytes)) return e;
  *grid = dim3((rows + w - 1) / w, BH);
  *threads = 32 * w;
  return 0;
}

template <typename T>
int fwd_wide(const void* q, const void* k, const void* v, const float* bias,
             void* o, float* lse, int BH, int Sq, int Sk, int D,
             int sk_valid, int causal, float scale, void* stream) {
  auto kern = flash_fwd_wide_kernel<T>;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid;
  int threads;
  size_t bytes;
  if (int e = wide_launch(kern, Sq, BH, D, 2, &grid, &threads, &bytes))
    return e;
  kern<<<grid, threads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), lse, Sq, Sk, D,
      sk_valid, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dq_wide(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                const float* bias, void* dq, int BH, int Sq, int Sk, int D,
                int sk_valid, int causal, float scale, void* stream) {
  auto kern = flash_bwd_dq_wide_kernel<T>;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid;
  int threads;
  size_t bytes;
  if (int e = wide_launch(kern, Sq, BH, D, 3, &grid, &threads, &bytes))
    return e;
  kern<<<grid, threads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      bias, static_cast<T*>(dq), Sq, Sk, D, sk_valid, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dkv_wide(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 const float* bias, void* dk, void* dv, int BH, int Sq,
                 int Sk, int D, int causal, float scale, void* stream) {
  auto kern = flash_bwd_dkv_wide_kernel<T>;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid;
  int threads;
  size_t bytes;
  if (int e = wide_launch(kern, Sk, BH, D, 4, &grid, &threads, &bytes))
    return e;
  kern<<<grid, threads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      bias, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, D, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
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

// The wide-head entry points (D > 128; any D the wrappers route here),
// with the same arguments as the ones above.
int flash_fwd_wide_f32(const void* q, const void* k, const void* v,
                       const float* bias, void* o, float* lse, int BH,
                       int Sq, int Sk, int D, int sk_valid, int causal,
                       float scale, void* stream) {
  return fwd_wide<float>(q, k, v, bias, o, lse, BH, Sq, Sk, D, sk_valid,
                         causal, scale, stream);
}

int flash_fwd_wide_bf16(const void* q, const void* k, const void* v,
                        const float* bias, void* o, float* lse, int BH,
                        int Sq, int Sk, int D, int sk_valid, int causal,
                        float scale, void* stream) {
  return fwd_wide<__nv_bfloat16>(q, k, v, bias, o, lse, BH, Sq, Sk, D,
                                 sk_valid, causal, scale, stream);
}

int flash_bwd_dq_wide_f32(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const float* bias, void* dq,
                          int BH, int Sq, int Sk, int D, int sk_valid,
                          int causal, float scale, void* stream) {
  return bwd_dq_wide<float>(q, k, v, dout, lse, delta, bias, dq, BH, Sq, Sk,
                            D, sk_valid, causal, scale, stream);
}

int flash_bwd_dq_wide_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const float* bias, void* dq,
                           int BH, int Sq, int Sk, int D, int sk_valid,
                           int causal, float scale, void* stream) {
  return bwd_dq_wide<__nv_bfloat16>(q, k, v, dout, lse, delta, bias, dq, BH,
                                    Sq, Sk, D, sk_valid, causal, scale,
                                    stream);
}

int flash_bwd_dkv_wide_f32(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const float* bias, void* dk,
                           void* dv, int BH, int Sq, int Sk, int D,
                           int causal, float scale, void* stream) {
  return bwd_dkv_wide<float>(q, k, v, dout, lse, delta, bias, dk, dv, BH, Sq,
                             Sk, D, causal, scale, stream);
}

int flash_bwd_dkv_wide_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const float* bias, void* dk,
                            void* dv, int BH, int Sq, int Sk, int D,
                            int causal, float scale, void* stream) {
  return bwd_dkv_wide<__nv_bfloat16>(q, k, v, dout, lse, delta, bias, dk, dv,
                                     BH, Sq, Sk, D, causal, scale, stream);
}

}  // extern "C"
