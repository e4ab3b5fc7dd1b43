"""The wide-head flash kernels of `caffe_mpi_tpu_torch/csrc/flash_attention.cu`
(K3, K4 and K5 for D > 128), checked on the CPU, since no CUDA compiler
runs here.

Their section of the source is built with g++ over mocked CUDA builtins
and called through its C entry points: a launch runs every block in turn
and every thread of a block as a host thread; the lanes of each warp meet
at a barrier in `__shfl_xor_sync` and `__syncwarp`, so a shuffle reached
by some lanes of a warp and not by others would hang rather than pass
(the design claims every branch on a score is warp-uniform); shared memory
is one host array that the blocks, run one at a time, reuse. bf16 has
round-to-nearest-even.

Held against the plain versions (`flash_fwd_ref`, `flash_bwd_dq_ref`,
`flash_bwd_dkv_ref`) at D 160 and 256, causal and not, with a ragged
sk_valid and with a key bias, in both types, at chip_smoke.py's
FLASH_TOL (f32: rtol 1e-5 plus 1e-5 of the largest plain element, both
summing in f32 in other orders; bf16: rtol 8e-3, one bf16 ulp of the
output). The grid and shared memory each launch takes are held against
the launcher's rule (4 warps a block, halved while the block would pass
227 KB). Skipped where there is no g++.
"""

import ctypes
import math
import os
import re
import shutil
import subprocess

import pytest
import torch

from caffe_mpi_tpu_torch.ops import flash_attention as fa

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_ROOT, "caffe_mpi_tpu_torch", "csrc",
                       "flash_attention.cu")
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (8e-3, 1e-5)}
SMEM = 232448  # bytes a block may use on the card

MOCK = r'''
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
thread_local dim3 blockIdx, threadIdx;
static dim3 blockDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  return bytes <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
extern "C" {
int emul_grid_x = 0, emul_grid_y = 0, emul_threads = 0;
long emul_bytes = 0;
}
static float emul_smem[1 << 18];
struct EmulWarp {
  std::barrier<> bar{32};
  float xch[32];
};
thread_local EmulWarp* emul_warp;
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int lane = threadIdx.x & 31;
  emul_warp->xch[lane] = v;
  emul_warp->bar.arrive_and_wait();
  const float r = emul_warp->xch[lane ^ o];
  emul_warp->bar.arrive_and_wait();
  return r;
}
inline void __syncwarp() { emul_warp->bar.arrive_and_wait(); }
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = uint32_t(h.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7FFF + ((u >> 16) & 1);
  return __nv_bfloat16{uint16_t(u >> 16)};
}
inline float __int_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
template <class Kern, class... A>
void emul_launch(dim3 grid, int threads, size_t bytes, cudaStream_t,
                 Kern kern, A... args) {
  emul_grid_x = grid.x;
  emul_grid_y = grid.y;
  emul_threads = threads;
  emul_bytes = static_cast<long>(bytes);
  blockDim = dim3(threads);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::unique_ptr<EmulWarp[]> warps(new EmulWarp[threads / 32]);
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, t] {
          blockIdx = dim3(bx, by);
          threadIdx = dim3(t);
          emul_warp = &warps[t / 32];
          kern(args...);
        });
      for (auto& th : ts) th.join();
    }
}
'''


def _section(src, start, end):
    i = src.index(start)
    return src[i:src.index(end, i)]


def _cpp_text(src: str) -> str:
    """The wide kernels' section of flash_attention.cu with the helpers it
    uses, launches as emul_launch calls, shared memory the mock's array."""
    helpers = (
        _section(src, "__device__ __forceinline__ float neg_inf()", "\n")
        + "\n" + _section(src, "__device__ __forceinline__ void store(float*",
                          "// ---")
        + _section(src, "template <typename K>\nint prepare(", "\n}\n")
        + "\n}\n")
    wide = _section(src, "// -- Wide heads", "}  // namespace")
    entries = _section(src, "// The wide-head entry points",
                       '}  // extern "C"')
    text = ("#include <cuda_runtime.h>\n#include <cuda_bf16.h>\n"
            "namespace {\n" + helpers + wide + "}  // namespace\n"
            'extern "C" {\n' + entries + '}  // extern "C"\n')
    text, n = re.subn(r"([A-Za-z_]\w*)<<<(.*?)>>>\(",
                      r"emul_launch(\2, \1, ", text, flags=re.S)
    assert n == 3, "the three wide launches were not found"
    n_smem = text.count("extern __shared__ float wide_smem[];")
    assert n_smem == 3
    return text.replace("extern __shared__ float wide_smem[];",
                        "float* wide_smem = emul_smem;")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA source over the mocks")
    d = tmp_path_factory.mktemp("flash_wide_gxx")
    (d / "cuda_runtime.h").write_text(MOCK)
    (d / "cuda_bf16.h").write_text("#pragma once\n#include <cuda_runtime.h>\n")
    with open(_SOURCE) as f:
        (d / "wide.cpp").write_text(_cpp_text(f.read()))
    out = str(d / "libwide_emul.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", "-w", "-I", str(d), "-o", out,
                    str(d / "wide.cpp")], check=True, timeout=300)
    so = ctypes.CDLL(out)
    P, I, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for dt in ("f32", "bf16"):
        getattr(so, f"flash_fwd_wide_{dt}").argtypes = \
            [P] * 6 + [I] * 6 + [F_, P]
        getattr(so, f"flash_bwd_dq_wide_{dt}").argtypes = \
            [P] * 8 + [I] * 6 + [F_, P]
        getattr(so, f"flash_bwd_dkv_wide_{dt}").argtypes = \
            [P] * 9 + [I] * 5 + [F_, P]
    return so


def _launch(so):
    return tuple(ctypes.c_int.in_dll(so, n).value for n in
                 ("emul_grid_x", "emul_grid_y", "emul_threads")) + \
        (ctypes.c_long.in_dll(so, "emul_bytes").value,)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _close(name, got, want, dtype):
    rtol, share = TOL[dtype]
    g, w = got.float(), want.float()
    bound = share * float(w.abs().max()) + rtol * w.abs()
    assert bool(torch.all((g - w).abs() <= bound)), \
        f"{name}: max abs error {float((g - w).abs().max()):.3g}"


def _run_all(so, q, k, v, do, causal, sk_valid, kb):
    """The three wide entry points on CPU tensors; (o, lse, dq, dk, dv) and
    each launch's (grid x, grid y, threads, bytes)."""
    dt = "f32" if q.dtype == torch.float32 else "bf16"
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    o, lse = torch.empty_like(q), torch.empty(bh, sq)
    assert getattr(so, f"flash_fwd_wide_{dt}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kb), o.data_ptr(),
        lse.data_ptr(), bh, sq, sk, d, sk_valid, int(causal), scale,
        None) == 0
    grids = [_launch(so)]
    delta = fa._delta(do, o).contiguous()
    dq = torch.empty_like(q)
    assert getattr(so, f"flash_bwd_dq_wide_{dt}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(kb), dq.data_ptr(), bh, sq,
        sk, d, sk_valid, int(causal), scale, None) == 0
    grids.append(_launch(so))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    assert getattr(so, f"flash_bwd_dkv_wide_{dt}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(kb), dk.data_ptr(),
        dv.data_ptr(), bh, sq, sk, d, int(causal), scale, None) == 0
    grids.append(_launch(so))
    return (o, lse, dq, dk, dv, delta), grids


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [160, 256])
def test_wide_source_matches_the_plain_versions(lib, d, causal, dtype):
    """(BH 1, S 20, D): sk_valid 15 (rows past it zero, as flash_attention
    pads), then the key bias masking the last 4 keys, and 4 warps a block:
    grid (5, 1), 128 threads, 2/3/4 rows of D floats a warp."""
    gen = torch.Generator().manual_seed(d + causal)
    q, k, v, do = (torch.randn((1, 20, d), generator=gen).to(dtype)
                   for _ in range(4))
    for sk_valid, kb in ((15, None), (20, torch.zeros(1, 20))):
        if kb is not None:
            kb[0, 16:] = -math.inf
            kb[0, :16] = torch.linspace(-1, 1, 16)
        else:
            for t in (q, k, v, do):
                t[:, sk_valid:] = 0
        (o, lse, dq, dk, dv, delta), grids = _run_all(
            lib, q, k, v, do, causal, sk_valid, kb)
        kq = dict(causal=causal, sk_valid=sk_valid, k_bias=kb)
        o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, **kq)
        dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kq)
        dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta,
                                              causal=causal, k_bias=kb)
        _close("O", o, o_ref, dtype)
        _close("lse", lse, lse_ref, torch.float32)
        _close("dQ", dq, dq_ref, dtype)
        keep = slice(0, sk_valid)
        _close("dK", dk[:, keep], dk_ref[:, keep], dtype)
        _close("dV", dv[:, keep], dv_ref[:, keep], dtype)
        assert grids == [(5, 1, 128, 4 * r * d * 4) for r in (2, 3, 4)]


def test_wide_source_fully_masked_rows_and_small_blocks(lib):
    """A key bias masking every key: O = 0 and lse = log(1e-30), no NaN;
    at D 8000 the launcher halves the warps a block until the block's
    shared memory fits (K3 2, K4 2, K5 1 warps)."""
    q = torch.randn(1, 3, 200)
    kb = torch.full((1, 3), -math.inf)
    (o, lse, dq, dk, dv, _), _ = _run_all(lib, q, q, q, q, False, 3, kb)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.allclose(lse, torch.full_like(lse, math.log(1e-30)))
    for t in (dq, dk, dv):
        assert torch.equal(t, torch.zeros_like(t))
    big = torch.randn(1, 2, 8000) * 0.05
    (o, lse, dq, dk, dv, delta), grids = _run_all(lib, big, big, big, big,
                                                  True, 2, None)
    assert [g[2] for g in grids] == [64, 64, 32]
    assert all(g[3] <= SMEM for g in grids)
    o_ref, _ = fa.flash_fwd_ref(big, big, big, causal=True)
    _close("O", o, o_ref, torch.float32)
    too_wide = torch.randn(1, 1, 15000)
    dt = torch.empty_like(too_wide)
    assert lib.flash_bwd_dkv_wide_f32(
        too_wide.data_ptr(), too_wide.data_ptr(), too_wide.data_ptr(),
        too_wide.data_ptr(), dt.data_ptr(), dt.data_ptr(), None,
        dt.data_ptr(), dt.data_ptr(), 1, 1, 1, 15000, 0, 1.0, None) != 0
