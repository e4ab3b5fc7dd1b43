"""The LRN forward K1 of `caffe_mpi_tpu_torch/csrc/lrn.cu`, checked on the
CPU two ways, since no CUDA compiler runs here.

1. A numpy emulation of one thread's walk, vectorised over the threads
   (every image and position) of a channel run: R channels, a zero halo
   of h = (size - 1) / 2 on each side loaded once into "registers", each
   square formed once, each output's window sum taken from the registers
   in ascending order (0 + x_{c-h}^2 + ... + x_{c+h}^2), runs that end
   past C, and the runtime-window walk for h > 7 (runs of 8, each window
   read again). Its scale and output are held BITWISE against the plain
   version's, the property K1 keeps on the card (max_abs_err 0).
2. The CUDA source itself, built with g++ over mocked CUDA builtins
   (`__global__` and friends; blockIdx, threadIdx and blockDim as
   globals; a launch `k<<<grid, threads, ...>>>(...)` a loop over every
   block and thread; `__f*_rn` as f32 operations with contraction off;
   bf16 with round-to-nearest-even) and called through its C entry
   points: K1 and K2 at the edge shapes, every window size up to 19 and
   both types, held bitwise against the plain versions with exp and log
   replaced by the identity on both sides (the libraries' exp and log
   differ by an ulp between glibc and torch), and within the LRN tests'
   tolerances with them. The grid each launch picks is held against the
   launcher's rule. Skipped where there is no g++.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from caffe_mpi_tpu_torch.ops import lrn as lrn_op

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_ROOT, "caffe_mpi_tpu_torch", "csrc", "lrn.cu")
SHAPES = [(2, 96, 13, 13), (1, 3, 5, 5), (2, 16, 1, 1), (1, 8, 7, 9),
          (3, 40, 2, 3)]  # the edge shapes; C 40 ends a run of 16 at 8
SIZES = [1, 3, 5, 7, 15, 17]
ALPHA, BETA, K = 1e-2, 0.75, 2.0
MAX_HALF = 7              # csrc/lrn.cu kMaxHalf
RUNS = (32, 16, 8)        # the runs K1's launcher picks from
F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=8e-3, atol=1e-6)


def _x(shape, seed, scale=4.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# -- 1. the numpy emulation ---------------------------------------------------

def emulate_scale(x, size, alpha, beta, k, run):
    """The scale of every element as K1's threads form it: x (N, C, HW)
    f32; `run` channels a thread (R), each thread one (image, position).
    The arguments reach the kernel as f32 (ctypes c_float)."""
    n, c, hw = x.shape
    h = (size - 1) // 2
    a_n, kk = np.float32(alpha / size), np.float32(k)
    zero = np.zeros((n, hw), np.float32)
    scale = np.full(x.shape, np.nan, np.float32)
    if h > MAX_HALF:  # the runtime-window kernel: runs of 8, windows reread
        for c0 in range(0, c, 8):
            for ch in range(c0, min(c0 + 8, c)):
                s = zero.copy()
                for j in range(max(ch - h, 0), min(ch + h, c - 1) + 1):
                    s = s + x[:, j] * x[:, j]
                scale[:, ch] = kk + s * a_n
        return scale
    for c0 in range(0, c, run):
        # the registers: channel c0 - h + i, zero past the edges
        xv = [x[:, j] if 0 <= j < c else zero
              for j in range(c0 - h, c0 + run + h)]
        sq = [v * v for v in xv]  # each square once
        for i in range(run):
            ch = c0 + i
            if ch >= c:  # the run ends past C
                break
            s = zero.copy()
            for d in range(2 * h + 1):  # ascending, from the registers
                s = s + sq[i + d]
            scale[:, ch] = kk + s * a_n
    return scale


def _plain_scale(xt, size, alpha, k):
    """The plain version's scale, as lrn_across_channels_ref forms it."""
    xf = xt.float()
    return k + lrn_op._window_sum(xf * xf, size) * (alpha / size)


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_k1_equals_the_plain_version_bitwise(shape, size, run):
    x = _x(shape, size)
    n, c, h, w = shape
    scale = emulate_scale(x.reshape(n, c, h * w), size, ALPHA, BETA, K,
                          run).reshape(shape)
    xt = torch.from_numpy(x)
    want = _plain_scale(xt, size, ALPHA, K)
    assert not np.isnan(scale).any()
    np.testing.assert_array_equal(scale, want.numpy())
    # x_c from the registers times scale^-beta: the plain output, bitwise
    y = xt * torch.exp(-BETA * torch.log(torch.from_numpy(scale)))
    assert torch.equal(y, lrn_op.lrn_across_channels_ref(xt, size, ALPHA,
                                                          BETA, K))


def test_emulated_window_sum_of_a_run_that_ends_past_c():
    """C = 3 under a run of 16 with the halo at both edges: every register
    past the edges is zero, and channels 3.. are never written."""
    x = _x((1, 3, 2, 2), 1).reshape(1, 3, 4)
    scale = emulate_scale(x, 5, ALPHA, BETA, K, 16)
    sq = x * x
    want = np.float32(K) + (np.float32(0) + sq[:, 0] + sq[:, 1]
                            + sq[:, 2]) * np.float32(ALPHA / 5)
    np.testing.assert_array_equal(scale[:, 1], want)


# -- 2. the CUDA source under g++ --------------------------------------------

MOCK = r'''
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
struct dim3 { unsigned x = 1, y = 1, z = 1; };
static dim3 blockIdx, threadIdx, blockDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
extern "C" {
int emul_sms = 132, emul_identity = 0, emul_grid = 0, emul_threads = 0;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = emul_sms;
  return cudaSuccess;
}
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float emul_expf(float v) { return emul_identity ? v : std::exp(v); }
inline float emul_logf(float v) { return emul_identity ? v : std::log(v); }
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
template <class Kern, class... A>
void emul_launch(unsigned grid, int threads, int, cudaStream_t, Kern kern,
                 A... args) {
  emul_grid = grid;
  emul_threads = threads;
  blockDim.x = threads;
  for (unsigned b = 0; b < grid; ++b)
    for (int t = 0; t < threads; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      kern(args...);
    }
}
'''


def _cpp_text(src: str) -> str:
    """lrn.cu as C++ over the mock: launches as emul_launch calls, exp and
    log through the switchable mock, the SM count read at every launch."""
    text, n = re.subn(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<(.*?)>>>\(",
                      r"emul_launch(\2, \1, ", src)
    assert n >= 4, "the launches of lrn.cu were not found"
    text = re.sub(r"\b(expf|logf)\(", r"emul_\1(", text)
    assert "static int n = 0;" in text
    return text.replace("static int n = 0;", "int n = 0;")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA source over the mocks")
    d = tmp_path_factory.mktemp("lrn_gxx")
    (d / "cuda_runtime.h").write_text(MOCK)
    (d / "cuda_bf16.h").write_text("#pragma once\n#include <cuda_runtime.h>\n")
    with open(_SOURCE) as f:
        (d / "lrn.cpp").write_text(_cpp_text(f.read()))
    out = str(d / "liblrn_emul.so")
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-w", "-I", str(d), "-o", out,
                    str(d / "lrn.cpp")], check=True, timeout=300)
    so = ctypes.CDLL(out)
    P, I, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for dt in ("f32", "bf16"):
        getattr(so, f"lrn_fwd_{dt}").argtypes = [P, P, I, I, I, I, F_, F_,
                                                 F_, P]
        getattr(so, f"lrn_bwd_{dt}").argtypes = [P, P, P, I, I, I, I, F_,
                                                 F_, F_, F_, P]
    return so


def _var(so, name):
    return ctypes.c_int.in_dll(so, name)


def _run(so, x, dy, size, sms=132, identity=False):
    """K1's y and K2's dx from the C entry points; the grid K1 took."""
    _var(so, "emul_sms").value = sms
    _var(so, "emul_identity").value = int(identity)
    n, c, h, w = x.shape
    dt = "f32" if x.dtype == torch.float32 else "bf16"
    y, dx = torch.empty_like(x), torch.empty_like(x)
    a_n = ALPHA / size
    assert getattr(so, f"lrn_fwd_{dt}")(x.data_ptr(), y.data_ptr(), n, c,
                                        h * w, size, a_n, BETA, K,
                                        None) == 0
    grid = (_var(so, "emul_grid").value, _var(so, "emul_threads").value)
    assert getattr(so, f"lrn_bwd_{dt}")(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, c, h * w, size, a_n,
        BETA, K, 2.0 * ALPHA * BETA / size, None) == 0
    return y, dx, grid


def _inputs(shape, dtype, seed):
    x = torch.from_numpy(_x(shape, seed)).to(dtype)
    dy = torch.from_numpy(_x(shape, seed + 1, 1.0)).to(dtype)
    return x, dy


def _identity(monkeypatch):
    monkeypatch.setattr(torch, "exp", lambda t: t)
    monkeypatch.setattr(torch, "log", lambda t: t)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", SIZES + [19])
def test_source_equals_the_plain_versions_bitwise(lib, size, dtype, sms,
                                                  monkeypatch):
    """Everything but exp and log, bitwise: with both replaced by the
    identity on each side, K1 and K2 (register and runtime-window
    kernels, every grid the launcher picks) give the plain versions'
    very bits."""
    _identity(monkeypatch)
    for i, shape in enumerate(SHAPES):
        x, dy = _inputs(shape, dtype, 10 * size + i)
        y, dx, _ = _run(lib, x, dy, size, sms, identity=True)
        assert torch.equal(y, lrn_op.lrn_across_channels_ref(
            x, size, ALPHA, BETA, K)), (shape, "fwd")
        assert torch.equal(dx, lrn_op.lrn_across_channels_bwd_ref(
            x, dy, size, ALPHA, BETA, K)), (shape, "bwd")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_source_with_exp_and_log_meets_the_lrn_tolerances(lib, dtype):
    tol = F32 if dtype == torch.float32 else BF16
    for size in SIZES:
        for i, shape in enumerate(SHAPES):
            x, dy = _inputs(shape, dtype, 100 + size + i)
            y, dx, _ = _run(lib, x, dy, size)
            for got, want in (
                    (y, lrn_op.lrn_across_channels_ref(x, size, ALPHA, BETA,
                                                       K)),
                    (dx, lrn_op.lrn_across_channels_bwd_ref(
                        x, dy, size, ALPHA, BETA, K))):
                torch.testing.assert_close(got.float(), want.float(), **tol)


def pick_fwd(n, c, hw, size, sms):
    """K1's (blocks, threads) by the launcher's rule: the longest run of
    32, 16 or 8 channels in blocks of 256 positions whose grid gives every
    SM 8 blocks, else runs of 8 in blocks of 128; windows past 15 runs of
    8 in blocks of 256."""
    def blocks(run, threads):
        return n * -(-c // run) * -(-hw // threads)
    if (size - 1) // 2 > MAX_HALF:
        return blocks(8, 256), 256
    for run in RUNS:
        if blocks(run, 256) >= 8 * sms:
            return blocks(run, 256), 256
    return blocks(8, 128), 128


@pytest.mark.parametrize("sms", [1, 4, 132])
@pytest.mark.parametrize("size", [5, 17])
def test_source_picks_the_grid_of_the_launchers_rule(lib, size, sms):
    for shape in SHAPES + [(12, 40, 20, 20), (40, 40, 9, 9)]:
        x, dy = _inputs(shape, torch.float32, 7)
        n, c, h, w = shape
        assert _run(lib, x, dy, size, sms)[2] == pick_fwd(n, c, h * w, size,
                                                          sms), shape


def test_the_serving_and_training_grids():
    """Where the rule puts AlexNet's LRNs on a 132-SM H100: runs of 32 at
    the training batch 256, runs of 8 at serving's batch 10, and runs of
    8 in blocks of 128 at batches 1 and 4."""
    got = {(b, c): pick_fwd(b, c, hw, 5, 132)
           for b in (1, 4, 10, 256) for c, hw in ((96, 3025), (256, 729))}
    assert got[(256, 96)] == (256 * 3 * 12, 256)
    assert got[(256, 256)] == (256 * 8 * 3, 256)
    assert got[(10, 96)] == (10 * 12 * 12, 256)
    assert got[(10, 256)] == (10 * 32 * 6, 128)
    assert got[(4, 96)] == (4 * 12 * 24, 128)
    assert got[(4, 256)] == (4 * 32 * 6, 128)
    assert got[(1, 96)] == (12 * 24, 128)
    assert got[(1, 256)] == (32 * 6, 128)
