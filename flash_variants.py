#!/usr/bin/env python3
"""Time variants of the flash-attention backward kernels (K4, K5) on one
NVIDIA card, each checked against the plain versions.

    python3 flash_variants.py [--parent DIR] [--cases a,b] [--ptxas DIR]
                              [VARIANT ...]

Each VARIANT is a named text substitution in
caffe_mpi_tpu_torch/csrc/flash_attention.cu (VARIANTS below; with none
given, the source as it is). Every variant, the source as it is, and with
--parent DIR the parent checkout's flash_attention.cu, is built with nvcc
(all at once, with -Xptxas -v; with --ptxas DIR its register and spill
lines go to DIR/ptxas_<name>.txt), then each case of chip_smoke.py's
_flash_cases() (or those named in --cases) runs K4 and K5 of every build
on the same inputs: held against flash_bwd_dq_ref / flash_bwd_dkv_ref at
FLASH_TOL (a miss is reported, not fatal) and timed with chip_smoke's
time_ms. One JSON line a case on stdout; exit 1 if this tree's build
missed FLASH_TOL anywhere.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from caffe_mpi_tpu_torch.ops import build  # noqa: E402
from caffe_mpi_tpu_torch.ops import flash_attention as fa  # noqa: E402

# name: (text in the source, its replacement, what the variant tests)
VARIANTS = {
    "cvt_rna": (
        "    big[i] = __float_as_uint(x[i]) & 0xffffe000u;\n"
        "    small[i] =\n"
        "        (__float_as_uint(x[i] - __uint_as_float(big[i])) + 0x1000u) &\n"
        "        0xffffe000u;",
        "    asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(big[i]) : \"f\"(x[i]));\n"
        "    asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(small[i])\n"
        "        : \"f\"(x[i] - __uint_as_float(big[i])));",
        "both 3xTF32 parts rounded by the cvt.rna instruction"),
    "one_sum": (
        "    typename O::A a[BN / O::KS];",
        "    if (true) {\n#pragma unroll\n"
        "      for (int kk = 0; kk < BN; kk += O::KS) {\n"
        "        typename O::A a1;\n        O::a_from_c(a1, c[kk / 8]);\n"
        "#pragma unroll\n        for (int n = 0; n < ND; ++n) {\n"
        "          typename O::B bf;\n"
        "          O::load_bt(bf, b + kk * ld + n * 8, ld, g, t);\n"
        "          O::mma_c(acc[n], a1, bf);\n        }\n      }\n"
        "      return;\n    }\n    typename O::A a[BN / O::KS];",
        "f32 dQ, dK, dV summed in their registers, no per-tile sums"),
    "no_split": (
        "constexpr int SPLIT = W == 1 ? 2 : 1",
        "constexpr int SPLIT = 1",
        "one warp a row group at W = 1"),
}


def _build(name: str, src: str, out_dir: str, ptxas_dir) -> str:
    """Build one source; its -Xptxas -v lines go to `ptxas_dir`, if any."""
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"lib{name}.so")
    log = cs.build_flash_lib(path, lib, extra=("-Xptxas", "-v"))
    if ptxas_dir:
        os.makedirs(ptxas_dir, exist_ok=True)
        with open(os.path.join(ptxas_dir, f"ptxas_{name}.txt"), "w") as f:
            f.write(log)
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", choices=sorted(VARIANTS))
    ap.add_argument("--parent", metavar="DIR")
    ap.add_argument("--cases", default="")
    ap.add_argument("--ptxas", metavar="DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: no card")
    with open(os.path.join(build.CSRC_DIR, "flash_attention.cu")) as f:
        src = f.read()
    sources = {"tree": src}
    for name in args.variants:
        old, new, _ = VARIANTS[name]
        if old not in src:
            raise SystemExit(f"variant {name}: its text is not in the source")
        sources[name] = src.replace(old, new)
    if args.parent:
        with open(os.path.join(os.path.abspath(args.parent),
                               "caffe_mpi_tpu_torch", "csrc",
                               "flash_attention.cu")) as f:
            sources["parent"] = f.read()
    tmp = tempfile.mkdtemp(prefix="flash_variants_")
    try:
        with ThreadPoolExecutor(len(sources)) as ex:
            paths = dict(zip(sources, ex.map(
                lambda item: _build(item[0], item[1], tmp, args.ptxas),
                sources.items())))
        libs = {n: cs.bind_flash_bwd(p) for n, p in paths.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "builds": list(libs),
                      "variants": {n: VARIANTS[n][2]
                                   for n in args.variants}}), flush=True)

    only = set(filter(None, args.cases.split(",")))
    gen = torch.Generator(device="cuda").manual_seed(3)
    missed = 0
    for label, bh, s, d, dtype, causal, skv, bias in cs._flash_cases():
        if only and label not in only:
            continue
        q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        kb = None
        if skv is not None:
            for t in (q, k, v, do):
                t[:, skv:] = 0
        if bias:
            kb = torch.zeros((1, s), device="cuda")
            kb[0, :128] = torch.linspace(-1.0, 1.0, 128, device="cuda")
            kb[0, 128:] = -float("inf")
        kq = dict(causal=causal, sk_valid=skv, k_bias=kb)
        kw = dict(causal=causal, k_bias=kb)
        o, lse = fa.flash_fwd_ref(q, k, v, **kq)
        delta = fa._delta(do, o)
        refs = {"dq": (fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kq),),
                "dkv": fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)}
        keep = slice(None) if skv is None else slice(0, skv)
        row = {"case": label, "shape": [bh, s, d],
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "max_abs_err": {}, "ms": {}}
        call_args = (q, k, v, do, lse, delta, causal, skv, kb)
        for name, lib in libs.items():
            for kind in ("dq", "dkv"):
                got = cs.call_flash_bwd(lib, kind, *call_args)
                torch.cuda.synchronize()
                try:
                    row["max_abs_err"][f"{name}_{kind}"] = max(
                        cs._flash_close(f"{name} {label} {kind}", g[:, keep],
                                        r[:, keep], dtype)
                        for g, r in zip(got, refs[kind]))
                except SystemExit as e:
                    row["max_abs_err"][f"{name}_{kind}"] = str(e)
                    missed += name == "tree"
                row["ms"][f"{name}_{kind}"] = cs.time_ms(
                    lambda: cs.call_flash_bwd(lib, kind, *call_args),
                    reps=15)
        print(json.dumps(row), flush=True)
        del q, k, v, do, o, lse, delta, refs
        torch.cuda.empty_cache()
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
