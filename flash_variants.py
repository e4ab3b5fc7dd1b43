#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels on one NVIDIA card: the
flash-attention forward (K3) and backward (K4, K5), and the LRN forward
(K1) and backward (K2), each checked against its plain version.

    python3 flash_variants.py [--parent DIR] [--cases a,b] [--ptxas DIR]
                              [VARIANT ...]

Each VARIANT is a named set of text substitutions in one kernel source,
caffe_mpi_tpu_torch/csrc/flash_attention.cu or lrn.cu (VARIANTS below;
with none given, the sources as they are). Every variant, the sources as
they are ("tree"), and with --parent DIR the parent checkout's sources,
are built with nvcc (all at once, with -Xptxas -v; with --ptxas DIR the
register and spill lines go to DIR/ptxas_<build>_<source stem>.txt). Then
each case of chip_smoke.py's _flash_cases() runs K3, K4 and K5 of every
build that has a flash library; each K1 case (norm1 and norm2 at the
serving batches 1, 4, 10 and the training batch 256) runs K1, and each
K2 case (norm1 and norm2 at batch 256) K2, of every build that has an
LRN library, in f32 and bf16, on the same inputs: held against the plain
versions (FLASH_TOL, or the LRN kernels' TOL; a miss is reported, not
fatal) and timed with chip_smoke's time_ms. Both LRN kernels are first
checked at chip_smoke's edge shapes and windows. --cases keeps the cases
named (flash labels such as s2048_d128, K2 labels such as norm1_float32,
K1 labels such as k1_norm1_b256_float32). One JSON line a case on
stdout; exit 1 if the tree's build missed a limit anywhere.
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
from caffe_mpi_tpu_torch.ops import lrn as lrn_op  # noqa: E402

FLASH, LRN = "flash_attention.cu", "lrn.cu"

# name: (source, [(text in the source, its replacement), ...], what the
# variant tests)
VARIANTS = {
    "cvt_rna": (FLASH, [(
        "    big[i] = __float_as_uint(x[i]) & 0xffffe000u;\n"
        "    small[i] =\n"
        "        (__float_as_uint(x[i] - __uint_as_float(big[i])) + 0x1000u) &\n"
        "        0xffffe000u;",
        "    asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(big[i]) : \"f\"(x[i]));\n"
        "    asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(small[i])\n"
        "        : \"f\"(x[i] - __uint_as_float(big[i])));")],
        "both 3xTF32 parts rounded by the cvt.rna instruction"),
    "one_sum": (FLASH, [(
        "    typename O::A a[BN / O::KS];\n#pragma unroll\n"
        "    for (int kk = 0; kk < BN; kk += O::KS)\n"
        "      O::a_from_c(a[kk / O::KS], c[kk / 8]);",
        "    if (true) {\n#pragma unroll\n"
        "      for (int kk = 0; kk < BN; kk += O::KS) {\n"
        "        typename O::A a1;\n        O::a_from_c(a1, c[kk / 8]);\n"
        "#pragma unroll\n        for (int n = 0; n < ND; ++n) {\n"
        "          typename O::B bf;\n"
        "          O::load_bt(bf, b + kk * ld + n * 8, ld, g, t);\n"
        "          O::mma_c(acc[n], a1, bf);\n        }\n      }\n"
        "      return;\n    }\n    typename O::A a[BN / O::KS];\n"
        "#pragma unroll\n    for (int kk = 0; kk < BN; kk += O::KS)\n"
        "      O::a_from_c(a[kk / O::KS], c[kk / 8]);")],
        "f32 dQ, dK, dV summed in their registers, no per-tile sums"),
    "no_split": (FLASH, [
        ("constexpr int SPLIT = W == 1 ? 2 : 1",
         "constexpr int SPLIT = 1"),
        ("  if (W == 1) {\n    constexpr int SPLIT = 2",
         "  if (false) {\n    constexpr int SPLIT = 2")],
        "one warp a row group at W = 1 (K3, K4 and K5)"),
    "no_ldmatrix": (FLASH, [
        ("constexpr bool kFwdLdmatrix = true;",
         "constexpr bool kFwdLdmatrix = false;")],
        "K3's bf16 fragments by scalar 16-bit loads, as K4 and K5"),
    "p_bf16": (FLASH, [
        ("        O::mma_c(part[0], a[kk / O::KS], b0);\n"
         "        O::mma_c(part[1], a[kk / O::KS], b1);",
         "        O::mma(part[0], a[kk / O::KS], b0);\n"
         "        O::mma(part[1], a[kk / O::KS], b1);")],
        "K3's bf16 P rounded once to bf16 (one product, no hi/lo split)"),
    "k3_bn32": (FLASH, [
        ("    constexpr int SPLIT = 1, BN = 64;",
         "    constexpr int SPLIT = 1, BN = DK >= 64 ? 32 : 64;")],
        "K3 takes key tiles of 32 from head dim 64 up, as K4 and K5"),
    "k3_w4": (FLASH, [
        ("  const int W = pick_warps(Sq, BH);",
         "  const int W = pick_warps(Sq, BH) > 4 ? 4 : pick_warps(Sq, BH);")],
        "K3 blocks of at most 4 row groups (two blocks an SM in f32 at D 128)"),
    "lrn_occ3": (LRN, [
        ("template <typename T, int H>\n__global__ void "
         "__launch_bounds__(kThreads)\nlrn_bwd_kernel(",
         "template <typename T, int H>\n__global__ void "
         "__launch_bounds__(kThreads, 3)\nlrn_bwd_kernel(")],
        "K2 held to three blocks an SM (at most 85 registers)"),
    "lrn_r8": (LRN, [("constexpr int kRun = 16;", "constexpr int kRun = 8;")],
               "K2 with runs of 8 channels a thread"),
    "lrn_r32": (LRN, [("constexpr int kRun = 16;",
                       "constexpr int kRun = 32;")],
                "K2 with runs of 32 channels a thread"),
    "k1_r8": (LRN, [("  const FwdShape order[] = {{32, kThreads},\n"
                     "                            {16, kThreads},",
                     "  const FwdShape order[] = {{kSmallRun, kThreads},\n"
                     "                            {kSmallRun, kThreads},")],
              "K1 with runs of 8 channels a thread at every grid"),
    "k1_r16": (LRN, [("  const FwdShape order[] = {{32, kThreads},",
                      "  const FwdShape order[] = {{16, kThreads},")],
               "K1 with runs of at most 16 channels a thread"),
    "k1_old": (LRN, [("  if (half > kMaxHalf) {  // K1's runtime window",
                      "  if (true) {  // K1's runtime window")],
               "K1's first design at every window: each output's window "
               "reloaded, in a runtime loop (runs of 8, one-axis grid)"),
    "k1_r32": (LRN, [("    if (blocks(N, C, HW, s.run, s.threads) >=\n"
                      "        static_cast<long long>(kFwdWaves) * num_sms())"
                      "\n      return s;",
                      "    return s;")],
               "K1 with runs of 32 in blocks of 256 at every grid (no "
               "small-grid rule)"),
    "k1_waves2": (LRN, [("constexpr int kFwdWaves = 8;",
                         "constexpr int kFwdWaves = 2;")],
                  "K1's longest run whose grid gives each SM 2 blocks (8 "
                  "in the tree)"),
    "k1_occ4": (LRN, [("template <typename T, int H, int R>\n__global__ "
                       "void __launch_bounds__(kThreads)\nlrn_fwd_kernel(",
                       "template <typename T, int H, int R>\n__global__ "
                       "void __launch_bounds__(kThreads, 4)\nlrn_fwd_kernel(")],
                "K1 held to four blocks an SM (at most 64 registers)"),
}


def _build(name: str, source: str, text: str, out_dir: str,
           ptxas_dir) -> str:
    """Build one source text; its -Xptxas -v lines go to `ptxas_dir`."""
    stem = os.path.splitext(source)[0]
    path = os.path.join(out_dir, f"{name}_{source}")
    with open(path, "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, f"lib{name}_{stem}.so")
    log = cs.build_lib(path, lib, extra=("-Xptxas", "-v"))
    if ptxas_dir:
        os.makedirs(ptxas_dir, exist_ok=True)
        with open(os.path.join(ptxas_dir, f"ptxas_{name}_{stem}.txt"),
                  "w") as f:
            f.write(log)
    return lib


def _sources(variants, parent) -> dict:
    """{(build name, source): source text}."""
    tree = {}
    for source in (FLASH, LRN):
        with open(os.path.join(build.CSRC_DIR, source)) as f:
            tree[source] = f.read()
    out = {("tree", src): text for src, text in tree.items()}
    for name in variants:
        source, subs, _ = VARIANTS[name]
        text = tree[source]
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: its text is not in "
                                 f"{source}")
            text = text.replace(old, new)
        out[(name, source)] = text
    if parent:
        for source in (FLASH, LRN):
            with open(os.path.join(os.path.abspath(parent),
                                   "caffe_mpi_tpu_torch", "csrc",
                                   source)) as f:
                out[("parent", source)] = f.read()
    return out


def _check(name, got, want, dtype, tol):
    """Max abs error, or the failure's text past the limit."""
    try:
        if tol == "flash":
            return cs._flash_close(name, got, want, dtype)
        torch.testing.assert_close(got.float(), want.float(), **cs.TOL[dtype])
        return float((got.float() - want.float()).abs().max())
    except (SystemExit, AssertionError) as e:
        return str(e).splitlines()[0][:200]


def _flash_rows(libs, only):
    gen = torch.Generator(device="cuda").manual_seed(3)
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
        refs = {"fwd": (o, lse),
                "dq": (fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kq),),
                "dkv": fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)}
        keep = slice(None) if skv is None else slice(0, skv)
        row = {"case": label, "shape": [bh, s, d],
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "max_abs_err": {}, "ms": {}}
        bwd_args = (q, k, v, do, lse, delta, causal, skv, kb)
        for name, lib in libs.items():
            calls = {
                "fwd": lambda lib=lib: cs.call_flash_fwd(lib, q, k, v,
                                                         causal, skv, kb),
                "dq": lambda lib=lib: cs.call_flash_bwd(lib, "dq",
                                                        *bwd_args),
                "dkv": lambda lib=lib: cs.call_flash_bwd(lib, "dkv",
                                                         *bwd_args)}
            for kind, call in calls.items():
                got = call()
                torch.cuda.synchronize()
                errs = []
                for i, (g, r) in enumerate(zip(got, refs[kind])):
                    # lse is f32; K5's rows past sk_valid are sliced off
                    dt = torch.float32 if kind == "fwd" and i else dtype
                    rows = keep if kind == "dkv" else slice(None)
                    errs.append(_check(f"{name} {label} {kind}",
                                       g[:, rows], r[:, rows], dt, "flash"))
                bad = [e for e in errs if isinstance(e, str)]
                row["max_abs_err"][f"{name}_{kind}"] = bad[0] if bad \
                    else max(errs)
                row["ms"][f"{name}_{kind}"] = cs.time_ms(call, reps=15)
        yield row, _tree_missed(row)
        del q, k, v, do, o, lse, delta, refs
        torch.cuda.empty_cache()


def _lrn_rows(libs, only, rates):
    gen = torch.Generator(device="cuda").manual_seed(1)
    args = (cs.LRN["size"], cs.LRN["alpha"], cs.LRN["beta"], cs.LRN["k"])
    calls = {"lrn_fwd": lambda lib, x, dy, *a: cs.call_lrn_fwd(lib, x, *a),
             "lrn_bwd": cs.call_lrn_bwd}
    refs = {"lrn_fwd": lambda x, dy, *a: lrn_op.lrn_across_channels_ref(
                x, *a),
            "lrn_bwd": lrn_op.lrn_across_channels_bwd_ref}
    # the edge shapes at every edge window, checked only
    edge = {f"{name}_{kind}": 0.0 for name in libs for kind in calls}
    for shape in cs.EDGE_SHAPES:
        for size in cs.EDGE_SIZES:
            for dtype in cs.TOL:
                x = (torch.randn(shape, generator=gen, device="cuda")
                     * 4).to(dtype)
                dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                hyper = (size, 1e-2, 0.75, 2.0)
                for kind, call in calls.items():
                    ref = refs[kind](x, dy, *hyper)
                    for name, lib in libs.items():
                        key = f"{name}_{kind}"
                        if isinstance(edge[key], str):  # keep the first miss
                            continue
                        try:
                            got = call(lib, x, dy, *hyper)
                        except SystemExit as e:  # a refused window, as the
                            edge[key] = str(e)   # parent's K2 past 15
                            continue
                        err = _check(f"{key} edge", got, ref, dtype, "lrn")
                        edge[key] = err if isinstance(err, str) \
                            else max(edge[key], err)
    yield {"case": "lrn_edge_shapes", "max_abs_err": edge}, \
        _tree_missed({"max_abs_err": edge})
    cases = [("lrn_fwd", f"k1_{layer}_b{shape[0]}", shape)
             for layer, shape in cs._alexnet_lrn_shapes((1, 4, 10, 256))]
    cases += [("lrn_bwd", layer, shape)
              for layer, shape in cs._alexnet_lrn_shapes((256,))]
    for kind, layer, shape in cases:
        for dtype in cs.TOL:
            label = f"{layer}_{str(dtype).replace('torch.', '')}"
            if only and label not in only:
                continue
            x = (torch.randn(shape, generator=gen, device="cuda") * 4).to(dtype)
            dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            ref = refs[kind](x, dy, *args)
            bound, by = cs.lrn_bound(shape, dtype, cs.LRN["size"], rates) \
                if kind == "lrn_fwd" else cs.lrn_bound(
                    shape, dtype, cs.LRN["size"], rates, tensors=3,
                    ops_per_elem=3 * cs.LRN["size"] + 10)
            row = {"case": label, "kernel": kind, "shape": list(shape),
                   "dtype": str(dtype).replace("torch.", ""),
                   "bound_ms": bound, "bound_by": by,
                   "max_abs_err": {}, "ms": {}}
            for name, lib in libs.items():
                got = calls[kind](lib, x, dy, *args)
                torch.cuda.synchronize()
                row["max_abs_err"][f"{name}_{kind}"] = _check(
                    f"{name} {label}", got, ref, dtype, "lrn")
                row["ms"][f"{name}_{kind}"] = cs.time_ms(
                    lambda lib=lib: calls[kind](lib, x, dy, *args), reps=15)
            yield row, _tree_missed(row)
            del x, dy, ref
            torch.cuda.empty_cache()


def _tree_missed(row) -> bool:
    """Whether the tree's build missed a limit in this row."""
    return any(isinstance(err, str) for key, err in
               row["max_abs_err"].items() if key.startswith("tree_"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", choices=sorted(VARIANTS))
    ap.add_argument("--parent", metavar="DIR")
    ap.add_argument("--cases", default="")
    ap.add_argument("--ptxas", metavar="DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: no card")
    card, rates = cs.device_phase()
    sources = _sources(args.variants, args.parent)
    tmp = tempfile.mkdtemp(prefix="flash_variants_")
    try:
        with ThreadPoolExecutor(len(sources)) as ex:
            paths = dict(zip(sources, ex.map(
                lambda item: _build(item[0][0], item[0][1], item[1], tmp,
                                    args.ptxas),
                sources.items())))
        flash_libs = {n: cs.bind_flash(p) for (n, src), p in paths.items()
                      if src == FLASH}
        lrn_libs = {n: cs.bind_lrn(p) for (n, src), p in paths.items()
                    if src == LRN}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"card": card, "builds": [list(b) for b in paths],
                      "variants": {n: VARIANTS[n][2]
                                   for n in args.variants}}), flush=True)

    only = set(filter(None, args.cases.split(",")))
    missed = 0
    for rows in (_flash_rows(flash_libs, only),
                 _lrn_rows(lrn_libs, only, rates)):
        for row, miss in rows:
            print(json.dumps(row), flush=True)
            missed += miss
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
