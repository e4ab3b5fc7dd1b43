"""The port's lint core and netlint (caffe_mpi_tpu_torch/tools/lint/) held
against the JAX package's on the same files.

Findings are compared exactly — pass, file, line and message — since both
run the same checks over the same engine arithmetic. The footprint budget
is the one deliberate difference (one H100's memory against one v5e
chip's), so a comparison that can reach it pins CAFFE_NETLINT_HBM_MB for
both sides.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from caffe_mpi_tpu.tools import lint as jlint
from caffe_mpi_tpu.tools.lint import netlint as jnetlint
from caffe_mpi_tpu_torch.tools import lint
from caffe_mpi_tpu_torch.tools.lint import netlint
from caffe_mpi_tpu_torch.utils.flops import card_memory_mb
from test_netlint import _INPUT_2, _NON_RGB, MUTATIONS

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def findings(root, lint_pkg, select=netlint.NET_PASSES) -> list[tuple]:
    got = lint_pkg.run_lint(paths=[], select=list(select), root=str(root))
    return [(f.pass_name, os.path.relpath(f.path, str(root)), f.line,
             f.message) for f in got]


def both(root, select=netlint.NET_PASSES) -> list[tuple]:
    """The port's findings, after holding them equal to the JAX
    package's."""
    got = findings(root, lint, select)
    assert got == findings(root, jlint, select)
    return got


def write(root, body, name="models/fixture/net.prototxt"):
    p = root / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(body))
    return p


@pytest.fixture
def same_budget(monkeypatch):
    monkeypatch.setenv("CAFFE_NETLINT_HBM_MB", "16384")


CONCURRENCY_PASSES = ("lock-order", "blocking-under-lock",
                      "thread-shared-mutation")


def test_the_port_registers_the_six_net_passes():
    lint._load_passes()
    jlint._load_passes()
    assert set(netlint.NET_PASSES) == set(jnetlint.NET_PASSES)
    # beside them, the concurrency passes and every other pass of the
    # JAX package's lint (tests/test_torch_lint_passes.py)
    assert set(lint.REGISTRY) == set(jlint.REGISTRY)
    assert set(CONCURRENCY_PASSES) <= set(lint.REGISTRY)
    for name in netlint.NET_PASSES:
        assert lint.REGISTRY[name].description == \
            jlint.REGISTRY[name].description
    assert netlint.GENERATED_WAIVERS == jnetlint.GENERATED_WAIVERS == {}


def test_zoo_and_examples_are_netlint_clean_through_the_port():
    assert findings(_ROOT, lint) == []
    assert findings(_ROOT, jlint) == []


@pytest.mark.parametrize("name,expected,body", MUTATIONS,
                         ids=[m[0] for m in MUTATIONS])
def test_each_seeded_mutation_gives_the_jax_finding(tmp_path, same_budget,
                                                    name, expected, body):
    write(tmp_path, 'name: "fixture"\n' + body)
    got = both(tmp_path)
    assert got and {f[0] for f in got} == {expected}, got


FIXTURES = {
    "clean": 'name: "ok"\n' + _INPUT_2 + """
    layer { name: "fc" type: "InnerProduct" bottom: "data" top: "fc"
            inner_product_param { num_output: 4 } }
    layer { name: "loss" type: "SoftmaxWithLoss"
            bottom: "fc" bottom: "label" top: "loss" }
    """,
    "malformed": 'layer { name: "x" type: ??? }',
    "missing_bottom": 'name: "f"\n' + _INPUT_2 + """
    layer { name: "r" type: "ReLU" top: "x" }
    """,
    "zero_stride": 'name: "f"\n' + _INPUT_2 + """
    layer { name: "c" type: "Convolution" bottom: "data" top: "c"
            convolution_param { num_output: 4 kernel_size: 3 stride: 0 } }
    layer { name: "p" type: "Pooling" bottom: "data" top: "p"
            pooling_param { pool: MAX kernel_size: 2 stride: 0 } }
    """,
    "colon_form": 'name: "f"\n' + """
    layer: { name: "in" type: "Input" top: "data"
             input_param { shape { dim: 8 dim: 3 dim: 8 dim: 8 } } }
    layer: { name: "fc" type: "InnerProduct" bottom: "nosuch" top: "fc"
             inner_product_param { num_output: 4 } }
    """,
    "train_pipeline_dropout": 'name: "pp2"\n' + """
    layer { name: "in" type: "Input" top: "x"
            include { phase: TRAIN }
            input_param { shape { dim: 4 dim: 8 dim: 16 } } }
    layer { name: "in" type: "Input" top: "x"
            include { phase: TEST }
            input_param { shape { dim: 4 dim: 8 dim: 16 } } }
    layer { name: "trunk" type: "Pipeline" bottom: "x" top: "y"
            pipeline_param { num_stages: 2 micro_batches: 2
              layer { name: "ln" type: "LayerNorm" bottom: "x" top: "n" }
              layer { name: "do" type: "Dropout" bottom: "n" top: "n2" }
              layer { name: "res" type: "Eltwise" bottom: "x"
                      bottom: "n2" top: "out" } } }
    """,
    "unnamed": 'name: "anon"\n' + """
    layer { type: "Input" top: "a" }
    layer { type: "Input" top: "b" }
    """,
    "quoted_hash": 'name: "q"\n' + """
    layer { name: "in" type: "Input" top: "data"
            input_param { shape { dim: 8 dim: 4 dim: 16 dim: 16 } } }
    layer { name: "h5" type: "HDF5Output" bottom: "data"
            hdf5_output_param { file_name: '/data/#shard1.h5' } }
    layer { name: "fc" type: "InnerProduct" bottom: "data" top: "fc"
            inner_product_param { num_output: 4 } }
    """,
    "solver": 'net: "train.prototxt"\nbase_lr: 0.01\n',
    "waiver_inside": 'name: "w"\n' + _NON_RGB.replace(
        'top: "data"',
        'top: "data"  # lint: ok(net-serve) — grayscale+alpha by design'),
    "waiver_above": 'name: "w"\n' + _NON_RGB.replace(
        'layer { name: "in"',
        '# lint: ok(net-serve) — grayscale+alpha by design\n'
        '    layer { name: "in"'),
    "waiver_on_other_layer": 'name: "w"\n' + _NON_RGB.replace(
        'top: "fc"', 'top: "fc"  # lint: ok(net-serve) — wrong layer'),
    "misspelled_waiver": 'name: "w"\n' + _INPUT_2 + """
    # lint: ok(net-sreve) — typo'd pass name must fail, not suppress
    layer { name: "fc" type: "InnerProduct" bottom: "data" top: "fc"
            inner_product_param { num_output: 4 } }
    """,
}
EXPECTED = {"clean": [], "malformed": ["net-wiring"],
            "quoted_hash": ["net-serve"], "solver": [],
            "waiver_inside": [], "waiver_above": [],
            "waiver_on_other_layer": ["net-serve"],
            "misspelled_waiver": ["net-wiring"]}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixtures_and_waivers_give_the_jax_findings(tmp_path, name):
    write(tmp_path, FIXTURES[name])
    got = both(tmp_path)
    if name in EXPECTED:
        assert [f[0] for f in got] == EXPECTED[name], got
    else:
        assert got, name


def test_generated_waivers_suppress_as_in_jax(tmp_path, monkeypatch):
    write(tmp_path, 'name: "w"\n' + _NON_RGB)
    assert [f[0] for f in both(tmp_path)] == ["net-serve"]
    key = (os.path.join("models", "fixture", "net.prototxt"), "net-serve",
           "in")
    for mod in (netlint, jnetlint):
        monkeypatch.setitem(mod.GENERATED_WAIVERS, key, "by design")
    assert both(tmp_path) == []


FOOTPRINT = ("net-footprint",)


def test_the_footprint_budget_is_one_h100(tmp_path, monkeypatch):
    """Without CAFFE_NETLINT_HBM_MB the budget is the H100's memory, as
    nvidia-smi reports it, from the card table of utils/flops.py; a blob
    between the v5e budget and it is flagged only by the JAX package."""
    monkeypatch.delenv("CAFFE_NETLINT_HBM_MB", raising=False)
    assert netlint.DEFAULT_BUDGET_MB == card_memory_mb(
        "NVIDIA H100 80GB HBM3") == 81559
    # 32 GiB of float32: over 16,384 MiB, under 81,559 MiB
    write(tmp_path, """
    layer { name: "in" type: "Input" top: "data"
            input_param { shape { dim: 8 dim: 1024 dim: 1024 dim: 1024 } } }
    """)
    assert findings(tmp_path, lint, FOOTPRINT) == []
    assert [f[0] for f in findings(tmp_path, jlint, FOOTPRINT)] == \
        ["net-footprint"]
    write(tmp_path, """
    layer { name: "in" type: "Input" top: "data"
            input_param { shape { dim: 32 dim: 1024 dim: 1024 dim: 1024 } } }
    """)
    (got,) = findings(tmp_path, lint, FOOTPRINT)
    assert got[0] == "net-footprint" and "81559 MiB" in got[3]
    monkeypatch.setenv("CAFFE_NETLINT_HBM_MB", "1024")
    write(tmp_path, """
    layer { name: "in" type: "Input" top: "data"
            input_param { shape { dim: 2 dim: 1024 dim: 1024 dim: 1024 } } }
    """)
    (got,) = findings(tmp_path, lint, FOOTPRINT)
    assert "1024 MiB" in got[3]


@pytest.mark.parametrize("src", [
    "x = 1  # lint: ok(net-shape) — reason\n",
    "# lint: ok(a, b) — two\nx = 1\n",
    's = "# lint: ok(net-shape) — quoted, not a waiver"\n',
    '"""doc\n# lint: ok(net-shape)\n"""\nx = 1  # lint:ok(c)\n',
    "x = 1\n",
])
def test_the_waiver_grammar_reads_as_in_jax(src):
    assert lint.extract_waivers(src) == jlint.extract_waivers(src)
    assert lint._WAIVER_RE.pattern == jlint._WAIVER_RE.pattern
    lines = src.splitlines()
    waivers = lint.extract_waivers(src)
    for ln in range(1, len(lines) + 1):
        for name in ("net-shape", "a", "c"):
            assert lint.span_waiver_lines((ln, ln), name, waivers, lines) \
                == jlint.span_waiver_lines((ln, ln), name, waivers, lines)


def test_a_python_waiver_naming_an_unknown_pass_is_a_finding(tmp_path):
    (tmp_path / "a.py").write_text(
        "x = 1  # lint: ok(no-such-pass) — typo\n"
        "y = 2  # lint: ok(net-shape) — a known pass\n")
    got = lint.run_lint(paths=[str(tmp_path)], root=str(tmp_path))
    assert [(f.pass_name, f.line) for f in got] == [("bad-waiver", 1)]


def test_the_cli_lists_selects_and_prints_json(capsys):
    assert lint.main(["--list"]) == 0
    listed = capsys.readouterr().out.split("\n")
    jlint._load_passes()
    assert [l.split()[0] for l in listed if l] == sorted(jlint.REGISTRY)
    assert lint.main(["--json", "--select", "net-shape,net-wiring"]) == 0
    assert json.loads(capsys.readouterr().out) == []
    assert lint.main(["--select", "no-such-pass"]) == 2
    assert "unknown pass" in capsys.readouterr().err
    assert lint.main(["no/such/path.py"]) == 2


def test_the_lint_runs_without_torch_or_jax():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy\n"
         "sys.modules['torch'] = sys.modules['jax'] = None\n"
         "sys.argv = ['lint']\n"
         "runpy.run_module('caffe_mpi_tpu_torch.tools.lint',"
         " run_name='__main__')\n"],
        cwd=_ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=_ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout == ""
