"""The port's static shape engine (caffe_mpi_tpu_torch/proto/netshape.py)
and what rides it — the MAC model, the serving plan before load,
model_shapes — held against the JAX package on the same files.

Every comparison is exact: the same Python arithmetic runs on both sides
(integers, the same shape rules), so records, problems, footprints, MACs
and plans are equal, not close. The engine against the port's BUILT Net
is held in tests/test_torch_cli_tools.py (`test_mac_counts_equal_the_jax_
packages`), folded into the builds that test already makes.
"""

import dataclasses
import glob
import logging
import os

import pytest
import torch

from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu.proto import netshape as jns
from caffe_mpi_tpu.serving import plan as jplan
from caffe_mpi_tpu.utils import model_shapes as jshapes
from caffe_mpi_tpu_torch.layers.base import LAYER_REGISTRY
from caffe_mpi_tpu_torch.proto import NetParameter
from caffe_mpi_tpu_torch.proto import netshape as ns
from caffe_mpi_tpu_torch.serving import engine as engine_mod
from caffe_mpi_tpu_torch.serving import plan
from caffe_mpi_tpu_torch.utils import model_shapes

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def zoo_nets() -> list[str]:
    """Every net file of models/*/ and examples/*/ (solvers aside), the
    HDF5 example too (the engine only reads it). The net-surgery
    example's windownet*.prototxt, which a test writes (gitignored), is
    left out, so every worker collects the same list."""
    return sorted(
        os.path.relpath(p, _ROOT) for d in ("models", "examples")
        for p in glob.glob(os.path.join(_ROOT, d, "*", "*.prototxt"))
        if "solver" not in os.path.basename(p)
        and not os.path.basename(p).startswith("windownet"))


def deploy_nets() -> list[str]:
    return [p for p in zoo_nets() if os.path.basename(p).startswith("deploy")]


def record(analysis, engine) -> dict:
    """Everything the engine says of one net, as plain data."""
    return {
        "name": analysis.name, "phase": analysis.phase,
        "blobs": analysis.blob_shapes,
        "problems": [dataclasses.astuple(p) for p in analysis.problems],
        "losses": analysis.loss_blobs,
        "layers": [(l.index, l.name, l.type, l.fwd_type, l.bwd_type,
                    l.in_shapes, l.out_shapes, l.loss_weights,
                    {k: dataclasses.astuple(v) for k, v in l.params.items()},
                    engine.layer_footprint(l), engine.layer_macs(l),
                    engine.macs_per_image(
                        l.type, l.in_shapes, l.out_shapes,
                        {k: v.shape for k, v in l.params.items()}, l.lp))
                   for l in analysis.layers],
        "hazards": [dataclasses.astuple(p)
                    for p in engine.inplace_hazards(analysis)],
        "unconsumed": {t: i.name for t, i in
                       engine.unconsumed_tops(analysis).items()},
    }


def test_the_zoo_holds_the_expected_nets():
    nets = zoo_nets()
    assert len(nets) == 47, nets
    assert "examples/hdf5_classification/nonlinear_train_val.prototxt" \
        in nets
    assert len(deploy_nets()) >= 15


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("path", zoo_nets())
def test_analyze_net_equals_the_jax_engine(path, phase):
    """Every LayerInfo (names, types, fwd/bwd types, in and out shapes,
    params), blob_shapes, problems, layer_footprint, macs_per_image and
    inplace_hazards, in f32 and under precision bf16: equal."""
    text = os.path.join(_ROOT, path)
    for precision in ("", "bf16"):
        got = ns.analyze_net(NetParameter.from_file(text), phase,
                             precision=precision)
        want = jns.analyze_net(JaxNP.from_file(text), phase,
                               precision=precision)
        assert record(got, ns) == record(want, jns), (path, precision)


def test_a_data_probe_fills_the_record_shape_as_in_jax():
    text = os.path.join(_ROOT, "examples/mnist/lenet_train_test.prototxt")
    got = ns.analyze_net(NetParameter.from_file(text), "TRAIN",
                         data_probe=lambda lp: (1, 28, 28))
    want = jns.analyze_net(JaxNP.from_file(text), "TRAIN",
                           data_probe=lambda lp: (1, 28, 28))
    assert record(got, ns) == record(want, jns)
    assert got.blob_shapes["data"] == (64, 1, 28, 28)
    assert not got.problems


def test_rules_cover_the_port_layer_registry():
    assert set(ns.RULES) == set(LAYER_REGISTRY), \
        set(ns.RULES) ^ set(LAYER_REGISTRY)
    assert len(LAYER_REGISTRY) == 62
    assert set(ns.RULES) == set(jns.RULES)


def test_bf16_registries_are_exhaustive_and_disjoint():
    assert ns.BF16_ELIGIBLE | ns.BF16_INELIGIBLE == set(LAYER_REGISTRY)
    assert not (ns.BF16_ELIGIBLE & ns.BF16_INELIGIBLE)
    assert (ns.BF16_ELIGIBLE, ns.BF16_INELIGIBLE) == \
        (jns.BF16_ELIGIBLE, jns.BF16_INELIGIBLE)
    for name in ("LOSS_TYPES", "SINK_TYPES", "STATEFUL_TYPES",
                 "INPUT_TYPES"):
        assert getattr(ns, name) == getattr(jns, name), name


@pytest.mark.parametrize("size,kernel,pad,stride,dil", [
    (227, 11, 0, 4, 1), (27, 5, 2, 1, 1), (13, 3, 1, 1, 2), (7, 3, 0, 2, 1),
    (None, 3, 1, 1, 1), (6, 3, 1, 2, 1), (5, 2, 2, 2, 1), (1, 3, 1, 1, 1)])
def test_dim_arithmetic_equals_the_jax_engine(size, kernel, pad, stride,
                                              dil):
    assert ns.conv_output_dim(size, kernel, pad, stride, dil) == \
        jns.conv_output_dim(size, kernel, pad, stride, dil)
    for any_pad in (None, True, False):
        assert ns.pool_output_dim(size, kernel, pad, stride, any_pad) == \
            jns.pool_output_dim(size, kernel, pad, stride, any_pad)


def test_footprint_handles_unknown_dims():
    analysis = ns.analyze_net(NetParameter.from_file(
        os.path.join(_ROOT, "examples/mnist/lenet_train_test.prototxt")),
        phase="TRAIN")
    assert not analysis.problems
    conv1 = next(l for l in analysis.layers if l.name == "conv1")
    fp = ns.layer_footprint(conv1)
    assert fp["macs"] is None and fp["param_count"] is None
    conv2 = next(l for l in analysis.layers if l.name == "conv2")
    assert ns.layer_footprint(conv2)["param_count"] == 25050


def test_the_engine_collects_problems_instead_of_raising():
    text = """
    layer { name: "in" type: "Input" top: "data"
            input_param { shape { dim: 8 dim: 3 dim: 8 dim: 8 } } }
    layer { name: "r" type: "ReLU" top: "x" }
    layer { name: "c" type: "Convolution" bottom: "data" top: "c"
            convolution_param { num_output: 4 kernel_size: 3 stride: 0 } }
    layer { name: "z" type: "NoSuchType" bottom: "data" top: "z" }
    """
    got = ns.analyze_net(NetParameter.from_text(text), "TRAIN")
    want = jns.analyze_net(JaxNP.from_text(text), "TRAIN")
    assert record(got, ns) == record(want, jns)
    assert {p.kind for p in got.problems} == {"wiring", "shape"}
    assert got.blob_shapes["z"] is None


def test_the_engine_imports_neither_torch_nor_jax():
    import subprocess
    import sys
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "sys.modules['torch'] = sys.modules['jax'] = None\n"
         "from caffe_mpi_tpu_torch.proto import NetParameter, netshape\n"
         "a = netshape.analyze_net(NetParameter.from_file("
         "'models/alexnet/deploy.prototxt'), 'TEST')\n"
         "print(len(a.layers), sum(netshape.layer_footprint(l)"
         "['param_count'] for l in a.layers))\n"],
        cwd=_ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=_ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.split() == ["24", "60965224"]


# -- the serving plan ---------------------------------------------------------

@pytest.mark.parametrize("path", deploy_nets())
def test_plan_model_equals_the_jax_plan_for_every_deploy_net(path):
    text = os.path.join(_ROOT, path)
    for ladder in (None, "1,4,10"):
        for dtype in ("f32", "bf16"):
            got = plan.plan_model(NetParameter.from_file(text),
                                  ladder=ladder, dtype=dtype)
            want = jplan.plan_model(JaxNP.from_file(text), ladder=ladder,
                                    dtype=dtype)
            assert got == want, (ladder, dtype)


def test_the_engine_plans_before_it_builds_anything(monkeypatch):
    """load_model calls plan_model on the prototxt before InferenceModel
    builds or uploads a tensor, and the plan it keeps is that plan."""
    order = []
    real_plan, real_model = engine_mod.plan_model, engine_mod.InferenceModel

    def planned(*a, **kw):
        order.append("plan")
        return real_plan(*a, **kw)

    def built(*a, **kw):
        order.append("build")
        return real_model(*a, **kw)

    monkeypatch.setattr(engine_mod, "plan_model", planned)
    monkeypatch.setattr(engine_mod, "InferenceModel", built)
    model = os.path.join(_ROOT, "models/cifar10_quick/deploy.prototxt")
    with engine_mod.ServingEngine(device="cpu", buckets="1,4", window_ms=0,
                                  start=False) as eng:
        eng.load_model("m", model)
        got = eng.stats()["plan"]["models"]["m"]
        m = eng.model("m")
    assert order == ["plan", "build"]
    want = plan.plan_model(NetParameter.from_file(model), ladder="1,4")
    assert {k: v for k, v in got.items() if k != "load_ms"} == want
    assert got["load_ms"] > 0
    assert plan.measured_plan(m.fwd, m.param_bytes) == want


def test_a_failed_plan_warns_and_the_model_loads(monkeypatch, caplog):
    def broken(*a, **kw):
        raise ValueError("no plan")

    monkeypatch.setattr(engine_mod, "plan_model", broken)
    model = os.path.join(_ROOT, "models/cifar10_quick/deploy.prototxt")
    with caplog.at_level(logging.WARNING, logger=engine_mod.log.name):
        with engine_mod.ServingEngine(device="cpu", buckets="1", window_ms=0,
                                      start=False) as eng:
            eng.load_model("m", model)
            assert eng.models == ["m"]
            assert "m" not in eng.stats()["plan"]["models"]
    assert "static plan for 'm' failed (no plan)" in caplog.text


# -- model_shapes -------------------------------------------------------------

@pytest.mark.parametrize("path", zoo_nets())
def test_input_shapes_and_label_tops_equal_the_jax_helpers(path):
    text = os.path.join(_ROOT, path)
    for batch in (None, 3):
        for train_only in (True, False):
            npar, jnpar = NetParameter.from_file(text), JaxNP.from_file(text)
            got = model_shapes.input_shapes(npar, batch, train_only)
            want = jshapes.input_shapes(jnpar, batch, train_only)
            assert got == want
            assert model_shapes.label_tops(npar, got) == \
                jshapes.label_tops(jnpar, want)
    assert model_shapes._CLASSIFICATION_CONSUMERS == \
        jshapes._CLASSIFICATION_CONSUMERS


def test_synthetic_feeds_draw_from_the_generator_onto_the_device():
    from caffe_mpi_tpu_torch.tools import cli
    assert cli._CLASSIFICATION_CONSUMERS is \
        model_shapes._CLASSIFICATION_CONSUMERS
    npar = NetParameter.from_file(
        os.path.join(_ROOT, "models/alexnet/train_val.prototxt"))
    npar.layer[0].type = "Input"  # a Data-free copy: feed the two tops
    npar.layer[0].input_param = NetParameter.from_text(
        'layer { input_param { shape { dim: 4 dim: 3 dim: 9 dim: 9 } '
        'shape { dim: 4 } } }').layer[0].input_param
    shapes = model_shapes.input_shapes(npar)
    assert shapes == {"data": [4, 3, 9, 9], "label": [4]}

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return model_shapes.synthetic_feeds(
            shapes, generator=g, device=torch.device("cpu"), n_classes=7,
            npar=npar)

    a, b, c = draw(0), draw(0), draw(1)
    assert a["label"].dtype == torch.int64 and a["data"].dtype == \
        torch.float32
    assert tuple(a["data"].shape) == (4, 3, 9, 9)
    assert int(a["label"].min()) >= 0 and int(a["label"].max()) < 7
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["data"], c["data"])
    # without a net, any 1-D top is a label vector
    g = torch.Generator().manual_seed(0)
    feeds = model_shapes.synthetic_feeds(shapes, generator=g,
                                         device="cpu", n_classes=7)
    assert feeds["label"].dtype == torch.int64
