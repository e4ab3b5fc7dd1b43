"""Port refusals: solver and serving fields that the JAX package honours and
the port does not yet are refused, never accepted and then ignored.

Each field of `caffe_mpi_tpu_torch/solver/solver.py` UNPORTED_FIELDS and
of `serving/engine.py` UNPORTED_FIELDS raises NotImplementedError at a
value other than its default, before anything is built, naming the field
and the ROADMAP.md item that will port it; set to its default it passes.
An unknown `precision` or `serve_dtype` raises ValueError, as the JAX
`Solver` and `ServingEngine` do. Source scans keep the tables from
drifting: every SolverParameter field the JAX `Solver` reads, and every
ServingParameter field the JAX serving path reads, is either read by the
port or refused by it.
"""

import dataclasses
import glob
import os
import re

import pytest
import torch

from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.proto.config import ServingParameter as JaxServing
from caffe_mpi_tpu.serving import ServingEngine as JaxEngine
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu_torch.proto import SolverParameter
from caffe_mpi_tpu_torch.proto.config import ServingParameter
from caffe_mpi_tpu_torch.serving import ServingEngine
from caffe_mpi_tpu_torch.serving import engine as engine_mod
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.solver import solver as solver_mod
from caffe_mpi_tpu_torch.tools import cli

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVER_FIELDS = solver_mod.UNPORTED_FIELDS
SERVING_FIELDS = engine_mod.UNPORTED_FIELDS
# a value the JAX package takes, other than the default, for the string
# fields; other fields take `_other`'s
OTHER = {"precision": "bf16", "solver_data_type": "FLOAT16",
         "anomaly_action": "abort", "coordinator": "localhost:1234",
         "serve_dtype": "bf16", "serve_program_bank": "bank"}
# one inner product over an Input feed: the smallest net a Solver builds
NET = ('net_param { name: "tiny" '
       'layer { name: "data" type: "Input" top: "data" top: "label" '
       'input_param { shape { dim: 2 dim: 3 } shape { dim: 2 } } } '
       'layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip" '
       'inner_product_param { num_output: 10 } } '
       'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" '
       'bottom: "label" top: "loss" } }\n')


def _default(cls, name):
    return next(f.default for f in dataclasses.fields(cls) if f.name == name)


def _other(name, default):
    if name in OTHER:
        return OTHER[name]
    if isinstance(default, bool):
        return not default
    return default + (2 if isinstance(default, int) else 0.5)


def _solver_param(extra=""):
    return SolverParameter.from_text(NET + "base_lr: 0.01\nmax_iter: 1\n"
                                     + extra)


# -- the solver ---------------------------------------------------------------

@pytest.mark.parametrize("name,item", SOLVER_FIELDS)
def test_unported_solver_field_is_refused_and_its_default_passes(name, item):
    default = _default(SolverParameter, name)
    sp = SolverParameter()  # no net: a refusal comes before any building
    setattr(sp, name, _other(name, default))
    with pytest.raises(NotImplementedError,
                       match=rf"solver field {name}: .*ROADMAP\.md §1 item "
                       rf"{item}\b"):
        Solver(sp, device="cpu")
    sp = _solver_param()
    setattr(sp, name, default)
    Solver(sp, device="cpu")


# fields ported since the refusal table began, each with a check that
# the solver took its non-default value
PORTED = {
    "precision": ('precision: "bf16"', lambda s: s.precision == "bf16"),
    "loss_scale": ('precision: "bf16" loss_scale: 8',
                   lambda s: s.loss_scale_value == 8.0
                   and not s._guard_on),
    "loss_scale_window": ('precision: "bf16" loss_scale_window: 7',
                          lambda s: s._ls_window == 7),
    "solver_data_type": ('solver_data_type: "FLOAT16"',
                         lambda s: s.net.layer_by_name("ip").weight.dtype
                         == torch.bfloat16),
    "train_guard": ("train_guard: true", lambda s: s._guard_on),
    "guard_max_skips": ("train_guard: true guard_max_skips: 0",
                        lambda s: s.sp.guard_max_skips == 0),
    "guard_loss_spike": ("train_guard: true guard_loss_spike: 3",
                         lambda s: s.sp.guard_loss_spike == 3.0),
    "guard_ema_decay": ("train_guard: true guard_ema_decay: 0.5",
                        lambda s: s.sp.guard_ema_decay == 0.5),
    "step_chunk": ("step_chunk: 4", lambda s: s.step_chunk == 4
                   and tuple(s._table.shape) == (4, 3)),
}


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_solver_field_is_taken_at_a_non_default_value(name):
    assert name not in {n for n, _ in SOLVER_FIELDS}
    text, check = PORTED[name]
    solver = Solver(_solver_param(text), device="cpu")
    assert check(solver)
    solver.step(1, lambda it: {
        "data": torch.zeros(2, 3), "label": torch.zeros(2, dtype=torch.long)})


@pytest.mark.parametrize("text", ['precision: "f32"', 'precision: "F32"',
                                  'precision: ""', "rampup_interval: 10",
                                  "solver_mode: CPU", "device_id: 3"])
def test_ported_or_ignored_by_both_solver_values_pass(text):
    """f32 as the JAX Solver spells it; a ported field; fields neither
    package honours."""
    Solver(_solver_param(text), device="cpu")


def test_unknown_precision_raises_value_error_as_jax_does():
    with pytest.raises(ValueError, match="unknown precision"):
        Solver(_solver_param('precision: "nonsense"'), device="cpu")
    jsp = JaxSP.from_text(NET + 'base_lr: 0.01\nprecision: "nonsense"\n')
    with pytest.raises(ValueError, match="unknown precision"):
        JaxSolver(jsp)


@pytest.mark.parametrize("path", ["models/alexnet/solver.prototxt",
                                  "models/transformer_lm/solver.prototxt"])
def test_the_chip_paths_solvers_set_no_refused_field(path):
    sp = SolverParameter.from_file(os.path.join(_ROOT, path))
    for name, _ in SOLVER_FIELDS:
        assert getattr(sp, name) == _default(SolverParameter, name), name


def _fields_read(paths, names, var):
    """The fields of `names` read as `var.<f>`, `self.var.<f>`,
    `getattr(var, "<f>"...)` or `var.has("<f>")` in the files."""
    out = set()
    for path in paths:
        with open(path) as f:
            src = f.read()
        for pat in (rf"\b(?:self\.)?{var}\.(\w+)",
                    rf"getattr\((?:self\.)?{var}, \"(\w+)\"",
                    rf"\b{var}\.has\(\"(\w+)\"\)"):
            out |= set(re.findall(pat, src))
    return out & names


def test_solver_refusal_table_covers_what_the_jax_solver_reads():
    names = {f.name for f in dataclasses.fields(SolverParameter)}
    jax = _fields_read([os.path.join(_ROOT, "caffe_mpi_tpu", "solver",
                                     "solver.py")], names, "sp")
    port = _fields_read(glob.glob(os.path.join(
        _ROOT, "caffe_mpi_tpu_torch", "solver", "*.py")), names, "sp")
    assert "train_guard" in jax and "step_chunk" in jax  # the scan works
    assert jax - port <= {name for name, _ in SOLVER_FIELDS}
    assert {name for name, _ in SOLVER_FIELDS} <= names


# -- serving ------------------------------------------------------------------

@pytest.mark.parametrize("name,item", SERVING_FIELDS)
def test_unported_serving_field_is_refused_and_its_default_passes(name,
                                                                   item):
    default = _default(ServingParameter, name)
    sp = ServingParameter()
    setattr(sp, name, _other(name, default))
    # device "cuda" would raise on a card-less machine: the refusal is first
    with pytest.raises(NotImplementedError,
                       match=rf"serving field {name}: .*ROADMAP\.md §1 item "
                       rf"{item}\b"):
        ServingEngine(sp, device="cuda")
    sp = ServingParameter()
    setattr(sp, name, default)
    ServingEngine(sp, device="cpu").close()


@pytest.mark.parametrize("dtype", ["f32", ""])
def test_f32_serve_dtype_passes(dtype):
    ServingEngine(ServingParameter(serve_dtype=dtype), device="cpu").close()


def test_unknown_serve_dtype_raises_value_error_as_jax_does():
    with pytest.raises(ValueError, match="unknown serve_dtype"):
        ServingEngine(ServingParameter(serve_dtype="nonsense"), device="cpu")
    with pytest.raises(ValueError, match="unknown serve_dtype"):
        JaxEngine(JaxServing(serve_dtype="nonsense"))


def test_serving_refusal_table_covers_what_the_jax_serving_path_reads():
    names = {f.name for f in dataclasses.fields(ServingParameter)}
    jax = set()
    for path in glob.glob(os.path.join(_ROOT, "caffe_mpi_tpu", "serving",
                                       "*.py")) + [
            os.path.join(_ROOT, "caffe_mpi_tpu", "tools", "cli.py")]:
        with open(path) as f:
            src = f.read()
        jax |= set(re.findall(r"\.(\w+)\b", src)) & names
        jax |= set(re.findall(r"getattr\(\w+, \"(\w+)\"", src)) & names
    port = _fields_read(glob.glob(os.path.join(
        _ROOT, "caffe_mpi_tpu_torch", "serving", "*.py")), names, "sp")
    assert {"serve_dtype", "serve_hbm_mb", "serve_replicas"} <= jax
    assert jax - port <= {name for name, _ in SERVING_FIELDS}


# -- the CLI ------------------------------------------------------------------

def _write_solver(tmp_path):
    path = tmp_path / "solver.prototxt"
    path.write_text(NET + "base_lr: 0.01\nmax_iter: 1\n")
    return str(path)


@pytest.mark.parametrize("flags", [["-test_chunk", "4"],
                                   ["-anomaly_action", "abort"],
                                   ["-snapshot_keep", "2"],
                                   ["-min_hosts", "2"],
                                   ["-precision", "nonsense"]])
def test_cli_train_flag_of_an_unported_field_exits_one(tmp_path, flags):
    assert cli.main(["train", "-solver", _write_solver(tmp_path),
                     "-synthetic", "-device", "cpu", *flags]) == 1


def test_cli_train_flags_at_their_defaults_train(tmp_path):
    args = cli.parse_args(["train", "-solver", _write_solver(tmp_path),
                           "-synthetic", "-device", "cpu",
                           "-precision", "f32", "-step_chunk", "1"])
    solver, summary = cli.train(args)
    assert solver.sp.precision == "f32" and summary["iters"] == 1


@pytest.mark.parametrize("flags", [["-serve_dtype", "bf16"],
                                   ["-serve_dtype", "nonsense"],
                                   ["-serve_deadline_ms", "50"]])
def test_cli_serve_flag_of_an_unported_field_exits_one(flags):
    assert cli.main(["serve", "-model", os.path.join(
        _ROOT, "models", "alexnet", "deploy.prototxt"), "-smoke", "1",
        "-device", "cpu", *flags]) == 1


def test_cli_has_a_flag_for_every_refused_field():
    args = cli.parse_args(["train"])
    for name, _ in SOLVER_FIELDS + SERVING_FIELDS:
        assert getattr(args, name) is None, name


# -- the data plane -----------------------------------------------------------

DATA_ITEM = r"ROADMAP\.md §1 item 3\b"


def _lmdb(tmp_path):
    from caffe_mpi_tpu_torch.data.datasets import encode_datum
    from caffe_mpi_tpu_torch.data.lmdb_io import write_lmdb
    import numpy as np
    img = np.zeros((1, 4, 4), np.uint8)
    write_lmdb(str(tmp_path / "db"), [(b"%08d" % i, encode_datum(img, i))
                                      for i in range(3)])
    return str(tmp_path / "db")


def _data_net(source, data_param="", transform=""):
    from caffe_mpi_tpu_torch.proto import NetParameter
    return NetParameter.from_text(
        'layer { name: "d" type: "Data" top: "data" top: "label" '
        f'transform_param {{ {transform} }} data_param {{ source: "{source}" '
        f'batch_size: 2 {data_param} }} }}')


def test_leveldb_backend_is_refused(tmp_path):
    from caffe_mpi_tpu_torch.data.datasets import open_dataset
    from caffe_mpi_tpu_torch.net import Net
    with pytest.raises(NotImplementedError,
                       match=rf"backend: LEVELDB .*{DATA_ITEM}"):
        open_dataset("LEVELDB", str(tmp_path))
    # the prototxt default backend is LEVELDB, as in the reference
    with pytest.raises(NotImplementedError, match=DATA_ITEM):
        Net(_data_net(str(tmp_path)), "TRAIN", device="cpu")
    Net(_data_net(_lmdb(tmp_path), "backend: LMDB"), "TRAIN", device="cpu")


def test_data_param_cache_is_refused(tmp_path):
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.tools import cli as port_cli
    net = Net(_data_net(_lmdb(tmp_path), "backend: LMDB cache: true"),
              "TRAIN", device="cpu")
    with pytest.raises(NotImplementedError,
                       match=rf"data_param\.cache .*{DATA_ITEM}"):
        port_cli.build_feeder(net, "TRAIN")
    net = Net(_data_net(_lmdb(tmp_path), "backend: LMDB"), "TRAIN",
              device="cpu")
    port_cli.build_feeder(net, "TRAIN").close()


def test_decoded_cache_mb_stays_refused():
    assert ("decoded_cache_mb", 3) in SOLVER_FIELDS
    sp = SolverParameter()
    sp.decoded_cache_mb = 64.0
    with pytest.raises(NotImplementedError,
                       match=rf"decoded_cache_mb: .*{DATA_ITEM}"):
        Solver(sp, device="cpu")
    from caffe_mpi_tpu_torch.data.datasets import DecodedCacheDataset
    with pytest.raises(NotImplementedError, match=DATA_ITEM):
        DecodedCacheDataset(None, 64.0)


@pytest.mark.parametrize("kind,param", [
    ("ImageData", 'image_data_param { source: "list.txt" batch_size: 2 '
                  'new_height: 8 new_width: 8 }'),
    ("WindowData", 'window_data_param { source: "w.txt" batch_size: 2 '
                   'crop_size: 8 }'),
    ("HDF5Data", 'hdf5_data_param { source: "h5.txt" batch_size: 2 }'),
])
def test_unported_data_layer_types_are_refused(kind, param):
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.proto import NetParameter
    net = NetParameter.from_text(
        f'layer {{ name: "d" type: "{kind}" top: "data" top: "label" '
        f'{param} }}')
    with pytest.raises(NotImplementedError,
                       match=rf"the {kind} layer is not ported .*{DATA_ITEM}"):
        Net(net, "TRAIN", device="cpu")
