"""Port parity: the mesh's 'model' axis (caffe_mpi_tpu_torch/parallel/
mesh.py's placement and tensor-parallel regions, InnerProduct and
Convolution `param_sharding` rows/cols, expert parallelism, MoE under
data parallelism, sequence-parallel attention through the Solver) against
the JAX `Solver` on `MeshPlan.from_shape(2, 2)` over the virtual CPU
devices.

The port's ranks are four gloo processes on the CPU in a 2 x 2 mesh
(tests/torch_dp_worker.py, data index r // 2, model index r % 2), which
run while the JAX references step. Every scenario starts from the JAX
solver's initial weights (full arrays; each rank keeps its shards).

Tolerances, float32 (the PR 14 bars, unloosened):
- losses rtol 1e-5; params and history (whole: the shards gathered)
  rtol 1e-5 / atol 1e-6 after 5 iterations;
- the ranks' whole states against each other: equal, element for
  element;
- expert-parallel `moe_ffn` against the dense reference and the JAX
  function: rtol 1e-5 / atol 1e-6, gradients 1e-5 of the largest
  element.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.ops import moe as jax_moe
from caffe_mpi_tpu.parallel import MeshPlan as JaxMeshPlan
from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu_torch.ops import moe as port_moe
from test_torch_train import _jax_masks
from test_torch_train import train_val as alexnet_train_val
from torch_dp_worker import Ranks

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = dict(rtol=1e-5, atol=1e-6)
ITERS = 5
MESH = (2, 2)

TP_MLP = """
name: "tp_mlp"
layer { name: "in" type: "Input" top: "x" top: "t"
        input_param { shape { dim: 8 dim: 12 } shape { dim: 8 } } }
layer { name: "fc1" type: "InnerProduct" bottom: "x" top: "h"
        param_sharding: "rows"
        inner_product_param { num_output: 16 weight_filler { type: "xavier" }
          bias_filler { type: "gaussian" std: 0.1 } } }
layer { name: "r" type: "ReLU" bottom: "h" top: "h" }
layer { name: "fc2" type: "InnerProduct" bottom: "h" top: "g"
        param_sharding: "cols"
        inner_product_param { num_output: 10 weight_filler { type: "xavier" }
          bias_filler { type: "gaussian" std: 0.1 } } }
layer { name: "fc3" type: "InnerProduct" bottom: "g" top: "y"
        inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "y" bottom: "t" top: "l" }
"""

TP_CONV = """
name: "tp_conv"
layer { name: "in" type: "Input" top: "x" top: "t"
        input_param { shape { dim: 4 dim: 3 dim: 6 dim: 6 } shape { dim: 4 } } }
layer { name: "conv1" type: "Convolution" bottom: "x" top: "c1"
        param_sharding: "rows"
        convolution_param { num_output: 8 kernel_size: 3 pad: 1
          weight_filler { type: "msra" } bias_filler { type: "gaussian" std: 0.1 } } }
layer { name: "r1" type: "ReLU" bottom: "c1" top: "c1" }
layer { name: "conv2" type: "Convolution" bottom: "c1" top: "c2"
        param_sharding: "cols"
        convolution_param { num_output: 6 kernel_size: 3
          weight_filler { type: "msra" } bias_filler { type: "gaussian" std: 0.1 } } }
layer { name: "pool" type: "Pooling" bottom: "c2" top: "p"
        pooling_param { pool: AVE global_pooling: true } }
layer { name: "ip" type: "InnerProduct" bottom: "p" top: "y"
        param_sharding: "rows"
        inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "y" bottom: "t" top: "l" }
"""

MOE_NET = """
name: "moe_mlp"
layer { name: "in" type: "Input" top: "x" top: "t"
        input_param { shape { dim: 8 dim: 6 } shape { dim: 8 } } }
layer { name: "moe1" type: "MoE" bottom: "x" top: "h" top: "aux"
        loss_weight: 0.0 loss_weight: 0.01
        moe_param { num_experts: 4 hidden_dim: 8 capacity_factor: 1.0
                    top_k: 2 } }
layer { name: "ip" type: "InnerProduct" bottom: "h" top: "y"
        inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "y" bottom: "t" top: "l" }
"""

# two branches of one weight (Net::AppendParam sharing, as the siamese
# net's): the owner split by rows, the other branch with its own whole
# bias, so it runs the column-parallel product on the owner's shard
SHARED_NET = """
name: "tp_shared"
layer { name: "in" type: "Input" top: "x" top: "x2" top: "t"
        input_param { shape { dim: 8 dim: 12 } shape { dim: 8 dim: 12 }
                      shape { dim: 8 } } }
layer { name: "fa" type: "InnerProduct" bottom: "x" top: "ha"
        param_sharding: "rows" param { name: "w" }
        inner_product_param { num_output: 16 weight_filler { type: "xavier" }
          bias_filler { type: "gaussian" std: 0.1 } } }
layer { name: "fb" type: "InnerProduct" bottom: "x2" top: "hb"
        param { name: "w" }
        inner_product_param { num_output: 16 weight_filler { type: "xavier" }
          bias_filler { type: "gaussian" std: 0.1 } } }
layer { name: "sum" type: "Eltwise" bottom: "ha" bottom: "hb" top: "h" }
layer { name: "r" type: "ReLU" bottom: "h" top: "h" }
layer { name: "fc3" type: "InnerProduct" bottom: "h" top: "y"
        inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "y" bottom: "t" top: "l" }
"""

EP = {"w1": ("model",), "b1": ("model",), "w2": ("model",),
      "b2": ("model",)}


def narrow_sp_net() -> str:
    """transformer_lm's train_val_sp.prototxt cut to a narrow width: 2
    blocks (attention with sequence_parallel, causal; then MoE), vocab
    32, width 16, 2 heads, sequence 6 (it splits over 2 model ranks),
    batch 4 (2 a data rank)."""
    text = open(os.path.join(_ROOT, "models", "transformer_lm",
                             "train_val_sp.prototxt")).read()
    for old, new in (("dim: 8\n      dim: 64", "dim: 4\n      dim: 6"),
                     ("dim: 64\n      dim: 128", "dim: 6\n      dim: 16"),
                     ("input_dim: 256", "input_dim: 32"),
                     ("num_output: 128", "num_output: 16"),
                     ("num_output: 256", "num_output: 32"),
                     ("num_heads: 4", "num_heads: 2"),
                     ("hidden_dim: 256", "hidden_dim: 16")):
        assert old in text, old
        text = text.replace(old, new)
    return text[text.index("layer"):]


def narrow_sp_tp_net() -> str:
    """narrow_sp_net with its first block's MLP split Megatron-style (fc1
    by rows, fc2 by cols) and its MoE whole."""
    text = narrow_sp_net()
    for name, mode in (("blk0/fc1", "rows"), ("blk0/fc2", "cols")):
        old = f'name: "{name}"\n  type: "InnerProduct"'
        assert old in text, old
        text = text.replace(old, f'{old}\n  param_sharding: "{mode}"')
    return text


def solver_text(net, kind="SGD", extra=""):
    return ("net_param { " + net + " }\n"
            'base_lr: 0.05 momentum: 0.9 lr_policy: "fixed" max_iter: 20 '
            f'type: "{kind}" random_seed: 7 ' + extra)


def feeds_for(js, n, seed, classes=32):
    """Global feeds for the JAX solver's net, seeded; label ids in [0,
    classes)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = {}
        for layer in js.net.layers:
            if layer.lp.type != "Input":
                continue
            for top, shape in zip(layer.lp.top, layer.out_shapes):
                if top == "t":
                    f[top] = rs.randint(0, 4, shape).astype(np.int32)
                elif top in ("tokens", "label"):
                    f[top] = rs.randint(0, classes, shape).astype(np.int32)
                else:
                    f[top] = rs.randn(*shape).astype(np.float32)
        out.append(f)
    return out


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_start(text, feeds_seed, shardings=None, classes=32, mesh=MESH):
    """The JAX Solver on the mesh, not stepped, and the scenario the
    port's ranks start from (its weights, its global Dropout masks)."""
    d, m = mesh
    js = JaxSolver(JaxSP.from_text(text),
                   mesh=JaxMeshPlan.from_shape(
                       d, m, devices=jax.devices()[:d * m]),
                   param_shardings=shardings)
    feeds = feeds_for(js, ITERS, feeds_seed, classes)
    sc = {"solver": text, "feeds": feeds, "iters": ITERS,
          "weights": _host(js.params), "net_state": _host(js.net_state),
          "param_shardings": shardings}
    if any(l.lp.type == "Dropout" for l in js.net.layers):
        fn = _jax_masks(js, seed=js.sp.random_seed)
        sc["masks"] = {(it, 0): {k: v.numpy() for k, v in fn(it, 0).items()}
                       for it in range(ITERS)}
    return js, sc


def narrow_alexnet_tp() -> str:
    """The narrow AlexNet of test_torch_train.py (grouped convolutions,
    LRN, Dropout) with fc6 split by rows and fc7 by cols."""
    text = alexnet_train_val(8)
    for name, mode in (("fc6", "rows"), ("fc7", "cols")):
        old = f'layer {{ name: "{name}" type: "InnerProduct"'
        assert old in text
        text = text.replace(old, f'{old} param_sharding: "{mode}"')
    return text[text.index("layer"):]


def assert_like_jax(js, losses, res, **tol):
    tol = tol or STEP
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
    state = res["state"]
    for lname, blobs in js.params.items():
        for pname, arr in blobs.items():
            np.testing.assert_allclose(state[f"{lname}.{pname}"],
                                       np.asarray(arr),
                                       err_msg=f"{lname}.{pname}", **tol)
            for i, slot in enumerate(js.opt_state[lname][pname]):
                np.testing.assert_allclose(
                    state[f"{lname}.{pname}.h{i}"], np.asarray(slot),
                    err_msg=f"{lname}.{pname}.h{i}", **tol)


def assert_ranks_equal(results, name):
    first = results[0][name]
    for r, res in enumerate(results[1:], 1):
        assert np.array_equal(res[name]["losses"], first["losses"]), r
        for key, arr in first["state"].items():
            assert np.array_equal(res[name]["state"][key], arr), (r, key)


CASES = {
    # name: (solver text, feeds seed, param_shardings[, label classes])
    "tp_alexnet": (solver_text(narrow_alexnet_tp(),
                               extra="weight_decay: 0.0005 "
                               "clip_gradients: 2.0"), 5, None, 10),
    "tp_mlp": (solver_text(TP_MLP, extra="clip_gradients: 0.5"), 1, None),
    "tp_conv": (solver_text(TP_CONV, extra="clip_gradients: 0.5"), 2, None),
    "moe_dp": (solver_text(MOE_NET), 3, None),
    "moe_ep": (solver_text(MOE_NET, extra="clip_gradients: 0.5"), 3,
               {"moe1": EP}),
    "sp": (solver_text(narrow_sp_net(), kind="Adam",
                       extra="base_lr: 0.01"), 4, {"blk1/moe": EP}),
    "sp_tp": (solver_text(narrow_sp_tp_net(), kind="Adam",
                          extra="base_lr: 0.01 clip_gradients: 0.5"), 6,
              None),
    "tp_shared": (solver_text(SHARED_NET, extra="clip_gradients: 0.5"), 7,
                  None),
    # output channels split, each bias whole (added after the gather)
    "tp_conv_whole_bias": (solver_text(TP_CONV), 8,
                           {n: {"weight": ("model", None, None, None)}
                            for n in ("conv1", "conv2")}),
}


# The JAX Solver on a 2 x 2 mesh draws its Dropout masks otherwise than on
# (1, 1) or (2, 1) (the same narrow AlexNet, the same seed: losses 2.2867
# on (2, 2) against 2.2887 on both others at iteration 1, the CPU), so
# the net with Dropout is held against the JAX Solver on (2, 1), whose
# masks are the one-device draw that the port's ranks replay; the 'model'
# axis changes no math.
JAX_MESH = {"tp_alexnet": (2, 1)}


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    # the JAX solvers trace and compile in threads, overlapping a little
    with ThreadPoolExecutor(len(CASES)) as ex:
        started = dict(zip(CASES, ex.map(
            lambda name: jax_start(*CASES[name],
                                   mesh=JAX_MESH.get(name, MESH)), CASES)))
    jaxes = {name: js for name, (js, _) in started.items()}
    scs = [dict(sc, name=name) for name, (_, sc) in started.items()]
    snap = dict(next(sc for sc in scs if sc["name"] == "tp_mlp"),
                name="tp_mlp_snap", snapshot=str(tmp / "snap" / "tp"))
    os.makedirs(tmp / "snap")
    scs.append(snap)
    ranks = Ranks({"mesh": MESH, "scenarios": scs}, 4, str(tmp / "ranks"),
                  timeout=240)

    def step(name):
        js = jaxes[name]
        feeds = started[name][1]["feeds"]
        return name, (js, [js.step(1, lambda k: feeds[k])
                           for _ in range(ITERS)])
    with ThreadPoolExecutor(len(CASES)) as ex:
        refs = dict(ex.map(step, CASES))
    return ranks.results(), refs, {sc["name"]: sc for sc in scs}


@pytest.mark.parametrize("name", sorted(CASES))
def test_five_iterations_match_the_jax_2x2_mesh(spawn, name):
    results, refs, _ = spawn
    js, losses = refs[name]
    assert_like_jax(js, losses, results[0][name])
    assert_ranks_equal(results, name)
    assert results[0][name]["stats"]["n_model"] == 2


def test_tensor_parallel_params_are_split_on_the_ranks(spawn):
    """rows: fc1's weight dim 0 and its bias; cols: fc2's weight dim 1,
    its bias whole; the EP banks' dim 0; every slot as its param."""
    results, _, _ = spawn
    shards = results[0]["tp_mlp"]["shards"]
    assert shards["fc1.weight"] == (8, 12) and shards["fc1.bias"] == (8,)
    assert shards["fc2.weight"] == (10, 8) and shards["fc2.bias"] == (10,)
    assert shards["fc3.weight"] == (4, 10)
    ep = results[0]["moe_ep"]["shards"]
    assert ep["moe1.w1"] == (2, 6, 8) and ep["moe1.gate"] == (6, 4)
    conv = results[0]["tp_conv"]["shards"]
    assert conv["conv1.weight"] == (4, 3, 3, 3)
    assert conv["conv2.weight"] == (6, 4, 3, 3)
    # the shared weight has one history, the owner's shard; the other
    # branch's own bias stays whole
    shared = results[0]["tp_shared"]["shards"]
    assert shared["fa.weight"] == (8, 12) and shared["fa.bias"] == (8,)
    assert "fb.weight" not in shared and shared["fb.bias"] == (16,)
    whole = results[0]["tp_conv_whole_bias"]["shards"]
    assert whole["conv2.weight"] == (3, 8, 3, 3)
    assert whole["conv2.bias"] == (6,)
    sp_tp = results[0]["sp_tp"]["shards"]
    assert sp_tp["blk0/fc1.weight"] == (16, 16)
    assert sp_tp["blk0/fc2.weight"] == (16, 16)
    assert sp_tp["blk1/moe.w1"] == (4, 16, 16)


def test_model_parallel_snapshot_is_the_whole_net_and_resumes(
        spawn, tmp_path):
    """The 2 x 2 run's snapshot holds the whole arrays, equal to the JAX
    run's and to a one-process port run's; every rank resumes from it to
    its own shards (whole again when gathered: equal to before)."""
    from caffe_mpi_tpu_torch import io as port_io
    from caffe_mpi_tpu_torch.proto import SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.weights import load_jax_params
    results, refs, scs = spawn
    js, _ = refs["tp_mlp"]
    res = results[0]["tp_mlp_snap"]
    assert res["restored_iter"] == ITERS
    for r in results:
        for key, arr in res["state"].items():
            np.testing.assert_array_equal(r["tp_mlp_snap"]["restored"][key],
                                          arr, err_msg=key)
    model = port_io.load_weights(res["snapshot"].replace(".solverstate",
                                                         ".caffemodel"))
    sc = scs["tp_mlp_snap"]
    one = Solver(SolverParameter.from_text(sc["solver"]), device="cpu")
    load_jax_params(one.net, sc["weights"])
    one.step(ITERS, lambda k: {key: torch.from_numpy(v)
                               for key, v in sc["feeds"][k].items()})
    one.sp.snapshot_prefix = str(tmp_path / "one")
    one_model = port_io.load_weights(one.snapshot().replace(
        ".solverstate", ".caffemodel"))
    for lname, blobs in js.params.items():
        for i, pname in enumerate(("weight", "bias")):
            np.testing.assert_allclose(model[lname][i],
                                       np.asarray(blobs[pname]), **STEP)
            np.testing.assert_allclose(model[lname][i],
                                       one_model[lname][i], **STEP)


def test_expert_parallel_moe_matches_the_dense_reference_and_jax(
        tmp_path):
    """moe_ffn with the experts split over 4 model ranks (shard_experts)
    against the port's and the JAX dense references (no overflow at
    capacity 8) and JAX moe_ffn with capacity drops; the gradients of
    sum(y * dy) + aux against the one-device port's."""
    r = np.random.RandomState(5)
    e, c, h, t = 4, 6, 8, 10
    params = {"gate": r.randn(c, e).astype(np.float32),
              "w1": (r.randn(e, c, h) * 0.3).astype(np.float32),
              "b1": (r.randn(e, h) * 0.1).astype(np.float32),
              "w2": (r.randn(e, h, c) * 0.3).astype(np.float32),
              "b2": (r.randn(e, c) * 0.1).astype(np.float32)}
    x = r.randn(t, c).astype(np.float32)
    dy = r.randn(t, c).astype(np.float32)
    scs = [dict(kind="moe", name=f"cf{cf}", params=params, x=x, dy=dy,
                top_k=2, capacity_factor=cf) for cf in (8.0, 1.0)]
    ranks = Ranks({"mesh": (1, 4), "scenarios": scs}, 4, str(tmp_path))
    jp = {k: jax.numpy.asarray(v) for k, v in params.items()}
    dense = np.asarray(jax_moe.moe_ffn_dense_reference(jp, x, top_k=2))
    port_dense = port_moe.moe_ffn_dense_reference(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), top_k=2).numpy()
    jax_drop, jax_aux = jax_moe.moe_ffn(jp, x, top_k=2, capacity_factor=1.0)
    pt = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y1, aux1 = port_moe.moe_ffn(pt, xt, top_k=2, capacity_factor=1.0)
    ((y1 * torch.from_numpy(dy)).sum() + aux1).backward()
    results = ranks.results()
    for m, res in enumerate(results):
        np.testing.assert_allclose(res["cf8.0"]["y"], dense, **STEP)
        np.testing.assert_allclose(res["cf8.0"]["y"], port_dense, **STEP)
        got = res["cf1.0"]
        np.testing.assert_allclose(got["y"], np.asarray(jax_drop), **STEP)
        np.testing.assert_allclose(got["aux"], float(jax_aux), rtol=1e-5)
        for name, want in (("dx", xt.grad), ("gate", pt["gate"].grad)):
            g = got["dx"] if name == "dx" else got["grads"][name]
            np.testing.assert_allclose(
                g, want.numpy(), rtol=1e-5,
                atol=1e-5 * float(want.abs().max()))
        for name in port_moe.EXPERT_PARAMS:
            want = pt[name].grad[m:m + 1].numpy()
            np.testing.assert_allclose(
                got["grads"][name], want, rtol=1e-5,
                atol=1e-5 * float(np.abs(pt[name].grad.numpy()).max()))
    sharded = port_moe.shard_experts(
        {k: torch.from_numpy(v) for k, v in params.items()},
        type("P", (), {"n_model": 4, "model_index": 3})())
    assert tuple(sharded["w1"].shape) == (1, c, h)
    np.testing.assert_array_equal(sharded["b2"].numpy(), params["b2"][3:])
    assert sharded["gate"].shape == (c, e)


# -- the CLI and its flags ------------------------------------------------------

def _cli_solver(tmp_path):
    body = TP_MLP.replace("dim: 8 dim: 12 } shape { dim: 8",
                          "dim: 4 dim: 12 } shape { dim: 4").replace(
        "num_output: 4 weight_filler", "num_output: 10 weight_filler")
    path = tmp_path / "solver.prototxt"
    path.write_text("net_param { " + body + " }\n"
                    'base_lr: 0.05 lr_policy: "fixed" max_iter: 3 '
                    'type: "SGD" random_seed: 7 snapshot_prefix: "'
                    + str(tmp_path / "cli") + '"\n')
    return str(path)


def test_cli_train_mesh_data1_model2_on_the_cpu(tmp_path):
    """`cli train -mesh data=1,model=2 -device cpu`: two gloo worker
    processes, fc1 rows and fc2 cols; rank 0's summary and the
    snapshot of whole arrays."""
    from caffe_mpi_tpu_torch import io as port_io
    env = dict(os.environ, CAFFE_TPU_COLLECTIVE_TIMEOUT="90",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli", "train",
         "-solver", _cli_solver(tmp_path), "-synthetic", "-device", "cpu",
         "-mesh", "data=1,model=2"], cwd=_ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{"train"')]
    assert len(lines) == 1
    s = json.loads(lines[0])["train"]
    assert (s["world"], s["n_model"], s["iters"]) == (1, 2, 3)
    assert np.all(np.isfinite(s["losses"]))
    w = port_io.load_weights(str(tmp_path / "cli_iter_3.caffemodel"))
    assert w["fc1"][0].shape == (16, 12) and w["fc2"][0].shape == (10, 16)


def test_cli_decoded_cache_mb_lands_on_the_solver(tmp_path):
    from caffe_mpi_tpu_torch.tools import cli
    args = cli.parse_args(["train", "-solver", _cli_solver(tmp_path),
                           "-decoded_cache_mb", "64"])
    assert cli.solver_param(args).decoded_cache_mb == 64


@pytest.mark.parametrize("flags,item", [(["-require_bank_warm"], 5)])
def test_cli_unported_jax_flags_exit_one_naming_their_item(
        tmp_path, caplog, flags, item):
    from caffe_mpi_tpu_torch.tools import cli
    rc = cli.main(["train", "-solver", _cli_solver(tmp_path), "-synthetic",
                   "-device", "cpu", *flags])
    assert rc == 1
    assert f"ROADMAP.md §1 item {item}" in caplog.text


def test_refused_model_axis_combinations_name_item_6():
    """zero_stage 1 and step_chunk > 1 under a model axis, and
    param_sharding on a layer without a model-parallel forward, are
    refused naming ROADMAP item 6; a rule without a mesh or for an
    unknown layer raises as the JAX Solver's."""
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    plan = type("Plan", (), {"n_model": 2, "n_data": 1, "rank": 0,
                             "device": torch.device("cpu")})()
    for extra in ("zero_stage: 1", "step_chunk: 4"):
        with pytest.raises(NotImplementedError, match=r"item 6\b"):
            Solver(SolverParameter.from_text(solver_text(TP_MLP, extra=extra)),
                   device="cpu", mesh=plan)
    with pytest.raises(ValueError, match="requires a mesh"):
        Solver(SolverParameter.from_text(solver_text(TP_MLP)), device="cpu",
               param_shardings={"fc1": "rows"})
    bad = TP_MLP.replace('type: "ReLU" bottom: "h" top: "h" }',
                         'type: "ReLU" bottom: "h" top: "h" '
                         'param_sharding: "rows" }')
    with pytest.raises(NotImplementedError, match=r"item 6\b"):
        Net(NetParameter.from_text(bad), "TRAIN", device="cpu")
    # a rule that splits only the bias of a layer sharing its weight
    from caffe_mpi_tpu_torch.parallel.mesh import Placement
    net = Net(NetParameter.from_text(SHARED_NET), "TRAIN", device="cpu")
    net.init(0)
    plan.model_index = 0
    with pytest.raises(NotImplementedError, match=r"'fb'.*item 6\b"):
        net.place(Placement(plan, {"fb": "rows"}))
    grouped = TP_CONV.replace("num_output: 6 kernel_size: 3",
                              "num_output: 6 kernel_size: 3 group: 2")
    with pytest.raises(NotImplementedError, match=r"group 1 only .*item 6"):
        Net(NetParameter.from_text(grouped), "TRAIN", device="cpu")
