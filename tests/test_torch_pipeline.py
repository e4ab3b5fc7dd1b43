"""Port parity: pipeline parallelism (caffe_mpi_tpu_torch/parallel/
pipeline.py `pipeline_apply`, layers/composite.py `PipelineLayer`)
against the JAX package's `pipeline_apply` and Pipeline layer.

- `pipeline_apply` over 2 and 4 model ranks (gloo processes on the CPU,
  tests/torch_dp_worker.py "pipeline" scenarios) with a microbatch count
  that is not a multiple of the stages, forward and gradients, against
  the JAX function on a (1, n) mesh of the virtual CPU devices;
- the Pipeline layer's setup refusals, message for message against the
  JAX layer's;
- transformer_lm's train_val_pp.prototxt, narrowed, trained 5 Adam
  iterations sequentially in one process and at model=4 (one stage a
  rank) against the JAX Solver on a (1, 4) mesh, which shards the stage
  dim and runs its pipelined schedule.

Tolerances, float32: pipeline_apply's output rtol 1e-5 / atol 1e-6, its
gradients 1e-5 of the largest element; training: losses rtol 1e-5,
params and history rtol 1e-5 / atol 1e-6 (the PR 14 bars).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.net import Net as JaxNet
from caffe_mpi_tpu.parallel import MeshPlan as JaxMeshPlan
from caffe_mpi_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.parallel.pipeline import stack_stage_params
from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.weights import load_jax_params
from torch_dp_worker import Ranks

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = dict(rtol=1e-5, atol=1e-6)
ITERS = 5
F = 6          # the stage width of pipeline_apply's cases
N_MICRO = 5    # not a multiple of 2 or 4


def _stage_case(n, seed):
    r = np.random.RandomState(seed)
    return {"w": (r.randn(n, F, F) * 0.5).astype(np.float32),
            "b": r.randn(n, F).astype(np.float32),
            "x": r.randn(N_MICRO, 3, F).astype(np.float32),
            "dy": r.randn(N_MICRO, 3, F).astype(np.float32)}


def _jax_pipeline(n, case):
    mesh = JaxMeshPlan.from_shape(1, n, devices=jax.devices()[:n]).mesh

    def stage(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def f(params, x):
        return jax_pipeline(stage, params, x, mesh, stage_axis="model")
    params = {"w": jnp.asarray(case["w"]), "b": jnp.asarray(case["b"])}
    out, vjp = jax.vjp(f, params, jnp.asarray(case["x"]))
    gp, gx = vjp(jnp.asarray(case["dy"]))
    return {"out": np.asarray(out), "dx": np.asarray(gx),
            "dw": np.asarray(gp["w"]), "db": np.asarray(gp["b"])}


def narrow_pp_net() -> str:
    """train_val_pp.prototxt cut to a narrow width: vocab 32, width 16, 2
    heads, fc 32, sequence 6, batch 4 (4 microbatches of 1), the 4
    stages as written."""
    text = open(os.path.join(_ROOT, "models", "transformer_lm",
                             "train_val_pp.prototxt")).read()
    for old, new in (("shape { dim: 8 dim: 64 }", "shape { dim: 4 dim: 6 }"),
                     ("dim: 64 dim: 128", "dim: 6 dim: 16"),
                     ("input_dim: 256", "input_dim: 32"),
                     ("num_output: 128", "num_output: 16"),
                     ("num_output: 256", "num_output: 32"),
                     ("num_heads: 4", "num_heads: 2")):
        assert old in text, old
        text = text.replace(old, new)
    return text[text.index("layer"):]


PP_SOLVER = ("net_param { " + narrow_pp_net() + " }\n"
             'base_lr: 0.01 momentum: 0.9 momentum2: 0.999 lr_policy: '
             '"fixed" max_iter: 20 type: "Adam" random_seed: 7')


def _pp_feeds(seed=3):
    rs = np.random.RandomState(seed)
    return [{"tokens": rs.randint(0, 32, (4, 6)).astype(np.int32),
             "label": rs.randint(0, 32, (4, 6)).astype(np.int32)}
            for _ in range(ITERS)]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The ranks of both sizes and the model=4 training start at once;
    the JAX references run meanwhile."""
    cases = {n: _stage_case(n, n) for n in (2, 4)}
    js = JaxSolver(JaxSP.from_text(PP_SOLVER),
                   mesh=JaxMeshPlan.from_shape(1, 4,
                                               devices=jax.devices()[:4]))
    feeds = _pp_feeds()
    train = {"name": "pp", "solver": PP_SOLVER, "feeds": feeds,
             "iters": ITERS, "weights": _host(js.params),
             "net_state": _host(js.net_state)}
    ranks = {2: Ranks({"mesh": (1, 2), "scenarios": [
        dict(kind="pipeline", name="apply", **cases[2])]}, 2,
        str(tmp_path_factory.mktemp("pp2"))),
        4: Ranks({"mesh": (1, 4), "scenarios": [
            dict(kind="pipeline", name="apply", **cases[4]), train]}, 4,
            str(tmp_path_factory.mktemp("pp4")), timeout=240)}
    with ThreadPoolExecutor(2) as ex:
        refs = dict(zip((2, 4), ex.map(lambda n: _jax_pipeline(
            n, cases[n]), (2, 4))))
    losses = [js.step(1, lambda k: feeds[k]) for _ in range(ITERS)]
    return ({n: r.results() for n, r in ranks.items()}, refs, cases,
            (js, losses, train))


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_apply_matches_jax(spawned, n):
    results, refs, cases, _ = spawned
    want = refs[n]
    for s, res in enumerate(results[n]):
        got = res["apply"]
        np.testing.assert_allclose(got["out"], want["out"], **STEP)
        for key, ref in (("dx", want["dx"]), ("dw", want["dw"][s]),
                         ("db", want["db"][s])):
            full = want[key]
            np.testing.assert_allclose(
                got[key], ref, rtol=1e-5,
                atol=1e-5 * float(np.abs(full).max()),
                err_msg=f"stage {s} {key}")


def test_stacking_needs_congruent_stages():
    a = {"w": torch.zeros(2, 3), "b": torch.zeros(3)}
    st = stack_stage_params([a, {k: v + 1 for k, v in a.items()}])
    assert st["w"].shape == (2, 2, 3) and float(st["b"][1, 0]) == 1.0
    with pytest.raises(ValueError, match="structurally identical"):
        stack_stage_params([a, {"w": torch.zeros(3, 3), "b": a["b"]}])


def _assert_like_jax(js, losses, got_losses, state):
    np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
    for lname, blobs in js.params.items():
        for pname, arr in blobs.items():
            np.testing.assert_allclose(state[f"{lname}.{pname}"],
                                       np.asarray(arr),
                                       err_msg=f"{lname}.{pname}", **STEP)
            for i, slot in enumerate(js.opt_state[lname][pname]):
                np.testing.assert_allclose(
                    state[f"{lname}.{pname}.h{i}"], np.asarray(slot),
                    err_msg=f"{lname}.{pname}.h{i}", **STEP)


def test_train_val_pp_at_model_4_matches_the_jax_mesh(spawned):
    """One stage a rank: the stacked params split over 'model' (each rank
    holds (1, ...)), the schedule pipelined; whole states equal across
    the ranks."""
    results, _, _, (js, losses, _) = spawned
    res = [r["pp"] for r in results[4]]
    _assert_like_jax(js, losses, res[0]["losses"], res[0]["state"])
    assert res[0]["shards"]["trunk.fc1.weight"] == (1, 32, 16)
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
        for key, arr in res[0]["state"].items():
            assert np.array_equal(r["state"][key], arr), key


def test_train_val_pp_sequential_matches_the_jax_mesh(spawned):
    """One process: the stages in sequence over the stacked params (the
    JAX layer's scan), against the JAX pipelined run."""
    _, _, _, (js, losses, train) = spawned
    solver = Solver(SolverParameter.from_text(PP_SOLVER), device="cpu")
    load_jax_params(solver.net, train["weights"])
    solver.step(ITERS, lambda k: {key: torch.from_numpy(v) for key, v
                                  in train["feeds"][k].items()})
    state = {}
    for lname, pname, _, p in solver._decls:
        state[f"{lname}.{pname}"] = p.detach().numpy()
        for i, h in enumerate(solver.history[(lname, pname)]):
            state[f"{lname}.{pname}.h{i}"] = h.numpy()
    _assert_like_jax(js, losses, solver.losses, state)


def test_train_val_pp_builds_as_written_with_the_jax_shapes():
    path = os.path.join(_ROOT, "models", "transformer_lm",
                        "train_val_pp.prototxt")
    net = Net(NetParameter.from_file(path), "TRAIN", device="cpu")
    jnet = JaxNet(JaxNP.from_file(path), "TRAIN")
    assert net.blob_shapes == jnet.blob_shapes
    trunk, jtrunk = net.layer_by_name("trunk"), jnet._layer_by_name("trunk")
    assert list(trunk.decls) == list(jtrunk.params)
    for name, decl in trunk.decls.items():
        assert decl.shape == jtrunk.params[name].shape


BLOCK = ('layer { name: "ln" type: "LayerNorm" bottom: "h" top: "n" } '
         'layer { name: "fc" type: "InnerProduct" bottom: "n" top: "out" '
         'inner_product_param { num_output: 8 axis: 2 } }')
REFUSALS = {
    "not_shape_preserving": BLOCK.replace("num_output: 8", "num_output: 6"),
    "stateful": BLOCK.replace('type: "LayerNorm" bottom: "h" top: "n" }',
                              'type: "BatchNorm" bottom: "h" top: "n" }'),
    "dropout": BLOCK.replace('type: "LayerNorm" bottom: "h" top: "n" }',
                             'type: "Dropout" bottom: "h" top: "n" }'),
    "sequence_parallel": BLOCK.replace(
        'type: "LayerNorm" bottom: "h" top: "n" }',
        'type: "Attention" bottom: "h" top: "n" attention_param { '
        "num_heads: 2 sequence_parallel: true } }"),
    "shared": BLOCK.replace("inner_product_param",
                            'param { name: "w" } inner_product_param'),
    "micro_batches": BLOCK,
    "unknown_bottom": BLOCK.replace('bottom: "n" top: "out"',
                                    'bottom: "zz" top: "out"'),
}


@pytest.mark.parametrize("case", sorted(REFUSALS) + ["two_bottoms"])
def test_pipeline_setup_refusals_give_the_jax_messages(case):
    micro = 3 if case == "micro_batches" else 2
    block = REFUSALS.get(case, BLOCK)
    extra = ' bottom: "h"' if case == "two_bottoms" else ""
    text = ('layer { name: "in" type: "Input" top: "h" input_param { '
            "shape { dim: 4 dim: 3 dim: 8 } } } "
            f'layer {{ name: "trunk" type: "Pipeline" bottom: "h"{extra} '
            f'top: "y" pipeline_param {{ num_stages: 2 micro_batches: '
            f"{micro} {block} }} }}")
    with pytest.raises(ValueError) as jax_err:
        JaxNet(JaxNP.from_text(text), "TRAIN")
    with pytest.raises(ValueError) as port_err:
        Net(NetParameter.from_text(text), "TRAIN", device="cpu")
    assert str(port_err.value) == str(jax_err.value)


def test_a_pipeline_net_tests_as_the_jax_solver():
    """The test pass of a net with a Pipeline layer, whose stacked params
    are named "inner.param": the port's pass reads the weights' copies
    by swapping the layers' own dicts (`net.reading`), as a dotted name
    cannot resolve as a submodule path; its scores against the JAX
    Solver's test_all on the same weights and batches (rtol 1e-5)."""
    text = PP_SOLVER + " test_iter: 2 test_interval: 1000"
    js = JaxSolver(JaxSP.from_text(text))
    feeds = _pp_feeds(seed=9)
    want = js.test_all([lambda k: feeds[k]])
    solver = Solver(SolverParameter.from_text(text), device="cpu")
    load_jax_params(solver.net, _host(js.params))
    got = solver.test_all([lambda k: {key: torch.from_numpy(v)
                                      for key, v in feeds[k].items()}])
    assert set(got[0]) == set(want[0]) and "loss" in got[0]
    for key, value in want[0].items():
        np.testing.assert_allclose(got[0][key], value, rtol=1e-5,
                                   atol=1e-6)
