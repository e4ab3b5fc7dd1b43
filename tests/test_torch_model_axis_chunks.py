"""Port parity: `step_chunk` > 1 under the mesh's 'model' axis (the JAX
Solver's fused chunk over the sharded program,
caffe_mpi_tpu/solver/solver.py `_train_chunk`).

Four gloo ranks on the CPU in a 2 x 2 mesh (tests/torch_dp_worker.py):
the ring over the model ranks (narrow transformer_lm, sequence parallel,
experts split), InnerProduct rows/cols, Convolution rows/cols. On the
CPU, and under gloo on a card, a chunk runs its iterations eagerly
(`Solver.graph_route`), so step_chunk 5 equals step_chunk 1 element for
element; both are held against the JAX Solver's one fused chunk of 5 at
the bars of test_torch_model_parallel.py (losses rtol 1e-5; params and history, gathered whole,
rtol 1e-5 / atol 1e-6). Under NCCL the chunk is one CUDA graph an
iteration, model-axis collectives inside (chip_smoke.py --only mp_cards).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_model_parallel import (EP, ITERS, MESH, TP_CONV, TP_MLP,
                                       assert_like_jax, assert_ranks_equal,
                                       jax_start, narrow_sp_net,
                                       narrow_sp_tp_net, solver_text)
from torch_dp_worker import Ranks

# the JAX solver's loss window keeps a fused chunk's 5 losses (display
# smoothing only: no number of the run depends on it)
KEEP5 = " average_loss: 5"

CASES = {
    # name: (solver text without step_chunk, feeds seed, param_shardings)
    "sp": (solver_text(narrow_sp_net(), kind="Adam", extra="base_lr: 0.01"),
           4, {"blk1/moe": EP}),
    "sp_tp": (solver_text(narrow_sp_tp_net(), kind="Adam",
                          extra="base_lr: 0.01 clip_gradients: 0.5"), 6,
              None),
    "tp_mlp": (solver_text(TP_MLP, extra="clip_gradients: 0.5"), 1, None),
    "tp_conv": (solver_text(TP_CONV, extra="train_guard: true"), 2, None),
}


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chunks")
    with ThreadPoolExecutor(len(CASES)) as ex:
        started = dict(zip(CASES, ex.map(
            lambda n: jax_start(CASES[n][0] + KEEP5 + " step_chunk: 5",
                                *CASES[n][1:]), CASES)))
    scs = []
    for name, (_, sc) in started.items():
        scs.append(dict(sc, name=f"{name}_k5"))
        scs.append(dict(sc, name=f"{name}_k1",
                        solver=CASES[name][0] + KEEP5 + " step_chunk: 1"))
    ranks = Ranks({"mesh": MESH, "scenarios": scs}, 4, str(tmp / "ranks"),
                  timeout=240)

    def chunk(name):
        # one call: the JAX solver fuses the 5 iterations into one chunk
        js, sc = started[name]
        js.step(ITERS, lambda k: sc["feeds"][k])
        return name, (js, [float(v) for v in js._loss_window])
    with ThreadPoolExecutor(len(CASES)) as ex:
        refs = dict(ex.map(chunk, CASES))
    return ranks.results(), refs


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunk_of_five_equals_five_single_steps(spawn, name):
    results, _ = spawn
    k5, k1 = results[0][f"{name}_k5"], results[0][f"{name}_k1"]
    assert k5["losses"] == k1["losses"]
    for key, arr in k1["state"].items():
        assert np.array_equal(k5["state"][key], arr), key
    assert_ranks_equal(results, f"{name}_k5")
    assert k5["graph_route"] == "eager: not on a card"


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunk_of_five_matches_the_jax_fused_chunk(spawn, name):
    results, refs = spawn
    js, losses = refs[name]
    assert len(losses) == ITERS
    assert_like_jax(js, losses, results[0][f"{name}_k5"])


def test_model_axis_only_view_shares_the_counters():
    """A whole-batch test net's plan: its data-axis collectives do
    nothing and its data index is 0; its model group's peers, counters
    and timing are the mesh's own."""
    from caffe_mpi_tpu_torch.parallel.mesh import MeshPlan
    mp = MeshPlan(n_data=2, rank=3, device=torch.device("cpu"),
                  backend="gloo", n_model=2)
    view = mp.model_axis_only()
    assert (view.n_data, view.data_index, view.model_index) == (1, 0, 1)
    assert [view.model_peer(m) for m in range(2)] == \
        [mp.model_peer(m) for m in range(2)] == [2, 3]
    assert view.collectives is mp.collectives and view.sent is mp.sent
    mp.timing = True
    assert view.timing and view.clock is mp.clock
    x = torch.arange(6.0)
    assert torch.equal(view.shard(x), x)
    t = torch.ones(3)
    view.all_reduce_(t)
    assert torch.equal(t, torch.ones(3))
    assert view.all_gather(t).shape == (1, 3)
    view.model_bytes += 12
    assert mp.model_bytes == 12
