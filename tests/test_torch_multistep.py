"""Port parity: `step_chunk` — iterations in chunks of up to K, one host
sync a chunk — against the port's K = 1 and the JAX Solver's fused
K-step scan, on the CPU.

On the CPU a chunk runs the same iteration code eagerly (on the card it
replays a CUDA graph of it; chip_smoke.py holds that against the eager
chunk). The iteration reads (lr, momentum, t) from the chunk's table on
the device and the Dropout masks drawn ahead of it, so K = 5 equals
K = 1 bitwise here, snapshots at chunk boundaries included. Against the
JAX Solver at step_chunk 5: losses rtol 1e-5, params and history rtol
1e-5 / atol 1e-6 (the f32 solver tolerances of tests/test_torch_train.py
and test_torch_transformer.py). `_chunk_at` is the JAX rule, held equal
over a grid of iterations, lengths, boundaries and K.
"""

import filecmp
import itertools

import jax
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu_torch.proto import SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.weights import load_jax_params

import test_torch_resnet as tr
import test_torch_train as tt
import test_torch_transformer as tx

STEP = dict(rtol=1e-5, atol=1e-6)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state(solver):
    out = {f"{l}.{p}": p_.detach().clone() for l, p, _, p_ in solver._decls}
    for key, slots in solver.history.items():
        for i, s in enumerate(slots):
            out[f"{key}.h{i}"] = s.clone()
    for l, s, buf in solver.net.state_buffers():
        out[f"{l}.{s}"] = buf.clone()
    return out


def _assert_bitwise(a, b):
    assert a.losses == b.losses
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# -- _chunk_at ----------------------------------------------------------------

class _Probe:
    """The attributes each package's _chunk_at reads."""

    def __init__(self, text):
        self.sp = SolverParameter.from_text(text)
        self.step_chunk = max(self.sp.step_chunk, 1)
        self.gpipe, self._sync_steps = None, False


GRID = list(itertools.product(
    (1, 2, 5, 10),                  # step_chunk
    ("", "display: 4", "display: 7 test_interval: 6",
     "test_interval: 5 snapshot: 3", "display: 1 snapshot: 10",
     "display: 20 test_interval: 20 snapshot: 20")))


@pytest.mark.parametrize("k,events", GRID)
def test_chunk_at_equals_the_jax_rule(k, events):
    text = f"base_lr: 0.1 step_chunk: {k} {events}"
    port, ref = _Probe(text), _Probe(text)
    ref.sp = JaxSP.from_text(text)
    for it, n, testing in itertools.product(range(0, 41), (1, 3, 9, 40),
                                            (True, False)):
        assert Solver._chunk_at(port, it, n, testing) == \
            JaxSolver._chunk_at(ref, it, n, testing), (it, n, testing)


# -- K = 5 against K = 1 in the port, bitwise ---------------------------------

def _alexnet(extra):
    return Solver(SolverParameter.from_text(tt.solver_text(extra)),
                  device="cpu")


NETS = {
    # Dropout drawn from the solver's generator (no given masks)
    "alexnet": (_alexnet, lambda: tt._torch_feeds(tt._feeds(10))),
    "resnet": (tr._port_solver, lambda: tr._torch_feeds(tr._feeds(10))),
}


@pytest.mark.parametrize("net", ["alexnet", "resnet"])
@pytest.mark.parametrize("extra", ["", 'precision: "bf16"',
                                   "train_guard: true display: 3"])
def test_step_chunk_5_equals_step_chunk_1_bitwise(net, extra):
    make, feeds = NETS[net]
    one = make(extra)
    one.step(10, feeds())
    five = make(extra + " step_chunk: 5")
    five.step(10, feeds())
    _assert_bitwise(one, five)
    assert one.dispatch_count == 10
    assert five.dispatch_count == five.host_sync_count < 10
    assert (one.skipped_steps, one.overflow_steps, one.loss_scale_value) \
        == (five.skipped_steps, five.overflow_steps, five.loss_scale_value)


def test_step_chunk_5_equals_step_chunk_1_bitwise_for_adam():
    def make(k):
        sp_text = tx.SOLVER + f" step_chunk: {k}"
        sp = SolverParameter.from_text(sp_text)
        from caffe_mpi_tpu_torch.proto import NetParameter
        sp.net_param = NetParameter.from_text(tx.narrow_net())
        return Solver(sp, device="cpu")
    one, five = make(1), make(5)
    feeds = tx._feeds(10)
    one.step(10, tx._torch_feeds(feeds))
    five.step(10, tx._torch_feeds(feeds))
    _assert_bitwise(one, five)
    assert five.dispatch_count == 2


def test_a_burst_inside_a_chunk_skips_the_same_steps_as_k1():
    """Non-finite feeds in the middle of a chunk under the dynamic scale:
    the same skips, overflows and scale, bitwise the same params."""
    feeds = tt._feeds(10)
    bad = {k: np.full_like(v, np.nan) if k == "data" else v
           for k, v in feeds[0].items()}
    poisoned = [bad if i in (3, 6) else f for i, f in enumerate(feeds)]
    one = _alexnet('precision: "bf16" loss_scale_window: 2')
    five = _alexnet('precision: "bf16" loss_scale_window: 2 step_chunk: 5')
    one.step(10, tt._torch_feeds(poisoned))
    five.step(10, tt._torch_feeds(poisoned))
    assert one.skipped_iters == five.skipped_iters == [3, 6]
    assert five.overflow_steps == one.overflow_steps == 2
    assert five.loss_scale_value == one.loss_scale_value
    np.testing.assert_array_equal(np.array(one.losses),
                                  np.array(five.losses))
    sa, sb = _state(one), _state(five)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_masks_drawn_ahead_are_the_forwards_own_draws():
    """A Dropout layer's draw_mask gives the mask its forward would draw
    from the same generator state, so chunks (and graphs) that draw the
    masks ahead train as the forward-drawn path did."""
    s = _alexnet("")
    feeds = tt._torch_feeds(tt._feeds(1))(0)
    gen = torch.Generator().manual_seed(7)
    blobs, loss = s.net(feeds, generator=gen)
    gen.manual_seed(7)
    masks = {l.name: l.draw_mask(gen) for l in s._droppers}
    assert sorted(masks) == ["drop_fc6", "drop_fc7"]
    blobs2, loss2 = s.net(feeds, dropout_masks=masks)
    assert torch.equal(loss, loss2)
    assert torch.equal(blobs["fc7"], blobs2["fc7"])


# -- against the JAX Solver's fused chunks -------------------------------------

def test_step_chunk_5_matches_the_jax_fused_scan_alexnet():
    text = tt.solver_text("step_chunk: 5")
    jsolver = JaxSolver(JaxSP.from_text(text))
    port = Solver(SolverParameter.from_text(text), device="cpu")
    load_jax_params(port.net, _host(jsolver.params))
    feeds = tt._feeds(10)
    jsolver.step(10, lambda k: feeds[k])
    port.step(10, tt._torch_feeds(feeds),
              dropout_masks=tt._jax_masks(jsolver))
    assert jsolver.dispatch_count == port.dispatch_count == 2
    tt._assert_params_equal(jsolver.params, port.net, **STEP)
    for (l, p), slots in port.history.items():
        np.testing.assert_allclose(slots[0].numpy(), np.asarray(
            jsolver.opt_state[l][p][0]), err_msg=f"{l}.{p}", **STEP)


def test_step_chunk_5_matches_the_jax_fused_scan_resnet():
    text = tr.solver_text("step_chunk: 5")
    jsolver = JaxSolver(JaxSP.from_text(text))
    port = tr._port_solver("step_chunk: 5")
    load_jax_params(port.net, _host(jsolver.params),
                    _host(jsolver.net_state))
    feeds = tr._feeds(10)
    jsolver.step(10, lambda k: feeds[k])
    port.step(10, tr._torch_feeds(feeds))
    tr._assert_tree(jsolver.params, port.net, **STEP)
    tr._assert_tree(jsolver.net_state, port.net, **STEP)


def test_step_chunk_5_matches_the_jax_fused_scan_adam():
    from caffe_mpi_tpu.proto import NetParameter as JaxNP
    from caffe_mpi_tpu_torch.proto import NetParameter
    jsp = JaxSP.from_text(tx.SOLVER + " step_chunk: 5")
    jsp.net_param = JaxNP.from_text(tx.narrow_net())
    sp = SolverParameter.from_text(tx.SOLVER + " step_chunk: 5")
    sp.net_param = NetParameter.from_text(tx.narrow_net())
    jsolver, port = JaxSolver(jsp), Solver(sp, device="cpu")
    load_jax_params(port.net, _host(jsolver.params))
    feeds = tx._feeds(10)
    jsolver.step(10, lambda k: feeds[k])
    port.step(10, tx._torch_feeds(feeds))
    assert jsolver.dispatch_count == port.dispatch_count == 2
    tt._assert_params_equal(jsolver.params, port.net, **STEP)
    for (l, p), slots in port.history.items():
        for s, (a, b) in enumerate(zip(slots, jsolver.opt_state[l][p])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=f"{l}.{p}.{s}", **STEP)


# -- snapshots at chunk boundaries --------------------------------------------

def test_snapshot_at_a_chunk_boundary_is_the_k1_snapshot_byte_for_byte(
        tmp_path):
    feeds = tt._feeds(10)
    paths = {}
    for k in (1, 5):
        prefix = tmp_path / f"k{k}" / "s"
        s = _alexnet(f'step_chunk: {k} snapshot: 4 '
                     f'snapshot_prefix: "{prefix}"')
        s.step(10, tt._torch_feeds(feeds))
        paths[k] = prefix
        # a chunk stops at the snapshot boundary: 0-3, 4-7, 8-9
        assert s.dispatch_count == (10 if k == 1 else 3)
    for it in (4, 8):
        for ext in ("caffemodel", "solverstate"):
            a = f"{paths[1]}_iter_{it}.{ext}"
            b = f"{paths[5]}_iter_{it}.{ext}"
            if ext == "solverstate":
                # the state names its caffemodel by path: compare the rest
                from caffe_mpi_tpu_torch import io as port_io
                ia, la, ha, sa = port_io.load_solverstate(a)
                ib, lb, hb, sb = port_io.load_solverstate(b)
                assert (ia, sa) == (ib, sb)
                assert all(np.array_equal(x, y) for x, y in zip(ha, hb))
            else:
                assert filecmp.cmp(a, b, shallow=False), (it, ext)


def test_resume_at_a_chunk_boundary_equals_the_uninterrupted_run(tmp_path):
    feeds = tt._feeds(10)
    prefix = tmp_path / "s"
    whole = _alexnet(f'step_chunk: 5 snapshot: 4 snapshot_prefix: "{prefix}"')
    whole.step(10, tt._torch_feeds(feeds))
    resumed = _alexnet(f'step_chunk: 5 snapshot: 4 '
                       f'snapshot_prefix: "{tmp_path / "r"}"')
    resumed.restore(f"{prefix}_iter_4.solverstate")
    assert resumed.iter == 4
    resumed.step(6, tt._torch_feeds(feeds))
    assert resumed.losses == whole.losses[4:]
    sa, sb = _state(whole), _state(resumed)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_the_chunk_table_holds_each_iterations_lr_momentum_and_t():
    """A chunk that crosses a step of the LR policy (stepsize 3) reads the
    new rate at its iteration: the rates the host reads back are the
    schedule's, row by row."""
    from caffe_mpi_tpu_torch.solver import lr_policy
    s = _alexnet("step_chunk: 5")
    s.step(5, tt._torch_feeds(tt._feeds(5)))
    table = lr_policy.table(s.sp, 0, 5)
    assert table.dtype == np.float32 and table.shape == (5, 3)
    np.testing.assert_array_equal(table[:, 2], np.arange(1, 6))
    np.testing.assert_allclose(table[:, 0], [0.01] * 3 + [0.001] * 2,
                               rtol=1e-7)
    np.testing.assert_array_equal(s._out[:5, 1].numpy(), table[:, 0])
