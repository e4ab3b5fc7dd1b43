"""Heterogeneous pipeline parallelism: GPipe over explicit devices.

The port's counterpart of the JAX package's caffe_mpi_tpu/parallel/gpipe.py,
name for name. The reference has no pipeline parallelism (its
ForwardFromTo is a sequential loop on one device, net.cpp:669-682);
`parallel/pipeline.py` covers stages of one shape (a shift register of
stacked blocks). This module covers nets whose stages differ in both
computation and activation shape: every CNN of the zoo.

- Stage s is a contiguous layer range [bounds[s], bounds[s+1]) of a `Net`,
  run by `Net.forward_range` (the code path of the whole net), its
  layers' params and state buffers on the stage's device (`place_params`:
  the params are partitioned, not replicated).
- Only boundary blobs cross between stages (`boundary_blobs`): the wire a
  stage reads for blob b comes from the last earlier stage that
  (re)produces b, resolved for each consumer stage, since an in-place top
  (conv1 -> bn1 -> relu1, all named conv1) can be produced again in a
  later stage than its origin.
- The schedule is a wavefront issued from the host: at tick t stage s
  runs micro-batch t - s. The forward runs without autograd and keeps
  only each stage's boundary inputs (detached). The backward wavefront
  runs in reverse: stage s runs its range again on the saved inputs
  under autograd and back-propagates the cotangents of its out-wire and
  the loss seed (`loss_scale`). Peak memory is n_micro boundary blobs,
  not n_micro activation sets.
- Gradients accumulate on the owner stage's device. A param shared by
  name whose owner lives on another stage is read by the referencing
  stage as a per-step copy on its own device; that copy's gradient goes
  back and is added on the owner's device. Integer wires (labels) carry
  no gradient.

Semantics (the JAX module's): micro-batches run in order within each
stage, so layer state (BatchNorm's running statistics) updates once a
micro-batch, in micro-batch order, as a sequential loop would; the
recompute reads the state the forward read and leaves the state the
forward wavefront left. The loss and the gradients are means over the
micro-batches: the `iter_size` contract (reference solver.cpp:277-288).
Dropout masks are handed in, keyed by layer name, so the recompute and
the forward draw alike, whatever the partition.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..core.device import resolve_device
from ..layers.data_layers import InputLayerBase
from ..utils.flops import layer_macs_per_image


def _stage_cost(layer) -> float:
    """Balance weight for the automatic cut: MACs, plus a little of the
    activation size so that stretches of elementwise layers count."""
    macs = layer_macs_per_image(layer)
    act = sum(math.prod(s) for s in layer.out_shapes if s)
    return float(macs) + 0.05 * float(act)


def auto_boundaries(net, n_stages: int) -> list[int]:
    """Stage boundaries [0 = b0 < b1 < ... < b_S = n_layers] that balance
    the cumulative layer cost, preferring cuts with few crossing blobs.
    The input layers stay in stage 0. The JAX `auto_boundaries`: the same
    net gives the same cuts."""
    n = len(net.layers)
    if not 1 <= n_stages <= n:
        raise ValueError(f"n_stages {n_stages} out of range for {n} layers")
    costs = [_stage_cost(l) for l in net.layers]
    total = sum(costs) or 1.0
    # the number of blobs alive across each cut position
    widths = [len(boundary_blobs(net, cut, n)) for cut in range(n + 1)]
    first_cut = max((i + 1 for i, l in enumerate(net.layers)
                     if isinstance(l, InputLayerBase)), default=1)
    bounds = [0]
    for s in range(1, n_stages):
        target = total * s / n_stages
        # the best cut near the cost quantile: least (width, distance)
        lo = max(bounds[-1] + 1, first_cut)
        best, best_key = None, None
        run = 0.0
        for cut in range(1, n):
            run += costs[cut - 1]
            if cut < lo:
                continue
            if cut > n - (n_stages - s):  # leave room for later stages
                break
            key = (widths[cut], abs(run - target) / total)
            if best_key is None or key < best_key:
                best, best_key = cut, key
        if best is None:
            raise ValueError("could not place stage boundaries")
        bounds.append(best)
    bounds.append(n)
    return bounds


def boundary_blobs(net, lo: int, hi: int) -> list[str]:
    """Blobs that layers [lo, hi) consume but that an earlier layer last
    produced (the stage's in-wire), sorted."""
    produced_before = set()
    for l in net.layers[:lo]:
        produced_before.update(l.lp.top)
    produced_in: set[str] = set()
    need: set[str] = set()
    for l in net.layers[lo:hi]:
        for b in l.lp.bottom:
            if b not in produced_in:
                if b not in produced_before:
                    raise ValueError(f"blob {b!r} undefined before layer "
                                     f"range [{lo},{hi})")
                need.add(b)
        produced_in.update(l.lp.top)
    return sorted(need)


def stage_devices(n_stages: int, device) -> list[torch.device]:
    """The stages' devices: `cuda:s` for stage s when `device` is a card
    and that many cards are visible, else `device` for every stage (all
    stages on one card, or on the CPU)."""
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= n_stages:
        return [resolve_device(f"cuda:{s}") for s in range(n_stages)]
    return [device] * n_stages


def _floating(t) -> bool:
    return torch.is_tensor(t) and t.is_floating_point()


class GPipe:
    """Pipelined trainer over a Net cut into heterogeneous stages.

    devices: one device a stage (default `stage_devices(S, net.device)`).
    boundaries: an explicit [0, ..., n_layers] cut list, or None to
    balance by the analytic layer cost."""

    def __init__(self, net, n_stages: int | None = None, *,
                 boundaries: Sequence[int] | None = None,
                 devices: Sequence | None = None):
        self.net = net
        if boundaries is None:
            if n_stages is None:
                raise ValueError("give n_stages or boundaries")
            boundaries = auto_boundaries(net, n_stages)
        boundaries = list(boundaries)
        if (boundaries[0] != 0 or boundaries[-1] != len(net.layers)
                or any(a >= b for a, b in zip(boundaries, boundaries[1:]))):
            raise ValueError(f"bad boundaries {boundaries}")
        self.bounds = boundaries
        self.n_stages = len(boundaries) - 1
        if devices is None:
            devices = stage_devices(self.n_stages, net.device)
        if len(devices) < self.n_stages:
            raise ValueError(
                f"{self.n_stages} stages need {self.n_stages} devices, "
                f"got {len(devices)}")
        # a stage that cannot reach its card raises here
        self.devices = [resolve_device(d) for d in devices[: self.n_stages]]

        n = len(net.layers)
        self.in_blobs = [boundary_blobs(net, self.bounds[s],
                                        self.bounds[s + 1])
                         for s in range(self.n_stages)]
        # out wire of stage s: tops (re)produced in s that a later layer
        # still consumes (the in-wire of the rest of the net)
        self.out_blobs = []
        for s in range(self.n_stages):
            hi = self.bounds[s + 1]
            produced = set()
            for l in net.layers[self.bounds[s]: hi]:
                produced.update(l.lp.top)
            rest_need = (set(boundary_blobs(net, hi, n))
                         if hi < n else set())
            self.out_blobs.append(sorted(produced & rest_need))
        # the value stage s reads for wire blob b comes from the LAST
        # stage before s that (re)produces b: per consumer stage, since
        # an in-place top can be produced again in a later stage
        produced_by_stage = []
        for s in range(self.n_stages):
            tops: set[str] = set()
            for l in net.layers[self.bounds[s]: self.bounds[s + 1]]:
                tops.update(l.lp.top)
            produced_by_stage.append(tops)
        self._in_producer: list[dict[str, int]] = []
        for s in range(self.n_stages):
            prod = {}
            for b in self.in_blobs[s]:
                for p in range(s - 1, -1, -1):
                    if b in produced_by_stage[p]:
                        prod[b] = p
                        break
            self._in_producer.append(prod)
        # host-feed keys per stage (the input layers in the range)
        self.feed_keys: list[list[str]] = []
        for s in range(self.n_stages):
            keys: list[str] = []
            for l in net.layers[self.bounds[s]: self.bounds[s + 1]]:
                if isinstance(l, InputLayerBase):
                    keys.extend(k for k, _, _ in l.feed_specs())
            self.feed_keys.append(keys)
        # home stage of every layer's params (place_params puts them there)
        self._owner_stage: dict[str, int] = {}
        for s in range(self.n_stages):
            for l in net.layers[self.bounds[s]: self.bounds[s + 1]]:
                self._owner_stage[l.name] = s
        # param layers each stage needs: its own and the owners of params
        # it shares by name that live elsewhere
        self.param_layers: list[list[str]] = []
        for s in range(self.n_stages):
            names: set[str] = set()
            for l in net.layers[self.bounds[s]: self.bounds[s + 1]]:
                for pname in l.decls:
                    names.add(net.owner_of(l.name, pname)[0])
            self.param_layers.append(sorted(names))
        self.state_layers = [
            [l.name for l in net.layers[self.bounds[s]: self.bounds[s + 1]]]
            for s in range(self.n_stages)]
        # (layer, param) -> owner (layer, param) for each stage's uses of
        # a param whose owner lives on another stage
        self._remote: list[dict[tuple[str, str], tuple[str, str]]] = []
        for s in range(self.n_stages):
            uses = {}
            for l in net.layers[self.bounds[s]: self.bounds[s + 1]]:
                for pname in l.decls:
                    owner = net.owner_of(l.name, pname)
                    if self._owner_stage[owner[0]] != s:
                        uses[(l.name, pname)] = owner
            self._remote.append(uses)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def place_params(self) -> None:
        """Put each stage's params and state buffers on its stage's device
        (the memory partition). A param shared by name stays with its
        owner's stage, and every layer holding it sees it move."""
        net = self.net
        for layer in net.layers:
            dev = self.devices[self._owner_stage[layer.name]]
            layer.device = dev
            for pname in layer.decls:
                if (layer.name, pname) in net.param_aliases:
                    continue
                p = getattr(layer, pname)
                if p.device != dev:
                    p.data = p.data.to(dev)
            for sname in layer.state_shapes:
                buf = getattr(layer, sname)
                if buf.device != dev:
                    buf.data = buf.data.to(dev)

    def owner_stage(self, lname: str) -> int:
        """Home stage of a layer's params (where they live and where their
        optimizer update runs)."""
        return self._owner_stage.get(lname, 0)

    def owned_param_layers(self, s: int) -> list[str]:
        """The layers whose params live on stage s: the partition the
        stage-local optimizer update runs over."""
        return sorted({lname for lname, _, _ in
                       self.net.learnable_param_decls()
                       if self._owner_stage.get(lname, 0) == s})

    def _stage_params(self, s: int) -> dict:
        """Stage s's copies of the params it shares with an owner on
        another stage, {layer: {param: copy on the stage's device}}, and
        the (owner param, copy) pairs whose gradients go back. Only such
        params are copied; the zoo's CNNs share none across stages."""
        out: dict[str, dict[str, torch.Tensor]] = {}
        pairs = []
        for (lname, pname), (oname, opname) in self._remote[s].items():
            owner = getattr(self.net.layer_by_name(oname), opname)
            copy = owner.detach().to(self.devices[s], copy=True)
            copy.requires_grad_(owner.requires_grad)
            out.setdefault(lname, {})[pname] = copy
            pairs.append((owner, copy))
        return out, pairs

    def _stage_state(self, s: int) -> list[torch.Tensor]:
        return [buf for lname in self.state_layers[s]
                for buf in (getattr(self.net.layer_by_name(lname), n)
                            for n in self.net.layer_by_name(
                                lname).state_shapes)]

    def _run(self, s: int, feeds: dict, env_in: dict, masks: dict,
             params: dict):
        lo, hi = self.bounds[s], self.bounds[s + 1]
        return self.net.forward_range(
            feeds, env_in, lo, hi, dropout_masks=masks, params=params,
            device=self.devices[s])

    # ------------------------------------------------------------------
    def train_step(self, microbatch_feeds: Sequence[dict], *,
                   dropout_masks: Sequence[dict] | None = None,
                   loss_scale: float = 1.0):
        """One pipelined step over the micro-batches' feed dicts.

        Returns (loss, grads): the loss, a float32 scalar on stage 0's
        device, and {(layer, param): gradient on the owner's device} for
        every owned param that trains, both means over the micro-batches
        (`iter_size` semantics). The layers' state buffers hold the state
        after the step (micro-batches applied in order). `loss_scale`
        seeds the backward scaled (reference global_grad_scale,
        net.cpp:116-119): the returned gradients are scaled by it, the
        caller unwinds it; the loss is not scaled. The params' `.grad`
        are the scaled sums over the micro-batches after the call."""
        n_micro = len(microbatch_feeds)
        if n_micro < 1:
            raise ValueError("need at least one microbatch")
        S, dev, net = self.n_stages, self.devices, self.net
        masks = list(dropout_masks) if dropout_masks is not None \
            else [{}] * n_micro
        decls = [(l, p, getattr(net.layer_by_name(l), p))
                 for l, p, _ in net.learnable_param_decls()]
        for _, _, p in decls:
            p.grad = None
        stage_params, pairs = zip(*(self._stage_params(s)
                                    for s in range(S)))
        stage_state = [self._stage_state(s) for s in range(S)]
        stage_layers = [set(self.state_layers[s]) for s in range(S)]
        env: list[dict[str, torch.Tensor]] = [dict() for _ in range(n_micro)]
        saved = [[None] * n_micro for _ in range(S)]
        losses: list[list[torch.Tensor]] = [[] for _ in range(n_micro)]

        # forward wavefront: at tick t stage s runs micro-batch t - s
        with torch.no_grad():
            for t in range(S + n_micro - 1):
                for s in range(min(t, S - 1), -1, -1):
                    m = t - s
                    if not 0 <= m < n_micro:
                        continue
                    env_in = {b: env[m][b].to(dev[s], non_blocking=True)
                              for b in self.in_blobs[s]}
                    feeds = {k: torch.as_tensor(microbatch_feeds[m][k]).to(
                        dev[s], non_blocking=True)
                        for k in self.feed_keys[s]}
                    mk = {k: v.to(dev[s], non_blocking=True)
                          for k, v in masks[m].items()
                          if k in stage_layers[s]}
                    st_in = [b.clone() for b in stage_state[s]]
                    saved[s][m] = (env_in, feeds, mk, st_in)
                    out, loss_s = self._run(s, feeds, env_in, mk,
                                            stage_params[s])
                    env[m].update({b: out[b] for b in self.out_blobs[s]})
                    losses[m].append(loss_s)
        # the state the forward wavefront left, which each recompute
        # leaves in place
        final_state = [[b.clone() for b in stage_state[s]]
                       for s in range(S)]

        # backward wavefront, in reverse; cotangents accumulate on the
        # producing stage's device
        ct_env: list[dict[str, torch.Tensor]] = [dict() for _ in
                                                 range(n_micro)]
        for t in range(S + n_micro - 2, -1, -1):
            for s in range(min(t, S - 1), -1, -1):
                m = t - s
                if not 0 <= m < n_micro:
                    continue
                env_in, feeds, mk, st_in = saved[s][m]
                saved[s][m] = None  # free the residual once consumed
                leaves = {}
                for b, v in env_in.items():
                    if _floating(v) and b in self._in_producer[s]:
                        v = v.detach().requires_grad_(True)
                        leaves[b] = v
                    env_in[b] = v
                with torch.no_grad():
                    for buf, v in zip(stage_state[s], st_in):
                        buf.copy_(v)
                with torch.enable_grad():
                    out, loss_s = self._run(s, feeds, env_in, mk,
                                            stage_params[s])
                roots, cts = [], []
                for b in self.out_blobs[s]:
                    ct = ct_env[m].pop(b, None)
                    if ct is None or not out[b].requires_grad:
                        continue  # int wires, and outs nobody differentiates
                    roots.append(out[b])
                    cts.append(ct.to(dev[s], non_blocking=True))
                if loss_s.requires_grad:
                    roots.append(loss_s)
                    cts.append(torch.full((), float(loss_scale),
                                          dtype=torch.float32,
                                          device=dev[s]))
                if roots:
                    torch.autograd.backward(roots, cts)
                for b, v in leaves.items():
                    if v.grad is None:
                        continue
                    p = self._in_producer[s][b]
                    ct = v.grad.to(dev[p], non_blocking=True)
                    prev = ct_env[m].get(b)
                    ct_env[m][b] = ct if prev is None else prev + ct
        with torch.no_grad():
            for s in range(S):
                for buf, v in zip(stage_state[s], final_state[s]):
                    buf.copy_(v)
            # a shared param's gradient from a stage other than its
            # owner's, added on the owner's device
            for stage_pairs in pairs:
                for owner, copy in stage_pairs:
                    if copy.grad is None:
                        continue
                    g = copy.grad.to(owner.device)
                    owner.grad = g if owner.grad is None else owner.grad + g
        inv = 1.0 / n_micro
        grads = {(l, p): t.grad * inv for l, p, t in decls
                 if t.grad is not None}
        loss = sum(torch.stack([x.to(dev[0]) for x in losses[m]]).sum()
                   for m in range(n_micro)) * inv
        return loss, grads


def lrn_launches(gp: GPipe, n_micro: int) -> tuple[int, int]:
    """(K1, K2): the across-channel LRN kernel launches one `train_step`
    over `n_micro` micro-batches makes on the card. Each LRN of a stage
    launches K1 once a micro-batch in the forward wavefront and once
    more in its stage's recompute, and K2 once a micro-batch in the
    backward, where its input carries a gradient; a `remat` LRN runs its
    forward once more inside the backward."""
    net, k1, k2 = gp.net, 0, 0
    for layer in net.layers:
        if layer.lp.type != "LRN" or layer.region == "WITHIN_CHANNEL":
            continue
        remat = 1 if layer.lp.remat else 0
        k1 += n_micro * (2 + remat)
        k2 += n_micro
    return k1, k2
