"""pycaffe-compatible API — `import caffe_mpi_tpu_torch.pycaffe as caffe`.

Reference: python/caffe/_caffe.cpp (boost::python bindings) and
python/caffe/pycaffe.py; JAX package caffe_mpi_tpu/pycaffe.py, whose
surface this is: `Net(model, [weights,] phase)` with `blobs`, `params`,
`forward`, `backward`, `copy_from`, `save`; `Blob` with numpy `data` and
`diff`; the solvers (`SGDSolver` and the Nesterov, AdaGrad, RMSProp,
AdaDelta and Adam aliases: the prototxt's `type` picks the rule),
`get_solver`; `set_mode_cpu`, `set_mode_gpu`, `set_device`,
`layer_type_list`; `NetSpec`, `L`; `io` (caffe_io.py), `Classifier` and
`Detector` (classifier.py).

Blob values are numpy copies: a blob's `data` is read after `forward`, a
param's `data` reads the live tensor and assigning it copies into the
tensor in place (every net and CUDA graph that holds the tensor sees
it); `backward()` fills the params' `diff` with the gradients of the net's
loss. As in the JAX module, `backward` does not move layer state (a TRAIN
BatchNorm's running statistics are put back) and draws Dropout from a
generator seeded 0, unless masks are handed in.

The card is the default: `set_mode_cpu()`, or `device="cpu"`, is the only
way onto the CPU, and without a card and without either every entry point
raises. HDF5 weights are refused (ROADMAP.md §1 item 7).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import caffe_io as io  # noqa: F401 — pycaffe's io module
from . import io as _io
from .layers.base import LAYER_REGISTRY
from .net import Net as _GraphNet
from .net_spec import L, NetSpec  # noqa: F401 — pycaffe net_spec parity
from .proto import NetParameter, SolverParameter

TRAIN, TEST = "TRAIN", "TEST"

# the device entry points run on: Caffe::mode and the device id, which
# the reference keeps process-wide and pycaffe sets through set_mode_*
_MODE = {"gpu": True, "device_id": 0}


def set_mode_cpu() -> None:
    """Caffe::set_mode(CPU): later nets and solvers run on the CPU."""
    _MODE["gpu"] = False


def set_mode_gpu() -> None:
    """Caffe::set_mode(GPU): later nets and solvers run on the card (the
    default)."""
    _MODE["gpu"] = True


def set_device(device_id: int) -> None:
    """Caffe::SetDevice: the card of later nets and solvers in GPU mode."""
    _MODE["device_id"] = int(device_id)


def _device(device) -> str:
    if device is not None:
        return str(device)
    return f"cuda:{_MODE['device_id']}" if _MODE["gpu"] else "cpu"


def layer_type_list() -> list[str]:
    """The registered layer types (LayerRegistry::LayerTypeList)."""
    return sorted(LAYER_REGISTRY)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.is_floating_point() and t.dtype != torch.float32:
        t = t.float()
    return t.cpu().numpy().copy()


class Blob:
    """Numpy view of a named array (reference _caffe.cpp Blob bindings)."""

    def __init__(self, get, set_=None, diff_get=None):
        self._get = get
        self._set = set_
        self._diff_get = diff_get
        self._cache: np.ndarray | None = None

    @property
    def data(self) -> np.ndarray:
        if self._cache is None:
            self._cache = np.array(self._get())
        return self._cache

    @data.setter
    def data(self, value) -> None:
        self._cache = np.asarray(value)
        if self._set:
            self._set(self._cache)

    def push(self) -> None:
        """Write an in-place edit of `data` back."""
        if self._cache is not None and self._set:
            self._set(self._cache)

    @property
    def diff(self) -> np.ndarray:
        if self._diff_get is None:
            raise AttributeError("diff only available after backward()")
        return np.array(self._diff_get())

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def num(self):
        return self.shape[0]

    @property
    def channels(self):
        return self.shape[1] if len(self.shape) > 1 else 1


def _data_probe(model_dir: str):
    """A Data layer's shape from its dataset, without the raw record
    shape: the net takes blobs already transformed (users set them by
    name), as the JAX module's `device_transform=False`."""
    from .data.feeder import data_shape_probe
    return lambda lp: tuple(data_shape_probe(lp, model_dir))


class Net:
    """caffe.Net(model_file, phase) or caffe.Net(model_file, weights,
    phase); `device=` overrides the mode."""

    def __init__(self, model_file: str, *args, device=None):
        if len(args) == 1:
            weights, phase = None, args[0]
        elif len(args) == 2:
            weights, phase = args
        else:
            raise TypeError("Net(model, [weights,] phase)")
        self._attach(_GraphNet(NetParameter.from_file(model_file),
                               phase=phase, device=_device(device),
                               data_shape_probe=_data_probe("")))
        self._net.init(0)
        if weights:
            self.copy_from(weights)

    def _attach(self, net: _GraphNet, inputs: dict | None = None) -> None:
        self._net = net
        self._blob_values: dict[str, np.ndarray] = {}
        self._grads: dict[tuple[str, str], torch.Tensor] | None = None
        self._inputs = {} if inputs is None else inputs
        self.env: dict[str, torch.Tensor] = {}

    # -- pycaffe surface -------------------------------------------------
    @property
    def inputs(self) -> list[str]:
        return list(self._net.feed_blobs)

    @property
    def outputs(self) -> list[str]:
        consumed = {b for l in self._net.layers for b in l.lp.bottom}
        return [t for l in self._net.layers for t in l.lp.top
                if t not in consumed]

    @property
    def blobs(self) -> dict[str, Blob]:
        out = {}
        for name in self._net.blob_shapes:
            if name in self._net.feed_blobs:
                out[name] = Blob(
                    get=lambda n=name: self._input_value(n),
                    set_=lambda v, n=name: self._inputs.__setitem__(n, v))
            else:
                out[name] = Blob(get=lambda n=name: self._blob_value(n))
        return out

    def _owner(self, layer, pname) -> tuple[str, str]:
        return self._net.param_aliases.get((layer.name, pname),
                                           (layer.name, pname))

    def _tensor(self, owner: tuple[str, str]) -> torch.Tensor:
        return getattr(self._net.layer_by_name(owner[0]), owner[1])

    @property
    def params(self) -> dict[str, list[Blob]]:
        out = {}
        for layer in self._net.layers:
            if not layer.decls:
                continue
            blobs = []
            for pname in layer.decls:
                owner = self._owner(layer, pname)

                def set_(v, o=owner):
                    cur = self._tensor(o)
                    with torch.no_grad():
                        cur.copy_(torch.as_tensor(
                            np.asarray(v, np.float32)).reshape(cur.shape))

                blobs.append(Blob(lambda o=owner: _host(self._tensor(o)),
                                  set_, lambda o=owner: self._diff(o)))
            out[layer.name] = blobs
        return out

    @property
    def layer_dict(self):
        return {l.name: l for l in self._net.layers}

    def _diff(self, owner) -> np.ndarray:
        if self._grads is None:
            raise RuntimeError("run backward() first")
        return _host(self._grads[owner])

    def _input_value(self, name: str) -> np.ndarray:
        if name not in self._inputs:
            self._inputs[name] = np.zeros(self._net.blob_shapes[name],
                                          np.float32)
        return self._inputs[name]

    def _blob_value(self, name: str) -> np.ndarray:
        if name not in self._blob_values:
            if name not in self.env:
                raise RuntimeError(f"blob {name!r}: run forward() first")
            self._blob_values[name] = _host(self.env[name])
        return self._blob_values[name]

    def _feeds(self, label_int: bool) -> dict[str, torch.Tensor]:
        feeds = {}
        dev = self._net.device
        for name in self._net.feed_blobs:
            val = np.asarray(self._input_value(name))
            if label_int and name == "label":
                val = val.astype(np.int32)
            feeds[name] = torch.from_numpy(np.array(val)).reshape(
                self._net.blob_shapes[name]).to(dev)
        return feeds

    def forward(self, blobs=None, **kwargs) -> dict[str, np.ndarray]:
        """net.forward(data=x), or after setting net.blobs['data'].data:
        an inference forward (TEST mode whatever the phase); returns the
        output blobs (or `blobs`) as numpy, and every blob is readable
        through `blobs`."""
        for k, v in kwargs.items():
            self._inputs[k] = np.asarray(v)
        net = self._net
        was = net.training
        net.train(False)
        try:
            with torch.inference_mode():
                env, _ = net(self._feeds(label_int=True))
        finally:
            net.train(was)
        self.env, self._blob_values = env, {}
        want = blobs or self.outputs
        return {b: self._blob_value(b) for b in want if b in env}

    def backward(self, dropout_masks: dict | None = None) -> None:
        """Fill the params' diffs with the gradients of the net's loss on
        the current inputs, a TRAIN forward (the JAX module's jax.grad).
        Layer state is left as it was; Dropout draws from a generator
        seeded 0 unless `dropout_masks` {layer: bool mask} are given."""
        net = self._net
        owned = [(l, p) for l, p, _ in net.learnable_param_decls()]
        tensors = {o: self._tensor(o) for o in owned}
        state = [(buf, buf.clone()) for *_, buf in net.state_buffers()]
        flags = {o: t.requires_grad for o, t in tensors.items()}
        was = net.training
        gen = torch.Generator(device=net.device).manual_seed(0)
        try:
            net.train(True)
            for t in tensors.values():
                t.requires_grad_(True)
                t.grad = None
            with torch.enable_grad(), \
                    net.layers[0].policy.math(net.device):
                _, loss = net(self._feeds(label_int=False), generator=gen,
                              dropout_masks=dropout_masks)
                if loss.requires_grad:
                    loss.backward()
            self._grads = {o: (t.grad if t.grad is not None
                               else torch.zeros_like(t)).detach().clone()
                           for o, t in tensors.items()}
        finally:
            net.train(was)
            with torch.no_grad():
                for buf, saved in state:
                    buf.copy_(saved)
            for o, t in tensors.items():
                t.grad = None
                t.requires_grad_(flags[o])

    def copy_from(self, weights_file: str) -> None:
        """Load a .caffemodel by layer name (CopyTrainedLayersFrom)."""
        self._net.import_weights(_io.load_weights(weights_file))

    def save(self, path: str) -> None:
        """Write a .caffemodel (Net::ToProto)."""
        _io.refuse_hdf5(path)
        types = {l.name: l.lp.type for l in self._net.layers}
        _io.save_caffemodel(path, self._net.export_weights(), self._net.name,
                            types)

    def reshape(self) -> None:  # shapes are fixed at build
        pass


class SGDSolver:
    """caffe.SGDSolver(solver_file): the port's Solver, fed from the
    net's data layer (a Feeder, as `cli train`) or through
    `solver.net.blobs[...].data` assignment. `device=` overrides the
    mode."""

    def __init__(self, solver_file: str, device=None):
        from .data.feeder import DeviceFeed
        from .solver import Solver
        from .tools.cli import build_feeder
        sp = SolverParameter.from_file(solver_file)
        model_dir = ""
        if sp.net and not os.path.exists(sp.net):
            model_dir = os.path.dirname(os.path.abspath(solver_file))
        self._solver = Solver(sp, model_dir=model_dir,
                              device=_device(device))
        feeder = build_feeder(self._solver.net, "TRAIN", sp)
        self._feed = None if feeder is None \
            else DeviceFeed(feeder, self._solver.device)
        self._inputs: dict[str, np.ndarray] = {}

    @property
    def solver(self):
        """The port's Solver underneath."""
        return self._solver

    @property
    def net(self) -> Net:
        shim = Net.__new__(Net)
        shim._attach(self._solver.net, self._inputs)
        return shim

    @property
    def iter(self) -> int:
        return self._solver.iter

    def _feed_fn(self):
        if self._feed is not None:
            return self._feed
        net = self._solver.net

        def fn(it):
            feeds = {}
            for name in net.feed_blobs:
                val = self._inputs.get(name)
                if val is None:
                    raise RuntimeError(
                        f"no data for input blob {name!r}: assign "
                        "solver.net.blobs[...].data first")
                feeds[name] = torch.from_numpy(np.array(val)).reshape(
                    net.blob_shapes[name]).to(net.device)
            return feeds
        return fn

    def step(self, n: int) -> float:
        return self._solver.step(n, self._feed_fn())

    def solve(self) -> float:
        return self._solver.solve(self._feed_fn())

    def snapshot(self) -> str:
        return self._solver.snapshot()

    def restore(self, path: str) -> None:
        self._solver.restore(path)

    def close(self) -> None:
        """Stop the feed's staging thread and join a snapshot write."""
        if self._feed is not None:
            self._feed.close()
        self._solver.close()


# one class a registered solver, as the reference exposes them; the
# prototxt's `type` picks the update rule
class NesterovSolver(SGDSolver):
    pass


class AdaGradSolver(SGDSolver):
    pass


class RMSPropSolver(SGDSolver):
    pass


class AdaDeltaSolver(SGDSolver):
    pass


class AdamSolver(SGDSolver):
    pass


def get_solver(solver_file: str, device=None) -> SGDSolver:
    return SGDSolver(solver_file, device=device)


def __getattr__(name: str):
    # Classifier and Detector subclass Net: classifier.py imports this
    # module, so they are looked up at first use
    if name in ("Classifier", "Detector"):
        from . import classifier
        return getattr(classifier, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
