"""Input-layer shapes and synthetic feeds for the bench tools and the
card's checks: one definition of "rewrite the Input batch dim and build
matching feeds".

The port's copy of the JAX package's `caffe_mpi_tpu/utils/model_shapes.py`.
`input_shapes` and `label_tops` read the NetParameter alone (no torch);
`synthetic_feeds` draws torch tensors from an explicit `torch.Generator`
and puts them on an explicit device.
"""

from __future__ import annotations

# loss/metric layers whose SECOND bottom is an integer class-id vector
# (reference softmax_loss_layer.cpp etc.: label blob of shape [N])
_CLASSIFICATION_CONSUMERS = frozenset((
    "SoftmaxWithLoss", "Accuracy", "MultinomialLogisticLoss",
    "InfogainLoss", "HingeLoss",
))


def input_shapes(npar, batch: int | None = None,
                 train_only: bool = True) -> dict[str, list[int]]:
    """{top: dims} for the net's Input layers. batch, when given, REWRITES
    the leading dim in-place (callers re-use the mutated NetParameter as
    the net definition). train_only skips TEST-phase-gated Input layers so
    the batch override and the feeds track the TRAIN net."""
    shapes: dict[str, list[int]] = {}
    for l in npar.layer:
        if l.type != "Input":
            continue
        if train_only and any(str(getattr(r, "phase", "")) == "TEST"
                              for r in (l.include or [])):
            continue
        decls = list(l.input_param.shape)
        if len(decls) == 1 and len(l.top) > 1:
            # one shape block broadcasts to every top, matching
            # InputLayer.setup (layers/data_layers.py)
            decls = decls * len(l.top)
        for top, shp in zip(l.top, decls):
            if batch:
                shp.dim[0] = batch
            shapes[top] = list(shp.dim)
    return shapes


def label_tops(npar, shapes: dict[str, list[int]]) -> set[str]:
    """Tops that must be fed INTEGER class ids, detected structurally: a
    1-D blob consumed as the label bottom (bottom[1]) of a classification
    loss/metric layer. Name-independent — a net whose label top is called
    'target' or 'y' gets integer feeds too."""
    out = set()
    for l in npar.layer:
        if l.type in _CLASSIFICATION_CONSUMERS and len(l.bottom) > 1:
            b = l.bottom[1]
            if b in shapes and len(shapes[b]) == 1:
                out.add(b)
    return out


def synthetic_feeds(shapes: dict[str, list[int]], *, generator, device,
                    n_classes: int = 1000, npar=None) -> dict:
    """Random feeds matching input_shapes() output, drawn from `generator`
    (a torch.Generator, on the device it was made for) and placed on
    `device`. Integer class-id feeds are chosen by CONSUMER when `npar` is
    given (label_tops above); without a net to inspect, any 1-D top is
    treated as a label vector — both structural, neither keyed on a blob
    name."""
    import torch

    ints = (label_tops(npar, shapes) if npar is not None
            else {t for t, dims in shapes.items() if len(dims) == 1})
    feeds = {}
    for top, dims in shapes.items():
        if top in ints:
            t = torch.randint(0, n_classes, (dims[0],), generator=generator,
                              device=generator.device)
        else:
            t = torch.randn(*dims, generator=generator,
                            device=generator.device)
        feeds[top] = t.to(device)
    return feeds
