"""coord_map — receptive-field / coordinate mapping math (pycaffe parity).

Reference: python/caffe/coord_map.py: composes per-layer (axis scale,
offset) affine maps so a pixel in one blob can be located in another
(used to align crops in FCN-style nets).

For blob B reached from blob A, the map (scale, offset) satisfies
  coord_A = scale * coord_B + offset.
Conv/pool layers contribute scale=stride, offset=(kernel-1)/2 - pad;
deconv inverts; elementwise layers are identity. The port's copy of the
JAX package's caffe_mpi_tpu/coord_map.py.
"""

from __future__ import annotations

from .proto.config import NetParameter
from .proto.upgrade import normalize_net

_IDENTITY_TYPES = {
    "ReLU", "PReLU", "ELU", "Sigmoid", "TanH", "AbsVal", "BNLL", "Power",
    "Exp", "Log", "Threshold", "Dropout", "BatchNorm", "Scale", "Bias",
    "LRN", "MVN", "Eltwise", "Concat", "Split", "Softmax", "Accuracy",
}


def _layer_map(lp) -> tuple[float, float] | None:
    """(scale, offset) for spatial axis 0, or None if untracked."""
    if lp.type in ("Convolution", "Im2col"):
        p = lp.convolution_param
        k = (p.kernel_size[0] if p.kernel_size else p.kernel_h) or 1
        s = (p.stride[0] if p.stride else p.stride_h) or 1
        pad = (p.pad[0] if p.pad else p.pad_h) or 0
        d = p.dilation[0] if p.dilation else 1
        k_ext = d * (k - 1) + 1
        return float(s), (k_ext - 1) / 2.0 - pad
    if lp.type == "Deconvolution":
        p = lp.convolution_param
        k = (p.kernel_size[0] if p.kernel_size else p.kernel_h) or 1
        s = (p.stride[0] if p.stride else p.stride_h) or 1
        pad = (p.pad[0] if p.pad else p.pad_h) or 0
        return 1.0 / s, -((k - 1) / 2.0 - pad) / s
    if lp.type == "Pooling":
        p = lp.pooling_param
        k = p.kernel_h or p.kernel_size or 1
        s = p.stride_h or p.stride or 1
        pad = p.pad_h or p.pad or 0
        return float(s), (k - 1) / 2.0 - pad
    if lp.type in _IDENTITY_TYPES:
        return 1.0, 0.0
    return None


def coord_map_from_to(net: NetParameter, from_blob: str, to_blob: str
                      ) -> tuple[float, float]:
    """Compose maps along the unique path of spatial layers between blobs.
    Returns (scale, offset): coord_to = scale * coord_from + offset."""
    net = normalize_net(net)
    # walk producers backward from each blob to the inputs, composing
    maps: dict[str, tuple[float, float]] = {}
    for lp in net.layer:
        if not lp.top:
            continue
        if not lp.bottom:
            for t in lp.top:
                maps[t] = (1.0, 0.0)
            continue
        base = maps.get(lp.bottom[0])
        lm = _layer_map(lp)
        for t in lp.top:
            if base is None or lm is None:
                maps.setdefault(t, (1.0, 0.0) if base is None else base)
                continue
            s0, o0 = base
            s1, o1 = lm
            # coord_input = s0 * (s1 * coord_top + o1) + o0
            maps[t] = (s0 * s1, s0 * o1 + o0)
    if from_blob not in maps or to_blob not in maps:
        raise KeyError("blob not found in net")
    sf, of = maps[from_blob]
    st, ot = maps[to_blob]
    # coord_input = sf*c_from + of = st*c_to + ot
    #   => c_to = (sf/st) c_from + (of - ot)/st
    return sf / st, (of - ot) / st
