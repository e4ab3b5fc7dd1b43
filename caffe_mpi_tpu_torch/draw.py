"""Net visualization — Graphviz DOT emitter (pycaffe draw parity).

Reference: python/caffe/draw.py renders NetParameter to an image through
pydot; this emits the DOT source directly (no pydot/graphviz python deps),
which `dot -Tpng` renders wherever graphviz is installed. The port's copy
of the JAX package's `caffe_mpi_tpu/draw.py`.
"""

from __future__ import annotations

from .proto.config import LayerParameter, NetParameter
from .proto.upgrade import normalize_net

_LAYER_STYLE = {
    "Convolution": ("box", "#cfe2ff"),
    "Deconvolution": ("box", "#cfe2ff"),
    "InnerProduct": ("box", "#d1e7dd"),
    "Pooling": ("box", "#fff3cd"),
    "LRN": ("box", "#fde2e4"),
    "BatchNorm": ("box", "#e2d9f3"),
    "ReLU": ("ellipse", "#f8d7da"),
    "SoftmaxWithLoss": ("hexagon", "#f5c2c7"),
    "Accuracy": ("hexagon", "#badbcc"),
}


def _layer_label(lp: LayerParameter) -> str:
    extra = ""
    if lp.type in ("Convolution", "Deconvolution") and lp.convolution_param:
        p = lp.convolution_param
        k = p.kernel_size[0] if p.kernel_size else p.kernel_h
        s = p.stride[0] if p.stride else (p.stride_h or 1)
        extra = f"\\n{p.num_output}x{k}x{k} s{s}"
    elif lp.type == "InnerProduct" and lp.inner_product_param:
        extra = f"\\n{lp.inner_product_param.num_output}"
    elif lp.type == "Pooling" and lp.pooling_param:
        p = lp.pooling_param
        extra = f"\\n{p.pool} {p.kernel_size}x{p.kernel_size} s{p.stride}"
    return f"{lp.name}\\n({lp.type}){extra}"


def net_to_dot(net: NetParameter, rankdir: str = "TB",
               phase: str | None = None) -> str:
    """NetParameter -> DOT source (reference draw.py get_pydot_graph)."""
    net = normalize_net(net)
    lines = [
        "digraph caffe_net {",
        f'  rankdir={rankdir};',
        '  node [fontsize=10, margin="0.1,0.05"];',
    ]
    if phase is not None:
        from .proto.config import NetState
        from .proto.upgrade import filter_net
        net = filter_net(net, NetState(phase=phase))
    blob_producer: dict[str, str] = {}
    for i, lp in enumerate(net.layer):
        node = f"layer_{i}"
        shape, color = _LAYER_STYLE.get(lp.type, ("box", "#eeeeee"))
        lines.append(
            f'  {node} [label="{_layer_label(lp)}", shape={shape}, '
            f'style=filled, fillcolor="{color}"];')
        for b in lp.bottom:
            src = blob_producer.get(b)
            if src is not None:
                lines.append(f'  {src} -> {node} [label="{b}", fontsize=8];')
        for t in lp.top:
            blob_producer[t] = node
    lines.append("}")
    return "\n".join(lines)


def draw_net_to_file(net: NetParameter, filename: str, rankdir: str = "TB",
                     phase: str | None = None) -> None:
    dot = net_to_dot(net, rankdir, phase)
    if filename.endswith(".dot") or filename.endswith(".gv"):
        with open(filename, "w") as f:
            f.write(dot)
        return
    # try rendering through the graphviz binary if present
    import shutil
    import subprocess
    ext = filename.rsplit(".", 1)[-1]
    dot_bin = shutil.which("dot")
    if dot_bin is None:
        raise RuntimeError(
            "graphviz 'dot' binary not found; write a .dot file instead")
    subprocess.run([dot_bin, f"-T{ext}", "-o", filename],
                   input=dot.encode(), check=True)
