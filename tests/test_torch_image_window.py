"""Port parity: the ImageData and WindowData input sources against the JAX
package's, on the CPU.

ImageData (a list of image files, decoded and resized by
data/decode.py decode_file): PNG batches are bitwise the JAX Feeder's;
JPEG batches are compared path against path, the port's native decode
with the JAX library's, PIL with PIL (as tests/test_torch_native_decode.py
does), and every batch is bitwise. WindowData (R-CNN's window file,
data/window.py): the parse is identical, and TRAIN and TEST batches are
bitwise the JAX WindowFeeder's at its default seed (1701), with and
without context_pad and mirror. Then 5 SGD iterations of a tiny net over
each source, held against the JAX Solver on the JAX feeders (losses
rtol 1e-5, params rtol 1e-5 / atol 1e-6, as tests/test_torch_train.py).
Images are tiny (3x20x24 to 3x40x52).
"""

import os

import numpy as np
import pytest

from caffe_mpi_tpu.data import decode as jdecode
from caffe_mpi_tpu.data import feeder as jfeeder
from caffe_mpi_tpu.data import window as jwindow
from caffe_mpi_tpu.proto import LayerParameter as JaxLP
from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu.tools import cli as jax_cli
from caffe_mpi_tpu_torch.data import decode as pdecode
from caffe_mpi_tpu_torch.data import feeder as pfeeder
from caffe_mpi_tpu_torch.data import window as pwindow
from caffe_mpi_tpu_torch.proto import LayerParameter, SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.tools import cli
from caffe_mpi_tpu_torch.weights import load_jax_params
from test_torch_data import _records, close_jax
from test_torch_native import jax_native  # noqa: F401 (a fixture)
from test_torch_train import _assert_params_equal, _host

# the JAX decode and host transform go native only with its library
pytestmark = pytest.mark.usefixtures("jax_native")

LOSSES = dict(rtol=1e-5)
PARAMS = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    monkeypatch.delenv("CAFFE_NATIVE_DECODE", raising=False)
    pdecode.STATS.reset()
    jdecode.STATS.reset()


def _save(path, chw):
    from PIL import Image
    Image.fromarray(np.ascontiguousarray(chw[::-1].transpose(1, 2, 0))).save(
        path)


def _image_list(tmp_path, n, codec, hw=(20, 24)):
    """n images (BGR CHW records written as RGB files) in tmp_path/imgs
    and a list file of `name label` lines; returns (list, root)."""
    root = tmp_path / "imgs"
    os.makedirs(root, exist_ok=True)
    imgs, labels = _records(n, (3, *hw), seed=11)
    lines = []
    for i, (img, label) in enumerate(zip(imgs, labels)):
        name = f"im{i}.{codec}"
        _save(root / name, img)
        lines.append(f"{name} {label}")
    path = tmp_path / "list.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path), str(root) + "/"


def _image_layer(source, root, transform="crop_size: 12 mirror: true "
                 "mean_value: 104 mean_value: 117 mean_value: 123"):
    return (f'name: "d" type: "ImageData" top: "data" top: "label" '
            f'transform_param {{ {transform} }} image_data_param {{ '
            f'source: "{source}" root_folder: "{root}" batch_size: 4 '
            f'new_height: 16 new_width: 18 shuffle: true }}')


@pytest.mark.parametrize("transform", ["classic", "native"])
@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("codec,decoder", [
    ("png", "native"), ("png", "pil"), ("jpg", "native"), ("jpg", "pil")])
def test_image_data_batches_are_the_jax_feeders(tmp_path, monkeypatch,
                                                codec, decoder, phase,
                                                transform):
    """Iterations 0..2 of batch 4 over 10 images resized 20x24 -> 16x18,
    cropped to 12, mirrored in TRAIN, shuffled: bitwise, with the same
    decode counts. The host transform is the classic numpy one on both
    sides (`_native = False`) or the native one on both."""
    if decoder == "pil":
        monkeypatch.setenv("CAFFE_NATIVE_DECODE", "0")
    source, root = _image_list(tmp_path, 10, codec)
    text = _image_layer(source, root)
    port = pfeeder.feeder_from_layer(LayerParameter.from_text(text), phase)
    jax = jfeeder.feeder_from_layer(JaxLP.from_text(text), phase)
    if transform == "classic":
        port._native = jax._native = False
    try:
        for it in range(3):
            got, want = port._build_batch_inner(it), \
                jax._build_batch_inner(it)
            assert list(got) == list(want)
            for key in want:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{key} it {it}")
    finally:
        port.close()
        close_jax(jax)
    snap = pdecode.STATS.snapshot()
    assert snap == jdecode.STATS.snapshot()
    if decoder == "pil":
        assert snap["pil_records"] == 12 and snap["native_records"] == 0
    else:
        assert snap["native_records"] == 12 and snap["pil_records"] == 0


def test_decode_file_resizes_as_jax(monkeypatch):
    """decode_file alone: native and PIL, color and gray, with and without
    the resize; PNG bitwise PIL's at the source size."""
    import io

    from PIL import Image
    img, _ = _records(1, (3, 13, 17), seed=4)
    b = io.BytesIO()
    Image.fromarray(img[0][::-1].transpose(1, 2, 0)).save(b, "PNG")
    data = b.getvalue()
    for env in ("", "0"):
        monkeypatch.setenv("CAFFE_NATIVE_DECODE", env)
        for kw in (dict(), dict(new_h=9, new_w=21), dict(is_color=False),
                   dict(is_color=False, new_h=20, new_w=8)):
            got = pdecode.decode_file(data, **kw)
            want = jdecode.decode_file(data, **kw)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(pdecode.decode_file(data), img[0])


# -- WindowData -----------------------------------------------------------------

def _window_file(tmp_path, n_images=4, windows=7, seed=2):
    """PNG images of 3x40x52 and a window file: per image `windows`
    windows, overlaps spread over [0, 1] so both fg and bg exist, class
    indices under 5, some windows past the image edge."""
    r = np.random.RandomState(seed)
    root = tmp_path / "win"
    os.makedirs(root, exist_ok=True)
    lines = []
    for i in range(n_images):
        img = r.randint(0, 256, (3, 40, 52)).astype(np.uint8)
        _save(root / f"w{i}.png", img)
        lines += [f"# {i}", f"w{i}.png", "3 40 52", str(windows)]
        for _ in range(windows):
            x1, y1 = r.randint(-4, 30), r.randint(-4, 20)
            x2, y2 = x1 + r.randint(6, 30), y1 + r.randint(6, 26)
            lines.append(f"{r.randint(1, 5)} {r.rand():.3f} {x1} {y1} "
                         f"{x2} {y2}")
    path = tmp_path / "windows.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path), str(root) + "/"


def _window_layer(source, root, context_pad=0, mirror="", batch=6):
    transform = (f"transform_param {{ {mirror} mean_value: 104 "
                 f"mean_value: 117 mean_value: 123 }}"
                 if mirror != "param" else "")
    mirror_param = "mirror: true" if mirror == "param" else ""
    return (f'name: "w" type: "WindowData" top: "data" top: "label" '
            f'{transform} window_data_param {{ source: "{source}" '
            f'root_folder: "{root}" batch_size: {batch} crop_size: 11 '
            f'fg_threshold: 0.5 bg_threshold: 0.5 fg_fraction: 0.25 '
            f'context_pad: {context_pad} {mirror_param} }}')


def test_window_file_parses_as_jax(tmp_path):
    source, root = _window_file(tmp_path)
    port = pwindow.WindowFile(source, root, 0.5, 0.4)
    jax = jwindow.WindowFile(source, root, 0.5, 0.4)
    assert port.images == jax.images
    assert port.fg == jax.fg and port.bg == jax.bg
    assert port._records == jax._records and len(port._records) == 28


@pytest.mark.parametrize("mirror", ["", "mirror: true", "param"])
@pytest.mark.parametrize("context_pad", [0, 3])
@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_window_batches_are_bitwise_the_jax_window_feeders(
        tmp_path, phase, context_pad, mirror):
    """Three batches of 6 windows (2 fg, 4 bg) at seed 1701 and at rank 1
    of 2: the draws, the context-pad warp, the mean and the mirror."""
    source, root = _window_file(tmp_path)
    text = _window_layer(source, root, context_pad, mirror)
    for rank in (0, 1):
        port = pwindow.WindowFeeder(LayerParameter.from_text(text), phase,
                                    rank=rank, world=2)
        jax = jwindow.WindowFeeder(JaxLP.from_text(text), phase, rank=rank,
                                   world=2)
        assert port.num_fg == jax.num_fg == 2
        for it in range(3):
            got, want = port(it), jax(it)
            assert list(got) == list(want)
            for key in want:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{key} it {it}")
        port.close()


# -- 5 SGD iterations over each source --------------------------------------------

def _solver_text(layer):
    net = (f'name: "tiny" layer {{ {layer} }} '
           'layer { name: "ip" type: "InnerProduct" bottom: "data" '
           'top: "ip" inner_product_param { num_output: 10 weight_filler { '
           'type: "gaussian" std: 0.01 } } } '
           'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" '
           'bottom: "label" top: "loss" }')
    return (f"net_param {{ {net} }} base_lr: 0.01 momentum: 0.9 "
            'weight_decay: 0.0005 lr_policy: "fixed" max_iter: 5 '
            "random_seed: 3")


@pytest.mark.parametrize("source", ["image_data", "window_data"])
def test_five_sgd_iterations_match_the_jax_solver(tmp_path, source):
    if source == "image_data":
        lst, root = _image_list(tmp_path, 10, "png")
        layer = _image_layer(lst, root)
    else:
        win, root = _window_file(tmp_path)
        layer = _window_layer(win, root, 3, "mirror: true", batch=4)
    text = _solver_text(layer)
    jsolver = JaxSolver(JaxSP.from_text(text))
    port = Solver(SolverParameter.from_text(text), device="cpu")
    load_jax_params(port.net, _host(jsolver.params))
    jfeed = jax_cli._build_feeders(jsolver.net, "TRAIN")
    feed, _, opened, feeder = cli._feed_fns(port, False)
    if source == "image_data":
        jfeed._native = feeder._native = False  # one transform path
    jlosses = [jsolver.step(1, jfeed) for _ in range(5)]
    port.step(5, feed)
    for f in opened:
        f.close()
    if source == "image_data":
        close_jax(jfeed)
    np.testing.assert_allclose(port.losses, jlosses, **LOSSES)
    _assert_params_equal(_host(jsolver.params), port.net, **PARAMS)
