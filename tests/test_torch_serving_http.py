"""Port HTTP front on the CPU: caffe_mpi_tpu_torch.serving.http_front
against the JAX package's front (caffe_mpi_tpu/serving/http_front.py),
both on port 0 over the same narrow LRN deploy net and .caffemodel.

The same requests get the same status codes and the same `kind` in their
error bodies (400 bad_request, 403, 404, 411, 429 shed, 503 closed and
unhealthy, 504 deadline), and the success bodies the same top-5 labels
with scores within 1e-4 (the tolerance of test_torch_serving.py). /readyz
and /stats hold the build invariant; `cli serve -smoke 8` answers over
HTTP on the CPU.
"""

import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from caffe_mpi_tpu.serving import ServingEngine as JaxEngine
from caffe_mpi_tpu.serving.http_front import make_server as jax_server
from caffe_mpi_tpu.utils import resilience as jres
from caffe_mpi_tpu_torch.serving import ServingEngine
from caffe_mpi_tpu_torch.serving.http_front import make_server
from caffe_mpi_tpu_torch.tools import cli
from caffe_mpi_tpu_torch.utils import resilience as pres
from test_torch_native import jax_native  # noqa: F401 (a fixture)
from test_torch_serving_ingest import BUCKETS, PRE, jpeg, png, write_deploy

pytestmark = pytest.mark.usefixtures("jax_native")

LABELS = [f"class_{i}" for i in range(7)]


@pytest.fixture(scope="module")
def deploy(tmp_path_factory):
    return write_deploy(tmp_path_factory.mktemp("serve_http"))


class Front:
    """An engine behind its HTTP front on an ephemeral port."""

    def __init__(self, kind, deploy, image_root=None, **kw):
        model, weights = deploy
        if kind == "port":
            self.eng = ServingEngine(device="cpu", buckets=BUCKETS, **kw)
            mk = make_server
        else:
            self.eng = JaxEngine(buckets=BUCKETS, **kw)
            mk = jax_server
        self.eng.load_model("m", model, weights, **PRE)
        self.srv = mk(self.eng, "m", labels=LABELS, image_root=image_root,
                      port=0)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def call(self, path, data=None, headers=None):
        if (headers or {}).get("Transfer-Encoding") == "chunked":
            return self._headers_alone(path, headers)
        req = urllib.request.Request(self.url + path, data=data,
                                     headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                body = r.read()
                code = r.status
        except urllib.error.HTTPError as e:
            body, code = e.read(), e.code
        try:
            return code, json.loads(body)
        except ValueError:
            return code, body

    def _headers_alone(self, path, headers):
        """A POST that sends its headers alone over a raw socket and
        reads the answer before any body: both fronts answer a chunked
        upload 411 without reading it and close, so a body sent first
        races the close (the client then sees a broken pipe instead of
        the 411)."""
        import http.client
        import socket
        port = self.srv.server_address[1]
        head = (f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                + "".join(f"{k}: {v}\r\n" for k, v in headers.items())
                + "\r\n")
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=60) as sock:
            sock.sendall(head.encode())
            resp = http.client.HTTPResponse(sock)
            resp.begin()
            code, body = resp.status, resp.read()
        try:
            return code, json.loads(body)
        except ValueError:
            return code, body

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.eng.close()


@pytest.fixture
def faults():
    def configure(spec):
        pres.FAULTS.configure(spec)
        jres.FAULTS.configure(spec)
    yield configure
    configure("")


def multipart(data, field="image"):
    boundary = "caffeboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="note"\r\n\r\nhello\r\n--{boundary}\r\n'
            f'Content-Disposition: form-data; name="{field}"; '
            f'filename="x.png"\r\nContent-Type: image/png\r\n\r\n'
            ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type":
                  f"multipart/form-data; boundary={boundary}"}


def requests(root):
    """(method path, body, headers) for every case both fronts answer."""
    with open(os.path.join(root, "im.png"), "wb") as f:
        f.write(png(40, (30, 20)))
    raw = {"Content-Type": "application/octet-stream"}
    return [
        ("/classify", png(41, (16, 16)), raw),
        ("/classify", png(42, (40, 33)), raw),
        ("/classify", jpeg(43, (24, 24)), raw),
        ("/classify", *multipart(png(44, (18, 18)))),
        ("/classify", *multipart(png(45), field="file")),
        ("/classify", *multipart(b"not an image", field="other")),
        ("/classify", b"junk bytes", raw),
        ("/classify", png(46)[:50], raw),
        ("/classify_path?path=im.png", None, None),
        ("/classify_path?path=../etc/passwd", None, None),
        ("/classify_path?path=missing.png", None, None),
        ("/nope", None, None),
        ("/nope", b"x", raw),
        ("/classify", b"x", {"Transfer-Encoding": "chunked"}),
    ]


def test_the_same_requests_get_the_same_answers_as_the_jax_front(
        deploy, tmp_path):
    root = str(tmp_path)
    cases = requests(root)
    answers = {}
    for kind in ("port", "jax"):
        front = Front(kind, deploy, image_root=root, window_ms=5)
        try:
            answers[kind] = [front.call(p, d, h) for p, d, h in cases]
        finally:
            front.close()
    codes = []
    for (path, _, _), (pc, pb), (jc, jb) in zip(cases, answers["port"],
                                                answers["jax"]):
        assert pc == jc, (path, pb, jb)
        codes.append(pc)
        if pc == 200:
            assert [p["label"] for p in pb["predictions"]] == \
                [p["label"] for p in jb["predictions"]]
            np.testing.assert_allclose(
                [p["score"] for p in pb["predictions"]],
                [p["score"] for p in jb["predictions"]], rtol=0, atol=1e-4)
            assert len(pb["predictions"]) == 5
            assert all(p["label"] in LABELS for p in pb["predictions"])
        else:
            assert pb["kind"] == jb["kind"], (path, pb, jb)
    assert codes == [200, 200, 200, 200, 200, 400, 400, 400, 200, 403,
                     404, 404, 404, 411]


def test_no_image_root_forbids_classify_path(deploy):
    front = Front("port", deploy)
    try:
        code, body = front.call("/classify_path?path=x.png")
        assert (code, body["kind"]) == (403, "forbidden")
        code, body = front.call("/")
        assert code == 200 and b"form" in body
    finally:
        front.close()


def test_readyz_and_stats_hold_the_build_invariant(deploy):
    front = Front("port", deploy, window_ms=5)
    try:
        code, ready = front.call("/readyz")
        assert code == 200 and ready["ready"] is True
        assert ready["compile_count"] == ready["warmed_buckets"] + \
            ready["recaptures"] == 2
        for i in range(3):
            assert front.call("/classify", png(50 + i))[0] == 200
        code, st = front.call("/stats")
        assert code == 200 and st["requests"] == 3
        assert st["compile_count"] == st["warmed_buckets"] == 2
        assert st["ingest"]["deferred_rows"] == st["ingest"]["fused_rows"] \
            == 3
        code, h = front.call("/healthz")
        assert code == 200 and h["healthy"] is True
    finally:
        front.close()
    front = Front("port", deploy)
    front.eng.close()
    try:
        code, ready = front.call("/readyz")
        assert code == 503 and ready["closed"] is True
        code, body = front.call("/classify", png(1))
        assert (code, body["kind"]) == (503, "closed")
    finally:
        front.srv.shutdown()
        front.srv.server_close()


def _typed_run(kind, deploy, faults):
    """429, 504 and 503 (unhealthy, then recovered) over HTTP."""
    out = []
    front = Front(kind, deploy, window_ms=600_000, queue_limit=1)
    try:
        hold = threading.Thread(target=front.call,
                                args=("/classify", png(60)))
        hold.start()  # parks in the long window, filling the queue
        deadline = 0
        while not front.eng._batcher._pending and deadline < 500:
            threading.Event().wait(0.01)
            deadline += 1
        code, body = front.call("/classify", png(61))
        out.append((code, body["kind"]))
    finally:
        front.eng.close()
        hold.join(timeout=30)
        front.srv.shutdown()
        front.srv.server_close()
    faults("serve_dispatch_stall:1:0:0.8")
    front = Front(kind, deploy, window_ms=0, deadline_ms=150)
    try:
        hold = threading.Thread(target=front.call,
                                args=("/classify", png(62)))
        hold.start()
        deadline = 0
        while front.eng._batcher.dispatch_count == 0 and deadline < 500 \
                and not front.eng._batcher._inflight:
            threading.Event().wait(0.01)
            deadline += 1
        code, body = front.call("/classify", png(63))
        out.append((code, body["kind"]))
        hold.join(timeout=30)
    finally:
        front.close()
    faults("serve_dispatch_stall:1:0:1.2")
    front = Front(kind, deploy, window_ms=0, stall_s=0.3)
    try:
        code, body = front.call("/classify", png(64))
        out.append((code, body["kind"]))
        code, h = front.call("/healthz")
        out.append((code, h["breaker"]["state"]))
        code, body = front.call("/classify", png(65))
        out.append((code, body["kind"]))
        code, ready = front.call("/readyz")
        out.append((code, ready["healthy"]))
        front.eng.drain(timeout=10)
        assert front.eng.probe_recovery(timeout=10)
        code, h = front.call("/healthz")
        out.append((code, h["breaker"]["state"]))
        out.append(front.call("/classify", png(66))[0])
    finally:
        front.close()
    return out


def test_typed_failures_over_http_match_the_jax_front(deploy, faults):
    port = _typed_run("port", deploy, faults)
    jax = _typed_run("jax", deploy, faults)
    assert port == jax
    assert port == [(429, "shed"), (504, "deadline"), (504, "deadline"),
                    (503, "open"), (503, "unhealthy"), (503, False),
                    (200, "closed"), 200]


def test_cli_serve_smoke_over_http_on_cpu(deploy, capsys):
    model, weights = deploy
    rc = cli.main(["serve", "-model", model, "-weights", weights,
                   "-smoke", "8", "-serve_buckets", BUCKETS,
                   "-device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    smoke = json.loads(out.strip().splitlines()[-1])["serve_smoke"]
    assert smoke["requests"] == 8 and smoke["post_warmup_compiles"] == 0
    assert smoke["compile_count"] == smoke["warmed_buckets"] == 2
    assert smoke["ingest"]["requests"] == 8
    assert smoke["ingest"]["deferred_rows"] == 8
    assert smoke["native_ingest_engaged"] is True


def test_cli_serve_smoke_in_bf16_on_cpu(deploy, capsys):
    model, weights = deploy
    rc = cli.main(["serve", "-model", model, "-weights", weights,
                   "-smoke", "6", "-serve_dtype", "bf16",
                   "-require_native_ingest", "-device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    smoke = json.loads(out.strip().splitlines()[-1])["serve_smoke"]
    assert smoke["serve_dtype"] == "bf16" and smoke["requests"] == 6


def test_cli_serve_without_a_card_raises(deploy, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["serve", "-model", deploy[0], "-smoke", "2"])


def test_multipart_extraction_matches_the_jax_front():
    from caffe_mpi_tpu.serving.http_front import \
        extract_image_bytes as jextract
    from caffe_mpi_tpu_torch.serving.http_front import extract_image_bytes
    data = png(70)
    body, headers = multipart(data)
    ct = headers["Content-Type"]
    assert extract_image_bytes(body, ct) == jextract(body, ct) == data
    assert extract_image_bytes(data, "image/png") == data
    body, headers = multipart(b"", field="x")
    with pytest.raises(ValueError):
        extract_image_bytes(body, headers["Content-Type"])
    buf = io.BytesIO(data)
    assert extract_image_bytes(buf.getvalue(), "") == data
