"""Stdlib HTTP front over the serving engine.

Port of the JAX package's caffe_mpi_tpu/serving/http_front.py. Reference:
examples/web_demo/app.py (Flask+Tornado upload form + classify-by-URL
around a pycaffe Classifier), rebuilt on stdlib `http.server`
(ThreadingHTTPServer) with the same routes:

  GET  /                    upload form
  POST /classify            multipart/form-data file field "image", or a
                            raw image body (curl --data-binary)
  GET  /classify_path?path= classify a file under image_root (the
                            reference's /classify_url without the web)
  GET  /stats               serving telemetry JSON (engine.stats())
  GET  /healthz             liveness: breaker state + last-dispatch age
                            (200 healthy / 503 breaker open)
  GET  /readyz              readiness: zoo loaded, every bucket built
                            (compile_count == warmed_buckets +
                            recaptures), the engine accepting (200 / 503)

Failures are typed (serving/errors.py): a shed request is 429, a missed
`serve_deadline_ms` 504, a closed or unhealthy engine 503, each with a
JSON body `{"error": ..., "kind": "shed"|"deadline"|"closed"|"unhealthy"}`;
bytes no decoder takes are 400 `kind=bad_request`; only an unexpected
failure is 500.

The handler does not run the model: it decodes the upload through the
engine's ingest plane (`engine.decode_request`), submits the decoded image
(`engine.submit_raw`, preprocessing fused at the batcher's window close)
and waits on the future, so concurrent requests batch into the padded
buckets. Responses are JSON top-5 {label, score}.

The JAX package's admin route `POST /swap` belongs to its serving fleet
(ROADMAP.md §1 item 5) and is not ported: `admin=True` is refused.
"""

from __future__ import annotations

import email
import email.policy
import json
import os
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .errors import ServingError

_FORM = (b"<html><body><h3>caffe_mpi_tpu_torch classification demo</h3>"
         b"<form method=post action=/classify enctype=multipart/form-data>"
         b"<input type=file name=image> "
         b"<input type=submit value=Classify></form></body></html>")


def extract_image_bytes(body: bytes, content_type: str) -> bytes:
    """Pull the uploaded file out of a multipart/form-data body (stdlib
    email parser — the cgi module is deprecated); raw bodies pass
    through."""
    if content_type and content_type.startswith("multipart/"):
        msg = email.message_from_bytes(
            b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body,
            policy=email.policy.HTTP)
        fallback = None
        for part in msg.iter_parts():
            payload = part.get_payload(decode=True)
            if not payload:
                continue
            name = part.get_param("name", header="content-disposition")
            if name == "image":
                return payload
            # a form may carry extra fields; prefer any part that looks
            # like a file upload over bare text fields
            if fallback is None and part.get_filename():
                fallback = payload
        if fallback is not None:
            return fallback
        raise ValueError('no "image" file part in multipart body')
    return body


class _Handler(BaseHTTPRequestHandler):
    # injected by make_server:
    engine = None
    model_name = None
    labels = None
    image_root = None

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _classify_bytes(self, img_bytes: bytes) -> None:
        """Decode + submit one encoded upload: native request decode
        (crc32c-cached) in this handler thread, preprocessing fused at
        the batcher's window close. Undecodable bytes are the client's
        fault — typed 400, never a 500 or a native abort."""
        try:
            # shed BEFORE paying decode: an open breaker fails fast
            self.engine._shed_if_unhealthy()
        except ServingError as e:
            return self._json(e.http_status,
                              {"error": str(e), "kind": e.kind})
        try:
            raw = self.engine.decode_request(img_bytes)
        except Exception as e:  # noqa: BLE001 — bad upload is a client
            # error (the native plane declines to PIL, PIL raises here)
            return self._json(400,
                              {"error": f"could not decode image: {e}",
                               "kind": "bad_request"})
        try:
            # submit + wait: the engine batches this request with every
            # other in-flight one inside the batching window
            preds = self.engine.submit_raw(self.model_name, raw).result(
                timeout=60)
            top = np.argsort(-preds)[:5]
            body = {"predictions": [
                # a short labels file falls back to the class index
                # rather than crashing the handler mid-response
                {"label": (self.labels[i] if self.labels
                           and i < len(self.labels) else int(i)),
                  "score": float(preds[i])} for i in top]}
        except ServingError as e:
            # typed engine failures: shed 429, deadline 504,
            # closed/unhealthy 503 — never a blanket 500
            return self._json(e.http_status,
                              {"error": str(e), "kind": e.kind})
        except Exception as e:  # noqa: BLE001 — anything else IS a 500
            return self._json(500, {"error": f"classification failed: {e}",
                                    "kind": "error"})
        self._json(200, body)

    def do_GET(self):
        url = urlparse(self.path)
        if url.path == "/":
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(_FORM)))
            self.end_headers()
            self.wfile.write(_FORM)
            return
        if url.path == "/stats":
            return self._json(200, self.engine.stats())
        if url.path == "/healthz":
            h = self.engine.health()
            return self._json(200 if h["healthy"] else 503, h)
        if url.path == "/readyz":
            ok, doc = self.engine.ready()
            return self._json(200 if ok else 503, doc)
        if url.path == "/classify_path":
            if not self.image_root:
                return self._json(403, {"error": "no --image-root given",
                                        "kind": "forbidden"})
            rel = parse_qs(url.query).get("path", [""])[0]
            full = os.path.realpath(os.path.join(self.image_root, rel))
            root = os.path.realpath(self.image_root)
            if not full.startswith(root + os.sep):
                return self._json(403, {"error": "path outside image root",
                                        "kind": "forbidden"})
            try:
                with open(full, "rb") as f:
                    raw = f.read()
            except OSError as e:
                return self._json(404, {"error": str(e), "kind": "not_found"})
            return self._classify_bytes(raw)
        self._json(404, {"error": f"no route {url.path}",
                         "kind": "not_found"})

    def do_POST(self):
        if urlparse(self.path).path != "/classify":
            return self._json(404, {"error": "POST /classify",
                                    "kind": "not_found"})
        if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
            # http.server doesn't de-chunk; demand a sized body instead of
            # reading 0 bytes and emitting a confusing decode error.
            return self._json(411, {"error": "Content-Length required "
                                             "(chunked uploads unsupported)",
                                    "kind": "bad_request"})
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:  # garbled header is a client error, not a crash
            return self._json(400, {"error": "bad Content-Length",
                                    "kind": "bad_request"})
        body = self.rfile.read(length)
        try:
            img_bytes = extract_image_bytes(
                body, self.headers.get("Content-Type", ""))
        except Exception as e:  # bad upload is a client error, not a crash
            return self._json(400,
                              {"error": f"could not decode image: {e}",
                               "kind": "bad_request"})
        self._classify_bytes(img_bytes)

    def log_message(self, fmt, *args):  # quiet by default
        if os.environ.get("WEB_DEMO_VERBOSE"):
            sys.stderr.write(fmt % args + "\n")


class _Server(ThreadingHTTPServer):
    # the accept backlog: socketserver's default of 5 resets the
    # connections of a burst of concurrent uploads
    request_queue_size = 256


def make_server(engine, model_name: str = "default", labels=None,
                image_root: str | None = None, port: int = 5000,
                host: str = "127.0.0.1",
                admin: bool = False) -> ThreadingHTTPServer:
    """HTTP front over an already-loaded ServingEngine (port=0 picks an
    ephemeral port: tests, the smoke). `labels` is a list of class names
    or a path to a labels file. `admin=True` (the fleet's POST /swap) is
    not ported and raises NotImplementedError."""
    if admin:
        raise NotImplementedError(
            "http_front admin=True (POST /swap, the serving fleet's "
            "rolling swap) is not ported yet (ROADMAP.md §1 item 5)")
    if isinstance(labels, str):
        with open(labels) as f:
            labels = [line.strip() for line in f]
    handler = type("Handler", (_Handler,), {
        "engine": engine,
        "model_name": model_name,
        "labels": labels,
        "image_root": image_root,
    })
    return _Server((host, port), handler)
