"""Minimal HTTP front end over the BatchingEngine (a copy of
``qcnn_tpu/serve/http.py``: the same routes and status codes).

POST /classify   body: BMP bytes (24-bit, like the reference's inputs) or a
                 raw float32 tensor with X-Shape: H,W,C header
GET  /healthz    liveness + engine stats

Stdlib-only (http.server with a thread per request); concurrent requests
coalesce into device batches via the engine. One change against the JAX
package's server: a listen backlog of 1024 where socketserver's default is
5. With the default, 256 clients connecting at once lost 2 to 106 of their
256 requests to connection resets on the CPU host that runs the tests; with
1024, none.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from qcnn_tpu_torch.serve.engine import (
    BatchingEngine, DeadlineExceeded, EngineOverloaded,
)


class _Server(ThreadingHTTPServer):
    """The threading HTTP server with a listen backlog for bursts."""

    request_queue_size = 1024


def make_handler(engine: BatchingEngine, preprocessor, top_k: int,
                 class_names, max_body_bytes: int = 32 << 20):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "stats": engine.stats})
            elif self.path == "/metrics":
                self._json(200, {
                    **engine.stats,
                    **engine.latency_percentiles(),
                    "buckets": list(engine.config.bucket_ladder()),
                })
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/classify":
                self._json(404, {"error": "unknown path"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length > max_body_bytes:
                # unbounded rfile.read(client-declared length) is a
                # trivial memory-exhaustion DoS; a preprocessed 224x224x3
                # f32 tensor is ~600 KB
                self._json(413, {
                    "error": f"body {length} bytes > limit "
                             f"{max_body_bytes}"
                })
                return
            body = self.rfile.read(length)
            try:
                if self.headers.get("X-Shape"):
                    shape = tuple(
                        int(v) for v in self.headers["X-Shape"].split(",")
                    )
                    img = np.frombuffer(body, np.float32).reshape(shape)
                else:
                    # Image uploads (BMP via the native pipeline, JPEG/PNG
                    # via PIL where it is installed) go through the model's
                    # preprocessing (resize/crop/normalize -> HWC); X-Shape
                    # raw tensors are assumed preprocessed.
                    if preprocessor is not None:
                        batch = preprocessor.process_blobs([body])
                        if batch is not None:  # threaded C++ pipeline
                            img = batch[0]
                        else:
                            from qcnn_tpu_torch.preproc.bmp import decode_image

                            img = preprocessor(decode_image(body))
                    else:
                        from qcnn_tpu_torch.preproc.bmp import decode_image

                        img = decode_image(body)
            except Exception as e:  # noqa: BLE001
                self._json(400, {"error": f"bad image: {e}"})
                return
            try:
                deadline_hdr = self.headers.get("X-Deadline-Ms")
                probs = engine.classify(
                    img,
                    deadline_ms=(
                        float(deadline_hdr) if deadline_hdr else None
                    ),
                )
            except ValueError as e:
                # submit()'s shape/rank validation: the CLIENT sent a
                # mis-shaped tensor — 400, not 500 (5xx alerting must not
                # fire for malformed client requests)
                self._json(400, {"error": str(e)})
                return
            except EngineOverloaded as e:
                # backpressure: shed load instead of queueing unboundedly
                self._json(503, {"error": str(e)})
                return
            except DeadlineExceeded as e:
                self._json(504, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": str(e)})
                return
            idx = np.argsort(-probs)[:top_k]
            self._json(200, {
                "class_ids": [int(i) for i in idx],
                "probs": [float(probs[i]) for i in idx],
                "class_names": [
                    class_names[i] if class_names and i < len(class_names)
                    else str(i)
                    for i in idx
                ],
            })

    return Handler


def serve(
    engine: BatchingEngine,
    *,
    host: str = "127.0.0.1",
    port: int = 8000,
    preprocessor=None,
    top_k: int = 5,
    class_names=None,
    block: bool = True,
):
    handler = make_handler(engine, preprocessor, top_k, class_names)
    server = _Server((host, port), handler)
    if block:
        server.serve_forever()
        return server
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server
