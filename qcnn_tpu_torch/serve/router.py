"""Multi-host serving router: a thin HTTP front door over per-host engines
(a copy of ``qcnn_tpu/serve/router.py``).

The multi-host continuous-batching design (docs/PARALLELISM.md): hosts run
independent BatchingEngines over their local cards; a router spreads
requests so each host's dispatcher forms its own device batches. Stdlib
only; least-outstanding-requests balancing with passive failover (a backend
that errors is quarantined for `cooldown_s` and retried on the next
candidate).

POST /classify and GET /metrics proxy through; GET /healthz aggregates
backend health. The router listens with a backlog of 1024, as the port's
server does (serve/http.py says why).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _Server(ThreadingHTTPServer):
    request_queue_size = 1024


class Backend:
    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.outstanding = 0
        self.down_until = 0.0
        self.requests = 0
        self.errors = 0


class Router:
    def __init__(self, backend_urls, *, cooldown_s: float = 5.0,
                 timeout_s: float = 600.0):
        if not backend_urls:
            raise ValueError("need at least one backend")
        self.backends = [Backend(u) for u in backend_urls]
        self.cooldown_s = cooldown_s
        self.timeout_s = timeout_s
        self._lock = threading.Lock()

    def _candidates(self):
        now = time.monotonic()
        with self._lock:
            up = [b for b in self.backends if b.down_until <= now]
            pool = up or self.backends  # all down: try anyway
            # least-outstanding first; tie-break on total served so serial
            # traffic round-robins instead of pinning the first backend
            return sorted(pool, key=lambda b: (b.outstanding, b.requests))

    def forward(self, method: str, path: str, body: bytes | None,
                headers: dict) -> tuple[int, bytes]:
        last_err: Exception | None = None
        last_http: tuple[int, bytes] | None = None
        for backend in self._candidates():
            with self._lock:
                backend.outstanding += 1
                backend.requests += 1
            try:
                req = urllib.request.Request(
                    backend.url + path, data=body, method=method,
                    headers={k: v for k, v in headers.items()
                             if k.lower() in ("x-shape", "x-deadline-ms",
                                              "content-type")},
                )
                with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                if e.code < 500 and e.code != 429:
                    # client error (bad image etc.): pass through,
                    # don't fail over — retrying elsewhere cannot help
                    return e.code, e.read()
                # 5xx/429 = LOAD or backend fault (503 EngineOverloaded,
                # a wedged 500): another backend may have capacity.
                # Passing these through would defeat the module's
                # failover contract — least-outstanding kept
                # selecting the overloaded backend (its 503s return
                # instantly, so its outstanding count stayed lowest)
                # while an idle peer sat unused. Overload errors count
                # toward quarantine like connection failures.
                last_err = e
                body_err = e.read()
                with self._lock:
                    backend.errors += 1
                    backend.down_until = time.monotonic() + self.cooldown_s
                last_http = (e.code, body_err)
                continue
            except Exception as e:  # noqa: BLE001 - connection-level: fail over
                last_err = e
                with self._lock:
                    backend.errors += 1
                    backend.down_until = time.monotonic() + self.cooldown_s
            finally:
                with self._lock:
                    backend.outstanding -= 1
        if last_http is not None:
            # every candidate was overloaded/faulted at the HTTP level:
            # surface the real backend status (e.g. 503 + its
            # backpressure body), not a generic 502
            return last_http
        return 502, json.dumps(
            {"error": f"all backends failed: {last_err}"}
        ).encode()

    def health(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return {
                "ok": any(b.down_until <= now for b in self.backends),
                "backends": [
                    {
                        "url": b.url,
                        "up": b.down_until <= now,
                        "outstanding": b.outstanding,
                        "requests": b.requests,
                        "errors": b.errors,
                    }
                    for b in self.backends
                ],
            }


def serve_router(
    backend_urls,
    *,
    host: str = "127.0.0.1",
    port: int = 8080,
    block: bool = True,
    **router_kwargs,
):
    router = Router(backend_urls, **router_kwargs)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, json.dumps(router.health()).encode())
            else:
                code, body = router.forward("GET", self.path, None, {})
                self._send(code, body)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            code, resp = router.forward(
                "POST", self.path, body, dict(self.headers)
            )
            self._send(code, resp)

    server = _Server((host, port), Handler)
    server.router = router
    if block:
        server.serve_forever()
        return server
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
