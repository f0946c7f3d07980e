"""The port's serving stack (serve/engine.py, http.py, router.py) against the
JAX package's, on the CPU.

Both packages' engines serve the tiny spec of tests/test_serve.py with the
same PQ params (the JAX package's synthetic ones, carried over by
models.interop.params_from_jax) and the same seeded NumPy images:
- float32, 'auto' (decoded at load) and 'memory': max |Δprob| <= 1e-5
  (the same f32 arithmetic in another order);
- bf16, uploads in bf16 on both sides: max |Δprob| <= 1e-2 (bf16 rounds
  at other places in the two frameworks; the end-to-end limit the chip
  smoke holds memory mode to).
The HTTP bodies of both servers, the status code of each error case and
the engines' stats keys are held equal. The pipeline tests of
tests/test_serve.py run on an echo engine built with from_forward, whose
forward returns each row's mean, so a result names the image that filled
its batch slot. The router runs over the port's backends.
"""

import concurrent.futures as cf
import functools
import http.client
import http.server
import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcnn_tpu.core import ConvSpec as JConv
from qcnn_tpu.core import FCSpec as JFC
from qcnn_tpu.core import ModelSpec as JModel
from qcnn_tpu.core import PoolSpec as JPool
from qcnn_tpu.core import ReLUSpec as JReLU
from qcnn_tpu.core import SoftmaxSpec as JSoftmax
from qcnn_tpu.models import resnet as jresnet
from qcnn_tpu.models import synth as jsynth
from qcnn_tpu.serve import engine as jengine
from qcnn_tpu.serve.http import serve as jserve
from qcnn_tpu_torch.core import ConvSpec, FCSpec, ModelSpec, PoolSpec, ReLUSpec
from qcnn_tpu_torch.core import SoftmaxSpec
from qcnn_tpu_torch.models import common
from qcnn_tpu_torch.models import resnet as tresnet
from qcnn_tpu_torch.models.interop import (
    family_params_from_jax,
    params_from_jax,
)
from qcnn_tpu_torch.serve import engine as tengine
from qcnn_tpu_torch.serve.http import serve as tserve
from qcnn_tpu_torch.serve.router import serve_router
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

SHAPE = (11, 11, 4)
NAMES = [f"class {i}" for i in range(10)]


def _tiny(core):
    conv, fc, model, pool, relu, softmax = core
    return model(
        name="tiny", in_height=11, in_width=11, in_channels=4,
        layers=(conv(kernel=3, out_channels=16, pad=1, stride=2), relu(),
                pool(kernel=2, stride=2), fc(10), softmax()),
    )


JSPEC = _tiny((JConv, JFC, JModel, JPool, JReLU, JSoftmax))
TSPEC = _tiny((ConvSpec, FCSpec, ModelSpec, PoolSpec, ReLUSpec, SoftmaxSpec))


@pytest.fixture(scope="module")
def params():
    jp = jsynth.random_pq_params(JSPEC, seed=1)
    return jp, params_from_jax(jp, device="cpu")


def _images(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, *SHAPE)).astype(np.float32)


def _pair(params, impl="auto", dtype="float32", **cfg):
    """(port engine, JAX engine) on the same params, un-started."""
    jp, tp = params
    config = dict(max_batch=8, max_wait_ms=5.0) | cfg
    teng = tengine.BatchingEngine(
        TSPEC, tp, config=tengine.EngineConfig(**config), conv_impl=impl,
        fc_impl=impl, compute_dtype=getattr(torch, dtype), device="cpu")
    jeng = jengine.BatchingEngine(
        JSPEC, jp, config=jengine.EngineConfig(**config), conv_impl=impl,
        fc_impl=impl, compute_dtype=getattr(jnp, dtype))
    return teng, jeng


def _serve_all(engine, images, timeout=60):
    futs = [engine.submit(im) for im in images]
    return np.stack([np.asarray(f.result(timeout=timeout), np.float32)
                     for f in futs])


@pytest.fixture(scope="module")
def engines(params):
    """A started f32 pair, shared by the tests that only read."""
    teng, jeng = _pair(params)
    teng.start()
    jeng.start()
    yield teng, jeng
    teng.stop()
    jeng.stop()


@pytest.fixture
def servers():
    """Start HTTP servers (and routers) through `start`; every one is shut
    down and closed at the end of the test."""
    started = []

    def start(server):
        started.append(server)
        return server

    yield start
    for server in started:
        server.shutdown()
        server.server_close()


def _url(server, path="/classify"):
    return f"http://127.0.0.1:{server.server_address[1]}{path}"


def _post(url, body, headers=None, timeout=60):
    req = urllib.request.Request(url, data=body, headers=headers or {},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _classify(server, img, **headers):
    return _post(_url(server), img.tobytes(),
                 {"X-Shape": ",".join(map(str, img.shape)), **headers})


# ---- the engine against the JAX package's -----------------------------------


@pytest.mark.parametrize("impl", ["auto", "memory"])
def test_f32_engine_matches_jax(params, impl):
    teng, jeng = _pair(params, impl)
    images = _images(12)
    with teng, jeng:
        got, want = _serve_all(teng, images), _serve_all(jeng, images)
    assert teng._upload_dtype == torch.float32
    assert got.dtype == np.float32 and got.shape == (12, 10)
    assert np.abs(got - want).max() <= 1e-5
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "memory"])
def test_bf16_engine_matches_jax(params, impl):
    teng, jeng = _pair(params, impl, "bfloat16")
    assert teng._upload_dtype == torch.bfloat16
    assert jeng._upload_dtype.__name__ == "bfloat16"
    images = _images(12, seed=1)
    with teng, jeng:
        got, want = _serve_all(teng, images), _serve_all(jeng, images)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-2


def test_memory_mode_keeps_only_compressed_params(params):
    teng, _ = _pair(params, "memory")
    assert any(p is not None and "codebooks" in p for p in teng.params)
    assert not any(p is not None and ("kernel" in p or "weight" in p)
                   for p in teng.params)
    teng.stop()


def test_stats_keys_equal_the_jax_engines(engines):
    teng, jeng = engines
    assert teng.stats.keys() == jeng.stats.keys()
    assert teng.stats["stage_ms"].keys() == jeng.stats["stage_ms"].keys()
    for eng in engines:
        eng.classify(_images(1)[0], timeout=60)
    # both engines record a batch's latency after resolving its futures
    t_end = time.monotonic() + 10
    while (not all(e.latency_percentiles() for e in engines)
           and time.monotonic() < t_end):
        time.sleep(0.01)
    assert (teng.latency_percentiles().keys()
            == jeng.latency_percentiles().keys()
            == {"p50_ms", "p95_ms", "p99_ms"})


def test_concurrent_requests_coalesce(engines):
    teng, _ = engines
    before = dict(teng.stats)
    got = _serve_all(teng, _images(20, seed=2))
    assert got.shape == (20, 10)
    batches = teng.stats["batches"] - before["batches"]
    requests = teng.stats["requests"] - before["requests"]
    assert requests == 20 and batches < requests


def test_warmup_runs_every_bucket(params):
    teng, _ = _pair(params)
    times = teng.warmup()
    assert sorted(times) == [1, 8] and all(t > 0 for t in times.values())
    teng.stop()


def test_no_cuda_raises_unless_cpu_is_asked_for(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.BatchingEngine(TSPEC, params[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.BatchingEngine.from_forward(lambda p, x: x, None, SHAPE)
    eng = tengine.BatchingEngine(TSPEC, params[1], device="cpu")
    assert eng.device == torch.device("cpu")
    assert eng.params[0]["kernel"].dtype == torch.float32  # f32 on the CPU


def test_resnet_family_from_forward_matches_jax():
    """A ResNet tiny family through from_forward, both packages: the
    family's nested params and partial forward."""
    jspec = jresnet.ResNetSpec("rn-serve", (1,), (32,), num_classes=7,
                               in_size=16, bottleneck=False)
    tspec = tresnet.ResNetSpec("rn-serve", (1,), (32,), num_classes=7,
                               in_size=16, bottleneck=False)
    pq = jresnet.quantize_params(
        jspec, jresnet.init_dense_params(jspec, seed=9),
        conv_codewords=8, fc_codewords=8)
    jfwd = functools.partial(jresnet.forward, spec=jspec, with_softmax=True)
    config = dict(max_batch=4, max_wait_ms=5.0)
    jeng = jengine.BatchingEngine.from_forward(
        jfwd, jresnet.prepare_params(jspec, pq, dtype=np.float32),
        (16, 16, 3), config=jengine.EngineConfig(**config))
    prepared, tfwd, act = common.build_family_forward(
        "resnet", tspec, family_params_from_jax(pq, device="cpu"),
        compute_dtype=torch.float32, device="cpu")
    teng = tengine.BatchingEngine.from_forward(
        tfwd, prepared, (16, 16, 3), config=tengine.EngineConfig(**config),
        upload_dtype=tengine._upload_dtype_for(act), device="cpu")
    images = np.random.default_rng(3).standard_normal(
        (6, 16, 16, 3)).astype(np.float32)
    with teng, jeng:
        got, want = _serve_all(teng, images), _serve_all(jeng, images)
    assert got.shape == (6, 7)
    assert np.abs(got - want).max() <= 1e-5


# ---- HTTP --------------------------------------------------------------------


def test_http_bodies_match_jax(engines, servers):
    teng, jeng = engines
    tsrv = servers(tserve(teng, port=0, block=False, class_names=NAMES))
    jsrv = servers(jserve(jeng, port=0, block=False, class_names=NAMES))
    for img in _images(3, seed=4):
        (tcode, tbody), (jcode, jbody) = (_classify(tsrv, img),
                                          _classify(jsrv, img))
        assert tcode == jcode == 200
        assert tbody["class_ids"] == jbody["class_ids"]
        assert tbody["class_names"] == jbody["class_names"]
        assert len(tbody["class_ids"]) == 5
        np.testing.assert_allclose(tbody["probs"], jbody["probs"],
                                   rtol=0, atol=1e-5)
    for path in ("/healthz", "/metrics"):
        bodies = []
        for srv in (tsrv, jsrv):
            with urllib.request.urlopen(_url(srv, path), timeout=30) as r:
                bodies.append(json.loads(r.read()))
        assert bodies[0].keys() == bodies[1].keys()
    assert bodies[0]["buckets"] == [1, 8]


def _get_status(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _status_of_each_error(srv, overloaded_srv):
    """{case: status} of one package's server (over a started engine) and
    of a server over an engine whose bounded queue is full."""
    img = _images(1)[0]
    out = {
        "undecodable": _post(_url(srv), b"garbage", {"X-Shape": "3,3"})[0],
        "mis-shaped": _post(_url(srv), img[:5, :5].tobytes(),
                            {"X-Shape": "5,5,4"})[0],
        "unknown path": _post(_url(srv, "/nope"), b"x")[0],
        "unknown get": _get_status(_url(srv, "/nope")),
        "deadline": _classify(srv, img, **{"X-Deadline-Ms": "0.001"})[0],
        "overloaded": _classify(overloaded_srv, img)[0],
    }
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                      timeout=30)
    try:
        conn.putrequest("POST", "/classify")
        conn.putheader("Content-Length", str(64 << 20))  # over 32 MB
        conn.endheaders()
        out["too large"] = conn.getresponse().status
    finally:
        conn.close()
    return out


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_error_matrix(params, engines, servers, pkg):
    """Each error case gets the status qcnn_tpu/serve/http.py maps it to,
    from both packages' servers."""
    eng, serve = {"torch": (engines[0], tserve),
                  "jax": (engines[1], jserve)}[pkg]
    overloaded = _pair(params, max_queue=1)[pkg == "jax"]
    overloaded.submit(_images(1)[0])  # not started: the queue stays full
    before = dict(eng.stats)
    try:
        got = _status_of_each_error(
            servers(serve(eng, port=0, block=False)),
            servers(serve(overloaded, port=0, block=False)))
    finally:
        overloaded.stop()
    assert got == {"undecodable": 400, "mis-shaped": 400,
                   "unknown path": 404, "unknown get": 404,
                   "deadline": 504, "too large": 413, "overloaded": 503}
    assert eng.stats["expired"] - before["expired"] == 1
    assert overloaded.stats["rejected"] == 1


def test_burst_of_connections_is_answered(servers):
    """256 clients connecting at once all get answers: the port's server
    listens with a backlog for bursts (socketserver's default of 5 reset
    some of these connections)."""
    eng = tengine.BatchingEngine.from_forward(
        lambda p, x: x.reshape(x.shape[0], -1)[:, :10], None, (32, 32, 3),
        device="cpu", config=tengine.EngineConfig(max_batch=64))
    srv = servers(tserve(eng, port=0, block=False))
    img = np.zeros((32, 32, 3), np.float32)
    with eng, cf.ThreadPoolExecutor(256) as pool:
        codes = list(pool.map(lambda _: _classify(srv, img)[0], range(256)))
    assert codes == [200] * 256


# ---- the pipeline, on an echo engine (tests/test_serve.py:566-728) --------


def _echo_engine(max_batch=4, max_wait_ms=2.0, buckets=None):
    """An engine whose forward returns each row's mean: a result tells
    which image filled its batch slot (a reused-buffer leak or a stale pad
    row would corrupt it)."""
    def fwd(params, x):
        assert params is None
        return x.reshape(x.shape[0], -1).mean(dim=1, keepdim=True)

    return tengine.BatchingEngine.from_forward(
        fwd, None, (5, 5, 2), device="cpu",
        config=tengine.EngineConfig(max_batch=max_batch,
                                    max_wait_ms=max_wait_ms,
                                    buckets=buckets))


def _const(v):
    return np.full((5, 5, 2), v, np.float32)


def test_pipeline_buffer_reuse_no_stale_rows():
    """A fuller batch then a smaller one through the same reused upload
    buffer: every request gets ITS image's result."""
    eng = _echo_engine()
    with eng:
        for wave, vals in enumerate(([1.0, 2.0, 3.0, 4.0], [5.0, 6.0])):
            futs = [eng.submit(_const(v)) for v in vals]
            got = [float(f.result(timeout=30)[0]) for f in futs]
            assert got == pytest.approx(vals), (wave, got)


def test_stop_completes_or_fails_everything():
    """stop() leaves no hung futures: already-pipelined batches complete,
    anything still queued fails fast with RuntimeError."""
    eng = _echo_engine(max_batch=2, max_wait_ms=1.0)
    eng.start()
    futs = [eng.submit(_const(float(i))) for i in range(32)]
    eng.stop()
    outcomes = []
    for f in futs:
        try:
            outcomes.append(float(f.result(timeout=5)[0]))
        except RuntimeError:
            outcomes.append(None)
    assert len(outcomes) == 32  # nothing hung past its timeout
    done_vals = [v for v in outcomes if v is not None]
    assert done_vals == sorted(done_vals)  # FIFO order preserved
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit(_const(0.0))


def test_striped_assembly_preserves_slot_contents(rng):
    """The per-image copy stripes across a worker pool: force a
    multi-stripe geometry whatever the host's core count."""
    eng = _echo_engine(max_batch=64, max_wait_ms=5.0)
    eng._asm_workers = 4  # stripes at n >= 8 regardless of host cores
    n = 192
    vals = rng.permutation(np.arange(1.0, n + 1.0)).astype(np.float32)
    with eng:
        futs = [eng.submit(_const(v)) for v in vals]
        got = [float(f.result(timeout=60)[0]) for f in futs]
        assert eng._asm_pool is not None  # the striped path engaged
    assert got == pytest.approx(list(vals))
    assert eng.stats["requests"] == n


def test_pipeline_stress_no_cross_batch_corruption(rng):
    """Hundreds of requests with unique payloads through varying batch
    sizes from more submitting threads than cores: every future resolves
    to ITS image's mean."""
    eng = _echo_engine(max_batch=8, max_wait_ms=1.0)
    n = 400
    vals = rng.permutation(np.arange(1.0, n + 1.0)).astype(np.float32)
    with eng:
        with cf.ThreadPoolExecutor(16) as pool:
            got = list(pool.map(
                lambda v: float(eng.submit(_const(v)).result(timeout=60)[0]),
                vals))
    assert got == pytest.approx(list(vals))
    assert eng.stats["requests"] == n
    assert eng.stats["batches"] < n


def test_bucket_cap_below_max_batch():
    """Buckets smaller than max_batch: a batch never ships above the
    largest bucket, and padded_waste stays >= 0."""
    eng = _echo_engine(max_batch=8, max_wait_ms=50.0, buckets=(1, 2))
    with eng:
        futs = [eng.submit(_const(float(v))) for v in range(5)]
        got = [float(f.result(timeout=60)[0]) for f in futs]
    assert got == pytest.approx([0.0, 1.0, 2.0, 3.0, 4.0])
    assert eng.stats["batches"] >= 3 and eng.stats["padded_waste"] >= 0


def test_cancelled_future_does_not_poison_batch():
    """fut.cancel() before dispatch must not break the batch: the
    dispatcher claims futures (RUNNING) and drops cancelled ones."""
    eng = _echo_engine(max_batch=4, max_wait_ms=20.0)
    futs = [eng.submit(_const(float(v))) for v in range(4)]
    assert futs[1].cancel()  # not started: the cancel wins
    with eng:
        got = [float(f.result(timeout=60)[0]) for i, f in enumerate(futs)
               if i != 1]
    assert got == pytest.approx([0.0, 2.0, 3.0])
    assert eng.stats["requests"] == 3


def test_a_batch_is_counted_before_its_answers_resolve():
    """A caller holding its answer sees its batch in the stats: a done-
    callback, which runs inside set_result, reads them."""
    eng = _echo_engine()
    fut = eng.submit(_const(1.0))
    seen = []
    fut.add_done_callback(lambda f: seen.append(
        (eng.stats["requests"], eng.stats["batches"])))
    with eng:
        assert float(fut.result(timeout=30)[0]) == 1.0
    assert seen == [(1, 1)]


def test_a_failed_forward_fails_its_batch_and_is_counted():
    def fwd(params, x):
        raise RuntimeError("forward broke")

    eng = tengine.BatchingEngine.from_forward(
        fwd, None, (5, 5, 2), device="cpu",
        config=tengine.EngineConfig(max_batch=4, max_wait_ms=20.0))
    futs = [eng.submit(_const(float(v))) for v in range(3)]
    with eng:
        for f in futs:
            with pytest.raises(RuntimeError, match="forward broke"):
                f.result(timeout=30)
        # the slot was handed back: the engine still takes a batch
        with pytest.raises(RuntimeError, match="forward broke"):
            eng.classify(_const(0.0), timeout=30)
    assert eng.stats["requests"] == 4 and eng.stats["batches"] == 2


def test_deadline_expired_requests_are_dropped():
    eng = _echo_engine(max_batch=2, max_wait_ms=1.0)
    doomed = eng.submit(_const(1.0), deadline_ms=1.0)
    alive = eng.submit(_const(2.0))  # no deadline
    time.sleep(0.05)
    with eng:
        assert float(alive.result(timeout=60)[0]) == pytest.approx(2.0)
        with pytest.raises(tengine.DeadlineExceeded):
            doomed.result(timeout=5)
    assert eng.stats["expired"] == 1


def test_backpressure_rejects_when_queue_full():
    eng = tengine.BatchingEngine.from_forward(
        lambda p, x: x, None, (5, 5, 2), device="cpu",
        config=tengine.EngineConfig(max_batch=2, max_queue=2))
    eng.submit(_const(0.0))
    eng.submit(_const(0.0))
    with pytest.raises(tengine.EngineOverloaded, match="queue full"):
        eng.submit(_const(0.0))
    assert eng.stats["rejected"] == 1
    eng.stop()


def test_mis_shaped_request_rejected_not_fatal():
    eng = _echo_engine()
    with eng:
        with pytest.raises(ValueError, match="expected image shape"):
            eng.submit(np.zeros((4, 5, 2), np.float32))
        with pytest.raises(ValueError, match="expected HWC"):
            eng.submit(np.zeros((5, 5), np.float32))
        assert float(eng.classify(_const(3.0), timeout=60)[0]) == 3.0


def test_bf16_uploads_round_once_on_the_callers_thread():
    """A bf16 engine receives rows already in bf16 (float64 images through
    float32 first) and its forward sees the upload dtype."""
    seen = []

    def fwd(params, x):
        seen.append(x.dtype)
        return x.float().reshape(x.shape[0], -1)[:, :1]

    eng = tengine.BatchingEngine.from_forward(
        fwd, None, (5, 5, 2), upload_dtype=torch.bfloat16, device="cpu")
    v = 1.0 + 2.0 ** -9  # not a bf16 value: rounds to 1.0
    with eng:
        got = eng.classify(np.full((5, 5, 2), v, np.float64), timeout=60)
    assert seen == [torch.bfloat16] and got.dtype == np.float32
    assert float(got[0]) == float(torch.tensor(v).to(torch.bfloat16))


# ---- the router over the port's backends (tests/test_serve.py:394-563) ------


def _router_post(server, body, headers):
    return _post(_url(server), body, headers, timeout=30)


def test_router_balances_and_fails_over(params, servers):
    engines = [_pair(params, max_batch=4, max_wait_ms=2.0)[0].start()
               for _ in range(2)]
    try:
        urls = [_url(servers(tserve(e, port=0, block=False)), "")
                for e in engines] + ["http://127.0.0.1:1"]  # dead backend
        router = servers(serve_router(urls, port=0, block=False,
                                      cooldown_s=60))
        img = _images(1)[0]
        for _ in range(6):
            code, out = _classify(router, img)
            assert code == 200 and len(out["class_ids"]) == 5
        assert sum(e.stats["requests"] for e in engines) == 6
        assert all(e.stats["requests"] > 0 for e in engines)
        with urllib.request.urlopen(_url(router, "/healthz"),
                                    timeout=10) as r:
            health = json.loads(r.read())
        assert health["ok"] is True
        assert [b["up"] for b in health["backends"]] == [True, True, False]
        assert health["backends"][2]["errors"] > 0
    finally:
        for e in engines:
            e.stop()


def _stub_server(status, body, seen=None):
    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if seen is not None:
                seen["deadline"] = self.headers.get("X-Deadline-Ms")
            self.send_response(status)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def test_router_overload_fails_over_to_idle_peer(servers):
    """A 503 from an overloaded backend fails over (and counts toward its
    quarantine); the idle peer answers every request."""
    over = servers(_stub_server(503, b'{"error": "queue full"}'))
    ok = servers(_stub_server(200, b'{"class_ids": [0], "probs": [1.0]}'))
    router = servers(serve_router([_url(over, ""), _url(ok, "")], port=0,
                                  block=False, cooldown_s=60))
    for _ in range(4):
        code, _ = _router_post(router, b"\x00" * 16, {"X-Shape": "2,2,1"})
        assert code == 200
    assert router.router.health()["backends"][0]["errors"] > 0


def test_router_passes_application_errors_through(engines, servers):
    srv = servers(tserve(engines[0], port=0, block=False))
    router = servers(serve_router([_url(srv, "")], port=0, block=False))
    code, _ = _router_post(router, b"junk", {"X-Shape": "2,2"})
    assert code == 400  # not converted to a 502 failover
    assert router.router.health()["backends"][0]["errors"] == 0


def test_router_forwards_deadline_header(servers):
    seen = {}
    backend = servers(_stub_server(200, b'{"ok": true}', seen))
    router = servers(serve_router([_url(backend, "")], port=0, block=False))
    code, out = _router_post(router, b"x", {"X-Deadline-Ms": "1500"})
    assert code == 200 and out["ok"]
    assert seen["deadline"] == "1500"
