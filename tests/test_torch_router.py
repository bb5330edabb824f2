"""The router of the PyTorch port (engine/router.py, neurons/router.py)
against the JAX package's, on the CPU.

The policy is held to JAX's on the same backend pictures (least loaded,
the latency and URL tiebreaks, the majority revision, the shed bounds,
the clamped Retry-After). Over live port workers (tiny preset, f32): an
HTTP round trip, the shed 429, the retry on the next backend, a
backend's Retry-After honoured, and the two-leg disaggregated route with
prefill workers kept out of the unified fallback. The JSON is the
protocol: a JAX router in front of port workers and a port router in
front of JAX workers both route, the two-leg hop included.
"""

import dataclasses
import http.server
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu.engine import kv_transfer as jkvt
from distributedtraining_tpu.engine import router as jrouter
from distributedtraining_tpu.engine import serve as jserve
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.transport import InMemoryTransport as JMem
from distributedtraining_tpu_torch.engine import kv_transfer as kvt
from distributedtraining_tpu_torch.engine import router as trouter
from distributedtraining_tpu_torch.engine import serve as tserve
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.neurons import router as router_cli
from distributedtraining_tpu_torch.transport import InMemoryTransport
from distributedtraining_tpu_torch.utils import reqtrace

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# RouterPolicy against JAX's (pure)
# ---------------------------------------------------------------------------

def _b(mod, url, *, queue=0, active=0, ttft=0.0, tpot=0.0, rev=None,
       healthy=True, tps=0.0, acc=0.0, k=0):
    return mod.BackendState(url=url, healthy=healthy, queue_depth=queue,
                            active=active, ttft_ms_p95=ttft,
                            tpot_ms_p95=tpot, revision=rev,
                            tokens_per_sec=tps, spec_accept_rate=acc,
                            spec_k=k)


# (policy kwargs, backends as _b kwargs): the cases of the JAX package's
# tests/test_router.py, and a speculating backend
POLICY_CASES = {
    "least_loaded": ({"max_queue_depth": 6},
                     [dict(url="http://a", queue=3, active=1),
                      dict(url="http://b", queue=0, active=1)]),
    "latency_tiebreak": ({"max_queue_depth": 6},
                         [dict(url="http://a", queue=1, ttft=400.0),
                          dict(url="http://b", queue=1, ttft=20.0)]),
    "url_tiebreak": ({"max_queue_depth": 6},
                     [dict(url="http://b"), dict(url="http://a")]),
    "all_overloaded": ({"max_queue_depth": 4},
                       [dict(url="http://a", queue=3, active=1),
                        dict(url="http://b", queue=4)]),
    "none_live": ({"max_queue_depth": 4},
                  [dict(url="http://a", healthy=False)]),
    "empty": ({"max_queue_depth": 4}, []),
    "ttft_shed": ({"max_queue_depth": 0, "shed_ttft_ms": 250.0},
                  [dict(url="http://a", ttft=300.0)]),
    "ttft_admit": ({"max_queue_depth": 0, "shed_ttft_ms": 250.0},
                   [dict(url="http://a", ttft=200.0)]),
    "majority_revision": ({"max_queue_depth": 4},
                          [dict(url="http://old", rev="r1"),
                           dict(url="http://n1", rev="r2", queue=1),
                           dict(url="http://n2", rev="r2", queue=2)]),
    "majority_saturated": ({"max_queue_depth": 4},
                           [dict(url="http://old", rev="r1"),
                            dict(url="http://n1", rev="r2", queue=4),
                            dict(url="http://n2", rev="r2", queue=4)]),
    "revision_off": ({"max_queue_depth": 6, "prefer_revision": False},
                     [dict(url="http://old", rev="r1"),
                      dict(url="http://n1", rev="r2", queue=1),
                      dict(url="http://n2", rev="r2", queue=2)]),
    "speculating": ({"max_queue_depth": 8},
                    [dict(url="http://a", queue=3),
                     dict(url="http://b", queue=4, acc=0.75, k=4)]),
}


@pytest.mark.parametrize("name", sorted(POLICY_CASES))
def test_policy_matches_jax(name):
    kw, backends = POLICY_CASES[name]
    picks = []
    for mod in (trouter, jrouter):
        pol = mod.RouterPolicy(**kw)
        states = [_b(mod, **b) for b in backends]
        got = pol.choose(states)
        picks.append((None if got is None else got.url,
                      [pol.overloaded(s) for s in states],
                      [pol.score(s) for s in states],
                      pol.retry_after(states)))
    assert picks[0] == picks[1]


@pytest.mark.parametrize("queue,tps", [(0, 0.0), (500, 1.0), (1, 1e6),
                                       (7, 40.0)])
def test_retry_after_clamped_as_jax(queue, tps):
    got = [mod.RouterPolicy(max_queue_depth=2).retry_after(
        [_b(mod, "http://a", queue=queue, tps=tps)])
        for mod in (trouter, jrouter)]
    assert got[0] == got[1]
    assert 1.0 <= got[0] <= 30.0


def test_backend_state_reads_health_as_jax():
    for health in ({"ok": True, "queue_depth": 2, "active": 1,
                    "tokens_per_sec": 12.5, "ttft_ms_p95": 40.0,
                    "revision": "r9", "shed": 3, "phase": "decode",
                    "kv_exported": 0, "kv_adopted": 7,
                    "spec_accept_rate": 0.5, "spec_k": 4},
                   {"ok": True, "phase": "bogus"}, {}):
        ours, theirs = trouter.BackendState("u"), jrouter.BackendState("u")
        ours.update(health)
        theirs.update(health)
        a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        a.pop("last_poll_t"), b.pop("last_poll_t")
        assert a == b


# ---------------------------------------------------------------------------
# Over live workers
# ---------------------------------------------------------------------------

def _sharpened(cfg, seed):
    tree = tg.init_params_numpy(cfg, seed)
    for key, block in tree.items():
        if key.startswith("h_"):
            for name in ("c_attn", "c_proj", "c_fc", "mlp_proj"):
                block[name]["kernel"] *= 10.0
    tree["wpe"] *= 10.0
    return tree


@pytest.fixture(scope="module")
def world():
    tree = _sharpened(TINY, 0)
    jmodel, _ = jg.make_model(JTINY)
    tmodel, _ = tg.make_model(TINY)
    return {"tmodel": tmodel, "jmodel": jmodel,
            "state": tg.params_from_numpy(tree, device="cpu"),
            "jparams": jax.tree_util.tree_map(jnp.asarray, tree),
            "refs": {}}


def oracle(world, prompt, n):
    key = (tuple(prompt), n)
    if key not in world["refs"]:
        world["refs"][key] = jserve.reference_generate(
            world["jmodel"], world["jparams"], prompt, n)
    return world["refs"][key]


class Fleet:
    """Workers of one package (engine + ServeLoop + HTTP frontend each)
    over one shared KV transport, by phase."""

    def __init__(self, world, phases, pkg="torch"):
        self.engines, self.loops, self.fes, self.urls = [], [], [], []
        serve = tserve if pkg == "torch" else jserve
        kv = kvt if pkg == "torch" else jkvt
        tr = InMemoryTransport() if pkg == "torch" else JMem()
        for phase in phases:
            kw = {"phase": phase}
            if phase == "prefill":
                kw["kv_exporter"] = kv.KVExporter(tr)
            if phase == "decode":
                kw["kv_adopter"] = kv.KVAdopter(tr)
            if pkg == "torch":
                eng = serve.GenerationEngine(
                    world["tmodel"], world["state"], device="cpu",
                    revision="r1", max_slots=2, page_size=8, **kw)
            else:
                eng = serve.GenerationEngine(
                    world["jmodel"], world["jparams"], revision="r1",
                    max_slots=2, page_size=8, **kw)
            self.loops.append(serve.ServeLoop(eng, idle_poll_s=0.02).start())
            fe = serve.ServeHTTPFrontend(eng, 0, timeout_s=60.0)
            self.urls.append(f"http://127.0.0.1:{fe.start()}")
            self.engines.append(eng)
            self.fes.append(fe)

    def close(self):
        for fe in self.fes:
            fe.close()
        for loop in self.loops:
            loop.close()
        for eng in self.engines:
            eng.close()


@pytest.fixture()
def fleet(world):
    f = Fleet(world, ["unified", "unified"])
    try:
        yield f
    finally:
        f.close()


@pytest.fixture()
def disagg(world):
    f = Fleet(world, ["unified", "prefill", "decode"])
    try:
        yield f
    finally:
        f.close()


def _generate(port, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _router(mod, urls, **kw):
    kw.setdefault("poll_interval_s", 30.0)
    kw.setdefault("timeout_s", 60.0)
    router = mod.RouterHTTPFrontend(urls, 0, **kw)
    router.refresh()
    return router, router.start()


def test_http_round_trip(world, fleet):
    router, port = _router(trouter, fleet.urls)
    try:
        assert all(b.healthy for b in router.backends)
        prompt = [3, 1, 4, 1, 5]
        out = _generate(port, {"tokens": prompt, "max_new_tokens": 6})
        assert out["tokens"] == oracle(world, prompt, 6)
        assert out["revision"] == "r1" and out["backend"] in fleet.urls
        assert router.routed == 1 and router.shed == 0
        assert router in tserve.live_frontends()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            hz = json.loads(r.read())
        assert hz["role"] == "router" and hz["routed"] == 1
        assert [b["phase"] for b in hz["backends"]] == ["unified"] * 2
    finally:
        router.close()
    assert router not in tserve.live_frontends()


def test_shed_429_without_forwarding(fleet):
    router, port = _router(trouter, fleet.urls,
                           policy=trouter.RouterPolicy(max_queue_depth=2))
    try:
        for b in router.backends:
            b.queue_depth = 2
        with pytest.raises(urllib.error.HTTPError) as ei:
            _generate(port, {"tokens": [1, 2, 3]}, timeout=10)
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) >= 1
        assert router.shed == 1 and router.routed == 0
        assert sum(e.tokens_emitted for e in fleet.engines) == 0
    finally:
        router.close()


def test_retries_the_next_backend(world, fleet):
    """A dead first choice (connection refused): the request is retried
    on the next-best backend and the caller gets a 200."""
    router, port = _router(trouter, ["http://127.0.0.1:9"] + fleet.urls)
    try:
        router.backends[0].healthy = True
        router.backends[0].queue_depth = 0
        prompt = [2, 7, 1]
        out = _generate(port, {"tokens": prompt, "max_new_tokens": 4})
        assert out["tokens"] == oracle(world, prompt, 4)
        assert out["backend"] in fleet.urls and router.routed == 1
    finally:
        router.close()


def test_backend_retry_after_honoured(world, fleet):
    """A backend answering 429 with Retry-After 30 is waited on (capped
    at 0.05 s) before the next-best retry; the request id reaches it."""
    seen = []

    class Shedding(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            seen.append(self.headers.get(reqtrace.REQUEST_ID_HEADER))
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            body = json.dumps({"error": "overloaded"}).encode()
            self.send_response(429)
            self.send_header("Retry-After", "30")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            body = json.dumps({"queue_depth": 0, "active": 0}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Shedding)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    shed_url = f"http://127.0.0.1:{srv.server_address[1]}"
    router = trouter.RouterHTTPFrontend([shed_url] + fleet.urls, 0,
                                        poll_interval_s=30.0, timeout_s=60.0,
                                        retry_after_cap_s=0.05)
    waits = []
    router._sleep = waits.append
    router.refresh()
    try:
        for b in router.backends:
            b.queue_depth = 0 if b.url == shed_url else 1
            b.healthy, b.revision = True, "r1"
        prompt, rid = [9, 8, 7], "rq-0123456789abcdef"
        code, out, hdrs = router._route(
            json.dumps({"tokens": prompt, "max_new_tokens": 4}).encode(), rid)
        assert code == 200 and out["tokens"] == oracle(world, prompt, 4)
        assert out["backend"] in fleet.urls and out["request_id"] == rid
        assert hdrs[reqtrace.REQUEST_ID_HEADER] == rid and seen == [rid]
        assert waits == [0.05] and router.retry_after_honored == 1
    finally:
        router.close()
        srv.shutdown()
        srv.server_close()


def test_two_leg_route_over_port_workers(world, disagg):
    """The router learns the worker classes from /healthz and routes
    /prefill then /generate (kv_ref and first_token merged into the
    body); the spliced output is the oracle's."""
    router, port = _router(trouter, disagg.urls)
    try:
        assert sorted(b.phase for b in router.backends) == \
            ["decode", "prefill", "unified"]
        prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5]
        out = _generate(port, {"tokens": prompt, "max_new_tokens": 6})
        assert out["tokens"] == oracle(world, prompt, 6)
        assert out["backend"] == disagg.urls[2]
        assert out["prefill_backend"] == disagg.urls[1]
        assert (router.disagg_routed, router.disagg_fallbacks) == (1, 0)
        uni, pre, dec = disagg.engines
        assert (pre.kv_exported, dec.kv_adopted, dec.kv_reprefills,
                uni.tokens_emitted) == (1, 1, 0, 0)
    finally:
        router.close()


def test_prefill_workers_stay_out_of_the_unified_fallback(world, disagg):
    """Without a decode worker the two-leg route cannot run: every
    request goes to the unified worker, never to the prefill worker."""
    router, port = _router(trouter, disagg.urls[:2])
    try:
        prompt = [2, 7, 1, 8]
        for _ in range(3):
            out = _generate(port, {"tokens": prompt, "max_new_tokens": 6})
            assert out["tokens"] == oracle(world, prompt, 6)
            assert out["backend"] == disagg.urls[0]
        assert router.disagg_routed == 0
        assert disagg.engines[1].kv_exported == 0
        assert disagg.engines[0].tokens_emitted == 18
    finally:
        router.close()


@pytest.mark.parametrize("router_pkg,workers_pkg", [("jax", "torch"),
                                                    ("torch", "jax")])
def test_router_and_workers_of_either_package(world, router_pkg,
                                              workers_pkg):
    """A JAX router over port workers and a port router over JAX workers:
    both route the two-leg hop, adopting the pages."""
    f = Fleet(world, ["unified", "prefill", "decode"], pkg=workers_pkg)
    router, port = _router(trouter if router_pkg == "torch" else jrouter,
                           f.urls)
    try:
        prompt = [5, 3, 5, 8, 9, 7, 9, 3, 2, 3]
        out = _generate(port, {"tokens": prompt, "max_new_tokens": 5})
        assert out["tokens"] == oracle(world, prompt, 5)
        assert router.disagg_routed == 1 and router.disagg_fallbacks == 0
        assert (f.engines[2].kv_adopted, f.engines[2].kv_reprefills) == \
            (1, 0)
    finally:
        router.close()
        f.close()


def test_router_cli_routes_until_closed(world, fleet, monkeypatch):
    """``neurons.router.main`` with the JAX flags routes, and returns 0
    once its frontend is closed."""
    made = []
    real = trouter.RouterHTTPFrontend.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(trouter.RouterHTTPFrontend, "__init__", spy)
    rc = {}
    argv = [a for u in fleet.urls for a in ("--backend", u)] + [
        "--port", "0", "--max-queue", "4", "--poll-interval", "30",
        "--retry-after-cap", "0"]
    th = threading.Thread(target=lambda: rc.setdefault(
        "rc", router_cli.main(argv)), daemon=True)
    th.start()
    # the frontend listens before its first sweep has read the backends
    for _ in range(400):
        if made and made[0].running and all(b.healthy
                                            for b in made[0].backends):
            break
        threading.Event().wait(0.05)
    fe = made[0]
    try:
        assert fe.policy.max_queue_depth == 4 and fe.retry_after_cap_s == 0
        prompt = [4, 4, 2]
        assert _generate(fe.port, {"tokens": prompt, "max_new_tokens": 3}
                         )["tokens"] == oracle(world, prompt, 3)
    finally:
        fe.close()
        th.join(10)
    assert rc == {"rc": 0}
