"""The port's server role (config.py ``server``, neurons/server.py, the
transport-backed BaseRevisionWatcher of engine/serve.py) against the JAX
package's, on the CPU.

The ``server`` parser takes every flag of the JAX server's parser (same
spellings, destinations, defaults and choices) and refuses only the
fleet planes' flags (slice 7); ``--serve-phase prefill|decode`` is
ported (the CLI's disaggregated workers: tests/test_torch_kv_transfer.py
and test_torch_router.py). The CLI under ``DT_FORCE_PLATFORM=cpu`` boots from a
base the JAX package published on a LocalFS root, answers ``/generate``
with the JAX engine's greedy tokens (and the port engine's sampled
ones), and hot-swaps to a second published base. The watcher stages a
new revision and keeps the current base on a torn fetch, and a server
with ``--speculative`` self-drafts.
"""

import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributedtraining_tpu.engine import serve as jserve
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu_torch.config import RunConfig
from distributedtraining_tpu_torch.engine import serve as tserve
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.neurons import server as tcli
from distributedtraining_tpu_torch.transport import LocalFSTransport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tg.PRESETS["tiny"]


def test_server_flags_match_the_jax_parser():
    from distributedtraining_tpu.config import build_parser as jparser
    from distributedtraining_tpu_torch.config import build_parser

    def table(p):
        return {o: (a.dest, a.default, a.choices)
                for a in p._actions for o in a.option_strings}
    assert table(build_parser("server")) == table(jparser("server"))
    cfg = RunConfig.from_args("server", [
        "--serve-port", "8900", "--serve-slots", "4", "--page-size", "8",
        "--kv-pages", "99", "--max-new-tokens", "7", "--max-seq-len",
        "64", "--max-queue", "3", "--no-prefix-cache", "--speculative",
        "--draft-k", "2", "--draft-repo", "tiny@/x", "--no-serve-trace",
        "--trace-exemplars", "2", "--trace-window", "5", "--swap-policy",
        "restart", "--swap-poll", "0.5"])
    assert (cfg.serve_port, cfg.serve_slots, cfg.serve_page_size,
            cfg.serve_kv_pages, cfg.serve_max_new, cfg.serve_max_seq,
            cfg.serve_max_queue, cfg.serve_prefix_cache,
            cfg.serve_speculative, cfg.serve_draft_k, cfg.serve_draft_repo,
            cfg.serve_trace, cfg.serve_trace_exemplars,
            cfg.serve_trace_window, cfg.swap_policy, cfg.swap_poll) == (
        8900, 4, 8, 99, 7, 64, 3, False, True, 2, "tiny@/x", False, 2,
        5.0, "restart", 0.5)
    cfg.check_ported()


@pytest.mark.parametrize("extra,slice_no", [
    ([], None),
    (["--speculative"], None),
    (["--no-prefix-cache", "--no-serve-trace"], None),
    (["--serve-phase", "unified"], None),
    # disaggregated workers are ported (tests/test_torch_kv_transfer.py);
    # the ids are those of the cases when slice 6b refused them
    pytest.param(["--serve-phase", "prefill"], None, id="extra4-6b"),
    pytest.param(["--serve-phase", "decode"], None, id="extra5-6b"),
    # heartbeats and the JSONL sink are ported (tests/test_torch_health.py,
    # test_torch_metrics.py); the ids are those of the refused cases
    pytest.param(["--heartbeat-interval", "2"], None, id="extra6-7"),
    # the exporter is ported (tests/test_torch_obs_http.py)
    pytest.param(["--obs-port", "9100"], None, id="extra7-7"),
    pytest.param(["--metrics-path", "m.jsonl"], None, id="extra8-7"),
])
def test_server_refusals_name_their_slice(extra, slice_no):
    cfg = RunConfig.from_args("server", extra)
    if slice_no is None:
        cfg.check_ported()
        return
    with pytest.raises(NotImplementedError, match=f"slice {slice_no}"):
        cfg.check_ported()


def _tree(seed):
    tree = tg.init_params_numpy(CFG, seed)
    for key, block in tree.items():
        if key.startswith("h_"):
            for name in ("c_attn", "c_proj", "c_fc", "mlp_proj"):
                block[name]["kernel"] *= 10.0
    tree["wpe"] *= 10.0
    return tree


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        return json.loads(resp.read())


def _jax_tokens(tree, prompts, n, sampling):
    jmodel, _ = jg.make_model(jg.PRESETS["tiny"])
    eng = jserve.GenerationEngine(jmodel, _jtree(tree), prefix_cache=True)
    try:
        reqs = [eng.submit(p, n, **s) for p, s in zip(prompts, sampling)]
        for _ in range(1000):
            if all(r.done_evt.is_set() for r in reqs):
                break
            eng.step()
        return [list(r.tokens) for r in reqs]
    finally:
        eng.close()


def _port_tokens(tree, prompts, n, sampling):
    """The port's engine on the CPU, one request after another (as the
    test posts them), at the preset's bf16 compute."""
    eng = tserve.GenerationEngine(tg.make_model(CFG)[0],
                                  tg.params_from_numpy(tree, device="cpu"),
                                  device="cpu", prefix_cache=True)
    try:
        return [eng.generate([p], n, **s)[0]
                for p, s in zip(prompts, sampling)]
    finally:
        eng.close()


def test_server_cli_serves_a_jax_base_and_hot_swaps(tmp_path, monkeypatch):
    """Greedy answers equal the JAX engine's. A sampled lane at the
    preset's bf16 compute equals the port engine's: its Gumbel noise is
    indexed by rank, so an ulp of difference between JAX's and torch's
    bf16 logits that swaps two near-equal ranks changes the draw
    (tests/test_torch_sampling.py holds sampled streams to JAX's at
    f32)."""
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    work = str(tmp_path / "run")
    jt = JFS(os.path.join(work, "artifacts"))
    trees = [_tree(0), _tree(5)]
    rev1 = jt.publish_base(_jtree(trees[0]))
    port = _free_port()
    rng = np.random.RandomState(4)
    sys_p = [int(t) for t in rng.randint(0, CFG.vocab_size, 20)]
    prompts = [sys_p + [1, 2], sys_p + [3]]
    sampling = [{}, {"temperature": 0.8, "top_p": 0.9, "seed": 12}]
    want1 = _jax_tokens(trees[0], prompts[:1], 8, sampling[:1]) + \
        _port_tokens(trees[0], prompts, 8, sampling)[1:]
    want2 = _jax_tokens(trees[1], prompts[:1], 8, sampling[:1]) + \
        _port_tokens(trees[1], prompts, 8, sampling)[1:]
    assert want1[1] != _port_tokens(trees[0], prompts[1:], 8, [{}])[0]
    rc = {}
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level

    def run():
        rc["rc"] = tcli.main([
            "--backend", "local", "--work-dir", work, "--model", "tiny",
            "--dataset", "synthetic", "--tokenizer", "word",
            "--serve-port", str(port), "--swap-poll", "0.2",
            "--max-steps", "100000", "--flight-events", "0"])

    th = threading.Thread(target=run, name="test-server-main", daemon=True)
    th.start()
    try:
        for _ in range(600):
            try:
                hz = _get(port, "/healthz")
                break
            except OSError:
                time.sleep(0.05)
        assert hz["ok"] and hz["revision"] == rev1 and hz["phase"] == \
            "unified"
        outs = [_post(port, {"tokens": p, "max_new_tokens": 8, **s})
                for p, s in zip(prompts, sampling)]
        assert [o["tokens"] for o in outs] == want1
        assert all(o["revision"] == rev1 and o["status"] == "done"
                   and o["request_id"].startswith("rq-") for o in outs)
        hz = _get(port, "/healthz")
        assert hz["prefix_hit_rate"] == 0.5 and "slo_burn" in hz
        rev2 = jt.publish_base(_jtree(trees[1]))
        for _ in range(200):
            out = _post(port, {"tokens": prompts[0], "max_new_tokens": 8})
            if out["revision"] == rev2:
                break
            time.sleep(0.1)
        assert out["revision"] == rev2 and out["tokens"] == want2[0]
        out = _post(port, {"tokens": prompts[1], "max_new_tokens": 8,
                           **sampling[1]})
        assert out["tokens"] == want2[1]
    finally:
        th.join(timeout=60)
        root.handlers[:], root.level = handlers, level
    assert not th.is_alive() and rc["rc"] == 0
    assert not tserve.live_frontends()


def test_server_cli_speculates_with_a_self_draft(tmp_path, monkeypatch):
    """``--speculative`` with an empty ``--draft-repo`` drafts with the
    served base itself: every proposal is accepted, and the answer is
    the port's speculative engine's at the preset's bf16 compute (spec-on
    against spec-off and JAX at f32: tests/test_torch_speculative.py)."""
    from distributedtraining_tpu_torch.engine import speculative as tspec
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    work = str(tmp_path / "run")
    tree = _tree(0)
    LocalFSTransport(os.path.join(work, "artifacts")).publish_base(tree)
    port = _free_port()
    prompt = [5, 6, 7, 8, 9, 10, 11]
    model = tg.make_model(CFG)[0]
    state = tg.params_from_numpy(tree, device="cpu")
    eng = tserve.GenerationEngine(
        model, state, device="cpu", prefix_cache=True, draft_k=3,
        draft=tspec.DraftEngine(model, state, device="cpu"))
    try:
        want = eng.generate([prompt], 8)
    finally:
        eng.close()
    rc = {}
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level

    def run():
        rc["rc"] = tcli.main([
            "--backend", "local", "--work-dir", work, "--model", "tiny",
            "--dataset", "synthetic", "--tokenizer", "word",
            "--serve-port", str(port), "--swap-poll", "0.2",
            "--max-steps", "100000", "--speculative", "--draft-k", "3",
            "--flight-events", "0", "--no-base-wire-v2"])

    th = threading.Thread(target=run, name="test-server-spec", daemon=True)
    th.start()
    try:
        for _ in range(600):
            try:
                _get(port, "/healthz")
                break
            except OSError:
                time.sleep(0.05)
        out = _post(port, {"tokens": prompt, "max_new_tokens": 8})
        assert out["tokens"] == want[0]
        hz = _get(port, "/healthz")
        assert hz["spec_k"] == 3 and hz["spec_accept_rate"] == 1.0
    finally:
        th.join(timeout=60)
        root.handlers[:], root.level = handlers, level
    assert rc["rc"] == 0


class _TornFetcher:
    def __init__(self):
        self.calls = 0

    def fetch(self, template, revision=None):
        self.calls += 1
        return None


def test_watcher_stages_swaps_and_survives_a_torn_fetch(tmp_path):
    """A published revision stages once (on the CPU here); the engine
    swaps it in between steps; a torn fetch stages nothing and the
    current base keeps serving."""
    root = str(tmp_path / "artifacts")
    t = LocalFSTransport(root)
    trees = [_tree(0), _tree(5)]
    rev1 = t.publish_base(trees[0])
    model, _ = tg.make_model(CFG)
    watcher = tserve.BaseRevisionWatcher(
        t, lambda: tserve.host_param_template(model), poll_s=60,
        device="cpu")
    assert watcher.poll_once() and not watcher.poll_once()
    rev, state = watcher.take_pending()
    assert rev == rev1 and state["wte"].device.type == "cpu"
    eng = tserve.GenerationEngine(model, state, device="cpu", revision=rev,
                                  watcher=watcher, prefix_cache=True,
                                  max_slots=2, page_size=8)
    try:
        first = eng.generate([[1, 2, 3, 4]], 4)
        rev2 = t.publish_base(trees[1])
        assert watcher.poll_once()
        second = eng.generate([[1, 2, 3, 4]], 4)
        assert eng.revision == rev2 and second != first
        torn = tserve.BaseRevisionWatcher(
            t, lambda: tserve.host_param_template(model), device="cpu",
            fetcher=_TornFetcher())
        t.publish_base(trees[0])
        assert not torn.poll_once() and torn.take_pending() is None
    finally:
        eng.close()


def test_server_path_loads_without_jax():
    forbidden = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
                 "ml_dtypes", "distributedtraining_tpu")
    code = ("import sys\n"
            "import distributedtraining_tpu_torch.neurons.server\n"
            "import distributedtraining_tpu_torch.engine.speculative\n"
            "import distributedtraining_tpu_torch.engine.health\n"
            "import distributedtraining_tpu_torch.utils.reqtrace\n"
            "import distributedtraining_tpu_torch.utils.prng\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{forbidden!r}]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
