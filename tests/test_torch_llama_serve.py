"""The Llama family on the port's serving path (engine/serve.py,
engine/speculative.py, engine/kv_transfer.py, neurons/server.py and the
family dispatch of neurons/common.py) against the JAX package, on the
CPU.

The spine is token identity at f32, on the configuration of JAX's own
``tests/test_serve.py::test_llama_gqa_parity`` (2 layers, 4 query heads
over 2 kv heads): the port's engine emits the JAX engine's greedy and
seeded sampled tokens with the prefix cache on, over a KV pool whose
head axis is ``n_kv_head``; a GPT-2 drafter drafts for the Llama target
as JAX's does (same streams, same acceptance); a prefill worker exports
the pages a JAX prefill worker exports, byte for byte, and a decode
worker of either package adopts the other's, and either package's
router routes Llama workers in two legs. The ``--model tiny-llama``
server CLI answers what JAX's answers on the same root. The other roles
build a Llama (ROADMAP item 2(b)), also in the scan layout
(``--scan-blocks``, item 2(e)).
"""

import dataclasses
import json
import logging
import os
import socket
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtraining_tpu.engine import kv_transfer as jkvt
from distributedtraining_tpu.engine import serve as jserve
from distributedtraining_tpu.engine import speculative as jspec
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.models import llama as jl
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu_torch import models
from distributedtraining_tpu_torch.config import RunConfig
from distributedtraining_tpu_torch.engine import kv_transfer as kvt
from distributedtraining_tpu_torch.engine import serve as tserve
from distributedtraining_tpu_torch.engine import speculative as tspec
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.models import llama as tl
from distributedtraining_tpu_torch.transport import LocalFSTransport
from distributedtraining_tpu_torch.transport import base as tbase

# JAX tests/test_serve.py::test_llama_gqa_parity's configuration
LCFG = tl.LlamaConfig(vocab_size=128, max_seq_len=64, n_embd=32, n_layer=2,
                      n_head=4, n_kv_head=2, intermediate_size=64,
                      remat=False, dtype="float32", vocab_multiple=64)
JLCFG = jl.LlamaConfig(vocab_size=128, max_seq_len=64, n_embd=32,
                       n_layer=2, n_head=4, n_kv_head=2,
                       intermediate_size=64, remat=False, dtype="float32",
                       vocab_multiple=64)
# a GPT-2 drafter over the same real vocabulary
DCFG = dataclasses.replace(tg.PRESETS["tiny"], vocab_size=128,
                           n_positions=64, n_embd=32, dtype="float32",
                           vocab_multiple=64)
JDCFG = dataclasses.replace(jg.PRESETS["tiny"], vocab_size=128,
                            n_positions=64, n_embd=32, dtype="float32",
                            vocab_multiple=64)
P = 8
GEN = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sharpened_llama(cfg, seed):
    """Dense kernels x10: generations then depend on the context."""
    tree = tl.init_params_numpy(cfg, seed)
    for key, block in tree.items():
        if key.startswith("layer_"):
            for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                         "w_down"):
                block[name]["kernel"] *= 10.0
    return tree


def sharpened_gpt2(cfg, seed):
    tree = tg.init_params_numpy(cfg, seed)
    for key, block in tree.items():
        if key.startswith("h_"):
            for name in ("c_attn", "c_proj", "c_fc", "mlp_proj"):
                block[name]["kernel"] *= 10.0
    tree["wpe"] *= 10.0
    return tree


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def world():
    tree = sharpened_llama(LCFG, 3)
    rng = np.random.RandomState(1)
    sys_p = [int(t) for t in rng.randint(0, LCFG.vocab_size, size=12)]
    # a shared system prompt (one whole page and a half) and ragged
    # suffixes; the last prompt is the first page alone plus two tokens
    prompts = [sys_p + [int(t) for t in rng.randint(0, LCFG.vocab_size,
                                                    size=n)]
               for n in (3, 9, 1, 5)] + [sys_p[:8] + [3, 4]]
    return {"tree": tree, "jmodel": jl.make_model(JLCFG)[0],
            "tmodel": models.make_model(LCFG)[0],
            "jparams": _jtree(tree),
            "state": models.params_from_numpy(tree, device="cpu"),
            "prompts": prompts}


def _serve(eng, prompts, sampled, n=GEN, **kw):
    """Every prompt submitted at once (odd lanes sampled when
    ``sampled``), the engine stepped until all are done."""
    reqs = [eng.submit(p, n, temperature=(0.8 if sampled and i % 2
                                          else 0.0), top_p=0.9, seed=i,
                       **kw.get("per_req", [{}] * len(prompts))[i])
            for i, p in enumerate(prompts)]
    for _ in range(5000):
        if all(r.done_evt.is_set() for r in reqs):
            break
        eng.step()
    return reqs


def _tokens(reqs):
    return [list(r.tokens) for r in reqs]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_engine_matches_jax_engine(world, sampled):
    """Greedy and seeded sampled lanes, prefix cache on, three slots for
    five requests: the port emits the JAX engine's tokens with its prefix
    hits; greedy lanes are also JAX's ``reference_generate``'s and the
    port's own oracle's; the pool stores n_kv_head heads."""
    kw = dict(max_slots=3, page_size=P, prefix_cache=True)
    jeng = jserve.GenerationEngine(world["jmodel"], world["jparams"], **kw)
    try:
        ref = _tokens(_serve(jeng, world["prompts"], sampled))
        jhits = (jeng.prefix_hits, jeng.prefix_misses,
                 jeng.prefix_tokens_saved)
    finally:
        jeng.close()
    eng = tserve.GenerationEngine(world["tmodel"], world["state"],
                                  device="cpu", debug_invariants=True, **kw)
    try:
        out = _tokens(_serve(eng, world["prompts"], sampled))
        hits = (eng.prefix_hits, eng.prefix_misses,
                eng.prefix_tokens_saved)
        assert eng.suffix_prefills == eng.prefix_hits > 0
        assert eng._kv[0].shape == (LCFG.n_layer, eng.pool_pages, P,
                                    LCFG.n_kv_head, LCFG.head_dim)
        assert eng.max_seq_len == LCFG.max_seq_len
    finally:
        eng.close()
    assert out == ref and hits == jhits
    for i, p in enumerate(world["prompts"]):
        if sampled and i % 2:
            continue
        oracle = jserve.reference_generate(world["jmodel"],
                                           world["jparams"], p, GEN)
        assert out[i] == oracle
        assert tserve.reference_generate(world["tmodel"], world["state"],
                                         p, GEN) == oracle
    # the sampled lanes are not the greedy ones
    if sampled:
        greedy = tserve.GenerationEngine(world["tmodel"], world["state"],
                                         device="cpu", **kw)
        try:
            plain = _tokens(_serve(greedy, world["prompts"], False))
        finally:
            greedy.close()
        assert any(out[i] != plain[i] for i in (1, 3))


# ---------------------------------------------------------------------------
# A GPT-2 drafter for a Llama target
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_gpt2_drafter_for_a_llama_target_matches_jax(world, sampled):
    """A GPT-2 drafter over the Llama's real vocabulary (its own KV pool
    of GPT-2 geometry) drafts for the Llama target: the streams, the
    proposals, acceptances and verify rounds equal JAX's speculative
    engine's, and the streams equal spec-off."""
    dtree = sharpened_gpt2(DCFG, 11)
    kw = dict(max_slots=2, page_size=P, prefix_cache=True, draft_k=3)
    jd = jspec.DraftEngine(jg.make_model(JDCFG)[0], _jtree(dtree),
                           max_slots=2, page_size=P)
    jeng = jserve.GenerationEngine(world["jmodel"], world["jparams"],
                                   draft=jd, **kw)
    try:
        ref = _tokens(_serve(jeng, world["prompts"], sampled))
        jacc = (jeng._spec_proposed, jeng._spec_accepted, jeng.spec_rounds)
    finally:
        jeng.close()
    dmodel = models.make_model(DCFG)[0]
    assert tspec.compat_reason(dmodel, LCFG) is None
    td = tspec.DraftEngine(dmodel, models.params_from_numpy(
        dtree, device="cpu"), device="cpu", max_slots=2, page_size=P)
    eng = tserve.GenerationEngine(world["tmodel"], world["state"],
                                  device="cpu", draft=td,
                                  debug_invariants=True, **kw)
    try:
        out = _tokens(_serve(eng, world["prompts"], sampled))
        acc = (eng._spec_proposed, eng._spec_accepted, eng.spec_rounds)
        assert eng.verify_dispatches == eng.spec_rounds > 0
        assert eng.spec_fallbacks == 0 and td.step_dispatches > 0
        assert td._kv[0].shape[-2:] == (DCFG.n_head, DCFG.head_dim)
    finally:
        eng.close()
    assert out == ref and acc == jacc and acc[0] > 0
    plain = tserve.GenerationEngine(world["tmodel"], world["state"],
                                    device="cpu", max_slots=2, page_size=P)
    try:
        assert _tokens(_serve(plain, world["prompts"], sampled)) == out
    finally:
        plain.close()


def test_drafter_of_another_vocabulary_is_refused(world):
    """A GPT-2 drafter whose real vocabulary is not the target's: the
    reason is JAX's, and the engine refuses it; the server's
    ``--draft-repo`` resolves a preset of either family."""
    other = dataclasses.replace(DCFG, vocab_size=96)
    reason = tspec.compat_reason(models.make_model(other)[0], LCFG)
    assert reason is not None and reason == jspec.compat_reason(
        jg.make_model(dataclasses.replace(JDCFG, vocab_size=96))[0], JLCFG)
    with pytest.raises(ValueError, match="incompatible draft"):
        tserve.GenerationEngine(
            world["tmodel"], world["state"], device="cpu",
            draft=tspec.DraftEngine(models.make_model(other)[0],
                                    device="cpu"))
    # a Llama drafter for a GPT-2 target, both families' rule the same
    assert tspec.compat_reason(models.make_model("tiny-llama")[0],
                               tg.PRESETS["tiny"]) is None


# ---------------------------------------------------------------------------
# Disaggregated workers
# ---------------------------------------------------------------------------

def _kv_files(root):
    d = os.path.join(root, "deltas")
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.startswith("__kv__.")}


def _pair(make, transport_cls, kvmod, root, world_params, model):
    tr = transport_cls(root)
    pe = make(model, world_params, phase="prefill",
              kv_exporter=kvmod.KVExporter(tr))
    de = make(model, world_params, phase="decode",
              kv_adopter=kvmod.KVAdopter(tr))
    return pe, de


def _hop(pe, de, prompts, sampled):
    ids = [{"request_id": f"rq-llama-{i}"} for i in range(len(prompts))]
    pre = _serve(pe, prompts, sampled, per_req=ids)
    assert all(r.status == "prefilled" for r in pre)
    dec = _serve(de, prompts, sampled, per_req=[
        {"kv_ref": r.kv_ref, "first_token": r.first_token} for r in pre])
    return pre, _tokens(dec)


def test_disaggregated_pages_equal_jax_byte_for_byte(world, tmp_path):
    """A port prefill worker and a JAX one (prefix cache on, the same
    request ids) on their own LocalFS roots: each decode worker adopts
    every request with no re-prefill and emits the unified engine's
    tokens. The exports agree page for page: as many page files, each
    manifest's fields (request, revision, prompt length, first token,
    the Hkv-wide geometry, page sizes) equal, and each page's bytes are
    what the other package's codec writes for its arrays (the manifests
    too). The K/V values agree within 1e-5, not in every bit: XLA's and
    torch's CPU GEMMs sum in different orders, so the f32 pages' digests
    differ (rows past the prompt are the padded prefill's, never read).
    Then the mixed pairs over one root: a JAX decode worker
    adopts the port's pages, and the port's decode worker JAX's."""
    kw = dict(max_slots=3, page_size=P, prefix_cache=True, revision="r1")

    def port_engine(model, params, **k):
        return tserve.GenerationEngine(model, params, device="cpu",
                                       debug_invariants=True, **kw, **k)

    def jax_engine(model, params, **k):
        return jserve.GenerationEngine(model, params, **kw, **k)

    uni = port_engine(world["tmodel"], world["state"])
    try:
        ref = _tokens(_serve(uni, world["prompts"], True))
    finally:
        uni.close()
    roots = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    outs, refs = {}, {}
    for name, make, tcls, kvmod, params, model in (
            ("port", port_engine, LocalFSTransport, kvt, world["state"],
             world["tmodel"]),
            ("jax", jax_engine, JFS, jkvt, world["jparams"],
             world["jmodel"])):
        pe, de = _pair(make, tcls, kvmod, roots[name], params, model)
        try:
            pre, outs[name] = _hop(pe, de, world["prompts"], True)
            refs[name] = [r.kv_ref for r in pre]
            n = len(world["prompts"])
            assert (pe.kv_exported, de.kv_adopted, de.kv_reprefills) == \
                (n, n, 0)
        finally:
            pe.close()
            de.close()
    assert outs["port"] == outs["jax"] == ref
    files = {k: _kv_files(r) for k, r in roots.items()}
    n_pages = [sum(f.startswith("__kv__.s.") for f in files[k])
               for k in roots]
    assert n_pages[0] == n_pages[1] > len(world["prompts"])   # deduped
    stores = {k: LocalFSTransport(r) for k, r in roots.items()}
    for ref_p, ref_j in zip(refs["port"], refs["jax"]):
        raw = {k: tbase.fetch_kv_manifest_bytes(stores[k], r)
               for k, r in (("port", ref_p), ("jax", ref_j))}
        man = {k: kvt.parse_kv_manifest(v) for k, v in raw.items()}
        assert jkvt.build_kv_manifest(**{
            k: v for k, v in man["port"].items()}) == raw["port"]
        assert kvt.build_kv_manifest(**man["jax"]) == raw["jax"]
        fields = [{k: v for k, v in m.items() if k != "pages"}
                  for m in man.values()]
        assert fields[0] == fields[1]
        assert fields[0]["geometry"] == {
            "layers": LCFG.n_layer, "page_size": P,
            "kv_heads": LCFG.n_kv_head, "head_dim": LCFG.head_dim,
            "dtype": "float32"}
        assert [n for _, n in man["port"]["pages"]] == \
            [n for _, n in man["jax"]["pages"]]
        plen = fields[0]["prompt_len"]
        for i, ((hp, _), (hj, _)) in enumerate(zip(man["port"]["pages"],
                                                   man["jax"]["pages"])):
            rows = min(P, plen - i * P)   # the rest: padding, never read
            bp = tbase.fetch_kv_page(stores["port"], hp)
            bj = tbase.fetch_kv_page(stores["jax"], hj)
            kp, vp = kvt.unpack_kv_page(bp)
            kj, vj = kvt.unpack_kv_page(bj)
            assert kp.shape == (LCFG.n_layer, P, LCFG.n_kv_head,
                                LCFG.head_dim)
            assert jkvt.pack_kv_page(kp.numpy(), vp.numpy()) == bp
            assert kvt.pack_kv_page(kj, vj) == bj
            np.testing.assert_allclose(kp[:, :rows].numpy(),
                                       kj[:, :rows].numpy(), rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(vp[:, :rows].numpy(),
                                       vj[:, :rows].numpy(), rtol=0,
                                       atol=1e-5)
    # mixed pairs over one root, both ways
    for prefill_pkg in ("jax", "port"):
        root = str(tmp_path / f"mixed_{prefill_pkg}")
        jt, tt = JFS(root), LocalFSTransport(root)
        if prefill_pkg == "jax":
            pe = jax_engine(world["jmodel"], world["jparams"],
                            phase="prefill", kv_exporter=jkvt.KVExporter(jt))
            de = port_engine(world["tmodel"], world["state"],
                             phase="decode", kv_adopter=kvt.KVAdopter(tt))
        else:
            pe = port_engine(world["tmodel"], world["state"],
                             phase="prefill", kv_exporter=kvt.KVExporter(tt))
            de = jax_engine(world["jmodel"], world["jparams"],
                            phase="decode", kv_adopter=jkvt.KVAdopter(jt))
        try:
            _, out = _hop(pe, de, world["prompts"], True)
            assert out == ref
            assert (de.kv_adopted, de.kv_reprefills) == \
                (len(world["prompts"]), 0)
        finally:
            pe.close()
            de.close()


@pytest.mark.parametrize("router_pkg", ["torch", "jax"])
def test_router_routes_llama_workers_in_two_legs(world, router_pkg):
    """Llama workers (unified, prefill, decode; the port's engines behind
    their HTTP frontends, the KV over one transport) behind either
    package's router, which is family-blind: the request goes /prefill
    then /generate, the decode worker adopts the Hkv-wide pages, and the
    answer is JAX's ``reference_generate``'s."""
    from distributedtraining_tpu.engine import router as jrouter
    from distributedtraining_tpu_torch.engine import router as trouter
    from distributedtraining_tpu_torch.transport import InMemoryTransport
    tr = InMemoryTransport()
    engines, loops, fes, urls = [], [], [], []
    for phase in ("unified", "prefill", "decode"):
        kw = {"phase": phase}
        if phase == "prefill":
            kw["kv_exporter"] = kvt.KVExporter(tr)
        if phase == "decode":
            kw["kv_adopter"] = kvt.KVAdopter(tr)
        eng = tserve.GenerationEngine(world["tmodel"], world["state"],
                                      device="cpu", revision="r1",
                                      max_slots=2, page_size=P, **kw)
        loops.append(tserve.ServeLoop(eng, idle_poll_s=0.02).start())
        fe = tserve.ServeHTTPFrontend(eng, 0, timeout_s=60.0)
        urls.append(f"http://127.0.0.1:{fe.start()}")
        engines.append(eng)
        fes.append(fe)
    mod = trouter if router_pkg == "torch" else jrouter
    router = mod.RouterHTTPFrontend(urls, 0, poll_interval_s=30.0,
                                    timeout_s=60.0)
    try:
        router.refresh()
        port = router.start()
        prompt = world["prompts"][1]
        out = _post(port, {"tokens": prompt, "max_new_tokens": GEN})
        assert out["tokens"] == jserve.reference_generate(
            world["jmodel"], world["jparams"], prompt, GEN)
        assert (out["prefill_backend"], out["backend"]) == (urls[1],
                                                            urls[2])
        uni, pre, dec = engines
        assert (pre.kv_exported, dec.kv_adopted, dec.kv_reprefills,
                uni.tokens_emitted) == (1, 1, 0, 0)
        assert dec._kv[0].shape[-2] == LCFG.n_kv_head
    finally:
        router.close()
        for x in fes + loops + engines:
            x.close()


# ---------------------------------------------------------------------------
# The server CLI and the roles' refusals
# ---------------------------------------------------------------------------

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


def _cli_answers(main, work, bodies):
    """``main`` (either package's server CLI) on a thread over ``work``
    with ``--model tiny-llama`` and the JAX defaults otherwise: the
    answers to ``bodies`` posted one after another, and its exit code
    once it idles out (after two swap polls of 3 s: under a loaded
    machine a shorter idle window can close the server between its
    /healthz and the first request)."""
    port = _free_port()
    rc = {}
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    th = threading.Thread(target=lambda: rc.setdefault("rc", main([
        "--backend", "local", "--work-dir", work, "--model", "tiny-llama",
        "--dataset", "synthetic", "--tokenizer", "word",
        "--serve-port", str(port), "--swap-poll", "3",
        "--max-steps", "100000", "--flight-events", "0"])),
        name="test-llama-server", daemon=True)
    th.start()
    try:
        for _ in range(1200):
            try:
                hz = _get(port, "/healthz")
                break
            except OSError:
                time.sleep(0.05)
        assert hz["ok"]
        outs = [_post(port, b) for b in bodies]
    finally:
        th.join(timeout=120)
        root.handlers[:], root.level = handlers, level
    assert not th.is_alive() and rc["rc"] == 0
    return outs, hz


def test_server_cli_serves_tiny_llama_as_jax_does(world, tmp_path,
                                                  monkeypatch):
    """``--model tiny-llama``: both packages' server CLIs over one LocalFS
    root, whose base the port published sharded (the monolithic file,
    then the shard set and manifest): the same revision, the same greedy
    answers at the preset's bf16 compute, prefix hits on the shared
    prompt, and the port's base pulled through the manifest."""
    from neurons import server as jcli
    from distributedtraining_tpu_torch.engine.basedist import BasePublisher
    from distributedtraining_tpu_torch.neurons import server as tcli
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    cfg = tl.PRESETS["tiny-llama"]
    tree = sharpened_llama(cfg, 5)
    work = str(tmp_path / "run")
    t = LocalFSTransport(os.path.join(work, "artifacts"))
    rev = t.publish_base(tree)
    assert BasePublisher(t).publish_revision(tree, rev)
    rng = np.random.RandomState(6)
    sys_p = [int(x) for x in rng.randint(0, cfg.vocab_size, 20)]
    bodies = [{"tokens": sys_p + s, "max_new_tokens": GEN}
              for s in ([1, 2], [3], [7, 8, 9])]
    fetched = []
    real_fetch = tserve.BaseRevisionWatcher.poll_once

    def poll(w):
        out = real_fetch(w)
        if w.fetcher is not None:
            fetched.append((w.fetcher.sharded_fetches_total,
                            w.fetcher.fallbacks_total))
        return out
    monkeypatch.setattr(tserve.BaseRevisionWatcher, "poll_once", poll)
    ours, hz = _cli_answers(tcli.main, work, bodies)
    theirs, jhz = _cli_answers(jcli.main, work, bodies)
    assert [o["tokens"] for o in ours] == [o["tokens"] for o in theirs]
    assert all(o["revision"] == rev and o["status"] == "done"
               for o in ours + theirs)
    assert hz["revision"] == jhz["revision"] == rev
    assert fetched and fetched[0] == (1, 0)       # sharded, no fallback
    # the port's engine and JAX's agree on the same prompts offline too
    eng = tserve.GenerationEngine(models.make_model(cfg)[0],
                                  models.params_from_numpy(tree, device="cpu"),
                                  device="cpu", prefix_cache=True)
    try:
        assert [eng.generate([b["tokens"]], GEN)[0] for b in bodies] == \
            [o["tokens"] for o in ours]
        assert eng.prefix_hits == 2
    finally:
        eng.close()


@pytest.mark.parametrize("role", ["miner", "validator", "averager"])
def test_other_roles_refuse_a_llama(role, monkeypatch, tmp_path):
    """The miner, the validator and the averager build on a Llama preset
    (item 2(b)): the model and the engine's one-device route; with
    ``--scan-blocks`` (item 2(e)) the model stacks its blocks under
    ``layers.block`` and the engine's specs lead with the layer axis."""
    from distributedtraining_tpu_torch.neurons.common import build
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    base = ["--model", "tiny-llama", "--dataset", "synthetic",
            "--tokenizer", "word", "--backend", "memory",
            "--work-dir", str(tmp_path)]
    c = build(RunConfig.from_args(role, base))
    assert isinstance(c.model, tl.Llama)
    assert c.model_cfg == tl.PRESETS["tiny-llama"]
    assert c.engine.mesh is None and c.engine.model is c.model
    c = build(RunConfig.from_args(role, base + ["--scan-blocks"]))
    assert c.model_cfg.scan_blocks and isinstance(c.model.layers,
                                                  tg.BlockScan)
    assert c.model.state_dict()["layers.block.wq.kernel"].shape[0] == \
        tl.PRESETS["tiny-llama"].n_layer


def test_server_builds_a_llama_and_refuses_what_stays_out(monkeypatch,
                                                          tmp_path):
    """The server's build takes either family (the TrainEngine it builds
    reads a Llama's missing dropout as 0), also with ``--scan-blocks``
    (item 2(e): the serving engine rebuilds the blocks unrolled, and the
    model itself refuses generation), and an unknown preset names the
    presets."""
    from distributedtraining_tpu_torch.neurons.common import build
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    base = ["--model", "tiny-llama", "--dataset", "synthetic",
            "--tokenizer", "word", "--backend", "memory",
            "--work-dir", str(tmp_path)]
    c = build(RunConfig.from_args("server", base))
    assert isinstance(c.model, tl.Llama) and c.model_cfg == \
        tl.PRESETS["tiny-llama"]
    c = build(RunConfig.from_args("server", base + ["--scan-blocks"]))
    assert c.model_cfg.scan_blocks
    with pytest.raises(ValueError, match="unrolled block layout"):
        c.model(torch.zeros((1, 4), dtype=torch.int64), sow_kv=True)
    with pytest.raises(NotImplementedError, match="llama3-8b"):
        build(RunConfig.from_args("server", ["--model", "llama-70b"]))
