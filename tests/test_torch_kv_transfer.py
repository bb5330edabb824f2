"""Disaggregated prefill/decode serving of the PyTorch port (engine/
kv_transfer.py, the ``phase=`` workers of engine/serve.py, the frontend's
``/prefill``) against the JAX package's, on the CPU at the tiny preset in
f32.

The wire is held byte for byte: a page's bytes and a manifest's bytes
equal the JAX package's for the same arrays, so digests are
interchangeable, and the port's parser refuses what the JAX one refuses.
The spine is cross-worker identity: a request prefilled on one worker
and decoded on another emits exactly the unified engine's tokens (greedy
and sampled lanes; the port's unified engine and the JAX package's), with
every adoption counted (``kv_adopted == n``, ``kv_reprefills == 0``):
a degrade to the local prefill gives the same tokens, so a token check
alone would not see a failed adoption. Mixed pairs run both ways over
one LocalFS root. Every degrade (absent or torn manifest, hash miss,
geometry skew, another base revision) is counted and leaves the output
unchanged.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distributedtraining_tpu.engine import kv_transfer as jkvt
from distributedtraining_tpu.engine import serve as jserve
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.transport import InMemoryTransport as JMem
from distributedtraining_tpu.transport import LocalFSTransport as JLocalFS
from distributedtraining_tpu_torch.engine import kv_transfer as kvt
from distributedtraining_tpu_torch.engine import serve as tserve
from distributedtraining_tpu_torch.engine import speculative as tspec
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.transport import (InMemoryTransport,
                                                     LocalFSTransport)
from distributedtraining_tpu_torch.transport import base as tbase
from distributedtraining_tpu_torch.utils import obs

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
P = 8
GEN = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sharpened(cfg, seed):
    """Dense kernels and positions x10, so generations depend on the
    context."""
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
    rng = np.random.RandomState(0)
    # page boundaries straddled: 8 and 16 exactly, 9 and 17 one past
    prompts = [[int(t) for t in rng.randint(0, TINY.vocab_size, size=n)]
               for n in (5, 9, 16, 17, 3)]
    jmodel, _ = jg.make_model(JTINY)
    tmodel, _ = tg.make_model(TINY)
    w = {"tmodel": tmodel, "jmodel": jmodel, "prompts": prompts,
         "state": tg.params_from_numpy(tree, device="cpu"),
         "jparams": jax.tree_util.tree_map(jnp.asarray, tree)}
    w["refs"] = [jserve.reference_generate(jmodel, w["jparams"], p, GEN)
                 for p in prompts]
    return w


@pytest.fixture()
def metrics():
    obs.configure()
    try:
        yield obs.registry()
    finally:
        obs.reset()


def engine(world, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("page_size", P)
    kw.setdefault("revision", "r1")
    return tserve.GenerationEngine(world["tmodel"], world["state"],
                                   device="cpu", debug_invariants=True, **kw)


def jengine(world, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("page_size", P)
    kw.setdefault("revision", "r1")
    return jserve.GenerationEngine(world["jmodel"], world["jparams"], **kw)


def pair(world, transport=None, *, decode_revision="r1", **dec_kw):
    tr = transport if transport is not None else InMemoryTransport()
    pe = engine(world, phase="prefill", kv_exporter=kvt.KVExporter(tr))
    de = engine(world, phase="decode", kv_adopter=kvt.KVAdopter(tr),
                revision=decode_revision, **dec_kw)
    return tr, pe, de


def drain(eng, reqs):
    for _ in range(5000):
        if all(r.done_evt.is_set() for r in reqs):
            return [list(r.tokens) for r in reqs]
        eng.step()
    raise AssertionError("engine did not drain")


def hop(pe, de, prompts, n=GEN, **sampling):
    """Prefill on ``pe``, hand ``(kv_ref, first_token)`` to ``de``."""
    pre = [pe.submit(p, n, request_id=f"rq-hop-{i}", **sampling)
           for i, p in enumerate(prompts)]
    drain(pe, pre)
    dec = [de.submit(p, n, kv_ref=r.kv_ref, first_token=r.first_token,
                     **sampling) for p, r in zip(prompts, pre)]
    return pre, drain(de, dec)


def close(*engines):
    for e in engines:
        e.close()


# ---------------------------------------------------------------------------
# The wire, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_bytes_equal_jax(dtype):
    """The same K/V page packs to the same bytes (so the same sha256) in
    both packages, at f32 and bf16; each side decodes the other's."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, P, 4, 16), dtype=np.float32)
    v = rng.standard_normal((2, P, 4, 16), dtype=np.float32)
    if dtype == "bfloat16":
        jk, jv = (np.asarray(x.astype(ml_dtypes.bfloat16)) for x in (k, v))
        tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
    else:
        jk, jv, tk, tv = k, v, torch.from_numpy(k), torch.from_numpy(v)
    ours = kvt.pack_kv_page(tk, tv)
    theirs = jkvt.pack_kv_page(jk, jv)
    assert ours == theirs
    back = kvt.unpack_kv_page(theirs)
    assert back[0].dtype == tk.dtype and torch.equal(back[0], tk)
    assert torch.equal(back[1], tv)
    jback = jkvt.unpack_kv_page(ours)
    assert str(jback[0].dtype) == dtype == kvt.dtype_name(back[0])
    np.testing.assert_array_equal(np.asarray(jback[1], np.float32),
                                  tv.float().numpy())


def test_page_codec_rejects_as_jax_does():
    rng = np.random.default_rng(1)
    k = torch.from_numpy(rng.standard_normal((2, P, 2, 16),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((2, P, 2, 16),
                                             dtype=np.float32))
    data = kvt.pack_kv_page(k, v)
    for bad in (b"not msgpack", kvt.pack_kv_page(k, v[:, :4]),
                kvt.pack_kv_page(k[0], v[0]),
                kvt.pack_kv_page(k, v.to(torch.bfloat16))):
        assert kvt.unpack_kv_page(bad) is None
        assert jkvt.unpack_kv_page(bad) is None
    assert kvt.unpack_kv_page(data, max_bytes=16) is None
    assert kvt.unpack_kv_page(data) is not None


GEOM = {"layers": 2, "page_size": P, "kv_heads": 4, "head_dim": 16,
        "dtype": "float32"}


def test_manifest_bytes_equal_jax():
    kw = dict(request_id="rq-1.a/b", revision="r1",
              pages=[("ab" * 32, 4096), ("cd" * 32, 4097)], geometry=GEOM,
              prompt_len=11, first_token=7)
    ours = kvt.build_kv_manifest(**kw)
    assert ours == jkvt.build_kv_manifest(**kw)
    want = {**kw, "pages": kw["pages"]}
    assert kvt.parse_kv_manifest(ours) == jkvt.parse_kv_manifest(ours) \
        == want
    assert tbase.kv_manifest_id("rq-1.a/b") == "__kv__.rq-1%2Ea%2Fb"
    assert tbase.kv_page_id("ab" * 32) == "__kv__.s." + "ab" * 32
    assert tbase.is_kv_id("__kv__.x") and tbase.is_reserved_id("__kv__.x")


def _hostile_manifests():
    good = kvt.build_kv_manifest(request_id="rq-1", revision="r1",
                                 pages=[("ab" * 32, 128)], geometry=GEOM,
                                 prompt_len=5, first_token=7)
    body = json.loads(good[len(kvt.KV_MANIFEST_MAGIC):])

    def with_(**patch):
        b = json.loads(json.dumps(body))
        for k, v in patch.items():
            if k.startswith("geometry."):
                b["geometry"][k.split(".", 1)[1]] = v
            else:
                b[k] = v
        return kvt.KV_MANIFEST_MAGIC + json.dumps(b).encode()

    return {
        "bad_magic": b"XX" + good[2:],
        "truncated": good[:-3],
        "bad_digest": good.replace(b"ab" * 32, b"zz" * 32),
        "zero_pages": with_(pages=[]),
        "not_bytes": "DTKV1\n{}",
        "oversize": good + b" " * kvt.KV_MANIFEST_MAX_BYTES,
        "format_2": with_(format=2),
        "empty_request_id": with_(request_id=""),
        "prompt_len_0": with_(prompt_len=0),
        "prompt_len_bool": with_(prompt_len=True),
        "first_token_negative": with_(first_token=-1),
        "geometry_extra_key": with_(**{"geometry.extra": 1}),
        "geometry_zero_layers": with_(**{"geometry.layers": 0}),
        "geometry_dtype_not_str": with_(**{"geometry.dtype": 4}),
        "page_size_zero": with_(pages=[{"h": "ab" * 32, "n": 0}]),
        "page_extra_key": with_(pages=[{"h": "ab" * 32, "n": 1, "x": 0}]),
        "page_oversize": with_(pages=[{"h": "ab" * 32,
                                       "n": kvt.KV_PAGE_MAX_BYTES + 1}]),
        "too_many_pages": with_(pages=[{"h": "ab" * 32, "n": 1}]
                                * (kvt.KV_MAX_PAGES + 1)),
    }


@pytest.mark.parametrize("name", sorted(_hostile_manifests()))
def test_parser_rejects_every_hostile_manifest(name):
    """Every defect the JAX codec test plants (and more) reads as no
    transfer in both parsers, never an exception."""
    data = _hostile_manifests()[name]
    assert jkvt.parse_kv_manifest(data) is None
    assert kvt.parse_kv_manifest(data) is None


def test_page_store_lru_matches_jax():
    """The same puts and lookups on both stores evict the same digests
    and hold the same byte count."""
    rng = np.random.default_rng(2)
    pages = [rng.standard_normal((2, 4, 2, 8), dtype=np.float32)
             for _ in range(6)]
    cap = 3 * 2 * pages[0].nbytes
    ours, theirs = kvt.KVPageStore(cap), jkvt.KVPageStore(cap)
    script = [("put", 0), ("put", 1), ("get", 0), ("put", 2), ("put", 3),
              ("put", 1), ("get", 2), ("put", 4), ("put", 5), ("get", 0)]
    for op, i in script:
        d = f"{i:064x}"
        if op == "put":
            ours.put(d, torch.from_numpy(pages[i]), torch.from_numpy(pages[i]))
            theirs.put(d, pages[i], pages[i])
        else:
            assert (ours.lookup(d) is None) == (theirs.lookup(d) is None)
        assert list(ours._entries) == list(theirs._entries)
        assert ours.nbytes == theirs.nbytes and len(ours) == len(theirs)
    with pytest.raises(ValueError):
        kvt.KVPageStore(0)


# ---------------------------------------------------------------------------
# Cross-worker identity
# ---------------------------------------------------------------------------

def test_greedy_cross_worker_identity_and_pool_audit(world, metrics):
    """Prefill on one worker, decode on another: the tokens of the JAX
    oracle, of the port's unified engine and of the JAX pair; every
    request adopted, the pool audited each step and whole again at the
    end."""
    uni = engine(world)
    try:
        assert uni.generate(world["prompts"], GEN) == world["refs"]
    finally:
        uni.close()
    tr, pe, de = pair(world)
    try:
        pre, out = hop(pe, de, world["prompts"])
        assert out == world["refs"]
        n = len(world["prompts"])
        assert (pe.kv_exported, de.kv_adopted, de.kv_reprefills,
                de.kv_rev_mismatch) == (n, n, 0, 0)
        assert all(r.status == "prefilled" and r.kv_ref and r.tokens ==
                   [r.first_token] for r in pre)
        assert pe.pool.free == pe.pool.total      # nothing held after export
        de.pool.check({})
        assert de.pool.free == de.pool.total
        assert metrics.counter("serve.kv_adoptions").value == n
        assert metrics.counter("serve.kv_exports").value == n
    finally:
        close(pe, de)
    jt = JMem()   # the JAX pair over its own transport
    jpe = jengine(world, phase="prefill", kv_exporter=jkvt.KVExporter(jt))
    jde = jengine(world, phase="decode", kv_adopter=jkvt.KVAdopter(jt))
    try:
        _, jout = hop(jpe, jde, world["prompts"])
        assert jout == out and jde.kv_adopted == n
    finally:
        close(jpe, jde)


def test_sampled_cross_worker_identity(world, metrics):
    """Sampled lanes survive the hop token for token: index 0 drawn on
    the prefill worker, 1.. on the decode worker, the same keys as the
    unified engine's, in both packages."""
    sampling = {"temperature": 0.8, "top_p": 0.9, "seed": 23}
    uni = engine(world)
    juni = jengine(world)
    try:
        ref = uni.generate(world["prompts"], GEN, **sampling)
        assert ref == juni.generate(world["prompts"], GEN, **sampling)
    finally:
        close(uni, juni)
    tr, pe, de = pair(world)
    try:
        _, out = hop(pe, de, world["prompts"], **sampling)
        assert out == ref
        assert (de.kv_adopted, de.kv_reprefills) == (len(ref), 0)
    finally:
        close(pe, de)


@pytest.mark.parametrize("prefill_pkg", ["jax", "torch"])
def test_mixed_package_pairs_adopt(world, metrics, tmp_path, prefill_pkg):
    """A JAX prefill worker feeding a port decode worker, and the reverse,
    over one LocalFS root: each adopts every request (no re-prefill), and
    the tokens are the oracle's."""
    root = str(tmp_path / "artifacts")
    jt, tt = JLocalFS(root), LocalFSTransport(root)
    if prefill_pkg == "jax":
        pe = jengine(world, phase="prefill", kv_exporter=jkvt.KVExporter(jt))
        de = engine(world, phase="decode", kv_adopter=kvt.KVAdopter(tt))
    else:
        pe = engine(world, phase="prefill", kv_exporter=kvt.KVExporter(tt))
        de = jengine(world, phase="decode", kv_adopter=jkvt.KVAdopter(jt))
    try:
        _, out = hop(pe, de, world["prompts"])
        n = len(world["prompts"])
        assert out == world["refs"]
        assert (de.kv_adopted, de.kv_reprefills, de.kv_rev_mismatch) == \
            (n, 0, 0)
    finally:
        close(pe, de)


def test_speculative_decode_on_adopted_pages(world, metrics):
    """Drafting over adopted pages (a self-draft: every proposal
    accepted) stays lossless, with the pool audited each step."""
    draft = tspec.DraftEngine(world["tmodel"], world["state"], device="cpu",
                              max_slots=3, page_size=P)
    tr, pe, de = pair(world, draft=draft, draft_k=4)
    try:
        _, out = hop(pe, de, world["prompts"])
        assert out == world["refs"]
        assert (de.kv_adopted, de.kv_reprefills) == (len(out), 0)
        assert de.verify_dispatches > 0
        assert de.spec_accept_rate == pytest.approx(1.0)
    finally:
        close(pe, de)


def test_prefix_cache_on_both_workers(world, metrics):
    """With the prefix cache on both workers: the prefill worker runs
    suffix prefills (the window kernel's path) and its exports of the
    shared pages dedupe; the decode worker registers adopted pages, a
    sibling's first write into a shared page copies it first, and
    ``PagePool.check`` holds after every step."""
    rng = np.random.RandomState(3)
    shared = [int(t) for t in rng.randint(0, TINY.vocab_size, 20)]
    prompts = [shared + [int(t) for t in rng.randint(0, TINY.vocab_size,
                                                     n)] for n in (3, 9, 1)]
    refs = [jserve.reference_generate(world["jmodel"], world["jparams"], p,
                                      GEN) for p in prompts]
    tr = InMemoryTransport()
    pe = engine(world, phase="prefill", kv_exporter=kvt.KVExporter(tr),
                prefix_cache=True)
    de = engine(world, phase="decode", kv_adopter=kvt.KVAdopter(tr),
                prefix_cache=True)
    try:
        _, out = hop(pe, de, prompts)
        assert out == refs
        assert pe.suffix_prefills == len(prompts) - 1 and pe.prefix_hits
        assert (de.kv_adopted, de.kv_reprefills) == (len(prompts), 0)
        assert de.cow_copies >= 1
        # the cache holds the adopted pages (and only the cache)
        de._check_invariants()
        assert de.pool.free == de.pool.total - len(de._cache)
        assert metrics.counter("serve.kv_pages_deduped").value >= 2 * 2
    finally:
        close(pe, de)


# ---------------------------------------------------------------------------
# Degrades: counted, the output unchanged
# ---------------------------------------------------------------------------

def _prefilled(pe, prompt, rid):
    r = pe.submit(prompt, GEN, request_id=rid)
    drain(pe, [r])
    return r


@pytest.mark.parametrize("defect", ["absent", "torn_manifest", "hash_miss",
                                    "bad_page_bytes", "geometry",
                                    "revision"])
def test_each_degrade_is_counted_and_output_unchanged(world, metrics,
                                                     defect):
    prompt, ref = world["prompts"][1], world["refs"][1]
    tr, pe, de = pair(world, decode_revision=(
        "r2" if defect == "revision" else "r1"))
    try:
        r = _prefilled(pe, prompt, "rq-d")
        kv_ref, first = r.kv_ref, r.first_token
        man = kvt.parse_kv_manifest(tbase.fetch_kv_manifest_bytes(tr, "rq-d"))
        digest, nbytes = man["pages"][0]
        if defect == "absent":
            kv_ref = "rq-never-published"
        elif defect == "torn_manifest":
            tbase.publish_kv_manifest(tr, "rq-d", b"DTKV1\n{torn")
        elif defect == "hash_miss":
            tr._deltas[tbase.kv_page_id(digest)] = b"\x00" * nbytes
        elif defect == "bad_page_bytes":
            # right digest and size for bytes that are no page
            junk = b"\x01" * 64
            d2 = kvt.ser.shard_digest(junk)
            tbase.publish_kv_page(tr, d2, junk)
            tbase.publish_kv_manifest(tr, "rq-d", kvt.build_kv_manifest(
                request_id="rq-d", revision="r1",
                pages=[(d2, len(junk))] * len(man["pages"]),
                geometry=man["geometry"], prompt_len=man["prompt_len"],
                first_token=man["first_token"]))
        elif defect == "geometry":
            tbase.publish_kv_manifest(tr, "rq-d", kvt.build_kv_manifest(
                request_id="rq-d", revision="r1", pages=man["pages"],
                geometry={**man["geometry"], "dtype": "bfloat16"},
                prompt_len=man["prompt_len"],
                first_token=man["first_token"]))
        out = drain(de, [de.submit(prompt, GEN, kv_ref=kv_ref,
                                   first_token=first)])
        assert out == [ref]
        assert (de.kv_adopted, de.kv_reprefills) == (0, 1)
        assert de.kv_rev_mismatch == (1 if defect == "revision" else 0)
        assert de.full_prefills == 1
        assert metrics.counter("serve.kv_reprefills").value == 1
        de.pool.check({})
    finally:
        close(pe, de)


def test_shared_prefix_dedupes_wire_bytes(world, metrics):
    """Two prompts sharing two full pages: the second export sends only
    its own pages, and the adopter serves the shared ones from its store."""
    shared = [int(t) for t in
              np.random.RandomState(5).randint(0, TINY.vocab_size, 16)]
    prompts = [shared + [3], shared + [9]]
    tr, pe, de = pair(world)
    try:
        _, out = hop(pe, de, prompts)
        ex, ad = pe._kv_exporter, de._kv_adopter
        page_bytes = len(kvt.pack_kv_page(*(torch.zeros(
            2, P, TINY.n_head, TINY.n_embd // TINY.n_head),) * 2))
        assert ad.bytes_fetched == 4 * page_bytes   # 2 shared + 2 tails
        assert ex.bytes_published > 4 * page_bytes
        assert metrics.counter("serve.kv_pages_deduped").value == 2 + 2
        assert (de.kv_adopted, de.kv_reprefills) == (2, 0)
        assert out == [jserve.reference_generate(
            world["jmodel"], world["jparams"], p, GEN) for p in prompts]
    finally:
        close(pe, de)


def test_engine_validates_phases_as_jax_does(world):
    with pytest.raises(ValueError, match="kv_exporter"):
        engine(world, phase="prefill")
    with pytest.raises(ValueError, match="phase"):
        engine(world, phase="both")
    eng = engine(world)
    try:
        with pytest.raises(ValueError, match="first_token"):
            eng.submit([1, 2, 3], 4, kv_ref="rq-x")
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# The frontend
# ---------------------------------------------------------------------------

def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_frontend_prefill_route_and_phase_discipline(world, metrics):
    """POST /prefill on a prefill worker returns kv_ref, first_token and
    prompt_len (the JAX keys); /generate there is 409, and so is /prefill
    on a decode worker; /healthz names the phase and the kv counts; the
    decode worker's /generate with the ref emits the oracle's tokens."""
    tr, pe, de = pair(world)
    fes, loops = [], []
    try:
        ports = []
        for eng in (pe, de):
            loops.append(tserve.ServeLoop(eng, idle_poll_s=0.02).start())
            fe = tserve.ServeHTTPFrontend(eng, 0, timeout_s=60.0)
            ports.append(fe.start())
            fes.append(fe)
        prompt, ref = world["prompts"][3], world["refs"][3]
        leg1 = _post(ports[0], "/prefill", {"tokens": prompt,
                                            "max_new_tokens": GEN})
        assert leg1["status"] == "prefilled" and leg1["kv_ref"]
        assert leg1["first_token"] == ref[0]
        assert leg1["prompt_len"] == len(prompt)
        for port, path in ((ports[0], "/generate"), (ports[1], "/prefill")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(port, path, {"tokens": prompt})
            assert ei.value.code == 409
        out = _post(ports[1], "/generate", {
            "tokens": prompt, "max_new_tokens": GEN,
            "kv_ref": leg1["kv_ref"], "first_token": leg1["first_token"]})
        assert out["tokens"] == ref
        hz = [fe.healthz() for fe in fes]
        assert [(h["phase"], h["kv_exported"], h["kv_adopted"])
                for h in hz] == [("prefill", 1, 0), ("decode", 0, 1)]
    finally:
        for fe in fes:
            fe.close()
        for loop in loops:
            loop.close()
        close(pe, de)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 22's checkers, pinned on the CPU
# ---------------------------------------------------------------------------

def _chip_smoke():
    """chip_smoke.py as a module (it runs nothing on import)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _s6b_fixture():
    rng = np.random.default_rng(9)
    sys_p = [int(t) for t in rng.integers(0, TINY.vocab_size, 32)]
    prompts = [sys_p + [int(t) for t in rng.integers(0, TINY.vocab_size, n)]
               for n in (3, 9, 17, 1)]
    lanes = [(0.8, 0.9, 1000 + i) if i % 2 else (0.0, 1.0, 1000 + i)
             for i in range(len(prompts))]
    return _sharpened(TINY, 0), prompts, lanes


@pytest.mark.parametrize("fault", [None, "decode_keys_shifted"])
def test_card_disagg_parity_sees_a_key_fault(fault, monkeypatch):
    """Phase 22's f32 check on the tiny model: the healthy pair passes
    (every request adopted, greedy lanes identical, no differing token
    that is not a near-tie); with the decode worker's sampling keys
    shifted by one token (a planted fault), the sampled lanes part on
    rows that rank the kept tokens alike, and the check fails."""
    smoke = _chip_smoke()
    tree, prompts, lanes = _s6b_fixture()
    if fault:
        real = tserve.GenerationEngine._lanes

        def lanes_fn(eng, active, sb):
            temps, top_ps, seeds, tok_idx = real(eng, active, sb)
            return (temps, top_ps, seeds,
                    tok_idx + (1 if eng.phase == "decode" else 0))
        monkeypatch.setattr(tserve.GenerationEngine, "_lanes", lanes_fn)
        with pytest.raises(smoke.SmokeFailure, match="near-tie"):
            smoke._disagg_parity(TINY, tree, prompts, lanes, "cpu", new=8)
        return
    got = smoke._disagg_parity(TINY, tree, prompts, lanes, "cpu", new=8)
    assert got["greedy_identical"] and got["adopted"] == len(prompts)
    assert got["agreement"] == 1.0 and got["requests_parted"] == 0
    assert got["suffix_prefills"] == len(prompts) - 1


def test_card_planted_degrades_are_counted_and_restore():
    """Phase 22's planted torn page and revision skew on a library pair
    (prefix caches on, an in-memory transport): each is one counted
    re-prefill with the output unchanged, and the restored transfer
    adopts; a plant that is not undone would fail the restore check."""
    smoke = _chip_smoke()
    tree, prompts, lanes = _s6b_fixture()
    model, _ = tg.make_model(TINY)
    state = tg.params_from_numpy(tree, device="cpu")
    tr = InMemoryTransport()
    kw = dict(device="cpu", page_size=16, prefix_cache=True,
              debug_invariants=True, revision="r0")
    pe = tserve.GenerationEngine(model, state, phase="prefill",
                                 kv_exporter=kvt.KVExporter(tr), **kw)
    de = tserve.GenerationEngine(model, state, phase="decode",
                                 kv_adopter=kvt.KVAdopter(tr), **kw)

    def prefill(prompt):
        r = pe.submit(prompt, 8)
        drain(pe, [r])
        return r.kv_ref, r.first_token

    def decode(prompt, kv_ref, first):
        return drain(de, [de.submit(prompt, 8, kv_ref=kv_ref,
                                    first_token=first)])[0]

    try:
        hop(pe, de, prompts[:2])    # the shared prefix's pages adopted
        got = smoke._planted_degrades(tr, prefill, decode, de,
                                      prompts[2:], TINY.n_layer)
        assert set(got) == {"torn_page", "revision_skew"}
        assert (de.kv_reprefills, de.kv_rev_mismatch, de.kv_adopted) == \
            (2, 1, 4)
        # an undo that does nothing: the restored transfer cannot adopt
        real = smoke._plant_torn_page
        smoke._plant_torn_page = lambda t, ref: (real(t, ref), lambda: None)[1]
        with pytest.raises(smoke.SmokeFailure, match="restored"):
            smoke._planted_degrades(tr, prefill, decode, de,
                                    [prompts[2] + [7], prompts[3] + [7]],
                                    TINY.n_layer)
    finally:
        close(pe, de)
