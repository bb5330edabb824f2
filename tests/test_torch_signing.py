"""Signed artifacts in the port (utils/ed25519.py, utils/identity.py,
signing.py, transport/signed.py, the envelope-tolerant reads of
transport/localfs.py and engine/ingest.py, ``--sign-artifacts`` and
``--my-repo-id`` in neurons/common.py) against the JAX package, on the
CPU. ``cryptography`` (which the JAX identities use) is the Ed25519
oracle; the port never imports it.

- Keys and signatures byte-equal to ``cryptography``'s for seeded private
  seeds, a message given in chunks, and the same verdicts on tampered
  signatures, a non-canonical S and a public key off the curve.
- Wallet files that both packages read; envelopes byte-equal to JAX's
  ``signing.wrap``; each package unwraps the other's, with the same
  verdict text on every refusal.
- The port's counterparts of ``tests/test_signed_artifacts.py``: signed
  delta and base round trips and forgeries over both transports, unsigned
  and strict policies, a registered key that makes signatures mandatory,
  first-write-wins keys, a delta envelope replayed as a base, a replayed
  stale base, and an unsigned node that reads a signed fleet.
- The repair: a JAX-signed fleet read by an UNSIGNED port validator is
  scored as a JAX validator scores it (the port's localfs read an
  enveloped artifact as absent before).
- A mixed signed round both ways (a JAX miner merged by a port averager
  whose signed base a JAX reader verifies, and the reverse).
- The signed wire-v2 path pinned to the reference with the setup that
  ``tests/test_wire_v2.py::test_signed_transport_signs_manifest_and_
  passes_shards`` means (``Identity.generate()``, ``public_bytes`` a
  field): manifest enveloped, shards unsigned, decode equal to
  ``densify_packed_v2``, a forged unsigned manifest refused as
  ``no_delta``, both directions.
- The CLIs with ``--sign-artifacts`` and ``--my-repo-id``.
"""

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey, Ed25519PublicKey)

from distributedtraining_tpu import delta as jdl
from distributedtraining_tpu import serialization as jser
from distributedtraining_tpu import signing as jsign
from distributedtraining_tpu.chain import LocalAddressStore as JStore
from distributedtraining_tpu.chain import LocalChain as JChain
from distributedtraining_tpu.engine import train as jtrain
from distributedtraining_tpu.engine.average import AveragerLoop as JLoop
from distributedtraining_tpu.engine.average import WeightedAverage as JWA
from distributedtraining_tpu.engine.ingest import DeltaIngestor as JIngest
from distributedtraining_tpu.engine.publish import DeltaPublisher as JPub
from distributedtraining_tpu.engine.validate import Validator as JValidator
from distributedtraining_tpu.models import gpt2 as jg
from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu.transport.retry import RetryPolicy as JRetry
from distributedtraining_tpu.transport.signed import \
    SignedTransport as JSigned
from distributedtraining_tpu.utils.identity import Identity as JIdentity
from distributedtraining_tpu_torch import delta as tdl
from distributedtraining_tpu_torch import serialization as ser
from distributedtraining_tpu_torch import signing
from distributedtraining_tpu_torch.chain import LocalAddressStore, LocalChain
from distributedtraining_tpu_torch.data import datasets as tds
from distributedtraining_tpu_torch.engine import average as tavg
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.engine import validate as tval
from distributedtraining_tpu_torch.engine.ingest import DeltaIngestor
from distributedtraining_tpu_torch.engine.publish import DeltaPublisher
from distributedtraining_tpu_torch.engine.scheduler import FakeClock
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.neurons import averager as tavg_cli
from distributedtraining_tpu_torch.neurons import miner as tminer
from distributedtraining_tpu_torch.neurons import validator as tval_cli
from distributedtraining_tpu_torch.transport import (InMemoryTransport,
                                                     LocalFSTransport,
                                                     SignedTransport)
from distributedtraining_tpu_torch.transport.retry import RetryPolicy
from distributedtraining_tpu_torch.utils import ed25519
from distributedtraining_tpu_torch.utils.identity import (Identity,
                                                          generate_wallets,
                                                          load_wallets)

TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")
JTINY = dataclasses.replace(jg.PRESETS["tiny"], dtype="float32")
B, T = 2, 32
SEEDS = [bytes(np.random.default_rng(s).integers(0, 256, 32, np.uint8))
         for s in range(6)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree():
    return {"w": np.arange(4, dtype=np.float32), "b": np.zeros(2, np.float32)}


# ---------------------------------------------------------------------------
# Ed25519 and identities
# ---------------------------------------------------------------------------

def test_ed25519_keys_and_signatures_equal_cryptography():
    rng = np.random.default_rng(11)
    for seed in SEEDS:
        ref = Ed25519PrivateKey.from_private_bytes(seed)
        pub = ref.public_key().public_bytes_raw()
        assert ed25519.public_key(seed) == pub
        for n in (0, 1, 64, 1000):
            msg = rng.bytes(n)
            sig = ref.sign(msg)
            cut = n // 3
            assert ed25519.sign(seed, msg) == sig
            assert ed25519.sign(seed, (msg[:cut], memoryview(msg)[cut:])) \
                == sig
            assert ed25519.verify(pub, msg, sig)
            bad = bytearray(sig)
            bad[n % 64] ^= 0x10
            assert not ed25519.verify(pub, msg, bytes(bad))
            assert not ed25519.verify(pub, msg + b"x", sig)
        # a non-canonical S (S + L) is refused, as OpenSSL refuses it
        s = int.from_bytes(sig[32:], "little") + ed25519._L
        forged = sig[:32] + s.to_bytes(32, "little")
        assert not ed25519.verify(pub, msg, forged)
        with pytest.raises(Exception):
            Ed25519PublicKey.from_public_bytes(pub).verify(forged, msg)
    # a public key off the curve verifies nothing, in both
    off = (2).to_bytes(32, "little")
    assert ed25519._decode_point(off) is None
    assert not ed25519.verify(off, b"m", sig)
    with pytest.raises(Exception):
        Ed25519PublicKey.from_public_bytes(off).verify(sig, b"m")


def test_identities_and_wallets_cross_packages(tmp_path):
    for seed in SEEDS[:3]:
        ours = Identity.from_private_bytes(seed)
        ref = JIdentity.from_private_bytes(seed)
        assert (ours.hotkey, ours.public_bytes) == (ref.hotkey,
                                                    ref.public_bytes)
        assert ours.sign(b"payload") == ref.sign(b"payload")
        assert ours.verify(b"payload", ref.sign(b"payload"))
        assert ref.verify(b"payload", ours.sign(b"payload"))
        ours.save(str(tmp_path / "port.json"))
        ref.save(str(tmp_path / "jax.json"))
        assert JIdentity.load(str(tmp_path / "port.json")).public_bytes \
            == ours.public_bytes
        assert Identity.load(str(tmp_path / "jax.json")).sign(b"m") \
            == ref.sign(b"m")
        assert (os.stat(tmp_path / "port.json").st_mode & 0o777) == 0o600
        assert json.load(open(tmp_path / "port.json")) == json.load(
            open(tmp_path / "jax.json"))
    with pytest.raises(ValueError, match="public-only"):
        Identity.public_only(ours.public_bytes).sign(b"x")
    generated = generate_wallets(str(tmp_path / "w"), 3)
    theirs = {i.hotkey for i in
              __import__("distributedtraining_tpu.utils.identity",
                         fromlist=["load_wallets"]).load_wallets(
                  str(tmp_path / "w"))}
    assert {i.hotkey for i in generated} == theirs == {
        i.hotkey for i in load_wallets(str(tmp_path / "w"))}
    # a wallet whose hotkey field lies is refused
    bad = json.load(open(tmp_path / "port.json"))
    bad["hotkey"] = "hk" + "0" * 20
    json.dump(bad, open(tmp_path / "bad.json", "w"))
    with pytest.raises(ValueError, match="does not match"):
        Identity.load(str(tmp_path / "bad.json"))


# ---------------------------------------------------------------------------
# Envelopes
# ---------------------------------------------------------------------------

def _verdict(mod, err, *args, **kw):
    with pytest.raises(err) as e:
        mod.unwrap(*args, **kw)
    return str(e.value)


def test_wrap_bytes_equal_jax_and_verdicts_match():
    ours = Identity.from_private_bytes(SEEDS[0])
    ref = JIdentity.from_private_bytes(SEEDS[0])
    other = Identity.from_private_bytes(SEEDS[1])
    payload = jser.to_msgpack(tree())
    for ctx in (signing.delta_context("hk1"),
                signing.base_context("hotkey_99") + b":1700000000"):
        env = signing.wrap(payload, ours, ctx)
        assert env == jsign.wrap(payload, ref, ctx)
        assert signing.is_enveloped(env) and env[:6] == b"DTSG2\x00"
        assert signing.strip_envelope(env) == jsign.strip_envelope(env)
        assert signing.unwrap_with_context(env) == \
            jsign.unwrap_with_context(env)
    env = signing.wrap(payload, ours, signing.delta_context("hk1"))
    tampered = env[:-1] + bytes([env[-1] ^ 1])
    cases = [
        ((tampered, signing.delta_context("hk1")), {}),
        ((env, signing.delta_context("hk1")),
         {"expected_pub": other.public_bytes}),
        ((env, signing.base_context("hk1")), {}),
        ((env, signing.delta_context("hk2")), {}),
        ((env,), {"kind": b"base"}),
        ((payload, b"ctx"), {"require": True}),
        ((env[:20],), {}),
    ]
    for args, kw in cases:
        assert _verdict(signing, ser.PayloadError, *args, **kw) == \
            _verdict(jsign, jser.PayloadError, *args, **kw)
    assert signing.unwrap(payload, b"ctx") == payload
    assert signing.context_seq(b"base:a:12", b"base:a") == \
        jsign.context_seq(b"base:a:12", b"base:a") == 12
    assert signing.context_seq(b"base:a:x", b"base:a") == 0
    with pytest.raises(ValueError, match="too long"):
        signing.wrap(b"", ours, b"c" * 256)


# ---------------------------------------------------------------------------
# SignedTransport: the cases of tests/test_signed_artifacts.py
# ---------------------------------------------------------------------------

@pytest.fixture(params=["memory", "localfs"])
def inner(request, tmp_path):
    if request.param == "memory":
        return InMemoryTransport()
    return LocalFSTransport(str(tmp_path / "artifacts"))


def test_signed_delta_roundtrip_and_forgery(inner, tmp_path):
    store = LocalAddressStore(str(tmp_path / "chain"))
    miner = Identity.from_private_bytes(SEEDS[0])
    store.store_pubkey("m0", miner.public_bytes)
    miner_t = SignedTransport(inner, identity=miner,
                              pubkey_resolver=store.retrieve_pubkey,
                              my_hotkey="m0")
    validator_t = SignedTransport(inner,
                                  pubkey_resolver=store.retrieve_pubkey)
    miner_t.publish_delta("m0", tree())
    got = validator_t.fetch_delta("m0", tree())
    np.testing.assert_array_equal(got["w"], tree()["w"])
    attacker = Identity.from_private_bytes(SEEDS[1])
    inner.publish_raw("m0", signing.wrap(ser.to_msgpack(tree()), attacker,
                                         signing.delta_context("m0")))
    assert validator_t.fetch_delta("m0", tree()) is None
    inner.publish_raw("m0", ser.to_msgpack(tree()))   # a downgrade
    assert validator_t.fetch_delta("m0", tree()) is None
    inner.publish_raw("anon", ser.to_msgpack(tree()))
    assert validator_t.fetch_delta("anon", tree()) is not None
    strict_t = SignedTransport(inner, pubkey_resolver=store.retrieve_pubkey,
                               strict=True)
    assert strict_t.fetch_delta("anon", tree()) is None


def test_signed_base_roundtrip_forgery_and_kind(inner, tmp_path):
    store = LocalAddressStore(str(tmp_path / "chain"))
    avg = Identity.from_private_bytes(SEEDS[2])
    store.store_pubkey("hotkey_99", avg.public_bytes)
    averager_t = SignedTransport(inner, identity=avg,
                                 pubkey_resolver=store.retrieve_pubkey,
                                 my_hotkey="hotkey_99")
    miner_t = SignedTransport(inner, pubkey_resolver=store.retrieve_pubkey,
                              base_signer="hotkey_99")
    averager_t.publish_base(tree())
    got, rev = miner_t.fetch_base(tree())
    assert rev is not None
    np.testing.assert_array_equal(got["b"], tree()["b"])
    attacker = Identity.from_private_bytes(SEEDS[1])
    inner.publish_base_raw(signing.wrap(ser.to_msgpack(tree()), attacker,
                                        signing.base_context("hotkey_99")))
    assert miner_t.fetch_base(tree()) is None
    inner.publish_base_raw(ser.to_msgpack(tree()))
    assert miner_t.fetch_base(tree()) is None
    # no configured signer: a valid base reads, a delta envelope replayed
    # as a base does not, and strict refuses the unsigned one
    plain = SignedTransport(inner)
    averager_t.publish_base(tree())
    assert plain.fetch_base(tree()) is not None
    inner.publish_base_raw(signing.wrap(ser.to_msgpack(tree()), avg,
                                        signing.delta_context("hotkey_99")))
    assert plain.fetch_base(tree()) is None
    inner.publish_base_raw(ser.to_msgpack(tree()))
    assert plain.fetch_base(tree()) is not None
    assert SignedTransport(inner, strict=True).fetch_base(tree()) is None


def test_pubkey_first_write_wins(tmp_path):
    store = LocalAddressStore(str(tmp_path))
    a = Identity.from_private_bytes(SEEDS[0])
    b = Identity.from_private_bytes(SEEDS[1])
    store.store_pubkey("hk", a.public_bytes)
    store.store_pubkey("hk", a.public_bytes)
    with pytest.raises(ValueError):
        store.store_pubkey("hk", b.public_bytes)
    assert JStore(str(tmp_path)).retrieve_pubkey("hk") == a.public_bytes


def test_replayed_stale_base_rejected(tmp_path):
    inner = InMemoryTransport()
    store = LocalAddressStore(str(tmp_path))
    avg = Identity.from_private_bytes(SEEDS[2])
    store.store_pubkey("hotkey_99", avg.public_bytes)
    t = [1000.0]
    averager_t = SignedTransport(inner, identity=avg,
                                 pubkey_resolver=store.retrieve_pubkey,
                                 my_hotkey="hotkey_99", now_fn=lambda: t[0])
    miner_t = SignedTransport(inner, pubkey_resolver=store.retrieve_pubkey,
                              base_signer="hotkey_99")
    averager_t.publish_base(tree())
    stale = inner.fetch_base_bytes()
    assert miner_t.fetch_base(tree()) is not None
    t[0] = 2000.0
    newer = tree()
    newer["w"] = newer["w"] + 1
    averager_t.publish_base(newer)
    assert miner_t.fetch_base(tree()) is not None
    inner.publish_base_raw(stale)
    assert miner_t.fetch_base(tree()) is None
    # the JAX verifier takes the same view of the same bytes
    jreader = JSigned(_JMemFrom(inner), pubkey_resolver=store.retrieve_pubkey,
                      base_signer="hotkey_99")
    jreader._base_seq_seen = miner_t._base_seq_seen
    assert jreader.fetch_base(tree()) is None
    fresh = SignedTransport(inner, pubkey_resolver=store.retrieve_pubkey,
                            base_signer="hotkey_99")
    assert fresh.fetch_base(tree()) is not None


class _JMemFrom:
    """The port's in-memory store read through the JAX SignedTransport."""

    def __init__(self, t):
        self.t = t

    def fetch_base_bytes(self):
        return self.t.fetch_base_bytes()

    def base_revision(self):
        return self.t.base_revision()


def test_unsigned_node_reads_signed_fleet(inner):
    avg = Identity.from_private_bytes(SEEDS[2])
    miner = Identity.from_private_bytes(SEEDS[0])
    SignedTransport(inner, identity=avg,
                    my_hotkey="hotkey_99").publish_base(tree())
    SignedTransport(inner, identity=miner,
                    my_hotkey="m0").publish_delta("m0", tree())
    fetched = inner.fetch_base(tree())
    assert fetched is not None
    np.testing.assert_array_equal(fetched[0]["w"], tree()["w"])
    assert inner.fetch_delta("m0", tree()) is not None
    assert signing.is_enveloped(inner.fetch_delta_bytes("m0"))


# ---------------------------------------------------------------------------
# Rounds with a signed fleet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    docs = tds.text_corpus(n_docs=64, seed=0)
    tok = tds.WordTokenizer(docs, vocab_size=TINY.vocab_size)
    it = tds.batch_iterator(docs, tok, batch_size=B, seq_len=T, repeat=True,
                            shuffle=True, seed=1)
    train = [next(it) for _ in range(4)]
    val = list(tds.batch_iterator(tds.text_corpus(split="test", n_docs=64,
                                                  seed=0), tok,
                                  batch_size=B, seq_len=T))[:2]
    model, _ = tg.make_model(TINY)
    jmodel, _ = jg.make_model(JTINY)
    base = tg.init_params_numpy(TINY, 0)
    fast = ttrain.TrainEngine(
        model, optimizer=ttrain.default_optimizer(1e-2), device="cpu")
    deltas = []
    for i in range(2):
        state = fast.init_state(tg.params_from_numpy(base, device="cpu"))
        snap = {k: v.detach().clone() for k, v in state.params.items()}
        for b in train[2 * i:2 * i + 2]:
            state, _ = fast.train_step(state, fast.place_batch(b))
        deltas.append(tg.params_to_numpy(
            tdl.compute_delta(state.params, snap)))
    return {"base": base, "val": val, "deltas": deltas, "train": train,
            "teng": ttrain.TrainEngine(model, device="cpu"),
            "jeng": jtrain.TrainEngine(jmodel)}


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _template(world):
    return jax.tree_util.tree_map(lambda x: np.zeros(np.shape(x), np.float32),
                                  world["base"])


def test_unsigned_port_validator_scores_a_signed_jax_fleet(world, tmp_path):
    """The repair of transport/localfs.py: a JAX-signed base and miner,
    read by validators that do not sign. The JAX one strips the envelope
    and scores the miner; the port's now does the same, loss for loss."""
    root = str(tmp_path / "artifacts")
    jt = JFS(root)
    JSigned(jt, identity=JIdentity.from_private_bytes(SEEDS[2]),
            my_hotkey="hotkey_99").publish_base(_jtree(world["base"]))
    JSigned(jt, identity=JIdentity.from_private_bytes(SEEDS[0]),
            my_hotkey="hotkey_1").publish_delta("hotkey_1",
                                                world["deltas"][0])
    assert jsign.is_enveloped(jt.fetch_delta_bytes("hotkey_1"))
    chain_dir = str(tmp_path / "chain")
    ours = tval.Validator(world["teng"], LocalFSTransport(root),
                          LocalChain(chain_dir, my_hotkey="hotkey_91"),
                          eval_batches=lambda: iter(world["val"]))
    ref = JValidator(world["jeng"], jt,
                     JChain(chain_dir, my_hotkey="hotkey_91"),
                     eval_batches=lambda: iter(world["val"]))
    try:
        ours.bootstrap()
        ref.bootstrap()
        assert ours._base_revision == ref._base_revision == \
            jt.base_revision()
        got = {r.hotkey: r for r in ours.validate_and_score()}
        want = {r.hotkey: r for r in ref.validate_and_score()}
    finally:
        ours.close()
    assert got["hotkey_1"].reason == want["hotkey_1"].reason == "ok"
    np.testing.assert_allclose(got["hotkey_1"].loss, want["hotkey_1"].loss,
                               rtol=1e-5)
    assert {h for h, r in got.items() if r.reason == "ok"} == \
        {h for h, r in want.items() if r.reason == "ok"}


def _signed_pair(root, chain_dir, hotkey, seed, *, jax_side, base_signer):
    store = (JStore if jax_side else LocalAddressStore)(chain_dir)
    ident = (JIdentity if jax_side else Identity).from_private_bytes(seed)
    store.store_pubkey(hotkey, ident.public_bytes)
    inner = (JFS if jax_side else LocalFSTransport)(root)
    return (JSigned if jax_side else SignedTransport)(
        inner, identity=ident, pubkey_resolver=store.retrieve_pubkey,
        base_signer=base_signer, my_hotkey=hotkey)


@pytest.mark.parametrize("direction", ["jax_miner_port_averager",
                                       "port_miner_jax_averager"])
def test_mixed_signed_round(world, tmp_path, direction):
    root, chain_dir = str(tmp_path / "artifacts"), str(tmp_path / "chain")
    port_avg = direction == "jax_miner_port_averager"
    avg_t = _signed_pair(root, chain_dir, "hotkey_95", SEEDS[2],
                         jax_side=not port_avg, base_signer="hotkey_95")
    miner_t = _signed_pair(root, chain_dir, "hotkey_1", SEEDS[0],
                           jax_side=port_avg, base_signer="hotkey_95")
    avg_t.publish_base(world["base"] if port_avg else _jtree(world["base"]))
    if port_avg:
        miner_t.publish_delta("hotkey_1", world["deltas"][0])
    else:
        model, _ = tg.make_model(TINY)
        loop = ttrain.MinerLoop(
            ttrain.TrainEngine(model, optimizer=ttrain.default_optimizer(
                1e-2), device="cpu"), miner_t, "hotkey_1", clock=FakeClock(),
            send_interval=1.0, log_every=10**9)
        loop.bootstrap()      # the signed base, verified
        assert loop._base_revision == miner_t.base_revision()
        for b in world["train"][:2]:
            loop.clock.sleep(1.0)
            loop.run([b], max_steps=1)
        loop.flush()
        loop.close()
        assert loop.report.pushes >= 1
    # a forgery under another miner's id, signed by the wrong key
    attacker = Identity.from_private_bytes(SEEDS[4])
    (LocalAddressStore if port_avg else JStore)(chain_dir).store_pubkey(
        "hotkey_2", Identity.from_private_bytes(SEEDS[3]).public_bytes)
    LocalFSTransport(root).publish_raw("hotkey_2", signing.wrap(
        ser.to_msgpack(world["deltas"][1]), attacker,
        signing.delta_context("hotkey_2")))
    if port_avg:
        loop = tavg.AveragerLoop(
            world["teng"], avg_t, LocalChain(chain_dir,
                                             my_hotkey="hotkey_95"),
            tavg.WeightedAverage(), val_batches=lambda: iter(world["val"]),
            publish_policy="always")
    else:
        loop = JLoop(world["jeng"], avg_t,
                     JChain(chain_dir, my_hotkey="hotkey_95"), JWA(),
                     val_batches=lambda: iter(world["val"]),
                     publish_policy="always")
    loop.bootstrap()
    assert loop.run_round()
    loop.close()
    assert loop.report.last_accepted == 1 and loop.report.last_rejected == 0
    # the merged base is signed by the averager and verifies in the other
    # package under the registered key
    assert signing.is_enveloped(LocalFSTransport(root).fetch_base_bytes())
    store_cls = JStore if port_avg else LocalAddressStore
    reader = (JSigned(JFS(root), pubkey_resolver=store_cls(
        chain_dir).retrieve_pubkey, base_signer="hotkey_95") if port_avg
        else SignedTransport(LocalFSTransport(root),
                             pubkey_resolver=store_cls(
                                 chain_dir).retrieve_pubkey,
                             base_signer="hotkey_95"))
    got = reader.fetch_base(_template(world))
    assert got is not None
    base = tdl.flatten_tree(world["base"])
    moved = tdl.flatten_tree(jax.tree_util.tree_map(np.asarray, got[0]))
    assert max(float(np.abs(moved[k] - base[k]).max()) for k in base) > 0


FAST = RetryPolicy(attempts=2, base_delay=0.0, max_delay=0.0, jitter=0.0)
JFAST = JRetry(attempts=2, base_delay=0.0, max_delay=0.0, jitter=0.0)


class _Report:
    pushes = pushes_failed = pushes_superseded = 0


def _v2_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"big": {"kernel": rng.standard_normal((300, 40)).astype(
                np.float32)},
            "small": {"bias": rng.standard_normal(32).astype(np.float32)}}


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_signed_wire_v2_manifest_and_unsigned_shards(tmp_path, publisher):
    """The reference's signed wire-v2 path, set up as the API has it: the
    manifest enveloped under the delta context, the shards unsigned and
    pinned by its hashes; a reader of either package decodes exactly
    ``densify_packed_v2``; a forged unsigned manifest under a registered
    key reads as ``no_delta``."""
    seed = SEEDS[0]
    delta = _v2_tree()
    template = jax.tree_util.tree_map(np.zeros_like, delta)
    root = str(tmp_path / "fs")
    spec = {"format": 2, "density": 1 / 64, "quant": "int8"}
    if publisher == "jax":
        ident = JIdentity.from_private_bytes(seed)
        keys = {"m0": ident.public_bytes}
        packed = jax.device_get(jdl.pack_delta_v2(_jtree(delta),
                                                  density=1 / 64)[0])
        pub = JPub(JSigned(JFS(root), identity=ident,
                           pubkey_resolver=keys.get, my_hotkey="m0"), "m0",
                   report=_Report(), publish_retry=JFAST, meta_retry=JFAST,
                   wire_spec=spec)
    else:
        ident = Identity.from_private_bytes(seed)
        keys = {"m0": ident.public_bytes}
        packed = tdl.pack_delta_v2(
            {k: torch.from_numpy(v) for k, v in
             tdl.flatten_tree(delta).items()}, density=1 / 64)[0]
        pub = DeltaPublisher(SignedTransport(
            LocalFSTransport(root), identity=ident, pubkey_resolver=keys.get,
            my_hotkey="m0"), "m0", report=_Report(), publish_retry=FAST,
            meta_retry=FAST, wire_spec=spec)
    assert pub.publish_now(packed, None, "r0")
    pub.close()
    raw = LocalFSTransport(root).fetch_delta_bytes("m0")
    assert signing.is_enveloped(raw)
    assert ser.is_wire_v2_manifest(signing.strip_envelope(raw))
    ref = jdl.densify_packed_v2(
        jax.device_get(jdl.pack_delta_v2(_jtree(delta), density=1 / 64)[0]),
        template)
    readers = [
        DeltaIngestor(SignedTransport(LocalFSTransport(root),
                                      pubkey_resolver=keys.get), template,
                      workers=1),
        JIngest(JSigned(JFS(root), pubkey_resolver=keys.get), template,
                workers=1)]
    for ing in readers:
        s = ing.stage(["m0"])[0]
        ing.close()
        assert s.reason == "ok"
        got = tdl.flatten_tree(jax.tree_util.tree_map(np.asarray, s.delta))
        for k, v in tdl.flatten_tree(jax.tree_util.tree_map(
                np.asarray, ref)).items():
            np.testing.assert_array_equal(got[k], v)
    forged = ser.build_wire_manifest(
        {k: (ser.shard_digest(b"x"), 1)
         for k in tdl.packed_layer_entries(packed)},
        density=1 / 64, quant="int8")
    LocalFSTransport(root).publish_raw("m0", forged)
    for ing in (DeltaIngestor(SignedTransport(LocalFSTransport(root),
                                              pubkey_resolver=keys.get),
                              template, workers=1),
                JIngest(JSigned(JFS(root), pubkey_resolver=keys.get),
                        template, workers=1)):
        s = ing.stage(["m0"])[0]
        ing.close()
        assert s.reason == "no_delta"


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def test_clis_sign_artifacts_and_register_repo(tmp_path, monkeypatch):
    monkeypatch.setenv("DT_FORCE_PLATFORM", "cpu")
    work = str(tmp_path / "run")
    common = ["--backend", "local", "--model", "tiny", "--dataset",
              "synthetic", "--tokenizer", "word", "--no-base-wire-v2",
              "--flight-events", "0", "--batch-size", "2", "--eval-batches",
              "2", "--eval-seq-len", "32", "--work-dir", work,
              "--sign-artifacts", "--base-signer", "hotkey_95"]
    miner = ["--checkpoint-interval", "0", "--no-anomaly-trace",
             "--max-steps", "3", "--seq-len", "32"]
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        # genesis by the signing averager, then a signed miner with a repo
        assert tavg_cli.main(common + ["--rounds", "1", "--hotkey",
                                       "hotkey_95", "--strategy",
                                       "weighted", "--no-lineage"]) == 1
        assert tminer.main(common + miner + [
            "--hotkey", "hotkey_3", "--my-repo-id", "me/hotkey_3"]) == 0
        assert tval_cli.main(common + ["--rounds", "1", "--hotkey",
                                       "hotkey_91"]) == 0
        assert tavg_cli.main(common + ["--rounds", "1", "--hotkey",
                                       "hotkey_95", "--strategy",
                                       "weighted", "--no-lineage",
                                       "--publish-policy", "always"]) == 0
        # a rotated wallet for a registered hotkey is fatal
        first = Identity.load(os.path.join(work, "wallets", "hotkey_3.json"))
        os.remove(os.path.join(work, "wallets", "hotkey_3.json"))
        with pytest.raises(SystemExit, match="different registered"):
            tminer.main(common + miner + ["--hotkey", "hotkey_3"])
    finally:
        root.handlers[:], root.level = handlers, level
    store = JStore(os.path.join(work, "chain"))
    assert store.retrieve_repo("hotkey_3") == "me/hotkey_3"
    for hk in ("hotkey_95", "hotkey_91"):
        wallet = JIdentity.load(os.path.join(work, "wallets", f"{hk}.json"))
        assert store.retrieve_pubkey(hk) == wallet.public_bytes
    assert store.retrieve_pubkey("hotkey_3") == first.public_bytes
    t = JFS(os.path.join(work, "artifacts"))
    assert jsign.is_enveloped(t.fetch_delta_bytes("hotkey_3"))
    assert jsign.is_enveloped(t.fetch_base_bytes())
    # the JAX verifier accepts the port averager's signed base
    reader = JSigned(t, pubkey_resolver=store.retrieve_pubkey,
                     base_signer="hotkey_95")
    assert reader.fetch_base(jax.tree_util.tree_map(
        lambda x: np.zeros(np.shape(x), np.float32),
        tg.init_params_numpy(TINY, 0))) is not None
    weights = JChain(os.path.join(work, "chain")).consensus_scores()
    assert "hotkey_3" in weights
