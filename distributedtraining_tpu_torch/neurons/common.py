"""Composition of the port's roles — the miner's, the validator's, the
averager's and the server's part of the JAX package's ``neurons/common.py``
(``Components`` and ``build``): the model, the ``TrainEngine``, the
``memory`` or ``local`` transport (behind ``SignedTransport`` with
``--sign-artifacts``), the local chain and address store,
the tokenizer, the train, self-eval and held-out batch streams and the
flight recorder, the role's metrics sink (``--metrics-path``: a
``JSONLSink`` rotated at ``--metrics-rotate-mb`` keeping
``--metrics-keep-segments``, bound to ``utils/obs`` so spans and
registry flushes land in it, with the device observatory
``utils/devprof`` on unless ``--no-devprof``), the deterministic fault
injection of ``--chaos-spec`` (``transport/chaos.ChaosTransport``
around the outermost transport layer), driven by ``RunConfig``;
``build_base_fetcher``, the content-addressed base fetcher of
``--base-wire-v2``; and ``build_health_plane``, the role's part of the
fleet health plane (``--heartbeat-interval``, ``--remediate``) and its
``--obs-port`` exporter (``utils/obs_http.ObsHTTPExporter``).

The tokenizer follows the JAX build branch for branch: ``byte`` (or
``auto`` under GPT-2's vocabulary) is ``ByteTokenizer``, ``word`` the
corpus-fit ``WordTokenizer``, ``bpe`` the byte-level BPE trained on the
machine's own text and saved under ``<work-dir>/tokenizer/`` (on a world
the coordinator trains it and the other ranks load its file), and any
other name (``auto``: ``gpt2``) an HF tokenizer read from a local
directory or cache, else ``ByteTokenizer``. ``--compile-cache-dir``
names the build directory of the CUDA kernels and the host packer
(``ops/_cuda.set_build_dir``), set before anything builds: a restart on
the same directory compiles nothing.

The device is the card unless the caller asks for the CPU the way the JAX
roles do: ``DT_FORCE_PLATFORM=cpu`` in the environment. Without it,
everything is placed on ``cuda``, and building raises if there is none.

A miner, validator or averager started as several processes
(``torchrun --nproc-per-node N``, or the ``--multihost-*`` flags) builds
its mesh as the JAX roles do: the world over ``torch.distributed``
(``parallel.multihost.initialize``, each rank on its card by
``LOCAL_RANK``), ``resolve_mesh_config`` over the world's size (``--dp
0``: every rank the other axes leave) and ``pod_mesh`` over it; the
transport and chain are gated so that the coordinator alone writes, and
with ``--sign-artifacts`` the coordinator alone holds the signing
identity. The miner's ``--batch-size`` is the global batch: each
data-parallel group (dp x fsdp; tp peers share rows) reads its own
document shard at ``batch_size / (dp * fsdp)``. A server (or the router)
started as several processes is refused before any process group
exists. A mesh role started as one process on a host with several
cards logs at its build that it uses one, with the ``torchrun`` line
that would use all of them (a JAX role takes every chip).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable, Iterable

from ..chain import LocalAddressStore, LocalChain
from ..config import MESH_ROLES, RunConfig
from ..data.datasets import (ByteTokenizer, WordTokenizer, batch_iterator,
                             load_tokenizer, shuffle_seed_for, text_corpus)
from ..engine.train import TrainEngine, default_optimizer
from .. import models
from ..parallel import multihost
from ..parallel.mesh import resolve_mesh_config
from ..transport import InMemoryTransport, LocalFSTransport

logger = logging.getLogger(__name__)


def resolve_role_device() -> str:
    """``"cpu"`` when ``DT_FORCE_PLATFORM=cpu``, else ``"cuda"`` (which
    the engine then requires); any other value raises."""
    val = os.environ.get("DT_FORCE_PLATFORM", "").strip().lower()
    if val in ("", "cuda", "gpu"):
        return "cuda"
    if val == "cpu":
        return "cpu"
    raise ValueError(f"DT_FORCE_PLATFORM={val!r}: expected cpu or cuda")


@dataclasses.dataclass
class Components:
    cfg: RunConfig
    model: Any
    model_cfg: Any
    engine: TrainEngine
    transport: Any
    chain: Any
    address_store: Any
    tokenizer: Any
    # set when --lora-rank > 0 (models.lora.LoRAConfig: the LoRA miner,
    # and the adapter payloads the validator and averager accept)
    lora_cfg: Any = None
    # True when build() brought the torch.distributed world up (the
    # role's exit tears it down)
    owns_world: bool = False
    # the role's MetricsSink (--metrics-path), or None
    metrics: Any = None

    def train_batches(self, *, repeat: bool = True) -> Iterable[dict]:
        """The shuffled packed train stream (per-hotkey order), behind
        the look-ahead thread when ``--prefetch-depth`` > 0. On a mesh
        of several processes, this rank's rows: its data-parallel
        group's document shard at ``batch_size / (dp * fsdp)`` (sp and
        tp peers share documents), and on an sp mesh this rank's
        positions of them (``sharding.batch_columns``)."""
        docs = text_corpus(split="train", source=self.cfg.dataset,
                           n_docs=self.cfg.n_docs)
        bs = self.cfg.batch_size
        mesh = self.engine.mesh
        sp = 1
        if mesh is not None and mesh.world_size > 1:
            from ..parallel.sharding import ROW_AXES
            groups = mesh.size(ROW_AXES)
            if bs % groups:
                raise SystemExit(
                    f"--batch-size {bs} (global) must be divisible by "
                    f"dp x fsdp = {groups}")
            sp = mesh.size("sp")
            if self.cfg.seq_len % sp:
                raise SystemExit(
                    f"--seq-len {self.cfg.seq_len} must be divisible by "
                    f"sp = {sp}")
            docs = list(multihost.shard_documents(
                docs, process_index=mesh.index(ROW_AXES),
                process_count=groups))
            bs //= groups
        it = batch_iterator(docs, self.tokenizer,
                            batch_size=bs,
                            seq_len=self.cfg.seq_len, repeat=repeat,
                            max_vocab=self.model_cfg.vocab_size,
                            shuffle=True,
                            seed=shuffle_seed_for(self.cfg.hotkey))
        if sp > 1:
            from ..parallel.sharding import batch_columns
            it = (batch_columns(b, mesh) for b in it)
        if self.cfg.prefetch_depth > 0:
            from ..data.prefetch import prefetch
            it = prefetch(it, depth=self.cfg.prefetch_depth)
        return it

    def initial_params(self):
        """The pretrained starting point of ``--init-from`` (None without
        the flag): ``models.convert.load_params`` against the model config
        in use (a nested numpy tree, stacked under ``--scan-blocks``).
        The roles hand it to their bootstraps uncalled, which call it on
        the genesis path alone: a published base or a local checkpoint
        always wins, and a restart does not pay a conversion it would
        discard. On a world of several processes the coordinator reads
        and converts, and every rank receives the tree (a flat state dict
        of host tensors) by broadcast, as every transport read is
        shared."""
        if not self.cfg.init_from:
            return None
        from ..models import convert
        logger.info("loading pretrained weights from %s", self.cfg.init_from)
        mesh = self.engine.mesh
        if mesh is None or mesh.world_size == 1:
            return convert.load_params(self.cfg.init_from, self.model_cfg)
        from ..delta import flatten_tree
        from ..engine.train import broadcast_optional_tree
        tree = broadcast_optional_tree(
            self.model.state_dict(), lambda: flatten_tree(
                convert.load_params(self.cfg.init_from, self.model_cfg)))
        if tree is None:
            raise RuntimeError(f"--init-from {self.cfg.init_from}: the "
                               f"coordinator's read gave nothing")
        return tree

    _test_docs_cache = None

    def _test_docs(self) -> list[str]:
        if self._test_docs_cache is None:
            self._test_docs_cache = text_corpus(
                split="test", source=self.cfg.dataset,
                n_docs=max(256, self.cfg.n_docs // 8))
        return self._test_docs_cache

    def _batches_over(self, docs) -> Callable[[], Iterable[dict]]:
        cfg = self.cfg

        def factory():
            it = batch_iterator(docs, self.tokenizer,
                                batch_size=cfg.batch_size,
                                seq_len=cfg.eval_seq_len,
                                max_vocab=self.model_cfg.vocab_size)
            for i, b in enumerate(it):
                if i >= cfg.eval_batches:
                    break
                yield b

        return factory

    def eval_batches(self) -> Callable[[], Iterable[dict]]:
        """The server-side held-out shard (the averager's publish guard,
        validator scoring): the front half of the test split, disjoint
        from the miners' self-eval shard."""
        docs = self._test_docs()
        return self._batches_over(docs[: max(1, len(docs) // 2)]
                                  if len(docs) >= 4 else docs)

    def miner_val_batches(self) -> Callable[[], Iterable[dict]]:
        """The miner's self-eval shard: a per-hotkey rotation of the back
        half of the test split, disjoint from the validators' shard."""
        docs = self._test_docs()
        if len(docs) < 4:
            logger.warning(
                "test split too small (%d docs) to give the miner a "
                "disjoint self-eval shard; guard evals will share the "
                "validator's data", len(docs))
            tail = docs
        else:
            tail = docs[len(docs) // 2:]
        off = shuffle_seed_for(self.cfg.hotkey) % len(tail)
        return self._batches_over(tail[off:] + tail[:off])


def build(cfg: RunConfig) -> Components:
    """The role's components. Raises NotImplementedError for a flag
    value the port has not brought over (``RunConfig.check_ported``)."""
    device = resolve_role_device()
    if cfg.role not in MESH_ROLES:
        multihost.refuse_world(cfg.role, multihost_flags=any(
            v is not None for v in (cfg.multihost_coordinator,
                                    cfg.multihost_processes,
                                    cfg.multihost_id)))
    cfg.check_ported()
    if cfg.compile_cache_dir:
        # before anything builds: the kernels and the packer compile into
        # (or load from) this directory
        from ..ops import _cuda
        _cuda.set_build_dir(cfg.compile_cache_dir)
        logger.info("build directory of the kernels and the packer: %s",
                    _cuda.BUILD_DIR)
    try:
        family = models.family(cfg.model)
    except KeyError as e:
        raise NotImplementedError(f"--model {cfg.model}: {e.args[0]}")
    model_cfg = family.PRESETS[cfg.model]
    if cfg.scan_blocks:
        model_cfg = dataclasses.replace(model_cfg, scan_blocks=True)
    if cfg.logits_dtype:
        model_cfg = dataclasses.replace(model_cfg,
                                        logits_dtype=cfg.logits_dtype)
    if cfg.remat is not None:   # tri-state: None keeps the preset's value
        model_cfg = dataclasses.replace(model_cfg, remat=cfg.remat)
    model, model_cfg = family.make_model(model_cfg)
    owns_world = False
    mesh = None
    if cfg.role in MESH_ROLES:
        owns_world = multihost.initialize(
            cfg.multihost_coordinator, cfg.multihost_processes,
            cfg.multihost_id, device=device)
        mesh = role_mesh(cfg, model)
        if device == "cuda" and mesh is None:
            _note_idle_cards(cfg.role)
    engine = TrainEngine(
        model,
        optimizer=default_optimizer(cfg.learning_rate,
                                    grad_clip=cfg.grad_clip,
                                    weight_decay=cfg.weight_decay,
                                    mu_dtype=cfg.mu_dtype),
        mesh=mesh, fused_loss=cfg.fused_loss, accum_steps=cfg.accum_steps,
        device=device)
    if cfg.backend == "memory":
        transport = InMemoryTransport()
    else:
        transport = LocalFSTransport(os.path.join(cfg.work_dir, "artifacts"))
    chain_dir = os.path.join(cfg.work_dir, "chain")
    chain = LocalChain(chain_dir, my_hotkey=cfg.hotkey,
                       epoch_length=cfg.epoch_length,
                       vpermit_stake_limit=cfg.vpermit_stake_limit)
    address_store = LocalAddressStore(chain_dir)
    if cfg.sign_artifacts:
        transport = _signed_transport(cfg, transport, address_store)
    if cfg.chaos_spec:
        # deterministic fault injection (transport/chaos.py) around the
        # OUTERMOST layer, so injected faults hit signed publishes and
        # verified fetches as network faults would; soak and test
        # machinery, so the flag warns on every boot
        from ..transport.chaos import ChaosSpec, ChaosTransport
        logger.warning("CHAOS INJECTION ACTIVE for role %s: %s",
                       cfg.role, cfg.chaos_spec)
        transport = ChaosTransport(transport,
                                   ChaosSpec.from_json(cfg.chaos_spec),
                                   role=cfg.role)
    # one writer for the whole world (identity for one process)
    transport, chain = multihost.gate_io(transport, chain)
    if cfg.my_repo_id and multihost.is_coordinator():
        # advertise this node's repo, as the reference miner does on chain
        address_store.store_repo(cfg.hotkey, cfg.my_repo_id)
    tokenizer = build_tokenizer(cfg, model_cfg)
    metrics = None
    if cfg.metrics_path and multihost.is_coordinator():
        from ..utils import obs
        from ..utils.metrics import JSONLSink
        metrics = JSONLSink(
            cfg.metrics_path,
            max_bytes=(cfg.metrics_rotate_mb * (1 << 20)
                       if cfg.metrics_rotate_mb > 0 else None),
            keep_segments=max(1, cfg.metrics_keep_segments))
        # every span and registry flush lands in the same JSONL as the
        # role's records; role mains reset obs on exit. On a world the
        # coordinator alone writes it (one file, no interleaved ranks)
        obs.configure(metrics, role=cfg.role)
        if cfg.devprof:
            # the device observatory (utils/devprof.py): per-program
            # cost and time on every registered hot path, through the
            # same sink at each flush; role mains reset it beside obs
            from ..utils import devprof
            devprof.enable()
    if cfg.flight_events > 0:
        # the bounded forensic ring every role keeps, frozen into a
        # published __pm__ bundle on a quality drift or a crash; role
        # mains install the crash hooks and call flight.shutdown() on exit
        from ..utils import flight
        flight.configure(cfg.role, cfg.hotkey, transport=transport,
                         capacity=cfg.flight_events, config=cfg)
    lora_cfg = None
    if cfg.lora_rank > 0:
        from ..models.lora import LoRAConfig
        lora_cfg = LoRAConfig(rank=cfg.lora_rank, alpha=cfg.lora_alpha)
    return Components(cfg=cfg, model=model, model_cfg=model_cfg,
                      engine=engine, transport=transport, chain=chain,
                      address_store=address_store, tokenizer=tokenizer,
                      lora_cfg=lora_cfg, owns_world=owns_world,
                      metrics=metrics)


def build_tokenizer(cfg: RunConfig, model_cfg):
    """The role's tokenizer (JAX ``neurons/common.py:462-485``, branch
    for branch). Called after the world is up: on a world of several
    processes the coordinator trains the BPE and the other ranks load its
    file (a rank that cannot see it trains the identical vocab itself)."""
    if cfg.tokenizer == "byte" or (cfg.tokenizer == "auto"
                                   and model_cfg.vocab_size < 50257):
        return ByteTokenizer()
    if cfg.tokenizer == "word":
        # corpus-fit word vocab, deterministic per corpus: every role of a
        # deployment rebuilds the identical mapping
        return WordTokenizer(text_corpus(split="train", source=cfg.dataset),
                             vocab_size=model_cfg.vocab_size)
    if cfg.tokenizer == "bpe":
        # byte-level BPE (GPT-2's algorithm) trained on the machine's own
        # text, saved under the work dir so the roles of a deployment
        # train it once
        from ..data.bpe import BPETokenizer
        vocab = min(model_cfg.vocab_size, 32000)
        path = os.path.join(cfg.work_dir, "tokenizer", f"bpe-{vocab}.json")
        if multihost.process_count() > 1:
            from ..engine.train import coordinator_call
            made = {}

            def train() -> int:
                made["tok"] = BPETokenizer.train_or_load(path,
                                                         vocab_size=vocab)
                return made["tok"].vocab_size

            coordinator_call(train, "BPE training")
            if made:
                return made["tok"]
        return BPETokenizer.train_or_load(path, vocab_size=vocab)
    return load_tokenizer("gpt2" if cfg.tokenizer == "auto"
                          else cfg.tokenizer)


@dataclasses.dataclass
class HealthPlane:
    """The role's part of the fleet health plane (``engine/health.py``):
    its heartbeat publisher, a FleetMonitor (validator, averager), the
    remediation engine acting on that monitor's breaches
    (``--remediate``) and the ``--obs-port`` Prometheus exporter
    (``utils/obs_http.py``)."""
    heartbeat: Any = None
    fleet: Any = None
    remediation: Any = None
    exporter: Any = None

    def close(self) -> None:
        """Idempotent teardown, the JAX order: the exporter (it may
        render the fleet ledger until it stops serving), the heartbeat,
        then the fleet's pool."""
        if self.exporter is not None:
            self.exporter.close()
        if self.heartbeat is not None:
            self.heartbeat.close()
        if self.fleet is not None:
            self.fleet.close()


def build_health_plane(cfg: RunConfig, c: Components, *, vitals=None,
                       monitor: bool = False, anomaly=None, collect=None,
                       start_heartbeat: bool = True) -> HealthPlane:
    """The role's health plane from its flags: a heartbeat publisher
    when ``--heartbeat-interval`` > 0 (``vitals`` gives the body,
    ``collect`` extra fields), a FleetMonitor for the delta-consuming
    roles (``monitor=True``), and with ``--remediate`` the remediation
    engine, and with ``--obs-port`` the exporter (its ``/debug/profile``
    traces under ``<work-dir>/debug_traces/<hotkey>``). On a world only
    the coordinator beats and monitors (its writes are the gated ones,
    and N monitors would multiply the probe traffic); the exporter
    serves on every process, each its own registry (a rank past the
    first on one host needs its own port: ``--obs-port`` plus the
    rank)."""
    plane = HealthPlane()
    coordinator = multihost.is_coordinator()
    if cfg.heartbeat_interval > 0 and coordinator:
        from ..engine.health import FleetMonitor, HeartbeatPublisher
        if monitor:
            plane.fleet = FleetMonitor(c.transport, metrics=c.metrics,
                                       anomaly=anomaly)
            if cfg.remediate:
                from ..engine.remediate import (RemediationEngine,
                                                RemediationPolicy)
                rules = tuple(r.strip()
                              for r in cfg.quarantine_rules.split(",")
                              if r.strip())
                plane.remediation = RemediationEngine(
                    plane.fleet, metrics=c.metrics,
                    policy=RemediationPolicy(
                        quarantine_rules=rules,
                        probation_beats=cfg.probation_beats,
                        probation_rounds=cfg.probation_rounds,
                        score_decay=cfg.score_decay))
        plane.heartbeat = HeartbeatPublisher(
            c.transport, cfg.role, cfg.hotkey,
            interval=cfg.heartbeat_interval, vitals=vitals,
            collect=collect)
        if start_heartbeat:
            plane.heartbeat.start()
    elif cfg.remediate and coordinator:
        logger.warning(
            "--remediate has no effect without --heartbeat-interval > 0: "
            "remediation acts on SLO breaches, and breaches come from the "
            "heartbeat-fed FleetMonitor")
    if cfg.obs_port:
        from ..utils.obs_http import ObsHTTPExporter
        plane.exporter = ObsHTTPExporter(
            cfg.obs_port + multihost.process_index(), fleet=plane.fleet,
            role=cfg.role, profile_dir=os.path.join(
                cfg.work_dir, "debug_traces", cfg.hotkey))
        plane.exporter.start()
    return plane


def _note_idle_cards(role: str) -> None:
    """Log (once a build) that a role started as one process uses one of
    several cards, where the JAX role takes every chip."""
    import torch
    n = torch.cuda.device_count()
    if n > 1:
        logger.warning(
            "%s: one process uses one of this host's %d cards; "
            "torchrun --nproc-per-node %d -m "
            "distributedtraining_tpu_torch.neurons.%s <flags> runs it on "
            "all of them", role, n, n, role)


def role_mesh(cfg: RunConfig, model):
    """The mesh of the miner, the validator or the averager (JAX
    ``neurons/common.py:304-326``): over every process of the world when
    there are several, else none. A mesh that wants more processes than
    the world has raises, naming the launch."""
    spec = cfg.mesh
    n_params = (sum(v.numel() for v in model.state_dict().values())
                if spec.auto else 0)
    world = multihost.process_count()
    rcfg = resolve_mesh_config(
        n_devices=world, dp=spec.dp, fsdp=spec.fsdp, sp=spec.sp, tp=spec.tp,
        auto=spec.auto, model_params=n_params, dcn_dp=spec.dcn_dp)
    if world > 1:
        return multihost.pod_mesh(dp=rcfg.dp, fsdp=rcfg.fsdp, sp=rcfg.sp,
                                  tp=rcfg.tp, dcn_dp=spec.dcn_dp)
    if rcfg.n_devices > 1:
        raise SystemExit(
            f"mesh {rcfg.shape} (dp, fsdp, sp, tp) needs {rcfg.n_devices} "
            f"processes, one a device: start the {cfg.role} with torchrun "
            f"--nproc-per-node {rcfg.n_devices} (or --multihost-*)")
    return None


def _signed_transport(cfg: RunConfig, transport, address_store):
    """``--sign-artifacts`` (JAX ``neurons/common.py:394-432``): the
    coordinator loads (or generates and saves) the hotkey's wallet and
    registers its key, first write wins; every publish is signed and
    every fetch verified against the registered keys. The other ranks of
    a world hold no identity (their writes are gated) and only verify:
    N ranks generating into one wallet path would race, and the key one
    registered could lose the file to another's. The coordinator's
    verdict reaches every rank, so a different registered key (a rotated
    local wallet would publish artifacts every peer rejects) ends them
    all at once, none left waiting at its next collective."""
    from ..engine.train import broadcast_flag
    from ..transport.signed import SignedTransport
    from ..utils.identity import Identity
    wallet_path = cfg.wallet_path or os.path.join(
        cfg.work_dir, "wallets", f"{cfg.hotkey}.json")
    coordinator = multihost.is_coordinator()
    identity = None
    if coordinator:
        if os.path.exists(wallet_path):
            identity = Identity.load(wallet_path)
        else:
            identity = Identity.generate()
            identity.save(wallet_path)
            logger.info("generated signing identity %s at %s",
                        identity.hotkey, wallet_path)
    base_signer = cfg.base_signer or (
        cfg.hotkey if cfg.role == "averager" else None)
    signed = SignedTransport(transport, identity=identity,
                             pubkey_resolver=address_store.retrieve_pubkey,
                             base_signer=base_signer, my_hotkey=cfg.hotkey)
    registered = True
    if coordinator:
        try:
            address_store.store_pubkey(cfg.hotkey, identity.public_bytes)
        except ValueError:
            registered = False
    if multihost.process_count() > 1:
        registered = broadcast_flag(registered)
    if not registered:
        raise SystemExit(
            f"hotkey {cfg.hotkey} has a different registered pubkey; "
            f"restore the original wallet file or use a new hotkey")
    return signed


def base_mirrors(cfg: RunConfig) -> list[str]:
    """The ``--base-mirrors`` list (comma-separated hotkeys)."""
    return [m.strip() for m in (cfg.base_mirrors or "").split(",")
            if m.strip()]


def build_base_fetcher(cfg: RunConfig, c: Components):
    """The role's content-addressed base fetcher
    (``engine/basedist.BaseFetcher``) with ``--base-wire-v2`` (the
    default), else None (the monolithic pull). Mirrors come from
    ``--base-mirrors``; the averager's announce rider adds its own at
    fetch time."""
    if not cfg.base_wire_v2:
        return None
    from ..engine.basedist import BaseFetcher
    return BaseFetcher(c.transport, mirrors=base_mirrors(cfg),
                       store_bytes=cfg.base_store_mb * (1 << 20))
