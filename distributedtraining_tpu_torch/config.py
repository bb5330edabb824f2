"""Run configuration of the port's miner and averager — the port of the
JAX package's ``config.py`` for ``RunConfig.from_args(role, argv)`` with
``role`` ``"miner"`` or ``"averager"``.

Each role's parser takes every flag the JAX package's parser for that
role accepts, with the same spellings, destinations and defaults, so a
JAX command line parses unchanged. A value whose machinery the port has
not brought over yet raises NotImplementedError naming its slice
(:meth:`RunConfig.check_ported`). Some are JAX defaults and must be
turned off explicitly for now: for the miner ``--no-base-wire-v2``,
``--checkpoint-interval 0``, ``--no-anomaly-trace`` and ``--flight-events
0``; for the averager ``--strategy weighted``, ``--no-base-wire-v2``,
``--no-lineage`` and ``--flight-events 0``. Arguments are parsed only
when an entry point asks (never at import).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

_SLICES = "ROADMAP 'Slices of the port'"
ROLES = ("miner", "averager")


@dataclasses.dataclass
class MeshSpec:
    """dp x fsdp x sp x tp axis sizes (0 for dp: all visible devices)."""
    dp: int = 0
    fsdp: int = 1
    sp: int = 1
    tp: int = 1
    dcn_dp: int = 1
    auto: bool = False


@dataclasses.dataclass
class RunConfig:
    role: str = "miner"
    # identity / chain
    chain: str = "local"
    netuid: int = 25
    hotkey: str = "hotkey_0"
    wallet_name: str = "default"
    wallet_hotkey: str = "default"
    subtensor_network: str = "finney"
    epoch_length: int = 100
    resync_blocks: int = 0
    vpermit_stake_limit: float = 1000.0
    # storage / transport
    backend: str = "local"
    work_dir: str = "./hivetrain_run"
    my_repo_id: Optional[str] = None
    averaged_model_repo_id: Optional[str] = None
    sign_artifacts: bool = False
    wallet_path: Optional[str] = None
    base_signer: Optional[str] = None
    base_wire_v2: bool = True
    base_mirrors: str = ""
    base_mirror: bool = True
    base_store_mb: int = 1024
    # model / optimization
    model: str = "gpt2-124m"
    init_from: Optional[str] = None
    seq_len: int = 64
    eval_seq_len: int = 512
    batch_size: int = 8
    eval_batches: int = 12
    max_delta_abs: float = 1e3
    accept_quant: bool = True
    stale_deltas: Optional[str] = None
    learning_rate: float = 5e-4
    weight_decay: float = 0.01
    grad_clip: Optional[float] = None
    mu_dtype: Optional[str] = None
    lora_rank: int = 0
    lora_alpha: float = 16.0
    dataset: str = "auto"
    n_docs: int = 256
    tokenizer: str = "auto"
    fused_loss: bool = False
    accum_steps: int = 1
    prefetch_depth: int = 2
    delta_dtype: Optional[str] = None
    delta_density: float = 1.0 / 64.0
    wire_v2: bool = False
    wire_density: float = 1.0 / 64.0
    wire_quant: str = "int8"
    accept_wire_v2: bool = True
    logits_dtype: Optional[str] = None
    remat: Optional[bool] = None
    scan_blocks: bool = False
    compile_cache_dir: Optional[str] = None
    # mesh / multi-host
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    multihost_coordinator: Optional[str] = None
    multihost_processes: Optional[int] = None
    multihost_id: Optional[int] = None
    # cadences (seconds)
    send_interval: float = 800.0
    push_async: bool = True
    push_queue_depth: int = 1
    self_eval_interval: float = -1.0
    self_eval_patience: int = 3
    self_eval_margin: float = 0.1
    keep_optimizer_on_pull: bool = False
    checkpoint_interval: float = 600.0
    checkpoint_dir: Optional[str] = None
    check_update_interval: float = 300.0
    validation_interval: float = 1800.0
    val_cohort: int = 8
    val_pipeline_depth: int = 1
    averaging_interval: float = 1200.0
    ingest_workers: int = 4
    ingest_cache_mb: int = 2048
    # averager strategy
    strategy: str = "parameterized"
    publish_policy: str = "improved"
    merge_chunk: int = 8
    meta_epochs: int = 7
    genetic_population: int = 10
    genetic_generations: int = 10
    genetic_sigma: float = 0.1
    genetic_screen_batches: int = 2
    meta_lr: float = 0.01
    meta_optimizer: str = "adam"
    outer_momentum: float = 0.0
    outer_lr: float = 0.7
    # hierarchical aggregation, remediation, failover
    hier: str = ""
    hier_node: str = ""
    hier_nodes: str = ""
    hier_fanout: int = 0
    hier_wire_v2: bool = False
    remediate: bool = False
    quarantine_rules: str = "push_failure_streak,loss_divergence,stale_node"
    probation_beats: int = 3
    probation_rounds: int = 2
    score_decay: float = 0.25
    standby: bool = False
    failover_deadline: float = 0.0
    chaos_spec: Optional[str] = None
    # bounded runs
    max_steps: Optional[int] = None
    rounds: Optional[int] = None
    # observability
    metrics_path: Optional[str] = None
    metrics_rotate_mb: int = 0
    metrics_keep_segments: int = 3
    heartbeat_interval: float = 0.0
    obs_port: int = 0
    devprof: bool = True
    lineage: bool = True
    flight_events: int = 512
    log_every: int = 1000
    mlflow_uri: Optional[str] = None
    profile_dir: Optional[str] = None
    profile_steps: int = 5
    anomaly_trace: bool = True
    anomaly_dir: Optional[str] = None

    @classmethod
    def from_args(cls, role: str, argv: Sequence[str] | None = None
                  ) -> "RunConfig":
        ns = build_parser(role).parse_args(argv)
        mesh = MeshSpec(dp=ns.dp, fsdp=ns.fsdp, sp=ns.sp, tp=ns.tp,
                        dcn_dp=ns.dcn_dp, auto=ns.mesh_auto)
        fields = {f.name for f in dataclasses.fields(cls)} - {"mesh"}
        kw = {k: v for k, v in vars(ns).items() if k in fields}
        return cls(role=role, mesh=mesh, **kw)

    def check_ported(self, device: str = "cuda") -> None:
        """Raise NotImplementedError for the first value whose machinery
        is not ported, naming its slice. ``device`` is where the role
        will run: on the card, ``--fused-loss`` also needs a width the
        CE kernels take (the CPU's plain version takes any)."""
        m = self.mesh
        miner, averager = self.role == "miner", self.role == "averager"
        refused = [
            (self.backend == "hf",
             "--backend hf (the HF Hub transport needs the network)", 7),
            (self.chain != "local",
             f"--chain {self.chain} (the bittensor chain needs the "
             f"network)", 7),
            (self.my_repo_id is not None,
             "--my-repo-id (the chain's address store)", 5),
            (self.sign_artifacts, "--sign-artifacts", 5),
            (averager and self.strategy != "weighted",
             f"--strategy {self.strategy}, parameterized by default (pass "
             f"--strategy weighted)", 5),
            (self.base_wire_v2,
             "--base-wire-v2, on by default (pass --no-base-wire-v2)", 5),
            (miner and self.checkpoint_interval > 0,
             f"--checkpoint-interval {self.checkpoint_interval:g}, 600 by "
             f"default (pass --checkpoint-interval 0)", 5),
            (averager and self.lineage,
             "--lineage, on by default (pass --no-lineage)", 5),
            (miner and self.anomaly_trace,
             "--anomaly-trace, on by default (pass --no-anomaly-trace)", 7),
            (self.flight_events > 0,
             f"--flight-events {self.flight_events}, 512 by default (pass "
             f"--flight-events 0)", 7),
            (self.lora_rank > 0, "--lora-rank > 0", 7),
            (m.auto or max(m.fsdp, m.sp, m.tp, m.dcn_dp, m.dp) > 1
             or self.multihost_coordinator is not None
             or self.multihost_processes is not None,
             "mesh axes > 1 (--dp/--fsdp/--sp/--tp/--dcn-dp/--mesh-auto, "
             "multi-host)", 7),
            (self.scan_blocks, "--scan-blocks", 7),
            (bool(self.remat), "--remat", 7),
            (self.mu_dtype is not None, f"--mu-dtype {self.mu_dtype}", 7),
            (self.delta_dtype in ("int8", "sparse8"),
             f"--delta-dtype {self.delta_dtype}", 5),
            (averager and self.outer_momentum > 0,
             "--outer-momentum > 0 (OuterOptMerge)", 5),
            (averager and self.hier != "", f"--hier {self.hier}", 5),
            (averager and self.standby, "--standby (the failover lease)", 5),
            (averager and self.remediate, "--remediate", 7),
            (self.init_from is not None, "--init-from", 7),
            (self.heartbeat_interval > 0, "--heartbeat-interval > 0", 7),
            (self.obs_port != 0, "--obs-port", 7),
            (self.compile_cache_dir is not None,
             "--compile-cache-dir (a JAX compilation cache)", 7),
            (self.metrics_path is not None,
             "--metrics-path (the JSONL metrics sink)", 7),
            (self.mlflow_uri is not None, "--mlflow-uri", 7),
            (self.profile_dir is not None, "--profile-dir", 7),
            (self.chaos_spec is not None, "--chaos-spec", 7),
        ]
        for hit, what, slice_no in refused:
            if hit:
                raise NotImplementedError(
                    f"{what} is not ported to the PyTorch {self.role} yet: "
                    f"{_SLICES}, slice {slice_no}")
        if self.fused_loss and device == "cuda":
            from .models.gpt2 import PRESETS
            from .ops.fused_ce import refuse_width
            preset = PRESETS.get(self.model)
            if preset is not None:
                refuse_width(preset.n_embd, preset.compute_dtype())


def _nonneg_float(value: str) -> float:
    f = float(value)
    if f < 0:
        raise argparse.ArgumentTypeError(
            f"{value}: must be >= 0 (0 disables)")
    return f


def _dataset_arg(value: str) -> str:
    if value in ("auto", "wikitext", "synthetic") or \
            value.startswith("files:"):
        return value
    raise argparse.ArgumentTypeError(
        f"{value!r}: expected auto, wikitext, synthetic, or files:<glob>")


# (flags, argparse keywords) of the JAX package's miner parser, in its
# order; help strings are the port's. The averager's parser takes these
# less _MINER_ONLY, plus _AVERAGER_FLAGS.
_D = RunConfig()
_M = MeshSpec()
_FLAGS: list[tuple[tuple[str, ...], dict]] = [
    (("--chain",), dict(choices=("local", "bittensor"), default=_D.chain)),
    (("--netuid",), dict(type=int, default=_D.netuid)),
    (("--hotkey",), dict(default=_D.hotkey)),
    (("--wallet-name",), dict(dest="wallet_name", default=_D.wallet_name)),
    (("--wallet-hotkey",), dict(dest="wallet_hotkey",
                                default=_D.wallet_hotkey)),
    (("--subtensor-network",), dict(dest="subtensor_network",
                                    default=_D.subtensor_network)),
    (("--epoch-length",), dict(dest="epoch_length", type=int,
                               default=_D.epoch_length)),
    (("--resync-blocks",), dict(dest="resync_blocks", type=int,
                                default=_D.resync_blocks)),
    (("--vpermit-stake-limit",), dict(dest="vpermit_stake_limit",
                                      type=float,
                                      default=_D.vpermit_stake_limit)),
    (("--backend",), dict(choices=("local", "memory", "hf"),
                          default=_D.backend)),
    (("--work-dir",), dict(dest="work_dir", default=_D.work_dir)),
    (("--my-repo-id",), dict(dest="my_repo_id", default=None)),
    (("--averaged-model-repo-id",), dict(dest="averaged_model_repo_id",
                                         default=None)),
    (("--sign-artifacts",), dict(dest="sign_artifacts",
                                 action="store_true")),
    (("--wallet-path",), dict(dest="wallet_path", default=None)),
    (("--base-signer",), dict(dest="base_signer", default=None)),
    (("--base-wire-v2",), dict(dest="base_wire_v2", action="store_true",
                               default=_D.base_wire_v2)),
    (("--no-base-wire-v2",), dict(dest="base_wire_v2",
                                  action="store_false",
                                  help="monolithic base pulls (required "
                                       "by the port for now)")),
    (("--base-mirrors",), dict(dest="base_mirrors",
                               default=_D.base_mirrors)),
    (("--no-base-mirror",), dict(dest="base_mirror", action="store_false",
                                 default=_D.base_mirror)),
    (("--base-store-mb",), dict(dest="base_store_mb", type=int,
                                default=_D.base_store_mb)),
    (("--model",), dict(default=_D.model, help="GPT-2 preset name")),
    (("--init-from",), dict(dest="init_from", default=None)),
    (("--seq-len",), dict(dest="seq_len", type=int, default=_D.seq_len)),
    (("--eval-seq-len",), dict(dest="eval_seq_len", type=int,
                               default=_D.eval_seq_len)),
    (("--batch-size",), dict(dest="batch_size", type=int,
                             default=_D.batch_size)),
    (("--eval-batches",), dict(dest="eval_batches", type=int,
                               default=_D.eval_batches)),
    (("--learning-rate",), dict(dest="learning_rate", type=float,
                                default=_D.learning_rate)),
    (("--weight-decay",), dict(dest="weight_decay", type=float,
                               default=_D.weight_decay)),
    (("--grad-clip",), dict(dest="grad_clip", type=float, default=None)),
    (("--mu-dtype",), dict(dest="mu_dtype",
                           choices=("float32", "bfloat16"),
                           default=_D.mu_dtype)),
    (("--lora-rank",), dict(dest="lora_rank", type=int,
                            default=_D.lora_rank)),
    (("--lora-alpha",), dict(dest="lora_alpha", type=float,
                             default=_D.lora_alpha)),
    (("--dataset",), dict(default=_D.dataset, type=_dataset_arg,
                          help="synthetic (the port's only corpus so far)")),
    (("--n-docs",), dict(dest="n_docs", type=int, default=_D.n_docs)),
    (("--tokenizer",), dict(default=_D.tokenizer,
                            help="byte | word (the port has no HF "
                                 "tokenizer)")),
    (("--fused-loss",), dict(dest="fused_loss", action="store_true",
                             help="the loss through the fused CE kernels "
                                  "(no [batch, seq, vocab] logits)")),
    (("--accum-steps",), dict(dest="accum_steps", type=int,
                              default=_D.accum_steps)),
    (("--prefetch-depth",), dict(dest="prefetch_depth", type=int,
                                 default=_D.prefetch_depth,
                                 help="batches the input thread keeps "
                                      "ready (0 disables)")),
    (("--delta-dtype",), dict(dest="delta_dtype",
                              choices=("float32", "bfloat16", "int8",
                                       "sparse8"),
                              default=_D.delta_dtype)),
    (("--delta-density",), dict(dest="delta_density", type=float,
                                default=_D.delta_density)),
    (("--wire-v2",), dict(dest="wire_v2", action="store_true",
                          default=_D.wire_v2)),
    (("--wire-density",), dict(dest="wire_density", type=float,
                               default=_D.wire_density)),
    (("--wire-quant",), dict(dest="wire_quant", choices=("int8", "none"),
                             default=_D.wire_quant)),
    (("--logits-dtype",), dict(dest="logits_dtype",
                               choices=("float32", "bfloat16"),
                               default=_D.logits_dtype)),
    (("--remat",), dict(dest="remat", action="store_true", default=None)),
    (("--no-remat",), dict(dest="remat", action="store_false")),
    (("--scan-blocks",), dict(dest="scan_blocks", action="store_true")),
    (("--compile-cache-dir",), dict(dest="compile_cache_dir",
                                    default=_D.compile_cache_dir)),
    (("--dp",), dict(type=int, default=_M.dp)),
    (("--fsdp",), dict(type=int, default=_M.fsdp)),
    (("--sp",), dict(type=int, default=_M.sp)),
    (("--tp",), dict(type=int, default=_M.tp)),
    (("--mesh-auto",), dict(dest="mesh_auto", action="store_true")),
    (("--dcn-dp",), dict(dest="dcn_dp", type=int, default=_M.dcn_dp)),
    (("--multihost-coordinator",), dict(dest="multihost_coordinator",
                                        default=None, metavar="HOST:PORT")),
    (("--multihost-processes",), dict(dest="multihost_processes",
                                      type=int, default=None)),
    (("--multihost-id",), dict(dest="multihost_id", type=int,
                               default=None)),
    (("--send-interval",), dict(dest="send_interval", type=float,
                                default=_D.send_interval)),
    (("--push-async",), dict(dest="push_async", action="store_true",
                             default=_D.push_async)),
    (("--no-push-async",), dict(dest="push_async", action="store_false")),
    (("--push-queue-depth",), dict(dest="push_queue_depth", type=int,
                                   default=_D.push_queue_depth)),
    (("--self-eval-interval",), dict(dest="self_eval_interval", type=float,
                                     default=_D.self_eval_interval,
                                     help="-1 follows --send-interval, 0 "
                                          "disables the guard")),
    (("--self-eval-patience",), dict(dest="self_eval_patience", type=int,
                                     default=_D.self_eval_patience)),
    (("--self-eval-margin",), dict(dest="self_eval_margin", type=float,
                                   default=_D.self_eval_margin)),
    (("--keep-optimizer-on-pull",), dict(dest="keep_optimizer_on_pull",
                                         action="store_true",
                                         default=_D.keep_optimizer_on_pull)),
    (("--checkpoint-interval",), dict(dest="checkpoint_interval",
                                      type=float,
                                      default=_D.checkpoint_interval,
                                      help="0 (required by the port for "
                                           "now) disables checkpoints")),
    (("--checkpoint-dir",), dict(dest="checkpoint_dir", default=None)),
    (("--check-update-interval",), dict(dest="check_update_interval",
                                        type=float,
                                        default=_D.check_update_interval)),
    (("--validation-interval",), dict(dest="validation_interval",
                                      type=float,
                                      default=_D.validation_interval)),
    (("--val-cohort",), dict(dest="val_cohort", type=int,
                             default=_D.val_cohort)),
    (("--val-pipeline-depth",), dict(dest="val_pipeline_depth", type=int,
                                     default=_D.val_pipeline_depth)),
    (("--averaging-interval",), dict(dest="averaging_interval", type=float,
                                     default=_D.averaging_interval)),
    (("--chaos-spec",), dict(dest="chaos_spec", default=None)),
    (("--max-steps",), dict(dest="max_steps", type=int, default=None)),
    (("--rounds",), dict(type=int, default=None)),
    (("--metrics-path",), dict(dest="metrics_path", default=None)),
    (("--metrics-rotate-mb",), dict(dest="metrics_rotate_mb", type=int,
                                    default=_D.metrics_rotate_mb)),
    (("--metrics-keep-segments",), dict(dest="metrics_keep_segments",
                                        type=int,
                                        default=_D.metrics_keep_segments)),
    (("--heartbeat-interval",), dict(dest="heartbeat_interval",
                                     type=_nonneg_float,
                                     default=_D.heartbeat_interval)),
    (("--obs-port",), dict(dest="obs_port", type=int,
                           default=_D.obs_port)),
    (("--no-devprof",), dict(dest="devprof", action="store_false",
                             default=_D.devprof)),
    (("--no-lineage",), dict(dest="lineage", action="store_false",
                             default=_D.lineage)),
    (("--flight-events",), dict(dest="flight_events", type=int,
                                default=_D.flight_events,
                                help="0 (required by the port for now) "
                                     "disables the flight recorder")),
    (("--log-every",), dict(dest="log_every", type=int,
                            default=_D.log_every)),
    (("--mlflow-uri",), dict(dest="mlflow_uri", default=None)),
    (("--profile-dir",), dict(dest="profile_dir", default=None)),
    (("--profile-steps",), dict(dest="profile_steps", type=int,
                                default=_D.profile_steps)),
    (("--no-anomaly-trace",), dict(dest="anomaly_trace",
                                   action="store_false",
                                   default=_D.anomaly_trace,
                                   help="required by the port for now")),
    (("--anomaly-dir",), dict(dest="anomaly_dir", default=None)),
]


_MINER_ONLY = frozenset((
    "--delta-dtype", "--delta-density", "--wire-v2", "--wire-density",
    "--wire-quant", "--push-async", "--no-push-async", "--push-queue-depth",
    "--checkpoint-interval", "--checkpoint-dir", "--log-every",
    "--profile-dir", "--profile-steps", "--no-anomaly-trace",
    "--anomaly-dir"))

# the JAX averager's own flags (its delta-consumer, ingest, strategy,
# hierarchy and resilience groups)
_AVERAGER_FLAGS: list[tuple[tuple[str, ...], dict]] = [
    (("--max-delta-abs",), dict(dest="max_delta_abs", type=_nonneg_float,
                                default=_D.max_delta_abs,
                                help="admission cap on max |value| "
                                     "(0 disables)")),
    (("--no-accept-quant",), dict(dest="accept_quant", action="store_false",
                                  default=_D.accept_quant)),
    (("--no-wire-v2",), dict(dest="accept_wire_v2", action="store_false",
                             default=_D.accept_wire_v2,
                             help="refuse wire-v2 shard manifests")),
    (("--stale-deltas",), dict(dest="stale_deltas",
                               choices=("skip", "accept"),
                               default=_D.stale_deltas)),
    (("--ingest-workers",), dict(dest="ingest_workers", type=int,
                                 default=_D.ingest_workers)),
    (("--ingest-cache-mb",), dict(dest="ingest_cache_mb", type=int,
                                  default=_D.ingest_cache_mb)),
    (("--strategy",), dict(choices=("weighted", "parameterized", "genetic"),
                           default=_D.strategy,
                           help="weighted (the port's only strategy so "
                                "far)")),
    (("--merge-chunk",), dict(dest="merge_chunk", type=int,
                              default=_D.merge_chunk)),
    (("--meta-epochs",), dict(dest="meta_epochs", type=int,
                              default=_D.meta_epochs)),
    (("--outer-momentum",), dict(dest="outer_momentum", type=float,
                                 default=_D.outer_momentum)),
    (("--outer-lr",), dict(dest="outer_lr", type=float,
                           default=_D.outer_lr)),
    (("--meta-lr",), dict(dest="meta_lr", type=float, default=_D.meta_lr)),
    (("--meta-optimizer",), dict(dest="meta_optimizer",
                                 choices=("adam", "sgd"),
                                 default=_D.meta_optimizer)),
    (("--genetic-population",), dict(dest="genetic_population", type=int,
                                     default=_D.genetic_population)),
    (("--genetic-generations",), dict(dest="genetic_generations", type=int,
                                      default=_D.genetic_generations)),
    (("--publish-policy",), dict(dest="publish_policy",
                                 choices=("improved", "always"),
                                 default=_D.publish_policy)),
    (("--genetic-screen-batches",), dict(dest="genetic_screen_batches",
                                         type=int,
                                         default=_D.genetic_screen_batches)),
    (("--genetic-sigma",), dict(dest="genetic_sigma", type=float,
                                default=_D.genetic_sigma)),
    (("--hier",), dict(choices=("", "sub", "root"), default=_D.hier)),
    (("--hier-node",), dict(dest="hier_node", default=_D.hier_node)),
    (("--hier-nodes",), dict(dest="hier_nodes", default=_D.hier_nodes)),
    (("--hier-fanout",), dict(dest="hier_fanout", type=int,
                              default=_D.hier_fanout)),
    (("--hier-wire-v2",), dict(dest="hier_wire_v2", action="store_true",
                               default=_D.hier_wire_v2)),
    (("--remediate",), dict(dest="remediate", action="store_true",
                            default=_D.remediate)),
    (("--quarantine-rules",), dict(dest="quarantine_rules",
                                   default=_D.quarantine_rules)),
    (("--probation-beats",), dict(dest="probation_beats", type=int,
                                  default=_D.probation_beats)),
    (("--probation-rounds",), dict(dest="probation_rounds", type=int,
                                   default=_D.probation_rounds)),
    (("--score-decay",), dict(dest="score_decay", type=float,
                              default=_D.score_decay)),
    (("--standby",), dict(dest="standby", action="store_true",
                          default=_D.standby)),
    (("--failover-deadline",), dict(dest="failover_deadline",
                                    type=_nonneg_float,
                                    default=_D.failover_deadline)),
]


def build_parser(role: str = "miner") -> argparse.ArgumentParser:
    """The parser of ``role`` (``"miner"`` or ``"averager"``)."""
    if role not in ROLES:
        raise NotImplementedError(
            f"role {role!r}: the port's validator is slice 5 and its server "
            f"slice 6 ({_SLICES})")
    p = argparse.ArgumentParser(
        prog=f"python -m distributedtraining_tpu_torch.neurons.{role}",
        description=f"distributedtraining {role}, PyTorch/CUDA port")
    for flags, kw in _FLAGS:
        if role == "miner" or flags[0] not in _MINER_ONLY:
            p.add_argument(*flags, **kw)
    if role == "averager":
        for flags, kw in _AVERAGER_FLAGS:
            p.add_argument(*flags, **kw)
    return p
