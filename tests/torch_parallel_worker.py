"""One rank of a gloo world for tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py CASE RANK WORLD PORT IO_DIR

reads ``IO_DIR/args.json`` and ``IO_DIR/inputs.npz``, runs CASE on this
rank of a ``torch.distributed`` world over gloo on the CPU, and writes
``IO_DIR/out_RANK.npz``. It imports torch and the port only (no JAX),
so a world of 8 starts in seconds; the test holds the results against
the JAX package.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from distributedtraining_tpu_torch.parallel import (  # noqa: E402
    Mesh, MeshConfig, batch_rows, multihost, shard_params)


# the miner case's wait for each push's upload
PUSH_WAIT_S = 120.0


def case_ce(mesh: Mesh, args: dict, inp) -> dict:
    """The sharded fused CE: this rank's rows and head shard, the loss,
    dh of the local rows and dW of the shard."""
    from distributedtraining_tpu_torch.ops.losses import \
        fused_linear_cross_entropy
    rows = batch_rows({"h": inp["hidden"], "y": inp["labels"],
                       "m": inp["mask"]}, mesh)
    h = torch.from_numpy(np.array(rows["h"])).requires_grad_()
    w = shard_params({"wte": inp["head"]}, mesh)["wte"].requires_grad_()
    loss, count = fused_linear_cross_entropy(
        h, w, torch.from_numpy(np.array(rows["y"])),
        torch.from_numpy(np.array(rows["m"])), mesh=mesh)
    loss.backward()
    return {"loss": loss.detach().numpy(), "count": count.numpy(),
            "dh": h.grad.numpy(), "dw": w.grad.numpy()}


def _model(preset: str, overrides: dict):
    """The structure of ``preset`` (either family) with ``overrides``."""
    import dataclasses

    from distributedtraining_tpu_torch import models
    cfg = dataclasses.replace(models.family(preset).PRESETS[preset],
                              **overrides)
    return models.make_model(cfg)[0]


def _engine(mesh: Mesh, args: dict):
    """The mesh TrainEngine of ``args`` (preset, overrides, fused, accum,
    lr, grad_clip) on the CPU."""
    from distributedtraining_tpu_torch.engine.train import (
        TrainEngine, default_optimizer)
    model = _model(args["preset"], args["overrides"])
    return TrainEngine(model, mesh=mesh, fused_loss=args["fused"],
                       accum_steps=args["accum"],
                       optimizer=default_optimizer(
                           args["lr"], grad_clip=args["grad_clip"]),
                       device="cpu")


def _tree(inp) -> dict:
    return {k[len("p/"):]: inp[k] for k in inp.files if k.startswith("p/")}


def case_engine(mesh: Mesh, args: dict, inp) -> dict:
    """``args["steps"]`` mesh train steps on this rank's rows of the
    global batches; the losses, the final shards (params, mu, nu) and,
    from every rank, the gathered params."""
    eng = _engine(mesh, args)
    state = eng.init_state(_tree(inp))
    losses, tokens = [], []
    for ids in inp["input_ids"]:
        batch = eng.place_batch(batch_rows({"input_ids": ids}, mesh))
        state, m = eng.train_step(state, batch)
        losses.append(float(m["loss"]))
        tokens.append(float(m["tokens"]))
    out = {"losses": np.array(losses), "tokens": np.array(tokens)}
    for name, tree in (("p", state.params), ("mu", state.opt_state.mu),
                       ("nu", state.opt_state.nu)):
        out.update({f"{name}/{k}": v.detach().numpy()
                    for k, v in tree.items()})
    out.update({f"full/{k}": v.numpy()
                for k, v in eng.gather(state.params).items()})
    return out


def case_tp(mesh: Mesh, args: dict, inp) -> dict:
    """The tp blocks: :func:`case_engine`'s steps and the block routes
    they counted; ``sharding.gather_heads`` of a known ``c_attn`` kernel
    and bias and the shard gradients of a cotangent of (rank + 1) times
    the output; the raw gradients of one loss (before the sums over dp
    and fsdp); and the collectives and sharding counts of one more step,
    set to 0 just before it."""
    from distributedtraining_tpu_torch.parallel import collectives, sharding
    sharding.reset_counts()
    out = case_engine(mesh, args, inp)
    out.update({f"routes/{k}": v for k, v in sharding.counts.items()})
    for name, spec in (("kernel", ("fsdp", "tp")), ("bias", ("tp",))):
        key = f"h_0.c_attn.{name}"
        shard = shard_params({key: inp[f"qkv/{name}"]}, mesh)[key]
        shard.requires_grad_()
        local = sharding.gather_heads(shard, mesh, spec)
        local.backward((mesh.rank + 1) * local.detach())
        out[f"heads/{name}"] = local.detach().numpy()
        out[f"heads_grad/{name}"] = shard.grad.numpy()
    eng = _engine(mesh, args)
    batch = eng.place_batch(batch_rows({"input_ids": inp["input_ids"][0]},
                                       mesh))
    params = eng.place_params(_tree(inp))
    loss, _ = eng._loss(params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    out.update({f"grad/{k}": g.numpy() for k, g in zip(params, grads)})
    state = eng.init_state(_tree(inp))
    collectives.reset_counts()
    sharding.reset_counts()
    eng.train_step(state, batch)
    for (op, backend, route), c in collectives.counts.items():
        out.update({f"coll/{op}/{backend}/{route}/{k}": v
                    for k, v in c.items()})
    out.update({f"count/{k}": v for k, v in sharding.counts.items()})
    return out


def case_miner(mesh: Mesh, args: dict, inp) -> dict:
    """The miner CLI (``neurons.miner.main``) in this process of the
    world: the shards right after bootstrap, the report, and the
    gathered params and base at the end."""
    from distributedtraining_tpu_torch.engine import publish
    from distributedtraining_tpu_torch.engine import train as ttrain
    from distributedtraining_tpu_torch.neurons import miner
    seen = {}
    submit = publish.DeltaPublisher.submit

    def drained(self, *a, **kw):
        # each push uploaded before the loop goes on: the publisher's
        # queue supersedes a pending push that the next one overtakes,
        # which a loaded host makes happen, and the test counts pushes
        dropped = submit(self, *a, **kw)
        if not self.flush(timeout=PUSH_WAIT_S):
            raise RuntimeError(f"a push was not uploaded in {PUSH_WAIT_S} s")
        return dropped

    publish.DeltaPublisher.submit = drained
    bootstrap = ttrain.MinerLoop.bootstrap

    def watched(self, *a, **kw):
        bootstrap(self, *a, **kw)
        seen["loop"] = self
        seen["boot"] = {k: v.detach().clone()
                        for k, v in self.state.params.items()}
        seen["boot_step"] = self.state.step
        seen["boot_count"] = self.state.opt_state.count

    ttrain.MinerLoop.bootstrap = watched
    rc = miner.main(args["argv"])
    loop = seen["loop"]
    full = loop.engine.gather(loop.state.params)      # collectives
    base = loop.engine.gather(loop.base_params)
    out = {"rc": rc, "pushes": loop.report.pushes,
           "superseded": loop.report.pushes_superseded,
           "steps": loop.report.steps, "base_pulls": loop.report.base_pulls,
           "boot_step": seen["boot_step"], "boot_count": seen["boot_count"],
           "step": loop.state.step, "count": loop.state.opt_state.count,
           "coords": json.dumps(loop.engine.mesh.coords)}
    for name, tree in (("boot", seen["boot"]), ("full", full),
                       ("base", base)):
        out.update({f"{name}/{k}": v.detach().numpy()
                    for k, v in tree.items()})
    return out


def case_bpe_build(mesh: Mesh, args: dict, inp) -> dict:
    """The miner's build (``neurons.common.build``) with ``--tokenizer
    bpe`` and no saved file, the BPE's corpus the files of
    ``args["corpus"]``: how often this rank trained and loaded it, and
    its ids of ``args["text"]``."""
    from distributedtraining_tpu_torch.config import RunConfig
    from distributedtraining_tpu_torch.data import bpe
    from distributedtraining_tpu_torch.neurons import common
    files = bpe.corpus_files((args["corpus"],))
    bpe.corpus_files = lambda *a, **kw: list(files)
    calls = {"train": 0, "load": 0}
    for name in calls:
        real = getattr(bpe.BPETokenizer, name).__func__

        def counted(cls, *a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(cls, *a, **kw)

        setattr(bpe.BPETokenizer, name, classmethod(counted))
    c = common.build(RunConfig.from_args("miner", args["argv"]))
    return {"trains": calls["train"], "loads": calls["load"],
            "ids": json.dumps(c.tokenizer.encode(args["text"]))}


def case_collectives(mesh: Mesh, args: dict, inp) -> dict:
    """Each differentiable collective's value and its backward on a
    known input: x = (rank + 1) * arange, a cotangent of
    (rank + 1) * ones."""
    from distributedtraining_tpu_torch.parallel import collectives as coll
    r = mesh.rank + 1
    out = {}
    for name, fn in (("all_gather", lambda x: coll.all_gather(
                          x, mesh, "fsdp", 1)),
                     ("reduce_scatter", lambda x: coll.reduce_scatter(
                         x, mesh, "fsdp", 1)),
                     ("all_reduce", lambda x: coll.all_reduce(
                         x, mesh, ("dp", "fsdp"))),
                     ("copy_to", lambda x: coll.copy_to(x, mesh, "fsdp"))):
        x = (r * torch.arange(12.0).reshape(3, 4)).requires_grad_()
        y = fn(x)
        y.backward(r * torch.ones_like(y))
        out[f"{name}/y"] = y.detach().numpy()
        out[f"{name}/dx"] = x.grad.numpy()
    return out


def case_pod(mesh: Mesh, args: dict, inp) -> dict:
    """The pod helpers: every rank gets the coordinator's value, and the
    coordinator's failed base read raises on every rank."""
    from distributedtraining_tpu_torch.chain.base import Metagraph
    from distributedtraining_tpu_torch.engine import train as ttrain
    coord = mesh.rank == 0
    out = {"json": json.dumps(ttrain.broadcast_json(
        {"rank": mesh.rank, "x": [1.5, None]})),
        "bytes": ttrain.broadcast_optional_bytes(
            b"\x00payload" if coord else b"other") or b"",
        "none_bytes": ttrain.broadcast_optional_bytes(None) is None,
        "empty_bytes": ttrain.broadcast_optional_bytes(
            b"" if coord else b"x") == b"",
        "flag": ttrain.broadcast_flag(coord),
        "agree": ttrain.all_ranks_agree(coord)}
    template = {"a": {"k": np.zeros((2, 3), np.float32)},
                "b": np.zeros((4,), np.int32)}
    tree = ttrain.broadcast_optional_tree(template, lambda: {
        "a": {"k": np.full((2, 3), 7.0, np.float64)},
        "b": torch.arange(4, dtype=torch.int32)})
    out["tree_a"] = tree["a"]["k"].numpy()
    out["tree_b"] = tree["b"].numpy()
    out["tree_none"] = ttrain.broadcast_optional_tree(
        template, lambda: None) is None

    class Chain:
        def sync(self):
            return Metagraph(hotkeys=[f"h{mesh.rank}"], uids=[mesh.rank],
                             stakes=[1.0], block=10 + mesh.rank)

    out["metagraph"] = json.dumps(ttrain.broadcast_metagraph(Chain()).__dict__)

    class Transport:
        def __init__(self, rev, fail=False):
            self.rev, self.fail = rev, fail

        def base_revision(self):
            if self.fail:
                raise OSError("partitioned")
            return self.rev

        def fetch_base(self, template):
            return {"a": {"k": np.ones((2, 3), np.float32)},
                    "b": np.arange(4, dtype=np.int32)}, self.rev

        def fetch_delta_meta(self, hotkey):
            return {"base_revision": self.rev}

    rev = "r0" if coord else "r-other"
    got = ttrain.broadcast_base_fetch(Transport(rev), template, None)
    out["fetch_rev"] = got[1]
    out["fetch_a"] = got[0]["a"]["k"].numpy()
    out["fetch_current"] = ttrain.broadcast_base_fetch(
        Transport(rev), template, rev) is None
    try:
        ttrain.broadcast_base_fetch(Transport(rev, fail=coord), template,
                                    None)
        out["fetch_raised"] = False
    except OSError:
        out["fetch_raised"] = True
    out["stale"] = ttrain.stale_submission(Transport(rev), "h", "r1",
                                           multi=True)
    out["not_stale"] = ttrain.stale_submission(Transport(rev), "h", "r0",
                                               multi=True)
    published = []

    class Inner:
        def publish_delta(self, *a):
            published.append(a)
            return "rev"

        def fetch_base_bytes(self):
            return b"read"

    gated, _ = multihost.gate_io(Inner(), None)
    out["publish_ret"] = str(gated.publish_delta("h", {}))
    out["published"] = len(published)
    out["read"] = gated.fetch_base_bytes()
    return out


def case_regather(mesh: Mesh, args: dict, inp) -> dict:
    """One fused-loss forward and backward of the mesh engine with
    ``sharding.regathered`` and, for comparison, with its registry but
    without its hooks: the gathered parameters still alive after each
    forward, the counts, the loss and the gradients."""
    import contextlib
    import dataclasses
    import gc

    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.models import gpt2
    from distributedtraining_tpu_torch.parallel import sharding as sh
    cfg = dataclasses.replace(gpt2.PRESETS[args["preset"]],
                              **args["overrides"])
    model, _ = gpt2.make_model(cfg)
    eng = TrainEngine(model, mesh=mesh, fused_loss=True, device="cpu")
    tree = {k[len("p/"):]: inp[k] for k in inp.files if k.startswith("p/")}
    batch = eng.place_batch(batch_rows({"input_ids": inp["input_ids"]},
                                       mesh))
    hooked, seen = sh.regathered, []

    @contextlib.contextmanager
    def with_hooks():
        with hooked():
            seen.append(sh._live)
            yield

    @contextlib.contextmanager
    def registry_only():
        prev, sh._live = sh._live, {}
        seen.append(sh._live)
        try:
            yield
        finally:
            sh._live = prev

    out = {}
    for name, ctx in (("on", with_hooks), ("off", registry_only)):
        sh.regathered = ctx
        sh.reset_counts()
        params = eng.place_params(tree)
        loss, _ = eng._loss(params, batch)
        gc.collect()
        out[f"{name}/alive"] = sum(e[0]() is not None
                                   for e in seen[-1].values())
        loss.backward()
        out[f"{name}/loss"] = loss.detach().numpy()
        out.update({f"{name}/count/{k}": v for k, v in sh.counts.items()})
        out.update({f"{name}/grad/{k}": v.grad.numpy()
                    for k, v in params.items()})
    sh.regathered = hooked
    return out


def _sp_engine_run(e: dict, inp) -> dict:
    """One engine of ``args["engines"]`` (:func:`case_sp`,
    :func:`case_llama`): its mesh, its preset (``tiny`` unless named),
    fused or not, its model overrides (``attention_impl``, ``remat``,
    ``scan_blocks``: the inputs' unrolled tree is then stacked),
    ``args["steps"]`` AdamW steps on this rank's rows and positions of
    the global batches (packed ones carry segment ids, positions and a
    loss mask); the losses, the block routes those steps took, the final
    shards and the gathered tree."""
    from distributedtraining_tpu_torch.engine.train import (
        TrainEngine, default_optimizer)
    from distributedtraining_tpu_torch.parallel import sharding
    mesh = Mesh(MeshConfig(**e["mesh"]))
    model = _model(e.get("preset", "tiny"), e["overrides"])
    sharding.reset_counts()
    eng = TrainEngine(model, mesh=mesh, fused_loss=e["fused"],
                      optimizer=default_optimizer(e["lr"],
                                                  grad_clip=e["grad_clip"]),
                      device="cpu")
    keys = ("input_ids", "segment_ids", "position_ids", "loss_mask") \
        if e["packed"] else ("input_ids",)
    init = _tree(inp)
    if model.cfg.scan_blocks:   # the unrolled inputs, stacked
        from distributedtraining_tpu_torch.models import stack_blocks
        init = stack_blocks(model, init)
    state = eng.init_state(init)
    losses, tokens = [], []
    for i in range(inp["input_ids"].shape[0]):
        batch = batch_rows({k: inp[k][i] for k in keys}, mesh)
        state, m = eng.train_step(state, eng.place_batch(batch))
        losses.append(float(m["loss"]))
        tokens.append(float(m["tokens"]))
    out = {"losses": np.array(losses), "tokens": np.array(tokens)}
    out.update({f"routes/{k}": v for k, v in sharding.counts.items()
                if k.startswith("tp_")})
    for name, tree in (("p", state.params), ("mu", state.opt_state.mu)):
        out.update({f"{name}/{k}": v.detach().numpy()
                    for k, v in tree.items()})
    out.update({f"full/{k}": v.numpy()
                for k, v in eng.gather(state.params).items()})
    # one loss and its gradient, summed over the data axes as a step
    # sums it, on the first batch
    batch = eng.place_batch(batch_rows({k: inp[k][0] for k in keys}, mesh))
    params = eng.place_params(init)
    loss, count = eng._loss(params, batch)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    eng._sum_grads(grads)
    # evaluate takes whole rows, each rank cutting its positions
    eval0, _ = eng.evaluate(params, [{k: inp[k][0] for k in keys}])
    out.update({"loss0": loss.detach().numpy(), "count0": count.numpy(),
                "grad0/wte": grads["wte"].numpy(), "eval0": eval0})
    return out


def case_llama(mesh: Mesh, args: dict, inp) -> dict:
    """The Llama engines of ``args["engines"]``, each on its own mesh of
    this world (:func:`_sp_engine_run` with a Llama preset)."""
    out = {}
    for name, e in args["engines"].items():
        out.update({f"{name}/{k}": v
                    for k, v in _sp_engine_run(e, inp).items()})
    return out


def case_sp(mesh: Mesh, args: dict, inp) -> dict:
    """Sequence parallelism: ``ops.ring_attention`` on this rank's
    blocks of global q, k, v (f32) for each mesh of ``args["ring"]``,
    its output and the gradients of a cotangent (the ring passes of the
    forward and of the backward counted apart); then each engine of
    ``args["engines"]`` (:func:`_sp_engine_run`)."""
    from distributedtraining_tpu_torch.ops.ring_attention import \
        ring_attention
    from distributedtraining_tpu_torch.parallel import collectives
    out = {}
    for name, kw in args["ring"].items():
        m = Mesh(MeshConfig(**kw))
        n, i = m.size("sp"), m.index("sp")
        per = inp["q"].shape[1] // n
        q, k, v = (torch.from_numpy(inp[x][:, i * per:(i + 1) * per].copy())
                   .requires_grad_() for x in ("q", "k", "v"))
        collectives.reset_counts()
        o = ring_attention(q, k, v, mesh=m)
        fwd = sum(c["calls"] for key, c in collectives.counts.items()
                  if key[0] == "ring_pass")
        o.backward(torch.from_numpy(inp["ct"][:, i * per:(i + 1) * per]
                                    .copy()))
        total = sum(c["calls"] for key, c in collectives.counts.items()
                    if key[0] == "ring_pass")
        out.update({f"ring/{name}/o": o.detach().numpy(),
                    f"ring/{name}/dq": q.grad.numpy(),
                    f"ring/{name}/dk": k.grad.numpy(),
                    f"ring/{name}/dv": v.grad.numpy(),
                    f"ring/{name}/passes_fwd": fwd,
                    f"ring/{name}/passes_bwd": total - fwd})
    for name, e in args["engines"].items():
        out.update({f"{name}/{k}": v
                    for k, v in _sp_engine_run(e, inp).items()})
    return out


def case_lora(mesh: Mesh, args: dict, inp) -> dict:
    """LoRA engines on meshes of this world (``args["engines"]``: each
    its preset, overrides, mesh and fused flag): this rank's shards of
    the base, the adapters replicated, steps on this rank's rows of the
    global batches; the losses, the adapters and Adam's first moment
    after them, the tp route and the ring's passes (the sp route)."""
    from distributedtraining_tpu_torch.engine.lora_train import LoRAEngine
    from distributedtraining_tpu_torch.parallel import collectives
    from distributedtraining_tpu_torch.engine.train import default_optimizer
    from distributedtraining_tpu_torch.models.lora import LoRAConfig
    out = {}
    for name, e in args["engines"].items():
        m = Mesh(MeshConfig(**e["mesh"]))
        eng = LoRAEngine(_model(e["preset"], e["overrides"]),
                         LoRAConfig(rank=args["rank"], alpha=args["alpha"]),
                         mesh=m, fused_loss=e["fused"],
                         optimizer=default_optimizer(
                             args["lr"], grad_clip=args["grad_clip"]),
                         device="cpu")

        def part(tag, name=name):
            pre = f"{name}/{tag}/"
            return {k[len(pre):]: inp[k] for k in inp.files
                    if k.startswith(pre)}
        base = eng.place_base(part("p"))
        state = eng.init_state_from(part("a"))
        losses = []
        collectives.reset_counts()
        for ids in inp[f"{name}/ids"]:
            batch = eng.place_batch(batch_rows({"input_ids": ids}, m))
            state, met = eng.train_step(state, base, batch)
            losses.append(float(met["loss"]))
        out[f"{name}/losses"] = np.array(losses)
        out[f"{name}/ring_passes"] = np.array(sum(
            c["calls"] for key, c in collectives.counts.items()
            if key[0] == "ring_pass"))
        for tag, tree in (("ad", state.params), ("mu", state.opt_state.mu)):
            out.update({f"{name}/{tag}/{k}": v.detach().numpy()
                        for k, v in tree.items()})
        out[f"{name}/route"] = np.array(eng.tp_route or "none")
    # the pod's fetch: the coordinator alone holds the bytes; every rank
    # densifies the same broadcast
    from distributedtraining_tpu_torch.delta import flatten_tree
    from distributedtraining_tpu_torch.engine.lora_train import \
        fetch_delta_any_broadcast
    from distributedtraining_tpu_torch.transport import InMemoryTransport
    t = InMemoryTransport()
    if mesh.rank == 0:
        t.publish_raw("m", inp["bcast/bytes"].tobytes())
    template = json.loads(str(inp["bcast/template"]))
    template = {k: np.zeros(v, np.float32) for k, v in template.items()}
    from distributedtraining_tpu_torch.delta import nest_tree
    dense = fetch_delta_any_broadcast(
        t, "m", nest_tree(template),
        LoRAConfig(rank=args["rank"], alpha=args["alpha"]))
    out.update({f"bcast/{k}": v for k, v in flatten_tree(dense).items()})
    return out


CASES = {"ce": case_ce, "lora": case_lora, "engine": case_engine, "tp": case_tp,
         "sp": case_sp, "llama": case_llama,
         "miner": case_miner, "bpe_build": case_bpe_build,
         "collectives": case_collectives, "pod": case_pod,
         "regather": case_regather}


def main() -> int:
    case, rank, world, port, io_dir = sys.argv[1:6]
    with open(os.path.join(io_dir, "args.json")) as f:
        args = json.load(f)
    inp = np.load(os.path.join(io_dir, "inputs.npz"))
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", int(world), int(rank),
                         device="cpu", timeout_s=120)
    try:
        mesh = Mesh(MeshConfig(**args["mesh"]))
        out = CASES[case](mesh, args, inp)
    finally:
        multihost.shutdown()
    np.savez(os.path.join(io_dir, f"out_{rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
