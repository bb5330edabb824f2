"""One rank of a gloo world for tests/test_torch_mesh_roles.py.

    python tests/torch_mesh_worker.py RANK WORLD PORT IO_DIR

reads ``IO_DIR/args.json`` and ``IO_DIR/inputs.npz``, brings a world of
WORLD ranks up over gloo on the CPU, runs each case named in
``args["cases"]`` in turn on the mesh ``args["mesh"]`` (default dp =
WORLD), and writes
``IO_DIR/out_RANK.npz`` (a case's outputs under ``"<case>/"``).

    python tests/torch_mesh_worker.py cli RANK IO_DIR

runs ``args["role"]``'s entry point on ``args["argv"] + args["rank_argv"]
[RANK]`` (the CLI brings its world up itself, from its ``--multihost-*``
flags), counting the local chain's ``set_weights``, the local
transport's ``publish_base`` and the publication lease's ``acquire`` and
``stamp`` calls, and writes ``IO_DIR/cli_RANK.json``
(the return code, the counts and the seconds it took). A ``SystemExit``
of the entry point ends the process as it would end the role.

Both import torch and the port only (no JAX); the test holds the results
against the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from distributedtraining_tpu_torch import delta as tdl  # noqa: E402
from distributedtraining_tpu_torch.parallel import (  # noqa: E402
    Mesh, MeshConfig, multihost)


class Counting:
    """A transport or chain whose method calls are counted by name."""

    def __init__(self, inner):
        self._inner = inner
        self.calls = collections.Counter()

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if not callable(attr):
            return attr

        def call(*a, **kw):
            self.calls[name] += 1
            return attr(*a, **kw)
        return call


def _tree(inp, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: inp[k] for k in inp.files if k.startswith(prefix)}


def _engine(mesh, args):
    from distributedtraining_tpu_torch.engine.train import TrainEngine
    from distributedtraining_tpu_torch.models import gpt2
    cfg = dataclasses.replace(gpt2.PRESETS["tiny"], dtype="float32")
    model, _ = gpt2.make_model(cfg)
    return TrainEngine(model, mesh=mesh, device="cpu")


def _batches(inp) -> list[dict]:
    return [{"input_ids": x} for x in inp["val_ids"]]


def _io(root: str, chain_dir: str, my_hotkey: str, **chain_kw):
    """Counted LocalFS transport and local chain, gated as the roles gate
    them (the coordinator alone writes)."""
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    t = Counting(LocalFSTransport(root))
    c = Counting(LocalChain(chain_dir, my_hotkey=my_hotkey, **chain_kw))
    gt, gc = multihost.gate_io(t, c)
    return t, c, gt, gc


def case_merge(mesh: Mesh, args: dict, inp) -> dict:
    """``sharded_cohort_merge`` of three deltas into an f32 base on the
    stack built at its bucket: bf16 deltas (``merged``) and the same
    deltas in f32 (``merged_f32``)."""
    from distributedtraining_tpu_torch.parallel import collectives as coll
    base = {k: torch.from_numpy(v) for k, v in _tree(inp, "base/").items()}
    axis = coll.merge_axis(mesh)
    coll.reset_merge_cache()
    m_pad = coll.merge_bucket(3, mesh, axis)
    out = {"m_pad": m_pad, "axis": axis}
    for name, dtype in (("merged", torch.bfloat16),
                        ("merged_f32", torch.float32)):
        deltas = [{k: torch.from_numpy(v).to(dtype)
                   for k, v in _tree(inp, f"d{i}/").items()}
                  for i in range(3)]
        stack = coll.stack_deltas_sharded(deltas, mesh, axis, target=m_pad)
        merged = coll.sharded_cohort_merge(base, stack, inp["w"])
        out.update({f"{name}/{k}": v.numpy() for k, v in merged.items()})
    out.update({"k_local": stack.k_local, "start": stack.start})
    return out


def case_stage(mesh: Mesh, args: dict, inp) -> dict:
    """``DeltaIngestor.stage(multi=True)`` over the fleet's root: every
    verdict and delta, and this rank's transport calls."""
    from distributedtraining_tpu_torch.engine.ingest import DeltaIngestor
    from distributedtraining_tpu_torch.engine.train import _wire_template
    eng = _engine(mesh, args)
    t, _, gt, _ = _io(args["root"], args["chain_dir"] + "-stage",
                      "hotkey_91")
    ing = DeltaIngestor(gt, lambda: _wire_template(eng.model),
                        stale_deltas="skip", workers=4)
    staged = ing.stage(args["hotkeys"], base_revision=args["rev"],
                       multi=True)
    ing.close()
    out = {"verdicts": json.dumps([[s.hotkey, s.reason, s.revision, s.cid]
                                   for s in staged]),
           "transport_calls": sum(t.calls.values())}
    for s in staged:
        if s.delta is not None:
            out.update({f"delta/{s.hotkey}/{k}": np.asarray(v)
                        for k, v in tdl.flatten_tree(s.delta).items()})
    return out


def case_eval(mesh: Mesh, args: dict, inp) -> dict:
    """The batched evaluator on the mesh: a cohort of three deltas."""
    from distributedtraining_tpu_torch.engine.batched_eval import \
        BatchedCohortEvaluator
    eng = _engine(mesh, args)
    base = {k: torch.from_numpy(v) for k, v in _tree(inp, "base/").items()}
    ev = BatchedCohortEvaluator(eng)
    got = ev.evaluate_cohort(base, [_tree(inp, f"d{i}/") for i in range(3)],
                             _batches(inp))
    return {"scores": np.array(got), "bucket": ev.bucket_for(3),
            "candidate_batches": ev.candidate_batches}


def case_validator(mesh: Mesh, args: dict, inp) -> dict:
    """A validator round on the fleet's root at cohort 8: every score,
    and this rank's chain emissions and transport calls."""
    from distributedtraining_tpu_torch.engine.validate import Validator
    eng = _engine(mesh, args)
    t, c, gt, gc = _io(args["root"], args["chain_dir"], "hotkey_91")
    v = Validator(eng, gt, gc, eval_batches=lambda: iter(_batches(inp)),
                  cohort_size=8, stale_deltas="accept")
    v.bootstrap()
    res = v.validate_and_score()
    v.close()
    return {"scores": json.dumps([[s.hotkey, s.score, s.loss, s.reason]
                                  for s in res]),
            "base_loss": v.base_loss,
            "set_weights": c.calls["set_weights"],
            "candidate_batches": v._evaluator().candidate_batches,
            "transport_calls": sum(t.calls.values())}


class FailingPublish:
    """A transport whose first ``fails`` calls of ``publish_base`` raise
    OSError (a failed push) before reaching the inner transport."""

    def __init__(self, inner, fails: int = 1):
        self._inner = inner
        self.fails = fails

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def publish_base(self, *a, **kw):
        if self.fails > 0:
            self.fails -= 1
            raise OSError("planted publish failure")
        return self._inner.publish_base(*a, **kw)


def _loop(mesh: Mesh, args: dict, strategy, batches, *, fail_publish=0):
    """An averager loop on the mesh over ``args["root"]``, its transport
    counted (and its first ``fail_publish`` publishes failing), gated as
    the role gates it."""
    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine.average import AveragerLoop
    from distributedtraining_tpu_torch.engine.scheduler import FakeClock
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    eng = _engine(mesh, args)
    t = Counting(FailingPublish(LocalFSTransport(args["root"]),
                                fail_publish))
    gt, gc = multihost.gate_io(t, LocalChain(
        args["chain_dir"], my_hotkey="hotkey_99", epoch_length=0))
    strat = strategy(eng.model)
    # the winner of each merge: the strategy's returned weights
    strat.winners = []
    inner = strat.merge

    def merge(*a, **kw):
        merged, w = inner(*a, **kw)
        strat.winners.append(w)
        return merged, w
    strat.merge = merge
    return t, AveragerLoop(eng, gt, gc, strat, val_batches=lambda: batches,
                           clock=FakeClock(), publish_policy="always")


def _loop_out(t, loop) -> dict:
    out = {"accepted": loop.report.last_accepted,
           "publishes": t.calls["publish_base"],
           "revision": json.dumps(loop._base_revision)}
    out.update({f"base/{k}": v.detach().numpy()
                for k, v in loop.base_params.items()})
    w = loop.strategy.winners[-1] if loop.strategy.winners else None
    if isinstance(w, torch.Tensor):
        out["winner"] = w.detach().cpu().numpy()
    return out


def _avg_round(mesh: Mesh, args: dict, inp, strategy) -> dict:
    t, loop = _loop(mesh, args, strategy, _batches(inp))
    loop.bootstrap()
    merged = loop.run_round()
    loop.close()
    return {"merged": merged, **_loop_out(t, loop)}


def case_avg_publish_fail(mesh: Mesh, args: dict, inp) -> dict:
    """The coordinator's publish failing once, on a world: (1) a genesis
    publish on an empty root raises on every rank, and the next
    bootstrap publishes the genesis; (2) a round whose publish fails
    fails on every rank, and ``run_periodic``'s next round merges and
    publishes on all of them in step."""
    from distributedtraining_tpu_torch.engine.average import WeightedAverage
    batches = _batches(inp)
    t, loop = _loop(mesh, {**args, "root": args["root_empty"],
                           "chain_dir": args["chain_dir"] + "-ge"},
                    lambda model: WeightedAverage(), batches,
                    fail_publish=1)
    try:
        loop.bootstrap()
        genesis_raised = ""
    except RuntimeError as e:
        genesis_raised = str(e)
    loop.bootstrap()
    loop.close()
    out = {"genesis_raised": genesis_raised,
           "genesis_revision": json.dumps(loop._base_revision),
           "genesis_publishes": t.calls["publish_base"]}
    t, loop = _loop(mesh, {**args, "root": args["root_retry"],
                           "chain_dir": args["chain_dir"] + "-r"},
                    lambda model: WeightedAverage(), batches,
                    fail_publish=1)
    loop.bootstrap()
    before = json.dumps(loop._base_revision)
    merged = loop.run_periodic(interval=0.0, rounds=2)
    loop.close()
    out.update({"merged_rounds": merged, "before": before,
                **_loop_out(t, loop)})
    return out


def case_avg_weighted(mesh: Mesh, args: dict, inp) -> dict:
    from distributedtraining_tpu_torch.engine.average import WeightedAverage
    return _avg_round(mesh, {**args, "root": args["root_weighted"],
                             "chain_dir": args["chain_dir"] + "-w"}, inp,
                      lambda model: WeightedAverage())


def case_avg_param(mesh: Mesh, args: dict, inp) -> dict:
    from distributedtraining_tpu_torch.engine.average import \
        ParameterizedMerge
    return _avg_round(mesh, {**args, "root": args["root_param"],
                             "chain_dir": args["chain_dir"] + "-p"}, inp,
                      lambda model: ParameterizedMerge(
                          model, meta_epochs=2, meta_lr=0.3,
                          per_tensor=True, meta_optimizer="sgd"))


def case_avg_genetic(mesh: Mesh, args: dict, inp) -> dict:
    from distributedtraining_tpu_torch.engine.average import GeneticMerge
    return _avg_round(mesh, {**args, "root": args["root_genetic"],
                             "chain_dir": args["chain_dir"] + "-g"}, inp,
                      lambda model: GeneticMerge(
                          population=4, generations=2, screen_batches=1))


CASES = {"merge": case_merge, "stage": case_stage, "eval": case_eval,
         "validator": case_validator, "avg_weighted": case_avg_weighted,
         "avg_param": case_avg_param, "avg_genetic": case_avg_genetic,
         "avg_publish_fail": case_avg_publish_fail}


def cli_main(rank: str, io_dir: str) -> int:
    import importlib
    import time

    from distributedtraining_tpu_torch.chain import LocalChain
    from distributedtraining_tpu_torch.engine.remediate import LeaseManager
    from distributedtraining_tpu_torch.transport import LocalFSTransport
    with open(os.path.join(io_dir, "args.json")) as f:
        args = json.load(f)
    counts = collections.Counter()
    for cls, name in ((LocalChain, "set_weights"),
                      (LocalFSTransport, "publish_base"),
                      (LeaseManager, "acquire"), (LeaseManager, "stamp")):
        def counted(self, *a, _f=getattr(cls, name), _n=name, **kw):
            counts[_n] += 1
            return _f(self, *a, **kw)
        setattr(cls, name, counted)
    torch.set_num_threads(1)
    role = importlib.import_module(
        f"distributedtraining_tpu_torch.neurons.{args['role']}")
    t0 = time.perf_counter()
    rc = role.main(args["argv"] + args["rank_argv"][int(rank)])
    with open(os.path.join(io_dir, f"cli_{rank}.json"), "w") as f:
        json.dump({"rc": rc, "counts": dict(counts),
                   "seconds": time.perf_counter() - t0}, f)
    return 0


def main() -> int:
    if sys.argv[1] == "cli":
        return cli_main(*sys.argv[2:4])
    rank, world, port, io_dir = sys.argv[1:5]
    with open(os.path.join(io_dir, "args.json")) as f:
        args = json.load(f)
    inp = np.load(os.path.join(io_dir, "inputs.npz"))
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", int(world), int(rank),
                         device="cpu", timeout_s=120)
    out = {}
    try:
        mesh = Mesh(MeshConfig(**args.get("mesh", {"dp": int(world)})))
        for case in args["cases"]:
            out.update({f"{case}/{k}": v for k, v in
                        CASES[case](mesh, args, inp).items()})
    finally:
        multihost.shutdown()
    np.savez(os.path.join(io_dir, f"out_{rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
