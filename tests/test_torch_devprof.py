"""The port's device observatory (utils/devprof.py) and its wiring against
the JAX package's, on the CPU.

- The program vocabulary is JAX's; every name the JAX package's sources
  pass to ``devprof.wrap``/``track`` is registered somewhere in the
  port's sources (an AST lint), except the programs the port does not
  compute as one call (``EXEMPT``, named in the module's docstring).
- Records, ``prom_lines`` and ``anatomy`` agree with JAX's on the same
  observations; ``snapshot`` keeps JAX's schema.
- The same tiny miner command line with ``--metrics-path`` in both
  packages: the ``{"devprof": ...}`` records name the same (program,
  bucket, calls, timed calls), and the last heartbeats carry the same
  keys, ``anat.*`` included. ``--no-devprof`` leaves both out.
- ``train.step``'s FLOPs at the tiny preset equal the analytic count of
  its matrix products exactly, and the cost probe (the first call run
  under a dispatch mode) leaves the step's result unchanged.
- A kernel wrapper's count reaches an active probe and nothing else.
"""

import ast
import dataclasses
import json
import logging
import pathlib

import numpy as np
import pytest
import torch

from distributedtraining_tpu.transport import LocalFSTransport as JFS
from distributedtraining_tpu.transport.base import heartbeat_id as jhb_id
from distributedtraining_tpu.utils import devprof as jdp
from distributedtraining_tpu.utils import obs as jobs
from distributedtraining_tpu_torch.engine import train as ttrain
from distributedtraining_tpu_torch.models import gpt2 as tg
from distributedtraining_tpu_torch.transport import LocalFSTransport
from distributedtraining_tpu_torch.transport.base import heartbeat_id
from distributedtraining_tpu_torch.utils import devprof, obs

ROOT = pathlib.Path(__file__).resolve().parent.parent
# JAX programs the port does not compute as one call (devprof's
# docstring names each and why)
EXEMPT = {"eval.stack", "eval.pad"}
TINY = dataclasses.replace(tg.PRESETS["tiny"], dtype="float32")


@pytest.fixture(autouse=True)
def _clean():
    for m in (obs, jobs, devprof, jdp):
        m.reset()
    yield
    for m in (obs, jobs, devprof, jdp):
        m.reset()


# ---------------------------------------------------------------------------
# Vocabulary and the wrap sites
# ---------------------------------------------------------------------------

def test_vocabulary_equals_jax():
    assert set(devprof.PROGRAMS) == set(jdp.PROGRAMS)
    assert len(devprof.PROGRAMS) == 24
    for name in ("x.y", "train_step"):
        with pytest.raises(ValueError, match="closed vocabulary"):
            devprof.wrap(name, lambda: None)
        with pytest.raises(ValueError, match="closed vocabulary"):
            with devprof.track(name):
                pass


def _program_names(pkg: pathlib.Path, calls: tuple) -> set:
    """Every string constant in the first argument of a
    ``devprof.<call>(...)`` under ``pkg``."""
    out = set()
    for path in pkg.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in calls
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "devprof"):
                continue
            out |= {c.value for c in ast.walk(node.args[0])
                    if isinstance(c, ast.Constant)
                    and isinstance(c.value, str)}
    return out


def test_every_jax_wrap_site_has_a_port_site():
    jax_names = _program_names(ROOT / "distributedtraining_tpu",
                               ("wrap", "track"))
    port_names = _program_names(ROOT / "distributedtraining_tpu_torch",
                                ("wrap", "track", "call"))
    assert jax_names and jax_names <= set(jdp.PROGRAMS)
    assert port_names <= set(devprof.PROGRAMS)
    assert jax_names - port_names == EXEMPT
    for name in EXEMPT:
        assert f"``{name}``" in devprof.__doc__


# ---------------------------------------------------------------------------
# Records, Prometheus lines and the anatomy against JAX's
# ---------------------------------------------------------------------------

_OBSERVATIONS = {
    ("train.step", "4x512"): (7, 1234.5, 3.0e12, 9.0e9,
                              [41.0, 40.5, 43.25, 40.0, 39.5, 42.0]),
    ("serve.decode", "8x16"): (4, 88.0, 2.0e9, 1.5e9, [1.5, 1.25, 2.0]),
    ("delta.densify", "-"): (2, None, None, None, [3.0, 5.0]),
}


def _feed(mod):
    for (prog, bucket), (calls, comp, fl, by, ms) in _OBSERVATIONS.items():
        rec = mod._get_record(prog, bucket, host=prog == "delta.densify")
        rec.calls, rec.compile_ms, rec.flops = calls, comp, fl
        rec.bytes_accessed = by
        for v in ms:
            rec.exec_ms.observe(v)


@pytest.mark.parametrize("known", [False, True])
def test_records_and_prom_lines_equal_jax(known):
    """The same observations give equal records and Prometheus text, the
    achieved fractions included when the card is in the ladder."""
    for mod in (devprof, jdp):
        mod.enable()
        _feed(mod)
    if known:
        devprof._STATE.roofline = devprof.roofline_for(
            "NVIDIA H100 80GB HBM3")
        jdp._STATE.roofline = jdp.Roofline("NVIDIA H100 80GB HBM3",
                                           989.4e12, 3.35e12)
    ours, theirs = devprof.snapshot(), jdp.snapshot()
    assert ours == theirs
    assert all(("achieved_flops_frac" in r) == (known and not r["host"])
               for r in ours["programs"])
    assert devprof.prom_lines() == jdp.prom_lines()
    assert devprof.achieved_fractions() == jdp.achieved_fractions()


def test_roofline_ladder():
    for name, flops, bw in (("NVIDIA H100 80GB HBM3", 989.4e12, 3.35e12),
                            ("NVIDIA H100 PCIe", 756e12, 2.0e12),
                            ("NVIDIA H100 NVL", 835e12, 3.9e12),
                            ("NVIDIA A100-SXM4-80GB", 312e12, 2.039e12)):
        rl = devprof.roofline_for(name)
        assert (rl.known, rl.peak_flops, rl.hbm_bytes_per_s) == (
            True, flops, bw)
    for name in ("cpu", "NVIDIA GeForce RTX 4090", "TPU v5 lite", ""):
        rl = devprof.roofline_for(name)
        assert not rl.known and rl.peak_flops is None
    # a process that never touched CUDA is the CPU, as JAX's is
    assert devprof.current_roofline().device_kind == "cpu"


def test_anatomy_equals_jax_from_equal_registries():
    for o, d in ((obs, devprof), (jobs, jdp)):
        assert d.anatomy() == {}
        d.enable()
        assert d.anatomy() == {}
        _feed(d)
        o.configure(object())      # a sink (never logged to here)
        for v in (50.0, 48.0, 61.5):
            o.observe("miner.step_ms", v)
        for v in (1.0, 0.5):
            o.observe("miner.data_wait_ms", v)
    ours = devprof.anatomy()
    assert ours == jdp.anatomy()
    assert set(ours) == {"anat.step_ms", "anat.device_ms", "anat.host_ms",
                         "anat.device_frac", "anat.data_wait_ms"}


def test_track_and_cardinality_cap_equal_jax():
    for d in (devprof, jdp):
        d.enable(max_programs=2)
        for i in range(4):
            with d.track("delta.densify", bucket=i):
                pass
    assert devprof._STATE.dropped == jdp._STATE.dropped == 2
    ours = [(r["prog"], r["bucket"], r["calls"], r["host"])
            for r in devprof.snapshot()["programs"]]
    assert ours == [(r["prog"], r["bucket"], r["calls"], r["host"])
                    for r in jdp.snapshot()["programs"]]
    assert devprof.prom_lines()[-1] == jdp.prom_lines()[-1] \
        == "dt_prog_dropped 2.0"


def test_wrap_is_a_pass_through_while_off():
    seen = []
    f = devprof.wrap("train.eval", lambda x: seen.append(x) or x * 2,
                     bucket=lambda a, kw: a[0])
    assert f(3) == 6 and not devprof.records()
    devprof.enable()
    assert f(4) == 8 and f(4) == 8
    (rec,) = devprof.records()
    assert (rec.prog, rec.bucket, rec.calls, rec.exec_ms.count) == (
        "train.eval", "4", 2, 1)
    assert rec.compile_ms is not None and rec.flops == 0.0
    assert seen == [3, 4, 4]


# ---------------------------------------------------------------------------
# The cost probe
# ---------------------------------------------------------------------------

def _tiny_batch(B, T, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY.vocab_size, size=(B, T)).astype(np.int32)
    seg = np.ones((B, T), np.int32)
    seg[:, T // 2:] = 2
    return {"input_ids": ids, "segment_ids": seg,
            "loss_mask": np.ones((B, T), np.float32)}


def _analytic_step_flops(cfg, B, T) -> int:
    """The tiny step's matrix products: per block the four projections
    (12 E^2 weights) forward and both backward products (6 N a weight),
    the plain attention's dense T x T products (two forward, five in its
    backward: 2 B H T^2 D each), and the tied head (6 N E V)."""
    N, E, L = B * T, cfg.n_embd, cfg.n_layer
    H, D = cfg.n_head, cfg.n_embd // cfg.n_head
    V = tg.padded_vocab(cfg) if hasattr(tg, "padded_vocab") else \
        -(-cfg.vocab_size // cfg.vocab_multiple) * cfg.vocab_multiple
    return L * (6 * N * 12 * E * E + 7 * 2 * B * H * T * T * D) \
        + 6 * N * E * V


def test_train_step_flops_equal_the_analytic_count():
    torch.manual_seed(0)
    B, T = 2, 32
    eng = ttrain.TrainEngine(tg.make_model(TINY)[0], device="cpu")
    state = eng.init_state(tg.params_from_numpy(
        tg.init_params_numpy(TINY, 0), device="cpu"))
    devprof.enable()
    batch = eng.place_batch(_tiny_batch(B, T))
    for _ in range(2):
        state, _ = eng.train_step(state, batch)
    (rec,) = devprof.records()
    assert (rec.prog, rec.bucket, rec.calls, rec.exec_ms.count) == (
        "train.step", f"{B}x{T}", 2, 1)
    assert rec.flops == _analytic_step_flops(TINY, B, T)
    assert rec.bytes_accessed > 0


def test_the_probe_runs_the_first_call_once():
    """The first step under the probe updates AdamW's state exactly as a
    step without the observatory does."""
    tree = tg.init_params_numpy(TINY, 0)
    batch = _tiny_batch(2, 32, seed=1)
    states = []
    for on in (True, False):
        devprof.reset()
        if on:
            devprof.enable()
        eng = ttrain.TrainEngine(tg.make_model(TINY)[0], device="cpu")
        state = eng.init_state(tg.params_from_numpy(tree, device="cpu"))
        state, _ = eng.train_step(state, eng.place_batch(batch))
        states.append(state)
        if on:
            (rec,) = devprof.records()
            assert rec.calls == 1 and rec.cost_probed and rec.flops > 0
    a, b = states
    assert a.step == b.step == 1
    assert a.opt_state.count == b.opt_state.count == 1
    for name, x, y in (("params", a.params, b.params),
                       ("mu", a.opt_state.mu, b.opt_state.mu),
                       ("nu", a.opt_state.nu, b.opt_state.nu)):
        for k in x:
            assert torch.equal(x[k].detach(), y[k].detach()), (name, k)


def test_kernel_cost_reaches_only_an_active_probe():
    calls = []

    def cost():
        calls.append(1)
        # a tensor op inside the count is not itself counted
        torch.ones(64, 64) @ torch.ones(64, 64)
        return 1000.0, 24.0

    devprof.kernel_cost(cost)
    assert not calls and not devprof.probing()

    probed = []

    def program(x):
        probed.append(devprof.probing())
        devprof.kernel_cost(cost)
        return x @ x

    f = devprof.wrap("serve.decode", program, bucket="1x1")
    devprof.enable()
    x = torch.ones(8, 8)
    f(x)
    f(x)
    (rec,) = devprof.records()
    assert probed == [True, False] and calls == [1]   # the first call
    assert rec.flops == 1000.0 + 2 * 8 * 8 * 8
    assert rec.bytes_accessed == 24.0 + 3 * 8 * 8 * 4


# ---------------------------------------------------------------------------
# The miner command line against JAX's (fault 1)
# ---------------------------------------------------------------------------

def _argv(work, jsonl, extra=()):
    return ["--backend", "local", "--model", "tiny", "--dataset",
            "synthetic", "--tokenizer", "word", "--no-base-wire-v2",
            "--checkpoint-interval", "0", "--no-anomaly-trace",
            "--flight-events", "0", "--work-dir", str(work),
            "--hotkey", "hotkey_3", "--max-steps", "3", "--seq-len", "32",
            # 8 rows: the JAX miner's data axis spans the test
            # process's 8 host devices
            "--batch-size", "8", "--log-every", "1",
            "--heartbeat-interval", "30", "--metrics-path", str(jsonl),
            *extra]


def _run(main, argv):
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        assert main(argv) == 0
    finally:
        root.handlers[:], root.level = handlers, level


def _devprof_cells(jsonl) -> tuple[list, set]:
    recs = [json.loads(line) for line in open(jsonl)]
    dp = [r for r in recs if "devprof" in r]
    if not dp:
        return [], set()
    cells = sorted((p["prog"], p["bucket"], p["calls"],
                    p["exec_ms"]["count"])
                   for p in dp[-1]["devprof"]["programs"])
    keys = {k for r in dp for k in r} | {
        k for r in dp for p in r["devprof"]["programs"] for k in p}
    return cells, keys


@pytest.fixture(scope="module")
def miners(tmp_path_factory, monkeypatch_module):
    """The JAX miner and the port's, with and without ``--no-devprof``,
    on one command line each."""
    from distributedtraining_tpu_torch.neurons import miner as tminer
    from neurons import miner as jminer
    monkeypatch_module.setenv("DT_FORCE_PLATFORM", "cpu")
    tmp = tmp_path_factory.mktemp("miners")
    out = {}
    for name, main, extra in (("jax", jminer.main, ()),
                              ("port", tminer.main, ()),
                              ("port_off", tminer.main, ("--no-devprof",))):
        work, jsonl = tmp / name, tmp / f"{name}.jsonl"
        _run(main, _argv(work, jsonl, extra))
        t = (JFS if name == "jax" else LocalFSTransport)(
            str(work / "artifacts"))
        beat = t.fetch_delta_meta((jhb_id if name == "jax" else
                                   heartbeat_id)("miner", "hotkey_3"))
        out[name] = (_devprof_cells(jsonl), beat)
        assert not devprof.enabled() and not devprof.records()
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_miner_cli_devprof_records_equal_jax(miners):
    (jcells, jkeys), _ = miners["jax"]
    (cells, keys), _ = miners["port"]
    assert jcells == [("push.snapshot", "-", 1, 0.0),
                      ("train.step", "8x32", 3, 2.0)]
    assert cells == jcells
    assert keys == jkeys
    # --no-devprof: no record at all
    assert miners["port_off"][0] == ([], set())


def test_miner_cli_heartbeat_keys_equal_jax(miners):
    _, jbeat = miners["jax"]
    _, beat = miners["port"]
    _, beat_off = miners["port_off"]
    anat = {"anat.step_ms", "anat.device_ms", "anat.host_ms",
            "anat.device_frac", "anat.data_wait_ms"}
    assert anat <= set(jbeat)
    assert set(beat) == set(jbeat)
    assert set(beat_off) == set(jbeat) - anat
    assert beat["anat.device_ms"] > 0 and beat["anat.step_ms"] > 0
