"""The port's metric sinks (utils/metrics.py: InMemorySink, JSONLSink with
rotation, jsonl_segments, multi_sink, the device memory numbers) and the
sink binding of utils/obs.py (``configure(sink, role=)``, span records,
registry flushes) against the JAX package, on the CPU.

- ``JSONLSink``: the same records (the clock pinned) give the same line
  bytes and, under ``max_bytes`` rotation, the same segments, file for
  file; the retention sweep of an earlier run's segments prunes the same
  files; ``jsonl_segments`` lists them oldest first.
- ``multi_sink`` fans out to every sink; a sink that fails leaves a span
  and its phase alone.
- Spans and flushes reach the configured sink as the JAX package's
  records (nesting, role, cid, attrs; ``obs_registry``), durations
  aside.
- On the CPU the device memory functions carry no device keys; on a
  host of several cards they read the process's own card alone.
"""

import os
import time

import pytest

from distributedtraining_tpu.utils import metrics as jm
from distributedtraining_tpu.utils import obs as jobs
from distributedtraining_tpu_torch.utils import metrics as tm
from distributedtraining_tpu_torch.utils import obs


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


def _records(n):
    return [({"train_loss": 2.5 - 0.01 * i, "staleness_s": float(i),
              "note": "x" * (i % 7), "nested": {"a": [i, None]},
              "nan": float("nan") if i % 5 == 0 else 1.0}, i)
            for i in range(n)]


def _write(mod, path, recs, **kw):
    sink = mod.JSONLSink(str(path), **kw)
    for rec, step in recs:
        sink.log(rec, step=step)
    sink.log_params({"lr": 1e-3})
    sink.close()
    return sink


def _tree(d):
    return {p: open(os.path.join(d, p), "rb").read()
            for p in sorted(os.listdir(d))}


@pytest.mark.parametrize("max_bytes,keep", [(None, 3), (700, 2), (300, 4),
                                            (1, 1)])
def test_jsonl_lines_and_segments_match_jax(tmp_path, monkeypatch,
                                            max_bytes, keep):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    recs = _records(23)
    ours = _write(tm, tmp_path / "p" / "m.jsonl", recs, max_bytes=max_bytes,
                  keep_segments=keep)
    ref = _write(jm, tmp_path / "j" / "m.jsonl", recs, max_bytes=max_bytes,
                 keep_segments=keep)
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")
    assert ours.rotations == ref.rotations
    rel = [os.path.basename(s) for s in tm.jsonl_segments(
        str(tmp_path / "p" / "m.jsonl"))]
    assert rel == [os.path.basename(s) for s in jm.jsonl_segments(
        str(tmp_path / "j" / "m.jsonl"))]
    if max_bytes:
        rotated = [r for r in rel if r != "m.jsonl"]
        assert ours.rotations > 0 \
            and len(rotated) == min(keep, ours.rotations)
    else:
        assert rel == ["m.jsonl"] and ours.rotations == 0
    # an appending second run resumes the current segment's byte count
    for mod, d in ((tm, "p"), (jm, "j")):
        _write(mod, tmp_path / d / "m.jsonl", recs[:3], max_bytes=max_bytes,
               keep_segments=keep)
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")


def test_jsonl_retention_sweep_matches_jax(tmp_path):
    for d in ("p", "j"):
        os.makedirs(tmp_path / d)
        for n in range(1, 7):
            (tmp_path / d / f"m.jsonl.{n}").write_text(f"{n}\n")
    ours = tm.JSONLSink(str(tmp_path / "p" / "m.jsonl"), keep_segments=2)
    ref = jm.JSONLSink(str(tmp_path / "j" / "m.jsonl"), keep_segments=2)
    assert not os.path.exists(tmp_path / "p" / "m.jsonl")  # lazy open
    ours.log({"a": 1})
    ref.log({"a": 1})
    ours.close()
    ref.close()
    assert ours.segments_pruned == ref.segments_pruned == 4
    assert sorted(os.listdir(tmp_path / "p")) \
        == sorted(os.listdir(tmp_path / "j")) \
        == ["m.jsonl", "m.jsonl.1", "m.jsonl.2"]
    assert tm.jsonl_segments(str(tmp_path / "none.jsonl")) \
        == [str(tmp_path / "none.jsonl")]
    for bad in (dict(max_bytes=-1), dict(keep_segments=0),
                dict(retention_segments=0)):
        with pytest.raises(ValueError):
            tm.JSONLSink(str(tmp_path / "x.jsonl"), **bad)


def test_multi_sink_and_in_memory_sink(tmp_path):
    mem, jmem = tm.InMemorySink(), jm.InMemorySink()
    path = tmp_path / "m.jsonl"
    jsonl = tm.JSONLSink(str(path))
    both = tm.multi_sink(mem, jsonl)
    jboth = jm.multi_sink(jmem)
    for s in (both, jboth):
        s.log({"x": 1.5}, step=3)
        s.log_params({"lr": 0.1})
    assert mem.records == jmem.records == [{"step": 3, "x": 1.5}]
    assert mem.params == jmem.params == {"lr": 0.1}
    jsonl.close()
    lines = path.read_text().splitlines()
    assert len(lines) == 2 and '"x": 1.5' in lines[0]


def _span_script(mod):
    sink = mod.InMemorySink()
    mod_obs = obs if mod is tm else jobs
    mod_obs.configure(sink, role="validator")
    with mod_obs.span("val.round", k=3):
        with mod_obs.span("val.fetch", cid="m1-000001", miner="m1"):
            mod_obs.count("ingest.fetches", 2)
        try:
            with mod_obs.span("val.eval", cids=["a", "b"]):
                raise KeyError("boom")
        except KeyError:
            pass
    mod_obs.gauge("val.effective_cohort", 4.0)
    snap = mod_obs.flush(step=7)
    assert mod_obs.current_sink() is sink
    return sink.records, snap


def test_spans_and_flushes_reach_the_configured_sink_as_jax():
    ours, snap = _span_script(tm)
    ref, jsnap = _span_script(jm)
    assert obs.enabled() and jobs.enabled()

    def strip(recs):
        out = []
        for r in recs:
            r = {k: v for k, v in r.items()
                 if k not in ("dur_ms", "t0") and "_ms." not in k}
            out.append(r)
        return out
    assert strip(ours) == strip(ref)
    assert [r.get("span") for r in ours] == ["val.fetch", "val.eval",
                                             "val.round", None]
    assert ours[0]["parent"] == "val.round" and ours[0]["depth"] == 1
    assert ours[0]["cid"] == "m1-000001" and ours[1]["error"] is True
    assert ours[-1]["obs_registry"] == "validator" \
        and ours[-1]["step"] == 7
    assert snap.keys() == jsnap.keys()
    # a broken sink never breaks the traced phase
    class Broken:
        def log(self, *a, **k):
            raise OSError("disk full")
    obs.configure(Broken(), role="miner")
    with obs.span("miner.step"):
        pass
    assert obs.registry().histogram("span.miner.step_ms").count == 1
    # configure() without a sink switches the instruments on, no records
    obs.reset()
    obs.configure()
    with obs.span("x.y"):
        pass
    assert obs.current_sink() is None and obs.flush() \
        and "span.x.y_ms.count" in obs.flush()


def test_device_memory_functions_on_the_cpu():
    assert tm.device_memory_watermarks() == {}
    out = tm.device_metrics()
    assert not any(k.startswith("device") for k in out)
    assert all(isinstance(v, float) for v in out.values())


def test_device_memory_functions_read_only_the_current_card(monkeypatch):
    """With two cards visible and card 1 current, only card 1 is read
    (reading card 0 would open a context there); it is numbered 0, as
    JAX numbers a process's one local device."""
    import torch
    asked = []

    def stats(i):
        asked.append(("stats", i))
        return {"allocated_bytes.all.current": 100 + i,
                "allocated_bytes.all.peak": 200 + i}

    def info(i):
        asked.append(("info", i))
        return (0, 1000 + i)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", info)
    assert tm.device_memory_watermarks() == {
        "mem_in_use_bytes": 101.0, "mem_peak_bytes": 201.0,
        "mem_limit_bytes": 1001.0}
    out = tm.device_metrics()
    assert {k: v for k, v in out.items() if k.startswith("device")} == {
        "device0_bytes_in_use": 101.0, "device0_peak_bytes": 201.0,
        "device0_mem_fraction": 101.0 / 1001.0}
    assert {i for _, i in asked} == {1}
