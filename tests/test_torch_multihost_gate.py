"""The coordinator gate of a world of several processes, at rank 1, in
both packages: ``parallel/multihost.CoordinatorGatedTransport`` over each
package's ``InMemoryTransport``, with ``is_coordinator`` patched to
return False.

A rank that crashes publishes its flight bundle under the post-mortem id
in both packages. The port's gate drops every artifact write of a rank
other than 0 (a delta, a base, a rider, a wire-v2 shard) and ``gc``, as
the JAX gate does for all of them but the shard: the JAX gate passes the
raw publishes through, so every JAX process writes the shards, against
its own one-writer rule. At rank 0 every write passes in the port.
"""

import numpy as np
import pytest

from distributedtraining_tpu.parallel import multihost as jax_multihost
from distributedtraining_tpu.transport import InMemoryTransport as JaxMemory
from distributedtraining_tpu.transport import base as jax_base
from distributedtraining_tpu_torch.parallel import multihost
from distributedtraining_tpu_torch.transport import InMemoryTransport
from distributedtraining_tpu_torch.transport import base

PACKAGES = {"jax": (jax_multihost, JaxMemory, jax_base),
            "port": (multihost, InMemoryTransport, base)}


def _gated(package, monkeypatch, coordinator):
    """(gated transport, inner transport, the package's transport.base)
    at rank 0 (``coordinator``) or rank 1; the inner one counts its
    ``gc`` calls."""
    mh, memory, tbase = PACKAGES[package]

    class Counted(memory):
        gcs = 0

        def gc(self):
            type(self).gcs += 1
            return super().gc()

    monkeypatch.setattr(mh, "is_coordinator", lambda: coordinator)
    inner = Counted()
    return mh.CoordinatorGatedTransport(inner), inner, tbase


def _tree():
    return {"w": np.arange(4, dtype=np.float32)}


# each write at rank 1, and what it leaves in the inner store
WRITES = {
    "delta": (lambda g, tb: g.publish_delta("m0", _tree()),
              lambda i, tb: i.fetch_delta_bytes("m0")),
    "base": (lambda g, tb: g.publish_base(_tree()),
             lambda i, tb: i.fetch_base_bytes()),
    "rider": (lambda g, tb: g.publish_delta_meta("m0", {"base": "r1"}),
              lambda i, tb: i.fetch_delta_meta("m0")),
    "wire_v2_shard": (lambda g, tb: tb.publish_shard(g, "m0", "h.0.w",
                                                     b"shard"),
                      lambda i, tb: tb.fetch_shard(i, "m0", "h.0.w")),
    "gc": (lambda g, tb: g.gc(), lambda i, tb: type(i).gcs or None),
}
# what reaches the store at rank 1: the port drops every artifact write;
# the JAX gate passes the raw publishes, so a shard lands
LANDS = {"port": set(), "jax": {"wire_v2_shard"}}


@pytest.mark.parametrize("package", ["jax", "port"])
def test_rank1_publishes_its_postmortem_bundle(package, monkeypatch):
    gated, inner, tbase = _gated(package, monkeypatch, coordinator=False)
    tbase.publish_postmortem(gated, "miner", "m0", b"bundle")
    assert tbase.fetch_postmortem_bytes(inner, "miner", "m0") == b"bundle"


@pytest.mark.parametrize("write", sorted(WRITES))
@pytest.mark.parametrize("package", ["jax", "port"])
def test_rank1_artifact_writes_and_gc(package, write, monkeypatch):
    gated, inner, tbase = _gated(package, monkeypatch, coordinator=False)
    do, read = WRITES[write]
    assert do(gated, tbase) is None or write in LANDS[package]
    assert (read(inner, tbase) is not None) == (write in LANDS[package])


@pytest.mark.parametrize("write", sorted(WRITES))
def test_rank0_port_gate_passes_every_write(write, monkeypatch):
    gated, inner, tbase = _gated("port", monkeypatch, coordinator=True)
    do, read = WRITES[write]
    do(gated, tbase)
    assert read(inner, tbase) is not None
