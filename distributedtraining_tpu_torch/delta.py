"""Weight-delta algebra on the port's state dicts — the port of the JAX
package's ``delta.py``: the dense algebra, the admission screens, the v1
wire decodes (bf16, int8, sparse8), the wire-v2 packed form with its
error-feedback encoder, and the merges (chunked dense and packed
scatter-add).

A *delta* is the per-parameter difference ``trained - base`` between two
state dicts with the same keys and shapes (the JAX param tree's paths
joined with ``.``): the miner's product, which validators apply to score
and the averager merges.

Two forms of the same tree travel through here. Wire trees (what the
transports serve and the screens check) are nested dicts in the JAX
layout (``h_0/c_attn/kernel``) with host leaves: numpy arrays, and CPU
tensors for bf16. Device work (the encoder, the merges) runs on state
dicts. :func:`flatten_tree` maps the first onto the second; packed
entries pair with accumulator leaves by that path, never by position,
because the JAX walk sorts nested keys component by component while a
state dict's ``.``-joined keys sort as flat strings.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

Params = Mapping[str, torch.Tensor]
Tree = Any

_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_FLOAT_NAMES = ("float16", "bfloat16", "float32", "float64")


def _same_keys(a: Params, b: Params) -> None:
    if a.keys() != b.keys():
        raise ValueError(f"state dicts differ in keys: "
                         f"{sorted(set(a) ^ set(b))[:5]}")


def tree_sub(a: Params, b: Params) -> dict[str, torch.Tensor]:
    """Elementwise ``a - b`` over state dicts with the same keys."""
    _same_keys(a, b)
    return {k: a[k] - b[k] for k in a}


def tree_add(a: Params, b: Params) -> dict[str, torch.Tensor]:
    """Elementwise ``a + b`` over state dicts with the same keys."""
    _same_keys(a, b)
    return {k: a[k] + b[k] for k in a}


@torch.no_grad()
def compute_delta(trained: Params, base: Params,
                  wire_dtype: str | None = None) -> dict[str, torch.Tensor]:
    """``delta = trained - base``, the artifact a miner uploads (outside
    autograd: training params take gradients, the artifact does not).
    ``wire_dtype="bfloat16"`` casts its float leaves for the wire (half
    the bytes; the rounding is of the delta, not of the weights)."""
    d = tree_sub(trained, base)
    if wire_dtype is None:
        return d
    dt = _WIRE_DTYPES[wire_dtype]
    return {k: v.to(dt) if v.is_floating_point() else v
            for k, v in d.items()}


def apply_delta(base: Params, delta: Params) -> dict[str, torch.Tensor]:
    """Reconstruct trained params from base + delta (a bf16 delta adds
    onto f32 weights in f32, by type promotion)."""
    return tree_add(base, delta)


def tree_finite(tree: Params) -> torch.Tensor:
    """0-dim bool tensor: True when every float leaf is finite (integer
    leaves are finite by construction). Stays on the leaves' device, so a
    caller decides when to synchronise."""
    flags = [torch.isfinite(t).all() for t in tree.values()
             if t.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


# ---------------------------------------------------------------------------
# Wire trees: nested host dicts in the JAX layout
# ---------------------------------------------------------------------------

def _walk_state_dict(tree, path=()):
    """Yield (path tuple, leaf) for a nested state dict, keys sorted per
    level (the JAX package's walk order)."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _walk_state_dict(tree[key], path + (key,))
    else:
        yield path, tree


def flatten_tree(tree: Tree) -> dict:
    """A nested wire tree as a ``.``-keyed flat dict (the state-dict key
    of each leaf); a flat state dict passes through unchanged."""
    if not any(isinstance(v, Mapping) for v in tree.values()):
        return dict(tree)
    return {".".join(str(k) for k in p): v for p, v in _walk_state_dict(tree)}


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))


def _f32(x) -> np.ndarray:
    """A host leaf (numpy, or a tensor: bf16 off the wire) as f32
    numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _is_float(x) -> bool:
    return _dtype_name(x) in _FLOAT_NAMES


# ---------------------------------------------------------------------------
# Screening of untrusted submissions
# ---------------------------------------------------------------------------

def shapes_match(tree: Tree, reference: Tree, *, check_dtype: bool = False,
                 extra_dtypes: Sequence[str] = ()) -> bool:
    """True iff ``tree`` has the same structure and per-leaf shapes as
    ``reference`` (nested wire trees). ``extra_dtypes`` lists alternate
    dtypes a FLOAT leaf may carry besides the reference's own (the bf16
    wire spelling); f64 or integer substitutions stay rejected."""
    try:
        a = list(_walk_state_dict(tree))
        b = list(_walk_state_dict(reference))
    except TypeError:     # keys of mixed types cannot be sorted
        return False
    if [p for p, _ in a] != [p for p, _ in b]:
        return False
    for (_, x), (_, y) in zip(a, b):
        if isinstance(x, Mapping) or isinstance(y, Mapping):
            return False
        if _shape(x) != _shape(y):
            return False
        if check_dtype:
            dx, dy = _dtype_name(x), _dtype_name(y)
            if dx != dy and not (dx in extra_dtypes
                                 and dy in _FLOAT_NAMES):
                return False
    return True


def _leaf_stats(leaves) -> tuple[bool, np.float32]:
    """(every float leaf finite, max |value| in f32) over host leaves."""
    finite, m = True, np.float32(0.0)
    for leaf in leaves:
        x = _f32(leaf)
        if _is_float(leaf) and not np.isfinite(x).all():
            finite = False
        if x.size:
            m = max(m, np.float32(np.max(np.abs(x))))
    return finite, m


def has_nonfinite(tree: Tree) -> bool:
    """True if any float leaf contains NaN/Inf."""
    return not _leaf_stats(v for _, v in _walk_state_dict(tree))[0]


def _verdict(finite: bool, mag, max_abs) -> tuple[bool, str]:
    if not finite:
        return False, "nonfinite"
    # <= 0 disables, exactly like None (the JAX package's one home of
    # that rule)
    if max_abs is not None and max_abs > 0 and float(mag) > max_abs:
        return False, (f"magnitude_exceeded({float(mag):.3e}"
                       f">{max_abs:.3e})")
    return True, "ok"


def screen_delta(delta: Tree, base: Tree, *, max_abs: float | None = None,
                 check_dtype: bool = True,
                 extra_dtypes: Sequence[str] = ("bfloat16",)
                 ) -> tuple[bool, str]:
    """Full admission screen for one untrusted dense delta: structure,
    shapes and dtypes against the base, finiteness, and the optional
    magnitude cap. Returns ``(ok, reason)`` with the JAX package's
    reason strings."""
    if not shapes_match(delta, base, check_dtype=check_dtype,
                        extra_dtypes=extra_dtypes):
        return False, "shape_mismatch"
    finite, mag = _leaf_stats(v for _, v in _walk_state_dict(delta))
    return _verdict(finite, mag, max_abs)


def screen_deltas(deltas: Sequence[Tree], base: Tree, *,
                  max_abs: float | None = None, check_dtype: bool = True,
                  extra_dtypes: Sequence[str] = ("bfloat16",)
                  ) -> list[tuple[bool, str]]:
    """``screen_delta`` over a cohort, with the JAX package's verdicts and
    check order. v2 PACKED deltas screen in their packed form, no
    densify: admission is :func:`packed_matches`, then
    :func:`_packed_screen_stats`, whose finite/max verdicts equal the
    dense screen's on the densified tree."""
    out = []
    for d in deltas:
        if is_packed_v2(d):
            if not packed_matches(d, base):
                out.append((False, "shape_mismatch"))
                continue
            out.append(_verdict(*_packed_screen_stats(d["leaves"]),
                                max_abs))
            continue
        out.append(screen_delta(d, base, max_abs=max_abs,
                                check_dtype=check_dtype,
                                extra_dtypes=extra_dtypes))
    return out


# ---------------------------------------------------------------------------
# v1 wire decodes: int8 ({"q", "scale"} leaves) and sparse8
# ---------------------------------------------------------------------------

def _is_qleaf(node) -> bool:
    return isinstance(node, Mapping) and set(node) == {"q", "scale"}


def _map_tree(fn, tree, is_leaf=lambda n: not isinstance(n, Mapping)):
    if is_leaf(tree):
        return fn(tree)
    return {k: _map_tree(fn, v, is_leaf) for k, v in tree.items()}


def dequantize_delta(qtree: Tree) -> Tree:
    """int8 wire tree (``{"q": int8, "scale": f32}`` leaves) -> f32 host
    tree, ``q * scale`` in f32."""
    return _map_tree(lambda d: (np.asarray(d["q"]).astype(np.float32)
                                * np.asarray(d["scale"], np.float32)),
                     qtree, is_leaf=_is_qleaf)


def quantized_template(base_template: Tree) -> Tree:
    """Host zeros tree in the int8 wire structure: the restore template
    that discriminates int8 submissions."""
    return _map_tree(lambda x: {"q": np.zeros(_shape(x), np.int8),
                                "scale": np.zeros((), np.float32)},
                     base_template)


SPARSE_FORMAT_KEY = "__delta_format__"
SPARSE_FORMAT_TOPK8 = 1
# leaves at or below this size ship dense (k = n)
SPARSE_DENSE_CUTOFF = 4096


def sparse_k(n: int, density: float) -> int:
    """Per-leaf kept-coordinate count: dense below the cutoff, else
    ceil(n * density) — at LEAST the density fraction, never 0."""
    if n <= SPARSE_DENSE_CUTOFF:
        return n
    return max(1, -int(-n * density // 1))


# kept-value dtypes a packed entry's "q" may carry: int8 or f32 (--wire-quant
# none); anything else is a hostile substitution
_PACKED_Q_DTYPES = ("int8", "float32")


def _host_field(x):
    """A packed field as numpy, or None for what no wire form carries (a
    bf16 tensor off the decoder)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return None
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _validate_packed_entry(entry, n: int, *,
                           q_dtypes: tuple = ("int8",)) -> tuple | None:
    """Field-wise validation of one top-k packed entry ``{"idx", "q",
    "scale"}`` against a template leaf of ``n`` elements: key set, dtypes
    (idx int32, q in ``q_dtypes``, scale f32 scalar), k <= n, a finite
    non-negative scale, index bounds. Returns host ``(idx, q, scale)`` or
    None."""
    if not isinstance(entry, Mapping) or set(entry) != {"idx", "q", "scale"}:
        return None
    idx, q, scale = (_host_field(entry[k]) for k in ("idx", "q", "scale"))
    if idx is None or q is None or scale is None:
        return None
    if (idx.dtype != np.int32 or q.dtype.name not in q_dtypes
            or scale.dtype != np.float32):
        return None
    if idx.ndim != 1 or q.ndim != 1 or scale.shape != ():
        return None
    if not np.isfinite(scale) or scale < 0:
        # a negative scale would flip the sign of max|q|*scale in the
        # packed magnitude screen
        return None
    if idx.shape[0] == 0 and q.shape[0] == n and n > 0:
        return idx, q, scale      # dense-form entry (k == n)
    if q.shape != idx.shape or idx.shape[0] > n:
        return None
    if idx.shape[0] and (idx.min() < 0 or idx.max() >= n):
        return None
    return idx, q, scale


def _densify_packed_entry(idx, q, scale, shape) -> np.ndarray:
    """Validated entry -> dense f32 host array. Duplicate indices resolve
    last-wins (deterministic; screens run on the result regardless)."""
    n = int(np.prod(shape, dtype=np.int64))
    if idx.shape[0] == 0 and q.shape[0] == n and n > 0:
        return (q.astype(np.float32) * np.float32(scale)).reshape(shape)
    dense = np.zeros((n,), np.float32)
    dense[idx] = q.astype(np.float32) * np.float32(scale)
    return dense.reshape(shape)


def _packed_tree_fields(leaves, template, *, q_dtypes: tuple = ("int8",)):
    """Validate a packed-leaves tree against ``template`` leaf by leaf:
    path parity (each template leaf maps to exactly one entry), then
    :func:`_validate_packed_entry` per entry. Returns ``[(path, shape,
    (idx, q, scale)), ...]`` in template walk order, or None."""
    if not isinstance(leaves, Mapping):
        return None
    t_flat = list(_walk_state_dict(template))
    s_by_parent: dict = {}
    for path, leaf in _walk_state_dict(leaves):
        if len(path) < 1:
            return None
        s_by_parent.setdefault(path[:-1], {})[path[-1]] = leaf
    if len(s_by_parent) != len(t_flat):
        return None
    out = []
    for path, t_leaf in t_flat:
        entry = s_by_parent.get(path)
        if entry is None:
            return None
        fields = _validate_packed_entry(
            entry, int(np.prod(_shape(t_leaf), dtype=np.int64)),
            q_dtypes=q_dtypes)
        if fields is None:
            return None
        out.append((path, _shape(t_leaf), fields))
    return out


def _densify_fields(fields, template) -> Tree:
    """Validated ``_packed_tree_fields`` output -> dense f32 host tree
    shaped like ``template``."""
    out = _map_tree(lambda x: x, template)
    for path, shape, entry_fields in fields:
        node = out
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = _densify_packed_entry(*entry_fields, shape)
    return out


def densify_sparse_delta(sparse: Tree, template: Tree) -> Tree | None:
    """sparse8 wire tree -> dense f32 host delta shaped like
    ``template``, or None on any mismatch (format marker, path parity,
    pinned dtypes, k <= n, index bounds). A hostile marker reads as "not
    sparse8", never raises."""
    if not isinstance(sparse, Mapping):
        return None
    marker = sparse.get(SPARSE_FORMAT_KEY)
    try:
        marker_arr = np.asarray(marker)
        if marker_arr.shape != () or not np.issubdtype(
                marker_arr.dtype, np.integer):
            return None
        if int(marker_arr) != SPARSE_FORMAT_TOPK8:
            return None
    except (TypeError, ValueError):
        return None
    leaves = sparse.get("leaves")
    if not isinstance(leaves, Mapping) or set(sparse) != {
            SPARSE_FORMAT_KEY, "leaves"}:
        return None
    fields = _packed_tree_fields(leaves, template, q_dtypes=("int8",))
    if fields is None:
        return None
    return _densify_fields(fields, template)


def sparse_delta_from_bytes(data: bytes, template: Tree,
                            *, max_bytes: int | None = None) -> Tree | None:
    """Raw artifact bytes -> dense delta if they are a valid sparse8
    artifact, else None."""
    from . import serialization as ser

    try:
        kw = {} if max_bytes is None else {"max_bytes": max_bytes}
        raw = ser.from_msgpack(data, None, **kw)
    except ser.PayloadError:
        return None
    try:
        return densify_sparse_delta(raw, template)
    except (TypeError, ValueError, KeyError, IndexError):
        return None


# ---------------------------------------------------------------------------
# Wire v2: the packed per-layer top-k form with error feedback
# ---------------------------------------------------------------------------

WIRE_V2_KEY = "__wire_v2__"
WIRE_V2_FORMAT = 2
WIRE_QUANTS = ("int8", "none")


def is_packed_entry(node) -> bool:
    """True for one packed per-tensor entry ``{"idx", "q", "scale"}``."""
    return isinstance(node, Mapping) and set(node) == {"idx", "q", "scale"}


def is_packed_v2(tree) -> bool:
    """True when ``tree`` is a v2 packed delta (marker + leaves keys and
    an integer format-2 marker). Hostile marker types read as "not v2",
    never raise."""
    if not isinstance(tree, Mapping) or set(tree) != {WIRE_V2_KEY, "leaves"}:
        return False
    m = tree[WIRE_V2_KEY]
    try:
        if isinstance(m, torch.Tensor):
            m = m.detach().cpu().numpy()
        m = np.asarray(m)
        return (m.shape == () and np.issubdtype(m.dtype, np.integer)
                and int(m) == WIRE_V2_FORMAT)
    except (TypeError, ValueError):
        return False


def nest_tree(flat: Mapping[str, Any]) -> dict:
    """``.``-keyed entries as the nested JAX-layout tree (the inverse of
    :func:`flatten_tree`)."""
    out: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


@torch.no_grad()
def pack_delta_v2(delta: Params, *, density: float = 1.0 / 64.0,
                  quant: str = "int8", residual: Params | None = None
                  ) -> tuple[dict, dict[str, torch.Tensor]]:
    """Float delta (a state dict) -> (v2 packed tree, new error-feedback
    residual, a state dict of f32 tensors).

    Per leaf: the ``sparse_k`` largest |values| (ties to the lower index,
    as ``lax.top_k`` breaks them: a stable descending sort), kept values
    int8-quantized against the leaf's own max (or f32 under
    ``quant="none"``). ``residual`` (the previous publish's unsent mass)
    is added before selection; the returned residual is ``(delta +
    residual) - decode(packed)``. Leaves at or below the dense cutoff ship
    in dense form (empty ``idx``, full ``q``). The packed leaves are a
    nested tree in the JAX layout, on the delta's device."""
    if not 0.0 < density <= 1.0:
        raise ValueError(f"density must be in (0, 1], got {density}")
    if quant not in WIRE_QUANTS:
        raise ValueError(f"quant must be one of {WIRE_QUANTS}, got {quant!r}")
    if residual is not None and residual.keys() != delta.keys():
        raise ValueError("pack_delta_v2: residual/delta structure mismatch")
    entries, res = {}, {}
    for key, x in delta.items():
        if not x.is_floating_point():
            raise ValueError(
                f"pack_delta_v2: non-float leaf of dtype {x.dtype} — the v2 "
                "wire covers all-float delta trees only")
        flat = x.reshape(-1).to(torch.float32)
        if residual is not None:
            flat = flat + residual[key].reshape(-1).to(torch.float32)
        n = flat.numel()
        k = sparse_k(n, density)
        dense_form = k >= n
        if dense_form:
            idx = torch.zeros((0,), dtype=torch.int32, device=flat.device)
            kept = flat
            top_mag = (flat.abs().max() if n else
                       torch.zeros((), dtype=torch.float32,
                                   device=flat.device))
        else:
            mags, order = torch.sort(flat.abs(), descending=True,
                                     stable=True)
            idx = order[:k].to(torch.int32)
            kept = flat[order[:k]]
            top_mag = mags[0]
        if quant == "int8":
            scale = torch.clamp(top_mag, min=1e-12) / 127.0
            q = torch.clamp(torch.round(kept / scale), -127, 127
                            ).to(torch.int8)
            decoded = q.to(torch.float32) * scale
        else:
            scale = torch.ones((), dtype=torch.float32, device=flat.device)
            q = kept
            decoded = kept
        if dense_form:
            r = flat - decoded
        else:
            # top-k indices are unique: a scatter-add of -decoded
            r = flat.clone()
            r[idx.long()] = flat[idx.long()] - decoded
        entries[key] = {"idx": idx, "q": q, "scale": scale}
        res[key] = r.reshape(x.shape)
    packed = {WIRE_V2_KEY: np.int32(WIRE_V2_FORMAT), "leaves": nest_tree(entries)}
    return packed, res


def packed_matches(packed: Tree, base: Tree) -> bool:
    """Admission check for an untrusted packed v2 tree against the wire
    template ``base``: marker, per-leaf path parity, pinned field dtypes,
    k <= n, finite non-negative scales, index bounds."""
    if not is_packed_v2(packed):
        return False
    try:
        return _packed_tree_fields(packed["leaves"], base,
                                   q_dtypes=_PACKED_Q_DTYPES) is not None
    except (TypeError, ValueError, KeyError):
        return False


def densify_packed_v2(packed: Tree, template: Tree) -> Tree | None:
    """v2 packed tree -> dense f32 HOST delta shaped like ``template``,
    or None on any validation failure (int8 AND f32 kept values)."""
    if not is_packed_v2(packed):
        return None
    try:
        fields = _packed_tree_fields(packed["leaves"], template,
                                     q_dtypes=_PACKED_Q_DTYPES)
    except (TypeError, ValueError, KeyError):
        return None
    if fields is None:
        return None
    return _densify_fields(fields, template)


def packed_layer_entries(packed: Tree) -> dict[str, dict]:
    """Host split of a packed v2 tree into its shard units: one
    ``"a/b/c" -> {"idx", "q", "scale"}`` (numpy) per wire tensor, keys the
    ``/``-joined wire paths the shard manifest is addressed by. The
    publisher's own tree: malformed input raises."""
    if not is_packed_v2(packed):
        raise ValueError("packed_layer_entries: not a v2 packed tree")
    by_parent: dict = {}
    for path, leaf in _walk_state_dict(packed["leaves"]):
        if any("/" in str(k) for k in path):
            raise ValueError(f"packed_layer_entries: path component with "
                             f"'/' in {path!r} would make layer keys "
                             "ambiguous")
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        by_parent.setdefault(path[:-1], {})[path[-1]] = np.asarray(leaf)
    return {"/".join(str(k) for k in p): e for p, e in by_parent.items()}


def packed_from_layer_entries(entries: Mapping[str, Mapping]) -> dict:
    """Inverse of :func:`packed_layer_entries`: reassemble shard entries
    (keys from an UNTRUSTED manifest) into a v2 packed tree. Purely
    structural: colliding or hostile keys give a tree that then fails
    :func:`packed_matches`, never an exception here."""
    nested: dict = {}
    for key, entry in entries.items():
        parts = str(key).split("/")
        node = nested
        ok = True
        for p in parts[:-1]:
            nxt = node.setdefault(p, {})
            if not isinstance(nxt, dict):
                ok = False
                break
            node = nxt
        if ok:
            node[parts[-1]] = entry
    return {WIRE_V2_KEY: np.int32(WIRE_V2_FORMAT), "leaves": nested}


def _packed_entries(leaves) -> list[tuple[str, Mapping]]:
    """``(state-dict key, entry)`` for every packed entry of a leaves
    tree, in walk order."""
    out = []

    def walk(node, path):
        if is_packed_entry(node):
            out.append((".".join(str(k) for k in path), node))
            return
        for key in sorted(node):
            walk(node[key], path + (key,))

    walk(leaves, ())
    return out


def _packed_screen_stats(leaves) -> tuple[bool, np.float32]:
    """(finite, max |decoded value|) of one packed leaves tree, with no
    densify: int8 kept values are finite by construction, so finiteness
    is the scales' (and f32 kept values'); the decoded max is
    ``max|q| * |scale|`` per tensor, the abs covering the scale too."""
    finite, m = True, np.float32(0.0)
    for _, e in _packed_entries(leaves):
        scale = _f32(e["scale"])
        q = e["q"]
        qf = _f32(q)
        if not np.isfinite(scale).all():
            finite = False
        if _is_float(q) and not np.isfinite(qf).all():
            finite = False
        if qf.size:
            m = max(m, np.float32(np.max(np.abs(qf)))
                    * np.float32(np.abs(scale)))
    return finite, m


# ---------------------------------------------------------------------------
# Merges
# ---------------------------------------------------------------------------

def normalized_merge_weights(miner_ids: Sequence[str],
                             consensus: Mapping[str, float] | None
                             ) -> np.ndarray:
    """Consensus scores -> normalized ``(M,)`` f32 mixing vector:
    negative scores clamp to zero, an all-zero (or absent) score set falls
    back to uniform, and normalization runs over the real miner count."""
    m = len(miner_ids)
    if m == 0:
        raise ValueError("normalized_merge_weights: empty cohort")
    if not consensus:
        return np.full((m,), 1.0 / m, np.float32)
    raw = np.asarray([max(float(consensus.get(h, 0.0)), 0.0)
                      for h in miner_ids], np.float32)
    total = float(raw.sum())
    if not np.isfinite(total) or total <= 0:
        return np.full((m,), 1.0 / m, np.float32)
    return np.asarray(raw / total, np.float32)


def _dense_leaf(x, like: torch.Tensor) -> torch.Tensor:
    """A dense delta leaf (numpy, or a tensor) in f32 on ``like``'s
    device."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        # arrays decoded from msgpack are read-only views of its buffer
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    return x.to(device=like.device, dtype=torch.float32)


@torch.no_grad()
def chunked_weighted_merge(base: Params, deltas: Sequence[Tree],
                           weights, *, chunk: int = 8
                           ) -> dict[str, torch.Tensor]:
    """``base + sum_i weights[i] * delta_i`` over a HOST list of dense
    deltas (wire trees or state dicts), at most ``chunk`` of them on the
    device at a time: each chunk's weighted sum, accumulated in the base's
    dtype, is added to the running result."""
    m = len(deltas)
    if m == 0:
        raise ValueError("chunked_weighted_merge: empty delta list")
    w = np.asarray(weights, np.float32).reshape(-1)
    if w.shape[0] != m:
        raise ValueError(f"{w.shape[0]} weights for {m} deltas")
    chunk = max(1, min(chunk, m))
    merged = {k: v.detach().clone() for k, v in base.items()}
    for i in range(0, m, chunk):
        flats = [flatten_tree(d) for d in deltas[i:i + chunk]]
        for key, b in merged.items():
            s = None
            for f, wi in zip(flats, w[i:i + chunk]):
                term = _dense_leaf(f[key], b).to(b.dtype) * float(wi)
                s = term if s is None else s + term
            b.add_(s)
    return merged


@torch.no_grad()
def accumulate_delta(acc: Params, delta: Tree, weight) -> Params:
    """``acc += weight * delta`` in place, where ``acc`` is an f32 state
    dict and ``delta`` a dense tree (wire tree or state dict) OR a v2
    packed tree already admitted by :func:`packed_matches`. Packed entries
    pair with ``acc`` by path and fold without densifying: the
    indexed-form entries of the contribution in one ``ops.dequant_scatter``
    fold (one launch of the CUDA kernel for a CUDA accumulator),
    dense-form entries as ``acc + w * (q * scale)``. Their idx and q reach
    a CUDA device in one copy from a pinned staging buffer. The weight is
    taken as f32."""
    from .ops import dequant_scatter as dsc

    w = float(np.float32(weight))
    if is_packed_v2(delta):
        entries = _packed_entries(delta["leaves"])
        keys = [k for k, _ in entries]
        if sorted(keys) != sorted(acc) or len(set(keys)) != len(keys):
            raise ValueError(
                f"accumulate_delta: packed entry paths do not match the "
                f"accumulator's keys ({sorted(set(keys) ^ set(acc))[:5]}; "
                "run packed_matches before accumulating)")
        indexed, dense = [], []
        for key, e in entries:
            flat = acc[key].view(-1)
            idx, q = _host_field(e["idx"]), _host_field(e["q"])
            scale = np.float32(_host_field(e["scale"]))
            n = flat.numel()
            if idx.size == 0 and q.size == n and n > 0:
                dense.append((flat, q, scale))
            elif idx.size:
                indexed.append((flat, idx, q, dsc.fold_weight(w, scale)))
        c = dsc.stage_contribution(
            indexed, [q for _, q, _ in dense],
            device=acc[keys[0]].device if keys else None)
        for (flat, _, scale), q in zip(dense, c.extra):
            # a Python float holding the f32 scale multiplies as the f32
            flat.add_((q.to(torch.float32) * float(scale)) * w)
        dsc.dequant_scatter_contribution(c)
        return acc
    flat_d = flatten_tree(delta)
    _same_keys(acc, flat_d)
    for key, a in acc.items():
        a.add_(_dense_leaf(flat_d[key], a) * w)
    return acc


@torch.no_grad()
def aggregate_deltas(template: Params, deltas: Sequence[Tree],
                     weights) -> dict[str, torch.Tensor]:
    """``sum_i weights[i] * delta_i`` over a HOST list of mixed dense and
    packed submissions into one f32 accumulator on the template's device,
    one contribution at a time (:func:`accumulate_delta`). ``weights``
    are used as given (normalize with :func:`normalized_merge_weights`)."""
    if not deltas:
        raise ValueError("aggregate_deltas: empty delta list")
    w = np.asarray(weights, np.float32).reshape(-1)
    if w.shape[0] != len(deltas):
        raise ValueError(f"{w.shape[0]} weights for {len(deltas)} deltas")
    acc = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
           for k, v in template.items()}
    for d, wi in zip(deltas, w):
        accumulate_delta(acc, d, wi)
    return acc
