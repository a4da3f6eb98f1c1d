"""Snapshot store — paper §4.4 crash recovery (snapshot half).

Two on-disk formats live here, file for file the JAX package's:

* **Legacy full snapshots** (``save_snapshot``/``load_snapshot``): one dir
  with ``manifest.json`` + ``leaves.npz`` holding every state leaf,
  committed by atomic rename with a ``path.old`` rotation fallback.  Used
  by ``SPFreshIndex.snapshot``.

* **Chained incremental snapshots** (:class:`SnapshotStore`): the paper's
  block-level copy-on-write made durable.  A store directory holds *units*
  — ``base-<id>`` dirs (a full snapshot) and ``delta-<id>`` dirs (only the
  blocks the pool's dirty bitmap marked since the previous unit, plus the
  small non-block leaves, as one file per shard) — chained by parent links
  in their manifests.  A ``CURRENT`` pointer file names the head unit and
  is the commit point: it is replaced atomically only after the new unit
  dir has fully landed, so at EVERY crash point the store resolves a
  complete recovery chain.  Restore = base + ordered deltas; compaction
  folds the chain back into a fresh base and only then prunes the old
  units.

Leaves are stored positionally as ``leaf_i`` in ``tensor_leaves`` order,
which is the JAX package's flatten order of the same state, so either
package reads the other's snapshots.  A bfloat16 leaf is stored as numpy
writes the JAX package's: its 2-byte bit pattern as a ``|V2`` void, never
converted numerically.  Leaves are found by their dotted names
(``pool.dirty``, ``pool.post_scale``, ``telemetry.*``).  A legacy
snapshot also takes a plain list of tensors, stored in list order (the
training checkpoints of ``train/checkpoint.py``).

A state is read into numpy arrays and then filled straight onto the
device (``convert.fill_state``): the template passed to a load gives only
names, shapes and dtypes and may live on the meta device.

A sharded state (the port's list of per-shard states) is stored in the
JAX package's stacked layout: every leaf of a base unit carries a leading
``(n_shards,)`` axis, each shard's leaf copied to the host into its slice
of the stacked host array (nothing is stacked on the card), and a delta
holds one ``shard_{s:03d}.npz`` per shard.  It loads through
:func:`stacked_template`.

Manifest format 2 adds ``kind``/``unit``/``parent``/``chain_len``/
``n_shards``; format-1 snapshots (and states saved before the pool grew
its ``dirty`` leaf) load through an explicit migration path: the missing
leaves are reconstructed from the template.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.convert import fill_state
from repro_torch.utils.tree import map_tensors, tensor_leaves

_MANIFEST = "manifest.json"
_LEAVES = "leaves.npz"
_CURRENT = "CURRENT"
_FORMAT = 2

# Test seam: called with a named step label at every crash point of a
# unit commit / compaction prune so tests can kill the process (raise) at
# each step and assert the store still resolves a complete chain.
_crash_hook: Callable[[str], None] | None = None


def _crash_point(label: str) -> None:
    if _crash_hook is not None:
        _crash_hook(label)


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    """Durably commit a directory's entries (renames live here) — the WAL
    is truncated right after a checkpoint, so the snapshot must reach the
    platter first or power loss could destroy acknowledged updates."""
    fd = os.open(path, getattr(os, "O_DIRECTORY", os.O_RDONLY))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_tree(d: str) -> None:
    for name in os.listdir(d):
        _fsync_file(os.path.join(d, name))
    _fsync_dir(d)


# ---------------------------------------------------------------------------
# Leaf helpers shared by both formats
# ---------------------------------------------------------------------------

def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf as the array ``np.save`` stores: bfloat16 as its bit pattern
    in a 2-byte void (``|V2``), as numpy stores the JAX package's."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _host_leaves(state: Any) -> list[np.ndarray]:
    """The leaves a base unit stores, in leaf order.  A list of per-shard
    states is stored stacked: each shard's leaf is copied to the host into
    its slice of one host array."""
    if not isinstance(state, (list, tuple)):
        return [to_numpy(x) for x in tensor_leaves(state).values()]
    per = [list(tensor_leaves(st).values()) for st in state]
    out = []
    for j, first in enumerate(per[0]):
        host = torch.empty((len(per),) + tuple(first.shape), dtype=first.dtype)
        for s, leaves in enumerate(per):
            host[s].copy_(leaves[j])
        out.append(to_numpy(host))
    return out


def stacked_template(template: Any, n_shards: int) -> Any:
    """``template`` with a leading ``(n_shards,)`` axis on every leaf, on
    the meta device: the shapes a sharded unit stores."""
    return map_tensors(
        lambda t: torch.empty((n_shards,) + tuple(t.shape), dtype=t.dtype, device="meta"),
        template,
    )


def _zeros_like(t: torch.Tensor) -> np.ndarray:
    dtype = np.dtype("V2") if t.dtype == torch.bfloat16 else \
        torch.empty((), dtype=t.dtype).numpy().dtype
    return np.zeros(tuple(t.shape), dtype)


def _ones_like(t: torch.Tensor) -> np.ndarray:
    return np.ones(tuple(t.shape), _zeros_like(t).dtype)


def _path_names(template: Any) -> list[list[str]]:
    """Each leaf's attribute path, in leaf order."""
    return [name.split(".") for name in tensor_leaves(template)]


def _dirty_leaf_index(template: Any) -> int | None:
    """Leaf index of ``pool.dirty`` (None when the state has no pool)."""
    for i, names in enumerate(_path_names(template)):
        if names[-2:] == ["pool", "dirty"]:
            return i
    return None


def _telemetry_leaf_indices(template: Any) -> list[int]:
    """Leaf indices of the ``telemetry`` sub-tree (the LAST state field,
    so trailing; snapshots written before it existed reconstruct them as
    zeros)."""
    return [i for i, names in enumerate(_path_names(template))
            if len(names) >= 2 and names[-2] == "telemetry"]


def _codec_leaf_indices(template: Any) -> dict[str, int]:
    """Leaf indices of the pool's per-posting codec params
    (``post_scale`` / ``post_zero``) — reconstructed for snapshots
    written before the payload codec existed.  ``blocks_exact`` is NOT
    here: a pre-codec snapshot can only be opened under the fp32 codec
    (replay-critical drift check), whose pool has no exact-tier leaf."""
    return {names[-1]: i for i, names in enumerate(_path_names(template))
            if len(names) >= 2 and names[-2] == "pool"
            and names[-1] in ("post_scale", "post_zero")}


def _block_leaf_indices(template: Any) -> dict[str, int] | None:
    """Leaf indices of the per-block pool arrays (``pool.blocks`` /
    ``block_vid`` / ``block_ver`` / ``dirty``, plus the optional cold
    exact tier ``blocks_exact`` when the codec keeps one) — the leaves a
    delta snapshot stores at block granularity instead of in full."""
    want = ("blocks", "block_vid", "block_ver", "dirty")
    opt = ("blocks_exact",)
    out = {names[-1]: i for i, names in enumerate(_path_names(template))
           if len(names) >= 2 and names[-2] == "pool" and names[-1] in want + opt}
    return out if all(n in out for n in want) else None


def _assemble(template: Any, leaves_np: list[np.ndarray], device) -> Any:
    """``template`` filled with ``leaves_np`` (in leaf order) on ``device``
    (default: the template's own)."""
    names = list(tensor_leaves(template))
    if device is None:
        device = next(iter(tensor_leaves(template).values())).device
    return fill_state(template, dict(zip(names, leaves_np)), device=device)


# ---------------------------------------------------------------------------
# Legacy full snapshots (format 1)
# ---------------------------------------------------------------------------

def _leaf_list(state: Any) -> list[torch.Tensor]:
    """A state's leaves in leaf order: a list of tensors as it is (a
    training checkpoint's, already in the reference's order), else the
    state dataclass's ``tensor_leaves``."""
    if isinstance(state, list):
        return state
    return list(tensor_leaves(state).values())


def save_snapshot(path: str, state: Any, *, step: int = 0, extra: dict | None = None) -> None:
    """Crash-safe commit: write to a temp dir, rotate the previous
    snapshot aside (``path + ".old"``), rename the new one in, then drop
    the old.  At EVERY intermediate crash point either ``path`` or
    ``path.old`` holds a complete snapshot — ``load_snapshot`` /
    ``snapshot_exists`` resolve the fallback — so a checkpoint can never
    destroy the only recovery point (the WAL is truncated strictly after
    this function returns)."""
    leaves = _leaf_list(state)
    arrays = {f"leaf_{i}": to_numpy(x) for i, x in enumerate(leaves)}
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".snap_tmp_")
    old = path + ".old"
    try:
        np.savez(os.path.join(tmp, _LEAVES), **arrays)
        manifest = {
            "format": _FORMAT,
            "kind": "base",
            "n_leaves": len(leaves),
            "step": step,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as fh:
            json.dump(manifest, fh)
        _fsync_tree(tmp)       # data on the platter before the renames
        if os.path.exists(path):
            # Only rotate when a live primary exists: if a prior crash
            # left the .old fallback as the ONLY snapshot, deleting it
            # before the new commit would violate the invariant above.
            shutil.rmtree(old, ignore_errors=True)
            os.replace(path, old)
        os.replace(tmp, path)  # commit
        _fsync_dir(parent)     # ...and the renames before WAL truncation
        shutil.rmtree(old, ignore_errors=True)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


def _resolve(path: str) -> str:
    """The live snapshot dir: ``path``, or the rotated-aside ``path.old``
    if a crash hit save_snapshot between its two renames."""
    if os.path.exists(os.path.join(path, _MANIFEST)):
        return path
    if os.path.exists(os.path.join(path + ".old", _MANIFEST)):
        return path + ".old"
    return path


def read_manifest(path: str) -> dict:
    """The snapshot manifest alone (cheap: no leaf arrays loaded)."""
    with open(os.path.join(_resolve(path), _MANIFEST)) as fh:
        return json.load(fh)


def _load_leaves_npz(path: str, template: Any, n_leaves: int) -> list[np.ndarray]:
    """Positional ``leaf_i`` arrays with the older-format migrations (see
    ``_migrate_leaves``)."""
    data = np.load(path)
    return _migrate_leaves(
        [data[f"leaf_{i}"] for i in range(n_leaves)], template
    )


def _migrate_leaves(raw: list[np.ndarray], template: Any) -> list[np.ndarray]:
    """Insert reconstructed leaves into a positionally-loaded older-format
    leaf list.  A snapshot written before the pool grew its ``dirty``
    leaf, the state grew its ``telemetry`` sub-tree, and/or the pool grew
    its codec params (``post_scale``/``post_zero``) is short those leaves;
    each missing leaf is reconstructed from the template at its leaf
    position (all-clean bitmap, zeroed counters, identity codec — scale 1,
    zero 0).  The leaf groups landed in a fixed order (dirty → telemetry
    → codec), so every historical generation maps to a distinct deficit:
    1 (dirty), 2 (codec), 3 (telemetry), 4 (dirty+tel), 5 (tel+codec), or
    6 (dirty+tel+codec).  A delta CHAIN folds in its own (old) leaf
    coordinates first and migrates once at the end."""
    tmpl_leaves = _leaf_list(template)
    n_leaves = len(raw)
    if n_leaves == len(tmpl_leaves):
        return raw
    if isinstance(template, list):
        raise ValueError(f"snapshot has {n_leaves} leaves, template has {len(tmpl_leaves)}")
    dirty_at = _dirty_leaf_index(template)
    tel_at = _telemetry_leaf_indices(template)
    codec_at = _codec_leaf_indices(template)
    missing = len(tmpl_leaves) - n_leaves
    # index -> fill value factory for each reconstructible leaf group
    dirty_g = {dirty_at: _zeros_like} if dirty_at is not None else None
    tel_g = {i: _zeros_like for i in tel_at} if tel_at else None
    codec_g = (
        {codec_at["post_scale"]: _ones_like,
         codec_at["post_zero"]: _zeros_like}
        if len(codec_at) == 2 else None
    )
    reconstruct: dict[int, Any] = {}
    for groups in (
        (dirty_g,), (codec_g,), (tel_g,), (dirty_g, tel_g),
        (tel_g, codec_g), (dirty_g, tel_g, codec_g),
    ):
        if all(g is not None for g in groups) \
                and missing == sum(len(g) for g in groups):
            for g in groups:
                reconstruct.update(g)
            break
    if reconstruct:
        out, src = [], 0
        for i, tmpl in enumerate(tmpl_leaves):
            if i in reconstruct:
                out.append(reconstruct[i](tmpl))
            else:
                out.append(raw[src])
                src += 1
        return out
    raise ValueError(
        f"snapshot has {n_leaves} leaves, template has {len(tmpl_leaves)}"
    )


def load_snapshot_arrays(path: str, template: Any) -> tuple[list[np.ndarray], dict]:
    """The legacy snapshot's leaves as numpy arrays, in leaf order, and its
    manifest."""
    path = _resolve(path)
    with open(os.path.join(path, _MANIFEST)) as fh:
        manifest = json.load(fh)
    leaves = _load_leaves_npz(
        os.path.join(path, _LEAVES), template, manifest["n_leaves"]
    )
    return leaves, manifest


def load_snapshot(path: str, template: Any, *, device=None) -> tuple[Any, dict]:
    """Restore a state with the same structure as ``template`` on
    ``device`` (default: the template's)."""
    leaves, manifest = load_snapshot_arrays(path, template)
    return _assemble(template, leaves, device), manifest


def snapshot_exists(path: str) -> bool:
    return os.path.exists(os.path.join(_resolve(path), _MANIFEST))


# ---------------------------------------------------------------------------
# SnapshotStore — chained base + delta units (format 2)
# ---------------------------------------------------------------------------

_UNIT_RE = re.compile(r"^(base|delta)-(\d{10})$")


class SnapshotChainError(RuntimeError):
    """The store's head chain references a unit that no longer resolves."""


class SnapshotStore:
    """Base + delta snapshot chain under one directory (see module doc).

    The store is format-compatible with a legacy full-snapshot dir: a
    root that holds only ``manifest.json``/``leaves.npz`` (or its
    ``.old`` rotation) loads as an implicit base, and the first
    ``save_base`` converts the root to the chained layout (pruning the
    legacy files only after the new unit commits).
    """

    def __init__(self, path: str):
        self.path = path

    # ----------------------------- resolve -----------------------------
    def _units(self) -> list[str]:
        if not os.path.isdir(self.path):
            return []
        return sorted(
            d for d in os.listdir(self.path)
            if _UNIT_RE.match(d)
            and os.path.exists(os.path.join(self.path, d, _MANIFEST))
        )

    def _unit_manifest(self, unit: str) -> dict:
        with open(os.path.join(self.path, unit, _MANIFEST)) as fh:
            return json.load(fh)

    def _chain(self, head: str) -> list[str]:
        """``[base, delta, ..., head]`` oldest-first; raises
        :class:`SnapshotChainError` on a broken parent link."""
        chain = []
        unit: str | None = head
        while unit is not None:
            if not os.path.exists(os.path.join(self.path, unit, _MANIFEST)):
                raise SnapshotChainError(
                    f"{self.path}: chain references missing unit {unit!r}"
                )
            chain.append(unit)
            unit = self._unit_manifest(unit).get("parent")
        if not chain or not chain[-1].startswith("base-"):
            raise SnapshotChainError(
                f"{self.path}: chain from {head!r} has no base"
            )
        return chain[::-1]

    def _head(self) -> str | None:
        """The committed head unit: ``CURRENT`` when it resolves, else the
        newest unit with a complete chain (crash between unit rename and
        the CURRENT update — both states are consistent recovery points
        because the WAL is truncated strictly after the commit)."""
        cur = os.path.join(self.path, _CURRENT)
        if os.path.exists(cur):
            with open(cur) as fh:
                head = fh.read().strip()
            try:
                self._chain(head)
                return head
            except SnapshotChainError:
                pass
        for unit in reversed(self._units()):
            try:
                self._chain(unit)
                return unit
            except SnapshotChainError:
                continue
        return None

    def _legacy_exists(self) -> bool:
        return os.path.exists(os.path.join(_resolve(self.path), _MANIFEST))

    def exists(self) -> bool:
        return self._head() is not None or self._legacy_exists()

    def has_base(self) -> bool:
        """True when a chained-layout head exists to hang a delta on (a
        legacy-layout root must be rebased by a full save first)."""
        return self._head() is not None

    def read_manifest(self) -> dict:
        head = self._head()
        if head is not None:
            return self._unit_manifest(head)
        return read_manifest(self.path)

    def chain_len(self) -> int:
        """Deltas stacked on the current base (0 = head is a base)."""
        head = self._head()
        if head is None:
            return 0
        return int(self._unit_manifest(head).get("chain_len", 0))

    # ------------------------------ write ------------------------------
    def _next_unit(self, kind: str) -> str:
        ids = [int(_UNIT_RE.match(u).group(2)) for u in self._units()]
        return f"{kind}-{(max(ids) + 1 if ids else 1):010d}"

    def _commit_unit(self, tmp: str, unit: str) -> None:
        """tmp dir → unit dir → CURRENT, with crash points between; every
        data file, the unit dir, and the store dir are fsync'd so the
        commit is on the platter BEFORE the caller truncates the WAL."""
        _fsync_tree(tmp)
        _crash_point("pre_commit")
        os.replace(tmp, os.path.join(self.path, unit))
        _fsync_dir(self.path)
        _crash_point("post_commit")
        cur_tmp = os.path.join(self.path, f".current_tmp_{unit}")
        with open(cur_tmp, "w") as fh:
            fh.write(unit)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(cur_tmp, os.path.join(self.path, _CURRENT))
        _fsync_dir(self.path)
        _crash_point("post_current")

    def _prune(self, keep: set[str]) -> None:
        """Drop every unit outside ``keep`` plus any legacy files — only
        reachable after the new head committed, so each deletion is safe
        at every crash point."""
        for unit in self._units():
            if unit not in keep:
                _crash_point(f"prune:{unit}")
                shutil.rmtree(os.path.join(self.path, unit),
                              ignore_errors=True)
        for legacy in (_MANIFEST, _LEAVES):
            p = os.path.join(self.path, legacy)
            if os.path.exists(p):
                _crash_point(f"prune:{legacy}")
                os.remove(p)
        old = self.path + ".old"
        if os.path.exists(old):
            _crash_point("prune:old")
            shutil.rmtree(old, ignore_errors=True)

    def save_base(self, state: Any, *, step: int = 0,
                  extra: dict | None = None) -> str:
        """Full snapshot as a new base unit; prunes the entire previous
        chain (and any legacy-layout files) after the commit — this IS
        the chain compaction: the in-memory state already equals
        base + deltas + dirty tail, so folding is a fresh full write.
        ``state`` is one state or a list of per-shard states."""
        os.makedirs(self.path, exist_ok=True)
        unit = self._next_unit("base")
        leaves = _host_leaves(state)
        tmp = tempfile.mkdtemp(dir=self.path, prefix=".unit_tmp_")
        try:
            np.savez(
                os.path.join(tmp, _LEAVES),
                **{f"leaf_{i}": x for i, x in enumerate(leaves)},
            )
            manifest = {
                "format": _FORMAT,
                "kind": "base",
                "unit": unit,
                "parent": None,
                "chain_len": 0,
                "n_leaves": len(leaves),
                "step": step,
                "extra": extra or {},
            }
            with open(os.path.join(tmp, _MANIFEST), "w") as fh:
                json.dump(manifest, fh)
            self._commit_unit(tmp, unit)
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        self._prune(keep={unit})
        return unit

    def save_delta(self, state: Any, *, n_shards: int = 1, step: int = 0,
                   extra: dict | None = None) -> str:
        """Delta unit: per shard, only the blocks marked dirty in its
        ``pool.dirty`` (payload + slot metadata) plus every non-block leaf
        in full.  Chained onto the current head; restore applies the chain
        oldest-first.  Requires an existing head (the first checkpoint of a
        durable root is always a base).  ``state`` is one state
        (``n_shards=1``) or a list of ``n_shards`` per-shard states.

        The dirty blocks are gathered where the state lives (on the card:
        ``blocks[dirty_idx]``) before the copy to the host, so only they
        cross it; the files are the JAX package's."""
        head = self._head()
        if head is None:
            raise SnapshotChainError(
                f"{self.path}: save_delta with no base snapshot to chain to"
            )
        shards = list(state) if isinstance(state, (list, tuple)) else [state]
        if len(shards) != n_shards:
            raise ValueError(f"save_delta of {len(shards)} states for {n_shards} shards")
        blk = _block_leaf_indices(shards[0])
        if blk is None:
            raise ValueError("save_delta needs a state with a block pool")
        head_m = self._unit_manifest(head)
        unit = self._next_unit("delta")
        n_leaves = len(tensor_leaves(shards[0]))
        if head_m["n_leaves"] != n_leaves:
            raise ValueError(
                f"delta over a {head_m['n_leaves']}-leaf chain, state has "
                f"{n_leaves} (mixed-format chain?)"
            )
        tmp = tempfile.mkdtemp(dir=self.path, prefix=".unit_tmp_")
        try:
            for s, st in enumerate(shards):
                leaves = list(tensor_leaves(st).values())
                idx = torch.nonzero(leaves[blk["dirty"]]).flatten()
                arrays: dict[str, np.ndarray] = {
                    "dirty_idx": idx.cpu().numpy().astype(np.int32),
                }
                for name, j in blk.items():
                    if name != "dirty":
                        arrays[f"blk_{name}"] = to_numpy(leaves[j][idx])
                for j, leaf in enumerate(leaves):
                    if j not in blk.values():
                        arrays[f"leaf_{j}"] = to_numpy(leaf)
                np.savez(os.path.join(tmp, f"shard_{s:03d}.npz"), **arrays)
            manifest = {
                "format": _FORMAT,
                "kind": "delta",
                "unit": unit,
                "parent": head,
                "chain_len": int(head_m.get("chain_len", 0)) + 1,
                "n_leaves": n_leaves,
                "n_shards": n_shards,
                "block_leaves": blk,
                "step": step,
                "extra": extra or {},
            }
            with open(os.path.join(tmp, _MANIFEST), "w") as fh:
                json.dump(manifest, fh)
            self._commit_unit(tmp, unit)
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        return unit

    # ------------------------------ read -------------------------------
    def _apply_delta(self, leaves: list[np.ndarray], unit: str,
                     manifest: dict) -> None:
        blk = manifest["block_leaves"]
        n_shards = int(manifest.get("n_shards", 1))
        blk_idx = set(blk.values())
        for s in range(n_shards):
            data = np.load(os.path.join(self.path, unit, f"shard_{s:03d}.npz"))
            idx = data["dirty_idx"]
            for name in blk:
                if name == "dirty":
                    continue
                tgt = leaves[blk[name]]
                if n_shards > 1:
                    tgt[s][idx] = data[f"blk_{name}"]
                else:
                    tgt[idx] = data[f"blk_{name}"]
            for j in range(len(leaves)):
                if j in blk_idx:
                    continue
                arr = data[f"leaf_{j}"]
                if n_shards > 1:
                    leaves[j][s] = arr
                else:
                    leaves[j] = arr

    def load_arrays(self, template: Any) -> tuple[list[np.ndarray], dict]:
        """Resolve the head, walk to its base, and fold the deltas in
        order, on the host: the leaves as numpy arrays in leaf order, and
        the head unit's manifest (whose ``extra`` stamps the WAL seqnos of
        the LAST checkpoint).  Falls back to the legacy full-snapshot
        layout."""
        head = self._head()
        if head is None:
            if self._legacy_exists():
                return load_snapshot_arrays(self.path, template)
            raise FileNotFoundError(f"{self.path}: no snapshot to load")
        chain = self._chain(head)
        base_m = self._unit_manifest(chain[0])
        data = np.load(os.path.join(self.path, chain[0], _LEAVES))
        # fold the chain in ITS OWN leaf coordinates (every unit of a
        # chain has the same n_leaves — save_delta enforces it), THEN
        # migrate: each delta's stamped block/dense leaf indices predate
        # any leaves the template has since grown.
        leaves = [np.array(data[f"leaf_{i}"])
                  for i in range(base_m["n_leaves"])]
        for unit in chain[1:]:
            self._apply_delta(leaves, unit, self._unit_manifest(unit))
        leaves = _migrate_leaves(leaves, template)
        dirty_at = _dirty_leaf_index(template)
        if dirty_at is not None:
            # post-restore the state is by definition in sync with the
            # chain head: nothing is dirty until the next update lands
            leaves[dirty_at] = np.zeros_like(leaves[dirty_at])
        return leaves, self._unit_manifest(head)

    def load(self, template: Any, *, device=None) -> tuple[Any, dict]:
        """:meth:`load_arrays`, filled into ``template``'s structure on
        ``device`` (default: the template's)."""
        leaves, manifest = self.load_arrays(template)
        return _assemble(template, leaves, device), manifest

    # --------------------------- accounting ----------------------------
    def unit_bytes(self, unit: str | None = None) -> int:
        """On-disk bytes of one unit (default: head) — the checkpoint-cost
        metric."""
        unit = unit or self._head()
        if unit is None:
            return 0
        d = os.path.join(self.path, unit)
        return sum(
            os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
        )
