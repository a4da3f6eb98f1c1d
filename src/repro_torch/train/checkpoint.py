"""Training checkpoint store: atomic snapshots of ``(params, opt_state)``
and the step, with retention, over the port's legacy snapshot
(``storage/snapshot.py``).

The leaves are stored as the reference's store stores them: positionally,
in ``jax.tree_util`` order over ``(params, opt_state)`` (the parameters,
then ``count``, ``m``, ``v``), each dense ``w`` as ``(in, out)`` and
bfloat16 as ``|V2`` (``convert.train_state_leaves``).  A checkpoint that
either package writes restores in the other.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any

from repro_torch.convert import fill_train_state_, train_state_leaves
from repro_torch.storage.snapshot import load_snapshot_arrays, save_snapshot, snapshot_exists

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointStore:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and snapshot_exists(os.path.join(self.root, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step: int, state: tuple[Any, dict], extra: dict | None = None) -> None:
        """Commit ``state = (params, opt_state)`` as ``step_<step>``, then
        drop all but the newest ``keep`` checkpoints."""
        leaves = [(t.T if tr else t).contiguous() for t, tr in train_state_leaves(*state)]
        save_snapshot(self._path(step), leaves, step=step, extra=extra)
        for old in self.steps()[: -self.keep]:
            shutil.rmtree(self._path(old), ignore_errors=True)

    def restore_latest(self, template: tuple[Any, dict]) -> tuple[Any, int, dict] | None:
        """The newest checkpoint copied into ``template = (params,
        opt_state)``'s tensors in place: ``(template, step, extra)``, or
        None where there is none."""
        steps = self.steps()
        if not steps:
            return None
        leaves = [t for t, _ in train_state_leaves(*template)]
        arrays, manifest = load_snapshot_arrays(self._path(steps[-1]), leaves)
        fill_train_state_(*template, arrays)
        return template, manifest["step"], manifest.get("extra", {})
