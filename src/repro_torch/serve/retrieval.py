"""Two-tower retrieval served by the SPFresh index — the paper's technique
as a feature of the framework.

The item corpus lives in a ``SPFreshIndex`` built over the item tower's
embeddings; ``retrieve`` runs the user tower and answers top-k by ANN
search instead of the brute-force GEMM over every candidate.  Catalog
churn (new and removed items) goes through LIRE insert and delete, with
no rebuild.  The towers run on ``device`` (the card unless the caller asks
for the CPU); only what the index's host API takes (numpy) is copied to
the host.

``attach_engine`` puts the serving pipeline in front of the index:
lookups and churn then flow through the micro-batched ``ServeEngine``, and
its ``MaintenancePolicy`` schedules the background rebuilder in place of
the fixed ``maintain(32)`` after each churn batch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distance import stable_topk
from repro_torch.core.index import SPFreshIndex
from repro_torch.core.types import LireConfig, resolve_device
from repro_torch.models.recsys import TwoTower, TwoTowerConfig

# scores held at once by the brute-force top-k, in values
_BRUTE_FORCE_CHUNK = 1 << 26


class IndexedRetriever:
    """``params`` (a ``TwoTower``) is moved to ``device`` in place, as
    ``nn.Module.to`` moves a module."""

    def __init__(self, params: TwoTower, model_cfg: TwoTowerConfig, index_cfg: LireConfig,
                 *, device="cuda"):
        assert index_cfg.dim == model_cfg.tower_dims[-1]
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.model_cfg = model_cfg
        self.index_cfg = index_cfg
        self.index: SPFreshIndex | None = None
        self.engine = None

    # ------------------------------------------------------------------
    def attach_engine(self, cfg=None, policy=None):
        """Serve this corpus through the batched pipeline; returns the
        ``ServeEngine`` (also kept on ``self``).  ``cfg`` is an
        ``EngineConfig`` or a ``repro_torch.api.ServiceSpec``, whose
        serve, scan and maintenance parts compile to the engine config."""
        from repro_torch.api.spec import ServiceSpec
        from repro_torch.serve.engine import EngineConfig, ServeEngine

        assert self.index is not None, "build_corpus first"
        if isinstance(cfg, ServiceSpec):
            cfg = cfg.engine_config()
        self.engine = ServeEngine(self.index, cfg or EngineConfig(), policy=policy)
        return self.engine

    # ------------------------------------------------------------------
    def build_corpus(self, item_ids: np.ndarray, batch: int = 4096) -> None:
        embs = self.embed_items(item_ids, batch)
        self.index = SPFreshIndex.build(self.index_cfg, embs, device=self.device)
        self._id_map = np.asarray(item_ids)

    @torch.no_grad()
    def _embed(self, item_ids, batch: int = 4096) -> torch.Tensor:
        """Item embeddings ``(N, D)`` f32 on the device, ``batch`` items a
        tower call (no graph: the towers serve here)."""
        ids = torch.as_tensor(np.asarray(item_ids)).to(self.device)
        return torch.cat([self.params.item_tower(ids[s:s + batch]).float()
                          for s in range(0, ids.shape[0], batch)])

    def embed_items(self, item_ids: np.ndarray, batch: int = 4096) -> np.ndarray:
        return self._embed(item_ids, batch).cpu().numpy()

    @torch.no_grad()
    def _users(self, user_fields) -> torch.Tensor:
        return self.params.user_tower(torch.as_tensor(np.asarray(user_fields))).float()

    # ------------------------------------------------------------------
    def add_items(self, item_ids: np.ndarray) -> None:
        """Catalog churn: embed fresh items and LIRE-insert them; an item's
        vid is its position in the id map."""
        embs = self.embed_items(item_ids)
        base = len(self._id_map)
        vids = np.arange(base, base + len(item_ids)).astype(np.int32)
        self._id_map = np.concatenate([self._id_map, np.asarray(item_ids)])
        if self.engine is not None:
            self.engine.insert(embs, vids)
        else:
            self.index.insert(embs, vids)
            self.index.maintain(max_steps=32)

    def remove_items(self, vids: np.ndarray) -> None:
        vids = np.asarray(vids, np.int32)
        if self.engine is not None:
            self.engine.delete(vids)
        else:
            self.index.delete(vids)

    # ------------------------------------------------------------------
    def retrieve(self, user_fields: np.ndarray, k: int = 10,
                 nprobe: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """``(scores, item_ids)``: the ANN path of ``retrieval_cand``.  An
        empty slot gives id -1 and score ``-inf``."""
        u = self._users(user_fields).cpu().numpy()
        if self.engine is not None:
            d, v = self.engine.search(u, k=k, nprobe=nprobe)
        else:
            d, v = self.index.search(u, k, nprobe=nprobe)
        safe = np.maximum(v, 0)
        ids = np.where(v >= 0, self._id_map[safe], -1)
        # squared L2 on unit vectors: dot = 1 - d/2
        scores = np.where(v >= 0, 1.0 - d / 2.0, -np.inf)
        return scores, ids

    def retrieve_bruteforce(self, user_fields: np.ndarray, k: int = 10
                            ) -> tuple[np.ndarray, np.ndarray]:
        """The exact GEMM over the whole id map (removed items included),
        re-embedded, for recall accounting: a lowest-index-first top-k of
        ``u @ embs.T``, taken chunk by chunk of the corpus."""
        u = self._users(user_fields)
        embs = self._embed(self._id_map)
        chunk = max(k, _BRUTE_FORCE_CHUNK // max(u.shape[0], 1))
        best_s = best_i = None
        for s in range(0, embs.shape[0], chunk):
            vals, idx = stable_topk(u @ embs[s:s + chunk].T, k, largest=True)
            idx = idx + s
            if best_s is not None:        # earlier chunks first: ties keep the lower index
                vals, sel = stable_topk(torch.cat([best_s, vals], 1), k, largest=True)
                idx = torch.gather(torch.cat([best_i, idx], 1), 1, sel)
            best_s, best_i = vals, idx
        return best_s.cpu().numpy(), self._id_map[best_i.cpu().numpy()]
