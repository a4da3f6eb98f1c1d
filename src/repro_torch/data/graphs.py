"""Graph data substrate (a numpy-only copy of the reference's): CSR
adjacency and the layer-wise fanout neighbour sampler the
``minibatch_lg`` cell requires (GraphSAGE-style, fanout 15-10).

The sampler produces FIXED-SHAPE padded subgraphs: for targets B and
fanouts (f1, f2, ...) it emits
    nodes   : B + B·f1 + B·f1·f2 + ...   node slots (-1 padded, w/ repeats)
    edges   : B·f1 + B·f1·f2 + ...       (src, dst) pairs into slot space
plus a self-loop on every live slot, so every batch has the same shapes.
Sampling-with-replacement repeats are kept (the standard GraphSAGE
estimator); padded slots carry -1 and are ignored by the GAT's segment
ops.  Every draw consumes the ``np.random.Generator`` exactly as the
reference's does: one seed gives both packages the same graph and the
same batches, array for array.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray    # (N+1,) int64
    indices: np.ndarray   # (E,) int32 neighbor ids
    features: np.ndarray  # (N, F) float32
    labels: np.ndarray    # (N,) int32

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @classmethod
    def random(cls, n_nodes: int, avg_degree: int, d_feat: int,
               n_classes: int, seed: int = 0,
               feature_signal: float = 0.5,
               homophily: float = 0.8) -> "CSRGraph":
        """Synthetic power-lawish graph for tests/examples.

        ``homophily`` = probability an edge stays within the node's class
        (real GNN benchmarks like Cora/Reddit are strongly homophilous —
        without it, message passing has nothing to aggregate).
        """
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, n_classes, size=n_nodes).astype(np.int32)
        by_class = [np.where(labels == c)[0] for c in range(n_classes)]
        deg = np.maximum(
            1, rng.zipf(1.7, size=n_nodes).clip(max=avg_degree * 8)
        )
        deg = (deg * (avg_degree / max(deg.mean(), 1e-9))).astype(np.int64).clip(1)
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        indices = np.empty(indptr[-1], np.int32)
        for v in range(n_nodes):
            d = deg[v]
            same = rng.random(d) < homophily
            pool = by_class[labels[v]]
            nbrs = np.where(
                same & (len(pool) > 0),
                rng.choice(pool, size=d) if len(pool) else 0,
                rng.integers(0, n_nodes, size=d),
            )
            indices[indptr[v]:indptr[v + 1]] = nbrs
        feats = (rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
                 + labels[:, None] * feature_signal)
        return cls(indptr=indptr, indices=indices, features=feats,
                   labels=labels)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


def sample_subgraph(
    graph: CSRGraph,
    targets: np.ndarray,
    fanouts: tuple[int, ...],
    rng: np.random.Generator,
) -> dict:
    """Layer-wise fanout sampling → fixed-shape padded batch for GAT.

    Node slot layout: [targets | layer-1 samples | layer-2 samples | ...].
    Edges point sampled-neighbor-slot → parent-slot (message flow toward
    the targets) plus per-slot self-loops.  Labels only on target slots
    (-1 elsewhere).
    """
    b = len(targets)
    frontier = np.asarray(targets, np.int64)
    slot_of_frontier = np.arange(b)
    node_ids = [frontier]
    edge_src, edge_dst = [], []
    next_slot = b

    for fanout in fanouts:
        n_par = len(frontier)
        sampled = np.full((n_par, fanout), -1, np.int64)
        for i, v in enumerate(frontier):
            if v < 0:
                continue
            nbrs = graph.neighbors(int(v))
            if len(nbrs) == 0:
                continue
            sampled[i] = rng.choice(nbrs, size=fanout, replace=True)
        slots = next_slot + np.arange(n_par * fanout)
        next_slot += n_par * fanout
        src = slots
        dst = np.repeat(slot_of_frontier, fanout)
        valid = sampled.reshape(-1) >= 0
        edge_src.append(np.where(valid, src, -1))
        edge_dst.append(np.where(valid, dst, -1))
        frontier = sampled.reshape(-1)
        slot_of_frontier = slots
        node_ids.append(frontier)

    all_ids = np.concatenate(node_ids)
    # self-loops on every slot (standard GAT practice — without them a
    # node's own features never reach its own output)
    slots = np.arange(len(all_ids))
    self_valid = all_ids >= 0
    edge_src.append(np.where(self_valid, slots, -1))
    edge_dst.append(np.where(self_valid, slots, -1))
    safe = np.maximum(all_ids, 0)
    features = graph.features[safe]
    features[all_ids < 0] = 0.0
    labels = np.full(len(all_ids), -1, np.int32)
    labels[:b] = graph.labels[targets]
    return {
        "features": features.astype(np.float32),
        "edge_src": np.concatenate(edge_src).astype(np.int32),
        "edge_dst": np.concatenate(edge_dst).astype(np.int32),
        "labels": labels,
        "node_ids": all_ids,
    }


def minibatch_stream(
    graph: CSRGraph, batch_nodes: int, fanouts: tuple[int, ...],
    seed: int = 0,
):
    """Infinite deterministic sampler stream (step -> batch)."""

    def batch_fn(step: int) -> dict:
        rng = np.random.default_rng(seed + step)
        targets = rng.choice(graph.n_nodes, size=batch_nodes, replace=False)
        return sample_subgraph(graph, targets, fanouts, rng)

    return batch_fn
