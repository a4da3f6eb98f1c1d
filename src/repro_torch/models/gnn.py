"""Graph attention network (GAT, arXiv:1710.10903) with segment-op message
passing (the reference's ``models/gnn.py``), on PyTorch.

Message passing runs over an explicit edge index: edge softmax = per-edge
scores (SDDMM) → a per-destination segment softmax → a weighted sum of the
source features into each destination (SpMM).  It serves the four shape
cells: a full graph (cora, ogb_products: one big edge list), a sampled
minibatch (the fanout sampler of ``repro_torch.data.graphs``) and batched
small graphs (molecule: block-diagonal edges and a per-graph mean readout
by ``graph_ids``).

The arithmetic is the reference's, line by line: ``-1`` edges clamped to
node 0 and masked; the leaky ReLU cast to f32 and an invalid logit
``-1e30``; the segment max, a non-finite max (a node with no incoming
edge) replaced by 0; ``exp`` masked to 0; the division by
``max(denom, 1e-16)``; the message ``h[src].float() * w`` summed per
destination and cast back to ``x``'s dtype; heads concatenated, or
averaged on the node head; ELU between layers.

No segment reduction is a float atomic, forward or backward, so the card
gives the same bits on every run.  :func:`edge_index` orders a batch's
edge indices by destination once (a stable sort): the per-edge tensors
come out in segment order and ``torch.segment_reduce`` adds each
segment's edges in edge order.  A gather's backward (the sum of every
edge's gradient into its node) is a ``segment_reduce`` too, over the
edges in source order.  The weighted sum :func:`aggregate` keeps only
``h`` and the edge weights for its backward: the ``(E, H, D)`` message
(15.8 GB in ogb_products' first layer) is made once in the forward and
once in the backward, never kept.

The parameters are one ``GAT`` (a ``layers.ParamTree``) under the
reference's tree names: ``{"layers": [{"w" (d_in, H·D), "a_src", "a_dst"
(H, D)}, …], "head" (d, C)?}``, each ``w`` in ``dense_init``'s
orientation.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.recsys import torch_dtype


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat"
    d_in: int = 1433
    d_hidden: int = 8
    n_heads: int = 8
    n_layers: int = 2
    n_classes: int = 7
    negative_slope: float = 0.2
    dtype: str = "float32"
    readout: str = "none"  # "mean" for graph-level tasks (molecule cell)
    n_graphs: int = 0      # static graph count for batched-small-graph cells


class GAT(L.ParamTree):
    """``{"layers": [{"w", "a_src", "a_dst"}, …], "head"?}``."""

    def __init__(self, cfg: GATConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg


def _layer_shape(cfg: GATConfig, i: int) -> tuple[int, int, bool]:
    """``(heads, d_out, node_head)`` of layer ``i``: the last layer of a
    node task is one head of ``n_classes``."""
    node_head = i == cfg.n_layers - 1 and cfg.readout == "none"
    return (1, cfg.n_classes, True) if node_head else (cfg.n_heads, cfg.d_hidden, False)


def init_params(gen: torch.Generator | None, cfg: GATConfig, *, device="cuda") -> GAT:
    """The GAT's parameters on ``device``, drawn from ``gen`` layer by layer
    (``w`` from ``dense_init``, then ``a_src`` and ``a_dst`` normal × 0.1
    in f32), then the readout head.  ``gen=None`` on the ``meta`` device
    gives the shapes alone (:func:`param_specs`)."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)

    def attn(heads, d_out):
        return (torch.randn((heads, d_out), generator=gen, device=dev) * 0.1).to(dt)

    layers = []
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        heads, d_out, node_head = _layer_shape(cfg, i)
        w = L.dense_init(gen, d_in, heads * d_out, dt, device=dev)
        layers.append({"w": w, "a_src": attn(heads, d_out), "a_dst": attn(heads, d_out)})
        d_in = d_out if node_head else heads * d_out
    tree = {"layers": layers}
    if cfg.readout != "none":
        tree["head"] = L.dense_init(gen, d_in, cfg.n_classes, dt, device=dev)
    return GAT(cfg, tree)


def param_specs(cfg: GATConfig) -> GAT:
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    allocation."""
    return init_params(None, cfg, device="meta")


# ---------------------------------------------------------------------------
# The edge index and its deterministic segment ops
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EdgeIndex:
    """A batch's edges in destination order (a stable sort of the input's
    order): ``src``, ``dst`` (int64, ``-1`` clamped to node 0), ``valid``
    (both ends ``>= 0``), ``by_dst`` (each node's count of incoming edges,
    the segment lengths), ``src_order`` (the stable order of ``src``) and
    ``by_src`` (each node's count of outgoing edges)."""

    src: torch.Tensor
    dst: torch.Tensor
    valid: torch.Tensor
    by_dst: torch.Tensor
    src_order: torch.Tensor
    by_src: torch.Tensor


def edge_index(edge_src, edge_dst, n: int) -> EdgeIndex:
    """The :class:`EdgeIndex` of ``(edge_src, edge_dst)`` over ``n`` nodes:
    two stable sorts and two counts, nothing read back to the host."""
    es, ed = torch.as_tensor(edge_src).long(), torch.as_tensor(edge_dst).long()
    valid = (es >= 0) & (ed >= 0)
    order = torch.sort(ed.clamp_min(0), stable=True).indices
    src, dst = es.clamp_min(0)[order], ed.clamp_min(0)[order]
    return EdgeIndex(src=src, dst=dst, valid=valid[order],
                     by_dst=torch.bincount(dst, minlength=n),
                     src_order=torch.sort(src, stable=True).indices,
                     by_src=torch.bincount(src, minlength=n))


def _segment_sum(t: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    return torch.segment_reduce(t, "sum", lengths=lengths, unsafe=True)


class _Gather(torch.autograd.Function):
    """``table[idx]``, whose backward sums each row's gradients by
    ``segment_reduce`` over the edges in ``order`` (``None``: ``idx`` is
    sorted) with ``lengths`` edges a row."""

    @staticmethod
    def forward(ctx, table, idx, order, lengths):
        ctx.save_for_backward(order, lengths)
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        order, lengths = ctx.saved_tensors
        g = g if order is None else g[order]
        return _segment_sum(g, lengths), None, None, None


def gather_src(t: torch.Tensor, ei: EdgeIndex) -> torch.Tensor:
    """``t[src]`` over the edges."""
    return _Gather.apply(t, ei.src, ei.src_order, ei.by_src)


def gather_dst(t: torch.Tensor, ei: EdgeIndex) -> torch.Tensor:
    """``t[dst]`` over the edges."""
    return _Gather.apply(t, ei.dst, None, ei.by_dst)


class _Aggregate(torch.autograd.Function):
    """``out[v] = Σ_{e → v} h[src_e] * w_e[..., None]`` over the edges into
    each node, in ``w``'s dtype (f32 in the GAT: ``h[src].float() * w``).
    The backward recomputes the gathered ``h`` rather than keep it."""

    @staticmethod
    def forward(ctx, h, w, src, dst, by_dst, src_order, by_src):
        msg = h[src].to(w.dtype)
        msg.mul_(w[..., None])
        ctx.save_for_backward(h, w, src, dst, src_order, by_src)
        return _segment_sum(msg, by_dst)

    @staticmethod
    def backward(ctx, g):
        h, w, src, dst, src_order, by_src = ctx.saved_tensors
        ge = g[dst]                                        # (E, H, D)
        gw = None
        if ctx.needs_input_grad[1]:
            t = h[src].to(w.dtype)
            gw = t.mul_(ge).sum(dim=-1)
            del t
        gh = None
        if ctx.needs_input_grad[0]:
            ge.mul_(w[..., None])
            gh = _segment_sum(ge[src_order], by_src).to(h.dtype)
        return gh, gw, None, None, None, None, None


def aggregate(h: torch.Tensor, w: torch.Tensor, ei: EdgeIndex) -> torch.Tensor:
    """The weighted sum of the source rows of ``h (N, H, D)`` into each
    destination, edge weights ``w (E, H)``: ``(N, H, D)`` in ``w``'s
    dtype."""
    return _Aggregate.apply(h, w, ei.src, ei.dst, ei.by_dst, ei.src_order, ei.by_src)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def gat_layer(lp, x: torch.Tensor, edge_src, edge_dst, *, heads: int, d_out: int,
              negative_slope: float, concat: bool, edges: EdgeIndex | None = None
              ) -> torch.Tensor:
    """One GAT layer over ``x (N, d_in)``: ``(N, heads·d_out)`` if
    ``concat``, else the mean over the heads ``(N, d_out)``.  ``edges`` is
    the batch's :func:`edge_index`, made here when not given."""
    n = x.shape[0]
    ei = edges if edges is not None else edge_index(edge_src, edge_dst, n)
    h = (x @ lp["w"]).reshape(n, heads, d_out)                      # (N, H, D)
    valid = ei.valid[:, None]

    # SDDMM: per-edge unnormalised attention logits
    alpha_src = torch.sum(h * lp["a_src"][None], dim=-1)           # (N, H)
    alpha_dst = torch.sum(h * lp["a_dst"][None], dim=-1)
    e = gather_src(alpha_src, ei) + gather_dst(alpha_dst, ei)       # (E, H)
    e = torch.nn.functional.leaky_relu(e, negative_slope).float()
    e = torch.where(valid, e, -1e30)

    # segment softmax over the incoming edges of each destination
    e_max = torch.segment_reduce(e, "max", lengths=ei.by_dst, unsafe=True)   # (N, H)
    e_max = torch.where(torch.isfinite(e_max), e_max, 0.0)
    p = torch.exp(e - gather_dst(e_max, ei))
    p = torch.where(valid, p, 0.0)
    denom = _segment_sum(p, ei.by_dst)                              # (N, H)
    w = p / torch.clamp_min(gather_dst(denom, ei), 1e-16)           # (E, H)

    # SpMM: the weighted sum of the source features into each destination
    out = aggregate(h, w, ei).to(x.dtype)                           # (N, H, D)
    return out.reshape(n, heads * d_out) if concat else torch.mean(out, dim=1)


def forward(params, batch: dict, cfg: GATConfig) -> torch.Tensor:
    """Node logits ``(N, C)``, or graph logits ``(G, C)`` when ``readout``
    is not ``none``."""
    x = batch["features"]
    ei = edge_index(batch["edge_src"], batch["edge_dst"], x.shape[0])
    for i, lp in enumerate(params["layers"]):
        heads, d_out, node_head = _layer_shape(cfg, i)
        x = gat_layer(lp, x, None, None, heads=heads, d_out=d_out,
                      negative_slope=cfg.negative_slope, concat=not node_head, edges=ei)
        if i < cfg.n_layers - 1:
            x = torch.nn.functional.elu(x)
    if cfg.readout == "none":
        return x
    # graph level: the mean readout by graph id, then the classifier
    gid = torch.as_tensor(batch["graph_ids"], device=x.device)
    summed, counts = L.segment_sum(x, gid, cfg.n_graphs)
    pooled = summed / torch.clamp_min(counts.to(x.dtype), 1.0)[:, None]
    return pooled @ params["head"]


def loss_fn(params, batch: dict, cfg: GATConfig):
    """Masked cross entropy over the labelled nodes (or graphs): ``(ce,
    {"ce", "acc"})``."""
    logits = forward(params, batch, cfg).float()
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    mask = (labels >= 0).float()
    safe = torch.clamp_min(labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[:, None])[:, 0]
    n = torch.clamp_min(torch.sum(mask), 1.0)
    ce = torch.sum((logz - gold) * mask) / n
    acc = torch.sum((torch.argmax(logits, dim=-1) == labels).float() * mask) / n
    return ce, {"ce": ce, "acc": acc}
