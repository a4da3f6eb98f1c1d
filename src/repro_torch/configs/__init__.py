"""Architecture registry of the port.

``get_cells(arch)`` returns the (arch × shape) Cell list; ``all_cells()``
every cell, 46 in all, the reference's: the five LMs (granite-20b,
deepseek-7b, qwen1.5-110b, granite-moe-1b-a400m, phi3.5-moe-42b-a6.6b; 20
cells, five skipped), the GAT (gat-cora; 4), the four recsys families
(two-tower retrieval with its index-served ``retrieval_cand_ann``,
DeepFM, BERT4Rec, MIND; 17) and the paper's own spfresh-1b (5).  Exact
configs are in the per-arch modules.
"""
from __future__ import annotations

from repro_torch.configs.common import Cell

_ARCH_MODULES = [
    "granite_20b",
    "deepseek_7b",
    "qwen15_110b",
    "granite_moe_1b_a400m",
    "phi35_moe_42b_a6_6b",
    "gat_cora",
    "bert4rec",
    "mind",
    "two_tower_retrieval",
    "deepfm",
    "spfresh",
]

_CELLS: dict[str, list[Cell]] | None = None


def _load() -> dict[str, list[Cell]]:
    global _CELLS
    if _CELLS is None:
        import importlib

        cells_by_arch = {}
        for mod_name in _ARCH_MODULES:
            mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
            cells = mod.cells()
            assert cells, mod_name
            cells_by_arch[cells[0].arch] = cells
        _CELLS = cells_by_arch
    return _CELLS


def arch_names() -> list[str]:
    return list(_load().keys())


def get_cells(arch: str) -> list[Cell]:
    return _load()[arch]


def get_cell(arch: str, shape: str) -> Cell:
    for c in get_cells(arch):
        if c.shape == shape:
            return c
    raise KeyError(f"{arch}/{shape}")


def all_cells(include_skipped: bool = True) -> list[Cell]:
    out = []
    for cells in _load().values():
        for c in cells:
            if include_skipped or c.skip_reason is None:
                out.append(c)
    return out
