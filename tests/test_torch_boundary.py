"""The port's boundary: it imports no JAX and nothing of the reference, and
its entry points run on the card unless the caller asks for the CPU."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
# the port, the chip smoke and the scripts run on the card (which has no JAX)
PORT_FILES = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
              + sorted((REPO / "scripts").glob("*_on_card.py")))


def _imported_modules(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout


def _tiny_cfg():
    from repro_torch.core.types import LireConfig

    return LireConfig(dim=8, block_size=4, max_blocks_per_posting=4,
                      num_blocks=64, num_postings_cap=32, num_vectors_cap=256,
                      split_limit=12, merge_limit=3, replica_count=2, nprobe=2)


def test_the_boundary_covers_the_serving_layer_and_grouping():
    names = {str(p.relative_to(PORT)) for p in PORT_FILES if PORT in p.parents}
    for mod in ("serve/__init__.py", "serve/engine.py", "serve/queue.py", "serve/policy.py",
                "serve/ownership.py", "storage/durability.py", "core/grouping.py",
                "serve/retrieval.py", "models/recsys.py", "models/layers.py",
                "configs/two_tower_retrieval.py", "configs/common.py", "configs/deepfm.py",
                "configs/bert4rec.py", "configs/mind.py", "train/optimizer.py",
                "train/trainer.py", "train/checkpoint.py", "launch/train.py",
                "models/transformer.py", "configs/deepseek_7b.py", "configs/granite_20b.py",
                "configs/granite_moe_1b_a400m.py", "configs/phi35_moe_42b_a6_6b.py",
                "configs/qwen15_110b.py"):
        assert mod in names, mod


@pytest.mark.parametrize("entry", ["SPFreshIndex.build", "build_state", "make_empty_state",
                                   "group_index_from_numpy", "twotower_init",
                                   "twotower_init_counter", "twotower_params_from_numpy",
                                   "IndexedRetriever", "deepfm_init", "bert4rec_init",
                                   "mind_init", "mind_params_from_numpy", "make_smoke_inputs",
                                   "Trainer", "adamw_state_from_numpy", "lm_init_params",
                                   "lm_params_from_numpy", "init_cache"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device=`` an entry point runs on CUDA; on a machine with
    no card it raises rather than falling back to the CPU."""
    from repro_torch.core.index import SPFreshIndex, build_state
    from repro_torch.core.types import make_empty_state

    cfg = _tiny_cfg()
    x = np.random.default_rng(0).normal(size=(40, 8)).astype(np.float32)
    from repro_torch.convert import group_index_from_numpy

    leaves = {"group_centroids": np.zeros((2, 8), np.float32),
              "group_sqn": np.zeros(2, np.float32), "members": np.zeros((2, 4), np.int32),
              "member_valid": np.ones((2, 4), bool)}
    from repro_torch import convert
    from repro_torch.configs.two_tower_retrieval import SMOKE
    from repro_torch.models import recsys
    from repro_torch.configs import get_cell
    from repro_torch.configs.bert4rec import SMOKE as B4
    from repro_torch.configs.deepfm import SMOKE as DF
    from repro_torch.configs.mind import SMOKE as MI
    from repro_torch.serve.retrieval import IndexedRetriever
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import Trainer, TrainerConfig

    from repro_torch.configs.granite_moe_1b_a400m import SMOKE as LM
    from repro_torch.models import transformer

    mind_cpu = recsys.mind_init(torch.Generator().manual_seed(0), MI, device="cpu")
    lm_cpu = transformer.init_params(torch.Generator().manual_seed(0), LM, device="cpu")
    tower = recsys.twotower_init(torch.Generator().manual_seed(0), SMOKE, device="cpu")
    icfg = dataclasses.replace(cfg, dim=SMOKE.tower_dims[-1])
    call = {
        "SPFreshIndex.build": lambda: SPFreshIndex.build(cfg, x).state,
        "twotower_init": lambda: recsys.twotower_init(torch.Generator(), SMOKE).item_embed,
        "twotower_init_counter": lambda: recsys.twotower_init_counter(0, SMOKE).item_embed,
        "twotower_params_from_numpy": lambda: convert.twotower_params_from_numpy(
            convert.twotower_params_to_numpy(tower), SMOKE).item_embed,
        "IndexedRetriever": lambda: IndexedRetriever(tower, SMOKE, icfg).params.item_embed,
        "build_state": lambda: build_state(cfg, x),
        "make_empty_state": lambda: make_empty_state(cfg),
        "group_index_from_numpy": lambda: group_index_from_numpy(leaves).members,
        "deepfm_init": lambda: recsys.deepfm_init(torch.Generator(), DF).embed,
        "bert4rec_init": lambda: recsys.bert4rec_init(torch.Generator(), B4).item_embed,
        "mind_init": lambda: recsys.mind_init(torch.Generator(), MI).item_embed,
        "mind_params_from_numpy": lambda: convert.mind_params_from_numpy(
            convert.params_to_numpy(mind_cpu), MI).item_embed,
        "make_smoke_inputs": lambda: get_cell("deepfm", "train_batch").make_smoke_inputs(
            DF, np.random.default_rng(0))[2]["fields"],
        "Trainer": lambda: Trainer(loss_fn=None, init_params_fn=None, batch_fn=None,
                                   opt_cfg=AdamWConfig(), trainer_cfg=TrainerConfig()),
        "adamw_state_from_numpy": lambda: convert.adamw_state_from_numpy(
            convert.adamw_state_to_numpy(adamw_init(mind_cpu), mind_cpu), mind_cpu)["count"],
        "lm_init_params": lambda: transformer.init_params(torch.Generator(), LM).embed,
        "lm_params_from_numpy": lambda: convert.lm_params_from_numpy(
            convert.lm_params_to_numpy(lm_cpu), LM).embed,
        "init_cache": lambda: transformer.init_cache(LM, 1, 4)["k"],
    }[entry]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_explicit_cpu_runs_the_plain_path():
    from repro_torch.core.index import SPFreshIndex

    x = np.random.default_rng(1).normal(size=(40, 8)).astype(np.float32)
    idx = SPFreshIndex.build(_tiny_cfg(), x, device="cpu")
    assert idx.state.device.type == "cpu"
    _, v = idx.search(x[:3], 2)
    assert v.shape == (3, 2)


def test_spflint_still_clean_with_the_port_in_src():
    """spflint parses all of src/; the port adds no finding and no
    pallas_call site (its kernels are CUDA C++)."""
    from repro.analysis import run_all

    result = run_all(REPO / "src")
    assert [f.render() for f in result["findings"]] == []
    assert len(result["vmem_table"]) == 7            # the reference's seven
    assert not any("repro_torch" in r["file"] for r in result["vmem_table"])
