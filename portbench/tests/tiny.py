"""A copy of the benchmark under a temporary root with tiny cells added by
new files and manifest entries alone: ``tiny-train`` and ``tiny-serve``
(K = 32, W = 300) on the real drivers, run on the CPU."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]

TINY = {"num_topics": 32, "vocab_size": 300, "minibatch_docs": 16,
        "bucket_len": 16, "active_topics": 4, "doc_tokens": [4, 24],
        "phi_tokens": 2e4, "phi_topics_per_word": 8, "max_sweeps": 12}
#: what the tiny cells' sound CPU runs are held to
TINY_LIMITS = {
    "tiny-train": {"rows_gap": 1e-3, "mass_gap": 1e-4, "phik_gap": 1e-4,
                   "ppl_gap": 1e-3, "stop_mismatch": 0, "steps_missing": 0},
    "tiny-serve": {"theta_gap": 1e-4, "stop_mismatch": 0,
                   "launches_missing": 0},
}


def make_root(tmp: Path) -> Path:
    """The benchmark copied to ``tmp`` with the tiny configuration, a
    tiny serving mix, their limits and two cells."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/lda-pubmed-k10k.json")
                     .read_text())
    cfg.update(TINY, name="tiny")
    (tmp / "portbench/configs/tiny.json").write_text(json.dumps(cfg))
    man["configs"].append({"name": "tiny", "source": "test",
                           "file": "portbench/configs/tiny.json",
                           "reduced": [], "why": "test"})
    mix = json.loads((ROOT / "portbench/traffic/serve-closed.json")
                     .read_text())
    mix.update(clients=12, max_batch=8, doc_pool=128, warmup_seconds=0.2,
               fit_sweeps=20, sampled_launches=2)
    (tmp / "portbench/traffic/tiny-serve.json").write_text(json.dumps(mix))
    for cell, traffic, like in (("tiny-train", "train-stream", "train-pubmed"),
                                ("tiny-serve", "tiny-serve", "serve-pubmed")):
        man["workloads"].append({"name": cell, "config": "tiny",
                                 "traffic": traffic, "chips": 1,
                                 "why": "test"})
        (tmp / f"portbench/limits/{cell}.json").write_text(
            json.dumps(TINY_LIMITS[cell]))
        for m in man["end_to_end"] + man["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp


def run(root: Path, cell: str, seed: int = 5, seconds: float = 0.4,
        trace: bool = False, driver=None):
    return harness.run_cell(root, cell, seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter(),
                            driver=driver)
