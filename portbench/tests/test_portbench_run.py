"""A run end to end on the CPU (the harness's look for a card skipped),
the result line's keys, the refusal without a card, and the import rule:
nothing under portbench imports JAX or the JAX package, and the reference
imports nothing of the program."""
import ast
import json
import os
import subprocess
import sys

import pytest

from portbench.tests.tiny import ROOT, make_root, run

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,metric", [("tiny-train", "train_tokens_per_s"),
                                         ("tiny-serve", "serve_docs_per_s")])
def test_a_clean_run_is_correct(root, cell, metric):
    result, checks = run(root, cell)
    assert set(result) - {"info"} == KEYS
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) >= {"setup_s", metric}
    assert all(v <= lim for v, lim in checks.values())


def test_without_a_card_run_py_refuses():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench/run.py"), "--workload",
         "train-pubmed", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA" in proc.stderr


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in (ROOT / "portbench").rglob(
                                            "*.py")))
def test_no_jax_and_no_jax_package(path):
    tops = {name.split(".")[0] for name in imports_of(ROOT / path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
    if path.startswith("portbench/reference/"):
        assert not tops & {"repro_torch"}, path


def test_the_result_line_is_json_with_checks_last(root):
    result, checks = run(root, "tiny-train", seed=9)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    line = json.dumps(result)
    assert list(json.loads(line))[-1] == "checks"
