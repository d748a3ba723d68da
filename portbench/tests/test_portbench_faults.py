"""The comparison that decides ``correct`` fails what it must: the control
(the reference in bfloat16 in the program's place) and, with the timed
path broken underneath a whole run, a step or fit that leaves its state
unchanged, half of the batch left out, and a token or an answer altered
where it is produced."""
import pytest
import torch

from portbench import faults, harness
from portbench.tests.tiny import ROOT, make_root, run


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-serve"])
def test_the_control_is_not_correct(root, cell):
    files = harness.cell_files(root, harness.load_manifest(root), cell)
    driver = harness.make_driver(files, 21, torch.device("cpu"))
    driver.stand_in(torch.bfloat16)
    numbers = driver.check()
    assert any(numbers[k] > v for k, v in files["limits"].items()), numbers


@pytest.mark.parametrize("cell,like", [("tiny-train", "train-pubmed"),
                                       ("tiny-serve", "serve-pubmed")])
def test_the_tiny_cells_compare_what_the_real_cells_do(root, cell, like):
    tiny = harness.cell_files(root, harness.load_manifest(root), cell)
    real = harness.cell_files(ROOT, harness.load_manifest(ROOT), like)
    assert set(tiny["limits"]) == set(real["limits"])


@pytest.mark.parametrize("cell,kind", [
    ("tiny-train", "unchanged"), ("tiny-train", "half"),
    ("tiny-train", "token"), ("tiny-serve", "unchanged"),
    ("tiny-serve", "half"), ("tiny-serve", "answer")])
def test_a_planted_fault_is_not_correct(root, monkeypatch, cell, kind):
    files = harness.cell_files(root, harness.load_manifest(root), cell)
    module, attr, broken = faults.plant(
        files["mix"], "token" if kind == "answer" else kind)
    monkeypatch.setattr(module, attr, broken)
    result, checks = run(root, cell, seed=31)
    assert not result["correct"], checks
