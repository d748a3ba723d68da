"""The manifest and the files it names: every cell resolves its
configuration, mix, driver, limits and metric readers by name, a new cell
is picked up from new files and entries alone, and the manifest keeps the
benchmark contract's shape."""
import json
import re
import shutil

import pytest

from portbench import harness
from portbench.tests.tiny import ROOT, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files_by_name(cell):
    files = harness.cell_files(ROOT, MANIFEST, cell)
    assert files["cfg"]["name"] == files["cell"]["config"]
    assert (ROOT / "portbench/drivers" / f"{files['mix']['driver']}.py").is_file()
    names = {m["name"] for m in files["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert files["per_layer"], "every cell reports a per-layer metric"
    for m in files["per_layer"]:
        assert m["moves"] in names, "a cell reports what its metrics move"


def test_manifest_shape():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["portbench"] and 1 <= m["run_seconds"] <= 51
    metric_names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    for name in metric_names + CELLS + [c["name"] for c in m["configs"]]:
        assert NAME.match(name), name
    assert len(set(metric_names)) == len(metric_names)
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in (
            "host_clock", "device_trace")
    layers = {}
    for x in m["per_layer"]:
        assert x["moves"] in e2e and "bound" not in x
        for cell in x["workloads"]:
            assert cell in e2e[x["moves"]].get("workloads", CELLS)
        if x["name"].endswith("_roofline") or "mfu" in x["name"]:
            assert x["unit"] == "%"
        layers.setdefault(x["layer"], set()).add(x["name"])
    for w in m["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "portbench/limits" / f"{w['name']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]


def test_a_new_cell_comes_from_new_files_alone(tmp_path):
    root = make_root(tmp_path)
    shutil.copy(root / "portbench/metrics/serve.fill.py",
                root / "portbench/metrics/serve.fill_copy.py")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "serve.fill_copy", "unit": "%",
                             "better": "higher", "source": "program_counter",
                             "layer": "launch/serve.py AdmissionRouter",
                             "moves": "serve_docs_per_s",
                             "workloads": ["tiny-serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    files = harness.cell_files(root, harness.load_manifest(root),
                               "tiny-serve")
    assert files["cfg"]["num_topics"] == 32
    assert files["mix"]["clients"] == 12
    assert "serve.fill_copy" in {m["name"] for m in files["per_layer"]}
    rec = {"kind": "serve", "launches": [{"filled": 3, "capacity": 4}]}
    assert harness.read_metric(root, "serve.fill_copy", rec) == 75.0


def test_a_missing_file_is_refused(tmp_path):
    root = make_root(tmp_path)
    (root / "portbench/limits/tiny-train.json").unlink()
    with pytest.raises(harness.ManifestError):
        harness.cell_files(root, harness.load_manifest(root), "tiny-train")
    with pytest.raises(harness.ManifestError):
        harness.cell_files(root, harness.load_manifest(root), "no-such")
