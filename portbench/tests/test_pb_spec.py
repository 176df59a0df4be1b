"""Everything is found by name, and a cell added by files alone is found."""

import json
import os
import shutil

import pytest

from portbench import spec


def test_every_file_loads_by_name():
    bench = spec.benchmark()
    for c in bench["configs"]:
        cfg = spec.config(c["name"])
        assert os.path.relpath(os.path.join(spec.PKG, "configs", c["name"]
                                            + ".json"), spec.ROOT) == c["file"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["driver"] in ("train", "predict")
        spec.driver(cell["driver"]).Session
        assert "setup_s" in cell["end_to_end"] and len(cell["end_to_end"]) > 1
        assert cell["per_layer"]
        numbers = ({"loss_gap", "logit_gap", "logit_gap_pooled", "norm_gap",
                    "grad_gap", "change_gap"} if cell["driver"] == "train"
                   else {"prob_gap", "logit_gap_rms"})
        assert cell["limits"] and set(cell["limits"]) <= numbers
    for m in bench["per_layer"]:
        assert spec.metric_reader(m["name"])({}) is None


def test_a_cell_added_in_a_copy_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = spec.benchmark()
    bench["workloads"].append({"name": "train_2c_copy", "config": "2c_copy",
                               "traffic": "fold_training", "chips": 1,
                               "why": "a copy"})
    bench["configs"].append({"name": "2c_copy", "source": "x",
                             "file": "portbench/configs/2c_copy.json",
                             "reduced": [], "why": "a copy"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = spec.config("2c_flagship")
    cfg["name"] = "2c_copy"
    (root / "portbench/configs/2c_copy.json").write_text(json.dumps(cfg))
    (root / "portbench/workloads/train_2c_copy.json").write_text(json.dumps(
        {"config": "2c_copy", "traffic": "fold_training",
         "limits": {"loss_gap": 1.0}}))
    cell = spec.cell("train_2c_copy", root=str(root),
                     pkg=str(root / "portbench"))
    assert cell["config"]["name"] == "2c_copy"
    assert cell["driver"] == "train" and cell["limits"] == {"loss_gap": 1.0}
    with pytest.raises(KeyError):
        spec.cell("no_such_cell", root=str(root), pkg=str(root / "portbench"))
