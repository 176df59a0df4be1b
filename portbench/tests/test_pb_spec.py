"""Everything is found by name, and a cell added by files alone is found;
so is a model kind, whose cell then runs."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import spec
from tiny import tiny_config

# A toy kind: the 2A text model with CLS pooling (no pooler weights), its
# reference the encoder's first token through the output Linear.
TOY_KIND = '''"""A toy kind: the text model pooled at its first token."""
import numpy as np

from portbench.counts import flops
from portbench.kinds.text import PACKED, PORT_KIND, memes, model_config
from portbench.reference.nets import F32, linear, text_encoder
from portbench.weights import linear_specs, text_encoder_specs


def param_specs(cfg):
    H = cfg["text_encoder"]["hidden_size"]
    return (text_encoder_specs("encoder.", cfg["text_encoder"])
            + linear_specs("output", H, cfg["head"]["num_classes"]))


def logits(W, cfg, batch, training, P=F32):
    drop = batch.get("drop") if training else None
    hidden = text_encoder(W, "encoder.", cfg["text_encoder"],
                          batch["text_ids"], batch["text_mask"], P, drop)
    return linear(W, "output", hidden[:, 0], P)


def forward_flops(cfg, n, tokens):
    t = cfg["text_encoder"]
    return float(np.sum(flops.encoder(tokens["text"], t["hidden_size"],
                                      t["intermediate_size"],
                                      t["num_hidden_layers"])))


def attention_parts(cfg, n, tokens):
    return [(tokens["text"], cfg["text_encoder"])]
'''

RUN = ("import json, time, torch; from portbench import spec; "
       "from portbench.run import execute, forbidden_modules; "
       "r = execute(spec.cell('train_toy'), 2**31 + 3, 0.5, False, "
       "torch.device('cpu'), time.time()); "
       "r['forbidden'] = forbidden_modules(); print(json.dumps(r))")


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

    # A kind added by files alone: its module, a configuration that names
    # it, a traffic mix and a workload, and the entries in BENCHMARK.json.
    pkg = root / "portbench"
    (pkg / "kinds/toy.py").write_text(TOY_KIND)
    toy = tiny_config("2a_arabert")
    toy.update(name="toy_cls", kind="toy")
    toy["head"] = {"pooling": "cls", "num_classes": 2, "loss": "ce",
                   "max_text_len": 32}
    (pkg / "configs/toy_cls.json").write_text(json.dumps(toy))
    (pkg / "traffic/toy_folds.json").write_text(json.dumps(dict(
        spec.traffic("fold_training_2a"), train_memes=160, words_max=20,
        checked_steps=8)))
    (pkg / "workloads/train_toy.json").write_text(json.dumps(
        {"config": "toy_cls", "traffic": "toy_folds",
         "limits": {"logit_gap": 0.01, "norm_gap": 0.01, "grad_gap": 0.01,
                    "change_gap": 0.01}}))
    bench["configs"].append({"name": "toy_cls", "source": "x",
                             "file": "portbench/configs/toy_cls.json",
                             "reduced": [], "why": "a toy"})
    bench["workloads"].append({"name": "train_toy", "config": "toy_cls",
                               "traffic": "toy_folds", "chips": 1,
                               "why": "a toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "train_2a_packed" in m.get("workloads", ()):
            m["workloads"].append("train_toy")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=spec.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["check"]
    assert set(result["metrics"]) == {"train_memes_per_s", "setup_s"}
    assert set(result["check"]) == {"logit_gap", "norm_gap", "grad_gap",
                                    "change_gap"}
    assert result["forbidden"] == []
