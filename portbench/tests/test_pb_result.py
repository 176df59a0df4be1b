"""A whole run of each cell at tiny size on the CPU, the harness's look for
a GPU skipped: the result line's keys, and what a traced run adds."""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import spec
from portbench.run import execute
from tiny import tiny_cell


@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(name, trace):
    cell = tiny_cell(name)
    result = execute(cell, 2 ** 31 + 11, 0.5, trace, torch.device("cpu"),
                     time.time())
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "check"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    units = spec.metric_units()
    if trace:
        assert set(result["metrics"]) <= set(cell["per_layer"])
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == set(cell["end_to_end"])
    for m, v in result["metrics"].items():
        assert v["unit"] == units[m] and v["value"] >= 0
    for j in result["check"].values():
        assert set(j) == {"value", "limit"}
    json.dumps(result)


def test_no_gpu_no_result():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the run would measure")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "train_2c_folds", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
