"""Every cell of BENCHMARK.json runs end to end at a small size on the CPU
and gives a result line with exactly the contract's keys; the command
itself refuses to run without the card. (The limits are the cells' own,
set at their sizes on the card; at these sizes a sound run may read above
them, so `correct` is held to its definition here, and the faults'
tests show what it catches.)"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, small

from perfbench.run import run_cell

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_small_on_cpu(workload, trace):
    cfg, traffic = small(workload)
    result, numbers = run_cell(workload, 2 ** 31 + 12345, 3.0, bool(trace),
                               device="cpu", config_overrides=cfg,
                               traffic_overrides=traffic)
    line = json.loads(json.dumps(result))
    keys = list(line)
    assert keys[:5] == KEYS
    assert keys[-1] == "checks"
    assert set(keys) <= set(KEYS + ["breakdown", "checks"])
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        assert sorted(line["metrics"]) == sorted(e2e)
        assert "setup_s" in line["metrics"]
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["metrics"]) <= {m["name"] for m in BENCH["per_layer"]}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["correct"] == all(c["value"] <= c["limit"]
                                  for c in line["checks"].values())
    assert set(numbers) >= set(line["checks"])


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_command_fails_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's files
    exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
