"""A configuration, a traffic mix and a per-layer metric added as new files
and BENCHMARK.json entries are found by name, and no file the benchmark
already has is edited. Run on a copy in a temporary directory."""

import hashlib
import json
import os
import shutil

from conftest import ROOT, TRAIN_SMALL, TRAIN_TRAFFIC

from perfbench.counts import step_flops
from perfbench.run import run_cell

METRIC = '''"""flops.train_b16: the model FLOPs of a step the harness counted."""


def read(r):
    return r.get("flops_per_step")
'''


def _hashes(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "perfbench")):
        for f in files:
            if "__pycache__" not in d and "_cache" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = _hashes(root)
    pb = os.path.join(root, "perfbench")

    with open(os.path.join(pb, "configs", "seqvae_teb.json")) as f:
        cfg = json.load(f)
    cfg["model"]["lstm_hidden_dim"] = 16
    cfg["reduced"] = []
    with open(os.path.join(pb, "configs", "seqvae_teb_h16.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "train_b16.json"), "w") as f:
        json.dump({"kind": "train", "batch": 16, "steps_per_execution": 2,
                   "pool_windows": 64, "prefetch": 2,
                   "trace_after_groups": 1, "trace_groups": 1}, f)
    with open(os.path.join(pb, "metrics", "flops.train_b16.py"), "w") as f:
        f.write(METRIC)
    name = "train.seqvae_teb_h16.b16"
    with open(os.path.join(pb, "limits", name + ".json"), "w") as f:
        json.dump({"loss_gap.step1": 1e-4}, f)

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "seqvae_teb_h16", "source": cfg["source"],
                             "file": "perfbench/configs/seqvae_teb_h16.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": name, "config": "seqvae_teb_h16",
                               "traffic": "train_b16", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_windows_per_s":
            m["workloads"].append(name)
    bench["per_layer"].append({"name": "flops.train_b16", "unit": "FLOP",
                               "better": "higher", "source": "host_clock",
                               "layer": "Training step",
                               "moves": "train_windows_per_s",
                               "workloads": [name]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    small = {"model": {k: v for k, v in TRAIN_SMALL["model"].items()
                       if k != "lstm_hidden_dim"},
             "frontend": TRAIN_SMALL["frontend"]}
    traffic = {"batch": 4, "pool_windows": 16}
    result, _ = run_cell(name, 11, 1.0, True, device="cpu", root=root,
                         config_overrides=small, traffic_overrides=traffic)
    assert result["correct"] is True
    want = step_flops(dict(cfg["model"], **small["model"]), 4, training=True)
    assert result["metrics"]["flops.train_b16"]["value"] == want
    assert "step_mfu.train" not in result["metrics"]
    after = _hashes(root)
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == {
        "perfbench/configs/seqvae_teb_h16.json",
        "perfbench/traffic/train_b16.json",
        "perfbench/metrics/flops.train_b16.py",
        "perfbench/limits/train.seqvae_teb_h16.b16.json"}
    assert TRAIN_TRAFFIC["batch"] == 4
