"""Readings that set the upper end of the forecaster cell's limits
(`train.seqvae_teb_forecast.b128`): the plain forecaster reference
(`reference/forecast.py`) put in the program's place in the precision
below the configuration's, or with a fault planted, read by the same
numbers as the harness reads the program.

    python3 perfbench/control_forecast.py \
        --workload train.seqvae_teb_forecast.b128 --seeds 1 2 3 \
        --precision tf32 [--fault half_batch]

The reference's first three steps on the rows and noise a run of that
seed steps on (`drivers/train_forecast.py`), against the float64
reference's. `--precision fp32` reads the reference in plain float32: how
far float32 rounding alone moves each number; `tf32` rounds the operands
of every product to TF32 (`reference/precision.py`). `--fault half_batch`
takes each step's loss over half the rows. One JSON line a seed. The
benchmark's own runs never run this; `tests/test_perfbench_forecast.py`
runs it small.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench import data  # noqa: E402
from perfbench.checks import train_numbers  # noqa: E402
from perfbench.control import _cell  # noqa: E402
from perfbench.reference.forecast import param_shapes, reference_steps  # noqa: E402


def forecast_control(cfg, tr, seed, device, precision, fault=None):
    m = cfg["model"]
    B = tr["batch"]
    pool, stats = data.coefficient_pool(cfg, tr["pool_windows"], seed, device)
    order = data.batch_order(tr["pool_windows"], B, seed)
    rows = [next(order) for _ in range(4)][1:]     # the run's first batch warms up
    cfg = dict(cfg, seed=seed)
    shapes = param_shapes(m)
    ref = reference_steps(cfg, shapes, pool, stats, rows, seed, B, device)
    low = reference_steps(cfg, shapes, pool, stats, rows, seed, B, device,
                          precision=precision, fault=fault)
    return train_numbers(low, ref)


def control(workload, seed, precision, fault=None, device="cuda", root=ROOT,
            config_overrides=None, traffic_overrides=None):
    cfg, tr = _cell(workload, root, config_overrides, traffic_overrides)
    if tr["kind"] != "train_forecast":
        raise SystemExit(f"{workload} is not a forecaster cell; "
                         f"perfbench/control.py reads the others")
    return forecast_control(cfg, tr, seed, torch.device(device), precision,
                            fault)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precision", default=None, choices=("fp32", "tf32"))
    p.add_argument("--fault", default=None, choices=("half_batch",))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed in args.seeds:
        numbers = control(args.workload, seed, args.precision, args.fault,
                          args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": args.precision, "fault": args.fault,
                          **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
