"""Readings that set the upper end of a cell's limits: the reference put in
the program's place in the precision below the configuration's, or with a
fault planted, read by the same numbers as the harness reads the program.

    python3 perfbench/control.py --workload <name> --seeds 1 2 3 \
        --precision tf32 [--fault half_batch]

Training cells: the reference's first three steps on the rows and noise a
run of that seed steps on, against the float64 reference's. Serving
cells: the reference frontend and model serve the requests a run of that
seed checks; their coefficients are read against the float64 frontend's,
their outputs against the float64 model's on the same coefficients.
`--precision fp32` reads the reference in plain float32: how far float32
rounding alone moves each number. `--precision program_bf16` (serving)
puts the program's own lower-precision frontend path in place: its pair
products and decimation operators in bf16. `--fault` plants a fault in
the lower side: `half_batch` (training: each step's loss over half the
rows), `cross_swapped` / `cross_shifted` (serving: the cross family of UP
against FHR, or each cross channel moved one over). One JSON line a seed. The benchmark's
own runs never run this; `tests/test_perfbench_control.py` runs it small.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import data  # noqa: E402
from perfbench.checks import serve_numbers, train_numbers  # noqa: E402
from perfbench.drivers.serve import sampled  # noqa: E402
from perfbench.reference.frontend import Frontend  # noqa: E402
from perfbench.reference.model import Model, calibrated, param_shapes  # noqa: E402
from perfbench.reference.precision import Precision  # noqa: E402
from perfbench.reference.train import reference_steps  # noqa: E402
from perfbench import weights  # noqa: E402


def _cell(workload, root, config_overrides, traffic_overrides):
    from perfbench.run import _json, _merge
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    pb = os.path.join(root, "perfbench")
    cfg = _merge(_json(os.path.join(pb, "configs", cell["config"] + ".json")),
                 config_overrides)
    tr = _merge(_json(os.path.join(pb, "traffic", cell["traffic"] + ".json")),
                traffic_overrides)
    return cfg, dict(tr, seconds=bench["run_seconds"])


def train_control(cfg, tr, seed, device, precision, fault=None):
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


def serve_control(cfg, tr, seed, device, precision, fault=None):
    fe, m = cfg["frontend"], cfg["model"]
    B = tr["batch"]
    sample = sampled(tr, seed, tr["seconds"])
    order = np.random.default_rng([seed, 5]).integers(0, tr["ring"], size=4096)
    shapes = param_shapes(m)
    made = weights.make(shapes, seed, device)
    args = (fe["J"], fe["Q"], fe["T"], fe["N"], fe["trim"], device)
    front = Frontend(*args)
    if precision == "program_bf16":
        front_low = _program_bf16_frontend(fe, device)
        pol = Precision("fp32")
    else:
        pol = Precision(precision)
        front_low = Frontend(*args, precision=pol)
    calib = front_low(*(torch.as_tensor(a) for a in
                        data.raw_windows(B, fe["N"], seed, 0)))
    P = calibrated(m, {k: v.double() for k, v in made.items()}, calib)
    P_low = calibrated(m, {k: v.to(pol.real) for k, v in made.items()}, calib)
    model = Model(m, P, None, False)
    low = Model(m, {k: v.to(pol.real) for k, v in P_low.items()}, pol, False)
    pairs = []
    with torch.no_grad():
        for i in sample:
            fhr, up = (torch.as_tensor(a) for a in
                       data.raw_windows(B, fe["N"], seed, int(order[i])))
            coeffs = front_low(fhr, up)
            if fault == "cross_swapped":       # UP against FHR, not FHR against UP
                coeffs = coeffs[:2] + front_low(up, fhr)[2:]
            elif fault == "cross_shifted":     # each cross channel one over
                coeffs = coeffs[:2] + (coeffs[2].roll(1, dims=-1),)
            pairs.append((coeffs, front(fhr, up), low.forward(*coeffs),
                          model.forward(*coeffs)))
    return serve_numbers(pairs)


def _program_bf16_frontend(fe, device):
    """The program's own lower-precision frontend path: the production
    frontend with its pair products and decimation operators in bf16."""
    from vae_teb_tpu_torch import PhaseScattering1D
    from vae_teb_tpu_torch.serve import WindowFrontend
    wf = WindowFrontend(PhaseScattering1D(
        J=fe["J"], Q=fe["Q"], T=fe["T"], shape=fe["N"], max_order=1,
        reduced_rate=True, correlation_dtype=torch.bfloat16, device=device))
    return lambda fhr, up: wf(fhr.to(device), up.to(device))


def control(workload, seed, precision, fault=None, device="cuda", root=ROOT,
            config_overrides=None, traffic_overrides=None):
    cfg, tr = _cell(workload, root, config_overrides, traffic_overrides)
    if tr["kind"] == "train":
        return train_control(cfg, tr, seed, torch.device(device), precision,
                             fault)
    return serve_control(cfg, tr, seed, torch.device(device), precision,
                         fault)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precision", default=None,
                   choices=("fp32", "tf32", "fp8", "program_bf16"))
    p.add_argument("--fault", default=None,
                   choices=("half_batch", "cross_swapped", "cross_shifted"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        numbers = control(args.workload, seed, args.precision, args.fault,
                          args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": args.precision, "fault": args.fault,
                          **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
