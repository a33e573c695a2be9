"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or `python -m perfbench.run ...`), from the root of a checkout, on a
machine with the CUDA cards the cell asks for. The cell is found by name
in `BENCHMARK.json`; its configuration in `perfbench/configs/<config>.json`,
its traffic in `perfbench/traffic/<traffic>.json` (whose `kind` names the
driver, `perfbench/drivers/<kind>.py`), the limits of its correctness
numbers in `perfbench/limits/<workload>.json`, and each per-layer metric's
reader in `perfbench/metrics/<metric>.py`. Nothing else needs an edit when
a cell, a configuration, a mix or a metric is added.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), device (and with --trace 1 the
breakdown), then `checks`: each number that decided `correct` with its
limit. The same numbers close standard error. Without the cards the cell
asks for, or with JAX or the JAX package loaded once the window has
closed, it exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()      # set-up is timed from here

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, "perfbench", "_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vae_teb_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: the port's name begins with the package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class Context(SimpleNamespace):
    """What a driver gets: the cell's configuration, traffic and limits,
    the run's arguments, the tracer and device timer, and device helpers."""

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def event(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            return ev
        return SimpleNamespace(synchronize=lambda: None)

    def memory_peak(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def free(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def note(self, text: str):
        print(f"perfbench: {text}", file=sys.stderr, flush=True)

    def mark(self, phase: str):
        """Note the seconds since the harness's first line at the end of a
        set-up phase."""
        self.note(f"set-up {phase} done at "
                  f"{time.perf_counter() - self.t0:.2f} s")


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", root: str = ROOT, config_overrides=None,
             traffic_overrides=None):
    """Run one cell on `device`: (its result object, the line the command
    prints; every number the check computed). The look for cards is the caller's; the tests
    call this on the CPU at a small size through the overrides."""
    from perfbench.trace import DeviceTimer, Tracer, top
    from perfbench.checks import passed

    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    pb = os.path.join(root, "perfbench")
    cfg = _merge(_json(os.path.join(pb, "configs", cell["config"] + ".json")),
                 config_overrides)
    traffic = _merge(_json(os.path.join(pb, "traffic",
                                        cell["traffic"] + ".json")),
                     traffic_overrides)
    limits = _json(os.path.join(pb, "limits", workload + ".json"))
    device = torch.device(device)
    cfg["seed"] = int(seed)
    if device.type == "cuda":
        tf32 = bool(cfg.get("tf32", False))
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cuda = device.type == "cuda"
    ctx = Context(cfg=cfg, traffic=traffic, limits=limits, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace), device=device,
                  t0=T0, tracer=Tracer(bool(trace), device),
                  timer=DeviceTimer(bool(trace) and cuda))
    driver = _load(os.path.join(pb, "drivers", traffic["kind"] + ".py"),
                   f"perfbench.drivers.{traffic['kind']}")
    out = driver.run(ctx)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak"],
           "power_limit": power_limit() if cuda else "none"}
    result = {"correct": passed(out["checks"]) and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"]}
    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            if workload in m.get("workloads", [workload]):
                metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                      "unit": m["unit"]}
    else:
        readings = out["readings"]
        e2e = {m["name"] for m in bench["end_to_end"]
               if workload in m.get("workloads", [workload])}
        for m in bench["per_layer"]:
            listed = m.get("workloads")
            if (listed is not None and workload not in listed) or \
                    (listed is None and m["moves"] not in e2e):
                continue
            reader = _load(os.path.join(pb, "metrics", m["name"] + ".py"),
                           "perfbench.metrics." + m["name"].replace(".", "_"))
            value = reader.read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = readings.get("trace") or {}
        dev["busy_s"] = tr.get("busy_s", 0.0)
        dev["window_s"] = tr.get("window_s", 0.0)
    result["metrics"] = metrics
    result["device"] = dev
    if trace and readings.get("trace"):
        result["breakdown"] = {"device_ops": top(readings["trace"]["kernels"]),
                               "idle_gaps": top(readings["trace"]["gaps"])}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in out["checks"]}
    return result, out.get("numbers", {})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"perfbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    result, numbers = run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}: the benchmark measures "
              f"the PyTorch port alone", file=sys.stderr)
        return 3
    if numbers:
        print(f"perfbench: numbers {json.dumps(numbers)}", file=sys.stderr)
    for name, v in result["checks"].items():
        print(f"perfbench: {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
