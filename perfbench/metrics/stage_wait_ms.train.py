"""stage_wait_ms.train: host milliseconds a step waits on the prefetch iterator (the harness's
`stage_wait` span, host clock), summed over the window, per step.

Layer: Staging layer (`prefetch_to_device`, `Trainer._prep`). Moves `train_windows_per_s`. Reads the harness's readings of a
`--trace 1` run; returns None where it finds nothing to read."""


def read(r):
    if r.get("kind") != "train" or not r["steps"]:
        return None
    return r["host"].get("stage_wait", 0.0) * 1e3 / r["steps"]
