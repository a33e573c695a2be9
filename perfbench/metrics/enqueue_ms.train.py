"""enqueue_ms.train: host milliseconds a step spends enqueueing in
`Trainer.train_multi_step`: the program's span `trainer.train_multi_step`
(host clock, from the call until it returns, before any synchronization)
less its spans `graph.launch` (the graph launches, which wait while the
card's queue is full, so they follow the device's time), summed over the
traced groups, over their steps (K a group).

Layer: Training step (`Trainer.train_multi_step`, `StepGraph.replay`). Moves `train_windows_per_s`. Reads the program's own record,
`vae_teb_tpu_torch.utils.profiling.snapshot()`, after a `--trace 1` run;
returns None where the program has no `snapshot` or the group span is
absent."""


def read(r):
    if r.get("kind") != "train":
        return None
    try:
        from vae_teb_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    spans = snapshot()["spans"]
    group = spans.get("trainer.train_multi_step")
    if not group or not group["calls"]:
        return None
    launch = spans.get("graph.launch", {}).get("host_s", 0.0)
    return 1e3 * (group["host_s"] - launch) / group["calls"] / r["K"]
