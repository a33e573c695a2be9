"""enqueue_ms.serve: host milliseconds a request spends in `InferenceServer.infer`: the
program's span `serve.infer` (host clock, from the call until it
returns, before the caller synchronizes), the mean over the traced
requests.

Layer: Serving (`serve.InferenceServer.infer`). Moves `serve_p95_ms`. Reads the program's own record,
`vae_teb_tpu_torch.utils.profiling.snapshot()`, after a `--trace 1` run;
returns None where the program has no `snapshot` or the span is
absent."""


def read(r):
    if r.get("kind") != "serve":
        return None
    try:
        from vae_teb_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    span = snapshot()["spans"].get("serve.infer")
    if not span or not span["calls"]:
        return None
    return 1e3 * span["host_s"] / span["calls"]
