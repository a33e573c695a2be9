"""device_idle.serve: idle share of the card while requests are served: 1 - the union of the
device's operations over the union of the traced requests' spans, from
sending each to its outputs synchronized (profiler trace), in %.

Layer: Device (one H100). Moves `serve_p95_ms`. Reads the harness's readings of a
`--trace 1` run; returns None where it finds nothing to read."""


def read(r):
    tr = r.get("trace") or {}
    if r.get("kind") != "serve" or not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
