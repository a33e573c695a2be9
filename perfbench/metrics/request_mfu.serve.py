"""request_mfu.serve: the whole request's share of the card's peak: the model's forward FLOPs
of a request (`counts.step_flops`) times the window's requests, over the
seconds the server spent serving them (host clock, from sending to the
outputs synchronized) and the peak of the configuration's precision, in %.

Layer: Serving (`serve.InferenceServer.infer`). Moves `serve_p95_ms`. Reads the harness's readings of a
`--trace 1` run; returns None where it finds nothing to read."""


def read(r):
    if r.get("kind") != "serve" or not r["requests"]:
        return None
    return 100.0 * r["flops_per_request"] * r["requests"] / r["service_s"] / \
        r["peak_flops"]
