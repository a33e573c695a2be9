"""frontend_ms.serve: device milliseconds of `InferenceServer.coefficients` a request: CUDA
events around the call, the mean over the window's requests.

Layer: Frontend (`serve.WindowFrontend`, `ops.phase_reduced`, `ops.scattering`). Moves `serve_p95_ms`. Reads the harness's readings of a
`--trace 1` run; returns None where it finds nothing to read."""


def read(r):
    ms = r.get("frontend_ms") or []
    if r.get("kind") != "serve" or not ms:
        return None
    return sum(ms) / len(ms)
