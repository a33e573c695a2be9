"""forward_ms.serve: device milliseconds of the model's forward a request: CUDA events from
the module's forward pre-hook to its forward hook, the mean over the
window's requests.

Layer: Model forward (`models.vae_teb.SeqVaeTeb`, eval mode). Moves `serve_p95_ms`. Reads the harness's readings of a
`--trace 1` run; returns None where it finds nothing to read."""


def read(r):
    ms = r.get("forward_ms") or []
    if r.get("kind") != "serve" or not ms:
        return None
    return sum(ms) / len(ms)
