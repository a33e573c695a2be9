"""correlation_ms.serve: device milliseconds of a request's correlation stage: the program's
stage mark `correlation` (the UP spectrum, the reduced-rate phase and
cross families, the trim), the mean over the traced requests.

Layer: Frontend (`serve.WindowFrontend`, `ops.phase.PhaseScattering1D.analyze`). Moves `serve_p95_ms`. Reads the program's own record,
`vae_teb_tpu_torch.utils.profiling.snapshot()`, after a `--trace 1` run;
returns None where the program has no `snapshot` or the stage is
absent."""


def read(r):
    if r.get("kind") != "serve":
        return None
    try:
        from vae_teb_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    stages = snapshot()["stages"]["request"]
    if "correlation" not in stages:
        return None
    return stages["correlation"]
