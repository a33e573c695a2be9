"""decoder_ms.serve: device milliseconds of a request's decoder: the program's stage mark
`decode` (the decoder and its raw heads), the mean over the traced
requests.

Layer: Model forward (`models.vae_teb.SeqVaeTeb`, eval mode). Moves `serve_p95_ms`. Reads the program's own record,
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
    if "decode" not in stages:
        return None
    return stages["decode"]
