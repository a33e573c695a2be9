"""encoder_ms.forecast: device milliseconds of a forecaster training
step's encoders (SeqVaeTeb's three, shared with `train.seqvae_teb.b128`),
forward and backward: the program's stage marks `encode` (from the
step's start mark: the normalization, the three encoders, z) plus
`encode_backward` (from z's gradient to the end of the backward), in the
latest replay of the captured step (CUDA events recorded by the graph).

Layer: Training step (`Trainer.train_multi_step`, `StepGraph.replay`). Moves `train_windows_per_s`. Reads the program's own record,
`vae_teb_tpu_torch.utils.profiling.snapshot()`, after a `--trace 1` run;
returns None where the program has no `snapshot` or the stage is
absent."""


def read(r):
    if r.get("kind") != "train" or "grid_least_s" not in r:
        return None
    try:
        from vae_teb_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    stages = snapshot()["stages"]["step"]
    if "encode" not in stages or "encode_backward" not in stages:
        return None
    return stages["encode"] + stages["encode_backward"]
