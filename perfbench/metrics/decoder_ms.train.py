"""decoder_ms.train: device milliseconds of a training step's decoder, forward and
backward: the program's stage marks `decode` (the decoder, its raw heads
and the loss) plus `decode_backward` (until z's gradient is ready), in
the latest replay of the captured step (CUDA events recorded by the
graph).

Layer: Training step (`Trainer.train_multi_step`, `StepGraph.replay`). Moves `train_windows_per_s`. Reads the program's own record,
`vae_teb_tpu_torch.utils.profiling.snapshot()`, after a `--trace 1` run;
returns None where the program has no `snapshot` or the stage is
absent."""


def read(r):
    if r.get("kind") != "train":
        return None
    try:
        from vae_teb_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    stages = snapshot()["stages"]["step"]
    if "decode" not in stages or "decode_backward" not in stages:
        return None
    return stages["decode"] + stages["decode_backward"]
