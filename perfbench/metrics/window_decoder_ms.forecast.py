"""window_decoder_ms.forecast: device milliseconds of a training step's
direct-window decoder, forward and backward: the program's stage marks
`window_paths` (the three paths from z, summed), `window_heads` (the
processor and both heads), `decode` (the rest of the decoder and the
loss) and `decode_backward` (until z's gradient is ready), in the latest
replay of the captured step (CUDA events recorded by the graph). Where
the decoder sets no marks of its own, `decode` covers its forward whole.

Layer: Training step (`Trainer.train_multi_step`, `StepGraph.replay`). Moves `train_windows_per_s`. Reads the program's own record,
`vae_teb_tpu_torch.utils.profiling.snapshot()`, after a `--trace 1` run;
returns None where the program has no `snapshot` or the stages are
absent."""


def read(r):
    if r.get("kind") != "train" or "grid_least_s" not in r:
        return None
    try:
        from vae_teb_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    stages = snapshot()["stages"]["step"]
    if "decode" not in stages or "decode_backward" not in stages:
        return None
    return sum(stages.get(k, 0.0) for k in ("window_paths", "window_heads",
                                            "decode", "decode_backward"))
