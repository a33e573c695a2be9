#!/usr/bin/env python3
"""Where the card and the CPU part after one fp32 training step.

    python3 step_drift_probe.py            # one CUDA device, seeds 5 5 6 7
    python3 step_drift_probe.py 5 8 9      # other data seeds

For each data seed: the full-width model from chip_smoke.py's seeded
weights takes chip_smoke.py's 15 training steps on the card (phase 5's
loop), then one B=2 step from that state runs on the card twice and on the
CPU once, on identical coefficients and noise. It prints the gradients'
distance (chip_smoke.grad_report), the share of weights more than lr/100
apart after the step, and for the leaves that hold most of them how many
are sign flips of the clipped gradient, how many keep their sign with a
clipped gradient below 1e-7 (Adam's update is near-linear in g there, eps
1e-8), and how many are neither. The two card runs from one state show how
far the card's step repeats itself.
"""

import copy
import sys
import time

import torch

import chip_smoke as cs


def leaves_apart(gpu_model, cpu_model, lr, clip_g, clip_c):
    """(weights more than lr/100 apart, all weights, per-leaf lines)."""
    rows, apart, total = [], 0, 0
    for (name, p), q in zip(gpu_model.named_parameters(),
                            cpu_model.parameters()):
        d = (p.detach().cpu() - q.detach()).abs()
        far = d > 1e-2 * lr
        n = int(far.sum())
        apart, total = apart + n, total + d.numel()
        if not n:
            continue
        gg, gc = p.grad.cpu()[far] * clip_g, q.grad[far] * clip_c
        flips = int((gg * gc < 0).sum())
        tiny = int(((gg * gc >= 0)
                    & (torch.minimum(gg.abs(), gc.abs()) < 1e-7)).sum())
        rows.append((n, f"  {name} {tuple(d.shape)}: {n} apart, sign flips "
                        f"{flips}, tiny same-sign {tiny}, other "
                        f"{n - flips - tiny}; median |clipped g| of those "
                        f"{gc.abs().median().item():.3e}, leaf max |g| "
                        f"{q.grad.abs().max().item():.3e}"))
    return apart, total, [r for _, r in sorted(rows, reverse=True)[:8]]


def probe(seed, device):
    from vae_teb_tpu_torch import (SeqVaeTeb, Trainer, TrainerConfig,
                                   WindowFrontend, init_parameters,
                                   production_frontend)
    model = init_parameters(SeqVaeTeb(), seed=cs.INIT_SEED)
    cfg = TrainerConfig()
    trainer = Trainer(model, cfg, device)
    frontend = WindowFrontend(production_frontend(device))
    gen = torch.Generator(device=device).manual_seed(seed)
    beta = trainer.beta_fn(0)
    raw_len = model.decoder.raw_len

    def batch_of(b):
        x = torch.randn((2, b, cs.N), generator=gen, device=device)
        return x[0], x[1], torch.randn((b, raw_len), generator=gen,
                                       device=device)

    def fields(coeffs, y_raw):
        return dict(zip(("fhr_st", "fhr_ph", "fhr_up_ph"), coeffs), fhr=y_raw)

    t0 = time.perf_counter()
    cs.train_loop(trainer, frontend, batch_of, fields, beta, "train")
    batch_of(8)                                   # phase 5's draws, in order
    torch.randn((8, raw_len // 16, 32), generator=gen, device=device)
    fhr, up, y_raw = batch_of(2)
    batch = fields(frontend(fhr, up), y_raw)
    eps = torch.randn((2, raw_len // 16, 32), generator=gen, device=device)
    cpu_model = copy.deepcopy(model).cpu()
    m_cpu = Trainer(cpu_model, cfg, "cpu").train_step(
        {k: v.cpu() for k, v in batch.items()}, beta, eps=eps.cpu())
    clip_c = min(1.0, cfg.grad_clip_norm / m_cpu["grad_norm"].item())
    runs = []
    for r in range(2):
        gpu_model = copy.deepcopy(model)
        m_gpu = Trainer(gpu_model, cfg, device).train_step(batch, beta,
                                                           eps=eps)
        clip_g = min(1.0, cfg.grad_clip_norm / m_gpu["grad_norm"].item())
        worst, leaf, l2 = cs.grad_report(
            {k: p.grad.cpu() for k, p in gpu_model.named_parameters()},
            {k: p.grad for k, p in cpu_model.named_parameters()})
        apart, total, rows = leaves_apart(gpu_model, cpu_model, cfg.lr,
                                          clip_g, clip_c)
        print(f"seed {seed} card run {r}: grad_norm card "
              f"{m_gpu['grad_norm'].item()!r} CPU "
              f"{m_cpu['grad_norm'].item()!r}; gradients worst {worst!r} "
              f"({leaf}), rel-L2 {l2!r}; share more than lr/100 apart "
              f"{apart / total!r} ({apart} of {total})")
        print("\n".join(rows))
        runs.append(gpu_model)
    params = max((p - q).abs().max().item() for p, q in
                 zip(runs[0].parameters(), runs[1].parameters()))
    grads = max((p.grad - q.grad).abs().max().item() for p, q in
                zip(runs[0].parameters(), runs[1].parameters()))
    print(f"seed {seed}: two card steps from one state: parameters max-abs "
          f"{params!r} apart, gradients {grads!r}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("step_drift_probe: no CUDA device visible", file=sys.stderr)
        return 2
    from vae_teb_tpu_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load_all(("wavefront_fwd.cu", "wavefront_bwd.cu"))
    cs.log = lambda msg: None                   # the loop's per-step lines
    print(cs.card())
    for seed in [int(a) for a in argv] or (5, 5, 6, 7):
        probe(seed, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
