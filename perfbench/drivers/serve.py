"""Serving raw windows: `InferenceServer.infer` in a closed loop.

Set-up builds the server (the model made on the device from the seed, in
eval mode; the production frontend, whose plan is built on the host) and
a ring of request batches, each B raw FHR and UP windows made from the
seed on the host, as a monitoring station hands them over. The model's
BatchNorm statistics are calibrated on the first batch (`calibrate`). Two requests
warm it up. Then the window: one caller sends requests back to back, each
as soon as the one before is answered: it calls `infer`, waits for the
outputs to be on the card, synchronized, and moves on, while the host
clock is within `seconds`. A request's latency runs from the call until
then.

A sample of requests drawn from the seed (`sampled`) is kept: their coefficients (the
frontend's output, by wrapping `InferenceServer.coefficients`) and their
outputs. After the window the reference frontend recomputes the
coefficients from the raw windows, and the reference model the outputs
from the program's coefficients, both in float64.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import data, weights
from ..checks import serve_checks, serve_numbers
from ..counts import PEAK_FLOPS, step_flops, wavefront_least_s
from ..reference.frontend import Frontend
from ..reference.model import Model, calibrated


def _server(cfg, device):
    from vae_teb_tpu_torch import (InferenceServer, PhaseScattering1D,
                                   production_frontend)
    from .train import _model
    fe = cfg["frontend"]
    if fe.get("production"):
        frontend = production_frontend(device)
    else:
        frontend = PhaseScattering1D(J=fe["J"], Q=fe["Q"], T=fe["T"],
                                     shape=fe["N"], max_order=1,
                                     reduced_rate=True, device=device)
    model, shapes = _model(cfg, device)
    return InferenceServer(model, frontend, device), shapes


def sampled(tr, seed: int, seconds: float):
    """The requests checked: `checked_requests` drawn from the seed among
    the window's first `sample_rate_per_s` x `seconds` (a rate below what
    the server completes), so that each is served."""
    rng = np.random.default_rng([seed, 4])
    span = max(int(tr["sample_rate_per_s"] * seconds), tr["checked_requests"])
    return sorted(int(i) for i in rng.choice(span, tr["checked_requests"],
                                             replace=False))


def calibrate(server, fhr, up):
    """Move the model's BatchNorm running statistics once towards those of
    a batch (one training-mode forward, no gradient), as a trained model's
    hold its data's; with the seed's fresh statistics (0 and 1) the
    decoder's one-channel last block can clip every window to 0. Returns
    the batch's coefficients."""
    with torch.no_grad():
        coeffs = server.coefficients(fhr, up)
        server.model.train()
        server.model(*coeffs, deterministic=True)
        server.model.eval()
    return coeffs


def reference_pairs(cfg, shapes, inputs, kept, calibration, device):
    """Per kept request: (program coefficients, reference coefficients,
    program outputs, reference outputs). The reference model runs on the
    program's coefficients: each stage is judged apart (end to end, the
    cross family's float32 rounding, amplified by the model, moves the
    outputs by 3-8% of their maximum in sound runs). It calibrates its BatchNorm statistics as the program did on
    the program's coefficients of the calibration batch (`calibration`)."""
    fe, m = cfg["frontend"], cfg["model"]
    front = Frontend(fe["J"], fe["Q"], fe["T"], fe["N"], fe["trim"], device)
    P = {k: v.double() for k, v in
         weights.make(shapes, cfg["seed"], device).items()}
    P = calibrated(m, P, calibration)
    model = Model(m, P, None, train=False)
    pairs = []
    with torch.no_grad():
        for i, (coeffs, outs) in sorted(kept.items()):
            fhr, up = inputs[i]
            ref_c = front(torch.as_tensor(fhr), torch.as_tensor(up))
            pairs.append((coeffs, ref_c, outs, model.forward(*coeffs)))
    return pairs


def run(ctx) -> Dict:
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    m = cfg["model"]
    B, N = tr["batch"], cfg["frontend"]["N"]
    server, shapes = _server(cfg, dev)
    ctx.mark("server")
    ring = [data.raw_windows(B, N, ctx.seed, r) for r in range(tr["ring"])]
    sample = set(sampled(tr, ctx.seed, ctx.seconds))
    tracer, timer = ctx.tracer, ctx.timer
    kept: Dict[int, tuple] = {}
    current = {"i": -1}
    coefficients = server.coefficients

    def traced_coefficients(fhr, up):
        timer.begin("frontend")
        out = coefficients(fhr, up)
        timer.end("frontend")
        if current["i"] in sample:
            kept[current["i"]] = out
        return out

    ctx.mark("requests")
    calibration = calibrate(server, *ring[0])
    server.coefficients = traced_coefficients
    server.model.register_forward_pre_hook(
        lambda *_: timer.begin("forward"))
    server.model.register_forward_hook(lambda *_: timer.end("forward"))

    for r in range(2):                                   # warm-up
        server.infer(*ring[r % len(ring)])
    ctx.sync()
    timer.pairs.clear()
    setup_s = time.perf_counter() - ctx.t0
    tracer.host.clear()
    tracer.calls.clear()

    latency, requests = [], 0
    order = np.random.default_rng([ctx.seed, 5]).integers(
        0, len(ring), size=4096)
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < ctx.seconds:
        if ctx.trace and requests == tr["trace_after_requests"]:
            tracer.start()
        current["i"] = requests
        fhr, up = ring[order[requests % len(order)]]
        begin = time.perf_counter()
        with tracer.span("request"):
            outs = server.infer(fhr, up)
            ctx.sync()
        latency.append(time.perf_counter() - begin)
        if requests in sample:
            kept[requests] = (kept[requests], outs)
        requests += 1
        if tracer.prof is not None and tracer.units == 0 and requests >= \
                tr["trace_after_requests"] + tr["trace_requests"]:
            tracer.stop()
            tracer.units = tr["trace_requests"]
    window_s = time.perf_counter() - t_start
    if tracer.prof is not None and tracer.units == 0:   # the window closed first
        tracer.stop()
        tracer.units = requests - tr["trace_after_requests"]
    memory_peak = ctx.memory_peak()
    trace = tracer.summary(within="request")
    inputs = {i: ring[order[i % len(order)]] for i in kept}
    del server, outs
    ctx.free()

    pairs = reference_pairs(cfg, shapes, inputs, kept, calibration, dev)
    ctx.note(f"requests checked: {sorted(kept)}")
    lat_ms = np.asarray(latency) * 1e3
    return {
        "attempted": requests, "failed": 0, "memory_peak": memory_peak,
        "end_to_end": {"serve_p95_ms": float(np.percentile(lat_ms, 95)),
                       "serve_windows_per_s": requests * B / window_s,
                       "setup_s": setup_s},
        "checks": serve_checks(pairs, ctx.limits),
        "numbers": serve_numbers(pairs) if pairs else {},
        "readings": {
            "kind": "serve", "requests": requests, "window_s": window_s,
            "service_s": float(np.sum(latency)),
            "latency_ms": lat_ms.tolist(),
            "host": dict(tracer.host), "calls": dict(tracer.calls),
            "frontend_ms": timer.ms("frontend"),
            "forward_ms": timer.ms("forward"),
            "flops_per_request": step_flops(m, B, training=False),
            "peak_flops": PEAK_FLOPS[cfg["precision"]],
            "wavefront_least_s": wavefront_least_s(
                {**m, "precision": cfg["precision"]}, B, training=False),
            "trace": trace},
    }
