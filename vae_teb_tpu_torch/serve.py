"""Serving: raw FHR/UP windows in, SeqVaeTeb outputs out.

`WindowFrontend` turns raw (B, N) windows into the model's coefficients:
the phase-scattering frontend (scattering, phase and cross-phase families)
on the production selections, then TRIM steps (2 minutes) trimmed from
each end. The training step takes the same coefficients.
`production_frontend` is the frontend serving and training use: the
reduced-rate pipeline with first-order scattering, set explicitly (the
frontend's own defaults are the JAX package's: exact rate).

`InferenceServer` holds a model and a `WindowFrontend` on one device, the
CUDA card unless the caller names another.
`infer(fhr, up)` runs the whole serving path -> the deterministic forward
(posterior mean latent). `infer_coefficients(y_st, y_ph, x_ph)` starts
from precomputed coefficients, as the JAX package's `serve._inference_fn`
does.

Precision is fp32. On a CUDA device PyTorch runs float32 matmuls in full
fp32 by default, but cuDNN convolutions in TF32; callers that need the
JAX package's fp32 numbers set `torch.backends.cudnn.allow_tf32 = False`.

Serving artifacts: `export_inference` and `export_source_stream` trace the
deterministic forward from coefficients, or one step of the streaming
source encode, with `torch.export` into a program that `save_artifact`
writes and `load_artifact` reads back, in two flavours: weights as the
program's first argument (the default; one program serves many
checkpoints) or bundled in it (`bundle_params=True`). The program is traced
on one device, the card unless `device` names another, and runs there.
The wavefront recurrence stays one operator,
`vae_teb_tpu_torch::wavefront_fwd`, which picks the kernel or the plain
version by device when the program runs: loading an artifact needs
`vae_teb_tpu_torch.kernels` imported (`load_artifact` does), where the JAX
package's StableHLO artifact runs with no Python model code.

`StreamingSession` is the stateful causal source encode: chunk in, mu_x of
the chunk out, the convs' tails and the LSTM's state carried on the
session's device, at the cost of a chunk where the reference's
`get_sequence_encoding` recomputes the whole history.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from .device import resolve_device
from .models import SeqVaeTeb
from .ops import PhaseScattering1D
from .utils import profiling

TRIM = 30


def production_frontend(device=None) -> PhaseScattering1D:
    """The serving and training frontend: J=11, Q=4, T=16 over 5760-sample
    windows, first-order scattering (43 channels), reduced-rate phase and
    cross-phase correlations (44 and 130 pairs), fp32 products; constants
    on the CUDA card unless `device` names another (`device="cpu"`)."""
    return PhaseScattering1D(J=11, Q=4, T=16, shape=5760, max_order=1,
                             reduced_rate=True,
                             device=resolve_device(device))


class WindowFrontend:
    """Raw (B, N) FHR and UP windows -> trimmed (y_st, y_ph, x_ph), each
    (B, S, C), on the frontend's device. Needs no gradient."""

    def __init__(self, frontend: PhaseScattering1D):
        self.frontend = frontend
        sel = frontend.optimal_fhr_selection()
        self.phase_subset = sel["phase_selection"]["selected_indices"]
        self.cross_subset = sel["cross_selection"]["selected_indices"]
        if frontend.reduced_rate:   # build the plan now, not in a request
            frontend.plan(self.phase_subset, self.cross_subset)

    @torch.no_grad()
    def __call__(self, fhr: torch.Tensor, up: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
        out = self.frontend.analyze(fhr, up, phase_subset=self.phase_subset,
                                    cross_subset=self.cross_subset)
        n_out = out["scattering"].shape[-1]
        sl = slice(TRIM, n_out - TRIM)
        coeffs = tuple(out[k][:, :, sl].transpose(1, 2)
                       for k in ("scattering", "phase_corr",
                                 "cross_phase_corr"))
        profiling.mark("correlation")
        return coeffs


class InferenceServer:
    """A model and its frontend on one device: the CUDA card unless
    `device` names another (`device="cpu"`). The model moves there; the
    frontend is built on its own device (`production_frontend(device)`),
    which should be the same."""

    def __init__(self, model: SeqVaeTeb, frontend: PhaseScattering1D,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.frontend = WindowFrontend(frontend)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def coefficients(self, fhr, up) -> Tuple[torch.Tensor, ...]:
        """Raw (B, N) windows -> trimmed (y_st, y_ph, x_ph), each (B, S, C)."""
        with profiling.span("serve.coefficients"):
            return self.frontend(self._tensor(fhr), self._tensor(up))

    @torch.inference_mode()
    def infer(self, fhr, up) -> Dict[str, torch.Tensor]:
        """Raw FHR and UP windows (B, N) -> the deterministic forward's
        outputs (z, linear_output, mu_pr, logvar_pr, mu_x, mu_prior,
        logvar_prior, mu_post, logvar_post).

        The span `serve.infer` covers the call until it returns (the work
        it enqueued may still run); the request's stage marks start before
        the windows are copied to the device (`utils.profiling`)."""
        with profiling.span("serve.infer"), \
                profiling.stages("request", self.device):
            return self.model(*self.coefficients(fhr, up), deterministic=True)

    @torch.inference_mode()
    def infer_coefficients(self, y_st, y_ph, x_ph) -> Dict[str, torch.Tensor]:
        """Trimmed coefficients (B, S, 43/44/130) -> the deterministic
        forward's outputs."""
        return self.model(self._tensor(y_st), self._tensor(y_ph),
                          self._tensor(x_ph), deterministic=True)


COEFF_KEYS = ("fhr_st", "fhr_ph", "fhr_up_ph")   # y_st, y_ph, x_ph


class _SourceStep(nn.Module):
    """One step of the streaming source encode as a module:
    (x_chunk, state) -> (mu_x chunk, state), through the model's
    recurrence. Its parameters and buffers are the source encoder's, under
    the model's names (`source_encoder.*`)."""

    def __init__(self, model: SeqVaeTeb):
        super().__init__()
        self.source_encoder = model.source_encoder
        self.recurrence = model.recurrence

    def forward(self, x_chunk, state):
        return self.source_encoder.stream(x_chunk, state, self.recurrence)


class _WeightsAsArgument(nn.Module):
    """`entry` with the model's `state_dict()` as the first argument: its
    parameters and buffers (BatchNorm's running statistics too) replace
    the entry's own (`torch.func.functional_call`, strict: every one the
    entry has). The entry is kept out of this module's state, so the
    program carries no weights."""

    def __init__(self, entry: nn.Module):
        super().__init__()
        self.__dict__["entry"] = entry        # not a submodule

    def call(self, weights, *inputs):
        return torch.func.functional_call(self.entry, weights, inputs,
                                          strict=True)


# the programs' signatures, written out: torch.export keeps a `*inputs`
# argument as one tuple
class _InferenceWeights(_WeightsAsArgument):
    def forward(self, weights, y_st, y_ph, x_ph):
        return self.call(weights, y_st, y_ph, x_ph)


class _StreamWeights(_WeightsAsArgument):
    def forward(self, weights, x_chunk, state):
        own = {k: v for k, v in weights.items()
               if k.startswith("source_encoder.")}
        return self.call(own, x_chunk, state)


def _export(program: nn.Module, inputs: tuple,
            weights: Optional[Mapping] = None,
            batch: Optional[torch.export.Dim] = None
            ) -> torch.export.ExportedProgram:
    """Trace `program` on `inputs` with no gradient, so the recurrence is
    the serving operator; `weights`, the model's state dict, comes first
    for a `_WeightsAsArgument` program. `batch` marks axis 0 of every
    tensor in `inputs` symbolic."""
    dims = None if batch is None else tuple({0: batch} for _ in inputs)
    if weights is not None:
        inputs = (weights,) + inputs
        if dims is not None:
            dims = (dict.fromkeys(weights),) + dims
    with torch.no_grad():
        exported = torch.export.export(program, inputs, dynamic_shapes=dims)
    # the example inputs (the weights too, when they are an argument) would
    # be saved with the program
    exported.example_inputs = None
    return exported


def export_inference(model: SeqVaeTeb, example_batch: Mapping, *,
                     batch_polymorphic: bool = True,
                     bundle_params: bool = False,
                     device=None) -> torch.export.ExportedProgram:
    """Trace the deterministic eval-mode forward from coefficients into a
    program: (weights, y_st, y_ph, x_ph) -> the forward's output dict, where
    weights is the model's `state_dict()` (parameters and BatchNorm running
    statistics, an OrderedDict: a checkpoint's "model" entry of the same
    configuration serves), or (y_st, y_ph, x_ph) with `bundle_params=True`,
    the weights then held in the program.

    example_batch: "fhr_st", "fhr_ph", "fhr_up_ph" arrays (B, S, C) fixing
    the sequence length and channel counts. With `batch_polymorphic` axis
    0 is the symbolic dimension "b" and the program takes any batch size:
    it is traced at B >= 2 (a smaller example is repeated to 2 rows), since
    `torch.export` specializes sizes 0 and 1. The model moves to `device`
    (the card unless it names another) and goes to eval mode; the program
    is traced, and runs, there.
    """
    device = resolve_device(device)
    model = model.to(device).eval()
    coeffs = tuple(torch.as_tensor(example_batch[k], dtype=torch.float32,
                                   device=device) for k in COEFF_KEYS)
    batch = None
    if batch_polymorphic:
        batch = torch.export.Dim("b")
        if coeffs[0].shape[0] < 2:
            coeffs = tuple(c[:1].expand(2, *c.shape[1:]).contiguous()
                           for c in coeffs)
    if bundle_params:
        return _export(model, coeffs, batch=batch)
    return _export(_InferenceWeights(model), coeffs, model.state_dict(), batch)


def export_source_stream(model: SeqVaeTeb, *, batch_size: int,
                         chunk_len: int, n_channels: int = 130,
                         bundle_params: bool = False,
                         device=None) -> torch.export.ExportedProgram:
    """Trace one step of the streaming source encode into a program at a
    static batch: (weights, x_chunk (B, chunk_len, C), state) -> (mu_x
    chunk, new state), or without weights when `bundle_params`. weights
    is the model's `state_dict()`, as in `export_inference` (the program
    reads its `source_encoder.*` entries; a bundled program holds only
    those); state is `model.init_source_stream_state(B)`'s
    dict, an explicit input and output, so the caller owns the session
    and chained calls reproduce the full-sequence encode. Device as in
    `export_inference`."""
    device = resolve_device(device)
    model = model.to(device).eval()
    state = model.init_source_stream_state(batch_size, device)
    chunk = torch.zeros((batch_size, chunk_len, n_channels), device=device)
    if bundle_params:
        return _export(_SourceStep(model), (chunk, state))
    return _export(_StreamWeights(_SourceStep(model)), (chunk, state),
                   model.state_dict())


def save_artifact(exported: torch.export.ExportedProgram, path: str) -> int:
    """Write a program with `torch.export.save`; returns the bytes
    written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(exported, path)
    return os.path.getsize(path)


def load_artifact(path: str) -> torch.export.ExportedProgram:
    """Read a program written by `save_artifact`; call it as
    `.module()(*args)`. It calls the operator
    `vae_teb_tpu_torch::wavefront_fwd`, which importing
    `vae_teb_tpu_torch.kernels` registers."""
    from . import kernels  # noqa: F401  (registers the operator)
    return torch.export.load(path)


class StreamingSession:
    """A stateful causal source encode on one device, the CUDA card unless
    `device` names another: each `step(x_chunk)` takes the next (B,
    S_chunk, C) chunk of phase channels and returns its mu_x (B, S_chunk,
    latent), keeping the causal convs' tails and the LSTM's state on the
    device. Chained steps give the full-sequence source encode at the cost
    of a chunk each. `state` is that carried state
    (`SeqVaeTeb.init_source_stream_state`'s dict): copy it to checkpoint a
    session, assign it to resume one. The model moves to the device and
    goes to eval mode.
    """

    def __init__(self, model: SeqVaeTeb, batch_size: int, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.state = self.model.init_source_stream_state(batch_size,
                                                         self.device)

    @torch.inference_mode()
    def step(self, x_chunk) -> torch.Tensor:
        x = torch.as_tensor(x_chunk, dtype=torch.float32, device=self.device)
        mu, self.state = self.model.encode_source_stream(x, self.state)
        return mu
