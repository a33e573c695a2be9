"""The decoder's linear 2x upsample (`kernels.upsample`): on the CPU, the
plain gather backward against autograd through F.interpolate in float64,
the operator's fake implementation, the layouts and the launch-count
bookkeeping. Marked `cuda`: the kernel pair of `kernels/upsample.cu`
against F.interpolate and the plain version on the card, inside a captured
B=128 train step and in an exported program, which skip elsewhere. This
file imports no JAX, so it runs on the card too:
`python -m pytest tests/test_torch_upsample.py -m cuda`.
(tests/test_torch_blocks.py holds linear_upsample against the JAX
package's.)
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from vae_teb_tpu_torch import serve
from vae_teb_tpu_torch.init import init_parameters
from vae_teb_tpu_torch.kernels import (LinearUpsampleFunction,
                                       add_launch_counts, launch_counts,
                                       linear_upsample,
                                       upsample_linear2x_bwd,
                                       upsample_linear2x_bwd_plain,
                                       upsample_linear2x_fwd,
                                       upsample_linear2x_fwd_plain,
                                       upsample_linear2x_op)
from vae_teb_tpu_torch.models import SeqVaeTeb

torch.set_num_threads(2)

OP = torch.ops.vae_teb_tpu_torch.upsample_linear2x.default


def _input(shape, layout, dtype=torch.float64, seed=0, device="cpu"):
    """(B, S, C) standard normal, physically (B, S, C) ("bsc") or, as the
    decoder hands it over, the transposed view of a (B, C, S) tensor
    ("bcs")."""
    B, S, C = shape
    g = torch.Generator().manual_seed(seed)
    if layout == "bcs":
        x = torch.randn(B, C, S, generator=g, dtype=torch.float64)
        x = x.transpose(1, 2)
    else:
        x = torch.randn(B, S, C, generator=g, dtype=torch.float64)
    return x.to(dtype=dtype, device=device)


def _interpolate(x):
    return F.interpolate(x.transpose(1, 2), size=2 * x.shape[1], mode="linear",
                         align_corners=False).transpose(1, 2)


def _channels_first(t):
    return t.transpose(1, 2).is_contiguous()


def _same_layout(out, inp):
    """Whether out lies physically as inp does: (B, C, L) when inp's
    transpose is contiguous (which a length or channel count of 1 allows
    either way), else (B, L, C)."""
    return (_channels_first(out) if _channels_first(inp)
            else out.is_contiguous())


@pytest.mark.parametrize("layout", ["bsc", "bcs"])
@pytest.mark.parametrize("steps", [1, 2, 3, 300])
def test_plain_gather_is_interpolate_gradient(steps, layout):
    """In float64, the plain gather equals autograd through F.interpolate
    (within summation order) at an odd channel count, the edges (S = 1, 2,
    3) included, and so does the gradient through `LinearUpsampleFunction`
    (which the CPU runs on the plain versions); `linear_upsample` on the
    CPU is F.interpolate, forward and gradient, exactly; outputs and
    gradients keep their input's physical layout."""
    x = _input((3, steps, 5), layout, seed=steps).requires_grad_(True)
    want = _interpolate(x)
    cot = _input((3, 2 * steps, 5), layout, seed=100 + steps)
    (want_dx,) = torch.autograd.grad(want, x, cot)
    got_dx = upsample_linear2x_bwd_plain(cot)
    assert got_dx.shape == x.shape
    torch.testing.assert_close(got_dx, want_dx, rtol=1e-14, atol=1e-14)
    a = x.detach().clone().requires_grad_(True)
    y = LinearUpsampleFunction.apply(a)
    assert torch.equal(y, want.detach())
    y.backward(cot)
    assert torch.equal(a.grad, got_dx)
    b = x.detach().clone().requires_grad_(True)
    y = linear_upsample(b)
    assert torch.equal(y, want.detach())
    y.backward(cot)
    assert torch.equal(b.grad, want_dx)
    assert _same_layout(y, x) and _same_layout(got_dx, cot)
    assert _channels_first(y) == (layout == "bcs" or steps == 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bsc", "bcs"])
def test_op_fake_gives_shape_and_strides(layout, dtype):
    """The operator's fake implementation gives the real output's shape,
    strides and type (the decoder's layout keeps its transpose a view), and
    the operator passes opcheck; with no gradient to record,
    `linear_upsample` is the operator."""
    x = _input((2, 7, 3), layout, dtype)
    real = OP(x)
    with FakeTensorMode() as mode:
        fake = OP(mode.from_tensor(x))
    assert fake.shape == real.shape == (2, 14, 3)
    assert fake.stride() == real.stride()
    assert fake.dtype == real.dtype == dtype
    assert _channels_first(real) == (layout == "bcs")
    torch.library.opcheck(upsample_linear2x_op, (x,))
    with torch.no_grad():
        assert torch.equal(linear_upsample(x), real)


def test_launch_counts_bookkeeping():
    """CPU calls launch no kernel and count none; a difference of two
    snapshots carries the upsample wrappers' totals and entries beside the
    wavefront's, and adding it back (as a graph replay does) or taking it
    away (as a capture does) moves exactly those counts."""
    before = launch_counts()
    x = _input((2, 4, 3), "bcs", torch.float32).requires_grad_(True)
    linear_upsample(x).sum().backward()
    assert launch_counts() == before
    keys = [("upsample_linear2x_fwd", "launches"),
            ("upsample_linear2x_fwd", "upsample_linear2x_fwd_f32"),
            ("upsample_linear2x_bwd", "launches"),
            ("upsample_linear2x_bwd", "upsample_linear2x_bwd_bf16")]
    delta = {k: 4 for k in keys}
    delta[("wavefront_fwd", "residual_launches")] = 1
    add_launch_counts(delta, times=2)
    moved = launch_counts() - before
    assert moved == {k: 2 * n for k, n in delta.items()}
    assert upsample_linear2x_fwd.launches == before[keys[0]] + 8
    assert upsample_linear2x_bwd.entry_launches[
        "upsample_linear2x_bwd_bf16"] == before[keys[3]] + 8
    add_launch_counts(delta, times=-2)
    assert launch_counts() - before == {}
    assert before - launch_counts() == {}


def test_refuses_other_devices_and_ranks():
    """A device other than the CPU and CUDA, or a tensor that is not
    (B, L, C), raises."""
    with pytest.raises(ValueError, match="no implementation"):
        upsample_linear2x_fwd(torch.empty(2, 3, 4, device="meta"))
    with pytest.raises(ValueError, match=r"\(B, L, C\)"):
        upsample_linear2x_bwd(torch.zeros(2, 6))


# ---------------------------------------------------------------------------
# the kernel pair on the card
# ---------------------------------------------------------------------------

# (B, S, C): the decoder's four upsamples of SeqVaeTeb at B=128, the
# conv-window decoder's first (B * S = 2 * 300 maps of 32 channels at
# length 30), and the shortest sequences
CARD_SHAPES = [(128, 300, 77), (128, 600, 66), (128, 1200, 44),
               (128, 2400, 33), (600, 30, 32), (3, 1, 5), (3, 2, 5)]
BWD_TOL = {torch.float32: 1e-6, torch.bfloat16: 8e-3}   # of max|dx|


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bcs", "bsc"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_kernel_forward_is_exact_on_card(cuda_device, shape, layout, dtype):
    """The forward kernel equals F.interpolate on the card bit for bit in
    float32, and the plain blends on the card in bfloat16, in the input's
    physical layout; one launch a call."""
    x = _input(shape, layout, dtype, seed=sum(shape), device=cuda_device)
    before = upsample_linear2x_fwd.launches
    got = upsample_linear2x_fwd(x)
    want = (_interpolate(x) if dtype == torch.float32
            else upsample_linear2x_fwd_plain(x))
    torch.cuda.synchronize()
    assert upsample_linear2x_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert _same_layout(got, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["bcs", "bsc"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_kernel_backward_on_card(cuda_device, shape, layout, dtype):
    """The gather kernel is within rounding of float64 autograd through
    F.interpolate (float32: 1e-6 of max|dx|, a few roundings of four
    terms; bfloat16: 8e-3, two of its 2**-8 roundings), bit-identical
    across two runs and to the plain gather run on the card (the same
    operations in the same order), in the output gradient's layout."""
    B, S, C = shape
    x = _input(shape, layout, torch.float64, device=cuda_device)
    x.requires_grad_(True)
    cot = _input((B, 2 * S, C), layout, dtype, seed=7, device=cuda_device)
    (want,) = torch.autograd.grad(_interpolate(x), x, cot.double())
    before = upsample_linear2x_bwd.launches
    got = upsample_linear2x_bwd(cot)
    again = upsample_linear2x_bwd(cot)
    plain = upsample_linear2x_bwd_plain(cot)
    torch.cuda.synchronize()
    assert upsample_linear2x_bwd.launches == before + 2
    assert got.dtype == dtype and got.shape == (B, S, C)
    assert torch.equal(got, again) and torch.equal(got, plain)
    err = (got.double() - want).abs().max() / want.abs().max()
    assert err <= BWD_TOL[dtype]
    assert _same_layout(got, cot)


def _train_batch(b, s, seed, device):
    r = np.random.default_rng(seed)
    x = lambda *shape: torch.as_tensor(
        r.standard_normal(shape).astype(np.float32), device=device)
    return {"fhr_st": x(1, b, s, 43), "fhr_ph": x(1, b, s, 44),
            "fhr_up_ph": x(1, b, s, 130), "fhr": x(1, b, 16 * s)}


@pytest.mark.cuda
def test_captured_step_launches_upsample_kernels(cuda_device):
    """A captured train step of the published SeqVaeTeb at B=128 (S=300):
    one replay launches the upsample kernels 4 times each way, by the
    counter, and its profiler trace holds their kernels and no
    upsample_linear1d op."""
    from vae_teb_tpu_torch import Trainer, TrainerConfig
    model = init_parameters(SeqVaeTeb(), seed=3)
    trainer = Trainer(model, TrainerConfig(steps_per_execution=1),
                      cuda_device)
    trainer.train_multi_step(_train_batch(128, 300, 1, cuda_device), 1e-5)
    (graph,) = trainer.graphs.values()
    for way in ("fwd", "bwd"):
        assert graph.launches[(f"upsample_linear2x_{way}", "launches")] == 4
        assert graph.launches[(f"upsample_linear2x_{way}",
                               f"upsample_linear2x_{way}_f32")] == 4
    before = launch_counts()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        trainer.train_multi_step(_train_batch(128, 300, 2, cuda_device), 1e-5)
        torch.cuda.synchronize()
    assert graph.replays == 1
    launched = launch_counts() - before
    assert launched[("upsample_linear2x_fwd", "launches")] == 4
    assert launched[("upsample_linear2x_bwd", "launches")] == 4
    names = [e.key for e in prof.key_averages()]
    assert not [n for n in names if "upsample_linear1d" in n]
    for kernel in ("upsample_linear2x_fwd_vec", "upsample_linear2x_bwd_vec"):
        assert [n for n in names if kernel in n], kernel


@pytest.mark.cuda
def test_exported_program_runs_upsample_on_card(cuda_device):
    """`export_inference` of SeqVaeTeb on the card: the program holds the
    upsample as four operator nodes, launches the kernel four times a run,
    and gives the eager forward's outputs."""
    S = 32
    model = init_parameters(SeqVaeTeb(lstm_hidden_dim=8, lstm_num_layers=2,
                                      seq_len=S), seed=0).eval()
    r = np.random.default_rng(4)
    batch = {k: r.standard_normal((2, S, c)).astype(np.float32)
             for k, c in zip(serve.COEFF_KEYS, (43, 44, 130))}
    program = serve.export_inference(model, batch, bundle_params=True,
                                     device=cuda_device)
    assert sum(n.target is OP for n in program.graph.nodes) == 4
    coeffs = tuple(torch.as_tensor(batch[k], device=cuda_device)
                   for k in serve.COEFF_KEYS)
    with torch.inference_mode():
        want = model(*coeffs)
        before = upsample_linear2x_fwd.launches
        got = program.module()(*coeffs)
        torch.cuda.synchronize()
    assert upsample_linear2x_fwd.launches == before + 4
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6)
