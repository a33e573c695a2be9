"""LayerNorm over the last axis (`kernels.layer_norm`, `models.blocks.
LayerNorm`): on the CPU, the module against nn.LayerNorm bit for bit, the
plain forward and gradient against float64 autograd through F.layer_norm,
`LayerNormFunction`'s gradients, the wrapper's refusals and the launch
bookkeeping, the operator that tracing records. Marked `cuda`: the
kernel pair of `kernels/layer_norm.cu` against the plain version on the
card, its backward's determinism, the module's two paths and an exported
program, which skip elsewhere. This file imports no JAX, so it runs on
the card too:
`python -m pytest tests/test_torch_layer_norm.py -m cuda`.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from vae_teb_tpu_torch.kernels import (LayerNormFunction, launch_counts,
                                       layer_norm_bwd, layer_norm_bwd_plain,
                                       layer_norm_fwd, layer_norm_fwd_plain,
                                       layer_norm_op, layer_norm_rows)
from vae_teb_tpu_torch.models.blocks import LAYER_NORM_EPS, LayerNorm

torch.set_num_threads(2)

EPS = LAYER_NORM_EPS


def _rows(shape, seed, dtype=torch.float64, device="cpu", scale=3.0,
          offset=1.0):
    """Seeded normal rows, scaled and shifted (the centering has work)."""
    x = np.random.default_rng(seed).standard_normal(shape) * scale + offset
    return torch.as_tensor(x, dtype=dtype, device=device)


def _params(width, seed, dtype=torch.float64, device="cpu"):
    """(gamma, beta) near (1, 0)."""
    return (1 + 0.1 * _rows((width,), seed, dtype, device, 1.0, 0.0),
            0.1 * _rows((width,), seed + 1, dtype, device, 1.0, 0.0))


def _module(width, dtype, seed):
    """blocks.LayerNorm and nn.LayerNorm with the same seeded parameters."""
    ours, ref = LayerNorm(width, dtype), nn.LayerNorm(width, eps=EPS)
    gamma, beta = _params(width, seed, torch.float32)
    with torch.no_grad():
        for m in (ours, ref):
            m.weight.copy_(gamma)
            m.bias.copy_(beta)
    return ours, ref


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 16), (3, 130), (2, 4800), (7,)])
def test_module_is_nn_layer_norm_on_cpu(shape, dtype):
    """On the CPU, blocks.LayerNorm gives nn.LayerNorm's output and
    gradients bit for bit (with a compute dtype, nn.LayerNorm of the
    float32 input, cast after), and launches nothing."""
    ours, ref = _module(shape[-1], dtype, seed=sum(shape))
    x = _rows(shape, 1, torch.float32)
    if dtype is not None:
        x = x.to(dtype)
    before = launch_counts()
    outs, grads = [], []
    for m in (ours, ref):
        xi = x.clone().requires_grad_(True)
        y = m(xi) if m is ours else m(xi.float()).to(x.dtype)
        cot = _rows(shape, 2, y.dtype)
        grads.append(torch.autograd.grad(y, (xi, m.weight, m.bias), cot))
        outs.append(y)
    assert outs[0].dtype == x.dtype
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert launch_counts() == before


@pytest.mark.parametrize("width, rows", [(1, 1), (3, 4), (16, 300),
                                         (33, 1), (130, 300)])
def test_plain_matches_autograd(width, rows):
    """In float64 the plain forward is F.layer_norm with the biased,
    centered statistics, and the plain gradient equals autograd through
    F.layer_norm (within summation order), dx left out on request; the
    CPU wrappers are the plain versions."""
    x = _rows((rows, width), width).requires_grad_(True)
    gamma, beta = (p.requires_grad_(True) for p in _params(width, rows))
    y = F.layer_norm(x, (width,), gamma, beta, EPS)
    dy = _rows((rows, width), 7 + width, scale=1.0, offset=0.5)
    want = torch.autograd.grad(y, (x, gamma, beta), dy)
    y_plain, mean, rstd = layer_norm_fwd_plain(x.detach(), gamma.detach(),
                                               beta.detach(), EPS)
    assert torch.equal(y_plain, y.detach())
    xd = x.detach()
    torch.testing.assert_close(mean, xd.mean(-1), rtol=0, atol=1e-14)
    torch.testing.assert_close(
        rstd, 1 / torch.sqrt(xd.var(-1, unbiased=False) + EPS),
        rtol=1e-13, atol=0)
    got = layer_norm_bwd_plain(xd, dy, mean, rstd, gamma.detach())
    for g, w in zip(got, want):   # float64 sums over up to 300 rows
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-10)
    assert layer_norm_bwd_plain(xd, dy, mean, rstd, gamma.detach(),
                                need_dx=False)[0] is None
    assert all(torch.equal(a, b) for a, b in zip(
        layer_norm_fwd(xd, gamma.detach(), beta.detach(), EPS),
        (y_plain, mean, rstd)))
    assert all(torch.equal(a, b) for a, b in zip(
        layer_norm_bwd(xd, dy, mean, rstd, gamma.detach()), got))


@pytest.mark.parametrize("needs", [(True, True, True), (False, True, True),
                                   (True, False, False)])
def test_function_gradients(needs):
    """`LayerNormFunction` (on the CPU, over the plain versions) gives
    autograd's gradients through F.layer_norm in float64, and None for an
    input that asks for none; `layer_norm_rows` is the Function when a
    gradient is recorded and the bare forward otherwise."""
    x = _rows((2, 3, 9), 3)
    gamma, beta = _params(9, 4)
    for t, need in zip((x, gamma, beta), needs):
        t.requires_grad_(need)
    dy = _rows((2, 3, 9), 5, scale=1.0, offset=0.0)
    y = LayerNormFunction.apply(x, gamma, beta, EPS)
    want = F.layer_norm(x, (9,), gamma, beta, EPS)
    assert torch.equal(y, want)
    inputs = [t for t in (x, gamma, beta) if t.requires_grad]
    for g, w in zip(torch.autograd.grad(y, inputs, dy),
                    torch.autograd.grad(want, inputs, dy)):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    assert layer_norm_rows(x, gamma, beta, EPS).grad_fn is not None
    with torch.no_grad():
        assert torch.equal(layer_norm_rows(x, gamma, beta, EPS), want)


def _fake(shape, dtype=torch.float32, device="cuda"):
    return torch.empty(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("case", ["meta", "float64", "bfloat16",
                                  "bf16_params", "gamma_width", "beta_width",
                                  "bwd_gamma_width", "params_device",
                                  "bwd_dy_float64", "bwd_stats_device"])
def test_refuses_what_the_kernel_does_not_take(case):
    """The wrappers raise on a device other than the CPU and CUDA, on CUDA
    storage other than float32 (rows, parameters, the output gradient),
    on a gamma or beta whose width differs from the last axis, and on a
    parameter or row statistics on another device; nothing is launched
    (fake CUDA tensors: the checks come before any launch)."""
    before = launch_counts()
    with FakeTensorMode(allow_non_fake_inputs=True):
        x, w = _fake((4, 8)), _fake((8,))
        args, error = {
            "meta": ((_fake((4, 8), device="meta"), _fake((8,), device="meta"),
                      _fake((8,), device="meta")), ValueError),
            "float64": ((_fake((4, 8), torch.float64), w, w), TypeError),
            "bfloat16": ((_fake((4, 8), torch.bfloat16), w, w), TypeError),
            "bf16_params": ((x, _fake((8,), torch.bfloat16), w), TypeError),
            "gamma_width": ((x, _fake((7,)), w), ValueError),
            "beta_width": ((x, w, _fake((9,))), ValueError),
            "bwd_gamma_width": ((x, x, _fake((4,)), _fake((4,)),
                                 _fake((6,))), ValueError),
            "params_device": ((x, torch.ones(8), w), ValueError),
            "bwd_dy_float64": ((x, _fake((4, 8), torch.float64),
                                _fake((4,)), _fake((4,)), w), TypeError),
            "bwd_stats_device": ((x, x, torch.zeros(4), _fake((4,)), w),
                                 ValueError)}[case]
        with pytest.raises(error):
            if case.startswith("bwd_"):
                layer_norm_bwd(*args)
            else:
                layer_norm_fwd(*args, EPS)
    assert launch_counts() == before


def test_traced_module_records_the_operator():
    """While tracing the module calls the operator
    `vae_teb_tpu_torch::layer_norm`: its fake implementation gives the
    output's shape and strides on fake CUDA tensors (opcheck on the CPU);
    `torch.export` of the module (with a bf16 compute dtype) holds it as
    one node, and the program gives the live module's bits on the CPU and
    launches nothing."""
    before = launch_counts()
    with FakeTensorMode():
        y = layer_norm_op(torch.empty(3, 16, device="cuda").t(),
                          torch.ones(3, device="cuda"),
                          torch.zeros(3, device="cuda"), EPS)
        assert y.shape == (16, 3) and y.is_contiguous() and y.is_cuda
    x = _rows((2, 5, 16), 9, torch.float32)
    gamma, beta = _params(16, 10, torch.float32)
    torch.library.opcheck(layer_norm_op, (x, gamma, beta, EPS))
    m = _module(16, torch.bfloat16, seed=11)[0].eval()
    with torch.no_grad():
        program = torch.export.export(m, (x.bfloat16(),))
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count(torch.ops.vae_teb_tpu_torch.layer_norm.default) \
        == 1, targets
    assert not any("aten.layer_norm" in str(t) or "native_layer_norm"
                   in str(t) for t in targets), targets
    with torch.no_grad():
        assert torch.equal(program.module()(x.bfloat16()), m(x.bfloat16()))
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# the kernel pair on the card
# ---------------------------------------------------------------------------

# widths: one lane a row (1, 3), several rows a warp (16, 32, 33, 64), a
# warp a row with 4 to 32 values a lane (130, 458, 513, 1024), a block a
# row (4800); the main path's rows: B * S = 38,400 and the raw heads' 128
# (here 1 and 4)
CARD_WIDTHS = [1, 3, 16, 32, 33, 64, 130, 458, 513, 1024, 4800]
CARD_ROWS = [1, 4, 38400]
# The kernel's error against the float64 plain version, of max|float64|,
# is held to 4x that of PyTorch's own float32 LayerNorm (forward and
# autograd) on the same inputs, or FLOOR where that is smaller: both round
# in float32, in other orders (the column sums add 38,400 terms of both
# signs, whose rounding grows with the row count).
LIBRARY_FACTOR, FLOOR = 4.0, 2e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    return torch.device("cuda")


def _err(got, want):
    return ((got.double() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", CARD_ROWS)
@pytest.mark.parametrize("width", CARD_WIDTHS)
def test_kernel_matches_plain_on_card(cuda_device, width, rows):
    """Forward (y, mean, rstd) and backward (dx, dgamma, dbeta) against the
    float64 plain version, each within the bar above; the backward without
    dx gives the same column sums; one launch of each entry point a
    call."""
    d = cuda_device
    x = _rows((rows, width), width + rows, torch.float32, d)
    gamma, beta = _params(width, width, torch.float32, d)
    dy = _rows((rows, width), 3 * width + rows, torch.float32, d, 1.0, 0.2)
    x64, g64, b64, dy64 = (t.double() for t in (x, gamma, beta, dy))
    want_fwd = layer_norm_fwd_plain(x64, g64, b64, EPS)
    want_bwd = layer_norm_bwd_plain(x64, dy64, *want_fwd[1:], g64)
    # PyTorch's float32 LayerNorm, the yardstick of the bar
    xl, gl, bl = (t.clone().requires_grad_(True) for t in (x, gamma, beta))
    yl = F.layer_norm(xl, (width,), gl, bl, EPS)
    lib = (yl.detach(),) + torch.autograd.grad(yl, (xl, gl, bl), dy)
    before = launch_counts()
    y, mean, rstd = layer_norm_fwd(x, gamma, beta, EPS)
    dx, dgamma, dbeta = layer_norm_bwd(x, dy, mean, rstd, gamma)
    _, dgamma2, dbeta2 = layer_norm_bwd(x, dy, mean, rstd, gamma,
                                        need_dx=False)
    torch.cuda.synchronize()
    launched = launch_counts() - before
    assert launched == {("layer_norm_fwd", "launches"): 1,
                        ("layer_norm_fwd", "layer_norm_fwd_f32"): 1,
                        ("layer_norm_bwd", "launches"): 2,
                        ("layer_norm_bwd", "layer_norm_bwd_f32"): 2}
    assert torch.equal(dgamma, dgamma2) and torch.equal(dbeta, dbeta2)
    for name, got, want, library in (
            ("y", y, want_fwd[0], lib[0]), ("dx", dx, want_bwd[0], lib[1]),
            ("dgamma", dgamma, want_bwd[1], lib[2]),
            ("dbeta", dbeta, want_bwd[2], lib[3])):
        bar = max(LIBRARY_FACTOR * _err(library, want), FLOOR)
        assert _err(got, want) <= bar, (name, _err(got, want), bar)
    for got, want in zip((mean, rstd), want_fwd[1:]):
        assert _err(got, want) <= FLOOR


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(38400, 16), (38400, 37), (38400, 130),
                                   (38400, 458), (128, 4800)])
def test_backward_is_deterministic_on_card(cuda_device, shape):
    """Two runs of the forward and of the backward give the same bits: the
    column sums take no atomics."""
    d = cuda_device
    x = _rows(shape, 11, torch.float32, d)
    dy = _rows(shape, 12, torch.float32, d, 1.0, 0.0)
    gamma, beta = _params(shape[1], 13, torch.float32, d)
    runs = []
    for _ in range(2):
        y, mean, rstd = layer_norm_fwd(x, gamma, beta, EPS)
        runs.append((y, mean, rstd) + layer_norm_bwd(x, dy, mean, rstd,
                                                     gamma))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_module_on_card(cuda_device, dtype):
    """blocks.LayerNorm on the card: with a gradient, `LayerNormFunction`
    (one forward and one backward launch), close to nn.LayerNorm on the
    card (the bar above; bf16 outputs within an ulp); without one, the
    forward alone, with no row statistics, equal to the Function's output."""
    ours, ref = _module(130, dtype, seed=5)
    ours, ref = ours.to(cuda_device), ref.to(cuda_device)
    x = _rows((128, 300, 130), 6, torch.float32, cuda_device)
    if dtype is not None:
        x = x.to(dtype)
    dy = _rows((128, 300, 130), 7, x.dtype, cuda_device, 1.0, 0.0)
    before = launch_counts()
    xi = x.clone().requires_grad_(True)
    y = ours(xi)
    got = torch.autograd.grad(y, (xi, ours.weight, ours.bias), dy)
    launched = launch_counts() - before
    assert launched[("layer_norm_fwd", "launches")] == 1
    assert launched[("layer_norm_bwd", "launches")] == 1
    xr = x.clone().requires_grad_(True)
    yr = ref(xr.float()).to(x.dtype)
    want = torch.autograd.grad(yr, (xr, ref.weight, ref.bias), dy)
    assert y.dtype == x.dtype
    ulp = 2.0 ** -7 if dtype is not None else 1e-5
    assert _err(y.float(), yr.double()) <= ulp
    for g, w in zip(got, want):
        assert _err(g.float(), w.double()) <= ulp
    before = launch_counts()
    with torch.inference_mode():
        assert torch.equal(ours(x), y.detach())
    assert launch_counts() - before == {
        ("layer_norm_fwd", "launches"): 1,
        ("layer_norm_fwd", "layer_norm_fwd_f32"): 1}


@pytest.mark.cuda
def test_exported_module_runs_the_kernel_on_card(cuda_device):
    """An exported program of blocks.LayerNorm, traced on the card, holds
    the operator, launches the forward entry once a run, and gives the
    live module's bits."""
    m = LayerNorm(64).to(cuda_device).eval()
    x = _rows((32, 64), 8, torch.float32, cuda_device)
    with torch.no_grad():
        program = torch.export.export(m, (x,))
    before = launch_counts()
    with torch.inference_mode():
        got = program.module()(x)
    torch.cuda.synchronize()
    assert launch_counts() - before == {
        ("layer_norm_fwd", "launches"): 1,
        ("layer_norm_fwd", "layer_norm_fwd_f32"): 1}
    with torch.inference_mode():
        assert torch.equal(got, m(x))
