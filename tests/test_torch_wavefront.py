"""The wavefront LSTM recurrences: the port's run_lstm_streams and the plain
residual forward and reverse wavefront (the CPU path) against the JAX
package's Pallas kernels in interpret mode, gradients against JAX autodiff
and against float64 finite differences, the packing steps against JAX, and
the CUDA kernels against their plain versions on a card.

JAX is imported inside the tests that compare with it, so the CUDA cases
also run where JAX is not installed:
    python -m pytest tests/test_torch_wavefront.py -m cuda
"""

import numpy as np
import pytest
import torch

from vae_teb_tpu_torch.kernels import (WavefrontFunction, wavefront_bwd,
                                       wavefront_bwd_plain, wavefront_fwd,
                                       wavefront_fwd_plain,
                                       wavefront_recurrence)
from vae_teb_tpu_torch.models.blocks import (LSTMStream, _wavefront_meta,
                                             _wavefront_pack, _wavefront_xs,
                                             run_lstm_streams)

torch.set_num_threads(2)

B, S, H = 3, 17, 8
DEPTHS = (4, 2)   # heterogeneous stream depths


def _stream_arrays(seed, n_layers, b=B, s=S, h=H):
    """Numpy weights, projected inputs and non-zero initial states of one
    stream, as tests/test_models.py builds them."""
    r = np.random.default_rng(seed)
    f32 = lambda *shape: r.standard_normal(shape).astype(np.float32)
    return dict(xp=f32(b, s, 4 * h),
                w_ih=[f32(h if l else 12, 4 * h) * 0.3 for l in range(n_layers)],
                w_hh=[f32(h, 4 * h) * 0.3 for _ in range(n_layers)],
                b=[f32(4 * h) * 0.1 for _ in range(n_layers)],
                h0=[f32(b, h) * 0.2 for _ in range(n_layers)],
                c0=[f32(b, h) * 0.2 for _ in range(n_layers)])


def _streams(cls, wrap, arrays):
    return [cls(wrap(a["xp"]), [wrap(w) for w in a["w_ih"]],
                [wrap(w) for w in a["w_hh"]], [wrap(v) for v in a["b"]],
                (tuple(wrap(h) for h in a["h0"]), tuple(wrap(c) for c in a["c0"])))
            for a in arrays]


def _operands(streams):
    return [{"xs": st.x_proj.swapaxes(0, 1), "w_ih_rest": tuple(st.w_ih[1:]),
             "w_hh": tuple(st.w_hh), "b_rest": tuple(st.biases[1:]),
             "init_h": st.init[0], "init_c": st.init[1]} for st in streams]


ARRAYS = [_stream_arrays(1, DEPTHS[0]), _stream_arrays(2, DEPTHS[1])]


def test_run_lstm_streams_matches_pallas_interpret():
    """Outputs and final states to rtol 1e-5 / atol 1e-6 (fp32, the same
    cell math; only the gate sums' order differs)."""
    import jax.numpy as jnp
    from vae_teb_tpu.models.blocks import LSTMStream as JaxStream
    from vae_teb_tpu.models.blocks import run_lstm_streams as jax_run
    want = jax_run(_streams(JaxStream, jnp.asarray, ARRAYS),
                   schedule="wavefront_pallas")
    got = run_lstm_streams(_streams(LSTMStream, torch.as_tensor, ARRAYS))
    for (ys_w, (h_w, c_w)), (ys_g, (h_g, c_g)) in zip(want, got):
        for w, g in ((ys_w, ys_g), (h_w, h_g), (c_w, c_g)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-6)


def test_pack_and_xs_match_jax():
    """W_eff, the packed biases and xs_wave are data movement: equal."""
    import jax.numpy as jnp
    from vae_teb_tpu.models import blocks as jb
    ops_j = _operands(_streams(jb.LSTMStream, jnp.asarray, ARRAYS))
    ops_t = _operands(_streams(LSTMStream, torch.as_tensor, ARRAYS))
    meta = _wavefront_meta(ops_t)
    H_, depths, offsets, U, D, lvec = meta
    np.testing.assert_array_equal(lvec, jb._wavefront_meta(ops_j)[5])
    K = S + D - 1
    for got, want in zip(_wavefront_pack(ops_t, H_, depths, offsets, U),
                         jb._wavefront_pack(ops_j, H_, depths, offsets, U)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        _wavefront_xs(ops_t, H_, depths, offsets, U, K, S).numpy(),
        np.asarray(jb._wavefront_xs(ops_j, H_, depths, offsets, U, K, S)))


def _recurrence_inputs(seed, b, s, h, depths, dtype=torch.float32,
                       device="cpu"):
    """Random wavefront operands: W_eff, b, xs_wave, h0, c0, lvec."""
    r = np.random.default_rng(seed)
    U = sum(depths)
    UH, K = U * h, s + max(depths) - 1
    lvec = np.concatenate([np.arange(d) for d in depths]).astype(np.int32)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device).to(dtype)
    return (t(r.standard_normal((UH, 4 * UH)) / np.sqrt(UH)),
            t(r.standard_normal(4 * UH) * 0.1),
            t(r.standard_normal((K, b, 4 * UH))),
            t(r.standard_normal((b, UH)) * 0.2),
            t(r.standard_normal((b, UH)) * 0.2),
            torch.as_tensor(lvec, device=device))


def test_plain_bf16_storage_tracks_fp32():
    """bf16 storage rounds h and c every step; the states stay within a
    few bf16 ulps of 1.0 of the fp32 run (loose: 4e-2)."""
    args = _recurrence_inputs(3, B, S, H, DEPTHS)
    h32 = wavefront_fwd_plain(*args, S)
    bf = [a.to(torch.bfloat16) if a.is_floating_point() else a for a in args]
    h16 = wavefront_fwd_plain(*bf, S)
    for a, b in zip(h32, h16):
        assert b.dtype == torch.bfloat16
        assert (a - b.float()).abs().max().item() <= 4e-2


def test_dispatch_by_device():
    """CPU tensors take the plain version without counting a launch; other
    non-CUDA devices raise."""
    args = _recurrence_inputs(4, B, S, H, DEPTHS)
    before = wavefront_fwd.launches
    for got, want in zip(wavefront_fwd(*args, S), wavefront_fwd_plain(*args, S)):
        assert torch.equal(got, want)
    assert wavefront_fwd.launches == before
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no implementation"):
        wavefront_fwd(*meta, S)


def _bwd_inputs(seed, fwd_args, S, dtype=None):
    """Residuals of a plain residual forward on fwd_args, plus random
    cotangents: (W_eff, gates_seq, c_seq, c_prev_seq, dY, dh0, dc0, lvec)."""
    W, b, xs, h0, c0, lvec = fwd_args
    _, _, _, gates_seq, c_seq = wavefront_fwd_plain(W, b, xs, h0, c0, lvec, S,
                                                    with_residuals=True)
    c_prev_seq = torch.cat([c0[None], c_seq[:-1]])
    r = np.random.default_rng(seed)
    K, B_, UH = c_seq.shape
    t = lambda *shape: torch.as_tensor(r.standard_normal(shape).astype(
        np.float32), device=xs.device).to(dtype or xs.dtype)
    return (W, gates_seq, c_seq, c_prev_seq, t(K, B_, UH), t(B_, UH),
            t(B_, UH), lvec)


def test_plain_residual_forward_and_backward_match_pallas_interpret():
    """The plain residual forward against `_wavefront_scan_pallas_local(...,
    with_residuals=True)` and the plain reverse wavefront against
    `wavefront_bwd_pallas`, both in interpret mode: rtol 1e-5 / atol 1e-6
    (fp32, the same arithmetic; only summation order differs)."""
    import jax.numpy as jnp
    from vae_teb_tpu.models.wavefront_pallas import (
        _wavefront_scan_pallas_local, wavefront_bwd_pallas)
    args = _recurrence_inputs(7, B, S, H, DEPTHS)
    W, b, xs, h0, c0, lvec = args
    j = lambda x: jnp.asarray(x.numpy())
    (hf, cf), (gates, hs, cs) = _wavefront_scan_pallas_local(
        j(W), j(b), j(xs), j(h0), j(c0), lvec=lvec.numpy(), S=S,
        with_residuals=True)
    got = wavefront_fwd_plain(*args, S, with_residuals=True)
    for g, w in zip(got, (hs, hf, cf, gates, cs)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    bargs = _bwd_inputs(8, args, S)
    (dhf, dcf), dgates = wavefront_bwd_pallas(
        *(j(x) for x in bargs[:-1]), lvec.numpy(), S)
    got = wavefront_bwd_plain(*bargs, S)
    for g, w in zip(got, (dgates, dhf, dcf)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def _stream_leaves(arrays, wrap):
    """The leaves run_lstm_streams reads, per stream: x_proj, w_ih[1:],
    w_hh, b[1:], h0, c0 (layer 0's w_ih and bias act through x_proj)."""
    return [[wrap(a["xp"]), [wrap(w) for w in a["w_ih"][1:]],
             [wrap(w) for w in a["w_hh"]], [wrap(v) for v in a["b"][1:]],
             [wrap(h) for h in a["h0"]], [wrap(c) for c in a["c0"]]]
            for a in arrays]


def _streams_from_leaves(cls, leaves, arrays, wrap):
    out = []
    for (xp, w_ih, w_hh, bs, h0, c0), a in zip(leaves, arrays):
        out.append(cls(xp, [wrap(a["w_ih"][0])] + list(w_ih), list(w_hh),
                       [wrap(a["b"][0])] + list(bs), (tuple(h0), tuple(c0))))
    return out


def _stream_loss(outs, lib):
    """Reads the outputs and every final state, as
    tests/test_models.py::test_lstm_wavefront_matches_stacked does."""
    (y1, (hf1, cf1)), (y2, (hf2, cf2)) = outs
    return (lib.sum(y1 ** 2) + lib.sum(lib.cos(y2)) + 0.7 * lib.sum(hf1)
            + 0.3 * lib.sum(cf1 ** 2) + 0.1 * lib.sum(hf2) + 0.2 * lib.sum(cf2))


def test_run_lstm_streams_grads_match_jax():
    """Gradients of a loss on ys and the final states, on every leaf of
    both streams (depths 4 and 2), against jax.value_and_grad through the
    JAX package's run_lstm_streams(schedule="wavefront_pallas"): rtol 2e-4 /
    atol 2e-5, the bar tests/test_models.py holds the JAX wavefront
    backward to (fp32; summation order differs across a 20-step reverse
    recurrence)."""
    import jax
    import jax.numpy as jnp
    from vae_teb_tpu.models.blocks import LSTMStream as JaxStream
    from vae_teb_tpu.models.blocks import run_lstm_streams as jax_run

    def jax_loss(leaves):
        return _stream_loss(jax_run(
            _streams_from_leaves(JaxStream, leaves, ARRAYS, jnp.asarray),
            schedule="wavefront_pallas"), jnp)

    j_leaves = _stream_leaves(ARRAYS, jnp.asarray)
    v_want, g_want = jax.value_and_grad(jax_loss)(j_leaves)
    wrap = lambda a: torch.tensor(a, requires_grad=True)
    t_leaves = _stream_leaves(ARRAYS, wrap)
    v_got = _stream_loss(run_lstm_streams(_streams_from_leaves(
        LSTMStream, t_leaves, ARRAYS, torch.as_tensor)), torch)
    v_got.backward()
    np.testing.assert_allclose(v_got.item(), float(v_want), rtol=1e-5)
    flat_t = jax.tree_util.tree_leaves(t_leaves)
    flat_j = jax.tree_util.tree_leaves(g_want)
    assert len(flat_t) == len(flat_j) == sum(5 * d - 1 for d in DEPTHS)
    for t, w in zip(flat_t, flat_j):
        assert t.grad is not None and t.grad.shape == w.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5)


def test_run_lstm_streams_function_grads_match_plain_autograd():
    """The same gradients through the hand-written backward and through
    PyTorch autograd of the plain forward loop: rtol 1e-5 / atol 1e-6
    (fp32, the same arithmetic in another order)."""
    grads = []
    for recurrence in (wavefront_recurrence, wavefront_fwd_plain):
        leaves = _stream_leaves(ARRAYS, lambda a: torch.tensor(
            a, requires_grad=True))
        _stream_loss(run_lstm_streams(
            _streams_from_leaves(LSTMStream, leaves, ARRAYS, torch.as_tensor),
            recurrence=recurrence), torch).backward()
        grads.append([t.grad for t in torch.utils._pytree.tree_leaves(leaves)])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_wavefront_function_gradcheck():
    """torch.autograd.gradcheck of WavefrontFunction in float64 (finite
    differences, gradcheck's default tolerances) at a tiny size with a
    2-layer and a 1-layer stream, so warm-up, drain and the feed cotangent
    of an invalid unit are all exercised."""
    r = np.random.default_rng(9)
    depths, h, b, s = (2, 1), 2, 2, 4
    U = sum(depths)
    UH, K = U * h, s + max(depths) - 1
    lvec = torch.as_tensor(np.concatenate([np.arange(d) for d in depths]),
                           dtype=torch.int32)
    leaf = lambda shape, scale: torch.tensor(
        r.standard_normal(shape) * scale, dtype=torch.float64,
        requires_grad=True)
    args = (leaf((UH, 4 * UH), 0.5), leaf(4 * UH, 0.1), leaf((K, b, 4 * UH), 1.0),
            leaf((b, UH), 0.3), leaf((b, UH), 0.3))
    assert torch.autograd.gradcheck(
        lambda *a: WavefrontFunction.apply(*a, lvec, s), args)


def test_wavefront_records_residuals_only_for_gradients():
    """Without a gradient to record, `wavefront_recurrence` is the
    residual-free forward and builds no graph; with one, it is
    WavefrontFunction."""
    args = _recurrence_inputs(10, B, S, H, DEPTHS)
    with torch.no_grad():
        out = wavefront_recurrence(*args, S)
    assert all(o.grad_fn is None for o in out)
    w = args[0].clone().requires_grad_(True)
    out = wavefront_recurrence(w, *args[1:], S)
    assert "WavefrontFunction" in type(out[0].grad_fn).__name__
    for g, p in zip(out, wavefront_fwd_plain(*args, S)):
        assert torch.equal(g.detach(), p)


def test_bwd_dispatch_by_device():
    """CPU tensors take the plain reverse wavefront without counting a
    launch, and so does the residual forward; other non-CUDA devices
    raise."""
    args = _recurrence_inputs(11, B, S, H, DEPTHS)
    bargs = _bwd_inputs(12, args, S)
    before = (wavefront_fwd.residual_launches, wavefront_bwd.launches)
    for got, want in zip(wavefront_bwd(*bargs, S), wavefront_bwd_plain(*bargs, S)):
        assert torch.equal(got, want)
    wavefront_fwd(*args, S, with_residuals=True)
    assert (wavefront_fwd.residual_launches, wavefront_bwd.launches) == before
    with pytest.raises(ValueError, match="no implementation"):
        wavefront_bwd(*[a.to("meta") for a in bargs], S)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("depths,h,b,s", [((4, 4), 64, 32, 300),
                                          ((4, 2), 64, 5, 40),
                                          ((4, 2), 8, 3, 17)])
def test_kernel_matches_plain(cuda_device, dtype, tol, depths, h, b, s):
    """The CUDA kernel against its plain version on the card: max-abs 1e-5
    in fp32, 1.6e-2 (two bf16 ulps at 1.0) in bf16 storage."""
    args = _recurrence_inputs(5, b, s, h, depths, dtype, cuda_device)
    before = wavefront_fwd.launches
    got = wavefront_fwd(*args, s)
    torch.cuda.synchronize()
    assert wavefront_fwd.launches == before + 1
    want = wavefront_fwd_plain(*args, s)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= tol




@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("depths,h,b,s", [((4, 4), 64, 32, 300),
                                          ((4, 2), 64, 5, 40),
                                          ((4, 2), 8, 3, 17)])
def test_residual_kernel_matches_plain(cuda_device, dtype, tol, depths, h, b,
                                       s):
    """The residual forward kernel against its plain version, all five
    outputs: max-abs 1e-5 in fp32, 1.6e-2 in bf16 storage; the stored
    pre-activation gates, which reach |g| ~ 8, per element to tol *
    max(1, |g|) (the same two bf16 ulps at each value's scale: a sum taken
    in another order can round to the neighbouring bf16 value, 0.03125
    apart in [4, 8))."""
    args = _recurrence_inputs(13, b, s, h, depths, dtype, cuda_device)
    before = wavefront_fwd.residual_launches
    got = wavefront_fwd(*args, s, with_residuals=True)
    torch.cuda.synchronize()
    assert wavefront_fwd.residual_launches == before + 1
    want = wavefront_fwd_plain(*args, s, with_residuals=True)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == dtype and g.shape == w.shape
        scale = w.float().abs().clamp_min(1.0) if i == 3 else 1.0
        assert ((g.float() - w.float()).abs() / scale).max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("depths,h,b,s", [((4, 4), 64, 32, 300),
                                          ((4, 2), 64, 5, 40),
                                          ((4, 2), 8, 3, 17)])
def test_bwd_kernel_matches_plain(cuda_device, dtype, tol, depths, h, b, s):
    """The reverse-wavefront kernel against its plain version on the same
    residuals: dgates_seq, dh_fin and dc_fin within tol * max|plain| (fp32
    1e-5; bf16 3e-2: the carried dh, dc and the dgates are re-rounded to
    bf16 every step, on both sides, after sums taken in another order)."""
    args = _recurrence_inputs(14, b, s, h, depths, dtype, cuda_device)
    bargs = _bwd_inputs(15, args, s)
    before = wavefront_bwd.launches
    got = wavefront_bwd(*bargs, s)
    torch.cuda.synchronize()
    assert wavefront_bwd.launches == before + 1
    want = wavefront_bwd_plain(*bargs, s)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_gradients_flow_through_the_kernels(cuda_device):
    """run_lstm_streams on the card: gradients through the kernels (one
    residual forward, one backward launch) against autograd of the plain
    loop on the card, every leaf within 1e-4 of its max (fp32)."""
    arrays = [_stream_arrays(1, 4, b=8, s=60, h=64),
              _stream_arrays(2, 4, b=8, s=60, h=64)]
    grads = []
    for recurrence in (wavefront_recurrence, wavefront_fwd_plain):
        leaves = _stream_leaves(arrays, lambda a: torch.tensor(
            a, device=cuda_device, requires_grad=True))
        before = (wavefront_fwd.residual_launches, wavefront_bwd.launches)
        _stream_loss(run_lstm_streams(
            _streams_from_leaves(LSTMStream, leaves, arrays,
                                 lambda a: torch.as_tensor(a, device=cuda_device)),
            recurrence=recurrence), torch).backward()
        torch.cuda.synchronize()
        launched = (wavefront_fwd.residual_launches - before[0],
                    wavefront_bwd.launches - before[1])
        kernels = recurrence is wavefront_recurrence
        assert launched == ((1, 1) if kernels else (0, 0))
        grads.append([t.grad for t in torch.utils._pytree.tree_leaves(leaves)])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
