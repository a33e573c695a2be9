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
from vae_teb_tpu_torch.kernels.wavefront import (_block_index, _bwd_layout,
                                                 _fwd_layout, _launch_plan,
                                                 unit_blocks)
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


def _lvec(depths):
    return np.concatenate([np.arange(d) for d in depths]).astype(np.int32)


def _block_mask(depths, h):
    """(UH, 4UH) 0/1 mask of the blocks `_wavefront_pack` fills: each unit's
    recurrent block and, for a unit of layer >= 1, its feed block from the
    unit below."""
    lvec = _lvec(depths)
    U = len(lvec)
    mask = np.zeros((U, h, 4, U, h), np.float32)
    for u in range(U):
        mask[u, :, :, u] = 1
        if lvec[u] > 0:
            mask[u - 1, :, :, u] = 1
    return mask.reshape(U * h, 4 * U * h)


def _recurrence_inputs(seed, b, s, h, depths, dtype=torch.float32,
                       device="cpu"):
    """Random wavefront operands: W_eff, b, xs_wave, h0, c0, lvec. W_eff is
    masked to the packed block structure, the only entries the kernels
    read, so kernel and plain version compute the same function."""
    r = np.random.default_rng(seed)
    U = sum(depths)
    UH, K = U * h, s + max(depths) - 1
    lvec = _lvec(depths)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device).to(dtype)
    return (t(r.standard_normal((UH, 4 * UH)) * _block_mask(depths, h)
              / np.sqrt(2 * h)),
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


PACK_DEPTHS = [(4, 4), (4, 2), (1, 3)]


@pytest.mark.parametrize("depths", PACK_DEPTHS)
def test_unit_blocks_rebuild_the_packed_weight(depths):
    """The blocks the kernels keep resident, put back into a zero W_eff,
    reproduce `_wavefront_pack`'s W_eff exactly: from the forward's Wf
    (recurrent over feed-in block) and from the backward's Wb (row block:
    recurrent beside feed-out block). The plain forward and backward on the
    rebuilt W_eff then equal those on the packed one."""
    arrays = [_stream_arrays(20 + i, d) for i, d in enumerate(depths)]
    ops = _operands(_streams(LSTMStream, torch.as_tensor, arrays))
    H_, depths_, offsets, U, D, lvec = _wavefront_meta(ops)
    W, b = _wavefront_pack(ops, H_, depths_, offsets, U)
    lvec = torch.as_tensor(lvec)
    wf, wb = unit_blocks(W, lvec)
    assert wf.shape == (U, 2 * H, 4 * H) and wb.shape == (U, H, 8 * H)
    from_f = torch.zeros(U, H, 4, U, H)
    from_b = torch.zeros(U, H, 4, U, H)
    for u in range(U):
        from_f[u, :, :, u] = wf[u, :H].view(H, 4, H)
        from_b[u, :, :, u] = wb[u, :, :4 * H].view(H, 4, H)
        if lvec[u] > 0:
            from_f[u - 1, :, :, u] = wf[u, H:].view(H, 4, H)
        else:
            assert not wf[u, H:].any()
        if u + 1 < U and lvec[u + 1] > 0:
            from_b[u, :, :, u + 1] = wb[u, :, 4 * H:].view(H, 4, H)
        else:
            assert not wb[u, :, 4 * H:].any()
    for rebuilt in (from_f, from_b):
        assert torch.equal(rebuilt.view(W.shape), W)
    K = S + D - 1
    xs = _wavefront_xs(ops, H_, depths_, offsets, U, K, S)
    h0 = torch.cat([h for op in ops for h in op["init_h"]], -1)
    c0 = torch.cat([c for op in ops for c in op["init_c"]], -1)
    fwd = lambda w: wavefront_fwd_plain(w, b, xs, h0, c0, lvec, S,
                                        with_residuals=True)
    for got, want in zip(fwd(from_f.view(W.shape)), fwd(W)):
        assert torch.equal(got, want)
    bargs = _bwd_inputs(21, (W, b, xs, h0, c0, lvec), S)
    for got, want in zip(wavefront_bwd_plain(from_b.view(W.shape), *bargs[1:], S),
                         wavefront_bwd_plain(*bargs, S)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("depths", PACK_DEPTHS)
def test_unit_blocks_give_the_step_products(depths):
    """What each CTA computes from its resident blocks equals the dense
    step products on structured input (fp32, 1e-6 / 1e-5: only the sum's
    order differs): the forward's gates of unit u from [h_u | h_{u-1}] @
    Wf[u], and the reverse wavefront's dz of unit u from [dgates_u |
    dgates_{u+1}] @ Wb[u]^T."""
    W, _, _, _, _, lvec = _recurrence_inputs(22, B, S, H, depths)
    U = len(lvec)
    wf, wb = unit_blocks(W, lvec)
    r = np.random.default_rng(23)
    h = torch.as_tensor(r.standard_normal((B, U, H)).astype(np.float32))
    dg = torch.as_tensor(r.standard_normal((B, 4, U, H)).astype(np.float32))
    gates = (h.reshape(B, -1) @ W).view(B, 4, U, H)
    dz = (dg.reshape(B, -1) @ W.t()).view(B, U, H)
    for u in range(U):
        below = h[:, u - 1] if u else torch.zeros(B, H)
        got = (torch.cat([h[:, u], below], 1) @ wf[u]).view(B, 4, H)
        np.testing.assert_allclose(got.numpy(), gates[:, :, u].numpy(),
                                   rtol=1e-5, atol=1e-6)
        above = dg[:, :, u + 1] if u + 1 < U else torch.zeros(B, 4, H)
        got = torch.cat([dg[:, :, u].reshape(B, -1), above.reshape(B, -1)],
                        1) @ wb[u].t()
        np.testing.assert_allclose(got.numpy(), dz[:, u].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_kernel_weight_layouts():
    """The shared-memory layouts the kernels index: wavefront_fwd.cu's
    thread t reads Wf[u][4 d4 + e, q H + t] at ((d4 4 + e) H + t) 4 + q,
    and wavefront_bwd.cu reads Wb[u][t, d] at d H + t."""
    U, H_ = 3, 8
    wf = torch.arange(U * 2 * H_ * 4 * H_, dtype=torch.float32).view(
        U, 2 * H_, 4 * H_)
    wb = torch.arange(U * H_ * 8 * H_, dtype=torch.float32).view(U, H_, 8 * H_)
    kf = _fwd_layout(wf).view(U, -1)
    kb = _bwd_layout(wb).view(U, -1)
    for u in range(U):
        for t in range(H_):
            for d in range(2 * H_):
                for q in range(4):
                    assert kf[u, ((d // 4 * 4 + d % 4) * H_ + t) * 4 + q] == \
                        wf[u, d, q * H_ + t]
            for d in range(8 * H_):
                assert kb[u, d * H_ + t] == wb[u, t, d]


@pytest.mark.parametrize("depths", PACK_DEPTHS)
def test_block_index_gathers_the_kernel_layouts(depths):
    """The one gather the CUDA wrappers make per call, W_eff.view(-1)[idx],
    gives `_fwd_layout(Wf)` and `_bwd_layout(Wb)` wherever the kernels
    read: a unit's whole slab when it has a feed block (forward: lvec[u] >
    0; backward: lvec[u+1] > 0), its first half (the recurrent block)
    otherwise."""
    W, _, _, _, _, lvec = _recurrence_inputs(24, B, S, H, depths)
    U = len(lvec)
    idx_f, idx_b = _block_index(U, H, W.device)
    wf, wb = unit_blocks(W, lvec)
    for idx, want, fed in ((idx_f, _fwd_layout(wf), lvec > 0),
                           (idx_b, _bwd_layout(wb),
                            torch.cat([lvec[1:] > 0, torch.zeros(1, dtype=bool)]))):
        got = W.view(-1)[idx].view(U, -1)
        want = want.view(U, -1)
        n = want.shape[1] // 2
        for u in range(U):
            cols = slice(None) if fed[u] else slice(0, n)
            assert torch.equal(got[u, cols], want[u, cols])


@pytest.mark.parametrize("b,rows,clusters", [(1, 1, 1), (8, 1, 8),
                                             (32, 2, 16), (128, 8, 16)])
def test_launch_plan(b, rows, clusters):
    """Rows per cluster: the fewest with which the ceil(B/M) clusters of
    U=8 CTAs are resident at once, by default one CTA per SM of 132 (16
    clusters); a card that holds 15 (the H100's cluster residency, which
    the wrappers ask the card for) takes M = 3 at B=32 and 9 at B=128. The
    shared memory mirrors the kernels' layout (fp32, H=64: 128 KB of
    weights plus the buffers)."""
    plan = _launch_plan(b, 8, 64, torch.float32)
    assert (plan.rows, plan.clusters) == (rows, clusters)
    base = 16 + 8 * 64 * 64 * 4      # two mbarriers, the weights
    assert plan.fwd_smem == base + rows * (2 * 128 * 4 + 2 * 256 * 4
                                           + 16 * 64 * 4)
    assert plan.bwd_smem == base + rows * (2 * 512 * 4 + 7 * 64 * 4
                                           + 16 * 64 * 4)
    held15 = _launch_plan(b, 8, 64, torch.float32, lambda *a: 15)
    assert held15.rows == {1: 1, 8: 1, 32: 3, 128: 9}[b]
    assert held15.clusters <= 15 and held15.bwd_smem <= 232448
    bf16 = _launch_plan(b, 8, 64, torch.bfloat16)
    assert bf16.rows == rows and bf16.fwd_smem < plan.fwd_smem
    # no M fits at once: the largest the shared memory takes, in waves
    waves = _launch_plan(4096, 8, 64, torch.float32)
    assert waves.rows == 10 and waves.bwd_smem <= 232448


def test_launch_plan_refuses():
    """What the kernels do not take: more units than a portable cluster
    (8), a hidden size that is not a multiple of 8, shared memory over 227
    KB (H=128 fp32: 512 KB of weights), or more than the 256 threads a CTA
    the kernels are built for (H=72: 288)."""
    _launch_plan(32, 6, 8, torch.float32)          # the tests' shape
    with pytest.raises(ValueError, match="units"):
        _launch_plan(32, 9, 64, torch.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        _launch_plan(32, 8, 12, torch.float32)
    with pytest.raises(ValueError, match="shared"):
        _launch_plan(32, 8, 128, torch.float32)
    with pytest.raises(ValueError, match="threads"):
        _launch_plan(32, 8, 72, torch.float32)
    with pytest.raises(TypeError):
        _launch_plan(32, 8, 64, torch.float64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (depths, H, B, S): the main path's shape at B = 32, 128 and 1 (rows per
# cluster 2, 8, 1), ragged cluster groups, and a narrow 4+2-layer stack
CUDA_CASES = [((4, 4), 64, 32, 300), ((4, 4), 64, 128, 300),
              ((4, 4), 64, 1, 300), ((4, 2), 64, 5, 40), ((4, 2), 8, 3, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("depths,h,b,s", CUDA_CASES)
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
@pytest.mark.parametrize("depths,h,b,s", CUDA_CASES)
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
@pytest.mark.parametrize("depths,h,b,s", CUDA_CASES)
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
