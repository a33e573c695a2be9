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


def _stream_arrays(seed, n_layers, b=B, s=S, h=H, w_scale=0.3):
    """Numpy weights, projected inputs and non-zero initial states of one
    stream, as tests/test_models.py builds them."""
    r = np.random.default_rng(seed)
    f32 = lambda *shape: r.standard_normal(shape).astype(np.float32)
    return dict(xp=f32(b, s, 4 * h),
                w_ih=[f32(h if l else 12, 4 * h) * w_scale
                      for l in range(n_layers)],
                w_hh=[f32(h, 4 * h) * w_scale for _ in range(n_layers)],
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
    """What the cluster kernels do not take goes to the grid kernels: more
    units than a portable cluster (8), shared memory over 227 KB (H=128
    fp32: 512 KB of weights), or more than the 256 threads a CTA the
    cluster kernels are built for (H=72: 288). What no kernel takes
    raises: a hidden size that is not a multiple of 8, a storage dtype
    other than float32 or bfloat16, and more grid CTAs than the card
    holds at once."""
    assert _launch_plan(32, 6, 8, torch.float32).kind == "cluster"  # tests'
    for U, H in ((9, 64), (8, 128), (8, 72)):
        assert _launch_plan(32, U, H, torch.float32).kind == "grid"
    with pytest.raises(ValueError, match="multiple of 8"):
        _launch_plan(32, 8, 12, torch.float32)
    with pytest.raises(TypeError):
        _launch_plan(32, 8, 64, torch.float64)
    with pytest.raises(ValueError, match="no kernel takes"):
        _launch_plan(32, 40, 256, torch.float32)


def _up128(x):
    return -(-x // 128) * 128


@pytest.mark.parametrize("U,H,dtype,cols,ctas", [
    (3, 256, torch.float32, 8, 96), (2, 256, torch.bfloat16, 8, 64),
    (8, 128, torch.float32, 8, 128), (10, 64, torch.bfloat16, 8, 80),
    (9, 64, torch.float32, 8, 72)])
def test_grid_launch_plan(U, H, dtype, cols, ctas):
    """The grid plan: the fewest columns N (of 8, 16, 32) whose CTAs fit
    the shared memory, in the largest clusters (8, 4, 2, 1 CTAs of one
    unit) with which all U * H / N CTAs are resident at once, by default
    whole clusters on 132 SMs; min(B, 32) rows a pass, so any batch. The
    shared memory mirrors the grid kernels' layout, each region 128-byte
    aligned: 256 bytes of mbarriers, the weight slice as mma fragments
    (2H x 4N forward, 8H x N reverse, each stage's depth rounded up to
    the mma's: 8 tf32, 16 bf16), the stage ring (rows rounded up to 8 /
    16, H values and 16 bytes a row), the depth slices' sums (8 / m-tiles
    of them, fp32, the rows by 4N + 8 forward, by N reverse), two steps'
    inputs (4 / 7 segments of N a row), the
    forward's bias, the carried state (2 / 3 fp32 of rows x N). A card
    that holds fewer CTAs takes wider ones; one that holds none of them
    raises (a cooperative launch cannot run in waves)."""
    item = torch.empty((), dtype=dtype).element_size()
    kw = 8 if item == 4 else 16
    kts = -(-H // kw)
    rs = (kts * kw + 16 // item) * item           # bytes of a stage row
    for b in (1, 32, 4096):
        plan = _launch_plan(b, U, H, dtype)
        assert (plan.kind, plan.cols, plan.ctas) == ("grid", cols, ctas)
        assert plan.cluster == 8 and plan.clusters == ctas // 8
        rows = min(b, 32)
        assert plan.rows == rows and plan.flags == U * 32
        r8, r16 = -(-rows // 8) * 8, -(-rows // 16) * 16
        mt_f, mt_b = cols // 4, r16 // 16
        fwd = bwd = 256
        fwd = _up128(fwd + mt_f * 2 * kts * 32 * 16)
        fwd = _up128(fwd + plan.fwd_bufs * r8 * rs)
        fwd = _up128(fwd + 8 // mt_f * r8 * (4 * cols + 8) * 4)
        fwd = _up128(fwd + 2 * rows * 4 * cols * item)
        fwd = _up128(fwd + 16 * cols)
        fwd = _up128(fwd + 2 * rows * cols * 4)
        bwd = _up128(bwd + cols // 8 * 8 * kts * 32 * 8)
        bwd = _up128(bwd + plan.bwd_bufs * r16 * rs)
        bwd = _up128(bwd + 8 // mt_b * r16 * cols * 4)
        bwd = _up128(bwd + 2 * rows * 7 * cols * item)
        bwd = _up128(bwd + 3 * rows * cols * 4)
        assert (plan.fwd_smem, plan.bwd_smem) == (fwd, bwd)
        assert max(plan.fwd_smem, plan.bwd_smem) <= 232448
        # the ring: every stage of a step where it fits (2 forward, 8
        # reverse), else as many buffers as fit
        assert plan.fwd_bufs == 2 and 1 <= plan.bwd_bufs <= 8
        assert plan.bwd_bufs == 8 or plan.bwd_smem + r16 * rs > 232448
    held = lambda N, CS, fwd, bwd: U * H // 16
    wide = _launch_plan(32, U, H, dtype, grid_resident=held)
    assert (wide.cols, wide.ctas) == (16, U * H // 16)
    with pytest.raises(ValueError, match="the card holds"):
        _launch_plan(32, U, H, dtype, grid_resident=lambda N, CS, f, b: 1)


@pytest.mark.parametrize("U,H,held,cols,cluster", [
    # the H100 holds 15 clusters of 8 of these CTAs, 30 of 4, 66 of 2
    (8, 128, {8: 120, 4: 120, 2: 132, 1: 132}, 8, 2),
    (3, 256, {8: 120, 4: 120, 2: 132, 1: 132}, 8, 8),
    # no cluster of the 128 CTAs of N=8 fits: clusters of 8 of N=16
    (8, 128, {8: 120, 4: 120, 2: 120, 1: 120}, 16, 8),
    # one CTA a unit (H = N = 8): no cluster to share rows with
    (9, 8, {8: 0, 4: 0, 2: 0, 1: 132}, 8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_plan_clusters(U, H, held, cols, cluster, dtype):
    """The plan takes the fewest columns, then the largest cluster of CTAs
    of one unit (which fetch each step's rows once between them) that the
    card holds all of at once; `resident(N, CS, ...)` answers in CTAs. In
    bf16 storage clusters of at least 4 come first: U=8, H=128 on the
    H100 takes clusters of 8 of N=16 rather than clusters of 2 of N=8."""
    if dtype == torch.bfloat16 and (U, H, cluster) == (8, 128, 2):
        cols, cluster = 16, 8
    plan = _launch_plan(32, U, H, dtype,
                        grid_resident=lambda N, CS, f, b: held[CS])
    assert (plan.cols, plan.cluster) == (cols, cluster)
    assert plan.ctas == U * H // cols and plan.clusters == plan.ctas // cluster
    assert plan.flags == U * 32


def test_grid_plan_refuses_too_few_clusters():
    """A card that holds fewer clusters than a plan needs, at every N and
    cluster size, raises before any launch; the message names each
    (N, cluster size) tried and the N whose CTAs overflow the shared
    memory (fp32 H=256: N=32). A card that holds 20 CTAs, too few for
    every resident plan, takes the streamed mode's 12 CTAs of N=64; one
    that holds 8 takes no plan at all."""
    plan = _launch_plan(32, 3, 256, torch.float32,
                        grid_resident=lambda N, CS, f, b: 20)
    assert (plan.kind, plan.cols, plan.ctas) == ("stream", 64, 12)
    with pytest.raises(ValueError, match=r"N=8 in clusters of 8: 96 CTAs, "
                                         r"the card holds 8") as err:
        _launch_plan(32, 3, 256, torch.float32,
                     grid_resident=lambda N, CS, f, b: 8)
    msg = str(err.value)
    assert "N=16 in clusters of 1: 48 CTAs" in msg
    assert "N=32: over 232448 bytes of shared memory" in msg
    assert "streamed N=64 in clusters of 1: 12 CTAs" in msg


def test_grid_plan_rows_and_rings():
    """Rows a pass: min(B, 32). The reverse's ring: all 8 stages where the
    shared memory takes them (bf16 at H=256, every H=64 shape), 4 at fp32
    H=256 (33 KB a stage). The forward's: both stages but at fp32 H=512
    with 32 rows a pass, where one buffer takes them in turn (as one does
    the reverse's eight); 5 rows a pass keep two."""
    assert _launch_plan(5, 3, 256, torch.float32).rows == 5
    assert _launch_plan(300, 3, 256, torch.float32).rows == 32
    assert _launch_plan(32, 3, 256, torch.float32).bwd_bufs == 4
    assert _launch_plan(32, 3, 256, torch.bfloat16).bwd_bufs == 8
    assert _launch_plan(32, 10, 64, torch.float32).bwd_bufs == 8
    for b in (32, 40):
        plan = _launch_plan(b, 2, 512, torch.float32)
        assert (plan.fwd_bufs, plan.bwd_bufs) == (1, 1)
    assert _launch_plan(32, 2, 512, torch.bfloat16).fwd_bufs == 2
    assert _launch_plan(5, 2, 512, torch.float32).fwd_bufs == 2


def _tf32(x):
    """x (float32) rounded to tf32, to nearest with ties away from zero, as
    cvt.rna.tf32.f32 and the kernels' integer version round."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """x (float32) cut to tf32 (its top 19 bits), as the tensor cores read an
    fp32 operand of a tf32 mma."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _emulated_product(x, w, H, kw, ks, sets, tf32):
    """x (R, stages * H) @ w (stages * H, C) summed as a grid kernel's warps
    sum it: each stage's depth in k-tiles of kw (zero past H), k-tile j of
    a stage to depth slice j % ks and accumulator set (j // ks) % sets;
    per k-tile one tensor-core step, taken here as the product's exact sum
    rounded to fp32 once and added to its fp32 accumulator; fp32 operands
    split into tf32 big (rounded to nearest) + small (the rest, which the
    mma cuts to tf32), three accumulators (big*big, small*big, big*small)
    per set, summed as acc0 + (acc1 + acc2); the sets added in order, then
    the slices."""
    R, D = x.shape
    S = D // H
    kts = -(-H // kw)
    pad = kts * kw - H
    xs = torch.nn.functional.pad(x.view(R, S, H), (0, pad)).view(R, S, kts, kw)
    ws = torch.nn.functional.pad(w.view(S, H, -1), (0, 0, 0, pad)).view(
        S, kts, kw, -1)
    tiles = lambda a, b: torch.einsum("rskd,skdc->skrc", a.double(),
                                      b.double()).float()
    if tf32:
        xh, wh = _tf32(xs), _tf32(ws)
        xl, wl = _tf32_trunc(xs - xh), _tf32_trunc(ws - wh)
        parts = [tiles(xh, wh), tiles(xl, wh), tiles(xh, wl)]
    else:
        parts = [tiles(xs, ws)]
    acc = torch.zeros(ks, sets, len(parts), R, w.shape[1])
    for s in range(S):
        for j in range(kts):
            for a, part in enumerate(parts):
                acc[j % ks, (j // ks) % sets, a] += part[s, j]
    per_set = acc[:, :, 0] + (acc[:, :, 1] + acc[:, :, 2]) if tf32 \
        else acc[:, :, 0]
    v = per_set[:, 0]
    for q in range(1, sets):
        v = v + per_set[:, q]
    dot = v[0]
    for s in range(1, ks):
        dot = dot + v[s]
    return dot


def _emulated_grid_products(W, lvec, B, N, tf32):
    """The forward's and the reverse's step products as the grid kernels
    compute them for N columns a CTA at batch B (as `product` hooks of the
    plain recurrences): per unit u, [h_u | h_{u-1}] @ Wf[u] and [dg_u |
    dg_{u+1}] @ Wb[u]^T in stages of H, on min(B, 32) rows a pass."""
    U = lvec.numel()
    H = W.shape[0] // U
    wf, wb = (x.float() for x in unit_blocks(W, lvec))
    kw = 8 if tf32 else 16
    rows = min(B, 32)
    nt_f, mt_b = -(-rows // 8), -(-rows // 16)
    sets_for = lambda nt: 1 if nt >= 3 else 4 // nt
    ks_f, sets_f = 32 // N, sets_for(nt_f)
    ks_b, sets_b = 8 // mt_b, sets_for(N // 8)

    def fwd(h, _):
        hu = h.view(B, U, H)
        below = torch.cat([torch.zeros_like(hu[:, :1]), hu[:, :-1]], 1)
        out = torch.empty(B, 4, U, H)
        for u in range(U):
            x = torch.cat([hu[:, u], below[:, u]], 1)
            out[:, :, u] = _emulated_product(x, wf[u], H, kw, ks_f, sets_f,
                                             tf32).view(B, 4, H)
        return out.view(B, 4 * U * H)

    def bwd(dg, _):
        d = dg.view(B, 4, U, H)
        above = torch.cat([d[:, :, 1:], torch.zeros_like(d[:, :, :1])], 2)
        out = torch.empty(B, U, H)
        for u in range(U):
            x = torch.cat([d[:, :, u].reshape(B, -1),
                           above[:, :, u].reshape(B, -1)], 1)
            out[:, u] = _emulated_product(x, wb[u].t(), H, kw, ks_b, sets_b,
                                          tf32)
        return out.view(B, U * H)
    return fwd, bwd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depths,h,b,s", [((3,), 256, 2, 24),
                                          ((5, 5), 64, 3, 24)])
def test_grid_tensor_core_products_hold_the_bars(dtype, depths, h, b, s):
    """The grid kernels' tensor-core arithmetic, emulated on the CPU in the
    kernels' summation order (3xTF32 for fp32 storage: the big part rounded
    as cvt.rna.tf32.f32 rounds, the rest cut to tf32 as the mma reads it;
    bf16 operands, fp32 sums for bf16) and run through the plain
    recurrences, against the plain recurrences at the card's bars: forward
    max-abs 1e-5 (fp32) / 1.6e-2 (bf16; the stored gates per element to
    that times max(1, |g|)), reverse 1e-5 / 3e-2 of max|plain|."""
    fp32 = dtype == torch.float32
    args = _recurrence_inputs(31, b, s, h, depths, dtype)
    W, lvec = args[0], args[5]
    fwd_p, bwd_p = _emulated_grid_products(W, lvec, b, 8, fp32)
    want = wavefront_fwd_plain(*args, s, with_residuals=True)
    got = wavefront_fwd_plain(*args, s, with_residuals=True, product=fwd_p)
    tol = 1e-5 if fp32 else 1.6e-2
    for i, (g, w) in enumerate(zip(got, want)):
        scale = w.float().abs().clamp_min(1.0) if i == 3 else 1.0
        assert ((g.float() - w.float()).abs() / scale).max().item() <= tol
    bargs = _bwd_inputs(32, args, s)
    want = wavefront_bwd_plain(*bargs, s)
    got = wavefront_bwd_plain(*bargs, s, product=bwd_p)
    btol = 1e-5 if fp32 else 3e-2
    for g, w in zip(got, want):
        assert ((g.float() - w.float()).abs().max().item()
                <= btol * w.float().abs().max().item())


def test_emulated_product_is_the_exact_sum():
    """The emulation itself: on values that are already tf32 (fp32 case) or
    bf16, with sums exact in fp32, it gives x @ w exactly, whatever the
    slices and sets."""
    r = np.random.default_rng(33)
    x = torch.as_tensor(r.integers(-8, 8, (5, 2 * 24)).astype(np.float32))
    w = torch.as_tensor(r.integers(-8, 8, (2 * 24, 12)).astype(np.float32))
    for tf32, kw in ((True, 8), (False, 16)):
        for ks, sets in ((1, 1), (4, 1), (2, 4), (8, 2)):
            got = _emulated_product(x, w, 24, kw, ks, sets, tf32)
            assert torch.equal(got, x @ w)


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


# (depths, H, B, S): the shapes the cluster kernels refuse, which the grid
# kernels take: the forecast decoder's LSTM(256, 3) and the predict-st
# decoder's LSTM(256, 2) at the smoke's B=32, S=300 and at B = 2 and 64;
# two 4-layer H=128 encoders; two 5-layer H=64 encoders; ragged small
# cases (a batch that is no multiple of the kernels' row chunks, 9 units
# of H=8); and a 2-layer H=512 stream, whose fp32 forward holds one stage
# buffer for its two stages a step (a ring, as the fp32 H=512 reverse's
# one buffer for eight), in one pass (B=32) and in two (B=40)
GRID_CASES = [((3,), 256, 32, 300), ((2,), 256, 32, 300),
              ((4, 4), 128, 32, 300), ((5, 5), 64, 32, 300),
              ((3,), 256, 2, 40), ((2,), 256, 64, 40),
              ((3,), 256, 5, 17), ((5, 4), 64, 19, 40), ((9,), 8, 3, 17),
              ((2,), 512, 32, 17), ((2,), 512, 40, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwd", "fwd_res", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depths,h,b,s", GRID_CASES)
def test_grid_kernels_match_plain(cuda_device, kind, dtype, depths, h, b, s):
    """The grid kernels against their plain versions at the bars of the
    cluster kernels' tests above (serving and residual forward: max-abs
    1e-5 fp32, 1.6e-2 bf16, the stored gates per element to that times
    max(1, |g|); reverse: 1e-5 / 3e-2 of max|plain|), each call one launch
    of its grid entry point."""
    from vae_teb_tpu_torch.kernels.wavefront import _check
    fp32 = dtype == torch.float32
    args = _recurrence_inputs(21, b, s, h, depths, dtype, cuda_device)
    assert _check("grid", args[:5], args[5], args[2]).kind == "grid"
    counts = wavefront_bwd.entry_launches if kind == "bwd" else \
        wavefront_fwd.entry_launches
    entry = f"wavefront_grid_{kind}_{'f32' if fp32 else 'bf16'}"
    before = counts[entry]
    if kind == "bwd":
        bargs = _bwd_inputs(22, args, s)
        got, want = wavefront_bwd(*bargs, s), wavefront_bwd_plain(*bargs, s)
    else:
        res = kind == "fwd_res"
        got = wavefront_fwd(*args, s, with_residuals=res)
        want = wavefront_fwd_plain(*args, s, with_residuals=res)
    torch.cuda.synchronize()
    assert counts[entry] == before + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs()
        if kind == "bwd":
            tol = 1e-5 if fp32 else 3e-2
            assert err.max().item() <= tol * w.float().abs().max().item()
        else:
            scale = w.float().abs().clamp_min(1.0) if i == 3 else 1.0
            assert (err / scale).max().item() <= (1e-5 if fp32 else 1.6e-2)


@pytest.mark.cuda
def test_grid_gradients_flow_through_the_kernels(cuda_device):
    """A 3-layer and a 2-layer H=256 stream (the two decoders' LSTMs) on the
    card: gradients through the grid kernels (one residual forward, one
    backward launch) against autograd of the plain loop, every leaf within
    1e-4 of its max (fp32). The weights are scaled as the H=8 streams'
    are at their width (0.3 * sqrt(8 / H)), so that the recurrence is no
    more sensitive to rounding than theirs."""
    w_scale = 0.3 * np.sqrt(8 / 256)
    arrays = [_stream_arrays(3, 3, b=4, s=40, h=256, w_scale=w_scale),
              _stream_arrays(4, 2, b=4, s=40, h=256, w_scale=w_scale)]
    grads = []
    for recurrence in (wavefront_recurrence, wavefront_fwd_plain):
        leaves = _stream_leaves(arrays, lambda a: torch.tensor(
            a, device=cuda_device, requires_grad=True))
        before = (wavefront_fwd.entry_launches["wavefront_grid_fwd_res_f32"],
                  wavefront_bwd.entry_launches["wavefront_grid_bwd_f32"])
        _stream_loss(run_lstm_streams(
            _streams_from_leaves(LSTMStream, leaves, arrays,
                                 lambda a: torch.as_tensor(a, device=cuda_device)),
            recurrence=recurrence), torch).backward()
        torch.cuda.synchronize()
        launched = (
            wavefront_fwd.entry_launches["wavefront_grid_fwd_res_f32"]
            - before[0],
            wavefront_bwd.entry_launches["wavefront_grid_bwd_f32"] - before[1])
        kernels = recurrence is wavefront_recurrence
        assert launched == ((1, 1) if kernels else (0, 0))
        grads.append([t.grad for t in torch.utils._pytree.tree_leaves(leaves)])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
