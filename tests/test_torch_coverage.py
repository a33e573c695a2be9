"""Every LSTM shape the JAX package runs: hidden sizes that are not a
multiple of 8 (packed with exact zero padding), stacks too wide for one
launch (depth groups chained through hoisted input projections) and units
too wide for a CTA's shared memory (the streamed grid kernels), against
the JAX package's LSTM and SeqVaeTeb (schedule "wavefront", its default
XLA scan, which takes any hidden size) and against the port's own
unpadded, single-group runs; the depth-group planner with stub
residencies; and, on a card, the same shapes through the kernels against
the plain recurrence.

JAX is imported inside the tests that compare with it, so the CUDA cases
also run where JAX is not installed:
    python -m pytest tests/test_torch_coverage.py -m cuda
"""

import numpy as np
import pytest
import torch

from vae_teb_tpu_torch import SeqVaeTeb, init_parameters
from vae_teb_tpu_torch.kernels import (wavefront, wavefront_bwd,
                                       wavefront_fwd, wavefront_fwd_plain,
                                       wavefront_recurrence)
from vae_teb_tpu_torch.kernels.wavefront import depth_groups
from vae_teb_tpu_torch.models import compute_loss
from vae_teb_tpu_torch.models.blocks import (LSTM, LSTMStream, _wavefront_meta,
                                             _wavefront_pack, _wavefront_unpack,
                                             _wavefront_xs, padded_width,
                                             run_lstm_streams)

torch.set_num_threads(2)

# fp32 bars of the port's slices: forward max-abs 1e-5 of max, each
# gradient leaf 1e-4 of its own max
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# bf16 storage: forward two bf16 ulps at 1.0 (the kernels' bar), gradient
# leaves tests/test_torch_train.py's bf16 bars (1.5e-1 of max, rel-L2 1e-1)
BF16_FWD_TOL, BF16_GRAD_TOL, BF16_L2_TOL = 1.6e-2, 1.5e-1, 1e-1
# whole-model outputs against JAX: test_torch_slice.py's 1e-4 of max
MODEL_FWD_TOL = 1e-4
# the JAX side's XLA compiles at backend optimization level 0: fp32
# throughout, so only its summation orders move, and it compiles in
# about half the time
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _rel(got, want):
    got, want = (a.detach().float().cpu() if isinstance(a, torch.Tensor)
                 else torch.as_tensor(np.asarray(a, np.float32))
                 for a in (got, want))
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def _stream_arrays(r, depth, h, b, s, c):
    """Numpy weights (scaled as a unit of width h keeps its gates O(1)),
    layer-0 input and non-zero initial state of one stream."""
    f32 = lambda *shape: r.standard_normal(shape).astype(np.float32)
    w = 1.0 / np.sqrt(h + 4)
    return dict(x=f32(b, s, c),
                w_ih=[f32(h if l else c, 4 * h) * w for l in range(depth)],
                w_hh=[f32(h, 4 * h) * w for _ in range(depth)],
                b=[f32(4 * h) * 0.1 for _ in range(depth)],
                h0=f32(depth, b, h) * 0.3, c0=f32(depth, b, h) * 0.3)


def _leaves(arrays, dtype):
    """Per stream the differentiable leaves (x, w_ih, w_hh, b, h0, c0),
    float32 with gradients, and the LSTMStream the model would prepare
    from them in `dtype` (layer 0's projection hoisted)."""
    leaves, streams = [], []
    for a in arrays:
        t = {k: ([torch.tensor(w, requires_grad=True) for w in v]
                 if isinstance(v, list) else torch.tensor(v, requires_grad=True))
             for k, v in a.items()}
        c = lambda x: x.to(dtype)
        w_ih, w_hh, bs = ([c(w) for w in t[k]] for k in ("w_ih", "w_hh", "b"))
        streams.append(LSTMStream(c(t["x"]) @ w_ih[0] + bs[0], w_ih, w_hh, bs,
                                  (tuple(c(t["h0"]).unbind(0)),
                                   tuple(c(t["c0"]).unbind(0)))))
        leaves.append(t)
    return leaves, streams


def _loss(outs, seed):
    """A loss that reads every output and final state with seeded weights."""
    r = torch.Generator().manual_seed(seed)
    total = 0.0
    for ys, (h, c) in outs:
        for x in (ys, h, c):
            total = total + (x.float() * torch.randn(x.shape, generator=r)).sum()
    return total


def _unpadded(streams, recurrence=wavefront_recurrence):
    """The streams as one wavefront packed at their own width H, however
    small (the plain recurrence takes any H)."""
    ops = [{"xs": st.x_proj.transpose(0, 1), "w_ih_rest": st.w_ih[1:],
            "w_hh": st.w_hh, "b_rest": st.biases[1:], "init_h": st.init[0],
            "init_c": st.init[1]} for st in streams]
    H, depths, offsets, U, D, lvec = _wavefront_meta(ops)
    S = ops[0]["xs"].shape[0]
    W, b = _wavefront_pack(ops, H, depths, offsets, U)
    xs = _wavefront_xs(ops, H, depths, offsets, U, S + D - 1, S)
    h0 = torch.cat([h for op in ops for h in op["init_h"]], -1)
    c0 = torch.cat([c for op in ops for c in op["init_c"]], -1)
    h_seq, h_fin, c_fin = recurrence(W, b, xs, h0, c0, torch.as_tensor(lvec),
                                     S)
    return [(ys.transpose(0, 1), (torch.stack(h), torch.stack(c)))
            for ys, h, c in _wavefront_unpack(h_fin, c_fin, h_seq, ops)]


def _grads(leaves):
    return [t.grad for t in torch.utils._pytree.tree_leaves(leaves)]


def _assert_grads(got, want, bf16):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is not None and g.shape == w.shape
        err = _rel(g, w)
        if bf16:
            l2 = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
            assert err <= BF16_GRAD_TOL and l2 <= BF16_L2_TOL, (err, l2)
        else:
            assert err <= GRAD_TOL, err


# ---------------------------------------------------------------------------
# zero padding of H
# ---------------------------------------------------------------------------

def test_padded_width():
    assert [padded_width(h) for h in (1, 5, 8, 12, 60, 64, 100, 512)] == \
        [8, 8, 8, 16, 64, 64, 104, 512]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 5, 12, 60, 100])
def test_padded_pack_matches_unpadded(h, dtype):
    """run_lstm_streams packs a 2-layer and a 1-layer stream at the padded
    width and slices each unit's first H columns back out; against the
    same streams packed at H through the same recurrence (the plain
    version here): outputs, final states and the gradient of every leaf.
    The padded columns add exact zeros, so only summation order differs:
    fp32 within 1e-5 of max forward and 1e-4 of each leaf's max; bf16
    storage within two ulps forward and test_torch_train.py's bf16 bars."""
    r = np.random.default_rng(h)
    arrays = [_stream_arrays(r, 2, h, 3, 6, 5), _stream_arrays(r, 1, h, 3, 6, 5)]
    bf16 = dtype == torch.bfloat16
    runs = []
    for run in (run_lstm_streams, _unpadded):
        leaves, streams = _leaves(arrays, dtype)
        outs = run(streams)
        _loss(outs, 1).backward()
        runs.append((outs, _grads(leaves)))
    (got, g_got), (want, g_want) = runs
    for (ys, (hf, cf)), (ys_w, (hf_w, cf_w)) in zip(got, want):
        for a, b in ((ys, ys_w), (hf, hf_w), (cf, cf_w)):
            assert a.shape == b.shape and a.dtype == dtype
            assert _rel(a.detach(), b.detach()) <= (BF16_FWD_TOL if bf16
                                                   else FWD_TOL)
    _assert_grads(g_got, g_want, bf16)


def test_lstm_h5_matches_jax():
    """The port's LSTM(hidden_size=5, num_layers=2), padded to 8, against
    the JAX package's LSTM(hidden_size=5, num_layers=2,
    schedule="wavefront") on the same weights, input and non-zero initial
    state: outputs and final state within 1e-5 of max, the gradient of a
    loss on all three with respect to every weight, the input and the
    initial state within 1e-4 of each leaf's max."""
    import jax
    import jax.numpy as jnp
    from vae_teb_tpu.models import blocks as jb
    r = np.random.default_rng(5)
    a = _stream_arrays(r, 2, 5, 3, 9, 6)
    params = {f"{k}_{l}": a[n][l] for l in range(2)
              for k, n in (("w_ih", "w_ih"), ("w_hh", "w_hh"), ("bias", "b"))}
    cot = [r.standard_normal(s).astype(np.float32)
           for s in ((3, 9, 5), (2, 3, 5), (2, 3, 5))]
    jm = jb.LSTM(hidden_size=5, num_layers=2, schedule="wavefront")

    def jax_loss(p, x, h0, c0):
        ys, (h, c) = jm.apply({"params": p}, x, (h0, c0))
        return (sum(jnp.sum(o * w) for o, w in zip((ys, h, c), cot)),
                (ys, h, c))

    args = (params, a["x"], a["h0"], a["c0"])
    (_, want), g_want = jax.jit(jax.value_and_grad(
        jax_loss, (0, 1, 2, 3), has_aux=True)).lower(*args).compile(
        FAST_COMPILE)(*args)
    lstm = LSTM(6, 5, 2)
    with torch.no_grad():
        for k, v in params.items():
            getattr(lstm, k).copy_(torch.as_tensor(v))
    x, h0, c0 = (torch.tensor(a[k], requires_grad=True)
                 for k in ("x", "h0", "c0"))
    ((ys, (h, c)),) = run_lstm_streams([lstm(x, (h0, c0))])
    sum((o * torch.as_tensor(w)).sum() for o, w in zip((ys, h, c), cot)
        ).backward()
    for g, w in zip((ys, h, c), want):
        assert g.shape == w.shape and _rel(g.detach(), w) <= FWD_TOL
    got = {k: getattr(lstm, k).grad for k in params}
    for k in params:
        assert _rel(got[k], g_want[0][k]) <= GRAD_TOL, k
    for t, w in zip((x, h0, c0), g_want[1:]):
        assert _rel(t.grad, w) <= GRAD_TOL


# ---------------------------------------------------------------------------
# the depth-group planner
# ---------------------------------------------------------------------------

# the H100's residency of grid CTAs at (8 units, 512) in clusters of CS
# CTAs: 15 clusters of 8, 30 of 4, 66 of 2
H100 = {8: 120, 4: 120, 2: 132, 1: 132}


def _layers(*runs):
    """Groups holding layers [l0, l1) of both 4-layer streams."""
    return tuple(((0, l0, l1), (1, l0, l1)) for l0, l1 in runs)


@pytest.mark.parametrize("dtype,groups", [
    # fp32 H=512: one layer of both streams is 128 CTAs of N=8 (the only
    # N whose weight slice fits 227 KB), resident in clusters of 2
    (torch.float32, _layers((0, 1), (1, 2), (2, 3), (3, 4))),
    # bf16: two layers of both, 128 CTAs of N=16, in clusters of 2
    (torch.bfloat16, _layers((0, 2), (2, 4)))])
def test_depth_groups_of_the_wide_encoders(dtype, groups):
    """SeqVaeTeb(lstm_hidden_dim=512): two 4-layer streams (8 units) of
    H=512 fit no single launch on an H100; the planner makes the fewest
    runs of consecutive layers, each holding that layer of every stream."""
    assert depth_groups((4, 4), 512, dtype,
                        lambda N, CS, f, b: H100[CS]) == groups


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depths,h", [
    ((4, 4), 64), ((4, 4), 8), ((4,), 64), ((4, 2), 64),   # cluster kernels
    ((3,), 256), ((2,), 256), ((4, 4), 128), ((5, 5), 64), ((9,), 64),
    ((4, 4), 104)])                                          # grid kernels
def test_depth_groups_keep_one_launch(depths, h, dtype):
    """Every shape one launch takes today stays one group: the main path's,
    the streaming encoder's, the grid kernels' (test_grid_launch_plan's
    shapes) and lstm_hidden_dim=100 padded to 104 (13 CTAs a unit)."""
    one = (tuple((s, 0, d) for s, d in enumerate(depths)),)
    assert depth_groups(depths, h, dtype) == one
    assert depth_groups(depths, h, dtype, lambda N, CS, f, b: H100[CS]) == one


def test_depth_groups_split_streams_and_raise():
    """Where one layer of all streams fits no launch, each stream is
    partitioned alone. Where one unit's weight slice is over a CTA's 227
    KB at every column split (fp32 H=1024), the groups take the streamed
    mode, one layer of both streams a group (33.5 MB of weights a step,
    within the L2 budget). Where one unit fits no launch even streamed
    (the card holds 4 CTAs: 8 of N=64 are needed at bf16 H=512), the
    planner raises and names the card's residency."""
    held = lambda N, CS, f, b: 64
    assert depth_groups((2, 2, 1), 512, torch.float32, held) == (
        ((0, 0, 1),), ((0, 1, 2),), ((1, 0, 1),), ((1, 1, 2),), ((2, 0, 1),))
    groups = depth_groups((4, 4), 1024, torch.float32)
    assert groups == _layers((0, 1), (1, 2), (2, 3), (3, 4))
    assert all(wavefront._launch_plan(32, 2, 1024, torch.float32).kind
               == "stream" and 2 * 1024 * 4096 * 4 <= wavefront._L2_BUDGET
               for _ in groups)
    with pytest.raises(ValueError, match=r"hidden size 512 in bfloat16 .*"
                                         r"more than the card holds"):
        depth_groups((4, 4), 512, torch.bfloat16, lambda N, CS, f, b: 4)


def test_wavefront_groups_on_the_cpu():
    """The CPU's plain recurrence takes any stack: one group, even where a
    card would need several or none."""
    for depths, h in (((4, 4), 512), ((4, 4), 1024), ((3, 1), 8)):
        assert wavefront.wavefront_groups(depths, h, torch.float32,
                                          torch.device("cpu")) == (
            tuple((s, 0, d) for s, d in enumerate(depths)),)


# ---------------------------------------------------------------------------
# chained depth groups in the model, against one group and against JAX
# ---------------------------------------------------------------------------

S, B = 8, 3
FIELDS = ("fhr_st", "fhr_ph", "fhr_up_ph", "fhr")


def _batch(seed):
    r = np.random.default_rng(seed)
    f32 = lambda *shape: r.standard_normal(shape).astype(np.float32)
    return {"fhr_st": f32(B, S, 43), "fhr_ph": f32(B, S, 44),
            "fhr_up_ph": f32(B, S, 130), "fhr": f32(B, 16 * S)}


def _port_step(model, batch, eps):
    """Train-mode forward with the given noise, the ELBO (beta 0.3) and its
    gradients: (outputs, losses, {name: gradient})."""
    model.zero_grad(set_to_none=True)
    t = [torch.as_tensor(batch[k]) for k in FIELDS]
    out = model.train()(*t[:3], deterministic=False, eps=torch.as_tensor(eps))
    losses = compute_loss(out, *t[:2], t[3], beta=0.3)
    losses["total_loss"].backward()
    return ({k: v.detach() for k, v in out.items()},
            {k: v.item() for k, v in losses.items()},
            {k: p.grad for k, p in model.named_parameters()})


def _jax_step(model_kw, sd, batch, seed):
    """The JAX package's SeqVaeTeb (schedule "wavefront") on the port's
    weights `sd`: (outputs, losses, gradients by port name, the noise the
    model drew)."""
    import jax
    import jax.numpy as jnp
    from vae_teb_tpu.models import SeqVaeTeb as JaxSeqVaeTeb
    from vae_teb_tpu_torch.convert import flax_path, to_torch_layout, torch_key
    jm = JaxSeqVaeTeb(**model_kw, lstm_schedule="wavefront")
    cols = [jnp.asarray(batch[k]) for k in FIELDS]
    # the flax tree from the state_dict's names (`flax_path`; a kernel's
    # layout change is its own inverse), without tracing flax's init
    variables = {"params": {}, "batch_stats": {}}
    for name, t in sd.items():
        path = flax_path(name, t.dim())
        node = variables["batch_stats" if name.endswith(
            ("running_mean", "running_var")) else "params"]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = to_torch_layout(path[-1], t.numpy())
    key = jax.random.PRNGKey(seed)

    def loss_fn(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          *cols[:3], train=True, rngs={"sample": key},
                          mutable=["batch_stats"])
        losses = jm.compute_loss(out, *cols[:2], cols[3], beta=0.3)
        return losses["total_loss"], (losses, out)

    (_, (losses, out)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True)).lower(variables["params"]).compile(
        FAST_COMPILE)(variables["params"])
    eps = jm.apply(variables, rngs={"sample": key}, method=(
        lambda m: jax.random.normal(m.make_rng("sample"), out["z"].shape)))
    named = {torch_key(tuple(p.key for p in path)): to_torch_layout(
        path[-1].key, np.asarray(g))
        for path, g in jax.tree_util.tree_leaves_with_path(grads)}
    return ({k: np.asarray(v) for k, v in out.items()},
            {k: float(v) for k, v in losses.items()}, named, np.asarray(eps))


def _grad_bar(grads):
    """tests/test_torch_train.py's per-leaf bar: 1e-4 of the leaf's max, or
    1e-6 of the largest entry of any leaf (leaves whose gradient cancels)."""
    top = max(np.abs(np.asarray(g)).max() for g in grads.values())
    return lambda scale: max(GRAD_TOL * scale, 1e-6 * top)


def _assert_step_matches(got, want, out_tol):
    out, losses, grads = got
    out_w, losses_w, grads_w = want
    assert set(out) == set(out_w) and set(grads) == set(grads_w)
    for k in out_w:
        assert _rel(out[k], out_w[k]) <= out_tol, k
    for k in losses_w:
        np.testing.assert_allclose(losses[k], losses_w[k], rtol=1e-5)
    bar = _grad_bar(grads_w)
    for k, w in grads_w.items():
        w = np.asarray(w)
        err = np.abs(np.asarray(grads[k]) - w).max()
        assert err <= bar(np.abs(w).max()), (k, err)


def _three_groups(seen):
    """A planner that puts each of three layers of every stream in a group
    of its own, as a card would split a stack too wide for one launch,
    recording the stacks it was asked about."""
    def plan(depths, h, dtype, device):
        seen.append(tuple(depths))
        return tuple(tuple((s, l, l + 1) for s in range(len(depths)))
                     for l in range(3))
    return plan


def test_chained_groups_match_one_group(monkeypatch):
    """SeqVaeTeb(lstm_hidden_dim=8, lstm_num_layers=3) with its two encoder
    LSTMs forced into three depth groups (a layer of both streams each)
    against the same model in one group: the train-mode forward within
    1e-5 of max (the chained groups' hoisted products sum in another
    order), the ELBO rtol 1e-5, each gradient leaf within 1e-4 of its max
    (test_torch_train.py's floor for leaves whose gradient cancels)."""
    model = init_parameters(SeqVaeTeb(lstm_hidden_dim=8, lstm_num_layers=3,
                                      seq_len=S), seed=3)
    batch = _batch(40)
    eps = np.random.default_rng(41).standard_normal((B, S, 32)).astype(
        np.float32)
    one = _port_step(model, batch, eps)
    seen = []
    monkeypatch.setattr(wavefront, "wavefront_groups", _three_groups(seen))
    _assert_step_matches(_port_step(model, batch, eps), one, FWD_TOL)
    assert seen == [(3, 3)]


def test_padded_and_chained_model_match_jax(monkeypatch):
    """SeqVaeTeb(lstm_hidden_dim=12, lstm_num_layers=3), whose LSTMs pack at
    16 columns a unit, in one group and forced into three depth groups:
    the train-mode forward, the ELBO and every gradient against the JAX
    package's model on the same weights and noise. Outputs within 1e-4 of
    max (test_torch_slice.py's bar for whole-model outputs against JAX:
    fp32 through ~60 layers, summed in other orders), losses rtol 1e-5,
    each gradient leaf within 1e-4 of its max (floored as above)."""
    kw = dict(lstm_hidden_dim=12, lstm_num_layers=3)
    model = init_parameters(SeqVaeTeb(**kw, seq_len=S), seed=4)
    batch = _batch(50)
    out_j, losses_j, grads_j, eps = _jax_step(kw, model.state_dict(), batch, 7)
    want = (out_j, losses_j, grads_j)
    _assert_step_matches(_port_step(model, batch, eps), want, MODEL_FWD_TOL)
    seen = []
    monkeypatch.setattr(wavefront, "wavefront_groups", _three_groups(seen))
    _assert_step_matches(_port_step(model, batch, eps), want, MODEL_FWD_TOL)
    assert seen == [(3, 3)]


def test_export_and_streaming_run_the_groups(monkeypatch):
    """With the planner splitting the source encoder's LSTM into three
    depth groups: a streaming program exported on the CPU
    (export_source_stream, chunks of 4) holds one recurrence operator a
    group, and chained over the sequence, its carried state sliced per
    group, it reproduces the full-sequence source encode within 1e-5 of
    max (test_torch_stream.py's bar), as a StreamingSession over uneven
    chunks does; the grouped encode stays within 1e-4 of max of the
    one-group encode (the hoisted projections sum in another order)."""
    from vae_teb_tpu_torch import serve
    op = torch.ops.vae_teb_tpu_torch.wavefront_fwd.default
    model = init_parameters(SeqVaeTeb(lstm_hidden_dim=12, lstm_num_layers=3,
                                      seq_len=16), seed=5).eval()
    x = torch.as_tensor(np.random.default_rng(60).standard_normal(
        (2, 16, 130)).astype(np.float32))
    with torch.inference_mode():
        one = model.source_encoder(x)
    seen = []
    monkeypatch.setattr(wavefront, "wavefront_groups", _three_groups(seen))
    program = serve.export_source_stream(model, batch_size=2, chunk_len=4,
                                         bundle_params=True, device="cpu")
    assert len([n for n in program.graph.nodes if n.target is op]) == 3
    step = program.module()
    state = model.init_source_stream_state(2)
    outs = []
    with torch.inference_mode():
        want = model.source_encoder(x)
        for lo in range(0, 16, 4):
            mu, state = step(x[:, lo:lo + 4], state)
            outs.append(mu)
    assert _rel(torch.cat(outs, 1), want) <= FWD_TOL
    assert _rel(want, one) <= MODEL_FWD_TOL
    session = serve.StreamingSession(model, 2, device="cpu")
    chunks = [session.step(x[:, lo:hi]) for lo, hi in ((0, 1), (1, 6),
                                                       (6, 16))]
    assert _rel(torch.cat(chunks, 1), want) <= FWD_TOL
    assert seen and set(seen) == {(3,)}


# ---------------------------------------------------------------------------
# on the card: the kernels against the plain recurrence
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _entries():
    return (sum(wavefront_fwd.entry_launches.values()),
            sum(wavefront_bwd.entry_launches.values()))


def _card_run(arrays, dtype, recurrence, device):
    leaves, streams = _leaves(arrays, dtype)
    streams = [LSTMStream(st.x_proj.to(device),
                          [w.to(device) for w in st.w_ih],
                          [w.to(device) for w in st.w_hh],
                          [b.to(device) for b in st.biases],
                          tuple(tuple(x.to(device) for x in xs)
                                for xs in st.init)) for st in streams]
    before = _entries()
    outs = run_lstm_streams(streams, recurrence)
    _loss([(y.cpu(), (h.cpu(), c.cpu())) for y, (h, c) in outs], 2).backward()
    torch.cuda.synchronize()
    after = _entries()
    return ([(y.detach().cpu(), (h.detach().cpu(), c.detach().cpu()))
             for y, (h, c) in outs], _grads(leaves),
            (after[0] - before[0], after[1] - before[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,depths", [(1, (4, 4)), (5, (4, 4)), (12, (4, 4)),
                                      (60, (4, 4)), (100, (4, 4)),
                                      (512, (4, 4))])
def test_kernels_match_plain_on_the_card(cuda_device, dtype, h, depths):
    """run_lstm_streams on the card, padded (H = 1, 5, 12, 60, 100) and in
    depth groups (H=512: 4 groups in fp32, 2 in bf16, as the card's
    residency decides), through the kernels against the plain recurrence
    on the card in the same groups: one residual forward and one reverse
    launch per group, none for the plain runs; outputs and gradients at
    the bars above (bf16: the kernel tests' forward bar and
    test_torch_train.py's gradient bars)."""
    r = np.random.default_rng(h)
    arrays = [_stream_arrays(r, d, h, 4, 30, 7) for d in depths]
    groups = wavefront.wavefront_groups(depths, padded_width(h), dtype,
                                        cuda_device)
    got, g_got, n = _card_run(arrays, dtype, wavefront_recurrence, cuda_device)
    want, g_want, n_plain = _card_run(arrays, dtype, wavefront_fwd_plain,
                                      cuda_device)
    assert n == (len(groups), len(groups)) and n_plain == (0, 0)
    assert len(groups) == (1 if h < 512 else
                           4 if dtype == torch.float32 else 2)
    bf16 = dtype == torch.bfloat16
    for (ys, (hf, cf)), (ys_w, (hf_w, cf_w)) in zip(got, want):
        for a, b in ((ys, ys_w), (hf, hf_w), (cf, cf_w)):
            assert _rel(a, b) <= (BF16_FWD_TOL if bf16 else FWD_TOL)
    _assert_grads(g_got, g_want, bf16)


@pytest.mark.cuda
def test_unit_over_the_shared_memory_raises_on_the_card(cuda_device):
    """fp32 H=1024, whose weight slice no CTA's shared memory holds: the
    unit runs on the streamed grid kernels, one streamed residual forward
    and one streamed reverse launch, its outputs and gradients against
    the plain recurrence on the card at the fp32 bars above; the plain
    run launches nothing."""
    r = np.random.default_rng(0)
    arrays = [_stream_arrays(r, 1, 1024, 2, 4, 3)]
    counts = (wavefront_fwd.entry_launches, wavefront_bwd.entry_launches)
    entries = ("wavefront_grid_fwd_res_stream_f32",
               "wavefront_grid_bwd_stream_f32")
    before = [c[e] for c, e in zip(counts, entries)]
    got, g_got, n = _card_run(arrays, torch.float32, wavefront_recurrence,
                              cuda_device)
    assert [c[e] - b for c, e, b in zip(counts, entries, before)] == [1, 1]
    want, g_want, n_plain = _card_run(arrays, torch.float32,
                                      wavefront_fwd_plain, cuda_device)
    assert n == (1, 1) and n_plain == (0, 0)
    for (ys, (hf, cf)), (ys_w, (hf_w, cf_w)) in zip(got, want):
        for a, b in ((ys, ys_w), (hf, hf_w), (cf, cf_w)):
            assert _rel(a, b) <= FWD_TOL
    _assert_grads(g_got, g_want, False)
