"""The port's streaming source encode against the JAX package's: the LSTM's
initial state, the causal convs' carry, `SourceEncoder.stream` chunk by
chunk, `get_sequence_encoding`, the standalone `TargetEncoder`,
`SeqVaeTeb.encode_source_stream`, the bf16 policy's stream and
`stitch_predictions`. Weights are seeded flax trees
converted into the port (no JAX compile for init); inputs are seeded numpy
arrays handed to both. The JAX encoders run jitted (eager flax compiles
every primitive on its own)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_teb_tpu.models import SourceEncoder as JaxSourceEncoder
from vae_teb_tpu.models import TargetEncoder as JaxTargetEncoder
from vae_teb_tpu.models import blocks as jb
from vae_teb_tpu.models import source_stream_init_state as jax_stream_state
from vae_teb_tpu.models import stitch_predictions as jax_stitch
from vae_teb_tpu_torch.convert import load_flax_variables
from vae_teb_tpu_torch.init import init_parameters
from vae_teb_tpu_torch.models import (SeqVaeTeb, SourceEncoder,
                                      TargetEncoder, source_stream_init_state,
                                      stitch_predictions)
from vae_teb_tpu_torch.models import blocks as tb

torch.set_num_threads(2)

# fp32 on both sides; only summation order (and, across chunks, the rows
# of each matmul) differs: the JAX package's own streaming bar
# (tests/test_models.py::test_source_encoder_streaming_matches_full)
STREAM_TOL = 1e-5
CONV_TOL = 1e-6
BF16_TOL = 1.6e-2   # a few bf16 ulps of max
CHUNKS = ((0, 5), (5, 6), (6, 15), (15, 24))
H, LAYERS = 8, 2


def _randomize(variables, seed):
    """Every leaf replaced by seeded numpy values (variances positive)."""
    r = np.random.default_rng(seed)

    def leaf(path, x):
        v = r.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "var":
            return np.abs(v) + 0.5
        return 0.5 * v

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _flax_vars(module, seed, *args, **kw):
    """Seeded variables of a flax module from eval_shape (no compile)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                                **kw))
    return jax.tree_util.tree_map(np.asarray, _randomize(shapes, seed))


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("schedule", ["wavefront", "wavefront_pallas"])
def test_lstm_initial_state_matches_jax(schedule):
    """LSTM(x, initial_state=(h, c)) against JAX's LSTM(initial_state=...)
    in the wavefront schedule and the Pallas kernel (interpret mode on the
    CPU): outputs and the final stacked (h, c), which chain into the next
    call."""
    B, S, C, L = 2, 7, 5, 3
    x = _x((B, S, C), 1)
    h0, c0 = _x((L, B, H), 2, 0.3), _x((L, B, H), 3, 0.3)
    flax = jb.LSTM(H, L, schedule=schedule)
    v = _flax_vars(flax, 4, jnp.asarray(x))
    ys, (h, c) = flax.apply(v, jnp.asarray(x),
                            initial_state=(jnp.asarray(h0), jnp.asarray(c0)))
    port = load_flax_variables(tb.LSTM(C, H, L), v)
    with torch.no_grad():
        ((got, (gh, gc)),) = tb.run_lstm_streams([port(
            torch.as_tensor(x), (torch.as_tensor(h0), torch.as_tensor(c0)))])
    assert gh.shape == gc.shape == (L, B, H)
    for g, w in ((got, ys), (gh, h), (gc, c)):
        assert _rel(g, w) <= STREAM_TOL


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("block", [False, True], ids=["conv", "block"])
def test_causal_conv_carry_matches_jax(k, block):
    """A (B, k-1, C) carry in place of the zero left pad, CausalConv1d and
    CausalConvBlock (eval mode), against JAX's `carry`."""
    x, carry = _x((2, 6, 4), 5), _x((2, k - 1, 4), 6)
    if block:
        flax, port = jb.CausalConvBlock(6, k), tb.CausalConvBlock(4, 6, k)
        kw = {"train": False}
    else:
        flax = jb.CausalConv1d(6, k, use_bias=False)
        port, kw = tb.CausalConv1d(4, 6, k), {}
    v = _flax_vars(flax, 7, jnp.asarray(x), **kw)
    want = flax.apply(v, jnp.asarray(x), carry=jnp.asarray(carry), **kw)
    load_flax_variables(port, v).eval()
    with torch.no_grad():
        got = port(torch.as_tensor(x), torch.as_tensor(carry))
    assert _rel(got, want) <= CONV_TOL


@pytest.fixture(scope="module")
def encoders():
    """A small JAX SourceEncoder with seeded variables and the port's on
    the converted ones (eval mode)."""
    flax = JaxSourceEncoder(lstm_hidden_dim=H, lstm_num_layers=LAYERS)
    x = _x((2, 24, 130), 8)
    v = _flax_vars(flax, 9, jnp.asarray(x), train=False)
    port = load_flax_variables(SourceEncoder(130, H, LAYERS), v).eval()
    return flax, v, port, x


def test_source_stream_matches_jax_and_full(encoders):
    """SourceEncoder.stream over uneven chunks at B=2: each chunk's mu and
    every field of the carried state against JAX's `stream`, and the
    chained mu against the port's own full forward."""
    flax, v, port, x = encoders
    jstream = jax.jit(lambda v, x, s: flax.apply(v, x, s, method="stream"))
    jstate = jax_stream_state(2, LAYERS, H)
    state = source_stream_init_state(2, LAYERS, H)
    assert set(state) == set(jstate) == {"conv_tails", "h", "c"}
    outs = []
    with torch.no_grad():
        full = port(torch.as_tensor(x))
        for lo, hi in CHUNKS:
            jmu, jstate = jstream(v, jnp.asarray(x[:, lo:hi]), jstate)
            mu, state = port.stream(torch.as_tensor(x[:, lo:hi]), state)
            assert _rel(mu, jmu) <= STREAM_TOL
            for g, w in zip(state["conv_tails"], jstate["conv_tails"]):
                assert g.shape == w.shape
                assert _rel(g, w) <= STREAM_TOL
            for key in ("h", "c"):
                assert _rel(state[key], jstate[key]) <= STREAM_TOL
            outs.append(mu)
    assert _rel(torch.cat(outs, 1), full) <= STREAM_TOL


def test_get_sequence_encoding_matches_jax(encoders):
    flax, v, port, x = encoders
    want = jax.jit(lambda v, x: flax.apply(
        v, x, 9, method="get_sequence_encoding"))(v, jnp.asarray(x))
    with torch.no_grad():
        got = port.get_sequence_encoding(torch.as_tensor(x), 9)
    assert got.shape == (2, 10, 32)
    assert _rel(got, want) <= STREAM_TOL


def test_target_encoder_forward_matches_jax():
    """TargetEncoder alone (its LSTM as one wavefront), eval mode, against
    JAX's TargetEncoder.__call__: mu and the clipped logvar."""
    flax = JaxTargetEncoder(lstm_hidden_dim=H, lstm_num_layers=LAYERS)
    y_st, y_ph = _x((2, 12, 43), 14), _x((2, 12, 44), 15)
    v = _flax_vars(flax, 16, jnp.asarray(y_st), jnp.asarray(y_ph),
                   train=False)
    want = jax.jit(lambda v, *y: flax.apply(v, *y, train=False))(
        v, jnp.asarray(y_st), jnp.asarray(y_ph))
    port = load_flax_variables(TargetEncoder(H, LAYERS), v).eval()
    with torch.no_grad():
        got = port(torch.as_tensor(y_st), torch.as_tensor(y_ph))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= STREAM_TOL


def test_stream_needs_eval_mode(encoders):
    _, _, port, x = encoders
    port.train()
    try:
        with pytest.raises(RuntimeError, match="eval"):
            port.stream(torch.as_tensor(x[:, :3]),
                        source_stream_init_state(2, LAYERS, H))
    finally:
        port.eval()


def _chained(model, x, chunks=CHUNKS):
    state = model.init_source_stream_state(x.shape[0])
    outs = []
    for lo, hi in chunks:
        mu, state = model.encode_source_stream(x[:, lo:hi], state)
        outs.append(mu)
    return torch.cat(outs, 1), state


def test_encode_source_stream_matches_encode():
    """SeqVaeTeb.encode_source_stream chained over uneven chunks against
    the mu_x of `encode` (the two LSTMs as one wavefront)."""
    model = init_parameters(SeqVaeTeb(lstm_hidden_dim=H, lstm_num_layers=LAYERS,
                                      seq_len=24), seed=3).eval()
    y_st, y_ph, x = (torch.as_tensor(_x((2, 24, c), 10 + c))
                     for c in (43, 44, 130))
    with torch.no_grad():
        want = model.encode(y_st, y_ph, x)["mu_x"]
        got, state = _chained(model, x)
    assert _rel(got, want) <= STREAM_TOL
    assert state["h"].dtype == torch.float32


def test_bf16_stream_matches_full():
    """The bf16 policy's stream, carrying a bf16 state, against its own
    full-sequence source encode."""
    model = init_parameters(SeqVaeTeb(lstm_hidden_dim=H, lstm_num_layers=LAYERS,
                                      seq_len=24, dtype=torch.bfloat16),
                            seed=4).eval()
    x = torch.as_tensor(_x((2, 24, 130), 12))
    with torch.no_grad():
        want = model.source_encoder(x)
        got, state = _chained(model, x)
    assert got.dtype == want.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16
               for t in (state["h"], state["c"], *state["conv_tails"]))
    assert _rel(got.float(), want.float()) <= BF16_TOL


@pytest.mark.parametrize("c,n,stride,new_len", [(48, 10, 16, 200),
                                                (20, 6, 8, 64)])
def test_stitch_predictions_matches_jax(c, n, stride, new_len):
    """The NaN-marked stack and the NaN-mean: NaN at the same places,
    values within 1e-6; also `SeqVaeTeb.get_predictions`."""
    x = _x((2, n, c), 13)
    ws, wm = (np.asarray(a) for a in jax_stitch(jnp.asarray(x), stride,
                                                new_len))
    for fn in (stitch_predictions, SeqVaeTeb.get_predictions):
        gs, gm = (a.numpy() for a in fn(torch.as_tensor(x), stride, new_len))
        assert gs.shape == ws.shape and gm.shape == wm.shape
        np.testing.assert_array_equal(np.isnan(gs), np.isnan(ws))
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
        np.testing.assert_allclose(gm, wm, rtol=0, atol=1e-6)
