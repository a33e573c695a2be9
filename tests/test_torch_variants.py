"""The forecast and predict-st families against the JAX package on the CPU:
the sliding-window and coefficient-window losses, the dilated causal conv
block, each decoder in eval and train mode, both models end to end
(outputs, losses, every gradient and the running statistics), and the
wavefront packing of the decoders' wide LSTMs (U=3 and U=2 units of
H=256, which run on the grid kernels on a card) through the plain
recurrence against JAX's Pallas kernel in interpret mode and its stacked
LSTM.

Inputs come from numpy seeds; weights are the port's seeded init in a
flax tree (structure from `eval_shape`, so nothing compiles for init),
loaded on the port's side with `load_flax_variables`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_teb_tpu.models import blocks as jb
from vae_teb_tpu.models import variants as jv
from vae_teb_tpu_torch import init_parameters
from vae_teb_tpu_torch.convert import load_flax_variables, to_torch_layout, torch_key
from vae_teb_tpu_torch.models import blocks as tb
from vae_teb_tpu_torch.models import variants as tv

torch.set_num_threads(2)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _flat(tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        yield tuple(p.key for p in path), np.asarray(leaf)


def _close(got, want, rel, what=""):
    """max-abs <= rel * max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def _assert_tree_matches(module, tree, kind, bar, what):
    """Every leaf of a flax tree (grads or batch_stats) against the
    module's counterpart within bar(max|flax leaf|); returns the count."""
    named = dict(module.named_parameters())
    named.update(module.named_buffers())
    n = 0
    for path, want in _flat(tree):
        t = named[torch_key(path)]
        got = (t.grad if kind == "grad" else t).detach().numpy()
        want = to_torch_layout(path[-1], want, path)
        assert got.shape == want.shape, path
        err = np.abs(got - want).max()
        scale = max(np.abs(want).max(), 1e-30)
        assert err <= bar(scale), f"{what} {path}: {err} > {bar(scale)}"
        n += 1
    return n


def _flax_variables(jax_module, port_module, *args, **kwargs):
    """A flax variable tree for `jax_module` holding the port module's
    seeded initialization (the tree's structure from eval_shape, so that
    nothing compiles for init); the port module is initialized in
    place."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jax_module.init(
        {"params": key, "sample": key}, *map(jnp.asarray, args), **kwargs))
    sd = init_parameters(port_module, seed=3).state_dict()
    return jax.tree_util.tree_map_with_path(
        lambda path, _: to_torch_layout(
            path[-1].key, sd[torch_key(tuple(p.key for p in path[1:]))].numpy(),
            tuple(p.key for p in path[1:])), shapes)


def _random_stats(variables, seed):
    """The flax variables with random running statistics (var > 0.5), so
    that eval mode normalizes with something other than 0 and 1."""
    r = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (np.abs(r.standard_normal(v.shape)) + 0.5
                      if p[-1].key == "var" else 0.5 * r.standard_normal(v.shape)
                      ).astype(np.float32), variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


# ---------------------------------------------------------------------------
# losses (fp32 on both sides: rtol 1e-6)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,h,length,warmup,dec", [
    (12, 32, 12 * 16 + 32, 3, 16),   # every step after warmup kept
    (20, 24, 200, 2, 8),             # the later steps overflow the signal
    (4, 8, 16, 10, 16)])             # no step kept: 0
def test_sliding_window_nll_matches_jax(s, h, length, warmup, dec):
    mu, lv = _x((2, s, h), 1), _x((2, s, h), 2, 0.3)
    raw = _x((2, length), 3)
    want = float(jv.sliding_window_nll(jnp.asarray(mu), jnp.asarray(lv),
                                       jnp.asarray(raw), warmup, dec))
    got = tv.sliding_window_nll(torch.as_tensor(mu), torch.as_tensor(lv),
                                torch.as_tensor(raw), warmup, dec)
    assert got.dtype == torch.float32
    if want == 0.0:
        assert got.item() == 0.0
    else:
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_future_window_targets_match_jax():
    x = _x((2, 12, 3), 4)
    want = np.asarray(jv.future_window_targets(jnp.asarray(x), 3))
    got = tv.future_window_targets(torch.as_tensor(x), 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 9, 3, 3)


def _st_predictions(seed, s, h, cs=5, cp=6):
    return {"scattering_mu": _x((2, s, h, cs), seed),
            "scattering_logvar": _x((2, s, h, cs), seed + 1, 0.3),
            "phase_harmonic_mu": _x((2, s, h, cp), seed + 2),
            "phase_harmonic_logvar": _x((2, s, h, cp), seed + 3, 0.3)}


@pytest.mark.parametrize("warmup,flags", [(2, (True, True)),
                                          (3, (True, False)),
                                          (3, (False, True)),
                                          (9, (True, True))])   # guard
def test_predict_st_loss_matches_jax(warmup, flags):
    """Both modalities and each alone; warmup 9 with S=12 and H=3 leaves
    no step (start >= end): every loss 0."""
    s, h = 12, 3
    preds = _st_predictions(5, s, h)
    y_st, y_ph = _x((2, s, 5), 9), _x((2, s, 6), 10)
    want = jv.predict_st_loss({k: jnp.asarray(v) for k, v in preds.items()},
                              jnp.asarray(y_st), jnp.asarray(y_ph), warmup,
                              *flags)
    got = tv.predict_st_loss({k: torch.as_tensor(v) for k, v in preds.items()},
                             torch.as_tensor(y_st), torch.as_tensor(y_ph),
                             warmup, *flags)
    assert set(got) == set(want)
    for k in want:
        if float(want[k]) == 0.0:
            assert got[k].item() == 0.0, k
        else:
            np.testing.assert_allclose(got[k].item(), float(want[k]),
                                       rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("counts,max_m,s", [((32, 32), 0.5, 30.0),
                                            ((100, 10, 3), 0.3, 10.0)])
def test_ldam_loss_matches_jax(counts, max_m, s):
    n, c = 16, len(counts)
    logits = _x((n, c), 11)
    labels = np.random.default_rng(12).integers(0, c, n).astype(np.int32)
    want = float(jv.ldam_loss(jnp.asarray(logits), jnp.asarray(labels),
                              counts, max_m, s))
    got = tv.ldam_loss(torch.as_tensor(logits), torch.as_tensor(labels),
                       counts, max_m, s).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the dilated causal conv block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
def test_dilated_causal_conv_block(dilation):
    """Train mode against flax (outputs and updated batch_stats, 1e-5 of
    max: fp32), with the left pad (k-1) d; then in eval mode, chunks with
    the carried (k-1) d input tail against one full call, and the
    full call against flax's eval mode (1e-6 of max)."""
    k, S = 3, 40
    x = _x((2, S, 4), 13)
    flax_block = jb.CausalConvBlock(6, k, dilation=dilation)
    variables = _random_stats(_flax_variables(
        flax_block, tb.CausalConvBlock(4, 6, k, dilation=dilation), x,
        train=False), 14)
    want, upd = flax_block.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    block = load_flax_variables(tb.CausalConvBlock(4, 6, k, dilation=dilation),
                                variables)
    assert block.conv.pad == (k - 1) * dilation
    got = block.train()(torch.as_tensor(x))
    _close(got.detach().numpy(), want, 1e-5, "train output")
    _assert_tree_matches(block, upd["batch_stats"], "buffer",
                         lambda scale: 1e-5 * scale, "batch_stats")

    block = load_flax_variables(tb.CausalConvBlock(4, 6, k, dilation=dilation),
                                variables).eval()
    want = flax_block.apply(variables, jnp.asarray(x), train=False)
    xt = torch.as_tensor(x)
    with torch.no_grad():
        full = block(xt)
        _close(full.numpy(), want, 1e-6, "eval output")
        pad = (k - 1) * dilation
        tail = torch.zeros((2, pad, 4))
        outs, lo = [], 0
        for n in (1, 7, 13, 19):
            chunk = xt[:, lo:lo + n]
            outs.append(block(chunk, tail))
            tail = torch.cat([tail, chunk], 1)[:, -pad:]
            lo += n
    _close(torch.cat(outs, 1).numpy(), full.numpy(), 1e-6, "chunked")


# ---------------------------------------------------------------------------
# the decoders
# ---------------------------------------------------------------------------

B, S = 3, 10
DECODERS = {
    "direct": (lambda: jv.DirectWindowDecoder(latent_dim=8,
                                              prediction_horizon=12,
                                              hidden=16),
               lambda: tv.DirectWindowDecoder(8, 12, hidden=16)),
    "conv_window": (lambda: jv.ConvWindowDecoder(latent_dim=8,
                                                 prediction_horizon=12,
                                                 feature_channels=4,
                                                 feature_len=3),
                    lambda: tv.ConvWindowDecoder(8, 12, feature_channels=4,
                                                 feature_len=3)),
    "predict_st": (lambda: jv.PredictStDecoder(latent_dim=8,
                                               prediction_horizon=3,
                                               scattering_channels=5,
                                               phase_channels=6, hidden=16,
                                               lstm_layers=2),
                   lambda: tv.PredictStDecoder(8, 3, 5, 6, hidden=16,
                                               lstm_layers=2)),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", sorted(DECODERS))
def test_decoders_match_jax(name, train):
    """Each decoder on flax's weights with random running statistics, in
    eval mode and in train mode (BatchNorm on batch statistics, which
    update). Outputs within 1e-5 of their max in eval mode (fp32; JAX's
    decoders run their LSTM in the stacked schedule, the port in the
    wavefront one: only the order of sums differs) and 1e-4 in train
    mode: the conv-window decoder's six BatchNorms normalize over 30 rows
    with batch statistics and its heads' LayerNorms amplify the 2-3e-6
    the conv stack differs by to 3.1e-5 (measured). The updated
    statistics within 1e-5 of their max."""
    make_jax, make_port = DECODERS[name]
    jm = make_jax()
    z = _x((B, S, 8), 15)
    variables = _random_stats(_flax_variables(jm, make_port(), z,
                                              train=False), 16)
    apply = jax.jit(jm.apply, static_argnames=("train", "mutable"))
    if train:
        want, upd = apply(variables, jnp.asarray(z), train=True,
                          mutable=("batch_stats",))
    else:
        want = apply(variables, jnp.asarray(z), train=False)
    model = load_flax_variables(make_port(), variables).train(train)
    with torch.no_grad():
        got = model(torch.as_tensor(z))
    if name == "predict_st":
        assert set(got) == set(want)
        pairs = [(got[k], want[k], k) for k in want]
    else:
        pairs = [(got[0], want[0], "mu"), (got[1], want[1], "logvar")]
    for g, w, k in pairs:
        _close(g.numpy(), w, 1e-4 if train else 1e-5, k)
    if train:
        _assert_tree_matches(model, upd["batch_stats"], "buffer",
                             lambda scale: 1e-5 * scale, "batch_stats")


# ---------------------------------------------------------------------------
# the models end to end
# ---------------------------------------------------------------------------

SMALL = dict(lstm_hidden_dim=8, lstm_num_layers=2)
MS = 16     # steps


class _JaxForecast16(jv.SeqVaeTebForecast):
    """The JAX forecaster with a 16-wide direct decoder (LSTM(16, 3)),
    which compiles in a fraction of the production width's time."""

    def setup(self):
        jv.SeqVaeTeb.setup(self)
        self.window_decoder = jv.DirectWindowDecoder(
            latent_dim=self.latent_dim_z,
            prediction_horizon=self.prediction_horizon, hidden=16)


class _JaxPredictSt16(jv.SeqVaeTebPredictSt):
    """The JAX predict-st model with a 16-wide decoder (LSTM(16, 2))."""

    def setup(self):
        jv.SeqVaeTeb.setup(self)
        self.st_decoder = jv.PredictStDecoder(
            latent_dim=self.latent_dim_z,
            prediction_horizon=self.prediction_horizon,
            scattering_channels=self.n_scattering,
            phase_channels=self.n_phase, hidden=16)


def _model_case(name, hidden):
    """(JAX model, port model, loss on (outputs, y_st, y_ph, y_raw) for
    either side) with decoders `hidden` wide (256: the production width)."""
    if name == "forecast":
        jm = (jv.SeqVaeTebForecast if hidden == 256 else _JaxForecast16)(
            decoder_type="direct", prediction_horizon=32, **SMALL)
        port = tv.SeqVaeTebForecast(decoder_type="direct",
                                    prediction_horizon=32, seq_len=MS,
                                    **SMALL)
        port.window_decoder = tv.DirectWindowDecoder(32, 32, hidden=hidden)
        return jm, port, lambda lib, out, y_st, y_ph, y_raw: lib.compute_loss(
            out, y_raw, beta=0.3, warmup_period=2)
    jm = (jv.SeqVaeTebPredictSt if hidden == 256 else _JaxPredictSt16)(
        prediction_horizon=4, **SMALL)
    port = tv.SeqVaeTebPredictSt(prediction_horizon=4, seq_len=MS, **SMALL)
    port.st_decoder = tv.PredictStDecoder(32, 4, 43, 44, hidden=hidden)
    return jm, port, lambda lib, out, y_st, y_ph, y_raw: lib.compute_loss(
        out, y_st, y_ph, beta=0.3, warmup_period=2)


def _grad_bar(grads):
    """1e-4 of the leaf's largest entry, or 1e-6 of the largest entry of
    any leaf, whichever is larger (tests/test_torch_train.py's bar)."""
    top = max(np.abs(leaf).max() for _, leaf in _flat(grads))
    return lambda scale: max(1e-4 * scale, 1e-6 * top)


@pytest.mark.parametrize("name,hidden", [
    ("forecast", 16), ("predict_st", 16),
    pytest.param("forecast", 256, marks=pytest.mark.slow),
    pytest.param("predict_st", 256, marks=pytest.mark.slow)])
def test_variant_models_match_jax(name, hidden):
    """SeqVaeTebForecast (direct decoder) and SeqVaeTebPredictSt at S=16,
    B=2, with 16-wide decoders (and, marked slow, at the decoders'
    production width, 256: an LSTM(256, 3) and six 256-wide convs), in
    train mode with z the posterior mean (deterministic): every output
    within 1e-4 of its max (train-mode BatchNorm amplifies rounding, as in
    test_decoders_match_jax), the losses rtol 1e-5, every parameter
    gradient at tests/test_torch_train.py's bar, the updated running
    statistics within 1e-5 of their max (fp32)."""
    jm, model, loss = _model_case(name, hidden)
    cls_j = type(jm)
    cols = [_x((2, MS, c), 20 + i) for i, c in enumerate((43, 44, 130))]
    y_raw = _x((2, 16 * MS), 23)
    variables = _flax_variables(jm, model, *cols, train=False,
                                deterministic=True)

    def loss_fn(params):
        out, upd = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            *map(jnp.asarray, cols), train=True,
                            deterministic=True, mutable=["batch_stats"])
        losses = loss(cls_j, out, jnp.asarray(cols[0]), jnp.asarray(cols[1]),
                      jnp.asarray(y_raw))
        return losses["total_loss"], (losses, out, upd["batch_stats"])

    (_, (want, out_j, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])

    model = load_flax_variables(model, variables).train()
    t = [torch.as_tensor(c) for c in cols]
    out = model(*t, deterministic=True)
    got = loss(type(model), out, t[0], t[1], torch.as_tensor(y_raw))
    got["total_loss"].backward()
    assert set(out) == set(out_j)
    for k in out_j:
        _close(out[k].detach().numpy(), out_j[k], 1e-4, k)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    n = _assert_tree_matches(model, grads, "grad", _grad_bar(grads), "grad")
    assert n == sum(1 for _ in model.parameters())
    _assert_tree_matches(model, stats, "buffer", lambda scale: 1e-5 * scale,
                         "batch_stats")


def test_variant_models_carry_no_raw_decoder():
    """flax never creates the raw Decoder's parameters in the variants, and
    the port builds none (no 16 S-wide heads)."""
    for model in (tv.SeqVaeTebForecast(prediction_horizon=32, seq_len=MS,
                                       **SMALL),
                  tv.SeqVaeTebPredictSt(prediction_horizon=4, seq_len=MS,
                                        **SMALL)):
        assert not hasattr(model, "decoder")
        assert not any(k.startswith("decoder.") for k in model.state_dict())
    with pytest.raises(ValueError, match="decoder_type"):
        tv.SeqVaeTebForecast(decoder_type="raw")


# ---------------------------------------------------------------------------
# the decoders' wide LSTMs through the wavefront packing
# ---------------------------------------------------------------------------

def _wide_streams(seed, depth, b=2, s=8, h=256):
    """One stream's numpy weights, projected inputs and initial states,
    scaled as tests/test_torch_wavefront.py's H=8 streams are at their
    width (0.3 * sqrt(8 / H))."""
    r = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: (scale * r.standard_normal(shape)
                                   ).astype(np.float32)
    w = 0.3 * np.sqrt(8 / h)
    return dict(xp=f(b, s, 4 * h),
                w_ih=[f(h, 4 * h, scale=w) for _ in range(depth)],
                w_hh=[f(h, 4 * h, scale=w) for _ in range(depth)],
                b=[f(4 * h, scale=0.1) for _ in range(depth)],
                h0=[f(b, h, scale=0.2) for _ in range(depth)],
                c0=[f(b, h, scale=0.2) for _ in range(depth)])


@pytest.mark.parametrize("depth", [3, 2])
def test_wide_lstm_packing_matches_jax(depth):
    """The forecast (3 layers) and predict-st (2 layers) decoders' LSTM
    width, H=256, S=8, B=2: the port's run_lstm_streams (the plain
    wavefront recurrence on the CPU) against the JAX package's Pallas
    wavefront in interpret mode and its stacked LSTM: ys and final
    states within 1e-5 of their max (fp32)."""
    a = _wide_streams(30 + depth, depth)
    stream = lambda cls, wrap: cls(
        wrap(a["xp"]), [wrap(w) for w in a["w_ih"]],
        [wrap(w) for w in a["w_hh"]], [wrap(v) for v in a["b"]],
        (tuple(wrap(h) for h in a["h0"]), tuple(wrap(c) for c in a["c0"])))
    ((ys, (h, c)),) = tb.run_lstm_streams([stream(tb.LSTMStream,
                                                  torch.as_tensor)])
    for schedule in ("wavefront_pallas", "stacked"):
        ((ys_j, (h_j, c_j)),) = jb.run_lstm_streams(
            [stream(jb.LSTMStream, jnp.asarray)], schedule=schedule)
        for g, w, k in ((ys, ys_j, "ys"), (h, h_j, "h"), (c, c_j, "c")):
            _close(g.numpy(), w, 1e-5, f"{schedule} {k}")
