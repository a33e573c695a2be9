"""The port's evaluation slice against the JAX package's evaluator, on the
CPU at the JAX package's own evaluation fixture size: the exact
PhaseScattering1D(J=6, Q=2, T=8, shape=1024, max_order=1), 4 records x 2
windows, trim_minutes=0.5 (15 decimated steps, decimation 8), SeqVaeTeb
with decimation_factor=8 and small LSTMs (H=16, 2 layers per encoder).

One HDF5 file is built by the port's `build_dataset`; both packages read
its stored coefficients and raw traces, and both models hold one set of
weights: the port's seeded initialization laid out as a flax tree (the
tree's structure from `eval_shape`, so nothing compiles for init), loaded
into the port model through `convert.load_flax_variables`. The JAX
model runs its default LSTM schedule (a scan), as the JAX package's own
evaluation tests do.

Bars (each test states the values it measured):
- metrics, the numpy copies and coefficient_error_stats: 1e-6 relative;
- decode, the analyses on stored coefficients, seqvae_mse_test: 1e-4 of
  each output's max;
- te_shift_analysis / up_gain_sweep, each package through its own exact
  frontend: 5e-2 relative per entry, test_torch_slice.py's cross-family
  bar (the cross family's non-integer phase acceleration is chaotic in
  fp32); the gain-0 column at 1e-4 of max, since UP x 0 makes every cross
  product exactly zero before normalization.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vae_teb_tpu.eval as je
import vae_teb_tpu_torch.cli as torch_cli
import vae_teb_tpu_torch.eval as te
from vae_teb_tpu.data import load_stats as jax_load_stats
from vae_teb_tpu.models import SeqVaeTeb as JaxSeqVaeTeb
from vae_teb_tpu.models.vae_teb import Decoder as JaxDecoder
from vae_teb_tpu.ops import PhaseScattering1D as JaxPhase
from vae_teb_tpu_torch import SeqVaeTeb, init_parameters
from vae_teb_tpu_torch.convert import (load_flax_variables, to_torch_layout,
                                       torch_key)
from vae_teb_tpu_torch.data import (CombinedHDF5Dataset,
                                    DatasetStatsCalculator, build_dataset)
from vae_teb_tpu_torch.models import Decoder
from vae_teb_tpu_torch.ops import PhaseScattering1D

torch.set_num_threads(2)

FRONTEND = dict(J=6, Q=2, T=8, shape=1024, max_order=1)
TRIM_MINUTES, TRIM_DEC, DEC = 0.5, 15, 8
LSTM = dict(lstm_hidden_dim=16, lstm_num_layers=2)
CPU = "cpu"


def _flax_tree(flax_module, port_module, *inputs, **kw):
    """A flax variable tree of `flax_module` holding `port_module`'s
    weights (structure from eval_shape)."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: flax_module.init(
        {"params": key, "sample": key}, *inputs, **kw))
    sd = port_module.state_dict()
    return jax.tree_util.tree_map_with_path(
        lambda path, _: to_torch_layout(path[-1].key, sd[torch_key(
            tuple(p.key for p in path[1:]))].numpy()), shapes)


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_eval")
    path, stats_path = str(d / "eval.h5"), str(d / "stats.h5")
    sc = PhaseScattering1D(**FRONTEND)
    build_dataset(path, n_records=4, windows_per_record=2, len_signal=1024,
                  seed=3, transform=sc, device=CPU)
    calc = DatasetStatsCalculator(trim_minutes=TRIM_MINUTES, decimation=DEC)
    calc.save_stats(calc.calculate_stats([path]), stats_path)

    sel = sc.optimal_fhr_selection()
    cross = sel["cross_selection"]["selected_indices"]
    dims = dict(n_scattering=sc.scattering.output_channels,
                n_phase=sel["phase_selection"]["n_selected"],
                input_channels=sel["cross_selection"]["n_selected"])
    seq = sc.scattering.n_out - 2 * TRIM_DEC
    model = init_parameters(SeqVaeTeb(**dims, **LSTM, seq_len=seq,
                                      decimation_factor=DEC), seed=5)
    jm = JaxSeqVaeTeb(**dims, **LSTM, decimation_factor=DEC)
    variables = _flax_tree(jm, model, *(jnp.zeros((1, seq, dims[k])) for k in
                                        ("n_scattering", "n_phase",
                                         "input_channels")), train=False)
    model = load_flax_variables(SeqVaeTeb(**dims, **LSTM, seq_len=seq,
                                          decimation_factor=DEC), variables)

    trimmed = CombinedHDF5Dataset(path, stats_path=stats_path,
                                  trim_minutes=TRIM_MINUTES, decimation=DEC,
                                  cache_size=0)
    raw = CombinedHDF5Dataset(path, stats_path=stats_path, cache_size=0,
                              normalize_fields=("fhr_st", "fhr_ph",
                                                "fhr_up_ph"),
                              allow_stats_trim_mismatch=True)
    port = te.ModelEvaluator(model, scattering=sc, stats=trimmed.stats,
                             cross_subset=cross, trim_decimated=TRIM_DEC,
                             device=CPU)
    jax_ev = je.ModelEvaluator(jm, variables, scattering=JaxPhase(**FRONTEND),
                               stats=jax_load_stats(stats_path),
                               cross_subset=cross, trim_decimated=TRIM_DEC)
    return types.SimpleNamespace(port=port, jax=jax_ev, trimmed=trimmed,
                                 raw=raw, path=path, stats_path=stats_path,
                                 dims=dims, seq=seq)


def _batches(ds, size=2):
    return list(ds.as_batches(batch_size=size, shuffle=False,
                              drop_last=False))


# -- metrics ---------------------------------------------------------------

def test_metrics_match_jax():
    """reconstruction_metrics on tensors, the numpy helpers and
    coefficient_error_stats, against the JAX package's on the same inputs
    (1e-6 relative; measured 2.9e-7 and below)."""
    r = np.random.default_rng(0)
    x = r.standard_normal((4, 256)).astype(np.float32)
    y = x + 0.3 * r.standard_normal((4, 256)).astype(np.float32)
    y[3] = x[3]                                   # the 100 dB cap
    got = te.reconstruction_metrics(torch.as_tensor(x), torch.as_tensor(y))
    want = je.reconstruction_metrics(jnp.asarray(x), jnp.asarray(y))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert got["snr_db"][3].item() == 100.0

    a, b = r.standard_normal((3, 10, 2)), r.standard_normal((3, 10, 2))
    assert te.calculate_vaf(a, b) == pytest.approx(je.calculate_vaf(a, b),
                                                   rel=1e-6)
    lv = r.uniform(-1, 1, a.shape)
    assert te.gaussian_log_likelihood(a, b, lv) == pytest.approx(
        je.gaussian_log_likelihood(a, b, lv), rel=1e-6)
    np.testing.assert_allclose(te.interpolate_latent(a[0], b[0], 5),
                               je.interpolate_latent(a[0], b[0], 5), rtol=1e-6)
    np.testing.assert_array_equal(te.discretize_signal(a.ravel(), 7),
                                  je.discretize_signal(a.ravel(), 7))
    assert te.gaussian_mutual_information(a, b + a) == pytest.approx(
        je.gaussian_mutual_information(a, b + a), rel=1e-6)
    xm = r.standard_normal((50, 20, 3))
    zm = np.concatenate([xm[:, :, :1], r.standard_normal((50, 20, 1))], 2)
    np.testing.assert_allclose(te.histogram_mutual_information(xm, zm, 8),
                               je.histogram_mutual_information(xm, zm, 8),
                               rtol=1e-6)

    sx = r.standard_normal((3, 5, 40)).astype(np.float32)
    mu = sx + 0.2 * r.standard_normal(sx.shape).astype(np.float32)
    var = r.uniform(0.5, 2.0, sx.shape).astype(np.float32)
    got = te.coefficient_error_stats(sx, mu, var)
    want = je.coefficient_error_stats(sx, mu, var)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)


def test_gaussian_mi_matches_golden():
    """The Gaussian MI estimator against the torch reference's value in
    tests/golden/mi_gaussian.npz, with and without PCA (1e-6 relative;
    the JAX package holds 1e-12 and so does the copy)."""
    g = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "mi_gaussian.npz"))
    for reduce_dim in (False, True):
        ours = te.gaussian_mutual_information(
            g["x"], g["y"], reduce_dim=reduce_dim, n_components_X=10,
            n_components_Y=5)
        want = float(g[f"mi_reduce{int(reduce_dim)}"])
        np.testing.assert_allclose(ours, want, rtol=1e-12)


# -- the model: decode and the configurable widths ----------------------------

@pytest.mark.parametrize("factor, latent", [(8, 32), (16, 16)])
def test_decode_matches_jax(factor, latent):
    """The decoder alone at decimation 8 and 16 (and a 16-wide latent), on
    one set of weights, in eval mode: every output within 1e-4 of its max
    (measured 1.6e-6 at 8, 2.7e-6 at 16)."""
    s, coeff = 12, 11
    dec = init_parameters(Decoder(coeff, s, latent_dim=latent,
                                  upsample_factor=factor), seed=2)
    for i, bn in enumerate(m for m in dec.modules()
                           if type(m).__name__ == "BatchNorm"):
        bn.running_mean.uniform_(-0.2, 0.2)     # non-trivial statistics
        bn.running_var.uniform_(0.5, 1.5)
    jd = JaxDecoder(latent_dim=latent, coeff_channels=coeff,
                    upsample_factor=factor)
    z = np.random.default_rng(1).standard_normal((3, s, latent)).astype(
        np.float32)
    variables = _flax_tree(jd, dec, jnp.zeros((1, s, latent)), train=False)
    want = jax.jit(lambda v, z: jd.apply(v, z, False))(variables, z)
    port = SeqVaeTeb(n_scattering=5, n_phase=6, input_channels=7, **LSTM,
                     seq_len=s, latent_dim_source=latent,
                     latent_dim_target=latent, latent_dim_z=latent,
                     decimation_factor=factor)
    port.decoder.load_state_dict(dec.state_dict())
    with torch.inference_mode():
        got = port.eval().decode(torch.as_tensor(z))
    assert got[1].shape == (3, factor * s)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_max(g.numpy(), w) <= 1e-4


def test_decimation_and_widths_follow_the_config():
    """cli.make_model builds any power-of-two decimation up to 16 and any
    latent widths (the JAX package's rule); other factors raise."""
    from vae_teb_tpu_torch.train import RunConfig
    cfg = RunConfig()
    cfg.model.decimation_factor, cfg.model.latent_dim_source = 4, 12
    cfg.model.latent_dim_target = cfg.model.latent_dim_z = 20
    m = torch_cli.make_model(cfg, seq_len=10)
    assert m.decoder.raw_len == 40
    assert m.source_encoder.mu_layer.dense[-1].out_features == 12
    assert m.target_encoder.logvar_layer.dense[-1].out_features == 40
    assert m.conditional_encoder.mlp.dense[0].in_features == 32
    for bad in (3, 32, 0):
        with pytest.raises(ValueError, match="power of two"):
            Decoder(11, 10, upsample_factor=bad)


# -- the analyses on stored coefficients --------------------------------------

def _outputs_close(got, want, keys, bar=1e-4):
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        assert _rel_max(g, w) <= bar, (k, _rel_max(g, w))


def test_analyze_sample_matches_jax(setup):
    """Forward outputs and the (B, S, D) TE map of one sample (1e-4 of
    max; measured 1.5e-6 on the map, 1.2e-5 on the worst output)."""
    s = setup.trimmed.read_batch([3])
    args = (s["fhr_st"], s["fhr_ph"], s["fhr_up_ph"])
    got = setup.port.analyze_sample(*args)
    want = setup.jax.analyze_sample(*args)
    assert got["te_map"].shape == (1, setup.seq, 32)
    _outputs_close(got, want, ["te_map"])
    _outputs_close(got["outputs"], want["outputs"], want["outputs"])


def test_reconstruction_and_ablation_match_jax(setup):
    """reconstruction_analysis and up_ablation over every window, batch 2
    (1e-4 of max; measured 1.1e-6 and below; VAF is 0 throughout, clipped,
    for this untrained model)."""
    batches = _batches(setup.trimmed)
    got = setup.port.reconstruction_analysis(batches)
    want = setup.jax.reconstruction_analysis(batches)
    assert got["vaf"].shape == (len(setup.trimmed),)
    _outputs_close(got, want, want)
    got, want = setup.port.up_ablation(batches), setup.jax.up_ablation(batches)
    _outputs_close(got, want, want)
    assert not np.allclose(got["te_with_up"], got["te_without_up"])


def test_latent_interpolation_matches_jax(setup, tmp_path):
    """The latent path and its decodings (1e-4 of max; measured 1.6e-5);
    the path starts at the first sample's posterior mean; the grids and
    the GIF land on disk."""
    a, b = setup.trimmed.read_batch([0]), setup.trimmed.read_batch([1])
    a, b = ({k: v[0] for k, v in s.items() if k != "guid"} for s in (a, b))
    prefix, gif = str(tmp_path / "interp"), str(tmp_path / "interp.gif")
    got = setup.port.latent_interpolation(a, b, steps=3, plot_prefix=prefix,
                                          animate_path=gif)
    want = setup.jax.latent_interpolation(a, b, steps=3)
    _outputs_close(got, want, want)
    z0 = setup.port.analyze_sample(a["fhr_st"][None], a["fhr_ph"][None],
                                   a["fhr_up_ph"][None])["outputs"]["z"][0]
    np.testing.assert_allclose(got["z_path"][0], z0, atol=1e-6)
    for f in (prefix + "_z_latent.png", prefix + "_decoder.png", gif):
        assert os.path.exists(f), f


def test_seqvae_mse_test_matches_jax(setup, tmp_path):
    """The coefficient battery of the decoder's linear_output (1e-4 of max;
    measured 7.9e-7), its .npy files and histograms."""
    batches = _batches(setup.trimmed)
    out_dir = str(tmp_path / "battery")
    got = te.seqvae_mse_test(setup.port.model, batches, trim=5,
                             out_dir=out_dir)
    # the JAX battery applies its model eagerly, op by op; hand it the JAX
    # evaluator's jitted forward of the same variables instead
    def apply(variables, y_st, y_ph, x_ph, train, deterministic):
        assert variables is setup.jax.variables
        assert not train and deterministic
        return setup.jax._forward(y_st, y_ph, x_ph)

    want = je.seqvae_mse_test(types.SimpleNamespace(apply=apply),
                              setup.jax.variables, batches, trim=5)
    assert got["mse"].shape == (len(setup.trimmed), setup.dims["n_scattering"]
                                + setup.dims["n_phase"])
    _outputs_close(got, want, want)
    for k in want:
        assert os.path.exists(os.path.join(out_dir, f"error_stats-{k}.npy"))
    assert os.path.exists(os.path.join(out_dir, "error_stats-histograms.png"))
    with pytest.raises(ValueError, match="too short"):
        te.seqvae_mse_test(setup.port.model, batches, trim=setup.seq // 2)


# -- the recompute analyses -------------------------------------------------

SHIFTS, GAINS = (-8, -4, -1, 0), (0.0, 0.5, 1.0, 2.0)


def test_shift_and_gain_match_jax(setup):
    """TE vs UP shift and vs UP gain for two samples (and one sample
    alone), each package through its own exact frontend: 5e-2 relative per
    entry (measured 3.7e-4 shift, 2.3e-4 gain); the gain-0 column at 1e-4
    of max (measured 9.6e-8)."""
    b = setup.raw.read_batch([2, 5])
    args = (b["fhr"], b["up"], b["fhr_st"], b["fhr_ph"])
    got = setup.port.te_shift_analysis(*args, shift_seconds=SHIFTS)["te"]
    want = setup.jax.te_shift_analysis(*args, shift_seconds=SHIFTS)["te"]
    assert got.shape == (2, len(SHIFTS)) and np.all(got >= -1e-5)
    np.testing.assert_allclose(got, want, rtol=5e-2)
    got = setup.port.up_gain_sweep(*args, gains=GAINS)["te"]
    want = setup.jax.up_gain_sweep(*args, gains=GAINS)["te"]
    np.testing.assert_allclose(got, want, rtol=5e-2)
    assert _rel_max(got[:, 0], want[:, 0]) <= 1e-4
    one = setup.port.up_gain_sweep(*(a[1] for a in args), gains=GAINS)
    assert one["te"].shape == (len(GAINS),)
    np.testing.assert_allclose(one["te"], got[1], rtol=1e-5)


def test_shift_zero_is_gain_one_and_the_stored_te(setup):
    """On the port's own file: the shift-0 column equals the gain-1.0
    column (both are TE of the unshifted UP) and agrees with up_ablation's
    te_with_up on the stored coefficients, which the same exact frontend
    wrote (1e-4 of max; measured 1.0e-7)."""
    ids = [0, 6, 7]
    b = setup.raw.read_batch(ids)
    args = (b["fhr"], b["up"], b["fhr_st"], b["fhr_ph"])
    shift0 = setup.port.te_shift_analysis(*args, shift_seconds=(0,))["te"]
    shift0 = shift0[:, 0]
    gain1 = setup.port.up_gain_sweep(*args, gains=(1.0,))["te"][:, 0]
    np.testing.assert_array_equal(shift0, gain1)
    stored = setup.port.up_ablation([setup.trimmed.read_batch(ids)])
    assert _rel_max(shift0, stored["te_with_up"]) <= 1e-4


def test_recompute_needs_frontend_and_stats(setup):
    ev = te.ModelEvaluator(setup.port.model, device=CPU)
    b = setup.raw.read_batch([0])
    with pytest.raises(ValueError, match="scattering"):
        ev.te_shift_analysis(b["fhr"][0], b["up"][0], b["fhr_st"][0],
                             b["fhr_ph"][0])


# -- the suite, cli test and the callbacks ------------------------------------

def test_full_suite_artifacts(setup, tmp_path):
    """The suite writes the JAX package's artifact set
    (tests/test_eval.py::test_full_suite_artifacts)."""
    out_dir = str(tmp_path / "suite")
    results = te.run_evaluation_suite(
        setup.port, setup.trimmed, out_dir, raw_dataset=setup.raw,
        num_samples=4, batch_size=2, shift_samples=1, shift_seconds=[-4, 0],
        gains=(0.0, 1.0))
    for f in ("metrics.pkl", "metrics_histograms.png", "up_ablation.png",
              "te_gain_sweep.png", "coefficient_error_stats-mse.npy",
              "coefficient_error_stats-histograms.png"):
        assert os.path.exists(os.path.join(out_dir, f)), f
    names = os.listdir(out_dir)
    assert sum(f.startswith("analysis_") for f in names) == 4
    assert sum(f.startswith("reconstruction_") for f in names) == 4
    assert sum(f.startswith("te_shift_") for f in names) == 1
    assert results["errors"] == []
    assert results["te_shift"]["te"].shape == (1, 2)
    assert results["gain_sweep"]["te"].shape == (1, 2)
    acc = results["coefficient_acceptance"]
    assert acc["mse"].shape == (4, setup.dims["n_scattering"]
                                + setup.dims["n_phase"])
    assert np.all(np.isfinite(acc["vaf"]))


def test_suite_isolates_per_sample_failures(setup, tmp_path, monkeypatch):
    """A failing per-sample stage is recorded and the rest of the suite
    completes (tests/test_eval.py::test_suite_isolates_per_sample_failures);
    a device fault is not isolated."""
    calls = {"n": 0}

    def flaky(self, *a, **k):
        calls["n"] += 1
        raise RuntimeError("degenerate sample")

    monkeypatch.setattr(te.ModelEvaluator, "te_shift_analysis", flaky)
    results = te.run_evaluation_suite(
        setup.port, setup.trimmed, str(tmp_path / "faulty"),
        raw_dataset=setup.raw, num_samples=4, batch_size=2, shift_samples=2,
        shift_seconds=[-4, 0], gains=(0.0, 1.0), recompute_chunk=1)
    assert calls["n"] == 2
    assert [e["stage"] for e in results["errors"]] == ["te_shift"] * 2
    assert "gain_sweep" in results and "te_shift" not in results

    def oom(self, *a, **k):
        raise torch.OutOfMemoryError("out of memory")

    monkeypatch.setattr(te.ModelEvaluator, "te_shift_analysis", oom)
    with pytest.raises(torch.OutOfMemoryError):
        te.run_evaluation_suite(
            setup.port, setup.trimmed, str(tmp_path / "oom"),
            raw_dataset=setup.raw, num_samples=2, shift_samples=1,
            plot_samples=0)


def test_cli_test_with_scattering(setup, tmp_path, monkeypatch):
    """`cli test --with-scattering` on a tiny config (the fixture's file as
    the test split, 2 samples, a checkpoint of the seeded model) returns 0
    and writes test_results/. The recompute frontend is swapped for the
    fixture's geometry: the command builds the production one."""
    import yaml
    from vae_teb_tpu_torch.train import Checkpointer, load_config
    real = PhaseScattering1D
    monkeypatch.setattr(
        "vae_teb_tpu_torch.ops.PhaseScattering1D",
        lambda J, Q, T, shape, **kw: real(**dict(FRONTEND, **kw)))
    cfg = {"tag": "t", "out_dir_base": str(tmp_path / "runs"),
           "model": dict(setup.dims, decimation_factor=DEC),
           "dataset": {"test_paths": [setup.path],
                       "stat_path": setup.stats_path,
                       "trim_minutes": TRIM_MINUTES, "decimation": DEC,
                       "cache_size": 0}}
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    model = init_parameters(torch_cli.make_model(load_config(str(cfg_path)),
                                                 setup.seq), seed=11)
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save({"model": model.state_dict()}, step=0, metric=1.0)
    rc = torch_cli.main(["test", "--config", str(cfg_path), "--checkpoint",
                         str(tmp_path / "ckpt"), "--num-samples", "2",
                         "--with-scattering", "--device", CPU])
    assert rc == 0
    runs = os.listdir(tmp_path / "runs")
    out = tmp_path / "runs" / runs[0] / "test_results"
    names = os.listdir(out)
    for f in ("metrics.pkl", "up_ablation.png", "te_gain_sweep.png",
              "test.log"):
        assert f in names, f
    assert sum(f.startswith("te_shift_") for f in names) == 2
    assert "restored best checkpoint" in (out / "test.log").read_text()


@pytest.mark.parametrize("argv", [
    ["test", "--config", "c.yaml"],
    ["test", "--config", "c.yaml", "--root", "r", "--checkpoint", "ck",
     "--num-samples", "7", "--bf16-frontend", "--reduced-frontend",
     "--with-scattering"],
    ["train", "--config", "c.yaml"],
    ["train", "--config", "c.yaml", "--plot-every", "0"],
    ["train", "--config", "c.yaml", "--model-parallel", "2", "--multihost"],
], ids=["test-defaults", "test-all", "train-defaults", "train-plot-every",
        "train-mesh"])
def test_cli_parsers_match_jax(monkeypatch, argv):
    """`test` takes JAX's flags with JAX's defaults, and `train` JAX's
    --plot-every, --model-parallel and --multihost; the port adds --device
    (default: the card)."""
    import vae_teb_tpu.cli as jax_cli
    seen = {}
    fn = {"test": "cmd_test", "train": "cmd_train"}[argv[0]]
    for name, mod in (("jax", jax_cli), ("torch", torch_cli)):
        monkeypatch.setattr(mod, fn, lambda args, name=name: seen.__setitem__(
            name, vars(args)) or 0)
        assert mod.main(argv) == 0
    got = {k: v for k, v in seen["torch"].items() if k != "fn"}
    want = {k: v for k, v in seen["jax"].items() if k != "fn"}
    assert got.pop("device") is None
    if argv[0] == "train" and "--multihost" not in argv:
        assert got["model_parallel"] == 1 and got["multihost"] is False
    assert got == want


def test_callbacks_write_figures(setup, tmp_path):
    """LossCurveCallback and ReconstructionPlotCallback write their figures;
    the plot forward runs on the trainer's device and leaves the model in
    the mode it found."""
    from vae_teb_tpu_torch.train import (LossCurveCallback,
                                         ReconstructionPlotCallback)
    model = setup.port.model
    trainer = types.SimpleNamespace(
        model=model, device=torch.device(CPU),
        history={"epoch": [0, 1], "train/total_loss": [2.0, 1.5],
                 "val/total_loss": [2.2, 1.7]})
    curve = str(tmp_path / "loss.png")
    cb = LossCurveCallback(curve, every=2)
    cb.on_epoch_end(trainer, 1)
    assert not os.path.exists(curve)
    cb.on_epoch_end(trainer, 0)
    assert os.path.exists(curve)
    batch = setup.trimmed.read_batch([0, 1, 2])
    rec = ReconstructionPlotCallback(str(tmp_path / "rec"), batch, every=5)
    model.train()
    try:
        rec.on_epoch_end(trainer, 3)
        rec.on_epoch_end(trainer, 5)
        assert model.training
    finally:
        model.eval()
    assert sorted(os.listdir(tmp_path / "rec")) == [
        "reconstruction_epoch0005_s0.png", "reconstruction_epoch0005_s1.png"]
