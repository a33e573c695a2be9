"""The port's exact (full-rate) frontend and order-2 scattering against the
JAX package, the golden fixtures and a float64 oracle, fed the same
numpy-seeded inputs.

Bars are the JAX package's own (tests/test_phase.py, tests/test_scattering.py):
scattering 2e-5 of max; the golden phase correlations at `TOL` of max;
the selected phase family (integer acceleration powers) at rel-L2 1e-4;
the cross family, whose non-integer powers are chaotic in fp32, against
the float64 oracle at the torch reference's own distance, 3.3e-2.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_teb_tpu.ops import PhaseScattering1D as JaxPhase
from vae_teb_tpu.ops import Scattering1D as JaxScattering
from vae_teb_tpu.ops import analyze_scattering_frequencies as jax_freqs
from vae_teb_tpu.ops import channel_labels as jax_labels
from vae_teb_tpu.ops import physiological_band as jax_band
from vae_teb_tpu_torch import WindowFrontend, production_frontend
from vae_teb_tpu_torch.ops import (PhaseScattering1D, Scattering1D,
                                   analyze_scattering_frequencies,
                                   channel_labels, physiological_band)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import fp64_phase_oracle  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(J=6, Q=2, T=8, shape=1024)
PROD = dict(J=11, Q=4, T=16, shape=5760)
TOL = {"small_o2_phase": 1.2e-2, "small_o2_cross": 1.1e-1,
       "prod_phase": 3e-2, "prod_cross": 8e-2}
SCAT_REL = 2e-5       # scattering: max-abs over max
PHASE_L2 = 1e-4       # selected phase family, rel-L2
CROSS_ORACLE = 3.3e-2  # cross family vs the float64 oracle, rel-L2
CROSS_L2 = 5e-2       # cross family between fp32 implementations, rel-L2


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _subsets(sc):
    sel = sc.optimal_fhr_selection()
    return (tuple(int(i) for i in sel["phase_selection"]["selected_indices"]),
            tuple(int(i) for i in sel["cross_selection"]["selected_indices"]))


def _golden_model(g, **kw):
    return PhaseScattering1D(int(g["J"]), int(g["Q"]), int(g["T"]),
                             int(g["N"]), max_order=int(g["max_order"]), **kw)


def _noise(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- order-2 scattering --------------------------------------------------------

@pytest.mark.parametrize("oversampling", [0, 1])
def test_scattering_order2_matches_jax(oversampling):
    """Order 2 (the JAX default) on a (B, C, N) batch, with and without
    oversampling: coefficients at 2e-5 of max, metadata equal."""
    kw = dict(SMALL, oversampling=oversampling)
    x = _noise((2, 3, SMALL["shape"]))
    sc_j, sc_t = JaxScattering(**kw), Scattering1D(**kw)
    want = np.asarray(sc_j(jnp.asarray(x)))
    got = sc_t(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (2, 3, sc_j.output_channels,
                                       sc_j.n_out)
    assert sc_t.output_channels == sc_j.output_channels
    assert _max_rel(got, want) < SCAT_REL
    meta_j, meta_t = sc_j.meta(), sc_t.meta()
    assert meta_t["key"] == meta_j["key"]
    for k in ("order", "xi", "sigma", "j", "n"):
        np.testing.assert_array_equal(meta_t[k], meta_j[k], err_msg=k)


@pytest.mark.parametrize("name", ["small_o2_phase", "small_o2_cross"])
def test_scattering_order2_golden(name, golden_loader):
    """The torch reference's order-2 scattering at 2e-5 of max."""
    g = golden_loader(name)
    sc = Scattering1D(int(g["J"]), int(g["Q"]), int(g["T"]), int(g["N"]),
                      max_order=int(g["max_order"]))
    x = g["x"][:, 0, :] if g["x"].ndim == 3 else g["x"]
    got = sc(torch.as_tensor(x, dtype=torch.float32)).numpy()
    assert got.shape == g["scattering"].shape
    assert _max_rel(got, g["scattering"]) < SCAT_REL


# -- the exact frontend on the golden fixtures ---------------------------------

@pytest.mark.parametrize("name", ["small_o2_phase", "small_o2_cross",
                                  "prod_phase", "prod_cross"])
def test_exact_all_pairs_golden(name, golden_loader):
    """All pairs through `__call__` at the JAX package's golden bars, and
    the scattering (order 2 on the small fixtures) at 2e-5 of max."""
    g = golden_loader(name)
    m = _golden_model(g)
    x = torch.as_tensor(g["x"])
    if name.endswith("cross"):
        out = m(x, compute_phase=False, compute_cross_phase=True)
        key = "cross_phase_corr"
    else:
        out = m(x, compute_phase=True)
        key = "phase_corr"
    got, ref = out[key].numpy(), g[key]
    assert got.shape == ref.shape
    assert _max_rel(got, ref) < TOL[name]
    assert _max_rel(out["scattering"].numpy(), g["scattering"]) < SCAT_REL


def test_default_flags_and_validation():
    """JAX's defaults: exact rate, first order, phase family only; both
    families when both flags are set; bad shapes raise."""
    m = PhaseScattering1D(**SMALL)
    assert not m.reduced_rate and m.scattering.max_order == 1
    assert Scattering1D(**SMALL).max_order == 2
    x = torch.as_tensor(_noise((2, 2, SMALL["shape"]), 4))
    out = m(x, compute_phase=True, compute_cross_phase=True)
    assert set(out) == {"scattering", "phase_corr", "cross_phase_corr"}
    alone = m(x[:, 0], compute_phase=True, compute_scattering=False)
    assert set(alone) == {"phase_corr"}
    torch.testing.assert_close(out["phase_corr"], alone["phase_corr"],
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="signal length"):
        m(x[..., :-1])
    with pytest.raises(ValueError, match="requires"):
        m(x[:, 0], compute_cross_phase=True)
    with pytest.raises(ValueError, match="input must be"):
        m(x[None])


@pytest.mark.parametrize("family", ["phase", "cross"])
def test_subset_equals_masked_full(family, golden_loader):
    """Computing only the selected pairs equals masking the all-pairs
    output (1e-6 of max)."""
    g = golden_loader(f"small_o2_{family}")
    m = _golden_model(g)
    idx = _subsets(m)[family == "cross"]
    x = torch.as_tensor(g["x"])
    kw = (dict(compute_phase=True) if family == "phase" else
          dict(compute_phase=False, compute_cross_phase=True))
    key = "phase_corr" if family == "phase" else "cross_phase_corr"
    full = m(x, **kw)[key].numpy()
    sub_kw = {f"{family}_subset": idx}
    sub = m(x, **kw, **sub_kw)[key].numpy()
    np.testing.assert_allclose(sub, full[:, list(idx)], rtol=0,
                               atol=1e-6 * np.abs(full).max())


def test_phi_decimate_operator_matches_fft_path(monkeypatch):
    """The dense decimation operator reproduces the pad -> FFT -> phi ->
    truncated IFFT -> unpad chain it replaces (1e-5 of max)."""
    m = PhaseScattering1D(**SMALL)
    rng = np.random.default_rng(3)
    cr, ci = (torch.as_tensor(rng.standard_normal((2, 5, SMALL["shape"]))
                              .astype(np.float32)) for _ in range(2))
    out_mat = m._phi_decimate(cr, ci)
    monkeypatch.setattr(m, "_decimation_operators", lambda: None)
    out_fft = m._phi_decimate(cr, ci)
    assert out_mat.shape == out_fft.shape
    assert _max_rel(out_mat.numpy(), out_fft.numpy()) < 1e-5


def test_cross_products_without_low_pass_match_jax():
    """`cross_phase_correlation(apply_low_pass=False)`: the real part of
    the full-rate accelerated products (B, P, N). Before the low-pass
    cancels them down to a small residual, the two packages agree far
    inside the cross family's bar (measured 3.2e-6): held at 1e-4."""
    sc_j, sc_t = JaxPhase(**SMALL, max_order=1), PhaseScattering1D(**SMALL)
    idx = _subsets(sc_t)[1]
    x = _noise((2, 2, SMALL["shape"]), 8)
    want = np.asarray(sc_j.cross_phase_correlation(
        sc_j._filter_all(jnp.asarray(x)), idx, apply_low_pass=False))
    got = sc_t.cross_phase_correlation(sc_t._filter_all(torch.as_tensor(x)),
                                       idx, apply_low_pass=False)
    assert got.shape == want.shape == (2, len(idx), SMALL["shape"])
    assert _rel_l2(got, want) < 1e-4


def test_verify_properties(golden_loader):
    g = golden_loader("small_o2_phase")
    res = _golden_model(g).verify_phase_correlation_properties(g["x"],
                                                               tol=1e-3)
    assert res["passed"], res["details"]


def test_tukey_window_applied():
    """The window reaches every family, as in the JAX package."""
    kw = dict(SMALL, tukey_alpha=0.2)
    x = _noise((2, 2, SMALL["shape"]), 6)
    want = JaxPhase(**kw)(jnp.asarray(x), compute_phase=True,
                          compute_cross_phase=True)
    got = PhaseScattering1D(**kw)(torch.as_tensor(x), compute_phase=True,
                                  compute_cross_phase=True)
    assert _max_rel(got["scattering"].numpy(), want["scattering"]) < SCAT_REL
    assert _max_rel(got["phase_corr"].numpy(),
                    want["phase_corr"]) < TOL["small_o2_phase"]
    assert _max_rel(got["cross_phase_corr"].numpy(),
                    want["cross_phase_corr"]) < TOL["small_o2_cross"]


def test_analyze_matches_forward_paths(golden_loader):
    """The fused exact `analyze` agrees with the separate `__call__` subset
    paths (shared band computation, one decimation)."""
    g = golden_loader("small_o2_cross")
    m = _golden_model(g)
    p_idx, c_idx = _subsets(m)
    x = torch.as_tensor(g["x"])
    fused = m.analyze(x[:, 0], x[:, 1], phase_subset=p_idx,
                      cross_subset=c_idx)
    ref_ph = m(x[:, 0], compute_phase=True, phase_subset=p_idx)
    ref_cr = m(x, compute_phase=False, compute_cross_phase=True,
               cross_subset=c_idx, compute_scattering=False)
    for key, ref, rtol, atol in (("scattering", ref_ph, 2e-5, 1e-6),
                                 ("phase_corr", ref_ph, 2e-4, 1e-5),
                                 ("cross_phase_corr", ref_cr, 2e-4, 1e-5)):
        np.testing.assert_allclose(fused[key].numpy(), ref[key].numpy(),
                                   rtol=rtol, atol=atol, err_msg=key)


def test_reduced_matches_exact():
    """Reduced rate against exact, as the JAX suite holds them: scattering
    identical, phase family rel-L2 1e-4, cross 5e-2 (white noise); the
    reduced `__call__` subset paths run the same plan as `analyze`."""
    e = PhaseScattering1D(**SMALL)
    r = PhaseScattering1D(**SMALL, reduced_rate=True)
    p_idx, c_idx = _subsets(e)
    x = torch.as_tensor(_noise((2, 2, SMALL["shape"])))
    a = e.analyze(x[:, 0], x[:, 1], phase_subset=p_idx, cross_subset=c_idx)
    b = r.analyze(x[:, 0], x[:, 1], phase_subset=p_idx, cross_subset=c_idx)
    assert torch.equal(a["scattering"], b["scattering"])
    assert _rel_l2(b["phase_corr"], a["phase_corr"]) < PHASE_L2
    assert _rel_l2(b["cross_phase_corr"], a["cross_phase_corr"]) < CROSS_L2
    f = r(x, compute_phase=True, compute_cross_phase=True,
          phase_subset=p_idx, cross_subset=c_idx, compute_scattering=False)
    for key in ("phase_corr", "cross_phase_corr"):
        np.testing.assert_allclose(f[key].numpy(), b[key].numpy(), rtol=0,
                                   atol=1e-5 * b[key].abs().max().item())


def test_oracle_copy_matches_jax_suite(golden_loader):
    """The smoke's float64 oracle equals the JAX suite's
    (tests/test_phase.py::_fp64_phase_oracle)."""
    from test_phase import _fp64_phase_oracle
    g = golden_loader("small_o2_cross")
    sc_j, sc_t = JaxPhase(**SMALL, max_order=1), PhaseScattering1D(**SMALL)
    x64 = np.asarray(g["x"], np.float64)
    for idx, cross in zip(_subsets(sc_t), (False, True)):
        want = _fp64_phase_oracle(sc_j, x64, idx, cross)
        got = fp64_phase_oracle(sc_t, x64, idx, cross)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def _check_exact_against_jax(cfg, x, corr=None):
    """The exact `analyze` of both packages on the same windows: scattering
    2e-5 of max, phase family rel-L2 1e-4 between them, cross family
    within 3.3e-2 of the float64 oracle (and 5e-2 of JAX). Returns the
    port's and JAX's cross-family oracle distances."""
    jax_dt, torch_dt = {None: (None, None),
                        "bf16": (jnp.bfloat16, torch.bfloat16)}[corr]
    sc_j = JaxPhase(**cfg, max_order=1, correlation_dtype=jax_dt)
    sc_t = PhaseScattering1D(**cfg, correlation_dtype=torch_dt)
    p_idx, c_idx = _subsets(sc_t)
    want = sc_j.analyze(jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]),
                        phase_subset=p_idx, cross_subset=c_idx)
    got = sc_t.analyze(torch.as_tensor(x[:, 0]), torch.as_tensor(x[:, 1]),
                       phase_subset=p_idx, cross_subset=c_idx)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == torch.float32
    assert _max_rel(got["scattering"].numpy(), want["scattering"]) < SCAT_REL
    assert _rel_l2(got["phase_corr"], want["phase_corr"]) < PHASE_L2
    assert _rel_l2(got["cross_phase_corr"],
                   want["cross_phase_corr"]) < CROSS_L2
    oracle = fp64_phase_oracle(sc_t, x.astype(np.float64), c_idx, True)
    d_t = _rel_l2(got["cross_phase_corr"], oracle)
    d_j = _rel_l2(want["cross_phase_corr"], oracle)
    assert d_t < CROSS_ORACLE, (d_t, d_j)
    return d_t, d_j


@pytest.mark.parametrize("source", ["noise", "golden"])
def test_exact_matches_jax_small(source, golden_loader):
    x = (_noise((2, 2, SMALL["shape"])) if source == "noise"
         else np.asarray(golden_loader("small_o2_cross")["x"], np.float32))
    _check_exact_against_jax(SMALL, x)


@pytest.mark.slow
def test_exact_matches_jax_prod(golden_loader):
    x = np.asarray(golden_loader("prod_cross")["x"], np.float32)
    _check_exact_against_jax(PROD, x)


# -- bf16 correlation products -------------------------------------------------

def test_bf16_correlation_close_to_fp32():
    """bf16 products with fp32 accumulation stay within 2e-3 (rel-L2) of the
    exact fp32 path and leave the scattering bit-identical."""
    m32 = PhaseScattering1D(**SMALL)
    mbf = PhaseScattering1D(**SMALL, correlation_dtype=torch.bfloat16)
    p_idx, c_idx = _subsets(m32)
    x = torch.as_tensor(_noise((4, 2, SMALL["shape"])))
    a = m32.analyze(x[:, 0], x[:, 1], phase_subset=p_idx, cross_subset=c_idx)
    b = mbf.analyze(x[:, 0], x[:, 1], phase_subset=p_idx, cross_subset=c_idx)
    assert torch.equal(a["scattering"], b["scattering"])
    for key in ("phase_corr", "cross_phase_corr"):
        assert b[key].dtype == torch.float32
        assert _rel_l2(b[key], a[key]) < 2e-3, key


def test_bf16_correlation_matches_jax_bf16():
    """The bf16 mode of both packages: phase family rel-L2 1e-4 between
    them (the products round at the same points), cross within the
    oracle bar."""
    _check_exact_against_jax(SMALL, _noise((2, 2, SMALL["shape"]), 7), "bf16")


def test_bf16_correlation_all_pairs_path():
    """correlation_dtype also applies on the all-pairs paths."""
    m32 = PhaseScattering1D(**SMALL)
    mbf = PhaseScattering1D(**SMALL, correlation_dtype=torch.bfloat16)
    x = torch.as_tensor(_noise((2, 2, SMALL["shape"]), 1))
    for fn, sig in ((lambda m, f: m.phase_correlation(f), x[:, 0]),
                    (lambda m, f: m.cross_phase_correlation(f), x)):
        a = fn(m32, m32._filter_all(sig))
        b = fn(mbf, mbf._filter_all(sig))
        assert b.dtype == torch.float32
        assert 0 < _rel_l2(b, a) < 2e-3   # 0 <: the cast happened


def test_bf16_correlation_fft_fallback_casts_back(monkeypatch):
    """Without a dense operator the bf16 products are cast back to fp32
    before the FFT chain."""
    m = PhaseScattering1D(**SMALL, correlation_dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    cr, ci = (torch.as_tensor(rng.standard_normal((2, 3, SMALL["shape"])),
                              dtype=torch.bfloat16) for _ in range(2))
    want = m._phi_decimate(cr, ci)      # bf16 operator path
    monkeypatch.setattr(m, "_decimation_operators", lambda: None)
    got = m._phi_decimate(cr, ci)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel_l2(got, want) < 2e-3


@pytest.mark.slow
def test_bf16_correlation_production_shapes(golden_loader):
    """Production shapes: bf16 within one bf16 ulp (4e-3 rel-L2) of fp32."""
    g = golden_loader("prod_cross")
    m32 = PhaseScattering1D(**PROD)
    mbf = PhaseScattering1D(**PROD, correlation_dtype=torch.bfloat16)
    p_idx, c_idx = _subsets(m32)
    x = torch.as_tensor(g["x"])
    a = m32.analyze(x[:, 0], x[:, 1], phase_subset=p_idx, cross_subset=c_idx)
    b = mbf.analyze(x[:, 0], x[:, 1], phase_subset=p_idx, cross_subset=c_idx)
    assert torch.equal(a["scattering"], b["scattering"])
    for key in ("phase_corr", "cross_phase_corr"):
        assert _rel_l2(b[key], a[key]) < 4e-3, key


# -- which frontend the entry points use ---------------------------------------

def test_production_frontend_is_reduced_rate(monkeypatch):
    """Serving and training use the reduced-rate, first-order frontend
    with fp32 products, set explicitly: the frontend's own defaults are
    the exact rate. Like the other entry points it runs on the card
    unless the caller names another device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        production_frontend()
    sc = production_frontend("cpu")
    assert sc.device == torch.device("cpu")
    assert sc.reduced_rate and sc.scattering.max_order == 1
    assert sc.correlation_dtype is None
    assert (sc.J, sc.Q, sc.T, sc.N) == (11, 4, 16, 5760)
    assert sc.scattering.output_channels == 43
    p_idx, c_idx = _subsets(sc)
    assert (len(p_idx), len(c_idx)) == (44, 130)


def test_window_frontend_runs_both_rates():
    """WindowFrontend builds the reduced plan up front and runs whichever
    pipeline its frontend has."""
    x = torch.as_tensor(_noise((2, 2, SMALL["shape"]), 5))
    outs = []
    for reduced in (True, False):
        sc = PhaseScattering1D(**SMALL, reduced_rate=reduced)
        wf = WindowFrontend(sc)
        assert bool(sc._plans) == reduced
        outs.append(wf(x[:, 0], x[:, 1]))
    for a, b in zip(*outs):
        assert a.shape == b.shape
    assert _rel_l2(outs[0][1], outs[1][1]) < PHASE_L2


# -- frequency annotation ----------------------------------------------------

@pytest.mark.parametrize("cfg", [(6, 2, 8), (11, 4, 16)])
def test_frequency_analysis_matches_jax(cfg):
    want, got = jax_freqs(*cfg), analyze_scattering_frequencies(*cfg)
    assert got == want
    for order in (1, 2):
        assert channel_labels(got, order) == jax_labels(want, order)
    for f in (0.05, 0.3, 0.7, 1.5, 3.0):
        assert physiological_band(f) == jax_band(f)
