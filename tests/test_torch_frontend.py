"""PyTorch frontend port against the JAX package: numpy builders, scattering
and the reduced-rate `analyze`, fed the same numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_teb_tpu.ops import PhaseScattering1D as JaxPhase
from vae_teb_tpu.ops import Scattering1D as JaxScattering
from vae_teb_tpu.ops import build_filter_bank as jax_filter_bank
from vae_teb_tpu.ops import reflect_pad as jax_reflect_pad
from vae_teb_tpu.ops import tukey_window as jax_tukey_window
from vae_teb_tpu.ops.phase import _build_phi_decimation_operator
from vae_teb_tpu.ops.phase_reduced import _phi_lt_src, _reconstruction_slice
from vae_teb_tpu.ops.phase_reduced import build_reduced_plan as jax_plan
from vae_teb_tpu_torch.ops import PhaseScattering1D, Scattering1D, build_filter_bank
from vae_teb_tpu_torch.ops.phase_reduced import _compose_reconstruction, build_reduced_plan
from vae_teb_tpu_torch.ops.scattering import reflect_pad, tukey_window

torch.set_num_threads(2)

SMALL = dict(J=6, Q=2, T=8, shape=1024)
PROD = dict(J=11, Q=4, T=16, shape=5760)
FLOAT_REL = 1e-6   # builder float fields: max |a - b| <= 1e-6 * max |b|


def _assert_same(got, want, name):
    """Integer (and bool) fields exactly, float fields to FLOAT_REL."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{name}[{i}]")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        scale = max(np.abs(want).max(), 1e-30) if want.size else 1.0
        assert np.abs(got - want).max(initial=0.0) <= FLOAT_REL * scale, name


def _subsets(sc):
    sel = sc.optimal_fhr_selection()
    return (tuple(int(i) for i in sel["phase_selection"]["selected_indices"]),
            tuple(int(i) for i in sel["cross_selection"]["selected_indices"]))


@pytest.mark.parametrize("n,left,right", [(10, 3, 4), (6, 9, 14), (5, 0, 17),
                                          (1, 2, 3)])
def test_reflect_pad_matches_jax(n, left, right):
    """Pads longer than the signal chain reflections, as in JAX; length 1
    zero-pads."""
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    want = np.asarray(jax_reflect_pad(jnp.asarray(x), left, right))
    got = reflect_pad(torch.as_tensor(x), left, right).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg", [SMALL, PROD], ids=["small", "prod"])
def test_builders_match_jax(cfg):
    """Filter bank, pair table (float32 powers), both selections and the
    phi-decimation operator equal the JAX package's builders."""
    kw = dict(J=cfg["J"], Q=cfg["Q"], T=cfg["T"])
    fb_t = build_filter_bank(N=cfg["shape"], **kw)
    fb_j = jax_filter_bank(N=cfg["shape"], **kw)
    for field in fb_j.__dataclass_fields__:
        _assert_same(getattr(fb_t, field), getattr(fb_j, field), field)

    sc_t = PhaseScattering1D(**cfg, max_order=1)
    sc_j = JaxPhase(**cfg, max_order=1)
    assert sc_t.pairs.powers.dtype == np.float32
    for field in ("i_idx", "j_idx", "autoc_idx"):
        _assert_same(getattr(sc_t.pairs, field), getattr(sc_j.pairs, field),
                     field)
    np.testing.assert_array_equal(sc_t.pairs.powers, sc_j.pairs.powers)
    sel_t, sel_j = sc_t.optimal_fhr_selection(), sc_j.optimal_fhr_selection()
    for fam in ("phase_selection", "cross_selection"):
        _assert_same(sel_t[fam]["selected_indices"],
                     sel_j[fam]["selected_indices"], fam)
    for mask in ("use_phase_mask", "use_cross_mask"):
        _assert_same(sel_t[mask], sel_j[mask], mask)
    assert sel_t["total_selected_features"] == sel_j["total_selected_features"]
    if cfg is PROD:
        assert sel_t["phase_selection"]["n_selected"] == 44
        assert sel_t["cross_selection"]["n_selected"] == 130

    lt = sc_t.phi_lt_src()
    lrt, lit = _build_phi_decimation_operator(
        sc_j.N, sc_j.pad_left, sc_j.pad_right, sc_j.N_padded,
        np.asarray(sc_j.fb.phi_levels[0], np.float64), sc_j.decimation)
    _assert_same(lt.real.astype(np.float32), lrt, "LrT")
    _assert_same(lt.imag.astype(np.float32), lit, "LiT")


def test_compose_reconstruction_matches_dense_product():
    """The FFT form of the reconstruction-then-decimate composition equals
    the JAX package's dense `_reconstruction_slice(...).T @ lt_src`."""
    sc = JaxPhase(**SMALL, max_order=1)
    lt_src = _phi_lt_src(sc)
    for W in (sc.N_padded, sc.N_padded // 2, sc.N_padded // 16):
        want = _reconstruction_slice(sc.N, sc.N_padded, sc.pad_left, W).T @ lt_src
        got = _compose_reconstruction(lt_src, sc.N_padded, sc.pad_left, W)
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def _check_plan(cfg):
    sc_t = PhaseScattering1D(**cfg, max_order=1, reduced_rate=True)
    sc_j = JaxPhase(**cfg, max_order=1, reduced_rate=True)
    p_idx, c_idx = _subsets(sc_j)
    plan_t = build_reduced_plan(sc_t, p_idx, c_idx)
    plan_j = jax_plan(sc_j, p_idx, c_idx, sc_j.support_threshold)
    assert (plan_t.n_phase, plan_t.n_cross, plan_t.n_out) == (
        plan_j.n_phase, plan_j.n_cross, plan_j.n_out)
    assert len(plan_t.groups) == len(plan_j.groups)
    for g_t, g_j in zip(plan_t.groups, plan_j.groups):
        for field in g_j.__dataclass_fields__:
            _assert_same(getattr(g_t, field), getattr(g_j, field),
                         f"ds={g_j.ds} {field}")


def test_reduced_plan_matches_jax_small():
    _check_plan(SMALL)


@pytest.mark.slow
def test_reduced_plan_matches_jax_prod():
    _check_plan(PROD)


def test_scattering_matches_jax_small():
    x = np.random.default_rng(0).standard_normal((3, SMALL["shape"])).astype(np.float32)
    want = np.asarray(JaxScattering(**SMALL, max_order=1)(jnp.asarray(x)))
    got = Scattering1D(**SMALL, max_order=1)(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 2e-5 * np.abs(want).max()


@pytest.mark.parametrize("name", ["prod_phase", "prod_cross"])
def test_scattering_golden(name, golden_loader):
    """The torch reference's production scattering at the JAX package's
    bar (tests/test_scattering.py)."""
    g = golden_loader(name)
    sc = Scattering1D(int(g["J"]), int(g["Q"]), int(g["T"]), int(g["N"]),
                      max_order=int(g["max_order"]))
    x = g["x"][:, 0, :] if g["x"].ndim == 3 else g["x"]
    got = sc(torch.as_tensor(x, dtype=torch.float32)).numpy()
    ref = g["scattering"]
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 2e-5 * np.abs(ref).max()


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("alpha", [None, 0.0, 0.25, 1.0])
def test_tukey_window_matches_jax(alpha):
    np.testing.assert_array_equal(tukey_window(1024, alpha),
                                  jax_tukey_window(1024, alpha))


def _check_analyze(cfg, corr, tukey_alpha=None):
    """Phase family rel-L2 <= 1e-4 (integer powers: branch-insensitive);
    cross family <= 5e-2, the JAX suite's white-noise bar for the reduced
    pipeline (non-integer powers are chaotic in fp32,
    tests/test_phase.py::test_reduced_rate_matches_exact_small); scattering
    <= 2e-5 * max."""
    jax_dt, torch_dt = {None: (None, None),
                        "bf16": (jnp.bfloat16, torch.bfloat16)}[corr]
    sc_j = JaxPhase(**cfg, max_order=1, reduced_rate=True,
                    correlation_dtype=jax_dt, tukey_alpha=tukey_alpha)
    sc_t = PhaseScattering1D(**cfg, max_order=1, reduced_rate=True,
                             correlation_dtype=torch_dt,
                             tukey_alpha=tukey_alpha)
    p_idx, c_idx = _subsets(sc_j)
    x = np.random.default_rng(0).standard_normal((2, 2, cfg["shape"])).astype(np.float32)
    want = sc_j.analyze(jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]),
                        phase_subset=p_idx, cross_subset=c_idx)
    got = sc_t.analyze(torch.as_tensor(x[:, 0]), torch.as_tensor(x[:, 1]),
                       phase_subset=p_idx, cross_subset=c_idx)
    w = {k: np.asarray(v, np.float64) for k, v in want.items()}
    g = {k: v.double().numpy() for k, v in got.items()}
    assert set(g) == set(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
    assert np.abs(g["scattering"] - w["scattering"]).max() < (
        2e-5 * np.abs(w["scattering"]).max())
    assert _rel_l2(g["phase_corr"], w["phase_corr"]) <= 1e-4
    assert _rel_l2(g["cross_phase_corr"], w["cross_phase_corr"]) <= 5e-2


@pytest.mark.parametrize("corr,tukey_alpha", [(None, None), ("bf16", None),
                                               (None, 0.25)])
def test_analyze_matches_jax_reduced_small(corr, tukey_alpha):
    _check_analyze(SMALL, corr, tukey_alpha)


@pytest.mark.slow
def test_analyze_matches_jax_reduced_prod():
    _check_analyze(PROD, None)


def test_analyze_defaults_and_phase_only():
    """Default subsets are the optimal selection; without `up` only the
    phase family is computed, equal to its value in the joint call."""
    sc = PhaseScattering1D(**SMALL, max_order=1, reduced_rate=True)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, 2, SMALL["shape"])).astype(np.float32))
    both = sc.analyze(x[:, 0], x[:, 1])
    sel = sc.optimal_fhr_selection()
    assert both["phase_corr"].shape[1] == sel["phase_selection"]["n_selected"]
    assert both["cross_phase_corr"].shape[1] == sel["cross_selection"]["n_selected"]
    alone = sc.analyze(x[:, 0])
    assert "cross_phase_corr" not in alone
    torch.testing.assert_close(alone["phase_corr"], both["phase_corr"],
                               rtol=0, atol=1e-5 * both["phase_corr"].abs().max().item())
