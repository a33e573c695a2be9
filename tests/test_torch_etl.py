"""The port's dataset-building path against the JAX package: synthetic
windows, QC, windowing, the ETL into HDF5, statistics, splits,
inspection, packing and the build-data / stats / pack-data subcommands,
fed the same seeds.

Raw fields and everything the host computes are held bit for bit; the
coefficients at the frontend's bars (tests/test_torch_exact_frontend.py):
scattering 2e-5 of max, the selected phase family rel-L2 1e-4, the
cross family rel-L2 5e-2 (non-integer acceleration powers are chaotic
in fp32). Everything runs on the CPU (`device="cpu"`) at J=6, Q=2, T=8
over 1024-sample windows.
"""

import os

import h5py
import numpy as np
import pytest
import torch

import vae_teb_tpu.cli as jax_cli
import vae_teb_tpu.data as jd
import vae_teb_tpu_torch.cli as torch_cli
import vae_teb_tpu_torch.data as td
from vae_teb_tpu.ops import PhaseScattering1D as JaxPhase
from vae_teb_tpu_torch.ops import PhaseScattering1D

torch.set_num_threads(2)

CFG = dict(J=6, Q=2, T=8)
WINDOW = 1024
COEFF_BARS = {"fhr_st": ("max", 2e-5), "fhr_ph": ("l2", 1e-4),
              "fhr_up_ph": ("l2", 5e-2)}


def _coeff_err(got, want, kind):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if kind == "max":
        return np.abs(got - want).max() / np.abs(want).max()
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _assert_same_files(got_path, want_path):
    """Same datasets, dtypes, shapes, chunks, maxshape, compression and
    attrs; raw fields bit-equal, coefficients within their bars."""
    with h5py.File(got_path, "r") as g, h5py.File(want_path, "r") as w:
        assert set(g) == set(w)
        assert dict(g.attrs) == dict(w.attrs)
        for name in w:
            a, b = g[name], w[name]
            assert (a.dtype, a.shape, a.chunks, a.maxshape, a.compression) == (
                b.dtype, b.shape, b.chunks, b.maxshape, b.compression), name
            assert dict(a.attrs) == dict(b.attrs), name
            if name in COEFF_BARS:
                kind, bar = COEFF_BARS[name]
                assert _coeff_err(a[()], b[()], kind) < bar, name
            else:
                np.testing.assert_array_equal(a[()], b[()], err_msg=name)


# -- numpy pieces: bit for bit ----------------------------------------------

@pytest.mark.parametrize("n,windows,seed", [(WINDOW, 1, 0), (5760, 3, 7)])
def test_synthetic_fhr_up_bit_equal(n, windows, seed):
    want = jd.synthetic_fhr_up(n, np.random.default_rng(seed), windows)
    got = td.synthetic_fhr_up(n, np.random.default_rng(seed), windows)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _flat_signal(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(3000).astype(np.float32)
    x[100:130] = 5.0            # a 30-sample run
    x[500:1100] = -1.0          # 600 samples: over the FHR limit
    x[2000:2015] = 2.0          # shorter than min_length
    x[2900:] = 0.5              # run to the end
    return x


def test_flat_regions_and_qc_match_jax():
    for seed in range(3):
        x = _flat_signal(seed)
        for tol in (1e-9, 1e-3, 0.5):
            for min_len in (5, 20):
                assert td.find_flat_regions(x, tol, min_len) == \
                    jd.find_flat_regions(x, tol, min_len)
        y = np.random.default_rng(seed + 10).standard_normal(3000)
        weights = (np.ones(188, np.float32), np.full(188, 0.5, np.float32))
        for fhr, up in ((x, y), (y, x), (y, y)):
            for w in weights:
                assert td.passes_qc(fhr, up, w) == jd.passes_qc(fhr, up, w)
                assert td.passes_qc(fhr, up, w, flat_tolerance=1e-3) == \
                    jd.passes_qc(fhr, up, w, flat_tolerance=1e-3)
    assert td.find_flat_regions(np.zeros(1)) == []


@pytest.mark.parametrize("length", [700, WINDOW, 2500, 4000])
@pytest.mark.parametrize("overlap,weighted", [(0.5, False), (0.25, True)])
def test_window_record_matches_jax(length, overlap, weighted):
    """Windows, stride, the chained reflect tail, weights decimated by
    block mean (reflected samples weigh 0) and start offsets."""
    rng = np.random.default_rng(length)
    fhr, up = rng.standard_normal((2, length)).astype(np.float32)
    weight = rng.uniform(0, 1, length).astype(np.float32) if weighted else None
    kw = dict(window=WINDOW, overlap=overlap, weight=weight, decimation=8)
    want = jd.window_record(fhr, up, **kw)
    got = td.window_record(fhr, up, **kw)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError):
        td.window_record(fhr[:1], up[:1], window=WINDOW)


# -- the ETL -------------------------------------------------------------------

def _records():
    """Synthetic long records, one with a flat FHR stretch (skipped by the
    QC) and one too short to window (reported in errors)."""
    recs = list(jd.synthetic_records(3, 2500, seed=4))
    recs[1]["fhr"] = recs[1]["fhr"].copy()
    recs[1]["fhr"][:700] = 140.0
    recs[2]["weight"] = np.linspace(0.5, 1.0, 2500).astype(np.float32)
    recs[2]["cs_label"] = True
    recs.append({"fhr": np.ones(1, np.float32), "up": np.ones(1, np.float32),
                 "guid": "too_short"})
    return recs


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The same datasets built by both packages: build_dataset (exact, and
    reduced rate with bf16 products) and build_dataset_from_records."""
    d = tmp_path_factory.mktemp("etl")
    out = {"dir": d, "res": {}}
    kw = dict(n_records=3, windows_per_record=3, len_signal=WINDOW, seed=0,
              **CFG)
    for mode in ("exact", "reduced_bf16"):
        jt = tt = None
        if mode == "reduced_bf16":
            import jax.numpy as jnp
            jt = JaxPhase(**CFG, shape=WINDOW, max_order=1,
                          reduced_rate=True, correlation_dtype=jnp.bfloat16)
            tt = PhaseScattering1D(**CFG, shape=WINDOW, max_order=1,
                                   reduced_rate=True,
                                   correlation_dtype=torch.bfloat16)
        out["res"][("jax", mode)] = jd.build_dataset(
            str(d / f"jax_{mode}.h5"), transform=jt, **kw)
        out["res"][("torch", mode)] = td.build_dataset(
            str(d / f"torch_{mode}.h5"), transform=tt, device="cpu", **kw)
    rec_kw = dict(window=WINDOW, overlap=0.5, **CFG)
    out["res"][("jax", "records")] = jd.build_dataset_from_records(
        str(d / "jax_records.h5"), _records(), **rec_kw)
    out["res"][("torch", "records")] = td.build_dataset_from_records(
        str(d / "torch_records.h5"), _records(), device="cpu", **rec_kw)
    return out


@pytest.mark.parametrize("mode", ["exact", "reduced_bf16", "records"])
def test_build_matches_jax(built, mode):
    """Same kept / skipped / errors, and the same file."""
    res_t, res_j = built["res"][("torch", mode)], built["res"][("jax", mode)]
    assert res_t == res_j
    if mode == "records":
        # record 1's flat FHR fails window 0; record 2's weights fail all 4
        assert (res_t["kept"], res_t["skipped"]) == (7, 5)
        assert [e["record"] for e in res_t["errors"]] == ["too_short"]
    else:
        assert res_t == {"kept": 9, "skipped": 0}
    d = built["dir"]
    _assert_same_files(str(d / f"torch_{mode}.h5"), str(d / f"jax_{mode}.h5"))


@pytest.mark.parametrize("mode", ["exact", "records"])
def test_each_package_reads_the_others_file(built, mode):
    """CombinedHDF5Dataset of each package reads the other's file as it
    reads its own (trimmed, raw layout)."""
    d = built["dir"]
    t_file, j_file = str(d / f"torch_{mode}.h5"), str(d / f"jax_{mode}.h5")
    kw = dict(trim_minutes=1.0, raw_layout=True, cache_size=0)
    for Reader in (td.CombinedHDF5Dataset, jd.CombinedHDF5Dataset):
        own, other = Reader([t_file], **kw), Reader([j_file], **kw)
        assert len(own) == len(other)
        idx = range(len(own))
        a, b = own.read_batch(idx), other.read_batch(idx)
        assert set(a) == set(b)
        for k in b:
            if k in COEFF_BARS:
                kind, bar = COEFF_BARS[k]
                assert _coeff_err(a[k], b[k], kind) < bar, k
            else:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)
        own.close()
        other.close()


def test_write_callback_gets_the_files_windows(built):
    """`write` receives, record by record, what the HDF5 append stores: the
    same fields, dtypes and shapes, raw fields and labels bit for bit, and
    the coefficients of this second CPU build within COEFF_BARS of the
    fixture's. PyTorch gives no bitwise guarantee between two CPU runs of
    the frontend (MKL's FFT and GEMM take other code paths with the thread
    count, and the chaotic phase acceleration amplifies the last bit): one
    tier-1 run found the phase family 2.8e-3 apart at most, on 16.6% of
    its elements, where this file alone matches bit for bit."""
    batches = []
    res = td.build_dataset(None, n_records=3, windows_per_record=3,
                           len_signal=WINDOW, seed=0, device="cpu",
                           write=batches.append, **CFG)
    assert res == built["res"][("torch", "exact")]
    assert len(batches) == 3 and all(len(b["guid"]) == 3 for b in batches)
    with h5py.File(built["dir"] / "torch_exact.h5", "r") as f:
        for k in f:
            got = np.concatenate([np.asarray(b[k]) for b in batches])
            want = f[k][()]
            if k == "guid":
                want = np.array([g.decode() for g in want])
            got = got.astype(want.dtype)
            assert got.shape == want.shape, k
            if k in COEFF_BARS:
                kind, bar = COEFF_BARS[k]
                assert _coeff_err(got, want, kind) < bar, k
            else:
                np.testing.assert_array_equal(got, want, err_msg=k)


class _Faulting:
    """A transform that raises `fault` on the calls numbered in `fail_on`
    (two calls a batch: the phase family, then the cross family)."""

    def __init__(self, sc, fault, fail_on):
        self.sc, self.fault, self.fail_on, self.calls = sc, fault, fail_on, 0
        self.scattering, self.device = sc.scattering, sc.device

    def optimal_fhr_selection(self):
        return self.sc.optimal_fhr_selection()

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls in self.fail_on:
            raise self.fault
        return self.sc(*args, **kwargs)


def test_record_isolation_but_not_of_device_faults():
    """A record that fails in its second batch is reported and contributes
    no window, and the run goes on; a device fault (CUDA error, out of
    memory) ends the run."""
    sc = PhaseScattering1D(**CFG, shape=WINDOW)
    recs = list(td.synthetic_records(2, 1536, seed=1))   # 2 windows each
    batches = []
    res = td.build_dataset_from_records(
        None, recs, transform=_Faulting(sc, ValueError("bad batch"), {3}),
        window=WINDOW, batch_size=1, write=batches.append)
    assert [e["record"] for e in res["errors"]] == ["synthetic_0000"]
    assert (res["kept"], res["skipped"]) == (2, 0)
    assert [g for b in batches for g in b["guid"]] == ["synthetic_0001"] * 2
    for fault in (torch.AcceleratorError("CUDA error"),
                  torch.OutOfMemoryError("out of memory")):
        with pytest.raises(type(fault)):
            td.build_dataset_from_records(
                None, recs, transform=_Faulting(sc, fault, {3}),
                window=WINDOW, batch_size=1, write=lambda b: None)


def test_etl_defaults_to_the_card(monkeypatch, tmp_path):
    """The ETL and build-data run on the card unless told otherwise: with
    no card the default raises; device="cpu" runs on the CPU; a transform
    passed in keeps its own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "x.h5")
    kw = dict(n_records=1, windows_per_record=1, len_signal=WINDOW, **CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.build_dataset(path, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.build_dataset_from_records(
            path, td.synthetic_records(1, WINDOW), window=WINDOW, **CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_cli.main(["build-data", "--out", path, "--records", "1",
                        "--windows", "1", "--len-signal", str(WINDOW),
                        "--J", "6", "--Q", "2", "--T", "8"])
    assert td.build_dataset(path, device="cpu", **kw)["kept"] == 1
    sc = PhaseScattering1D(**CFG, shape=WINDOW)
    assert td.build_dataset(path, transform=sc, **kw)["kept"] == 1


# -- statistics, packing, the subcommands --------------------------------------

@pytest.mark.parametrize("trim", [None, 1.0])
def test_stats_match_jax(built, tmp_path, trim):
    """DatasetStatsCalculator of both packages on the same file agree to
    1e-6 relative, and each package's load_stats reads the other's file."""
    src = [str(built["dir"] / "jax_exact.h5")]
    calc_t = td.DatasetStatsCalculator(trim_minutes=trim)
    calc_j = jd.DatasetStatsCalculator(trim_minutes=trim)
    st_t = calc_t.calculate_stats(src, batch_size=4)
    st_j = calc_j.calculate_stats(src, batch_size=4)
    assert set(st_t) == set(st_j) == {"fhr", "up", "fhr_st", "fhr_ph",
                                      "fhr_up_ph"}
    for k, want in st_j.items():
        got = st_t[k]
        np.testing.assert_allclose(got.mean, want.mean, rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(got.variance, want.variance, rtol=1e-6,
                                   atol=1e-12)
        assert (got.log_channels, got.asinh_channels, got.count) == (
            want.log_channels, want.asinh_channels, want.count)
    t_file, j_file = str(tmp_path / "t.h5"), str(tmp_path / "j.h5")
    calc_t.save_stats(st_t, t_file, metadata={"source": "port"})
    calc_j.save_stats(st_j, j_file, metadata={"source": "port"})
    for load, path in ((td.load_stats, j_file), (jd.load_stats, t_file)):
        back = load(path)
        for k, want in st_j.items():
            np.testing.assert_allclose(back[k].mean, want.mean, rtol=1e-6)
            np.testing.assert_allclose(back[k].variance, want.variance,
                                       rtol=1e-6)
            assert back[k].log_channels == want.log_channels
    with h5py.File(t_file, "r") as a, h5py.File(j_file, "r") as b:
        assert set(a) == set(b)
        skip = {"created_at"}
        assert {k: v for k, v in a.attrs.items() if k not in skip} == {
            k: v for k, v in b.attrs.items() if k not in skip}
        for g in b:
            assert set(a[g]) == set(b[g])
            assert set(a[g].attrs) == set(b[g].attrs)


def _run_cli(main, argv):
    assert main(argv) == 0


@pytest.mark.parametrize("raw", [False, True])
def test_pack_data_matches_jax(built, tmp_path, raw):
    """pack-data of both packages on one file and one stats file: the same
    manifest and the same bytes."""
    src = str(built["dir"] / "jax_exact.h5")
    stats = str(tmp_path / "stats.h5")
    _run_cli(torch_cli.main, ["stats", "--data", src, "--out", stats,
                              "--trim-minutes", "1.0"])
    extra = ["--raw"] if raw else ["--stats", stats]
    outs = []
    for name, main in (("torch", torch_cli.main), ("jax", jax_cli.main)):
        out = str(tmp_path / name)
        _run_cli(main, ["pack-data", "--data", src, "--out", out,
                        "--trim-minutes", "1.0", "--batch-size", "4"] + extra)
        outs.append(td.PackedWindowStore(out))
    a, b = outs
    assert {k: v for k, v in a.meta.items()} == b.meta
    batch_a, batch_b = a.read_batch(range(len(b))), b.read_batch(range(len(b)))
    assert set(batch_a) == set(batch_b)
    for k in batch_b:
        np.testing.assert_array_equal(np.asarray(batch_a[k]),
                                      np.asarray(batch_b[k]), err_msg=k)


@pytest.mark.parametrize("argv", [
    ["build-data", "--out", "d.h5"],
    ["build-data", "--out", "d.h5", "--records", "16", "--windows", "8",
     "--seed", "0", "--record-len", "9000", "--overlap", "0.25",
     "--bf16-frontend", "--reduced-frontend", "--stats-out", "s.h5",
     "--trim-minutes", "1.5", "--J", "6", "--Q", "2", "--T", "8",
     "--len-signal", "1024"],
    ["stats", "--data", "a.h5", "b.h5", "--out", "s.h5"],
    ["stats", "--data", "a.h5", "--out", "s.h5", "--trim-minutes", "2"],
    ["pack-data", "--data", "a.h5", "--out", "p"],
    ["pack-data", "--data", "a.h5", "b.h5", "--out", "p", "--stats", "s.h5",
     "--trim-minutes", "2", "--decimation", "8", "--batch-size", "16",
     "--raw"],
], ids=["build-defaults", "build-all", "stats-defaults", "stats-trim",
        "pack-defaults", "pack-all"])
def test_cli_parsers_match_jax(monkeypatch, argv):
    """The three subcommands take JAX's flags with JAX's defaults; the port
    adds --device to build-data (default: the card)."""
    seen = {}
    fns = {"build-data": "cmd_build_data", "stats": "cmd_stats",
           "pack-data": "cmd_pack_data"}
    for name, mod in (("jax", jax_cli), ("torch", torch_cli)):
        monkeypatch.setattr(mod, fns[argv[0]],
                            lambda args, name=name: seen.__setitem__(
                                name, vars(args)) or 0)
        assert mod.main(argv) == 0
    got = {k: v for k, v in seen["torch"].items() if k != "fn"}
    want = {k: v for k, v in seen["jax"].items() if k != "fn"}
    if argv[0] == "build-data":
        assert got.pop("device") is None
    assert got == want


def test_cli_build_stats_pack_on_cpu(tmp_path):
    """build-data (with --stats-out) -> stats -> pack-data --raw on the
    CPU, and the packed store reads back the built windows."""
    data, stats = str(tmp_path / "d.h5"), str(tmp_path / "s.h5")
    common = ["--J", "6", "--Q", "2", "--T", "8", "--len-signal", "1024"]
    _run_cli(torch_cli.main, ["build-data", "--out", data, "--records", "2",
                              "--windows", "2", "--device", "cpu",
                              "--stats-out", stats, "--trim-minutes", "1.0"]
             + common)
    _run_cli(torch_cli.main, ["build-data", "--out", str(tmp_path / "r.h5"),
                              "--records", "1", "--record-len", "2000",
                              "--device", "cpu", "--reduced-frontend"]
             + common)
    st = td.load_stats(stats)
    assert set(st) == {"fhr", "up", "fhr_st", "fhr_ph", "fhr_up_ph"}
    assert td.stats_file_trim_minutes(stats) == 1.0
    out = str(tmp_path / "p")
    _run_cli(torch_cli.main, ["pack-data", "--data", data, "--out", out,
                              "--raw"])
    store = td.PackedWindowStore(out)
    with h5py.File(data, "r") as f:
        assert len(store) == f["fhr"].shape[0] == 4
        np.testing.assert_array_equal(store.read_batch([0, 3])["fhr_st"],
                                      f["fhr_st"][[0, 3]])


# -- schema, splits, inspection ----------------------------------------------

def test_schema_functions_match_jax(tmp_path):
    """append_sample / dataset_info on files both packages create."""
    sample = dict(fhr=np.ones(64, np.float32), up=np.zeros(64, np.float32),
                  fhr_st=np.ones((3, 8), np.float32),
                  fhr_ph=np.ones((2, 8), np.float32),
                  fhr_up_ph=np.ones((4, 8), np.float32),
                  target=np.ones(8, np.float32), weight=np.ones(8, np.float32),
                  epoch=np.float32(3), cs_label=True, bg_label=False,
                  guid="g0")
    counts = {"fhr_st": 3, "fhr_ph": 2, "fhr_up_ph": 4}
    paths = []
    for pkg in (td, jd):
        path = str(tmp_path / f"{pkg.__name__}.h5")
        pkg.create_initial_hdf5(path, len_signal=64, len_sequence=8,
                                channel_counts=counts)
        pkg.append_sample(path, **sample)
        pkg.append_sample(path, **dict(sample, guid="g1"))
        paths.append(path)
    assert td.dataset_info(paths[0]) == jd.dataset_info(paths[1])
    _assert_same_files(*paths)
    with pytest.raises(ValueError, match="inconsistent"):
        td.append_batch(paths[0], {"fhr": np.ones((2, 64)),
                                   "up": np.ones((1, 64))})


def test_splits_match_jax():
    data = {"a": [f"a{i}" for i in range(23)], "b": [f"b{i}" for i in range(7)]}
    for kw in ({}, dict(n_splits=3, val_ratio=0.2, random_state=5)):
        assert td.create_cv_splits(data, **kw) == jd.create_cv_splits(data, **kw)
    guids = [f"g{i}" for i in range(30)]
    labels = [i % 3 for i in range(30)]
    assert td.guid_label_splits(guids, labels, n_splits=4) == \
        jd.guid_label_splits(guids, labels, n_splits=4)


def test_inspect_matches_jax(built, tmp_path):
    path = str(built["dir"] / "jax_exact.h5")
    got, want = td.describe_hdf5(path), jd.describe_hdf5(path)
    assert got == want
    assert td.format_report(got) == jd.format_report(want)
    png = str(tmp_path / "s.png")
    td.plot_sample(path, 1, png)
    assert os.path.getsize(png) > 0
