"""The port's data readers and run configuration against the JAX package's:
HDF5 reads (filters, trim, host normalization, layouts) and statistics
files of a dataset the JAX package builds through its frontend, packed
window stores built by either package, the numpy normalization it keeps
as a copy, prefetch, and the YAML config. Also that the port imports
without h5py, PyYAML and matplotlib.
"""

import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from vae_teb_tpu.data import CombinedHDF5Dataset as JaxDataset
from vae_teb_tpu.data import DatasetStatsCalculator, build_dataset
from vae_teb_tpu.data import PackedWindowStore as JaxStore
from vae_teb_tpu.data import load_stats as jax_load_stats
from vae_teb_tpu.data import normalize as jax_normalize
from vae_teb_tpu.data.stats import stats_file_trim_minutes as jax_trim_minutes
from vae_teb_tpu.train import load_config as jax_load_config
from vae_teb_tpu_torch.data import (Batch, CombinedHDF5Dataset,
                                    PackedWindowStore, load_stats,
                                    prefetch_to_device,
                                    stats_file_trim_minutes)
from vae_teb_tpu_torch.data import normalize as port_normalize
from vae_teb_tpu_torch.train import RunConfig, load_config, save_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small_dataset(tmp_path_factory):
    """A schema-complete dataset built by the JAX package through its
    frontend at the small size (J=6, Q=2, T=8, 1024), with statistics over
    it, as tests/test_data.py builds one; and statistics over the trimmed
    windows."""
    from vae_teb_tpu.ops import PhaseScattering1D
    d = tmp_path_factory.mktemp("ds")
    path = str(d / "train.h5")
    sc = PhaseScattering1D(J=6, Q=2, T=8, shape=1024, max_order=1)
    res = build_dataset(path, n_records=3, windows_per_record=2,
                        len_signal=1024, seed=0, transform=sc)
    assert res["kept"] > 0
    stats_paths = {}
    for trim in (None, 1.0):
        calc = DatasetStatsCalculator(trim_minutes=trim)
        p = str(d / f"stats_{trim}.h5")
        calc.save_stats(calc.calculate_stats([path], batch_size=4), p)
        stats_paths[trim] = p
    return path, stats_paths


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_load_stats_matches_jax(small_dataset):
    """load_stats reads the same FieldStats, field for field, and the same
    trim, from files with and without a trim."""
    _, stats_paths = small_dataset
    for p in stats_paths.values():
        got, want = load_stats(p), jax_load_stats(p)
        assert set(got) == set(want)
        for k in want:
            for f in dataclasses.fields(want[k]):
                a, b = getattr(got[k], f.name), getattr(want[k], f.name)
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
                else:
                    assert a == b, (k, f.name)
        assert stats_file_trim_minutes(p) == jax_trim_minutes(p)


# (normalize with the stats file, raw_layout, trim_minutes, normalize_fields)
READS = {"normalized": (True, False, None, None),
         "raw": (True, True, None, ()),
         "unnormalized": (False, False, None, None),
         "trimmed": (True, False, 1.0, None),
         "trimmed_raw": (True, True, 1.0, ()),
         "some_fields": (True, False, None, ("fhr_st", "fhr"))}


@pytest.mark.parametrize("case", sorted(READS))
def test_reader_matches_jax(small_dataset, case):
    """CombinedHDF5Dataset against the JAX package's on the same file and
    arguments: read_batch on a shuffled index list, the per-sample reads,
    and as_batches over a shuffled epoch (with and without drop_last) are
    equal bit for bit: the same bytes, trim, normalization and layout."""
    path, stats_paths = small_dataset
    norm, raw, trim, fields = READS[case]
    kw = dict(stats_path=stats_paths[trim] if norm else None,
              trim_minutes=trim, raw_layout=raw, normalize_fields=fields,
              cache_size=0)
    port, ref = CombinedHDF5Dataset(path, **kw), JaxDataset(path, **kw)
    try:
        assert len(port) == len(ref)
        idx = list(np.random.default_rng(3).permutation(len(ref)))
        _assert_batches_equal(port.read_batch(idx), ref.read_batch(idx))
        for i in idx[:3]:
            _assert_batches_equal(port[i], ref[i])
        for drop_last in (True, False):
            got = list(port.as_batches(4, shuffle=True, seed=7,
                                       drop_last=drop_last))
            want = list(ref.as_batches(4, shuffle=True, seed=7,
                                       drop_last=drop_last))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                _assert_batches_equal(g, w)
        np.testing.assert_array_equal(
            port.epoch_indices(True, 5, shard_index=1, shard_count=2),
            ref.epoch_indices(True, 5, shard_index=1, shard_count=2))
    finally:
        port.close()
        ref.close()


def test_reader_filters_and_trim_check_match_jax(small_dataset):
    """Filters select the same samples; statistics over another window
    raise in both packages."""
    path, stats_paths = small_dataset
    guid = JaxDataset(path, cache_size=0)[0].guid
    for kw in (dict(allowed_guids=[guid]), dict(epoch_max=1.0),
               dict(load_fields=["fhr", "guid"])):
        port, ref = (CombinedHDF5Dataset(path, cache_size=0, **kw),
                     JaxDataset(path, cache_size=0, **kw))
        assert port.index_map == ref.index_map
        idx = list(range(len(ref)))
        _assert_batches_equal(port.read_batch(idx), ref.read_batch(idx))
    for cls in (CombinedHDF5Dataset, JaxDataset):
        with pytest.raises(ValueError, match="trim_minutes"):
            cls(path, stats_path=stats_paths[None], trim_minutes=1.0)
        with pytest.raises(ValueError, match="No samples"):
            cls(path, epoch_min=1e12)


def test_get_the_lists_matches_jax(tmp_path):
    """get_the_lists on two files, given in reverse order and sub-selected
    by an epoch filter, returns what the JAX package's method returns: the
    GUIDs decoded, the epochs and the targets, file by file in index order,
    equal bit for bit."""
    import h5py
    paths = []
    for n, count in enumerate((6, 5)):
        path = str(tmp_path / f"part{n}.h5")
        r = np.random.default_rng(n)
        with h5py.File(path, "w") as f:
            f["guid"] = np.array([f"rec{n}-{i}".encode() for i in range(count)])
            f["epoch"] = r.uniform(0.0, 10.0, count)
            f["target"] = r.integers(0, 3, (count, 4)).astype(np.int32)
            f["cs_label"] = r.integers(0, 2, count).astype(bool)
            f["bg_label"] = r.integers(0, 2, count).astype(bool)
        paths.append(path)
    kw = dict(epoch_min=2.0, cache_size=0)
    port = CombinedHDF5Dataset(paths[::-1], **kw)
    ref = JaxDataset(paths[::-1], **kw)
    try:
        assert port.index_map == ref.index_map
        assert 0 < len(port) < 11
        (g, e, t), (wg, we, wt) = port.get_the_lists(), ref.get_the_lists()
        assert g == wg and all(isinstance(x, str) for x in g)
        assert g[0].startswith("rec1-")
        np.testing.assert_array_equal(np.asarray(e), np.asarray(we))
        np.testing.assert_array_equal(np.asarray(t), np.asarray(wt))
        assert len(g) == len(e) == len(t) == len(port)
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("builder", ["jax", "port"])
def test_packed_store_reads_in_both_packages(small_dataset, tmp_path,
                                             builder):
    """A PackedWindowStore built by either package (normalized, and raw
    layout) has the same manifest and reads identically in the other, and
    equal to the reader it was built from on the fields it packs."""
    path, stats_paths = small_dataset
    for raw in (False, True):
        kw = dict(stats_path=stats_paths[None], cache_size=0, raw_layout=raw,
                  normalize_fields=() if raw else None)
        ds = (JaxDataset if builder == "jax" else CombinedHDF5Dataset)(
            path, **kw)
        out = str(tmp_path / f"packed_{raw}")
        (JaxStore if builder == "jax" else PackedWindowStore).build(
            ds, out, batch_size=3)
        port, ref = PackedWindowStore(out), JaxStore(out)
        assert port.meta == ref.meta and port.meta["raw_layout"] == raw
        idx = list(np.random.default_rng(2).permutation(len(ref)))
        packed = port.read_batch(idx)
        _assert_batches_equal(packed, ref.read_batch(idx))
        _assert_batches_equal(packed, {k: v for k, v in ds.read_batch(
            idx).items() if k in packed})
        got = list(port.as_batches(2, shuffle=True, seed=4))
        want = list(ref.as_batches(2, shuffle=True, seed=4))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
        ds.close()


def test_numpy_normalization_matches_jax():
    """The port's copy of the numpy half of normalize.py: resolve_channels,
    default_field_stats, normalize_field, normalize_field_inplace and
    denormalize_field on numpy arrays equal the JAX package's exactly, for
    the production assignments and a non-contiguous one."""
    r = np.random.default_rng(0)
    for value in ("all", "all_except_0", None, [0, 3]):
        np.testing.assert_array_equal(
            port_normalize.resolve_channels(value, 5),
            jax_normalize.resolve_channels(value, 5))
    cases = [("fhr", (4, 50), None), ("fhr_st", (3, 6, 24), 6),
             ("fhr_ph", (3, 5, 24), 5), ("fhr_up_ph", (3, 7, 24), 7)]
    for name, shape, c in cases:
        x = (r.standard_normal(shape) * 3 + (140 if c is None else 0)
             ).astype(np.float32)
        if c is None:
            args = (float(x.mean()), float(x.var()))
        else:
            args = (r.standard_normal(c), np.abs(r.standard_normal(c)) + 0.5)
        got = port_normalize.default_field_stats(name, *args, n_channels=c)
        want = jax_normalize.default_field_stats(name, *args, n_channels=c)
        assert dataclasses.asdict(got).keys() == dataclasses.asdict(want).keys()
        assert got.log_channels == want.log_channels
        assert got.asinh_channels == want.asinh_channels
        np.testing.assert_array_equal(got.mean, want.mean)
        axis = -2 if c is not None else -1
        for fn in ("normalize_field", "denormalize_field"):
            np.testing.assert_array_equal(
                getattr(port_normalize, fn)(x, name, got, channel_axis=axis),
                np.asarray(getattr(jax_normalize, fn)(x, name, want,
                                                      channel_axis=axis)))
        np.testing.assert_array_equal(
            port_normalize.normalize_field_inplace(x.copy(), name, got, axis),
            jax_normalize.normalize_field_inplace(x.copy(), name, want, axis))
    odd = dict(mean=np.zeros(5, np.float32), variance=np.ones(5, np.float32),
               log_channels=(0, 2), asinh_channels=(1, 4))
    x = np.abs(r.standard_normal((2, 5, 8))).astype(np.float32)
    np.testing.assert_array_equal(
        port_normalize.normalize_field_inplace(
            x.copy(), "odd", port_normalize.FieldStats(**odd)),
        jax_normalize.normalize_field_inplace(
            x.copy(), "odd", jax_normalize.FieldStats(**odd)))


def test_prefetch_keeps_order_and_reraises():
    """prefetch_to_device hands the batches over in order, float arrays as
    tensors on the device (others unchanged, array_fields respected); an
    exception in the reader reaches the consumer after the batches read
    before it, rather than ending the epoch quietly; a consumer that stops
    early leaves no reader thread behind."""
    batches = [Batch(x=np.full((2, 3), i, np.float32), i=np.array([i]),
                     name=f"b{i}", skip=np.zeros(1, np.float32))
               for i in range(5)]
    got = list(prefetch_to_device(iter(batches), size=2, device="cpu",
                                  array_fields=("x",)))
    assert [int(b.x[0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b.x, torch.Tensor) and b.x.device.type == "cpu"
               and isinstance(b.i, np.ndarray) and b.name == f"b{n}"
               and isinstance(b.skip, np.ndarray) for n, b in enumerate(got))

    def failing():
        yield from batches[:2]
        raise OSError("disk gone")

    seen = []
    with pytest.raises(OSError, match="disk gone"):
        for b in prefetch_to_device(failing(), size=2):
            seen.append(int(b.x[0, 0]))
    assert seen == [0, 1]

    before = threading.active_count()
    stream = prefetch_to_device(iter(batches * 20), size=1)
    next(stream)
    stream.close()
    assert threading.active_count() == before


def test_config_matches_jax(tmp_path):
    """load_config('configs/default.yaml') equals the JAX package's field by
    field, on every field the two share: all of them but the trainer's
    donate_state and log_every, which the port does not have (the
    trainer's precision maps to torch.bfloat16 where the JAX package's
    maps to jnp.bfloat16), and the model's family, which the JAX package
    does not have (the port's default, SeqVaeTeb, where the file names
    none), with and without a root; save_config round-trips."""
    path = os.path.join(REPO, "configs", "default.yaml")
    for root in (None, str(tmp_path)):
        got = dataclasses.asdict(load_config(path, root=root))
        want = dataclasses.asdict(jax_load_config(path, root=root))
        trainer, jax_trainer = got.pop("trainer"), want.pop("trainer")
        assert got["model"].pop("family") == "seqvae_teb"
        assert got == want
        assert set(jax_trainer) - set(trainer) == {"donate_state", "log_every"}
        assert trainer == {k: jax_trainer[k] for k in trainer}
    assert load_config(path).trainer.model_dtype() == torch.bfloat16
    assert np.dtype(jax_load_config(path).trainer.model_dtype()).name \
        == "bfloat16"
    cfg = RunConfig(tag="t1")
    cfg.dataset.train_paths = ["a.h5"]
    cfg.trainer.accumulate_grad_batches = 4
    p = str(tmp_path / "cfg.yaml")
    save_config(cfg, p)
    loaded = load_config(p, root=str(tmp_path))
    assert loaded.trainer == cfg.trainer
    assert loaded.dataset.train_paths == [str(tmp_path / "a.h5")]
    d = loaded.run_dir(create=True)
    assert os.path.isdir(os.path.join(d, "model_checkpoints"))


def test_port_imports_without_h5py_yaml_matplotlib():
    """Every module of the port imports with jax, h5py, yaml, matplotlib
    and sklearn blocked (the card machine has none of them), the evaluation
    package's too, whose plots then raise; and a packed store plus a
    RunConfig built in code work there."""
    code = (
        "import sys, tempfile, os\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'h5py', 'yaml', "
        "'matplotlib', 'sklearn'):\n"
        "    sys.modules[name] = None\n"
        "import pkgutil, importlib, numpy as np, vae_teb_tpu_torch\n"
        "for m in pkgutil.walk_packages(vae_teb_tpu_torch.__path__, "
        "'vae_teb_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from vae_teb_tpu_torch.data import PackedWindowStore\n"
        "from vae_teb_tpu_torch.train import RunConfig\n"
        "class A:\n"
        "    stats, trim_minutes, raw_layout = None, None, True\n"
        "    def __len__(self): return 3\n"
        "    def read_batch(self, i):\n"
        "        return {'fhr': np.arange(3 * 4, dtype=np.float32)"
        ".reshape(3, 4)[list(i)]}\n"
        "d = tempfile.mkdtemp()\n"
        "s = PackedWindowStore.build(A(), os.path.join(d, 's'))\n"
        "assert s.read_batch([2])['fhr'].tolist() == [[8, 9, 10, 11]]\n"
        "assert RunConfig().trainer.precision == 'fp32'\n"
        "from vae_teb_tpu_torch.eval import ModelEvaluator, plots\n"
        "try:\n"
        "    plots.plot_loss_curves({'epoch': [0]}, os.path.join(d, 'l.png'))\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('a plot without matplotlib')\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_logging_matches_jax(tmp_path):
    """setup_logging configures the package's logger as the JAX package's
    configures its own: the same record format, a console handler and a
    rotating file handler at the same size and count, the root logger
    routed through them; records reach the file."""
    import logging

    from vae_teb_tpu.utils import logging as jax_logging
    from vae_teb_tpu_torch.utils import logging as port_logging
    root = logging.getLogger()
    saved = list(root.handlers), root.level
    try:
        loggers = []
        for mod in (port_logging, jax_logging):
            path = str(tmp_path / f"{mod.__name__}.log")
            logger = mod.setup_logging(path)
            logger.info("hello %d", 7)
            for h in logger.handlers:
                h.flush()
            with open(path) as f:
                assert f.read().rstrip().endswith("hello 7")
            loggers.append([(type(h), h.formatter._fmt,
                             getattr(h, "maxBytes", None),
                             getattr(h, "backupCount", None))
                            for h in logger.handlers])
            assert root.handlers == logger.handlers
            assert mod.get_logger() is logger
        assert loggers[0] == loggers[1]
    finally:
        for name in (port_logging.LOGGER, "vae_teb_tpu"):
            for h in list(logging.getLogger(name).handlers):
                logging.getLogger(name).removeHandler(h)
                h.close()
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])
