"""What a run loads: never JAX, flax or the JAX package (top-level names
compared whole, since the port's name begins with the package's); and the
reference loads nothing of the port."""

import json
import subprocess
import sys
import textwrap

from conftest import ROOT, SERVE_SMALL, SERVE_TRAFFIC, TRAIN_SMALL, TRAIN_TRAFFIC

from perfbench.run import FORBIDDEN, forbidden_modules

RUN = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {root!r})
    from perfbench.run import run_cell
    run_cell({workload!r}, 5, 1.0, False, device="cpu",
             config_overrides={cfg!r}, traffic_overrides={traffic!r})
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")


def _loaded(code: str):
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    for workload, cfg, traffic in (
            ("train.seqvae_teb.b128", TRAIN_SMALL, TRAIN_TRAFFIC),
            ("serve.seqvae_teb.b128", SERVE_SMALL, SERVE_TRAFFIC)):
        top = _loaded(RUN.format(root=ROOT, workload=workload, cfg=cfg,
                                 traffic=traffic))
        assert "vae_teb_tpu_torch" in top       # the port did run
        assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    top = _loaded(textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {ROOT!r})
        import perfbench.reference.frontend, perfbench.reference.model
        import perfbench.reference.train, perfbench.counts
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """))
    assert not top & {"vae_teb_tpu_torch", "jax", "jaxlib", "flax",
                      "vae_teb_tpu"}


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "vae_teb_tpu_torch_probe", sys)
    assert forbidden_modules() == [] or "vae_teb_tpu" not in \
        [m.split(".")[0] for m in sys.modules]
    monkeypatch.setitem(sys.modules, "vae_teb_tpu.probe", sys)
    assert "vae_teb_tpu" in forbidden_modules()
