"""Serving artifacts and streaming sessions of the port on the CPU: the
serving recurrence as the operator `vae_teb_tpu_torch::wavefront_fwd`,
`export_inference` (symbolic batch, both flavours) and
`export_source_stream` saved, loaded and run against the live model,
`StreamingSession`, and `cli export`. Small model: H=8, 2 layers per
encoder, S=16."""

import os

import numpy as np
import pytest
import torch

from vae_teb_tpu_torch import cli as torch_cli
from vae_teb_tpu_torch import serve
from vae_teb_tpu_torch.init import init_parameters
from vae_teb_tpu_torch.kernels import wavefront_fwd
from vae_teb_tpu_torch.models import SeqVaeTeb

torch.set_num_threads(2)

S, H, LAYERS = 16, 8, 2
EXPORT_TOL = 1e-6     # a program against the live model, of each output's max
STREAM_TOL = 1e-5     # chained chunks against the full encode (test_torch_stream)
OP = torch.ops.vae_teb_tpu_torch.wavefront_fwd.default


def _model(seq_len=S, seed=0):
    return init_parameters(SeqVaeTeb(lstm_hidden_dim=H, lstm_num_layers=LAYERS,
                                     seq_len=seq_len), seed=seed).eval()


def _batch(b, seed, seq_len=S):
    r = np.random.default_rng(seed)
    return {k: r.standard_normal((b, seq_len, c)).astype(np.float32)
            for k, c in zip(serve.COEFF_KEYS, (43, 44, 130))}


def _coeffs(batch):
    return tuple(torch.as_tensor(batch[k]) for k in serve.COEFF_KEYS)


def _worst(got, want):
    return max(((got[k] - want[k]).abs().max() / want[k].abs().max()).item()
               for k in want)


def _op_nodes(program):
    return [n for n in program.graph.nodes if n.target is OP]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wavefront_op_passes_opcheck(dtype):
    """The operator's schema, fake implementation (symbolic shapes too) and
    registration, on CPU inputs of one 4-layer stream."""
    g = torch.Generator().manual_seed(0)
    U, B, s = 4, 3, 5
    UH, K = U * H, s + U - 1
    rnd = lambda *shape: (0.3 * torch.randn(shape, generator=g)).to(dtype)
    args = (rnd(UH, 4 * UH), rnd(4 * UH), rnd(K, B, 4 * UH), rnd(B, UH),
            rnd(B, UH), torch.arange(U, dtype=torch.int32), s)
    torch.library.opcheck(OP, args)
    out = OP(*args)
    assert [o.shape for o in out] == [(K, B, UH), (B, UH), (B, UH)]
    assert all(o.dtype == dtype for o in out)


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """The small model's inference programs, weights as argument and
    bundled, traced on the CPU from a B=1 example (the symbolic batch is
    traced at B=2), saved and loaded back."""
    model = _model()
    out = {}
    for bundle in (False, True):
        program = serve.export_inference(model, _batch(1, 1),
                                         bundle_params=bundle, device="cpu")
        path = str(tmp_path_factory.mktemp("art") / "inference.pt2")
        size = serve.save_artifact(program, path)
        assert size == os.path.getsize(path) > 0
        out[bundle] = (program, serve.load_artifact(path), size)
    return model, out


@pytest.mark.parametrize("bundle", [False, True], ids=["weights", "bundled"])
def test_inference_artifact_matches_model(programs, bundle):
    """A loaded program with a symbolic batch reproduces the live model at
    B = 1, 3 and 5; the weights-as-argument flavour takes the model's
    state_dict (BatchNorm's running statistics included) and so serves
    other weights too."""
    model, out = programs
    loaded = out[bundle][1].module()
    other = _model(seed=5)
    for b in (1, 3, 5):
        coeffs = _coeffs(_batch(b, 10 + b))
        with torch.inference_mode():
            want = model(*coeffs)
            got = loaded(*coeffs) if bundle else loaded(model.state_dict(),
                                                        *coeffs)
            assert _worst(got, want) <= EXPORT_TOL
            if not bundle:
                got = loaded(other.state_dict(), *coeffs)
                assert _worst(got, other(*coeffs)) <= EXPORT_TOL
    if not bundle:   # the running statistics are inputs, not constants
        names = out[bundle][0].graph_signature.user_inputs
        assert len(names) == len(model.state_dict()) + 3


def test_weights_as_argument_artifact_holds_no_weights(programs):
    """The bundled artifact is larger than the weights-as-argument one by
    about the weights' bytes: neither keeps its example inputs."""
    model, out = programs
    weights = sum(t.numel() * t.element_size()
                  for t in model.state_dict().values())
    bundled, as_argument = out[True][2], out[False][2]
    assert 0.9 * weights < bundled - as_argument < 1.1 * weights + 1e5
    assert as_argument < weights


def test_graph_holds_one_recurrence_node(programs):
    """The recurrence is one operator node, not an unrolled loop: one node
    in each flavour, and as many nodes at S=32 as at S=16."""
    _, out = programs
    for program, loaded, _ in out.values():
        assert len(_op_nodes(program)) == len(_op_nodes(loaded)) == 1
    longer = serve.export_inference(_model(seq_len=2 * S), _batch(2, 2, 2 * S),
                                    bundle_params=True, device="cpu")
    assert len(_op_nodes(longer)) == 1
    assert len(longer.graph.nodes) == len(out[True][0].graph.nodes)


def test_program_runs_on_its_trace_device(programs):
    """A program is traced on the device it serves on: the unit layer
    vector the recurrence takes is a constant moved to the trace device
    (here the CPU) by the graph itself, and every tensor the graph creates
    names that device, so a program for the card is traced on the card."""
    _, out = programs
    for program, _, _ in out.values():
        (node,) = _op_nodes(program)
        lvec = node.args[5]
        assert lvec.target is torch.ops.aten.to.device
        assert lvec.args[1] == torch.device("cpu")
        const = program.graph_signature.inputs_to_lifted_tensor_constants[
            lvec.args[0].args[0].name]
        assert program.constants[const].dtype == torch.int32
        devices = {n.kwargs["device"] for n in program.graph.nodes
                   if "device" in n.kwargs}
        assert devices == {torch.device("cpu")}


def test_loaded_program_counts_launches(programs):
    """The operator's body is the dispatch: on CPU tensors a loaded
    program takes the plain version and counts no kernel launch."""
    model, out = programs
    before = wavefront_fwd.launches
    with torch.inference_mode():
        out[True][1].module()(*_coeffs(_batch(2, 3)))
    assert wavefront_fwd.launches == before


def test_stream_artifact_matches_sequence_encoding(tmp_path):
    """export_source_stream at chunk 1, saved, loaded and chained for 10
    steps, equals get_sequence_encoding's first 10 steps; a bundled stream
    program holds only the source encoder's weights."""
    model = _model()
    x = torch.as_tensor(_batch(2, 4)["fhr_up_ph"])
    program = serve.export_source_stream(model, batch_size=2, chunk_len=1,
                                         device="cpu")
    path = str(tmp_path / "stream.pt2")
    serve.save_artifact(program, path)
    step = serve.load_artifact(path).module()
    assert len(_op_nodes(program)) == 1
    state = model.init_source_stream_state(2)
    outs = []
    with torch.inference_mode():
        for t in range(10):
            mu, state = step(model.state_dict(), x[:, t:t + 1], state)
            outs.append(mu)
        want = model.get_sequence_encoding(x, 9)
    assert ((torch.cat(outs, 1) - want).abs().max()
            / want.abs().max()).item() <= STREAM_TOL
    bundled = serve.export_source_stream(model, batch_size=2, chunk_len=1,
                                         bundle_params=True, device="cpu")
    assert bundled.state_dict and all(k.startswith("source_encoder.")
                                      for k in bundled.state_dict)


def test_streaming_session_chains_and_resumes():
    """A StreamingSession over uneven chunks equals the full source encode;
    a second session given a copy of the first's `state` mid-way
    reproduces the rest bit for bit."""
    model = _model()
    x = torch.as_tensor(_batch(2, 6)["fhr_up_ph"])
    session = serve.StreamingSession(model, 2, device="cpu")
    outs = [session.step(x[:, lo:hi]) for lo, hi in ((0, 1), (1, 5), (5, 9))]
    saved = {k: (tuple(t.clone() for t in v) if k == "conv_tails"
                 else v.clone()) for k, v in session.state.items()}
    rest = [session.step(x[:, lo:hi]) for lo, hi in ((9, 12), (12, 16))]
    with torch.inference_mode():
        want = model.source_encoder(x)
    assert ((torch.cat(outs + rest, 1) - want).abs().max()
            / want.abs().max()).item() <= STREAM_TOL
    resumed = serve.StreamingSession(model, 2, device="cpu")
    resumed.state = saved
    for (lo, hi), mu in zip(((9, 12), (12, 16)), rest):
        assert torch.equal(resumed.step(x[:, lo:hi]), mu)
    assert session.state["h"].device.type == "cpu"


@pytest.mark.parametrize("platforms", ["tpu", "cuda,cpu", "gpu"])
def test_export_platforms_refused(monkeypatch, platforms):
    """A torch program runs on the device it was traced on: --platforms
    names one device, cuda or cpu, and sets what --device sets."""
    seen = {}
    monkeypatch.setattr(torch_cli, "cmd_export",
                        lambda args: seen.setdefault("device", args.device))
    argv = ["export", "--config", "c.yaml", "--out", "a", "--platforms"]
    with pytest.raises(SystemExit):
        torch_cli.main(argv + [platforms])
    assert not seen
    torch_cli.main(argv + ["cpu"])
    assert seen == {"device": "cpu"}


def _config(tmp_path):
    import yaml
    from vae_teb_tpu_torch.train import load_config
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"tag": "x", "out_dir_base": str(tmp_path / "runs"),
                        "trainer": {"precision": "fp32", "seed": 3}}, f)
    return path, load_config(path)


def test_cli_export_fresh_stream(tmp_path, capsys):
    """`cli export --stream` without a checkpoint warns and writes the
    stream step of the seeded model (production LSTM widths), which chains
    into its sequence encoding."""
    path, cfg = _config(tmp_path)
    out = str(tmp_path / "stream.pt2")
    rc = torch_cli.main(["export", "--config", path, "--out", out,
                         "--seq-len", "8", "--stream", "--static-batch", "2",
                         "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "no checkpoint given" in printed and "stream step" in printed
    model = init_parameters(torch_cli.make_model(cfg, 8), seed=3).eval()
    step = serve.load_artifact(out).module()
    x = torch.as_tensor(_batch(2, 7, 8)["fhr_up_ph"])
    state, outs = model.init_source_stream_state(2), []
    with torch.inference_mode():
        for t in range(3):
            mu, state = step(model.state_dict(), x[:, t:t + 1], state)
            outs.append(mu)
        want = model.get_sequence_encoding(x, 2)
    assert ((torch.cat(outs, 1) - want).abs().max()
            / want.abs().max()).item() <= STREAM_TOL


def test_cli_export_from_checkpoint(tmp_path, capsys):
    """`cli export --bundle-params --static-batch 3` from a checkpoint
    written by the port's Checkpointer: the file loads and reproduces the
    checkpoint's model."""
    from vae_teb_tpu_torch.train import Checkpointer
    path, cfg = _config(tmp_path)
    model = init_parameters(torch_cli.make_model(cfg, 8), seed=11).eval()
    Checkpointer(str(tmp_path / "ckpt")).save({"model": model.state_dict()},
                                              step=0, metric=1.0)
    out = str(tmp_path / "inference.pt2")
    rc = torch_cli.main(["export", "--config", path, "--checkpoint",
                         str(tmp_path / "ckpt"), "--out", out, "--seq-len", "8",
                         "--static-batch", "3", "--bundle-params", "--device",
                         "cpu"])
    assert rc == 0
    assert "no checkpoint" not in capsys.readouterr().out
    loaded = serve.load_artifact(out).module()
    coeffs = _coeffs(_batch(3, 23, 8))
    with torch.inference_mode():
        assert _worst(loaded(*coeffs), model(*coeffs)) <= EXPORT_TOL


@pytest.mark.parametrize("argv", [
    ["export", "--config", "c.yaml", "--out", "a"],
    ["export", "--config", "c.yaml", "--root", "r", "--checkpoint", "ck",
     "--out", "a", "--seq-len", "64", "--static-batch", "4", "--platforms",
     "cpu", "--bundle-params", "--stream", "--chunk-len", "3"],
], ids=["defaults", "all"])
def test_cli_export_parser_matches_jax(monkeypatch, argv):
    """`export` takes JAX's flags with JAX's defaults; the port adds
    --device (default: the card)."""
    import vae_teb_tpu.cli as jax_cli
    seen = {}
    for name, mod in (("jax", jax_cli), ("torch", torch_cli)):
        monkeypatch.setattr(mod, "cmd_export", lambda args, name=name:
                            seen.__setitem__(name, vars(args)) or 0)
        assert mod.main(argv) == 0
    got = {k: v for k, v in seen["torch"].items() if k != "fn"}
    want = {k: v for k, v in seen["jax"].items() if k != "fn"}
    assert got.pop("device") == want.pop("platforms")
    assert got == want
