"""The port's serving launcher, ``python -m repro_torch.launch.serve``, on
the CPU.

Reduced olmo-1b (``--reduced``), ``--device cpu``. ``main`` runs to its
end in every mode: the default (float residency), ``--resident
quantized``, ``--speculative``, ``--faults`` (which proves recovery
itself: the final store equals a clean stream's and the final-stage
tokens a clean run's, or it exits non-zero), ``--pool-clients`` and
``--event-log`` with ``--metrics``. The event log it writes validates
against the event schema and is the same from run to run; the parts still
to be ported raise naming their ROADMAP item; the default device is the
card.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import serve
from repro_torch.obs.schema import validate_jsonl

BASE = ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--decode-steps", "10"]
MODES = {
    "default": [],
    "quantized": ["--resident", "quantized"],
    "speculative": ["--speculative", "--draft-k", "2"],
    "faults": ["--faults", "--scenario", "browser-3g"],
    "pool": ["--pool-clients", "4", "--pool-slots", "2", "--scenario", "flash-crowd"],
    "event_log": ["--scenario", "edge-stall", "--seed", "1"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_runs_to_its_end(mode, tmp_path, capsys):
    log = tmp_path / "serve.jsonl"
    argv = BASE + MODES[mode] + ["--event-log", str(log)]
    if mode == "event_log":
        argv += ["--metrics", str(tmp_path / "serve.prom")]
    serve.main(argv)
    out = capsys.readouterr().out
    assert "served" in out and "event log ->" in out
    if mode == "faults":
        assert "fault recovery verified" in out
    if mode == "pool":
        assert out.count("client ") == 4
    text = log.read_text()
    assert validate_jsonl(text) == len(text.splitlines()) > 0
    kinds = {json.loads(line)["kind"] for line in text.splitlines()}
    assert {"cold_start", "chunk", "stage_complete"} <= kinds
    if mode == "event_log":
        prom = (tmp_path / "serve.prom").read_text()
        assert "session_chunks_total" in prom
        assert json.loads((tmp_path / "serve.prom.json").read_text())
        serve.main(argv[:-4] + ["--event-log", str(tmp_path / "again.jsonl")])
        assert (tmp_path / "again.jsonl").read_text() == text


@pytest.mark.parametrize("mode", ["default", "speculative", "pool"])
def test_cli_gemma3_reduced(mode, capsys):
    """``--arch gemma3-27b --reduced``: sliding windows of 16 over a
    32-token prompt, every ring wrapped, in the default stream, under
    speculation and in the pool (chunked admission over rings)."""
    argv = ["--arch", "gemma3-27b", "--reduced", "--device", "cpu", "--decode-steps", "12"]
    serve.main(argv + {"default": [], "speculative": ["--speculative", "--draft-k", "2"],
                       "pool": ["--pool-clients", "3", "--pool-slots", "2"]}[mode])
    assert "served" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["default", "speculative", "pool"])
def test_cli_mixtral_reduced(mode, capsys):
    """``--arch mixtral-8x22b --reduced``: mixture-of-experts blocks over
    sliding windows of 16 (4 experts, top-2), in the default stream, under
    speculation and in the pool."""
    argv = ["--arch", "mixtral-8x22b", "--reduced", "--device", "cpu", "--decode-steps", "12"]
    serve.main(argv + {"default": [], "speculative": ["--speculative", "--draft-k", "2"],
                       "pool": ["--pool-clients", "3", "--pool-slots", "2"]}[mode])
    assert "served" in capsys.readouterr().out


def test_cli_parts_still_to_port_raise(capsys):
    """The launcher lacks nothing it once refused: a serving mesh for a
    recurrent arch (ROADMAP A13) serves zamba2-7b, token for token the run
    without it. Every arch serves (``--mesh-shards``:
    ``tests/test_torch_sharded.py``, ``tests/test_torch_sharded_archs.py``
    and ``tests/test_torch_sharded_families.py``; the recurrent archs:
    ``tests/test_torch_recurrent.py``; the cross-attention ones:
    ``tests/test_torch_cross.py``, ``tests/test_torch_vision.py``;
    progressivenet-cnn, the last: ``tests/test_torch_cnn.py``)."""
    def lines(text):
        return [line for line in text.splitlines() if line.startswith(("tokens[0]",
                                                                       "stage per step"))]
    argv = ["--arch", "zamba2-7b", "--reduced", "--device", "cpu", "--decode-steps", "6"]
    serve.main(argv)
    plain = capsys.readouterr().out
    serve.main(argv + ["--mesh-shards", "2"])
    sharded = capsys.readouterr().out
    assert "serving mesh: 2 model shards" in sharded
    assert lines(sharded) == lines(plain) and len(lines(plain)) == 2


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "olmo-1b", "--reduced"])


def test_cli_as_a_module():
    """``python -m repro_torch.launch.serve`` in a process of its own."""
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [src] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *BASE,
                           "--decode-steps", "4"], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "served 4 steps across" in proc.stdout
