"""The port's ``examples_torch/progressive_serving.py`` against the JAX
package's ``examples/progressive_serving.py``, on the CPU.

Four modes of the reference run as the user runs them (``--decode-steps
8`` and ``--event-log``), each in a process of its own started by the
module's fixture (``test_torch_examples.start_references``), which
records the weights, the prompt batch or the flash crowd's prompts the
reference drew, and the tokens and stage logs it served; the port's
example serves the same weights and prompts (``main``'s ``params=``,
``batch=``, ``prompts=``). Held exactly in each mode — the default
(mixtral-8x22b reduced, float residency, ``browser-lte-handoff``),
``--arch olmo-1b --resident quantized``, ``--flash-crowd 4`` and
``--scheduled`` (the v2 wire, weight-SSE order, entropy coded): every
printed line but the reference's counts of compiled executables
(``decode_cache_size``, which the port has no counterpart of: its engines
compile nothing) and the event log's path, so the stage arrivals,
bits/weight, tokens, upgrades and event counts; the whole token arrays,
per-step stages or per-client stage logs, and upgrades; the event log's
JSONL byte for byte.

The port alone: ``--resident quantized`` on the default mode's weights
serves the reference's float-resident tokens at the same stages (the
reference's docstring promises it); ``--speculative`` serves the tokens
of a plain quantized server replayed at the run's per-token stages (as
``tests/test_torch_speculative.py`` holds it), with no extra resident
bytes; ``--bandwidth-mbps 2.5`` on the port's own seeded draws runs to
its end at 16 bits. ``main([])`` asks for the card.
"""
import re

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.progressive import divide
from repro_torch.interop import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ProgressiveServer
from test_torch_examples import (EXAMPLES, example_imports, load_example, reference,
                                 start_references, stop)

STEPS = 8
MODES = {"default": [],
         "olmo_quantized": ["--arch", "olmo-1b", "--resident", "quantized"],
         "crowd": ["--flash-crowd", "4"],
         "scheduled": ["--scheduled"]}
# the reference's clauses on compiled executables, which the port leaves out
_EXECUTABLES = re.compile(r"; \d+ decode executables? across every admission/eviction/upgrade"
                          r"|; decode executables compiled: \d+"
                          r"|; \d+ decode executables \(draft decode \+ target verify\)")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("example_serving")
    jobs = {tag: ("progressive_serving", ["--decode-steps", str(STEPS), *flags,
                                          "--event-log", str(tmp / tag / "events.jsonl")])
            for tag, flags in MODES.items()}
    world = {"procs": start_references(tmp, jobs), "out": {}, "tmp": tmp}
    yield world
    stop(world)


def _serve(argv, capsys, **inputs) -> tuple[dict, list[str]]:
    out = load_example("progressive_serving").main(
        ["--decode-steps", str(STEPS), *argv, "--device", "cpu"], **inputs)
    return out, capsys.readouterr().out.splitlines()


def _inputs(ref) -> dict:
    if "prompts" in ref:
        return {"params": ref["params"], "prompts": list(ref["prompts"])}
    return {"params": ref["params"], "batch": ref["batch"]}


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax_or_reference(name):
    tops = example_imports(name)
    assert not tops & {"jax", "jaxlib", "flax", "repro", "examples"}, tops


def test_serving_example_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_example("progressive_serving").main([])


@pytest.mark.parametrize("mode", list(MODES))
def test_serving_example_equals_reference(world, capsys, mode):
    ref = reference(world, mode)
    out, lines = _serve(MODES[mode], capsys, **_inputs(ref))
    want = [_EXECUTABLES.sub("", line) for line in ref["stdout"].splitlines()
            if not line.startswith("event log -> ")]
    assert lines == want
    assert out["jsonl"] == (world["tmp"] / mode / "events.jsonl").read_text()
    assert out["n_events"] == len(out["jsonl"].splitlines())
    assert out["final_stage"] == 8
    if "pool" in ref:
        assert out["tokens"] == ref["pool"]["tokens"]
        assert out["stage_log"] == ref["pool"]["stage_log"]
        assert list(map(list, out["upgrades"])) == list(map(list, ref["pool"]["upgrades"]))
    else:
        assert out["tokens"].tolist() == ref["tokens"].tolist()
        assert out["stage_at_step"] == ref["stage_at_step"].tolist()
        assert [s for _, s in out["upgrades"]] == list(range(2, 9))


def test_quantized_serves_the_reference_fp_tokens(world, capsys):
    """``--resident quantized`` on the default mode's weights and prompt:
    the reference's float-resident tokens at the same per-step stages."""
    ref = reference(world, "default")
    out, lines = _serve(["--resident", "quantized"], capsys, **_inputs(ref))
    assert out["tokens"].tolist() == ref["tokens"].tolist()
    assert out["stage_at_step"] == ref["stage_at_step"].tolist()
    assert out["resident"]["fp_bytes"] > 0 and out["resident"]["quantized_leaves"] > 0
    assert any(line.startswith("resident weights: ") for line in lines)


def _stage_replay(model, prog, prompt: torch.Tensor, stages: list) -> torch.Tensor:
    """Plain greedy tokens of a quantized ``ProgressiveServer`` replayed at
    a speculative run's per-token stages: token j computed at stages[j],
    its K/V written by the step that computes token j + 1."""
    srv = ProgressiveServer(model, prog, max_len=prompt.shape[1] + len(stages),
                            resident="quantized", device="cpu")
    while srv.stage < stages[0]:
        srv.receive_stage()
    srv.start({"tokens": prompt})
    out = [torch.argmax(srv.last_logits, dim=-1)]
    pos = prompt.shape[1]
    for stage in stages[1:]:
        while srv.stage < stage:
            srv.receive_stage()
        logits, srv.caches = model.decode_step(srv.params, srv.caches, out[-1][:, None], pos)
        pos += 1
        out.append(torch.argmax(logits, dim=-1))
    return torch.stack(out, dim=1)


def test_speculative_equals_plain_at_the_same_stages(world, capsys):
    ref = reference(world, "default")
    out, lines = _serve(["--speculative"], capsys, **_inputs(ref))
    model = build_model(get_config("mixtral-8x22b").reduced())
    prog = divide(params_from_numpy(ref["params"], device="cpu"))
    plain = _stage_replay(model, prog, torch.as_tensor(ref["batch"]["tokens"]),
                          out["stage_at_step"])
    assert torch.equal(out["tokens"], plain)
    assert out["speculation"]["rounds"] > 0 and out["speculation"]["drafted"] > 0
    assert out["upgrades"] and out["stage_at_step"][-1] > 1
    assert any("extra resident draft bytes: 0)" in line for line in lines)


def test_constant_link_runs_to_its_end(capsys):
    """The port's own seeded draws over a constant 2.5 MB/s link."""
    out, lines = _serve(["--bandwidth-mbps", "2.5"], capsys)
    assert lines[0].endswith("over constant 2.5 MB/s")
    assert out["final_stage"] == 8 and out["stage_at_step"][-1] == 8
    assert out["tokens"].shape == (2, STEPS)
    assert sorted(out["arrivals"]) == out["arrivals"]
