"""The port's examples (``examples_torch/``) against the JAX package's
(``examples/``), on the CPU.

Each reference example runs as the user runs it (``runpy`` as
``__main__``, its own arguments) in a process of its own, all started
together by the module's fixture; the process records, beside the
example's printed lines, the inputs the example drew (``Model.init``'s
params, the prompts) and what it computed (``Model.forward``'s logits,
``train``'s params, the MSEs it averaged), and the port's example gets
the same inputs through ``main``'s keywords. Held:

* ``quickstart``: the blob's bytes, the stage count, the singleton
  payload, the download time and every ``t=`` line exactly equal; each
  stage's logits within ``LOGIT_RTOL`` of the largest |logit|, the
  tolerance the port's ``Model.forward`` is held to (a float32 forward
  summed in other orders).
* ``train_then_transmit --steps 20``: the logged step indices equal
  (the port trains its own init); the port's evaluation half
  (``transmit``), given the reference's trained params, writes a
  manifest of exactly the reference's bytes (the header's JSON carries
  each tensor's float range, so its length follows the trained values:
  2086 bytes with XLA's optimisation off here, 2088 with it on; then 8 x
  83,968) and
  predicts every held-out label the reference predicts at each prefix
  and for the float params, except where the reference's top two logits
  are within twice ``LOGIT_RTOL`` of its largest |logit| (a near tie:
  one position of the 4096 at each of stages 1, 2, 3 and 6 in the seeded
  run), so each printed accuracy equals the reference's up to those
  positions.
* ``expert_priority_moe``: the router's choice counts exactly equal,
  except where the reference's k-th and (k+1)-th router probabilities
  are within ``ROUTER_TIE`` (none in the seeded run); the tensor counts
  after slicing equal; each MSE within ``MSE_RTOL`` of the reference's;
  the "popularity wins" flag equal where the two MSEs differ by more
  than that tolerance (at frac 0.3 they agree to 4 places: a near tie,
  not held).

Every example refuses to run without a card unless given ``--device
cpu``, and none imports ``jax`` or the reference package.
"""
import ast
import importlib.util
import json
import os
import pathlib
import pickle
import re
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.interop import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "train_then_transmit", "progressive_serving",
            "expert_priority_moe")
# Model.forward in float32 against the reference's: the tolerance the
# port's forward is held to, of the largest |logit|
LOGIT_RTOL = 2e-5
# the MSE of logits ~0.3 in size, each off by LOGIT_RTOL at most
MSE_RTOL = 1e-4
ROUTER_TIE = 1e-5
TRAIN_STEPS = 20

# The reference side: runs ``examples/<name>.py`` as ``__main__`` with
# the given arguments and pickles a dict of what it recorded: the printed
# lines (``stdout``); the first ``Model.init``'s params as a numpy tree
# (``params``); per example, what it drew and computed. XLA's backend
# optimisation is off: these small runs are compile-bound.
_REFERENCE = """
    import contextlib, io, json, os, pickle, runpy, sys, tempfile
    os.environ["XLA_FLAGS"] = ("--xla_cpu_multi_thread_eigen=false "
                               "--xla_backend_optimization_level=0 "
                               "--xla_llvm_disable_expensive_passes=true")
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.core import wire
    from repro.models import model as jmodel
    from repro.train import loop as jloop
    from repro.transmission import session as jsession

    name, out_path, argv = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    rec, mses = {}, []

    init = jmodel.Model.init
    def recording_init(self, key):
        params = init(self, key)
        rec.setdefault("params", jax.tree.map(np.asarray, params))
        return params
    jmodel.Model.init = recording_init

    forward, forwards = jmodel.Model.forward, []
    def recording_forward(self, params, batch):
        out = forward(self, params, batch)
        forwards.append(np.asarray(out[0]))
        return out
    if name == "quickstart":
        jmodel.Model.forward = recording_forward

    train, trained = jloop.train, []
    def recording_train(*a, **kw):
        res = train(*a, **kw)
        trained.append(res.params)
        return res
    jloop.train = recording_train

    run_serving, run_pool = jsession.Session.run_serving, jsession.Session.run_serving_pool
    def recording_serving(self, model, prog, *, batch, **kw):
        for k, v in batch.items():
            rec.setdefault("batch", {})[k] = np.asarray(v)
        res = run_serving(self, model, prog, batch=batch, **kw)
        rec["tokens"] = np.asarray(res.tokens)
        rec["stage_at_step"] = np.asarray(res.stage_at_step)
        return res
    def recording_pool(self, model, prog, *, prompts, **kw):
        rec["prompts"] = np.stack([np.asarray(p) for p in prompts])
        res = run_pool(self, model, prog, prompts=prompts, **kw)
        rec["pool"] = {"tokens": {r: [int(t) for t in v] for r, v in res.tokens.items()},
                       "stage_log": {r: list(v) for r, v in res.server.stage_log.items()},
                       "upgrades": list(res.upgrades)}
        return res
    jsession.Session.run_serving = recording_serving
    jsession.Session.run_serving_pool = recording_pool

    def recording_float(x):
        v = float(x)
        mses.append(v)
        return v

    path = os.path.join(os.getcwd(), "examples", name + ".py")
    sys.argv = [path] + argv
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g = runpy.run_path(path, run_name="__main__",
                           init_globals={"float": recording_float}
                           if name == "expert_priority_moe" else None)
    rec["stdout"] = buf.getvalue()

    if name == "quickstart":
        rec["blob_bytes"] = len(g["blob"])
        rec["singleton_bytes"] = g["prog"].singleton_payload_bytes()
        rec["download_s"] = g["events"][-1].end_s
        rec["logits"] = {i + 1: logits for i, logits in enumerate(forwards)}
    elif name == "train_then_transmit":
        # the example's own evaluation, logits kept: its model, batch and
        # checkpoint prefixes, the forward jitted as its acc_fn is
        from repro.configs import get_config
        from repro.models.model import build_model
        from repro.train import checkpoint
        from repro.train.data import DataConfig, MarkovMotifDataset
        params = trained[0]
        rec["trained"] = jax.tree.map(np.asarray, params)
        cfg = get_config("olmo-1b").reduced(n_layers=2, d_model=128, d_ff=256, vocab=64,
                                            n_heads=4, n_kv=4)
        model = build_model(cfg)
        ds = MarkovMotifDataset(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=64,
                                           seed=0))
        batch = {k: jnp.asarray(v) for k, v in ds.batch(10_000).items()}
        fwd = jax.jit(lambda p: model.forward(p, batch)[0])
        ckpt_dir = os.path.join(tempfile.gettempdir(), "progressive_ckpt")
        rec["logits"] = {s: np.asarray(fwd(checkpoint.load_into(ckpt_dir, params, stages=s)
                                           if s else params)) for s in range(9)}
        rec["labels"] = np.asarray(batch["labels"])
    elif name == "expert_priority_moe":
        cfg = g["cfg"]
        rec["calib_tokens"] = np.asarray(g["batch"]["tokens"])
        rec["eval_tokens"] = np.stack([np.asarray(jax.random.randint(
            jax.random.PRNGKey(100 + seed), (4, 64), 0, cfg.vocab).astype(jnp.int32))
            for seed in range(4)])
        rec["counts"] = np.asarray(g["counts"])
        rec["router_probs"] = np.asarray(jax.nn.softmax(g["logits"], -1))
        rec["mse"] = np.asarray(mses)
    with open(out_path, "wb") as f:
        pickle.dump(rec, f)
"""


def load_example(name: str):
    """``examples_torch/<name>.py`` as a module (its ``__main__`` block
    does not run)."""
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def start_references(tmp: pathlib.Path, jobs: dict) -> dict:
    """Start one reference process a job (``{tag: (example, argv)}``),
    each with ``tmp/<tag>`` as its ``TMPDIR``; returns ``{tag: (process,
    record path, stderr path)}`` for :func:`reference`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for tag, (name, argv) in jobs.items():
        (tmp / tag).mkdir()
        env["TMPDIR"] = str(tmp / tag)
        err = tmp / f"{tag}.err"
        with open(err, "w") as f:
            procs[tag] = (subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(_REFERENCE), name,
                 str(tmp / f"{tag}.pkl"), json.dumps(argv)],
                stdout=subprocess.DEVNULL, stderr=f, env=dict(env), cwd=ROOT),
                tmp / f"{tag}.pkl", err)
    return procs


def reference(world: dict, tag: str) -> dict:
    """A job's record (the pickle its process wrote): waits for the
    process the first time."""
    if tag not in world["out"]:
        proc, out, err = world["procs"][tag]
        rc = proc.wait(timeout=300)
        assert rc == 0, err.read_text()[-3000:]
        with open(out, "rb") as f:
            world["out"][tag] = pickle.load(f)
    return world["out"][tag]


def stop(world: dict) -> None:
    for proc, _, _ in world["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JOBS = {"quickstart": ("quickstart", []),
        "train": ("train_then_transmit", ["--steps", str(TRAIN_STEPS)]),
        "moe": ("expert_priority_moe", [])}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("examples")
    world = {"procs": start_references(tmp, JOBS), "out": {}, "tmp": tmp}
    yield world
    stop(world)


def _printed(capsys) -> list[str]:
    return capsys.readouterr().out.splitlines()


# ---------------------------------------------------------------------------
# both files: the examples' imports and devices
# ---------------------------------------------------------------------------

def example_imports(name: str) -> set[str]:
    """The top-level packages ``examples_torch/<name>.py`` imports."""
    tops = set()
    for node in ast.walk(ast.parse((ROOT / "examples_torch" / f"{name}.py").read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax_or_reference(name):
    tops = example_imports(name)
    assert not tops & {"jax", "jaxlib", "flax", "repro", "examples"}, tops
    assert "repro_torch" in tops and tops <= {"__future__", "argparse", "os", "tempfile",
                                              "numpy", "torch", "repro_torch"}, tops


@pytest.mark.parametrize("name", ["quickstart", "train_then_transmit", "expert_priority_moe"])
def test_example_asks_for_the_card(name, monkeypatch):
    """``main([])`` runs on ``cuda``: without a card it raises before any
    work, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_example(name).main([])


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_equals_reference(world, capsys):
    ref = reference(world, "quickstart")
    out = load_example("quickstart").main(["--device", "cpu"], params=ref["params"])
    lines, ref_lines = _printed(capsys), ref["stdout"].splitlines()
    assert out["blob_bytes"] == int(ref["blob_bytes"])
    assert out["singleton_bytes"] == int(ref["singleton_bytes"])
    assert out["download_s"] == float(ref["download_s"])
    assert out["n_stages"] == 8 and [s for _, s, _ in out["stages"]] == list(range(1, 9))
    # every line but the logits' values exactly the reference's
    assert len(lines) == len(ref_lines) == 11
    for got, want in zip(lines, ref_lines):
        assert got.split("logits")[0] == want.split("logits")[0]
    for stage, logits in out["logits"].items():
        want = ref["logits"][stage]
        err = float(np.abs(logits.numpy() - want).max())
        assert err <= LOGIT_RTOL * float(np.abs(want).max()), (stage, err)


# ---------------------------------------------------------------------------
# train_then_transmit
# ---------------------------------------------------------------------------

def test_train_then_transmit_logs_the_reference_steps(world, capsys):
    """The port trains its own init (``train``'s generator): the steps it
    logs and the checkpoint's stage sizes are the reference's; the loss
    falls over the 20 steps."""
    ex = load_example("train_then_transmit")
    model = ex.reduced_model("olmo-1b")
    res = ex.train_model(model, TRAIN_STEPS, device=torch.device("cpu"))
    ref_out = reference(world, "train")["stdout"]
    ref_steps = [int(m) for m in re.findall(r"^  step\s+(\d+)", ref_out, re.M)]
    assert [h["step"] for h in res.history] == ref_steps == [*range(0, 20, 2), 19]
    assert res.history[-1]["loss"] < res.history[0]["loss"]
    lines = _printed(capsys)
    assert [int(line.split()[1]) for line in lines] == ref_steps


def _near_ties(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= 2 * LOGIT_RTOL * float(np.abs(logits).max())


def test_train_then_transmit_evaluation_equals_reference(world, capsys, monkeypatch):
    """The evaluation half on the reference's trained params: the manifest
    bytes, each prefix's predictions and each printed accuracy."""
    ref = reference(world, "train")
    monkeypatch.setattr(tempfile, "tempdir", str(world["tmp"] / "port_ckpt"))
    (world["tmp"] / "port_ckpt").mkdir()
    ex = load_example("train_then_transmit")
    model = ex.reduced_model("olmo-1b")
    out = ex.transmit(model, params_from_numpy(ref["trained"], device="cpu"),
                      device=torch.device("cpu"))
    lines, ref_lines = _printed(capsys), ref["stdout"].splitlines()
    man = out["manifest"]
    assert [man["stage_bytes"][s] for s in range(1, 9)] == [83_968] * 8
    header = f"  header {man['header_bytes']}B + stages {[83_968] * 8}"
    assert header in lines and header in ref_lines
    np.testing.assert_array_equal(out["labels"].numpy(), ref["labels"])
    ties = {}
    for s in range(9):
        want = ref["logits"][s].argmax(-1)
        tie = _near_ties(ref["logits"][s])
        got = out["predictions"][s].numpy()
        assert np.array_equal(got[~tie], want[~tie]), s
        n_ref = int((want == ref["labels"]).sum())
        assert abs(out["correct"][s] - n_ref) <= int(tie.sum()), s
        ties[s] = int(tie.sum())
    # each accuracy line as printed: equal unless a near tie flipped a label
    acc_lines = [line for line in lines if ": accuracy" in line or "fp32 ref" in line]
    ref_acc = [line for line in ref_lines if ": accuracy" in line or "fp32 ref" in line]
    assert len(acc_lines) == len(ref_acc) == 9
    for s, got, want in zip([*range(1, 9), 0], acc_lines, ref_acc):
        assert got == want or ties[s], (got, want)


# ---------------------------------------------------------------------------
# expert_priority_moe
# ---------------------------------------------------------------------------

def test_expert_priority_moe_equals_reference(world, capsys):
    ref = reference(world, "moe")
    out = load_example("expert_priority_moe").main(
        ["--device", "cpu"], params=ref["params"], calib_tokens=ref["calib_tokens"],
        eval_tokens=list(ref["eval_tokens"]))
    lines, ref_lines = _printed(capsys), ref["stdout"].splitlines()
    # router top-k near ties: the k-th and (k+1)-th probabilities
    probs = np.sort(ref["router_probs"], axis=-1)[..., ::-1]
    k = int(np.asarray(ref["counts"]).sum() // probs[..., 0].size)
    n_ties = int((probs[..., k - 1] - probs[..., k] <= ROUTER_TIE).sum())
    assert n_ties == 0
    np.testing.assert_array_equal(out["counts"], ref["counts"])
    assert lines[0] == ref_lines[0]                       # router popularity
    assert lines[1] == ref_lines[1]                       # tensors after slicing
    assert (out["n_tensors"], out["n_tensors_unsliced"]) == (22, 13)
    # the reference's 24 per-batch MSEs: 4 eval batches a (frac, order)
    ref_mse = ref["mse"].reshape(3, 2, 4).mean(-1)
    for i, frac in enumerate((0.3, 0.5, 0.7)):
        for j, order in enumerate(("default", "popularity")):
            assert out["mse"][frac, order] == pytest.approx(ref_mse[i, j], rel=MSE_RTOL)
        d, p = ref_mse[i]
        line = next(x for x in lines if x.startswith(f"{frac:6.1f}"))
        if abs(d - p) > MSE_RTOL * max(d, p):
            assert ("popularity wins" in line) == (p < d), (frac, line)
        else:
            assert frac == 0.3, (frac, d, p)              # the named near tie
