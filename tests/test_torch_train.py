"""The port's training side (ROADMAP A12(b)) against the JAX package on the
CPU, in float32.

Held:

* ``train/data.py`` equal to the reference's text;
* ``optimizer.schedule`` and ``optimizer.update`` on the same numpy
  gradients, state and params within ``OPT_RTOL`` (relative) of the
  reference's;
* for a reduced arch of each family (``ARCHS``: the dense variants, a
  mixture of experts dropping pairs past capacity, sliding windows,
  recurrent blocks, an encoder-decoder and gated vision layers, their
  gates moved off 0), ``Model.forward``'s logits within ``LOGIT_ATOL``;
  ``Model.loss``, ``ce`` and ``balance_loss`` within ``LOSS_RTOL``; and
  every leaf's gradient (autograd against ``jax.grad``) within
  ``GRAD_RTOL`` of the leaf's largest reference |g|;
* ``train()`` for ``TRAIN_STEPS`` steps from the reference's parameters
  (the port model's ``init`` patched here to return them): the logged
  ``loss``, ``grad_norm`` and ``lr`` of every step within ``TRAIN_RTOL``;
* learning: the reference's learning test's sizes, loss down by more than
  1.0 in 100 steps;
* ``Model.input_specs`` for each mode: the reference's shapes and dtypes
  on the ``meta`` device;
* the launcher's ``main`` with ``--arch olmo-1b --reduced --device cpu``
  (``python -m repro_torch.launch.train``) runs to its end and writes a
  checkpoint.

The reference side runs in processes of its own, started with the
module's fixture (most of their time is JAX compiling each arch's
gradient).
"""
import dataclasses
import json
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core.progressive import tree_flatten_with_path, tree_skeleton, tree_unflatten
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models.model import Model, build_model
from repro_torch.train import optimizer as opt
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import make_train_step, train
from test_torch_cnn import Jobs

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
# float32 on both sides; the sums run in other orders (XLA's against
# PyTorch's CPU kernels), so each quantity differs by rounding: a few
# ulps of its magnitude, grown through the layers and the backward pass
OPT_RTOL = 1e-6
LOGIT_ATOL = 2e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
TRAIN_RTOL = 1e-4
B, S = 2, 24
# (arch, reduced overrides, the loss's ce_chunk); a tail block where the
# cycle leaves one, mixtral at capacity factor 1.0 (pairs dropped), olmo's
# CE in chunks of 10 (padded labels)
ARCHS = {
    "olmo-1b": ({}, 10),
    "starcoder2-15b": ({}, 512),
    "mixtral-8x22b": ({"capacity_factor": 1.0}, 512),
    "gemma3-27b": ({"n_layers": 7}, 512),
    "xlstm-125m": ({}, 512),
    "zamba2-7b": ({"n_layers": 7}, 512),
    "seamless-m4t-medium": ({}, 512),
    "llama-3.2-vision-90b": ({}, 512),
}
# the archs of each "grads" job, balanced by JAX's compile time
GROUPS = (("olmo-1b", "starcoder2-15b"), ("mixtral-8x22b", "xlstm-125m"),
          ("gemma3-27b", "llama-3.2-vision-90b"), ("zamba2-7b", "seamless-m4t-medium"))
GATE = 0.7          # the vision layers' gates, away from tanh(0) = 0
TRAIN = {"reduced": dict(n_layers=2, d_model=128, d_ff=256, vocab=64, n_heads=4, n_kv=4),
         "seq": 64, "batch": 16, "lr": 1e-3, "warmup": 2}
TRAIN_STEPS = 5

# "grads<i>": group i's archs: params, logits, aux, loss, metrics and
# gradients; "train": the schedule and one update, then TRAIN_STEPS steps
# of train() and the initial params
_REFERENCE = """
    import json, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models.model import build_model
    from repro.train import optimizer as opt
    from repro.train.data import DataConfig
    from repro.train.loop import train

    inp, out_path, job = sys.argv[1:]
    arrays = np.load(inp)
    spec = json.loads(arrays["spec"].item())
    out = {}

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + "/".join(str(p.key) for p in path)] = np.asarray(leaf)

    def gated(params):
        return jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.full_like(a, spec["gate"])
            if str(path[-1].key) in ("gate_attn", "gate_mlp") else a, params)

    if job.startswith("grads"):
        for arch in spec["groups"][int(job[5:])]:
            over, ce_chunk = spec["archs"][arch]
            model = build_model(get_config(arch).reduced(**over))
            params = gated(model.init(jax.random.PRNGKey(0)))
            batch = {k[len(arch) + 1:]: jnp.asarray(v) for k, v in arrays.items()
                     if k.startswith(arch + "/")}
            logits, aux = jax.jit(model.forward)(params, batch)
            loss_fn = lambda p, b: model.loss(p, b, ce_chunk=ce_chunk)
            (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                params, batch)
            put(f"{arch}/param/", params)
            put(f"{arch}/grad/", grads)
            out[f"{arch}/logits"] = np.asarray(logits)
            out[f"{arch}/loss"] = np.asarray(loss)
            for k, v in {**aux, **metrics}.items():
                out[f"{arch}/metric/{k}"] = np.asarray(v)
    else:
        ocfg = opt.OptConfig(**spec["opt"])
        steps = jnp.asarray(spec["steps"], jnp.float32)
        out["lr"] = np.asarray(jax.vmap(lambda s: opt.schedule(ocfg, s))(steps))
        tree = lambda p: {k[len(p):]: jnp.asarray(v) for k, v in arrays.items()
                          if k.startswith(p)}
        state = {"mu": tree("mu/"), "nu": tree("nu/"),
                 "step": jnp.asarray(spec["step"], jnp.int32)}
        params, state, m = jax.jit(lambda g, s, p: opt.update(ocfg, g, s, p))(
            tree("g/"), state, tree("p/"))
        put("new/p/", params)
        put("new/mu/", state["mu"])
        put("new/nu/", state["nu"])
        out["new/step"] = np.asarray(state["step"])
        out["grad_norm"], out["new_lr"] = np.asarray(m["grad_norm"]), np.asarray(m["lr"])
        t = spec["train"]
        cfg = get_config("olmo-1b").reduced(**t["reduced"])
        model = build_model(cfg)
        put("param/", model.init(jax.random.PRNGKey(0)))
        res = train(model, steps=spec["train_steps"],
                    data_cfg=DataConfig(vocab=cfg.vocab, seq_len=t["seq"],
                                        global_batch=t["batch"]),
                    opt_cfg=opt.OptConfig(lr=t["lr"], warmup_steps=t["warmup"],
                                          total_steps=spec["train_steps"]),
                    log_every=1)
        for k in ("loss", "grad_norm", "lr"):
            out[f"history/{k}"] = np.array([h[k] for h in res.history])
    np.savez(out_path, **out)
"""


def _batch(arch: str) -> dict:
    """Seeded numpy inputs: tokens and labels (the last 3 labels of row 1
    -1), and a cross arch's memory input."""
    over, _ = ARCHS[arch]
    cfg = get_config(arch).reduced(**over)
    rng = np.random.default_rng(len(arch))
    tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    labels = tokens[:, 1:].copy()
    labels[1, -3:] = -1
    batch = {"tokens": tokens[:, :S], "labels": labels}
    mem = cfg.memory_input(S)
    if mem is not None:
        batch[mem[0]] = rng.standard_normal((B,) + mem[1]).astype(np.float32)
    return batch


def _opt_inputs() -> dict:
    rng = np.random.default_rng(5)
    shapes = {"a": (6, 5), "b/c": (7,), "b/d": (3, 2, 4)}
    out = {}
    for name in ("g", "p", "mu"):
        for k, sh in shapes.items():
            out[f"{name}/{k}"] = rng.standard_normal(sh).astype(np.float32)
    for k, sh in shapes.items():
        out[f"nu/{k}"] = rng.random(sh).astype(np.float32)
    return out


OPT_CFG = {"lr": 3e-3, "warmup_steps": 4, "total_steps": 40, "grad_clip": 0.5}
OPT_STEPS = [0, 1, 3, 4, 5, 17, 39, 40, 55]
OPT_STEP = 6   # the state's step before the update


class Reference(Jobs):
    def __init__(self, tmp):
        spec = {"groups": GROUPS, "archs": {a: list(v) for a, v in ARCHS.items()},
                "gate": GATE, "opt": OPT_CFG, "steps": OPT_STEPS, "step": OPT_STEP,
                "train": TRAIN, "train_steps": TRAIN_STEPS}
        arrays = {f"{a}/{k}": v for a in ARCHS for k, v in _batch(a).items()}
        np.savez(tmp / "in.npz", spec=json.dumps(spec), **arrays, **_opt_inputs())
        jobs = [f"grads{i}" for i in range(len(GROUPS))] + ["train"]
        super().__init__(tmp, {job: [sys.executable, "-c", textwrap.dedent(_REFERENCE),
                                     str(tmp / "in.npz"), str(tmp / f"{job}.npz"), job]
                               for job in jobs})

    def __getitem__(self, job: str) -> dict:
        return self.read(job, lambda tmp: dict(np.load(tmp / f"{job}.npz")))

    def arch(self, arch: str) -> dict:
        group = next(i for i, g in enumerate(GROUPS) if arch in g)
        out = self[f"grads{group}"]
        return {k[len(arch) + 1:]: v for k, v in out.items() if k.startswith(arch + "/")}


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    """The reference's processes, started with the module so that they run
    while the tests of the port alone (first in the file) do."""
    r = Reference(tmp_path_factory.mktemp("train_reference"))
    yield r
    r.close()


def _tree(flat: dict, prefix: str) -> dict:
    """A nested dict of CPU tensors from ``{prefix + "a/b": array}``."""
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        *parents, leaf = k[len(prefix):].split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return params_from_numpy(out, device="cpu")


def _params(model, flat: dict, prefix: str = "param/") -> dict:
    """The reference's parameters in the port's tree (empty dicts, which
    hold no leaf on the reference's side, included), CPU tensors."""
    skeleton = tree_skeleton(model.init(torch.Generator().manual_seed(0), device="cpu"))
    return tree_unflatten(skeleton, {p: torch.from_numpy(flat[prefix + "/".join(p)])
                                     for p, _ in tree_flatten_with_path(skeleton)})


def _leaves(tree) -> dict:
    return {"/".join(p): leaf for p, leaf in tree_flatten_with_path(tree)}


def test_data_module_equals_reference_text():
    with open(os.path.join(ROOT, "src", "repro", "train", "data.py")) as f:
        want = f.read()
    with open(os.path.join(ROOT, "src", "repro_torch", "train", "data.py")) as f:
        assert f.read() == want


def test_launcher_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "olmo-1b", "--reduced", "--device", "cpu", "--steps", "3",
        "--batch", "2", "--seq", "32", "--log-every", "1", "--ckpt-dir", str(tmp_path / "ckpt"),
        "--ckpt-every", "3"])
    launch_train.main()
    lines = capsys.readouterr().out.strip().splitlines()
    steps = [json.loads(line) for line in lines[:-1]]
    assert [h["step"] for h in steps] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in steps)
    assert lines[-1].startswith("loss ") and lines[-1].endswith("over 3 steps")
    assert sorted(os.listdir(tmp_path / "ckpt")) == sorted(
        ["header.bin", "passthrough.npz"] + [f"stage_{s:02d}.bin" for s in range(1, 9)])


@pytest.fixture
def two_threads():
    """Two CPU threads for a loop of many tiny ops (more only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_training_learns(two_threads):
    """The reference's learning test (``tests/test_train_and_ckpt.py``):
    the loss on the structured stream drops by more than 1.0 in 100
    steps."""
    cfg = get_config("olmo-1b").reduced(n_layers=2, d_model=128, d_ff=256, vocab=64,
                                        n_heads=4, n_kv=4)
    res = train(build_model(cfg), steps=100,
                data_cfg=DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=16),
                opt_cfg=opt.OptConfig(lr=1e-2, warmup_steps=20, total_steps=100),
                log_every=10, device="cpu")
    first = res.history[0]["loss"]
    best_late = min(h["loss"] for h in res.history[len(res.history) // 2:])
    assert best_late < first - 1.0, (first, best_late)


def test_remat_changes_no_number():
    cfg = get_config("xlstm-125m").reduced()
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32))}
    params = build_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    leaves = list(_leaves(params).values())
    for leaf in leaves:
        leaf.requires_grad_(True)
    got = {}
    for remat in (True, False):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        loss, _ = model.loss(params, batch)
        got[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    assert torch.equal(got[True][0], got[False][0])
    assert all(torch.equal(a, b) for a, b in zip(got[True][1], got[False][1]))


def test_train_step_leaves_params_requiring_grad_and_state_in_place():
    cfg = get_config("olmo-1b").reduced(n_layers=2, d_model=32, d_ff=64, vocab=64,
                                        n_heads=2, n_kv=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    for leaf in _leaves(params).values():
        leaf.requires_grad_(True)
    before = {k: v.detach().clone() for k, v in _leaves(params).items()}
    state = opt.init(params)
    step = make_train_step(model, opt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=4))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 64, (2, 16)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, 64, (2, 16)).astype(np.int32))}
    p2, s2, m = step(params, state, batch)
    assert p2 is params and s2 is state and int(state["step"]) == 1
    assert sorted(m) == ["balance_loss", "ce", "dropped_frac", "grad_norm", "loss", "lr"]
    assert all(not v.requires_grad for v in m.values())
    assert all(v.requires_grad and v.grad is None for v in _leaves(params).values())
    assert all(not torch.equal(v, before[k]) for k, v in _leaves(params).items())


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["olmo-1b", "seamless-m4t-medium", "llama-3.2-vision-90b"])
def test_input_specs_equal_reference(arch, mode):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    specs = build_model(cfg).input_specs(batch=3, seq_len=40, mode=mode)
    jspecs = jax_build_model(jcfg).input_specs(batch=3, seq_len=40, mode=mode)
    assert sorted(specs) == sorted(jspecs)
    for k, v in specs.items():
        assert v.device.type == "meta" and tuple(v.shape) == jspecs[k].shape, k
        want = {"int32": torch.int32, "bfloat16": torch.bfloat16}[str(jspecs[k].dtype)]
        assert v.dtype == want, k
    with pytest.raises(ValueError):
        build_model(cfg).input_specs(batch=1, seq_len=4, mode="verify")


def test_schedule_and_update_equal_reference(ref):
    out = ref["train"]
    ocfg = opt.OptConfig(**OPT_CFG)
    lr = opt.schedule(ocfg, torch.tensor(OPT_STEPS, dtype=torch.float32))
    np.testing.assert_allclose(lr.numpy(), out["lr"], rtol=OPT_RTOL, atol=0)
    inputs = _opt_inputs()
    params, grads = _tree(inputs, "p/"), _tree(inputs, "g/")
    state = {"mu": _tree(inputs, "mu/"), "nu": _tree(inputs, "nu/"),
             "step": torch.tensor(OPT_STEP, dtype=torch.int32)}
    new_p, new_s, m = opt.update(ocfg, grads, state, params)
    assert new_p is params and new_s is state and int(state["step"]) == int(out["new/step"])
    assert state["step"].dtype == torch.int32
    np.testing.assert_allclose(float(m["grad_norm"]), out["grad_norm"], rtol=OPT_RTOL)
    np.testing.assert_allclose(float(m["lr"]), out["new_lr"], rtol=OPT_RTOL)
    # the clip is active (grad norm above grad_clip)
    assert float(m["grad_norm"]) > OPT_CFG["grad_clip"]
    for name, tree in (("p", new_p), ("mu", new_s["mu"]), ("nu", new_s["nu"])):
        for k, v in _leaves(tree).items():
            np.testing.assert_allclose(v.numpy(), out[f"new/{name}/{k}"], rtol=OPT_RTOL,
                                       atol=OPT_RTOL * float(np.abs(out[f"new/{name}/{k}"]).max()),
                                       err_msg=f"{name}/{k}")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_loss_and_grads_equal_reference(ref, arch):
    out = ref.arch(arch)
    over, ce_chunk = ARCHS[arch]
    model = build_model(get_config(arch).reduced(**over))
    params = _params(model, out)
    leaves = _leaves(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    with torch.no_grad():
        logits, aux = model.forward(params, batch)
    assert logits.shape == (B, S, model.cfg.vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), out["logits"], rtol=0, atol=LOGIT_ATOL)
    loss, metrics = model.loss(params, batch, ce_chunk=ce_chunk)
    np.testing.assert_allclose(float(loss.detach()), out["loss"], rtol=LOSS_RTOL)
    assert sorted(metrics) == ["balance_loss", "ce", "dropped_frac"]
    for k in ("ce", "balance_loss", "dropped_frac"):
        np.testing.assert_allclose(float(metrics[k].detach()), out[f"metric/{k}"], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
        if k != "ce":
            np.testing.assert_allclose(float(aux[k]), out[f"metric/{k}"], rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=k)
    if arch == "mixtral-8x22b":
        assert float(metrics["dropped_frac"].detach()) > 0
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert sorted(grads) == sorted(k[len("grad/"):] for k in out if k.startswith("grad/"))
    for k, g in grads.items():
        want = out[f"grad/{k}"]
        scale = float(np.abs(want).max())
        err = float(np.abs(g.numpy() - want).max())
        assert err <= GRAD_RTOL * scale + 1e-9, (k, err, scale)


def test_train_steps_equal_reference(ref, monkeypatch):
    out = ref["train"]
    cfg = get_config("olmo-1b").reduced(**TRAIN["reduced"])
    model = build_model(cfg)
    params = _params(model, out)
    monkeypatch.setattr(Model, "init", lambda self, g, device="cuda": params)
    res = train(model, steps=TRAIN_STEPS,
                data_cfg=DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                                    global_batch=TRAIN["batch"]),
                opt_cfg=opt.OptConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                                      total_steps=TRAIN_STEPS),
                log_every=1, device="cpu")
    assert [h["step"] for h in res.history] == list(range(TRAIN_STEPS))
    assert all(a is b for a, b in zip(_leaves(res.params).values(), _leaves(params).values()))
    assert int(res.opt_state["step"]) == TRAIN_STEPS
    for k in ("loss", "grad_norm", "lr"):
        got = np.array([h[k] for h in res.history])
        np.testing.assert_allclose(got, out[f"history/{k}"], rtol=TRAIN_RTOL, err_msg=k)
    assert sorted(res.history[0]) == sorted(["loss", "ce", "balance_loss", "dropped_frac",
                                             "grad_norm", "lr", "step", "wall_s"])
