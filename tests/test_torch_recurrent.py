"""Recurrent blocks (ROADMAP A8(d)): Mamba-2, mLSTM and sLSTM with
per-slot state masking, and xlstm-125m served whole, against the JAX
package on the CPU.

The functions of ``models/ssm.py`` on seeded numpy inputs beside the
reference's, and xlstm-125m as ``reduced(n_layers=4)`` gives it (two
cycles of ``slstm, mlstm``, d_model 64, 4 heads, vocab 256, float32), the
same numpy-made weights in both packages (the port's seeded init, the
norm scales spread around 1). Held:

* each function of ``ssm.py`` within ``RTOL``/``ATOL``; the reference's
  own properties on the port (chunked equals stepwise, the prefill's
  state continues decode, chunk-size invariance, mLSTM and sLSTM
  forwards continue from their caches);
* ``_mask_recurrent``: a masked slot's state ``torch.equal`` before and
  after a decode step and a ``prefill_chunk`` step, for each kind;
* the division: planes, stage order and wire v3 bytes identical;
  accumulators and ``fingerprint()`` equal at stages 1, 4 and 8, in
  memory and wire-fed;
* serving: ``ProgressiveServer`` in both residencies (logits within
  ``LOGIT_ATOL``, greedy tokens identical at stages 1, 4 and 8);
  ``SlotPoolEngine`` chunked (upgrades mid-stream, a slot reused after an
  eviction) and at batch 1 (buckets off): tokens identical;
* refusals: speculation, a bucket-padded prefill, a mesh (ROADMAP A13);
  the CLI serves ``--arch xlstm-125m --reduced``.

The reference's division, engines and pools run in processes of their
own (:class:`Reference`), one a job, started with the module's fixture
and read when a test needs them; ``tests/test_torch_zamba2.py`` runs its
jobs the same way.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jssm
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.core.progressive import ReceiverState, divide, tree_flatten_with_path
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import ssm
from repro_torch.models.model import build_model
from repro_torch.serving import (PoolRequest, ProgressiveServer, SlotPoolEngine, SpecConfig,
                                 SpeculativeEngine)
from repro_torch.transmission import ProgressiveClient

SIZE = dict(d_model=64, vocab=256)
# float32 on both sides, only the order of float32 sums differs (the
# matmuls, einsums over hd and N): a few ulps of outputs of order 1-10,
# compounded over the recurrences' steps
RTOL = ATOL = 2e-5
LOGIT_ATOL = 2e-5       # as tests/test_torch_serving.py
PROMPT, STEPS, MAX_LEN = 20, 12, 64
CHECK_STAGES = (1, 4, 8)
POOL = dict(n_slots=3, max_len=MAX_LEN, dispatch_window=4, prefill_chunk=8,
            resident="quantized")

# The reference side of one arch, a job a process: "division" divides the
# weights (paths, ranges, planes, stage order); "encode" encodes v3;
# "receiver" feeds an in-memory receiver
# (fingerprints and buffers at CHECK_STAGES, float leaves at stage 8);
# "server/<resident>"
# runs ProgressiveServer from a fresh start at each of CHECK_STAGES;
# "pool/<chunked>" runs SlotPoolEngine on the requests; "run_stack" runs
# the float model's prefill and decode steps. The jobs but "division" take
# the port's planes as the reference's divided model (its quantize is
# seconds of JAX compiles a job), which the division job holds bit for
# bit.
_REFERENCE = """
    import json, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import wire
    from repro.core.bitplanes import PlaneSchedule
    from repro.core.policy import TensorPlan
    from repro.core.progressive import (ProgressiveModel, ReceiverState, TensorPlanes,
                                        divide)
    from repro.models.model import build_model
    from repro.serving.engine import PoolRequest, ProgressiveServer, SlotPoolEngine

    inp, job = np.load(sys.argv[1]), sys.argv[3]
    spec = json.loads(str(inp["spec"]))
    model = build_model(get_config(spec["name"]).reduced(**spec["over"]))

    def leaf(path, shape):
        key = "param/" + wire.path_str(path)
        # a stack of no full cycle: the reference keeps zero-size leaves
        return jnp.asarray(inp[key]) if key in inp else jnp.zeros(shape.shape, shape.dtype)

    params = jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(model.init,
                                                                   jax.random.PRNGKey(0)))
    out = {}
    stages = spec["stages"]
    if job == "run_stack":
        tokens = jnp.asarray(inp["tokens"])
        logits, caches = model.prefill(params, {"tokens": tokens})
        caches = model.grow_caches(caches, tokens.shape[1] + len(spec["forced"][0]))
        out["prefill"] = np.asarray(logits)
        for t, tok in enumerate(np.asarray(spec["forced"]).T):
            logits, caches = model.decode_step(params, caches, jnp.asarray(tok)[:, None],
                                               tokens.shape[1] + t)
            out[f"decode/{t}"] = np.asarray(logits)
        for path, a in jax.tree_util.tree_flatten_with_path(caches)[0]:
            out["cache/" + wire.path_str(path)] = np.asarray(a)
        np.savez(sys.argv[2], **out)
        sys.exit(0)
    if job == "division":
        prog = divide(params)
    else:
        # the port's planes (the division job holds its bytes to the
        # reference's own), as the reference's divided model
        meta = json.loads(str(inp["prog"]))
        leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
        by_path = {wire.path_str(p): (p, a) for p, a in leaves}
        tensors = []
        for i, m in enumerate(meta["tensors"]):
            path, a = by_path[m["path"]]
            plan = TensorPlan(schedule=PlaneSchedule(m["bits"], tuple(m["widths"])),
                              priority=m["priority"])
            tensors.append(TensorPlanes(
                path=path, plan=plan, lo=jnp.asarray(inp[f"lo/{i}"]),
                hi=jnp.asarray(inp[f"hi/{i}"]), shape=tuple(a.shape), orig_dtype=a.dtype,
                planes=[jnp.asarray(inp[f"plane/{i}/{j}"]) for j in range(len(m["widths"]))]))
        prog = ProgressiveModel(tensors=tensors, treedef=treedef, n_stages=meta["n_stages"],
                                passthrough=[])
    if job == "division":
        out["order"] = np.asarray(json.dumps([[i for i, _ in prog.stage(s)]
                                              for s in range(1, prog.n_stages + 1)]))
        out["paths"] = np.asarray(json.dumps([wire.path_str(t.path) for t in prog.tensors]))
        for i, t in enumerate(prog.tensors):
            out[f"lo/{i}"], out[f"hi/{i}"] = np.asarray(t.lo), np.asarray(t.hi)
            for j, plane in enumerate(t.planes):
                out[f"plane/{i}/{j}"] = np.asarray(plane)
    elif job == "encode":
        out["blob"] = np.frombuffer(wire.encode(prog, integrity=True), np.uint8)
    elif job == "receiver":
        st = ReceiverState.init(prog)
        for s in range(1, prog.n_stages + 1):
            st = st.receive(prog.stage(s))
            if s in stages:
                out[f"fp/{s}"] = np.asarray(json.dumps(st.store.fingerprint()))
                for k, v in st.store.buffers.items():
                    out[f"buffer/{s}/{k}"] = np.asarray(v)
        for path, a in jax.tree_util.tree_flatten_with_path(st.materialize())[0]:
            out["leaf/" + wire.path_str(path)] = np.asarray(a)
    elif job.startswith("server/"):
        resident = job.split("/")[1]
        srv = ProgressiveServer(model, prog, max_len=spec["max_len"], resident=resident)
        for s in range(1, prog.n_stages + 1):
            srv.receive_stage()
            if s not in stages:
                continue
            srv.start({"tokens": jnp.asarray(inp["tokens"])})
            out[f"{s}/first"] = np.asarray(srv.last_logits)
            out[f"{s}/tokens"] = np.asarray(srv.decode(spec["steps"]).tokens)
            out[f"{s}/last"] = np.asarray(srv.last_logits)
        out["report"] = np.asarray(json.dumps(srv.resident_report()))
    else:
        chunked = job.split("/")[1] == "chunked"
        pool = SlotPoolEngine(model, prog, chunked_prefill=chunked, **spec["pool"])
        pool.receive_stage()
        for rid, budget in enumerate(spec["budgets"]):
            pool.submit(PoolRequest(rid=rid, prompt=inp[f"prompt/{rid}"],
                                    max_new_tokens=budget))
        res = pool.run(on_window=lambda _: pool.upgrade_if_available())
        out["run"] = np.asarray(json.dumps({
            "out": {rid: list(map(int, t)) for rid, t in res.items()},
            "stage_log": pool.stage_log, "admit_stage": pool.admit_stage,
            "upgrades": pool.upgrades, "buckets": pool.prefill_buckets}))
    np.savez(sys.argv[2], **out)
"""


class Reference:
    """The reference side of one arch: its jobs' processes, started
    together, each read once when a test asks for it."""

    def __init__(self, tmp, name: str, over: dict, weights: dict, jobs, **inputs):
        self.tmp, self.out = tmp, {}
        spec = {"name": name, "over": {**SIZE, **over}, "stages": list(CHECK_STAGES),
                "max_len": MAX_LEN, "steps": STEPS, "pool": POOL,
                **inputs.pop("spec", {})}
        arrays = {"spec": json.dumps(spec), **inputs}
        for path, a in tree_flatten_with_path(weights):
            arrays["param/" + wire.path_str(path)] = a
        np.savez(tmp / "in.npz", **arrays)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
        env.pop("XLA_FLAGS", None)
        self.procs = {}
        for job in jobs:
            name = job.replace("/", "_")
            with open(tmp / f"{name}.err", "w") as err:
                self.procs[job] = subprocess.Popen(
                    [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(tmp / "in.npz"),
                     str(tmp / f"{name}.npz"), job],
                    stdout=subprocess.DEVNULL, stderr=err, env=env)

    def __getitem__(self, job: str) -> dict:
        if job not in self.out:
            name = job.replace("/", "_")
            rc = self.procs[job].wait(timeout=300)
            assert rc == 0, (self.tmp / f"{name}.err").read_text()[-3000:]
            self.out[job] = dict(np.load(self.tmp / f"{name}.npz"))
        return self.out[job]

    def close(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(want, got, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _prompt(seed, shape, vocab=SIZE["vocab"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _numpy_weights(model, seed=0) -> dict:
    """The port's seeded init as numpy, every norm scale (``scale``,
    ``out_norm``) spread around 1 so that each changes the outputs."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, t in tree_flatten_with_path(model.init(torch.Generator().manual_seed(seed),
                                                     device="cpu")):
        a = t.numpy()
        if path[-1] in ("scale", "out_norm"):
            a = a + 0.2 * rng.standard_normal(a.shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a.astype(np.float32)
    return out


def _requests(seed, lengths, vocab=SIZE["vocab"]):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, vocab, L).astype(np.int32), int(rng.integers(10, 16)))
            for rid, L in enumerate(lengths)]


# four requests on three slots, prompts of 12 and 20 tokens (2 and 3
# chunks of 8; two lengths, two reference prefills at batch 1)
REQUESTS = _requests(4, [12, 20, 12, 20])


def start_arch(tmp, name: str, over: dict, jobs, **inputs) -> dict:
    """The port's model over the numpy weights, divided by the default
    policy, and the reference's jobs on the same weights, started."""
    cfg = get_config(name).reduced(**SIZE, **over)
    model = build_model(cfg)
    weights = _numpy_weights(model)
    params = params_from_numpy(weights, device="cpu")
    inputs.setdefault("tokens", _prompt(1, (2, PROMPT)))
    for rid, prompt, _ in REQUESTS:
        inputs[f"prompt/{rid}"] = prompt
    inputs["spec"] = {"budgets": [b for _, _, b in REQUESTS], **inputs.get("spec", {})}
    prog = divide(params)
    inputs["prog"] = json.dumps({"n_stages": prog.n_stages, "tensors": [
        {"path": "/".join(t.path), "bits": t.plan.schedule.bits,
         "widths": list(t.plan.schedule.widths), "priority": t.plan.priority}
        for t in prog.tensors]})
    for i, t in enumerate(prog.tensors):
        inputs[f"lo/{i}"], inputs[f"hi/{i}"] = t.lo.numpy(), t.hi.numpy()
        for j, plane in enumerate(t.planes):
            inputs[f"plane/{i}/{j}"] = plane.numpy()
    ref = Reference(tmp, name, over, weights, jobs, **inputs)
    return dict(cfg=cfg, model=model, params=params, prog=prog, ref=ref,
                tokens=inputs["tokens"])


@pytest.fixture(scope="module")
def xlstm(tmp_path_factory):
    a = start_arch(tmp_path_factory.mktemp("xlstm"), "xlstm-125m", dict(n_layers=4),
                   ["division", "encode", "receiver", "server/quantized", "server/fp",
                    "pool/chunked", "pool/batch1"])
    yield a
    a["ref"].close()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def check_config(name: str, over: dict):
    """Published and reduced fields equal the reference's; the parameter
    tree's paths and shapes too. Returns the reference's shapes."""
    cfg, jcfg = get_config(name), jax_get_config(name)
    fields = [f.name for f in dataclasses.fields(cfg) if f.name != "dtype"]
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    for kw in ({}, SIZE, over):
        red, jred = cfg.reduced(**kw), jcfg.reduced(**kw)
        assert {f: getattr(red, f) for f in fields} == {f: getattr(jred, f) for f in fields}
    ours = build_model(cfg.reduced(**SIZE, **over)).init(torch.Generator(), device="meta")
    jshapes = jax.eval_shape(jax_build_model(jcfg.reduced(**SIZE, **over)).init,
                             jax.random.PRNGKey(0))
    flat = {tuple(p.key for p in path): tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert {p: tuple(t.shape) for p, t in tree_flatten_with_path(ours)} == flat
    return flat


def test_config_equals_reference(xlstm):
    """(Takes the fixture first, which starts the reference's jobs.)"""
    flat = check_config("xlstm-125m", dict(n_layers=4))
    assert get_config("xlstm-125m").cycle == ("slstm", "mlstm")
    assert flat[("decoder", "cycles", "1_mlstm", "mixer", "w_if")] == (2, 128, 8)
    assert flat[("decoder", "cycles", "0_slstm", "mixer", "r")] == (2, 4, 16, 64)


# ---------------------------------------------------------------------------
# ssm.py against the reference
# ---------------------------------------------------------------------------

def _mixer(kind, cfg_name, seed, **over):
    """A mixer's parameters from the port's seeded init, in both packages."""
    jcfg = jax_get_config(cfg_name).reduced(**over)
    cfg = get_config(cfg_name).reduced(**over)
    p = ssm.INIT[kind](cfg, torch.Generator().manual_seed(seed), device="cpu")
    return jcfg, cfg, {k: jnp.asarray(v.numpy()) for k, v in p.items()}, p


def _u(seed, shape):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _cache_close(jc, c, msg):
    assert set(c) == set(jc)
    for k in c:
        _close(jc[k], c[k], msg=f"{msg} cache {k}")


def _jit(fn, **kw):
    """A reference function compiled whole, its config static (op-by-op
    dispatch compiles every operation apart)."""
    return jax.jit(functools.partial(fn, **kw), static_argnums=0)


@pytest.mark.parametrize("fn", ["mamba2_forward", "mamba2_prefill", "mamba2_step",
                                "mlstm_forward", "mlstm_forward_cache", "mlstm_step",
                                "slstm_forward", "slstm_step"])
def test_ssm_function_equals_reference(fn):
    """T = 19 spans three SSD chunks of 8 with a ragged end; the step
    functions run 6 steps from a prefill's cache."""
    kind = fn.split("_")[0]
    jcfg, cfg, jp, p = _mixer(kind, "zamba2-7b" if kind == "mamba2" else "xlstm-125m", 1)
    u = _u(2, (2, 19, cfg.d_model))
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    if fn == "mamba2_forward":
        jo, jS = _jit(jssm.mamba2_forward, return_state=True)(jcfg, jp, ju)
        o, S = ssm.mamba2_forward(cfg, p, tu, return_state=True)
        _close(jo, o)
        _close(jS, S)
        return
    if fn in ("mlstm_forward", "slstm_forward"):
        _close(_jit(getattr(jssm, fn))(jcfg, jp, ju), getattr(ssm, fn)(cfg, p, tu))
        return
    jprefill = {"mamba2": _jit(jssm.mamba2_prefill),
                "mlstm": _jit(jssm.mlstm_forward, return_cache=True),
                "slstm": _jit(jssm.slstm_forward, return_cache=True)}
    jo, jc = jprefill[kind](jcfg, jp, ju)
    o, c = ssm.prefill(cfg, kind, p, tu)
    _close(jo, o)
    _cache_close(jc, c, "prefill")
    if fn == "mlstm_forward_cache":
        # the forward over a second segment, from the prefill's cache
        u2 = _u(3, (2, 7, cfg.d_model))
        jo, jc = _jit(jssm.mlstm_forward, return_cache=True)(jcfg, jp, jnp.asarray(u2),
                                                            cache=jc)
        o, c = ssm.mlstm_forward(cfg, p, torch.from_numpy(u2), cache=c, return_cache=True)
        _close(jo, o)
        _cache_close(jc, c, "continued")
        return
    if fn == "mamba2_prefill":
        assert c["conv"].shape == (2, cfg.conv_width - 1, ssm.mamba2_dims(cfg)[0])
        return
    jstep = _jit(getattr(jssm, f"{kind}_step"))
    for t in range(6):
        x = _u(10 + t, (2, 1, cfg.d_model))
        jo, jc = jstep(jcfg, jp, jnp.asarray(x), jc)
        o, c = ssm.STEP[kind](cfg, p, torch.from_numpy(x), c)
        _close(jo, o, msg=f"step {t}")
        _cache_close(jc, c, f"step {t}")


# the reference's own properties (tests/test_ssm.py), on the port, at its
# tolerance
PROP_TOL = 2e-4


def _steps(cfg, kind, p, u, cache):
    outs = []
    for t in range(u.shape[1]):
        o, cache = ssm.STEP[kind](cfg, p, u[:, t:t + 1], cache)
        outs.append(o)
    return torch.cat(outs, dim=1), cache


@pytest.mark.parametrize("prop", ["chunked_equals_stepwise", "prefill_continues_decode",
                                  "chunk_size_invariance", "mlstm_continues_from_cache",
                                  "slstm_continues_from_cache"])
def test_ssm_properties(prop):
    if prop.startswith(("mlstm", "slstm")):
        kind = prop[:5]
        _, cfg, _, p = _mixer(kind, "xlstm-125m", 0)
        u = torch.from_numpy(_u(1, (2, 13, cfg.d_model)))
        full = getattr(ssm, f"{kind}_forward")(cfg, p, u)
        out, cache = ssm.prefill(cfg, kind, p, u[:, :9])
        _close(_np(full[:, :9]), out, PROP_TOL, PROP_TOL)
        step, _ = _steps(cfg, kind, p, u[:, 9:], cache)
        _close(_np(full[:, 9:]), step, PROP_TOL, PROP_TOL)
        return
    _, cfg, _, p = _mixer("mamba2", "zamba2-7b", 0, ssm_chunk=4)
    if prop == "chunked_equals_stepwise":
        u = torch.from_numpy(_u(1, (2, 13, cfg.d_model)))     # not a chunk multiple
        step, _ = _steps(cfg, "mamba2", p, u, ssm.mamba2_init_cache(cfg, 2, u.dtype,
                                                                      device="cpu"))
        _close(_np(ssm.mamba2_forward(cfg, p, u)), step, PROP_TOL, PROP_TOL)
    elif prop == "prefill_continues_decode":
        u = torch.from_numpy(_u(2, (1, 11, cfg.d_model)))
        full = ssm.mamba2_forward(cfg, p, u)
        out, cache = ssm.mamba2_prefill(cfg, p, u[:, :8])
        _close(_np(full[:, :8]), out, PROP_TOL, PROP_TOL)
        step, _ = _steps(cfg, "mamba2", p, u[:, 8:], cache)
        _close(_np(full[:, 8:]), step, PROP_TOL, PROP_TOL)
    else:
        u = torch.from_numpy(_u(3, (1, 16, cfg.d_model)))
        _close(_np(ssm.mamba2_forward(cfg, p, u)),
               ssm.mamba2_forward(dataclasses.replace(cfg, ssm_chunk=16), p, u),
               PROP_TOL, PROP_TOL)


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_masked_slot_state_unchanged(kind):
    """A decode step with slot 1 free (pos -1), then a prefill chunk with
    slot 1 fully masked and slot 2 past its end after 2 rows: slot 1's
    state ``torch.equal`` before and after both, written in place; slot
    2's state after the chunk equals two rows alone."""
    name = "zamba2-7b" if kind == "mamba2" else "xlstm-125m"
    cfg = get_config(name).reduced(**SIZE, cycle=(kind,), n_layers=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    caches = model.init_caches(3, 16, device="cpu")
    before = {k: v.clone() for k, v in caches["cycles"][f"0_{kind}"].items()}
    ids = {k: v.data_ptr() for k, v in caches["cycles"][f"0_{kind}"].items()}
    tok = torch.from_numpy(_prompt(1, (3, 1)))
    _, caches = model.decode_step(params, caches, tok, torch.tensor([0, -1, 0]))
    state = caches["cycles"][f"0_{kind}"]
    assert {k: v.data_ptr() for k, v in state.items()} == ids
    for k, v in state.items():
        assert torch.equal(v[:, 1], before[k][:, 1]), k
        assert not torch.equal(v[:, 0], before[k][:, 0]), k
    mid = {k: v.clone() for k, v in state.items()}
    toks = torch.from_numpy(_prompt(2, (3, 4)))
    tok_pos = torch.tensor([[1, 2, 3, 4], [-1] * 4, [1, 2, -1, -1]], dtype=torch.int32)
    _, caches = model.prefill_chunk(params, caches, toks, tok_pos)
    two = {k: v.clone() for k, v in mid.items()}
    alone = {"cycles": {f"0_{kind}": two}, "tail": {}}
    _, alone = model.prefill_chunk(params, alone, toks[:, :2], tok_pos[:, :2])
    for k, v in caches["cycles"][f"0_{kind}"].items():
        assert torch.equal(v[:, 1], before[k][:, 1]), k
        assert torch.equal(v[:, 2], alone["cycles"][f"0_{kind}"][k][:, 2]), k


def test_reset_recurrent_slot_zeroes_in_place(xlstm):
    """Admission into a used slot zeroes that slot's state in every
    recurrent leaf, in place, and leaves the other slots' as they were."""
    pool = SlotPoolEngine(xlstm["model"], xlstm["prog"], n_slots=2, max_len=MAX_LEN,
                          resident="quantized", device="cpu")
    leaves = [leaf for _, key in pool._recurrent_keys
              for leaf in pool.caches["cycles"][key].values()]
    assert len(leaves) == 4 + 3
    for i, leaf in enumerate(leaves):
        leaf.fill_(float(i + 1))
    ptrs = [leaf.data_ptr() for leaf in leaves]
    pool._reset_recurrent_slot(1)
    for i, leaf in enumerate(leaves):
        assert leaf.data_ptr() == ptrs[i]
        assert not leaf[:, 1].any() and bool((leaf[:, 0] == i + 1).all())


# ---------------------------------------------------------------------------
# refusals and the CLI
# ---------------------------------------------------------------------------

def test_refusals(xlstm):
    model, prog = xlstm["model"], xlstm["prog"]
    with pytest.raises(NotImplementedError, match="rollback"):
        SpeculativeEngine(model, prog, max_len=MAX_LEN, spec=SpecConfig(draft_bits=4, k=2),
                          device="cpu")
    params = ReceiverState.init(prog, device="cpu").receive(prog.stage(1)).materialize()
    with pytest.raises(NotImplementedError, match="recurrent states"):
        model.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.int64)},
                      n_valid=np.asarray([5], np.int32))
    mesh = make_serving_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        ProgressiveServer(model, prog, max_len=MAX_LEN, mesh=mesh, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        SlotPoolEngine(model, prog, n_slots=2, max_len=MAX_LEN, mesh=mesh, device="cpu")
    client = ProgressiveClient(mesh=mesh, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        client.feed(wire.encode(prog))


@pytest.mark.parametrize("mode", ["default", "pool"])
def test_cli_xlstm_reduced(mode, capsys):
    """``--arch xlstm-125m --reduced`` serves in the default stream and the
    pool."""
    argv = ["--arch", "xlstm-125m", "--reduced", "--device", "cpu", "--decode-steps", "8"]
    serve.main(argv + {"default": [], "pool": ["--pool-clients", "3", "--pool-slots", "2"]}[mode])
    assert "served" in capsys.readouterr().out


@pytest.mark.parametrize("flags,match", [(["--speculative"], "rollback"),
                                         (["--mesh-shards", "2"], "ROADMAP A13")],
                         ids=["speculative", "mesh_shards"])
def test_cli_refusals(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        serve.main(["--arch", "xlstm-125m", "--reduced", "--device", "cpu"] + flags)


# ---------------------------------------------------------------------------
# the division: bytes, accumulators, fingerprints
# ---------------------------------------------------------------------------

def _stage_ends(blob):
    meta, hdr = wire.decode_header(blob)
    return np.cumsum([hdr] + wire.layout_from_header(meta, hdr).stage_bytes).tolist()


def _buffers(store):
    return {k: _np(v).tobytes() for k, v in store.buffers.items()}


def check_division(a):
    """Every tensor's path, range and planes, and each stage's order,
    equal the reference's division's; the v3 blob byte-identical to the
    reference's encoding; the stream fed in ragged chunks to a client beside
    an in-memory receiver: accumulators and ``fingerprint()`` equal to each
    other and the reference's at stages 1, 4 and 8; at stage 8 the wire-fed
    leaves equal the in-memory ones and the reference's."""
    prog, division = a["prog"], a["ref"]["division"]
    assert ["/".join(t.path) for t in prog.tensors] == json.loads(str(division["paths"]))
    for i, t in enumerate(prog.tensors):
        assert float(t.lo) == float(division[f"lo/{i}"]) and \
            float(t.hi) == float(division[f"hi/{i}"]), t.path
        for j, plane in enumerate(t.planes):
            assert np.array_equal(_np(plane), division[f"plane/{i}/{j}"]), (t.path, j)
    assert [[i for i, _ in prog.stage(s)] for s in range(1, prog.n_stages + 1)] \
        == json.loads(str(division["order"]))
    blob = wire.encode(prog, integrity=True)
    assert blob == a["ref"]["encode"]["blob"].tobytes()
    ref = a["ref"]["receiver"]
    ends = _stage_ends(blob)
    client, st = ProgressiveClient(device="cpu"), ReceiverState.init(prog, device="cpu")
    rng = np.random.default_rng(5)
    pos = 0
    for s in range(1, prog.n_stages + 1):
        while pos < ends[s]:
            n = min(ends[s] - pos, int(np.exp(rng.uniform(0.0, np.log(1 << 15)))))
            client.feed(blob[pos:pos + n])
            pos += n
        st = st.receive(prog.stage(s))
        if s not in CHECK_STAGES:
            continue
        assert client.store.fingerprint() == st.store.fingerprint() \
            == json.loads(str(ref[f"fp/{s}"])), s
        want = {k[len(f"buffer/{s}/"):]: v.tobytes() for k, v in ref.items()
                if k.startswith(f"buffer/{s}/")}
        assert _buffers(client.store) == _buffers(st.store) == want, s
    wleaves = client.materialize()
    for path, leaf in tree_flatten_with_path(st.materialize()):
        key = "/".join(path)
        assert torch.equal(wleaves[key], leaf), path
        assert np.array_equal(ref["leaf/" + key], _np(leaf)), path
    return prog


def test_division_equals_reference(xlstm):
    prog = check_division(xlstm)
    paths = ["/".join(t.path) for t in prog.tensors]
    assert "decoder/cycles/0_slstm/mixer/r" in paths
    assert "decoder/cycles/1_mlstm/mixer/w_if" in paths


# ---------------------------------------------------------------------------
# serving against the JAX engines
# ---------------------------------------------------------------------------

def check_server(a, resident):
    """At stages 1, 4 and 8 from a fresh start: the prefill's logits, then
    ``STEPS`` greedy steps; logits within ``LOGIT_ATOL`` and tokens
    identical to the reference's; the resident report equal."""
    ref = a["ref"][f"server/{resident}"]
    srv = ProgressiveServer(a["model"], a["prog"], max_len=MAX_LEN, resident=resident,
                            device="cpu")
    for s in range(1, 9):
        srv.receive_stage()
        if s not in CHECK_STAGES:
            continue
        srv.start({"tokens": a["tokens"]})
        _close(ref[f"{s}/first"], srv.last_logits, 0, LOGIT_ATOL, f"stage {s}")
        res = srv.decode(STEPS)
        np.testing.assert_array_equal(_np(res.tokens), ref[f"{s}/tokens"], f"stage {s}")
        _close(ref[f"{s}/last"], srv.last_logits, 0, LOGIT_ATOL, f"stage {s}")
    assert json.loads(json.dumps(srv.resident_report())) == json.loads(str(ref["report"]))


@pytest.mark.parametrize("resident", ["quantized", "fp"])
def test_server_logits_and_tokens_every_stage(xlstm, resident):
    check_server(xlstm, resident)


def check_pool(a, chunked):
    """``REQUESTS`` on three slots, an upgrade a window; the fourth
    request reuses an evicted slot, whose state the pool zeroes. Tokens,
    stage log, admission stages and upgrades equal the reference's."""
    ref = json.loads(str(a["ref"][f"pool/{'chunked' if chunked else 'batch1'}"]["run"]))
    pool = SlotPoolEngine(a["model"], a["prog"], chunked_prefill=chunked, device="cpu", **POOL)
    pool.receive_stage()
    for rid, prompt, budget in REQUESTS:
        pool.submit(PoolRequest(rid=rid, prompt=prompt, max_new_tokens=budget))
    out = pool.run(on_window=lambda _: pool.upgrade_if_available())
    assert not pool.prefill_buckets and not ref["buckets"]
    assert {str(k): v for k, v in out.items()} == ref["out"]
    assert json.loads(json.dumps({"stage_log": pool.stage_log, "admit_stage": pool.admit_stage,
                                  "upgrades": pool.upgrades})) == \
        {k: ref[k] for k in ("stage_log", "admit_stage", "upgrades")}
    assert pool.stage > 2 and len(pool.admitted_order) == 4


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "batch1"])
def test_pool_tokens_equal_reference(xlstm, chunked):
    check_pool(xlstm, chunked)
