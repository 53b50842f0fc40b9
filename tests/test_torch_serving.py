"""The port's serving slice against the JAX package, on the CPU.

Reduced olmo-1b (2 layers, d_model 64), float32, the same weights in
both packages (the JAX init, converted through numpy). Held:

* prefill and decode logits of ``ProgressiveServer(resident="quantized")``
  within atol 2e-5: both sides are float32 and differ only in the order
  of float32 sums (the Pallas interpret kernel sweeps K in blocks);
* greedy tokens identical at every stage, with upgrades landing between
  decode steps, for each container dtype;
* ``resident_report`` equal to the reference's, byte for byte;
* no module of the port, and not ``chip_smoke.py``, imports JAX or the
  JAX package.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.bitplanes import PlaneSchedule as JSchedule
from repro.core.policy import UniformPolicy as JUniformPolicy
from repro.core.progressive import divide as jax_divide
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import ProgressiveServer as JServer
from repro_torch.configs import get_config
from repro_torch.core.bitplanes import PlaneSchedule
from repro_torch.core.policy import UniformPolicy
from repro_torch.core.progressive import divide
from repro_torch.interop import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ProgressiveServer

ROOT = pathlib.Path(__file__).resolve().parents[1]
REDUCED = dict(n_layers=2, d_model=64, d_ff=128, vocab=128, n_heads=2, n_kv=2)
LOGIT_ATOL = 2e-5
SCHEDULES = {"uint8": (8, (2, 2, 2, 2)), "uint16": (16, (2,) * 8),
             "uint32": (20, (5, 5, 5, 5))}


def _pair(bits=16, widths=(2,) * 8, prompt_len=8, decode_steps=16):
    """A JAX server and a port server over the same weights and schedule,
    plus a prompt made with numpy."""
    jcfg = jax_get_config("olmo-1b").reduced(**REDUCED)
    cfg = get_config("olmo-1b").reduced(**REDUCED)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jprog = jax_divide(jparams, JUniformPolicy(schedule=JSchedule(bits, widths)))
    prog = divide(params, UniformPolicy(schedule=PlaneSchedule(bits, widths)))
    max_len = prompt_len + decode_steps
    jsrv = JServer(jmodel, jprog, max_len=max_len, resident="quantized")
    srv = ProgressiveServer(model, prog, max_len=max_len, resident="quantized",
                            device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, prompt_len)
                                               ).astype(np.int32)
    return jsrv, srv, tokens


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy(),
                               rtol=0, atol=LOGIT_ATOL)


def test_prefill_and_decode_logits_every_stage():
    """At every stage: prefill logits, then teacher-forced decode logits
    (the same tokens fed to both), and the resident audit."""
    jsrv, srv, tokens = _pair(decode_steps=3)
    forced = np.random.default_rng(2).integers(0, 128, (2, 3)).astype(np.int32)
    for s in range(1, 9):
        jsrv.receive_stage()
        srv.receive_stage()
        jsrv.start({"tokens": jnp.asarray(tokens)})
        srv.start({"tokens": tokens})
        _close(jsrv.last_logits, srv.last_logits)
        jcaches, caches = jsrv.caches, srv.caches
        for t in range(forced.shape[1]):
            tok = forced[:, t:t + 1]
            jl, jcaches = jsrv._decode(jsrv.params, jcaches, jnp.asarray(tok),
                                       jnp.int32(jsrv.pos + t))
            l, caches = srv.model.decode_step(srv.params, caches, torch.from_numpy(tok),
                                              srv.pos + t)
            _close(jl, l)
        assert srv.resident_report() == jsrv.resident_report(), f"stage {s}"


@pytest.mark.parametrize("container", sorted(SCHEDULES))
def test_greedy_tokens_identical_with_midstream_upgrades(container):
    bits, widths = SCHEDULES[container]
    n_stages = len(widths)
    steps = 2 * n_stages + 2
    jsrv, srv, tokens = _pair(bits, widths, decode_steps=steps)
    arrivals = set(range(2, 2 * n_stages, 2))
    jsrv.receive_stage()
    srv.receive_stage()
    jsrv.start({"tokens": jnp.asarray(tokens)})
    srv.start({"tokens": tokens})
    jres = jsrv.decode(steps, stage_arrival=lambda i: i in arrivals)
    res = srv.decode(steps, stage_arrival=lambda i: i in arrivals)
    assert res.upgrades == jres.upgrades
    assert res.stage_at_step == jres.stage_at_step
    assert res.stage_at_step[-1] == n_stages
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    _close(jsrv.last_logits, srv.last_logits)
    rep = srv.resident_report()
    assert rep == jsrv.resident_report()
    assert rep["fp_bytes"] == 0 and rep["fp_leaves"] == 0


def test_resident_fp_and_missing_card_raise():
    """``resident`` takes the reference's two modes, ``"fp"`` the default;
    the default device is the card, never a silent move to the CPU, so
    the default server raises without one."""
    cfg = get_config("olmo-1b").reduced(**REDUCED)
    model = build_model(cfg)
    prog = divide(model.init(torch.Generator().manual_seed(0), device="cpu"))
    assert ProgressiveServer(model, prog, max_len=8, device="cpu").resident == "fp"
    with pytest.raises(ValueError, match="resident"):
        ProgressiveServer(model, prog, max_len=8, resident="float", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProgressiveServer(model, prog, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProgressiveServer(model, prog, max_len=8, resident="quantized")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(torch.Generator().manual_seed(0))


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_no_jax_and_no_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), f"{path}: {name}"
        assert "import_module(\"repro." not in path.read_text()
