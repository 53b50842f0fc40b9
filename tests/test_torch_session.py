"""The port's co-simulation ``Session`` against the JAX package's, on the CPU.

Reduced olmo-1b (2 layers, d_model 64), the same weights in both packages
(the JAX init, converted through numpy); both packages' wire blobs are
asserted equal first. Held, each byte for byte:

* the framework-free modules the port copies (simulator, scenarios,
  scheduler, ``obs``) equal the reference's text after the import rename;
* ``to_jsonl()`` of ``run_timeline`` on every scenario of the catalog,
  and its timeline against ``scheduler.progressive_timeline`` to 1e-9 s;
* ``to_jsonl()``, tokens, upgrades and per-step stages of
  ``run_serving`` in float and quantized residency and speculative;
* faulted runs (``browser-3g-lossy``, ``edge-flaky``, the CLI's default
  profile): logs and ``transport_summary``;
* ``run_serving_pool`` on ``flash-crowd``, plain and speculative;
* the session's telemetry mirror (Prometheus text).
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_config as jax_get_config
from repro.core import wire as jwire
from repro.core.progressive import divide as jax_divide
from repro.models.model import build_model as jax_build_model
from repro.obs.exporters import to_prometheus as jto_prometheus
from repro.serving.speculative import SpecConfig as JSpecConfig
from repro.transmission import FaultPolicy as JFaultPolicy
from repro.transmission import FaultTrace as JFaultTrace
from repro.transmission import Session as JSession
from repro.transmission import StageCost as JStageCost
from repro.transmission import get_scenario as jget_scenario
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.core.progressive import divide
from repro_torch.interop import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.obs.exporters import to_prometheus
from repro_torch.serving.speculative import SpecConfig
from repro_torch.transmission import (FaultPolicy, FaultTrace, Session, StageCost,
                                      flash_crowd_arrivals, get_scenario, list_scenarios,
                                      progressive_timeline)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REDUCED = dict(n_layers=2, d_model=64, d_ff=128, vocab=128, n_heads=2, n_kv=2)
TOL_S = 1e-9
COPIES = ["transmission/simulator.py", "transmission/scenarios.py",
          "transmission/scheduler.py", "transmission/__init__.py", "obs/__init__.py",
          "obs/registry.py", "obs/tracer.py", "obs/exporters.py", "obs/schema.py",
          "obs/report.py"]


@pytest.fixture(scope="module")
def pair():
    """Both packages' model, divided model and v1/v3 blobs over the same
    weights, and a numpy prompt."""
    jcfg = jax_get_config("olmo-1b").reduced(**REDUCED)
    cfg = get_config("olmo-1b").reduced(**REDUCED)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jprog, prog = jax_divide(jparams), divide(params)
    blobs = {}
    for integrity in (False, True):
        jb, b = jwire.encode(jprog, integrity=integrity), wire.encode(prog, integrity=integrity)
        assert jb == b, f"integrity={integrity}"
        blobs[integrity] = b
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    return {"jmodel": jmodel, "model": model, "jprog": jprog, "prog": prog,
            "blobs": blobs, "tokens": tokens, "vocab": cfg.vocab}


def _sessions(p, scenario, *, integrity=False, seed=0, **kw):
    blob = p["blobs"][integrity]
    return (JSession.from_scenario(blob, jget_scenario(scenario), seed=seed, **kw),
            Session.from_scenario(blob, get_scenario(scenario), seed=seed, device="cpu",
                                  **kw))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("rel", COPIES)
def test_copied_modules_equal_reference_after_rename(rel):
    ref = (ROOT / "src" / "repro" / rel).read_text()
    renamed = re.sub(r"\bfrom repro import\b", "from repro_torch import",
                     re.sub(r"\brepro\.", "repro_torch.", ref))
    assert (ROOT / "src" / "repro_torch" / rel).read_text() == renamed


@pytest.mark.parametrize("scenario", list_scenarios())
def test_run_timeline_log_identical_on_every_scenario(pair, scenario):
    costs = [(0.001 * s, 0.002, 0.004 * (s + 1)) for s in range(pair["prog"].n_stages)]
    js, s = _sessions(pair, scenario)
    for concurrent in (True, False):
        jr = js.run_timeline([JStageCost(*c) for c in costs], concurrent=concurrent)
        r = s.run_timeline([StageCost(*c) for c in costs], concurrent=concurrent)
        assert r.to_jsonl() == jr.to_jsonl(), concurrent
        assert r.timeline.download_done == jr.timeline.download_done
        assert r.timeline.result_ready == jr.timeline.result_ready
        assert r.client.store.fingerprint() == jr.client.store.fingerprint()
    assert s.stage_arrival_times() == js.stage_arrival_times()


@pytest.mark.parametrize("concurrent", [True, False])
def test_timeline_agrees_with_the_algebra(pair, concurrent):
    """The executed timeline against ``progressive_timeline`` to 1e-9 s on
    a constant link and on a trace with a stall (the reference's own
    agreement test, on the port's client)."""
    from repro_torch.transmission import BandwidthTrace, Link

    prog = pair["prog"]
    blob = pair["blobs"][False]
    layout = Session(blob, BandwidthTrace.constant(1.0), device="cpu").layout
    costs = [StageCost(0.001, 0.002, 0.01 * (s + 1)) for s in range(prog.n_stages)]
    link = Link(bandwidth_bytes_per_s=5e4, latency_s=0.25)
    for trace, lat in ((link.trace(), link.latency_s),
                       (BandwidthTrace.steps([(0.1, 8e4), (0.05, 0.0), (1.0, 3e4)]), 0.0)):
        got = Session(blob, trace, chunk_bytes=997, latency_s=lat,
                      device="cpu").run_timeline(costs, concurrent=concurrent).timeline
        want = progressive_timeline(layout.stage_bytes, link if lat else trace, costs,
                                    concurrent=concurrent, header_bytes=layout.header_bytes)
        assert len(got.download_done) == prog.n_stages
        for a, b in zip(got.download_done + got.result_ready,
                        want.download_done + want.result_ready):
            assert abs(a - b) < TOL_S


@pytest.mark.parametrize("mode", ["fp", "quantized", "speculative"])
def test_run_serving_identical(pair, mode):
    jkw, kw = {}, {}
    if mode == "speculative":
        jkw["speculative"] = JSpecConfig(draft_bits=4, k=2)
        kw["speculative"] = SpecConfig(draft_bits=4, k=2)
    else:
        jkw["resident"] = kw["resident"] = mode
    js, s = _sessions(pair, "browser-lte-handoff", seed=1)
    jr = js.run_serving(pair["jmodel"], pair["jprog"], decode_steps=14,
                        batch={"tokens": jnp.asarray(pair["tokens"])}, **jkw)
    r = s.run_serving(pair["model"], pair["prog"], decode_steps=14,
                      batch={"tokens": pair["tokens"]}, **kw)
    assert r.to_jsonl() == jr.to_jsonl()
    np.testing.assert_array_equal(_np(r.tokens), np.asarray(jr.tokens))
    assert r.upgrades == jr.upgrades and len(r.upgrades) > 1
    assert r.stage_at_step == jr.stage_at_step
    assert r.speculation_summary() == jr.speculation_summary()
    assert r.client.store.fingerprint() == jr.client.store.fingerprint()


@pytest.mark.parametrize("profile", ["browser-3g-lossy", "edge-flaky", "default"])
def test_faulted_runs_identical(pair, profile):
    """Lossy channels: the same faults, retries, repairs and reconnects
    on the byte clock, the same summary, tokens and final store."""
    if profile == "default":
        scenario, seed = "browser-3g", 2
        jfaults = JFaultTrace(seed=seed, p_corrupt=0.01, p_disconnect=0.002)
        faults = FaultTrace(seed=seed, p_corrupt=0.01, p_disconnect=0.002)
    else:
        scenario, seed = profile, 3
        jfaults = jget_scenario(scenario).make_faults(seed)
        faults = get_scenario(scenario).make_faults(seed)
    js, s = _sessions(pair, scenario, integrity=True, seed=seed, chunk_bytes=2048)
    jr = js.run_serving(pair["jmodel"], pair["jprog"], decode_steps=10,
                        batch={"tokens": jnp.asarray(pair["tokens"])}, resident="quantized",
                        faults=jfaults, fault_policy=JFaultPolicy(seed=seed))
    r = s.run_serving(pair["model"], pair["prog"], decode_steps=10,
                      batch={"tokens": pair["tokens"]}, resident="quantized",
                      faults=faults, fault_policy=FaultPolicy(seed=seed))
    assert r.transport == jr.transport
    assert sum(r.transport["injected"].values()) > 0
    assert r.to_jsonl() == jr.to_jsonl()
    np.testing.assert_array_equal(_np(r.tokens), np.asarray(jr.tokens))
    assert r.upgrades == jr.upgrades and r.stage_at_step == jr.stage_at_step
    assert r.client.complete and not r.client.nacks
    assert r.client.store.fingerprint() == jr.client.store.fingerprint()


@pytest.mark.parametrize("speculative", [False, True], ids=["plain", "speculative"])
def test_run_serving_pool_identical(pair, speculative):
    prompts = [np.random.default_rng(10 + i).integers(0, pair["vocab"], 4 + 2 * i)
               .astype(np.int32) for i in range(5)]
    offs = flash_crowd_arrivals(1, 5, span_s=0.05)
    jkw = {"speculative": JSpecConfig(draft_bits=4, k=2)} if speculative else {}
    kw = {"speculative": SpecConfig(draft_bits=4, k=2)} if speculative else {}
    js, s = _sessions(pair, "flash-crowd", seed=2)
    jr = js.run_serving_pool(pair["jmodel"], pair["jprog"],
                             prompts=[jnp.asarray(p) for p in prompts],
                             arrival_offsets_s=offs, max_new_tokens=6, n_slots=3,
                             dispatch_window=2, **jkw)
    r = s.run_serving_pool(pair["model"], pair["prog"], prompts=prompts,
                           arrival_offsets_s=offs, max_new_tokens=6, n_slots=3,
                           dispatch_window=2, **kw)
    assert r.to_jsonl() == jr.to_jsonl()
    assert r.tokens == jr.tokens and sorted(r.tokens) == list(range(5))
    assert r.upgrades == jr.upgrades and len(r.upgrades) > 1
    assert r.admissions == jr.admissions
    assert r.server.stage_log == jr.server.stage_log


def _families(text: str, names) -> str:
    """The Prometheus text of the metric families ``names``."""
    keep = []
    for line in text.splitlines():
        tok = line.split()[2] if line.startswith("#") else re.split(r"[{ ]", line)[0]
        if any(tok == n or tok in (n + "_sum", n + "_count") for n in names):
            keep.append(line)
    return "\n".join(keep)


def test_telemetry_mirror_identical(pair):
    """With both registries on, the session's counters, histograms and
    byte-clock spans export to the same Prometheus text as the
    reference's (whose client and store also report: ROADMAP A11)."""
    js, s = _sessions(pair, "edge-stall", seed=4)
    costs = [(0.0, 0.0, 0.01)] * pair["prog"].n_stages
    with jobs.telemetry(True), obs.telemetry(True):
        js.run_timeline([JStageCost(*c) for c in costs])
        s.run_timeline([StageCost(*c) for c in costs])
        text = to_prometheus(obs.get_registry())
        names = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}
        assert {"session_chunks_total", "session_stage_completions_total"} <= names
        assert text.rstrip("\n") == _families(jto_prometheus(jobs.get_registry()), names)
    assert not obs.enabled()


def test_session_defaults_to_the_card_and_refuses_a_mesh(pair):
    blob = pair["blobs"][False]
    s = Session.from_scenario(blob, get_scenario("pod-coldstart"), device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        s.run_serving(pair["model"], pair["prog"], decode_steps=2,
                      batch={"tokens": pair["tokens"]}, mesh=object())
    with pytest.raises(NotImplementedError, match="A13"):
        s.run_serving_pool(pair["model"], pair["prog"], prompts=[pair["tokens"][0]],
                           mesh=object())
    with pytest.raises(ValueError, match="conflicts"):
        s.run_serving(pair["model"], pair["prog"], decode_steps=2,
                      batch={"tokens": pair["tokens"]}, resident="fp",
                      speculative=SpecConfig())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Session.from_scenario(blob, get_scenario("pod-coldstart"))
