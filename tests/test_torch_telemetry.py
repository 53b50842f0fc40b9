"""The serving telemetry (ROADMAP A11's second half) against the JAX
package's, on the CPU: the port's counterpart of
``tests/test_telemetry_invariant.py``.

Reduced olmo-1b (2 layers, d_model 64), the same weights in both packages
(the JAX init, converted through numpy), over the reference test's four
runs: the single stream (``browser-3g``), the slot pool (three prompts,
two slots), speculation (draft 4 bits, k = 2) and the faulted v3
transport. Held:

* off against on: each run with the registry off and then on gives
  byte-identical event logs and equal tokens, and the enabled run records
  something; the counters equal the run's own records (tokens, upgrades,
  rounds, planes), and ``kernel_launches_total`` equals
  ``ops.LAUNCH_COUNTS`` of the run;
* against the reference: the same run of both packages, both registries
  on, exports the same metric families, and the same Prometheus text
  family by family, but for two kinds: the wall-clock families
  (``engine_ttft_s``, ``engine_upgrade_enqueue_s``,
  ``engine_upgrade_stall_s``, ``span_*_wall_s``), held by name, labels
  and sample count; and ``kernel_launches_total``, which the reference
  counts once a jitted trace and the port once a launch (held to
  ``LAUNCH_COUNTS`` above);
* the launcher's ``--metrics`` file holds the reference launcher's
  families, for the stream and the pool.

The reference's runs and its launcher run in processes of their own
(``test_torch_cnn.Jobs``), started with the module's fixture.
"""
import os
import re
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.core.progressive import divide
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.obs.exporters import parse_prometheus, to_prometheus
from repro_torch.serving.speculative import SpecConfig
from repro_torch.transmission import (BandwidthTrace, FaultPolicy, FaultTrace, Session,
                                      get_scenario)
from test_torch_cnn import Jobs

REDUCED = dict(n_layers=2, d_model=64, d_ff=128, vocab=128, n_heads=2, n_kv=2)
RUNS = ("single", "pool", "spec", "faulted")
WALL = re.compile(r"^(engine_ttft_s|engine_upgrade_enqueue_s|engine_upgrade_stall_s|"
                  r"span_\w+_wall_s)$")
CLI = {"stream": ["--decode-steps", "4"],
       "pool": ["--decode-steps", "4", "--pool-clients", "4", "--pool-slots", "2",
                "--scenario", "flash-crowd"]}
STEPS = 6


def _runs(S, BT, scenario, Spec, FP, FT, wire_mod, model, prog, tokens, prompts, **kw):
    """The reference test's four runs, for either package (``kw``: the
    port's device)."""
    blob, blob3 = wire_mod.encode(prog), wire_mod.encode(prog, integrity=True)
    batch = {"tokens": tokens}
    faults = dict(seed=8, p_corrupt=0.06, p_truncate=0.04, p_duplicate=0.04,
                  p_disconnect=0.04)
    return {
        "single": lambda: S.from_scenario(blob, scenario("browser-3g"), seed=3, **kw)
        .run_serving(model, prog, decode_steps=STEPS, batch=batch),
        "pool": lambda: S(blob, BT.constant(100e3), chunk_bytes=4096, **kw)
        .run_serving_pool(model, prog, prompts=prompts, max_new_tokens=4, n_slots=2,
                          dispatch_window=2),
        "spec": lambda: S.from_scenario(blob, scenario("browser-3g"), seed=0, **kw)
        .run_serving(model, prog, decode_steps=STEPS, batch=batch,
                     speculative=Spec(draft_bits=4, k=2)),
        "faulted": lambda: S(blob3, BT.constant(1e6), chunk_bytes=1024, latency_s=0.01, **kw)
        .run_serving(model, prog, decode_steps=STEPS, batch=batch, faults=FT(**faults),
                     fault_policy=FP(seed=1)),
    }


# The reference side: "runs" runs the four runs with its registry on and
# writes each run's Prometheus text and event log; "cli_<mode>" is its
# launcher with --metrics.
_REFERENCE = """
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro import obs
    from repro.configs import get_config
    from repro.core import wire
    from repro.core.progressive import divide
    from repro.models.model import build_model
    from repro.obs.exporters import to_prometheus
    from repro.serving.speculative import SpecConfig
    from repro.transmission import BandwidthTrace, Session, get_scenario
    from repro.transmission.session import FaultPolicy
    from repro.transmission.simulator import FaultTrace
    sys.path.insert(0, sys.argv[3])
    from test_torch_telemetry import REDUCED, RUNS, _runs

    inp, out_path = sys.argv[1:3]
    arrays = np.load(inp)
    model = build_model(get_config("olmo-1b").reduced(**REDUCED))
    prog = divide(model.init(jax.random.PRNGKey(0)))
    prompts = [jnp.asarray(arrays[f"prompt{i}"]) for i in range(3)]
    runs = _runs(Session, BandwidthTrace, get_scenario, SpecConfig, FaultPolicy, FaultTrace,
                 wire, model, prog, jnp.asarray(arrays["tokens"]), prompts)
    out = {}
    for name in RUNS:
        with obs.telemetry(True):
            res = runs[name]()
            out[f"{name}/prom"] = np.array(to_prometheus(obs.get_registry()))
        out[f"{name}/jsonl"] = np.array(res.to_jsonl())
    np.savez(out_path, **out)
"""


def _inputs():
    rng = np.random.default_rng(1)
    return {"tokens": rng.integers(0, REDUCED["vocab"], (2, 8)).astype(np.int32),
            **{f"prompt{i}": np.random.default_rng(20 + i).integers(
                0, REDUCED["vocab"], (6,)).astype(np.int32) for i in range(3)}}


class Reference(Jobs):
    """The "runs" job (``ref["runs"]``: its arrays) and the launcher's
    (``ref["cli_<mode>"]``: its Prometheus text)."""

    def __init__(self, tmp):
        np.savez(tmp / "in.npz", **_inputs())
        cmds = {"runs": [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(tmp / "in.npz"),
                         str(tmp / "runs.npz"), os.path.dirname(os.path.abspath(__file__))]}
        for mode, flags in CLI.items():
            cmds[f"cli_{mode}"] = [sys.executable, "-m", "repro.launch.serve", "--arch",
                                   "olmo-1b", "--reduced", *flags, "--metrics",
                                   str(tmp / f"cli_{mode}.prom")]
        super().__init__(tmp, cmds)

    def __getitem__(self, job: str):
        if job == "runs":
            return self.read(job, lambda tmp: dict(np.load(tmp / "runs.npz")))
        return self.read(job, lambda tmp: (tmp / f"{job}.prom").read_text())


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    r = Reference(tmp_path_factory.mktemp("telemetry_reference"))
    yield r
    r.close()


@pytest.fixture(autouse=True)
def _telemetry_off_between_tests():
    yield
    obs.configure(False)
    obs.reset()


@pytest.fixture(scope="module")
def port(ref):
    """The port's four runs, each with the registry off and then on: the
    results, the enabled run's Prometheus text and its ``LAUNCH_COUNTS``."""
    jmodel = jax_build_model(jax_get_config("olmo-1b").reduced(**REDUCED))
    params = params_from_numpy(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
                               device="cpu")
    model = build_model(get_config("olmo-1b").reduced(**REDUCED))
    inputs = _inputs()
    runs = _runs(Session, BandwidthTrace, get_scenario, SpecConfig, FaultPolicy, FaultTrace,
                 wire, model, divide(params), inputs["tokens"],
                 [inputs[f"prompt{i}"] for i in range(3)], device="cpu")
    out = {}
    for name in RUNS:
        with obs.telemetry(False):
            off = runs[name]()
            assert len(obs.get_registry()) == 0
        ops.reset_launch_counts()
        with obs.telemetry(True):
            on = runs[name]()
            out[name] = {"off": off, "on": on, "prom": to_prometheus(obs.get_registry()),
                         "launches": dict(ops.LAUNCH_COUNTS),
                         "values": _values(obs.get_registry())}
    return out


def _values(reg) -> dict:
    """Counter and gauge values and histogram counts, by family and labels."""
    out = {}
    for m in reg.collect():
        for labels, v in m.samples():
            out[(m.name, labels)] = len(v) if isinstance(v, (list, tuple)) else v
    return out


def _families(text: str) -> dict:
    """Prometheus text split into families: name -> its lines."""
    fams: dict[str, list[str]] = {}
    name = None
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name = line.split()[2]
            fams[name] = []
        fams[name].append(line)
    return fams


def _shape(lines: list[str]) -> list[str]:
    """A wall-clock family without its values: its HELP and TYPE lines, each
    sample's name and labels, and its sample counts."""
    return [line if line.startswith("#") or re.split(r"[{ ]", line)[0].endswith("_count")
            else line.rsplit(" ", 1)[0] for line in lines]


def _tokens(res) -> list:
    t = res.tokens
    return sorted(t.items()) if isinstance(t, dict) else np.asarray(t).tolist()


@pytest.mark.parametrize("name", RUNS)
def test_off_and_on_identical(port, name):
    r = port[name]
    assert r["off"].to_jsonl() == r["on"].to_jsonl()
    assert _tokens(r["off"]) == _tokens(r["on"])
    assert r["off"].upgrades == r["on"].upgrades
    if name == "spec":
        assert r["off"].speculation_summary() == r["on"].speculation_summary()
    if name == "faulted":
        assert r["off"].transport == r["on"].transport
    assert r["prom"]


@pytest.mark.parametrize("name", RUNS)
def test_counters_equal_the_runs_records(port, name):
    r = port[name]
    res, vals = r["on"], r["values"]

    def total(family, **labels):
        want = {(str(k), str(v)) for k, v in labels.items()}
        return sum(v for (f, ls), v in vals.items() if f == family and want <= set(ls))

    kernels = {ls[0][1]: v for (f, ls), v in vals.items() if f == "kernel_launches_total"}
    assert kernels == r["launches"]
    # one OR round a completed stage: a container dtype, no stage split
    assert kernels["plane_or_segments"] == total("store_or_rounds_total") == \
        res.client.stages_complete
    assert total("client_planes_ored_total") == sum(res.client.store.received) > 0
    assert total("client_bytes_fed_total") == sum(
        e.data["bytes"] for e in res.events_of("chunk"))
    assert total("store_or_rounds_total") == vals[("store_or_round_planes", ())]
    assert vals[("store_resident_bytes", ())] == res.client.store.resident_bytes()
    if name == "pool":
        engine = ("engine", "SlotPoolEngine")
        assert total("engine_tokens_total", engine=engine[1]) == sum(
            len(v) for v in res.tokens.values())
        assert total("engine_upgrades_total") == len(res.server.upgrade_log) > 0
        assert vals[("engine_window_steps", (engine,))] == len(res.server.window_stats)
        assert vals[("engine_ttft_s", (engine,))] == len(res.tokens)
    elif name == "spec":
        s = res.speculation_summary()
        assert total("spec_rounds_total") == s["rounds"] > 0
        assert total("engine_tokens_total", engine="SpeculativeEngine") == \
            np.asarray(res.tokens).size
    else:
        # the single stream counts a lock-stepped step once, whatever the
        # batch (the reference's count; speculation counts steps x batch)
        assert total("engine_tokens_total", engine="single") == len(res.stage_at_step) == STEPS
        # an ingest span an upgrade, and one for the first stage
        assert total("span_upgrade_ingest_wall_s") == len(res.upgrades) + 1
    if name == "faulted":
        t = res.transport
        assert total("client_quarantined_total") == t["quarantined"] > 0
        assert total("client_repairs_total", ok=True) == t["repaired_units"]


@pytest.mark.parametrize("name", RUNS)
def test_prometheus_equals_reference(ref, port, name):
    want, got = _families(ref["runs"][f"{name}/prom"].item()), _families(port[name]["prom"])
    assert sorted(got) == sorted(want)
    assert "kernel_launches_total" in got and "client_planes_ored_total" in got
    for family in sorted(want):
        if family == "kernel_launches_total":
            continue   # once a trace there, once a launch here (held to LAUNCH_COUNTS)
        if WALL.match(family):
            assert _shape(got[family]) == _shape(want[family]), family
        else:
            assert got[family] == want[family], family
    assert port[name]["on"].to_jsonl() == ref["runs"][f"{name}/jsonl"].item()


@pytest.mark.parametrize("mode", sorted(CLI))
def test_cli_metrics_families_equal_reference(ref, mode, tmp_path, capsys):
    obs.reset()
    prom = tmp_path / "serve.prom"
    serve.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu", *CLI[mode],
                "--metrics", str(prom)])
    assert "served" in capsys.readouterr().out
    got, want = parse_prometheus(prom.read_text()), parse_prometheus(ref[f"cli_{mode}"])
    assert sorted(got) == sorted(want)
    assert {"engine_tokens_total", "client_bytes_fed_total", "store_or_rounds_total",
            "kernel_launches_total", "span_decode_window_wall_s"} <= set(got)
