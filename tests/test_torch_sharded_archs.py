"""Sharded serving of the mixture-of-experts, dense-variant and windowed
archs in the port against the JAX package, on the CPU.

mixtral-8x22b reduced to 3 layers (4 experts, top-2, drop-free cf 4.0,
window 16; 3 layers, not 4, so that the expert policy slices the expert
axis and not the layer axis), starcoder2-15b reduced to 2 layers (affine
LayerNorm with 1-D biases, an untied ``lm_head``, G = 12) and gemma3-27b
reduced to one 5:1 cycle (6 layers: 5 windowed rings of 16 slots,
``qk_norm``, a tied ``embed``), d_model 64 (96 for starcoder2), d_ff 128,
vocab 256, float32, the same numpy-made weights in both packages. Meshes
of ``["cpu"] * n`` logical shards.

The reference's sharded store runs in ONE subprocess with eight forced
host devices (as in ``tests/test_torch_sharded.py``). mixtral is divided
twice there and here: under ``ExpertPopularityPolicy`` (each bank in 4
slices: the expert route at n = 2 and 4, the whole route at n = 3) and
under the default policy (unsliced banks, split on their expert dim).
Held exactly, at n = 2, 3 and 4 under both policies, for the v3 bytes fed
in ragged chunks to ``ProgressiveClient(mesh=)``: routes, placement,
per-shard fingerprints after every stage, every ``acc(i)``, and every
float and quantized leaf gathered (a sliced bank's per-expert ``scale``,
``offset`` and ``received_bits`` through ``ShardedLeaf.gather``).

The reference's sharded engines do not run on the installed JAX, so
serving is held against its single-device ``Session.run_serving``
(quantized): the port's sharded sessions at n = 2 for the three archs,
and for mixtral at n = 4 and under both policies, give the same tokens
and per-step stages. The port's sharded pool, ``SpeculativeEngine`` and
float-resident server (mixtral; the pool and speculation over gemma3's
rings too) give the tokens of its own single-device engines, which
``tests/test_torch_moe.py`` and ``tests/test_torch_sliding_window.py``
hold against the reference; quantized logits within B2's CPU tolerance
(rtol 2e-5, atol 2e-4, as ``tests/test_torch_kernels.py``).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.core.plane_store import PlaneStore, ShardedLeaf, ShardedPlaneStore
from repro_torch.core.policy import ExpertPopularityPolicy
from repro_torch.core.progressive import ReceiverState, divide, tree_flatten_with_path
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.model import build_model
from repro_torch.serving import (PoolRequest, ProgressiveServer, SlotPoolEngine, SpecConfig,
                                 SpeculativeEngine, SpeculativeSlotPool)
from repro_torch.transmission import ProgressiveClient, Session, get_scenario

MIXTRAL, STARCODER, GEMMA = "mixtral-8x22b", "starcoder2-15b", "gemma3-27b"
REDUCED = {MIXTRAL: dict(n_layers=3, d_model=64, d_ff=128, vocab=256),
           STARCODER: dict(n_layers=2, d_model=96, n_heads=12, n_kv=1, d_ff=128, vocab=256),
           GEMMA: dict(d_model=64, d_ff=128, vocab=256)}
POPULARITY = {2: 0.6, 0: 0.3, 3: 0.1}
POLICIES = ("expert", "default")
SHARDS = (2, 3, 4)
N_CUTS = 12
STEPS = 14
# B2 on the CPU: a shard's columns summed apart from the others
RTOL, ATOL = 2e-5, 2e-4
TOKENS = np.random.default_rng(1).integers(0, 256, (2, 8)).astype(np.int32)

# The reference side, one process a job, all started together: "expert"
# and "default" divide mixtral under that policy and feed its v3 bytes to
# the sharded client at n = 2, 3 and 4; an arch's name runs its
# single-device quantized session (mixtral's under the expert policy).
_REFERENCE = """
    import json, os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               "--xla_cpu_multi_thread_eigen=false")
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import wire
    from repro.core.policy import ExpertPopularityPolicy
    from repro.core.progressive import divide
    from repro.launch.mesh import make_serving_mesh
    from repro.models.model import build_model
    from repro.transmission import ProgressiveClient, Session, get_scenario

    inp, job = np.load(sys.argv[1]), sys.argv[3]
    mix = "mixtral-8x22b"
    name = mix if job in ("expert", "default") else job
    model = build_model(get_config(name).reduced(**json.loads(str(inp["reduced"]))[name]))
    params = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(inp[f"{name}/param/" + wire.path_str(p)]),
        jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    out = {}
    if job == "expert":
        blob = inp["expert/blob"].tobytes()   # the port's: the mixtral job holds its bytes
    else:
        pop = {int(k): v for k, v in json.loads(str(inp["popularity"])).items()}
        prog = divide(params, ExpertPopularityPolicy(popularity=pop,
                                                     n_experts=model.cfg.n_experts)
                      if job == mix else None)
        blob = wire.encode(prog, integrity=True)
        out[f"{job}/blob"] = np.frombuffer(blob, np.uint8)
    if job in ("expert", "default"):
        ends = {int(e) for e in inp[f"{job}/ends"]}
        for n in (2, 3, 4):
            client, prev, fps = ProgressiveClient(mesh=make_serving_mesh(n)), 0, {}
            for c in [int(c) for c in inp[f"{job}/cuts"]]:
                client.feed(blob[prev:c])
                prev = c
                if c in ends:
                    fps[client.stages_complete] = client.store.fingerprint()
            st = client.store
            tag = f"{job}/{n}"
            out[f"{tag}/fps"] = np.asarray(json.dumps(fps))
            out[f"{tag}/placement"] = np.asarray(json.dumps(st._placement))
            out[f"{tag}/route"] = np.asarray(json.dumps(st._route))
            for i in range(st.n_tensors):
                out[f"{tag}/acc/{i}"] = np.asarray(st.acc(i))
            for k, v in st.materialize_leaves().items():
                out[f"{tag}/fp/{k}"] = np.asarray(v)
            for k, v in st.quantized_leaves().items():
                for f in ("q", "scale", "offset", "received_bits"):
                    out[f"{tag}/q/{k}/{f}"] = np.asarray(getattr(v, f, v))
    else:
        res = Session.from_scenario(blob, get_scenario("browser-lte-handoff"), seed=1
                                    ).run_serving(model, prog, decode_steps=int(inp["steps"]),
                                                  batch={"tokens": jnp.asarray(inp["tokens"])},
                                                  resident="quantized")
        out[f"serve/{job}/tokens"] = np.asarray(res.tokens)
        out[f"serve/{job}/stages"] = np.asarray(res.stage_at_step)
    np.savez(sys.argv[2], **out)
"""
JOBS = ("expert", "default", MIXTRAL, STARCODER, GEMMA)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(model, seed) -> dict:
    """numpy weights in the tree layout of ``model.init``: matrices and
    banks at the init's scale, norm scales around 1, biases around 0."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path, t in tree_flatten_with_path(model.init(torch.Generator(), device="meta")):
        shape = tuple(t.shape)
        if path[-1] == "scale":
            a = 1.0 + 0.2 * rng.standard_normal(shape)
        elif path[-1] == "bias":
            a = 0.1 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) * (0.02 if path == ("embed",) else
                                              (2.0 / (shape[-2] + shape[-1])) ** 0.5)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a.astype(np.float32)
    return out


def _stage_ends(blob) -> list[int]:
    meta, hdr = wire.decode_header(blob)
    return np.cumsum([hdr] + wire.layout_from_header(meta, hdr).stage_bytes).tolist()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's models, and its programs and blobs by division (mixtral
    under each policy, the other archs by name); the reference's
    processes, started here and read by :func:`_reference`."""
    tmp = tmp_path_factory.mktemp("sharded_archs")
    inp = {"reduced": json.dumps(REDUCED), "popularity": json.dumps(POPULARITY),
           "steps": STEPS, "tokens": TOKENS}
    models, params = {}, {}
    for seed, (name, over) in enumerate(REDUCED.items()):
        models[name] = build_model(get_config(name).reduced(**over))
        weights = _weights(models[name], seed)
        params[name] = params_from_numpy(weights, device="cpu")
        for path, leaf in tree_flatten_with_path(weights):
            inp[f"{name}/param/" + wire.path_str(path)] = leaf
    progs = {"expert": divide(params[MIXTRAL], ExpertPopularityPolicy(
                 popularity=POPULARITY, n_experts=models[MIXTRAL].cfg.n_experts)),
             "default": divide(params[MIXTRAL])}
    progs.update({name: divide(params[name]) for name in (STARCODER, GEMMA)})
    blobs = {k: wire.encode(p, integrity=True) for k, p in progs.items()}
    rng = np.random.default_rng(5)
    cuts = {}
    for pol in POLICIES:
        ends = _stage_ends(blobs[pol])
        ragged = rng.choice(np.arange(1, len(blobs[pol])), N_CUTS, replace=False)
        cuts[pol] = sorted(set(ragged.tolist()) | set(ends[1:]))
        inp[f"{pol}/cuts"], inp[f"{pol}/ends"] = np.asarray(cuts[pol]), np.asarray(ends[1:])
    inp["expert/blob"] = np.frombuffer(blobs["expert"], np.uint8)
    np.savez(tmp / "in.npz", **inp)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for job in JOBS:
        with open(tmp / f"{job}.err", "w") as err:
            procs[job] = subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(tmp / "in.npz"),
                 str(tmp / f"{job}.npz"), job], stdout=subprocess.DEVNULL, stderr=err, env=env)
    world = {"models": models, "progs": progs, "blobs": blobs, "cuts": cuts, "tmp": tmp,
             "procs": procs, "out": None}
    yield world
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _reference(world) -> dict:
    """The reference's results, all jobs' in one dict: waits for its
    processes the first time."""
    if world["out"] is None:
        out = {}
        for job, proc in world["procs"].items():
            rc = proc.wait(timeout=240)
            assert rc == 0, (world["tmp"] / f"{job}.err").read_text()[-3000:]
            out.update(np.load(world["tmp"] / f"{job}.npz"))
        for job in JOBS[1:]:   # the same bytes
            assert out[f"{job}/blob"].tobytes() == world["blobs"][_division(job)], job
        world["out"] = out
    return world["out"]


def _division(job: str) -> str:
    """The division a reference job or an arch's session serves: mixtral's
    under the expert policy."""
    return "expert" if job == MIXTRAL else job


def _mesh(n: int):
    return make_serving_mesh(n, devices=["cpu"] * n)


def _gathered(leaf):
    return leaf.gather() if isinstance(leaf, ShardedLeaf) else leaf


def _json(arr) -> object:
    return json.loads(str(arr))


# ---------------------------------------------------------------------------
# the port against itself (while the reference's processes run)
# ---------------------------------------------------------------------------

def _pool(model, prog, mesh, speculative=False):
    rng = np.random.default_rng(4)
    kw = dict(n_slots=3, max_len=64, dispatch_window=4, prefill_chunk=8, mesh=mesh, device="cpu")
    pool = (SpeculativeSlotPool(model, prog, spec=SpecConfig(draft_bits=4, k=3), **kw)
            if speculative else SlotPoolEngine(model, prog, resident="quantized", **kw))
    pool.receive_stage()
    for rid, length in enumerate([12, 26, 9, 20]):
        pool.submit(PoolRequest(rid=rid, prompt=rng.integers(0, 256, length),
                                max_new_tokens=int(rng.integers(10, 16))))
    return pool, pool.run(on_window=lambda _: pool.upgrade_if_available())


@pytest.mark.parametrize("arch", [MIXTRAL, GEMMA])
def test_sharded_engines_equal_single_device(world, arch):
    """At n = 2: the pool (an upgrade a window, over rings with the chunk
    as ``ring_margin`` for gemma3), the speculative pool and
    ``SpeculativeEngine`` at stage 8 (rings grown by k_max + 1) give the
    single-device engines' tokens, with zero extra draft bytes and the
    same quantized bytes; for mixtral also the server in both
    residencies, its tokens equal and its last logits within B2's CPU
    tolerance."""
    model = world["models"][arch]
    prog = world["progs"]["expert" if arch == MIXTRAL else arch]
    runs = {}
    for mesh in (None, _mesh(2)):
        pool, out = _pool(model, prog, mesh)
        _, spec_out = _pool(model, prog, mesh, speculative=True)
        spec = SpeculativeEngine(model, prog, max_len=8 + STEPS + 5,
                                 spec=SpecConfig(draft_bits=4, k=4, k_max=4), mesh=mesh,
                                 device="cpu")
        for _ in range(prog.n_stages):
            spec.receive_stage()
        spec.start({"tokens": TOKENS})
        runs[mesh is None] = (out, pool.stage_log, spec.decode(STEPS).tokens,
                              spec.resident_report(), spec_out)
    (one, one_log, one_spec, one_rep, one_sp), (two, two_log, two_spec, two_rep, two_sp) = \
        runs[True], runs[False]
    assert two == one and two_log == one_log and len(one) == 4
    assert two_sp == one_sp and len(one_sp) == 4
    assert torch.equal(two_spec, one_spec)
    assert two_rep["extra_draft_bytes"] == 0
    assert two_rep["quantized_bytes"] == one_rep["quantized_bytes"]
    if arch != MIXTRAL:
        return
    for resident in ("quantized", "fp"):
        srv = {}
        for mesh in (None, _mesh(2)):
            s = ProgressiveServer(model, prog, max_len=8 + STEPS, resident=resident, mesh=mesh,
                                  device="cpu")
            s.receive_stage()
            s.start({"tokens": TOKENS})
            srv[mesh is None] = (s.decode(STEPS, stage_arrival=lambda i: i % 2 == 1).tokens,
                                 s.last_logits)
        assert torch.equal(srv[False][0], srv[True][0]), resident
        torch.testing.assert_close(srv[False][1], srv[True][1], rtol=RTOL, atol=ATOL)


def _session(world, division: str, mesh):
    arch = MIXTRAL if division in POLICIES else division
    return Session.from_scenario(world["blobs"][division], get_scenario("browser-lte-handoff"),
                                 seed=1, device="cpu").run_serving(
        world["models"][arch], world["progs"][division], decode_steps=STEPS,
        batch={"tokens": TOKENS}, resident="quantized", mesh=mesh)


@pytest.mark.parametrize("n", [2, 4])
def test_default_policy_session_equals_single_device(world, n):
    """mixtral divided by the default policy: its unsliced banks split on
    their expert dim; the sharded session's tokens and stages equal the
    single-device session's (the expert policy's are held against the
    reference below)."""
    one, r = _session(world, "default", None), _session(world, "default", _mesh(n))
    assert torch.equal(r.tokens, one.tokens) and r.stage_at_step == one.stage_at_step
    bank = r.server.params["decoder"]["cycles"]["0_swa_moe"]["moe"]["we_up"]
    assert isinstance(bank, ShardedLeaf) and bank.axis == -3 and len(bank.parts) == n
    assert r.client.store._route["decoder/cycles/0_swa_moe/moe/we_up"] == ("split", 1)


@pytest.mark.parametrize("n", [2, 4])
def test_sliced_bank_gathers_per_expert_constants(n):
    """``ShardedLeaf.gather`` of a bank sliced per expert: every eq.-(5)
    field, the truncated view's mask and offset included, and the float
    leaf equal the single-device store's, mid-stream (experts at other
    received bits) and at the last stage; each part's experts keep
    their own ranges (part 0's affine for the whole bank was wrong)."""
    E = 4
    bank = (np.random.default_rng(3).standard_normal((E, 8, 16))
            * np.arange(1, E + 1)[:, None, None]).astype(np.float32)
    prog = divide({"we_up": torch.from_numpy(bank)},
                  ExpertPopularityPolicy(popularity=POPULARITY, n_experts=E))
    one = PlaneStore.from_model(prog, device="cpu")
    sharded = ShardedPlaneStore.from_model(prog, _mesh(n))
    assert sharded._route == {("we_up",): ("expert", 0)}

    def held(mid_stream: bool) -> None:
        for bits in (4, None):
            want = one.quantized_leaves(bits=bits)[("we_up",)]
            leaf = sharded.quantized_leaves(bits=bits)[("we_up",)]
            assert isinstance(leaf, ShardedLeaf) and len(leaf.parts) == n
            got = leaf.gather()
            for f in ("q", "lo", "hi", "scale", "offset", "received_bits", "keep_bits"):
                w, g = getattr(want, f), getattr(got, f)
                assert (w is None) == (g is None) and (w is None or torch.equal(w, g)), f
        assert len(set(got.scale.flatten().tolist())) == E
        assert len(set(got.received_bits.flatten().tolist())) == (2 if mid_stream else 1)
        assert torch.equal(sharded.materialize_leaves()[("we_up",)].gather(),
                           one.materialize_leaves()[("we_up",)])

    for s in range(1, prog.n_stages + 1):
        items = prog.stage(s)
        cut = 2 if s == 3 else len(items)      # two experts a plane ahead
        for first, part in ((True, items[:cut]), (False, items[cut:])):
            if part:
                one.ingest(part)
                sharded.ingest(part)
            if s == 3 and first:
                held(mid_stream=True)
    held(mid_stream=False)


def test_layer_axis_sliced_bank_on_a_mesh():
    """dbrx reduced to 2 experts at its 2 layers: the expert policy slices
    the layer axis (depth equal to n_experts, as the reference does), the
    expert route puts a layer on each shard, and the prefill on the mesh
    gives the single-device logits."""
    cfg = get_config("dbrx-132b").reduced(n_experts=2, d_model=64, d_ff=128, vocab=256)
    model = build_model(cfg)
    params = params_from_numpy(_weights(model, 7), device="cpu")
    prog = divide(params, ExpertPopularityPolicy(n_experts=2))
    assert {t.slice_axis for t in prog.tensors if t.slice_axis is not None} == {0}
    batch = {"tokens": torch.from_numpy(TOKENS)}
    logits = {}
    for n in (None, 2):
        st = ReceiverState.init(prog, mesh=None if n is None else _mesh(n), device="cpu")
        for s in range(1, prog.n_stages + 1):
            st = st.receive(prog.stage(s))
        leaves = st.materialize_resident()
        if n:
            bank = leaves["decoder"]["cycles"]["0_moe"]["moe"]["we_gate"]
            assert isinstance(bank, ShardedLeaf) and bank.axis == -4
        logits[n], _ = model.prefill(leaves, batch)
    torch.testing.assert_close(logits[2], logits[None], rtol=RTOL, atol=ATOL)


def test_cli_mesh_shards_moe(capsys):
    base = ["--arch", MIXTRAL, "--reduced", "--device", "cpu", "--decode-steps", "6",
            "--resident", "quantized"]
    serve.main(base)
    plain = capsys.readouterr().out
    serve.main(base + ["--mesh-shards", "2"])
    sharded = capsys.readouterr().out
    assert "serving mesh: 2 model shards" in sharded

    def tokens(text):
        return [line for line in text.splitlines() if line.startswith(("tokens[0]",
                                                                       "stage per step"))]
    assert tokens(sharded) == tokens(plain) and len(tokens(plain)) == 2


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n", SHARDS)
def test_store_matches_reference(world, policy, n):
    """Routes, placement, fingerprints after every stage, accumulators and
    every leaf gathered, exactly; one ``plane_or_segments`` launch a
    sub-store a stage."""
    blob, out, tag = world["blobs"][policy], _reference(world), f"{policy}/{n}"
    ends = set(_stage_ends(blob)[1:])
    client = ProgressiveClient(mesh=_mesh(n), device="cpu")
    ops.reset_launch_counts()
    prev, fps = 0, {}
    for c in world["cuts"][policy]:
        client.feed(blob[prev:c])
        prev = c
        if c in ends:
            fps[str(client.stages_complete)] = client.store.fingerprint()
    st = client.store
    assert isinstance(st, ShardedPlaneStore) and len(fps) == 8
    assert fps == _json(out[f"{tag}/fps"])
    routes = {k: list(v) for k, v in st._route.items()}
    assert routes == _json(out[f"{tag}/route"])
    banks = [k for k in routes if "/we_" in k]
    kinds = {routes[k][0] for k in banks}
    # 4 experts and the reduced widths are indivisible by 3: whole
    assert kinds == {"whole" if n == 3 else "split" if policy == "default" else "expert"}
    assert [[list(p) for p in st.placement(i)] for i in range(st.n_tensors)] == \
        _json(out[f"{tag}/placement"])
    assert ops.LAUNCH_COUNTS["plane_or_segments"] == 8 * n
    for i in range(st.n_tensors):
        np.testing.assert_array_equal(st.acc(i).numpy(), out[f"{tag}/acc/{i}"])
    for k, v in st.materialize_leaves().items():
        np.testing.assert_array_equal(_gathered(v).numpy(), out[f"{tag}/fp/{k}"], err_msg=k)
    for k, v in st.quantized_leaves().items():
        v = _gathered(v)
        for f in ("q", "scale", "offset", "received_bits"):
            np.testing.assert_array_equal(getattr(v, f, v).numpy(), out[f"{tag}/q/{k}/{f}"],
                                          err_msg=f"{k} {f}")
    if policy == "expert" and n != 3:
        # a bank's part: its experts' slots, one strided view of the shard's
        # buffer each, with their own ranges
        bank = st.quantized_leaves()[banks[0]]
        assert isinstance(bank, ShardedLeaf) and bank.axis == -3
        for sub, part in zip(st.substores, bank.parts):
            assert part.q.shape[-3] == 4 // n and part.scale.shape[-3] == 4 // n
            assert part.q.untyped_storage().data_ptr() == \
                sub.buffers["uint16"].untyped_storage().data_ptr()
        assert len(set(bank.gather().scale.flatten().tolist())) == 4   # a range an expert


@pytest.mark.parametrize("arch,n", [(MIXTRAL, 2), (MIXTRAL, 4), (STARCODER, 2), (GEMMA, 2)])
def test_sharded_session_matches_reference_single_device(world, arch, n):
    """The quantized byte-clock session on the mesh: tokens and per-step
    stages equal the reference's single-device run (mixtral under the
    expert policy, starcoder2-15b, gemma3-27b); resident quantized bytes
    equal one device's."""
    out = _reference(world)
    ops.reset_launch_counts()
    r = _session(world, _division(arch), _mesh(n))
    np.testing.assert_array_equal(r.tokens.numpy(), out[f"serve/{arch}/tokens"])
    assert r.stage_at_step == out[f"serve/{arch}/stages"].tolist()
    assert len(set(r.stage_at_step)) > 1
    assert ops.LAUNCH_COUNTS["sharded_dequant_matmul"] > 0
    one = _session(world, _division(arch), None)
    assert r.server.resident_report()["quantized_bytes"] == \
        one.server.resident_report()["quantized_bytes"]
