"""Sharded serving in the port against the JAX package, on the CPU.

Reduced olmo-1b (2 layers, d_model 64, d_ff 128, vocab 128, 2 heads) and
a small tree with a 1-D, a scalar and an indivisible leaf (the whole
route), the same weights in both packages (made here with numpy). Meshes
of ``["cpu"] * n`` logical shards, n = 2 and 4: the counterpart of the
reference's forced host devices.

The reference's sharded objects run in ONE subprocess with eight forced
host devices (the pytest worker's JAX already holds one device), which
writes everything the tests compare to an ``.npz``. Its sharded engines
do not run on the installed JAX (``pallas_call`` under a mesh, a sharded
contraction in ``_unembed``), so the serving half is held against its
single-device engines, the reference's own criterion
(``tests/test_sharded_serving.py``: a sharded server is token-identical
to one device at every stage). Held:

* ``serving_spec_for_param`` equal to the reference's for every leaf,
  ``embed`` on d_model included;
* the v3 blob fed in the same ragged chunks to ``ProgressiveClient(mesh=)``:
  per-shard fingerprints (``shard{j}/{dtype}`` CRCs) after every stage,
  placement, ``acc(i)`` and the quantized and float leaves gathered,
  exactly; one ``plane_or_segments`` launch a sub-store a stage;
* ``ops.sharded_dequant_matmul`` against the reference's on
  ``make_serving_mesh(4)`` within B2's CPU tolerance (rtol 2e-5, atol
  2e-4, as ``tests/test_torch_kernels.py``); the GEMV route's emulation
  of a shard with ``n_split`` equal to the unsharded columns bit for bit;
* sharded ``Session.run_serving`` (float, quantized, speculative) and
  ``run_serving_pool``: tokens and per-step stages equal to the
  reference's single-device runs; the CLI with ``--mesh-shards 2
  --device cpu`` equal to the unsharded CLI.
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
from repro_torch.core.plane_store import ShardedLeaf, ShardedPlaneStore, _path
from repro_torch.core.progressive import ReceiverState, divide, tree_flatten_with_path
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dequant_matmul, ops, ref
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.launch.sharding import gathered_for_serving, serving_spec_for_param
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ProgressiveServer
from repro_torch.serving.speculative import SpecConfig
from repro_torch.transmission import (ProgressiveClient, Session, flash_crowd_arrivals,
                                      get_scenario)

REDUCED = dict(n_layers=2, d_model=64, d_ff=128, vocab=128, n_heads=2, n_kv=2)
SHARDS = (2, 4)
N_CUTS = 12
DECODE_STEPS = 14

# The reference side: its sharded store, kernel and spec rule on real
# meshes of forced host devices, and its single-device sessions.
_REFERENCE = """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import wire
    from repro.core.progressive import divide
    from repro.kernels import ops
    from repro.launch.mesh import make_serving_mesh
    from repro.launch.sharding import serving_spec_for_param
    from repro.models.model import build_model
    from repro.serving.speculative import SpecConfig
    from repro.transmission import ProgressiveClient, Session, get_scenario

    inp = np.load(sys.argv[1])
    out = {}
    cfg = get_config("olmo-1b").reduced(**json.loads(str(inp["reduced"])))
    model = build_model(cfg)

    def tree_from(prefix, skeleton):
        def fill(path, leaf):
            return jnp.asarray(inp[prefix + wire.path_str(path)])
        return jax.tree_util.tree_map_with_path(fill, skeleton)

    params = tree_from("param/", jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    small = {k[6:]: jnp.asarray(inp[k]) for k in inp.files if k.startswith("small/")}
    progs = {"olmo": divide(params), "small": divide(small)}
    for name, prog in progs.items():
        blob = wire.encode(prog, integrity=True)
        out[f"{name}/blob"] = np.frombuffer(blob, np.uint8)
        cuts = [int(c) for c in inp[f"{name}/cuts"]] + [len(blob)]
        meta, _ = wire.decode_header(blob)
        for n in (2, 4):
            mesh = make_serving_mesh(n)
            out[f"{name}/spec{n}"] = np.asarray(json.dumps(
                [list(serving_spec_for_param(t["path"], tuple(t["shape"]), mesh))
                 for t in meta["tensors"]]))
            client, prev, fps = ProgressiveClient(mesh=mesh), 0, {}
            for c in cuts:
                client.feed(blob[prev:c])
                prev = c
                if client.store is not None:
                    fps.setdefault(client.stages_complete, client.store.fingerprint())
            st = client.store
            out[f"{name}/fps{n}"] = np.asarray(json.dumps(fps))
            out[f"{name}/placement{n}"] = np.asarray(json.dumps(st._placement))
            for i in range(st.n_tensors):
                out[f"{name}/acc{n}/{i}"] = np.asarray(st.acc(i))
            for k, v in st.materialize_leaves().items():
                out[f"{name}/fp{n}/{k}"] = np.asarray(v)
            for k, v in st.quantized_leaves().items():
                out[f"{name}/q{n}/{k}"] = np.asarray(getattr(v, "q", v))

    mesh4 = make_serving_mesh(4)
    for M in (1, 8):
        x, q = inp[f"sdqm/{M}/x"], inp[f"sdqm/{M}/q"]
        sc, of = (jnp.asarray(inp[f"sdqm/{k}"]).reshape(1, 1) for k in ("scale", "offset"))
        out[f"sdqm/{M}"] = np.asarray(ops.sharded_dequant_matmul(
            jnp.asarray(x), jnp.asarray(q), sc, of, mesh=mesh4))

    prog, blob = progs["olmo"], out["olmo/blob"].tobytes()
    tokens = jnp.asarray(inp["tokens"])
    for mode in ("fp", "quantized", "speculative"):
        kw = ({"speculative": SpecConfig(draft_bits=4, k=2)} if mode == "speculative"
              else {"resident": mode})
        res = Session.from_scenario(blob, get_scenario("browser-lte-handoff"), seed=1
                                    ).run_serving(model, prog, decode_steps=int(inp["steps"]),
                                                  batch={"tokens": tokens}, **kw)
        out[f"serve/{mode}/tokens"] = np.asarray(res.tokens)
        out[f"serve/{mode}/stages"] = np.asarray(res.stage_at_step)
    prompts = [jnp.asarray(inp[f"prompt/{i}"]) for i in range(int(inp["n_prompts"]))]
    res = Session.from_scenario(blob, get_scenario("flash-crowd"), seed=2).run_serving_pool(
        model, prog, prompts=prompts, arrival_offsets_s=[float(t) for t in inp["offsets"]],
        max_new_tokens=6, n_slots=2, resident="quantized")
    out["pool/tokens"] = np.asarray(json.dumps({str(k): [int(t) for t in v]
                                                for k, v in res.tokens.items()}))
    out["pool/upgrades"] = np.asarray(json.dumps(res.upgrades))
    np.savez(sys.argv[2], **out)
"""


def _small_tree() -> dict:
    """Leaves on every route: split on the last dim (``a``, ``c``), split
    at 2 shards and whole at 4 (``d``: 6 columns), 1-D and scalar whole."""
    rng = np.random.default_rng(4)
    return {"a": rng.standard_normal((24, 8)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32),
            "c": rng.standard_normal((16, 12)).astype(np.float32),
            "d": rng.standard_normal((10, 6)).astype(np.float32),
            "s": np.float32(2.5)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's model, programs and blobs, and the reference side's
    results (one subprocess)."""
    tmp = tmp_path_factory.mktemp("sharded")
    cfg = get_config("olmo-1b").reduced(**REDUCED)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    small = _small_tree()
    progs = {"olmo": divide(params), "small": divide(params_from_numpy(small, device="cpu"))}
    blobs = {k: wire.encode(p, integrity=True) for k, p in progs.items()}
    rng = np.random.default_rng(5)
    inp = {"reduced": json.dumps(REDUCED), "steps": DECODE_STEPS,
           "tokens": np.random.default_rng(1).integers(0, cfg.vocab, (2, 8)).astype(np.int32)}
    for path, leaf in tree_flatten_with_path(params):
        inp["param/" + wire.path_str(path)] = leaf.numpy()
    for k, v in small.items():
        inp[f"small/{k}"] = v
    cuts = {k: np.sort(rng.choice(np.arange(1, len(b)), N_CUTS, replace=False))
            for k, b in blobs.items()}
    for k, c in cuts.items():
        inp[f"{k}/cuts"] = c
    prompts = [np.random.default_rng(10 + i).integers(0, cfg.vocab, 6 + 2 * i).astype(np.int32)
               for i in range(4)]
    inp["n_prompts"] = len(prompts)
    for i, p in enumerate(prompts):
        inp[f"prompt/{i}"] = p
    inp["offsets"] = np.asarray(flash_crowd_arrivals(3, len(prompts), span_s=0.5))
    g = np.random.default_rng(7)
    inp["sdqm/scale"], inp["sdqm/offset"] = np.float32(3.1 * 2.0 ** -16), np.float32(-1.3)
    for M in (1, 8):
        inp[f"sdqm/{M}/x"] = g.standard_normal((M, 96)).astype(np.float32)
        inp[f"sdqm/{M}/q"] = g.integers(0, 2 ** 16, (96, 256)).astype(np.uint16)
    np.savez(tmp / "in.npz", **inp)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                           str(tmp / "in.npz"), str(tmp / "out.npz")],
                          capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = dict(np.load(tmp / "out.npz"))
    for k, b in blobs.items():
        assert out[f"{k}/blob"].tobytes() == b, k   # the same bytes on both sides
    return {"model": model, "cfg": cfg, "progs": progs, "blobs": blobs, "cuts": cuts,
            "inp": inp, "out": out, "prompts": prompts}


def _mesh(n: int):
    return make_serving_mesh(n, devices=["cpu"] * n)


def _gathered(leaf) -> np.ndarray:
    """A leaf's whole value: a ShardedLeaf's parts joined, a quantized
    view's q."""
    if isinstance(leaf, ShardedLeaf):
        leaf = leaf.gather()
    return getattr(leaf, "q", leaf).numpy()


def _json(arr) -> object:
    return json.loads(str(arr))


# ---------------------------------------------------------------------------
# the spec rule and the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["olmo", "small"])
@pytest.mark.parametrize("n", SHARDS)
def test_serving_spec_matches_reference(world, name, n):
    meta, _ = wire.decode_header(world["blobs"][name])
    got = [list(serving_spec_for_param(t["path"], tuple(t["shape"]), _mesh(n)))
           for t in meta["tensors"]]
    assert got == _json(world["out"][f"{name}/spec{n}"])
    if name == "olmo":
        paths = [t["path"] for t in meta["tensors"]]
        assert got[paths.index("embed")] == [None, "model"]   # d_model, contracted
        assert all(s[-1] == "model" and not any(s[:-1]) for s in got)


def test_mesh_needs_its_cards_unless_told():
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_serving_mesh(2)
    mesh = make_serving_mesh(2, devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 1, "model": 2} and mesh.home == torch.device("cpu")
    with pytest.raises(ValueError, match="takes 2 devices"):
        make_serving_mesh(2, devices=["cpu"])


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["olmo", "small"])
@pytest.mark.parametrize("n", SHARDS)
def test_store_matches_reference(world, name, n):
    blob, out = world["blobs"][name], world["out"]
    client = ProgressiveClient(mesh=_mesh(n), device="cpu")
    ops.reset_launch_counts()
    prev, fps = 0, {}
    for c in [int(c) for c in world["cuts"][name]] + [len(blob)]:
        client.feed(blob[prev:c])
        prev = c
        if client.store is not None:
            fps.setdefault(str(client.stages_complete), client.store.fingerprint())
    st = client.store
    assert isinstance(st, ShardedPlaneStore)
    assert fps == _json(out[f"{name}/fps{n}"])
    assert [[list(p) for p in st.placement(i)] for i in range(st.n_tensors)] == \
        _json(out[f"{name}/placement{n}"])
    active = sum(1 for s in st.substores if s.n_tensors)
    assert ops.LAUNCH_COUNTS["plane_or_segments"] == 8 * active
    assert ops.LAUNCH_COUNTS["plane_or"] == 0
    for i in range(st.n_tensors):
        np.testing.assert_array_equal(st.acc(i).numpy(), out[f"{name}/acc{n}/{i}"])
    for k, v in st.materialize_leaves().items():
        np.testing.assert_array_equal(_gathered(v), out[f"{name}/fp{n}/{k}"])
    for k, v in st.quantized_leaves().items():
        np.testing.assert_array_equal(_gathered(v), out[f"{name}/q{n}/{k}"])


def test_store_routes_and_refusals(world):
    """``embed`` is split for ingest but gathered whole for serving; a
    lone sliced entry routes whole; replica rows, still to port, raise
    naming their ROADMAP item."""
    prog = world["progs"]["olmo"]
    st = ReceiverState.init(prog, mesh=_mesh(2), device="cpu").store
    leaves = st.quantized_leaves()
    assert len(st.placement([t.path for t in prog.tensors].index(("embed",)))) == 2
    assert not isinstance(leaves[("embed",)], ShardedLeaf)
    assert all(isinstance(v, ShardedLeaf) for k, v in leaves.items() if k != ("embed",))
    snap = st.copy()
    st.ingest(prog.stage(1))
    assert snap.fingerprint() != st.fingerprint() and snap.received != st.received
    with pytest.raises(NotImplementedError, match="A13"):
        ReceiverState.init(prog, mesh=make_serving_mesh(2, n_data=2, devices=["cpu"] * 4),
                           device="cpu")
    entries = [{"key": "e", "schedule": prog.tensors[0].plan.schedule, "lo": 0.0, "hi": 1.0,
                "shape": (4, 8), "orig_dtype": torch.float32, "slice_axis": 0,
                "slice_idx": 0}]
    # a lone slice is not an expert bank the shards can divide: the
    # reference's rules send it whole to one shard
    lone = ShardedPlaneStore(entries, _mesh(2))
    assert lone._route == {"e": ("whole", 0)} and lone.placement(0) == [(0, 0)]
    with pytest.raises(ValueError, match="home device"):
        ReceiverState.init(prog, mesh=make_serving_mesh(2, devices=["meta", "cpu"]),
                           device="cpu")


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 8])
def test_sharded_dequant_matmul_matches_reference(world, M):
    inp = world["inp"]
    x, q = torch.from_numpy(inp[f"sdqm/{M}/x"]), torch.from_numpy(inp[f"sdqm/{M}/q"])
    sc = torch.tensor([[float(inp["sdqm/scale"])]])
    of = torch.tensor([[float(inp["sdqm/offset"])]])
    shards, scales, offsets = list(torch.chunk(q, 4, dim=1)), [sc] * 4, [of] * 4
    ops.reset_launch_counts()
    got = ops.sharded_dequant_matmul(x, shards, scales, offsets, mesh=_mesh(4))
    assert ops.LAUNCH_COUNTS == {"sharded_dequant_matmul": 1}
    assert ops.sharded_launches == 0            # the CPU path launches no kernel
    np.testing.assert_allclose(got.numpy(), world["out"][f"sdqm/{M}"], rtol=2e-5, atol=2e-4)
    assert torch.equal(got, ref.sharded_dequant_matmul_ref(x, shards, scales, offsets))


@pytest.mark.parametrize("n", SHARDS)
def test_gemv_shard_with_n_split_equals_unsharded(n):
    """The GEMV route's order of sums, emulated on the CPU: a shard of
    ``mlp/wi_up``'s width (2048 x 8192) launched with ``n_split`` = the
    whole N gives the unsharded launch's columns bit for bit; at 4 shards
    the shard's own width would pick other chunks of K."""
    g = torch.Generator().manual_seed(n)
    K, N = 2048, 8192
    x = torch.randn((2, K), generator=g).to(torch.bfloat16)
    q = torch.randint(0, 2 ** 16, (K, N), generator=g).to(torch.uint16)
    sc, of = torch.tensor([[3.0 * 2.0 ** -16]]), torch.tensor([[-1.4]])
    keep = torch.tensor([[4]], dtype=torch.int32)
    for kt in (None, keep):
        whole = ref.dequant_matmul_gemv_ref(x, q, sc, of, kt)
        w = N // n
        for j in range(n):
            shard = q[:, j * w:(j + 1) * w].contiguous()
            part = ref.dequant_matmul_gemv_ref(x, shard, sc, of, kt, n_split=N)
            assert torch.equal(part, whole[:, j * w:(j + 1) * w]), (j, kt)
    assert (dequant_matmul.gemv_k_chunk(K, N // 4, False)
            != dequant_matmul.gemv_k_chunk(K, N, False))
    with pytest.raises(ValueError, match="n_split"):
        dequant_matmul.dequant_matmul(x, q, sc, of, n_split=N - 1)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _session(world, scenario="browser-lte-handoff", seed=1):
    return Session.from_scenario(world["blobs"]["olmo"], get_scenario(scenario), seed=seed,
                                 device="cpu")


@pytest.mark.parametrize("mode,n", [("fp", 2), ("quantized", 2), ("quantized", 4),
                                    ("speculative", 2)])
def test_sharded_session_matches_reference_single_device(world, mode, n):
    kw = ({"speculative": SpecConfig(draft_bits=4, k=2)} if mode == "speculative"
          else {"resident": mode})
    ops.reset_launch_counts()
    r = _session(world).run_serving(world["model"], world["progs"]["olmo"],
                                    decode_steps=DECODE_STEPS,
                                    batch={"tokens": world["inp"]["tokens"]},
                                    mesh=_mesh(n), **kw)
    out = world["out"]
    np.testing.assert_array_equal(r.tokens.numpy(), out[f"serve/{mode}/tokens"])
    assert r.stage_at_step == out[f"serve/{mode}/stages"].tolist()
    assert len(set(r.stage_at_step)) > 1
    assert set(r.client.store.fingerprint()) == {f"shard{j}/uint16" for j in range(n)}
    if mode != "fp":
        assert ops.LAUNCH_COUNTS["sharded_dequant_matmul"] > 0
    if mode == "speculative":
        assert r.server.resident_report()["extra_draft_bytes"] == 0


def test_sharded_pool_matches_reference_single_device(world):
    r = _session(world, "flash-crowd", seed=2).run_serving_pool(
        world["model"], world["progs"]["olmo"], prompts=world["prompts"],
        arrival_offsets_s=[float(t) for t in world["inp"]["offsets"]], max_new_tokens=6,
        n_slots=2, resident="quantized", mesh=_mesh(2))
    assert {str(k): v for k, v in r.tokens.items()} == _json(world["out"]["pool/tokens"])
    assert [list(u) for u in r.upgrades] == _json(world["out"]["pool/upgrades"])
    assert all(rec["sharded"] for rec in r.server.upgrade_log)


def test_pull_mode_server_upgrades_shard_local(world):
    """A pull-mode server over ``ReceiverState.init(mesh=)``: one
    ``plane_or_segments`` launch a shard a stage, tokens and served
    weight bytes equal to one device."""
    prog, tokens = world["progs"]["olmo"], world["inp"]["tokens"]
    runs = {}
    for n in (None, 4):
        srv = ProgressiveServer(world["model"], prog, max_len=32, resident="quantized",
                                mesh=None if n is None else _mesh(n), device="cpu")
        ops.reset_launch_counts()
        srv.receive_stage()
        srv.start({"tokens": tokens})
        res = srv.decode(12, stage_arrival=lambda i: i % 2 == 1)
        runs[n] = (res, dict(ops.LAUNCH_COUNTS), srv.resident_report(), srv.state.store)
    (plain, pc, prep, pstore), (sharded, sc, srep, sstore) = runs[None], runs[4]
    assert torch.equal(plain.tokens, sharded.tokens)
    assert plain.stage_at_step == sharded.stage_at_step
    assert sc["plane_or_segments"] == 4 * pc["plane_or_segments"] == 4 * 7
    # the served leaves: every weight's shards plus the gathered embed
    assert srep["quantized_bytes"] == prep["quantized_bytes"]
    assert "gathered_bytes" not in prep
    # the store holds the gathered embed on top of its split accumulators
    embed = pstore.acc(next(i for i, k in enumerate(sstore.keys)
                            if gathered_for_serving(_path(k))))
    assert srep["gathered_bytes"] == sstore.gathered_bytes() == embed.numel() * embed.element_size()


def test_cli_mesh_shards_on_the_cpu(capsys):
    base = ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--decode-steps", "6",
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
