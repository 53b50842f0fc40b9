"""The port's progressive checkpoints (``train/checkpoint.py``) against the
JAX package's on the CPU.

The reference's parameters (reduced olmo-1b at the reference test's
sizes) enter the port through their numpy arrays. Held:

* ``save``: ``header.bin`` and every ``stage_*.bin`` byte-identical to the
  reference's files for the same parameters, under the paper's schedule
  and under an 8-bit (4, 4) one; ``passthrough.npz`` holding the same
  arrays (the zip itself carries a timestamp), a non-float leaf included;
* ``load_into`` of the reference's files at stages 1, 4 and 8 equal to the
  reference's, into a tree of ``meta`` tensors; at stage 8 within the
  16-bit quantization step of the float parameters;
* cold start: ``Model.forward`` from stages 1, 4 and 8 finite, its error
  against the float parameters' logits decreasing, under 1e-4 at stage 8;
* ``manifest`` equal to the reference's;
* a ``ProgressiveServer(resident="quantized")`` fed the checkpoint's files
  as one stream through a ``WireStoreReceiver``, stages landing
  mid-decode, serves the reference's greedy tokens.

The reference side runs in a process of its own, started with the
module's fixture.
"""
import json
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.bitplanes import PlaneSchedule
from repro_torch.core.policy import UniformPolicy
from repro_torch.core.progressive import tree_flatten_with_path, tree_skeleton, tree_unflatten
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ProgressiveServer, WireStoreReceiver
from repro_torch.train import checkpoint
from repro_torch.transmission import ProgressiveClient
from test_torch_cnn import Jobs

REDUCED = dict(n_layers=2, d_model=64, d_ff=128, vocab=128, n_heads=2, n_kv=2)
STAGES = (1, 4, 8)
PROMPT = (2, 8)
STEPS = 16
# the checkpoints: the paper's schedule, an 8-bit one of two 4-bit
# stages, and a tree with a non-float leaf (a passthrough)
CKPTS = ("paper", "bits8", "passthrough")

_REFERENCE = """
    import json, sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.bitplanes import PlaneSchedule
    from repro.core.policy import UniformPolicy
    from repro.models.model import build_model
    from repro.serving.engine import ProgressiveServer, WireStoreReceiver
    from repro.train import checkpoint
    from repro.transmission.client import ProgressiveClient

    inp, out_path, root = sys.argv[1:]
    arrays = np.load(inp)
    spec = json.loads(arrays["spec"].item())
    out = {}

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + "/".join(str(p.key) for p in path)] = np.asarray(leaf)

    model = build_model(get_config("olmo-1b").reduced(**spec["reduced"]))
    params = model.init(jax.random.PRNGKey(0))
    put("param/", params)
    prog = checkpoint.save(params, f"{root}/paper")
    checkpoint.save(params, f"{root}/bits8", UniformPolicy(PlaneSchedule(bits=8, widths=(4, 4))))
    checkpoint.save({"w": params["embed"], "count": jnp.array([3, 7], jnp.int32)},
                    f"{root}/passthrough")
    for name in spec["ckpts"]:
        out[f"manifest/{name}"] = np.array(json.dumps(checkpoint.manifest(f"{root}/{name}")))
    for s in spec["stages"]:
        put(f"load/{s}/", checkpoint.load_into(f"{root}/paper", params, stages=s))

    files = [f"{root}/paper/header.bin"] + [f"{root}/paper/stage_{s:02d}.bin"
                                             for s in range(1, prog.n_stages + 1)]
    blobs = [open(f, "rb").read() for f in files]
    client = ProgressiveClient()
    srv = ProgressiveServer(model, prog, max_len=64, resident="quantized",
                            receiver=WireStoreReceiver(client, prog))
    client.feed(blobs[0])
    client.feed(blobs[1])
    srv.receive_stage()
    srv.start({"tokens": jnp.asarray(arrays["prompt"])})
    res = srv.decode(spec["steps"], stage_arrival=lambda i: i % 2 == 1 and client.feed(
        blobs[client.stages_complete + 1]) is None)
    out["tokens"] = np.asarray(res.tokens)
    out["stage_at_step"] = np.array(res.stage_at_step)
    np.savez(out_path, **out)
"""


class Reference(Jobs):
    def __init__(self, tmp):
        spec = {"reduced": REDUCED, "ckpts": CKPTS, "stages": STAGES, "steps": STEPS}
        np.savez(tmp / "in.npz", spec=json.dumps(spec), prompt=_prompt())
        self.root = tmp / "ref"
        super().__init__(tmp, {"ckpt": [sys.executable, "-c", textwrap.dedent(_REFERENCE),
                                        str(tmp / "in.npz"), str(tmp / "ckpt.npz"),
                                        str(self.root)]})

    @property
    def arrays(self) -> dict:
        return self.read("ckpt", lambda tmp: dict(np.load(tmp / "ckpt.npz")))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    r = Reference(tmp_path_factory.mktemp("ckpt_reference"))
    yield r
    r.close()


def _prompt() -> np.ndarray:
    return np.random.default_rng(3).integers(0, REDUCED["vocab"], PROMPT).astype(np.int32)


def _model():
    return build_model(get_config("olmo-1b").reduced(**REDUCED))


def _params(out: dict, prefix: str = "param/"):
    """The reference's parameters (or loaded tree) in the port's tree, on
    the CPU; the empty dicts of olmo's parameter-free norms included."""
    skeleton = tree_skeleton(_model().init(torch.Generator().manual_seed(0), device="cpu"))
    return tree_unflatten(skeleton, {p: torch.from_numpy(out[prefix + "/".join(p)])
                                     for p, _ in tree_flatten_with_path(skeleton)})


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty_like(tree, device="meta")


@pytest.fixture(scope="module")
def port_dir(ref, tmp_path_factory):
    """The port's checkpoints of the reference's parameters."""
    root = tmp_path_factory.mktemp("ckpt_port")
    params = _params(ref.arrays)
    checkpoint.save(params, str(root / "paper"))
    checkpoint.save(params, str(root / "bits8"), UniformPolicy(PlaneSchedule(bits=8,
                                                                             widths=(4, 4))))
    checkpoint.save({"w": params["embed"], "count": torch.tensor([3, 7], dtype=torch.int32)},
                    str(root / "passthrough"))
    return root


@pytest.mark.parametrize("name", CKPTS)
def test_files_equal_reference(ref, port_dir, name):
    mine, theirs = port_dir / name, ref.root / name
    files = sorted(p.name for p in theirs.iterdir())
    assert sorted(p.name for p in mine.iterdir()) == files
    n_stages = {"paper": 8, "bits8": 2, "passthrough": 8}[name]
    assert files == sorted(["header.bin", "passthrough.npz"]
                           + [f"stage_{s:02d}.bin" for s in range(1, n_stages + 1)])
    for f in files:
        if f != "passthrough.npz":
            assert (mine / f).read_bytes() == (theirs / f).read_bytes(), (name, f)
    with np.load(mine / "passthrough.npz") as a, np.load(theirs / "passthrough.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, k)
        if name == "passthrough":
            assert a.files == ["count"] and a["count"].tolist() == [3, 7]


@pytest.mark.parametrize("name", CKPTS)
def test_manifest_equals_reference(ref, port_dir, name):
    want = json.loads(ref.arrays[f"manifest/{name}"].item())
    got = checkpoint.manifest(str(port_dir / name))
    assert json.loads(json.dumps(got)) == want


@pytest.mark.parametrize("stages", STAGES)
def test_load_into_equals_reference(ref, stages):
    out = ref.arrays
    like = _meta(_params(out))
    got = checkpoint.load_into(str(ref.root / "paper"), like, stages=stages, device="cpu")
    want = _params(out, f"load/{stages}/")
    assert tree_skeleton(got) == tree_skeleton(want)
    for (path, a), (_, b) in zip(tree_flatten_with_path(got), tree_flatten_with_path(want)):
        assert a.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a, b), path
    if stages == 8:
        # 16-bit quantization error only
        for (path, a), (_, p) in zip(tree_flatten_with_path(got),
                                     tree_flatten_with_path(_params(out))):
            span = float(p.max() - p.min()) + 1e-9
            assert float((a - p).abs().max()) <= span / 2 ** 16 + 1e-6, path


def test_load_flat_passthrough_leaves(port_dir):
    flat = checkpoint.load_flat(str(port_dir / "passthrough"), device="cpu")
    assert sorted(flat) == ["count", "w"]
    assert flat["count"].dtype == torch.int32 and flat["count"].tolist() == [3, 7]


def test_coldstart_errors_decrease(ref, port_dir):
    out = ref.arrays
    model = _model()
    params = _params(out)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    with torch.no_grad():
        want, _ = model.forward(params, batch)
        errs = []
        for stages in STAGES:
            approx = checkpoint.load_into(str(port_dir / "paper"), params, stages=stages,
                                          device="cpu")
            logits, _ = model.forward(approx, batch)
            assert bool(torch.isfinite(logits).all())
            errs.append(float(torch.mean((logits - want) ** 2)))
    assert errs[0] > errs[1] > errs[2], errs
    assert errs[2] < 1e-4, errs


def test_served_tokens_equal_reference(ref, port_dir):
    out = ref.arrays
    model = _model()
    prog = checkpoint.save(_params(out), str(port_dir / "serve"))
    root = port_dir / "paper"
    blobs = [(root / "header.bin").read_bytes()] + [
        (root / f"stage_{s:02d}.bin").read_bytes() for s in range(1, prog.n_stages + 1)]
    client = ProgressiveClient(device="cpu")
    srv = ProgressiveServer(model, prog, max_len=64, resident="quantized", device="cpu",
                            receiver=WireStoreReceiver(client, prog))
    client.feed(blobs[0])
    client.feed(blobs[1])
    srv.receive_stage()
    srv.start({"tokens": _prompt()})
    res = srv.decode(STEPS, stage_arrival=lambda i: i % 2 == 1 and client.feed(
        blobs[client.stages_complete + 1]) is None)
    assert res.stage_at_step == out["stage_at_step"].tolist()
    assert res.stage_at_step[-1] == 8
    assert np.array_equal(res.tokens.numpy(), out["tokens"])
