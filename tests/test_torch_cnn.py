"""The paper's own CNN (ROADMAP A8(f)), ``progressivenet-cnn``, against the
JAX package on the CPU.

The reference's parameters (``cnn_init`` from a JAX key) enter the port
through ``interop.params_from_numpy``; images are made with numpy. Held:

* ``CONFIG`` equal to the reference's ``ArchConfig``; ``cnn_init``'s keys,
  shapes and dtypes equal to the reference's, the norms' scales ones and
  biases zeros;
* ``cnn_apply`` within ``ATOL`` (absolute) of the reference's logits at
  channels (16, 32, 64) and (8, 16, 32), on 16x16, 15x15 (odd: the
  stride-2 ``SAME`` pointwise convolution gives ``ceil(H / 2)`` rows) and
  32x32 batches;
* progressive inference: each stage's planes, the v1 and v3 wire blobs
  byte for byte; a ``ProgressiveClient`` fed each stage in ragged chunks,
  whose accumulators and ``PlaneStore.fingerprint()`` equal the
  reference client's and whose materialised leaves equal the reference's
  exactly at all 8 stages; the logits from those leaves within ``ATOL``
  of the reference's and the argmax equal, at every stage;
* the launcher serves ``--arch progressivenet-cnn --reduced``: the
  decoder its ``ArchConfig`` describes, as the reference's launcher does.

The reference side runs in two processes of its own (``_REFERENCE``: the
"apply" job and the "progressive" job), started with the module's
fixture, while the port's side runs here; most of their time is JAX
compiling each operation at each of the CNN's shapes.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import progressivenet_cnn as jcnn
from repro_torch.configs import get_config
from repro_torch.configs import progressivenet_cnn as cnn
from repro_torch.core import wire
from repro_torch.core.progressive import divide
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.transmission import ProgressiveClient

ATOL = 1e-5
CHANNELS = {"published": (16, 32, 64), "narrow": (8, 16, 32)}
SIZES = (16, 15, 32)
BATCH = 8
STREAM_BATCH = 16   # the images the progressive job classifies at each stage

# The reference side. "apply": each width's parameters and its logits on
# each size's images; "progressive": the published widths divided, each
# stage's planes, the v1 and v3 blobs, and a client fed a stage at a time:
# its accumulators, fingerprints, materialised leaves and their logits.
_REFERENCE = """
    import json, sys
    import numpy as np
    import jax
    from repro.configs import progressivenet_cnn as jcnn
    from repro.core import wire
    from repro.core.progressive import divide
    from repro.transmission import ProgressiveClient

    inp, out_path, job = sys.argv[1:]
    arrays = np.load(inp)
    spec = json.loads(arrays["spec"].item())
    apply = jax.jit(jcnn.cnn_apply)
    out = {}

    def params(channels):
        return jcnn.cnn_init(jax.random.PRNGKey(0), channels=tuple(channels))

    if job == "apply":
        for name, ch in spec["channels"].items():
            jp = params(ch)
            for k, v in jp.items():
                out[f"{name}/param/{k}"] = np.asarray(v)
            for size in spec["sizes"]:
                out[f"{name}/logits/{size}"] = np.asarray(apply(jp, arrays[f"x{size}"]))
    else:
        jp = params(spec["channels"]["published"])
        x = arrays["stream"]
        for k, v in jp.items():
            out[f"param/{k}"] = np.asarray(v)
        out["full"] = np.asarray(apply(jp, x))
        prog = divide(jp)
        for s in range(1, prog.n_stages + 1):
            for i, plane in prog.stage(s):
                out[f"plane/{s}/{i}"] = np.asarray(plane)
        for v, integrity in (("v1", False), ("v3", True)):
            blob = wire.encode(prog, integrity=integrity)
            out[f"{v}/blob"] = np.frombuffer(blob, np.uint8)
            meta, hdr = wire.decode_header(blob)
            ends = [hdr]
            for n in wire.layout_from_header(meta, hdr).stage_bytes:
                ends.append(ends[-1] + n)
            client = ProgressiveClient()
            client.feed(blob[:ends[0]])
            for s in range(1, len(ends)):
                client.feed(blob[ends[s - 1]:ends[s]])
                leaves = client.materialize()
                for dt, buf in client.store.buffers.items():
                    out[f"{v}/{s}/buf/{dt}"] = np.asarray(buf)
                out[f"{v}/{s}/fingerprint"] = np.array(json.dumps(client.store.fingerprint()))
                for k, a in leaves.items():
                    out[f"{v}/{s}/leaf/{k}"] = np.asarray(a)
                out[f"{v}/{s}/logits"] = np.asarray(apply(leaves, x))
    np.savez(out_path, **out)
"""


def _images(size, seed=1, batch=BATCH):
    return np.random.default_rng(seed).standard_normal((batch, size, size, 3)).astype(np.float32)


class Jobs:
    """The reference side's processes (``cmds``: job -> argv, run in
    ``tmp`` with ``src`` on the path), started together; ``read(job,
    load)`` waits for one once, checks its exit code and returns
    ``load(tmp)``."""

    def __init__(self, tmp, cmds: dict):
        self.tmp, self.out = tmp, {}
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
        env.pop("REPRO_TELEMETRY", None)
        self.procs = {}
        for job, cmd in cmds.items():
            with open(tmp / f"{job}.err", "w") as err:
                self.procs[job] = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=err,
                                                   env=env, cwd=tmp)

    def read(self, job: str, load):
        if job not in self.out:
            rc = self.procs[job].wait(timeout=300)
            assert rc == 0, (self.tmp / f"{job}.err").read_text()[-3000:]
            self.out[job] = load(self.tmp)
        return self.out[job]

    def close(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


class Reference(Jobs):
    """The "apply" and "progressive" jobs; ``ref[job]`` is a job's arrays."""

    def __init__(self, tmp, jobs=("apply", "progressive")):
        spec = {"channels": CHANNELS, "sizes": list(SIZES)}
        np.savez(tmp / "in.npz", spec=json.dumps(spec), stream=_images(16, 2, STREAM_BATCH),
                 **{f"x{s}": _images(s) for s in SIZES})
        super().__init__(tmp, {job: [sys.executable, "-c", textwrap.dedent(_REFERENCE),
                                     str(tmp / "in.npz"), str(tmp / f"{job}.npz"), job]
                               for job in jobs})

    def __getitem__(self, job: str) -> dict:
        return self.read(job, lambda tmp: dict(np.load(tmp / f"{job}.npz")))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    r = Reference(tmp_path_factory.mktemp("cnn_reference"))
    yield r
    r.close()


def _params(out: dict, prefix: str) -> dict:
    """The reference's parameters from a job's output, in the port's tree
    on the CPU."""
    return params_from_numpy({k[len(prefix):]: v for k, v in out.items()
                              if k.startswith(prefix)}, device="cpu")


def test_config_equal_reference(ref):
    cfg, jcfg = get_config("progressivenet-cnn"), jax_get_config("progressivenet-cnn")
    assert cfg is cnn.CONFIG and get_config("progressivenet_cnn") is cfg
    fields = [f.name for f in dataclasses.fields(cfg) if f.name != "dtype"]
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    assert (cfg.family, cfg.vocab, cfg.cycle) == ("cnn", 10, ("attn",))


@pytest.mark.parametrize("channels", sorted(CHANNELS))
def test_init_layout_equals_reference(channels):
    ch = CHANNELS[channels]
    # the reference's layout without running its generator
    jp = jax.eval_shape(lambda: jcnn.cnn_init(jax.random.PRNGKey(0), channels=ch))
    p = cnn.cnn_init(torch.Generator().manual_seed(0), channels=ch, device="cpu")
    assert sorted(p) == sorted(jp)
    for k, v in jp.items():
        assert tuple(p[k].shape) == v.shape and p[k].dtype == torch.float32, k
    assert p["conv0_dw"].shape == (3, 3, 1, 3) and p["head"].shape == (ch[-1], 10)
    for i, c in enumerate(ch):
        assert torch.equal(p[f"bn{i}_scale"], torch.ones(c))
        assert torch.equal(p[f"bn{i}_bias"], torch.zeros(c))
    # the same generator state gives the same weights
    again = cnn.cnn_init(torch.Generator().manual_seed(0), channels=ch, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("channels", sorted(CHANNELS))
def test_apply_equals_reference(ref, channels, size):
    out = ref["apply"]
    p = _params(out, f"{channels}/param/")
    want = out[f"{channels}/logits/{size}"]
    got = cnn.cnn_apply(p, torch.from_numpy(_images(size)))
    assert got.shape == (BATCH, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert np.array_equal(got.numpy().argmax(-1), want.argmax(-1))


def _stage_ends(blob: bytes) -> list[int]:
    meta, hdr = wire.decode_header(blob)
    ends = [hdr]
    for n in wire.layout_from_header(meta, hdr).stage_bytes:
        ends.append(ends[-1] + n)
    return ends


def _feed(client, data: bytes, rng) -> None:
    """``data`` in ragged chunks of 1-700 bytes."""
    at = 0
    while at < len(data):
        n = int(rng.integers(1, 700))
        client.feed(data[at:at + n])
        at += n


@pytest.mark.parametrize("integrity", [False, True], ids=["v1", "v3"])
def test_progressive_inference_equals_reference(ref, integrity):
    out = ref["progressive"]
    v = "v3" if integrity else "v1"
    p = _params(out, "param/")
    prog = divide(p)
    assert prog.n_stages == 8
    for s in range(1, prog.n_stages + 1):
        got = prog.stage(s)
        assert sorted(i for i, _ in got) == sorted(int(k.split("/")[2]) for k in out
                                                   if k.startswith(f"plane/{s}/"))
        for i, plane in got:
            assert np.array_equal(plane.numpy(), out[f"plane/{s}/{i}"]), (s, i)
    blob = wire.encode(prog, integrity=integrity)
    assert blob == out[f"{v}/blob"].tobytes()
    x = torch.from_numpy(_images(16, 2, STREAM_BATCH))
    full = out["full"].argmax(-1)
    client = ProgressiveClient(device="cpu")
    ends = _stage_ends(blob)
    rng = np.random.default_rng(4)
    _feed(client, blob[:ends[0]], rng)
    agree = []
    for s in range(1, prog.n_stages + 1):
        _feed(client, blob[ends[s - 1]:ends[s]], rng)
        assert client.stages_complete == s
        leaves = client.materialize()
        assert sorted(leaves) == sorted(p)
        for dt, buf in client.store.buffers.items():
            assert np.array_equal(buf.numpy(), out[f"{v}/{s}/buf/{dt}"]), (s, dt)
        assert client.store.fingerprint() == json.loads(out[f"{v}/{s}/fingerprint"].item())
        for k, leaf in leaves.items():
            assert np.array_equal(leaf.numpy(), out[f"{v}/{s}/leaf/{k}"]), (s, k)
        want = out[f"{v}/{s}/logits"]
        got = cnn.cnn_apply(leaves, x).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=f"stage {s}")
        assert np.array_equal(got.argmax(-1), want.argmax(-1)), s
        agree.append(float((got.argmax(-1) == full).mean()))
    # at 16 bits the received model classifies as the float model does
    assert client.complete and agree[-1] == 1.0


def test_cli_serves_progressivenet_cnn(capsys):
    serve.main(["--arch", "progressivenet-cnn", "--reduced", "--device", "cpu",
                "--decode-steps", "4"])
    assert "served 4 steps across 8 precision stages" in capsys.readouterr().out
