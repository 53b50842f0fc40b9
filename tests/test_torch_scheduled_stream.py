"""Scheduled streams (wire v2 and v3 with a non-uniform
``TransmissionSchedule``) through the port's client and a wire-fed server,
against the JAX package's, on the CPU.

Reduced olmo-1b (2 layers, d_model 64; the JAX init converted through
numpy). Two schedules: the calibrated ``weight_sse_schedule`` (asserted
equal to the reference's) and a seeded random MSB-first interleave; each
raw and entropy-coded, on v2 and v3, fed in seeded ragged chunks to both
packages' clients. Held exactly, mid-stream and at the end: the
fingerprints at every checkpoint, ``received``, the float leaves of
``ProgressiveClient.materialize()``; and the greedy tokens of a
quantized-resident ``ProgressiveServer(receiver=WireStoreReceiver(...))``
with a checkpoint landing every other step, against the JAX wire-fed
server's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import calibrate as jcal
from repro.core import wire as jwire
from repro.core.progressive import divide as jax_divide
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import ProgressiveServer as JServer
from repro.serving.engine import WireStoreReceiver as JWireStoreReceiver
from repro.transmission.client import ProgressiveClient as JClient
from repro_torch.configs import get_config
from repro_torch.core import calibrate as cal
from repro_torch.core import wire
from repro_torch.core.plane_store import PlaneStore
from repro_torch.core.progressive import divide
from repro_torch.interop import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ProgressiveServer, WireStoreReceiver
from repro_torch.transmission import ProgressiveClient
from test_torch_client import feed
from test_torch_resident_fp import _same_leaves

REDUCED = dict(n_layers=2, d_model=64, d_ff=128, vocab=128, n_heads=2, n_kv=2)


@pytest.fixture(scope="module")
def olmo():
    jcfg = jax_get_config("olmo-1b").reduced(**REDUCED)
    cfg = get_config("olmo-1b").reduced(**REDUCED)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, model, jax_divide(jparams), divide(params)


def random_msb_first(prog, seed: int):
    """A seeded interleave: each unit is the next plane of a tensor drawn
    at random among those with planes left; checkpoints at the uniform
    ladder's byte marks."""
    rng = np.random.default_rng(seed)
    left = [t.plan.schedule.n_planes for t in prog.tensors]
    nxt = [0] * len(left)
    units = []
    while any(left):
        t = int(rng.choice([i for i, n in enumerate(left) if n]))
        units.append((t, nxt[t]))
        nxt[t] += 1
        left[t] -= 1
    return cal._finalize(prog, units, None)


def _schedules(jprog, prog, kind):
    if kind == "calibrated":
        sched = cal.weight_sse_schedule(prog)
        want = jcal.weight_sse_schedule(jprog)
        assert sched.units == tuple(want.units) and sched.checkpoints == tuple(want.checkpoints)
        return sched, want
    sched = random_msb_first(prog, 4)
    return sched, jcal.TransmissionSchedule(units=sched.units, checkpoints=sched.checkpoints)


def _blob(jprog, prog, kind, entropy_coded, version):
    sched, jsched = _schedules(jprog, prog, kind)
    kw = dict(entropy_coded=entropy_coded, integrity=version == "v3")
    blob = wire.encode(prog, schedule=sched, **kw)
    assert blob == jwire.encode(jprog, schedule=jsched, **kw)
    return blob, sched


def _recording(cls, **kw):
    fps: list = []
    client = cls(on_stage_complete=lambda s: fps.append(
        (s, client.store.fingerprint(), list(client.store.received))), **kw)
    return client, fps


@pytest.mark.parametrize("version", ["v2", "v3"])
@pytest.mark.parametrize("coding", ["raw", "entropy"])
@pytest.mark.parametrize("kind", ["calibrated", "random"])
def test_client_state_and_leaves_equal_reference(olmo, kind, coding, version):
    _, _, jprog, prog = olmo
    blob, sched = _blob(jprog, prog, kind, coding == "entropy", version)
    client, fps = _recording(ProgressiveClient, device="cpu")
    jclient, jfps = _recording(JClient)
    cut = len(blob) * 5 // 8                       # mid-stream, mid-checkpoint
    for c in (client, jclient):
        feed(c, blob[:cut], seed=3)
    assert client.stages_complete == jclient.stages_complete
    _same_leaves(client.materialize(), jclient.materialize())
    assert client.store.received == jclient.store.received
    assert client.store.fingerprint() == jclient.store.fingerprint()
    for c in (client, jclient):
        feed(c, blob, seed=4, start=cut)
    assert client.complete and jclient.complete
    assert fps == jfps and len(fps) == sched.n_stages
    _same_leaves(client.materialize(), jclient.materialize())
    # every checkpoint's store is an in-memory store fed the same unit prefix
    want = PlaneStore.from_model(prog, device="cpu")
    prev = 0
    for (s, fp, received), cp in zip(fps, sched.checkpoints):
        want.ingest([(t, prog.tensors[t].planes[p]) for t, p in sched.units[prev:cp]])
        prev = cp
        assert want.fingerprint() == fp and want.received == received, s


@pytest.mark.parametrize("case", [("calibrated", "entropy", "v2"), ("random", "raw", "v3")])
def test_wire_fed_server_tokens_equal_reference(olmo, case):
    jmodel, model, jprog, prog = olmo
    kind, coding, version = case
    blob, sched = _blob(jprog, prog, kind, coding == "entropy", version)
    meta, hdr = wire.decode_header(blob)
    ends, pos = [], hdr
    for n in wire.layout_from_header(meta, hdr).stage_bytes:
        pos += n
        ends.append(pos)
    steps = 2 * sched.n_stages + 2
    tokens = np.random.default_rng(1).integers(0, REDUCED["vocab"], (2, 8)).astype(np.int32)
    client, jclient = ProgressiveClient(device="cpu"), JClient()
    srv = ProgressiveServer(model, prog, 8 + steps, resident="quantized", device="cpu",
                            receiver=WireStoreReceiver(client, prog))
    jsrv = JServer(jmodel, jprog, 8 + steps, resident="quantized",
                   receiver=JWireStoreReceiver(jclient, jprog))
    fed = {}

    def arrive(c):
        def step(i):
            if i % 2 or c.stages_complete >= len(ends):
                return False
            s = c.stages_complete
            feed(c, blob[:ends[s]], seed=20 + s, start=fed[c])
            fed[c] = ends[s]
            return True
        return step

    for c in (client, jclient):
        feed(c, blob[:ends[0]], seed=20)
        fed[c] = ends[0]
    srv.receive_stage()
    jsrv.receive_stage()
    srv.start({"tokens": tokens})
    jsrv.start({"tokens": jnp.asarray(tokens)})
    res = srv.decode(steps, stage_arrival=arrive(client))
    jres = jsrv.decode(steps, stage_arrival=arrive(jclient))
    assert res.upgrades == jres.upgrades and res.stage_at_step[-1] == sched.n_stages
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    assert client.store.fingerprint() == jclient.store.fingerprint()
