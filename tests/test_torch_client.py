"""The port's progressive client and wire-fed server against the JAX
package's, on the CPU.

Held exactly: each client fed the other package's stream, in the same
seeded ragged chunks, reaches the same ``PlaneStore.fingerprint()`` after
every stage; on a damaged v3 stream the quarantine log, NACKs, resume
cursor and ``header_failed`` equal the reference client's, and repairs
converge to the clean fingerprints. ``ProgressiveServer`` fed through a
``WireStoreReceiver`` serves greedy tokens equal to the JAX wire-fed
server's at every stage, for uint8/16/32 containers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import wire as jwire
from repro.core.bitplanes import PlaneSchedule as JPlaneSchedule
from repro.core.policy import UniformPolicy as JUniformPolicy
from repro.core.progressive import divide as jax_divide
from repro.kernels import ops as jops
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import ProgressiveServer as JServer
from repro.serving.engine import WireStoreReceiver as JWireStoreReceiver
from repro.transmission.client import ProgressiveClient as JClient
from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.core.bitplanes import PlaneSchedule
from repro_torch.core.policy import UniformPolicy
from repro_torch.core.progressive import ReceiverState, divide
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ProgressiveServer, WireStoreReceiver
from repro_torch.transmission import ProgressiveClient
from test_torch_wire import REDUCED, _progs, _small_tree, encode_both

SCHEDULES = {"uint8": (8, (2, 2, 2, 2)), "uint16": (16, (2,) * 8),
             "uint32": (20, (5, 5, 5, 5))}


@pytest.fixture(scope="module")
def jax_params():
    return jax_build_model(jax_get_config("olmo-1b").reduced(**REDUCED)).init(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def olmo_progs(jax_params):
    return _progs(jax.tree.map(np.asarray, jax_params))


def cuts(n: int, seed: int) -> list[int]:
    """Seeded ragged chunk boundaries over n bytes: chunks of 1 byte to
    4 KB, a few single bytes among them."""
    rng = np.random.default_rng(seed)
    out, pos = [], 0
    while pos < n:
        pos = min(n, pos + int(rng.choice([1, rng.integers(1, 4096)], p=[0.1, 0.9])))
        out.append(pos)
    return out


def feed(client, blob: bytes, seed: int = 0, start: int = 0) -> None:
    """Feed ``blob[start:]`` in seeded ragged chunks."""
    pos = start
    for end in cuts(len(blob) - start, seed):
        client.feed(blob[pos:start + end])
        pos = start + end


def recording(cls, **kw):
    """A client that records its store's fingerprint at every stage."""
    fps: list = []
    client = cls(on_stage_complete=lambda s: fps.append((s, client.store.fingerprint())),
                 **kw)
    return client, fps


def state_of(client) -> dict:
    """What a transport sees of a client."""
    return {"stages": client.stages_complete, "complete": client.complete,
            "nacks": client.nacks, "log": client.quarantine_log,
            "cursor": tuple(client.resume_cursor), "header_failed": client.header_failed,
            "duplicates": client.duplicate_units, "fed": client.bytes_fed,
            "fingerprint": client.store.fingerprint() if client.store else None}


# ---------------------------------------------------------------------------
# cross-decode: each package decodes the other's stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["v1", "v2_interleaved_entropy", "v3"])
def test_cross_decode_fingerprints_every_stage(olmo_progs, kind):
    jprog, prog = olmo_progs
    jblob, blob = encode_both(jprog, prog, kind)
    client, fps = recording(ProgressiveClient, device="cpu")
    jclient, jfps = recording(JClient)
    feed(client, jblob, seed=1)
    feed(jclient, blob, seed=1)
    assert client.complete and jclient.complete
    assert fps == jfps and len(fps) == prog.n_stages
    assert state_of(client) == state_of(jclient)
    if kind != "v2_interleaved_entropy":
        # the uniform streams' stages are the in-memory receiver's stages
        state = ReceiverState.init(prog, device="cpu")
        for s, fp in fps:
            state = state.receive(prog.stage(s))
            assert state.store.fingerprint() == fp


def test_one_byte_feeds_and_buffer_trimming(olmo_progs):
    """Feeding one byte at a time reaches the same store; the client keeps
    only unconsumed bytes while ``bytes_fed`` counts every byte."""
    jprog, prog = olmo_progs
    _, blob = encode_both(jprog, prog, "v1")
    blob = blob[:40_000]
    client, jclient = ProgressiveClient(device="cpu"), JClient()
    for i in range(len(blob)):
        client.feed(blob[i:i + 1])
    jclient.feed(blob)
    assert state_of(client) == state_of(jclient)
    assert len(client._buf) < 4096 < client.bytes_fed == len(blob)


# ---------------------------------------------------------------------------
# v3: verify before ingest, quarantine, repair, resume
# ---------------------------------------------------------------------------

def _unit_span(blob: bytes, seq: int) -> tuple[int, int]:
    meta, hdr = wire.decode_header(blob)
    layout = wire.layout_from_header(meta, hdr)
    sizes = [e[2] for st in layout.stages for e in st]
    o = layout.unit_offsets()[seq]
    return o, o + sizes[seq]


def test_v3_flipped_unit_is_quarantined_and_repaired_as_the_reference(olmo_progs):
    jprog, prog = olmo_progs
    _, blob = encode_both(jprog, prog, "v3")
    meta, _ = wire.decode_header(blob)
    seq = meta["checkpoints"][1] + 3          # a unit of stage 3
    o, e = _unit_span(blob, seq)
    mut = bytearray(blob)
    mut[o + (e - o) // 2] ^= 0x20
    clean, fps = recording(ProgressiveClient, device="cpu")
    feed(clean, blob, seed=2)
    client, jclient = ProgressiveClient(device="cpu"), JClient()
    feed(client, bytes(mut), seed=2)
    feed(jclient, bytes(mut), seed=2)
    got = state_of(client)
    assert got == state_of(jclient)
    assert got["stages"] == 2 and list(got["nacks"]) == [seq]
    assert "CRC mismatch" in got["log"][0]["reason"]
    assert got["fingerprint"] == fps[1][1]        # held at stage 2
    # a corrupt repair stays quarantined, a clean one converges
    for c in (client, jclient):
        assert not c.feed_repair(seq, bytes(mut[o:e]))
    assert state_of(client) == state_of(jclient)
    for c in (client, jclient):
        assert c.feed_repair(seq, blob[o:e])
        assert c.feed_repair(seq, blob[o:e])      # a duplicate
    got = state_of(client)
    assert got == state_of(jclient)
    assert got["complete"] and not got["nacks"] and got["duplicates"] == 1
    assert got["fingerprint"] == fps[-1][1]


def test_v3_flipped_header_byte_fails_the_header_as_the_reference(olmo_progs):
    jprog, prog = olmo_progs
    _, blob = encode_both(jprog, prog, "v3")
    _, hdr = wire.decode_header(blob)
    client, jclient = ProgressiveClient(device="cpu"), JClient()
    for i in (2, 9, hdr // 2, hdr - 2):
        mut = bytearray(blob[:hdr + 100])
        mut[i] ^= 0x01
        client.feed(bytes(mut))
        jclient.feed(bytes(mut))
        assert state_of(client) == state_of(jclient), i
    assert [e["target"] for e in client.quarantine_log] == ["header"] * 4
    feed(client, blob, seed=3)
    feed(jclient, blob, seed=3)
    got = state_of(client)
    assert got == state_of(jclient) and got["complete"]


def test_v3_sequence_mismatch_truncation_and_rewind(olmo_progs):
    jprog, prog = olmo_progs
    _, blob = encode_both(jprog, prog, "v3")
    meta, hdr = wire.decode_header(blob)
    o, e = _unit_span(blob, 0)
    wrong = wire.frame_unit(5, wire.encode_unit(prog, *meta["units"][0]))
    client, jclient = ProgressiveClient(device="cpu"), JClient()
    cut = _unit_span(blob, 12)[0] + 7             # mid-unit 12
    for c in (client, jclient):
        c.feed(blob[:o] + wrong + blob[e:cut])
    assert state_of(client) == state_of(jclient)
    assert "sequence mismatch" in client.nacks[0]
    assert client.drop_unconsumed() == jclient.drop_unconsumed() == 7
    assert client.rewind_to_gap() == jclient.rewind_to_gap() == (0, hdr)
    for c in (client, jclient):
        c.feed(blob[hdr:])
    got = state_of(client)
    assert got == state_of(jclient) and got["complete"] and got["duplicates"] == 11


def test_v3_fuzzed_streams_match_the_reference():
    """Random flips and truncations of a small v3 stream: the port's
    client never raises and ends in the reference client's state."""
    jprog, prog = _progs(_small_tree())
    jblob, blob = encode_both(jprog, prog, "v3")
    assert blob == jblob
    rng = np.random.default_rng(0)
    for trial in range(40):
        mut = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            mut[int(rng.integers(0, len(mut)))] ^= int(rng.integers(1, 256))
        if rng.random() < 0.5:
            mut = mut[:int(rng.integers(0, len(mut)))]
        client, jclient = ProgressiveClient(device="cpu"), JClient()
        client.feed(bytes(mut))
        jclient.feed(bytes(mut))
        assert state_of(client) == state_of(jclient), trial


def test_parts_left_for_later_raise():
    """A sharded store is still to be ported; materializing before the
    header arrives raises the reference's error (float leaves are ported:
    ``tests/test_torch_resident_fp.py``)."""
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        ProgressiveClient(mesh=object(), device="cpu")
    with pytest.raises(RuntimeError, match="header not received"):
        ProgressiveClient(device="cpu").materialize()
    with pytest.raises(RuntimeError, match="header not received"):
        WireStoreReceiver(ProgressiveClient(device="cpu"), None).materialize()


# ---------------------------------------------------------------------------
# serving from wire bytes
# ---------------------------------------------------------------------------

def _stage_ends(blob: bytes) -> list[int]:
    """Byte offset at which each stage of the stream is complete."""
    meta, hdr = wire.decode_header(blob)
    layout = wire.layout_from_header(meta, hdr)
    ends, pos = [], hdr
    for n in layout.stage_bytes:
        pos += n
        ends.append(pos)
    return ends


@pytest.mark.parametrize("container", sorted(SCHEDULES))
def test_wire_fed_server_tokens_match_the_reference_every_stage(jax_params, container):
    bits, widths = SCHEDULES[container]
    n_stages = len(widths)
    steps = 2 * n_stages + 2
    arrivals = set(range(2, 2 * n_stages, 2))
    jcfg = jax_get_config("olmo-1b").reduced(**REDUCED)
    cfg = get_config("olmo-1b").reduced(**REDUCED)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), device="cpu")
    jprog = jax_divide(jax_params, JUniformPolicy(schedule=JPlaneSchedule(bits, widths)))
    prog = divide(params, UniformPolicy(schedule=PlaneSchedule(bits, widths)))
    blob = wire.encode(prog, integrity=True)
    assert blob == jwire.encode(jprog, integrity=True)
    ends = _stage_ends(blob)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    max_len = 8 + steps

    client, jclient = ProgressiveClient(device="cpu"), JClient()
    srv = ProgressiveServer(model, prog, max_len, resident="quantized", device="cpu",
                            receiver=WireStoreReceiver(client, prog))
    jsrv = JServer(jmodel, jprog, max_len, resident="quantized",
                   receiver=JWireStoreReceiver(jclient, jprog))
    # divide counted its plane_extract launches (the reference's divide
    # runs eq. 3 in jnp and counts none)
    ops.reset_launch_counts()
    jops.reset_launch_counts()
    fed = {}

    def arrive(c):
        def step(i):
            if i not in arrivals:
                return False
            s = c.stages_complete
            feed(c, blob[:ends[s]], seed=10 + s, start=fed[c])
            fed[c] = ends[s]
            assert c.stages_complete == s + 1
            return True
        return step

    for c in (client, jclient):
        feed(c, blob[:ends[0]], seed=10)
        fed[c] = ends[0]
    srv.receive_stage()
    jsrv.receive_stage()
    with pytest.raises(RuntimeError, match="no new stage"):
        srv.receive_stage()
    srv.start({"tokens": tokens})
    jsrv.start({"tokens": jnp.asarray(tokens)})
    res = srv.decode(steps, stage_arrival=arrive(client))
    jres = jsrv.decode(steps, stage_arrival=arrive(jclient))
    # the client ORs each stage once; the wire-fed server ORs nothing itself
    assert ops.LAUNCH_COUNTS["plane_or_segments"] == \
        jops.LAUNCH_COUNTS["plane_or_segments"] == n_stages
    assert res.upgrades == jres.upgrades
    assert res.stage_at_step == jres.stage_at_step
    assert res.stage_at_step[-1] == n_stages
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jres.tokens))
    assert srv.resident_report() == jsrv.resident_report()
    assert srv.resident_report()["fp_bytes"] == 0
    assert srv._receiver.transport_health() == jsrv._receiver.transport_health()
    # the same tokens and store as the pull-mode server of the same planes
    pull = ProgressiveServer(model, prog, max_len, resident="quantized", device="cpu")
    pull.receive_stage()
    pull.start({"tokens": tokens})
    pres = pull.decode(steps, stage_arrival=lambda i: i in arrivals)
    assert pres.upgrades == res.upgrades
    np.testing.assert_array_equal(res.tokens.numpy(), pres.tokens.numpy())
    assert client.store.fingerprint() == jclient.store.fingerprint() \
        == pull.state.store.fingerprint()
