"""The port's wire format against the JAX package's, held exactly.

Bit packing, the entropy codec and the encoded streams (v1, v2 with the
uniform and a hand-built interleaved schedule, entropy coding on and off,
and v3) must be byte-identical to the reference's for the same model;
malformed input must raise the same exception classes with the same
messages. Inputs are made with numpy or come from the JAX init through
numpy, on the CPU.
"""
import dataclasses
import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import bitplanes as jbp
from repro.core import entropy as jentropy
from repro.core import wire as jwire
from repro.core.calibrate import TransmissionSchedule as JSchedule
from repro.core.calibrate import uniform_schedule as jax_uniform_schedule
from repro.core.progressive import divide as jax_divide
from repro.models.model import build_model as jax_build_model
from repro_torch.core import bitplanes, entropy, wire
from repro_torch.core.calibrate import TransmissionSchedule, uniform_schedule
from repro_torch.core.progressive import divide
from repro_torch.interop import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
REDUCED = dict(n_layers=2, d_model=64, d_ff=128, vocab=128, n_heads=2, n_kv=2)


def _small_tree():
    """The tree of ``tests/test_wire_v3.py`` (two weights and a scalar),
    made with numpy."""
    rng = np.random.default_rng(1)
    return {"w1": rng.standard_normal((24, 8)).astype(np.float32),
            "w2": rng.standard_normal((7,)).astype(np.float32),
            "scale": np.float32(2.5)}


def _progs(tree):
    """The JAX and the port's ProgressiveModel of the same numpy tree."""
    jprog = jax_divide(jax.tree.map(jnp.asarray, tree))
    return jprog, divide(params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module")
def olmo_progs():
    jparams = jax_build_model(jax_get_config("olmo-1b").reduced(**REDUCED)).init(
        jax.random.PRNGKey(0))
    return _progs(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def small_progs():
    return _progs(_small_tree())


def interleaved(n_tensors: int, n_planes: int, seed: int):
    """A hand-built schedule: tensor t's plane p ships at rank p + shift_t
    (seeded shifts of 0-2), MSB-first within each tensor, interleaved
    across tensors; one checkpoint every n_tensors units."""
    shift = np.random.default_rng(seed).integers(0, 3, n_tensors)
    units = sorted(((t, p) for t in range(n_tensors) for p in range(n_planes)),
                   key=lambda u: (u[1] + shift[u[0]], u[0]))
    checkpoints = tuple(range(n_tensors, len(units) + 1, n_tensors))
    return tuple(units), checkpoints


# ---------------------------------------------------------------------------
# bit packing and the entropy codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", range(1, 17))
def test_pack_unpack_bits_bytes_exact(width):
    rng = np.random.default_rng(width)
    n = 1000 + width            # leaves a partial byte group for most widths
    values = rng.integers(0, 2 ** width, n).astype(np.uint32)
    want = np.asarray(jbp.pack_bits(jnp.asarray(values), width))
    got = bitplanes.pack_bits(torch.from_numpy(values.astype(np.int64)), width)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = bitplanes.unpack_bits(torch.from_numpy(want.copy()), width, n)
    assert back.dtype == torch.uint32
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jbp.unpack_bits(jnp.asarray(want), width, n)))
    with pytest.raises(ValueError, match="need"):
        bitplanes.unpack_bits(torch.from_numpy(want[:-1].copy()), width, n)


def test_entropy_module_is_the_reference_file():
    """The codec is framework-free numpy, so the port carries a verbatim
    copy of it."""
    ref = (ROOT / "src" / "repro" / "core" / "entropy.py").read_bytes()
    assert (ROOT / "src" / "repro_torch" / "core" / "entropy.py").read_bytes() == ref


def _entropy_payloads():
    """The payloads of ``tests/test_entropy.py``: empty, constant planes,
    every single byte, skewed random bits, incompressible bytes and runs."""
    out = [b"", bytes(range(256)), b"\x00" * 500 + b"\xab", b"\xab" + b"\x00" * 500,
           b"\x01\x02\x03" * 100 + b"\xff" * 300, bytes(range(256)) * 3 + b"\x00" * 64,
           b"\x00\x01" * 200]
    out += [b"\x00" * n for n in (1, 9, 255, 4096)] + [b"\xff" * n for n in (1, 64, 1000)]
    for seed in range(2):
        rng = np.random.default_rng(seed)
        for p in (0.005, 0.05, 0.2, 0.5):
            out.append(np.packbits(rng.random(4096 * 8) < p).tobytes())
        out.append(rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())
    return out


def test_entropy_bytes_match_reference():
    for data in _entropy_payloads():
        mode, body = entropy.encode(data)
        assert (mode, body) == jentropy.encode(data)
        assert entropy.decode(mode, body, len(data)) == data


# ---------------------------------------------------------------------------
# encoded streams: byte-identical
# ---------------------------------------------------------------------------

STREAMS = {
    "v1": dict(),
    "v2_uniform_raw": dict(schedule="uniform"),
    "v2_uniform_entropy": dict(entropy_coded=True),
    "v2_interleaved_raw": dict(schedule="interleaved"),
    "v2_interleaved_entropy": dict(schedule="interleaved", entropy_coded=True),
    "v3": dict(integrity=True),
    "v3_interleaved_entropy": dict(schedule="interleaved", entropy_coded=True,
                                   integrity=True),
}


def encode_both(jprog, prog, kind: str, seed: int = 0) -> tuple[bytes, bytes]:
    """The reference's and the port's stream of one kind (``STREAMS``)."""
    kw = dict(STREAMS[kind])
    jkw = dict(kw)
    if kw.get("schedule") == "uniform":
        kw["schedule"] = uniform_schedule(prog)
        jkw["schedule"] = jax_uniform_schedule(jprog)
    elif kw.get("schedule") == "interleaved":
        units, cps = interleaved(len(prog.tensors), prog.n_stages, seed)
        kw["schedule"] = TransmissionSchedule(units=units, checkpoints=cps)
        jkw["schedule"] = JSchedule(units=units, checkpoints=cps)
    return jwire.encode(jprog, **jkw), wire.encode(prog, **kw)


@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_encode_byte_identical_to_reference(olmo_progs, kind):
    jblob, blob = encode_both(*olmo_progs, kind)
    assert blob == jblob
    meta, hdr = wire.decode_header(blob)
    assert (meta, hdr) == jwire.decode_header(jblob)
    layout = wire.layout_from_header(meta, hdr)
    assert dataclasses.asdict(layout) == dataclasses.asdict(
        jwire.layout_from_header(meta, hdr))
    assert layout.total_bytes == len(blob)
    assert wire.framing_overhead(meta) == jwire.framing_overhead(meta)


def test_small_tree_streams_and_units_byte_identical(small_progs):
    jprog, prog = small_progs
    for kind in ("v1", "v3", "v2_uniform_entropy"):
        jblob, blob = encode_both(jprog, prog, kind)
        assert blob == jblob, kind
    for t in range(len(prog.tensors)):
        for p in range(prog.n_stages):
            assert wire.encode_unit(prog, t, p) == jwire.encode_unit(jprog, t, p)
    assert wire.encode_stage(prog, 3) == jwire.encode_stage(jprog, 3)
    assert wire.encode_header(prog) == jwire.encode_header(jprog)


def test_schedule_validation_and_meta_round_trip(olmo_progs):
    jprog, prog = olmo_progs
    units, cps = interleaved(len(prog.tensors), prog.n_stages, 3)
    sched = TransmissionSchedule(units=units, checkpoints=cps)
    sched.validate([8] * len(prog.tensors))
    assert sched.to_meta() == JSchedule(units=units, checkpoints=cps).to_meta()
    assert TransmissionSchedule.from_meta(sched.to_meta()) == sched
    assert uniform_schedule(prog).to_meta() == jax_uniform_schedule(jprog).to_meta()
    i, j = units.index((0, 0)), units.index((0, 1))
    swapped = list(units)
    swapped[i], swapped[j] = units[j], units[i]
    bad = [TransmissionSchedule(units=units[1:], checkpoints=cps[:-1] + (len(units) - 1,)),
           TransmissionSchedule(units=tuple(swapped), checkpoints=cps),
           TransmissionSchedule(units=units, checkpoints=(cps[1], cps[0]) + cps[2:])]
    for s in bad:
        with pytest.raises(ValueError) as err:
            s.validate([8] * len(prog.tensors))
        with pytest.raises(ValueError) as jerr:
            JSchedule(units=s.units, checkpoints=s.checkpoints).validate(
                [8] * len(prog.tensors))
        assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# malformed input: the reference's exception classes and messages
# ---------------------------------------------------------------------------

def _same_error(fn, jfn, *args, **kw):
    """Call the port's and the reference's function on the same input;
    both must raise the same wire error class with the same message."""
    with pytest.raises(Exception) as err:
        fn(*args, **kw)
    with pytest.raises(Exception) as jerr:
        jfn(*args, **kw)
    assert type(err.value).__name__ == type(jerr.value).__name__
    assert isinstance(err.value, wire.WireFormatError)
    assert str(err.value) == str(jerr.value)
    return err.value


def test_decode_header_error_catalogue(small_progs):
    _, blob = encode_both(*small_progs, "v3")
    bad_ver = bytearray(blob)
    bad_ver[4] = 99
    bad_len = bytearray(blob)
    struct.pack_into("<I", bad_len, 8, wire.MAX_HEADER_BYTES + 1)
    cases = {"truncated": blob[:7], "bad magic": b"XXXX" + blob[4:],
             "unsupported version": bytes(bad_ver), "length field is corrupt": bytes(bad_len)}
    for match, buf in cases.items():
        e = _same_error(wire.decode_header, jwire.decode_header, buf)
        assert match in str(e)


def test_every_flipped_header_byte_raises_the_reference_error(small_progs):
    _, blob = encode_both(*small_progs, "v3")
    _, hdr = wire.decode_header(blob)
    for i in range(hdr):
        mut = bytearray(blob[:hdr])
        mut[i] ^= 0x01
        _same_error(wire.decode_header, jwire.decode_header, bytes(mut))


def test_unit_verification_and_decode_plane_errors(small_progs):
    jprog, prog = small_progs
    jblob, blob = encode_both(jprog, prog, "v3")
    meta, hdr = wire.decode_header(blob)
    layout = wire.layout_from_header(meta, hdr)
    offs = layout.unit_offsets()
    sizes = [e[2] for st in layout.stages for e in st]
    for seq, (o, n) in enumerate(zip(offs, sizes)):
        got_seq, body = wire.verify_unit(blob[o:o + n])
        assert (got_seq, bytes(body)) == jwire.verify_unit(blob[o:o + n])
        unit = bytearray(blob[o:o + n])
        for i in range(0, n, 3):
            unit[i] ^= 0x40
            _same_error(wire.verify_unit, jwire.verify_unit, bytes(unit))
            unit[i] ^= 0x40
    _same_error(wire.verify_unit, jwire.verify_unit, b"\x00" * 9)
    body = wire.encode_unit(prog, *meta["units"][0])
    assert wire.frame_unit(5, body) == jwire.frame_unit(5, body)
    _same_error(wire.decode_plane, jwire.decode_plane, b"\x00", 1, 8, framed=True)
    _same_error(wire.decode_plane, jwire.decode_plane, b"\xee\x00" + b"\x00" * 4, 1, 8,
                framed=True)
    _same_error(wire.decode_plane, jwire.decode_plane, b"\x00" * 3, 2, 8)


@pytest.mark.parametrize("width", [1, 2, 5, 16])
def test_decode_plane_values(width):
    rng = np.random.default_rng(width)
    n = 77
    values = rng.integers(0, 2 ** width, n).astype(np.uint32)
    payload = np.asarray(jbp.pack_bits(jnp.asarray(values), width)).tobytes()
    for framed in (False, True):
        buf = (b"\x00\x00" + payload) if framed else payload
        got = wire.decode_plane(buf, width, n, framed=framed, device="cpu")
        np.testing.assert_array_equal(got.numpy(), jwire.decode_plane(buf, width, n,
                                                                      framed=framed))
        small = wire.decode_plane(buf, width, n, framed=framed, device="cpu",
                                  dtype=torch.uint16)
        assert small.dtype == torch.uint16
        np.testing.assert_array_equal(small.numpy(), values)
