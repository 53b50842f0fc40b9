"""Payload accounting and calibrated transmission schedules against the
JAX package's, on the CPU.

Reduced olmo-1b (2 layers, d_model 64; the JAX init converted through
numpy) and the reference's own small tree. Held exactly:

* payload bytes (``stage_payload_bytes`` and its siblings,
  ``PlaneSchedule.payload_bytes``, ``QuantizedTensor.nbytes_payload``,
  ``plane_payload_bytes``), ``schedule_from_stages``, ``_convexify`` and
  ``_checkpoints_at``;
* ``build_schedule`` from the same gains: identical units and
  checkpoints; ``weight_sse_schedule``: an identical schedule (its float64
  torch sweep gives the reference's numpy sweep's units);
* ``measure_plane_gains`` and ``greedy_schedule`` under a float64 numpy
  weighted-MSE loss (the reference test's loss): identical gains and
  schedules, since the float leaves are byte-equal; the greedy ladder's
  trimmed leaf cache computes each (tensor, level) leaf once and never
  holds more than two levels of a tensor;
* under a loss on the model's logits, the marginal gains agree within
  ``GAIN_ATOL``: the two prefills' float32 sums differ in order only.
"""
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import calibrate as jcal
from repro.core.bitplanes import PlaneSchedule as JSchedule
from repro.core.plane_store import PlaneStore as JPlaneStore
from repro.core.policy import schedule_from_stages as jax_schedule_from_stages
from repro.core.progressive import divide as jax_divide
from repro.core.progressive import rebuild_params as jax_rebuild_params
from repro.core.quantize import quantize as jax_quantize
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core import calibrate as cal
from repro_torch.core.bitplanes import PlaneSchedule
from repro_torch.core.plane_store import PlaneStore
from repro_torch.core.policy import UniformPolicy, schedule_from_stages
from repro_torch.core.progressive import divide, rebuild_params
from repro_torch.core.quantize import quantize
from repro_torch.interop import params_from_numpy
from repro_torch.models.model import build_model

REDUCED = dict(n_layers=2, d_model=64, d_ff=128, vocab=128, n_heads=2, n_kv=2)
# marginal gains under the logits loss: the losses agree to ~1e-6 (float32
# prefills summing in other orders), a gain is a difference of two
GAIN_ATOL = 2e-5


@pytest.fixture(scope="module")
def olmo():
    jcfg = jax_get_config("olmo-1b").reduced(**REDUCED)
    cfg = get_config("olmo-1b").reduced(**REDUCED)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, model, jax_divide(jparams), divide(params)


@pytest.fixture(scope="module")
def small():
    """The reference test's tree, made with numpy."""
    rng = np.random.default_rng(7)
    tree = {"big": rng.standard_normal((16, 8)).astype(np.float32),
            "small": rng.standard_normal((5,)).astype(np.float32),
            "scalar": np.float32(1.25)}
    return jax_divide(jax.tree.map(jnp.asarray, tree)), \
        divide(params_from_numpy(tree, device="cpu"))


def _name(key) -> tuple:
    """A leaf key of either package as a tuple of strings."""
    return tuple(getattr(k, "key", k) for k in key)


def _same_schedule(got, want):
    assert got.units == tuple(want.units)
    assert got.checkpoints == tuple(want.checkpoints)


# ---------------------------------------------------------------------------
# payload accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("widths", [(2,) * 8, (1, 3, 12), (16,)])
def test_payload_bytes_equal_reference(olmo, small, widths):
    for jprog, prog in (olmo[2:], small):
        for s in range(1, prog.n_stages + 1):
            assert prog.stage_payload_bytes(s) == jprog.stage_payload_bytes(s)
        assert prog.total_payload_bytes() == jprog.total_payload_bytes()
        assert prog.singleton_payload_bytes() == jprog.singleton_payload_bytes()
        assert prog.padding_overhead_bound() == jprog.padding_overhead_bound()
        assert 0 <= prog.total_payload_bytes() - prog.singleton_payload_bytes() \
            <= prog.padding_overhead_bound()
    sched, jsched = PlaneSchedule(16, widths), JSchedule(16, widths)
    for n in (0, 1, 7, 1000, 50304 * 2048):
        for upto in (None, 1, len(widths)):
            assert sched.payload_bytes(n, upto) == jsched.payload_bytes(n, upto)
    for shape in ((), (5,), (7, 9), (3, 5, 11)):
        assert cal.plane_payload_bytes(shape, 3) == jcal.plane_payload_bytes(shape, 3)
    x = np.random.default_rng(0).standard_normal((13, 7)).astype(np.float32)
    for bits in (3, 8, 16, 20):
        assert quantize(torch.from_numpy(x), bits).nbytes_payload == \
            jax_quantize(jnp.asarray(x), bits).nbytes_payload
    assert schedule_from_stages(16, (2, 4, 16)) == PlaneSchedule(16, (2, 2, 12))
    for stage_bits in ((2, 4, 6, 8, 10, 12, 14, 16), (1, 4, 16), (16,)):
        got, want = schedule_from_stages(16, stage_bits), \
            jax_schedule_from_stages(16, stage_bits)
        assert (got.bits, got.widths) == (want.bits, want.widths)


def test_convexify_and_checkpoints_equal_reference():
    rng = np.random.default_rng(3)
    for _ in range(200):
        n = int(rng.integers(1, 10))
        gains = list(rng.exponential(1.0, n) * rng.integers(0, 2, n))
        costs = list(rng.integers(1, 100, n))
        assert cal._convexify(gains, costs) == jcal._convexify(gains, costs)
        unit_bytes = list(rng.integers(1, 50, int(rng.integers(1, 30))))
        targets = sorted(rng.integers(0, 2 * sum(unit_bytes), int(rng.integers(1, 9))))
        assert cal._checkpoints_at(unit_bytes, targets) == \
            jcal._checkpoints_at(unit_bytes, targets)


# ---------------------------------------------------------------------------
# schedule construction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_checkpoints", [None, 3])
def test_build_schedule_from_reference_gains(olmo, small, seed, n_checkpoints):
    rng = np.random.default_rng(seed)
    for jprog, prog in (olmo[2:], small):
        counts = [t.plan.schedule.n_planes for t in prog.tensors]
        gains = {i: list(rng.exponential(1.0, n)) for i, n in enumerate(counts)}
        if seed % 3 == 0:       # reward LSBs: forces bundle merging
            gains = {i: g[::-1] for i, g in gains.items()}
        got = cal.build_schedule(prog, gains, n_checkpoints=n_checkpoints)
        _same_schedule(got, jcal.build_schedule(jprog, gains, n_checkpoints=n_checkpoints))
        got.validate(counts)


def test_weight_sse_schedule_identical(olmo, small):
    for jprog, prog in (olmo[2:], small):
        want = jcal.weight_sse_schedule(jprog)
        # the torch float64 sweep orders the units as the numpy sweep
        _same_schedule(cal.weight_sse_schedule(prog), want)
        _same_schedule(cal.weight_sse_schedule(prog, n_checkpoints=5),
                       jcal.weight_sse_schedule(jprog, n_checkpoints=5))


def _mse_losses(jprog, prog):
    """The reference test's weighted-MSE calibration loss, in float64 numpy,
    for each package's leaves (keys differ in type only)."""
    store = PlaneStore.from_model(prog, device="cpu")
    for s in range(1, prog.n_stages + 1):
        store.ingest(prog.stage(s))
    refs = {_name(k): np.asarray(v, np.float64) for k, v in store.materialize_leaves().items()}
    weights = {k: float(10.0 ** (i % 5 - 2)) for i, k in enumerate(sorted(refs))}

    def loss(leaves):
        return sum(weights[_name(k)] * float(np.mean((np.asarray(v, np.float64)
                                                     - refs[_name(k)]) ** 2))
                   for k, v in leaves.items())

    return loss, loss


def test_marginal_gains_and_schedule_identical_under_mse(olmo, small):
    for jprog, prog in (olmo[2:], small):
        jloss, loss = _mse_losses(jprog, prog)
        gains = cal.measure_plane_gains(prog, loss)
        assert gains == jcal.measure_plane_gains(jprog, jloss)
        _same_schedule(cal.calibrate_schedule(prog, loss, method="marginal"),
                       jcal.calibrate_schedule(jprog, jloss, method="marginal"))
        _same_schedule(cal.build_schedule(prog, gains),
                       jcal.calibrate_schedule(jprog, jloss, method="marginal"))


def test_greedy_schedule_identical_with_trimmed_leaf_cache(olmo, small, monkeypatch):
    """The greedy ladder drops a tensor's leaves below its level: each
    (key, level) leaf is computed once, at most two levels of a key are
    alive at any evaluation, and the schedule is the reference's (which
    keeps every level)."""
    made: list = []
    real = cal._truncated_leaf

    def counted(store, idxs, bits):
        leaf = real(store, idxs, bits)
        made.append((store.slots[idxs[0]].key, weakref.ref(leaf)))
        return leaf

    monkeypatch.setattr(cal, "_truncated_leaf", counted)
    for jprog, prog in (olmo[2:], small):
        made.clear()
        jloss, loss = _mse_losses(jprog, prog)
        most = [0]

        def watched(leaves):
            alive: dict = {}
            for key, ref in made:
                if ref() is not None:
                    alive[key] = alive.get(key, 0) + 1
            most[0] = max([most[0], *alive.values()])
            return loss(leaves)

        got = cal.greedy_schedule(prog, watched)
        _same_schedule(got, jcal.greedy_schedule(jprog, jloss))
        _same_schedule(cal.calibrate_schedule(prog, loss), got)
        keys = {t.path for t in prog.tensors}
        levels = prog.tensors[0].plan.schedule.n_planes + 1
        assert len(made) >= len(keys) * levels
        assert len({(k, id(r)) for k, r in made}) == len(made)
        assert most[0] <= 2, most[0]


def test_marginal_gains_agree_under_a_logits_loss(olmo):
    """The loss is the cross-entropy of the prompts' last logits against
    the full model's greedy next tokens."""
    jmodel, model, jprog, prog = olmo
    tokens = np.random.default_rng(5).integers(0, REDUCED["vocab"], (2, 12)).astype(np.int32)
    jprefill = jax.jit(lambda p: jmodel.prefill(p, {"tokens": jnp.asarray(tokens)})[0])

    def logits_np(p, prefill_fn):
        return np.asarray(prefill_fn(p), np.float64)

    def make(prefill_fn, rebuild, m):
        target = None

        def loss(leaves):
            # measure_plane_gains evaluates the full model first: its greedy
            # tokens are the targets
            nonlocal target
            z = logits_np(rebuild(m, leaves), prefill_fn)
            if target is None:
                target = z.argmax(-1)
            z = z - z.max(-1, keepdims=True)
            logp = z - np.log(np.exp(z).sum(-1, keepdims=True))
            return float(-logp[np.arange(len(target)), target].mean())

        return loss

    loss = make(lambda p: model.prefill(p, {"tokens": torch.from_numpy(tokens)})[0].numpy(),
                rebuild_params, prog)
    jloss = make(jprefill, jax_rebuild_params, jprog)
    gains = cal.measure_plane_gains(prog, loss)
    jgains = jcal.measure_plane_gains(jprog, jloss)
    assert sorted(gains) == sorted(jgains)
    worst = max(abs(a - b) for i in gains for a, b in zip(gains[i], jgains[i]))
    assert worst <= GAIN_ATOL, worst
    assert max(max(g) for g in gains.values()) > 100 * GAIN_ATOL


def test_calibrated_schedules_validate_msb_first(olmo):
    _, _, jprog, prog = olmo
    counts = [t.plan.schedule.n_planes for t in prog.tensors]
    for sched in (cal.weight_sse_schedule(prog),
                  cal.calibrate_schedule(prog, _mse_losses(jprog, prog)[1], method="marginal")):
        sched.validate(counts)
        assert sched.n_stages == prog.n_stages
    with pytest.raises(ValueError, match="unknown calibration method"):
        cal.calibrate_schedule(prog, lambda leaves: 0.0, method="nope")
    uni = divide(params_from_numpy({"w": np.ones((4, 4), np.float32)}, device="cpu"),
                 UniformPolicy(schedule=PlaneSchedule(8, (4, 4))))
    with pytest.raises(ValueError, match="gains"):
        cal.build_schedule(uni, {0: [1.0]})


def test_jax_store_agrees(olmo):
    """The full store calibration builds is the reference's, bit for bit."""
    _, _, jprog, prog = olmo
    store = cal._full_store(prog)
    jstore = JPlaneStore.from_model(jprog)
    for s in range(1, jprog.n_stages + 1):
        jstore.ingest(jprog.stage(s))
    assert store.fingerprint() == jstore.fingerprint()
