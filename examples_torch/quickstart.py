"""Quickstart: the paper's whole pipeline on the PyTorch port.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cuda|cpu]

1. build a model, 2. divide it into bit-plane stages (server side),
3. stream it over a simulated 1 MB/s link, 4. run inference at every
precision stage as it arrives (client side). Last, check the paper's
claim that the 16-bit stage is exactly the singleton quantized model:
every leaf the client holds after stage 8 equals
``dequantize(quantize(leaf, 16))``, bit for bit (``SystemExit`` if not).

The port's counterpart of ``examples/quickstart.py``, with the same steps
and lines. The model is reduced olmo-1b, as there; the full-width model
runs the same path on the card in ``chip_smoke.py``. ``--device`` is
``cuda`` by default and raises without a card; ``--device cpu`` runs
every kernel's plain version. The weights come from a ``torch.Generator``
seeded 0 on the host, the same on every device (the reference draws
``jax.random.PRNGKey(0)``); ``main(params=)`` takes a numpy tree instead,
so a test can pass the reference's.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.core.progressive import (divide, tree_flatten_with_path, tree_skeleton,
                                          tree_unflatten)
from repro_torch.core.quantize import dequantize, quantize
from repro_torch.interop import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.transmission.client import ProgressiveClient
from repro_torch.transmission.simulator import Link, simulate_transfer

CHUNK = 64 * 1024
LINK_BYTES_PER_S = 1e6


def main(argv: list[str] | None = None, *, params=None) -> dict:
    """Run the quickstart; returns what it printed: ``blob_bytes``,
    ``n_stages``, ``singleton_bytes``, ``download_s``, ``stages`` (one
    ``(t_s, stage, bits)`` a line) and ``logits`` (each stage's full
    logits, on the host)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. a model (reduced = seconds-fast dims)
    cfg = get_config("olmo-1b").reduced()
    model = build_model(cfg)
    if params is None:
        # drawn on the host, so every device holds the same weights
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
    params = params_from_numpy(params, device=device)

    # 2. server side: quantize (eq. 2) + bit-divide (eq. 3) + serialize
    prog = divide(params)  # paper default: 16 bits as 8 x 2-bit planes
    blob = wire.encode(prog)
    print(f"serialized: {len(blob) / 1e6:.2f} MB in {prog.n_stages} stages "
          f"(singleton 16-bit payload would be "
          f"{prog.singleton_payload_bytes() / 1e6:.2f} MB — no size increase)")

    # 3. the link: when does each byte arrive at 1 MB/s?
    link = Link(bandwidth_bytes_per_s=LINK_BYTES_PER_S)
    events = simulate_transfer([("model", len(blob))], link)
    print(f"full download takes {events[-1].end_s:.1f}s — but we don't wait:")

    # 4. client side: feed the byte stream; infer at each completed stage
    batch = {"tokens": torch.arange(16, dtype=torch.int32, device=device)[None, :]}
    client = ProgressiveClient(device=device)
    leaves = tree_flatten_with_path(params)
    out = {"blob_bytes": len(blob), "n_stages": prog.n_stages,
           "singleton_bytes": prog.singleton_payload_bytes(), "download_s": events[-1].end_s,
           "stages": [], "logits": {}}
    printed = 0
    with torch.no_grad():
        for off in range(0, len(blob), CHUNK):
            client.feed(blob[off:off + CHUNK])
            new_stage = client.stages_complete
            if new_stage and printed < new_stage:
                printed = new_stage
                flat = client.materialize()
                approx = tree_unflatten(tree_skeleton(params), {
                    p: flat[wire.path_str(p)].reshape(leaf.shape).to(leaf.dtype)
                    for p, leaf in leaves})
                logits, _ = model.forward(approx, batch)
                t = events[0].start_s + (off + CHUNK) / LINK_BYTES_PER_S
                bits = 2 * new_stage
                print(f"  t={t:5.2f}s  stage {new_stage} ({bits:2d} bits/weight): "
                      f"logits[0,-1,:4] = {logits[0, -1, :4].cpu().numpy()}")
                out["stages"].append((t, new_stage, bits))
                out["logits"][new_stage] = logits.cpu()

        # the 16-bit stage against the singleton quantized model
        flat = client.materialize()
        for p, leaf in leaves:
            want = dequantize(quantize(leaf, 16))
            if not torch.equal(flat[wire.path_str(p)].reshape(leaf.shape), want):
                raise SystemExit(f"FAIL: {wire.path_str(p)} after stage {printed} differs "
                                 f"from the singleton quantized model")
    print("done — the 16-bit stage equals the singleton quantized model exactly")
    return out


if __name__ == "__main__":
    main()
