"""Progressive cold-start serving on the PyTorch port: a pod begins
decoding from the 2-bit planes and upgrades precision in place,
mid-generation, as later planes arrive over a simulated network scenario —
KV cache survives every upgrade (the paper's Fig. 4, pod-side).

The run is a deterministic co-simulation: real wire bytes stream
through the scenario's bandwidth trace into the real client/PlaneStore,
and the server decodes from that same store. Same seed, same tokens,
same event log — on one device.

    PYTHONPATH=src python examples_torch/progressive_serving.py \\
        [--arch mixtral-8x22b] [--scenario browser-lte-handoff] [--seed 0] \\
        [--device cuda|cpu]
    PYTHONPATH=src python examples_torch/progressive_serving.py \\
        --bandwidth-mbps 2.5   # constant link instead of a scenario
    PYTHONPATH=src python examples_torch/progressive_serving.py \\
        --resident quantized   # decode straight from the uint accumulators
    PYTHONPATH=src python examples_torch/progressive_serving.py \\
        --flash-crowd 6        # continuous batching: 6 clients, one pool

``--resident quantized`` serves the whole model from the PlaneStore's
uint accumulators: every matmul runs the fused dequant kernel, no fp
copy of the weights exists on the device, and each precision upgrade is
a metadata refresh (the token stream is identical to --resident fp at
every stage).

``--flash-crowd N`` swaps the lock-stepped stream for the slot-pool
engine: N clients join mid-download at staggered times, each is
admitted into a free slot (its prompt prefilled straight into the
slot's cache region), and every decode step is ONE batched ragged step
over per-slot positions and windows, across all admissions, evictions
and precision upgrades.

``--speculative`` turns the precision ladder into a throughput
multiplier: a truncated-bits view of the *same* accumulators (zero
extra weight bytes) drafts k tokens, the full-received-bits view
verifies the whole block in one pass, and the output stays
token-identical to plain greedy at every stage.

The port's counterpart of ``examples/progressive_serving.py``: its flags
and ``--device`` (``cuda`` by default, raising without a card; ``cpu``
runs every kernel's plain version), the same steps and lines but for the
reference's counts of compiled decode executables (``decode_cache_size``),
which are left out: the port's engines run eagerly and compile nothing,
so there is nothing to count. The model is the arch's ``reduced()``
config, as there; the full-width counterparts run on the card in
``chip_smoke.py``'s ``[session]`` (olmo-1b) and ``[arch mixtral-8x22b
x1]`` phases. The weights come from a ``torch.Generator`` seeded 0 on the
host (the same on every device), the prompt batch from
``launch.serve.build_batch`` and the flash crowd's prompts from
generators seeded 100 + i (the reference draws ``jax.random.PRNGKey``
streams); ``main``'s ``params=`` (a numpy tree), ``batch=`` and
``prompts=`` take other draws, so a test can pass the reference's.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.core.progressive import divide
from repro_torch.interop import params_from_numpy
from repro_torch.launch.serve import _write_event_log, build_batch
from repro_torch.models.model import build_model
from repro_torch.transmission import BandwidthTrace, Session, get_scenario, list_scenarios

B, S = 2, 16


def main(argv: list[str] | None = None, *, params=None, batch=None, prompts=None) -> dict:
    """Serve as the flags say; returns what it printed: ``blob_bytes``,
    ``arrivals``, ``tokens`` (the stream's (B, steps) tokens, or each
    client's list), ``upgrades``, ``stage_at_step`` (the stream) or
    ``stage_log`` and ``admissions`` (the crowd), ``n_events``, ``jsonl``
    (the audit log), ``final_stage``, and ``speculation`` and ``resident``
    where printed."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--scenario", default="browser-lte-handoff",
                    choices=list_scenarios())
    ap.add_argument("--bandwidth-mbps", type=float, default=None,
                    help="use a constant link instead of --scenario")
    ap.add_argument("--decode-steps", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resident", default="fp", choices=["fp", "quantized"],
                    help="'quantized' serves from the uint plane accumulators: no fp "
                         "weight copy, metadata-only upgrades, identical tokens")
    ap.add_argument("--speculative", action="store_true",
                    help="self-speculative decoding: the low-bit view of the SAME "
                         "accumulators drafts, the full view verifies whole blocks — "
                         "token-identical to plain greedy, zero extra weight bytes")
    ap.add_argument("--draft-bits", type=int, default=4)
    ap.add_argument("--draft-k", type=int, default=None,
                    help="fixed draft length (default: adaptive)")
    ap.add_argument("--chunked-prefill", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="force chunked admission on/off for the flash-crowd pool "
                         "(default: auto — on for every arch without cross-attention)")
    ap.add_argument("--flash-crowd", type=int, default=0, metavar="N",
                    help="> 0: serve N staggered clients through the continuous-batching "
                         "slot pool instead of one lock-stepped stream")
    ap.add_argument("--scheduled", action="store_true",
                    help="stream the v2 wire: weight-SSE calibrated plane order + "
                         "entropy-coded payloads (decoded transparently by the same "
                         "client/PlaneStore; final weights bit-identical to the v1 "
                         "stream)")
    ap.add_argument("--event-log", default=None,
                    help="write the session audit log (JSONL) here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    if params is None:
        # drawn on the host, so every device serves the same weights
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prog = divide(params_from_numpy(params, device=device))
    if args.scheduled:
        from repro_torch.core.calibrate import weight_sse_schedule

        blob = wire.encode(prog, schedule=weight_sse_schedule(prog), entropy_coded=True)
    else:
        blob = wire.encode(prog)

    if args.bandwidth_mbps is not None:
        session = Session(blob, BandwidthTrace.constant(args.bandwidth_mbps * 1e6),
                          device=device)
        where = f"constant {args.bandwidth_mbps} MB/s"
    else:
        scenario = get_scenario(args.scenario)
        session = Session.from_scenario(blob, scenario, seed=args.seed, device=device)
        where = f"{scenario.name} (seed {args.seed}): {scenario.description}"
    arrivals = session.stage_arrival_times()
    wire_desc = " (scheduled+coded v2 wire)" if args.scheduled else ""
    print(f"{args.arch} (reduced): {len(blob) / 1e6:.2f} MB{wire_desc} over {where}")
    print(f"stage arrivals at {[round(a, 2) for a in arrivals]} s")
    out = {"blob_bytes": len(blob), "arrivals": arrivals}

    if batch is None:
        batch = build_batch(cfg, B, S, seed=1)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}

    if args.flash_crowd > 0:
        from repro_torch.transmission import flash_crowd_arrivals

        pool_spec = None
        if args.speculative:
            from repro_torch.serving.speculative import SpecConfig

            pool_spec = SpecConfig(draft_bits=args.draft_bits, k=args.draft_k)
        n = args.flash_crowd
        if prompts is None:
            prompts = [torch.randint(0, cfg.vocab, (S,), dtype=torch.int32,
                                     generator=torch.Generator().manual_seed(100 + i))
                       for i in range(n)]
        offs = flash_crowd_arrivals(args.seed, n, span_s=1.0)
        res = session.run_serving_pool(
            model, prog, prompts=[torch.as_tensor(p) for p in prompts],
            arrival_offsets_s=offs, max_new_tokens=args.decode_steps, n_slots=min(4, n),
            resident=None if pool_spec else args.resident, speculative=pool_spec,
            chunked_prefill=args.chunked_prefill)
        print(f"flash crowd: {n} clients admitted at "
              f"{[round(t, 2) for t, _ in res.admissions]}s into {min(4, n)} slots"
              + (" (self-speculative rounds)" if args.speculative else ""))
        if args.speculative:
            s = out["speculation"] = res.speculation_summary()
            print(f"speculation: {s['rounds']} pool rounds, "
                  f"{s['accepted']}/{s['drafted']} drafts accepted; extra "
                  f"resident draft bytes: "
                  f"{res.server.resident_report()['extra_draft_bytes']}")
        for rid in sorted(res.tokens):
            print(f"client {rid}: bits "
                  + " ".join(f"{2 * s:2d}" for s in res.server.stage_log[rid])
                  + " | tokens " + " ".join(f"{t:3d}" for t in res.tokens[rid]))
        print(f"\n{len(res.upgrades)} in-place upgrades while the pool was live; "
              f"{len(res.events)} audited events")
        out.update(tokens={rid: list(t) for rid, t in res.tokens.items()},
                   stage_log={rid: list(s) for rid, s in res.server.stage_log.items()},
                   admissions=res.admissions)
    else:
        speculative = None
        max_len = S + args.decode_steps
        if args.speculative:
            from repro_torch.serving.speculative import SpecConfig

            speculative = SpecConfig(draft_bits=args.draft_bits, k=args.draft_k)
            max_len += speculative.k_max + 1
        print(f"cold start at t={arrivals[0]:.2f}s with 2-bit weights "
              f"({'speculative' if args.speculative else args.resident}"
              f"-resident); decoding...")
        res = session.run_serving(model, prog, decode_steps=args.decode_steps,
                                  batch=batch, max_len=max_len,
                                  resident=None if speculative else args.resident,
                                  speculative=speculative)
        tokens = res.tokens.cpu()
        print("decode-step : " + " ".join(f"{i:3d}" for i in range(args.decode_steps)))
        print("bits/weight : " + " ".join(f"{2 * s:3d}" for s in res.stage_at_step))
        print("tokens[0]   : " + " ".join(f"{int(t):3d}" for t in tokens[0]))
        print(f"\n{len(res.upgrades)} in-place upgrades during generation; "
              f"final precision {2 * res.server.stage} bits — no recompile, no KV loss; "
              f"{len(res.events)} audited events")
        if args.speculative:
            s = out["speculation"] = res.speculation_summary()
            rep = res.server.resident_report()
            print(f"speculation: {s['rounds']} rounds; "
                  f"{s['accepted']}/{s['drafted']} drafts accepted; draft view "
                  f"shares every buffer (extra resident draft bytes: "
                  f"{rep['extra_draft_bytes']})")
        if args.resident == "quantized" and not args.speculative:
            rep = out["resident"] = res.server.resident_report()
            print(f"resident weights: {rep['quantized_leaves']} quantized leaves "
                  f"({rep['quantized_bytes']} uint bytes), {rep['fp_leaves']} fp "
                  f"leaves ({rep['fp_bytes']} bytes, non-matmul remainder)")
        out.update(tokens=tokens, stage_at_step=list(res.stage_at_step))
    out.update(upgrades=list(res.upgrades), n_events=len(res.events), jsonl=res.to_jsonl(),
               final_stage=res.server.stage)
    _write_event_log(res, args.event_log)
    return out


if __name__ == "__main__":
    main()
