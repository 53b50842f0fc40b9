"""Progressive serving launcher: cold-start a server from bit-plane
stages arriving over a simulated link and decode while precision climbs.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --scenario pod-coldstart
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --reduced \\
        --device cpu --scenario browser-lte-handoff --seed 1 \\
        --event-log artifacts/serve.jsonl

Counterpart of ``src/repro/launch/serve.py``, with its flags and
``--device`` (default ``cuda``; ``cpu`` runs every kernel's plain
version). The whole run is a co-simulation :class:`Session`: real
``wire`` bytes stream through the bandwidth trace in transport chunks
into the real ``ProgressiveClient``/PlaneStore, and the server decodes
from that same store, upgrading in place between decode steps exactly
when the link delivered each stage.

Weights come from ``Model.init`` with a seeded ``torch.Generator``, the
prompts from another, so a run is the same for the same seed on one
device. The engines run eagerly: no graph is captured yet (ROADMAP Next
2). ``--mesh-shards N`` serves from a store split over N devices
(``launch/mesh.py``): N cards with ``--device cuda`` (``cuda:0`` the
home), N logical shards of the host with ``--device cpu`` (the
counterpart of XLA's forced host devices); on logical shards tokens
equal the unsharded run's, and a run across cards is not yet checked.
``--arch`` takes the dense decoders (olmo-1b, minitron-4b,
starcoder2-15b, gemma3-27b with its sliding windows), the
mixture-of-experts decoders (mixtral-8x22b, dbrx-132b), the recurrent
ones (xlstm-125m: sLSTM and mLSTM blocks; zamba2-7b: Mamba-2 blocks and
one shared attention block) and the cross-attention ones
(seamless-m4t-medium: an encoder-decoder over ``prompt_len // 4`` frames;
llama-3.2-vision-90b: gated image layers over ``vision_tokens`` image
embeddings) and progressivenet-cnn, each with ``--reduced``. For
progressivenet-cnn, as for the reference launcher, that is the decoder
its ``ArchConfig`` describes (4 layers, d_model 64, vocab 10); the CNN
itself is ``configs/progressivenet_cnn.cnn_init`` and ``cnn_apply``. A
cross-attention arch's memory input is zeros, as the reference launcher
makes it. ``--mesh-shards`` serves every one of these archs (the CNN
itself, ``cnn_apply``, is not an engine's model): a MoE arch's expert
banks split on their expert dim, each shard running its own experts; a
recurrent arch's Mamba-2 ``conv_w`` and sLSTM ``r``, which the
recurrences read elementwise, are gathered whole on the home device
beside the tied embedding (``launch.sharding.GATHERED_LEAVES``); a
cross-attention arch runs its encoder pass or ``vision_proj`` and writes
its cross caches on the home device, every projection sharded. For
xlstm-125m and zamba2-7b ``--speculative`` raises (a recurrent state has
no overwrite-only rollback for rejected drafts). seamless-m4t-medium
refuses ``--pool-clients`` (the pool's
caches have one length, its cross caches the prompt's); the pool admits
llama-3.2-vision-90b at batch 1, but the session's clients send no image
embeddings, so its requests raise as the reference's fail.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import wire
from repro_torch.core.progressive import divide
from repro_torch.launch.mesh import home_device, make_serving_mesh
from repro_torch.models.model import build_model
from repro_torch.transmission import Session, get_scenario, list_scenarios
from repro_torch.transmission.simulator import BandwidthTrace


def _write_event_log(result, event_log: str | None) -> None:
    if not event_log:
        return
    path = Path(event_log)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(result.to_jsonl())
    print(f"event log -> {path}")


def _write_metrics(metrics: str | None) -> None:
    """Dump the telemetry registry: Prometheus text at ``metrics``, the
    structured summary (with spans) as JSON at ``metrics + '.json'``:
    the session's, the client's, the store's, the engines' and the
    kernel entry points' families, as the reference's launcher writes
    them."""
    if not metrics:
        return
    from repro_torch import obs
    from repro_torch.obs.exporters import to_prometheus, to_summary

    path = Path(metrics)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(to_prometheus(obs.get_registry()))
    summary_path = path.with_name(path.name + ".json")
    summary_path.write_text(json.dumps(
        to_summary(obs.get_registry(), obs.get_tracer()), indent=2, sort_keys=True) + "\n")
    print(f"metrics -> {path} (+ {summary_path.name})")


def _verify_fault_recovery(result, blob, model, prog, batch, *, device, mesh=None,
                           decode_steps: int = 8) -> None:
    """The lossy run's acceptance check: after the transport converged,
    the client's store must be bit-identical to a clean stream's, and a
    fresh final-stage decode must emit the same tokens. Raises
    SystemExit on divergence."""
    from repro_torch.serving.engine import ProgressiveServer, WireStoreReceiver
    from repro_torch.transmission import ProgressiveClient

    t = result.transport
    print(f"transport: injected={t['injected']} "
          f"quarantined={t['quarantined']} repaired={t['repaired_units']} "
          f"reconnects={t['reconnects']} duplicates={t['duplicate_units']}")
    if result.client.nacks or not result.client.complete:
        raise SystemExit(
            f"FAIL: transport did not converge (stages "
            f"{result.client.stages_complete}, nacks {result.client.nacks})")
    clean = ProgressiveClient(mesh=mesh, device=device)
    clean.feed(blob)
    clean.materialize()
    result.client.materialize()
    fp_clean = clean.store.fingerprint()
    fp_lossy = result.client.store.fingerprint()
    if fp_clean != fp_lossy:
        raise SystemExit(
            f"FAIL: store diverged from the clean stream: {fp_lossy} != {fp_clean}")

    def final_tokens(client):
        srv = ProgressiveServer(
            model, prog, max_len=int(batch["tokens"].shape[1]) + decode_steps,
            receiver=WireStoreReceiver(client, prog), mesh=mesh, device=device)
        while srv.stage < client.stages_complete:
            srv.receive_stage()
        srv.start(batch)
        return srv.decode(decode_steps).tokens.cpu().numpy()

    a, b = final_tokens(clean), final_tokens(result.client)
    if not np.array_equal(a, b):
        raise SystemExit(f"FAIL: final-stage tokens diverged:\n{a}\n{b}")
    print(f"fault recovery verified: store bit-identical to clean stream, "
          f"final-stage tokens identical over {decode_steps} steps")


def build_batch(cfg, batch: int, prompt_len: int, seed: int) -> dict:
    """A (batch, prompt_len) int32 prompt from a seeded generator, on the
    host (the server moves it to its device); an encoder's frames
    (``enc_input``, ``prompt_len // enc_seq_divisor`` of them, at least 1)
    or an image's embeddings (``vision_embeds``) as zeros, as the
    reference launcher makes them."""
    gen = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                                   dtype=torch.int32)}
    mem = cfg.memory_input(prompt_len)
    if mem is not None:
        out[mem[0]] = torch.zeros((batch, *mem[1]), dtype=cfg.dtype)
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the store, the engine and the kernels run (cuda or "
                         "cpu; cpu takes every kernel's plain version)")
    ap.add_argument("--scenario", default=None, choices=list_scenarios(),
                    help="named network scenario (overrides --bandwidth-mbps)")
    ap.add_argument("--trace-csv", default=None,
                    help="bandwidth trace CSV (see benchmarks/traces/)")
    ap.add_argument("--bandwidth-mbps", type=float, default=1.0)
    ap.add_argument("--decode-steps", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resident", default="fp", choices=["fp", "quantized"],
                    help="weight residency: 'fp' re-materializes float weights per "
                         "upgrade; 'quantized' decodes straight from the uint plane "
                         "accumulators (no float weight copy on the device)")
    ap.add_argument("--speculative", action="store_true",
                    help="self-speculative decoding: a truncated-bits view of the "
                         "same accumulators drafts, the full view verifies whole "
                         "draft blocks in one pass; token-identical to plain greedy, "
                         "zero extra weight bytes (implies quantized residency)")
    ap.add_argument("--draft-bits", type=int, default=4,
                    help="draft view precision for --speculative")
    ap.add_argument("--draft-k", type=int, default=None,
                    help="fixed draft length for --speculative "
                         "(default: adaptive from the acceptance rate)")
    ap.add_argument("--pool-clients", type=int, default=0,
                    help="> 0: continuous-batching mode: this many clients join "
                         "mid-download (flash crowd) and are served by one slot "
                         "pool instead of a single lock-stepped stream")
    ap.add_argument("--chunked-prefill", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="force chunked admission on/off for the pool (default: auto "
                         "— on for every arch without cross-attention; a vision arch "
                         "admits at batch 1 and refuses --chunked-prefill)")
    ap.add_argument("--pool-slots", type=int, default=4,
                    help="slot-pool size for --pool-clients")
    ap.add_argument("--crowd-span-s", type=float, default=1.0,
                    help="window after cold start over which the crowd arrives")
    ap.add_argument("--mesh-shards", type=int, default=0,
                    help="> 1: shard the serving stack over this many devices on "
                         "the mesh's model axis: the plane accumulators shard with "
                         "the weights they back (shard-local ingest) and decode runs "
                         "a shard at a time. Needs that many cards with --device cuda "
                         "(cuda:0 .. cuda:N-1; --device must name cuda:0, the mesh's "
                         "home); with --device cpu the shards are logical shards of "
                         "the host (the counterpart of XLA's forced host devices). "
                         "Token-identical to one device at every stage on logical "
                         "shards; a run across cards is not yet checked")
    ap.add_argument("--event-log", default=None,
                    help="write the session's audit log (JSONL) here")
    ap.add_argument("--metrics", default=None,
                    help="enable the telemetry registry for this run and write its "
                         "Prometheus text export here (plus the structured summary "
                         "at <path>.json)")
    ap.add_argument("--faults", action="store_true",
                    help="lossy-channel mode: encode the stream on the v3 integrity "
                         "wire and inject seeded channel faults. Lossy scenarios "
                         "(browser-3g-lossy, edge-flaky) supply their own fault "
                         "profile; other links get a default ~1%% corruption "
                         "profile. After the run the launcher proves recovery: the "
                         "final store must be bit-identical to a clean stream's and "
                         "the final-stage tokens identical to a clean run's")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="seed for the fault profile and retry jitter (default: --seed)")
    args = ap.parse_args(argv)

    if args.metrics:
        from repro_torch import obs

        obs.configure(True)

    device = resolve_device(args.device)
    mesh = None
    if args.mesh_shards > 1:
        # N cards (raising with fewer), or N logical shards of the host
        mesh = make_serving_mesh(args.mesh_shards, devices=[device] * args.mesh_shards
                                 if device.type == "cpu" else None)
        device = home_device(mesh, device)
        print(f"serving mesh: {mesh.describe()}")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed),
                        device=device)
    prog = divide(params)
    del params
    # lossy mode needs the v3 integrity wire so damage is detectable
    blob = wire.encode(prog, integrity=args.faults)
    # from here on the stream carries the planes: the servers read the
    # divided model's metadata only, so its planes (a byte a weight a
    # stage) leave the device before the client's store and float leaves
    # fill it
    prog = dataclasses.replace(prog, tensors=[dataclasses.replace(t, planes=[])
                                              for t in prog.tensors])

    scenario = get_scenario(args.scenario) if args.scenario else None
    if scenario is not None:
        session = Session.from_scenario(blob, scenario, seed=args.seed, device=device)
        link_desc = f"scenario {args.scenario} (seed {args.seed})"
    elif args.trace_csv:
        session = Session(blob, BandwidthTrace.from_csv(args.trace_csv), device=device)
        link_desc = f"trace {args.trace_csv}"
    else:
        session = Session(blob, BandwidthTrace.constant(args.bandwidth_mbps * 1e6),
                          device=device)
        link_desc = f"{args.bandwidth_mbps} MB/s"

    faults = fault_policy = None
    if args.faults:
        from repro_torch.transmission import FaultPolicy, FaultTrace

        fseed = args.seed if args.fault_seed is None else args.fault_seed
        if scenario is not None and scenario.lossy:
            faults = scenario.make_faults(fseed)
        else:
            faults = FaultTrace(seed=fseed, p_corrupt=0.01, p_disconnect=0.002)
        fault_policy = FaultPolicy(seed=fseed)
        print(f"lossy channel: {faults}  (v3 framing overhead "
              f"{wire.framing_overhead(session.meta)['overhead_frac']:.2%})")

    arrivals = session.stage_arrival_times()
    print(f"model bytes={len(blob)}  stages={prog.n_stages}  "
          f"arrivals={[round(a, 2) for a in arrivals]}s over {link_desc}  device={device}")

    if args.pool_clients > 0:
        from repro_torch.transmission import flash_crowd_arrivals

        pool_spec = None
        if args.speculative:
            from repro_torch.serving.speculative import SpecConfig

            pool_spec = SpecConfig(draft_bits=args.draft_bits, k=args.draft_k)
        prompts = [torch.randint(0, cfg.vocab, (args.prompt_len,), dtype=torch.int32,
                                 generator=torch.Generator().manual_seed(1000 + i))
                   for i in range(args.pool_clients)]
        offs = flash_crowd_arrivals(args.seed, args.pool_clients, span_s=args.crowd_span_s)
        result = session.run_serving_pool(
            model, prog, prompts=prompts, arrival_offsets_s=offs,
            max_new_tokens=args.decode_steps, n_slots=args.pool_slots,
            resident=None if pool_spec else args.resident, speculative=pool_spec,
            chunked_prefill=args.chunked_prefill, mesh=mesh, faults=faults,
            fault_policy=fault_policy)
        pool = result.server
        print(f"flash crowd: {args.pool_clients} clients over {args.crowd_span_s}s into "
              f"{args.pool_slots} slots; admissions at "
              f"{[round(t, 2) for t, _ in result.admissions]}s")
        if args.speculative:
            s = result.speculation_summary()
            print(f"speculative pool: {s['rounds']} rounds, {s['accepted']}/{s['drafted']} "
                  f"drafts accepted; extra resident draft bytes: "
                  f"{pool.resident_report()['extra_draft_bytes']}")
        print(f"upgrades (batched step -> stage): {result.upgrades}")
        for rid in sorted(result.tokens):
            print(f"client {rid}: tokens {result.tokens[rid]}")
        print(f"served {sum(len(v) for v in result.tokens.values())} tokens across "
              f"{pool.stage} precision stages, eager (no captured graph); "
              f"{len(result.events)} audited session events")
        if args.faults:
            from repro_torch.transmission import ProgressiveClient

            clean = ProgressiveClient(mesh=mesh, device=device)
            clean.feed(blob)
            clean.materialize()
            result.client.materialize()
            if clean.store.fingerprint() != result.client.store.fingerprint():
                raise SystemExit("FAIL: pool store diverged from the clean stream")
            t = result.transport
            print(f"fault recovery verified (pool): store bit-identical; "
                  f"injected={t['injected']} quarantined={t['quarantined']}")
        _write_event_log(result, args.event_log)
        _write_metrics(args.metrics)
        return

    batch = build_batch(cfg, args.batch, args.prompt_len, seed=1)
    speculative = None
    max_len = args.prompt_len + args.decode_steps
    if args.speculative:
        from repro_torch.serving.speculative import SpecConfig

        speculative = SpecConfig(draft_bits=args.draft_bits, k=args.draft_k)
        # headroom for the final verify block to write past the last
        # emitted token
        max_len += speculative.k_max + 1
    result = session.run_serving(
        model, prog, decode_steps=args.decode_steps, batch=batch, max_len=max_len,
        resident=None if speculative else args.resident, speculative=speculative,
        mesh=mesh, faults=faults, fault_policy=fault_policy)
    server = result.server
    if args.faults:
        _verify_fault_recovery(result, blob, model, prog, batch, device=device, mesh=mesh)
    rep = server.resident_report()
    if args.speculative:
        s = result.speculation_summary()
        print(f"speculative: {s['rounds']} rounds, draft {args.draft_bits} bits, "
              f"acceptance {s['accepted']}/{s['drafted']} ({s['rate']:.0%} of drafted)"
              if s["drafted"] else
              f"speculative: {s['rounds']} rounds (no precision gap yet)")
        print(f"zero-copy draft: extra resident draft bytes = {rep['extra_draft_bytes']} "
              f"({rep['aliased_leaves']} aliased leaves); eager (no captured graph)")
    elif args.resident == "quantized":
        print(f"quantized-resident: {rep['quantized_leaves']} weight leaves on "
              f"{rep['quantized_bytes']} uint bytes, {rep['fp_bytes']} fp bytes "
              f"(non-matmul remainder); eager (no captured graph)")
    else:
        print(f"fp-resident: {rep['fp_leaves']} float leaves on {rep['fp_bytes']} bytes, "
              f"beside {server._receiver.store.resident_bytes()} accumulator bytes; "
              f"eager (no captured graph)")
    print("upgrades (decode step -> stage):", result.upgrades)
    print("stage per step:", result.stage_at_step)
    print("tokens[0]:", [int(t) for t in result.tokens[0][:16]], "...")
    print(f"served {args.decode_steps} steps across {server.stage} precision stages; "
          f"{len(result.events)} audited session events")
    _write_event_log(result, args.event_log)
    _write_metrics(args.metrics)


if __name__ == "__main__":
    main()
