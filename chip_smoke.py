#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA H100 and hold every
CUDA kernel of those paths against its plain PyTorch version.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero); each path runs
with the launch counts set to 0 just before it and read just after:

1. build every CUDA kernel from ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` per source, all at once;
1a. ``[arch minitron-4b]`` and ``[arch starcoder2-15b x2]``: the dense
   variants (RMSNorm, affine LayerNorm, tanh GELU, ``head_dim``, an
   untied ``lm_head``; GQA at G = 3 and 12) at their published widths,
   minitron-4b at its 32 layers and starcoder2-15b at 2 of its 40, from
   seeded weights: ``divide`` on the card, and an in-memory receiver's
   stage-8 accumulators equal to ``quantize(leaf).q`` of every tensor
   (minitron-4b's flat buffer passes element 2^32); the single stream
   (phase 3's shape) from in-memory planes, then from v3 wire bytes through
   ``ProgressiveClient`` (the store ``torch.equal`` to an in-memory store
   at every stage, fingerprints equal at stage 8, tokens equal); float
   residency on that store against quantized; the pool's 12 requests;
   ``SpeculativeEngine`` at stage 8, tokens equal to plain; B2 on every
   distinct weight shape at M = 1-64 with and without a mask, B3 and B4 at
   the arch's heads, against their plain versions (verify rows equal to
   decode rows); ``[path]`` (phase 7) at stages 1 and 8 for starcoder2-15b
   and minitron-4b at 1 layer (olmo-1b's ``[cli]`` runs beside
   minitron-4b's, ``[train cli]`` and the examples on the CPU beside
   starcoder2-15b's); the CLI for
   minitron-4b at full width; ``[mesh]`` for starcoder2-15b x2: its single
   stream on 2 logical shards of the card, every logit and token
   ``torch.equal`` to the phase's single-device stream (B7 on every layer
   weight and the untied ``lm_head``), B7 and B2 launches a decode step
   counted;
1a'. ``[arch xlstm-125m]`` and ``[arch zamba2-7b x13]``: the recurrent
   blocks (ROADMAP A8(d)) at their published widths, xlstm-125m whole (6
   sLSTM and 6 mLSTM blocks), zamba2-7b at 13 of its 81 layers (two cycles
   of five Mamba-2 blocks and the shared attention block, one set of
   weights and a cache a use, and a Mamba-2 tail), seeded weights:
   ``divide`` and the stage-8 accumulators as 1a; the single stream
   (phase 3's shape) with a decode step's launches checked by name and
   route (55 B2 and no B3; 37 B2 and 2 B3 at G = 1, hd = 112), then from
   v3 wire bytes and in float residency as 1a; the last logits of a
   prefill against a prefill one token shorter and a decode step (the
   chunked SSD and the mLSTM/sLSTM scans against the step recurrence),
   within ``PATH_RTOL``; the pool's 12 requests, then each alone in a pool
   of the same size stepped at the busy pool's stages, tokens
   ``torch.equal``; a chunk tick and a decode step leaving every masked
   slot's recurrent state ``torch.equal``; ``SpeculativeEngine``
   refused; B2 on every weight shape, B3 and B4 at the shared block's
   heads; ``[mesh]``: the single stream on 2 logical shards, ``conv_w``
   and ``r`` gathered home, every logit and token ``torch.equal`` to one
   device's, B7 and B2 launches a decode step as reckoned from its
   weights (54 and 103 for xlstm-125m, whose mLSTM ``w_if`` shards of 4
   columns B7 joins; 36 and 73 for zamba2-7b x13), ``gathered_bytes``
   logged, and for xlstm-125m B7 on a decode step's split weights timed
   against single-device B2; ``[path]`` at 2 layers (a sLSTM and a mLSTM
   block; two Mamba-2 blocks as a tail, no full cycle), a prefill chunk
   and no verify; the CLI for xlstm-125m (beside phase 7);
1b. ``[arch gemma3-27b x6]``: sliding windows over ring caches, qk-norm,
   the logit softcap and the global layers' rope base (ROADMAP A8(b)) at
   gemma3-27b's published widths, one 5:1 cycle (6 of its 62 layers):
   divide and the stage-8 accumulators as 1a; the single stream (a prompt
   of 1000, 48 steps, every ring wrapping at 1024) against the same stream
   teacher-forced over rings grown so that they never wrap, within
   ``RING_RTOL`` and every greedy token equal; the pool's chunked admission over rings (6 requests,
   prompts 990-1040); ``SpeculativeEngine`` at stage 8 from a prompt of
   1030, tokens equal to plain greedy tokens over the same rings; float
   residency; B2 on every weight shape; B3 and B4 on a ring wrapped twice
   and more, verify rows equal to decode rows, timed beside SDPA with the
   window mask; ``[mesh]``: the single stream over wrapping rings on 2
   logical shards, every logit and token equal to one device's. No wire,
   CLI or ``[path]``: they are arch-agnostic byte paths, and the CPU
   tests hold the windowed numerics against the JAX package;
1c. ``[arch mixtral-8x22b x1]``: mixture-of-experts blocks (``swa_moe``:
   8 experts, top-2, over a window of 4096) at mixtral-8x22b's published
   widths, 1 of its 56 layers, seeded weights with a skewed router:
   ``divide`` on the card under ``ExpertPopularityPolicy`` (each expert
   bank sliced in 8, B6 8 launches a slice), the stage-8 accumulators
   equal to ``quantize(slice).q`` of every slice, 8 distinct scales a
   bank, hot experts' planes first in stage 1, the live banks views of
   the store's buffer; the single stream (phase 3's shape) at the
   published cf = 1.25, stages 1-8 landing mid-decode, 30 B2 and 1 B3
   launches a decode step, all on the one-pass GEMV kernels, the share of
   routed pairs dropped; the pool's 12 requests with chunked admission;
   ``SpeculativeEngine`` at stage 8 with cf = 4.0 (drop-free), tokens
   ``torch.equal`` to plain greedy tokens, and at cf = 1.25 (acceptance
   and drops reported); B2 on every weight shape (the router at N = 8,
   the expert slots) at M = 1-64 with and without a per-expert mask; B3
   and B4 at G = 6 on rings; float residency against quantized;
   ``[mesh]`` at 2 and 4 logical shards (the expert route: each shard's
   expert slices on its own sub-store): the single stream, every logit
   and token equal to one device's, 6 B7 calls and 35 or 45 B2 launches a
   decode step; the stage-8 banks gathered equal to a single-device
   store's; a decode step under ``set_sync_debug_mode("error")``;
   ``SpeculativeEngine`` at cf 4.0, tokens equal to plain; float
   residency within ``FP_LOGIT_RTOL`` of one device's. No wire, CLI or
   ``[path]``: byte paths, which the CPU tests hold for a sliced
   division;
1d. ``[arch seamless-m4t-medium]``: cross attention and encoders
   (ROADMAP A8(e)) at seamless-m4t-medium's published widths and depth
   (12 ``enc_attn`` encoder blocks, 12 ``selfcross`` decoder blocks,
   vocab 256,206), seeded weights and a seeded ``enc_input`` of
   ``prompt // 4`` frames: divide and the stage-8 accumulators as 1a; the
   single stream (phase 3's shape) with a decode step's launches checked
   by name and route (109 B2 on the one-pass GEMV kernels, 24 B3: a self
   and a cross launch a layer), and a prefill's (the encoder's 84 and the
   cross ``wk``/``wv``'s 24 B2 launches at the frames' 64 rows, the
   decoder's 108 at the prompt's 256, on the tensor cores; the
   unembedding on the GEMV route); then from v3 wire bytes and in float
   residency as 1a; ``SpeculativeEngine`` at stage 8, tokens equal to
   plain; the pool refused; B2 on every distinct weight shape (``embed.T``
   at N = 256,206 included), B3 and B4 over the self caches and the cross
   caches (16 slots, half a 32-key chunk, every row at ``q_pos = S``),
   verify rows equal to decode rows, timed beside SDPA; ``[mesh]``: the
   single stream on 2 logical shards (the encoder pass and the cross
   caches on the home device, 108 B7 calls and 217 B2 launches a decode
   step), every logit and token equal to one device's; the CLI.
   ``[vision path]``: llama-3.2-vision-90b's cross path at its reduced
   config with its gates drawn away from 0: the single stream with a
   decode step's launches checked, its logits against the CPU's plain
   versions teacher-forced within ``PATH_RTOL``; ``SpeculativeEngine``,
   tokens equal to plain; the pool's batch-1 fall-back with an image a
   request, each request alone equal to the busy pool; ``[mesh]``: the
   single stream on 2 logical shards (``vision_proj`` and the untied
   ``lm_head`` through B7), every logit and token equal to one device's;
   B3 and B4 over its
   cross cache; then over 20 cross caches at the published heads (B 4,
   Kh 8, G 8, hd 128, Tv 1601, T 5), timed beside SDPA and the bound;
1e. ``[arch progressivenet-cnn]``: the paper's own CNN (ROADMAP A8(f))
   at its published widths (13 tensors, 3,931 weights), seeded weights
   and seeded images at 16x16 (batch 512, Table II's test set) and
   224x224 (batch 64, ImageNet's input): ``divide`` on the card (B6),
   its planes and v3 blob equal to the CPU's; the blob through a
   ``ProgressiveClient`` on the card (B1 a stage) beside one on the CPU;
   at each of the 8 stages ``materialize`` and ``cnn_apply``, the logits
   within ``CNN_RTOL`` of the CPU's plain path, the top-1 agreement with
   the undivided float32 model printed (Table II's column); stage-8
   accumulators equal to ``quantize(leaf).q``; B1 and B6 at its shapes
   timed;
1f. ``[train]`` (ROADMAP A12(b)): ``[train cli]``, ``python -m
   repro_torch.launch.train --arch olmo-1b --steps 2 --ckpt-dir DIR
   --ckpt-every 2`` at full width as a process of its own (run beside
   starcoder2-15b's ``[path]``), exit 0; ``[train step]``: 2 layers of
   olmo-1b at full width, a train step on
   the card against the CPU's plain path (loss, every leaf's gradient,
   AdamW on the same gradients); then the whole of olmo-1b through
   ``train(...)`` for ``TRAIN_STEPS`` steps at 8 x 128 with a checkpoint
   at the last (B6): losses finite, every leaf changed, step ms, tokens/s
   and peak memory; ``[train ckpt]``: 8 stages (sizes equal to the
   CLI's checkpoint's), the files through a client on the card (B1 a
   stage) to ``quantize(p).q`` of every trained tensor, a held-out
   batch's loss from stages 1, 2, 4 and 8 each nearer to the float
   params'; ``[train serve]``: the files as one stream through a
   ``WireStoreReceiver``, tokens ``torch.equal`` to a server over the
   in-memory ``divide`` (B2, B3);
2. ``[divide]``: split full-width olmo-1b into eight 2-bit planes on the
   card (``plane_extract``, 8 launches a tensor); the in-memory receiver
   after all 8 stages holds ``quantize(leaf).q`` of every tensor, bit for
   bit; every plane of the largest tensor equals the plain version;
3. serve full-width olmo-1b from its plane accumulators:
   ``ProgressiveServer(resident="quantized")``, one stage, a (4, 64)
   prompt, 48 decode steps with the other 7 stages landing mid-decode;
   then the slot pool on the same planes: ``SlotPoolEngine`` with 8
   slots, 12 requests of ragged prompts admitted by chunked prefill while
   the other slots decode, an upgrade every window from stage 1 to 8;
   then self-speculation on the same planes. ``[spec]``:
   ``SpeculativeEngine`` (draft 4 bits), (a) at each of the 8 stages
   from a fresh start at batch 4, 24 tokens, k = 4 and adaptive, each
   ``torch.equal`` to ``ProgressiveServer`` at that stage, (b) at batch
   1, 48 tokens with stages 2-8 landing between rounds, ``torch.equal``
   to a batch-1 server replayed at the run's per-token stage log (the
   plain server's runs come before the counts); every B2 launch but the
   prefills' layer weights on the GEMV route's one-pass kernels, verify
   passes included; the draft view shares every q of the target view
   (zero extra bytes). ``[spec pool]``:
   ``SpeculativeSlotPool`` (k = 3) on the pool's 12 requests at stage 8,
   each request's tokens ``torch.equal`` to a plain ``SlotPoolEngine``'s.
   ``[reject]``: both engines again, on the same seed-0 weights with the
   decoder's scaled by 2, where the 4-bit draft is rejected in part,
   tokens ``torch.equal`` to the plain engines' (stages 4-8; the pool);
   ``[quantized view]``: ``QuantizedLinearState`` over ``embed`` as a
   (50304, 2048) weight, upgraded plane by plane on a private store, its
   ``matmul`` (B2 at K = 50,304) at M = 1, 4, 64 against ``dequantize``
   and ``torch.matmul`` at every stage, within
   ``quantization_error_bound`` at stage 8; one upgrade through a view of
   a server's store is the server's. ``[pool batch-1]``: both pools
   admitting at batch 1 (a bucket-padded prefill a request), upgrades a
   window apart, each request alone in a 1-slot pool at the run's stages
   ``torch.equal`` to the busy pool (so speculative tokens equal plain
   batch-1 tokens); the tokens batch-1 shares with chunked admission at
   stage 8. ``[telemetry]`` (ROADMAP A11): the single stream (12 steps,
   2 upgrades) and ``SpeculativeEngine`` (16 tokens) each with the
   registry off and then on: tokens ``torch.equal`` and launches equal,
   nothing recorded off, the counters equal the runs' records and
   ``kernel_launches_total`` ``LAUNCH_COUNTS`` on, the wall ms a step
   printed both ways;
4. ``[wire]``: the same model from wire bytes: ``wire.encode`` (v3),
   ``ProgressiveClient.feed`` in seeded ragged chunks of 1 B to 64 MB,
   one stage at each arrival of phase 3's schedule, and
   ``ProgressiveServer(receiver=WireStoreReceiver(...))``: the store's
   fingerprint equals the in-memory receiver's after every stage and the
   tokens equal phase 3's; a unit of stage 3 damaged on a second feed is
   quarantined and repaired to the clean fingerprint; raw v1 streams the
   2-layer full-width model the same way;
   ``[mesh]``: sharded serving on logical shards of the one card
   (``make_serving_mesh(n, devices=[card] * n)``; a run on 2+ cards is
   still owed): at 2 shards, counted from 0, ``ProgressiveServer``
   quantized (phase 3's stream) and the pool (phase 3's requests), every
   logit and token ``torch.equal`` to one device's at every stage,
   ``SpeculativeEngine`` at stage 8 equal to plain, and float residency
   within ``FP_LOGIT_RTOL``; the v3 bytes through
   ``ProgressiveClient(mesh=)`` at 4 shards, one ``plane_or_segments`` a
   sub-store a stage, every leaf gathered equal to one device's store;
   ``sharded_dequant_matmul`` (B7) at 2 and 4 shards on ``attn.wq``,
   ``mlp.wi_up``, ``mlp.wo`` and ``embed.T`` split on its vocab columns,
   M = 1-256, with and without a mask: ``torch.equal`` to one B2 launch
   on either route, and within ``DQMM_RTOL`` of its plain version; its
   times beside single-device B2;
   ``[session]``: the byte-clock ``Session`` over ``pod-coldstart``
   (200 MB/s, 1 MB chunks) at full width: ``run_timeline`` within 1e-9 s
   of ``progressive_timeline``; ``run_serving`` quantized, ``torch.equal``
   to a ``ProgressiveServer(receiver=)`` replay at its per-step stages,
   and in float residency, its logits within ``FP_LOGIT_RTOL`` of the
   quantized run's and its tokens equal wherever the margin clears it;
   both decode rates at stage 8 and the float upgrade against its bytes
   bound; a faulted run (the CLI's default profile) whose store equals
   the clean one and whose final tokens equal a clean run's;
   ``run_serving_pool``; then the small-chunk scenarios on the 2-layer
   full-width model (the lossy ones end in ``TransportError`` there) and
   the lossy ones on reduced olmo-1b, recovered. ``[cli]`` (run beside
   minitron-4b's ``[path]``): ``python -m
   repro_torch.launch.serve --arch olmo-1b --scenario pod-coldstart`` at
   full width, as a process of its own, with ``--metrics``: the file
   holds every metric family the reference's launcher writes;
   ``[calibrate]``: ``weight_sse_schedule`` (float64 on the card),
   ``calibrate_schedule(method="marginal")`` and ``greedy_schedule`` at
   full width under a float-leaf cross-entropy loss, each valid and
   MSB-first per tensor, with seconds, loss evaluations and peak device
   memory; the card's SSE sweep ordered as the same sweep on CPU copies
   of the 2-layer model's planes; v2's host entropy codec timed; the
   greedy schedule on the v3 wire through ``Session`` (``run_timeline``,
   ``run_serving`` quantized), a client's store after every checkpoint
   equal to an in-memory store fed the same unit prefix, the final store
   and a fresh decode equal to the uniform stream's; the marginal
   schedule (checkpoints off the uniform ladder's) through
   ``run_serving`` quantized, ``torch.equal`` to a server fed the same
   unit prefixes at its per-step stages. ``[cli]``: also
   ``--pool-clients 4 --no-chunked-prefill``;
5. ``[upgrade per tensor]``: stage 8 as one ``plane_or`` a tensor on the
   live stage-7 accumulator views, byte-equal to the batched
   ``plane_or_segments`` upgrade, both timed;
6. hold each kernel against its plain version on the paths' operands
   (``dequant_matmul`` on both routes, GEMV and tensor-core, at M = 4, 8,
   64 and 256, with activations of zero and of large positive mean; every
   row of a GEMV launch at M = 4 and 8 ``torch.equal`` to that row
   launched alone; the plane mask ``keep`` = 0, 2, 4, 8, 16 on both
   routes and on the forced GEMV route (``rows="decode"``) at the verify
   shapes M = 5, 20, 32, 72, a full-width keep bit-equal to none, and
   every forced-GEMV row at those M equal to the row alone), every
   ``flash_verify`` row against a ``flash_decode`` launch (T = 8 and the
   verify shapes T = 2, 5, 9), and a verify step's logits and the K/V it
   writes ``torch.equal`` to sequential decode steps after reject-all,
   alternate and accept-all rounds;
7. run the same 2-layer full-width model on the card (kernels) and on
   the CPU (plain versions) and compare teacher-forced decode, prefill
   chunk and verify logits; xlstm-125m's and seamless-m4t-medium's CLI
   processes run beside it (it times nothing), and so do the examples on
   the card. ``[examples]`` (ROADMAP A12(d)): the four scripts of
   ``examples_torch/`` at the reduced configs of the reference's
   examples, a process each on the card and on the CPU (beside
   starcoder2-15b's ``[path]``), ``progressive_serving.py`` with five flag
   sets (``EXAMPLE_RUNS``), each exit 0: quickstart's blob, stages and
   ``t=`` times equal to the CPU's, its logits within ``PATH_RTOL``, its
   stage 8 equal to the singleton quantized model (the script's own
   check); train_then_transmit at its default 300 steps, its logged steps
   and stage bytes equal to the CPU's, its stage-8 accuracy within
   ``EXAMPLE_ACC_TOL`` of its float params'; progressive_serving's blob,
   stage arrivals and (but under ``--speculative``) per-step stages,
   upgrades and event log equal to the CPU's; expert_priority_moe's
   tensor counts equal and MSEs within ``PATH_RTOL``; a line an example
   with its launches by kernel;
8. time each kernel at the paths' shapes beside its bound, its plain
   version and one PyTorch call (or chain of calls) that computes the
   same function: ``dequant_matmul`` over a decode step's (M = 4), the
   pool's decode step's (M = 8), a chunk tick's and the prefill's
   operands, and both of its routes at M = 1 to 256; both attention
   kernels at the paths' shapes and on one synthetic layer at S = 1024
   and 4096 keys; one chunk tick of the pool and the single stream's
   prefill; the plane mask's cost over a decode step's launches; one
   verify step at M = 20 and 32 on either route and a speculation
   round.

``dequant_matmul``'s launches are also counted by route on every path:
the prefill and the chunk ticks run the tensor-core kernel, decode and
verify the GEMV route, every launch of it on its one-pass kernels
(checked on each serving path; ``[quantized view]``'s (50304, 2048)
weight at M = 1 and 4 takes the general GEMV kernel).

The second-to-last line is a JSON object with one entry per kernel, the
last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # float32 outside the tensor cores
BF16_FLOPS = 989e12         # bf16 on the tensor cores (dequant_matmul's mma route)

DEVICE = "cuda"
BATCH, PROMPT, STEPS = 4, 64, 48
ARRIVALS = (6, 12, 18, 24, 30, 36, 42)
# the slot pool: 8 slots, 8-token prefill chunks, 8-step windows, 12
# requests (prompts 16-96 tokens, budgets 24-40, numpy seed 3)
POOL_SLOTS, POOL_CHUNK, POOL_WINDOW, POOL_MAX_LEN = 8, 8, 8, 160
POOL_REQUESTS = 12
# dequant_matmul's rows: checked at the paths' M (decode, the pool's
# decode, a chunk tick, the prefill), both routes timed at each of these
DQMM_CHECK_M = (4, 8, 64, 256)
# self-speculation: verify's rows (batch 1 at k = 4, batch 4 at k = 4,
# the pool's 8 slots at k = 3, 8 slots at k = 8), the masks checked, the
# verify blocks' T, and the single stream's tokens a start
VERIFY_M = (5, 20, 32, 72)
KEEP_CHECK = (0, 2, 4, 8, 16)
VERIFY_T = (2, 5, 9)
SPEC_TOKENS = 24
# the speculative paths are also run on phase 2's weights with the
# decoder's scaled by this, where the 4-bit draft is rejected in part
DECODER_SCALE = 2.0
DQMM_TIME_M = (1, 2, 4, 8, 12, 16, 32, 64, 256)
# the attention kernels are also checked and timed on one synthetic layer
# at these cache lengths (keys), beyond what the body's ring holds at once
ATTN_LONG_S = (1024, 4096)
# wire chunks: log-uniform from 1 byte to 64 MB (numpy seed 5)
CHUNK_MAX = 64 << 20

# Stated tolerances, each with its reason.
# dequant_matmul: on both routes q is centred (so the two epilogue terms
# do not cancel), the products are exact (bfloat16 x) or rounded once
# (float32 x on the GEMV route) and only the float32 sums over K (<= 8192
# terms) round, where the plain version rounds each weight and sums in
# another order: error far below 1e-4 of the output's largest magnitude.
DQMM_RTOL = 1e-4
# decode_attention and flash_verify: the kernels write bfloat16, the
# plain versions float32; one bfloat16 rounding is 2**-9 relative, allow
# 2**-7 of the largest output magnitude.
ATTN_RTOL = 2.0 ** -7
# whole path: bfloat16 activations rounded at other places by the two
# sums orders compound over 2 layers; allow 3% of the largest logit.
PATH_RTOL = 3e-2
# gemma3-27b's stream over wrapping rings against unwrapped rings: the
# same kernels on the same card, only the order of the slots (and so of
# the sums over them) differs; the card measured 1.42e-3 of the largest
# logit, allow 5e-3 and hold every greedy token equal
RING_RTOL = 5e-3
# float residency against quantized on the same byte clock: the float
# path rounds every weight to bfloat16 (2**-9 relative) before a cuBLAS
# product, B2 multiplies the exact dequantised weight; over 16 layers
# allow 5% of the largest logit, and hold the greedy tokens equal only
# where the top two logits are further apart than twice that.
FP_LOGIT_RTOL = 5e-2

# [session]: the byte-clock Session on full-width olmo-1b over this
# scenario (200 MB/s, 1 MB chunks), SESSION_STEPS decode steps at batch
# 4; each stage's simulated processing cost (concat, dequant, inference
# seconds) in run_timeline; the pool's 12 requests SESSION_POOL_TOKENS
# tokens each; the 2-layer model over the small-chunk and lossy scenarios
SESSION_SCENARIO = "pod-coldstart"
SESSION_STEPS = 48
SESSION_STAGE_COST = (0.0, 0.0, 0.05)
SESSION_POOL_TOKENS = 32
SESSION_POOL_ROUNDS = 48
SMALL_CHUNK_SCENARIOS = ("browser-3g", "browser-lte-handoff", "edge-stall", "flash-crowd")
LOSSY_SCENARIOS = ("browser-3g-lossy", "edge-flaky")
CLI_TIMEOUT_S = 400
# CLI processes run beside a [path]'s CPU side, which times nothing: each
# [path] takes the runs queued under its arch in BESIDE_PATH (filled by
# ``main`` and the phases), if the card has this many GiB free for both
# (else they run after it); olmo-1b's is phase 7's
BESIDE_GIB = {"minitron-4b": 56, "starcoder2-15b": 52, "olmo-1b": 24}
BESIDE_PATH: dict[str, list] = {}
# the CLI's runs (flags, the start of the last line): every flag at its
# default (float residency, batch 2, prompt 32, 64 decode steps); the slot
# pool of 4 clients admitting at batch 1
CLI_STREAM = ([], "served 64 steps across 8 precision stages")
CLI_POOL = (["--pool-clients", "4", "--no-chunked-prefill"], "served 256 tokens across")
# [quantized view]: QuantizedLinearState over embed as a (50304, 2048)
# weight, its matmul checked at these rows at every stage
VIEW_M = (1, 4, 64)
# [mesh]: sharded serving on logical shards of the one card: the servers,
# the pool and speculation at MESH_SERVE_SHARDS, the wire-fed store at
# MESH_STORE_SHARDS, B7 against B2 at both and at these rows (20 on the
# forced GEMV route, verify's)
MESH_SERVE_SHARDS, MESH_STORE_SHARDS = 2, 4
MESH_B7_M = (1, 4, 8, 20, 64, 256)
# [calibrate]: the calibration batch (numpy-free torch seed 7)
CAL_BATCH, CAL_LEN = 4, 64
# [arch]: the dense variants of ROADMAP A8(a) at their published widths,
# minitron-4b at its full 32 layers and starcoder2-15b at 2 of its 40
# (its float32 weights, 88 GB at full depth by the reference's GLU MLP,
# do not fit the card that divides them; 4 layers until the cross phases
# took the script past 960 s: ROADMAP's second cut); B2 checked at these
# rows on every distinct weight shape, a float-resident run of FP_STEPS
# steps
ARCHS = (("minitron-4b", None), ("starcoder2-15b", 2), ("xlstm-125m", None),
         ("zamba2-7b", 13))
ARCH_DQMM_M = (1, 4, 8, 20, 64)
ARCH_FP_STEPS = 16
# [path] at 2 layers but starcoder2-15b's at 1: the CPU side of its
# 6144-wide layers set its phase's time (108.7-145.9 s at 2 layers), and
# with the recurrent phases the script passed 960 s (ROADMAP's first cut);
# minitron-4b's at 1: its CPU side over the 256,000-row embedding took
# 37.8-60.9 s at 2 layers and 45.1 s at 1, and with the training phase the
# script took 1231.7 s at 2 layers on a slow host (ROADMAP's third cut;
# PERF.md has the runs)
ARCH_PATH_LAYERS = {"starcoder2-15b": 1, "minitron-4b": 1}
# the recurrent archs of ROADMAP A8(d) among ARCHS (``_recurrent_phase``):
# xlstm-125m whole, zamba2-7b at 13 of its 81 layers (two cycles of five
# mamba2 blocks and the shared attention block, and a mamba2 tail; the 81
# layers' 5.6 B weights do not fit a divide on one card); each recurrent
# block's B2 weights in the order a token runs them
RECURRENT_B2 = {"mamba2": ("in_proj", "out_proj"),
                "mlstm": ("up_proj", "wq", "wk", "wv", "w_if", "down_proj"),
                "slstm": ("w_in", "up_proj", "down_proj")}
# [arch gemma3-27b x6]: sliding windows (ROADMAP A8(b)) at gemma3-27b's
# published widths, one 5:1 cycle of its 62 layers (its float32 weights,
# 108 GB at full depth, do not fit the card that divides them). The
# single stream's prompt of 1000 crosses the window (1024) during decode;
# the pool's 6 requests on 4 slots (numpy seed 3) have prompts of 990-1040
# and budgets of 24-39; speculation (k = k_max = 4: rings of 1024 + 5)
# starts past the window; float residency crosses it
GEMMA = ("gemma3-27b", 6)
GEMMA_PROMPT = 1000
GEMMA_POOL_SLOTS, GEMMA_POOL_REQUESTS, GEMMA_POOL_MAX_LEN = 4, 6, 1088
GEMMA_POOL_PROMPTS, GEMMA_POOL_BUDGETS = (990, 1041), (24, 40)
GEMMA_SPEC_PROMPT, GEMMA_SPEC_K = 1030, 4
GEMMA_FP_PROMPT = 1016
# [arch mixtral-8x22b x1]: mixture-of-experts blocks (ROADMAP A8(c)) at
# mixtral-8x22b's published widths, 1 of its 56 layers (one layer's divide
# holds about 41 GB at its peak; 2 layers would not fit the card). The
# router's 8 columns are scaled by MOE_SKEW (permuted by a seed) so that
# some experts are hot, as a trained model's are; the expert policy takes
# its popularity from a calibration batch of MOE_CAL tokens. Speculative
# tokens equal plain ones only at drop-free capacity, cf = E / K = 4.0;
# the published cf = 1.25 runs once and reports acceptance. B2 is checked
# at MOE_DQMM_M rows (16: an expert's rows at the pool's decode step)
MOE = ("mixtral-8x22b", 1)
MOE_SKEW = (1.6, 1.3, 1.0, 0.8, 0.6, 0.4, 0.2, 0.1)
MOE_CAL = (4, 64)
MOE_DQMM_M = (1, 4, 8, 16, 64)
MOE_SPEC_K = 4
# [mesh] inside an arch phase: its single stream (and for mixtral-8x22b
# speculation, float residency, the stage-8 banks and a decode step under
# the sync guard) on n logical shards of the card, over the planes the
# phase holds, for each n here: the dense, windowed and MoE archs; the
# recurrent ones (their conv_w and r gathered home) with B7 timed on
# xlstm-125m's decode-step weights; the cross-attention ones (the encoder
# pass or vision_proj on the home device, the cross caches written there)
MESH_ARCH_SHARDS = {"starcoder2-15b": (2,), "gemma3-27b": (2,), "mixtral-8x22b": (2, 4),
                    "xlstm-125m": (2,), "zamba2-7b": (2,), "seamless-m4t-medium": (2,),
                    "llama-3.2-vision-90b": (2,)}
MESH_B7_TIMED = "xlstm-125m"
# [arch seamless-m4t-medium]: cross attention and encoders (ROADMAP A8(e))
# at seamless-m4t-medium's published widths and depth (715,466,752
# weights); [vision path]: llama-3.2-vision-90b's cross path at its
# reduced config (its smallest stack with a cross block, one cycle of 5
# layers at the published widths, holds 6.4 B weights, which a divide on
# one card does not fit), VISION_REQUESTS requests in its pool, and B3/B4
# over VISION_HEADS_LAYERS cross caches at its published heads (its 100
# layers hold 20 cross layers); seamless's B3/B4 are also timed over 12
# cross caches of CROSS_LONG_TV frames at its heads, a memory 25 times the
# stub's 16 frames, standing for a speech input much longer than its text
CROSS = "seamless-m4t-medium"
VISION = "llama-3.2-vision-90b"
VISION_REQUESTS = 3
VISION_HEADS_LAYERS = 20
CROSS_LONG_TV = 400
# [arch progressivenet-cnn]: the paper's own CNN (ROADMAP A8(f)) at its
# published widths (channels 16, 32, 64; 3 input channels, 10 classes),
# classifying seeded numpy images at each stage: (input size, batch) of
# the reference's Table II test set and of ImageNet's input (the pool is
# global, so the model takes any size). Each seeded image is a random
# colour plus unit noise: white noise alone averages out in the global
# pool at 224x224, where every image would take one class. Its logits on
# the card against
# the CPU's plain path: cuDNN and the CPU sum each convolution in other
# orders in float32 (TF32 off), and the batch norm divides by the batch's
# own spread; allow 1e-4 of the largest logit
CNN = "progressivenet-cnn"
CNN_BATCHES = ((16, 512), (224, 64))
CNN_RTOL = 1e-4
# [train] (ROADMAP A12(b)): full-width olmo-1b trained TRAIN_STEPS steps
# at the launcher's batch and sequence (8 x 128) through train(), a
# checkpoint at the last step, then served from its files with the
# stages landing at TRAIN_ARRIVALS of TRAIN_SERVE_STEPS decode steps.
# [train step] holds a train step of 2 of its layers on the card against
# the CPU's plain path, bfloat16 activations on both: the loss within
# TRAIN_LOSS_RTOL (a mean over 256 positions; bfloat16 against float32
# differs by 2e-5 at d_model 512 on the CPU), each leaf's gradient within
# TRAIN_GRAD_RTOL of its largest |g| (bfloat16 against float32: 7e-3 to
# 1.3e-2 at d_model 512; two bfloat16 paths that round at other points
# differ by up to twice that, and the full width's longer sums add to
# it), and AdamW on the same gradients within TRAIN_OPT_RTOL (float32
# elementwise on both). The checkpoint's held-out losses are taken with
# float32 activations, so that the stages' differences are not bfloat16
# rounding: stage 8 within TRAIN_STAGE8_RTOL of the float params' loss
# (16-bit weights move a loss near ln(vocab) by about 1e-8 relative)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_PROFILED = 4, 8, 128, 2
TRAIN_STEP_LAYERS, TRAIN_STEP_BATCH = 2, 2
TRAIN_SERVE_STEPS, TRAIN_ARRIVALS = 16, (2, 4, 6, 8, 10, 12, 14)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_OPT_RTOL = 1e-3, 5e-2, 1e-6
TRAIN_STAGE8_RTOL = 1e-4
TRAIN_LOSS_STAGES = (1, 2, 4, 8)
# [telemetry]: full-width olmo-1b's single stream from stage TEL_START,
# TEL_STEPS decode steps with stages landing at TEL_ARRIVALS, and
# SpeculativeEngine at stage 8 for TEL_SPEC_TOKENS tokens at batch 1 (k =
# 4), each run TEL_TURNS times with the registry off and then on
TEL_START, TEL_STEPS, TEL_ARRIVALS, TEL_SPEC_TOKENS, TEL_TURNS = 6, 12, (4, 8), 16, 2
# the metric families the reference's launcher writes with --metrics for
# CLI_STREAM and CLI_POOL (reduced olmo-1b, pod-coldstart)
CLI_STREAM_FAMILIES = frozenset((
    "client_bytes_fed_total", "client_flush_planes", "client_planes_ored_total",
    "client_resume_cursor_byte", "client_resume_cursor_unit", "engine_tokens_total",
    "engine_ttft_s", "kernel_launches_total", "session_bytes_total", "session_chunks_total",
    "session_decode_steps_total", "session_stage_completions_total", "session_upgrades_total",
    "span_decode_window_wall_s", "span_stage_arrival_sim_s", "span_upgrade_ingest_wall_s",
    "span_upgrade_refresh_wall_s", "store_or_round_planes", "store_or_rounds_total",
    "store_refresh_dispatches_total", "store_refresh_slots", "store_resident_bytes"))
CLI_POOL_FAMILIES = CLI_STREAM_FAMILIES - {"session_decode_steps_total"} | {
    "engine_prefill_ticks_total", "engine_upgrade_enqueue_s", "engine_upgrade_stall_s",
    "engine_upgrades_total", "engine_window_steps", "pool_window_tokens"}
# v2 entropy coding is host numpy (core/entropy.py): its encode and decode
# are timed on the 2-layer full-width model's attn.wq units (8 planes)
# [examples] (ROADMAP A12(d)): each script of examples_torch/ in a process
# of its own, its main() once a flag set (the launch counts set to 0
# before each), at the reduced configs the reference's examples use: on
# the CPU beside starcoder2-15b's [path] and on the card beside phase 7's,
# with EXAMPLE_THREADS host threads each. train_then_transmit at its
# default 300 steps, its stage-8 accuracy on the card within
# EXAMPLE_ACC_TOL of the float params', the reference's Table II bound
# (benchmarks/table2_accuracy.py:231)
EXAMPLE_RUNS = (("quickstart", ([],)), ("train_then_transmit", ([],)),
                ("progressive_serving", ([], ["--resident", "quantized"], ["--speculative"],
                                         ["--flash-crowd", "4"], ["--scheduled"])),
                ("expert_priority_moe", ([],)))
EXAMPLE_ACC_TOL = 0.02
EXAMPLE_THREADS = 1
EXAMPLE_TIMEOUT_S = 400


def check(ok: bool, what="check failed") -> None:
    """Raise unless ``ok``: every phase's checks, kept under ``python -O``."""
    if not ok:
        raise RuntimeError(str(what))


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    return out.splitlines()[0]


def device_ms(fn, reps: int) -> float:
    """Device time of one ``fn()`` in ms: ``reps`` calls captured in one
    CUDA graph, replayed between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Host time in ms to issue one ``fn()``: no synchronisation inside."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_flops(dtype) -> float:
    """The card's peak rate for attention over q and caches of ``dtype``:
    the tensor cores' for bfloat16 and float16, the float32 units'
    otherwise."""
    return BF16_FLOPS if dtype in (torch.bfloat16, torch.float16) else FP32_FLOPS


def kernel_counters() -> dict:
    """Each kernel's launch counter (its wrapper module and the counter's
    name there), by its name in the kernels line."""
    from repro_torch.kernels import bitplane, decode_attention, dequant_matmul, ops
    from repro_torch.kernels import verify_attention

    return {"plane_or_segments": (bitplane, "launches"),
            "dequant_matmul": (dequant_matmul, "launches"),
            "decode_attention": (decode_attention, "launches"),
            "flash_verify": (verify_attention, "launches"),
            "plane_or": (bitplane, "plane_or_launches"),
            "plane_extract": (bitplane, "plane_extract_launches"),
            "sharded_dequant_matmul": (ops, "sharded_launches")}


def reset_counts(ops) -> None:
    from repro_torch.kernels import dequant_matmul

    for mod, attr in kernel_counters().values():
        setattr(mod, attr, 0)
    for by in (dequant_matmul.launches_by_route, dequant_matmul.launches_by_gemv_kernel):
        by.update(dict.fromkeys(by, 0))
    ops.reset_launch_counts()


def route_counts() -> dict:
    """``dequant_matmul``'s CUDA launches by route since the last reset."""
    from repro_torch.kernels import dequant_matmul

    return dict(dequant_matmul.launches_by_route)


def check_one_pass(routes: dict, what: str) -> dict:
    """Every GEMV-route launch since the last reset (decode's layer weights
    and, below ``MMA_MIN_M``, its unembedding) went through the one-pass
    kernels: none through the general ones. Returns the counts."""
    from repro_torch.kernels import dequant_matmul

    by = dict(dequant_matmul.launches_by_gemv_kernel)
    check(by["general"] == 0 and by["one_pass"] == routes["gemv"] > 0, (what, by, routes))
    return by


def expect_routes(calls) -> dict:
    """Launches by route for ``calls``: (launches, M) pairs, all on uint16
    accumulators, or (launches, M, rows) triples, rows="decode" forcing
    the GEMV route."""
    from repro_torch.kernels import dequant_matmul

    want = dict.fromkeys(dequant_matmul.launches_by_route, 0)
    for n, M, *rows in calls:
        want["gemv" if rows == ["decode"] else dequant_matmul.route(M, torch.uint16)] += n
    return want


def pass_calls(layers: int, passes: int, M: int) -> list:
    """``passes`` forward passes at M rows: 7 launches a layer on the (K, N)
    layer weights and the unembedding on the K-contiguous ``embed.T``."""
    return [(passes * layers * 7, M), (passes, M)]


def counts(names=None) -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in kernel_counters().items()
            if names is None or name in names}


class FiniteLogits:
    """Wraps a Model: records, without a host sync, whether the logits of
    every decode step and prefill chunk were finite."""

    def __init__(self, model):
        self.model = model
        self.flags: list[torch.Tensor] = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, params, caches, tokens, pos):
        logits, caches = self.model.decode_step(params, caches, tokens, pos)
        self.flags.append(torch.isfinite(logits).all())
        return logits, caches

    def prefill_chunk(self, params, caches, tokens, tok_pos):
        logits, caches = self.model.prefill_chunk(params, caches, tokens, tok_pos)
        self.flags.append(torch.isfinite(logits).all())
        return logits, caches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import ReceiverState
    from repro_torch.kernels import bitplane, build, ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dequant_matmul as dqm
    from repro_torch.kernels import verify_attention as va
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import layer
    from repro_torch.serving.engine import ProgressiveServer, _chunk_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    t_script = time.perf_counter()

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.library(name)
    log(f"[build] {len(build.SOURCES)} kernel sources built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    print(gpu_line(), flush=True)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # the CLIs beside the [path]s: olmo-1b's beside minitron-4b's, the
    # training launcher and the examples on the CPU beside starcoder2-15b's,
    # the examples on the card and the recurrent and cross archs' CLIs
    # (queued by their phases) beside phase 7's
    train_dir = tempfile.TemporaryDirectory()
    train_cli: dict = {}
    examples_dir = tempfile.TemporaryDirectory()
    examples: dict = {}
    BESIDE_PATH.update({
        "minitron-4b": [lambda: _cli_phase("olmo-1b", CLI_STREAM, CLI_POOL,
                                           families=(CLI_STREAM_FAMILIES, CLI_POOL_FAMILIES))],
        "starcoder2-15b": [lambda: _examples_start("cpu", examples_dir.name),
                           lambda: _train_cli(os.path.join(train_dir.name, "cli"), train_cli),
                           lambda: _examples_wait("cpu", examples)],
        "olmo-1b": [lambda: _examples_start("cuda", examples_dir.name)]})

    # -- 1a. the dense variants (ROADMAP A8(a)) at their published widths ----
    arch_runs = {}
    for name, n_layers in ARCHS:
        arch_runs[f"arch {name}" + ("" if n_layers is None else f" x{n_layers}")] = \
            _arch_phase(name, n_layers, dev, ops)
        torch.cuda.empty_cache()

    # -- 1b. sliding windows (ROADMAP A8(b)): gemma3-27b, 6 of its 62 layers -
    arch_runs[f"arch {GEMMA[0]} x{GEMMA[1]}"] = _gemma_phase(dev, ops)
    torch.cuda.empty_cache()

    # -- 1c. mixture of experts (ROADMAP A8(c)): mixtral-8x22b, 1 of 56 layers
    arch_runs[f"arch {MOE[0]} x{MOE[1]}"] = _moe_phase(dev, ops)
    torch.cuda.empty_cache()

    # -- 1d. cross attention and encoders (ROADMAP A8(e)) ----------------------
    arch_runs[f"arch {CROSS}"] = _cross_phase(dev, ops)
    torch.cuda.empty_cache()
    arch_runs["vision path"] = _vision_phase(dev, ops)
    torch.cuda.empty_cache()

    # -- 1e. the paper's own CNN (ROADMAP A8(f)), progressive inference -------
    arch_runs[f"arch {CNN}"] = _cnn_phase(dev, ops)
    torch.cuda.empty_cache()

    # -- 1f. training (ROADMAP A12(b)) and serving from its checkpoint -------
    arch_runs["train"] = _train_phase(dev, ops, train_cli)
    train_dir.cleanup()
    gc.collect()
    torch.cuda.empty_cache()

    # -- 2. divide on the card -----------------------------------------------
    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    prog, n_params, clean_fps, divide_counts = _divide_phase(model, dev, ops)

    # -- 3. full-width serve -------------------------------------------------
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    checked = FiniteLogits(model)
    srv = ProgressiveServer(checked, prog, max_len=PROMPT + STEPS, resident="quantized",
                            device=dev)
    torch.cuda.synchronize()
    serve_kernels = ("plane_or_segments", "dequant_matmul", "decode_attention")
    reset_counts(ops)
    t0 = time.perf_counter()
    srv.receive_stage()
    srv.start({"tokens": prompt})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill, prefill_routes = counts(serve_kernels), route_counts()
    res = srv.decode(STEPS, stage_arrival=lambda i: i in ARRIVALS)
    torch.cuda.synchronize()
    path_counts, serve_routes = counts(serve_kernels), route_counts()
    serve_gemv = check_one_pass(serve_routes, "serve")
    op_counts = dict(ops.LAUNCH_COUNTS)
    decode_s = sum(s for _, s in res.window_s)

    layers = cfg.n_layers
    per_step = {k: (path_counts[k] - after_prefill[k]) / STEPS for k in path_counts}
    report = srv.resident_report()
    check(srv.stage == prog.n_stages == 8, f"ended at stage {srv.stage}")
    check([s for _, s in res.upgrades] == list(range(2, 9)), res.upgrades)
    check(bool(torch.stack(checked.flags).all()), "non-finite decode logits")
    check(bool(torch.isfinite(srv.last_logits).all()))
    check(res.tokens.shape == (BATCH, STEPS))
    check(int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab)
    check(report["fp_bytes"] == 0, report["fp_bytes"])
    check(report["quantized_bytes"] == 2 * n_params, (report["quantized_bytes"], n_params))
    check(per_step["dequant_matmul"] == layers * 7 + 1, per_step)
    check(per_step["decode_attention"] == layers, per_step)
    check(path_counts["plane_or_segments"] == 8, path_counts)
    check(all(path_counts[k] > 0 for k in path_counts))
    check(op_counts == path_counts, (op_counts, path_counts))
    # the prefill's layer weights at M = BATCH * PROMPT and its unembedding
    # of the last position at M = BATCH; decode at M = BATCH
    prefill_calls = [(layers * 7, BATCH * PROMPT), (1, BATCH)]
    check(prefill_routes == expect_routes(prefill_calls), prefill_routes)
    check(serve_routes == expect_routes(prefill_calls + pass_calls(layers, STEPS, BATCH)),
          serve_routes)
    tok_s = BATCH * STEPS / decode_s
    log(f"[serve] stages {res.stage_at_step[0]}->{res.stage_at_step[-1]}, upgrades "
        f"{res.upgrades}; logits finite; resident {report['quantized_bytes']} B "
        f"quantized, {report['fp_bytes']} B fp")
    log(f"[serve] launches in the run {path_counts}; per decode step "
        f"dequant_matmul {per_step['dequant_matmul']:.0f}, decode_attention "
        f"{per_step['decode_attention']:.0f}; dequant_matmul by route: prefill "
        f"{prefill_routes}, whole run {serve_routes}; GEMV route by kernel {serve_gemv}")
    log(f"[serve] receive_stage + prefill {t_prefill * 1e3:.1f} ms; decode "
        f"{STEPS} steps x {BATCH} slots with 7 upgrades: {decode_s:.3f} s, "
        f"{tok_s:.1f} tokens/s, {decode_s / STEPS * 1e3:.2f} ms/step")

    # upgrade latency on a fresh store: host clock around one
    # receive(), synchronised before and after
    state = ReceiverState.init(prog, device=dev)
    upgrade_ms = []
    for s in range(1, prog.n_stages + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = state.receive(prog.stage(s))
        state.materialize_resident()
        torch.cuda.synchronize()
        upgrade_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[serve] upgrade (ingest + view refresh, synchronised) ms per stage: "
        f"{[round(u, 2) for u in upgrade_ms]}")
    del state

    # the single-tensor quantized view of embed, private and shared
    view = _view_phase(model, prog, dev, ops, prompt)

    # the slot pool on the same planes
    pool, pool_counts, pool_routes = _pool_phase(model, prog, dev, ops)

    # self-speculation on the same planes: the single stream and the pool
    spec = _spec_phase(model, prog, dev, ops, prompt, report["quantized_bytes"])
    spec_pool = _spec_pool_phase(model, prog, dev, ops)
    # both pools admitting at batch 1
    t0 = time.perf_counter()
    batch1 = _pool_batch1_phase(model, prog, dev, ops, spec_pool["plain_stage8"])
    log(f"[pool batch-1] {time.perf_counter() - t0:.1f} s")
    # both speculative engines on a model whose draft the target rejects
    prog_scaled = _scaled_model(model, dev)
    _spec_rejections(model, prog_scaled, prompt, dev)
    _spec_pool_rejections(model, prog_scaled, dev)
    del prog_scaled
    # the serving telemetry (ROADMAP A11), off and on, on the same planes
    telemetry = _telemetry_phase(model, prog, dev, ops, prompt)

    # -- 4. the same model from wire bytes -----------------------------------
    wire_counts, wire_routes, blob = _wire_phase(model, prog, dev, ops, prompt, res,
                                                 clean_fps, serve_routes)
    _wire_v1_check(cfg, dev)

    # -- 4a. sharded serving on logical shards of the card -------------------
    mesh = _mesh_phase(model, prog, dev, ops, prompt, blob)
    del blob

    # -- 4b. the byte-clock Session and the CLI ------------------------------
    t0 = time.perf_counter()
    session = _session_phase(model, prog, dev, ops, prompt, clean_fps)
    _session_small(cfg, dev, ops, session["counts"], session["routes"])
    log(f"[session] launches on the path {session['counts']}, dequant_matmul by route "
        f"{session['routes']}; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    calib = _calibrate_phase(model, prog, dev, ops, prompt, clean_fps, session["arrivals_v3"])
    log(f"[calibrate] launches on the path {calib['counts']}, dequant_matmul by route "
        f"{calib['routes']}; {time.perf_counter() - t0:.1f} s")

    # -- 5. stage 8 one tensor at a time -------------------------------------
    # the accumulators after stage 7, stage 8's operands, and the batched
    # upgrade's result (the stage-8 accumulators: q of every tensor)
    upgrade_counts, acc, plane, shifts, out, per_tensor, slots = _upgrade_phase(prog, dev,
                                                                                ops)

    # -- 6. each kernel against its plain version on the path's operands ----
    kern: dict[str, dict] = {"plane_or": {"max_abs_err": 0},
                             "plane_extract": {"max_abs_err": 0},
                             "sharded_dequant_matmul": mesh["kern"]}
    # plane_or_segments: the accumulators after stage 7 and stage 8's plane
    exact = True
    chunk = 1 << 26
    for c0 in range(0, acc.numel(), chunk):
        sl = slice(c0, c0 + chunk)
        want = ref.plane_or_segments_ref(acc[sl], plane[sl], shifts[c0 // 1024:
                                         (c0 + chunk) // 1024], 1024)
        exact &= bool(torch.equal(out[sl], want))
    check(exact, "plane_or_segments differs from its plain version")
    kern["plane_or_segments"] = {"max_abs_err": 0}
    log(f"[check] plane_or_segments on the {acc.numel()}-element uint16 buffer: exact")

    # dequant_matmul: both routes at the paths' M (decode 4, the pool's
    # decode 8, a chunk tick 64, the prefill 256) on the live stage-8
    # accumulators of layer 0 and on embed.T, float32 and bfloat16 x, of
    # zero mean and of large positive mean
    P = srv.params
    l0 = layer(P["decoder"]["cycles"]["0_attn"], 0)
    weights = {"attn.wq": l0["attn"]["wq"], "mlp.wi_gate": l0["mlp"]["wi_gate"],
               "mlp.wo": l0["mlp"]["wo"], "embed.T": P["embed"].T}
    xg = torch.Generator(device=dev).manual_seed(2)
    routes = {"gemv": dqm._launch_gemv, "mma": dqm._launch_mma}
    route_err, worst = dict.fromkeys(routes, 0.0), {}
    for name, w in weights.items():
        K = w.q.shape[0]
        for M in DQMM_CHECK_M:
            for xkind in ("randn", "silu", "relu3"):
                x = torch.randn((M, K), generator=xg, device=dev)
                x = {"randn": x, "silu": torch.nn.functional.silu(2 * x),
                     "relu3": torch.relu(x) + 3}[xkind]
                for xd in (torch.float32, torch.bfloat16):
                    xt = x.to(xd)
                    yr = ref.dequant_matmul_ref(xt, w.q, w.scale, w.offset)
                    mag = float(yr.abs().max())
                    for kernel, launch in routes.items():
                        y = launch(xt, w.q, w.scale, w.offset)
                        err = float((y - yr).abs().max())
                        check(err <= DQMM_RTOL * mag, (name, M, xkind, xd, kernel, err, mag))
                        route_err[kernel] = max(route_err[kernel], err)
                        key = (name, M)
                        worst[key] = max(worst.get(key, 0.0), err / mag)
        log(f"[check] dequant_matmul {name} K={K} N={w.q.shape[1]} q strides "
            f"{tuple(w.q.stride())}, routes {list(routes)}, x randn / silu / "
            f"relu+3 in float32 and bfloat16: max |err| / max |y| by M "
            + ", ".join(f"{M}: {worst[(name, M)]:.2e}" for M in DQMM_CHECK_M)
            + f" (tolerance {DQMM_RTOL})")
    log(f"[check] dequant_matmul largest |err| by route: {route_err}")
    # below MMA_MIN_M a GEMV row does not depend on M: at the decode paths'
    # M every row of a launch equals (torch.equal) that row launched alone,
    # and a second launch repeats the first, in the dtypes the model passes
    for name, w in weights.items():
        xd = torch.float32 if name == "embed.T" else cfg.dtype
        for M in (BATCH, POOL_SLOTS):
            check(dqm.route(M, w.q.dtype) == "gemv", (name, M))
            x = torch.randn((M, w.q.shape[0]), generator=xg, device=dev).to(xd)
            y = dqm.dequant_matmul(x, w.q, w.scale, w.offset)
            check(torch.equal(dqm.dequant_matmul(x, w.q, w.scale, w.offset), y),
                  f"dequant_matmul {name} M={M}: two launches differ")
            for i in range(M):
                check(torch.equal(dqm.dequant_matmul(x[i:i + 1], w.q, w.scale, w.offset),
                                  y[i:i + 1]),
                      f"dequant_matmul {name}: row {i} of an M={M} launch differs alone")
    log(f"[check] dequant_matmul GEMV route on {list(weights)}: every row of an M = "
        f"{BATCH} and an M = {POOL_SLOTS} launch equal (torch.equal) to a 1-row launch, "
        f"and launches repeat bit for bit")
    # the plane mask as an operand: keep = 0, 2, 4, 8, 16 on both routes at
    # the paths' M, and on the forced GEMV route (rows="decode") at the
    # verify shapes, against the plain version on the masked q; a
    # full-width keep is bit-equal to the unmasked launch
    keep_err, keep_abs = dict.fromkeys(routes, 0.0), dict.fromkeys(routes, 0.0)
    keep_mag = 0.0
    for name, w in weights.items():
        K = w.q.shape[0]
        xd = torch.float32 if name == "embed.T" else cfg.dtype
        full = torch.full((1, 1), 16, dtype=torch.int32, device=dev)
        for M in DQMM_CHECK_M + VERIFY_M:
            x = (torch.relu(torch.randn((M, K), generator=xg, device=dev)) + 3).to(xd)
            kinds = routes if M in DQMM_CHECK_M else {"gemv": routes["gemv"]}
            for keep in KEEP_CHECK:
                kt = torch.full((1, 1), keep, dtype=torch.int32, device=dev)
                yr = ref.dequant_matmul_ref(x, w.q, w.scale, w.offset, kt)
                mag = float(yr.abs().max())
                keep_mag = max(keep_mag, mag)
                for kernel, launch in kinds.items():
                    err = float((launch(x, w.q, w.scale, w.offset, kt) - yr).abs().max())
                    check(err <= DQMM_RTOL * mag, (name, M, keep, kernel, err, mag))
                    keep_err[kernel] = max(keep_err[kernel], err / mag)
                    keep_abs[kernel] = max(keep_abs[kernel], err)
            for kernel, launch in kinds.items():
                check(torch.equal(launch(x, w.q, w.scale, w.offset, full),
                                  launch(x, w.q, w.scale, w.offset)),
                      f"{name} M={M} {kernel}: a full-width keep changes bits")
    log(f"[check] dequant_matmul with the plane mask keep = {list(KEEP_CHECK)} on "
        f"{list(weights)}, relu+3 x in the model's dtypes: both routes at M = "
        f"{list(DQMM_CHECK_M)}, the forced GEMV route at M = {list(VERIFY_M)}; max |err| / "
        f"max |y| by route {', '.join(f'{k} {v:.2e}' for k, v in keep_err.items())} "
        f"(tolerance {DQMM_RTOL}; max |err| {keep_abs}, largest max |y| {keep_mag:.1f}); a "
        f"full-width keep bit-equal to no keep")
    # the forced GEMV route (verify's rows="decode") at the verify shapes:
    # every row equal to that row launched alone, masked or not
    four = torch.full((1, 1), 4, dtype=torch.int32, device=dev)
    for name, w in weights.items():
        xd = torch.float32 if name == "embed.T" else cfg.dtype
        x = torch.randn((max(VERIFY_M), w.q.shape[0]), generator=xg, device=dev).to(xd)
        for kt in (None, four):
            alone = torch.cat([dqm.dequant_matmul(x[i:i + 1], w.q, w.scale, w.offset, kt,
                                                  rows="decode") for i in range(x.shape[0])])
            for M in VERIFY_M:
                y = dqm.dequant_matmul(x[:M], w.q, w.scale, w.offset, kt, rows="decode")
                check(torch.equal(y, alone[:M]), f"dequant_matmul {name} rows='decode' "
                      f"M={M} keep={kt is not None}: a row differs alone")
    log(f"[check] dequant_matmul rows='decode' on {list(weights)}: every row of an M = "
        f"{list(VERIFY_M)} launch equal (torch.equal) to that row launched alone, without "
        f"a mask and with keep = 4")
    # each route's entry in the kernels line carries its own largest error
    # unmasked; the masked checks' errors ride beside it
    kern["dequant_matmul"] = {"max_abs_err": route_err["gemv"], "keep_checked": KEEP_CHECK,
                              "keep_max_rel_err": keep_err, "keep_max_abs_err": keep_abs}

    # decode_attention: layer 0's live cache, slot 1 ragged (its keys past
    # position 40 empty), slot 3 free
    cache = layer(srv.caches["cycles"]["0_attn"], 0)
    S = cache["k"].shape[2]
    k_pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(BATCH, 1)
    k_pos[1, 41:] = -1
    q_pos = torch.tensor([S - 1, S - 1, 70, -1], dtype=torch.int32, device=dev)
    q = torch.randn((BATCH, cfg.n_heads, cfg.hd), generator=xg, device=dev).to(cfg.dtype)
    o = da.flash_decode(q, cache["k"], cache["v"], k_pos, q_pos)
    orf = ref.flash_decode_ref(q, cache["k"], cache["v"], k_pos, q_pos)
    check(bool(torch.isfinite(o).all()), "non-finite attention output")
    at_err = float((o.float() - orf).abs().max())
    check(at_err <= ATTN_RTOL * float(orf.abs().max()), at_err)
    kern["decode_attention"] = {"max_abs_err": at_err}
    log(f"[check] decode_attention B={BATCH} H={cfg.n_heads} S={S} hd={cfg.hd} "
        f"(ragged slot, free slot): max |err| {at_err:.3e}")

    # flash_verify: layer 0's live pooled cache, one chunk of rows per
    # slot: slot 1 ragged (keys past 45 empty) with a short final chunk,
    # slots 2 and 3 fully masked (free, and decoding), the rest live
    pcache = layer(pool.caches["cycles"]["0_attn"], 0)
    PS, T = pcache["k"].shape[2], POOL_CHUNK
    vk_pos = torch.arange(PS, dtype=torch.int32, device=dev).repeat(POOL_SLOTS, 1)
    vk_pos[1, 46:] = -1
    base = torch.tensor([PS - T, 40, -1, -1] + [16 * i for i in range(4, POOL_SLOTS)],
                        dtype=torch.int32, device=dev)
    vq_pos = torch.where(base[:, None] >= 0,
                         base[:, None] + torch.arange(T, dtype=torch.int32, device=dev), -1)
    vq_pos[1, 6:] = -1
    vq = torch.randn((POOL_SLOTS, T, cfg.n_heads, cfg.hd), generator=xg,
                     device=dev).to(cfg.dtype)
    vo = va.flash_verify(vq, pcache["k"], pcache["v"], vk_pos, vq_pos)
    vorf = ref.flash_verify_ref(vq, pcache["k"], pcache["v"], vk_pos, vq_pos)
    check(bool(torch.isfinite(vo).all()), "non-finite verify output")
    v_err = float((vo.float() - vorf).abs().max())
    check(v_err <= ATTN_RTOL * float(vorf.abs().max()), v_err)
    for t in range(T):
        row = da.flash_decode(vq[:, t].contiguous(), pcache["k"], pcache["v"], vk_pos,
                              vq_pos[:, t].contiguous())
        check(torch.equal(vo[:, t], row), f"flash_verify row {t} differs from flash_decode")
    kern["flash_verify"] = {"max_abs_err": v_err}
    # the verify shapes T = k + 1: every row equal to a flash_decode launch
    for T2 in VERIFY_T:
        qb = torch.randn((BATCH, T2, cfg.n_heads, cfg.hd), generator=xg,
                         device=dev).to(cfg.dtype)
        qp = (torch.arange(T2, dtype=torch.int32, device=dev)
              + torch.tensor([40, PS - T2, 7, 100], dtype=torch.int32, device=dev)[:, None])
        qp[2] = -1
        kp = vk_pos[:BATCH]
        out_v = va.flash_verify(qb, pcache["k"][:BATCH], pcache["v"][:BATCH], kp, qp)
        for t in range(T2):
            row = da.flash_decode(qb[:, t].contiguous(), pcache["k"][:BATCH],
                                  pcache["v"][:BATCH], kp, qp[:, t].contiguous())
            check(torch.equal(out_v[:, t], row), f"flash_verify T={T2} row {t} differs")
    log(f"[check] flash_verify at the verify shapes T = {list(VERIFY_T)} (B={BATCH}, one "
        f"slot masked): every row equal (torch.equal) to a flash_decode launch")
    # a verify step against sequential decode steps on the full-width model
    eng = spec["engine"]
    n_rounds = _verify_patterns(model, srv.params, eng.params, eng.draft_params, dev,
                                torch.Generator(device=dev).manual_seed(6))
    log(f"[check] verify_step vs sequential decode_step, {layers} layers full width, "
        f"batch {BATCH} ragged, k = 4 (draft 4 bits): after reject-all, alternate and "
        f"accept-all ({n_rounds} rounds), every verify row's logits and every cache row "
        f"equal (torch.equal)")
    log(f"[check] flash_verify B={POOL_SLOTS} T={T} H={cfg.n_heads} S={PS} hd={cfg.hd} "
        f"(ragged slot with a short chunk, free and decoding slots masked): max |err| "
        f"{v_err:.3e}; each of the {T} rows equal (torch.equal) to a flash_decode launch")

    # -- 7. whole path: 2 layers at full width, card against CPU, and the
    # queued CLIs' processes beside its CPU side -----------------------------
    t0 = time.perf_counter()
    BESIDE_PATH["olmo-1b"].append(lambda: _examples_wait("cuda", examples))
    with _beside(BESIDE_PATH.pop("olmo-1b"), BESIDE_GIB["olmo-1b"]):
        path_err, chunk_err = _whole_path(cfg, dev)
    log(f"[path] 2-layer full width, cuda kernels vs cpu plain versions, teacher-forced "
        f"logits at all 8 stages: max |err| / max |logit| = {path_err:.3e}; prefill "
        f"chunk and verify logits at stages 1 and 8: {chunk_err:.3e} (tolerance "
        f"{PATH_RTOL}); {time.perf_counter() - t0:.1f} s")
    # the examples' runs (on the CPU beside starcoder2-15b's [path], on the
    # card beside this one) against each other
    examples_launches = _examples_phase(examples)
    examples_dir.cleanup()
    log(f"[examples] launches on the card over the four examples {examples_launches}")

    # -- 8. timings at the path's shapes -------------------------------------
    # Device times replay CUDA graphs, so the host's launch rate does not
    # enter them; host_ms gives the host's side. Per-step operands walk
    # the 16 layers' own weights and caches, as decode does, so the 50 MB
    # L2 holds no layer's weights from the previous call.
    n = acc.numel()
    a16, p16 = acc.view(torch.int16), plane.view(torch.int16)
    sh = int(shifts[0])
    # a uniform schedule: one shift for the whole round
    check(bool((shifts == sh).all()), "shifts differ within the round")
    b, by = bound_ms(3 * 2 * n + 4 * (n // 1024), n * 2, FP32_FLOPS)
    kern["plane_or_segments"].update(
        ms=device_ms(lambda: bitplane.plane_or_segments(acc, plane, shifts), 5),
        plain_ms=device_ms(lambda: ref.plane_or_segments_ref(acc, plane, shifts, 1024), 2),
        library_ms=device_ms(lambda: torch.bitwise_or(a16, torch.bitwise_left_shift(p16, sh)),
                             5),
        host_ms=host_ms(lambda: bitplane.plane_or_segments(acc, plane, shifts), 5),
        bound_ms=b, bound_by=by, per="one upgrade launch")
    del a16, p16

    # plane_or: stage 8 one launch a tensor on the live stage-7 views
    def upgrade_each(fn):
        for a, p, s in per_tensor:
            fn(a, p, s)

    n_el = sum(a.numel() for a, _, _ in per_tensor)
    b, by = bound_ms(sum(2 * a.numel() * a.element_size() + p.numel() * p.element_size()
                         for a, p, _ in per_tensor), 2 * n_el, FP32_FLOPS)
    kern["plane_or"].update(
        ms=device_ms(lambda: upgrade_each(lambda a, p, s: bitplane.plane_or(a, p, shift=s)),
                     3),
        plain_ms=device_ms(lambda: upgrade_each(lambda a, p, s: ref.plane_or_ref(a, p, s)),
                           2),
        library_ms=device_ms(lambda: upgrade_each(lambda a, p, s: torch.bitwise_or(
            a.view(torch.int16), torch.bitwise_left_shift(p.to(torch.int16), s))), 3),
        host_ms=host_ms(lambda: upgrade_each(lambda a, p, s: bitplane.plane_or(a, p,
                                                                               shift=s)), 3),
        bound_ms=b, bound_by=by,
        per=f"one stage-8 upgrade, a launch a tensor ({len(per_tensor)} launches)")

    # plane_extract: one 2-bit plane of every tensor from its uint16 q (the
    # stage-8 accumulators are q, bit for bit), written as uint8
    qs = [out[t.offset:t.offset + t.size].reshape(t.shape) for t in slots]

    def extract_each(fn):
        for q in qs:
            fn(q)

    b, by = bound_ms(3 * n_el, 3 * n_el, FP32_FLOPS)
    kern["plane_extract"].update(
        ms=device_ms(lambda: extract_each(lambda q: bitplane.plane_extract(
            q, bits=16, before=6, width=2, out_dtype=torch.uint8)), 3),
        plain_ms=device_ms(lambda: extract_each(lambda q: ref.plane_extract_ref(
            q, 16, 6, 2, torch.uint8)), 2),
        library_ms=device_ms(lambda: extract_each(lambda q: torch.bitwise_right_shift(
            torch.bitwise_and(torch.bitwise_left_shift(q.to(torch.int32), 6), 0xFFFF),
            14).to(torch.uint8)), 2),
        host_ms=host_ms(lambda: extract_each(lambda q: bitplane.plane_extract(
            q, bits=16, before=6, width=2, out_dtype=torch.uint8)), 3),
        bound_ms=b, bound_by=by,
        per=f"one plane of the model, a launch a tensor ({len(qs)} launches)")
    del qs, out

    # dequant_matmul: the decode step's 113 launches (M = BATCH), a chunk
    # tick's 113 (M = slots x chunk) and the prefill's 112 layer launches
    # (M = BATCH x PROMPT), each in its path's order over the 16 layers'
    # own weights; bfloat16 x for the layers, float32 for the unembedding,
    # as the model passes them
    stack = P["decoder"]["cycles"]["0_attn"]
    layer_ws = [w for r in range(layers) for w in _layer_weights(layer(stack, r))]
    emb_w = P["embed"].T
    dense = {id(w): w.q.to(torch.float32) * w.scale.reshape(()) + w.offset.reshape(())
             for w in layer_ws + [emb_w]}

    def path_calls(M, unembed=True):
        xs = {k: torch.randn((M, k), generator=xg, device=dev).to(cfg.dtype)
              for k in (cfg.d_model, cfg.d_ff)}
        calls = [(xs[w.q.shape[0]], w) for w in layer_ws]
        if unembed:
            calls.append((torch.randn((M, cfg.d_model), generator=xg, device=dev), emb_w))
        return calls

    def run(calls, fn=dqm.dequant_matmul):
        for x, w in calls:
            fn(x, w.q, w.scale, w.offset)

    calls = path_calls(BATCH)
    check(len(calls) == per_step["dequant_matmul"], len(calls))
    for shape in sorted({tuple(w.q.shape) for _, w in calls}):
        sub = [(x, w) for x, w in calls if tuple(w.q.shape) == shape]
        K, N = shape
        b, by = _dqmm_bound(sub)
        log(f"[time] dequant_matmul M={BATCH} K={K} N={N} x{len(sub)} per step: kernel "
            f"{device_ms(lambda: run(sub), 3) * 1e3:.1f} us, bound {b * 1e3:.1f} us ({by})")

    def dqmm_row(calls, per, reps=3):
        b, by = _dqmm_bound(calls)
        xf = [(x.float(), dense[id(w)]) for x, w in calls]
        row = {"ms": device_ms(lambda: run(calls), reps),
               "plain_ms": device_ms(lambda: run(calls, ref.dequant_matmul_ref), 1),
               "library_ms": device_ms(lambda: [torch.matmul(x, w) for x, w in xf], reps),
               "host_ms": host_ms(lambda: run(calls), reps),
               "bound_ms": b, "bound_by": by, "per": per,
               "route_ms": {k: device_ms(lambda: run(calls, fn), reps)
                            for k, fn in routes.items()}}
        log(f"[time] dequant_matmul per {per}: kernel {row['ms']:.4f} ms on the device "
            f"(by route {', '.join(f'{k} {v:.4f}' for k, v in row['route_ms'].items())}), "
            f"bound {b:.4f} ms ({by}), plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms']:.4f} ms (torch.matmul on dequantised float32 weights); host "
            f"issue {row['host_ms']:.4f} ms")
        return row

    step = dqmm_row(calls, f"one decode step ({len(calls)} launches at M={BATCH})")
    kern["dequant_matmul"].update(step)
    calls = path_calls(POOL_SLOTS)
    kern["dequant_matmul"]["pool_step"] = dqmm_row(
        calls, f"one pool decode step ({len(calls)} launches at M={POOL_SLOTS})")
    tick_M, prefill_M = POOL_SLOTS * POOL_CHUNK, BATCH * PROMPT
    calls = path_calls(tick_M)
    kern["dequant_matmul"]["tick"] = dqmm_row(
        calls, f"one chunk tick ({len(calls)} launches at M={tick_M})", 2)
    calls = path_calls(prefill_M, unembed=False)
    kern["dequant_matmul"]["prefill"] = dqmm_row(
        calls, f"one prefill's layer weights ({len(calls)} launches at M={prefill_M})", 2)
    del calls

    # both routes at every M, on layer 0's seven weights and on embed.T:
    # the measurements that set dequant_matmul.MMA_MIN_M
    by_m = {}
    for M in DQMM_TIME_M:
        calls = path_calls(M)
        groups = {"layer 0": calls[:7], "embed.T": calls[-1:]}
        by_m[M] = {g: {k: device_ms(lambda: run(sub, fn), 3) for k, fn in routes.items()}
                   for g, sub in groups.items()}
        log(f"[time] dequant_matmul M={M} (route {dqm.route(M, torch.uint16)}): "
            + "; ".join(f"{g} " + ", ".join(f"{k} {t:.4f} ms" for k, t in r.items())
                        for g, r in by_m[M].items()))
    kern["dequant_matmul"]["by_M"] = by_m
    del dense, calls

    # the plane mask's cost: a decode step's 113 launches with keep = 4
    # against the full-width keep, in one call
    calls = path_calls(BATCH)
    keeps = {"keep=4": four, "keep=16": torch.full((1, 1), 16, dtype=torch.int32, device=dev)}
    mask_ms = {}
    for rep_i in range(2):
        for label, kt in keeps.items():
            mask_ms.setdefault(label, []).append(device_ms(lambda: [
                dqm.dequant_matmul(x, w.q, w.scale, w.offset, kt) for x, w in calls], 3))
    log(f"[time] dequant_matmul plane mask, one decode step ({len(calls)} launches at "
        f"M={BATCH}), two turns each: " + ", ".join(f"{k} {v[0]:.4f}, {v[1]:.4f} ms"
                                                   for k, v in mask_ms.items()))
    kern["dequant_matmul"]["mask_ms"] = mask_ms
    del calls
    kern["dequant_matmul"]["verify_step"] = _verify_timings(model, spec["engine"], dev, xg)

    # decode_attention: the decode step's 16 launches, one per layer's cache
    caches = [layer(srv.caches["cycles"]["0_attn"], r) for r in range(layers)]
    valid = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    mask = torch.where(valid, 0.0, -1e30).to(cfg.dtype)[:, None, None, :]
    kv_bytes = 2 * cache["k"].numel() * cache["k"].element_size()
    n_b = kv_bytes + 2 * q.numel() * q.element_size() + k_pos.numel() * 4 + BATCH * 4
    n_ops = 4 * BATCH * cfg.n_heads * S * cfg.hd
    b, by = bound_ms(layers * n_b, layers * n_ops, attn_flops(cache["k"].dtype))
    kern["decode_attention"].update(
        **_attention_times(
            lambda: [da.flash_decode(q, c["k"], c["v"], k_pos, q_pos) for c in caches],
            lambda: [ref.flash_decode_ref(q, c["k"], c["v"], k_pos, q_pos) for c in caches],
            lambda: [_sdpa(q[:, None], c, mask) for c in caches], (5, 5, 5)),
        bound_ms=b, bound_by=by, per=f"one decode step ({layers} launches)")

    # flash_verify: one chunk tick's 16 launches, one per layer's pooled cache
    pcaches = [layer(pool.caches["cycles"]["0_attn"], r) for r in range(layers)]
    vvalid = (vk_pos[:, None, :] >= 0) & (vk_pos[:, None, :] <= vq_pos[:, :, None]) \
        & (vq_pos[:, :, None] >= 0)
    vmask = torch.where(vvalid, 0.0, -1e30).to(cfg.dtype)[:, None]   # (B, 1, T, S)
    kv_bytes = 2 * pcache["k"].numel() * pcache["k"].element_size()
    n_b = kv_bytes + 2 * vq.numel() * vq.element_size() + vk_pos.numel() * 4 \
        + vq_pos.numel() * 4
    n_ops = 4 * POOL_SLOTS * T * cfg.n_heads * PS * cfg.hd
    b, by = bound_ms(layers * n_b, layers * n_ops, attn_flops(pcache["k"].dtype))
    kern["flash_verify"].update(
        **_attention_times(
            lambda: [va.flash_verify(vq, c["k"], c["v"], vk_pos, vq_pos) for c in pcaches],
            lambda: [ref.flash_verify_ref(vq, c["k"], c["v"], vk_pos, vq_pos)
                     for c in pcaches],
            lambda: [_sdpa(vq, c, vmask) for c in pcaches], (5, 3, 5)),
        bound_ms=b, bound_by=by, per=f"one chunk tick ({layers} launches)")

    # both attention kernels at long caches, where the body's ring cycles
    for S_long in ATTN_LONG_S:
        for name, row in _attention_long(cfg, dev, xg, S_long, da, va, ref).items():
            kern[name].setdefault("by_S", {})[S_long] = row

    # one whole chunk tick of the pool (every slot consuming 8 prompt rows)
    # and its unembedding: the transposed 206 MB embed.T at M = 64
    tick_pos = (torch.arange(POOL_SLOTS, dtype=torch.int32, device=dev)[:, None] * 8
                + torch.arange(T, dtype=torch.int32, device=dev))
    tick_tok = torch.randint(0, cfg.vocab, (POOL_SLOTS, T), generator=xg, device=dev,
                             dtype=torch.int32)
    final = torch.full((POOL_SLOTS,), T - 1, dtype=torch.int32, device=dev)

    def tick():
        _chunk_step(model, pool.params, pool.caches, tick_tok, tick_pos, final, pool.pos,
                    pool.last_logits, pool._last_tok, pool._first_cap)

    emb = pool.params["embed"].T
    x64 = torch.randn((POOL_SLOTS * T, cfg.d_model), generator=xg, device=dev)
    tick_ms, tick_host_ms = device_ms(tick, 2), host_ms(tick, 3)
    unembed = {k: device_ms(lambda: fn(x64, emb.q, emb.scale, emb.offset), 5)
               for k, fn in routes.items()}
    unembed_bound, by = _dqmm_bound([(x64, emb)])
    log(f"[time] pool chunk tick ({POOL_SLOTS} slots x {T} rows, all live): "
        f"{tick_ms:.3f} ms on the device, host issue {tick_host_ms:.3f} ms; its "
        f"unembedding (dequant_matmul M={x64.shape[0]} on embed.T {tuple(emb.q.shape)}, "
        f"float32 x) on the device: " + ", ".join(f"{k} {t:.4f} ms" for k, t in unembed.items())
        + f", bound {unembed_bound:.4f} ms ({by})")

    # the single stream's prefill alone: a (BATCH, PROMPT) prompt at stage 8
    prompt_dev = prompt.to(dev)
    prefill_ms = device_ms(lambda: model.prefill(srv.params, {"tokens": prompt_dev}), 1)
    prefill_host_ms = host_ms(lambda: model.prefill(srv.params, {"tokens": prompt_dev}), 1)
    log(f"[time] single-stream prefill ({BATCH} x {PROMPT} tokens, stage 8): "
        f"{prefill_ms:.3f} ms on the device, host issue {prefill_host_ms:.3f} ms")

    sources = {"plane_or_segments": ("plane_or.cu", "src/repro/kernels/bitplane.py:89"),
               "dequant_matmul": ("dequant_matmul.cu",
                                  "src/repro/kernels/dequant_matmul.py:70"),
               "decode_attention": ("decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:101"),
               "flash_verify": ("verify_attention.cu",
                                "src/repro/kernels/verify_attention.py:91"),
               "plane_or": ("plane_or.cu", "src/repro/kernels/bitplane.py:53"),
               "plane_extract": ("plane_extract.cu", "src/repro/kernels/bitplane.py:149"),
               # B7: a B2 launch a shard with n_split = N, over the two B2 sources
               "sharded_dequant_matmul": ("src/repro_torch/kernels/ops.py",
                                          "src/repro/kernels/ops.py:76")}
    # launches on the main paths, each path counted from 0
    paths = {"divide": divide_counts, "serve": path_counts, "pool": pool_counts,
             "spec": spec["counts"], "spec pool": spec_pool["counts"],
             "wire": wire_counts, "session": session["counts"],
             "upgrade per tensor": upgrade_counts, "quantized view": view["counts"],
             "pool batch-1": batch1["counts"], "calibrate": calib["counts"],
             "mesh": mesh["counts"], "telemetry": telemetry["counts"],
             **{k: r["counts"] for k, r in arch_runs.items()}}
    launches = {name: sum(c.get(name, 0) for c in paths.values()) for name in sources}
    check(all(launches[name] > 0 for name in sources), launches)
    # dequant_matmul's launches by route on the paths that run it
    route_paths = {"serve": serve_routes, "pool": pool_routes, "spec": spec["routes"],
                   "spec pool": spec_pool["routes"], "wire": wire_routes,
                   "session": session["routes"], "quantized view": view["routes"],
                   "pool batch-1": batch1["routes"], "calibrate": calib["routes"],
                   "mesh": mesh["routes"], "telemetry": telemetry["routes"],
                   **{k: r["routes"] for k, r in arch_runs.items()}}
    by_route = {k: sum(r[k] for r in route_paths.values()) for k in dqm.launches_by_route}
    check(sum(by_route.values()) == launches["dequant_matmul"] and all(by_route.values()),
          (by_route, launches["dequant_matmul"]))
    log(f"[time] dequant_matmul launches by route on the paths: {by_route} ("
        + ", ".join(f"{p} {r}" for p, r in route_paths.items()) + ")")
    dq = kern["dequant_matmul"]
    dq["launches_by_route"] = by_route
    # one entry a CUDA kernel: dequant_matmul's launches are its GEMV
    # kernel's, the tensor-core kernel's are dequant_matmul_mma's (the
    # wrapper's count, ops.LAUNCH_COUNTS["dequant_matmul"], is their sum);
    # the tensor-core kernel's row is the chunk tick
    kern["dequant_matmul_mma"] = {**dq["tick"], "max_abs_err": route_err["mma"]}
    sources["dequant_matmul_mma"] = ("dequant_matmul_mma.cu",
                                     "src/repro/kernels/dequant_matmul.py:70")
    launches["dequant_matmul"], launches["dequant_matmul_mma"] = by_route["gemv"], by_route["mma"]
    line = []
    for name, (src, replaces) in sources.items():
        k = kern[name]
        dq_route = {"dequant_matmul": "gemv", "dequant_matmul_mma": "mma"}.get(name)
        per_path = ({p: r[dq_route] for p, r in route_paths.items()} if dq_route
                    else {p: c.get(name, 0) for p, c in paths.items()})
        log(f"[time] {name} per {k['per']}: kernel {k['ms']:.4f} ms on the device, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), plain {k['plain_ms']:.4f} ms, "
            f"library {k['library_ms']:.4f} ms; host issue {k['host_ms']:.4f} ms; "
            f"launches on the paths {launches[name]} ("
            + ", ".join(f"{p} {n}" for p, n in per_path.items()) + ")")
        entry = {"name": name, "route": "cuda",
                 "source": src if src.startswith("src/") else f"src/repro_torch/kernels/csrc/{src}",
                 "replaces": replaces,
                 "launches": launches[name], "max_abs_err": k["max_abs_err"],
                 "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                 "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        if name == "dequant_matmul":
            entry.update({key: dq[key] for key in ("launches_by_route", "pool_step", "tick",
                                                   "prefill", "by_M", "keep_checked",
                                                   "keep_max_rel_err", "keep_max_abs_err",
                                                   "mask_ms", "verify_step")})
        if "by_S" in k:
            entry["by_S"] = k["by_S"]
        if name == "sharded_dequant_matmul":
            entry.update(b2_ms=k["b2_ms"], by_shards=k["by_shards"])
        by_arch = {a: r["kern"][name] for a, r in arch_runs.items() if name in r["kern"]}
        if by_arch:
            entry["by_arch"] = by_arch
        line.append(entry)
    log(f"[done] {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _divide_phase(model, dev, ops):
    """``[divide]``: random full-width weights split into planes on the
    card, counted from 0; then the in-memory receiver through all 8
    stages, its fingerprint after each (the wire phase's reference), and
    its stage-8 accumulators against ``quantize(leaf).q`` of every tensor;
    every plane of the largest tensor against the plain version. Returns
    the divided model, the parameter count, the 8 fingerprints and the
    path's launch counts."""
    from repro_torch.core.bitplanes import concat
    from repro_torch.core.progressive import ReceiverState, divide, tree_flatten_with_path
    from repro_torch.core.quantize import quantize
    from repro_torch.kernels import bitplane, ref

    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    leaves = dict(tree_flatten_with_path(params))
    n_params = sum(t.numel() for t in leaves.values())
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    reset_counts(ops)
    t0 = time.perf_counter()
    prog = divide(params)
    torch.cuda.synchronize()
    t_divide = time.perf_counter() - t0
    run_counts, op_counts = counts(), dict(ops.LAUNCH_COUNTS)
    n_t = len(prog.tensors)
    check(run_counts["plane_extract"] == op_counts["plane_extract"] == 8 * n_t,
          (run_counts, n_t))
    check(sum(run_counts.values()) == 8 * n_t and op_counts == {"plane_extract": 8 * n_t},
          (run_counts, op_counts))
    log(f"[divide] olmo-1b full width: {n_params} parameters, {n_t} tensors, "
        f"{prog.n_stages} stages of 2-bit planes; init {t_init:.1f} s, divide on the card "
        f"{t_divide:.2f} s; launches {run_counts}")

    state = ReceiverState.init(prog, device=dev)
    fps = []
    for s in range(1, prog.n_stages + 1):
        state = state.receive(prog.stage(s))
        fps.append(state.store.fingerprint())
    for i, t in enumerate(prog.tensors):
        check(torch.equal(state.store._slice_acc(i), quantize(leaves[t.path], 16).q),
              f"stage-8 accumulator of {t.path} differs from quantize(leaf).q")
    del state
    big = max(prog.tensors, key=lambda t: int(np.prod(t.shape)))
    q = quantize(leaves[big.path], 16).q
    before = 0
    for w, p in zip(big.plan.schedule.widths, big.planes):
        got = bitplane.plane_extract(q, bits=16, before=before, width=w, out_dtype=torch.uint8)
        check(torch.equal(got, ref.plane_extract_ref(q, 16, before, w, torch.uint8))
              and torch.equal(got, p), f"plane at {before} of {big.path}")
        before += w
    wide = bitplane.plane_extract(q, bits=16, before=3, width=9)
    check(torch.equal(wide, ref.plane_extract_ref(q, 16, 3, 9)), "uint16 plane")
    check(torch.equal(concat(big.planes, 16, big.plan.schedule.widths), q),
          "concat of the planes differs from q")
    log(f"[divide] stage-8 accumulators equal quantize(leaf).q of all {n_t} tensors, bit "
        f"for bit; fingerprints after each stage {[fp['uint16'] for fp in fps]}; the 8 "
        f"planes of {'/'.join(big.path)} {tuple(big.shape)} (and a 9-bit uint16 plane) "
        f"equal the plain version, and concat of them (plane_or) restores its q")
    del params, leaves, q
    return prog, n_params, fps, run_counts


def _ragged(rng) -> int:
    """A chunk size, log-uniform from 1 byte to CHUNK_MAX."""
    return int(np.exp(rng.uniform(0.0, np.log(CHUNK_MAX))))


def _feeder(client, blob, seed):
    """``feed_to(end)`` feeds the next bytes of ``blob`` up to ``end`` in
    seeded ragged chunks and returns the host seconds it took."""
    view, rng, fed = memoryview(blob), np.random.default_rng(seed), [0]

    def feed_to(end: int) -> float:
        t0 = time.perf_counter()
        pos = fed[0]
        while pos < end:
            n = min(end - pos, _ragged(rng))
            client.feed(view[pos:pos + n])
            pos += n
        fed[0] = end
        return time.perf_counter() - t0

    return feed_to


def _stage_ends(wire, blob) -> tuple[dict, list[int]]:
    meta, hdr = wire.decode_header(blob)
    ends = [hdr]
    for n in wire.layout_from_header(meta, hdr).stage_bytes:
        ends.append(ends[-1] + n)
    return meta, ends


def _wire_phase(model, prog, dev, ops, prompt, res, clean_fps, serve_routes) -> tuple:
    """``[wire]``: the single stream of phase 3 served from v3 wire bytes
    through a CUDA ProgressiveClient, counted from 0 (encode, feed,
    ingest, serve); then a damaged unit on a second feed. Returns the
    path's launch counts and ``dequant_matmul``'s launches by route, which
    equal the in-memory server's."""
    from repro_torch.core import wire
    from repro_torch.serving.engine import ProgressiveServer, WireStoreReceiver
    from repro_torch.transmission import ProgressiveClient

    n_el = sum(t.planes[0].numel() for t in prog.tensors)
    reset_counts(ops)
    t0 = time.perf_counter()
    blob = wire.encode(prog, integrity=True)
    t_encode = time.perf_counter() - t0
    meta, ends = _stage_ends(wire, blob)
    n_units = len(meta["units"])
    check(ends[-1] == len(blob) and len(meta["checkpoints"]) == 8, (ends[-1], len(blob)))
    # the quantized model's 16 bits a weight, plus the v3 frames only
    check(len(blob) - ends[0] == 2 * n_el + n_units * wire.FRAME_BYTES_V3,
          (len(blob), ends[0], n_el, n_units))
    log(f"[wire] encode v3 {t_encode:.2f} s: {len(blob)} bytes, header {ends[0]}, "
        f"{n_units} units, framing {wire.framing_overhead(meta)['overhead_bytes']} bytes")

    snaps = []
    client = ProgressiveClient(on_stage_complete=lambda s: snaps.append(client.store.copy()),
                               device=dev)
    feed_to = _feeder(client, blob, 5)
    feed_s = [feed_to(ends[1])]
    checked = FiniteLogits(model)
    srv = ProgressiveServer(checked, prog, max_len=PROMPT + STEPS, resident="quantized",
                            device=dev, receiver=WireStoreReceiver(client, prog))

    def arrive(i: int) -> bool:
        if i not in ARRIVALS:
            return False
        feed_s.append(feed_to(ends[client.stages_complete + 1]))
        return True

    srv.receive_stage()
    srv.start({"tokens": prompt})
    wres = srv.decode(STEPS, stage_arrival=arrive)
    torch.cuda.synchronize()
    run_counts, op_counts, routes = counts(), dict(ops.LAUNCH_COUNTS), route_counts()
    gemv_by = check_one_pass(routes, "wire")
    decode_s = sum(s for _, s in wres.window_s)
    check(client.complete and client.bytes_fed == len(blob) and srv.stage == 8)
    check(wres.upgrades == res.upgrades, (wres.upgrades, res.upgrades))
    check(torch.equal(wres.tokens, res.tokens), "wire-fed tokens differ from phase 3's")
    check(bool(torch.stack(checked.flags).all()), "non-finite wire-fed logits")
    check(srv.resident_report()["fp_bytes"] == 0)
    check(run_counts["plane_or_segments"] == op_counts["plane_or_segments"] == 8, run_counts)
    check(run_counts["dequant_matmul"] > 0 and run_counts["decode_attention"] > 0
          and run_counts["plane_extract"] == run_counts["plane_or"] == 0, run_counts)
    check(routes == serve_routes, (routes, serve_routes))
    got = [st.fingerprint() for st in snaps]
    check(got == clean_fps, "wire-fed store fingerprints differ from the in-memory ones")
    del snaps
    log(f"[wire] fed in seeded ragged chunks of 1 B to {CHUNK_MAX >> 20} MB, one stage at "
        f"each arrival: host feed s per stage {[round(f, 3) for f in feed_s]}, "
        f"{len(blob) / sum(feed_s) / 1e9:.3f} GB/s; store fingerprint equal to the "
        f"in-memory receiver's after each of the 8 stages")
    log(f"[wire] served: {STEPS} steps x {BATCH} with 7 upgrades and the feeding in "
        f"{decode_s:.3f} s, {BATCH * STEPS / decode_s:.1f} tokens/s; tokens equal "
        f"(torch.equal) to the in-memory server's; launches {run_counts}, dequant_matmul "
        f"by route {routes}, GEMV route by kernel {gemv_by}; health "
        f"{srv._receiver.transport_health()}")
    del srv, client

    # a second feed with one byte of a stage-3 unit flipped
    seq = meta["checkpoints"][1] + int(np.argmax(meta["unit_bytes"][meta["checkpoints"][1]:
                                                                   meta["checkpoints"][2]]))
    layout = wire.layout_from_header(meta, ends[0])
    o = layout.unit_offsets()[seq]
    e = o + meta["unit_bytes"][seq]
    flip = o + (e - o) // 2
    client = ProgressiveClient(device=dev)
    feed = _feeder(client, blob, 6)
    feed(ends[0])
    ingest_ms, orig = [], client.store.ingest

    def timed_ingest(items):
        torch.cuda.synchronize()
        t = time.perf_counter()
        orig(items)
        torch.cuda.synchronize()
        ingest_ms.append((time.perf_counter() - t) * 1e3)

    client.store.ingest = timed_ingest
    feed(flip)
    client.feed(bytes([blob[flip] ^ 0x20]))
    _feeder(client, memoryview(blob)[flip + 1:], 7)(len(blob) - flip - 1)
    check(client.stages_complete == 2 and not client.complete, client.stages_complete)
    check(list(client.nacks) == [seq] and client.quarantine_log[0]["seq"] == seq,
          client.quarantine_log)
    check(client.store.fingerprint() == clean_fps[1], "damaged stream diverged at stage 2")
    check(client.feed_repair(seq, memoryview(blob)[o:e]), "repair refused")
    check(client.complete and not client.nacks, client.nacks)
    check(client.store.fingerprint() == clean_fps[-1], "repaired store differs")
    log(f"[wire] unit {seq} of stage 3 ({e - o} bytes) damaged: quarantined "
        f"({client.quarantine_log[0]['reason'][:40]}...), stages held at 2 with the "
        f"clean stage-2 fingerprint; after feed_repair all 8 stages, fingerprint equal to "
        f"the clean one; ingest ms a stage (synchronised) "
        f"{[round(t, 2) for t in ingest_ms]}")
    return run_counts, routes, blob


class LogitLog:
    """Wraps a Model: keeps a copy of the logits of every prefill, decode
    step and prefill chunk, on the device, in call order."""

    def __init__(self, model):
        self.model = model
        self.logits: list[torch.Tensor] = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, params, batch, n_valid=None):
        logits, caches = self.model.prefill(params, batch, n_valid)
        self.logits.append(logits.clone())
        return logits, caches

    def decode_step(self, params, caches, tokens, pos):
        logits, caches = self.model.decode_step(params, caches, tokens, pos)
        self.logits.append(logits.clone())
        return logits, caches

    def prefill_chunk(self, params, caches, tokens, tok_pos):
        logits, caches = self.model.prefill_chunk(params, caches, tokens, tok_pos)
        self.logits.append(logits.clone())
        return logits, caches


def _mesh_phase(model, prog, dev, ops, prompt, blob) -> dict:
    """``[mesh]``: sharded serving on logical shards of the one card,
    ``make_serving_mesh(n, devices=[card] * n)``. The single-device runs
    come first; then, counted from 0, the same runs at
    ``MESH_SERVE_SHARDS`` shards: ``ProgressiveServer`` quantized (every
    logit and token ``torch.equal``), the slot pool on the pool phase's
    requests (the same), ``SpeculativeEngine`` at stage 8 (tokens equal
    to plain) and the float-resident server (logits within
    ``FP_LOGIT_RTOL``, tokens equal where the margin clears it). Then the
    v3 bytes through ``ProgressiveClient(mesh=)`` at ``MESH_STORE_SHARDS``
    shards, a stage at a time, every leaf gathered equal to the
    single-device store's; then B7 against B2 on both routes and layouts
    at every M of ``MESH_B7_M``, with and without a mask, bit for bit, and
    against its plain version; then its times. Returns the path's launch
    counts and routes and the kernels line's B7 entry."""
    from repro_torch.core.plane_store import ShardedLeaf
    from repro_torch.core.progressive import ReceiverState
    from repro_torch.core import wire
    from repro_torch.kernels import dequant_matmul as dqm
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.transformer import layer
    from repro_torch.serving.engine import (PoolRequest, ProgressiveServer, SlotPoolEngine,
                                            WireStoreReceiver)
    from repro_torch.serving.speculative import SpecConfig, SpeculativeEngine
    from repro_torch.transmission import ProgressiveClient

    t_phase = time.perf_counter()
    cfg, layers = model.cfg, model.cfg.n_layers
    meshes = {n: make_serving_mesh(n, devices=[dev] * n)
              for n in (MESH_SERVE_SHARDS, MESH_STORE_SHARDS)}
    for n, mesh in meshes.items():
        log(f"[mesh] {n} logical shards on 1 card: {mesh.describe()}; this checks "
            f"placement, ingest and arithmetic, not the time of copies between cards")
    lengths, budgets, prompts = _pool_requests(cfg)

    def serve(mesh, resident):
        rec = LogitLog(model)
        srv = ProgressiveServer(rec, prog, max_len=PROMPT + STEPS, resident=resident,
                                mesh=mesh, device=dev)
        srv.receive_stage()
        srv.start({"tokens": prompt})
        res = srv.decode(STEPS, stage_arrival=lambda i: i in ARRIVALS)
        torch.cuda.synchronize()
        return srv, res, rec.logits

    def pool_run(mesh):
        rec = LogitLog(model)
        pool = SlotPoolEngine(rec, prog, n_slots=POOL_SLOTS, max_len=POOL_MAX_LEN,
                              resident="quantized", dispatch_window=POOL_WINDOW,
                              prefill_chunk=POOL_CHUNK, mesh=mesh, device=dev)
        t0 = time.perf_counter()
        pool.receive_stage()
        for rid in range(POOL_REQUESTS):
            pool.submit(PoolRequest(rid=rid, prompt=prompts[rid],
                                    max_new_tokens=int(budgets[rid])))
        out = pool.run(on_window=lambda _: pool.upgrade_if_available())
        torch.cuda.synchronize()
        return pool, out, rec.logits, time.perf_counter() - t0

    # single device, not counted
    srv1, res1, logits1 = serve(None, "quantized")
    logits1 = list(logits1)      # srv1 decodes again below, for the speculation
    pool1, out1, plog1, pool1_s = pool_run(None)
    slog1 = pool1.stage_log
    del pool1
    fsrv1, fres1, flog1 = serve(None, "fp")
    del fsrv1
    srv1.start({"tokens": prompt})                  # stage 8, the speculation's plain run
    plain8 = srv1.decode(SPEC_TOKENS).tokens
    torch.cuda.synchronize()

    # sharded, counted from 0
    n = MESH_SERVE_SHARDS
    mesh = meshes[n]
    reset_counts(ops)
    srv2, res2, logits2 = serve(mesh, "quantized")
    pool2, out2, plog2, pool2_s = pool_run(mesh)
    spec = SpeculativeEngine(model, prog, max_len=PROMPT + SPEC_TOKENS + 9,
                             spec=SpecConfig(draft_bits=4, k=4), mesh=mesh, device=dev)
    for _ in range(prog.n_stages):
        spec.receive_stage()
    spec.start({"tokens": prompt})
    sres = spec.decode(SPEC_TOKENS)
    fsrv2, fres2, flog2 = serve(mesh, "fp")
    torch.cuda.synchronize()
    run_counts, op_counts, routes = counts(), dict(ops.LAUNCH_COUNTS), route_counts()
    gemv_by = check_one_pass(routes, "mesh")

    # every logit and token of the quantized runs equal to one device's
    check(len(logits1) == len(logits2) == 1 + STEPS, (len(logits1), len(logits2)))
    check(all(torch.equal(a, b) for a, b in zip(logits1, logits2)),
          "[mesh] sharded server logits differ from one device's")
    check(torch.equal(res1.tokens, res2.tokens) and res1.upgrades == res2.upgrades,
          "[mesh] sharded server tokens differ from one device's")
    check(res2.stage_at_step == res1.stage_at_step and srv2.stage == 8, res2.stage_at_step)
    check(out1 == out2 and pool2.stage_log == slog1,
          "[mesh] sharded pool tokens differ from one device's")
    check(len(plog1) == len(plog2) and all(torch.equal(a, b) for a, b in zip(plog1, plog2)),
          "[mesh] sharded pool logits differ from one device's")
    check(pool2.stage == 8 and all(u["sharded"] for u in pool2.upgrade_log), pool2.stage)
    check(torch.equal(sres.tokens, plain8.cpu()), "[mesh] speculative tokens differ from plain")
    check(sres.drafted > 0 and spec.resident_report()["extra_draft_bytes"] == 0,
          (sres.drafted, spec.resident_report()["extra_draft_bytes"]))
    # float residency: cuBLAS may sum a shard's N/n columns in another
    # order than the whole N, so the sharded logits are held to the float
    # path's tolerance (FP_LOGIT_RTOL) and tokens wherever the margin clears
    fp_err, fp_checked, fp_near = _fp_against_quantized(flog2, flog1, fres2.tokens,
                                                        fres1.tokens)
    fp_equal = int((fres2.tokens == fres1.tokens).sum())
    rep1, rep2 = srv1.resident_report(), srv2.resident_report()
    check(rep2["quantized_bytes"] == rep1["quantized_bytes"] and rep2["fp_bytes"] == 0, rep2)
    # what the stores hold: the sharded one keeps the gathered embed on the
    # home device beside its split accumulators
    acc1, acc2 = srv1.state.store.resident_bytes(), srv2.state.store.resident_bytes()
    fgath = fsrv2.resident_report()["gathered_bytes"]
    eq = srv1.params["embed"].q
    check(rep2["gathered_bytes"] == eq.numel() * eq.element_size()
          and fgath == eq.numel() * 4, (rep2["gathered_bytes"], fgath))
    # launches: every layer weight through B7 (n B2 launches each), the
    # unembedding on the gathered embed through B2; one plane OR a shard a stage
    n_b7 = op_counts.get("sharded_dequant_matmul", 0)
    check(run_counts["sharded_dequant_matmul"] == n_b7 > 0, (run_counts, op_counts))
    check(run_counts["dequant_matmul"] == n * n_b7 + op_counts["dequant_matmul"],
          (run_counts, op_counts))
    check(n_b7 == layers * 7 * (1 + STEPS + pool2._tick_count + pool2._step_count
                                + 1 + _b2_steps(sres.accept_rounds)[0]
                                + _b2_steps(sres.accept_rounds)[1]), (n_b7, op_counts))
    check(run_counts["plane_or_segments"] == n * 8 * 4 and run_counts["plane_or"] == 0,
          run_counts)
    q_tok_s = {"1 card": BATCH * STEPS / sum(s for _, s in res1.window_s),
               f"{n} shards": BATCH * STEPS / sum(s for _, s in res2.window_s)}
    n_pool = sum(len(t) for t in out1.values())
    pool_tok_s = {"1 card": n_pool / pool1_s, f"{n} shards": n_pool / pool2_s}
    log(f"[mesh] {n} shards, counted from 0: ProgressiveServer quantized ({BATCH} x "
        f"{STEPS} steps, 8 stages): {len(logits2)} logits and every token equal "
        f"(torch.equal) to one device's; the pool ({POOL_REQUESTS} requests, "
        f"{pool2._tick_count} ticks, {pool2._step_count} steps): {len(plog2)} logits and "
        f"every token equal; SpeculativeEngine at stage 8 (k = 4, draft 4 bits, "
        f"{sres.accepted}/{sres.drafted} drafts accepted): tokens equal to plain; float "
        f"residency: logits within {fp_err:.3e} of one device's largest (tolerance "
        f"{FP_LOGIT_RTOL}), {fp_checked} tokens checked equal, {fp_near} near ties, "
        f"{fp_equal}/{fres1.tokens.numel()} tokens equal")
    log(f"[mesh] launches in the run {run_counts}; B7 calls {n_b7} ({n} B2 launches each), "
        f"B2 by route {routes}, GEMV route by kernel {gemv_by}")
    log(f"[mesh] tokens/s, in the same phase: ProgressiveServer {q_tok_s}; pool "
        f"{pool_tok_s}; the gathered embed (a copy at each upgrade that touches it): "
        f"{rep2['gathered_bytes']} bytes quantized, {fgath} bytes float")
    log(f"[mesh] store bytes at stage 8, quantized: one device {acc1} accumulator bytes; "
        f"{n} shards {acc2} accumulator bytes + {rep2['gathered_bytes']} gathered = "
        f"{acc2 + rep2['gathered_bytes']} ({(acc2 + rep2['gathered_bytes']) / acc1 - 1:+.4%}); "
        f"float residency holds {fgath} gathered bytes beside its float leaves")
    del pool2, fsrv2, plog1, plog2, flog1, flog2, spec

    # the store from wire bytes at MESH_STORE_SHARDS shards, a stage at a time
    n4 = MESH_STORE_SHARDS
    meta, ends = _stage_ends(wire, blob)
    client = ProgressiveClient(mesh=meshes[n4], device=dev)
    state = ReceiverState.init(prog, device=dev)
    client.feed(memoryview(blob)[:ends[0]])
    reset_counts(ops)
    ingest = []
    for s in range(1, prog.n_stages + 1):
        before = ops.LAUNCH_COUNTS["plane_or_segments"]
        client.feed(memoryview(blob)[ends[s - 1]:ends[s]])
        ingest.append(ops.LAUNCH_COUNTS["plane_or_segments"] - before)
        state = state.receive(prog.stage(s))
        mine, want = client.store.quantized_leaves(), state.store.quantized_leaves()
        for key, leaf in mine.items():
            whole = leaf.gather() if isinstance(leaf, ShardedLeaf) else leaf
            w = want[tuple(key.split("/"))]
            check(torch.equal(whole.q, w.q) and torch.equal(whole.offset, w.offset),
                  f"[mesh] store leaf {key} differs from one device's at stage {s}")
    check(client.complete and ingest == [n4] * 8 and ops.LAUNCH_COUNTS["plane_or"] == 0,
          (ingest, dict(ops.LAUNCH_COUNTS)))
    log(f"[mesh] v3 bytes through ProgressiveClient(mesh=) at {n4} shards, a stage at a "
        f"time: plane_or_segments launches a stage {ingest} (one a sub-store), plane_or 0; "
        f"every leaf gathered equal (torch.equal, q and offset) to the single-device "
        f"store's after each of the 8 stages; fingerprint keys {sorted(client.store.fingerprint())}")
    del state

    # B7 against B2, bit for bit, at both shard counts
    leaves = {n: srv2.params, n4: WireStoreReceiver(client, prog).materialize_resident()}
    full = srv1.params
    xg = torch.Generator(device=dev).manual_seed(9)
    four = torch.full((1, 1), 4, dtype=torch.int32, device=dev)
    forced = {"gemv": dqm._launch_gemv, "mma": dqm._launch_mma}
    b7_err, b7_mag, checks = 0.0, 0.0, 0
    for nn, P in leaves.items():
        mesh_n = meshes[nn]
        l0 = layer(P["decoder"]["cycles"]["0_attn"], 0)
        f0 = layer(full["decoder"]["cycles"]["0_attn"], 0)
        emb = full["embed"]
        V = emb.q.shape[0]
        emb_parts = [dataclasses.replace(emb, q=emb.q[j * V // nn:(j + 1) * V // nn])
                     for j in range(nn)]
        tensors = {"attn.wq": (l0["attn"]["wq"].parts, f0["attn"]["wq"]),
                   "mlp.wi_up": (l0["mlp"]["wi_up"].parts, f0["mlp"]["wi_up"]),
                   "mlp.wo": (l0["mlp"]["wo"].parts, f0["mlp"]["wo"]),
                   "embed.T": ([p.T for p in emb_parts], emb.T)}
        for name, (parts, w) in tensors.items():
            K, N = w.q.shape
            xd = torch.float32 if name == "embed.T" else cfg.dtype
            qs = [p.q for p in parts]
            for M in MESH_B7_M:
                rows = "decode" if M == 20 else "any"
                x = torch.randn((M, K), generator=xg, device=dev).to(xd)
                for kt in (None, four):
                    keeps = None if kt is None else [kt] * nn
                    scales, offsets = [p.scale for p in parts], [p.offset for p in parts]
                    y = ops.sharded_dequant_matmul(x, qs, scales, offsets, keeps=keeps,
                                                   bits=16, rows=rows, mesh=mesh_n)
                    y1 = dqm.dequant_matmul(x, w.q, w.scale, w.offset, kt, bits=16, rows=rows)
                    check(torch.equal(y, y1), f"[mesh] B7 {name} n={nn} M={M} keep="
                          f"{kt is not None}: differs from one B2 launch")
                    for route, launch in forced.items():
                        ys = torch.cat([launch(x, p.q, p.scale, p.offset, kt, bits=16,
                                               n_split=N) for p in parts], dim=1)
                        check(torch.equal(ys, launch(x, w.q, w.scale, w.offset, kt, bits=16)),
                              f"[mesh] B7 {name} n={nn} M={M} on {route}: shards differ")
                    yr = ref.sharded_dequant_matmul_ref(x, qs, scales, offsets, keeps, bits=16)
                    mag = float(yr.abs().max())
                    err = float((y - yr).abs().max())
                    check(err <= DQMM_RTOL * mag, (name, nn, M, err, mag))
                    b7_err, b7_mag = max(b7_err, err), max(b7_mag, mag)
                    checks += 1
    log(f"[mesh] B7 against B2 at {sorted(leaves)} shards on attn.wq (2048, 2048), "
        f"mlp.wi_up (2048, 8192), mlp.wo (8192, 2048) and embed.T split on its vocab "
        f"columns (K contiguous), M = {list(MESH_B7_M)} (20 on rows='decode'), without and "
        f"with keep = 4: in all {checks} cases torch.equal to one B2 launch, and on both forced "
        f"routes the shards' columns equal to the unsharded launch; against the plain "
        f"version max |err| {b7_err:.3e} (largest max |y| {b7_mag:.1f}, tolerance "
        f"{DQMM_RTOL} of it)")

    # times: one decode step's and one tick's layer weights through B7
    # against single-device B2 on the same card, at both shard counts
    stack_full = full["decoder"]["cycles"]["0_attn"]
    full_ws = [w for r in range(layers) for w in _layer_weights(layer(stack_full, r))]
    by_n = {}
    for nn, P in leaves.items():
        stack = P["decoder"]["cycles"]["0_attn"]
        sh_ws = [w for r in range(layers) for w in _layer_weights(layer(stack, r))]
        mesh_n = meshes[nn]
        for label, M in (("decode step", BATCH), ("tick", POOL_SLOTS * POOL_CHUNK)):
            xs = {k: torch.randn((M, k), generator=xg, device=dev).to(cfg.dtype)
                  for k in (cfg.d_model, cfg.d_ff)}
            calls = [(xs[w.q.shape[0]], w, sw) for w, sw in zip(full_ws, sh_ws)]

            def b7(calls=calls, mesh_n=mesh_n):
                for x, w, sw in calls:
                    ops.sharded_dequant_matmul(
                        x, [p.q for p in sw.parts], [p.scale for p in sw.parts],
                        [p.offset for p in sw.parts], bits=16, mesh=mesh_n)

            def b2(calls=calls):
                for x, w, _ in calls:
                    dqm.dequant_matmul(x, w.q, w.scale, w.offset)

            t = {"b7": [], "b2": []}
            for _ in range(2):        # in turns: B2, B7, B2, B7
                t["b2"].append(device_ms(b2, 3))
                t["b7"].append(device_ms(b7, 3))
            by_n[(nn, label)] = t
            if nn == MESH_SERVE_SHARDS and label == "decode step":
                bound, by = _dqmm_bound([(x, w) for x, w, _ in calls])
                dense_sh = [[p.q.to(torch.float32) * p.scale.reshape(()) + p.offset.reshape(())
                             for p in sw.parts] for _, _, sw in calls]
                xf = [x.float() for x, _, _ in calls]
                row = {"ms": min(t["b7"]),
                       "plain_ms": device_ms(lambda: [ref.sharded_dequant_matmul_ref(
                           x, [p.q for p in sw.parts], [p.scale for p in sw.parts],
                           [p.offset for p in sw.parts], bits=16) for x, _, sw in calls], 1),
                       "library_ms": device_ms(lambda: [torch.cat([torch.matmul(x, d)
                                                                   for d in ds], dim=1)
                                                        for x, ds in zip(xf, dense_sh)], 3),
                       "host_ms": host_ms(b7, 3), "b2_ms": min(t["b2"]),
                       "bound_ms": bound, "bound_by": by,
                       "per": f"one decode step's layer weights at {nn} shards "
                              f"({len(calls)} calls at M={M}, {nn * len(calls)} B2 launches)"}
                del dense_sh, xf
            log(f"[time] B7 {label} (M={M}, {len(calls)} layer weights) at {nn} shards: "
                f"B7 {', '.join(f'{v:.4f}' for v in t['b7'])} ms, single-device B2 "
                f"{', '.join(f'{v:.4f}' for v in t['b2'])} ms on the device")
    row["by_shards"] = {f"{nn} {label}": t for (nn, label), t in by_n.items()}
    row["max_abs_err"] = b7_err
    del srv1, srv2, client, leaves, full
    log(f"[mesh] {time.perf_counter() - t_phase:.1f} s")
    return {"counts": run_counts, "routes": routes, "kern": row,
            "tok_s": q_tok_s, "pool_tok_s": pool_tok_s}


def _wire_v1_check(cfg, dev) -> None:
    """Raw v1 bytes of the 2-layer full-width model through a CUDA client:
    fingerprints after every stage equal the in-memory receiver's, and the
    wire-fed server's tokens equal the pull-mode server's."""
    from repro_torch.core import wire
    from repro_torch.core.progressive import ReceiverState, divide
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ProgressiveServer, WireStoreReceiver
    from repro_torch.transmission import ProgressiveClient

    model = build_model(dataclasses.replace(cfg, n_layers=2))
    prog = divide(model.init(torch.Generator(device=dev).manual_seed(3), device=dev))
    blob = wire.encode(prog)
    meta, ends = _stage_ends(wire, blob)
    check(meta["version"] == 1 and ends[-1] == len(blob))
    fps = []
    client = ProgressiveClient(on_stage_complete=lambda s: fps.append(
        client.store.fingerprint()), device=dev)
    feed_to = _feeder(client, blob, 8)
    feed_to(ends[1])
    prompt = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(4))
    steps, arrivals = 16, set(range(1, 15, 2))
    wired = ProgressiveServer(model, prog, max_len=32, resident="quantized", device=dev,
                              receiver=WireStoreReceiver(client, prog))
    pull = ProgressiveServer(model, prog, max_len=32, resident="quantized", device=dev)
    for srv in (wired, pull):
        srv.receive_stage()
        srv.start({"tokens": prompt})

    def arrive(i: int) -> bool:
        if i not in arrivals:
            return False
        feed_to(ends[client.stages_complete + 1])
        return True

    got = wired.decode(steps, stage_arrival=arrive)
    want = pull.decode(steps, stage_arrival=lambda i: i in arrivals)
    check(client.complete and wired.stage == pull.stage == 8)
    check(torch.equal(got.tokens, want.tokens), "v1 wire-fed tokens differ")
    state = ReceiverState.init(prog, device=dev)
    for s in range(8):
        state = state.receive(prog.stage(s + 1))
        check(state.store.fingerprint() == fps[s], f"v1 stage {s + 1} fingerprint")
    log(f"[wire] raw v1, 2-layer full width: {len(blob)} bytes in ragged chunks; "
        f"fingerprints equal the in-memory receiver's after each of the 8 stages; "
        f"{steps} x 2 tokens equal (torch.equal) to the pull-mode server's")


class LogitLog:
    """Wraps a Model: keeps, on the device, the logits of the prefill and
    of every decode step, in order."""

    def __init__(self, model):
        self.model = model
        self.logits: list[torch.Tensor] = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, params, batch):
        last, caches = self.model.prefill(params, batch)
        self.logits.append(last)
        return last, caches

    def decode_step(self, params, caches, tokens, pos):
        logits, caches = self.model.decode_step(params, caches, tokens, pos)
        self.logits.append(logits)
        return logits, caches


def _counted(ops, fn, acc: dict, routes: dict):
    """Run ``fn()`` with the launch counts set to 0 just before and read
    just after; add them into ``acc`` and ``routes``. Returns ``fn()``'s
    result and this run's counts."""
    torch.cuda.synchronize()
    reset_counts(ops)
    out = fn()
    got, _ = _tally(acc, routes, "session")
    return out, got


def _tally(acc: dict, routes: dict, what: str) -> tuple[dict, dict]:
    """The launch counts and B2's launches by route since the last reset,
    every GEMV launch on the one-pass kernels; added into ``acc`` and
    ``routes``."""
    torch.cuda.synchronize()
    got, by = counts(), route_counts()
    if by["gemv"]:
        check_one_pass(by, what)
    for k, v in got.items():
        acc[k] = acc.get(k, 0) + v
    for k, v in by.items():
        routes[k] = routes.get(k, 0) + v
    return got, by


def _fp_against_quantized(fp_logits, q_logits, fp_tokens, q_tokens, held=True
                          ) -> tuple[float, int, int]:
    """Hold the float-resident run to the quantized-resident one, step by
    step and row by row while the row's tokens so far agree: logits within
    ``FP_LOGIT_RTOL`` of the largest quantized logit, and the greedy token
    equal wherever the quantized logits' top two are further apart than
    twice that. Returns the worst relative error, the tokens checked and
    the tokens whose margin did not clear the tolerance. With ``held``
    False it only compares: a token that differs ends its row."""
    worst, checked, near = 0.0, 0, 0
    B = fp_tokens.shape[0]
    live = [True] * B
    # step i's logits choose token i (the prefill's choose token 0)
    for i in range(fp_tokens.shape[1]):
        fl, ql = fp_logits[i].float(), q_logits[i].float()
        for b in range(B):
            if not live[b]:
                continue
            mag = float(ql[b].abs().max())
            err = float((fl[b] - ql[b]).abs().max())
            check(not held or err <= FP_LOGIT_RTOL * mag, ("fp logits", i, b, err, mag))
            worst = max(worst, err / mag)
            top2 = torch.topk(ql[b], 2).values
            if float(top2[0] - top2[1]) > 2 * FP_LOGIT_RTOL * mag:
                same = int(fp_tokens[b, i]) == int(q_tokens[b, i])
                check(not held or same, ("fp token", i, b))
                checked += same
                live[b] = same
            else:
                near += 1
                if int(fp_tokens[b, i]) != int(q_tokens[b, i]):
                    live[b] = False
    return worst, checked, near


def _replay_wire(model, prog, blob, ends, prompt, stage_at_step, dev):
    """A quantized-resident ``ProgressiveServer(receiver=)`` over a fresh
    client fed whole stages, upgraded to each step's stage of
    ``stage_at_step``."""
    from repro_torch.serving.engine import ProgressiveServer, WireStoreReceiver
    from repro_torch.transmission import ProgressiveClient

    client = ProgressiveClient(device=dev)
    view, fed = memoryview(blob), [0]

    def feed_to(s):
        client.feed(view[fed[0]:ends[s]])
        fed[0] = ends[s]

    srv = ProgressiveServer(model, prog, max_len=prompt.shape[1] + len(stage_at_step),
                            resident="quantized", device=dev,
                            receiver=WireStoreReceiver(client, prog))
    feed_to(stage_at_step[0])
    srv.receive_stage()
    srv.start({"tokens": prompt})

    def arrive(i: int) -> bool:
        if stage_at_step[i] <= srv.stage:
            return False
        feed_to(stage_at_step[i])
        return True

    res = srv.decode(len(stage_at_step), stage_arrival=arrive)
    check(res.stage_at_step == list(stage_at_step), (res.stage_at_step, stage_at_step))
    return res.tokens


def _session_phase(model, prog, dev, ops, prompt, clean_fps) -> dict:
    """``[session]``: the byte-clock ``Session`` on full-width olmo-1b over
    ``pod-coldstart`` (200 MB/s, 1 MB chunks): ``run_timeline``;
    ``run_serving`` in quantized and float residency; a faulted run on
    the v3 wire (the CLI's default profile) with its recovery proved;
    ``run_serving_pool``. Each run counted from 0; the counts of all of
    them are the path's. Returns the path's counts and routes."""
    from repro_torch.core import wire
    from repro_torch.launch.serve import _verify_fault_recovery
    from repro_torch.serving.engine import ProgressiveServer
    from repro_torch.transmission import (FaultPolicy, FaultTrace, Link, Session, StageCost,
                                          flash_crowd_arrivals, get_scenario,
                                          progressive_timeline)

    cfg, layers = model.cfg, model.cfg.n_layers
    acc, routes = {}, {}
    scenario = get_scenario(SESSION_SCENARIO)
    t0 = time.perf_counter()
    blob = wire.encode(prog)
    t_encode = time.perf_counter() - t0
    meta, ends = _stage_ends(wire, blob)
    session = Session.from_scenario(blob, scenario, seed=0, device=dev)
    n_pieces = len(session._pieces())
    log(f"[session] {SESSION_SCENARIO}: v1 stream {len(blob)} bytes (encode {t_encode:.2f} "
        f"s), {n_pieces} feeds of <= {scenario.chunk_bytes} bytes; simulated stage arrivals "
        f"{[round(a, 4) for a in session.stage_arrival_times()]} s")

    # run_timeline: the client alone on the byte clock, against the algebra
    costs = [StageCost(*SESSION_STAGE_COST)] * prog.n_stages
    t0 = time.perf_counter()
    tl, c = _counted(ops, lambda: session.run_timeline(costs), acc, routes)
    host_s = time.perf_counter() - t0
    feeds = len(tl.events_of("chunk"))
    check(c["plane_or_segments"] == 8 and sum(c.values()) == 8, c)
    check(tl.client.store.fingerprint() == clean_fps[-1], "timeline store differs")
    want = progressive_timeline(session.layout.stage_bytes,
                                Link(bandwidth_bytes_per_s=200e6, latency_s=scenario.latency_s),
                                costs, concurrent=True, header_bytes=session.layout.header_bytes)
    gap = max(abs(a - b) for a, b in zip(tl.timeline.download_done + tl.timeline.result_ready,
                                          want.download_done + want.result_ready))
    check(gap < 1e-9, ("timeline against the algebra", gap))
    feed_ms = host_s / feeds * 1e3
    log(f"[session] run_timeline: {feeds} feeds, {len(tl.events)} events; host {host_s:.3f} "
        f"s, {feed_ms:.4f} ms a feed, {len(blob) / host_s / 1e9:.3f} GB/s; simulated "
        f"download_done {[round(t, 4) for t in tl.timeline.download_done]} s, result_ready "
        f"(stage cost {SESSION_STAGE_COST} s, simulated) "
        f"{[round(t, 4) for t in tl.timeline.result_ready]} s; within {gap:.1e} s of "
        f"progressive_timeline; store fingerprint equal to the in-memory receiver's")
    del tl

    arrivals_clean = session.stage_arrival_times()
    # run_serving, quantized then float residency, on the same byte clock
    runs, logs = {}, {}
    for resident in ("quantized", "fp"):
        logs[resident] = LogitLog(model)
        t0 = time.perf_counter()
        r, c = _counted(ops, lambda: session.run_serving(
            logs[resident], prog, decode_steps=SESSION_STEPS, batch={"tokens": prompt},
            resident=resident), acc, routes)
        r.host_s = time.perf_counter() - t0
        runs[resident] = (r, c)
        check(r.tokens.shape == (BATCH, SESSION_STEPS) and r.server.stage == 8, r.upgrades)
        check(c["plane_or_segments"] == 8 and c["decode_attention"] == layers * SESSION_STEPS,
              c)
        check(r.client.store.fingerprint() == clean_fps[-1], f"{resident} store differs")
        log(f"[session] run_serving {resident}: {SESSION_STEPS} steps x {BATCH}, upgrades "
            f"(step, stage) {r.upgrades}; {len(r.events)} events; host {r.host_s:.3f} s; "
            f"launches {c}")
    (q, qc), (f, fc) = runs["quantized"], runs["fp"]
    check(qc["dequant_matmul"] == (layers * 7 + 1) * (1 + SESSION_STEPS), qc)
    check(fc["dequant_matmul"] == 0, fc)
    check(q.stage_at_step == f.stage_at_step and q.upgrades == f.upgrades)
    check(q.upgrades and q.stage_at_step[0] < 8 <= q.stage_at_step[-1], q.stage_at_step)
    q_events = [(e.t_s, e.kind) for e in q.events]
    check(q_events == [(e.t_s, e.kind) for e in f.events], "the two runs' byte clocks differ")
    replay = _replay_wire(model, prog, blob, ends, prompt, q.stage_at_step, dev)
    check(torch.equal(replay, q.tokens), "quantized session tokens differ from the replay")
    worst, n_checked, n_near = _fp_against_quantized(
        logs["fp"].logits, logs["quantized"].logits, f.tokens, q.tokens)
    same = int((f.tokens == q.tokens).sum())
    log(f"[session] quantized tokens equal (torch.equal) to a ProgressiveServer(receiver=) "
        f"replay at the run's stage_at_step; float-resident logits within {worst:.3e} of "
        f"the largest quantized logit (tolerance {FP_LOGIT_RTOL}), greedy tokens equal at "
        f"all {n_checked} positions whose top-two margin clears twice that ({n_near} "
        f"within it); {same}/{f.tokens.numel()} tokens equal overall")
    del logs

    # decode rate of both residencies at stage 8, and the float upgrade
    rates = {"quantized": [], "fp": []}
    for _ in range(2):
        for resident, (r, _) in runs.items():
            srv = r.server
            srv.start({"tokens": prompt})
            res = srv.decode(SESSION_STEPS)
            rates[resident].append(BATCH * SESSION_STEPS / sum(s for _, s in res.window_s))
    reports = {k: r.server.resident_report() for k, (r, _) in runs.items()}
    store_bytes = runs["fp"][0].client.store.resident_bytes()
    check(reports["quantized"]["fp_bytes"] == 0 and reports["fp"]["quantized_bytes"] == 0)
    store = runs["fp"][0].client.store
    n_w = sum(t.size for t in store.slots)
    up_ms, up_dev = [], []
    for _ in range(3):
        store._dirty.update(range(store.n_tensors))
        store._leaf_cache.clear()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        store.materialize_leaves()
        e1.record()
        torch.cuda.synchronize()
        up_ms.append((time.perf_counter() - t0) * 1e3)
        up_dev.append(e0.elapsed_time(e1))
    up_bound = (2 * n_w + 4 * n_w) / HBM_BYTES_PER_S * 1e3
    log(f"[session] decode at stage 8 ({BATCH} x {SESSION_STEPS}), in turns: quantized "
        f"{[round(x, 2) for x in rates['quantized']]} tokens/s, fp "
        f"{[round(x, 2) for x in rates['fp']]} tokens/s; resident bytes quantized "
        f"{reports['quantized']['quantized_bytes']} uint + {reports['quantized']['fp_bytes']} "
        f"fp, fp {reports['fp']['fp_bytes']} float leaves beside the store's {store_bytes} "
        f"accumulator bytes")
    log(f"[session] fp upgrade (dequantize all {store.n_tensors} tensors, {n_w} weights, "
        f"uint16 -> float32): host ms {[round(x, 2) for x in up_ms]}, device ms (events) "
        f"{[round(x, 3) for x in up_dev]}, bound {up_bound:.3f} ms (bytes: q read once, "
        f"leaves written once)")
    del runs, session, store
    torch.cuda.empty_cache()

    # a faulted run on the v3 wire: the CLI's default profile
    blob3 = wire.encode(prog, integrity=True)
    s3 = Session.from_scenario(blob3, scenario, seed=0, device=dev)
    arrivals_v3 = s3.stage_arrival_times()
    faults = FaultTrace(seed=0, p_corrupt=0.01, p_disconnect=0.002)
    t0 = time.perf_counter()
    fr, c = _counted(ops, lambda: s3.run_serving(
        model, prog, decode_steps=SESSION_STEPS, batch={"tokens": prompt},
        resident="quantized", faults=faults, fault_policy=FaultPolicy(seed=0)), acc, routes)
    host_s = time.perf_counter() - t0
    check(fr.client.complete and not fr.client.nacks, fr.transport)
    check(fr.client.store.fingerprint() == clean_fps[-1], "faulted store differs")
    check(sum(fr.transport["injected"].values()) > 0, fr.transport)
    log(f"[session] faulted run ({SESSION_SCENARIO}, default profile {faults}): "
        f"{fr.transport}; host {host_s:.3f} s; cold start at simulated "
        f"{fr.events_of('cold_start')[0].t_s:.4f} s (clean {arrivals_clean[0]:.4f} s), "
        f"stages served {fr.stage_at_step[0]}-{fr.stage_at_step[-1]}, upgrades "
        f"{fr.upgrades}; launches {c}")
    _verify_fault_recovery(fr, blob3, model, prog, {"tokens": prompt}, device=dev)
    del fr, s3, blob3
    torch.cuda.empty_cache()

    # the pool over the same link: 12 requests joining within 2 s, a
    # simulated round every 1/SESSION_POOL_ROUNDS of the download (the
    # default, a round a token of the whole budget, would end the run
    # before stage 3: 8 slots emit 8 tokens a round)
    lengths, budgets, prompts = _pool_requests(cfg)
    offs = flash_crowd_arrivals(0, POOL_REQUESTS, span_s=2.0)
    session = Session.from_scenario(blob, scenario, seed=0, device=dev)
    arrivals = session.stage_arrival_times()
    step_s = (arrivals[-1] - arrivals[0]) / SESSION_POOL_ROUNDS
    t0 = time.perf_counter()
    pr, c = _counted(ops, lambda: session.run_serving_pool(
        model, prog, prompts=prompts, arrival_offsets_s=offs, max_new_tokens=SESSION_POOL_TOKENS,
        n_slots=POOL_SLOTS, resident="quantized", dispatch_window=POOL_WINDOW,
        step_time_s=step_s), acc, routes)
    host_s = time.perf_counter() - t0
    pool = pr.server
    check(sorted(pr.tokens) == list(range(POOL_REQUESTS)), sorted(pr.tokens))
    check(all(len(v) == SESSION_POOL_TOKENS and all(0 <= t < cfg.vocab for t in v)
              for v in pr.tokens.values()))
    check(pool.stage == 8 and len(pr.upgrades) > 0, pr.upgrades)
    ticks, steps = pool._tick_count, pool._step_count
    check(c["plane_or_segments"] == 8 and c["flash_verify"] == layers * ticks
          and c["decode_attention"] == layers * steps
          and c["dequant_matmul"] == (layers * 7 + 1) * (ticks + steps), (c, ticks, steps))
    log(f"[session] run_serving_pool: {POOL_REQUESTS} requests over 2 s into {POOL_SLOTS} "
        f"slots, {SESSION_POOL_TOKENS} tokens each; admissions at simulated "
        f"{[round(t, 3) for t, _ in pr.admissions]} s; upgrades {pr.upgrades}; {ticks} "
        f"ticks, {steps} steps; host {host_s:.3f} s; launches {c}")
    del pr, pool, session, blob
    torch.cuda.empty_cache()
    return {"counts": acc, "routes": routes, "feed_ms": feed_ms, "arrivals_v3": arrivals_v3}


def _session_small(cfg, dev, ops, acc: dict, routes: dict) -> None:
    """``[session]`` on the 2-layer full-width model (475 MB on the v1
    wire): ``run_timeline`` over each small-chunk scenario (16-32 KB
    chunks: 14,489-28,969 feeds), ``run_serving`` over
    ``browser-lte-handoff`` against a stage replay, and the lossy
    scenarios on the v3 wire, which end in ``TransportError``; then the
    lossy scenarios on reduced olmo-1b, recovered. Counted into ``acc``
    and ``routes``."""
    from repro_torch.core import wire
    from repro_torch.core.progressive import ReceiverState, divide
    from repro_torch.models.model import build_model
    from repro_torch.transmission import (FaultPolicy, Session, StageCost, TransportError,
                                          get_scenario)

    model = build_model(dataclasses.replace(cfg, n_layers=2))
    prog = divide(model.init(torch.Generator(device=dev).manual_seed(3), device=dev))
    state = ReceiverState.init(prog, device=dev)
    for s in range(1, prog.n_stages + 1):
        state = state.receive(prog.stage(s))
    clean = state.store.fingerprint()
    del state
    blob = wire.encode(prog)
    _, ends = _stage_ends(wire, blob)
    costs = [StageCost(*SESSION_STAGE_COST)] * prog.n_stages
    for name in SMALL_CHUNK_SCENARIOS:
        session = Session.from_scenario(blob, get_scenario(name), seed=0, device=dev)
        t0 = time.perf_counter()
        tl, c = _counted(ops, lambda: session.run_timeline(costs), acc, routes)
        host_s = time.perf_counter() - t0
        feeds = len(tl.events_of("chunk"))
        check(c["plane_or_segments"] == 8 and tl.client.store.fingerprint() == clean, (name, c))
        log(f"[session] 2-layer, {name} ({session.chunk_bytes} B chunks): run_timeline "
            f"{feeds} feeds, host {host_s:.3f} s, {host_s / feeds * 1e3:.4f} ms a feed; "
            f"simulated download_done {[round(t, 2) for t in tl.timeline.download_done]} s; "
            f"fingerprint equal to the in-memory receiver's")
    prompt = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(4))
    session = Session.from_scenario(blob, get_scenario("browser-lte-handoff"), seed=1,
                                    device=dev)
    r, c = _counted(ops, lambda: session.run_serving(
        model, prog, decode_steps=32, batch={"tokens": prompt}, resident="quantized"),
        acc, routes)
    check(r.server.stage == 8 and len(r.upgrades) > 1, r.upgrades)
    replay = _replay_wire(model, prog, blob, ends, prompt, r.stage_at_step, dev)
    check(torch.equal(replay, r.tokens), "2-layer session tokens differ from the replay")
    log(f"[session] 2-layer, browser-lte-handoff: run_serving quantized, 32 steps x 2, "
        f"upgrades {r.upgrades}, tokens equal (torch.equal) to a stage replay; launches {c}")
    # the lossy scenarios repair whole v3 units; here a unit is a whole
    # plane of a tensor (2-26 MB), which 1% corruption a chunk almost
    # never lets through intact, so the transport must give up with its
    # typed error, before serving anything
    blob3 = wire.encode(prog, integrity=True)
    for name in LOSSY_SCENARIOS:
        sc = get_scenario(name)
        session = Session.from_scenario(blob3, sc, seed=0, device=dev)
        t0 = time.perf_counter()
        err = None
        try:
            session.run_serving(model, prog, decode_steps=16, batch={"tokens": prompt},
                                resident="quantized", faults=sc.make_faults(0),
                                fault_policy=FaultPolicy(seed=0))
        except TransportError as e:
            err = e
        check(err is not None, f"{name} on the 2-layer model: expected a TransportError")
        log(f"[session] 2-layer, {name}: TransportError, as the unit sizes predict, after "
            f"{time.perf_counter() - t0:.1f} s: {err}")
    del blob3, blob, prog, model
    torch.cuda.empty_cache()

    # the lossy scenarios where a unit is small enough to cross the
    # channel: reduced olmo-1b (d_model 128), both residencies' fault
    # recovery proved as the CLI proves it
    from repro_torch.launch.serve import _verify_fault_recovery

    small = build_model(cfg.reduced())
    sprog = divide(small.init(torch.Generator(device=dev).manual_seed(5), device=dev))
    blob3 = wire.encode(sprog, integrity=True)
    sprompt = torch.randint(0, small.cfg.vocab, (2, 16),
                            generator=torch.Generator().manual_seed(6))
    for name in LOSSY_SCENARIOS:
        sc = get_scenario(name)
        session = Session.from_scenario(blob3, sc, seed=0, device=dev)
        t0 = time.perf_counter()
        r, c = _counted(ops, lambda: session.run_serving(
            small, sprog, decode_steps=16, batch={"tokens": sprompt}, resident="quantized",
            faults=sc.make_faults(0), fault_policy=FaultPolicy(seed=0)), acc, routes)
        host_s = time.perf_counter() - t0
        check(sum(r.transport["injected"].values()) > 0, r.transport)
        _verify_fault_recovery(r, blob3, small, sprog, {"tokens": sprompt}, device=dev)
        log(f"[session] reduced olmo-1b ({len(blob3)} B v3), {name}: {r.transport}; "
            f"upgrades {r.upgrades}; host {host_s:.3f} s; launches {c}")


def _cli_phase(arch: str, *runs, families=()) -> None:
    """The CLI at full width, each run a process of its own: ``python -m
    repro_torch.launch.serve --arch <arch> --scenario pod-coldstart`` and
    each run's flags, its last line checked (``CLI_STREAM``,
    ``CLI_POOL``). With ``families`` (one set a run) each run also gets
    ``--metrics``: its file parses as Prometheus text and holds every
    family of its set (the reference launcher's, ``CLI_STREAM_FAMILIES``,
    ``CLI_POOL_FAMILIES``)."""

    from repro_torch.obs.exporters import parse_prometheus

    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
            "--scenario", "pod-coldstart"]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    with tempfile.TemporaryDirectory() as tmp:
        metrics = [os.path.join(tmp, f"cli{i}.prom") for i in range(len(families))]
        runs = [(base + flags + (["--metrics", metrics[i]] if i < len(families) else []), last)
                for i, (flags, last) in enumerate(runs)]
        for i, (cmd, last) in enumerate(runs):
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
                                  env=env, cwd=ROOT)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0, ("cli", cmd[3:], proc.returncode, proc.stderr[-3000:]))
            out = proc.stdout.strip().splitlines()
            check(out and out[-1].startswith(last) or
                  i < len(families) and len(out) > 1 and out[-2].startswith(last), out[-3:])
            for line in out:
                log(f"[cli] {line[:300]}")
            if i < len(families):
                with open(metrics[i]) as f:
                    got = parse_prometheus(f.read())
                missing = sorted(families[i] - set(got))
                check(not missing, ("cli --metrics lacks", missing))
                log(f"[cli] --metrics: {len(got)} families, every one of the reference "
                    f"launcher's {len(families[i])} for this mode; kernel_launches_total "
                    + str({k: int(v) for k, v in got["kernel_launches_total"]["samples"].items()}))
            log(f"[cli] {' '.join(cmd[1:])}: exit 0 in {wall:.1f} s")


@contextlib.contextmanager
def _beside(runs: list, need_gib: float):
    """Runs each of ``runs`` (CLI phases, each starting its processes) in
    turn in a thread of its own while the block runs, a ``[path]`` whose
    CPU side times nothing; joins it when the block ends, the block's
    failure first, else the thread's. With under ``need_gib`` GiB free on
    the card (the block's and the processes' peaks) they run after the
    block instead."""
    import threading

    if not runs:
        yield
        return
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0] / 2 ** 30
    if free < need_gib:
        log(f"[beside] {free:.1f} GiB free, under {need_gib}: {len(runs)} CLI runs after the "
            f"[path]")
        yield
        for fn in runs:
            fn()
        return
    failed = []

    def run():
        try:
            for fn in runs:
                fn()
        except BaseException as e:      # re-raised by the caller's thread
            failed.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    try:
        yield
    finally:
        thread.join()
    if failed:
        raise failed[0]


# an example's process: the script's main() once a flag set with
# --device, the launch counts set to 0 before each; its results, the
# counts by kernel and route and the seconds of each run, in a file
_EXAMPLE_DRIVER = """
import json, runpy, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
import torch
from repro_torch.kernels import ops
script, out_path, device, runs = sys.argv[2], sys.argv[3], sys.argv[4], json.loads(sys.argv[5])
torch.set_num_threads(cs.EXAMPLE_THREADS)
main = runpy.run_path(script)["main"]
results = []
for argv in runs:
    cs.reset_counts(ops)
    t0 = time.perf_counter()
    out = main(argv + ["--device", device])
    if device == "cuda":
        torch.cuda.synchronize()
    results.append({"argv": argv, "s": time.perf_counter() - t0, "counts": cs.counts(),
                    "routes": cs.route_counts(), "out": out})
torch.save(results, out_path)
"""


# the examples' processes still running: main's caller stops any left
EXAMPLE_PROCS: dict = {}


def _examples_start(device: str, out_dir: str) -> None:
    """Start the four scripts of ``examples_torch/`` on ``device``, a
    process each, all at once (``EXAMPLE_RUNS``), each with a ``TMPDIR`` of
    its own; :func:`_examples_wait` waits for them."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": str(EXAMPLE_THREADS)}
    for name, runs in EXAMPLE_RUNS:
        tmp = os.path.join(out_dir, f"{name}.{device}")
        os.makedirs(tmp)
        out, log_path = os.path.join(tmp, "results.pt"), os.path.join(tmp, "log")
        with open(log_path, "w") as f:
            EXAMPLE_PROCS[name, device] = (subprocess.Popen(
                [sys.executable, "-c", _EXAMPLE_DRIVER, ROOT,
                 os.path.join(ROOT, "examples_torch", f"{name}.py"), out, device,
                 json.dumps(runs)], stdout=f, stderr=subprocess.STDOUT,
                env={**env, "TMPDIR": tmp}, cwd=ROOT), out, log_path, time.perf_counter())


def _examples_wait(device: str, results: dict) -> None:
    """Wait for :func:`_examples_start`'s processes on ``device`` (killing
    any past ``EXAMPLE_TIMEOUT_S``) and put each one's exit code, output
    file, log and seconds in ``results`` under ``(name, device)`` for
    :func:`_examples_phase`."""
    running = {k: v for k, v in EXAMPLE_PROCS.items() if k[1] == device}
    deadline = min(t0 for *_, t0 in running.values()) + EXAMPLE_TIMEOUT_S
    while running:
        for key, (proc, out, log_path, t0) in list(running.items()):
            rc = proc.poll()
            if rc is None and time.perf_counter() > deadline:
                proc.kill()
                rc = f"killed after {EXAMPLE_TIMEOUT_S} s"
            if rc is not None:
                proc.wait()
                results[key] = {"rc": rc, "out": out, "log": log_path,
                                "s": time.perf_counter() - t0}
                del running[key], EXAMPLE_PROCS[key]
        time.sleep(0.1)


def _stop_examples() -> None:
    for proc, *_ in EXAMPLE_PROCS.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _examples_phase(results: dict) -> dict:
    """``[examples]`` (ROADMAP A12(d)): the runs of :func:`_examples_start`
    on the card and on the CPU, each exit 0 (each script checks itself:
    quickstart that its stage-8 leaves equal ``dequantize(quantize(leaf,
    16))``); the integer outputs of the card's runs equal the CPU's (the
    weights are drawn on the host but for training's, which ``train``
    draws on the device: its logged steps and stage bytes); quickstart's
    and the MoE demo's floats within ``PATH_RTOL``; the trained model's
    stage-8 accuracy on the card within ``EXAMPLE_ACC_TOL`` of its float
    params'. Logs a line per example with its launches by kernel on the
    card; returns them summed over the examples."""
    check(len(results) == 2 * len(EXAMPLE_RUNS), sorted(results))
    for key, r in results.items():
        with open(r["log"]) as f:
            check(r["rc"] == 0, ("examples", key, r["rc"], f.read()[-3000:]))
    got = {key: torch.load(r["out"], weights_only=False) for key, r in results.items()}
    total: dict = {}

    def launches(name) -> dict:
        by = {}
        for run in got[name, "cuda"]:
            for k, v in run["counts"].items():
                by[k] = by.get(k, 0) + v
                total[k] = total.get(k, 0) + v
        return {k: v for k, v in by.items() if v}

    def seconds(name) -> str:
        return (f"{sum(r['s'] for r in got[name, 'cuda']):.1f} s in main() on the card "
                f"({results[name, 'cuda']['s']:.1f} s with the process), "
                f"{sum(r['s'] for r in got[name, 'cpu']):.1f} s on the CPU "
                f"({results[name, 'cpu']['s']:.1f} s)")

    # quickstart: the same host-drawn weights, so the same blob
    c, h = (got["quickstart", d][0]["out"] for d in ("cuda", "cpu"))
    for k in ("blob_bytes", "n_stages", "singleton_bytes", "download_s", "stages"):
        check(c[k] == h[k], ("quickstart", k, c[k], h[k]))
    err = max(float((c["logits"][s] - h["logits"][s]).abs().max())
              / float(h["logits"][s].abs().max()) for s in h["logits"])
    check(err <= PATH_RTOL, ("quickstart logits", err))
    log(f"[examples] quickstart: {c['blob_bytes']} B in {c['n_stages']} stages, the t= lines "
        f"{[round(t, 2) for t, _, _ in c['stages']]} s equal to the CPU's; logits at every "
        f"stage within {err:.3e} of the CPU's max |logit| (tolerance {PATH_RTOL}); stage 8 "
        f"equal to the singleton quantized model; launches {launches('quickstart')}; "
        f"{seconds('quickstart')}")

    # train_then_transmit: train draws its init on the device, so only what
    # does not follow the trained values is held against the CPU (the
    # header's JSON carries each tensor's float range)
    c, h = (got["train_then_transmit", d][0]["out"] for d in ("cuda", "cpu"))
    check([x["step"] for x in c["history"]] == [x["step"] for x in h["history"]],
          "train_then_transmit: logged steps differ")
    check(c["manifest"]["stage_bytes"] == h["manifest"]["stage_bytes"],
          (c["manifest"], h["manifest"]))
    acc = c["accuracy"]
    check(abs(acc[8] - acc[0]) <= EXAMPLE_ACC_TOL, ("stage 8 against fp32", acc))
    log(f"[examples] train_then_transmit: {len(c['history'])} logged steps equal to the "
        f"CPU's, loss {c['history'][0]['loss']:.4f} -> {c['history'][-1]['loss']:.4f} "
        f"(CPU {h['history'][0]['loss']:.4f} -> {h['history'][-1]['loss']:.4f}); stage "
        f"bytes {sorted(set(c['manifest']['stage_bytes'].values()))} x 8 equal, header "
        f"{c['manifest']['header_bytes']} B (CPU {h['manifest']['header_bytes']}); "
        f"held-out accuracy by stages 1-8 "
        f"{[round(acc[s], 4) for s in range(1, 9)]}, fp32 {acc[0]:.4f} (CPU "
        f"{[round(h['accuracy'][s], 4) for s in range(1, 9)]}, fp32 "
        f"{h['accuracy'][0]:.4f}); stage 8 within {abs(acc[8] - acc[0]):.4f} of fp32 "
        f"(tolerance {EXAMPLE_ACC_TOL}); launches {launches('train_then_transmit')}; "
        f"{seconds('train_then_transmit')}")

    # progressive_serving: the byte clock's outputs equal the CPU's; tokens
    # reported (float32 reduced models, sums in other orders)
    for run, cpu_run in zip(got["progressive_serving", "cuda"],
                            got["progressive_serving", "cpu"]):
        c, h, flags = run["out"], cpu_run["out"], " ".join(run["argv"]) or "(default)"
        check(c["blob_bytes"] == h["blob_bytes"] and c["arrivals"] == h["arrivals"], flags)
        if "--speculative" in run["argv"]:
            same = "rounds {} and {} on the CPU".format(c["speculation"]["rounds"],
                                                       h["speculation"]["rounds"])
        else:
            for k in ("stage_at_step", "stage_log", "admissions", "upgrades", "jsonl",
                      "final_stage"):
                check(c.get(k) == h.get(k), (flags, k))
            same = f"{c['n_events']} events, the event log equal to the CPU's"
        if isinstance(c["tokens"], dict):
            agree = sum(c["tokens"][r] == h["tokens"][r] for r in c["tokens"])
            tokens = f"{agree} of {len(c['tokens'])} clients' tokens equal to the CPU's"
        else:
            eq = int((c["tokens"] == h["tokens"]).sum())
            tokens = f"{eq} of {c['tokens'].numel()} tokens equal to the CPU's"
        log(f"[examples] progressive_serving {flags}: {c['blob_bytes']} B, stages at "
            f"{[round(a, 2) for a in c['arrivals']]} s, {len(c['upgrades'])} upgrades, "
            f"final stage {c['final_stage']}; {same}; {tokens}; launches "
            f"{ {k: v for k, v in run['counts'].items() if v} }, dequant_matmul by route "
            f"{run['routes']}; {run['s']:.1f} s")
    log(f"[examples] progressive_serving: {len(got['progressive_serving', 'cuda'])} runs; "
        f"launches {launches('progressive_serving')}; {seconds('progressive_serving')}")

    # expert_priority_moe: the same host-drawn weights and batches
    c, h = (got["expert_priority_moe", d][0]["out"] for d in ("cuda", "cpu"))
    check((c["n_tensors"], c["n_tensors_unsliced"]) == (h["n_tensors"], h["n_tensors_unsliced"]),
          "expert_priority_moe: tensor counts differ")
    check(int(c["counts"].sum()) == int(h["counts"].sum()))
    err = max(abs(c["mse"][k] - h["mse"][k]) / h["mse"][k] for k in h["mse"])
    check(err <= PATH_RTOL, ("expert_priority_moe MSE", err))
    log(f"[examples] expert_priority_moe: {c['n_tensors']} tensors sliced "
        f"({c['n_tensors_unsliced']} unsliced) as on the CPU; router counts "
        f"{c['counts'].tolist()} (CPU {h['counts'].tolist()}); MSE by (frac, order) "
        f"{ {k: round(v, 6) for k, v in c['mse'].items()} }, within {err:.3e} of the CPU's "
        f"(tolerance {PATH_RTOL}); launches {launches('expert_priority_moe')}; "
        f"{seconds('expert_priority_moe')}")
    return total


def _upgrade_phase(prog, dev, ops):
    """``[upgrade per tensor]``: the store after stage 7; stage 8 as one
    ``plane_or`` a tensor on its live accumulator views (counted from 0),
    then as the batched ``plane_or_segments`` launch; byte-equal, both
    timed with the host clock, synchronised. Returns the path's counts,
    the batched operands and result, the per-tensor operands and the
    slots."""
    from repro_torch.core.plane_store import next_plane_shift
    from repro_torch.core.progressive import ReceiverState

    state = ReceiverState.init(prog, device=dev)
    for s in range(1, prog.n_stages):
        state = state.receive(prog.stage(s))
    store = state.store
    last = dict(prog.stage(prog.n_stages))
    per_tensor = [(store._slice_acc(i), last[i], next_plane_shift(t.schedule, 7))
                  for i, t in enumerate(store.slots)]
    acc = store.buffers["uint16"]
    _, plane, shifts = store.round_operands(last)["uint16"]
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    outs = [ops.plane_or(a, p, shift=s) for a, p, s in per_tensor]
    torch.cuda.synchronize()
    t_each = time.perf_counter() - t0
    run_counts, op_counts = counts(), dict(ops.LAUNCH_COUNTS)
    check(run_counts["plane_or"] == op_counts["plane_or"] == len(per_tensor)
          and sum(run_counts.values()) == len(per_tensor), run_counts)
    t0 = time.perf_counter()
    out = ops.plane_or_segments(acc, plane, shifts)
    torch.cuda.synchronize()
    t_batched = time.perf_counter() - t0
    for t, o in zip(store.slots, outs):
        check(torch.equal(o.reshape(-1), out[t.offset:t.offset + t.size]),
              f"per-tensor upgrade of {t.key} differs from the batched one")
    log(f"[upgrade per tensor] stage 8 as {len(outs)} plane_or launches on the live stage-7 "
        f"views (uint16 acc, uint8 plane): {t_each * 1e3:.3f} ms; one batched "
        f"plane_or_segments launch: {t_batched * 1e3:.3f} ms (host clock, synchronised, "
        f"first calls); byte-equal")
    return run_counts, acc, plane, shifts, out, per_tensor, store.slots


def _pool_phase(model, prog, dev, ops, tag="[pool]", fp_bytes=0, *, slots=POOL_SLOTS,
                max_len=POOL_MAX_LEN, requests=None, b2_calls=None, attn_layers=None,
                hook=None):
    """Serve the requests (default: the 12 of ``_pool_requests``) through
    the slot pool of ``slots`` slots from stage 1, one upgrade per window
    up to stage 8, and check what came out and which kernels ran;
    ``fp_bytes`` is the float leaves' resident bytes (olmo-1b has none);
    ``b2_calls(ticks, steps)`` gives B2's launches as :func:`expect_routes`
    reads them (default: the dense layers' :func:`pass_calls`);
    ``attn_layers`` the attention launches a forward pass (default: a
    layer each); ``hook(pool)`` runs before the first request. Returns
    the drained pool, the run's launch counts and ``dequant_matmul``'s
    launches by route."""
    from repro_torch.serving.engine import PoolRequest, SlotPoolEngine

    cfg = model.cfg
    lengths, budgets, prompts = requests or _pool_requests(cfg)
    n_req = len(prompts)
    checked = FiniteLogits(model)
    pool = SlotPoolEngine(checked, prog, n_slots=slots, max_len=max_len,
                          resident="quantized", dispatch_window=POOL_WINDOW,
                          prefill_chunk=POOL_CHUNK, device=dev)
    if hook is not None:
        hook(pool)
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    pool.receive_stage()
    for rid in range(n_req):
        pool.submit(PoolRequest(rid=rid, prompt=prompts[rid],
                                max_new_tokens=int(budgets[rid])))
    out = pool.run(on_window=lambda _: pool.upgrade_if_available())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_counts, routes = counts(), route_counts()
    gemv_by = check_one_pass(routes, tag)
    op_counts = dict(ops.LAUNCH_COUNTS)

    layers, ticks, steps = cfg.n_layers, pool._tick_count, pool._step_count
    attn = layers if attn_layers is None else attn_layers
    report = pool.resident_report()
    check(sorted(out) == list(range(n_req)), sorted(out))
    for rid, toks in out.items():
        check(len(toks) == budgets[rid], (rid, len(toks), budgets[rid]))
        check(all(0 <= t < cfg.vocab for t in toks), f"request {rid}: token out of vocab")
    check(pool.completed == set(range(n_req)), pool.completed)
    check(bool(torch.stack(checked.flags).all()), f"{tag} non-finite pool logits")
    check(report["fp_bytes"] == fp_bytes, (report["fp_bytes"], fp_bytes))
    check(pool.stage == prog.n_stages == 8, f"pool ended at stage {pool.stage}")
    check(run_counts["plane_or_segments"] == 8, run_counts)
    check(ticks > 0 and op_counts.get("prefill_attention", 0) == run_counts["flash_verify"]
          == attn * ticks, (op_counts, run_counts, ticks))
    check(run_counts["decode_attention"] == op_counts.get("decode_attention", 0)
          == attn * steps, (run_counts, steps))
    # a chunk tick runs every weight at M = slots x chunk, a decode step at
    # M = slots
    calls = (b2_calls(ticks, steps) if b2_calls else
             pass_calls(layers, ticks, slots * POOL_CHUNK) + pass_calls(layers, steps, slots))
    check(run_counts["dequant_matmul"] == op_counts["dequant_matmul"]
          == sum(c[0] for c in calls), (run_counts, ticks, steps))
    check("verify_attention" not in op_counts, op_counts)
    check(routes == expect_routes(calls), routes)
    n_tok = sum(len(t) for t in out.values())
    ttft = [pool.ttft_s[rid] for rid in range(n_req)]
    log(f"{tag} {n_req} requests, prompts {int(lengths.min())}-"
        f"{int(lengths.max())} tokens, budgets {int(budgets.min())}-{int(budgets.max())}; "
        f"{slots} slots, chunk {POOL_CHUNK}, window {POOL_WINDOW}; stages "
        f"1->{pool.stage}, upgrades at steps {[s for s, _ in pool.upgrades]}")
    log(f"{tag} {steps} decode steps, {ticks} chunk ticks, "
        f"{len(pool.window_stats)} windows; launches in the run {run_counts}; "
        f"dequant_matmul by route {routes}, GEMV route by kernel {gemv_by}; "
        f"every request got its budget of in-vocab tokens, logits finite, fp bytes "
        f"{report['fp_bytes']}")
    log(f"{tag} {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tokens/s; TTFT mean "
        f"{sum(ttft) / len(ttft) * 1e3:.1f} ms, largest {max(ttft) * 1e3:.1f} ms; upgrade "
        f"enqueue ms {[round(u['enqueue_s'] * 1e3, 2) for u in pool.upgrade_log]}")
    return pool, run_counts, routes


def _pool_requests(cfg):
    """The pool paths' requests: prompt lengths, budgets and prompts."""
    rng = np.random.default_rng(3)
    lengths = rng.integers(16, 97, POOL_REQUESTS)
    budgets = rng.integers(24, 41, POOL_REQUESTS)
    return lengths, budgets, [rng.integers(0, cfg.vocab, int(n)) for n in lengths]


def _b2_steps(rounds) -> tuple[int, int]:
    """Decode steps and verify passes of speculation rounds (their accept
    records): a round of k drafts is k decode steps and one verify, a
    k = 0 round one decode step."""
    return (sum(r["k"] if r["k"] else 1 for r in rounds),
            sum(1 for r in rounds if r["k"]))


def _spec_phase(model, prog, dev, ops, prompt, plain_bytes) -> dict:
    """``[spec]``: ``SpeculativeEngine`` on phase 3's planes (in-memory
    receiver). The plain server's tokens at each stage come first; then,
    counted from 0: (a) at each of the 8 stages, a fresh start at batch 4
    and SPEC_TOKENS tokens, k = 4 and adaptive, each ``torch.equal`` to
    ``ProgressiveServer(resident="quantized")`` at the same stage; (b) at
    batch 1, 48 tokens with stages 2-8 landing between rounds,
    ``torch.equal`` to a batch-1 server replayed at the run's per-token
    stage log. Every B2 launch but the prefills' layer weights runs on the
    GEMV route's one-pass kernels, the verify passes included; the draft
    adds no resident bytes. Returns the path's counts, B2's launches by
    route and the stage-8 engine's record."""
    from repro_torch.serving import ProgressiveServer, SpecConfig, SpeculativeEngine

    cfg, layers = model.cfg, model.cfg.n_layers
    plain = ProgressiveServer(model, prog, max_len=PROMPT + SPEC_TOKENS, resident="quantized",
                              device=dev)
    engines = {name: SpeculativeEngine(model, prog, max_len=PROMPT + SPEC_TOKENS + 9,
                                       spec=SpecConfig(draft_bits=4, k=k), device=dev)
               for name, k in (("k4", 4), ("adaptive", None))}
    wants, plain_s = {}, 0.0
    for s in range(1, prog.n_stages + 1):
        plain.receive_stage()
        plain.start({"tokens": prompt})
        pres = plain.decode(SPEC_TOKENS)
        wants[s] = pres.tokens.cpu()
        plain_s += sum(t for _, t in pres.window_s)
    torch.cuda.synchronize()
    reset_counts(ops)
    rounds, starts, by_stage = [], 0, {}
    spec_s = {name: 0.0 for name in engines}
    for s in range(1, prog.n_stages + 1):
        for name, eng in engines.items():
            eng.receive_stage()
            eng.start({"tokens": prompt})
            res = eng.decode(SPEC_TOKENS)
            starts += 1
            check(torch.equal(res.tokens, wants[s]), f"[spec] {name} stage {s}: tokens differ "
                  f"from the plain server's")
            rounds += res.accept_rounds
            spec_s[name] += res.wall_s
            by_stage[(name, s)] = (res.rounds, res.drafted, res.accepted,
                                   eng.current_draft_bits(),
                                   sorted({r["k"] for r in res.accept_rounds}))
    # (b) batch 1, the stages landing between rounds
    eng1 = SpeculativeEngine(model, prog, max_len=PROMPT + 48 + 9,
                             spec=SpecConfig(draft_bits=4, k=4), device=dev)
    eng1.receive_stage()
    eng1.start({"tokens": prompt[:1]})
    starts += 1
    res1 = eng1.decode(48, stage_arrival=lambda done: done >= ARRIVALS[eng1.stage - 1])
    rounds += res1.accept_rounds
    torch.cuda.synchronize()
    run_counts, op_counts, routes = counts(), dict(ops.LAUNCH_COUNTS), route_counts()
    gemv_by = check_one_pass(routes, "spec")
    check(eng1.stage == 8 and [u for _, u in res1.upgrades] == list(range(2, 9)),
          res1.upgrades)
    replay = _stage_replay(model, prog, prompt[:1], res1.stage_log[0], dev)
    check(res1.tokens[0].tolist() == replay, "[spec] batch-1 tokens differ from the "
          "stage-log replay")
    steps, verifies = _b2_steps(rounds)
    want_routes = {"mma": layers * 7 * starts,
                   "gemv": (layers * 7 + 1) * (steps + verifies) + starts}
    check(routes == want_routes, (routes, want_routes))
    check(run_counts["flash_verify"] == op_counts["verify_attention"] == layers * verifies,
          (run_counts, verifies))
    check(run_counts["decode_attention"] == layers * steps, run_counts)
    check(run_counts["plane_or_segments"] == 3 * 8, run_counts)
    want = wants[prog.n_stages]
    # zero extra bytes: the views share every q; no float leaf
    eng = engines["k4"]
    rep = eng.resident_report()
    check(rep["extra_draft_bytes"] == 0 and rep["fp_bytes"] == 0, rep["extra_draft_bytes"])
    check(rep["quantized_bytes"] == plain_bytes, (rep["quantized_bytes"], plain_bytes))
    shared = _shared_q(eng.params, eng.draft_params)
    # the draft is a different model: one decode step of each view from
    # the plain server's stage-8 caches
    tok = want[:, -1:].to(dev)
    lt, _ = model.decode_step(eng.params, _clone(plain.caches), tok, plain.pos)
    ld, _ = model.decode_step(eng.draft_params, _clone(plain.caches), tok, plain.pos)
    gap = float((ld - lt).abs().max()) / float(lt.abs().max())
    check(gap > 0, "the draft view's logits equal the target's")
    distinct = len(set(want.reshape(-1).tolist()))
    log(f"[spec] (a) batch {BATCH}, prompt {PROMPT}, {SPEC_TOKENS} tokens from a fresh start "
        f"at each of the 8 stages, k = 4 and adaptive (draft 4 bits): tokens equal "
        f"(torch.equal) to ProgressiveServer(resident='quantized') at every stage")
    toks = prog.n_stages * BATCH * SPEC_TOKENS
    log(f"[spec] plain ProgressiveServer in the same phase: {toks / plain_s:.1f} tokens/s "
        f"over its 8 runs ({plain_s:.3f} s, windows of 8 steps)")
    for name in engines:
        log(f"[spec] {name}: {toks / spec_s[name]:.1f} tokens/s over the 8 runs "
            f"({spec_s[name]:.3f} s); by stage (rounds, drafted, accepted, draft bits, "
            f"k chosen): " + "; ".join(f"{s} {by_stage[(name, s)]}"
                                       for s in range(1, prog.n_stages + 1)))
    log(f"[spec] (b) batch 1, 48 tokens, stages 2-8 landing between rounds at "
        f"{[u for u in res1.upgrades]}: {res1.rounds} rounds, {res1.accepted}/{res1.drafted} "
        f"drafts accepted, {48 / res1.wall_s:.1f} tokens/s; tokens equal to a batch-1 "
        f"ProgressiveServer replayed at the run's per-token stage log")
    log(f"[spec] launches in the run {run_counts}; dequant_matmul by route {routes} "
        f"(decode steps {steps}, verify passes {verifies} at M = T x slots, "
        f"prefills {starts}): every launch but the prefills' layer weights on the GEMV "
        f"route, GEMV route by kernel {gemv_by}")
    log(f"[spec] the draft (4 bits) against the target (16) at stage 8, one decode step: "
        f"max |logit difference| / max |logit| {gap:.3e}, argmax equal in "
        f"{int((ld.argmax(-1) == lt.argmax(-1)).sum())} of {BATCH} slots; the plain stream "
        f"at stage 8 holds {distinct} distinct tokens of {want.numel()}")
    log(f"[spec] zero extra bytes: draft and target share all {shared} q tensors "
        f"(data_ptr), extra_draft_bytes 0, fp_bytes 0, quantized_bytes "
        f"{rep['quantized_bytes']} = the plain server's")
    return {"counts": run_counts, "routes": routes, "engine": eng, "plain": plain,
            "tok_s": {**{name: toks / spec_s[name] for name in engines},
                      "plain": toks / plain_s}}


def _scaled_model(model, dev):
    """Phase 2's seed-0 weights with every decoder weight scaled by
    DECODER_SCALE, divided on the card. With the weights as initialised
    the residual stream keeps the input token's own embedding on top, so
    the tied unembedding repeats the last token and any draft agrees with
    its target; scaled, the layers pick the next token, the stream varies,
    and the 4-bit draft is rejected in part."""
    from repro_torch.core.progressive import divide

    def scaled(tree):
        if isinstance(tree, dict):
            return {k: scaled(v) for k, v in tree.items()}
        return tree * DECODER_SCALE

    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    params["decoder"] = scaled(params["decoder"])
    return divide(params)


def _spec_rejections(model, prog, prompt, dev) -> dict:
    """``[reject]`` single stream: on the scaled model, draft 4 bits,
    k = 4, batch 4, a fresh start at stages 4-8, each run's tokens
    ``torch.equal`` to the plain server's at that stage; the rounds
    reject drafts, accept part of a slot's and leave the slots ragged, so
    that the partial-accept gather and ragged positions run. Fails unless
    some round accepts part of a slot's drafts."""
    from repro_torch.serving import ProgressiveServer, SpecConfig, SpeculativeEngine

    plain = ProgressiveServer(model, prog, max_len=PROMPT + SPEC_TOKENS, resident="quantized",
                              device=dev)
    eng = SpeculativeEngine(model, prog, max_len=PROMPT + SPEC_TOKENS + 9,
                            spec=SpecConfig(draft_bits=4, k=4), device=dev)
    by_stage, drafted, accepted, partial, distinct = {}, 0, 0, 0, set()
    for s in range(1, prog.n_stages + 1):
        plain.receive_stage()
        eng.receive_stage()
        if s < 4:
            continue
        plain.start({"tokens": prompt})
        want = plain.decode(SPEC_TOKENS).tokens.cpu()
        eng.start({"tokens": prompt})
        res = eng.decode(SPEC_TOKENS)
        check(torch.equal(res.tokens, want), f"[reject] stage {s}: speculative tokens differ "
              f"from the plain server's")
        rnds = [r for r in res.accept_rounds if r["k"]]
        by_stage[s] = (res.drafted, res.accepted,
                       sum(1 for r in rnds if min(r["accepted"]) == 0),
                       sum(1 for r in rnds if any(0 < n < r["k"] for n in r["accepted"])),
                       sum(1 for r in rnds if len(set(r["accepted"])) > 1), len(rnds))
        drafted += res.drafted
        accepted += res.accepted
        partial += by_stage[s][3]
        distinct |= set(want.reshape(-1).tolist())
    check(accepted < drafted and partial > 0, f"[reject] no draft rejected, or none in part "
          f"({accepted}/{drafted}, {partial} partial rounds)")
    log(f"[reject] the decoder's weights x {DECODER_SCALE} (seed 0): plain streams of "
        f"{len(distinct)} distinct tokens over stages 4-8; SpeculativeEngine, draft 4 bits, "
        f"k = 4, batch {BATCH}, {SPEC_TOKENS} tokens from a fresh start at each stage: tokens "
        f"equal (torch.equal) to ProgressiveServer's at every stage; by stage (drafted, "
        f"accepted, rounds with a slot rejecting every draft, with a slot accepting part, "
        f"with ragged slots, rounds): " + "; ".join(f"{s} {r}" for s, r in by_stage.items())
        + f"; acceptance {accepted}/{drafted} = {accepted / drafted:.3f}")
    return {"drafted": drafted, "accepted": accepted, "partial": partial}


def _spec_pool_rejections(model, prog, dev) -> dict:
    """``[reject]`` pool: the scaled model's 8 stages, the pool phase's 12
    requests on ``SpeculativeSlotPool`` (draft 4 bits, k = 3), each
    request's tokens ``torch.equal`` to a plain ``SlotPoolEngine``'s:
    the pool's partial takes and position bounds run. Fails unless some
    draft is rejected."""
    from repro_torch.serving import PoolRequest, SlotPoolEngine, SpecConfig
    from repro_torch.serving import SpeculativeSlotPool

    _, budgets, prompts = _pool_requests(model.cfg)
    out = {}
    for name, eng in (("plain", SlotPoolEngine(model, prog, n_slots=POOL_SLOTS,
                                               max_len=POOL_MAX_LEN, resident="quantized",
                                               dispatch_window=POOL_WINDOW,
                                               prefill_chunk=POOL_CHUNK, device=dev)),
                      ("spec", SpeculativeSlotPool(model, prog, n_slots=POOL_SLOTS,
                                                   max_len=POOL_MAX_LEN,
                                                   spec=SpecConfig(draft_bits=4, k=3),
                                                   dispatch_window=POOL_WINDOW,
                                                   prefill_chunk=POOL_CHUNK,
                                                   device=dev))):
        for _ in range(prog.n_stages):
            eng.receive_stage()
        for rid in range(POOL_REQUESTS):
            eng.submit(PoolRequest(rid=rid, prompt=prompts[rid],
                                   max_new_tokens=int(budgets[rid])))
        out[name] = eng.run()
    for rid in range(POOL_REQUESTS):
        check(out["spec"][rid] == out["plain"][rid], f"[reject] pool request {rid}: tokens "
              f"differ from the plain pool's")
    log_ = eng.accept_log
    drafted = sum(r["k"] * len(r["accepted"]) for r in log_)
    accepted = sum(sum(r["accepted"]) for r in log_)
    partial = sum(1 for r in log_ if any(0 < n < r["k"] for n in r["accepted"]))
    check(accepted < drafted, f"[reject] pool: no draft rejected ({accepted}/{drafted})")
    log(f"[reject] SpeculativeSlotPool on the same model, draft 4 bits, k = 3, the pool's "
        f"{POOL_REQUESTS} requests at stage 8: every request's tokens equal (torch.equal) to a "
        f"plain SlotPoolEngine's; acceptance {accepted}/{drafted} = {accepted / drafted:.3f}; "
        f"{partial} of {len(log_)} rounds accept part of a slot's drafts")
    return {"drafted": drafted, "accepted": accepted, "partial": partial}


def _clone(caches):
    return {"cycles": {n: {kv: t.clone() for kv, t in c.items()}
                       for n, c in caches["cycles"].items()}, "tail": {}}


def _shared_q(target, draft) -> int:
    """Check that every quantized leaf of the draft view reads the target
    view's q (the same storage); returns how many."""
    from repro_torch.core.progressive import tree_flatten_with_path
    from repro_torch.core.quantize import QuantizedTensor

    t, d = dict(tree_flatten_with_path(target)), dict(tree_flatten_with_path(draft))
    n = 0
    for path, leaf in t.items():
        if isinstance(leaf, QuantizedTensor):
            check(d[path].q.data_ptr() == leaf.q.data_ptr(), f"draft q of {path} not shared")
            check(d[path].keep_bits is not None and leaf.keep_bits is not None, path)
            n += 1
    check(n > 0, "no quantized leaves")
    return n


def _stage_replay(model, prog, prompt, stage_log, dev) -> list:
    """Plain greedy tokens of a batch-1 ``ProgressiveServer`` replayed at a
    speculative run's per-token stage log: token j's value is computed at
    stage_log[j], its K/V written by the step that computes token j + 1."""
    from repro_torch.serving import ProgressiveServer

    srv = ProgressiveServer(model, prog, max_len=prompt.shape[1] + len(stage_log),
                            resident="quantized", device=dev)
    while srv.stage < stage_log[0]:
        srv.receive_stage()
    srv.start({"tokens": prompt})
    toks = [torch.argmax(srv.last_logits, dim=-1)[:, None]]
    pos = prompt.shape[1]
    for stage in stage_log[1:]:
        while srv.stage < stage:
            srv.receive_stage()
        logits, srv.caches = model.decode_step(srv.params, srv.caches, toks[-1], pos)
        pos += 1
        toks.append(torch.argmax(logits, dim=-1)[:, None])
    return torch.cat(toks, dim=1)[0].tolist()


def _spec_pool_phase(model, prog, dev, ops) -> dict:
    """``[spec pool]``: ``SpeculativeSlotPool`` (8 slots, chunk 8, k = 3)
    on all 8 stages, the pool phase's 12 requests, counted from 0; each
    request's tokens ``torch.equal`` to a plain ``SlotPoolEngine``'s on
    the same requests at stage 8 (both prefill in ticks of M = 64, whose
    rows do not depend on the other rows, and decode on GEMV rows)."""
    from repro_torch.serving import PoolRequest, SlotPoolEngine, SpecConfig
    from repro_torch.serving import SpeculativeSlotPool

    cfg, layers = model.cfg, model.cfg.n_layers
    lengths, budgets, prompts = _pool_requests(cfg)
    spec = SpeculativeSlotPool(model, prog, n_slots=POOL_SLOTS, max_len=POOL_MAX_LEN,
                               spec=SpecConfig(draft_bits=4, k=3), dispatch_window=POOL_WINDOW,
                               prefill_chunk=POOL_CHUNK, device=dev)
    plain = SlotPoolEngine(model, prog, n_slots=POOL_SLOTS, max_len=POOL_MAX_LEN,
                           resident="quantized", dispatch_window=POOL_WINDOW,
                           prefill_chunk=POOL_CHUNK, device=dev)
    for p in (plain, spec):
        for _ in range(prog.n_stages):
            p.receive_stage()
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    for rid in range(POOL_REQUESTS):
        spec.submit(PoolRequest(rid=rid, prompt=prompts[rid], max_new_tokens=int(budgets[rid])))
    out = spec.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_counts, op_counts, routes = counts(), dict(ops.LAUNCH_COUNTS), route_counts()
    gemv_by = check_one_pass(routes, "spec pool")
    for rid in range(POOL_REQUESTS):
        plain.submit(PoolRequest(rid=rid, prompt=prompts[rid],
                                 max_new_tokens=int(budgets[rid])))
    want = plain.run()
    for rid in range(POOL_REQUESTS):
        check(len(out[rid]) == budgets[rid], (rid, len(out[rid])))
        check(out[rid] == want[rid], f"[spec pool] request {rid}: tokens differ from the "
              f"plain pool's")
    steps, verifies = _b2_steps(spec.accept_log)
    ticks = spec._tick_count
    check(routes == {"mma": (layers * 7 + 1) * ticks,
                     "gemv": (layers * 7 + 1) * (steps + verifies)},
          (routes, ticks, steps, verifies))
    check(run_counts["flash_verify"] == layers * (ticks + verifies)
          and op_counts["verify_attention"] == layers * verifies, (run_counts, op_counts))
    drafted = sum(r["k"] * len(r["accepted"]) for r in spec.accept_log)
    accepted = sum(sum(r["accepted"]) for r in spec.accept_log)
    n_tok = sum(len(t) for t in out.values())
    ttft = [spec.ttft_s[rid] for rid in range(POOL_REQUESTS)]
    log(f"[spec pool] {POOL_REQUESTS} requests (prompts {int(lengths.min())}-"
        f"{int(lengths.max())}, budgets {int(budgets.min())}-{int(budgets.max())}), "
        f"{POOL_SLOTS} slots, chunk {POOL_CHUNK}, k = 3 on all 8 stages: every request's "
        f"tokens equal (torch.equal) to a plain SlotPoolEngine's at stage 8")
    log(f"[spec pool] {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tokens/s; TTFT mean "
        f"{sum(ttft) / len(ttft) * 1e3:.1f} ms, largest {max(ttft) * 1e3:.1f} ms; "
        f"{len(spec.accept_log)} rounds, {ticks} chunk ticks; acceptance "
        f"{accepted}/{drafted} = {accepted / max(drafted, 1):.3f}; launches {run_counts}; "
        f"dequant_matmul by route {routes}, GEMV route by kernel {gemv_by}")
    return {"counts": run_counts, "routes": routes, "tok_s": n_tok / wall,
            "plain_stage8": want}


def _view_phase(model, prog, dev, ops, prompt) -> dict:
    """``[quantized view]``: ``QuantizedLinearState`` over ``embed`` as a
    (50304, 2048) weight (K = 50,304 on B2's (K, N) layout, which no
    serving path launches). On a private store (``from_model(indices=)``),
    upgraded plane by plane, counted from 0: at every stage ``matmul`` at M
    = 1, 4 and 64 against ``dequantize`` and ``torch.matmul`` within
    ``DQMM_RTOL``, ``resident_bytes`` constant, at stage 8 the weight
    within ``quantization_error_bound`` of the float it came from. Then on
    a server's shared store at stage 7: one ``upgrade`` through the view is
    the server's, whose next step reads the upgraded accumulators."""
    from repro_torch.core.progressive import ReceiverState
    from repro_torch.core.quantize import dequantize, quantization_error_bound, quantize
    from repro_torch.kernels import dequant_matmul as dqm
    from repro_torch.serving import ProgressiveServer, from_progressive

    cfg = model.cfg
    i = next(k for k, t in enumerate(prog.tensors) if t.path == ("embed",))
    t = prog.tensors[i]
    K, N = t.shape
    xg = torch.Generator(device=dev).manual_seed(11)
    xs = {M: torch.randn((M, K), generator=xg, device=dev) for M in VIEW_M}
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    view = from_progressive(prog, i)
    check(view.store.n_tensors == 1 and view.store.resident_bytes() == view.resident_bytes,
          "the private store holds more than embed")
    sizes, worst = set(), {M: 0.0 for M in VIEW_M}
    for s in range(1, prog.n_stages + 1):
        view.upgrade(t.planes[s - 1])
        sizes.add(view.resident_bytes)
        w = dequantize(view.store.quantized(0), view.received_bits)
        for M, x in xs.items():
            y = view.matmul(x)
            want = x @ w
            err = float((y - want).abs().max()) / float(want.abs().max())
            check(err <= DQMM_RTOL, ("[quantized view]", s, M, err))
            worst[M] = max(worst[M], err)
        del w
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_counts, routes = counts(), route_counts()
    check(len(sizes) == 1 and sizes == {K * N * 2}, sizes)
    check(run_counts["plane_or_segments"] == prog.n_stages, run_counts)
    check(routes == expect_routes([(prog.n_stages, M) for M in VIEW_M]), routes)
    # the float it came from: model.init's first draw from seed 0
    w0 = 0.02 * torch.randn((cfg.vocab, cfg.d_model),
                            generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    qt = quantize(w0, 16)
    check(torch.equal(view.acc, qt.q), "the view's accumulator is not quantize(embed).q")
    bound = float(quantization_error_bound(qt))
    q_err = float((dequantize(view.store.quantized(0)) - w0).abs().max())
    check(q_err <= bound, (q_err, bound))
    log(f"[quantized view] embed as a ({K}, {N}) weight on a private store, 8 upgrades: "
        f"matmul at M = {list(VIEW_M)} against dequantize + torch.matmul at every stage, "
        f"max |err| / max |y| by M {', '.join(f'{M}: {e:.2e}' for M, e in worst.items())} "
        f"(tolerance {DQMM_RTOL}); resident {sizes.pop()} B at every stage; stage 8 within "
        f"{q_err:.3e} of the float weight (quantization_error_bound {bound:.3e}); launches "
        f"{run_counts}, dequant_matmul by route {routes}, GEMV by kernel "
        f"{dict(dqm.launches_by_gemv_kernel)}; {wall:.2f} s")
    del view, w0, qt, xs
    view_counts, view_routes = run_counts, routes

    # the shared store: a pull-mode server at stage 7, embed's plane 8
    # through the view
    srv = ProgressiveServer(model, prog, max_len=PROMPT + 4, resident="quantized", device=dev)
    for _ in range(prog.n_stages - 1):
        srv.receive_stage()
    srv.start({"tokens": prompt})
    store = srv.state.store
    shared = from_progressive(prog, i, store=store)
    check(shared.idx == i and shared.received == prog.n_stages - 1, shared.received)
    reset_counts(ops)
    shared.upgrade(t.planes[prog.n_stages - 1])
    check(counts()["plane_or_segments"] == 1 and store.received[i] == prog.n_stages
          and srv.state.store is store, store.received)
    srv._refresh_params()
    res = srv.decode(4)
    torch.cuda.synchronize()
    check(int(srv.params["embed"].received_bits.max()) == 16
          and srv.params["embed"].q.data_ptr() == store.acc(i).data_ptr(),
          "the server does not read the upgraded embed")
    check(bool(torch.isfinite(srv.last_logits).all()) and res.tokens.shape == (BATCH, 4))
    want = ReceiverState.init(prog, device=dev)
    for s in range(1, prog.n_stages):
        want = want.receive(prog.stage(s))
    want.store.ingest([(i, t.planes[prog.n_stages - 1])])
    fp = store.fingerprint()
    check(fp == want.store.fingerprint(), "the shared store is not stage 7 plus embed's plane 8")
    log(f"[quantized view] on the shared store of a server at stage 7: one upgrade through "
        f"the view (1 plane_or_segments launch) is the server's; its next 4 steps read "
        f"embed at 16 bits from the upgraded buffer; fingerprint {fp} equals stage 7 plus "
        f"embed's plane 8")
    del srv, store, shared, want
    torch.cuda.empty_cache()
    return {"counts": view_counts, "routes": view_routes}


def _alone(model, prog, prompt, budget, admit_stage, step_stages, dev, extras=None,
           max_len=POOL_MAX_LEN) -> list:
    """One request (with its ``extras``) alone in a 1-slot batch-1 pool:
    admitted at ``admit_stage``, each step j run at ``step_stages[j]``."""
    from repro_torch.serving import PoolRequest, SlotPoolEngine

    pool = SlotPoolEngine(model, prog, n_slots=1, max_len=max_len, resident="quantized",
                          chunked_prefill=False, device=dev)
    while pool.stage < admit_stage:
        pool.receive_stage()
    pool.submit(PoolRequest(rid=0, prompt=prompt, max_new_tokens=budget,
                            extras=extras or {}))
    for st in step_stages[:budget]:
        while pool.stage < st:
            pool.receive_stage()
        pool.step()
    pool.flush()
    return pool.outputs[0]


def _pool_batch1_phase(model, prog, dev, ops, chunked_stage8: dict) -> dict:
    """``[pool batch-1]``: both pools admitting at batch 1
    (``chunked_prefill=False``: a bucket-padded prefill a request) on the
    pool phase's 12 requests, from stage 1 with an upgrade a window, each
    counted from 0. Each request alone in a 1-slot batch-1 pool, replayed
    at the busy run's stages, emits its tokens (``torch.equal``): the
    plain pool's, and the speculative pool's (k = 3), which are therefore
    the plain batch-1 pool's. Each admission's prefill is 112 tensor-core
    launches and one GEMV launch (the unembedding of row n_valid - 1).
    Then both admissions at stage 8: the tokens batch-1 shares with
    chunked admission."""
    from repro_torch.serving import PoolRequest, SlotPoolEngine, SpecConfig
    from repro_torch.serving import SpeculativeSlotPool

    cfg, layers = model.cfg, model.cfg.n_layers
    lengths, budgets, prompts = _pool_requests(cfg)
    buckets = [min(1 << (int(n) - 1).bit_length(), POOL_MAX_LEN) for n in lengths]
    prefill_calls = [(layers * 7, b) for b in buckets] + [(1, 1)] * POOL_REQUESTS
    acc, acc_routes, out = {}, {}, {}
    for kind in ("plain", "spec"):
        if kind == "plain":
            pool = SlotPoolEngine(FiniteLogits(model), prog, n_slots=POOL_SLOTS,
                                  max_len=POOL_MAX_LEN, resident="quantized",
                                  dispatch_window=POOL_WINDOW, chunked_prefill=False,
                                  device=dev)
        else:
            # a round emits up to k + 1 tokens a slot: a window of one round,
            # so that the upgrades reach stage 8 within the budgets
            pool = SpeculativeSlotPool(model, prog, n_slots=POOL_SLOTS, max_len=POOL_MAX_LEN,
                                       spec=SpecConfig(draft_bits=4, k=3), dispatch_window=1,
                                       chunked_prefill=False, device=dev)
        torch.cuda.synchronize()
        reset_counts(ops)
        t0 = time.perf_counter()
        pool.receive_stage()
        for rid in range(POOL_REQUESTS):
            pool.submit(PoolRequest(rid=rid, prompt=prompts[rid],
                                    max_new_tokens=int(budgets[rid])))
        res = pool.run(on_window=lambda _, p=pool: p.upgrade_if_available())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_counts, routes = counts(), route_counts()
        gemv_by = check_one_pass(routes, f"pool batch-1 {kind}")
        for k, v in run_counts.items():
            acc[k] = acc.get(k, 0) + v
        for k, v in routes.items():
            acc_routes[k] = acc_routes.get(k, 0) + v
        check(pool._tick_count == 0 and not pool.chunked_prefill)
        check(pool.stage == prog.n_stages and pool.completed == set(range(POOL_REQUESTS)),
              (pool.stage, pool.completed))
        for rid in range(POOL_REQUESTS):
            check(len(res[rid]) == budgets[rid] and all(0 <= x < cfg.vocab for x in res[rid]),
                  (kind, rid, len(res[rid])))
        check(run_counts["plane_or_segments"] == prog.n_stages, run_counts)
        if kind == "plain":
            steps = pool._step_count
            check(bool(torch.stack(pool.model.flags).all()), "non-finite batch-1 pool logits")
            check(routes == expect_routes(prefill_calls
                                          + pass_calls(layers, steps, POOL_SLOTS)), routes)
            check(run_counts["decode_attention"] == layers * steps
                  and run_counts["flash_verify"] == 0, run_counts)
        else:
            steps, verifies = _b2_steps(pool.accept_log)
            check(routes == expect_routes(prefill_calls
                                          + pass_calls(layers, steps + verifies, POOL_SLOTS)),
                  (routes, steps, verifies))
            check(run_counts["decode_attention"] == layers * steps
                  and run_counts["flash_verify"] == layers * verifies, run_counts)
        # each request alone, replayed at the busy run's stages
        t1 = time.perf_counter()
        for rid in range(POOL_REQUESTS):
            log_ = pool.stage_log[rid]
            if kind == "plain":
                # the plain pool logs each token at the step that emits it
                admit, stages = pool.admit_stage[rid], log_
            else:
                # the speculative pool logs the stage a token's value came
                # from; a plain step j computes token j + 1
                admit, stages = log_[0], log_[1:] + log_[-1:]
            got = _alone(model, prog, prompts[rid], int(budgets[rid]), admit, stages, dev)
            check(got == res[rid], f"[pool batch-1] {kind} request {rid}: alone differs from "
                  f"the busy pool")
        t_alone = time.perf_counter() - t1
        n_tok = sum(len(v) for v in res.values())
        ttft = [pool.ttft_s[rid] for rid in range(POOL_REQUESTS)]
        extra = ""
        if kind == "spec":
            drafted = sum(r["k"] * len(r["accepted"]) for r in pool.accept_log)
            accepted = sum(sum(r["accepted"]) for r in pool.accept_log)
            extra = (f"; {len(pool.accept_log)} rounds, acceptance {accepted}/{drafted}; "
                     f"{verifies} verify passes")
        log(f"[pool batch-1] {kind}: {POOL_REQUESTS} requests (prompts "
            f"{int(lengths.min())}-{int(lengths.max())}, buckets {sorted(set(buckets))}), "
            f"{POOL_SLOTS} slots, stages 1->{pool.stage}, upgrades at steps "
            f"{[s for s, _ in pool.upgrades]}; {steps} decode steps{extra}; launches "
            f"{run_counts}, dequant_matmul by route {routes} (each admission 112 tensor-core "
            f"+ 1 GEMV), GEMV by kernel {gemv_by}")
        log(f"[pool batch-1] {kind}: {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} "
            f"tokens/s; TTFT mean {sum(ttft) / len(ttft) * 1e3:.1f} ms, largest "
            f"{max(ttft) * 1e3:.1f} ms; each request alone in a 1-slot batch-1 pool at the "
            f"run's stages equal (torch.equal) ({t_alone:.1f} s)")
        out[kind] = res
        del pool
    # both admissions at stage 8: batch-1 against the [spec pool] phase's
    # plain chunked pool
    b1 = SlotPoolEngine(model, prog, n_slots=POOL_SLOTS, max_len=POOL_MAX_LEN,
                        resident="quantized", dispatch_window=POOL_WINDOW,
                        chunked_prefill=False, device=dev)
    for _ in range(prog.n_stages):
        b1.receive_stage()
    for rid in range(POOL_REQUESTS):
        b1.submit(PoolRequest(rid=rid, prompt=prompts[rid], max_new_tokens=int(budgets[rid])))
    b8 = b1.run()
    same = sum(int(a == b) for rid in range(POOL_REQUESTS)
               for a, b in zip(b8[rid], chunked_stage8[rid]))
    prefix = [next((j for j, (a, b) in enumerate(zip(b8[rid], chunked_stage8[rid])) if a != b),
                   len(b8[rid])) for rid in range(POOL_REQUESTS)]
    n_tok = sum(len(v) for v in b8.values())
    log(f"[pool batch-1] at stage 8, batch-1 against chunked admission (prefill at M = "
        f"bucket against 8-row chunks at M = 64): {same}/{n_tok} tokens equal, "
        f"{sum(p == len(b8[r]) for r, p in enumerate(prefix))}/{POOL_REQUESTS} requests "
        f"whole; tokens equal before the first difference, by request {prefix}")
    return {"counts": acc, "routes": acc_routes, "shared": (same, n_tok)}


def _calibration_loss(model, prog, dev):
    """The calibration loss: a seeded (CAL_BATCH, CAL_LEN) batch prefilled
    with the leaves as float parameters (``rebuild_params``, the float
    residency's path), cross-entropy of every position's logits against
    the full model's greedy next tokens. Returns the loss, its call
    count, the seconds of one call and the full model's loss."""
    import torch.nn.functional as F

    from repro_torch.core import calibrate as cal
    from repro_torch.core.progressive import rebuild_params
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import apply_norm

    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab, (CAL_BATCH, CAL_LEN),
                           generator=torch.Generator().manual_seed(7)).to(dev)

    def logits(leaves):
        params = rebuild_params(prog, leaves)
        x = model._embed(params, tokens)
        x, _ = tfm.run_stack(cfg, params["decoder"], x, mode="prefill")
        x = apply_norm(cfg, params["final_norm"], x)
        return model._unembed(params, x).reshape(-1, cfg.vocab)

    store = cal._full_store(prog)
    full = store.materialize_leaves()
    target = logits(full).argmax(-1)
    calls = [0]

    def loss(leaves) -> float:
        calls[0] += 1
        return float(F.cross_entropy(logits(leaves), target))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full_loss = loss(full)
    t_eval = time.perf_counter() - t0
    calls[0] = 0
    del store, full
    return loss, calls, t_eval, full_loss


def _timed(fn, dev):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev) - base


def _prefix_server(model, prog, sched, meta, prompt, steps: int, dev):
    """A quantized-resident ``ProgressiveServer(receiver=)`` over an
    in-memory store (laid out from the wire header ``meta``, so keyed as a
    client's) that ingests ``sched``'s unit prefix up to each checkpoint:
    the calibrated stream's state with no wire payload and no client.
    Returns the server, ``arrive(k)``, which ingests checkpoint k's units,
    and the store's holder."""
    from types import SimpleNamespace

    from repro_torch.core.plane_store import PlaneStore
    from repro_torch.serving.engine import ProgressiveServer, WireStoreReceiver

    src = SimpleNamespace(store=PlaneStore.from_wire_meta(meta, device=dev), stages_complete=0)
    cps = (0,) + tuple(sched.checkpoints)

    def arrive(k: int) -> None:
        units = sched.units[cps[k - 1]:cps[k]]
        src.store.ingest([(t, prog.tensors[t].planes[p]) for t, p in units])
        src.stages_complete = k

    srv = ProgressiveServer(model, prog, max_len=prompt.shape[1] + steps, resident="quantized",
                            device=dev, receiver=WireStoreReceiver(src, prog))
    return srv, arrive, src


def _replay_prefix(model, prog, sched, meta, prompt, stage_at_step, dev):
    """Tokens and final store fingerprint of :func:`_prefix_server`
    upgraded to each step's checkpoint of ``stage_at_step``."""
    srv, arrive, src = _prefix_server(model, prog, sched, meta, prompt, len(stage_at_step),
                                      dev)
    for k in range(1, stage_at_step[0] + 1):
        arrive(k)
    srv.receive_stage()
    srv.start({"tokens": prompt})

    def step(i: int) -> bool:
        if stage_at_step[i] <= srv.stage:
            return False
        for k in range(src.stages_complete + 1, stage_at_step[i] + 1):
            arrive(k)
        return True

    res = srv.decode(len(stage_at_step), stage_arrival=step)
    check(res.stage_at_step == list(stage_at_step), (res.stage_at_step, stage_at_step))
    return res.tokens, src.store.fingerprint()


def _cpu_copy(prog):
    """``prog`` with every plane and range copied to the host."""
    return dataclasses.replace(prog, tensors=[
        dataclasses.replace(t, planes=[p.cpu() for p in t.planes],
                            lo=torch.as_tensor(t.lo).cpu(), hi=torch.as_tensor(t.hi).cpu())
        for t in prog.tensors])


def _calibrate_phase(model, prog, dev, ops, prompt, clean_fps, arr_uni) -> dict:
    """``[calibrate]``: ``weight_sse_schedule``,
    ``calibrate_schedule(method="marginal")`` and ``greedy_schedule`` on
    full-width olmo-1b under :func:`_calibration_loss`: seconds,
    evaluations, peak device memory, and the builders' ingests counted
    on the path; each schedule valid and MSB-first per tensor; the SSE
    sweep on the card ordered as the same sweep on CPU copies of the
    2-layer model's planes. The greedy schedule goes on the v3 wire (raw)
    through ``Session`` over ``pod-coldstart``: ``run_timeline``, then
    ``run_serving`` quantized (batch 4, 48 steps); after every checkpoint
    a client's store equals an in-memory store fed the same unit prefix,
    the final store is the uniform stream's, and a fresh decode after the
    last checkpoint equals the uniform stream's stage-8 server's. The
    marginal schedule, whose checkpoints hold tensors at different bit
    levels, goes through ``run_serving`` quantized too, its tokens
    ``torch.equal`` to a server fed the same unit prefixes at the run's
    per-step checkpoints. v2 entropy coding is timed on the 2-layer
    model's ``attn.wq`` units. Every run counted from 0."""
    from repro_torch.core import calibrate as cal
    from repro_torch.core import entropy, wire
    from repro_torch.core.plane_store import PlaneStore
    from repro_torch.core.progressive import divide
    from repro_torch.models.model import build_model
    from repro_torch.serving import ProgressiveServer
    from repro_torch.transmission import (ProgressiveClient, Session, StageCost,
                                          get_scenario)

    cfg, layers = model.cfg, model.cfg.n_layers
    plane_counts = [t.plan.schedule.n_planes for t in prog.tensors]
    uniform = cal.uniform_schedule(prog)
    acc, routes = {}, {}
    scheds, info = {}, {}
    ingests = {"plane_or_segments": prog.n_stages}

    def built(fn, store: bool):
        """``fn()`` timed and counted; a builder that holds a full store
        makes its 8 ingests and nothing else."""
        (out, sec, peak), c = _counted(ops, lambda: _timed(fn, dev), acc, routes)
        check({k: v for k, v in c.items() if v} == (ingests if store else {}), c)
        return out, sec, peak

    def record(name, sched, sec, peak, calls=None):
        sched.validate(plane_counts)           # complete and MSB-first per tensor
        check(sched.n_stages == prog.n_stages, (name, sched.checkpoints))
        scheds[name] = sched
        moved = sum(a != b for a, b in zip(sched.units, uniform.units))
        first_cp: dict = {}
        for t, _ in sched.units[:sched.checkpoints[0]]:
            name_t = ".".join(prog.tensors[t].path[-2:])
            first_cp[name_t] = first_cp.get(name_t, 0) + 1
        info[name] = {"s": sec, "peak_GB": peak / 1e9, "evals": calls}
        log(f"[calibrate] {name}: {sec:.2f} s, "
            + (f"{calls} eval_loss calls, " if calls is not None else "")
            + f"peak device memory {peak / 1e9:.2f} GB above the "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB held; valid, MSB-first per "
            f"tensor; {moved} of {len(sched.units)} units away from the uniform ladder's "
            f"place; checkpoints {list(sched.checkpoints)}; planes in the first checkpoint "
            f"{first_cp}")

    sse, sec, peak = built(lambda: cal.weight_sse_schedule(prog), store=False)
    record("weight_sse_schedule (float64 on the card)", sse, sec, peak)
    (loss, calls, t_eval, l0), _, _ = built(lambda: _calibration_loss(model, prog, dev),
                                            store=True)
    log(f"[calibrate] one eval_loss call at full width ({CAL_BATCH} x {CAL_LEN} tokens, float "
        f"leaves): {t_eval * 1e3:.1f} ms, loss of the full model {l0:.4f}")
    marg, sec, peak = built(lambda: cal.calibrate_schedule(prog, loss, method="marginal"),
                            store=True)
    record("calibrate_schedule(method='marginal')", marg, sec, peak, calls[0])
    calls[0] = 0
    greedy, sec, peak = built(lambda: cal.greedy_schedule(prog, loss), store=True)
    record("greedy_schedule", greedy, sec, peak, calls[0])
    del loss

    # the SSE sweep on the card against the same sweep on the host, on
    # the 2-layer model
    m2 = build_model(dataclasses.replace(cfg, n_layers=2))
    prog2 = divide(m2.init(torch.Generator(device=dev).manual_seed(3), device=dev))
    t0 = time.perf_counter()
    card = cal.weight_sse_schedule(prog2)
    t_card = time.perf_counter() - t0
    prog2_cpu = _cpu_copy(prog2)
    t0 = time.perf_counter()
    host = cal.weight_sse_schedule(prog2_cpu)
    t_host = time.perf_counter() - t0
    check(card.units == host.units and card.checkpoints == host.checkpoints,
          "the SSE sweep on the card orders the units otherwise than on the host")
    del prog2_cpu
    log(f"[calibrate] weight_sse_schedule on the 2-layer full-width model: card sweep "
        f"{t_card:.2f} s, the same sweep on CPU copies of the planes {t_host:.2f} s; identical "
        f"units and checkpoints")
    # v2's host codec on the 2-layer model's attn.wq units
    wq = next(i for i, t in enumerate(prog2.tensors) if t.path[-2:] == ("attn", "wq"))
    raw = [wire.encode_unit(prog2, wq, p, entropy_coded=False) for p in range(8)]
    t0 = time.perf_counter()
    coded = [wire.encode_unit(prog2, wq, p, entropy_coded=True) for p in range(8)]
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    for r, c in zip(raw, coded):
        check(entropy.decode(c[0], c[2:], len(r) - 2) == r[2:], "entropy round trip")
    t_dec = time.perf_counter() - t0
    n_raw, n_coded = sum(len(r) for r in raw), sum(len(c) for c in coded)
    log(f"[calibrate] v2 entropy coding (host numpy) of {prog2.tensors[wq].path} "
        f"{tuple(prog2.tensors[wq].shape)}, 8 units: {n_raw} -> {n_coded} bytes "
        f"({n_coded / n_raw:.3f}), encode {t_enc:.2f} s ({n_raw / t_enc / 1e6:.2f} MB/s), "
        f"decode {t_dec:.2f} s ({n_raw / t_dec / 1e6:.2f} MB/s), modes "
        f"{[c[0] for c in coded]}")
    del m2, prog2, raw, coded

    # the greedy schedule on the wire, through the session and a client
    t0 = time.perf_counter()
    blob = wire.encode(prog, schedule=greedy, integrity=True)
    t_encode = time.perf_counter() - t0
    scenario = get_scenario(SESSION_SCENARIO)
    session = Session.from_scenario(blob, scenario, seed=0, device=dev)
    arr = session.stage_arrival_times()
    costs = [StageCost(*SESSION_STAGE_COST)] * prog.n_stages
    tl, c = _counted(ops, lambda: session.run_timeline(costs), acc, routes)
    check(c["plane_or_segments"] >= prog.n_stages and sum(c.values()) == c["plane_or_segments"],
          c)
    check(tl.client.store.fingerprint() == clean_fps[-1],
          "the calibrated stream's final store differs from the uniform stream's")
    del tl
    t0 = time.perf_counter()
    r, c = _counted(ops, lambda: session.run_serving(
        model, prog, decode_steps=SESSION_STEPS, batch={"tokens": prompt},
        resident="quantized"), acc, routes)
    host_s = time.perf_counter() - t0
    check(r.tokens.shape == (BATCH, SESSION_STEPS) and r.server.stage == prog.n_stages,
          r.upgrades)
    check(c["decode_attention"] == layers * SESSION_STEPS
          and c["dequant_matmul"] == (layers * 7 + 1) * (1 + SESSION_STEPS), c)
    # a fresh decode after the last checkpoint against the uniform ladder's
    # stage-8 server
    r.server.start({"tokens": prompt})
    got = r.server.decode(8).tokens
    ref = ProgressiveServer(model, prog, max_len=PROMPT + 8, resident="quantized", device=dev)
    for _ in range(prog.n_stages):
        ref.receive_stage()
    ref.start({"tokens": prompt})
    check(torch.equal(got, ref.decode(8).tokens),
          "tokens after the last checkpoint differ from the uniform stream's at stage 8")
    del ref
    log(f"[calibrate] greedy schedule on the v3 wire: {len(blob)} bytes (encode "
        f"{t_encode:.2f} s); simulated checkpoint arrivals over {SESSION_SCENARIO} "
        f"{[round(a, 4) for a in arr]} s against the uniform ladder's "
        f"{[round(a, 4) for a in arr_uni]} s")
    log(f"[calibrate] run_timeline: final store equal to the uniform stream's; run_serving "
        f"quantized {SESSION_STEPS} steps x {BATCH}: upgrades {r.upgrades}, host "
        f"{host_s:.3f} s; 8 tokens decoded after the last checkpoint equal (torch.equal) to "
        f"the uniform stream's stage-8 server's; launches {c}")
    del r, session
    torch.cuda.empty_cache()
    # after every checkpoint: a client's store against the unit prefix
    meta, ends = _stage_ends(wire, blob)
    client = ProgressiveClient(device=dev)
    want = PlaneStore.from_model(prog, device=dev)
    view, pos, prev = memoryview(blob), 0, 0
    for k, cp in enumerate(greedy.checkpoints):
        client.feed(view[pos:ends[k + 1]])
        pos = ends[k + 1]
        want.ingest([(t, prog.tensors[t].planes[p]) for t, p in greedy.units[prev:cp]])
        prev = cp
        check(client.stages_complete == k + 1 and client.store.received == want.received,
              k)
        check(all(torch.equal(client.store.buffers[dt], want.buffers[dt])
                  for dt in want.buffers), f"checkpoint {k + 1}: store differs")
    del client, want, view, blob
    torch.cuda.empty_cache()
    log(f"[calibrate] a client fed the calibrated stream: after each of the "
        f"{greedy.n_stages} checkpoints its accumulators and received counts equal "
        f"(torch.equal) an in-memory store fed the same unit prefix")

    # the marginal schedule: checkpoints off the uniform ladder's, so a
    # step decodes with tensors at different bit levels
    blob = wire.encode(prog, schedule=marg, integrity=True)
    meta, _ = wire.decode_header(blob)
    session = Session.from_scenario(blob, scenario, seed=0, device=dev)
    arr_m = session.stage_arrival_times()
    t0 = time.perf_counter()
    r, c = _counted(ops, lambda: session.run_serving(
        model, prog, decode_steps=SESSION_STEPS, batch={"tokens": prompt},
        resident="quantized"), acc, routes)
    host_s = time.perf_counter() - t0
    check(r.tokens.shape == (BATCH, SESSION_STEPS) and r.server.stage == prog.n_stages,
          r.upgrades)
    check(c["decode_attention"] == layers * SESSION_STEPS
          and c["dequant_matmul"] == (layers * 7 + 1) * (1 + SESSION_STEPS), c)
    check(r.client.store.fingerprint() == clean_fps[-1],
          "the marginal stream's final store differs from the uniform stream's")
    levels = {}
    for k in sorted(set(r.stage_at_step)):
        rec = [0] * len(prog.tensors)
        for t, _ in marg.units[:marg.checkpoints[k - 1]]:
            rec[t] += 1
        levels[k] = sorted(set(rec))
    check(any(len(v) > 1 for v in levels.values()),
          ("no served checkpoint holds tensors at different bit levels", levels))
    del session, blob
    torch.cuda.empty_cache()
    replay, fp = _replay_prefix(model, prog, marg, meta, prompt, r.stage_at_step, dev)
    check(fp == clean_fps[-1], "the unit-prefix store's final fingerprint differs")
    check(torch.equal(replay, r.tokens),
          "the marginal stream's tokens differ from a server fed the same unit prefixes")
    log(f"[calibrate] marginal schedule through run_serving quantized {SESSION_STEPS} steps "
        f"x {BATCH}: simulated checkpoint arrivals {[round(a, 4) for a in arr_m]} s; "
        f"upgrades {r.upgrades}; planes received a tensor at each served checkpoint "
        f"(distinct levels) {levels}; host {host_s:.3f} s; tokens equal (torch.equal) to a "
        f"ProgressiveServer fed the same unit prefixes in memory at the run's per-step "
        f"checkpoints; final store equal to the uniform stream's; launches {c}")
    del r, replay
    torch.cuda.empty_cache()
    return {"counts": acc, "routes": routes, "info": info}


def _verify_patterns(model, params, target, draft, dev, g) -> int:
    """A verify step's logits and the K/V it writes against sequential
    ``decode_step``s of the same blocks, after reject-all, alternate and
    accept-all patterns: rounds of k draft steps (draft view) and one
    T = k + 1 verify (target view) on one set of caches, the same blocks
    decoded token by token on another, ragged across BATCH slots. Returns
    the rounds checked."""
    B, k, n_rounds = BATCH, 4, 3
    prompt = torch.randint(0, model.cfg.vocab, (B, 16), generator=g, device=dev)
    checked = 0
    for pattern in ("reject_all", "alternate", "accept_all"):
        logits, caches = model.prefill(params, {"tokens": prompt})
        spec_c = model.grow_caches(caches, 16 + n_rounds * (k + 1) + 1)
        seq_c = _clone(spec_c)
        last = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        pos = torch.full((B,), 16, dtype=torch.int32, device=dev)
        for rnd in range(n_rounds):
            toks, cur = [last], last
            for j in range(k):
                lg, spec_c = model.decode_step(draft, spec_c, cur, pos + j)
                cur = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
                toks.append(cur)
            block = torch.cat(toks, dim=1)
            vlog, spec_c = model.verify_step(target, spec_c, block, pos)
            for t in range(k + 1):
                lg, seq_c = model.decode_step(params, seq_c, block[:, t:t + 1], pos + t)
                check(torch.equal(vlog[:, t], lg), f"verify row {t} of round {rnd} "
                      f"({pattern}) differs from its decode step")
            for n, c in spec_c["cycles"].items():
                for kv in ("k", "v"):
                    check(torch.equal(c[kv], seq_c["cycles"][n][kv]),
                          f"{pattern} round {rnd}: cache {kv} differs")
            acc = {"reject_all": [0] * B, "accept_all": [k] * B,
                   "alternate": [k if (rnd + b) % 2 else 0 for b in range(B)]}[pattern]
            acc_t = torch.tensor(acc, device=dev)
            last = torch.gather(torch.argmax(vlog, dim=-1).to(torch.int32), 1, acc_t[:, None])
            pos = pos + acc_t.to(torch.int32) + 1
            checked += 1
    return checked


def _verify_timings(model, eng, dev, g) -> dict:
    """``[time]`` one verify step by CUDA-graph replay at M = 20 (batch 4,
    T = 5) and M = 32 (8 slots, T = 4): its dense layers on the GEMV route
    (rows="decode", as ``verify_step`` runs them) and on the tensor-core
    route (the route M picks), the cost of the choice; host issue ms of the
    step and of a whole round (k = 4 draft steps and the verify)."""
    from repro_torch.kernels import ops

    out = {}
    dqmm = ops.dequant_matmul
    for B, T in ((BATCH, 5), (POOL_SLOTS, 4)):
        caches = model.init_caches(B, POOL_MAX_LEN, device=dev)
        toks = torch.randint(0, model.cfg.vocab, (B, T), generator=g, device=dev,
                             dtype=torch.int32)
        pos = torch.full((B,), PROMPT, dtype=torch.int32, device=dev)

        def step():
            model.verify_step(eng.params, caches, toks, pos)

        gemv_ms = device_ms(step, 2)
        # the route M picks, for the timing: every launch with rows="any"
        ops.dequant_matmul = lambda *a, rows, **kw: dqmm(*a, **kw)
        try:
            mma_ms = device_ms(step, 2)
        finally:
            ops.dequant_matmul = dqmm
        gemv_ms2 = device_ms(step, 2)
        row = {"M": B * T, "gemv_ms": [gemv_ms, gemv_ms2], "mma_ms": mma_ms,
               "host_ms": host_ms(step, 3)}
        if B == BATCH:
            last = toks[:, :1].contiguous()
            rnd = lambda: eng._run_round(caches, last, pos, 4)   # noqa: E731
            row["round_device_ms"] = device_ms(rnd, 1)
            row["round_host_ms"] = host_ms(rnd, 3)
        out[f"M={B * T}"] = row
        log(f"[time] verify_step B={B} T={T} (M={B * T}), stage 8, one step by graph replay: "
            f"GEMV route (rows='decode') {gemv_ms:.4f}, {gemv_ms2:.4f} ms; tensor-core route "
            f"{mma_ms:.4f} ms; cost of the GEMV route {min(gemv_ms, gemv_ms2) - mma_ms:+.4f} ms; "
            f"host issue {row['host_ms']:.3f} ms"
            + (f"; a round (k = 4 drafts + verify): device {row['round_device_ms']:.4f} ms, "
               f"host issue {row['round_host_ms']:.3f} ms" if B == BATCH else ""))
        del caches
    return out


def _arch_phase(name: str, n_layers, dev, ops) -> dict:
    """``[arch <name>]``: a dense variant of ROADMAP A8(a) at its published
    widths (``n_layers`` cuts the depth), seeded random weights. Each path
    counted from 0: divide on the card (``plane_extract``); the single
    stream (batch 4, prompt 64, 48 steps, a stage every 6) in quantized
    residency from in-memory planes, then from v3 wire bytes fed in seeded
    ragged chunks through ``ProgressiveClient`` (its store ``torch.equal``
    to an in-memory store at every stage, ``fingerprint()`` equal at stage
    8, tokens equal); the slot pool's 12 requests with chunked admission;
    ``SpeculativeEngine`` at stage 8 (k = 4), tokens equal to plain greedy
    tokens; float residency on the wire-fed store at stage 8 against
    quantized. Between the paths, the stage-8 accumulators against
    ``quantize(leaf).q``, B2 on every distinct weight shape, B3 and B4 at
    the arch's heads against their plain versions, and the decode step's
    B2, B3 and a verify pass's B4 timed. Then ``_whole_path`` at stages 1
    and 8 (at ``ARCH_PATH_LAYERS`` layers; the CLIs queued in
    ``BESIDE_PATH`` under ``name`` beside it), and (at full depth) the
    CLI. Returns the launch counts and B2's
    launches by route over the paths, and the kernels' rows."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    from repro_torch.models.transformer import recurrent_kinds

    t_phase = time.perf_counter()
    cfg = get_config(name)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if recurrent_kinds(cfg):
        return _recurrent_phase(cfg, dev, ops)
    run = types.SimpleNamespace(
        tag=f"[arch {name}{'' if n_layers is None else f' x{n_layers}'}]", cfg=cfg,
        model=build_model(cfg), dev=dev, ops=ops, counts={}, routes={}, kern={},
        mesh_shards=MESH_ARCH_SHARDS.get(name, ()),
        prompt=torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                             generator=torch.Generator().manual_seed(1)))
    prog = _arch_divide(run)
    tokens = _arch_single(run, prog)
    # each path's engines and stores go before the next path builds its
    # own (a client and its stage callback hold each other: collect them)
    for path in (lambda: _arch_wire(run, prog, tokens), lambda: _arch_pool(run, prog),
                 lambda: _arch_spec(run, prog, run.prompt),
                 lambda: _arch_mesh(run, prog, PROMPT + STEPS)):
        gc.collect()
        torch.cuda.empty_cache()
        path()
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    depth = ARCH_PATH_LAYERS.get(name, 2)
    with _beside(BESIDE_PATH.pop(name, []), BESIDE_GIB.get(name, 0)):
        path_err, chunk_err = _whole_path(cfg, dev, stages=(1, 8), cpu_divides=False,
                                          n_layers=depth)
    log(f"{run.tag} [path] {depth} layers at full width, cuda kernels vs cpu plain versions, "
        f"each side ingesting its own copy of the card's planes, fingerprints equal at "
        f"stages 1 and 8: teacher-forced logits at stages 1 and 8 max |err| / max |logit| = "
        f"{path_err:.3e}; prefill chunk and verify logits at stages 1 and 8: "
        f"{chunk_err:.3e} (tolerance {PATH_RTOL}); {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    if n_layers is None:
        _cli_phase(name, CLI_STREAM)
    log(f"{run.tag} launches on the paths {run.counts}, dequant_matmul by route {run.routes}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"counts": run.counts, "routes": run.routes, "kern": run.kern}


def _arch_divide(run):
    """Seeded weights divided on the card (B6, 8 launches a tensor), the
    largest tensor's planes against the plain version; then an in-memory
    receiver through all 8 stages (B1 over the whole flat buffer, past
    element 2^32 at minitron-4b's width), its stage-8 accumulators against
    ``quantize(leaf).q`` of every tensor, bit for bit, as ``[divide]``
    holds olmo-1b's. Sets the counts of weights and of float norm weights,
    and returns the divided model."""
    from repro_torch.core.progressive import ReceiverState, divide, tree_flatten_with_path
    from repro_torch.core.quantize import quantize
    from repro_torch.kernels import ref
    from repro_torch.models.common import quantized_resident_eligible

    cfg = run.cfg
    params = run.model.init(torch.Generator(device=run.dev).manual_seed(0), device=run.dev)
    leaves = dict(tree_flatten_with_path(params))
    run.n_params = sum(t.numel() for t in leaves.values())
    run.n_fp = sum(t.numel() for k, t in leaves.items() if not quantized_resident_eligible(k))
    torch.cuda.synchronize()
    reset_counts(run.ops)
    t0 = time.perf_counter()
    prog = divide(params)
    torch.cuda.synchronize()
    t_divide = time.perf_counter() - t0
    got, _ = _tally(run.counts, run.routes, f"{run.tag} divide")
    n_t = len(prog.tensors)
    check(got["plane_extract"] == 8 * n_t and sum(got.values()) == 8 * n_t, got)
    big = max(prog.tensors, key=lambda t: int(np.prod(t.shape)))
    q = quantize(leaves[big.path], 16).q
    before = 0
    for w, plane in zip(big.plan.schedule.widths, big.planes):
        check(torch.equal(plane, ref.plane_extract_ref(q, 16, before, w, torch.uint8)),
              f"{run.tag} plane at {before} of {big.path}")
        before += w
    log(f"{run.tag} {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads on "
        f"{cfg.n_kv} KV heads (G = {cfg.n_heads // cfg.n_kv}), hd {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {cfg.norm_type}, {cfg.act}{' (tanh)' if cfg.act == 'gelu' else ''}, "
        f"tied embeddings "
        f"{cfg.tie_embeddings}: {run.n_params} parameters ({run.n_fp} in float norm leaves), "
        f"{n_t} tensors; divide on the card {t_divide:.2f} s, launches {got}; the 8 planes of "
        f"{'/'.join(big.path)} {tuple(big.shape)} equal the plain version")

    # every tensor's q kept on the host while the float weights are freed,
    # so the receiver's old and new buffers fit beside the planes
    t0 = time.perf_counter()
    del q
    want = [quantize(leaves[t.path], 16).q.cpu() for t in prog.tensors]
    del params, leaves
    torch.cuda.empty_cache()
    state = ReceiverState.init(prog, device=run.dev)
    for s in range(1, prog.n_stages + 1):
        state = state.receive(prog.stage(s))
    store = state.store
    for i, t in enumerate(prog.tensors):
        check(torch.equal(store._slice_acc(i), want[i].to(run.dev)),
              f"{run.tag} stage-8 accumulator of {t.path} differs from quantize(leaf).q")
    n_flat = {dt: b.numel() for dt, b in store.buffers.items()}
    beyond = ["/".join(t.path) for t, slot in zip(prog.tensors, store.slots)
              if slot.offset + slot.size > 2 ** 32]
    check(bool(beyond) == (max(n_flat.values()) > 2 ** 32), (n_flat, beyond))
    log(f"{run.tag} stage-8 accumulators of an in-memory receiver equal quantize(leaf).q of "
        f"all {n_t} tensors, bit for bit; flat buffers {n_flat} elements, tensors past "
        f"element 2^32: {beyond or 'none'}; {time.perf_counter() - t0:.1f} s")
    del state, store, want
    return prog


def _arch_single(run, prog) -> torch.Tensor:
    """The single stream (:func:`_arch_stream`: 7 B2 launches a layer and
    the unembedding, a B3 a layer, a decode step); then a decode step's B2
    and B3 launches timed, B2 on every distinct weight shape and B3 on
    layer 0's cache against their plain versions. Returns the tokens."""
    from repro_torch.models.transformer import layer

    L, dev = run.cfg.n_layers, run.dev
    srv, res = _arch_stream(run, prog, L * 7 + 1, L,
                            [(L * 7, BATCH * PROMPT), (1, BATCH)] + pass_calls(L, STEPS, BATCH),
                            "the norms")
    # a decode step's B2 launches, then B3's on the device
    xg = torch.Generator(device=dev).manual_seed(2)
    run.kern["dequant_matmul"] = _decode_b2_row(run, srv.params, xg)
    run.kern["decode_attention"] = _decode_attention_row(
        run, [layer(srv.caches["cycles"]["0_attn"], r) for r in range(L)], xg)
    return res.tokens.cpu()


def _arch_stream(run, prog, b2_step: int, b3_step: int, calls, fp_leaves: str):
    """The single stream from in-memory planes in quantized residency,
    counted from 0: stages 1-8 landing mid-decode, logits finite, resident
    bytes, ``b2_step`` B2 and ``b3_step`` B3 launches a decode step, B2's
    launches by route as ``calls`` (:func:`expect_routes`) and every GEMV
    launch on the one-pass kernels (``_tally``); ``fp_leaves`` names the
    float leaves in the log. Returns the server and its result."""
    from repro_torch.kernels import dequant_matmul as dqm
    from repro_torch.serving import ProgressiveServer

    cfg, dev = run.cfg, run.dev
    lm = LogitLog(run.model)
    checked = FiniteLogits(lm)
    srv = ProgressiveServer(checked, prog, max_len=PROMPT + STEPS, resident="quantized",
                            device=dev)
    torch.cuda.synchronize()
    reset_counts(run.ops)
    t0 = time.perf_counter()
    srv.receive_stage()
    srv.start(_batch(run, run.prompt))
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = counts()
    res = srv.decode(STEPS, stage_arrival=lambda i: i in ARRIVALS)
    got, by = _tally(run.counts, run.routes, f"{run.tag} serve")
    per_step = {k: (got[k] - after_prefill[k]) / STEPS for k in got}
    rep = srv.resident_report()
    decode_s = sum(s for _, s in res.window_s)
    check(srv.stage == 8 and [s for _, s in res.upgrades] == list(range(2, 9)), res.upgrades)
    check(bool(torch.stack(checked.flags).all()) and bool(torch.isfinite(srv.last_logits).all()),
          f"{run.tag} non-finite logits")
    check(res.tokens.shape == (BATCH, STEPS) and int(res.tokens.max()) < cfg.vocab)
    check(rep["quantized_bytes"] == 2 * (run.n_params - run.n_fp)
          and rep["fp_bytes"] == 4 * run.n_fp and rep["fp_leaves"] > 0, rep)
    check(per_step["dequant_matmul"] == b2_step and per_step["decode_attention"] == b3_step,
          per_step)
    check(got["plane_or_segments"] == 8 and got["flash_verify"] == 0, got)
    check(by == expect_routes(calls), by)
    # the stream [mesh] holds its sharded runs to
    run.stream = (lm.logits, res.tokens.cpu()) if run.mesh_shards else None
    log(f"{run.tag} single stream (in-memory planes, quantized): stages "
        f"{res.stage_at_step[0]}->{res.stage_at_step[-1]}, upgrades {res.upgrades}; resident "
        f"{rep['quantized_bytes']} B quantized + {rep['fp_bytes']} B in {rep['fp_leaves']} "
        f"float leaves ({fp_leaves})")
    log(f"{run.tag} receive_stage + prefill {t_prefill * 1e3:.1f} ms; decode {STEPS} steps x "
        f"{BATCH} with 7 upgrades: {decode_s:.3f} s, {BATCH * STEPS / decode_s:.1f} tokens/s, "
        f"{decode_s / STEPS * 1e3:.2f} ms/step; per step dequant_matmul "
        f"{per_step['dequant_matmul']:.0f}, decode_attention {per_step['decode_attention']:.0f}; "
        f"launches {got}; dequant_matmul by route {by}, GEMV route by kernel "
        f"{dict(dqm.launches_by_gemv_kernel)}")
    return srv, res


def _batch(run, prompt) -> dict:
    """A prompt's batch: its tokens and, for a cross-attention arch, its
    memory input (``run.memory(prompt)``)."""
    memory = getattr(run, "memory", None)
    return {"tokens": prompt, **(memory(prompt) if memory else {})}


def _decode_attention_row(run, caches, xg) -> dict:
    """B3 on ``caches`` (a decode step's layer caches, (B, Kh, S, hd)) at
    the arch's heads: the first within ``ATTN_RTOL`` of the plain version
    (a ragged slot, a free slot), then the step's launches timed beside
    the bound, the plain version and SDPA. Returns the kernels-line row."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref

    cfg, dev, L = run.cfg, run.dev, len(caches)
    S = caches[0]["k"].shape[2]
    k_pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(BATCH, 1)
    k_pos[1, 41:] = -1
    q_pos = torch.tensor([S - 1, S - 1, 70, -1], dtype=torch.int32, device=dev)
    q = torch.randn((BATCH, cfg.n_heads, cfg.hd), generator=xg, device=dev).to(cfg.dtype)
    n_b = 2 * caches[0]["k"].numel() * caches[0]["k"].element_size() \
        + 2 * q.numel() * q.element_size() + k_pos.numel() * 4 + BATCH * 4
    b, bb = bound_ms(L * n_b, L * 4 * BATCH * cfg.n_heads * S * cfg.hd,
                     attn_flops(caches[0]["k"].dtype))
    o = da.flash_decode(q, caches[0]["k"], caches[0]["v"], k_pos, q_pos)
    want = ref.flash_decode_ref(q, caches[0]["k"], caches[0]["v"], k_pos, q_pos)
    err = float((o.float() - want).abs().max())
    check(bool(torch.isfinite(o).all()) and err <= ATTN_RTOL * float(want.abs().max()),
          (run.tag, "decode_attention", err))
    mask = torch.where((k_pos >= 0) & (k_pos <= q_pos[:, None]), 0.0, -1e30).to(cfg.dtype)
    row = _attention_times(
        lambda: [da.flash_decode(q, c["k"], c["v"], k_pos, q_pos) for c in caches],
        lambda: [ref.flash_decode_ref(q, c["k"], c["v"], k_pos, q_pos) for c in caches],
        lambda: [_sdpa(q[:, None], c, mask[:, None, None]) for c in caches])
    log(f"{run.tag} [check] decode_attention B={BATCH} H={cfg.n_heads} Kh={cfg.n_kv} S={S} "
        f"hd={cfg.hd} (ragged slot, free slot): max |err| {err:.3e} (tolerance {ATTN_RTOL} of "
        f"max |out|); [time] a decode step's {L} launches {row['ms']:.4f} ms on the device, "
        f"bound {b:.4f} ms ({bb}), plain {row['plain_ms']:.4f} ms, library "
        f"{row['library_ms']:.4f} ms (scaled_dot_product_attention, GQA, additive mask)")
    return {**row, "bound_ms": b, "bound_by": bb, "max_abs_err": err,
            "per": f"one decode step ({L} launches)"}


def _stack_layers(cfg, tree) -> list:
    """Every layer of a decoder tree (params or caches), in the order a
    forward pass runs them: each cycle's slots layer by layer, then the
    tail; a ``shared_attn`` use is the params' ``shared`` block (a cache
    tree keeps the use's own cache)."""
    from repro_torch.models.transformer import layer

    def one(part, slot, kind, r=None):
        if kind == "shared_attn" and "shared" in tree:
            return tree["shared"]          # the params' one set (caches keep a use each)
        return tree[part][slot] if r is None else layer(tree[part][slot], r)

    out = [one("cycles", f"{j}_{kind}", kind, r) for r in range(cfg.n_cycles)
           for j, kind in enumerate(cfg.cycle)]
    return out + [one("tail", f"{i}_{kind}", kind) for i, kind in enumerate(cfg.tail)]


def _decode_b2_row(run, P, xg, calls=None, check_shapes=None) -> dict:
    """A decode step's B2 launches at M = BATCH (bfloat16 x for the
    layers, float32 for the unembedding) on the live views ``P``: the
    step timed beside its bound, each weight shape's launches beside the
    plain version and ``torch.matmul`` on dequantised float32 weights, the
    deepest weight also on the general kernel; then every distinct weight
    shape checked (:func:`_arch_dqmm_check`). ``calls`` ((x, view) pairs)
    and ``check_shapes`` (returns the check's worst error) replace both
    for a stack whose layers are not the dense seven. Returns the
    kernels-line row."""
    from repro_torch.kernels import dequant_matmul as dqm
    from repro_torch.kernels import ref

    cfg, dev = run.cfg, run.dev
    layers = _stack_layers(cfg, P["decoder"])
    unembed = P["embed"].T if cfg.tie_embeddings else P["lm_head"]
    if calls is None:
        ws = [w for lr in layers for w in _layer_weights(lr)]
        xs = {k: torch.randn((BATCH, k), generator=xg, device=dev).to(cfg.dtype)
              for k in {w.q.shape[0] for w in ws}}
        calls = [(xs[w.q.shape[0]], w) for w in ws] + [
            (torch.randn((BATCH, cfg.d_model), generator=xg, device=dev), unembed)]
    M_all = sorted({x.shape[0] for x, _ in calls})

    def b2(sub, fn=dqm.dequant_matmul):
        for x, w in sub:
            fn(x, w.q, w.scale, w.offset)

    b, bb = _dqmm_bound(calls)
    row = {"ms": device_ms(lambda: b2(calls), 2), "host_ms": host_ms(lambda: b2(calls), 2),
           "bound_ms": b, "bound_by": bb,
           "per": f"one decode step ({len(calls)} launches at M="
                  f"{'/'.join(map(str, M_all))})"}
    # each weight shape's launches alone, beside the plain version and
    # torch.matmul on the dequantised float32 weights (one shape's float
    # weights held at a time); the step's plain and library times are
    # the sums over the shapes
    row["by_shape"] = {}
    for shape in sorted({tuple(w.q.shape) for _, w in calls}):
        sub = [(x, w) for x, w in calls if tuple(w.q.shape) == shape]
        dense = [(x.float(), w.q.to(torch.float32) * w.scale.reshape(()) + w.offset.reshape(()))
                 for x, w in sub]
        row["by_shape"][f"K={shape[0]} N={shape[1]}"] = {
            "launches": len(sub), "ms": device_ms(lambda: b2(sub), 2),
            "plain_ms": device_ms(lambda: b2(sub, ref.dequant_matmul_ref), 1),
            "library_ms": device_ms(lambda: [torch.matmul(x, w) for x, w in dense], 2),
            "bound_ms": _dqmm_bound(sub)[0]}
        del dense
    for k in ("plain_ms", "library_ms"):
        row[k] = sum(r[k] for r in row["by_shape"].values())
    by_shape = [f"{k} x{r['launches']} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, plain "
                f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f})"
                for k, r in row["by_shape"].items()]
    # the deepest layer weight also on the general GEMV kernel, which takes
    # what the one-pass kernels cannot: a copy whose row stride (N + 1)
    # rules out their vector loads
    x, w = max(calls[:-1], key=lambda c: c[1].q.shape[0])
    K, N = w.q.shape
    strided = torch.empty((K, N + 1), dtype=w.q.dtype, device=dev)[:, :N]
    strided.copy_(w.q)
    check(not dqm.one_pass(strided), "the strided copy takes the one-pass kernels")
    row["general_ms"] = {f"K={K} N={N}": (
        device_ms(lambda: dqm.dequant_matmul(x, w.q, w.scale, w.offset), 5),
        device_ms(lambda: dqm.dequant_matmul(x, strided, w.scale, w.offset), 5))}
    del strided
    log(f"{run.tag} [time] dequant_matmul per {row['per']}: {row['ms']:.4f} ms on the device, "
        f"bound {b:.4f} ms ({bb}), plain {row['plain_ms']:.4f} ms, library "
        f"{row['library_ms']:.4f} ms (torch.matmul on dequantised float32 weights), host "
        f"issue {row['host_ms']:.4f} ms; by weight shape: "
        + "; ".join(by_shape) + f"; one launch at K={K} N={N}, one-pass and general kernel "
        f"(a copy of row stride N + 1): {row['general_ms']} ms")
    row["max_rel_err"] = (check_shapes() if check_shapes else
                          _arch_dqmm_check(run.tag, layers[0], unembed, cfg, dev, xg))
    return row


def _arch_wire(run, prog, tokens) -> None:
    """The single stream from v3 wire bytes through a CUDA client, counted
    from 0 (encode, feed, ingest, serve), an in-memory store fed in
    lockstep: ``torch.equal`` at every stage (a store's fingerprint is
    the CRC32 of these bytes, minutes of host work at this width), and
    ``fingerprint()`` equal at stage 8; the tokens equal the in-memory
    stream's. Then float residency on the client's store
    (:func:`_arch_fp`)."""
    from repro_torch.core import wire
    from repro_torch.core.progressive import ReceiverState
    from repro_torch.serving import ProgressiveServer, WireStoreReceiver
    from repro_torch.transmission import ProgressiveClient

    dev = run.dev
    reset_counts(run.ops)
    t0 = time.perf_counter()
    blob = wire.encode(prog, integrity=True)
    t_encode = time.perf_counter() - t0
    meta, ends = _stage_ends(wire, blob)
    n_el = sum(t.planes[0].numel() for t in prog.tensors)
    check(len(blob) - ends[0] == 2 * n_el + len(meta["units"]) * wire.FRAME_BYTES_V3,
          (len(blob), ends[0], n_el))
    mem = [ReceiverState.init(prog, device=dev)]
    ingest_ms = []

    def lockstep() -> None:
        # the in-memory store takes the client's newest stage once the
        # server has upgraded to it and let go of the client's old buffer
        s = client.stages_complete
        torch.cuda.synchronize()
        t = time.perf_counter()
        mem[0] = mem[0].receive(prog.stage(s))
        torch.cuda.synchronize()
        ingest_ms.append((time.perf_counter() - t) * 1e3)
        check(all(torch.equal(client.store.buffers[k], v)
                  for k, v in mem[0].store.buffers.items()),
              f"{run.tag} wire-fed store differs from the in-memory one at stage {s}")

    client = ProgressiveClient(device=dev)
    feed_to = _feeder(client, blob, 5)
    feed_s = [feed_to(ends[1])]
    srv = ProgressiveServer(run.model, prog, max_len=PROMPT + STEPS, resident="quantized",
                            device=dev, receiver=WireStoreReceiver(client, prog))

    def arrive(i: int) -> bool:
        if i not in ARRIVALS:
            return False
        lockstep()
        feed_s.append(feed_to(ends[client.stages_complete + 1]))
        return True

    srv.receive_stage()
    srv.start(_batch(run, run.prompt))
    res = srv.decode(STEPS, stage_arrival=arrive)
    lockstep()
    got, _ = _tally(run.counts, run.routes, f"{run.tag} wire")
    check(client.complete and len(ingest_ms) == 8 and srv.stage == 8, ingest_ms)
    check(torch.equal(res.tokens.cpu(), tokens), f"{run.tag} wire-fed tokens differ")
    t0 = time.perf_counter()
    fps = client.store.fingerprint(), mem[0].store.fingerprint()
    t_fp = time.perf_counter() - t0
    check(fps[0] == fps[1], fps)
    decode_s = sum(s for _, s in res.window_s)
    del mem, srv
    gc.collect()
    _arch_fp(run, prog, WireStoreReceiver(client, prog), run.prompt, "wire-fed store")
    log(f"{run.tag} wire: encode v3 {t_encode:.2f} s, {len(blob)} bytes, {len(meta['units'])} "
        f"units; fed in seeded ragged chunks of 1 B to {CHUNK_MAX >> 20} MB, a stage at each "
        f"arrival: host feed s a stage {[round(f, 3) for f in feed_s]}, "
        f"{len(blob) / sum(feed_s) / 1e9:.3f} GB/s; the store equal (torch.equal) to an "
        f"in-memory store fed in lockstep after each of the 8 stages (ingest ms, "
        f"synchronised, {[round(t, 2) for t in ingest_ms]}); fingerprint() at stage 8 equal "
        f"{fps[0]} ({t_fp:.1f} s for both); served {STEPS} x {BATCH} with the feeding in "
        f"{decode_s:.3f} s, {BATCH * STEPS / decode_s:.1f} tokens/s, tokens equal "
        f"(torch.equal) to the in-memory stream's; launches {got}; host peak resident "
        f"memory {_peak_rss_gb():.1f} GB")


def _peak_rss_gb() -> float:
    """The host's peak resident memory of this process, GB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _arch_pool(run, prog) -> None:
    """The slot pool's 12 requests as ``[pool]`` runs them, counted from
    0; then B4 on its live caches."""
    pool, got, by = _pool_phase(run.model, prog, run.dev, run.ops, f"{run.tag} pool",
                                4 * run.n_fp)
    for acc, new in ((run.counts, got), (run.routes, by)):
        for k, v in new.items():
            acc[k] = acc.get(k, 0) + v
    run.kern["flash_verify"] = _arch_verify_check(run, pool)


def _arch_spec(run, prog, prompt, k_max=8):
    """``SpeculativeEngine`` at stage 8 (k = 4, draft 4 bits), counted from
    0, against the plain server's greedy tokens (run first). A windowed
    arch's rings grow by ``k_max + 1`` slots in the engine, and by as many
    in the plain server, so both see the same rings. Returns the engine's
    caches."""
    from repro_torch.serving import ProgressiveServer, SpecConfig, SpeculativeEngine

    cfg, L, n = run.cfg, run.cfg.n_layers, prompt.shape[1]
    margin = k_max + 1 if cfg.window else 0
    plain = ProgressiveServer(run.model, prog, max_len=n + SPEC_TOKENS + margin,
                              resident="quantized", device=run.dev)
    for _ in range(8):
        plain.receive_stage()
    plain.start(_batch(run, prompt))
    if margin:
        plain.caches = run.model.grow_caches(plain.caches, plain.max_len, ring_margin=margin,
                                             pos=n)
    want = plain.decode(SPEC_TOKENS).tokens.cpu()
    del plain
    gc.collect()
    eng = SpeculativeEngine(run.model, prog, max_len=n + SPEC_TOKENS + k_max + 1,
                            spec=SpecConfig(draft_bits=4, k=4, k_max=k_max), device=run.dev)
    torch.cuda.synchronize()
    reset_counts(run.ops)
    for _ in range(8):
        eng.receive_stage()
    eng.start(_batch(run, prompt))
    res = eng.decode(SPEC_TOKENS)
    steps, verifies = _b2_steps(res.accept_rounds)
    got, by = _tally(run.counts, run.routes, f"{run.tag} spec")
    rings = sorted({c["k"].shape[-2] for slot, c in eng.caches["cycles"].items()
                    if slot.endswith("_swa")})
    check(rings == ([cfg.window + margin] if margin else []), rings)
    check(torch.equal(res.tokens.cpu(), want), f"{run.tag} speculative tokens differ from plain")
    check(got["flash_verify"] == getattr(run, "attn_layers", L) * verifies and verifies > 0,
          (got, verifies))
    # the prefill's launches on the tensor cores, a pass's on the GEMV route
    # (and the prefill's unembedding of the last position)
    mma, per_pass = getattr(run, "spec_b2", (L * 7, L * 7 + 1))
    check(by == {"mma": mma, "gemv": per_pass * (steps + verifies) + 1}, by)
    rep = eng.resident_report()
    check(rep["extra_draft_bytes"] == 0 and rep["fp_bytes"] == 4 * run.n_fp, rep["fp_bytes"])
    log(f"{run.tag} spec: SpeculativeEngine at stage 8, k = 4, k_max = {k_max}, draft 4 bits, "
        f"batch {BATCH}, prompt {n}{f' (rings of {rings[0]} slots)' if margin else ''}, "
        f"{SPEC_TOKENS} tokens: equal (torch.equal) to plain greedy tokens; {res.rounds} "
        f"rounds, {res.accepted}/{res.drafted} drafts accepted, {verifies} verify passes "
        f"(flash_verify at T = 5, B2 at M = {BATCH * 5} on the GEMV route); extra draft bytes "
        f"0, the norms' float leaves shared; launches {got}, dequant_matmul by route {by}")
    return eng.caches


def _arch_fp(run, prog, receiver, prompt, store) -> None:
    """Float residency against quantized at stage 8 on ``receiver``'s store
    (``store`` names it in the log), from ``prompt``, each a fresh server
    over it (one float materialization, no second store); the float run
    counted from 0. With ``run.fp_dtype`` (the recurrent archs) both
    residencies also serve at that activation dtype, whose logits are the
    ones held to ``FP_LOGIT_RTOL``; the arch dtype's are compared and
    logged (a random-weight xLSTM moves its logits by more than that when
    its weights are rounded to bfloat16: PERF.md)."""
    from repro_torch.models.model import build_model
    from repro_torch.serving import ProgressiveServer

    L, n = run.cfg.n_layers, prompt.shape[1]
    fp_dtype = getattr(run, "fp_dtype", None) or run.cfg.dtype
    models = {run.cfg.dtype: run.model}
    models.setdefault(fp_dtype, build_model(dataclasses.replace(run.cfg, dtype=fp_dtype)))
    logs: dict = {}
    for dtype, model in models.items():
        for resident in ("quantized", "fp"):
            lm = LogitLog(model)
            srv = ProgressiveServer(lm, prog, max_len=n + ARCH_FP_STEPS, resident=resident,
                                    device=run.dev, receiver=receiver)
            torch.cuda.synchronize()
            reset_counts(run.ops)
            srv.receive_stage()
            srv.start(_batch(run, prompt))
            res = srv.decode(ARCH_FP_STEPS)
            if resident == "fp":
                got, by = _tally(run.counts, run.routes, f"{run.tag} fp")
                check(by == {"gemv": 0, "mma": 0} and got["decode_attention"]
                      == getattr(run, "attn_layers", L) * ARCH_FP_STEPS, (got, by))
                rep = srv.resident_report()
            logs[dtype, resident] = (lm.logits, res.tokens)
            del srv, lm
            gc.collect()
    run.fp_ref = logs[run.cfg.dtype, "fp"]   # the float run [mesh] holds its sharded one to
    found = {dtype: _fp_against_quantized(logs[dtype, "fp"][0], logs[dtype, "quantized"][0],
                                          logs[dtype, "fp"][1], logs[dtype, "quantized"][1],
                                          held=dtype == fp_dtype)
             for dtype in models}
    worst, n_checked, near = found[fp_dtype]
    check(rep["quantized_bytes"] == 0 and rep["fp_bytes"] == 4 * run.n_params, rep)
    held = "" if fp_dtype == run.cfg.dtype else f" at {str(fp_dtype)[6:]} activations"
    log(f"{run.tag} float residency on the {store} at stage 8 (prompt {n}, {ARCH_FP_STEPS} "
        f"steps x {BATCH}){held}: logits within {worst:.3e} of the largest quantized logit "
        f"(tolerance {FP_LOGIT_RTOL}), greedy tokens equal at all {n_checked} positions whose "
        f"top-two margin clears twice that ({near} within it); {rep['fp_bytes']} float bytes "
        f"beside the {store}'s accumulators"
        + "".join(f"; at the arch's {str(dt)[6:]} activations (compared, not held): logits "
                  f"within {found[dt][0]:.3e}, tokens equal at {found[dt][1]} positions "
                  f"({found[dt][2]} within the margin)" for dt in models if dt != fp_dtype))


def _mesh_b2_step(cfg, n: int, step_weights=None) -> tuple[int, int]:
    """A decode step's B7 calls and B2 launches on n shards: every layer
    weight (the attention's four, then the MLP's three or the router) and
    an untied ``lm_head`` through B7, n B2 launches each but for a router
    whose n parts are too narrow for the one-pass kernels (B7 joins its
    columns for one launch); each expert's three slots one B2 launch on
    its owning shard; a tied ``embed.T`` one B2 launch on the gathered
    table. ``step_weights``, the (name, N) of each B2 weight a decode step
    runs (a recurrent or cross-attention arch's), reckons from them by
    the same rules: N divisible by n is one B7 call of n B2 launches, or
    of one where the N / n columns are not a multiple of 8 but the N
    columns are (the one-pass kernels' loads: B7 joins them); N
    indivisible is a whole-routed weight, one B2 launch; ``embed.T`` one
    on the gathered table."""
    if step_weights is not None:
        b7 = sum(1 for name, N in step_weights if name != "embed.T" and N % n == 0)
        b2 = sum(1 if name == "embed.T" or N % n or ((N // n) % 8 and N % 8 == 0) else n
                 for name, N in step_weights)
        return b7, b2
    L, E = cfg.n_layers, cfg.n_experts
    b7 = (5 if E else 7) * L + (0 if cfg.tie_embeddings else 1)
    joined = L if E and (E // n) % 8 else 0
    return b7, n * (b7 - joined) + joined + 3 * E * L + (1 if cfg.tie_embeddings else 0)


def _arch_mesh(run, prog, max_len: int, model=None) -> None:
    """``[mesh]`` of an arch phase, for each n of ``run.mesh_shards``, on
    ``make_serving_mesh(n, devices=[card] * n)`` over the planes the phase
    holds: the phase's single stream (:func:`_mesh_stream`), and for a MoE
    arch the checks of :func:`_moe_mesh`; each check's seconds and the
    peak device memory logged. ``model`` wraps ``run.model`` as the
    phase's stream did."""
    from repro_torch.launch.mesh import make_serving_mesh

    if not run.mesh_shards:
        return
    t_mesh = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    one = _StoreReceiver(prog, run.dev) if run.cfg.n_experts else None
    for n in run.mesh_shards:
        mesh = make_serving_mesh(n, devices=[run.dev] * n)
        _mesh_stream(run, prog, mesh, max_len, model or run.model)
        gc.collect()
        torch.cuda.empty_cache()
        if one is not None:
            _moe_mesh(run, prog, mesh, one)
            gc.collect()
            torch.cuda.empty_cache()
    run.stream = None
    log(f"{run.tag} [mesh] {time.perf_counter() - t_mesh:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")


def _mesh_stream(run, prog, mesh, max_len: int, model) -> None:
    """The phase's single stream on ``mesh`` (quantized, 8 stages landing
    mid-decode), counted from 0: every logit and token ``torch.equal`` to
    the phase's single-device stream; B7, B2 and B3 launches a decode step
    as :func:`_mesh_b2_step` counts them, every GEMV launch one-pass; one
    ``plane_or_segments`` a sub-store a stage; the same quantized bytes."""
    from repro_torch.serving import ProgressiveServer

    cfg, L, dev, n = run.cfg, run.cfg.n_layers, run.dev, mesh.shape["model"]
    want_logits, want_tokens = run.stream
    step_weights = getattr(run, "step_weights", None)
    b3 = getattr(run, "attn_layers", L)
    lm = LogitLog(model)
    srv = ProgressiveServer(lm, prog, max_len=max_len, resident="quantized", mesh=mesh,
                            device=dev)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_counts(run.ops)
    srv.receive_stage()
    srv.start(_batch(run, run.prompt))
    after_prefill = counts()
    res = srv.decode(STEPS, stage_arrival=lambda i: i in ARRIVALS)
    got, by = _tally(run.counts, run.routes, f"{run.tag} [mesh]")
    per_step = {k: (got[k] - after_prefill[k]) / STEPS for k in got}
    b7, b2 = _mesh_b2_step(cfg, n, step_weights)
    one_b2 = (len(step_weights) if step_weights is not None
              else L * (5 + 3 * cfg.n_experts if cfg.n_experts else 7) + 1)
    rep = srv.resident_report()
    decode_s = sum(s for _, s in res.window_s)
    check(len(lm.logits) == len(want_logits) == 1 + STEPS, (len(lm.logits), len(want_logits)))
    check(all(torch.equal(a, b) for a, b in zip(lm.logits, want_logits)),
          f"{run.tag} [mesh] n={n}: sharded logits differ from one device's")
    check(torch.equal(res.tokens.cpu(), want_tokens) and srv.stage == 8,
          f"{run.tag} [mesh] n={n}: sharded tokens differ from one device's")
    check(per_step["sharded_dequant_matmul"] == b7 and per_step["dequant_matmul"] == b2
          and per_step["decode_attention"] == b3, (per_step, b7, b2, b3))
    check(got["plane_or_segments"] == 8 * n and got["flash_verify"] == 0, got)
    check(rep["quantized_bytes"] == 2 * (run.n_params - run.n_fp), rep)
    gathered = sorted(k for k, g in srv.state.store._gathered.items() if g)
    log(f"{run.tag} [mesh] {n} logical shards of the card, the single stream (quantized, "
        f"stages landing mid-decode): {len(lm.logits)} logits and {res.tokens.numel()} tokens "
        f"equal (torch.equal) to one device's; a decode step {b7} B7 calls, {b2} B2 launches "
        f"(one device: {one_b2}), {b3} B3; launches {got}, B2 by route {by}; resident "
        f"{rep['quantized_bytes']} B quantized as one device, {rep['gathered_bytes']} B "
        f"gathered ({len(gathered)} leaves: {', '.join(map(str, gathered[:3]))}"
        f"{', ...' if len(gathered) > 3 else ''}); decode {STEPS} steps x {BATCH} with 7 "
        f"upgrades: {decode_s:.3f} s, {BATCH * STEPS / decode_s:.1f} tokens/s, "
        f"{decode_s / STEPS * 1e3:.2f} ms/step; {time.perf_counter() - t0:.1f} s")
    if cfg.name == MESH_B7_TIMED:
        run.kern["sharded_dequant_matmul"] = _mesh_b7_row(run, srv.params, mesh)


def _mesh_b7_row(run, P, mesh) -> dict:
    """B7 on one decode step's split weights (``run.step_weights`` less the
    unembedding) at M = BATCH through ``common.dense``, as the sharded
    stream runs them, against single-device B2 on the same weights
    gathered, timed in turns (B2, B7, B2, B7) on the device; held against
    the plain version (``ref.sharded_dequant_matmul_ref``) on the same
    inputs; the bound and the library call (a matmul a shard on the
    dequantized parts) beside them."""
    from repro_torch.core.plane_store import ShardedLeaf
    from repro_torch.kernels import ref
    from repro_torch.models.common import dense

    cfg, dev, n = run.cfg, run.dev, mesh.shape["model"]
    xg = torch.Generator(device=dev).manual_seed(11)
    named = [(nm, w) for nm, w in run.weights_of(P)
             if nm != "embed.T" and isinstance(w, ShardedLeaf)]
    xs = {}
    for _, w in named:
        K = w.shape[0]
        if K not in xs:
            xs[K] = torch.randn((BATCH, K), generator=xg, device=dev).to(cfg.dtype)
    calls = [(xs[w.shape[0]], w, w.gather()) for _, w in named]

    def b7():
        for x, w, _ in calls:
            dense(x, w, dtype=cfg.dtype, rows="decode")

    def b2():
        for x, _, whole in calls:
            dense(x, whole, dtype=cfg.dtype, rows="decode")

    t = {"b2": [], "b7": []}
    for _ in range(2):
        t["b2"].append(device_ms(b2, 3))
        t["b7"].append(device_ms(b7, 3))
    err, mag = 0.0, 0.0
    for x, w, _ in calls:
        y = dense(x, w, dtype=torch.float32, rows="decode")
        yr = ref.sharded_dequant_matmul_ref(x, [p.q for p in w.parts],
                                            [p.scale for p in w.parts],
                                            [p.offset for p in w.parts], bits=16)
        m = float(yr.abs().max())
        e = float((y - yr).abs().max())
        check(e <= DQMM_RTOL * m, (run.tag, "B7 against its plain version", e, m))
        err, mag = max(err, e), max(mag, m)
    bound, by = _dqmm_bound([(x, whole) for x, _, whole in calls])
    dense_sh = [[p.q.to(torch.float32) * p.scale.reshape(()) + p.offset.reshape(())
                 for p in w.parts] for _, w, _ in calls]
    xf = [x.float() for x, _, _ in calls]
    row = {"ms": min(t["b7"]), "b2_ms": min(t["b2"]),
           "plain_ms": device_ms(lambda: [ref.sharded_dequant_matmul_ref(
               x, [p.q for p in w.parts], [p.scale for p in w.parts],
               [p.offset for p in w.parts], bits=16) for x, w, _ in calls], 1),
           "library_ms": device_ms(lambda: [torch.cat([torch.matmul(x, d) for d in ds], dim=1)
                                            for x, ds in zip(xf, dense_sh)], 3),
           "host_ms": host_ms(b7, 3), "bound_ms": bound, "bound_by": by, "max_abs_err": err,
           "by_turn": t,
           "per": f"{cfg.name}'s decode step's {len(calls)} split weights at {n} logical "
                  f"shards, M = {BATCH}"}
    del dense_sh, xf
    log(f"{run.tag} [mesh] [time] B7 on a decode step's {len(calls)} split weights at {n} "
        f"shards (M = {BATCH}): B7 {', '.join(f'{v:.4f}' for v in t['b7'])} ms, single-device "
        f"B2 on the same weights {', '.join(f'{v:.4f}' for v in t['b2'])} ms, in turns on the "
        f"device; bound {bound:.4f} ms ({by}); plain {row['plain_ms']:.4f} ms, library "
        f"{row['library_ms']:.4f} ms; host issue {row['host_ms']:.3f} ms; against the plain "
        f"version max |err| {err:.3e} (largest max |y| {mag:.1f}, tolerance {DQMM_RTOL} of it)")
    return row


def _moe_mesh(run, prog, mesh, one) -> None:
    """The MoE arch's further checks on ``mesh``, over one sharded
    in-memory receiver at stage 8: every bank's leaves gathered equal to
    the single-device store ``one``'s (q and each expert's affine); a
    decode step under ``torch.cuda.set_sync_debug_mode("error")``;
    ``SpeculativeEngine`` at drop-free cf 4.0, counted from 0, its tokens
    ``torch.equal`` to the phase's plain greedy tokens; float residency,
    counted from 0, logits within ``FP_LOGIT_RTOL`` of the phase's
    single-device float run and tokens equal where the margin clears it."""
    from repro_torch.core.plane_store import ShardedLeaf
    from repro_torch.serving import ProgressiveServer, SpecConfig, SpeculativeEngine

    cfg, L, dev, n = run.cfg, run.cfg.n_layers, run.dev, mesh.shape["model"]
    tag = f"{run.tag} [mesh] n={n}"
    t0 = time.perf_counter()
    rec = _StoreReceiver(prog, dev, mesh)
    mine, want = rec.store.quantized_leaves(), one.store.quantized_leaves()
    banks = [k for k in mine if k[-1].startswith("we_")]
    check(len(banks) == 3 * L, banks)
    for key in banks:
        leaf = mine[key]
        check(isinstance(leaf, ShardedLeaf) and leaf.axis == -3 and len(leaf.parts) == n,
              (key, type(leaf)))
        whole, w = leaf.gather(), want[key]
        check(all(torch.equal(getattr(whole, f), getattr(w, f))
                  for f in ("q", "scale", "offset", "received_bits")),
              f"{tag}: the stage-8 bank {key} gathered differs from one device's")
        del whole
    t_banks = time.perf_counter() - t0

    t0 = time.perf_counter()
    srv = ProgressiveServer(run.model, prog, max_len=PROMPT + STEPS, resident="quantized",
                            receiver=rec, mesh=mesh, device=dev)
    srv.receive_stage()
    srv.start({"tokens": run.prompt})
    tok = torch.zeros((BATCH, 1), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = run.model.decode_step(srv.params, srv.caches, tok, PROMPT)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits")
    del srv, logits
    t_sync = time.perf_counter() - t0

    t0 = time.perf_counter()
    free, plain = run.spec_plain
    n_prompt = run.prompt.shape[1]
    eng = SpeculativeEngine(free, prog, max_len=n_prompt + SPEC_TOKENS + MOE_SPEC_K + 1,
                            spec=SpecConfig(draft_bits=4, k=MOE_SPEC_K, k_max=MOE_SPEC_K),
                            receiver=rec, mesh=mesh, device=dev)
    torch.cuda.synchronize()
    reset_counts(run.ops)
    eng.receive_stage()
    eng.start({"tokens": run.prompt})
    res = eng.decode(SPEC_TOKENS)
    got, by = _tally(run.counts, run.routes, f"{tag} spec")
    steps, verifies = _b2_steps(res.accept_rounds)
    check(torch.equal(res.tokens.cpu(), plain),
          f"{tag}: sharded speculative tokens at cf 4.0 differ from plain")
    check(got["flash_verify"] == L * verifies and verifies > 0 and got["plane_or_segments"] == 0
          and eng.resident_report()["extra_draft_bytes"] == 0, (got, verifies))
    del eng
    gc.collect()
    t_spec = time.perf_counter() - t0

    t0 = time.perf_counter()
    lm = LogitLog(run.model)
    fsrv = ProgressiveServer(lm, prog, max_len=n_prompt + ARCH_FP_STEPS, resident="fp",
                             receiver=rec, mesh=mesh, device=dev)
    torch.cuda.synchronize()
    reset_counts(run.ops)
    fsrv.receive_stage()
    fsrv.start({"tokens": run.prompt})
    fres = fsrv.decode(ARCH_FP_STEPS)
    fgot, fby = _tally(run.counts, run.routes, f"{tag} fp")
    frep = fsrv.resident_report()
    check(fby == {"gemv": 0, "mma": 0} and fgot["decode_attention"] == L * ARCH_FP_STEPS,
          (fgot, fby))
    fp_logits, fp_tokens = run.fp_ref
    worst, n_checked, near = _fp_against_quantized(lm.logits, fp_logits, fres.tokens, fp_tokens)
    del fsrv, lm, rec
    gc.collect()
    t_fp = time.perf_counter() - t0
    log(f"{tag}: the stage-8 banks ({len(banks)}) gathered equal (torch.equal: q, each "
        f"expert's scale, offset, received bits) to one device's, {t_banks:.1f} s; a sharded "
        f"decode step under set_sync_debug_mode('error'), {t_sync:.1f} s; SpeculativeEngine "
        f"at cf 4.0 (k = {MOE_SPEC_K}): {res.accepted}/{res.drafted} drafts accepted, tokens "
        f"equal (torch.equal) to plain, launches {got}, B2 by route {by}, {t_spec:.1f} s; "
        f"float residency ({ARCH_FP_STEPS} steps x {BATCH}): logits within {worst:.3e} of one "
        f"device's largest (tolerance {FP_LOGIT_RTOL}), {n_checked} tokens checked equal, "
        f"{near} near ties, {frep['gathered_bytes']} B gathered, launches {fgot}, "
        f"{t_fp:.1f} s")


class _StoreReceiver:
    """An in-memory receiver holding every stage of ``prog`` on ``dev`` (or
    on ``mesh``, whose home ``dev`` is), as a server's ``receiver=``:
    servers of both residencies over one set of accumulators."""

    def __init__(self, prog, dev, mesh=None):
        from repro_torch.core.progressive import ReceiverState

        state = ReceiverState.init(prog, mesh=mesh, device=dev)
        for s in range(1, prog.n_stages + 1):
            state = state.receive(prog.stage(s))
        self.state, self.store = state, state.store
        self.stages_complete = state.received_stages

    def materialize(self):
        return self.state.materialize()

    def materialize_resident(self, eligible=None, *, bits=None):
        return self.state.materialize_resident(eligible, bits=bits)


# ---------------------------------------------------------------------------
# [arch xlstm-125m], [arch zamba2-7b x13]: recurrent blocks (ROADMAP A8(d))
# ---------------------------------------------------------------------------

def _stack_kinds(cfg) -> list:
    """The block kind of every layer, in the order a forward pass runs them."""
    return list(cfg.cycle) * cfg.n_cycles + list(cfg.tail)


def recurrent_b2(cfg) -> tuple[int, int, int]:
    """A recurrent stack's B2 launches a token: the recurrent blocks'
    (``RECURRENT_B2``), the shared attention block's (7 a use); and the
    shared block's uses (a B3 launch each a decode step)."""
    kinds = _stack_kinds(cfg)
    uses = kinds.count("shared_attn")
    return sum(len(RECURRENT_B2.get(k, ())) for k in kinds), 7 * uses, uses


def recurrent_calls(cfg, passes: int, B: int, T: int, mode: str) -> list:
    """B2's launches in ``passes`` forward passes of a recurrent stack over
    (B, T) tokens, as :func:`expect_routes` reads them. A prefill runs
    each recurrent weight once at M = B*T (its recurrence is the token
    loop); a chunk tick steps the chunk through the recurrence, T launches
    of each at M = B; the shared block runs at M = B*T; the unembedding at
    M = B (a prefill's last position) or B*T. Decode runs every weight at
    M = B on the GEMV route."""
    rec, attn, _ = recurrent_b2(cfg)
    if mode == "decode":
        return [(passes * (rec + attn + 1), B, "decode")]
    rec_calls = (passes * rec * T, B) if mode == "prefill_chunk" else (passes * rec, B * T)
    return [rec_calls, (passes * attn, B * T), (passes, B if mode == "prefill" else B * T)]


def _recurrent_phase(cfg, dev, ops) -> dict:
    """``[arch xlstm-125m]``, ``[arch zamba2-7b x13]``: ROADMAP A8(d) at
    the published widths, seeded random weights. Each path counted from
    0: divide on the card (:func:`_arch_divide`); the single stream in
    quantized residency (:func:`_rec_single`: a decode step's launches by
    name and route, the prefill against the step recurrence, B2 on every
    weight shape, B3 at the shared block's heads), then wire-fed and in
    float residency (:func:`_arch_wire`); the pool, each request alone
    against it, masked states (:func:`_rec_pool`); speculation refused;
    the single stream on a serving mesh (:func:`_arch_mesh`, at
    ``MESH_ARCH_SHARDS``); ``_whole_path`` at 2 layers; the CLI at full
    depth queued beside phase 7. Logs each
    path's seconds and the phase's peak device memory. Returns the launch
    counts, B2's launches by route and the kernels' rows."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(cfg.name).n_layers
    rec, attn, uses = recurrent_b2(cfg)
    run = types.SimpleNamespace(
        tag=f"[arch {cfg.name}{'' if cfg.n_layers == full else f' x{cfg.n_layers}'}]",
        cfg=cfg, model=build_model(cfg), dev=dev, ops=ops, counts={}, routes={}, kern={},
        mesh_shards=MESH_ARCH_SHARDS.get(cfg.name, ()), attn_layers=uses,
        fp_dtype=torch.float32, weights_of=lambda P: _rec_weights(cfg, P),
        prompt=torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                             generator=torch.Generator().manual_seed(1)))
    blocks = {k: _stack_kinds(cfg).count(k) for k in dict.fromkeys(_stack_kinds(cfg))}
    mamba = (f"; Mamba-2: d_inner {ssm.mamba2_dims(cfg)[0]}, {ssm.mamba2_dims(cfg)[1]} heads of "
             f"{ssm.mamba2_dims(cfg)[2]}, state {cfg.ssm_state}, conv {cfg.conv_width}, SSD "
             f"chunk {cfg.ssm_chunk}" if "mamba2" in blocks else "")
    lstm = (f"; mLSTM d_inner {ssm.mlstm_dims(cfg)[0]} ({cfg.n_heads} heads of "
            f"{ssm.mlstm_dims(cfg)[2]}), sLSTM up {int(4 * cfg.d_model / 3)}"
            if "mlstm" in blocks else "")
    attn_desc = (f"; the shared block: {cfg.n_heads} heads on {cfg.n_kv} KV heads (G = "
                 f"{cfg.n_heads // cfg.n_kv}), hd {cfg.hd}, d_ff {cfg.d_ff}" if uses else "")
    log(f"{run.tag} {cfg.n_layers} of {full} layers, blocks {blocks}, d_model {cfg.d_model}"
        f"{mamba}{lstm}{attn_desc}; vocab {cfg.vocab}, tied; a decode step {rec} + {attn} + 1 B2 "
        f"and {uses} B3 launches by the code")
    seconds = {}

    def timed(name, fn):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    prog = timed("divide", lambda: _arch_divide(run))
    tokens = timed("stream", lambda: _rec_single(run, prog))
    timed("wire and fp", lambda: _arch_wire(run, prog, tokens))
    timed("pool", lambda: _rec_pool(run, prog))
    timed("refusals", lambda: _rec_refusals(run, prog))
    timed("mesh", lambda: _arch_mesh(run, prog, PROMPT + STEPS))
    del prog
    timed("path", lambda: _rec_path(run))
    if cfg.n_layers == full:
        BESIDE_PATH["olmo-1b"].append(lambda: _cli_phase(cfg.name, CLI_STREAM))
    log(f"{run.tag} launches on the paths {run.counts}, dequant_matmul by route {run.routes}; "
        f"seconds by path {seconds}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"counts": run.counts, "routes": run.routes, "kern": run.kern}


def _rec_weights(cfg, P) -> list:
    """A decode step's B2 weights, (name, view) in the order it runs them."""
    out = []
    for lr, kind in zip(_stack_layers(cfg, P["decoder"]), _stack_kinds(cfg)):
        if kind == "shared_attn":
            out += list(zip(("shared.wq", "shared.wk", "shared.wv", "shared.wo",
                             "shared.wi_gate", "shared.wi_up", "shared.mlp_wo"),
                            _layer_weights(lr)))
        else:
            out += [(f"{kind}.{k}", lr["mixer"][k]) for k in RECURRENT_B2[kind]]
    return out + [("embed.T", P["embed"].T)]


def _rec_single(run, prog) -> torch.Tensor:
    """The single stream (:func:`_arch_stream`: a decode step's B2 and B3
    launches by :func:`recurrent_b2`, by route by :func:`recurrent_calls`).
    Then, on its stage-8 views: the last logits of a prefill of PROMPT
    tokens against a prefill of one fewer and a decode step, within
    ``PATH_RTOL`` (the chunked SSD and the mLSTM/sLSTM scans against the
    step recurrence, bfloat16 at full width); a decode step's B2 launches
    timed and every distinct weight shape checked; B3 on the shared
    block's caches; a whole decode step's device time. Returns the
    tokens."""
    from repro_torch.kernels import dequant_matmul as dqm
    from repro_torch.models.transformer import layer

    cfg, dev = run.cfg, run.dev
    rec, attn, uses = recurrent_b2(cfg)
    srv, res = _arch_stream(run, prog, rec + attn + 1, uses,
                            recurrent_calls(cfg, 1, BATCH, PROMPT, "prefill")
                            + recurrent_calls(cfg, STEPS, BATCH, 1, "decode"),
                            "the norms and the recurrences' vectors and matrices")

    # the prefill against the step recurrence on the stage-8 views
    tokens = run.prompt.to(dev)
    want, _ = run.model.prefill(srv.params, {"tokens": tokens})
    _, caches = run.model.prefill(srv.params, {"tokens": tokens[:, :-1]})
    caches = run.model.grow_caches(caches, PROMPT)
    got_l, _ = run.model.decode_step(srv.params, caches, tokens[:, -1:], PROMPT - 1)
    err = float((got_l - want).abs().max()) / float(want.abs().max())
    check(bool(torch.isfinite(got_l).all()) and err <= PATH_RTOL,
          f"{run.tag} prefill against prefill + step: {err:.3e}")
    log(f"{run.tag} [check] the last logits of a prefill of {PROMPT} against a prefill of "
        f"{PROMPT - 1} and a decode step, stage 8: max |err| / max |logit| = {err:.3e} "
        f"(tolerance {PATH_RTOL})")
    del caches

    # a decode step's B2 launches timed, every distinct weight shape checked
    xg = torch.Generator(device=dev).manual_seed(2)
    named = _rec_weights(cfg, srv.params)
    check(len(named) == rec + attn + 1 and all(dqm.one_pass(w.q) for _, w in named),
          f"{run.tag} a weight is off the one-pass kernels")
    run.step_weights = [(nm, w.q.shape[1]) for nm, w in named]
    run.kern["dequant_matmul"] = _named_b2_row(run, srv.params, named, xg)
    if uses:
        slot = f"{cfg.cycle.index('shared_attn')}_shared_attn"
        stacked = srv.caches["cycles"][slot]
        run.kern["decode_attention"] = _decode_attention_row(
            run, [layer(stacked, r) for r in range(stacked["k"].shape[0])], xg)
    _step_time(run, srv, res, "the recurrences' plain torch, the norms, the embedding")
    return res.tokens.cpu()


def _rec_pool(run, prog) -> None:
    """The pool's 12 requests on 8 slots with chunked admission, counted
    from 0 (a chunk tick steps each recurrent block through the chunk's
    tokens, one B2 pass a token; :func:`recurrent_calls`), B4 on the
    shared block's pooled caches; masked states (:func:`_rec_masked`);
    then each request alone in a pool of the same size, stepped at the
    stages the busy pool served it at: tokens ``torch.equal``. With every
    shape the same, only the other slots' rows differ, and masking must
    leave a request's arithmetic as it was; an evicted slot's state must
    be zeroed for the next request."""
    from repro_torch.serving import PoolRequest, SlotPoolEngine

    cfg, dev = run.cfg, run.dev
    _, _, uses = recurrent_b2(cfg)
    stage_of_step: list = []

    def hook(pool):
        # the stage of each step and the requests in the pool at it
        step = pool.step

        def logged():
            stage_of_step.append((pool.stage, {s.rid for s in pool.slots if not s.free}))
            return step()
        pool.step = logged

    pool, got, by = _pool_phase(
        run.model, prog, dev, run.ops, f"{run.tag} pool", 4 * run.n_fp,
        b2_calls=lambda ticks, steps: (
            recurrent_calls(cfg, ticks, POOL_SLOTS, POOL_CHUNK, "prefill_chunk")
            + recurrent_calls(cfg, steps, POOL_SLOTS, 1, "decode")),
        attn_layers=uses, hook=hook)
    for acc, new in ((run.counts, got), (run.routes, by)):
        for k, v in new.items():
            acc[k] = acc.get(k, 0) + v
    if uses:
        run.kern["flash_verify"] = _arch_verify_check(
            run, pool, slot=f"{cfg.cycle.index('shared_attn')}_shared_attn")
    busy = {rid: list(t) for rid, t in pool.outputs.items()}
    _rec_masked(run, pool)
    del pool
    gc.collect()
    torch.cuda.empty_cache()

    _, budgets, prompts = _pool_requests(cfg)
    t0 = time.perf_counter()
    n_steps = 0
    for rid, prompt in enumerate(prompts):
        stages = [st for st, rids in stage_of_step if rid in rids]
        alone = SlotPoolEngine(run.model, prog, n_slots=POOL_SLOTS, max_len=POOL_MAX_LEN,
                               resident="quantized", dispatch_window=POOL_WINDOW,
                               prefill_chunk=POOL_CHUNK, device=dev)
        while alone.stage < stages[0]:
            alone.receive_stage()
        alone.submit(PoolRequest(rid=rid, prompt=prompt, max_new_tokens=int(budgets[rid])))
        for st in stages:
            while alone.stage < st:
                alone.receive_stage()
            alone.step()
        alone.flush()
        check(alone.outputs[rid] == busy[rid] and rid in alone.completed,
              f"{run.tag} request {rid} alone differs from the busy pool")
        n_steps += len(stages)
        del alone
        gc.collect()
    log(f"{run.tag} pool: each of the {len(prompts)} requests alone in a pool of {POOL_SLOTS} "
        f"slots, stepped at the busy pool's stages ({n_steps} steps): tokens equal (torch.equal) "
        f"to the busy pool's; {time.perf_counter() - t0:.1f} s")


def _rec_masked(run, pool) -> None:
    """On the drained pool: a request decoding in slot 0, one mid-way
    through its chunked prefill in slot 1, the rest free. A chunk tick
    (slot 1's next chunk) leaves every other slot's recurrent leaves
    ``torch.equal`` to before; a decode step (slot 0) leaves every other
    slot's so, slot 1's included."""
    from repro_torch.serving import PoolRequest

    _, _, prompts = _pool_requests(run.cfg)
    pool.submit(PoolRequest(rid=1000, prompt=prompts[0][:POOL_CHUNK], max_new_tokens=8))
    pool.step()                  # its one chunk, then its first decode step
    pool.submit(PoolRequest(rid=1001, prompt=prompts[1][:3 * POOL_CHUNK], max_new_tokens=8))
    pool.step()                  # slot 1's first chunk of three
    check(set(pool._prefill_state) == {1} and int(pool.pos[0]) > 0, pool._prefill_state)
    leaves = [(part, leaf) for part, key in pool._recurrent_keys
              for leaf in pool.caches[part][key].values()]

    def rows(part, leaf, s):
        return leaf[:, s] if part == "cycles" else leaf[s]

    def unchanged(fn, live: int, what: str) -> None:
        before = [leaf.clone() for _, leaf in leaves]
        fn()
        for (part, leaf), old in zip(leaves, before):
            for s in range(pool.n_slots):
                same = torch.equal(rows(part, leaf, s), rows(part, old, s))
                check(same != (s == live), f"{run.tag} {what}: slot {s}'s state "
                      f"{'changed' if not same else 'did not change'}")

    unchanged(pool._prefill_tick, 1, "chunk tick")
    nxt = torch.argmax(pool.last_logits, dim=-1).to(torch.int32)[:, None]
    unchanged(lambda: pool.model.decode_step(pool.params, pool.caches, nxt, pool.pos), 0,
              "decode step")
    log(f"{run.tag} [check] masked states: a chunk tick (slot 1 mid-prefill; slot 0 decoding "
        f"and {pool.n_slots - 2} free slots masked) and a decode step (slot 0; slot 1 mid-prefill "
        f"and the free slots masked): every masked slot's {len(leaves)} recurrent leaves equal "
        f"(torch.equal) to before, the live slot's changed")


def _rec_refusals(run, prog) -> None:
    """``SpeculativeEngine`` raises for a recurrent arch (a serving mesh
    serves it: ``[mesh]``)."""
    from repro_torch.serving import SpecConfig, SpeculativeEngine

    _refused(run.tag, "rollback", lambda: SpeculativeEngine(
        run.model, prog, max_len=PROMPT + SPEC_TOKENS + 9, spec=SpecConfig(draft_bits=4, k=4),
        device=run.dev))
    log(f"{run.tag} refusals: SpeculativeEngine (no overwrite-only rollback of a recurrent "
        f"state) raises NotImplementedError")


def _rec_path(run) -> None:
    """``_whole_path`` at 2 layers of the arch at full width: xlstm-125m's
    sLSTM and mLSTM, zamba2-7b's two mamba2 blocks as a tail (no full
    cycle); a prefill chunk, no verify."""
    t0 = time.perf_counter()
    two = dataclasses.replace(run.cfg, n_layers=2)
    blocks = _stack_kinds(two)
    path_err, chunk_err = _whole_path(run.cfg, run.dev, stages=(1, 8), cpu_divides=False)
    log(f"{run.tag} [path] 2 layers at full width ({blocks}), cuda kernels vs cpu plain "
        f"versions, each side ingesting its own "
        f"copy of the card's planes, fingerprints equal at stages 1 and 8: teacher-forced logits "
        f"max |err| / max |logit| = {path_err:.3e}; prefill chunk logits {chunk_err:.3e} "
        f"(tolerance {PATH_RTOL}); {time.perf_counter() - t0:.1f} s")


def _gemma_phase(dev, ops) -> dict:
    """``[arch gemma3-27b x6]``: ROADMAP A8(b) at gemma3-27b's published
    widths, one 5:1 cycle of its 62 layers, seeded random weights. Each
    path counted from 0: divide on the card and the stage-8 accumulators
    against ``quantize(leaf).q`` (:func:`_arch_divide`); the single stream
    over wrapping rings (:func:`_gemma_single`); the pool's chunked
    admission over rings; ``SpeculativeEngine`` from a prompt of 1030, past
    the window (:func:`_arch_spec`, rings grown by k_max + 1 = 5), then B3
    and B4 on its rings (:func:`_ring_attention`); float residency from a
    prompt of 1016, across the window (:func:`_arch_fp`). Returns the
    launch counts, B2's launches by route and the kernels' rows."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    name, n_layers = GEMMA
    cfg = dataclasses.replace(get_config(name), n_layers=n_layers)
    run = types.SimpleNamespace(
        tag=f"[arch {name} x{n_layers}]", cfg=cfg, model=build_model(cfg), dev=dev, ops=ops,
        counts={}, routes={}, kern={}, mesh_shards=MESH_ARCH_SHARDS[name],
        prompt=torch.randint(0, cfg.vocab, (BATCH, GEMMA_PROMPT),
                             generator=torch.Generator().manual_seed(1)))
    log(f"{run.tag} {cfg.n_layers} of {get_config(name).n_layers} layers (one cycle "
        f"{'/'.join(cfg.cycle)}), window {cfg.window}, qk_norm {cfg.qk_norm}, logit softcap "
        f"{cfg.logit_softcap}, rope base {cfg.rope_theta:g} (global layers x100); no wire, CLI "
        f"or [path] here: byte paths no window changes, and the CPU tests hold the windowed "
        f"numerics against the JAX package")
    prog = _arch_divide(run)
    spec_prompt, fp_prompt = (
        torch.randint(0, cfg.vocab, (BATCH, n), generator=torch.Generator().manual_seed(seed))
        for n, seed in ((GEMMA_SPEC_PROMPT, 5), (GEMMA_FP_PROMPT, 6)))
    for path in (lambda: _gemma_single(run, prog), lambda: _gemma_pool(run, prog),
                 lambda: _ring_attention(run, _arch_spec(run, prog, spec_prompt, GEMMA_SPEC_K),
                                         GEMMA_SPEC_K + 1),
                 lambda: _arch_fp(run, prog, _StoreReceiver(prog, dev), fp_prompt,
                                  "in-memory store"),
                 lambda: _arch_mesh(run, prog, GEMMA_PROMPT + STEPS)):
        gc.collect()
        torch.cuda.empty_cache()
        path()
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{run.tag} launches on the paths {run.counts}, dequant_matmul by route {run.routes}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"counts": run.counts, "routes": run.routes, "kern": run.kern}


def _gemma_single(run, prog) -> None:
    """The single stream (batch 4, prompt 1000, 48 steps, a stage every 6)
    from in-memory planes, quantized, counted from 0: positions 1000-1047
    cross the window, so every ring wraps. Then a decode step's B2 timed
    and checked (:func:`_decode_b2_row`), every weight on the one-pass
    kernels; and the same stream teacher-forced (its tokens fed, the same
    upgrades) over rings grown to ``max_len`` slots, where slot =
    position: the logits within ``RING_RTOL`` of the largest and the
    greedy tokens equal at every step."""
    from repro_torch.kernels import dequant_matmul as dqm
    from repro_torch.serving import ProgressiveServer

    cfg, L, dev, model = run.cfg, run.cfg.n_layers, run.dev, run.model
    max_len = GEMMA_PROMPT + STEPS
    lm = LogitLog(model)
    checked = FiniteLogits(lm)
    srv = ProgressiveServer(checked, prog, max_len=max_len, resident="quantized", device=dev)
    torch.cuda.synchronize()
    reset_counts(run.ops)
    t0 = time.perf_counter()
    srv.receive_stage()
    srv.start({"tokens": run.prompt})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = counts()
    res = srv.decode(STEPS, stage_arrival=lambda i: i in ARRIVALS)
    got, by = _tally(run.counts, run.routes, f"{run.tag} serve")
    per_step = {k: (got[k] - after_prefill[k]) / STEPS for k in got}
    rep = srv.resident_report()
    decode_s = sum(s for _, s in res.window_s)
    rings = {slot: c["k"].shape[-2] for slot, c in srv.caches["cycles"].items()}
    check(rings == {**{f"{j}_swa": cfg.window for j in range(5)}, "5_global": max_len}, rings)
    check(GEMMA_PROMPT < cfg.window < GEMMA_PROMPT + STEPS, "the stream does not cross the window")
    check(srv.stage == 8 and [s for _, s in res.upgrades] == list(range(2, 9)), res.upgrades)
    check(bool(torch.stack(checked.flags).all()) and bool(torch.isfinite(srv.last_logits).all()),
          f"{run.tag} non-finite logits")
    check(res.tokens.shape == (BATCH, STEPS) and int(res.tokens.max()) < cfg.vocab)
    check(rep["quantized_bytes"] == 2 * (run.n_params - run.n_fp)
          and rep["fp_bytes"] == 4 * run.n_fp and rep["fp_leaves"] > 0, rep)
    check(per_step["dequant_matmul"] == L * 7 + 1 and per_step["decode_attention"] == L, per_step)
    check(got["plane_or_segments"] == 8 and got["flash_verify"] == 0, got)
    check(by == expect_routes([(L * 7, BATCH * GEMMA_PROMPT), (1, BATCH)]
                              + pass_calls(L, STEPS, BATCH)), by)
    log(f"{run.tag} single stream (in-memory planes, quantized), prompt {GEMMA_PROMPT}, "
        f"positions {GEMMA_PROMPT}-{max_len - 1} across the window: stages "
        f"{res.stage_at_step[0]}->{res.stage_at_step[-1]}, upgrades {res.upgrades}; rings "
        f"{rings}; resident {rep['quantized_bytes']} B quantized + {rep['fp_bytes']} B in "
        f"{rep['fp_leaves']} float leaves (norms, q_norm, k_norm)")
    log(f"{run.tag} receive_stage + prefill {t_prefill * 1e3:.1f} ms; decode {STEPS} steps x "
        f"{BATCH} with 7 upgrades: {decode_s:.3f} s, {BATCH * STEPS / decode_s:.1f} tokens/s, "
        f"{decode_s / STEPS * 1e3:.2f} ms/step; per step dequant_matmul "
        f"{per_step['dequant_matmul']:.0f}, decode_attention {per_step['decode_attention']:.0f}; "
        f"launches {got}; dequant_matmul by route {by}, GEMV route by kernel "
        f"{dict(dqm.launches_by_gemv_kernel)}")

    xg = torch.Generator(device=dev).manual_seed(2)
    P = srv.params
    unembed = P["embed"].T
    check(all(dqm.one_pass(w.q) for w in _layer_weights(_stack_layers(cfg, P["decoder"])[0])
              + [unembed]), f"{run.tag} a weight shape is off the one-pass kernels")
    run.kern["dequant_matmul"] = _decode_b2_row(run, P, xg)
    logits, tokens = lm.logits, res.tokens
    run.stream = (logits, tokens.cpu())
    del srv, P, unembed, lm, checked
    gc.collect()
    torch.cuda.empty_cache()

    # the same stream over rings that never wrap, teacher-forced
    flat = ProgressiveServer(model, prog, max_len=max_len, resident="quantized", device=dev)
    flat.receive_stage()
    flat.start({"tokens": run.prompt})
    caches = model.grow_caches(flat.caches, max_len, ring_margin=max_len - cfg.window,
                               pos=GEMMA_PROMPT)
    check(caches["cycles"]["0_swa"]["k"].shape[-2] == max_len)
    pairs = [(flat.last_logits, logits[0])]
    for i in range(STEPS):
        if i in ARRIVALS:
            flat.receive_stage()
        lg, caches = model.decode_step(flat.params, caches, tokens[:, i:i + 1],
                                       GEMMA_PROMPT + i)
        pairs.append((lg, logits[i + 1]))
    errs = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in pairs]
    same = sum(int((a.argmax(-1) == b.argmax(-1)).sum()) for a, b in pairs)
    check(max(errs) <= RING_RTOL, (run.tag, "wrapped against unwrapped rings", max(errs)))
    check(same == len(pairs) * BATCH, (run.tag, "greedy tokens over unwrapped rings", same))
    log(f"{run.tag} the stream over rings of {cfg.window} slots (wrapped) against rings of "
        f"{max_len} slots (slot = position), the same tokens fed and upgrades at the same "
        f"steps: max |err| / max |logit| {max(errs):.3e} over the prefill and {STEPS} steps "
        f"(tolerance {RING_RTOL}); greedy tokens equal at {same} of {len(pairs) * BATCH}")


def _gemma_pool(run, prog) -> None:
    """The pool with chunked admission over rings (margin 8, the chunk),
    counted from 0: 6 requests on 4 slots, prompts 990-1040, budgets 24-39,
    an upgrade a window; prompts and decodes cross the window."""
    cfg = run.cfg
    rng = np.random.default_rng(3)
    lengths = rng.integers(*GEMMA_POOL_PROMPTS, GEMMA_POOL_REQUESTS)
    budgets = rng.integers(*GEMMA_POOL_BUDGETS, GEMMA_POOL_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lengths]
    pool, got, by = _pool_phase(run.model, prog, run.dev, run.ops, f"{run.tag} pool",
                                4 * run.n_fp, slots=GEMMA_POOL_SLOTS,
                                max_len=GEMMA_POOL_MAX_LEN, requests=(lengths, budgets, prompts))
    ring = pool.caches["cycles"]["0_swa"]["k"].shape[-2]
    check(ring == cfg.window + POOL_CHUNK and pool._ring_margin == POOL_CHUNK, ring)
    check(int(lengths.max()) + int(budgets.max()) > cfg.window > int(lengths.min()))
    for acc, new in ((run.counts, got), (run.routes, by)):
        for k, v in new.items():
            acc[k] = acc.get(k, 0) + v
    log(f"{run.tag} pool: rings of {ring} slots (window {cfg.window} + chunk {POOL_CHUNK})")


def _ring_attention(run, caches, T: int) -> None:
    """B3 and B4 on the speculative engine's caches at the arch's heads
    (gemma3-27b's G = 2, mixtral-8x22b's G = 6), each slot's k_pos from
    ``ring_positions`` at a head of its own: wrapped three times, twice,
    once, and a free slot. ``T`` is the engine's verify block (k + 1), by
    which its rings outgrow the window. On layer 0's ring (window + T
    slots): decode at the head and a verify block of its last T positions
    within ``ATTN_RTOL`` of the plain versions, every verify row
    ``torch.equal`` to a decode launch at its position (over the block's
    k_pos and over a decode step's own). Then a decode step's launches
    (one a layer: a ring, or a global layer at S = max_len at its last
    position; gemma3-27b's cycle gives 6, mixtral-8x22b's 1) and a verify
    pass's timed beside the plain versions and
    ``scaled_dot_product_attention`` with the additive window mask."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    from repro_torch.kernels import verify_attention as va
    from repro_torch.models.attention import ring_positions
    from repro_torch.models.transformer import attn_window

    cfg, L, dev = run.cfg, run.cfg.n_layers, run.dev
    g = torch.Generator(device=dev).manual_seed(11)
    layers = _stack_layers(cfg, caches)
    windows = [attn_window(cfg, k) for k in cfg.cycle]

    def operands(c, window):
        S = c["k"].shape[2]
        if window:
            heads = torch.tensor([3 * S + 7, 2 * S + 1, S + 300, -1], dtype=torch.int32,
                                 device=dev)
            k_pos = ring_positions(S, heads)
        else:
            heads = torch.full((BATCH,), S - 1, dtype=torch.int32, device=dev)
            k_pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(BATCH, 1)
        q_pos = torch.where(heads[:, None] >= 0, heads[:, None] - (T - 1)
                            + torch.arange(T, dtype=torch.int32, device=dev), -1)
        return heads, k_pos, q_pos

    q = torch.randn((BATCH, T, cfg.n_heads, cfg.hd), generator=g, device=dev).to(cfg.dtype)
    q1 = q[:, -1].contiguous()
    c0, w0 = layers[0], windows[0]
    heads, k_pos, q_pos = operands(c0, w0)
    S0 = c0["k"].shape[2]
    check(w0 == cfg.window and S0 == cfg.window + T and int(k_pos[1].min()) > S0, (w0, S0))
    dec = da.flash_decode(q1, c0["k"], c0["v"], k_pos, heads, window=w0)
    want = ref.flash_decode_ref(q1, c0["k"], c0["v"], k_pos, heads, window=w0)
    err_d = float((dec.float() - want).abs().max())
    check(bool(torch.isfinite(dec).all()) and err_d <= ATTN_RTOL * float(want.abs().max()),
          (run.tag, "decode_attention on a ring", err_d))
    out = va.flash_verify(q, c0["k"], c0["v"], k_pos, q_pos, window=w0)
    want = ref.flash_verify_ref(q, c0["k"], c0["v"], k_pos, q_pos, window=w0)
    err_v = float((out.float() - want).abs().max())
    check(bool(torch.isfinite(out).all()) and err_v <= ATTN_RTOL * float(want.abs().max()),
          (run.tag, "flash_verify on a ring", err_v))
    for t in range(T):
        qt, pt = q[:, t].contiguous(), q_pos[:, t].contiguous()
        for kp in (k_pos, ring_positions(S0, pt)):
            row = da.flash_decode(qt, c0["k"], c0["v"], kp, pt, window=w0)
            check(torch.equal(out[:, t], row), f"{run.tag} flash_verify row {t} on a ring differs")

    ops_d = [(c, w) + operands(c, w) for c, w in zip(layers, windows)]

    def visible(k_pos, q_pos, w):          # (B, T, S) bool, q_pos (B, T)
        ok = (k_pos[:, None, :] >= 0) & (k_pos[:, None, :] <= q_pos[:, :, None])
        if w:
            ok = ok & (k_pos[:, None, :] > q_pos[:, :, None] - w)
        return ok

    seen_d = [visible(kp, h[:, None], w) for c, w, h, kp, _ in ops_d]
    seen_v = [visible(kp, qp, w) for c, w, _, kp, qp in ops_d]
    masks_d, masks_v = ([torch.where(v, 0.0, -1e30).to(cfg.dtype)[:, None] for v in seen]
                        for seen in (seen_d, seen_v))
    kv_key = 2 * cfg.n_kv * cfg.hd * layers[0]["k"].element_size()
    q_row = cfg.n_heads * cfg.hd * q.element_size()

    def n_bytes(seen, T_):
        # the keys some row of a slot sees (none for a free slot, only the
        # window's on a ring), a live slot's k_pos, queries and q_pos, and
        # every slot's output
        total = 0
        for v, (_, _, _, kp, _) in zip(seen, ops_d):
            live = int(v.any(dim=(1, 2)).sum())
            total += (int(v.any(dim=1).sum()) * kv_key + live * (kp.shape[1] * 4 + T_ * (q_row + 4))
                      + BATCH * T_ * q_row)
        return total

    def n_ops(seen):
        return sum(4 * cfg.n_heads * cfg.hd * int(v.sum()) for v in seen)

    row_d = _attention_times(
        lambda: [da.flash_decode(q1, c["k"], c["v"], kp, h, window=w) for c, w, h, kp, _ in ops_d],
        lambda: [ref.flash_decode_ref(q1, c["k"], c["v"], kp, h, window=w)
                 for c, w, h, kp, _ in ops_d],
        lambda: [_sdpa(q1[:, None], c, m) for (c, *_), m in zip(ops_d, masks_d)])
    b_d, by_d = bound_ms(n_bytes(seen_d, 1), n_ops(seen_d), attn_flops(layers[0]["k"].dtype))
    row_v = _attention_times(
        lambda: [va.flash_verify(q, c["k"], c["v"], kp, qp, window=w) for c, w, _, kp, qp in ops_d],
        lambda: [ref.flash_verify_ref(q, c["k"], c["v"], kp, qp, window=w)
                 for c, w, _, kp, qp in ops_d],
        lambda: [_sdpa(q, c, m) for (c, *_), m in zip(ops_d, masks_v)])
    b_v, by_v = bound_ms(n_bytes(seen_v, T), n_ops(seen_v), attn_flops(layers[0]["k"].dtype))
    S_g = layers[-1]["k"].shape[2]
    n_ring = sum(1 for _, w, *_ in ops_d if w)
    per = (f"{L} launches: {n_ring} on rings of {S0} slots, window {cfg.window}"
           + (f"; {L - n_ring} global, S = {S_g}" if L > n_ring else ""))
    run.kern["decode_attention"] = {**row_d, "bound_ms": b_d, "bound_by": by_d,
                                    "max_abs_err": err_d, "per": f"one decode step ({per})"}
    run.kern["flash_verify"] = {**row_v, "bound_ms": b_v, "bound_by": by_v, "max_abs_err": err_v,
                                "per": f"one verify pass at T = {T} ({per})"}
    log(f"{run.tag} [check] decode_attention and flash_verify (T = {T}) B={BATCH} "
        f"H={cfg.n_heads} Kh={cfg.n_kv} hd={cfg.hd} on a ring of {S0} slots, window "
        f"{cfg.window}, slots' heads {heads.tolist()} (wrapped 3, 2 and 1 times, a free slot): "
        f"max |err| {err_d:.3e} and {err_v:.3e} (tolerance {ATTN_RTOL} of max |out|); every "
        f"verify row equal (torch.equal) to a decode launch at its position, over the block's "
        f"k_pos and over its own")
    for name, row, b, bb in (("decode_attention", row_d, b_d, by_d),
                             ("flash_verify", row_v, b_v, by_v)):
        log(f"{run.tag} [time] {name} per {run.kern[name]['per']}: {row['ms']:.4f} ms on the "
            f"device, bound {b:.4f} ms ({bb}), plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms']:.4f} ms (scaled_dot_product_attention, GQA, additive window "
            f"mask), host issue {row['host_ms']:.4f} ms")


class MoeAux:
    """Wraps a Model: keeps, on the device and without a host sync, the
    MoE auxiliaries (``balance_loss``, ``dropped_frac``, summed over
    layers) of every forward pass, by mode."""

    def __init__(self, model):
        self.model = model
        self.aux: dict[str, list] = {m: [] for m in ("prefill", "decode", "prefill_chunk",
                                                     "verify")}

    def __getattr__(self, name):
        return getattr(self.model, name)

    def _run(self, mode, fn, device, *args, **kw):
        from repro_torch.models.transformer import zero_aux

        aux = zero_aux(device)
        out = fn(*args, aux=aux, **kw)
        self.aux[mode].append(aux["dropped_frac"])
        return out

    def prefill(self, params, batch, *args, **kw):
        return self._run("prefill", self.model.prefill, batch["tokens"].device, params, batch,
                         *args, **kw)

    def decode_step(self, params, caches, tokens, pos):
        return self._run("decode", self.model.decode_step, tokens.device, params, caches,
                         tokens, pos)

    def prefill_chunk(self, params, caches, tokens, tok_pos):
        return self._run("prefill_chunk", self.model.prefill_chunk, tokens.device, params,
                         caches, tokens, tok_pos)

    def verify_step(self, params, caches, tokens, pos):
        return self._run("verify", self.model.verify_step, tokens.device, params, caches,
                         tokens, pos)

    def dropped(self) -> dict:
        """Mean share of routed (token, k) pairs dropped, by mode (one read
        of the device)."""
        return {m: round(float(torch.stack(v).mean()), 6) for m, v in self.aux.items() if v}


def moe_calls(cfg, passes: int, B: int, T: int, mode: str) -> list:
    """B2's launches in ``passes`` forward passes of a MoE stack over (B, T)
    tokens, as :func:`expect_routes` reads them: the attention's four
    weights and the router at M = B*T, each expert's three slots at M =
    B*C (C its capacity at T), the unembedding at M = B*T (B for a
    prefill, which unembeds the last position). Decode and verify force
    the GEMV route."""
    from repro_torch.models.moe import capacity

    rows = "decode" if mode in ("decode", "verify") else "any"
    L = cfg.n_layers
    return [(passes * L * 5, B * T, rows),
            (passes * L * 3 * cfg.n_experts, B * capacity(cfg, T), rows),
            (passes, B if mode == "prefill" else B * T, rows)]


def _moe_phase(dev, ops) -> dict:
    """``[arch mixtral-8x22b x1]``: ROADMAP A8(c) at mixtral-8x22b's
    published widths, 1 of its 56 layers, seeded random weights with a
    skewed router. Each path counted from 0: divide under the expert policy
    (:func:`_moe_divide`); the single stream at the published capacity
    (:func:`_moe_single`); the pool's chunked admission; speculation at
    cf = 4.0 and 1.25 (:func:`_moe_spec`), then B3 and B4 on its rings
    (:func:`_ring_attention`); float residency against quantized
    (:func:`_arch_fp`). Returns the launch counts, B2's launches by route
    and the kernels' rows."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    name, n_layers = MOE
    cfg = dataclasses.replace(get_config(name), n_layers=n_layers)
    run = types.SimpleNamespace(
        tag=f"[arch {name} x{n_layers}]", cfg=cfg, model=build_model(cfg), dev=dev, ops=ops,
        counts={}, routes={}, kern={}, mesh_shards=MESH_ARCH_SHARDS[name],
        prompt=torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                             generator=torch.Generator().manual_seed(1)))
    log(f"{run.tag} {cfg.n_layers} of {get_config(name).n_layers} layers ({cfg.cycle[0]}), "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv} KV heads (G = "
        f"{cfg.n_heads // cfg.n_kv}), hd {cfg.hd}, {cfg.n_experts} experts of d_ff {cfg.d_ff}, "
        f"top-{cfg.top_k}, capacity factor {cfg.capacity_factor}, window {cfg.window}, vocab "
        f"{cfg.vocab}, untied lm_head; no wire, CLI or [path] here: byte paths, which the CPU "
        f"tests hold for a sliced division against the JAX package")
    prog = _moe_divide(run)
    for path in (lambda: _moe_single(run, prog), lambda: _moe_pool(run, prog),
                 lambda: _ring_attention(run, _moe_spec(run, prog), MOE_SPEC_K + 1),
                 lambda: _arch_fp(run, prog, _StoreReceiver(prog, dev), run.prompt,
                                  "in-memory store"),
                 lambda: _arch_mesh(run, prog, PROMPT + STEPS, MoeAux(run.model))):
        gc.collect()
        torch.cuda.empty_cache()
        path()
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{run.tag} launches on the paths {run.counts}, dequant_matmul by route {run.routes}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"counts": run.counts, "routes": run.routes, "kern": run.kern}


def _moe_divide(run):
    """Seeded weights, the router's columns scaled by a seeded permutation
    of ``MOE_SKEW``; the experts' popularity from a calibration batch
    (top-k of the first layer's router over the embedded tokens, as
    ``examples/expert_priority_moe.py`` measures it); divided on the card
    under ``ExpertPopularityPolicy`` (B6, 8 launches a slice), the planes
    of the largest slice and of ``lm_head`` against the plain version;
    stage 1's sliced planes in order of popularity; 8 distinct scales a
    bank; then an in-memory receiver through all 8 stages, its stage-8
    accumulators against ``quantize(slice).q`` of every slice, bit for
    bit, and the live banks one strided view of the flat buffer each.
    Sets the counts of weights and returns the divided model."""
    from repro_torch.core.policy import ExpertPopularityPolicy
    from repro_torch.core.progressive import ReceiverState, divide, tree_flatten_with_path
    from repro_torch.core.quantize import dequant_affine, quantize
    from repro_torch.kernels import ref
    from repro_torch.models.common import quantized_resident_eligible

    cfg, E, dev = run.cfg, run.cfg.n_experts, run.dev
    params = run.model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    moe_p = params["decoder"]["cycles"][f"0_{cfg.cycle[0]}"]["moe"]
    perm = torch.randperm(E, generator=torch.Generator().manual_seed(4))
    moe_p["router"].mul_(torch.tensor(MOE_SKEW)[perm].to(dev))
    cal = torch.randint(0, cfg.vocab, MOE_CAL, generator=torch.Generator().manual_seed(7))
    x = run.model._embed(params, cal.to(dev)).float()
    top = torch.topk(torch.softmax(x @ moe_p["router"][0], -1), cfg.top_k).indices
    hits = torch.bincount(top.flatten(), minlength=E).cpu()
    pop = {e: float(hits[e]) / float(hits.sum()) for e in range(E)}
    leaves = dict(tree_flatten_with_path(params))
    run.n_params = sum(t.numel() for t in leaves.values())
    run.n_fp = sum(t.numel() for k, t in leaves.items() if not quantized_resident_eligible(k))
    torch.cuda.synchronize()
    reset_counts(run.ops)
    t0 = time.perf_counter()
    prog = divide(params, ExpertPopularityPolicy(popularity=pop, n_experts=E))
    torch.cuda.synchronize()
    t_divide = time.perf_counter() - t0
    got, _ = _tally(run.counts, run.routes, f"{run.tag} divide")
    n_t = len(prog.tensors)
    sliced = [t for t in prog.tensors if t.slice_axis is not None]
    check(len(sliced) == 3 * E * cfg.n_layers and all(t.slice_axis == 1 for t in sliced),
          [(t.path, t.slice_axis) for t in sliced])
    check(got["plane_extract"] == 8 * n_t and sum(got.values()) == 8 * n_t, got)

    def sub(t):
        leaf = leaves[t.path]
        return leaf if t.slice_axis is None else leaf.select(t.slice_axis, t.slice_idx)

    for big in (max(prog.tensors, key=lambda t: math.prod(t.shape)),
                max(sliced, key=lambda t: math.prod(t.shape))):
        q = quantize(sub(big), 16).q
        before = 0
        for w, plane in zip(big.plan.schedule.widths, big.planes):
            check(torch.equal(plane, ref.plane_extract_ref(q, 16, before, w, torch.uint8)),
                  f"{run.tag} plane at {before} of {big.path} slice {big.slice_idx}")
            before += w
        del q
    stage1 = [prog.tensors[i] for i, _ in prog.stage(1)]
    order = [pop[t.slice_idx] for t in stage1 if t.slice_axis is not None]
    check(order == sorted(order, reverse=True) and len(set(order)) > 1, order)
    check(all(t.slice_axis is None for t in stage1[:n_t - len(sliced)]), "a slice before a core "
          "tensor in stage 1")
    scales = {}
    for t in sliced:
        scales.setdefault(t.path[-1], set()).add(float(dequant_affine(t.lo, t.hi, 16)[0]))
    check(all(len(v) == E for v in scales.values()), scales)
    log(f"{run.tag} {run.n_params} parameters ({run.n_fp} in float norm leaves); router "
        f"popularity on {MOE_CAL[0]}x{MOE_CAL[1]} calibration tokens "
        f"{ {e: round(p, 3) for e, p in pop.items()} }; divide under ExpertPopularityPolicy on "
        f"the card {t_divide:.2f} s: {n_t} tensors ({len(sliced)} expert slices), launches "
        f"{got}; the planes of the largest tensor and slice equal the plain version; stage 1 "
        f"ships the core tensors, then the slices by popularity; {E} distinct scales a bank")

    t0 = time.perf_counter()
    want = [quantize(sub(t), 16).q.cpu() for t in prog.tensors]
    del params, leaves, moe_p, x
    torch.cuda.empty_cache()
    state = ReceiverState.init(prog, device=dev)
    for s in range(1, prog.n_stages + 1):
        state = state.receive(prog.stage(s))
    store = state.store
    for i, t in enumerate(prog.tensors):
        check(torch.equal(store._slice_acc(i), want[i].reshape(t.shape).to(dev)),
              f"{run.tag} stage-8 accumulator of {t.path} slice {t.slice_idx} differs from "
              f"quantize(slice).q")
    del want
    leaves = state.materialize_resident()
    moe_q = leaves["decoder"]["cycles"][f"0_{cfg.cycle[0]}"]["moe"]
    buf = store.buffers["uint16"]
    for nm in ("we_gate", "we_up", "we_down"):
        bank = moe_q[nm]
        idxs = store.groups[("decoder", "cycles", f"0_{cfg.cycle[0]}", "moe", nm)]
        check(bank.q.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
              and all(bank.q[0, e].data_ptr() == store.acc(i).data_ptr()
                      for e, i in enumerate(idxs)), f"{run.tag} {nm} is not a view of the store")
        check(len(set(bank.scale.flatten().tolist())) == E, bank.scale.flatten())
    log(f"{run.tag} stage-8 accumulators of an in-memory receiver equal quantize(slice).q of "
        f"all {n_t} tensors and slices, bit for bit; each live bank one strided view of the "
        f"store's uint16 buffer (expert e's (d, f) slot its slice's accumulator), "
        f"{E} scales a bank; {time.perf_counter() - t0:.1f} s")
    del state, store, leaves, moe_q, bank, buf
    return prog


def _moe_weights(cfg, P, dev) -> tuple[list, list]:
    """Layer 0's B2 operands in the order a decode step runs them: the
    attention's four weights, the router, each expert's gate, up and down
    slot (views of its bank), then the unembedding, as (name, view)
    pairs; and the experts' names."""
    lr = _stack_layers(cfg, P["decoder"])[0]
    a, m = lr["attn"], lr["moe"]
    out = [(f"attn.{k}", a[k]) for k in ("wq", "wk", "wv", "wo")] + [("moe.router", m["router"])]
    experts = []
    for e in range(cfg.n_experts):
        for k in ("we_gate", "we_up", "we_down"):
            w = m[k]
            experts.append(f"moe.{k}[{e}]")
            out.append((experts[-1], types.SimpleNamespace(q=w.q[e], scale=w.scale[e],
                                                           offset=w.offset[e])))
    return out + [("lm_head", P["lm_head"])], experts


def _moe_single(run, prog) -> None:
    """The single stream (batch 4, prompt 64, 48 steps, a stage every 6)
    from in-memory planes at the published capacity factor, quantized,
    counted from 0: 30 B2 launches a decode step (4 attention weights,
    the router at N = 8, 8 x 3 expert slots at M = 8 rows each, lm_head)
    and 1 B3, every B2 launch on the one-pass GEMV kernels; the share of
    routed pairs dropped by mode. Then a decode step's B2 timed and every
    weight shape checked with a per-expert mask (:func:`_decode_b2_row`,
    :func:`_dqmm_check`), and B3 on layer 0's cache against its plain
    version."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dequant_matmul as dqm
    from repro_torch.kernels import ref
    from repro_torch.models.moe import capacity
    from repro_torch.serving import ProgressiveServer

    cfg, L, dev = run.cfg, run.cfg.n_layers, run.dev
    aux = MoeAux(run.model)
    lm = LogitLog(aux)
    checked = FiniteLogits(lm)
    srv = ProgressiveServer(checked, prog, max_len=PROMPT + STEPS, resident="quantized",
                            device=dev)
    torch.cuda.synchronize()
    reset_counts(run.ops)
    t0 = time.perf_counter()
    srv.receive_stage()
    srv.start({"tokens": run.prompt})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = counts()
    res = srv.decode(STEPS, stage_arrival=lambda i: i in ARRIVALS)
    got, by = _tally(run.counts, run.routes, f"{run.tag} serve")
    per_step = {k: (got[k] - after_prefill[k]) / STEPS for k in got}
    rep = srv.resident_report()
    decode_s = sum(s for _, s in res.window_s)
    per_b2 = L * (5 + 3 * cfg.n_experts) + 1
    dropped = aux.dropped()
    check(per_b2 == 30 and per_step["dequant_matmul"] == per_b2
          and per_step["decode_attention"] == L, per_step)
    check(srv.stage == 8 and [s for _, s in res.upgrades] == list(range(2, 9)), res.upgrades)
    check(bool(torch.stack(checked.flags).all()) and bool(torch.isfinite(srv.last_logits).all()),
          f"{run.tag} non-finite logits")
    check(res.tokens.shape == (BATCH, STEPS) and int(res.tokens.max()) < cfg.vocab)
    check(rep["quantized_bytes"] == 2 * (run.n_params - run.n_fp)
          and rep["fp_bytes"] == 4 * run.n_fp and rep["fp_leaves"] > 0, rep)
    check(rep["quantized_bytes"] + rep["fp_bytes"] // 2 <= srv.state.store.resident_bytes(),
          (rep, srv.state.store.resident_bytes()))
    check(got["plane_or_segments"] == 8 and got["flash_verify"] == 0, got)
    check(by == expect_routes(moe_calls(cfg, 1, BATCH, PROMPT, "prefill")
                              + moe_calls(cfg, STEPS, BATCH, 1, "decode")), by)
    check(dropped["decode"] == 0.0, dropped)
    run.stream = (lm.logits, res.tokens.cpu())     # the stream [mesh] holds its sharded ones to
    log(f"{run.tag} single stream (in-memory planes, quantized, cf {cfg.capacity_factor}: "
        f"capacity {capacity(cfg, PROMPT)} rows an expert at the prefill, {capacity(cfg, 1)} at "
        f"decode): stages {res.stage_at_step[0]}->{res.stage_at_step[-1]}, upgrades "
        f"{res.upgrades}; resident {rep['quantized_bytes']} B quantized + {rep['fp_bytes']} B "
        f"in {rep['fp_leaves']} float leaves (the norms), the store's buffers "
        f"{srv.state.store.resident_bytes()} B; share of routed pairs dropped {dropped}")
    log(f"{run.tag} receive_stage + prefill {t_prefill * 1e3:.1f} ms; decode {STEPS} steps x "
        f"{BATCH} with 7 upgrades: {decode_s:.3f} s, {BATCH * STEPS / decode_s:.1f} tokens/s, "
        f"{decode_s / STEPS * 1e3:.2f} ms/step; per step dequant_matmul "
        f"{per_step['dequant_matmul']:.0f}, decode_attention {per_step['decode_attention']:.0f}; "
        f"launches {got}; dequant_matmul by route {by}, GEMV route by kernel "
        f"{dict(dqm.launches_by_gemv_kernel)}")

    # a decode step's B2 launches at their rows: B for the attention, the
    # router and lm_head, B x C for each expert's slots
    xg = torch.Generator(device=dev).manual_seed(2)
    named, experts = _moe_weights(cfg, srv.params, dev)
    check(all(dqm.one_pass(w.q) for _, w in named), f"{run.tag} a weight is off the one-pass "
          f"kernels")
    Me = BATCH * capacity(cfg, 1)
    calls = [(torch.randn((Me if nm in experts else BATCH, w.q.shape[0]), generator=xg,
                          device=dev).to(torch.float32 if nm == "lm_head" else cfg.dtype), w)
             for nm, w in named]

    def shapes():
        # each distinct shape of the other weights with keep = 3; the first
        # and the last expert's three slots, each expert with keep = 3 + e
        first: dict = {}
        for nm, w in named:
            if nm not in experts:
                first.setdefault(tuple(w.q.shape), (nm, w))
        keep = {e: torch.full((1, 1), 3 + e, dtype=torch.int32, device=dev)
                for e in (0, cfg.n_experts - 1)}
        weights = [(nm, w, torch.float32 if nm == "lm_head" else cfg.dtype, keep[0])
                   for nm, w in first.values()]
        for e, kt in keep.items():
            weights += [(nm, w, cfg.dtype, kt) for nm, w in named if nm.endswith(f"[{e}]")]
        return _dqmm_check(run.tag, weights, xg, MOE_DQMM_M,
                           "keep none and a mask of its own an expert (3 + e bits)")

    run.kern["dequant_matmul"] = _decode_b2_row(run, srv.params, xg, calls=calls,
                                                check_shapes=shapes)

    # B3 on the stream's own ring: window slots, of which the stream wrote
    # its first n (slot = position), the rest not yet written
    c0 = _stack_layers(cfg, srv.caches)[0]
    S, n = c0["k"].shape[2], PROMPT + STEPS
    check(S == cfg.window > n, S)
    k_pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(BATCH, 1)
    k_pos[:, n:] = -1
    k_pos[1, 41:] = -1
    q_pos = torch.tensor([n - 1, n - 1, 70, -1], dtype=torch.int32, device=dev)
    q = torch.randn((BATCH, cfg.n_heads, cfg.hd), generator=xg, device=dev).to(cfg.dtype)
    o = da.flash_decode(q, c0["k"], c0["v"], k_pos, q_pos, window=cfg.window)
    want = ref.flash_decode_ref(q, c0["k"], c0["v"], k_pos, q_pos, window=cfg.window)
    err = float((o.float() - want).abs().max())
    check(bool(torch.isfinite(o).all()) and err <= ATTN_RTOL * float(want.abs().max()),
          (run.tag, "decode_attention", err))
    log(f"{run.tag} [check] decode_attention B={BATCH} H={cfg.n_heads} Kh={cfg.n_kv} on the "
        f"stream's ring of {S} slots ({n} written), hd={cfg.hd}, window {cfg.window} (ragged "
        f"slot, free slot): max |err| {err:.3e} (tolerance {ATTN_RTOL} of max |out|)")


def _moe_pool(run, prog) -> None:
    """The slot pool's 12 requests as ``[pool]`` runs them, counted from 0:
    a chunk tick runs the attention and router at M = 64 and each expert's
    slots at M = 8 x C(8) = 16 (the tensor-core route), a decode step
    every expert's slots at M = 16 on the GEMV route (rows="decode")."""
    cfg = run.cfg
    pool, got, by = _pool_phase(
        run.model, prog, run.dev, run.ops, f"{run.tag} pool", 4 * run.n_fp,
        b2_calls=lambda ticks, steps: (moe_calls(cfg, ticks, POOL_SLOTS, POOL_CHUNK,
                                                 "prefill_chunk")
                                       + moe_calls(cfg, steps, POOL_SLOTS, 1, "decode")))
    for acc, new in ((run.counts, got), (run.routes, by)):
        for k, v in new.items():
            acc[k] = acc.get(k, 0) + v
    ring = _stack_layers(cfg, pool.caches)[0]["k"].shape[-2]
    log(f"{run.tag} pool: rings of {ring} slots (window {cfg.window} + chunk {POOL_CHUNK})")


def _moe_spec(run, prog):
    """``SpeculativeEngine`` at stage 8 (k = 4, draft 4 bits, rings grown by
    k_max + 1 = 5), counted from 0, on the same planes twice: at cf = 4.0
    (drop-free: every expert's capacity holds a verify block's 5 tokens),
    its tokens ``torch.equal`` to a plain server's greedy tokens at the same
    cf over the same rings (run first); then at the published cf = 1.25,
    where a verify block's capacity is 2 rows an expert: acceptance and the
    share of routed pairs dropped reported, no equality claimed. Returns
    the drop-free engine's caches."""
    from repro_torch.models.model import build_model
    from repro_torch.serving import ProgressiveServer, SpecConfig, SpeculativeEngine

    cfg, L, n = run.cfg, run.cfg.n_layers, run.prompt.shape[1]
    margin, max_len = MOE_SPEC_K + 1, n + SPEC_TOKENS + MOE_SPEC_K + 1
    spec = SpecConfig(draft_bits=4, k=MOE_SPEC_K, k_max=MOE_SPEC_K)
    free = build_model(dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k))
    plain = ProgressiveServer(free, prog, max_len=max_len, resident="quantized", device=run.dev)
    for _ in range(8):
        plain.receive_stage()
    plain.start({"tokens": run.prompt})
    plain.caches = free.grow_caches(plain.caches, max_len, ring_margin=margin, pos=n)
    want = plain.decode(SPEC_TOKENS).tokens.cpu()
    run.spec_plain = (free, want)     # [mesh] holds sharded speculation to these tokens
    del plain
    gc.collect()
    out = {}
    for model in (free, run.model):
        aux = MoeAux(model)
        eng = SpeculativeEngine(aux, prog, max_len=max_len, spec=spec, device=run.dev)
        torch.cuda.synchronize()
        reset_counts(run.ops)
        for _ in range(8):
            eng.receive_stage()
        eng.start({"tokens": run.prompt})
        res = eng.decode(SPEC_TOKENS)
        steps, verifies = _b2_steps(res.accept_rounds)
        got, by = _tally(run.counts, run.routes, f"{run.tag} spec")
        cf = model.cfg.capacity_factor
        check(got["flash_verify"] == L * verifies and verifies > 0, (got, verifies))
        check(by == expect_routes(moe_calls(model.cfg, 1, BATCH, n, "prefill")
                                  + moe_calls(model.cfg, steps, BATCH, 1, "decode")
                                  + moe_calls(model.cfg, verifies, BATCH, MOE_SPEC_K + 1,
                                              "verify")), by)
        rep = eng.resident_report()
        check(rep["extra_draft_bytes"] == 0 and rep["fp_bytes"] == 4 * run.n_fp, rep["fp_bytes"])
        rings = sorted({c["k"].shape[-2] for c in _stack_layers(cfg, eng.caches)})
        check(rings == [cfg.window + margin], rings)
        same = torch.equal(res.tokens.cpu(), want)
        if cf * cfg.top_k >= cfg.n_experts:
            check(same, f"{run.tag} speculative tokens at cf {cf} differ from plain")
        out[cf] = (eng.caches, aux.dropped())
        log(f"{run.tag} spec at cf {cf}: SpeculativeEngine at stage 8, k = {MOE_SPEC_K}, draft "
            f"4 bits, batch {BATCH}, prompt {n} (rings of {rings[0]} slots), {SPEC_TOKENS} "
            f"tokens: {res.rounds} rounds, {res.accepted}/{res.drafted} drafts accepted, "
            f"{verifies} verify passes; share of routed pairs dropped {out[cf][1]}; tokens "
            + ("equal (torch.equal) to plain greedy tokens at cf 4.0" if cf == 4.0 else
               f"{'equal' if same else 'not equal'} to the drop-free plain tokens (no claim: "
               f"a verify block's capacity drops tokens a decode step keeps)")
            + f"; extra draft bytes 0; launches {got}, dequant_matmul by route {by}")
        del eng, aux, res
        gc.collect()
    return out[cfg.n_experts / cfg.top_k][0]


# ---------------------------------------------------------------------------
# [arch seamless-m4t-medium], [vision path]: cross attention and encoders
# (ROADMAP A8(e))
# ---------------------------------------------------------------------------

def cross_b2(cfg) -> tuple[int, int, int]:
    """An encoder-decoder stack's B2 launches: a decode step's (each
    ``selfcross`` layer's self-attention 4, its cross-attention's ``wq``
    and ``wo``, the MLP's 3, then the unembedding), and a prefill's on the
    tensor cores: on the encoder's frames (7 an encoder layer, each
    decoder layer's cross ``wk`` and ``wv``) and on the prompt (9 a
    decoder layer)."""
    L, E = cfg.n_layers, cfg.enc_layers
    return 9 * L + 1, 7 * E + 2 * L, 9 * L


def _cross_phase(dev, ops) -> dict:
    """``[arch seamless-m4t-medium]``: ROADMAP A8(e) at seamless-m4t-medium's
    published widths and depth (12 ``enc_attn`` encoder blocks, 12
    ``selfcross`` decoder blocks), seeded random weights and a seeded
    ``enc_input`` of ``prompt // 4`` frames. Each path counted from 0:
    divide on the card and the stage-8 accumulators (:func:`_arch_divide`);
    the single stream (:func:`_cross_single`: a decode step's and a
    prefill's launches by name and route, B2 on every weight shape, B3 and
    B4 over the self and the cross caches); the stream from v3 wire bytes
    and float residency (:func:`_arch_wire`); ``SpeculativeEngine`` at
    stage 8 against plain greedy tokens (:func:`_arch_spec`); the pool
    refused; the single stream on a serving mesh (:func:`_arch_mesh`, the
    encoder pass on the home device, every projection through B7); the
    CLI queued beside phase 7. Returns the launch counts, B2's launches by
    route and the kernels' rows."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving import SlotPoolEngine

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(CROSS)
    L, E = cfg.n_layers, cfg.enc_layers
    model = build_model(cfg)
    step_b2, frame_b2, prompt_b2 = cross_b2(cfg)

    def memory(prompt) -> dict:
        # the stub frontend's frames for this prompt, from a seed
        g = torch.Generator(device=dev).manual_seed(3)
        return {"enc_input": torch.randn((prompt.shape[0], model.enc_len(prompt.shape[1]),
                                          cfg.d_model), generator=g, device=dev).to(cfg.dtype)}

    run = types.SimpleNamespace(
        tag=f"[arch {cfg.name}]", cfg=cfg, model=model, dev=dev, ops=ops, counts={},
        routes={}, kern={}, mesh_shards=MESH_ARCH_SHARDS.get(cfg.name, ()), attn_layers=2 * L,
        spec_b2=(frame_b2 + prompt_b2, step_b2), memory=memory,
        prompt=torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                             generator=torch.Generator().manual_seed(1)))
    log(f"{run.tag} {E} encoder blocks over {model.enc_len(PROMPT)} frames a {PROMPT}-token "
        f"prompt and {L} selfcross decoder blocks; a decode step {step_b2} B2 and {2 * L} B3 "
        f"launches, a prefill {frame_b2} + {prompt_b2} B2 launches on the tensor cores and the "
        f"unembedding's, by the code")
    seconds = {}

    def timed(name, fn):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    prog = timed("divide", lambda: _arch_divide(run))
    tokens = timed("stream", lambda: _cross_single(run, prog))
    timed("wire and fp", lambda: _arch_wire(run, prog, tokens))
    timed("spec", lambda: _arch_spec(run, prog, run.prompt))
    timed("pool refused", lambda: _refused(run.tag, "encoder-decoder", lambda: SlotPoolEngine(
        model, prog, n_slots=2, max_len=PROMPT + STEPS, resident="quantized", device=dev)))
    timed("mesh", lambda: _arch_mesh(run, prog, PROMPT + STEPS))
    del prog
    BESIDE_PATH["olmo-1b"].append(lambda: _cli_phase(cfg.name, CLI_STREAM))
    log(f"{run.tag} launches on the paths {run.counts}, dequant_matmul by route {run.routes}; "
        f"seconds by path {seconds}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"counts": run.counts, "routes": run.routes, "kern": run.kern}


def _refused(tag, text, fn) -> None:
    """``fn()`` raises ``NotImplementedError`` naming ``text``."""
    try:
        fn()
    except NotImplementedError as e:
        check(text in str(e), (tag, text, str(e)))
    else:
        check(False, f"{tag}: no refusal ({text})")
    gc.collect()
    log(f"{tag} refused, as it should be: {text}")


def _cross_single(run, prog) -> torch.Tensor:
    """The single stream (:func:`_arch_stream`) with a decode step's
    launches checked by name and route (:func:`cross_b2`: B2 on the
    one-pass GEMV kernels, a self and a cross B3 a layer); then a prefill
    at stage 8 counted alone (the encoder's and the cross projections'
    launches at the frames' rows, the decoder's at the prompt's, on the
    tensor cores; the last position's unembedding on the GEMV route); a
    decode step's B2 launches timed and every distinct weight shape
    checked (``embed.T`` at N = 256,206 included); B3 and B4 over the self
    and the cross caches (:func:`_memory_rows`); a whole decode step's
    device time; B3 and B4 over 12 cross caches of ``CROSS_LONG_TV``
    frames at seamless's heads. Returns the tokens."""
    from repro_torch.kernels import dequant_matmul as dqm
    from repro_torch.models.transformer import layer

    cfg, dev, L = run.cfg, run.dev, run.cfg.n_layers
    step_b2, frame_b2, prompt_b2 = cross_b2(cfg)
    frames = run.model.enc_len(PROMPT)
    prefill = [(frame_b2, BATCH * frames), (prompt_b2, BATCH * PROMPT), (1, BATCH)]
    srv, res = _arch_stream(run, prog, step_b2, 2 * L,
                            prefill + [(STEPS * step_b2, BATCH, "decode")],
                            "the norms")

    # a prefill alone at stage 8
    batch = _batch(run, run.prompt.to(dev))
    torch.cuda.synchronize()
    reset_counts(run.ops)
    _, caches = run.model.prefill(srv.params, batch)
    got, by = _tally(run.counts, run.routes, f"{run.tag} prefill")
    check(got["dequant_matmul"] == frame_b2 + prompt_b2 + 1 and got["decode_attention"] == 0
          and got["flash_verify"] == 0, got)
    check(by == expect_routes(prefill), by)
    cross = caches["cycles"]["0_selfcross"]["cross"]["k"]
    check(tuple(cross.shape) == (L, BATCH, cfg.n_kv, frames, cfg.hd), cross.shape)
    log(f"{run.tag} a prefill at stage 8 counted alone: dequant_matmul {got['dequant_matmul']} "
        f"launches, by route {by} ({frame_b2} at M = {BATCH * frames}: the encoder's "
        f"{7 * cfg.enc_layers} and the cross wk/wv {2 * L}; {prompt_b2} at M = "
        f"{BATCH * PROMPT}; the unembedding at M = {BATCH}); cross caches "
        f"{tuple(cross.shape)}; launches {got}")
    del caches

    # a decode step's B2 launches timed, every distinct weight shape checked
    xg = torch.Generator(device=dev).manual_seed(2)
    named = []
    for r in range(L):
        lr = layer(srv.params["decoder"]["cycles"]["0_selfcross"], r)
        named += [(f"self_attn.{k}", lr["self_attn"][k]) for k in ("wq", "wk", "wv", "wo")]
        named += [(f"cross_attn.{k}", lr["cross_attn"][k]) for k in ("wq", "wo")]
        named += [(f"mlp.{k}", lr["mlp"][k]) for k in ("wi_gate", "wi_up", "wo")]
    named.append(("embed.T", srv.params["embed"].T))
    check(len(named) == step_b2 and all(dqm.one_pass(w.q) for _, w in named),
          f"{run.tag} a weight is off the one-pass kernels")
    run.step_weights = [(nm, w.q.shape[1]) for nm, w in named]
    run.kern["dequant_matmul"] = _named_b2_row(run, srv.params, named, xg)
    stacked = srv.caches["cycles"]["0_selfcross"]
    run.kern["decode_attention"], run.kern["flash_verify"] = _memory_rows(
        run.tag, {"self": ([layer(stacked["self"], r) for r in range(L)], True),
                  "cross": ([layer(stacked["cross"], r) for r in range(L)], False)},
        cfg.n_heads, cfg.dtype, dev, xg)
    # the cross layers at seamless's heads over a memory of CROSS_LONG_TV frames
    mem = [{k: torch.randn((BATCH, cfg.n_kv, CROSS_LONG_TV, cfg.hd), generator=xg,
                           device=dev).to(cfg.dtype) for k in ("k", "v")} for _ in range(L)]
    for kind, row in zip(("decode_attention", "flash_verify"), _memory_rows(
            f"{run.tag} long memory", {"cross": (mem, False)}, cfg.n_heads, cfg.dtype, dev, xg)):
        run.kern[kind]["long_memory"] = {k: row[k] for k in (
            "per", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
    del mem
    _step_time(run, srv, res, "the norms, the embedding, rope, the cache writes")
    return res.tokens.cpu()


def _named_b2_row(run, P, named, xg) -> dict:
    """:func:`_decode_b2_row` over ``named`` ((name, view) in the order a
    decode step runs them, the unembedding last): bfloat16 x for the
    layers, float32 for the unembedding; every distinct weight shape
    checked with and without a mask (:func:`_dqmm_check`)."""
    cfg, dev = run.cfg, run.dev
    xs, calls = {}, []
    for nm, w in named:
        xd = torch.float32 if nm in ("embed.T", "lm_head") else cfg.dtype
        key = (w.q.shape[0], xd)
        if key not in xs:
            xs[key] = torch.randn((BATCH, key[0]), generator=xg, device=dev).to(xd)
        calls.append((xs[key], w))
    four = torch.full((1, 1), 4, dtype=torch.int32, device=dev)

    def shapes():
        first: dict = {}
        for nm, w in named:
            first.setdefault(tuple(w.q.shape), (nm, w, torch.float32 if nm in
                                                ("embed.T", "lm_head") else cfg.dtype, four))
        return _dqmm_check(run.tag, list(first.values()), xg, ARCH_DQMM_M, "keep none and 4")

    return _decode_b2_row(run, P, xg, calls=calls, check_shapes=shapes)


def _step_time(run, srv, res, rest: str) -> None:
    """A whole decode step at stage 8 (writing the stream's last cache
    row): its device time against its kernels' (B2's and B3's rows, where
    the arch has them), the ``rest`` named in the log, and the host's time
    to issue it."""
    dev = run.dev
    nxt = res.tokens[:, -1:].to(dev)
    last = torch.full((BATCH,), PROMPT + STEPS - 1, dtype=torch.int32, device=dev)

    def step():
        run.model.decode_step(srv.params, srv.caches, nxt, last)

    step_ms, issue_ms = device_ms(step, 2), host_ms(step, 3)
    kernels_ms = sum(run.kern[k]["ms"] for k in ("dequant_matmul", "decode_attention")
                     if k in run.kern)
    log(f"{run.tag} [time] a decode step at stage 8 (batch {BATCH}): {step_ms:.4f} ms on the "
        f"device (graph replay), of which B2 and B3 {kernels_ms:.4f} ms and the rest ({rest}) "
        f"{step_ms - kernels_ms:.4f} ms; the host issues it in {issue_ms:.3f} ms")


def _memory_rows(tag, groups, H, dtype, dev, g, T=5) -> tuple[dict, dict]:
    """B3 (one row a slot) and B4 (``T`` rows a slot) over each group of
    layer caches ((B, Kh, S, hd) each): ``groups`` maps a name to (the
    caches, causal). A causal group (a self cache, every row written)
    queries at its last positions; a memory group (a cross cache) at
    ``q_pos = S`` on every row, every key valid. On each group's first
    cache: both kernels within ``ATTN_RTOL`` of their plain versions, every
    B4 row ``torch.equal`` to a B3 launch of that row. Then each kernel's
    launches over all the groups timed (one decode step's, one verify
    pass's) beside the bound, the plain version and SDPA, and each group
    alone. Returns the B3 and B4 rows."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    from repro_torch.kernels import verify_attention as va

    first = next(iter(groups.values()))[0][0]["k"]
    B, _, _, hd = first.shape
    q1 = torch.randn((B, H, hd), generator=g, device=dev).to(dtype)
    qT = torch.randn((B, T, H, hd), generator=g, device=dev).to(dtype)
    ops_ = {}
    worst = {"decode": 0.0, "verify": 0.0}
    for name, (caches, causal) in groups.items():
        c = caches[0]
        S = c["k"].shape[2]
        k_pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
        if causal:
            p1 = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
            pT = (torch.arange(T, dtype=torch.int32, device=dev) + S - T).repeat(B, 1)
        else:
            p1 = torch.full((B,), S, dtype=torch.int32, device=dev)
            pT = torch.full((B, T), S, dtype=torch.int32, device=dev)
        o1, w1 = (da.flash_decode(q1, c["k"], c["v"], k_pos, p1),
                  ref.flash_decode_ref(q1, c["k"], c["v"], k_pos, p1))
        oT, wT = (va.flash_verify(qT, c["k"], c["v"], k_pos, pT),
                  ref.flash_verify_ref(qT, c["k"], c["v"], k_pos, pT))
        for kind, o, w in (("decode", o1, w1), ("verify", oT, wT)):
            err = float((o.float() - w).abs().max())
            check(bool(torch.isfinite(o).all()) and err <= ATTN_RTOL * float(w.abs().max()),
                  (tag, name, kind, err))
            worst[kind] = max(worst[kind], err)
        for t in range(T):
            row = da.flash_decode(qT[:, t].contiguous(), c["k"], c["v"], k_pos,
                                  pT[:, t].contiguous())
            check(torch.equal(oT[:, t], row), f"{tag} {name} flash_verify row {t} differs")
        valid = k_pos[:, None, :] <= pT[:, :, None]
        ops_[name] = dict(caches=caches, S=S, k_pos=k_pos, p1=p1, pT=pT,
                          m1=torch.where(valid[:, -1:], 0.0, -1e30).to(dtype)[:, None],
                          mT=torch.where(valid, 0.0, -1e30).to(dtype)[:, None])

    def launches(kind, which, fn):
        out = []
        for name in which:
            o = ops_[name]
            for c in o["caches"]:
                if kind == "decode":
                    out.append(fn(q1, c, o["k_pos"], o["p1"], o["m1"]))
                else:
                    out.append(fn(qT, c, o["k_pos"], o["pT"], o["mT"]))
        return out

    fns = {"decode": (lambda q, c, kp, qp, m: da.flash_decode(q, c["k"], c["v"], kp, qp),
                      lambda q, c, kp, qp, m: ref.flash_decode_ref(q, c["k"], c["v"], kp, qp),
                      lambda q, c, kp, qp, m: _sdpa(q[:, None], c, m)),
           "verify": (lambda q, c, kp, qp, m: va.flash_verify(q, c["k"], c["v"], kp, qp),
                      lambda q, c, kp, qp, m: ref.flash_verify_ref(q, c["k"], c["v"], kp, qp),
                      lambda q, c, kp, qp, m: _sdpa(q, c, m))}
    rows = {}
    for kind, (kern, plain, lib) in fns.items():
        rows_T = 1 if kind == "decode" else T

        def bound(which):
            n_b = n_ops = 0
            for name in which:
                for c in ops_[name]["caches"]:
                    S = c["k"].shape[2]
                    n_b += 2 * c["k"].numel() * c["k"].element_size() \
                        + 2 * B * rows_T * H * hd * c["k"].element_size() + B * S * 4 \
                        + B * rows_T * 4
                    n_ops += 4 * B * rows_T * H * S * hd
            return bound_ms(n_b, n_ops, attn_flops(first.dtype))

        def timed(which):
            return _attention_times(lambda: launches(kind, which, kern),
                                    lambda: launches(kind, which, plain),
                                    lambda: launches(kind, which, lib))

        row = timed(list(ops_))
        row["bound_ms"], row["bound_by"] = bound(list(ops_))
        row["max_abs_err"] = worst[kind]
        n = sum(len(o["caches"]) for o in ops_.values())
        row["per"] = (f"one {'decode step' if kind == 'decode' else f'verify pass (T = {T})'} "
                      f"({n} launches: " + ", ".join(f"{len(o['caches'])} over the {name} "
                                                      f"cache, S = {o['S']}"
                                                      for name, o in ops_.items()) + ")")
        row["by_cache"] = {}
        for name, o in ops_.items():
            sub = timed([name])
            b, bb = bound([name])
            row["by_cache"][name] = {"S": o["S"], "launches": len(o["caches"]), **sub,
                                     "bound_ms": b, "bound_by": bb}
        rows[kind] = row
        log(f"{tag} [check] {'decode_attention' if kind == 'decode' else 'flash_verify'} B={B} "
            f"H={H} Kh={first.shape[1]} hd={hd} over "
            + ", ".join(f"the {name} cache (S = {o['S']}, q_pos "
                        f"{'the last positions' if groups[name][1] else '= S'})"
                        for name, o in ops_.items())
            + f": max |err| {worst[kind]:.3e} (tolerance {ATTN_RTOL} of max |out|)"
            + ("; every row equal (torch.equal) to a flash_decode launch" if kind == "verify"
               else "")
            + f"; [time] {row['per']}: {row['ms']:.4f} ms on the device, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']:.4f} ms (scaled_dot_product_attention, additive "
            f"mask); by cache " + "; ".join(
                f"{name} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, plain "
                f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f})"
                for name, r in row["by_cache"].items()))
    return rows["decode"], rows["verify"]


def _vision_phase(dev, ops) -> dict:
    """``[vision path]``: llama-3.2-vision-90b's cross path at its reduced
    config (one cycle of four ``attn`` blocks and a gated ``cross`` block,
    ``vision_proj``; float32), seeded weights with the gates drawn away
    from 0 and seeded images. Each path counted from 0: divide on the
    card; the single stream (a decode step's launches by name and route),
    its logits against the same stream teacher-forced on the CPU's plain
    versions; ``SpeculativeEngine`` at stage 8, tokens equal to plain;
    the pool's batch-1 fall-back with each request's image, an upgrade a
    window, each request alone in a 1-slot pool at the busy pool's stages
    ``torch.equal``; the single stream on a serving mesh
    (:func:`_arch_mesh`: ``vision_proj`` and every projection through
    B7, the cross cache written on the home device). Then B3 and B4 over
    the stream's cross cache (Tv = 16), and over a cross cache at
    llama-3.2-vision-90b's published heads (Kh 8, G 8, hd 128, Tv 1601, B
    4, T 5), whose rows it returns with the counts."""
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import divide, tree_flatten_with_path
    from repro_torch.models.common import quantized_resident_eligible
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import layer
    from repro_torch.serving import ProgressiveServer

    t_phase = time.perf_counter()
    tag = "[vision path]"
    cfg = get_config(VISION).reduced()
    model = build_model(cfg)
    acc, routes = {}, {}
    g = torch.Generator(device=dev).manual_seed(4)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    gates = params["decoder"]["cycles"]["4_cross"]
    for name in ("gate_attn", "gate_mlp"):
        gates[name].copy_(torch.empty_like(gates[name]).uniform_(0.5, 1.0, generator=g))
    n_params = sum(t.numel() for _, t in tree_flatten_with_path(params))
    n_fp = sum(t.numel() for k, t in tree_flatten_with_path(params)
               if not quantized_resident_eligible(k))
    torch.cuda.synchronize()
    reset_counts(ops)
    prog = divide(params)
    got, _ = _tally(acc, routes, f"{tag} divide")
    check(got["plane_extract"] == 8 * len(prog.tensors), got)
    del params
    images = torch.randn((BATCH, cfg.vision_tokens, cfg.d_vision), generator=g, device=dev)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    L = cfg.n_layers
    step_b2 = 4 * 7 + 5 + 1          # four attn blocks, the cross block's wq, wo and MLP, lm_head
    log(f"{tag} {VISION} reduced: {L} layers {cfg.cycle}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads on {cfg.n_kv} KV heads, {cfg.vision_tokens} image embeddings of "
        f"{cfg.d_vision}, float32; gates {[float(v) for v in gates['gate_attn']]} (attention) "
        f"and {[float(v) for v in gates['gate_mlp']]} (MLP), each scaling its output by its "
        f"tanh; divide on the card {got}")

    # the single stream, then the same stream on the CPU, teacher-forced
    lm = LogitLog(model)
    srv = ProgressiveServer(lm, prog, max_len=PROMPT + STEPS, resident="quantized", device=dev)
    torch.cuda.synchronize()
    reset_counts(ops)
    srv.receive_stage()
    srv.start({"tokens": prompt, "vision_embeds": images})
    after = counts()
    res = srv.decode(STEPS, stage_arrival=lambda i: i in ARRIVALS)
    got, by = _tally(acc, routes, f"{tag} serve")
    per_step = {k: (got[k] - after[k]) / STEPS for k in got}
    check(per_step["dequant_matmul"] == step_b2 and per_step["decode_attention"] == 5
          and got["flash_verify"] == 0, per_step)
    check(after["dequant_matmul"] == 4 * 7 + 7 + 1 + 1, after)   # + vision_proj, lm_head
    check(srv.stage == 8 and bool(torch.isfinite(srv.last_logits).all()), srv.stage)
    cpu = ProgressiveServer(model, _cpu_copy(prog), max_len=PROMPT + STEPS,
                            resident="quantized", device="cpu")
    cpu.receive_stage()
    cpu.start({"tokens": prompt, "vision_embeds": images.cpu()})
    want = [cpu.last_logits]
    toks = res.tokens.cpu()
    for i in range(STEPS):
        if i in ARRIVALS:
            cpu.receive_stage()
        logits, cpu.caches = model.decode_step(cpu.params, cpu.caches,
                                               (toks[:, i:i + 1]), PROMPT + i)
        want.append(logits)
    err = max(float((a.cpu() - b).abs().max()) / float(b.abs().max())
              for a, b in zip(lm.logits, want))
    check(len(lm.logits) == len(want) and err <= PATH_RTOL, (tag, err))
    caches = srv.caches
    step_weights = [(nm, w.q.shape[1]) for nm, w in _vision_weights(srv.params)]
    check(len(step_weights) == step_b2, step_weights)
    stream = (lm.logits, res.tokens.cpu())
    log(f"{tag} single stream: stages {res.stage_at_step[0]}->{res.stage_at_step[-1]}, per "
        f"decode step dequant_matmul {per_step['dequant_matmul']:.0f} and decode_attention "
        f"{per_step['decode_attention']:.0f} (4 self, 1 cross over {cfg.vision_tokens} "
        f"slots); launches {got}, by route {by}; the prefill and every step's logits within "
        f"{err:.3e} of the CPU's plain versions teacher-forced, relative to the largest "
        f"(tolerance {PATH_RTOL})")
    del srv, cpu, lm
    gc.collect()

    # the single stream on a serving mesh, against the stream above
    _arch_mesh(types.SimpleNamespace(
        tag=tag, cfg=cfg, model=model, dev=dev, ops=ops, counts=acc, routes=routes, kern={},
        mesh_shards=MESH_ARCH_SHARDS[VISION], attn_layers=5, prompt=prompt,
        memory=lambda _: {"vision_embeds": images}, stream=stream,
        step_weights=step_weights, n_params=n_params, n_fp=n_fp), prog, PROMPT + STEPS)
    del stream
    gc.collect()

    # speculation against plain greedy tokens at stage 8
    from repro_torch.serving import SpecConfig, SpeculativeEngine

    batch = {"tokens": prompt, "vision_embeds": images}
    plain = ProgressiveServer(model, prog, max_len=PROMPT + SPEC_TOKENS + 9,
                              resident="quantized", device=dev)
    eng = SpeculativeEngine(model, prog, max_len=PROMPT + SPEC_TOKENS + 9,
                            spec=SpecConfig(draft_bits=4, k=4), device=dev)
    for _ in range(8):
        plain.receive_stage()
    plain.start(batch)
    want_toks = plain.decode(SPEC_TOKENS).tokens.cpu()
    torch.cuda.synchronize()
    reset_counts(ops)
    for _ in range(8):
        eng.receive_stage()
    eng.start(batch)
    sres = eng.decode(SPEC_TOKENS)
    got, by = _tally(acc, routes, f"{tag} spec")
    check(torch.equal(sres.tokens.cpu(), want_toks), f"{tag} speculative tokens differ")
    steps, verifies = _b2_steps(sres.accept_rounds)
    check(got["flash_verify"] == 5 * verifies and verifies > 0, (got, verifies))
    log(f"{tag} spec: SpeculativeEngine at stage 8, k = 4, {SPEC_TOKENS} tokens x {BATCH}: "
        f"equal (torch.equal) to plain greedy tokens; {sres.rounds} rounds, "
        f"{sres.accepted}/{sres.drafted} drafts accepted, {verifies} verify passes (B4 over "
        f"the self and the cross caches); launches {got}, by route {by}")
    del plain, eng
    gc.collect()

    _vision_pool(tag, model, prog, dev, ops, acc, routes)
    kern = {}
    xg = torch.Generator(device=dev).manual_seed(5)
    _memory_rows(f"{tag} reduced", {"cross": ([layer(caches["cycles"]["4_cross"], 0)], False)},
                 cfg.n_heads, cfg.dtype, dev, xg)
    del caches, prog
    gc.collect()
    torch.cuda.empty_cache()
    # a cross layer at llama-3.2-vision-90b's published heads
    full = get_config(VISION)
    mem = []
    for _ in range(VISION_HEADS_LAYERS):
        mem.append({k: torch.randn((BATCH, full.n_kv, full.vision_tokens, full.hd), generator=xg,
                                   device=dev).to(torch.bfloat16) for k in ("k", "v")})
    kern["decode_attention"], kern["flash_verify"] = _memory_rows(
        f"{tag} published heads", {"cross": (mem, False)}, full.n_heads, torch.bfloat16, dev,
        xg)
    log(f"{tag} launches on the paths {acc}, dequant_matmul by route {routes}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"counts": acc, "routes": routes, "kern": kern}


def _vision_weights(P) -> list:
    """The vision stack's decode-step B2 weights, (name, view) in the order
    it runs them: each ``attn`` layer's seven, the ``cross`` block's
    ``wq``, ``wo`` and MLP, the untied ``lm_head``."""
    from repro_torch.models.transformer import layer

    cyc = P["decoder"]["cycles"]
    out = [(f"attn{j}", w) for j in range(4) for w in _layer_weights(layer(cyc[f"{j}_attn"], 0))]
    cross = layer(cyc["4_cross"], 0)
    out += [("cross.wq", cross["attn"]["wq"]), ("cross.wo", cross["attn"]["wo"])]
    out += [(f"cross.mlp.{k}", cross["mlp"][k]) for k in ("wi_gate", "wi_up", "wo")]
    return out + [("lm_head", P["lm_head"])]


def _vision_pool(tag, model, prog, dev, ops, acc, routes) -> None:
    """The pool with ``chunked_prefill=None`` (it falls back to batch-1
    admission): ``VISION_REQUESTS`` requests with an image each on 2
    slots, an upgrade a window from stage 1, the last in a slot an
    eviction freed; then each request alone in a 1-slot pool, replayed at
    the busy pool's stages with its image: tokens ``torch.equal``."""
    from repro_torch.serving import PoolRequest, SlotPoolEngine

    cfg = model.cfg
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, cfg.vocab, int(n)), int(b), {"vision_embeds": rng.standard_normal(
        (cfg.vision_tokens, cfg.d_vision)).astype(np.float32)})
            for n, b in zip(rng.integers(16, 60, VISION_REQUESTS),
                            rng.integers(12, 25, VISION_REQUESTS))]
    max_len = 96
    pool = SlotPoolEngine(FiniteLogits(model), prog, n_slots=2, max_len=max_len,
                          resident="quantized", dispatch_window=4, device=dev)
    check(pool.chunked_prefill is False, "the vision pool does not fall back to batch 1")
    torch.cuda.synchronize()
    reset_counts(ops)
    pool.receive_stage()
    for rid, (p, b, ex) in enumerate(reqs):
        pool.submit(PoolRequest(rid=rid, prompt=p, max_new_tokens=b, extras=ex))
    out = pool.run(on_window=lambda _: pool.upgrade_if_available())
    got, by = _tally(acc, routes, f"{tag} pool")
    check(bool(torch.stack(pool.model.flags).all()), f"{tag} non-finite pool logits")
    check(pool.completed == set(range(VISION_REQUESTS)) and pool._tick_count == 0,
          pool.completed)
    for rid, (p, b, ex) in enumerate(reqs):
        alone = _alone(model, prog, p, b, pool.admit_stage[rid], pool.stage_log[rid], dev,
                       extras=ex, max_len=max_len)
        check(alone == out[rid], f"{tag} pool request {rid} alone differs from the busy pool")
    log(f"{tag} pool: {VISION_REQUESTS} requests with an image each on 2 slots, batch-1 "
        f"admission (chunked_prefill=None fell back), stages 1->{pool.stage}, admission "
        f"stages {pool.admit_stage}; launches {got}, by route {by}; each request alone in a "
        f"1-slot pool at the busy pool's stages, with its image: tokens equal (torch.equal)")


def _cnn_phase(dev, ops) -> dict:
    """``[arch progressivenet-cnn]``: the paper's own CNN (ROADMAP A8(f)) at
    its published widths (``cnn_init``: channels 16, 32, 64; 13 tensors,
    3,931 weights), seeded weights, progressive inference on the card.
    Each path counted from 0: ``divide`` on the card (B6, 8 launches a
    tensor), its planes and its v3 wire blob equal to the CPU divide's
    (the plain version); the blob fed in seeded ragged chunks through a
    ``ProgressiveClient`` on the card (B1, one launch a stage over all 13
    tensors) beside one on the CPU; at each of the 8 stages
    ``materialize`` and ``cnn_apply`` on each ``CNN_BATCHES`` batch, the
    logits within ``CNN_RTOL`` of the CPU client's leaves through the
    plain path, and the top-1 agreement with the undivided float32 model
    (Table II's column) printed with the ms of each; at stage 8 every
    accumulator ``torch.equal`` to ``quantize(leaf).q``. Then B1 on a
    stage's operands and B6 on the 13 tensors, timed beside their bounds,
    plain versions and library calls. Returns the launch counts, B2's
    launches by route (none) and the kernels' rows."""
    from repro_torch.configs.progressivenet_cnn import cnn_apply, cnn_init
    from repro_torch.core import wire
    from repro_torch.core.progressive import ReceiverState, divide
    from repro_torch.core.quantize import quantize
    from repro_torch.kernels import bitplane, ref
    from repro_torch.transmission import ProgressiveClient

    tag = f"[arch {CNN}]"
    t_phase = time.perf_counter()
    acc, routes, kern = {}, {}, {}
    params = cnn_init(torch.Generator(device=dev).manual_seed(0), device=dev)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    x_cpu = {size: torch.from_numpy(_cnn_images(size, b)) for size, b in CNN_BATCHES}
    x_dev = {size: x.to(dev) for size, x in x_cpu.items()}
    # the undivided float32 model's classes, Table II's reference
    full = {size: cnn_apply(params, x).argmax(-1) for size, x in x_dev.items()}

    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    prog = divide(params)
    torch.cuda.synchronize()
    t_divide = time.perf_counter() - t0
    got, _ = _tally(acc, routes, f"{tag} divide")
    n_t = len(prog.tensors)
    check(got["plane_extract"] == 8 * n_t and sum(got.values()) == 8 * n_t, (tag, got))
    cpu_prog = divide(cpu_params)
    for t, c in zip(prog.tensors, cpu_prog.tensors):
        check(t.path == c.path and all(torch.equal(a.cpu(), b)
                                       for a, b in zip(t.planes, c.planes)), (tag, t.path))
    blob = wire.encode(prog, integrity=True)
    check(blob == wire.encode(cpu_prog, integrity=True), f"{tag} wire blob differs")
    numel = sorted(int(np.prod(t.shape)) for t in prog.tensors)
    log(f"{tag} {n_t} tensors of {numel[0]}-{numel[-1]} elements, {sum(numel)} weights; "
        f"divide on the card {t_divide * 1e3:.1f} ms, launches {got}; every plane equals the "
        f"CPU divide's (the plain version) and the v3 blob ({len(blob)} bytes) the CPU's")

    # the stream: the card's client beside the CPU's, a stage at a time
    _, ends = _stage_ends(wire, blob)
    client, cpu_client = ProgressiveClient(device=dev), ProgressiveClient(device="cpu")
    feed = _feeder(client, blob, 7)
    cpu_client.feed(blob[:ends[0]])
    torch.cuda.synchronize()
    reset_counts(ops)
    feed(ends[0])
    stages = []
    for s in range(1, len(ends)):
        feed(ends[s])
        cpu_client.feed(blob[ends[s - 1]:ends[s]])
        check(client.stages_complete == cpu_client.stages_complete == s, (tag, s))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves = client.materialize()
        torch.cuda.synchronize()
        row = {"stage": s, "materialize_ms": (time.perf_counter() - t0) * 1e3}
        cpu_leaves = cpu_client.materialize()
        row["leaf_max_abs_diff"] = max(float((leaves[k].cpu() - v).abs().max())
                                       for k, v in cpu_leaves.items())
        for size, x in x_dev.items():
            t0 = time.perf_counter()
            logits = cnn_apply(leaves, x)
            torch.cuda.synchronize()
            apply_ms = (time.perf_counter() - t0) * 1e3
            want = cnn_apply(cpu_leaves, x_cpu[size])
            err = float((logits.cpu() - want).abs().max()) / float(want.abs().max())
            check(bool(torch.isfinite(logits).all()) and err <= CNN_RTOL, (tag, s, size, err))
            row[size] = {"apply_ms": apply_ms, "rel_err": err,
                         "top1_agreement": float((logits.argmax(-1) == full[size]).float().mean())}
        stages.append(row)
        log(f"{tag} stage {s} ({2 * s} bits): materialize {row['materialize_ms']:.2f} ms, "
            f"leaves against the CPU client's max |diff| {row['leaf_max_abs_diff']:.3e}; "
            + "; ".join(f"{size}x{size} x {x.shape[0]}: cnn_apply {row[size]['apply_ms']:.2f} "
                        f"ms, max |err| / max |logit| against the CPU "
                        f"{row[size]['rel_err']:.3e} (tolerance {CNN_RTOL}), top-1 agreement "
                        f"with the float model {row[size]['top1_agreement']:.4f}"
                        for size, x in x_dev.items()))
    got, _ = _tally(acc, routes, f"{tag} stream")
    check(got["plane_or_segments"] == 8 and sum(got.values()) == 8, (tag, got))
    for i, t in enumerate(prog.tensors):
        check(torch.equal(client.store._slice_acc(i), quantize(params[t.path[0]], 16).q),
              f"{tag} stage-8 accumulator of {t.path} differs from quantize(leaf).q")
    log(f"{tag} the stream's launches {got}; stage-8 accumulators equal quantize(leaf).q of "
        f"all {n_t} tensors; the float model's classes take "
        + ", ".join(f"{len(set(c.tolist()))} of 10 values at {size}x{size}"
                    for size, c in full.items())
        + "; top-1 agreement by stage: " + "; ".join(
            f"{size}x{size} " + ", ".join(f"{r[size]['top1_agreement']:.4f}" for r in stages)
            for size in x_dev))
    del client, cpu_client

    # B1 on stage 8's operands (every tensor in one round) after stage 7
    state = ReceiverState.init(prog, device=dev)
    for s in range(1, prog.n_stages):
        state = state.receive(prog.stage(s))
    store = state.store
    ((dt, (_, plane, shifts)),) = store.round_operands(dict(prog.stage(8))).items()
    buf = store.buffers[dt]
    check(plane.numel() == buf.numel(), (tag, plane.numel(), buf.numel()))
    check(torch.equal(bitplane.plane_or_segments(buf, plane, shifts),
                      ref.plane_or_segments_ref(buf, plane, shifts, store.block)),
          f"{tag} plane_or_segments differs from its plain version")
    n = buf.numel()
    sh = int(shifts[0])
    check(bool((shifts == sh).all()), f"{tag} shifts differ within the round")
    b16, p16 = buf.view(torch.int16), plane.view(torch.int16)
    b, by = bound_ms(3 * 2 * n + 4 * (n // store.block), n * 2, FP32_FLOPS)
    kern["plane_or_segments"] = {
        "ms": device_ms(lambda: bitplane.plane_or_segments(buf, plane, shifts), 20),
        "plain_ms": device_ms(lambda: ref.plane_or_segments_ref(buf, plane, shifts,
                                                                store.block), 5),
        "library_ms": device_ms(lambda: torch.bitwise_or(
            b16, torch.bitwise_left_shift(p16, sh)), 20),
        "host_ms": host_ms(lambda: bitplane.plane_or_segments(buf, plane, shifts), 20),
        "bound_ms": b, "bound_by": by, "max_abs_err": 0,
        "per": f"one stage ({n_t} tensors padded to {n} elements, one launch)"}
    # B6: one plane of each of the 13 tensors, from its q
    qs = [quantize(params[t.path[0]], 16).q for t in prog.tensors]
    for q in qs:
        check(torch.equal(bitplane.plane_extract(q, bits=16, before=6, width=2,
                                                 out_dtype=torch.uint8),
                          ref.plane_extract_ref(q, 16, 6, 2, torch.uint8)), (tag, "B6"))
    n_el = sum(q.numel() for q in qs)
    b, by = bound_ms(3 * n_el, 3 * n_el, FP32_FLOPS)

    def each(fn):
        for q in qs:
            fn(q)

    kern["plane_extract"] = {
        "ms": device_ms(lambda: each(lambda q: bitplane.plane_extract(
            q, bits=16, before=6, width=2, out_dtype=torch.uint8)), 5),
        "plain_ms": device_ms(lambda: each(lambda q: ref.plane_extract_ref(
            q, 16, 6, 2, torch.uint8)), 5),
        "library_ms": device_ms(lambda: each(lambda q: torch.bitwise_right_shift(
            torch.bitwise_and(torch.bitwise_left_shift(q.to(torch.int32), 6), 0xFFFF),
            14).to(torch.uint8)), 5),
        "host_ms": host_ms(lambda: each(lambda q: bitplane.plane_extract(
            q, bits=16, before=6, width=2, out_dtype=torch.uint8)), 5),
        "bound_ms": b, "bound_by": by, "max_abs_err": 0,
        "per": f"one plane of each of the {n_t} tensors ({n_t} launches, {n_el} elements)"}
    for name, row in kern.items():
        log(f"{tag} [time] {name} per {row['per']}: {row['ms']:.4f} ms on the device, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']:.4f} ms; host issue {row['host_ms']:.4f} ms")
    log(f"{tag} launches on the paths {acc}; {time.perf_counter() - t_phase:.1f} s")
    return {"counts": acc, "routes": routes, "kern": kern}


def _train_cli(cli_dir: str, result: dict) -> None:
    """``[train cli]``'s process: ``python -m repro_torch.launch.train
    --arch olmo-1b --steps 2 --ckpt-dir <cli_dir> --ckpt-every 2`` at full
    width; its command, exit code, output and seconds go into ``result``
    for :func:`_train_phase` to check."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo-1b", "--steps",
           "2", "--ckpt-dir", cli_dir, "--ckpt-every", "2"]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=CLI_TIMEOUT_S, env=env,
                          cwd=ROOT)
    result.update(cmd=cmd, dir=cli_dir, rc=proc.returncode, out=proc.stdout, err=proc.stderr,
                  s=time.perf_counter() - t0)


def _train_phase(dev, ops, cli: dict) -> dict:
    """``[train]``: ROADMAP A12(b) on the card. ``[train cli]``: the
    launcher's run (:func:`_train_cli`, a process of its own beside an
    earlier ``[path]``, ``cli`` its result) exited 0 with the launcher's
    three lines. ``[train step]`` (:func:`_train_step_check`): 2 layers of
    olmo-1b at full width, a train step on the card against the CPU's plain
    path. ``[train]``: the whole of olmo-1b through ``train(...)`` for
    ``TRAIN_STEPS`` steps at 8 x 128 with a checkpoint at the last step
    (B6 in ``save``): every step's loss finite, every leaf changed; step
    ms on the device's clock and the host's, tokens/s, peak memory.
    ``[train ckpt]``: the manifest's 8 stages (their sizes equal to the
    CLI's checkpoint's); the files through a client on the card (B1 a
    stage), whose stage-8 accumulators are ``quantize(p).q`` of every
    trained tensor, bit for bit; a held-out batch's loss (float32
    activations) from stages 1, 2, 4 and 8, each nearer to the float
    params' than the stage before, stage 8 within ``TRAIN_STAGE8_RTOL``
    of it. ``[train serve]``: the files as one stream through a
    ``WireStoreReceiver`` to ``ProgressiveServer(resident="quantized")``,
    stages landing mid-decode, tokens ``torch.equal`` to a server over the
    in-memory ``divide`` of the same params (B2, B3). Returns the launch
    counts and B2's launches by route."""

    from repro_torch.configs import get_config
    from repro_torch.core import wire
    from repro_torch.core.progressive import divide, tree_flatten_with_path
    from repro_torch.core.quantize import quantize
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ProgressiveServer, WireStoreReceiver
    from repro_torch.train import checkpoint
    from repro_torch.train.data import DataConfig, MarkovMotifDataset
    from repro_torch.train.loop import train
    from repro_torch.transmission import ProgressiveClient

    t_phase = time.perf_counter()
    acc, routes = {}, {}
    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    tmp = tempfile.TemporaryDirectory()
    check(cli.get("rc") == 0, ("[train cli]", cli.get("rc"), cli.get("err", "not run")[-3000:]))
    lines = cli["out"].strip().splitlines()
    check(len(lines) == 3 and lines[-1].endswith("over 2 steps"), ("[train cli]", lines[-3:]))
    for line in lines:
        log(f"[train cli] {line}")
    cli_manifest = checkpoint.manifest(cli["dir"])
    log(f"[train cli] {' '.join(cli['cmd'][1:])}: exit 0 in {cli['s']:.1f} s (the process "
        f"alone, beside [arch starcoder2-15b x2]'s [path]); manifest {cli_manifest}")
    _train_step_check(cfg, dev)

    # [train]: the whole model through train(), a checkpoint at the end
    ckpt = os.path.join(tmp.name, "ckpt")
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    init = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    init_heads = {p: leaf.reshape(-1)[:4096].clone() for p, leaf in tree_flatten_with_path(init)}
    del init
    starts = []
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])

    def clock(batch):
        # an event at each step's start, on the device's clock; the
        # profiler over step TRAIN_PROFILED alone
        if len(starts) == TRAIN_PROFILED + 1:
            torch.cuda.synchronize()
            prof.stop()
        starts.append(torch.cuda.Event(enable_timing=True))
        starts[-1].record()
        if len(starts) == TRAIN_PROFILED + 1:
            prof.start()
        return batch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    t0 = time.perf_counter()
    res = train(model, steps=TRAIN_STEPS, data_cfg=data_cfg, ckpt_dir=ckpt,
                ckpt_every=TRAIN_STEPS, log_every=1, extra_batch=clock, device=dev)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    got, _ = _tally(acc, routes, "[train]")
    leaves = dict(tree_flatten_with_path(res.params))
    check(got["plane_extract"] == 8 * len(leaves) and sum(got.values()) == got["plane_extract"],
          ("[train]", got))
    losses = [h["loss"] for h in res.history]
    check([h["step"] for h in res.history] == list(range(TRAIN_STEPS))
          and all(math.isfinite(x) for x in losses), ("[train]", losses))
    check(all(not torch.equal(leaves[p].detach().reshape(-1)[:4096], h)
              for p, h in init_heads.items()), "[train] a leaf did not change")
    del init_heads
    dev_ms = [a.elapsed_time(b) for a, b in zip(starts, starts[1:] + [end])]
    walls = [h["wall_s"] for h in res.history]
    wall_ms = [1e3 * (b - a) for a, b in zip([0.0] + walls, walls)]
    tok = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(v.numel() for v in leaves.values())
    log(f"[train] olmo-1b whole ({cfg.n_layers} layers, {n_params} weights), {TRAIN_STEPS} "
        f"steps at {TRAIN_BATCH} x {TRAIN_SEQ} through train(), bfloat16 activations, remat "
        f"{cfg.remat}: losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in res.history]}, lr "
        f"{[h['lr'] for h in res.history]}; every loss finite, every leaf changed")
    save_s = train_s - walls[-1]
    plain = [x for i, x in enumerate(wall_ms[1:], 1) if i != TRAIN_PROFILED]
    busy, top = _kernel_ms(prof)
    log(f"[train] a step (the first with its warm-up, step {TRAIN_PROFILED} under "
        f"torch.profiler): host clock {[round(x, 2) for x in wall_ms]} ms, device clock from "
        f"one step's start to the next's {[round(x, 2) for x in dev_ms[:-1]]} ms; tokens/s over "
        f"the other steps after the first {tok * len(plain) / (sum(plain) / 1e3):.1f}; the "
        f"checkpoint save after the last step {save_s:.2f} s; peak device memory "
        f"{peak_gb:.2f} GiB; train() {train_s:.1f} s; launches {got} (B6 in save)")
    log(f"[train] step {TRAIN_PROFILED}'s kernels: "
        + (f"{busy:.2f} ms of device time ({busy / (sum(plain) / len(plain)):.1%} of an "
           f"unprofiled step's host-clock ms); by kernel, the largest: "
           + "; ".join(f"{k[:70]} {v:.2f} ms x{n}" for k, v, n in top)
           if busy else "not measured (the profiler showed no device time)"))

    # [train ckpt]: the manifest, the stage-8 accumulators, the stage losses
    res.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    man = checkpoint.manifest(ckpt)
    check(sorted(man["stage_bytes"]) == list(range(1, 9)) and man["n_tensors"] == len(leaves),
          ("[train ckpt]", man))
    check(man["stage_bytes"] == cli_manifest["stage_bytes"]
          and man["n_tensors"] == cli_manifest["n_tensors"],
          ("[train cli] stage sizes differ", man, cli_manifest))
    with open(os.path.join(ckpt, "header.bin"), "rb") as f:
        meta, _ = wire.decode_header(f.read())
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    client = checkpoint.feed(ckpt, device=dev)
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    got, _ = _tally(acc, routes, "[train ckpt]")
    check(client.stages_complete == 8 and got["plane_or_segments"] == 8
          and sum(got.values()) == 8, ("[train ckpt]", got))
    for i, t in enumerate(meta["tensors"]):
        leaf = leaves[tuple(t["path"].split("/"))]
        check(torch.equal(client.store._slice_acc(i), quantize(leaf.detach(), 16).q),
              f"[train ckpt] stage-8 accumulator of {t['path']} differs from quantize(p).q")
    del client
    held = {k: torch.from_numpy(v).to(dev)
            for k, v in MarkovMotifDataset(data_cfg).batch(10 ** 6).items()}
    fp32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    stage_loss, load_s = {}, {}
    reset_counts(ops)
    with torch.no_grad():
        want = float(fp32.loss(res.params, held)[0])
        for s in TRAIN_LOSS_STAGES:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            approx = checkpoint.load_into(ckpt, res.params, stages=s, device=dev)
            torch.cuda.synchronize()
            load_s[s] = time.perf_counter() - t0
            stage_loss[s] = float(fp32.loss(approx, held)[0])
            del approx
    got, _ = _tally(acc, routes, "[train ckpt]")
    check(got["plane_or_segments"] == sum(TRAIN_LOSS_STAGES), ("[train ckpt]", got))
    # each stage's distance from the float params' loss: on weights a few
    # steps from their random init the loss's gradient is far from 0, so a
    # stage's quantization noise moves the loss by a first-order term of
    # either sign, and a signed loss may rise from stage 4 to 8; its size
    # shrinks 4x a bit
    dist = [abs(stage_loss[s] - want) for s in TRAIN_LOSS_STAGES]
    check(all(math.isfinite(stage_loss[s]) for s in TRAIN_LOSS_STAGES)
          and all(a > b for a, b in zip(dist, dist[1:])),
          ("[train ckpt] the stages' losses do not approach the float params'", stage_loss, want))
    rel8 = abs(stage_loss[8] - want) / abs(want)
    check(rel8 <= TRAIN_STAGE8_RTOL, ("[train ckpt] stage 8", stage_loss[8], want))
    log(f"[train ckpt] {len(leaves)} tensors, header {man['header_bytes']} B, stages "
        f"{man['stage_bytes']} B (equal to the CLI's); the files through a client on the card "
        f"(B1 a stage) in {feed_s:.2f} s; stage-8 accumulators equal quantize(p).q of every "
        f"trained tensor; held-out loss (float32 activations) by stage "
        + ", ".join(f"{s}: {stage_loss[s]:.6f}" for s in TRAIN_LOSS_STAGES)
        + f", the float params' {want:.6f}, each stage nearer to it (by "
        + ", ".join(f"{d:.3e}" for d in dist)
        + f"; stage 8 off by {rel8:.3e} of it, tolerance "
        f"{TRAIN_STAGE8_RTOL}); load_into s by stage "
        + ", ".join(f"{s}: {load_s[s]:.2f}" for s in TRAIN_LOSS_STAGES))
    del fp32

    # [train serve]: the checkpoint's files as one stream against the
    # in-memory divide of the same params
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    files = [os.path.join(ckpt, "header.bin")] + [os.path.join(ckpt, f"stage_{s:02d}.bin")
                                                  for s in range(1, 9)]
    torch.cuda.synchronize()
    reset_counts(ops)
    with torch.no_grad():
        prog = divide(res.params)
    del res, leaves
    gc.collect()
    client = ProgressiveClient(device=dev)

    def stream(i: int) -> None:
        with open(files[i], "rb") as f:
            while chunk := f.read(CHUNK_MAX):
                client.feed(chunk)

    def arrive(i: int) -> bool:
        if i not in TRAIN_ARRIVALS:
            return False
        stream(client.stages_complete + 1)
        return True

    max_len = PROMPT + TRAIN_SERVE_STEPS
    fed = ProgressiveServer(model, prog, max_len=max_len, resident="quantized", device=dev,
                            receiver=WireStoreReceiver(client, prog))
    stream(0)
    stream(1)
    fed.receive_stage()
    fed.start({"tokens": prompt})
    got_res = fed.decode(TRAIN_SERVE_STEPS, stage_arrival=arrive)
    mem = ProgressiveServer(model, prog, max_len=max_len, resident="quantized", device=dev)
    mem.receive_stage()
    mem.start({"tokens": prompt})
    want_res = mem.decode(TRAIN_SERVE_STEPS, stage_arrival=lambda i: i in TRAIN_ARRIVALS)
    got, by = _tally(acc, routes, "[train serve]")
    check(fed.stage == mem.stage == 8 and got_res.stage_at_step == want_res.stage_at_step,
          ("[train serve]", got_res.stage_at_step, want_res.stage_at_step))
    check(torch.equal(got_res.tokens, want_res.tokens), "[train serve] tokens differ")
    layers = cfg.n_layers
    calls = [(layers * 7, BATCH * PROMPT), (1, BATCH)] + pass_calls(layers, TRAIN_SERVE_STEPS,
                                                                    BATCH)
    check(got["plane_extract"] == 8 * len(prog.tensors) and got["plane_or_segments"] == 16
          and got["decode_attention"] == 2 * layers * TRAIN_SERVE_STEPS
          and by == expect_routes(calls + calls), ("[train serve]", got, by))
    log(f"[train serve] the checkpoint's files streamed in chunks of up to {CHUNK_MAX} B "
        f"through a WireStoreReceiver to ProgressiveServer(resident='quantized'), stages "
        f"{got_res.stage_at_step[0]}->{got_res.stage_at_step[-1]} over "
        f"{TRAIN_SERVE_STEPS} steps (upgrades {got_res.upgrades}): tokens "
        f"{tuple(got_res.tokens.shape)} torch.equal to a server over the in-memory divide; "
        f"launches {got}, dequant_matmul by route {by}")
    del fed, mem, prog, client
    tmp.cleanup()
    log(f"[train] launches on the paths {acc}; {time.perf_counter() - t_phase:.1f} s")
    return {"counts": acc, "routes": routes, "kern": {}}


def _train_step_check(cfg, dev) -> None:
    """``[train step]``: a train step of ``TRAIN_STEP_LAYERS`` layers of
    olmo-1b at full width on one seeded ``MarkovMotifDataset`` batch
    (``TRAIN_STEP_BATCH`` x ``TRAIN_SEQ``), bfloat16 activations, on the
    card and on the CPU (the plain path) from the same float32 params: the
    loss within ``TRAIN_LOSS_RTOL``, every leaf's gradient within
    ``TRAIN_GRAD_RTOL`` of its largest |g| on the CPU, and AdamW on the
    card's gradients on both within ``TRAIN_OPT_RTOL`` of each leaf's
    largest |p|. The card's step is timed on the host's clock and, under
    ``torch.profiler``, as the sum of its kernels' device time."""
    from repro_torch.core.progressive import tree_flatten_with_path, tree_skeleton, tree_unflatten
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.data import DataConfig, MarkovMotifDataset

    tag = "[train step]"
    t_phase = time.perf_counter()
    small = dataclasses.replace(cfg, n_layers=TRAIN_STEP_LAYERS)
    model = build_model(small)
    params = model.init(torch.Generator(device=dev).manual_seed(3), device=dev)
    flat = dict(tree_flatten_with_path(params))
    batch = {k: torch.from_numpy(v) for k, v in MarkovMotifDataset(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_STEP_BATCH)).batch(0).items()}
    skeleton = tree_skeleton(params)
    trees, losses, grads = {}, {}, {}
    where = {"cpu": torch.device("cpu"), "card": dev}
    for side, d in where.items():
        trees[side] = tree_unflatten(skeleton,
                                     {p: v.to(d).requires_grad_(True) for p, v in flat.items()})
        leaves = [v for _, v in tree_flatten_with_path(trees[side])]
        b = {k: v.to(d) for k, v in batch.items()}
        t0 = time.perf_counter()
        loss, _ = model.loss(trees[side], b)
        grads[side] = torch.autograd.grad(loss, leaves)
        losses[side] = float(loss.detach())
        log(f"{tag} {side}: loss {losses[side]:.6f}, forward and backward "
            f"{time.perf_counter() - t0:.2f} s (host clock, synchronised)")
    del params
    l_err = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    check(l_err <= TRAIN_LOSS_RTOL, (tag, losses))
    g_err = {}
    for (path, _), a, b in zip(tree_flatten_with_path(trees["cpu"]), grads["card"],
                               grads["cpu"]):
        g_err["/".join(path)] = float((a.cpu() - b).abs().max()) / float(b.abs().max())
    check(max(g_err.values()) <= TRAIN_GRAD_RTOL, (tag, g_err))
    # AdamW on the card's gradients on both sides, from zeroed moments
    ocfg = opt.OptConfig(warmup_steps=1)
    paths = list(flat)
    for side, tree in trees.items():
        g = tree_unflatten(skeleton, {p: v.to(where[side]) for p, v in zip(paths, grads["card"])})
        opt.update(ocfg, g, opt.init(tree), tree)
    o_err = max(float((a.detach().cpu() - b.detach()).abs().max()) / float(b.detach().abs().max())
                for (_, a), (_, b) in zip(tree_flatten_with_path(trees["card"]),
                                          tree_flatten_with_path(trees["cpu"])))
    check(o_err <= TRAIN_OPT_RTOL, (tag, "update", o_err))
    # the card's step alone: host clock, and its kernels' device time
    tree = trees["card"]
    leaves = [v for _, v in tree_flatten_with_path(tree)]
    b = {k: v.to(dev) for k, v in batch.items()}
    state = opt.init(tree)

    def step():
        loss, _ = model.loss(tree, b)
        g = torch.autograd.grad(loss, leaves)
        opt.update(ocfg, tree_unflatten(skeleton, dict(zip(paths, g))), state, tree)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    busy, _ = _kernel_ms(prof)
    log(f"{tag} {TRAIN_STEP_LAYERS} layers of olmo-1b at full width, "
        f"{TRAIN_STEP_BATCH} x {TRAIN_SEQ} tokens, bfloat16 activations on both sides: loss "
        f"card {losses['card']:.6f}, cpu {losses['cpu']:.6f}, off by {l_err:.3e} (tolerance "
        f"{TRAIN_LOSS_RTOL}); largest gradient error against the leaf's max |g| "
        f"{max(g_err.values()):.3e} (tolerance {TRAIN_GRAD_RTOL}; by leaf "
        + ", ".join(f"{k} {v:.2e}" for k, v in g_err.items())
        + f"); AdamW on the same gradients {o_err:.3e} (tolerance {TRAIN_OPT_RTOL}); the "
        f"card's step (loss, gradients, update) {host:.2f} ms on the host's clock, its kernels "
        + (f"{busy:.2f} ms of device time (torch.profiler)" if busy else
           "not measured (the profiler showed no device time)")
        + f"; {time.perf_counter() - t_phase:.1f} s")


def _kernel_ms(prof, top: int = 8) -> tuple[float, list]:
    """A profile's device time in ms, summed over its CUDA kernels (not the
    CPU ops, whose device time counts the same kernels again), and its
    ``top`` kernels by time: (name, ms, calls)."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows[:top]


def _cnn_images(size: int, batch: int) -> np.ndarray:
    """Seeded NHWC images: each a random colour (twice a unit normal a
    channel) plus unit noise a pixel."""
    rng = np.random.default_rng(size)
    colour = 2 * rng.standard_normal((batch, 1, 1, 3))
    return (colour + rng.standard_normal((batch, size, size, 3))).astype(np.float32)


def _metric_values(reg) -> dict:
    """A registry's samples: ``(family, labels) -> value`` for counters and
    gauges, ``-> (count, sum)`` for histograms."""
    out = {}
    for m in reg.collect():
        for labels, v in m.samples():
            out[(m.name, labels)] = (len(v), float(sum(v))) if isinstance(v, (list, tuple)) \
                else float(v)
    return out


def _family_total(values: dict, family: str, index=None) -> float:
    """The sum over a family's label sets (of the count, ``index`` 0, or the
    sum, 1, of a histogram)."""
    return sum(v if index is None else v[index] for (f, _), v in values.items() if f == family)


def _telemetry_phase(model, prog, dev, ops, prompt) -> dict:
    """``[telemetry]``: ROADMAP A11's second half on full-width olmo-1b.
    The single stream (quantized residency from stage ``TEL_START``,
    ``TEL_STEPS`` decode steps in one dispatch window, the next stages
    landing at ``TEL_ARRIVALS``) and ``SpeculativeEngine`` (stage 8, batch
    1, k = 4, ``TEL_SPEC_TOKENS`` tokens), each run with the registry off
    and then on, ``TEL_TURNS`` times in turn, the launch counts set to 0
    before each run: tokens
    ``torch.equal`` and launches equal between the two; the off run
    records nothing; in the on run the counters equal the run's own
    records (tokens, stages ingested and refreshed, windows, rounds and
    accepted drafts) and ``kernel_launches_total`` equals
    ``ops.LAUNCH_COUNTS``; the wall ms a step (a round) printed, off and
    on. Returns the launch counts and B2's launches by route."""
    from repro_torch import obs
    from repro_torch.serving import ProgressiveServer, SpecConfig, SpeculativeEngine

    tag = "[telemetry]"
    t_phase = time.perf_counter()
    acc, routes = {}, {}

    def stream():
        srv = ProgressiveServer(model, prog, max_len=PROMPT + TEL_STEPS, resident="quantized",
                                device=dev)
        for _ in range(TEL_START):
            srv.receive_stage()
        srv.start({"tokens": prompt})
        res = srv.decode(TEL_STEPS, stage_arrival=lambda i: i in TEL_ARRIVALS,
                         dispatch_window=TEL_STEPS)
        check(res.upgrades == [(a, TEL_START + 1 + j) for j, a in enumerate(TEL_ARRIVALS)],
              (tag, res.upgrades))
        return res, sum(w for _, w in res.window_s) / TEL_STEPS, "step"

    def spec():
        eng = SpeculativeEngine(model, prog, max_len=PROMPT + TEL_SPEC_TOKENS + 16,
                                spec=SpecConfig(draft_bits=4, k=4), device=dev)
        for _ in range(prog.n_stages):
            eng.receive_stage()
        eng.start({"tokens": prompt[:1]})
        res = eng.decode(TEL_SPEC_TOKENS)
        return res, res.wall_s / res.rounds, "round"

    for name, fn in (("stream", stream), ("spec", spec)):
        seen, per_ms = {}, {False: [], True: []}
        for on in (False, True) * TEL_TURNS:
            gc.collect()
            torch.cuda.empty_cache()
            obs.reset()
            with obs.telemetry(on):
                torch.cuda.synchronize()
                reset_counts(ops)
                res, per_s, per = fn()
                got, _ = _tally(acc, routes, f"{tag} {name}")
                reg = obs.get_registry()
                run = {"res": res, "tokens": res.tokens.cpu(), "got": got,
                       "launches": dict(ops.LAUNCH_COUNTS), "values": _metric_values(reg),
                       "families": len(reg)}
            per_ms[on].append(per_s * 1e3)
            if on in seen:   # a later turn: the same tokens, launches and records
                check(torch.equal(run["tokens"], seen[on]["tokens"]) and run["got"] ==
                      seen[on]["got"] and run["values"].keys() == seen[on]["values"].keys(),
                      (tag, name, "turns differ"))
            else:
                seen[on] = run
        off, on_ = seen[False], seen[True]
        check(torch.equal(off["tokens"], on_["tokens"]), f"{tag} {name}: tokens differ")
        check(off["got"] == on_["got"] and off["launches"] == on_["launches"],
              (tag, name, off["launches"], on_["launches"]))
        check(off["families"] == 0, (tag, name, "the off run recorded", off["families"]))
        v, res = on_["values"], on_["res"]
        kernels = {dict(ls)["kernel"]: int(x) for (f, ls), x in v.items()
                   if f == "kernel_launches_total"}
        check(kernels == on_["launches"], (tag, name, kernels, on_["launches"]))
        ingests = TEL_START + len(TEL_ARRIVALS) if name == "stream" else prog.n_stages
        engine = "single" if name == "stream" else "SpeculativeEngine"
        want = {"engine_tokens_total": TEL_STEPS if name == "stream" else TEL_SPEC_TOKENS,
                "span_upgrade_ingest_wall_s": ingests, "span_upgrade_refresh_wall_s": ingests,
                "store_or_rounds_total": ingests, "engine_ttft_s": 1,
                "span_decode_window_wall_s": len(res.window_s) if name == "stream" else 1}
        if name == "spec":
            want.update(spec_rounds_total=res.rounds, spec_accepted_per_round=res.rounds)
            check(_family_total(v, "spec_accepted_per_round", 1) == res.accepted,
                  (tag, "accepted drafts", res.accepted))
        have = {f: _family_total(v, f, None if f.endswith("_total") else 0) for f in want}
        check(have == want, (tag, name, have, want))
        check(v[("engine_tokens_total", (("engine", engine),))] == want["engine_tokens_total"],
              (tag, name, engine))
        check(kernels["plane_or_segments"] == ingests, (tag, name, kernels))
        log(f"{tag} {name}: tokens {tuple(on_['tokens'].shape)} torch.equal with telemetry off "
            f"and on, the same launches {on_['launches']}; off: nothing recorded; on: "
            f"{on_['families']} families, counters equal the run's records {want}"
            + (f" and {res.accepted} accepted drafts" if name == "spec" else "")
            + f", kernel_launches_total equal to LAUNCH_COUNTS; wall ms a {per} "
            f"(host-bound: the host issues it), turns in the order off, on: "
            + ", ".join(f"{a:.3f}, {b:.3f}" for a, b in zip(per_ms[False], per_ms[True])))
    obs.reset()
    log(f"{tag} launches on the paths {acc}; {time.perf_counter() - t_phase:.1f} s")
    return {"counts": acc, "routes": routes}


def _arch_dqmm_check(tag, layer0, unembed, cfg, dev, g) -> float:
    """B2 on each distinct weight shape of the arch (layer 0's live stage-8
    views and the unembedding) at ARCH_DQMM_M rows, with and without the
    plane mask keep = 4 (:func:`_dqmm_check`). Returns the worst error over
    the largest output."""
    names = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wi_gate", "mlp.wi_up", "mlp.wo")
    four = torch.full((1, 1), 4, dtype=torch.int32, device=dev)
    weights = {}
    for nm, w in zip(names, _layer_weights(layer0)):
        weights.setdefault(tuple(w.q.shape), (nm, w, cfg.dtype, four))
    weights["unembed"] = ("embed.T" if cfg.tie_embeddings else "lm_head", unembed,
                          torch.float32, four)
    return _dqmm_check(tag, list(weights.values()), g, ARCH_DQMM_M, "keep none and 4")


def _dqmm_check(tag, weights, g, Ms, masks: str) -> float:
    """B2 on each of ``weights`` ((name, view, x dtype, keep) tuples; a view
    has ``q``, ``scale`` and ``offset``) at ``Ms`` rows, without a mask and
    with its ``keep``, within ``DQMM_RTOL`` of the plain version on the
    wrapper's route and on the forced GEMV route (verify's rows="decode");
    every row of a forced-GEMV launch at M = 20 equal to the row alone.
    Returns the worst error over the largest output."""
    from repro_torch.kernels import dequant_matmul as dqm
    from repro_torch.kernels import ref

    worst, lines = 0.0, []
    for nm, w, xd, keep in weights:
        K = w.q.shape[0]
        x = torch.nn.functional.silu(2 * torch.randn((max(max(Ms), 20), K), generator=g,
                                                     device=w.q.device)).to(xd)
        rel = 0.0
        for kt in (None, keep):
            for M in Ms:
                yr = ref.dequant_matmul_ref(x[:M], w.q, w.scale, w.offset, kt)
                mag = float(yr.abs().max())
                for rows in ("any", "decode"):
                    y = dqm.dequant_matmul(x[:M], w.q, w.scale, w.offset, kt, rows=rows)
                    err = float((y - yr).abs().max())
                    check(err <= DQMM_RTOL * mag, (tag, nm, M, kt is None, rows, err, mag))
                    rel = max(rel, err / mag)
            alone = torch.cat([dqm.dequant_matmul(x[i:i + 1], w.q, w.scale, w.offset, kt,
                                                  rows="decode") for i in range(20)])
            check(torch.equal(dqm.dequant_matmul(x[:20], w.q, w.scale, w.offset, kt,
                                                 rows="decode"), alone),
                  f"{tag} {nm}: a row of an M = 20 decode-rows launch differs alone")
        worst = max(worst, rel)
        lines.append(f"{nm} K={K} N={w.q.shape[1]} "
                     f"{'one-pass' if dqm.one_pass(w.q) else 'general'} {rel:.2e}")
    log(f"{tag} [check] dequant_matmul on each distinct weight shape at M = {list(Ms)}, "
        f"{masks}, the wrapper's route and rows='decode': max |err| / max |y| "
        + "; ".join(lines) + f" (tolerance {DQMM_RTOL}); every row of an M = 20 "
        f"rows='decode' launch equal (torch.equal) to the row alone")
    return worst


def _arch_verify_check(run, pool, slot="0_attn") -> dict:
    """B4 on the first layer of the pool's live caches of cycle ``slot`` at
    the arch's heads: a chunk (T = 8) and verify's T = 5, slots ragged,
    masked and free, within ``ATTN_RTOL`` of the plain version, every row
    ``torch.equal`` to a ``flash_decode`` launch; then a verify pass's
    launches (one a layer of the slot) timed."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    from repro_torch.kernels import verify_attention as va
    from repro_torch.models.transformer import layer

    cfg, dev = run.cfg, run.dev
    g = torch.Generator(device=dev).manual_seed(8)
    stacked = pool.caches["cycles"][slot]
    caches = [layer(stacked, r) for r in range(stacked["k"].shape[0])]
    L = len(caches)
    pc = caches[0]
    PS = pc["k"].shape[2]
    k_pos = torch.arange(PS, dtype=torch.int32, device=dev).repeat(POOL_SLOTS, 1)
    k_pos[1, 46:] = -1
    worst = 0.0
    for T in (POOL_CHUNK, 5):
        base = torch.tensor([PS - T, 40, -1, -1] + [16 * i for i in range(4, POOL_SLOTS)],
                            dtype=torch.int32, device=dev)
        q_pos = torch.where(base[:, None] >= 0,
                            base[:, None] + torch.arange(T, dtype=torch.int32, device=dev), -1)
        q = torch.randn((POOL_SLOTS, T, cfg.n_heads, cfg.hd), generator=g,
                        device=dev).to(cfg.dtype)
        out = va.flash_verify(q, pc["k"], pc["v"], k_pos, q_pos)
        want = ref.flash_verify_ref(q, pc["k"], pc["v"], k_pos, q_pos)
        err = float((out.float() - want).abs().max())
        check(bool(torch.isfinite(out).all()) and err <= ATTN_RTOL * float(want.abs().max()),
              (run.tag, "flash_verify", T, err))
        worst = max(worst, err)
        for t in range(T):
            row = da.flash_decode(q[:, t].contiguous(), pc["k"], pc["v"], k_pos,
                                  q_pos[:, t].contiguous())
            check(torch.equal(out[:, t], row), f"{run.tag} flash_verify T={T} row {t} differs")
    n_b = 2 * pc["k"].numel() * pc["k"].element_size() + 2 * q.numel() * q.element_size() \
        + k_pos.numel() * 4 + q_pos.numel() * 4
    b, by = bound_ms(L * n_b, L * 4 * POOL_SLOTS * 5 * cfg.n_heads * PS * cfg.hd,
                     attn_flops(pc["k"].dtype))
    valid = (k_pos[:, None, :] >= 0) & (k_pos[:, None, :] <= q_pos[:, :, None]) \
        & (q_pos[:, :, None] >= 0)
    mask = torch.where(valid, 0.0, -1e30).to(cfg.dtype)[:, None]   # (B, 1, T, S)
    row = _attention_times(
        lambda: [va.flash_verify(q, c["k"], c["v"], k_pos, q_pos) for c in caches],
        lambda: [ref.flash_verify_ref(q, c["k"], c["v"], k_pos, q_pos) for c in caches],
        lambda: [_sdpa(q, c, mask) for c in caches])
    log(f"{run.tag} [check] flash_verify B={POOL_SLOTS} H={cfg.n_heads} Kh={cfg.n_kv} S={PS} "
        f"at T = {POOL_CHUNK} and 5 (ragged, masked and free slots): max |err| {worst:.3e}; "
        f"every row equal (torch.equal) to a flash_decode launch; [time] {L} launches at T = 5 "
        f"{row['ms']:.4f} ms on the device, bound {b:.4f} ms ({by}), plain "
        f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms "
        f"(scaled_dot_product_attention, GQA, (B, 1, T, S) mask)")
    return {**row, "max_abs_err": worst, "bound_ms": b, "bound_by": by,
            "per": f"one verify pass ({L} launches, T = 5)"}


def _attention_times(kernel, plain, library, reps=(3, 1, 3)) -> dict:
    """Device ms of one call of each (``reps`` calls a graph): the kernel,
    its plain version and ``scaled_dot_product_attention``; and the host's
    ms to issue the kernel's call."""
    return {"ms": device_ms(kernel, reps[0]), "plain_ms": device_ms(plain, reps[1]),
            "library_ms": device_ms(library, reps[2]), "host_ms": host_ms(kernel, reps[0])}


def _sdpa(q, cache, mask):
    """``scaled_dot_product_attention`` of (B, T, H, hd) rows against one
    layer's native (B, Kh, S, hd) cache, GQA, with an additive mask."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), cache["k"], cache["v"], attn_mask=mask,
        enable_gqa=q.shape[2] != cache["k"].shape[1])


def _dqmm_bound(calls) -> tuple[float, str]:
    """The least time for ``dequant_matmul`` over ``calls`` ((x, weight)
    pairs), whichever route runs it: each x, q and output crossing device
    memory once, or the function's 2MKN products once at the bf16
    tensor-core peak (its products are exact in bf16 once q and x are
    split), whichever is larger. The splits' extra passes are the
    kernel's cost, not the function's."""
    n_b, n_ops = 0, 0
    for x, w in calls:
        M, (K, N) = x.shape[0], w.q.shape
        n_b += w.q.numel() * w.q.element_size() + x.numel() * x.element_size() + M * N * 4
        n_ops += 2 * M * K * N
    t_bytes, t_ops = n_b / HBM_BYTES_PER_S * 1e3, n_ops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _layer_weights(lr: dict) -> list:
    """One layer's seven matmul weights in the order decode runs them."""
    a, m = lr["attn"], lr["mlp"]
    return [a["wq"], a["wk"], a["wv"], a["wo"], m["wi_gate"], m["wi_up"], m["wo"]]


def _whole_path(cfg, dev, stages=range(1, 9), cpu_divides=True, n_layers=2
                ) -> tuple[float, float]:
    """The same ``n_layers``-layer full-width weights served on the card and on the
    CPU, each side ingesting its own copy of the planes through all 8
    stages; after each of ``stages``, the fingerprints and teacher-forced
    logits compared, and after stages 1 and 8 the logits of a ragged
    prefill chunk and a verify block into pooled caches. The CPU divides
    its own float copy, or with ``cpu_divides`` False takes a host copy of
    the card's planes: the new archs, whose planes ``_arch_divide`` holds
    against ``quantize(leaf).q`` at full depth, and whose 1.0-1.67 B
    weights take the CPU's plain divide 40-65 s. Returns the worst max
    |err| / max |logit| of each."""
    from repro_torch.core.progressive import divide
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ProgressiveServer

    cfg2 = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg2)
    params = model.init(torch.Generator(device=dev).manual_seed(3), device=dev)
    params_cpu = {k: v for k, v in _to_cpu(params).items()} if cpu_divides else None
    gpu = ProgressiveServer(model, divide(params), max_len=16 + 2, resident="quantized",
                            device=dev)
    cpu = ProgressiveServer(model, divide(params_cpu) if cpu_divides else _cpu_copy(gpu.prog),
                            max_len=16 + 2, resident="quantized", device="cpu")
    del params, params_cpu
    g = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, cfg2.vocab, (2, 16), generator=g)
    forced = torch.randint(0, cfg2.vocab, (2, 2), generator=g)
    worst = worst_chunk = 0.0
    for s in range(1, gpu.prog.n_stages + 1):
        gpu.receive_stage()
        cpu.receive_stage()
        if s not in stages:
            continue
        check(gpu.state.store.fingerprint() == cpu.state.store.fingerprint(),
              f"accumulators differ at stage {s}")
        gpu.start({"tokens": prompt})
        cpu.start({"tokens": prompt})
        pairs = [(gpu.last_logits, cpu.last_logits)]
        for t in range(forced.shape[1]):
            tok = forced[:, t:t + 1]
            lg, gpu.caches = model.decode_step(gpu.params, gpu.caches, tok.to(dev),
                                               gpu.pos + t)
            lc, cpu.caches = model.decode_step(cpu.params, cpu.caches, tok, cpu.pos + t)
            pairs.append((lg, lc))
        for lg, lc in pairs:
            check(bool(torch.isfinite(lg).all()))
            err = float((lg.cpu() - lc).abs().max()) / float(lc.abs().max())
            check(err <= PATH_RTOL, f"stage {s}: relative logit error {err:.3e}")
            worst = max(worst, err)
        if s in (1, gpu.prog.n_stages):
            worst_chunk = max(worst_chunk, _chunk_and_verify(model, gpu, cpu, g, dev, s))
    return worst, worst_chunk


def _chunk_and_verify(model, gpu, cpu, g, dev, stage) -> float:
    """A prefill chunk (slot 0 at positions 0-7, slot 1 a short chunk of 5
    rows) then a 3-row verify block (not for a recurrent stack, which
    refuses it) into pooled caches, on both servers' parameters; returns
    the worst relative logit error."""
    from repro_torch.models.transformer import recurrent_kinds

    vocab = model.cfg.vocab
    tok_pos = torch.tensor([list(range(8)), [0, 1, 2, 3, 4, -1, -1, -1]],
                           dtype=torch.int32)
    calls = [("prefill_chunk", torch.randint(0, vocab, (2, 8), generator=g), tok_pos),
             ("verify_step", torch.randint(0, vocab, (2, 3), generator=g),
              torch.tensor([8, 5], dtype=torch.int32))]
    if recurrent_kinds(model.cfg):
        calls = calls[:1]        # a recurrent stack refuses verify
    caches = {"gpu": model.init_caches(2, 18, device=dev),
              "cpu": model.init_caches(2, 18, device="cpu")}
    worst = 0.0
    for name, toks, pos in calls:
        lg, caches["gpu"] = getattr(model, name)(gpu.params, caches["gpu"], toks.to(dev),
                                                 pos.to(dev))
        lc, caches["cpu"] = getattr(model, name)(cpu.params, caches["cpu"], toks, pos)
        check(bool(torch.isfinite(lg).all()), f"{name}: non-finite logits")
        err = float((lg.cpu() - lc).abs().max()) / float(lc.abs().max())
        check(err <= PATH_RTOL, f"stage {stage} {name}: relative logit error {err:.3e}")
        worst = max(worst, err)
    return worst


def _attention_long(cfg, dev, g, S, da, va, ref) -> dict:
    """``[check]`` and ``[time]`` both attention kernels on one synthetic
    layer of S keys, every key live, at the paths' heads: decode at the
    single stream's batch, verify at the pool's slots and chunk (each row
    also ``torch.equal`` to a decode launch). Device ms a launch beside
    ``scaled_dot_product_attention`` and the bytes bound."""
    H, Kh, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    rows = {}
    for name, B, T in (("decode_attention", BATCH, 1), ("flash_verify", POOL_SLOTS, POOL_CHUNK)):
        k = torch.randn((B, Kh, S, hd), generator=g, device=dev).to(cfg.dtype)
        v = torch.randn((B, Kh, S, hd), generator=g, device=dev).to(cfg.dtype)
        q = torch.randn((B, T, H, hd), generator=g, device=dev).to(cfg.dtype)
        k_pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
        q_pos = (torch.arange(T, dtype=torch.int32, device=dev) + S - T).repeat(B, 1)
        if T == 1:
            q1, qp1 = q[:, 0].contiguous(), q_pos[:, 0].contiguous()
            fn = lambda: da.flash_decode(q1, k, v, k_pos, qp1)             # noqa: E731
            want = ref.flash_decode_ref(q1, k, v, k_pos, qp1)[:, None]
        else:
            fn = lambda: va.flash_verify(q, k, v, k_pos, q_pos)            # noqa: E731
            want = ref.flash_verify_ref(q, k, v, k_pos, q_pos)
        out = fn().reshape(want.shape)
        check(bool(torch.isfinite(out).all()), f"{name} S={S}: non-finite output")
        err = float((out.float() - want).abs().max())
        check(err <= ATTN_RTOL * float(want.abs().max()), f"{name} S={S}: {err}")
        if T > 1:
            for t in range(T):
                row = da.flash_decode(q[:, t].contiguous(), k, v, k_pos,
                                      q_pos[:, t].contiguous())
                check(torch.equal(out[:, t], row), f"flash_verify S={S} row {t} differs")
        valid = k_pos[:, None, :] <= q_pos[:, :, None]
        mask = torch.where(valid, 0.0, -1e30).to(cfg.dtype)[:, None]    # (B, 1, T, S)
        n_b = 2 * k.numel() * k.element_size() + 2 * q.numel() * q.element_size() \
            + k_pos.numel() * 4 + q_pos.numel() * 4
        b, by = bound_ms(n_b, 4 * B * T * H * S * hd, attn_flops(k.dtype))
        row = {"ms": device_ms(fn, 10),
               "library_ms": device_ms(lambda: _sdpa(q, {"k": k, "v": v}, mask), 10),
               "bound_ms": b, "bound_by": by, "max_abs_err": err}
        rows[name] = row
        log(f"[check] {name} S={S} B={B} T={T} H={H} hd={hd} (one synthetic layer, all "
            f"keys live): max |err| {err:.3e}"
            + (f"; each of the {T} rows equal (torch.equal) to a flash_decode launch"
               if T > 1 else ""))
        log(f"[time] {name} S={S} B={B} T={T} H={H} hd={hd}, one launch: kernel "
            f"{row['ms']:.4f} ms on the device, sdpa {row['library_ms']:.4f} ms, bound "
            f"{b:.4f} ms ({by})")
        del k, v
    return rows


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


if __name__ == "__main__":
    try:
        code = main()
    finally:
        _stop_examples()
    sys.exit(code)
