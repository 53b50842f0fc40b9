"""Synthetic-but-learnable data pipeline.

A deterministic token stream with real structure (an order-2 Markov chain
plus copy motifs) so small models visibly learn (loss drops well below
ln(V)) in a few hundred CPU steps — the end-to-end training example and
the Table-II accuracy reproduction need a learnable task, not noise.

The pipeline is sharded: each data-parallel host slices its own batch
rows by process index (multi-host layout), double-buffers via a
background thread, and is fully deterministic given (seed, step).
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 8
    n_motifs: int = 64


class MarkovMotifDataset:
    """Order-2 Markov chain over a small state set, interleaved with
    repeated motifs: next-token prediction has both local (bigram) and
    copy (motif) structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        k = min(cfg.vocab, 256)
        self._k = k
        # sparse row-stochastic transitions: each (a,b) allows 4 successors
        self._succ = rng.integers(0, k, size=(k, k, 4))
        self._motifs = rng.integers(0, k, size=(cfg.n_motifs, cfg.motif_len))

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        out = np.empty((B, S + 1), np.int64)
        a = rng.integers(0, self._k, size=B)
        b = rng.integers(0, self._k, size=B)
        out[:, 0] = a
        out[:, 1] = b
        t = 2
        while t < S + 1:
            if rng.random() < 0.15:  # motif insertion
                m = self._motifs[rng.integers(0, cfg.n_motifs, size=B)]
                L = min(cfg.motif_len, S + 1 - t)
                out[:, t : t + L] = m[:, :L]
                t += L
                a, b = out[:, t - 2], out[:, t - 1]
            else:
                c = self._succ[a, b, rng.integers(0, 4, size=B)]
                out[:, t] = c
                a, b = b, c
                t += 1
        return {
            "tokens": out[:, :S].astype(np.int32),
            "labels": out[:, 1:].astype(np.int32),
        }


class Prefetcher:
    """Background-thread double buffering."""

    def __init__(self, dataset: MarkovMotifDataset, start_step: int = 0, depth: int = 2):
        self._ds = dataset
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = self._ds.batch(self._step)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()
