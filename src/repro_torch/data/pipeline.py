"""Deterministic sharded data pipeline (numpy only).

Port of ``repro.data.pipeline``, the port's own copy: the same numpy
generators in the same order, so a batch is bit-equal to the reference's
for the same seed and step.

  SyntheticCorpus     reproducible token stream (per-document PRNG with a
                      Zipfian unigram mixture — enough structure that a ~100M
                      model's loss visibly drops within a few hundred steps).
  PackedLoader        packs documents into fixed (B, S) token/label batches,
                      shards the batch across hosts by process index,
                      supports exact resume (skip to step N), and prefetches
                      on a background thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["SyntheticCorpus", "PackedLoader"]


class SyntheticCorpus:
    """Infinite deterministic document stream.

    Documents are drawn from per-document PRNGs seeded by (seed, doc_id), so
    any document is reconstructable independently — the property sharded
    loaders and exact resume rely on. Tokens follow a Zipf distribution with
    short-range repetition structure (a copy-prev channel) so next-token
    prediction is learnable.
    """

    def __init__(self, vocab: int, *, seed: int = 0, mean_len: int = 512):
        self.vocab = vocab
        self.seed = seed
        self.mean_len = mean_len
        base = np.arange(1, vocab + 1, dtype=np.float64)
        self._probs = (1.0 / base ** 1.1)
        self._probs /= self._probs.sum()

    def document(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 32) ^ doc_id)
        n = max(int(rng.exponential(self.mean_len)), 16)
        toks = rng.choice(self.vocab, size=n, p=self._probs)
        # repetition structure: 25% of positions copy 1-4 tokens back
        copy = rng.random(n) < 0.25
        lag = rng.integers(1, 5, n)
        idx = np.arange(n) - lag
        copied = toks[np.clip(idx, 0, None)]
        return np.where(copy & (idx >= 0), copied, toks).astype(np.int32)


class PackedLoader:
    """Fixed-shape (B, S) batches over a corpus, host-sharded + prefetched.

    Batch b at global step t packs documents (greedy concatenation with
    separator token 0); labels are next-token shifted with -1 at padding.
    ``process_index``/``process_count`` split the *global* batch rows so each
    host materializes only its slice (the standard multi-host pattern).
    ``start_step`` resumes exactly: document cursors are a pure function of
    the step index.
    """

    def __init__(self, corpus: SyntheticCorpus, *, global_batch: int,
                 seq_len: int, process_index: int = 0, process_count: int = 1,
                 start_step: int = 0, prefetch: int = 2):
        assert global_batch % process_count == 0
        self.corpus = corpus
        self.global_batch = global_batch
        self.local_batch = global_batch // process_count
        self.seq_len = seq_len
        self.process_index = process_index
        self.process_count = process_count
        self.step = start_step
        self.prefetch = prefetch
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # one document stream per global row; docs consumed round-robin by step
    def _row_tokens(self, row: int, step: int) -> np.ndarray:
        need = self.seq_len + 1
        out = np.empty(0, np.int32)
        d = 0
        while out.size < need:
            doc = self.corpus.document(((step * self.global_batch + row) << 8) + d)
            out = np.concatenate([out, doc[: need - out.size],
                                  np.zeros(1, np.int32)])[:need + 1]
            d += 1
        return out[:need]

    def _make_batch(self, step: int) -> dict:
        rows = range(self.process_index * self.local_batch,
                     (self.process_index + 1) * self.local_batch)
        packed = np.stack([self._row_tokens(r, step) for r in rows])
        return {"tokens": packed[:, :-1].astype(np.int32),
                "labels": packed[:, 1:].astype(np.int32)}

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._make_batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict]:
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        try:
            while True:
                step, batch = self._q.get()
                self.step = step + 1
                yield batch
        finally:
            self._stop.set()

    def close(self):
        self._stop.set()
