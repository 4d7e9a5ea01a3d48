"""Synthetic token pipeline: counterpart of ``repro/data/tokens.py``, in
numpy, with the same draws in the same order, so both packages yield the
same batches bit for bit from one seed.

Stands in for a real corpus: a mixture of Zipf-distributed unigrams and
repeated n-gram motifs, so a language model has structure to learn.
Each host draws only its own shard (seeded by host id), and a producer
thread fills a bounded prefetch queue, which decouples generation from
the step time. Closing the generator (``close()``, or the end of a
``with contextlib.closing(...)`` block) stops and joins the thread.

One quirk of the reference is not copied: its producer drops a batch it
could not queue within a second and draws the next, so a consumer slower
than that sees another stream. The port's producer keeps the batch until
it is queued, so the stream is the reference's whenever the reference
drops none, and never depends on the consumer's pace.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.lm.config import LMConfig

__all__ = ["synthetic_token_batches", "PRODUCER_THREAD"]

# the producer threads' name, which tests look for after a close
PRODUCER_THREAD = "synthetic-token-producer"


def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -alpha
    return p / p.sum()


def synthetic_token_batches(cfg: LMConfig, batch: int, seq: int,
                            seed: int = 0, host_id: int = 0,
                            prefetch: int = 2
                            ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields ``{"tokens" or "embeds", "labels"}`` numpy batches forever:
    tokens and labels (batch, seq) int32, embeds (batch, seq, d_model)
    float32 for the embedding frontends (the tokens looked up in a fixed
    N(0, 0.02^2) table from numpy seed 42, made once per iterator; the
    reference makes the same table for every batch)."""
    rng = np.random.default_rng(seed * 1000003 + host_id)
    probs = _zipf_probs(cfg.vocab)
    motifs = [rng.integers(0, cfg.vocab, size=rng.integers(4, 12))
              for _ in range(32)]
    table = None
    if cfg.frontend != "token":
        table = np.random.default_rng(42).standard_normal(
            (cfg.vocab, cfg.d_model)).astype(np.float32) * 0.02

    def make_batch():
        toks = rng.choice(cfg.vocab, size=(batch, seq + 1), p=probs)
        # splice in motifs: repeated structure = learnable signal
        for b in range(batch):
            pos = 0
            while pos < seq:
                if rng.random() < 0.5:
                    m = motifs[rng.integers(0, len(motifs))]
                    end = min(pos + len(m), seq + 1)
                    toks[b, pos:end] = m[:end - pos]
                    pos = end
                else:
                    pos += rng.integers(2, 8)
        batch_d = {"labels": toks[:, 1:].astype(np.int32)}
        if table is None:
            batch_d["tokens"] = toks[:, :-1].astype(np.int32)
        else:
            batch_d["embeds"] = table[toks[:, :-1]]
        return batch_d

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        while not stop.is_set():
            item = make_batch()
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=producer, name=PRODUCER_THREAD, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
        t.join()
