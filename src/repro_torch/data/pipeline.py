"""Deterministic synthetic token pipeline with multi-host shard semantics.

A copy of the JAX package's ``data/pipeline.py`` (numpy only): the port keeps
its own so that nothing of the JAX package is imported.  It yields numpy
batches; the trainer moves them to the device.

Index math is stateless: batch ``step`` for host ``h`` of ``H`` is a pure
function of (seed, step, h, H).  That is what makes elastic restart and
straggler re-balance exact — any host can recompute any other host's shard
after a re-mesh, so no sample is dropped or duplicated (see
runtime/fault_tolerance.py).  A real deployment swaps `_synth_tokens` for a
tokenized corpus reader with the same indexing contract.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import InputShape, ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    host_index: int = 0
    host_count: int = 1
    prefetch: int = 2


def _rng_for(seed: int, step: int, sample: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, sample]))


def _synth_tokens(seed: int, step: int, sample: int, seq: int, vocab: int) -> np.ndarray:
    """A learnable synthetic language: Markov-ish integer sequences."""
    rng = _rng_for(seed, step, sample)
    start = rng.integers(0, vocab)
    stride = rng.integers(1, 7)
    toks = (start + stride * np.arange(seq + 1)) % vocab
    noise = rng.random(seq + 1) < 0.05
    toks = np.where(noise, rng.integers(0, vocab, seq + 1), toks)
    return toks.astype(np.int32)


class Pipeline:
    """Host-sharded, prefetching batch iterator."""

    def __init__(self, cfg: ModelConfig, shape: InputShape, dc: DataConfig = DataConfig()):
        self.cfg, self.shape, self.dc = cfg, shape, dc
        if shape.global_batch % dc.host_count:
            raise ValueError(
                f"global batch {shape.global_batch} does not split over {dc.host_count} hosts"
            )
        self.local_batch = shape.global_batch // dc.host_count
        self._q: "queue.Queue" = queue.Queue(maxsize=dc.prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- stateless batch construction -------------------------------------------
    def batch_at(self, step: int, host_index: Optional[int] = None) -> Dict[str, np.ndarray]:
        h = self.dc.host_index if host_index is None else host_index
        seq, vocab = self.shape.seq_len, self.cfg.vocab_size
        base = step * self.shape.global_batch + h * self.local_batch
        toks = np.stack(
            [
                _synth_tokens(self.dc.seed, step, base + i, seq, vocab)
                for i in range(self.local_batch)
            ]
        )
        # labels[t] is the id of position t; the loss shifts internally
        # (logits[:, :-1] vs labels[:, 1:]), so labels == input ids.
        inputs = labels = toks[:, :-1]
        if self.cfg.input_kind == "embeddings":
            # stub modality frontend: deterministic embedding of token ids
            rng = _rng_for(self.dc.seed, 0, 0)
            proj = rng.standard_normal((1, self.cfg.d_model)).astype(np.float32)
            inputs = (inputs[..., None] % 256).astype(np.float32) / 256.0 * proj
        if self.cfg.pos_kind == "mrope":
            pos = np.broadcast_to(
                np.arange(seq, dtype=np.int32)[None, None, :],
                (self.local_batch, 3, seq),
            ).copy()
        else:
            pos = np.broadcast_to(
                np.arange(seq, dtype=np.int32)[None, :], (self.local_batch, seq)
            ).copy()
        return {"inputs": inputs, "labels": labels, "positions": pos}

    # -- prefetching iterator -------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iterate(start_step=0)

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        self._stop.clear()

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._q.put(self.batch_at(step), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        try:
            while True:
                yield self._q.get()
        finally:
            self._stop.set()

    def close(self):
        self._stop.set()
