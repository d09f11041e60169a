"""Deterministic synthetic token pipeline with staged prefetch.

The JAX package's ``repro/data/tokens.py``.  There is no corpus: the stream
is a stationary Zipf-ish token stream synthesised from ``(seed, step)`` so
loss curves are reproducible and restart-consistent (resuming at step k
regenerates exactly batch k).  :func:`synth_batch` is the reference's,
numpy for numpy, so its batches are byte-identical to the reference's.

:class:`PrefetchFeed` is the training side of the paper's sequential
staging: a producer thread builds batch k+1 while step k computes, copies
it into pinned host memory and enqueues its host->device copy through a
sequential :class:`repro_torch.core.transfer.StagingEngine` (one copy
stream that waits for nothing, ending in a CUDA event).  The consumer's
stream waits on that event and the staged tensors are marked as used there
(``record_stream``), the pattern of
:meth:`repro_torch.serving.swap.HostSwapStore.fetch`: no host
synchronisation.  On the CPU a batch is handed over as it is.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.tenancy import (TenancyConfig, TenantTask,
                                      VirtualDevicePool)
from repro_torch.core.transfer import StagingEngine, tree_map


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0


def synth_batch(dc: DataConfig, step: int, cfg: Optional[ArchConfig] = None,
                ) -> Dict[str, np.ndarray]:
    """Batch for one step, deterministic in (seed, step)."""
    rng = np.random.default_rng(np.random.SeedSequence([dc.seed, step]))
    # Zipf-ish marginal with local repetition structure (so loss can fall)
    base = rng.zipf(1.3, size=(dc.global_batch, dc.seq_len + 1))
    toks = (base % (dc.vocab_size - 2)) + 1
    # inject copy structure: second half repeats first half for 25% of rows
    rep = rng.random(dc.global_batch) < 0.25
    half = (dc.seq_len + 1) // 2
    toks[rep, half:2 * half] = toks[rep, :half]
    toks = toks.astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg is not None and cfg.num_patches:
        out["patch_embeds"] = rng.standard_normal(
            (dc.global_batch, cfg.num_patches, 1024)).astype(np.float32)
    if cfg is not None and cfg.enc_dec:
        out["frames"] = rng.standard_normal(
            (dc.global_batch, cfg.encoder_seq_len, cfg.d_model)
        ).astype(np.float32)
    return out


class PrefetchFeed:
    """Background producer staging batch k+1 while step k computes.

    ``device`` (default the CPU) is where batches land; ``depth`` batches
    may be staged ahead; ``start_step`` is the first step's index.
    ``wait_s`` sums the seconds :meth:`__next__` spent waiting for the
    producer (the feed's cost to the step loop)."""

    def __init__(self, dc: DataConfig, cfg: Optional[ArchConfig] = None,
                 device=None, depth: int = 2, start_step: int = 0):
        self.dc, self.cfg = dc, cfg
        self.device = torch.device(device if device is not None else "cpu")
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.staging = StagingEngine(
            VirtualDevicePool(TenancyConfig(1, 1, "sequential"),
                              devices=[self.device]))
        self.wait_s = 0.0
        self._step = start_step
        self._stop = threading.Event()
        self._failed: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _stage(self, step: int):
        host = {k: torch.from_numpy(v)
                for k, v in synth_batch(self.dc, step, self.cfg).items()}
        if self.device.type == "cuda":
            host = {k: t.pin_memory() for k, t in host.items()}
        task = TenantTask(vdev=0, pdev=0, slot=0, start=step, stop=step + 1)
        return self.staging.put(task, host)

    def _producer(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while not self._stop.is_set():
                self._offer(self._stage(self._step))
                self._step += 1
        except BaseException as e:        # handed to the consumer
            self._failed = e
            self._offer(None)

    def _offer(self, item) -> None:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        chunk = self.q.get()
        self.wait_s += time.perf_counter() - t0
        if chunk is None:
            raise RuntimeError("prefetch producer failed") from self._failed
        if chunk.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(chunk.event)
            tree_map(lambda t: t.record_stream(stream), chunk.arrays)
        return chunk.arrays

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)
