"""Serving engine: prefill + token-by-token decode with sampling.

The JAX package's ``repro/serving/engine.py`` without the overlapped
``dispatch``/``await_result`` halves (they come with the overlapped schedule
in a later slice of the port).  :meth:`ServingEngine.generate` is the
host-blocking reference loop -- one decode call per token over the dense
ring cache -- and the token-exactness oracle of the continuous engine.

Sampling.  Greedy rows take the first maximum (``argmax``), the contract
shared with the JAX package.  Sampled rows draw Gumbel noise from a
counter-based hash of ``(seed, local step, vocab index)`` computed on the
device: one key per row per local step, the reference's
``fold_in(PRNGKey(seed), step)`` *schedule* without its threefry bits, so a
row's draw depends on nothing but its seed and how many tokens it has
emitted -- the same in ``generate`` and in any slot of the continuous
engine, and replayable.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.tenancy import resolve_devices
from repro_torch.models.model import ModelBundle, build_model, prepare_params
from repro_torch.models.transformer import tree_map
from repro_torch.obs.telemetry import Telemetry, get_telemetry

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (lowbias32) on int64 tensors holding
    values in [0, 2**32): bijective, so distinct counters stay distinct."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def sampling_noise(seeds: torch.Tensor, lsteps: torch.Tensor, vocab: int
                   ) -> torch.Tensor:
    """(B, vocab) standard Gumbel noise, a pure function of each row's
    ``(seed, local step)`` and the vocab index -- computed on the tensors'
    device, no generator state."""
    s = seeds.long()
    key = _mix32((s & _M32) ^ _mix32(((s >> 32) & _M32) + 0x9E3779B9))
    key = _mix32(key ^ _mix32((lsteps.long() & _M32) + 0x85EBCA6B))
    idx = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    u = _mix32(key[:, None] ^ _mix32((idx * 0x9E3779B1) & _M32))
    uf = ((u >> 8).double() + 0.5) * (1.0 / (1 << 24))      # (0, 1)
    return (-torch.log(-torch.log(uf))).float()


def sample_rows(logits: torch.Tensor, temps: torch.Tensor,
                topks: torch.Tensor, seeds: torch.Tensor,
                lsteps: torch.Tensor, *, all_greedy: bool = False,
                any_topk: bool = True) -> torch.Tensor:
    """Per-row sampling: greedy where ``temps <= 0``, else temperature
    (optionally top-k truncated) categorical with a per-row key.

    logits (B, V) float32; temps (B,) float; topks (B,) int (0 disables
    top-k); seeds (B,) int64; lsteps (B,) int -- the row's local step.
    Greedy rows ignore temperature and keys entirely, so they stay
    token-exact with ``generate`` whatever their neighbours sample.
    ``all_greedy`` / ``any_topk`` are strength hints the caller derives on
    the host from the live rows (the row-wise masks make them
    semantics-preserving): an all-greedy step is a bare argmax.  No host
    synchronisation."""
    greedy = torch.argmax(logits, dim=-1)
    if all_greedy:
        return greedy
    scaled = logits
    if any_topk:
        v = logits.shape[-1]
        srt = torch.sort(logits, dim=-1).values            # ascending
        kidx = torch.clamp(v - topks.long(), 0, v - 1)
        thresh = torch.gather(srt, 1, kidx[:, None])
        keep = (topks[:, None] <= 0) | (logits >= thresh)
        scaled = torch.where(keep, logits, float("-inf"))
    scaled = scaled / torch.clamp(temps.float(), min=1e-6)[:, None]
    sampled = torch.argmax(scaled + sampling_noise(seeds, lsteps,
                                                   logits.shape[-1]), dim=-1)
    return torch.where(temps > 0, sampled, greedy)


def resolve_extra_inputs(cfg: ArchConfig, req: Any) -> Dict[str, np.ndarray]:
    """Per-request non-token prefill inputs (encoder frames, vision patch
    embeds) from ``req.extra_inputs``.  The archs the port serves so far
    take none; encoder-decoder defaults come with slice 4."""
    return dict(getattr(req, "extra_inputs", None) or {})


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without holding the host: on CUDA the
    copy goes through pinned memory asynchronously on the current stream (a
    pageable copy would wait for everything queued before it)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray            # (B, steps)
    prefill_s: float
    decode_s: float
    steps: int

    @property
    def tokens_per_s(self) -> float:
        return self.tokens.size / max(self.decode_s, 1e-9)


class ServingEngine:
    """One model on one device: the parameters (cast once for compute),
    prefill and the blocking ``generate`` loop.  ``device=None`` is the
    CUDA device; the CPU runs only when named."""

    def __init__(self, cfg: ArchConfig, params: Any, temperature: float = 0.0,
                 device=None, telemetry: Optional[Telemetry] = None):
        self.device = resolve_devices(1, device)[0]    # raises: no card
        self.cfg = cfg
        self.tel = get_telemetry(telemetry)
        self.bundle: ModelBundle = build_model(cfg)
        self.params = prepare_params(
            cfg, tree_map(lambda a: a.to(self.device), params))
        self.temperature = temperature
        self.prefill_calls = 0
        self.decode_steps = 0

    # ------------------------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _make_batch(self, prompts: np.ndarray,
                    extra_inputs: Optional[Dict[str, Any]]
                    ) -> Dict[str, torch.Tensor]:
        if extra_inputs:
            raise NotImplementedError(
                "non-token prefill inputs (encoder frames, patch embeds) "
                "come with slice 4 of the port")
        return {"tokens": to_device(np.asarray(prompts, np.int32),
                                    self.device)}

    def prefill(self, batch: Dict[str, torch.Tensor]):
        """(last-token logits (B, V) float32, caches, cache index).  Rows
        are independent of their batch neighbours, so callers may batch
        several requests' padded prompts and slice the rows back out."""
        self.prefill_calls += 1
        with self.tel.span("engine.prefill",
                           batch=int(batch["tokens"].shape[0]),
                           seq=int(batch["tokens"].shape[1])):
            out = self.bundle.prefill_fn(self.params, batch)
        self.tel.count("engine.prefill_calls")
        return out

    def _sample(self, logits: torch.Tensor, seed: int, step: int
                ) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        b = logits.shape[0]
        dev = logits.device
        return sample_rows(
            logits, torch.full((b,), self.temperature, device=dev),
            torch.zeros((b,), dtype=torch.int32, device=dev),
            torch.full((b,), seed, dtype=torch.int64, device=dev),
            torch.full((b,), step, dtype=torch.int64, device=dev),
            any_topk=False)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new_tokens: int = 16,
                 extra_inputs: Optional[Dict[str, Any]] = None,
                 seed: int = 0) -> GenerationResult:
        """prompts: (B, S) int32.  Greedy/temperature sampling, one decode
        call per token (the host waits for every token)."""
        batch = self._make_batch(prompts, extra_inputs)
        self.decode_steps += int(max_new_tokens)
        t0 = time.perf_counter()
        logits, caches, idx = self.prefill(batch)
        self.sync()
        prefill_s = time.perf_counter() - t0
        out = []
        t0 = time.perf_counter()
        tok = self._sample(logits, seed, 0)
        for step in range(max_new_tokens):
            out.append(tok.cpu().numpy().astype(np.int32))
            logits, caches = self.bundle.decode_fn(self.params, tok[:, None],
                                                   caches, idx + step)
            tok = self._sample(logits, seed, step + 1)
        self.sync()
        t_done = time.perf_counter()
        decode_s = t_done - t0
        if self.tel.enabled:
            self.tel.record_span("engine.generate",
                                 t_done - prefill_s - decode_s, t_done,
                                 batch=int(prompts.shape[0]),
                                 steps=int(max_new_tokens))
            self.tel.count("engine.decode_steps", int(max_new_tokens))
        return GenerationResult(
            np.stack(out, axis=1) if out else np.zeros(
                (prompts.shape[0], 0), np.int32),
            prefill_s, decode_s, max_new_tokens)
