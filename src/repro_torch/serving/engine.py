"""Serving engine: prefill + token-by-token decode with sampling.

The JAX package's ``repro/serving/engine.py``.  Two generation paths share
one sampling schedule:

* :meth:`ServingEngine.generate` -- the host-blocking reference loop: one
  decode call per token over the dense ring cache, each token brought to
  the host.  The A/B baseline of the slot schedules and the exactness
  oracle of the continuous engine.
* :meth:`ServingEngine.dispatch` / :meth:`ServingEngine.await_result` -- the
  split halves.  ``dispatch`` enqueues the prefill and the whole decode
  loop, ``steps`` tokens, and returns a :class:`PendingGeneration` without
  waiting; ``await_result`` waits for the handle and returns its tokens
  with the prefill and decode times.  Between the two the host is free to
  stage the next tenant's batch under this one's decode.  On a CUDA device
  the decode loop is one CUDA graph per key (:class:`DecodeProgram`, the
  reference's jitted ``lax.scan`` loop), captured at the key's first
  dispatch and replayed at every later one on a stream the engine owns,
  behind a prefill on a second one; on the CPU the same loop runs eagerly
  and the handle is complete when ``dispatch`` returns.

An encoder-decoder arch's prefill returns ``{"self", "cross"}`` caches (the
decoder's self-attention ring and every decoder layer's cross K/V of the
encoder's output); both paths thread them as any cache tree: ``generate``
decodes from them, and a captured decode loop copies both into its static
inputs.

Sampling.  Greedy rows take the first maximum (``argmax``), the contract
shared with the JAX package.  Sampled rows draw Gumbel noise from a
counter-based hash of ``(seed, local step, vocab index)`` computed on the
device: one key per row per local step, the reference's
``fold_in(PRNGKey(seed), step)`` *schedule* without its threefry bits, so a
row's draw depends on nothing but its seed and how many tokens it has
emitted -- the same in ``generate``, in ``dispatch`` and in any slot of the
continuous engine, and replayable.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ATTN, ArchConfig
from repro_torch.core.tenancy import resolve_devices
from repro_torch.distributed.sharding import (Sharder, ShardedTensor,
                                              null_sharder, param_shardings)
from repro_torch.kernels import ops as kops
from repro_torch.models.model import ModelBundle, build_model, prepare_params
from repro_torch.models.transformer import tree_map, tree_map2
from repro_torch.obs.telemetry import Telemetry, get_telemetry
from repro_torch.serving import kvcache

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
    embeds), resolved from ``req.extra_inputs`` with per-arch defaults.

    Encoder-decoder archs cannot prefill without ``frames``, so a request
    that carries none gets deterministic zero frames -- the *same* default
    on every path (blocking batch build, continuous admission).  Arrays are
    per-request (no batch axis); batching paths stack them."""
    extra = dict(getattr(req, "extra_inputs", None) or {})
    if cfg.enc_dec and "frames" not in extra:
        extra["frames"] = np.zeros((cfg.encoder_seq_len, cfg.d_model),
                                   np.float32)
    return extra


def extras_to_device(extra: Dict[str, Any], device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    """A batch's stacked non-token prefill inputs on the device.  Patch
    embeddings are merged by a vision arch's prefill and encoder frames
    encoded by an encoder-decoder's; an arch that takes neither ignores
    them, as the reference's prefill does."""
    return {k: to_device(np.asarray(v), device) for k, v in extra.items()}


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without holding the host: on CUDA the
    copy goes through pinned memory asynchronously on the current stream (a
    pageable copy would wait for everything queued before it)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _clone(t):
    """A tensor's copy; a placed one's shards copied on their devices."""
    return t.map(torch.clone) if isinstance(t, ShardedTensor) else t.clone()


def _copy_into(dst, src) -> None:
    """``src`` written into ``dst`` in place, shard by shard when placed
    (both laid out by one spec)."""
    if isinstance(dst, ShardedTensor):
        for (_, d, _), (_, t, _) in zip(dst.unique(), src.unique()):
            d.copy_(t)
    else:
        dst.copy_(src)


def _storages(t) -> List[torch.Tensor]:
    return [x for _, x, _ in t.unique()] if isinstance(t, ShardedTensor) \
        else [t]


def place_caches(sh: Sharder, axes: Any, caches: Any) -> Any:
    """The prefill's caches laid out on ``sh``'s mesh by their logical
    ``axes`` (``bundle.cache_axes()``, resolved by ``param_shardings``):
    under the serving rules K/V (and the cross K/V) split on KV heads as
    :class:`ShardedTensor`; a leaf its spec leaves whole -- the positions,
    the SSM states, K/V whose heads the "model" extent does not divide --
    stays the global tensor on the mesh's first device.  No mesh: the
    caches as they are."""
    if sh.mesh is None:
        return caches

    def put(x, named):
        if named is None or all(e is None for e in named.spec):
            return x
        return sh.place_named(x, named)
    return tree_map2(put, caches, param_shardings(sh, axes, caches))


def _on_stream(stream):
    """``torch.cuda.stream(stream)``; no change of stream for None (the
    CPU)."""
    return contextlib.nullcontext() if stream is None else \
        torch.cuda.stream(stream)


class CudaGraphs:
    """What a graph program (:class:`DecodeProgram`, the continuous
    engine's ``RoundProgram``) needs of one CUDA device: a stream and a
    graph memory pool that live as long as their owner, eager work on that
    stream, capture, and the buffers a capture read besides its owner's
    state.

    Captures are ``"thread_local"``: only the capturing thread is barred
    from unsafe CUDA calls meanwhile, since both owners' schedulers keep a
    completion-waiter thread that may be blocked on an earlier launch's
    event during a capture (``"global"`` would invalidate the capture)."""

    def __init__(self, device: torch.device):
        self.device = device
        with torch.cuda.device(device):
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()

    def run_beside(self, fn) -> None:
        """``fn()`` eagerly on the capture stream, after everything enqueued
        on the current stream and before anything enqueued on it later."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            fn()
        cur.wait_stream(self.stream)

    def capture(self, fn) -> "torch.cuda.CUDAGraph":
        """``fn``'s launches captured, not run, into a new graph (entering
        the capture synchronises the device).

        PyTorch keeps a cuBLAS workspace per (handle, stream) until its
        cache is cleared.  Cleared before the capture, the graph's GEMMs
        get theirs from the graph's own pool, so no later clearing can free
        memory a graph reads outside it; cleared after, no cache entry
        holds a block of the pool, which then goes with the owner."""
        graph = torch.cuda.CUDAGraph()
        torch._C._cuda_clearCublasWorkspaces()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            fn()
        torch._C._cuda_clearCublasWorkspaces()
        return graph

    def take_held(self) -> List[Any]:
        """The paged decode kernel's scratch of the capture stream, taken
        out of its cache for the graph that captured it."""
        sc = kops.detach_decode_scratch(self.device, self.stream.cuda_stream)
        return [] if sc is None else [sc]


def capture_counted(backend, fn) -> Tuple[Any, List[Dict[str, int]], float]:
    """``backend.capture(fn)`` with the kernel counts it added taken back
    out: a wrapper counts when its Python runs, so a capture counts the
    launches it only recorded.  Returns (graph, the counts one replay adds,
    host ms of the capture)."""
    before = [dict(c) for c in kops.counters()]
    t0 = time.perf_counter()
    graph = backend.capture(fn)
    capture_ms = (time.perf_counter() - t0) * 1e3
    added = []
    for counts, old in zip(kops.counters(), before):
        add = {k: n - old.get(k, 0) for k, n in counts.items()
               if n != old.get(k, 0)}
        for k, n in add.items():
            counts[k] -= n               # counted per replay instead
        added.append(add)
    return graph, added, capture_ms


def count_replay(added: List[Dict[str, int]]) -> None:
    """Add one replay's kernel counts (``capture_counted``'s second
    result)."""
    for counts, add in zip(kops.counters(), added):
        for k, n in add.items():
            counts[k] += n


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray            # (B, steps)
    prefill_s: float
    decode_s: float
    steps: int
    # CUDA events (start, prefill done, decode done) on the stream the work
    # ran on; None on the CPU
    events: Optional[Tuple[Any, Any, Any]] = None

    @property
    def tokens_per_s(self) -> float:
        return self.tokens.size / max(self.decode_s, 1e-9)


@dataclasses.dataclass
class PendingGeneration:
    """Handle of an in-flight generation: the prefill and the decode loop
    are enqueued, nothing here waits.

    ``tokens`` is this handle's own (B, steps) int32 host tensor (pinned on
    a CUDA device), filled by a copy enqueued behind the loop: a later
    dispatch replaying the same graph rewrites the graph's buffer, never
    this one.  ``prefilled`` and ``done`` are CUDA events after the prefill
    and after that copy (None on the CPU, where the work has finished when
    ``dispatch`` returns).  Timestamps are absolute ``perf_counter``
    values."""
    tokens: torch.Tensor
    steps: int
    t_start: float                # dispatch() entry
    t_dispatched: float           # dispatch() return (host enqueue cost end)
    start: Any = None             # CUDA event before the prefill
    prefilled: Any = None
    done: Any = None

    def ready(self) -> bool:
        """Non-blocking probe: has the decode loop finished?  A CUDA event
        query; work on the CPU has finished when dispatch returns."""
        return True if self.done is None else bool(self.done.query())


# a decode loop's key: (batch, prompt length -- None for an arch without
# attention, whose loop reads no position --, steps, sampling), sampling
# ("scalar", greedy) or ("rows", all_greedy, any_topk)
DecodeKey = Tuple[int, Optional[int], int, Tuple]


@dataclasses.dataclass
class CapturedLoop:
    """One key's decode loop as a graph: it reads the prefill's logits and
    caches and the sampling rows from ``inputs`` and writes ``tokens``."""
    graph: Any                     # replay() enqueues the loop
    inputs: Dict[str, Any]         # logits, caches, temps, topks, seeds
    tokens: torch.Tensor           # (B, steps) int32
    counts: List[Dict[str, int]]   # kernel counts one replay adds
    held: List[Any]                # buffers it reads besides ``inputs``
    capture_ms: float              # host time of the capture
    replays: int = 0


class DecodeProgram:
    """The decode loop, one graph per :data:`DecodeKey`, replayed at every
    later dispatch of the key: the port's counterpart of the reference's
    jitted ``_decode_loop`` / ``_decode_loop_rows``.

    A key's first dispatch runs the loop eagerly on the backend's stream --
    real work with real results, reading static copies of its prefill's
    outputs -- and then captures the same loop into the key's graph.  A
    later dispatch copies its prefill's logits and caches and its sampling
    rows into the key's static inputs and replays the graph; stream order
    keeps a second in-flight batch of the same key behind the first one's
    replay.  Capture runs the wrappers' Python, not their kernels, so the
    counts it added move to the replays.  Nothing falls back to an eager
    loop: a failed capture or replay raises.

    At most ``max_loops`` keys are held, least recently dispatched dropped
    first (a tenant's last, smaller batch is a new key, and each key holds
    its static caches: 0.54 GB for olmoe at B 4, S 1024): a dropped loop's
    graph and buffers are kept until an event recorded after its last
    replay has passed, then released.  ``backend`` is :class:`CudaGraphs`
    on the card (a test gives a stub)."""

    max_loops = 8

    def __init__(self, backend):
        self.backend = backend
        self.loops: "collections.OrderedDict[DecodeKey, CapturedLoop]" = \
            collections.OrderedDict()
        self.dropped = 0
        self._retired: List[Tuple[Any, CapturedLoop]] = []

    def run(self, eng: "ServingEngine", key: DecodeKey,
            inputs: Dict[str, Any], idx: int) -> torch.Tensor:
        """Enqueue ``eng``'s decode loop for ``key`` on ``inputs`` on the
        current stream (the backend's, on the card); returns the (static)
        buffer its tokens land in."""
        self._retired = [(ev, cap) for ev, cap in self._retired
                         if ev is not None and not ev.query()]
        cap = self.loops.get(key)
        if cap is None:
            return self._first(eng, key, inputs, idx)
        self.loops.move_to_end(key)
        tree_map2(_copy_into, cap.inputs, inputs)
        cap.graph.replay()
        cap.replays += 1
        count_replay(cap.counts)
        return cap.tokens

    def _first(self, eng: "ServingEngine", key: DecodeKey,
               inputs: Dict[str, Any], idx: int) -> torch.Tensor:
        # on a mesh every shard's cache storage is the loop's, written in
        # place by each replay, for as long as the loop is held
        static = tree_map(_clone, inputs)
        b, _, steps, sampling = key
        tokens = torch.empty((b, steps), dtype=torch.int32,
                             device=eng.device)

        def enqueue():
            eng._enqueue_loop(static, idx, tokens, sampling)

        self.backend.run_beside(enqueue)
        graph, added, capture_ms = capture_counted(self.backend, enqueue)
        self.loops[key] = CapturedLoop(graph, static, tokens, added,
                                       self.backend.take_held(), capture_ms)
        while len(self.loops) > self.max_loops:
            _, old = self.loops.popitem(last=False)
            self._retired.append((eng._event(), old))
            self.dropped += 1
        return tokens




class ServingEngine:
    """One model on one device: the parameters (cast once for compute),
    prefill, the blocking ``generate`` loop and the split
    ``dispatch``/``await_result`` halves.  ``device=None`` is the CUDA
    device; the CPU runs only when named.

    ``sh`` (a :func:`repro_torch.distributed.sharding.serving_sharder` on a
    mesh) places the weights replicated on the mesh -- kept once, on the
    mesh's first device, which becomes the engine's device, by the one
    controller that runs every replicated computation.  The slot paths
    (``generate``, ``dispatch``) lay each prefill's dense caches out by
    ``bundle.cache_axes()`` (K/V split on KV heads) and decode a shard at a
    time; a :class:`repro_torch.serving.continuous.ContinuousBatchingEngine`
    built on this engine splits its KV pools over the mesh."""

    def __init__(self, cfg: ArchConfig, params: Any, temperature: float = 0.0,
                 device=None, telemetry: Optional[Telemetry] = None,
                 sh: Optional[Sharder] = None):
        self.sh = sh or null_sharder()
        if self.sh.mesh is not None:
            # serving splits the KV pools along heads, never the weights:
            # the one controller keeps them once, on the mesh's first device
            first = self.sh.mesh.position_devices()[0]
            if device is not None and resolve_devices(1, device)[0] != first:
                raise ValueError(f"device {device}: the mesh's first device "
                                 f"is {first}")
            device = first
        self.device = resolve_devices(1, device)[0]    # raises: no card
        self.cfg = cfg
        self.tel = get_telemetry(telemetry)
        self.bundle: ModelBundle = build_model(cfg)
        self.params = prepare_params(
            cfg, tree_map(lambda a: a.to(self.device), params))
        self.temperature = temperature
        self.prefill_calls = 0
        self.decode_steps = 0
        # the dense decode reads its position as a Python int, so a loop
        # over attention is captured per prompt length
        self._positions_in_key = any(
            mixer == ATTN for mixer, _ in cfg.block_schedule())
        # first uses of a decode-loop key: the reference counts its
        # _decode_loop / _decode_loop_rows traces
        self._loop_keys: set = set()
        # the decode loop as graphs on a CUDA device, made at the first
        # dispatch with the two streams the engine's dispatches run on for
        # its life (the program's, and the prefill's); the CPU runs the
        # loop eagerly (a test may set a program)
        self.decode_program: Optional[DecodeProgram] = None
        self._prefill_stream = None

    # ------------------------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _event(self):
        """A timing CUDA event recorded on the current stream (None on the
        CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def state_kinds(self):
        """The per-request state kinds this arch's serving rows carry
        (:func:`repro_torch.serving.kvcache.state_kinds`): the capability
        probe ``supported_modes`` and ``launch.serve --list-archs`` read."""
        return kvcache.state_kinds(self.cfg)

    def _make_batch(self, prompts: np.ndarray,
                    extra_inputs: Optional[Dict[str, Any]]
                    ) -> Dict[str, torch.Tensor]:
        return {"tokens": to_device(np.asarray(prompts, np.int32),
                                    self.device),
                **extras_to_device(extra_inputs or {}, self.device)}

    def prefill(self, batch: Dict[str, torch.Tensor]):
        """(last-token logits (B, V) float32, caches, cache index).  Rows
        are independent of their batch neighbours, so callers may batch
        several requests' padded prompts and slice the rows back out."""
        self.prefill_calls += 1
        with self.tel.span("engine.prefill",
                           batch=int(batch["tokens"].shape[0]),
                           seq=int(batch["tokens"].shape[1])):
            logits, caches, idx = self.bundle.prefill_fn(self.params, batch)
        # on a mesh the decode reads the caches laid out once, here
        return logits, place_caches(self.sh, self.bundle.cache_axes(),
                                    caches), idx

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
        start = self._event()
        logits, caches, idx = self.prefill(batch)
        prefilled = self._event()
        self.sync()
        prefill_s = time.perf_counter() - t0
        out = []
        t0 = time.perf_counter()
        tok = self._sample(logits, seed, 0)
        for step in range(max_new_tokens):
            out.append(tok.cpu().numpy().astype(np.int32))
            logits, caches = self.bundle.decode_fn(self.params, tok[:, None],
                                                   caches, idx + step,
                                                   self.sh)
            tok = self._sample(logits, seed, step + 1)
        done = self._event()
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
            prefill_s, decode_s, max_new_tokens,
            None if start is None else (start, prefilled, done))

    # ------------------------------------------------------------------
    # split path: dispatch (enqueue, never waits) / await (materialise)
    # ------------------------------------------------------------------
    def _enqueue_loop(self, inputs: Dict[str, Any], idx: int,
                      tokens: torch.Tensor, sampling: Tuple) -> None:
        """The decode loop, op by op, on the current stream: token ``i``
        sampled from logits ``i`` with local step ``i``, written to
        ``tokens[:, i]`` and decoded into logits ``i + 1`` -- ``generate``'s
        schedule, its last decode included.  ``inputs``' caches are
        updated in place.  No host synchronisation: what a program
        captures."""
        logits, caches = inputs["logits"], inputs["caches"]
        b = logits.shape[0]
        for i in range(tokens.shape[1]):
            if sampling == ("scalar", True):
                tok = torch.argmax(logits, dim=-1)
            else:
                all_greedy, any_topk = ((False, False)
                                        if sampling[0] == "scalar"
                                        else sampling[1:])
                tok = sample_rows(
                    logits, inputs["temps"], inputs["topks"],
                    inputs["seeds"],
                    torch.full((b,), i, dtype=torch.int64,
                               device=logits.device),
                    all_greedy=all_greedy, any_topk=any_topk)
            tokens[:, i].copy_(tok)
            logits, caches = self.bundle.decode_fn(self.params, tok[:, None],
                                                   caches, idx + i, self.sh)

    def _sampling_rows(self, b: int, seed: int, temperatures, top_ks,
                       seeds) -> Tuple[Tuple, Dict[str, torch.Tensor]]:
        """(sampling key part, device rows temps / topks / seeds): the
        engine's scalar temperature and seed unless any per-request array
        is given (the reference's ``_decode_loop`` and
        ``_decode_loop_rows``)."""
        dev = self.device
        if temperatures is None and top_ks is None and seeds is None:
            return (("scalar", self.temperature <= 0.0), {
                "temps": torch.full((b,), self.temperature,
                                    dtype=torch.float32, device=dev),
                "topks": torch.zeros((b,), dtype=torch.int32, device=dev),
                "seeds": torch.full((b,), seed, dtype=torch.int64,
                                    device=dev)})
        temps = (np.full(b, self.temperature, np.float32)
                 if temperatures is None
                 else np.asarray(temperatures, np.float32))
        topks = (np.zeros(b, np.int32) if top_ks is None
                 else np.asarray(top_ks, np.int32))
        seed_arr = (np.full(b, seed, np.int64) if seeds is None
                    else np.asarray(seeds, np.int64))
        return (("rows", bool((temps <= 0).all()), bool((topks > 0).any())),
                {"temps": to_device(temps, dev),
                 "topks": to_device(topks, dev),
                 "seeds": to_device(seed_arr, dev)})

    @torch.no_grad()
    def dispatch(self, prompts: np.ndarray, max_new_tokens: int = 16,
                 extra_inputs: Optional[Dict[str, Any]] = None,
                 seed: int = 0, temperatures: Optional[Any] = None,
                 top_ks: Optional[Any] = None,
                 seeds: Optional[Any] = None) -> PendingGeneration:
        """Enqueue the prefill and the whole decode loop; never waits on the
        device, so the caller can stage other work under it.

        ``temperatures`` / ``top_ks`` / ``seeds`` (each (B,), any one
        optional) switch the loop to per-request sampling rows; left None,
        the engine's scalar temperature and ``seed`` sample every row, as
        ``generate`` does (token-exact with it).

        On a CUDA device the prefill runs on a stream of its own and the
        loop (static-input copies, replay, tokens out) on the program's
        stream, behind this prefill and every earlier loop.  A replayed
        loop holds its stream's launch queue until it has nearly run, and
        so would any stream waiting on it: a prefill enqueued behind a slot
        there held the host for most of the slot
        (``diagnostics/slot_dispatch.py``).  On the free stream the next
        slot's prefill is enqueued at once and runs on the device beside
        this slot's decode."""
        with self.tel.span("engine.dispatch", batch=int(prompts.shape[0]),
                           steps=int(max_new_tokens)):
            return self._dispatch_inner(prompts, max_new_tokens,
                                        extra_inputs, seed, temperatures,
                                        top_ks, seeds)

    def _dispatch_streams(self):
        """(prefill stream, loop stream), made at the first dispatch and kept
        for the engine's life; (None, None) on the CPU.  The prefill stream
        is put behind whatever the caller enqueued (the parameters'
        init)."""
        if self.device.type != "cuda":
            return None, None
        if self.decode_program is None:
            self.decode_program = DecodeProgram(CudaGraphs(self.device))
            self._prefill_stream = torch.cuda.Stream(self.device)
        side = self._prefill_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        return side, self.decode_program.backend.stream

    def _dispatch_inner(self, prompts, max_new_tokens, extra_inputs, seed,
                        temperatures, top_ks, seeds) -> PendingGeneration:
        t_start = time.perf_counter()
        b, steps = int(prompts.shape[0]), int(max_new_tokens)
        side, loop = self._dispatch_streams()
        with _on_stream(side):
            batch = self._make_batch(prompts, extra_inputs)
            start = self._event()
            logits, caches, idx = self.prefill(batch)
            prefilled = self._event()
            sampling, rows = self._sampling_rows(b, seed, temperatures,
                                                 top_ks, seeds)
        self.decode_steps += steps
        self.tel.count("engine.decode_steps", steps)
        key = (b, int(idx) if self._positions_in_key else None, steps,
               sampling)
        if key not in self._loop_keys:
            self._loop_keys.add(key)
            self.tel.count("trace.engine_decode" if sampling[0] == "scalar"
                           else "trace.engine_decode_rows")
        inputs = {"logits": logits, "caches": caches, **rows}
        if loop is not None:
            loop.wait_stream(side)
        with _on_stream(loop):
            if loop is not None:
                # read on the loop's stream: their memory goes back to the
                # prefill stream only once that has passed
                tree_map(lambda t: [x.record_stream(loop)
                                    for x in _storages(t)], inputs)
            if self.decode_program is not None:
                tokens = self.decode_program.run(self, key, inputs, idx)
            else:
                tokens = torch.empty((b, steps), dtype=torch.int32,
                                     device=self.device)
                self._enqueue_loop(inputs, idx, tokens, sampling)
            # the handle's own tokens: the next replay of this key's graph
            # rewrites the graph's buffer
            if self.device.type == "cuda":
                own = torch.empty((b, steps), dtype=torch.int32,
                                  pin_memory=True)
                own.copy_(tokens, non_blocking=True)
            else:
                own = tokens.clone()
            done = self._event()
        return PendingGeneration(own, steps, t_start, time.perf_counter(),
                                 start, prefilled, done)

    def await_result(self, handle: PendingGeneration) -> GenerationResult:
        """Wait until the handle's generation is complete and return its
        tokens.  ``prefill_s`` / ``decode_s`` are time to ready from dispatch
        entry, split where the prefill's event has passed: with host work
        between dispatch and await they measure pipeline latency, not device
        occupancy (the scheduler's timeline and the handle's CUDA events
        carry that)."""
        with self.tel.span("engine.await", steps=handle.steps):
            if handle.prefilled is not None:
                handle.prefilled.synchronize()
            t_prefill = time.perf_counter()
            if handle.done is not None:
                handle.done.synchronize()
            t_done = time.perf_counter()
        return GenerationResult(
            handle.tokens.numpy().copy(), t_prefill - handle.t_start,
            t_done - t_prefill, handle.steps,
            None if handle.done is None else (handle.start, handle.prefilled,
                                              handle.done))
