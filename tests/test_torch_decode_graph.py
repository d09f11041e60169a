"""The engine's decode loop as one captured unit, against the JAX package's
jitted ``_decode_loop`` / ``_decode_loop_rows``.

The reference traces its loop once per key -- batch, prompt length (the
caches' shape), steps and the sampling tier -- and counts the traces
(telemetry ``trace.engine_decode`` and ``trace.engine_decode_rows``).  The
port counts the first use of each key the same way; on the card it
captures the key's loop as a CUDA graph (``DecodeProgram``) and replays it.
Here, on the CPU, the program runs with a stub in place of
``torch.cuda.CUDAGraph`` whose capture records the loop and whose replay
runs it:

* the key counts equal the reference engine's over one dispatch sequence
  of mixed batch widths, prompt lengths, steps and sampling tiers;
* one capture per key, the kernel counts a capture added moved to the
  replays, the least recently used key dropped past ``max_loops``, a
  failed capture raised with nothing run eagerly instead;
* at ``stage_depth=3``, four in-flight dispatches of one key keep each
  handle's own tokens (the graph's buffer is rewritten by every replay).
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.models import params as jparams
from repro.models.model import build_model as jax_build
from repro.obs.telemetry import Telemetry as JaxTelemetry
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.telemetry import Telemetry
from repro_torch.serving.engine import DecodeProgram, ServingEngine
from repro_torch.serving.multitenant import MultiTenantScheduler, Request

CAPTURED_LAUNCHES = 5        # what the stub's capture counts, as a wrapper
                             # counts launches that capture only records


def _weights(arch):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    vals, _ = jparams.split(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, cfg, vals, params_from_jax(cfg, jax.tree.map(np.asarray,
                                                              vals))


@pytest.fixture(scope="module")
def internlm2():
    return _weights("internlm2-1.8b")


class StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: replay runs what was
    captured."""

    def __init__(self, fn):
        self.fn = fn
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.fn()


class StubBackend:
    """The decode program's CUDA side on the CPU: eager work runs in place,
    capture records the loop without running it and counts launches the
    way a kernel wrapper does while a stream is captured."""

    def __init__(self):
        self.captured = []

    def run_beside(self, fn):
        fn()

    def capture(self, fn):
        self.captured.append(fn)
        pa.launch_counts["paged_attention_decode"] += CAPTURED_LAUNCHES
        return StubGraph(fn)

    def take_held(self):
        return []


# (batch, prompt length, steps, sampling kwargs of dispatch)
SEQUENCE = [(2, 8, 4, {}), (2, 8, 4, {}), (3, 8, 4, {}), (2, 12, 4, {}),
            (2, 8, 6, {}), (2, 8, 4, dict(seeds=[3, 4])),
            (2, 8, 4, dict(temperatures=[0.9, 0.0], seeds=[1, 2])),
            (2, 8, 4, dict(temperatures=[0.9, 0.0], top_ks=[3, 0])),
            (2, 8, 4, dict(temperatures=[0.7, 0.0], top_ks=[2, 0])),
            (3, 8, 4, dict(seeds=[1, 2, 3])), (2, 12, 4, {})]


def _dispatch_all(eng, seq, rng, await_each=True):
    out = []
    for b, s, steps, kw in seq:
        prompts = rng.integers(1, eng.cfg.vocab_size, (b, s)).astype(
            np.int32)
        out.append((prompts, steps, kw, eng.dispatch(prompts, steps, **kw)))
        if await_each:
            out[-1] = out[-1][:3] + (eng.await_result(out[-1][3]),)
    return out


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_loop_keys_match_reference_traces(internlm2, temperature):
    """tests/test_obs.py::test_enabled_plane_changes_no_compile_counts for
    the engine's decode loop: one key per (B, S, steps, sampling tier),
    counted where the reference counts its traces, scalar and rows apart;
    through the stub program one capture per key."""
    jcfg, cfg, vals, params = internlm2
    tel, jtel = Telemetry(enabled=True), JaxTelemetry(enabled=True)
    eng = ServingEngine(cfg, params, temperature=temperature, device="cpu",
                        telemetry=tel)
    jeng = JaxEngine(jcfg, vals, temperature=temperature, telemetry=jtel)
    backend = StubBackend()
    prog = eng.decode_program = DecodeProgram(backend)
    got = _dispatch_all(eng, SEQUENCE, np.random.default_rng(3))
    _dispatch_all(jeng, SEQUENCE, np.random.default_rng(3))
    mine, ref = tel.counter_snapshot(), jtel.counter_snapshot()
    for name in ("trace.engine_decode", "trace.engine_decode_rows"):
        assert mine[name] == ref[name] > 0, name
    n_keys = mine["trace.engine_decode"] + mine["trace.engine_decode_rows"]
    assert len(prog.loops) == len(backend.captured) == n_keys >= 7
    assert sum(c.replays for c in prog.loops.values()) == \
        len(SEQUENCE) - n_keys
    # replayed or captured, every loop gives generate's tokens for the
    # scalar tier (rows: greedy rows only)
    for prompts, steps, kw, res in got:
        if not kw:
            np.testing.assert_array_equal(
                res.tokens, eng.generate(prompts, steps).tokens)


def test_keys_of_an_arch_without_attention_leave_out_the_prompt_length():
    """mamba2's decode reads no position, so the reference's loop is traced
    per (B, steps, tier) whatever the prompt length, and so is the
    port's."""
    jcfg, cfg, vals, params = _weights("mamba2-2.7b")
    tel, jtel = Telemetry(enabled=True), JaxTelemetry(enabled=True)
    eng = ServingEngine(cfg, params, device="cpu", telemetry=tel)
    jeng = JaxEngine(jcfg, vals, telemetry=jtel)
    eng.decode_program = DecodeProgram(StubBackend())
    seq = [(2, 8, 3, {}), (2, 16, 3, {}), (2, 24, 3, {}), (1, 8, 3, {})]
    got = _dispatch_all(eng, seq, np.random.default_rng(5))
    want = _dispatch_all(jeng, seq, np.random.default_rng(5))
    assert tel.counter_snapshot()["trace.engine_decode"] == \
        jtel.counter_snapshot()["trace.engine_decode"] == 2
    assert set(eng.decode_program.loops) == {(2, None, 3, ("scalar", True)),
                                             (1, None, 3, ("scalar", True))}
    for (_, _, _, a), (_, _, _, b) in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))


def test_program_moves_capture_counts_to_replays_and_drops_old_keys(
        internlm2):
    """A capture's counts come back out and every replay adds them; past
    ``max_loops`` the least recently dispatched key goes (and is captured
    again when it comes back)."""
    _, cfg, _, params = internlm2
    eng = ServingEngine(cfg, params, device="cpu")
    backend = StubBackend()
    prog = eng.decode_program = DecodeProgram(backend)
    prog.max_loops = 2
    pa.reset_counts()
    seq = [(2, 8, 3, {}), (2, 8, 3, {}), (1, 8, 3, {}), (2, 8, 3, {}),
           (3, 8, 3, {}), (1, 8, 3, {}), (1, 8, 3, {})]
    _dispatch_all(eng, seq, np.random.default_rng(9))
    key = lambda b: (b, 8, 3, ("scalar", True))
    assert list(prog.loops) == [key(3), key(1)]   # 2 dropped, then 1 too
    assert prog.dropped == 2 and len(backend.captured) == 4
    assert not prog._retired                      # no event on the CPU
    replays = len(seq) - len(backend.captured)
    assert pa.launch_counts["paged_attention_decode"] == \
        CAPTURED_LAUNCHES * replays
    for cap in prog.loops.values():
        added = dict(zip(map(id, ops.counters()), cap.counts))
        assert added[id(pa.launch_counts)] == {
            "paged_attention_decode": CAPTURED_LAUNCHES}
        assert cap.graph.replays == cap.replays
        assert cap.tokens.shape == (cap.inputs["logits"].shape[0], 3)


def test_staged_dispatches_of_one_key_keep_their_own_tokens(internlm2):
    """stage_depth=3: four batches of one key dispatched before the first
    is awaited (every replay rewrites the graph's tokens buffer) still
    each return their own prompts' tokens, through the scheduler."""
    _, cfg, _, params = internlm2
    eng = ServingEngine(cfg, params, device="cpu")
    backend = StubBackend()
    prog = eng.decode_program = DecodeProgram(backend)
    rng = np.random.default_rng(21)
    reqs = [Request("t", rng.integers(1, cfg.vocab_size, 10).astype(
        np.int32), max_new_tokens=4) for _ in range(8)]
    sched = MultiTenantScheduler(eng, max_batch=2, stage_depth=3)
    for r in reqs:
        sched.submit(r)
    first = sched.step()
    assert len(sched._inflight) == 3            # four slots dispatched
    got = first + sched.drain()
    assert len(prog.loops) == 1 and len(backend.captured) == 1
    assert next(iter(prog.loops.values())).replays == 3
    for i in range(0, 8, 2):
        want = eng.generate(np.stack([reqs[i].prompt, reqs[i + 1].prompt]),
                            4).tokens
        np.testing.assert_array_equal(got[i].tokens, want[0])
        np.testing.assert_array_equal(got[i + 1].tokens, want[1])
    assert not np.array_equal(got[0].tokens, got[6].tokens)


def test_failed_capture_raises_and_nothing_falls_back(internlm2):
    """A capture that fails raises out of ``dispatch``; the key is not held,
    so no later dispatch replays a half-made graph or quietly runs the
    loop eagerly instead."""
    _, cfg, _, params = internlm2

    class Failing(StubBackend):
        def capture(self, fn):
            raise RuntimeError("capture failed")

    eng = ServingEngine(cfg, params, device="cpu")
    eng.decode_program = DecodeProgram(Failing())
    prompts = np.arange(1, 9, dtype=np.int32)[None]
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture failed"):
            eng.dispatch(prompts, 3)
    assert not eng.decode_program.loops
