"""The port's crash safety against the JAX package's: the write-ahead
journal, engine checkpoints and kill-and-restart recovery.

* the journal (``repro_torch.serving.journal``): schema enforcement, torn
  tails dropped and repaired, replay bookkeeping -- the reference's cases --
  the golden schema file, and journals either package wrote replayed by the
  other to the same ``JournalState``;
* in process: a journalled, checkpointed scheduler abandoned mid-flight and
  recovered into a fresh engine finishes every request bit for bit as an
  uninterrupted run; a swapped request failing terminally drops its record
  and its ticket bookkeeping;
* in subprocesses that import only ``repro_torch`` and run on the CPU:
  SIGKILL at an exact dispatched round and inside a swap-out, then a fresh
  process recovers every request token-exactly (exit code -9 first).
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from repro.serving import journal as jjm
from repro.serving.multitenant import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serving import journal as jm
from repro_torch.serving.continuous import ContinuousBatchingEngine
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.multitenant import MultiTenantScheduler, Request

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "journal_schema.json")


# ---------------------------------------------------------------------------
# journal contracts (no engine)
# ---------------------------------------------------------------------------
def _writer(tmp_path):
    return jm.JournalWriter(str(tmp_path / "j.jsonl"))


def test_journal_append_enforces_schema(tmp_path):
    w = _writer(tmp_path)
    with pytest.raises(ValueError, match="unknown journal record kind"):
        w.append("NOPE", rid=0)
    with pytest.raises(ValueError, match="!= schema"):
        w.append("ADMIT", rid=0)                       # missing fields
    with pytest.raises(ValueError, match="!= schema"):
        w.append("RETIRE", rid=0, tokens=[1], extra=2)  # widened
    w.append("ADMIT", rid=0, slot=1, bucket=16, ring=16)
    w.close()
    assert len(jm.read_journal(w.path)) == 1


def test_journal_torn_tail_dropped_midfile_raises(tmp_path):
    w = _writer(tmp_path)
    w.append("ADMIT", rid=0, slot=0, bucket=16, ring=16)
    w.append("RETIRE", rid=0, tokens=[1, 2, 3])
    w.close()
    with open(w.path, "ab") as f:                 # crash mid-append: no \n
        f.write(b'{"v": 1, "seq": 2, "kind": "RET')
    recs = jm.read_journal(w.path)
    assert [r["kind"] for r in recs] == ["ADMIT", "RETIRE"]
    with open(w.path, "rb") as f:
        lines = f.read().splitlines()
    with open(w.path, "wb") as f:                 # the same damage mid-file
        f.write(b"\n".join([lines[0][:10], lines[1]]) + b"\n")
    with pytest.raises(ValueError, match="corrupt record"):
        jm.read_journal(w.path)


def test_journal_reopen_repairs_torn_tail_and_continues_seq(tmp_path):
    w = _writer(tmp_path)
    w.append("ADMIT", rid=0, slot=0, bucket=16, ring=16)
    w.append("RETIRE", rid=0, tokens=[1, 2, 3])
    w.close()
    with open(w.path, "ab") as f:
        f.write(b'{"v": 1, "seq": 2, "kind": "RET')
    w2 = jm.JournalWriter(w.path)                 # generation 2 reopens
    w2.append("RECOVER", step=-1, restored_live=0, restored_swapped=0,
              requeued=1, rounds_replayed=0)
    w2.append("ROUND_COMMIT", rnd=1, emitted={"1": 2})
    w2.close()
    recs = jm.read_journal(w.path)
    assert [r["kind"] for r in recs] == \
        ["ADMIT", "RETIRE", "RECOVER", "ROUND_COMMIT"]
    assert [r["seq"] for r in recs] == [0, 1, 2, 3]
    w3 = jm.JournalWriter(w.path)
    w3.append("CHECKPOINT", step=0, rnd=1)
    w3.close()
    assert jm.read_journal(w.path)[-1]["seq"] == 4
    w4 = jm.JournalWriter(str(tmp_path / "fresh.jsonl"))
    assert w4._seq == 0
    w4.close()


def test_journal_rejected_outside_continuous_mode(tmp_path):
    for mode in ("overlapped", "blocking"):
        with pytest.raises(ValueError, match="continuous"):
            MultiTenantScheduler(None, mode=mode,
                                 journal=str(tmp_path / "j.jsonl"))
        with pytest.raises(ValueError, match="continuous"):
            MultiTenantScheduler(None, mode=mode,
                                 checkpoint_dir=str(tmp_path / "ckpt"))
    assert not os.path.exists(tmp_path / "j.jsonl")


def test_journal_replay_folds_checkpoint_window(tmp_path):
    w = _writer(tmp_path)
    for rid in range(3):
        w.append("SUBMIT", **jm.request_to_record(
            rid, Request(f"t{rid}", np.asarray([1, 2, 3], np.int32), 8)))
    w.append("ADMIT", rid=0, slot=0, bucket=16, ring=16)
    w.append("ADMIT", rid=1, slot=1, bucket=16, ring=16)
    w.append("ROUND_COMMIT", rnd=1, emitted={"0": 4, "1": 4})
    w.append("CHECKPOINT", step=0, rnd=1)
    w.append("ROUND_COMMIT", rnd=2, emitted={"0": 8, "1": 8})
    w.append("RETIRE", rid=0, tokens=list(range(8)))
    w.append("ROUND_COMMIT", rnd=3, emitted={"1": 10})
    w.close()
    st = jm.replay(jm.read_journal(w.path))
    assert st.pending() == [1, 2]
    assert st.terminal == {0: "RETIRE"}
    assert st.retired_tokens[0] == list(range(8))
    assert st.admitted == {0, 1}
    assert st.last_checkpoint["step"] == 0
    assert st.rounds_after_checkpoint == 2
    assert st.tokens_after_checkpoint == 10
    assert st.next_rid == 3
    assert st.last_round == 3


def test_journal_replay_resets_round_bookkeeping_at_recover(tmp_path):
    w = _writer(tmp_path)
    w.append("SUBMIT", **jm.request_to_record(
        0, Request("t0", np.asarray([1, 2, 3], np.int32), 16)))
    w.append("CHECKPOINT", step=0, rnd=1)
    w.append("ROUND_COMMIT", rnd=2, emitted={"0": 4})
    w.append("ROUND_COMMIT", rnd=3, emitted={"0": 8})
    w.append("RECOVER", step=0, restored_live=1, restored_swapped=0,
             requeued=0, rounds_replayed=2)
    w.append("ROUND_COMMIT", rnd=2, emitted={"0": 4})
    w.append("ROUND_COMMIT", rnd=3, emitted={"0": 8})
    w.append("ROUND_COMMIT", rnd=4, emitted={"0": 12})
    w.close()
    st = jm.replay(jm.read_journal(w.path))
    assert st.rounds_after_checkpoint == 3
    assert st.tokens_after_checkpoint == 12
    assert st.last_round == 4


def test_request_record_roundtrip_lossless():
    req = Request("acme", np.asarray([5, 7, 11], np.int32), 6,
                  temperature=0.9, top_k=12, seed=42, priority=0,
                  deadline_s=3.5,
                  extra_inputs={"mel": np.arange(6, dtype=np.float32)})
    rec = jm.request_to_record(9, req)
    assert rec["rid"] == 9 and rec["extras_hash"] != ""
    json.dumps(rec)
    back = jm.request_from_record(rec)
    assert isinstance(back, Request)
    np.testing.assert_array_equal(back.prompt, req.prompt)
    np.testing.assert_array_equal(back.extra_inputs["mel"],
                                  req.extra_inputs["mel"])
    assert (back.tenant, back.max_new_tokens, back.temperature, back.top_k,
            back.seed, back.priority, back.deadline_s) == \
        ("acme", 6, 0.9, 12, 42, 0, 3.5)
    assert jm.extras_hash(back.extra_inputs) == rec["extras_hash"]
    assert jm.extras_hash(None) == ""
    # the same request gives the reference's record, hash included
    jreq = JaxRequest("acme", req.prompt.copy(), 6, temperature=0.9,
                      top_k=12, seed=42, priority=0, deadline_s=3.5,
                      arrival_s=req.arrival_s,
                      extra_inputs={"mel": np.arange(6, dtype=np.float32)})
    assert jjm.request_to_record(9, jreq) == rec


def test_golden_journal_schema():
    """The port's record schema equals the golden file (read, never
    written) and the reference's."""
    got = {"version": jm.JOURNAL_VERSION,
           "records": {k: list(v)
                       for k, v in sorted(jm.RECORD_FIELDS.items())}}
    with open(GOLDEN) as f:
        want = json.load(f)
    assert got == want
    assert jm.RECORD_FIELDS == jjm.RECORD_FIELDS
    assert jm.JOURNAL_VERSION == jjm.JOURNAL_VERSION


def _write_every_kind(mod, req_cls, path):
    w = mod.JournalWriter(path)
    rng = np.random.default_rng(4)
    for rid in range(4):
        w.append("SUBMIT", **mod.request_to_record(rid, req_cls(
            f"t{rid % 2}", rng.integers(1, 50, 5 + rid).astype(np.int32),
            6 + rid, temperature=None if rid % 2 else 0.7, seed=rid,
            priority=rid % 2, arrival_s=1.5 * rid,
            extra_inputs=({"frames": rng.normal(size=(3, 2)).astype(
                np.float32)} if rid == 3 else None))))
    w.append("ADMIT", rid=0, slot=0, bucket=16, ring=16)
    w.append("ADMIT", rid=1, slot=1, bucket=16, ring=8)
    w.append("ROUND_COMMIT", rnd=1, emitted={"0": 4, "1": 4})
    w.append("PREEMPT", rid=1, ticket=0)
    w.append("CHECKPOINT", step=0, rnd=1)
    w.append("ROUND_COMMIT", rnd=2, emitted={"0": 6})
    w.append("RETIRE", rid=0, tokens=[3, 1, 4, 1, 5, 9])
    w.append("RESTORE", rid=1, ticket=0)
    w.append("REJECT", rid=2, shed=True)
    w.append("FAIL", rid=1, preemptions=1)
    w.append("RECOVER", step=0, restored_live=1, restored_swapped=1,
             requeued=1, rounds_replayed=1)
    w.append("ROUND_COMMIT", rnd=2, emitted={"3": 2})
    w.close()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journals_replay_alike_across_packages(tmp_path, writer):
    """A journal written by either package -- every record kind, extras
    included -- is read and replayed by the other to the same state, and
    the files are byte-identical."""
    paths = {}
    for name, mod, cls in (("reference", jjm, JaxRequest),
                           ("port", jm, Request)):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        _write_every_kind(mod, cls, paths[name])
    with open(paths["reference"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    path = paths[writer]
    mine = jm.replay(jm.read_journal(path))
    ref = jjm.replay(jjm.read_journal(path))
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.pending() == ref.pending() == [3]
    back = jm.request_from_record(mine.submitted[3])
    np.testing.assert_array_equal(
        back.extra_inputs["frames"],
        jjm.request_from_record(ref.submitted[3]).extra_inputs["frames"])


# ---------------------------------------------------------------------------
# in process: checkpoint/recover cycle + terminal-swap hygiene
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engine():
    cfg = get_config("internlm2-1.8b").reduced()
    return ServingEngine(cfg, build_model(cfg).init(0, "cpu"), device="cpu")


def _ceng(engine, **kw):
    kw = dict(dict(capacity=2, page_size=8, num_pages=24, inner_steps=4,
                   max_prompt_len=16), **kw)
    return ContinuousBatchingEngine(engine, **kw)


def test_checkpoint_recover_token_exact_in_process(engine, tmp_path):
    """Abandon a journalled, checkpointed scheduler mid-flight (the
    on-disk pair is all recovery may read), recover into a fresh engine
    and scheduler: every request -- greedy and seeded sampling -- finishes
    bit for bit as an uninterrupted run; pre-crash retires surface from the
    journal without decoding again."""
    rng = np.random.default_rng(0)
    cfg = engine.cfg
    prompts = [rng.integers(1, cfg.vocab_size, 8 + i).astype(np.int32)
               for i in range(4)]

    def mkreqs():
        return [Request(f"r{i}", prompts[i].copy(), max_new_tokens=10 + 2 * i,
                        seed=7 + i, temperature=0.8 if i % 2 else None)
                for i in range(4)]

    sa = MultiTenantScheduler(engine, mode="continuous",
                              continuous_engine=_ceng(engine))
    for r in mkreqs():
        sa.submit(r)
    base = {r.tenant: np.asarray(r.tokens) for r in sa.drain()
            if r.outcome == "completed"}
    assert len(base) == 4

    jpath = str(tmp_path / "journal.jsonl")
    cdir = str(tmp_path / "ckpt")
    sb = MultiTenantScheduler(engine, mode="continuous",
                              continuous_engine=_ceng(engine),
                              journal=jpath, checkpoint_dir=cdir,
                              checkpoint_every=2)
    for r in mkreqs():
        sb.submit(r)
    for _ in range(6):                      # abandon mid-flight
        if sb.pending():
            sb.step()
    assert sb.checkpoints_taken >= 1
    cks = [r["rnd"] for r in jm.read_journal(jpath)
           if r["kind"] == "CHECKPOINT"]
    assert cks[0] == 2                      # every K rounds, not K+1
    assert all(b - a == 2 for a, b in zip(cks, cks[1:]))

    cc = _ceng(engine)
    sc = MultiTenantScheduler(engine, mode="continuous",
                              continuous_engine=cc, journal=jpath,
                              checkpoint_dir=cdir, checkpoint_every=2)
    summary = sc.recover()
    assert summary.checkpoint_step is not None
    assert summary.restored_live + summary.restored_swapped \
        + summary.requeued + len(summary.already_complete) >= 4
    got = {r.tenant: np.asarray(r.tokens) for r in sc.drain()
           if r.outcome == "completed"}
    js = jm.replay(jm.read_journal(jpath))
    for rid, toks in summary.already_complete.items():
        got[js.submitted[rid]["tenant"]] = np.asarray(toks, np.int32)
    assert set(got) == set(base)
    for t in base:
        np.testing.assert_array_equal(base[t], got[t])
    cc.kv.assert_conserved(host_pages=cc.swap_store.pages_by_kind())
    cc.assert_conserved()
    assert [r["kind"] for r in jm.read_journal(jpath)].count("RECOVER") == 1


def test_failed_swapped_request_drops_store_and_tickets(engine):
    """A swapped-out request whose restore keeps failing against an idle
    engine fails terminally, dropping its host record and both ticket
    maps; ``drain()`` audits exactly that."""
    rng = np.random.default_rng(1)
    cfg = engine.cfg
    ceng = _ceng(engine)
    sched = MultiTenantScheduler(engine, mode="continuous",
                                 continuous_engine=ceng, preemption=True,
                                 admission_retry_limit=1)
    for i in range(2):
        sched.submit(Request(f"lo{i}", rng.integers(
            1, cfg.vocab_size, 12).astype(np.int32),
            max_new_tokens=40, priority=1))
    sched.step()
    sched.submit(Request("hi", rng.integers(1, cfg.vocab_size,
                                            8).astype(np.int32),
                         max_new_tokens=6, priority=0))
    while ceng.preemptions == 0 and sched.pending():
        sched.step()
    assert len(ceng.swap_store) == 1
    ceng.try_restore = lambda ticket: False     # unrestorable from here
    out = sched.drain()
    assert sorted(r.outcome for r in out) == \
        ["completed", "completed", "failed"]
    failed, = [r for r in out if r.outcome == "failed"]
    assert failed.preemptions >= 1
    assert len(ceng.swap_store) == 0
    assert sched._ticket_attempts == {} and sched._ticket_backoff == {}
    ceng.kv.assert_conserved(host_pages=ceng.swap_store.pages_by_kind())


# ---------------------------------------------------------------------------
# subprocess kill-and-restart (SIGKILL mid-round / mid-preemption)
# ---------------------------------------------------------------------------
def _run_child(script: str, *argv: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(os.path.dirname(__file__), "..", "src")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-c", script, *argv],
                          capture_output=True, text=True, env=env,
                          timeout=240)


CRASH_RECOVER_SCRIPT = textwrap.dedent("""
    import json, os, sys
    import numpy as np

    phase, mode, root = sys.argv[1], sys.argv[2], sys.argv[3]

    from repro_torch.configs import get_config
    from repro_torch.distributed.fault import FaultPlane
    from repro_torch.models.model import build_model
    from repro_torch.serving import journal as jm
    from repro_torch.serving.continuous import ContinuousBatchingEngine
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.multitenant import MultiTenantScheduler, Request

    assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                   for m in sys.modules)
    cfg = get_config("internlm2-1.8b").reduced()
    engine = ServingEngine(cfg, build_model(cfg).init(0, "cpu"),
                           device="cpu")
    fp = None
    if phase == "crash":
        fp = (FaultPlane(crash_at_swap=1) if mode == "swap"
              else FaultPlane(crash_at_round=6))
    ceng = ContinuousBatchingEngine(engine, capacity=2, page_size=8,
                                    num_pages=24, inner_steps=4,
                                    max_prompt_len=16, fault_plane=fp)
    sched = MultiTenantScheduler(
        engine, mode="continuous", continuous_engine=ceng, preemption=True,
        journal=os.path.join(root, "journal.jsonl"),
        checkpoint_dir=os.path.join(root, "ckpt"), checkpoint_every=3)

    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, 8 + 2 * i).astype(np.int32)
               for i in range(4)]

    def mkreq(i, prio=1, steps=None):
        return Request("t%d" % i, prompts[i].copy(),
                       max_new_tokens=24 + 2 * i if steps is None else steps,
                       seed=11 + i, priority=prio,
                       temperature=0.7 if i % 2 else None)

    # swap: two long rows fill the slot table and a tier-0 arrival forces a
    # preemption whose swap-out put() is the crash site.  round: rows 0/1
    # decode through the SIGKILL at dispatched round 6 (checkpointed at
    # round 3), row 2 waits in the checkpointed queue, and row 3 is
    # submitted after the first checkpoint -- on disk only as a SUBMIT
    reqs = ([mkreq(0), mkreq(1), mkreq(2, prio=0, steps=8)]
            if mode == "swap" else [mkreq(i) for i in range(4)])

    if phase == "crash":
        if mode == "swap":
            sched.submit(reqs[0]); sched.submit(reqs[1])
            sched.step()
            sched.submit(reqs[2])
            sched.drain()
        else:
            for r in reqs[:3]:
                sched.submit(r)
            late = False
            while sched.pending() or not late:
                if not late and sched.checkpoints_taken >= 1:
                    sched.submit(reqs[3])
                    late = True
                sched.step()
        sys.exit(3)          # the injected crash never fired

    summary = sched.recover()
    out = sched.drain()
    js = jm.replay(jm.read_journal(os.path.join(root, "journal.jsonl")))
    got = {r.tenant: np.asarray(r.tokens) for r in out
           if r.outcome == "completed"}
    for rid, toks in summary.already_complete.items():
        got[js.submitted[rid]["tenant"]] = np.asarray(toks, np.int32)
    assert set(got) == {r.tenant for r in reqs}, sorted(got)
    for r in reqs:           # each request alone on the same engine
        clone = Request(r.tenant, r.prompt.copy(), r.max_new_tokens,
                        temperature=r.temperature, seed=r.seed)
        (_, want), = ceng.run_all([clone])
        np.testing.assert_array_equal(np.asarray(want), got[r.tenant])
    for rid, toks in summary.replay_check.items():
        np.testing.assert_array_equal(
            np.asarray(toks, np.int32), got[js.submitted[rid]["tenant"]])
    ceng.kv.assert_conserved(host_pages=ceng.swap_store.pages_by_kind())
    assert sched._ticket_attempts == {} and sched._ticket_backoff == {}
    print("RECOVERY_EXACT_OK " + json.dumps(dict(
        step=summary.checkpoint_step, live=summary.restored_live,
        swapped=summary.restored_swapped, requeued=summary.requeued,
        rounds=summary.rounds_replayed,
        preserved=summary.tokens_preserved)))
""")


def _crash_then_recover(mode: str) -> dict:
    root = tempfile.mkdtemp(prefix=f"torch_recovery_{mode}_")
    crash = _run_child(CRASH_RECOVER_SCRIPT, "crash", mode, root)
    assert crash.returncode == -9, (
        f"expected SIGKILL, got rc={crash.returncode}\n"
        + crash.stderr[-3000:])
    assert os.path.exists(os.path.join(root, "journal.jsonl"))
    rec = _run_child(CRASH_RECOVER_SCRIPT, "recover", mode, root)
    assert rec.returncode == 0, rec.stderr[-3000:]
    line, = [ln for ln in rec.stdout.splitlines()
             if ln.startswith("RECOVERY_EXACT_OK")]
    return json.loads(line.split(" ", 1)[1])


def test_sigkill_mid_round_recovery_subprocess():
    """SIGKILL at an exact dispatched round; a fresh process recovers every
    request token-exactly: checkpointed rows replay past the snapshot, rids
    never admitted re-queue."""
    s = _crash_then_recover("round")
    assert s["step"] is not None
    assert s["live"] + s["swapped"] >= 1
    assert s["requeued"] >= 1


def test_sigkill_mid_preemption_recovery_subprocess():
    """SIGKILL inside the swap-out's put(), the widest write-ahead window:
    the journal and the last checkpoint still rebuild a consistent state
    and every request finishes bit for bit."""
    s = _crash_then_recover("swap")
    assert s["requeued"] + s["live"] + s["swapped"] >= 1


def _retired(journal_path):
    """rid -> tokens of the last RETIRE record of each rid."""
    return {r["rid"]: r["tokens"] for r in jm.read_journal(journal_path)
            if r["kind"] == "RETIRE"}


def test_serve_cli_crash_at_round_then_recover_subprocess(tmp_path):
    """``launch.serve --journal-dir --checkpoint-every 4 --crash-at-round
    6`` dies by SIGKILL; ``--recover`` in a fresh process finishes every
    request, each with the tokens of an uncrashed run's journal."""
    argv = ["-m", "repro_torch.launch.serve", "--device", "cpu",
            "--reduced", "--mode", "continuous", "--tenants", "2",
            "--requests", "5", "--prompt-len", "10", "--new-tokens", "24",
            "--capacity", "2", "--priority", "3", "--checkpoint-every", "4"]
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(os.path.dirname(__file__), "..", "src")
                         + os.pathsep + env.get("PYTHONPATH", ""))

    def run(*extra):
        return subprocess.run([sys.executable, *argv, *extra],
                              capture_output=True, text=True, env=env,
                              timeout=240)

    base = run("--journal-dir", str(tmp_path / "base"))
    assert base.returncode == 0, base.stderr[-3000:]
    crash = run("--journal-dir", str(tmp_path / "crash"),
                "--crash-at-round", "6")
    assert crash.returncode == -9, crash.stderr[-3000:]
    rec = run("--journal-dir", str(tmp_path / "crash"), "--recover")
    assert rec.returncode == 0, rec.stderr[-3000:]
    assert "from checkpoint step=" in rec.stdout
    want = _retired(str(tmp_path / "base" / "journal.jsonl"))
    got = _retired(str(tmp_path / "crash" / "journal.jsonl"))
    assert len(want) == 5 and got == want
    kinds = [r["kind"] for r in
             jm.read_journal(str(tmp_path / "crash" / "journal.jsonl"))]
    assert kinds.count("RECOVER") == 1 and "CHECKPOINT" in kinds
