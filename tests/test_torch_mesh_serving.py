"""Continuous serving on a one-process device mesh against the JAX
package's meshless engine (the contract of the reference's
``tests/test_mesh_serving.py``, whose own mesh children cannot run under
this jax):

* **1x1 bitwise** -- an engine on a 1x1 mesh emits the same tokens and the
  same final logits, bit for bit, as the meshless engine;
* **1xN greedy token-exact** -- the K/V pools split on KV heads over 2, 4
  and 8 positions of one CPU device (reduced internlm2 re-widened to 16 /
  8 heads, as the reference's children re-widen it), through batched and
  prefix-shared admission, free-list eviction and copy-on-write forks: the
  tokens of the reference's meshless ``ContinuousBatchingEngine`` and of
  the port's; each shard's pool holds ``Hkv / N`` heads; page accounting
  stays host-global and conserved in both tiers;
* **preempt / restore through the lanes** -- a swap-in rides one staging
  lane per mesh position, and the victims decode as without a mesh;
* reduced jamba (SSM state replicated beside split attention pools) and
  reduced whisper (split cross pools) re-widened to 4 KV heads are
  token-exact at 1x2; a checkpoint written on 1x2 recovers on no mesh and
  on 1x4; ``launch.serve --mesh 1x1`` equals the run without a mesh.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import params as jparams
from repro.models.model import build_model as jax_build
from repro.serving.continuous import ContinuousBatchingEngine as JaxCont
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.multitenant import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (ShardedTensor, parse_mesh,
                                              serving_sharder)
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.serving import journal as jm
from repro_torch.serving.continuous import ContinuousBatchingEngine
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.multitenant import MultiTenantScheduler, Request

CPU = torch.device("cpu")
# a tight pool: admissions recycle registered pages (eviction)
KW = dict(capacity=4, page_size=8, num_pages=40, inner_steps=2,
          max_prompt_len=32)


def _sharder(spec):
    return serving_sharder(parse_mesh(spec, [CPU] * 8)) if spec else None


def _wide(cfg, heads, kv_heads):
    return dataclasses.replace(cfg.reduced(), num_heads=heads,
                               num_kv_heads=kv_heads)


@pytest.fixture(scope="module")
def wide():
    """Reduced internlm2 at 16 / 8 heads: the reference's meshless tokens
    and the port's parameters from the same draw."""
    jcfg = _wide(jax_config("internlm2-1.8b"), 16, 8)
    cfg = _wide(get_config("internlm2-1.8b"), 16, 8)
    vals, _ = jparams.split(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    reqs = _mix(cfg)
    jeng = JaxCont(JaxEngine(jcfg, vals), **KW)
    out = jeng.run_all([JaxRequest(r.tenant, r.prompt.copy(),
                                   r.max_new_tokens, seed=r.seed)
                        for r in reqs])
    ref = {_key(r): np.asarray(t) for r, t in out}
    params = params_from_jax(cfg, jax.tree.map(np.asarray, vals))
    return cfg, params, reqs, ref


def _mix(cfg):
    """The reference's SHARDED_ENGINE_SCRIPT mix: half of it shares a
    16-token system prefix (trie hits and copy-on-write forks)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
    reqs = []
    for i in range(8):
        tail = rng.integers(1, cfg.vocab_size,
                            8 + 4 * (i % 3)).astype(np.int32)
        prompt = np.concatenate([shared, tail]) if i % 2 == 0 else tail
        reqs.append(Request(f"t{i % 3}", prompt, 6 + i, seed=i))
    return reqs


def _key(r):
    return (r.prompt.tobytes(), int(r.max_new_tokens))


def _clone(reqs):
    return [Request(r.tenant, r.prompt.copy(), r.max_new_tokens,
                    seed=r.seed, priority=r.priority,
                    extra_inputs=r.extra_inputs) for r in reqs]


def _build(cfg, params, spec, **kw):
    eng = ServingEngine(cfg, params, device="cpu", sh=_sharder(spec))
    return ContinuousBatchingEngine(eng, **{**KW, **kw})


def _run(ceng, reqs):
    out = ceng.run_all(_clone(reqs))
    ceng.kv.assert_conserved(host_pages=ceng.swap_store.pages())
    ceng.assert_conserved()
    return {_key(r): np.asarray(t) for r, t in out}


@pytest.fixture(scope="module")
def base(wide):
    cfg, params, reqs, ref = wide
    ceng = _build(cfg, params, None)
    toks = _run(ceng, reqs)
    # the tight pool really forked and recycled
    assert ceng.kv.cow_forks + ceng.kv.pristine_forks > 0
    assert ceng.kv.pages_reused > 0
    return ceng, toks


def test_meshless_port_matches_reference(wide, base):
    ref = wide[3]
    assert sorted(ref) == sorted(base[1])
    for k in ref:
        np.testing.assert_array_equal(base[1][k], ref[k])


def test_mesh_1x1_is_bitwise_the_meshless_engine(wide, base):
    cfg, params, reqs, _ = wide
    one = _build(cfg, params, "1x1")
    toks = _run(one, reqs)
    for k, t in base[1].items():
        np.testing.assert_array_equal(toks[k], t)
    assert torch.equal(one.state["logits"], base[0].state["logits"])
    assert one.decode_traces == base[0].decode_traces


@pytest.mark.parametrize("spec", ["1x2", "1x4", "1x8"])
def test_mesh_1xn_is_greedy_token_exact(wide, base, spec):
    cfg, params, reqs, ref = wide
    ceng = _build(cfg, params, spec)
    n = ceng.sh.mesh.shape["model"]
    pool = ceng.state["caches"][ceng.kv.attn_subs[0]]["k"]
    assert isinstance(pool, ShardedTensor) and len(pool.unique()) == n
    assert {tuple(t.shape) for t in pool.locals} == {
        pool.shape[:3] + (cfg.num_kv_heads // n, pool.shape[4])}
    assert all(t.is_contiguous() for t in pool.locals)
    assert not isinstance(ceng.state["page_table"], ShardedTensor)
    toks = _run(ceng, reqs)
    for k in ref:
        np.testing.assert_array_equal(toks[k], ref[k])
        np.testing.assert_array_equal(toks[k], base[1][k])
    # the same eviction and forks as without a mesh: accounting is global
    for name in ("cow_forks", "pristine_forks", "pages_reused",
                 "pages_shared", "pages_allocated"):
        assert getattr(ceng.kv, name) == getattr(base[0].kv, name), name
    assert ceng.decode_traces == base[0].decode_traces


def _swap_cycle(cfg, params, spec, extra=None):
    """Two long tier-1 rows fill a capacity-2 table, then a tier-0 arrival
    preempts one (the reference's swap_cycle)."""
    rng = np.random.default_rng(1)
    eng = ServingEngine(cfg, params, device="cpu", sh=_sharder(spec))
    sched = MultiTenantScheduler(
        eng, mode="continuous", preemption=True,
        continuous=dict(capacity=2, page_size=8, num_pages=14,
                        inner_steps=2, max_prompt_len=16))
    prompts = [rng.integers(1, cfg.vocab_size,
                            8 + 8 * (i % 2)).astype(np.int32)
               for i in range(3)]
    for i in range(2):
        sched.submit(Request(f"lo{i}", prompts[i], 30, priority=1, seed=i,
                             extra_inputs=extra))
    sched.step()
    sched.submit(Request("hi", prompts[2], 4, priority=0,
                         extra_inputs=extra))
    res = sched.drain()
    ceng = sched.continuous_engine
    ceng.kv.assert_conserved(host_pages=ceng.swap_store.pages_by_kind())
    ceng.assert_conserved()
    assert ceng.preemptions > 0 and ceng.restores > 0
    assert all(r.outcome == "completed" for r in res)
    return {(r.tenant, tuple(r.tokens.tolist())) for r in res}, ceng


@pytest.mark.parametrize("spec", ["1x2", "1x8"])
def test_preempt_restore_rides_one_lane_per_position(wide, spec):
    cfg, params = wide[:2]
    want, _ = _swap_cycle(cfg, params, None)
    got, ceng = _swap_cycle(cfg, params, spec)
    assert got == want
    lanes = ceng.swap_store.lanes
    n = ceng.sh.mesh.size
    assert lanes is not None and lanes.n_lanes == n
    assert all(len(e.log) > 0 for e in lanes.engines)
    # a lane's KV slice is its position's heads; the host tier is global
    assert all(rec["bytes"] > 0 for e in lanes.engines for rec in e.log)


def _arch_params(arch, heads, kv_heads):
    cfg = _wide(get_config(arch), heads, kv_heads)
    return cfg, build_model(cfg).init(0, "cpu")


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "whisper-base"])
def test_hybrid_and_encoder_decoder_token_exact_at_1x2(arch):
    cfg, params = _arch_params(arch, 8, 4)
    rng = np.random.default_rng(2)
    reqs = []
    for i in range(4):
        extra = None
        if cfg.enc_dec:
            extra = {"frames": rng.normal(size=(
                cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)}
        reqs.append(Request(f"t{i % 2}", rng.integers(
            1, cfg.vocab_size, 8 + 4 * (i % 2)).astype(np.int32), 6 + i,
            seed=i, extra_inputs=extra))
    kw = dict(capacity=2, num_pages=24)
    base = _run(_build(cfg, params, None, **kw), reqs)
    ceng = _build(cfg, params, "1x2", **kw)
    caches = ceng.state["caches"]
    assert isinstance(caches[ceng.kv.attn_subs[0]]["k"], ShardedTensor)
    if cfg.enc_dec:
        assert isinstance(caches["cross"]["k"], ShardedTensor)
        assert {t.shape[3] for t in caches["cross"]["k"].locals} == {2}
    for name in ceng.ssm_subs:          # SSM state stays replicated
        assert all(isinstance(t, torch.Tensor)
                   for t in caches[name].values())
    got = _run(ceng, reqs)
    for k, t in base.items():
        np.testing.assert_array_equal(got[k], t)
    extra = reqs[0].extra_inputs
    want_swap, _ = _swap_cycle(cfg, params, None, extra)
    got_swap, _ = _swap_cycle(cfg, params, "1x2", extra)
    assert got_swap == want_swap


@pytest.mark.parametrize("recover_on", [None, "1x4"])
def test_checkpoint_from_1x2_recovers_on_any_mesh(wide, tmp_path,
                                                  recover_on):
    cfg, params = wide[:2]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, 8 + i).astype(np.int32)
               for i in range(4)]

    def mkreqs():
        return [Request(f"r{i}", prompts[i].copy(), max_new_tokens=10 + 2 * i,
                        seed=7 + i, temperature=0.8 if i % 2 else None)
                for i in range(4)]

    def sched(spec, **kw):
        eng = ServingEngine(cfg, params, device="cpu", sh=_sharder(spec))
        return MultiTenantScheduler(
            eng, mode="continuous", continuous=dict(
                capacity=2, page_size=8, num_pages=24, inner_steps=4,
                max_prompt_len=16), **kw)

    sa = sched(None)
    for r in mkreqs():
        sa.submit(r)
    base = {r.tenant: np.asarray(r.tokens) for r in sa.drain()}
    jpath, cdir = str(tmp_path / "journal.jsonl"), str(tmp_path / "ckpt")
    sb = sched("1x2", journal=jpath, checkpoint_dir=cdir,
               checkpoint_every=2)
    for r in mkreqs():
        sb.submit(r)
    for _ in range(6):                      # abandon mid-flight
        if sb.pending():
            sb.step()
    assert sb.checkpoints_taken >= 1
    sc = sched(recover_on, journal=jpath, checkpoint_dir=cdir,
               checkpoint_every=2)
    summary = sc.recover()
    assert summary.restored_live + summary.restored_swapped > 0
    got = {r.tenant: np.asarray(r.tokens) for r in sc.drain()
           if r.outcome == "completed"}
    js = jm.replay(jm.read_journal(jpath))
    for rid, toks in summary.already_complete.items():
        got[js.submitted[rid]["tenant"]] = np.asarray(toks, np.int32)
    assert set(got) == set(base)
    for t in base:
        np.testing.assert_array_equal(got[t], base[t])
    cc = sc.continuous_engine
    cc.kv.assert_conserved(host_pages=cc.swap_store.pages_by_kind())


class _Keep:
    """``observe`` hook: the scheduler and every retired request's tokens."""

    def __init__(self):
        self.sched, self.tokens = None, {}

    def __call__(self, sched):
        if self.sched is None:
            self.sched = sched
            eng = sched.continuous_engine
            collect = eng.collect

            def keep(handle):
                res = collect(handle)
                for r, t, _ in res.finished:
                    self.tokens[r.prompt.tobytes()] = t
                return res
            eng.collect = keep


def test_serve_cli_mesh_1x1_equals_no_mesh(capsys):
    argv = ["--reduced", "--device", "cpu", "--mode", "continuous",
            "--requests", "6", "--shared-prefix-len", "16"]
    runs = []
    for extra in ([], ["--mesh", "1x1"]):
        keep = _Keep()
        assert serve_cli.main(argv + extra, observe=keep) == 0
        runs.append(keep)
    a, b = runs
    assert b.sched.continuous_engine.sh.mesh.shape == {"data": 1,
                                                       "model": 1}
    assert sorted(a.tokens) == sorted(b.tokens) and len(a.tokens) == 6
    for k in a.tokens:
        np.testing.assert_array_equal(a.tokens[k], b.tokens[k])
    assert torch.equal(a.sched.continuous_engine.state["logits"],
                       b.sched.continuous_engine.state["logits"])
    # a mesh wider than the visible devices takes them in turn: both 1x2
    # positions on the one CPU device, the tokens of no mesh
    keep = _Keep()
    assert serve_cli.main(argv + ["--mesh", "1x2"], observe=keep) == 0
    assert keep.sched.continuous_engine.sh.mesh.position_devices() == \
        [CPU, CPU]
    assert sorted(keep.tokens) == sorted(a.tokens)
    for k in a.tokens:
        np.testing.assert_array_equal(a.tokens[k], keep.tokens[k])
    # the slot schedules take a mesh too
    assert serve_cli.main(["--reduced", "--device", "cpu", "--mesh",
                           "1x1"]) == 0
    assert "mesh" not in serve_cli.LATER
