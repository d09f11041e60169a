"""The slot schedules (``overlapped``, ``blocking``) on a device mesh.

A slot engine on a mesh (``ServingEngine(..., sh=serving_sharder(mesh))``)
prefills once on the mesh's first device, lays the dense caches out by the
bundle's ``cache_axes`` (K/V and whisper's cross K/V split on KV heads; the
positions and the SSM states whole) and decodes a shard at a time.  Held
here, in float32 on meshes of ``torch.device("cpu")`` repeated:

* ``cache_axes()`` equals the reference's ``bundle.cache_axes()`` for
  every arch;
* the prefill's caches are laid out as ``param_shardings`` says, and
  gather back to the meshless caches bit for bit;
* ``1x1`` is bit for bit no mesh: the scheduler's tokens in both slot
  modes and the decode's logits step by step;
* ``1x2`` and ``1x4`` (reduced internlm2 widened to 8 / 4 heads, which
  both divide; and whisper's cross caches, mamba2 with nothing split) give
  the greedy tokens of no mesh and of ``generate``;
* the same requests through the reference's scheduler on the same mesh
  (one module-scoped subprocess with eight host devices and
  ``axis_types=(AxisType.Auto,) * 2``; the reference's ``Sharder(mesh,
  rules=SERVING_RULES)`` directly, since its ``parse_mesh`` builds
  ``Explicit`` axes) give the same greedy tokens;
* ``launch.serve --mesh 1x2 --device cpu`` in both slot modes serves the
  tokens of the run without a mesh.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.sharding import (ShardedTensor, param_shardings,
                                              parse_mesh, serving_sharder,
                                              spec_index_map)
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.models.transformer import tree_leaves, tree_map2
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.multitenant import MultiTenantScheduler, Request

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# arch -> (reduced config replacements, meshes the reference runs)
CASES = {"internlm2-1.8b": (dict(num_heads=8, num_kv_heads=4),
                            ("1x2", "1x4")),
         "whisper-base": ({}, ("1x2",)),
         "mamba2-2.7b": ({}, ("1x2",))}
N_REQ, PROMPT, NEW = 4, 8, 3

REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.distributed.sharding import SERVING_RULES, Sharder
    from repro.models import params as pp
    from repro.models.model import build_model
    from repro.serving.engine import ServingEngine
    from repro.serving.multitenant import MultiTenantScheduler, Request

    def flat(tree, pre, out):
        for k, v in tree.items():
            if isinstance(v, dict):
                flat(v, pre + k + "/", out)
            else:
                out[pre + k] = np.asarray(v)

    cases = json.loads(sys.argv[2])
    out = {}
    for arch, (repl, meshes) in cases.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **repl)
        params, _ = pp.split(build_model(cfg).init(jax.random.PRNGKey(0)))
        flat(params, arch + "/params/", out)
        rng = np.random.default_rng(0)
        prompts = rng.integers(1, cfg.vocab_size, (%(n)d, %(s)d)).astype(
            np.int32)
        extra = ([{"frames": rng.standard_normal(
            (cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)}
            for _ in range(%(n)d)] if cfg.enc_dec else [None] * %(n)d)
        out[arch + "/prompts"] = prompts
        if cfg.enc_dec:
            out[arch + "/frames"] = np.stack([e["frames"] for e in extra])
        for tag in meshes:
            shape = tuple(int(n) for n in tag.split("x"))
            mesh = jax.make_mesh(shape, ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2)
            eng = ServingEngine(cfg, params,
                                sh=Sharder(mesh, rules=SERVING_RULES))
            sched = MultiTenantScheduler(eng, max_batch=2)
            for i in range(%(n)d):
                sched.submit(Request(f"t{i %% 2}", prompts[i], %(new)d,
                                     extra_inputs=extra[i]))
            res = sched.drain()
            out[arch + "/" + tag + "/tokens"] = np.stack(
                [np.asarray(r.tokens) for r in res])
            out[arch + "/" + tag + "/tenants"] = np.array(
                [r.tenant for r in res])
    np.savez(sys.argv[1], **out)
""" % dict(n=N_REQ, s=PROMPT, new=NEW))


def unflat(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import json
    out = tmp_path_factory.mktemp("ref") / "slot_mesh.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out),
                        json.dumps(CASES)], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as f:
        return dict(f)


def _cfg(arch):
    return dataclasses.replace(get_config(arch).reduced(), **CASES[arch][0])


def _engine(arch, ref, spec=None):
    cfg = _cfg(arch)
    params = params_from_jax(cfg, unflat(ref, arch + "/params/"))
    sh = serving_sharder(parse_mesh(spec, [CPU] * 8)) if spec else None
    return ServingEngine(cfg, params, device="cpu", sh=sh)


def _requests(arch, ref):
    prompts = ref[arch + "/prompts"]
    frames = ref.get(arch + "/frames")
    return [Request(f"t{i % 2}", prompts[i].copy(), NEW,
                    extra_inputs=None if frames is None
                    else {"frames": frames[i]})
            for i in range(N_REQ)]


def _serve(eng, reqs, mode):
    sched = MultiTenantScheduler(eng, max_batch=2, mode=mode)
    for r in reqs:
        sched.submit(r)
    res = sched.drain()
    sched.close()
    return [(r.tenant, np.asarray(r.tokens)) for r in res]


def _extra(arch, ref):
    frames = ref.get(arch + "/frames")
    return None if frames is None else {"frames": frames}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_match_reference(arch):
    got = build_model(get_config(arch)).cache_axes()
    assert got == jax_build(jax_config(arch)).cache_axes()


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "whisper-base",
                                  "mamba2-2.7b"])
@pytest.mark.parametrize("spec", ["1x2", "1x4"])
def test_caches_laid_out_by_param_shardings(arch, spec, ref):
    base, eng = _engine(arch, ref), _engine(arch, ref, spec)
    batch = base._make_batch(ref[arch + "/prompts"], _extra(arch, ref))
    _, want, _ = base.prefill(batch)
    _, got, _ = eng.prefill(batch)
    shards = param_shardings(eng.sh, eng.bundle.cache_axes(), want)
    split = []

    def check(g, named):
        if all(e is None for e in named.spec):
            assert isinstance(g, torch.Tensor)
            return g
        assert isinstance(g, ShardedTensor)
        assert g.spec == named.spec
        assert g.slices == spec_index_map(eng.sh.mesh, named.spec, g.shape)
        split.append(g)
        return g.full()

    full = tree_map2(check, got, shards)
    for a, b in zip(tree_leaves(full), tree_leaves(want)):
        assert torch.equal(a, b)
    # K/V split on KV heads where the extent divides them; mamba2 has none
    n_kv = eng.cfg.num_kv_heads
    m = int(spec.split("x")[1])
    expect = (0 if arch == "mamba2-2.7b" or n_kv % m
              else 4 if eng.cfg.enc_dec else 2)
    assert len(split) == expect
    for g in split:
        assert len(g.distinct()) == m


@pytest.mark.parametrize("mode", ["overlapped", "blocking"])
def test_mesh_1x1_is_bitwise_no_mesh(mode, ref):
    arch = "internlm2-1.8b"
    base, eng = _engine(arch, ref), _engine(arch, ref, "1x1")
    reqs = _requests(arch, ref)
    for (ta, a), (tb, b) in zip(_serve(base, reqs, mode),
                                _serve(eng, reqs, mode)):
        assert ta == tb
        np.testing.assert_array_equal(a, b)
    # the decode's logits, step by step
    batch = base._make_batch(ref[arch + "/prompts"], None)
    la, ca, idx = base.prefill(batch)
    lb, cb, _ = eng.prefill(batch)
    assert torch.equal(la, lb)
    for step in range(4):
        tok = torch.argmax(la, dim=-1)[:, None]
        la, ca = base.bundle.decode_fn(base.params, tok, ca, idx + step)
        lb, cb = eng.bundle.decode_fn(eng.params, tok, cb, idx + step,
                                      eng.sh)
        assert torch.equal(la, lb)


@pytest.mark.parametrize("arch,spec", [("internlm2-1.8b", "1x2"),
                                       ("internlm2-1.8b", "1x4"),
                                       ("whisper-base", "1x2"),
                                       ("mamba2-2.7b", "1x2")])
@pytest.mark.parametrize("mode", ["overlapped", "blocking"])
def test_wider_meshes_greedy_token_exact(arch, spec, mode, ref):
    base, eng = _engine(arch, ref), _engine(arch, ref, spec)
    reqs = _requests(arch, ref)
    want = _serve(base, reqs, mode)
    got = _serve(eng, reqs, mode)
    for (ta, a), (tb, b) in zip(want, got):
        assert ta == tb
        np.testing.assert_array_equal(a, b)
    # generate over the whole batch, and dispatch, on the mesh
    prompts, extra = ref[arch + "/prompts"], _extra(arch, ref)
    g0 = base.generate(prompts, NEW, extra_inputs=extra).tokens
    np.testing.assert_array_equal(
        eng.generate(prompts, NEW, extra_inputs=extra).tokens, g0)
    np.testing.assert_array_equal(eng.await_result(eng.dispatch(
        prompts, NEW, extra_inputs=extra)).tokens, g0)


@pytest.mark.parametrize("arch,spec", [(a, s) for a, (_, ms) in CASES.items()
                                       for s in ms])
def test_reference_scheduler_on_the_same_mesh(arch, spec, ref):
    eng = _engine(arch, ref, spec)
    got = _serve(eng, _requests(arch, ref), "overlapped")
    want = ref[f"{arch}/{spec}/tokens"]
    assert [t for t, _ in got] == list(ref[f"{arch}/{spec}/tenants"])
    np.testing.assert_array_equal(np.stack([t for _, t in got]), want)


class _Keep:
    """``observe``: wraps the scheduler's ``step`` to keep its responses."""

    def __init__(self):
        self.sched, self.out = None, []

    def __call__(self, sched):
        if self.sched is None:
            self.sched, step = sched, sched.step

            def keep():
                r = step()
                self.out.extend((x.tenant, np.asarray(x.tokens))
                                for x in r or [])
                return r
            sched.step = keep


@pytest.mark.parametrize("mode", ["overlapped", "blocking"])
def test_serve_cli_mesh_1x2_slot_modes(mode, capsys):
    argv = ["--reduced", "--device", "cpu", "--mode", mode, "--requests",
            "6", "--new-tokens", "4"]
    runs = []
    for extra in ([], ["--mesh", "1x2"]):
        keep = _Keep()
        assert serve_cli.main(argv + extra, observe=keep) == 0
        runs.append(keep)
    a, b = runs
    assert b.sched.engine.sh.mesh.shape == {"data": 1, "model": 2}
    assert b.sched.engine.sh.mesh.position_devices() == [CPU, CPU]
    assert len(a.out) == len(b.out) == 6
    for (ta, x), (tb, y) in zip(a.out, b.out):
        assert ta == tb
        np.testing.assert_array_equal(x, y)
    assert f"schedule={mode}" in capsys.readouterr().out
