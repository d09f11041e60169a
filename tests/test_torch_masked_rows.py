"""The continuous engine's masked rows and the paged decode kernel (K3).

A decode round runs every capacity row; rows that hold no live request are
masked.  Where no sublayer's MLP is MoE, no masked row's step reaches a live
row, so the engine hands the round's row mask to K3, which leaves masked
rows unread and gives them zeros (the reference computes them and throws
them away).  On the CPU, where K3 takes its plain version, these tests hold:

* a dense arch's engine (GQA, sliding window, encoder-decoder, the dense
  hybrid) with the mask: greedy rows token-exact with ``generate``, and every
  row -- greedy, temperature and top-k -- the tokens the same engine emits
  when its decode calls K3 without the mask (the call wrapped here);
* a MoE arch passes no mask and counts no ``round.masked_row_steps``; a
  dense one passes the mask to every K3 call and counts capacity x steps -
  live row-steps.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.obs.telemetry import Telemetry
from repro_torch.serving import continuous
from repro_torch.serving.continuous import ContinuousBatchingEngine
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.multitenant import Request

JAMBA = "jamba-1.5-large-398b"
# six rows for five requests: one row never holds a request, and rows that
# retire early stay masked beside the ones still decoding
KW = dict(capacity=6, page_size=8, inner_steps=3, max_prompt_len=16)
# (prompt length, new tokens, temperature, top-k) of each request
MIX = ((5, 4, 0.0, 0), (9, 11, 0.8, 0), (13, 7, 0.0, 0), (7, 9, 0.7, 3),
       (11, 5, 0.0, 0))


def _engine(arch):
    cfg = get_config(JAMBA if arch == "dense hybrid" else arch).reduced()
    if arch == "dense hybrid":
        cfg = dataclasses.replace(cfg, moe=None, moe_period=0)
    return ServingEngine(cfg, build_model(cfg).init(0, "cpu"), device="cpu")


def _requests(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(f"t{i}", rng.integers(1, cfg.vocab_size, n).astype(
        np.int32), max_new_tokens=new, temperature=temp, top_k=k, seed=i,
        extra_inputs=serve.synth_extra_inputs(cfg, rng) or None)
        for i, (n, new, temp, k) in enumerate(MIX)]


def _oracle(eng, ceng, req):
    """``generate`` on the prompt left-padded to its admission bucket."""
    b = ceng.bucket_len(req.prompt.size)
    padded = np.zeros((1, b), np.int32)
    padded[0, b - req.prompt.size:] = req.prompt
    extra = {k: np.asarray(v)[None]
             for k, v in (req.extra_inputs or {}).items()}
    return eng.generate(padded, max_new_tokens=req.max_new_tokens,
                        extra_inputs=extra or None).tokens[0]


def _serve(eng, reqs, monkeypatch, tel=None, drop_mask=False):
    """Run ``reqs`` through a fresh engine; returns the engine, each
    request's tokens and the row mask every K3 call got (None: no mask).
    With ``drop_mask`` the decode's K3 calls are made without the mask."""
    masks = []
    plain = pa.paged_attention_decode_plain

    def record(*a, row_mask=None, **kw):
        masks.append(None if row_mask is None else row_mask.clone())
        return plain(*a, row_mask=row_mask, **kw)

    layer = continuous.paged_attention_decode

    def unmasked(p, x, pool, pt, page, off, pos, cfg, pos_pool, sh=None,
                 row_mask=None):
        return layer(p, x, pool, pt, page, off, pos, cfg, pos_pool, sh)

    with monkeypatch.context() as m:
        m.setattr(pa, "paged_attention_decode_plain", record)
        if drop_mask:
            m.setattr(continuous, "paged_attention_decode", unmasked)
        ceng = ContinuousBatchingEngine(eng, telemetry=tel, **KW)
        done = {r.tenant: t for r, t in ceng.run_all(list(reqs))}
    assert not ceng.rejected and ceng.nonfinite_rows == 0
    ceng.assert_conserved()
    return ceng, done, masks


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-1.8b",
                                  "whisper-base", "dense hybrid"])
def test_dense_engine_skips_masked_rows_and_keeps_every_token(
        arch, monkeypatch):
    eng = _engine(arch)
    reqs = _requests(eng.cfg)
    ceng, got, masks = _serve(eng, reqs, monkeypatch)
    _, want, plain = _serve(eng, reqs, monkeypatch, drop_mask=True)
    assert ceng.skip_masked_rows
    assert masks and all(m is not None for m in masks)
    assert all(m is None for m in plain) and len(plain) == len(masks)
    # a row that never held a request is masked from the first step, rows
    # that retired early beside it later on
    assert not masks[0].all()
    assert min(int(m.sum()) for m in masks) < int(masks[0].sum())
    for r in reqs:
        np.testing.assert_array_equal(got[r.tenant], want[r.tenant],
                                      err_msg=r.tenant)
        if r.temperature <= 0:
            np.testing.assert_array_equal(got[r.tenant],
                                          _oracle(eng, ceng, r),
                                          err_msg=r.tenant)


@pytest.mark.parametrize("arch,moe", [("internlm2-1.8b", False),
                                      ("whisper-base", False),
                                      ("olmoe-1b-7b", True), (JAMBA, True)])
def test_masked_row_steps_counted_where_the_mask_is_passed(
        arch, moe, monkeypatch):
    """``round.masked_row_steps`` is capacity x steps - live row-steps over
    the run where the engine passes the mask (every K3 call takes it), and
    0 on a MoE arch, whose K3 calls take none."""
    eng = _engine(arch)
    modes = ContinuousBatchingEngine.supported_modes(eng.cfg)["continuous"]
    assert modes["exactness"] == ("statistical" if moe else "bitwise")
    tel = Telemetry(enabled=True)
    ceng, _, masks = _serve(eng, _requests(eng.cfg, seed=1), monkeypatch,
                            tel=tel)
    counted = tel.counter_snapshot().get("round.masked_row_steps", 0)
    assert masks and ceng.skip_masked_rows is not moe
    steps = ceng.rounds * ceng.inner_steps
    assert 0 < ceng.row_steps < steps * ceng.capacity
    if moe:
        assert all(m is None for m in masks) and counted == 0
    else:
        assert all(m is not None for m in masks)
        assert counted == steps * ceng.capacity - ceng.row_steps
        # every masked row-step was a row masked in K3's calls
        n_attn = len(masks) // steps
        assert n_attn * steps == len(masks)
        assert sum(int((~m).sum()) for m in masks[::n_attn]) == counted
