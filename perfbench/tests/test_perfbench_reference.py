"""The plain references against cases worked by hand."""
import pathlib
import sys

import numpy as np
import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import lm, risk  # noqa: E402


def test_risk_reference_by_hand():
    # catalog rows 0..3, two ELTs; row 0 is no event
    elt = torch.tensor([[0.0, 0.0], [10.0, 4.0], [3.0, 30.0], [50.0, 1.0]])
    occ_ret = torch.tensor([2.0, 1.0])
    occ_lim = torch.tensor([20.0, 25.0])
    # f = [0, (8 + 3), (1 + 25), (20 + 0)] = [0, 11, 26, 20]
    f = risk.event_losses(elt, occ_ret, occ_lim)
    assert f.tolist() == [0.0, 11.0, 26.0, 20.0]
    yet = torch.tensor([[1, 2, 0], [3, 3, 1], [0, 0, 0]], dtype=torch.int32)
    # sums 37, 51, 0; terms: retention 5, limit 40
    ylt = risk.year_losses(yet, elt, occ_ret, occ_lim, 5.0, 40.0)
    assert ylt.tolist() == [32.0, 40.0, 0.0]
    assert risk.worst_gap(np.array([32.0, 39.0, 0.0]), ylt, 40.0) == 1 / 40


def test_risk_control_is_coarser():
    g = torch.Generator().manual_seed(3)
    elt = torch.exp(10 + 1.5 * torch.randn(500, 15, generator=g))
    yet = torch.randint(0, 500, (64, 200), generator=g, dtype=torch.int32)
    ret, lim = torch.full((15,), 5e3), torch.full((15,), 2e5)
    exact = risk.year_losses(yet, elt, ret, lim, 1e6, 3e7)
    low = risk.year_losses(yet, elt, ret, lim, 1e6, 3e7,
                           dtype=torch.bfloat16)
    assert risk.worst_gap(low.float(), exact, 3e7) > 1e-4


def _tiny(seed=0, L=2, d=16, H=4, Hkv=2, D=4, F=32, V=50):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    W = {"embedding": r(V, d), "unembed": r(d, V) * 0.5,
         "final_norm": 1 + 0.1 * r(d), "norm1": 1 + 0.1 * r(L, d),
         "norm2": 1 + 0.1 * r(L, d), "wq": r(L, d, H * D) / 4,
         "wk": r(L, d, Hkv * D) / 4, "wv": r(L, d, Hkv * D) / 4,
         "wo": r(L, H * D, d) / 4, "w_gate": r(L, d, F) / 4,
         "w_up": r(L, d, F) / 4, "w_down": r(L, F, d) / 6}
    cfg = {"num_layers": L, "num_heads": H, "num_kv_heads": Hkv,
           "head_dim": D, "rms_norm_eps": 1e-5, "rope_theta": 1e4,
           "vocab_size": V}
    return W, cfg


def test_lm_windowed_attention_reads_only_the_window():
    W, cfg = _tiny()
    tok = torch.randint(0, 50, (12,), generator=torch.Generator()
                        .manual_seed(1))
    wide = lm.logits(W, cfg, tok, 0, 100)
    # a window wider than the sequence is plain causal attention; a window
    # of w: position i's logits depend on tokens i-w+1..i only, here
    # through one attention layer each, so with two layers on 2w-1
    narrow = lm.logits(W, cfg, tok, 0, 3)
    assert torch.allclose(wide[:3], narrow[:3], atol=1e-5)
    assert not torch.allclose(wide[6:], narrow[6:], atol=1e-3)
    tok2 = tok.clone()
    tok2[0] = (tok[0] + 1) % 50
    moved = lm.logits(W, cfg, tok2, 0, 3)
    assert torch.allclose(narrow[5:], moved[5:], atol=1e-6)


def test_lm_rope_is_relative():
    """Rotary positions: q.k depends on the positions' difference only."""
    g = torch.Generator().manual_seed(2)
    q, k = torch.randn(1, 1, 8, generator=g), torch.randn(1, 1, 8,
                                                         generator=g)
    dots = []
    for p in (3, 10):
        a = lm.rope(q, torch.tensor([p]), 1e4)
        b = lm.rope(k, torch.tensor([p - 2]), 1e4)
        dots.append(float((a * b).sum()))
    assert dots[0] == pytest.approx(dots[1], rel=1e-5)


def test_token_gaps():
    ref = torch.tensor([[1.0, 3.0, 2.0], [0.0, -1.0, 5.0]])
    assert lm.token_gaps(ref, torch.tensor([[2], [2]])).tolist() == [1.0, 0.0]


def test_token_gaps_inside_the_top_k_read_nought():
    ref = torch.tensor([[1.0, 3.0, 2.0, -1.0], [0.0, -1.0, 5.0, 4.0]])
    # second best: 2.0 in the first row, 4.0 in the second
    assert lm.token_gaps(ref, torch.tensor([[2], [0]]), 2).tolist() == \
        [0.0, 4.0]
    # the widest gap of several tokens a position: the lowest of them
    assert lm.token_gaps(ref, torch.tensor([[1, 3], [2, 3]]), 2).tolist() \
        == [3.0, 0.0]


def test_fp8_weight_rounds_coarsely():
    w = torch.randn(64, 32, generator=torch.Generator().manual_seed(4))
    err = (lm.fp8_weight(w) - w).abs().max() / w.abs().max()
    assert 1e-3 < float(err) < 0.1
