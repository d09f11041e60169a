"""Parameters of the JAX package's model as the port's parameter tree.

The reference's tree (``pp.split(build_model(cfg).init(key))[0]``) and the
port's (``build_model(cfg).init``) have the same keys and shapes:
``embed/embedding``, ``embed/unembed``, ``stages/sub0/attn/wq``, ...,
every ``stages`` leaf with the stage axis first; an encoder-decoder's
``enc_stages/attn/wq``, ``dec_stages/cross/wk``, ``enc_norm/scale``, ...,
the same way.  Given that tree with
numpy leaves, :func:`params_from_jax` returns the port's tensors, checking
every key, shape and dtype against what the port would build (the MoE
router, say, is float32 whatever the parameter type).  This is how
the tests hold the port to the reference on identical weights; the port's
own initialiser serves runs that need no such parity.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import ArchConfig


def _leaf(a: Any, want_dtype: torch.dtype, device, path: str
          ) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")    # writable, owned by the tensor
    if a.dtype.name == "bfloat16":           # ml_dtypes: no numpy twin
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if t.dtype != want_dtype:
        raise TypeError(f"{path}: leaf dtype {t.dtype}, expected "
                        f"{want_dtype}")
    return t.to(device)


def params_from_jax(cfg: ArchConfig, tree: Dict[str, Any],
                    device="cpu") -> Dict[str, Any]:
    """The port's parameter tree from the reference's (numpy leaves)."""
    from repro_torch.models.model import build_model
    template = build_model(cfg).init(0, "meta")

    def walk(tmpl, src, path):
        if isinstance(tmpl, dict):
            if not isinstance(src, dict) or set(src) != set(tmpl):
                got = sorted(src) if isinstance(src, dict) else type(src)
                raise KeyError(f"{path or '/'}: keys {got}, expected "
                               f"{sorted(tmpl)}")
            return {k: walk(tmpl[k], src[k], f"{path}/{k}") for k in tmpl}
        t = _leaf(src, tmpl.dtype, device, path)
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, expected "
                             f"{tuple(tmpl.shape)}")
        return t

    return walk(template, tree, "")
