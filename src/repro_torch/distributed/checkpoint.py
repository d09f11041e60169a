"""Checkpointing: tensor trees and serving-engine snapshots.

The JAX package's ``repro/distributed/checkpoint.py``; this module owns every
on-disk checkpoint format of the port.

**Trees** (nested dicts / lists of tensors or arrays)::

    <dir>/step_<N>/
        manifest.json        -- tree layout, shapes, dtypes
        leaf_<i>.npy         -- one file per leaf (on the host)
    <dir>/step_<N>.done      -- atomic commit marker

**Engine checkpoints** (crash-safe serving: the data plane to
:mod:`repro_torch.serving.journal`'s write-ahead control plane)::

    <dir>/engine_<N>/
        engine.json          -- json meta (slot records' scalars, chain
                                keys, the scheduler's queues, array index)
        arr_<i>.npy          -- one file per named array
    <dir>/engine_<N>.done    -- atomic commit marker

A save writes into ``*.tmp``, renames it, and writes the ``.done`` marker
last, so a SIGKILL mid-save leaves the previous checkpoint intact; readers
see only marked steps.  numpy has no bfloat16: a bfloat16 tensor is stored as
its ``uint8`` bytes with the dtype ``"bfloat16"`` recorded beside it, and
read back bit for bit.  Every leaf comes back as a host tensor.  A placed
leaf (:class:`repro_torch.distributed.sharding.ShardedTensor`, a train
state on a mesh) is written as its global tensor, the same file as with no
mesh; a restore whose target leaf is placed places it again.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import ShardedTensor


def _to_numpy(a: Any) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array plus the dtype to read it back as."""
    if isinstance(a, ShardedTensor):
        a = a.full("cpu")
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.reshape(-1).view(torch.uint8).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(a))
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, shape=None) -> torch.Tensor:
    """Inverse of :func:`_to_numpy`.  ``shape`` None: a bfloat16 array
    stored as the uint8 view of its last axis (the JAX package's form)."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr)).view(torch.bfloat16)
        return t if shape is None else t.reshape(shape)
    return torch.from_numpy(arr.astype(np.dtype(dtype), copy=False))


def _shape(leaf: Any) -> List[int]:
    return [int(d) for d in (leaf.shape if isinstance(leaf, ShardedTensor)
                             else np.shape(leaf))]


def _flatten(tree: Any, out: List[Any]) -> Any:
    """Leaves in order, and the tree's layout with leaves as None."""
    if isinstance(tree, dict):
        return {k: _flatten(tree[k], out) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, out) for v in tree]
    out.append(tree)
    return None


def _unflatten(layout: Any, leaves: List[Any], it=None) -> Any:
    it = iter(leaves) if it is None else it
    if isinstance(layout, dict):
        return {k: _unflatten(v, leaves, it) for k, v in layout.items()}
    if isinstance(layout, list):
        return [_unflatten(v, leaves, it) for v in layout]
    return next(it)


def _commit(directory: pathlib.Path, name: str, step: int, write) -> pathlib.Path:
    """``write(tmp_dir)`` into ``<name>_<step>.tmp``, rename it into place,
    then write the marker (last: the commit)."""
    tmp = directory / f"{name}_{step}.tmp"
    final = directory / f"{name}_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    write(tmp)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    (directory / f"{name}_{step}.done").write_text(str(step))
    return final


def _steps(directory, name: str, manifest: str) -> List[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return []
    steps = []
    for m in directory.glob(f"{name}_*.done"):
        try:
            s = int(m.stem.split("_")[1])
        except (IndexError, ValueError):
            continue
        if (directory / f"{name}_{s}" / manifest).exists():
            steps.append(s)
    return sorted(steps)


def _gc(directory, name: str, steps: List[int], keep_last: int) -> None:
    directory = pathlib.Path(directory)
    for s in steps[:-keep_last]:
        shutil.rmtree(directory / f"{name}_{s}", ignore_errors=True)
        (directory / f"{name}_{s}.done").unlink(missing_ok=True)


# ----------------------------------------------------------------------
# trees
# ----------------------------------------------------------------------
def save(directory, step: int, tree, keep_last: Optional[int] = 3
         ) -> pathlib.Path:
    """Copy every leaf to the host and write one .npy per leaf,
    atomically."""
    directory = pathlib.Path(directory)
    leaves: List[Any] = []
    layout = _flatten(tree, leaves)

    def write(tmp: pathlib.Path) -> None:
        manifest: Dict[str, Any] = {"step": step, "num_leaves": len(leaves),
                                    "layout": layout, "leaves": []}
        for i, leaf in enumerate(leaves):
            arr, dtype = _to_numpy(leaf)
            np.save(tmp / f"leaf_{i}.npy", arr)
            manifest["leaves"].append({"shape": _shape(leaf),
                                       "dtype": dtype})
        (tmp / "manifest.json").write_text(json.dumps(manifest))

    final = _commit(directory, "step", step, write)
    if keep_last:
        gc_old(directory, keep_last)
    return final


def save_async(directory, step: int, tree, keep_last: Optional[int] = 3
               ) -> threading.Thread:
    """Copy the tree to the host now, write it to disk in a thread (the
    caller continues while the file I/O drains)."""
    leaves: List[Any] = []
    layout = _flatten(tree, leaves)
    host = [leaf.full("cpu") if isinstance(leaf, ShardedTensor)
            else leaf.detach().to("cpu", copy=True)
            if isinstance(leaf, torch.Tensor) else np.array(leaf)
            for leaf in leaves]
    t = threading.Thread(target=save, daemon=True,
                         args=(directory, step, _unflatten(layout, host),
                               keep_last))
    t.start()
    return t


def available_steps(directory) -> List[int]:
    return _steps(directory, "step", "manifest.json")


def latest_step(directory) -> Optional[int]:
    steps = available_steps(directory)
    return steps[-1] if steps else None


def restore(directory, step: int, target_tree, device=None):
    """Load the leaves of ``step`` into the layout of ``target_tree`` (its
    values give the expected shapes and dtypes) as tensors on ``device``
    (default: the host); a placed target leaf comes back placed as it is,
    on its mesh."""
    directory = pathlib.Path(directory) / f"step_{step}"
    manifest = json.loads((directory / "manifest.json").read_text())
    leaves: List[Any] = []
    layout = _flatten(target_tree, leaves)
    assert manifest["num_leaves"] == len(leaves), \
        f"leaf count mismatch: ckpt {manifest['num_leaves']} vs {len(leaves)}"
    out = []
    for i, (ref, info) in enumerate(zip(leaves, manifest["leaves"])):
        want = tuple(_shape(ref))
        assert tuple(info["shape"]) == want, \
            f"leaf {i}: ckpt shape {tuple(info['shape'])} != target {want}"
        t = _from_numpy(np.load(directory / f"leaf_{i}.npy"),
                        info["dtype"], info["shape"])
        if isinstance(ref, ShardedTensor):
            out.append(sharding.layout(t.to(ref.dtype), ref.mesh, ref.spec))
            continue
        if isinstance(ref, torch.Tensor):
            t = t.to(ref.dtype)
        out.append(t if device is None else t.to(device))
    return _unflatten(layout, out)


def gc_old(directory, keep_last: int) -> None:
    _gc(directory, "step", available_steps(directory), keep_last)


# ----------------------------------------------------------------------
# engine checkpoints (crash-safe serving)
# ----------------------------------------------------------------------
def save_engine_checkpoint(directory, step: int, meta: Dict[str, Any],
                           arrays: Dict[str, Any],
                           keep_last: Optional[int] = 3) -> pathlib.Path:
    """Atomically write one serving-engine checkpoint: json-able ``meta``
    plus a flat dict of named tensors or arrays (names are free-form, e.g.
    ``live/0/kv/sub0/k``); the name -> file index rides the meta."""
    directory = pathlib.Path(directory)
    names = sorted(arrays)

    def write(tmp: pathlib.Path) -> None:
        dtypes, shapes = {}, {}
        for i, name in enumerate(names):
            arr, dtypes[name] = _to_numpy(arrays[name])
            shapes[name] = list(np.shape(arrays[name]))
            np.save(tmp / f"arr_{i}.npy", arr)
        doc = {"step": step, "version": 1, "array_names": names,
               "array_dtypes": dtypes, "array_shapes": shapes, "meta": meta}
        (tmp / "engine.json").write_text(json.dumps(doc))

    final = _commit(directory, "engine", step, write)
    if keep_last:
        _gc(directory, "engine", engine_checkpoint_steps(directory),
            keep_last)
    return final


def engine_checkpoint_steps(directory) -> List[int]:
    """Committed (``.done``-marked, manifest present) engine steps."""
    return _steps(directory, "engine", "engine.json")


def latest_engine_step(directory) -> Optional[int]:
    steps = engine_checkpoint_steps(directory)
    return steps[-1] if steps else None


def load_engine_checkpoint(directory, step: Optional[int] = None):
    """Load a committed engine checkpoint (``step=None``: the latest).
    Returns ``(meta, arrays)`` with host tensors -- the inverse of
    :func:`save_engine_checkpoint` -- or ``(None, None)`` when the directory
    holds no committed step."""
    if step is None:
        step = latest_engine_step(directory)
        if step is None:
            return None, None
    directory = pathlib.Path(directory) / f"engine_{step}"
    doc = json.loads((directory / "engine.json").read_text())
    dtypes = doc.get("array_dtypes", {})
    shapes = doc.get("array_shapes", {})
    arrays = {}
    for i, name in enumerate(doc["array_names"]):
        arr = np.load(directory / f"arr_{i}.npy")
        arrays[name] = _from_numpy(arr, dtypes.get(name, str(arr.dtype)),
                                   shapes.get(name))
    return doc["meta"], arrays
