"""Virtual-accelerator multi-tenancy (the paper's core concept, §V-D2).

A :class:`VirtualDevicePool` maps ``#v = n_pdev * tenants_per_pdev`` virtual
devices onto ``n_pdev`` physical devices.  Work splits across *all* vdevs;
each pdev serialises its tenants (the paper: a GPU executes its tenants'
kernels one after the other), while tenant k+1's host->device staging
overlaps tenant k's compute — that overlap is where multi-tenancy wins
(Fig 13).

The pool only deals in work decomposition; the staging engine in
:mod:`repro_torch.core.transfer` deals in placement.  ``devices`` are
``torch.device`` objects, one per pdev (see :func:`resolve_devices`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class TenancyConfig:
    n_pdev: int                      # physical accelerators
    tenants_per_pdev: int = 1        # vGPUs per pGPU
    transfer_mode: str = "sequential"   # sequential | concurrent

    @property
    def n_vdev(self) -> int:
        return self.n_pdev * self.tenants_per_pdev

    def validate(self) -> None:
        assert self.n_pdev >= 1 and self.tenants_per_pdev >= 1
        assert self.transfer_mode in ("sequential", "concurrent")


@dataclasses.dataclass(frozen=True)
class TenantTask:
    """One virtual device's slice of the trial axis.

    ``padded_size`` (when set by :meth:`VirtualDevicePool.plan` with
    ``uniform=True``) is the uniform per-vdev shape every staged chunk is
    padded up to, so an uneven remainder does not produce a second launch
    shape: the stager pads the staged slice with neutral rows and the result
    is sliced back to ``size``.
    """
    vdev: int
    pdev: int
    slot: int                        # tenant index within its pdev
    start: int                       # trial-range [start, stop)
    stop: int
    padded_size: Optional[int] = None

    @property
    def size(self) -> int:
        return self.stop - self.start

    @property
    def pad(self) -> int:
        """Neutral rows appended when staged (0 without uniform planning)."""
        return 0 if self.padded_size is None else self.padded_size - self.size


class VirtualDevicePool:
    def __init__(self, cfg: TenancyConfig, devices: Optional[Sequence] = None):
        cfg.validate()
        self.cfg = cfg
        self.devices = list(devices) if devices is not None else None
        if self.devices is not None:
            assert len(self.devices) >= cfg.n_pdev, \
                f"need {cfg.n_pdev} devices, have {len(self.devices)}"

    # ------------------------------------------------------------------
    def vdev_to_pdev(self, vdev: int) -> Tuple[int, int]:
        """vdev id -> (pdev, slot).  vdevs are slot-major: vdevs [0, n_pdev)
        are every pdev's first tenant (the paper stages one tenant per pGPU
        first — Fig 13 timeline)."""
        slot, pdev = divmod(vdev, self.cfg.n_pdev)
        return pdev, slot

    def device_of(self, vdev: int):
        pdev, _ = self.vdev_to_pdev(vdev)
        return self.devices[pdev] if self.devices is not None else None

    # ------------------------------------------------------------------
    def uniform_size(self, num_items: int) -> int:
        """Per-vdev chunk shape when every slice is padded to a common size
        (= ceil(num_items / n_vdev)); one shape per deployment."""
        nv = self.cfg.n_vdev
        return -(-num_items // nv)

    def plan(self, num_items: int, uniform: bool = False) -> List[TenantTask]:
        """Even split of the work axis over all vdevs (remainder spread over
        the first vdevs), in *staging order*: slot-major so that every pdev's
        first tenant is staged before any second tenant.

        With ``uniform=True`` every task carries ``padded_size`` =
        :meth:`uniform_size`, so stagers pad ragged remainders to one common
        chunk shape instead of one launch shape per remainder.
        """
        nv = self.cfg.n_vdev
        base, rem = divmod(num_items, nv)
        sizes = [base + (1 if v < rem else 0) for v in range(nv)]
        padded = self.uniform_size(num_items) if uniform else None
        tasks, off = [], 0
        for v in range(nv):
            pdev, slot = self.vdev_to_pdev(v)
            tasks.append(TenantTask(v, pdev, slot, off, off + sizes[v],
                                    padded_size=padded))
            off += sizes[v]
        assert off == num_items
        return tasks

    def tasks_by_pdev(self, tasks: Sequence[TenantTask]) -> List[List[TenantTask]]:
        out: List[List[TenantTask]] = [[] for _ in range(self.cfg.n_pdev)]
        for t in tasks:
            out[t.pdev].append(t)
        for lst in out:
            lst.sort(key=lambda t: t.slot)
        return out


def memory_per_pdev_mb(tenants_per_pdev: int, n_pdev: int, yet_mb: float,
                       elt_mb: float, pf_mb: float) -> float:
    """Paper §V-F1 memory-capacity model: each tenant holds its YET slice plus
    a full ELT + PF copy.  (K20: 4 tenants -> 4x(1000+120+1) = 4484 MB.)"""
    nv = n_pdev * tenants_per_pdev
    return tenants_per_pdev * (yet_mb / nv + elt_mb + pf_mb)


def resolve_devices(n_pdev: int,
                    device: Union[None, str, torch.device] = None,
                    ) -> List[torch.device]:
    """One ``torch.device`` per pdev.

    ``device=None`` means the card: pdev ``p`` is ``cuda:p``.  There is no
    quiet retreat to the CPU — asking for CUDA (explicitly or by default)
    without enough CUDA devices raises; the CPU runs only when the caller
    names it (``device="cpu"``), and then hosts every pdev.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [dev] * n_pdev
    if dev.type != "cuda":
        raise ValueError(f"device {dev}: expected a cuda or cpu device")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the host")
    have = torch.cuda.device_count()
    first = dev.index or 0
    if first + n_pdev > have:
        raise RuntimeError(
            f"need {n_pdev} CUDA devices from cuda:{first}, have {have}")
    return [torch.device("cuda", first + p) for p in range(n_pdev)]
