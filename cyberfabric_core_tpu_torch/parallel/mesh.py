"""Rank devices and the collectives of tensor-parallel serving (counterpart
of ``parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives. The port runs tensor parallelism from a single controller, as
JAX's GSPMD engine does: one scheduler thread and one engine hold ``tp``
rank shard sets, each on its device from an explicit list, and the
collectives are plain functions with a fixed order:

- :meth:`RankMesh.all_reduce_sum` adds the ranks' row-parallel partial sums
  in rank order, in f32, on the first rank's device;
- :meth:`RankMesh.all_gather` concatenates the ranks' column slices (the
  vocab-sharded logits, a replicated pool's q/k/v) in rank order there;
- :meth:`RankMesh.scatter` hands a tensor of the first rank's device to
  every rank (a no-op for a rank on the same device).

Ranks may share a device: ``cpu`` for every rank on the CPU (the tests),
``cuda:0`` for every rank on a one-card machine. NCCL refuses two ranks on
one card, so the port does not build on ``torch.distributed``.

Training lays its devices out the same way: :class:`StageMesh` gives the
GPipe pipeline's ``pp`` stages × ``dp`` data-parallel rows one device each,
and ring attention takes its ``sp`` ranks as a :class:`RankMesh`. A hand-off
between stages or a ring rotation is ``.to(device)``, a no-op between two
entries on one device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..device import DeviceLike, resolve_device


class RankMesh:
    """``tp`` ranks, rank r on ``devices[r]`` (devices may repeat)."""

    def __init__(self, devices: Sequence[DeviceLike]) -> None:
        if not devices:
            raise ValueError("a mesh needs at least one rank device")
        self.devices = tuple(resolve_device(d) for d in devices)
        kinds = {d.type for d in self.devices}
        if len(kinds) > 1:
            raise ValueError(f"rank devices mix device types: {[str(d) for d in self.devices]}")

    @property
    def tp(self) -> int:
        return len(self.devices)

    @property
    def shared(self) -> bool:
        """Whether every rank lives on one device (one CUDA graph can then
        capture all of them)."""
        return len({str(d) for d in self.devices}) == 1

    def scatter(self, t: Optional[torch.Tensor]) -> list[Optional[torch.Tensor]]:
        """``t`` on every rank's device (the same tensor where it already
        is there); None stays None."""
        if t is None:
            return [None] * self.tp
        return [t if t.device == d else t.to(d) for d in self.devices]

    def all_reduce_sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The ranks' partial sums added in rank order, in f32, on the first
        rank's device; one rank's part is the sum, as it is."""
        home = self.devices[0]
        if len(parts) == 1:
            return parts[0].to(home)
        acc = parts[0].to(home, torch.float32)
        for p in parts[1:]:
            acc = acc + p.to(home, torch.float32)
        return acc

    def all_gather(self, parts: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
        """The ranks' slices concatenated in rank order along ``dim`` on the
        first rank's device."""
        home = self.devices[0]
        return torch.cat([p.to(home) for p in parts], dim=dim)

    def __repr__(self) -> str:
        return f"RankMesh(tp={self.tp}, devices={[str(d) for d in self.devices]})"


class StageMesh:
    """``pp`` pipeline stages × ``dp`` data-parallel rows: stage p's row d on
    ``devices[p * dp + d]`` (devices may repeat). Row 0's device is the
    stage's own: its layers and their optimizer moments live there."""

    def __init__(self, pp: int, dp: int, devices: Sequence[DeviceLike]) -> None:
        if pp < 1 or dp < 1 or len(devices) != pp * dp:
            raise ValueError(f"a pp={pp} x dp={dp} mesh needs {pp * dp} devices, "
                             f"have {len(devices)}")
        self.pp, self.dp = pp, dp
        self.rows = tuple(RankMesh(devices[p * dp:(p + 1) * dp]) for p in range(pp))

    def device(self, stage: int, row: int = 0) -> torch.device:
        return self.rows[stage].devices[row]

    def __repr__(self) -> str:
        return (f"StageMesh(pp={self.pp}, dp={self.dp}, "
                f"devices={[[str(d) for d in r.devices] for r in self.rows]})")


def cuda_rank_devices(tp: int) -> list[torch.device]:
    """The first ``tp`` CUDA cards; raises when fewer are visible (the JAX
    engine raises the same way when the mesh lacks devices)."""
    resolve_device("cuda")  # no card at all raises here
    have = torch.cuda.device_count()
    if have < tp:
        raise ValueError(f"tp={tp} needs {tp} CUDA devices, have {have} (pass the rank "
                         "devices explicitly to put several ranks on one card)")
    return [torch.device("cuda", i) for i in range(tp)]

