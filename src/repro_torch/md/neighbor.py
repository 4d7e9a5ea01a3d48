"""Verlet-skin neighbour lists for device-resident MD: counterpart of
``repro/md/neighbor.py``.

The sparse forward consumes static-shape ``(senders, receivers,
edge_mask)`` edge lists (``serving/bucketing.py``). MD builds them with
an enlarged ``cutoff + skin`` radius and reuses one while no atom has
moved more than ``skin / 2`` from its position at build time: under that
bound no pair can have closed by more than ``skin``, so every pair now
inside the true cutoff is in the list (zero missed edges). Before each
force call the mask is tightened to the true cutoff at the current
coordinates (``sparse_energy(refine_cutoff=True)``), so the edge set
entering the forward is exactly a fresh rebuild's.

Nothing here reads a tensor on the host. The JAX package rebuilds under
``lax.cond``; a branch on the expiry flag would cost a host sync per
step, so :func:`maybe_rebuild` builds a fresh list every step (one
``device_edge_list``: a (B, cap, cap) distance pass and a stable sort)
and keeps it or the old one with ``torch.where`` on the flag. Capacity
overflow is a sticky flag in the list, read by the MD engine at record
checkpoints.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.serving.bucketing import device_edge_list

__all__ = ["NeighborList", "build_neighbor_list", "needs_rebuild",
           "maybe_rebuild"]


class NeighborList(NamedTuple):
    """A skin edge list plus what decides when it expires.

    senders/receivers/edge_mask follow the ``bucketing.EdgeList`` layout
    (flat ``(B * edge_capacity,)`` tensors, per-molecule slot ranges,
    receiver-sorted real edges, masked self-loop padding); ``edge_mask``
    marks edges within ``cutoff + skin`` *at build time* and is refined to
    the true cutoff before use, while staying the edge softmax's layout.
    """
    senders: torch.Tensor     # (B * ec,) int32 flat node index of atom j
    receivers: torch.Tensor   # (B * ec,) int32 flat node index of atom i
    edge_mask: torch.Tensor   # (B * ec,) bool, True = within cutoff + skin
    ref_coords: torch.Tensor  # (B, cap, 3) coordinates at build time
    overflow: torch.Tensor    # () bool, sticky: some build overflowed ec
    n_rebuilds: torch.Tensor  # () int32, rebuilds since build_neighbor_list

    @property
    def edge_capacity(self) -> int:
        return self.senders.shape[0] // self.ref_coords.shape[0]


def build_neighbor_list(coords: torch.Tensor, mask: torch.Tensor,
                        cutoff: float, skin: float,
                        edge_capacity: int) -> NeighborList:
    """A fresh skin list at ``cutoff + skin``, on the device.

    coords: (B, cap, 3); mask: (B, cap) bool. ``skin = 0`` gives a plain
    cutoff list that :func:`needs_rebuild` expires on any motion: the
    rebuild-every-step reference the skin path is tested against.
    """
    senders, receivers, edge_mask, counts = device_edge_list(
        coords, mask, cutoff + skin, edge_capacity)
    return NeighborList(senders=senders, receivers=receivers,
                        edge_mask=edge_mask, ref_coords=coords,
                        overflow=(counts > edge_capacity).any(),
                        n_rebuilds=torch.zeros((), dtype=torch.int32,
                                               device=coords.device))


def needs_rebuild(nlist: NeighborList, coords: torch.Tensor,
                  mask: torch.Tensor, skin: float) -> torch.Tensor:
    """() bool tensor: has any real atom moved more than skin/2 since the
    build? While False the list still covers the true cutoff graph.
    ``>=`` makes ``skin = 0`` expire on any motion."""
    disp2 = ((coords - nlist.ref_coords) ** 2).sum(-1)          # (B, cap)
    disp2 = torch.where(mask, disp2, torch.zeros_like(disp2))
    return disp2.max() >= (0.5 * skin) ** 2


def maybe_rebuild(nlist: NeighborList, coords: torch.Tensor,
                  mask: torch.Tensor, cutoff: float,
                  skin: float) -> NeighborList:
    """The list rebuilt at ``coords`` if it has expired, else ``nlist``,
    selected on the device: a fresh list is built every step and each
    field is ``torch.where``-picked by the expiry flag, so no host sync.
    ``overflow`` is sticky and only a kept fresh list can raise it;
    ``n_rebuilds`` adds the flag."""
    expired = needs_rebuild(nlist, coords, mask, skin)
    fresh = build_neighbor_list(coords, mask, cutoff, skin,
                                nlist.edge_capacity)

    def pick(new, old):
        return torch.where(expired, new, old)
    return NeighborList(
        senders=pick(fresh.senders, nlist.senders),
        receivers=pick(fresh.receivers, nlist.receivers),
        edge_mask=pick(fresh.edge_mask, nlist.edge_mask),
        ref_coords=pick(coords, nlist.ref_coords),
        overflow=nlist.overflow | (expired & fresh.overflow),
        n_rebuilds=nlist.n_rebuilds + expired.to(torch.int32))
