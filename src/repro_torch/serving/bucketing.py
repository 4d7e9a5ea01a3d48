"""Shape-class bucketing for variable-size molecular graphs.

Counterpart of ``repro/serving/bucketing.py``: the numpy host builders,
copied so both packages batch, pad and build edge lists identically for
the same graphs. Graphs are assigned to an atom-capacity bucket and
stacked into batches whose row count ``batch * capacity`` is a multiple
of 128 (the JAX package's MXU contract, kept so the two packages form the
same batches); dummy all-padding molecules fill the surplus rows.

Every bucket also carries an edge capacity for the sparse path:
``build_edge_list`` fills each molecule's slots with its real cutoff-graph
edges (sorted by receiver) and pads the rest with masked self-loops on
the molecule's first atom. The edge-softmax kernel relies on that layout
(``kernels/csrc/edge_softmax.cu``). ``device_edge_list`` builds the same
layout from device tensors with no host sync, for MD's skin lists.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Graph", "BucketSpec", "BatchPlan", "EdgeList", "assign_bucket",
           "plan_batches", "pad_graphs", "build_edge_list",
           "count_edges", "default_edge_capacity", "device_edge_list",
           "random_graph", "random_graphs", "MXU_LANE", "EDGE_LANE"]

MXU_LANE = 128  # minor-dim tile side of the TPU MXU; the 128-alignment contract
EDGE_LANE = 128  # edge slots are padded to a multiple of this (kernel block)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def default_edge_capacity(capacity: int) -> int:
    """Default per-molecule edge-slot count for a bucket.

    Small buckets get the complete graph (n*(n-1) directed pairs — no graph
    can overflow); from ~32 atoms up the capacity is clamped to an average
    degree of 16 neighbours, the regime where the sparse path wins. Always
    a multiple of EDGE_LANE. Molecules denser than the capacity fall back
    to the dense path at plan time (see ``QuantizedEngine``).
    """
    full = capacity * (capacity - 1)
    return _round_up(max(1, min(full, capacity * 16)), EDGE_LANE)


@dataclasses.dataclass(frozen=True)
class Graph:
    """One molecule: integer species codes (n,) and coordinates (n, 3)."""
    species: np.ndarray
    coords: np.ndarray

    @property
    def n_atoms(self) -> int:
        return int(self.species.shape[0])


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """A shape class: molecules padded to ``capacity`` atoms, batched in
    groups rounded up to a batch class with ``rows % 128 == 0``.

    ``edge_capacity`` is the per-molecule edge-slot count for the sparse
    path (None -> ``default_edge_capacity(capacity)``); it must be a
    multiple of EDGE_LANE so the segment-softmax kernel's edge blocks
    tile exactly.
    """
    capacity: int          # padded atom count per molecule
    max_batch: int = 64    # upper bound on molecules per compiled batch
    edge_capacity: Optional[int] = None  # per-molecule edge slots (sparse)

    @property
    def edges(self) -> int:
        ec = (default_edge_capacity(self.capacity)
              if self.edge_capacity is None else self.edge_capacity)
        if ec % EDGE_LANE != 0:
            raise ValueError(
                f"edge_capacity {ec} is not a multiple of {EDGE_LANE}")
        return ec

    def batch_class(self, n_graphs: int) -> int:
        """Smallest admissible batch size >= n_graphs: a power of two,
        clamped to max_batch, then rounded up so batch*capacity is a
        multiple of MXU_LANE (128)."""
        b = 1
        while b < min(n_graphs, self.max_batch):
            b *= 2
        b = min(b, self.max_batch)
        # enforce the row-alignment contract: batch * capacity % 128 == 0
        while (b * self.capacity) % MXU_LANE != 0:
            b *= 2
        return b


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """One compiled dispatch: which input graphs ride in which rows."""
    bucket: BucketSpec
    batch_size: int                 # rows in the stacked batch (incl. dummies)
    graph_indices: Tuple[int, ...]  # positions in the caller's graph list


def assign_bucket(n_atoms: int, buckets: Sequence[BucketSpec]) -> BucketSpec:
    """Smallest bucket whose capacity holds the graph. Raises if none fits."""
    for b in sorted(buckets, key=lambda b: b.capacity):
        if n_atoms <= b.capacity:
            return b
    raise ValueError(
        f"graph with {n_atoms} atoms exceeds the largest bucket "
        f"({max(b.capacity for b in buckets)}); extend the bucket ladder")


def random_graph(rng: np.random.Generator, n_atoms: int, n_species: int,
                 density: Optional[float] = None) -> Graph:
    """One random molecule — the same recipe as the JAX package's, so
    both packages draw the same molecules from the same seed.

    ``density`` (atoms per cubic Angstrom) places atoms uniformly in a
    cube whose volume grows with n, so the cutoff graph has a
    size-independent average degree — the physical regime where the
    sparse path's O(E) beats the dense O(n^2). The default (None) is
    the legacy normal(0, 2) cloud, nearly fully connected under typical
    cutoffs.
    """
    if density is None:
        coords = rng.normal(size=(n_atoms, 3)) * 2.0
    else:
        side = (n_atoms / density) ** (1.0 / 3.0)
        coords = rng.uniform(0.0, side, size=(n_atoms, 3))
    return Graph(
        species=rng.integers(0, n_species, n_atoms).astype(np.int32),
        coords=coords.astype(np.float32))


def random_graphs(n_graphs: int, min_atoms: int, max_atoms: int,
                  n_species: int, seed: int = 0,
                  density: Optional[float] = None) -> List[Graph]:
    """Uniform random molecules for benchmarks and smoke runs (sizes
    uniform in [min_atoms, max_atoms]; see :func:`random_graph` for the
    per-molecule recipe and the meaning of ``density``)."""
    rng = np.random.default_rng(seed)
    return [random_graph(rng, int(rng.integers(min_atoms, max_atoms + 1)),
                         n_species, density)
            for _ in range(n_graphs)]


def plan_batches(graphs: Sequence[Graph],
                 buckets: Sequence[BucketSpec]) -> List[BatchPlan]:
    """Group graphs into per-bucket batches of bounded shape classes."""
    by_bucket: Dict[int, List[int]] = {}
    spec_of: Dict[int, BucketSpec] = {}
    for gi, g in enumerate(graphs):
        spec = assign_bucket(g.n_atoms, buckets)
        by_bucket.setdefault(spec.capacity, []).append(gi)
        spec_of[spec.capacity] = spec
    plans: List[BatchPlan] = []
    for cap in sorted(by_bucket):
        spec, idxs = spec_of[cap], by_bucket[cap]
        for lo in range(0, len(idxs), spec.max_batch):
            chunk = idxs[lo:lo + spec.max_batch]
            plans.append(BatchPlan(bucket=spec,
                                   batch_size=spec.batch_class(len(chunk)),
                                   graph_indices=tuple(chunk)))
    return plans


def pad_graphs(graphs: Sequence[Graph], plan: BatchPlan,
               pad_species: int = 0):
    """Stack a plan's graphs into dense arrays with a validity mask.

    Returns (species (B, cap) int32, coords (B, cap, 3) f32,
    mask (B, cap) bool). Rows beyond ``len(plan.graph_indices)`` are dummy
    all-padding molecules added only to satisfy the 128-row alignment.
    Padded atoms get ``pad_species`` and coordinates far outside any cutoff
    sphere would be wrong — they get zeros, and the forward pass masks them
    out of the neighbour graph explicitly, so their values never matter.
    """
    cap, B = plan.bucket.capacity, plan.batch_size
    species = np.full((B, cap), pad_species, dtype=np.int32)
    coords = np.zeros((B, cap, 3), dtype=np.float32)
    mask = np.zeros((B, cap), dtype=bool)
    for row, gi in enumerate(plan.graph_indices):
        g = graphs[gi]
        n = g.n_atoms
        species[row, :n] = np.asarray(g.species, dtype=np.int32)
        coords[row, :n] = np.asarray(g.coords, dtype=np.float32)
        mask[row, :n] = True
    return species, coords, mask


# ---------------------------------------------------------------------------
# neighbour lists (the sparse serving path)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EdgeList:
    """Padded edge list for one batch, flat-indexed into ``(B * cap,)``.

    Layout contract (what ``kernels/csrc/edge_softmax.cu`` assumes):

    * molecule ``b`` owns edge slots ``[b * edge_capacity, (b+1) * ec)``
      exclusively — edges never cross molecule slot ranges;
    * within a molecule's range, real edges come first, **sorted by
      receiver**, followed by masked padding edges;
    * padding edges are self-loops on the molecule's first atom slot
      (sender == receiver == b * cap) with ``edge_mask == False``;
    * ``receivers[e] // cap == senders[e] // cap == e // edge_capacity``
      for every slot, masked or not.
    """
    senders: np.ndarray        # (B * ec,) int32, flat node index of atom j
    receivers: np.ndarray      # (B * ec,) int32, flat node index of atom i
    edge_mask: np.ndarray      # (B * ec,) bool, True = real cutoff edge
    edge_capacity: int         # ec: slots per molecule
    n_real: int                # total real edges across the batch


def _pair_adjacency(coords: np.ndarray, mask: np.ndarray,
                    cutoff: float) -> np.ndarray:
    """Host-side cutoff-graph adjacency (B, cap, cap): d < cutoff, no
    self-pairs, both atoms real — the single numpy mirror of the dense
    forward's ``pair_geometry`` predicate (keep the two in sync)."""
    d = np.linalg.norm(coords[:, :, None, :] - coords[:, None, :, :], axis=-1)
    cap = coords.shape[1]
    return ((d < cutoff) & ~np.eye(cap, dtype=bool)[None]
            & mask[:, :, None] & mask[:, None, :])


def count_edges(coords: np.ndarray, mask: np.ndarray,
                cutoff: float) -> np.ndarray:
    """Directed cutoff-graph edge count per molecule. coords: (B, cap, 3),
    mask: (B, cap) -> (B,) int. Used at plan time to decide whether a
    batch fits a bucket's edge capacity."""
    return _pair_adjacency(coords, mask, cutoff).sum(axis=(1, 2))


def build_edge_list(coords: np.ndarray, mask: np.ndarray, cutoff: float,
                    edge_capacity: int) -> Optional[EdgeList]:
    """Host-side neighbour-list construction for a padded batch.

    coords: (B, cap, 3) f32, mask: (B, cap) bool. Emits the exact edge set
    of the dense forward's ``pair_mask`` (d < cutoff, no self-pairs, both
    atoms real), receiver-sorted, padded to ``edge_capacity`` slots per
    molecule. Returns None when any molecule's edge count exceeds the
    capacity — the caller falls back to the dense path for this batch.

    Fully vectorized over the batch (no per-molecule Python loop — this
    runs per dispatch on the serving hot path): a stable argsort over each
    molecule's flattened adjacency moves edge positions to the front in
    row-major (= receiver-sorted) order, mirroring ``np.nonzero``.
    """
    B, cap = mask.shape
    ec = edge_capacity
    pair = _pair_adjacency(coords, mask, cutoff)             # (B, cap, cap)
    counts = pair.sum(axis=(1, 2))
    if (counts > ec).any():
        return None

    flat = pair.reshape(B, cap * cap)
    k = min(ec, cap * cap)
    # stable sort: edge positions (True) first, original order preserved
    order = np.argsort(~flat, axis=1, kind="stable")[:, :k]  # (B, k)
    valid = np.take_along_axis(flat, order, axis=1)          # (B, k)
    # padding slots: masked self-loops on the molecule's first atom,
    # so every index stays inside molecule b's node range
    i = np.where(valid, order // cap, 0)
    j = np.where(valid, order % cap, 0)
    base = (np.arange(B) * cap)[:, None]
    receivers = np.zeros((B, ec), dtype=np.int32)
    senders = np.zeros((B, ec), dtype=np.int32)
    edge_mask = np.zeros((B, ec), dtype=bool)
    receivers[:, :k] = base + i
    senders[:, :k] = base + j
    edge_mask[:, :k] = valid
    receivers[:, k:] = base
    senders[:, k:] = base
    return EdgeList(senders=senders.reshape(-1),
                    receivers=receivers.reshape(-1),
                    edge_mask=edge_mask.reshape(-1), edge_capacity=ec,
                    n_real=int(counts.sum()))


def device_edge_list(coords: torch.Tensor, mask: torch.Tensor,
                     cutoff: float, edge_capacity: int):
    """:func:`build_edge_list` on the device, with no host sync.

    coords: (B, cap, 3) f32, mask: (B, cap) bool tensors on one device.
    Same layout contract (per-molecule slot ranges, real edges first in
    row-major (i, j) order, i.e. receiver-sorted, then masked self-loops
    on the molecule's first atom slot), built by a stable sort of each
    molecule's flattened adjacency so the slot order is the host
    builder's. Instead of the host builder's ``None`` it returns
    ``(senders, receivers, edge_mask, counts)`` with ``counts`` (B,) the
    per-molecule real-edge count: the list is valid only where
    ``counts <= edge_capacity``, which the caller checks at a sync point
    of its own. The predicate is ``d^2 < cutoff^2``, as in
    ``kernels.ops.refine_edge_mask``.
    """
    B, cap = mask.shape
    ec = edge_capacity
    dev = coords.device
    rij = coords[:, :, None, :] - coords[:, None, :, :]      # [b, i, j]
    d2 = (rij * rij).sum(-1)
    eye = torch.eye(cap, dtype=torch.bool, device=dev)
    adj = ((d2 < cutoff * cutoff) & ~eye & mask[:, :, None]
           & mask[:, None, :])                               # (B, cap, cap)
    flat = adj.reshape(B, cap * cap)
    counts = flat.sum(1)

    k = min(ec, cap * cap)
    # stable: edge positions first, in row-major order (CUDA sorts no
    # bool, hence the cast)
    order = torch.argsort((~flat).to(torch.uint8), dim=1,
                          stable=True)[:, :k]
    valid = torch.take_along_dim(flat, order, dim=1)         # (B, k)
    order = order.to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    i = torch.where(valid, order // cap, zero)
    j = torch.where(valid, order % cap, zero)
    if k < ec:
        pad = (0, ec - k)
        i = torch.nn.functional.pad(i, pad)
        j = torch.nn.functional.pad(j, pad)
        valid = torch.nn.functional.pad(valid, pad)
    base = (torch.arange(B, dtype=torch.int32, device=dev) * cap)[:, None]
    return ((base + j).reshape(-1), (base + i).reshape(-1),
            valid.reshape(-1), counts)
