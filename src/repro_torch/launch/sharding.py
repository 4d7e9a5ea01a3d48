"""Partition rules: parameter / optimizer / batch / cache partition specs,
counterpart of ``repro/launch/sharding.py`` on ``torch.distributed``.

Scheme (the reference's baseline):
  * DP over ("pod", "data") — batch dims.
  * TP over "model" — Megatron column/row splits of every projection's
    non-d_model dim (heads*head_dim, d_ff, vocab, d_inner, experts).
  * EP: MoE expert axis (leading E of wg/wu/wd) over "model".
  * Decode caches: batch over DP when divisible, else sequence; heads over
    "model" when divisible, else sequence/feature.
Param leaves stacked by depth get a leading None (the depth axis is never
sharded).

A :class:`PartitionSpec` is the port's own: a tuple of ``None``, an axis
name or a tuple of axis names per tensor dim, the entries JAX's
``PartitionSpec`` holds. Paths are ``repro_torch.tree``'s (JAX's leaf
order and key names). The spec functions read only the mesh's axis names
and sizes (``mesh.mesh_dim_names``, ``mesh.shape``), so any object with
those two attributes stands in for a ``DeviceMesh``.
:func:`to_shardings` turns specs into DTensor placements on a mesh and
:func:`place` applies them.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Tuple

from torch.distributed.tensor import (Placement, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import tree
from repro_torch.models.lm.config import LMConfig, ShapeCell

__all__ = ["PartitionSpec", "P", "NamedSharding", "param_specs",
           "batch_specs", "cache_specs", "spec_items", "to_shardings",
           "placements", "place", "local_shape"]

M = "model"


class PartitionSpec(tuple):
    """Per tensor dim: ``None`` (replicated), an axis name, or a tuple of
    axis names (the dim split over their product, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(tuple(self))


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement on a mesh: one DTensor ``Placement`` per mesh
    dim, from its :class:`PartitionSpec`."""
    mesh: object
    placements: Tuple[Placement, ...]
    spec: PartitionSpec


def _axes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


# (regex, spec WITHOUT the stacked-depth axis). First match wins.
_PARAM_RULES = [
    # embeddings / head
    (r"^embed$", P(M, None)),
    (r"^lm_head$", P(None, M)),
    (r"^final_norm$", P(None)),
    # attention
    (r"attn/w[qkv]$", P(None, M)),
    (r"attn/wo$", P(M, None)),
    (r"attn/b[qkv]$", P(M)),
    (r"attn/tau$", P()),
    # dense mlp
    (r"mlp/(wg|wu|wi)$", P(None, M)),
    (r"mlp/wd$", P(M, None)),
    # moe (expert parallel on leading E)
    (r"moe/router$", P(None, None)),
    (r"moe/(wg|wu|wd)$", P(M, None, None)),
    # mamba2
    (r"(^|/)m/(w_z|w_x)$", P(None, M)),
    (r"(^|/)m/(w_B|w_C|w_dt)$", P(None, M)),
    (r"(^|/)m/conv_w$", P(None, M)),
    (r"(^|/)m/conv_b$", P(M)),
    (r"(^|/)m/(A_log|D|dt_bias)$", P(M)),
    (r"(^|/)m/norm_w$", P(M)),
    (r"(^|/)m/out_proj$", P(M, None)),
    # mlstm
    (r"b/(w_gate|w_up)$", P(None, M)),
    (r"b/w[qkv]$", P(None, M)),
    (r"b/wif$", P(None, None)),
    (r"b/norm_w$", P(M)),
    (r"b/down$", P(M, None)),
    # slstm
    (r"b/w_in$", P(None, M)),
    (r"b/r$", P(None, None, M)),
    (r"b/b$", P(M)),
    # layer norms
    (r"ln\d?$|/ln$", P(None)),
]


def _match_spec(path: str, shape, n_stack: int) -> PartitionSpec:
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            return P(*([None] * n_stack + list(spec)))
    return P(*([None] * len(shape)))


def _stack_depth(path: str, cfg: LMConfig) -> int:
    """How many leading stacked-depth axes this leaf carries."""
    if path.startswith("blocks/"):
        if cfg.block_pattern == "zamba2" and "/mamba/" in path:
            return 2      # (groups, mamba_per_attn, ...)
        if cfg.block_pattern == "xlstm" and "/mlstm/" in path:
            return 2
        return 1
    return 0


def _check_divisible(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    axes = _axes(mesh)
    ok = []
    for dim, s in zip(shape, spec):
        if s is None:
            ok.append(None)
            continue
        names = s if isinstance(s, tuple) else (s,)
        size = math.prod(axes[n] for n in names)
        ok.append(s if dim % size == 0 else None)
    return P(*ok)


def _map_with_path(fn, params):
    return tree.unflatten(params, {p: fn(p, x)
                                   for p, x in tree.items(params)})


def param_specs(abstract_params, cfg: LMConfig, mesh, policy: str = "tp"):
    """PartitionSpec tree matching an (abstract) param tree.

    policy:
      tp    - Megatron tensor parallel over "model" (the rules above)
      fsdp  - every matched weight shards its first non-depth dim over ALL
              mesh axes
      zero3 - like fsdp but over the "model" axis only; batch stays on the
              data axes
      cp    - weights stored sharded over the data axes on their output
              dim; the sequence goes over "model" between blocks
    """
    all_axes = tuple(mesh.mesh_dim_names)

    def leaf(p, x):
        shape = tuple(x.shape)
        # serve-quantized leaves are (w_q, w_scale) tuples: match the base
        # path; scales get the matched spec's LAST-dim entry only.
        is_scale = False
        if re.search(r"/(0|1)$", p):
            is_scale = p.endswith("/1")
            p = p[:-2]
        n_stack = _stack_depth(p, cfg)
        if is_scale:
            base = _match_spec(p, shape, n_stack)
            spec = [None] * len(shape)
            if len(base) >= 1 and len(shape) >= 1:
                spec[-1] = base[len(base) - 1] if len(base) == len(shape) \
                    else (base[-1] if base else None)
            return _check_divisible(P(*spec), shape, mesh)
        if policy in ("fsdp", "zero3", "cp"):
            matched = any(re.search(pat, p) for pat, _ in _PARAM_RULES)
            spec = [None] * len(shape)
            if policy == "cp":
                dp_axes = tuple(a for a in all_axes if a != M)
                dp_axes = dp_axes[0] if len(dp_axes) == 1 else dp_axes
                if matched and len(shape) > n_stack:
                    spec[-1] = dp_axes      # FSDP storage on the output dim
            else:
                shard_axes = all_axes if policy == "fsdp" else M
                if matched and len(shape) > n_stack:
                    spec[n_stack] = shard_axes
            spec = P(*spec)
        else:
            spec = _match_spec(p, shape, n_stack)
            if len(spec) < len(shape):  # pad missing minor axes
                spec = P(*(list(spec) + [None] * (len(shape) - len(spec))))
        return _check_divisible(spec, shape, mesh)

    return _map_with_path(leaf, abstract_params)


def batch_specs(cfg: LMConfig, cell: ShapeCell, mesh,
                policy: str = "tp") -> Dict[str, PartitionSpec]:
    names = tuple(mesh.mesh_dim_names)
    if policy == "fsdp":
        total = math.prod(_axes(mesh).values())
        dp = names if cell.global_batch % total == 0 \
            else tuple(a for a in names if a != M)
    else:
        dp = tuple(a for a in names if a != M)
    dp = dp[0] if len(dp) == 1 else dp
    if cell.kind == "decode" and cell.global_batch == 1:
        dp_b = None                 # batch=1: replicate batch
    else:
        dp_b = dp
    if cfg.frontend == "token":
        specs = {"tokens": P(dp_b, None)}
    else:
        specs = {"embeds": P(dp_b, None, None)}
    if cell.kind == "train":
        specs["labels"] = P(dp_b, None)
    return specs


def cache_specs(abstract_cache, cfg: LMConfig, cell: ShapeCell, mesh,
                mlstm_state_shard: bool = False):
    """Decode-cache specs: batch over DP if divisible else None; for KV
    caches, heads over model if divisible else the sequence axis.

    mlstm_state_shard: shard the mLSTM matrix state's d_k dim over
    "model" (the reference's measured default is False: replicate it over
    model, batch-shard only)."""
    axes = _axes(mesh)
    dp = tuple(a for a in mesh.mesh_dim_names if a != M)
    dp_size = math.prod(axes[a] for a in dp)
    dp = dp[0] if len(dp) == 1 else dp
    model_size = axes[M]

    def leaf(p, x):
        shape = tuple(x.shape)
        # leading axes: stacked groups (skip), then batch
        n_stack = _stack_depth(p, cfg) if p.startswith("blocks") else 0
        spec = [None] * len(shape)
        bdim = n_stack
        if shape[bdim] % dp_size == 0 and cell.global_batch > 1:
            spec[bdim] = dp
            batch_sharded = True
        else:
            batch_sharded = False
        if re.search(r"/(k|v|k_q|v_q|k_s|v_s)$", p):
            # (..., B, kv_heads, S, hd) or scales (..., B, kv_heads, S)
            hdim, sdim = bdim + 1, bdim + 2
            if shape[hdim] % model_size == 0:
                spec[hdim] = M
            elif shape[sdim] % model_size == 0:
                spec[sdim] = M
            if not batch_sharded and shape[sdim] % dp_size == 0 \
                    and spec[sdim] is None:
                spec[sdim] = dp     # long_500k: shard sequence over DP
        elif re.search(r"/ssm$", p):
            if shape[bdim + 1] % model_size == 0:
                spec[bdim + 1] = M   # heads
        elif re.search(r"/conv$", p):
            if shape[bdim + 2] % model_size == 0:
                spec[bdim + 2] = M   # d_inner
        elif re.search(r"/state$", p):   # mlstm (B, H, dk, dv)
            # the VALUE dim over model: aligned with column-parallel wv /
            # row-parallel down, so per-step read/write stay local
            if shape[bdim + 3] % model_size == 0:
                spec[bdim + 3] = M
            elif mlstm_state_shard and shape[bdim + 2] % model_size == 0:
                spec[bdim + 2] = M
        elif re.search(r"/norm$", p):    # mlstm normalizer (B, H, dk)
            pass  # batch-sharded only (tiny)
        elif re.search(r"/(h|c|n|m)$", p):  # slstm (B, d)
            if shape[bdim + 1] % model_size == 0:
                spec[bdim + 1] = M
        return P(*spec)

    return _map_with_path(leaf, abstract_cache)


def placements(spec: PartitionSpec, mesh) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``: an entry on tensor dim
    d becomes ``Shard(d)`` on its mesh dim (a tuple of axes: on each of
    them, in order); every other mesh dim is ``Replicate()``. A mesh dim
    of size 1 is ``Replicate()`` whatever the spec says: one device holds
    the whole dim, as JAX's ``NamedSharding`` over a size-1 axis is fully
    replicated (and DTensor before torch 2.13 refuses to view a dim
    sharded even over one device)."""
    sizes = _axes(mesh)
    out = [Replicate()] * len(mesh.mesh_dim_names)
    index = {n: i for i, n in enumerate(mesh.mesh_dim_names)}
    for d, s in enumerate(spec):
        for name in (() if s is None else s if isinstance(s, tuple)
                     else (s,)):
            if sizes[name] > 1:
                out[index[name]] = Shard(d)
    return tuple(out)


def spec_items(spec_tree, prefix: str = ""):
    """(path, PartitionSpec) pairs of a spec tree in JAX's leaf order."""
    if isinstance(spec_tree, PartitionSpec):
        return [(prefix, spec_tree)]
    if isinstance(spec_tree, dict):
        keys = sorted(spec_tree)
        pairs = [(str(k), spec_tree[k]) for k in keys]
    else:
        pairs = [(str(i), v) for i, v in enumerate(spec_tree)]
    return [kv for k, v in pairs
            for kv in spec_items(v, f"{prefix}/{k}" if prefix else k)]


def to_shardings(spec_tree, mesh):
    """A tree of :class:`NamedSharding` matching ``spec_tree``."""
    def walk(t):
        if isinstance(t, PartitionSpec):
            return NamedSharding(mesh, placements(t, mesh), t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            out = [walk(v) for v in t]
            return type(t)(out) if isinstance(t, tuple) else out
        return t
    return walk(spec_tree)


def local_shape(shape, spec: PartitionSpec, mesh) -> Tuple[int, ...]:
    """The per-device shard shape of a tensor of ``shape`` under ``spec``
    (every sharded dim divides: the rules keep only such entries)."""
    axes = _axes(mesh)
    out = list(shape)
    for d, s in enumerate(spec):
        if s is not None:
            names = s if isinstance(s, tuple) else (s,)
            out[d] //= math.prod(axes[n] for n in names)
    return tuple(out)


def place(values, shardings):
    """``values`` (a tree of tensors) as DTensors on each leaf's
    :class:`NamedSharding` (``distribute_tensor``)."""
    return tree.tree_map(lambda x, sh: distribute_tensor(x, sh.mesh,
                                                         sh.placements),
                         values, shardings)
