"""The port's LM training path against the JAX package on the CPU:
``qlinear``'s QAT W4A8 branch, ``lm_loss``'s gradient
(``launch.steps.lm_value_and_grad`` against eager
``jax.value_and_grad(lm_loss)``, as ``tests/test_arch_smoke.py`` calls
it), ``AdamW`` over nested trees, ``make_train_step``, and the abstract
trees (``abstract_params``, ``abstract_cache``, ``abstract_opt_state``)
against ``jax.eval_shape``'s.

Every tree is built by the JAX ``init_lm(PRNGKey(0))`` of the smoke
config (random QKV biases and per-layer ``tau`` added with numpy, so
those paths carry weight) and crosses over as numpy
(``weights.lm_params_from_numpy``); float32, B = 2, S = 64.

Tolerances (the largest gaps measured here, at these seeds, are in
brackets):
- ``qlinear`` QAT: ``wq`` and ``xq`` bit for bit; ``y`` to 1e-6 relative
  and ``dx``, ``dw`` to 1e-6 of their largest |value|, with the
  abs-max entries placed exactly on +-qmax (gradient 0.5).
- ``lm_loss``: the loss to ``LOSS_TOL`` = 1e-6 relative [2.6e-7] and
  every gradient leaf to ``GRAD_TOL`` = 1e-5 of its largest |g| [4.0e-6
  plain, with remat; 2.7e-6 QAT with JAX's sites pinned]: float32 sums
  the products in another order in each package.
- QAT (trap of A8 near ties, and of jitted XLA): even eager
  ``jax.value_and_grad`` compiles ``lax.scan``'s body, where XLA divides
  by the abs-max scale with a reciprocal multiply, so the abs-max entry of
  a W4 column lands an ulp off qmax and its clip gate is 1 or 0 where the
  port's exact division gives 0.5. JAX's sites (every ``x / scale`` of
  ``fake_quant_ste``) are recorded from inside that program
  (:func:`jax_sites`, ``jax.debug.callback``) and the port's beside them
  (``tools.lm_train_gap.qat_sites``, which ``chip_smoke.py`` phase 11
  also uses): the W4 codes must match bit for bit; a case that misses
  its tolerance must show a moved code or gate (``moved_sites``); then
  the port runs again with JAX's values pinned at every site and must
  hold the tolerance.
- ``AdamW`` over nested trees: every leaf to 1e-6 relative over 3 steps.
- ``make_train_step``: each step's loss to 1e-4 relative over 3 steps,
  against the JAX step jitted (its QAT sites recorded from inside
  the program and pinned as above).
- ``make_train_step(grad_specs=...)`` on DTensor parameters over the
  (1, 1) gloo mesh, one arch of each family: bit for bit against the
  plain step (loss, updated parameters, both moments); the mesh's group
  is destroyed in a ``finally``.
"""
import contextlib
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro import configs as jconfigs
from repro.core import quantizers as jq
from repro.launch import steps as jsteps
from repro.models.lm import layers as jlayers
from repro.models.lm import transformer as jtfm
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as j_cosine
from repro_torch import configs, tree
from repro_torch.core import quantizers as tq
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.lm import layers as tlayers
from repro_torch.models.lm import transformer as tfm
from repro_torch.models.lm.config import ShapeCell
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.tools.lm_train_gap import jitter_embed, moved_sites
from repro_torch.tools.lm_train_gap import qat_sites as port_sites
from repro_torch.tools.lm_train_gap import tree_gaps
from repro_torch.tools.so3_grad_conditioning import N_JITTERS
from repro_torch.weights import lm_params_from_numpy

ARCHS = configs.ARCH_IDS
# the transformer-pattern archs without MoE blocks; the other families'
# gradients: tests/test_torch_lm_{moe,ssm,xlstm}.py
DENSE = tuple(a for a in ARCHS
              if configs.get_config(a).block_pattern == "transformer"
              and not configs.get_config(a).moe)
B, S = 2, 64
LOSS_TOL, GRAD_TOL = 1e-6, 1e-5
F32_GRAD_FACTOR = 8.0        # chip_smoke.py's, phases 8 and 11


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch, mode="none", **extra):
    kw = dict(dtype=jnp.float32, attn_chunk_q=32, quant_mode=mode, **extra)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **kw)
    kw["dtype"] = torch.float32
    return jcfg, dataclasses.replace(configs.get_smoke_config(arch), **kw)


@functools.lru_cache(maxsize=None)
def _jax_tree(arch):
    """The JAX ``init_lm(PRNGKey(0))`` tree of the smoke config, with
    random QKV biases and tau, as numpy (shared; never written to)."""
    params = jax.tree.map(np.asarray, jax.jit(
        jtfm.init_lm, static_argnums=1)(jax.random.PRNGKey(0),
                                        jconfigs.get_smoke_config(arch)))
    rng = np.random.default_rng(1)
    # the layers' attention, or zamba2's shared block's
    for a in (params["blocks"].get("attn"),
              params.get("shared", {}).get("attn")):
        for name in ("bq", "bk", "bv"):
            if a is not None and name in a:
                a[name] = (rng.normal(size=a[name].shape) * 0.1).astype(
                    np.float32)
        if a is not None and "tau" in a:
            a["tau"] = rng.uniform(4.0, 12.0, a["tau"].shape).astype(
                np.float32)
    return params


def _batch(cfg, seed=1, mask=False):
    """A numpy batch: tokens (or embeddings), labels, optionally a
    partial mask."""
    rng = np.random.default_rng(seed)
    key = "tokens" if cfg.frontend == "token" else "embeds"
    x = (rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
         if key == "tokens"
         else rng.normal(size=(B, S, cfg.d_model)).astype(np.float32))
    out = {key: x,
           "labels": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
    if mask:
        out["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return out


def _leaf_gaps(got, want):
    """{path: |got - want|max / |want|max} over the leaves of two trees."""
    want = dict(tree.items(jax.tree.map(np.asarray, want)))
    return {k: float(np.abs(_np(g) - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-30))
            for k, g in tree.items(got)}


# --- quantization sites ------------------------------------------------------

def _kind(bits, channel_axis):
    """The port's site kinds (``tools.lm_train_gap.qat_sites``)."""
    return f"{'w' if channel_axis is not None else 'a'}{tq.qmax(bits)}"


@contextlib.contextmanager
def jax_sites(runs=1, groups=None):
    """While active, every ``fake_quant_ste`` of the JAX package's
    ``qlinear`` reports its ``x / scale`` from inside the program that ran
    it (``jax.debug.callback``; the function is recomputed here as the
    reference computes it, so the value is the one its clip and rounding
    saw). Yields a list that is filled, when the block ends, with
    ``runs`` lists of (kind, value) per site, one for each of the
    ``runs`` calls of the program in the block (a jitted program traces
    once and calls back on every call): group by group (the outer scan's
    iterations), within a group in call order. A scan nested in the
    group's body (zamba2's Mamba2 blocks, xlstm's mLSTM blocks) calls
    back once per inner iteration: its sites, consecutive in trace order
    and called back more often than the group's own, are laid out
    iteration by iteration where the body runs them. ``groups``: the
    outer scan's length (by default the fewest calls of any site)."""
    calls, order, out = {}, [], []
    orig = jlayers.fake_quant_ste

    def rec(x, bits=8, channel_axis=None, scale=None):
        if scale is None:
            scale = jq.abs_max_scale(jax.lax.stop_gradient(x), bits,
                                     channel_axis)
        y = x / scale
        key = (len(order), _kind(bits, channel_axis))
        order.append(key)
        jax.debug.callback(
            lambda v: calls.setdefault(key, []).append(np.array(v)), y)
        m = jq.qmax(bits)
        return jq._ste_round(jnp.clip(y, -m, m)) * scale

    jlayers.fake_quant_ste = rec
    try:
        yield out
    finally:
        jlayers.fake_quant_ste = orig
    # a body traced twice leaves keys that never ran
    keys = [k for k in order if k in calls]
    if groups is None:
        groups = min((len(calls[k]) for k in keys), default=0) // runs
    segments = []              # (calls per group, keys), in trace order
    for k in keys:
        n = len(calls[k]) // runs
        assert n * runs == len(calls[k]), (k, len(calls[k]))
        # 0: a site of a loop invariant (the W4 codes of zamba2's shared
        # block), which autodiff hoists out of the group scan: one call
        # a run, the same value for every group
        per = n // groups if n % groups == 0 else 0
        assert per or n == 1, (k, n, groups)
        if segments and segments[-1][0] == per:
            segments[-1][1].append(k)
        else:
            segments.append((per, [k]))

    def value(k, r, g, m, per):
        return calls[k][r] if not per else calls[k][(r * groups + g) * per
                                                    + m]
    out.extend([(k[1], value(k, r, g, m, per))
                for g in range(groups) for per, seg in segments
                for m in range(max(per, 1)) for k in seg]
               for r in range(runs))


def _w4_codes(y):
    return np.round(np.clip(np.asarray(y), -7, 7))


# --- qlinear -----------------------------------------------------------------

def test_qlinear_qat_w4a8_matches_jax():
    """W4 per output channel and A8 per tensor, codes bit for bit; the
    abs-max entries sit exactly on +-qmax (each column's largest |w| is 7
    x a power of two, and the activation's is 127 / 4), so the clip's
    gradient there is 0.5, as ``jnp.clip`` gives it."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 8, 24)).astype(np.float32)
    x[0, 0, 0], x[1, 3, 5] = 127 / 4, -127 / 4
    w = rng.uniform(-1, 1, (24, 16)).astype(np.float32)
    w[rng.integers(0, 24, 16), np.arange(16)] = 7 * 2.0 ** rng.integers(
        -2, 3, 16) * rng.choice([-1, 1], 16)
    gy = rng.normal(size=(2, 8, 16)).astype(np.float32)

    jy = jlayers.qlinear(jnp.asarray(x), jnp.asarray(w), "qat_w4a8")
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(
        jlayers.qlinear(a, b, "qat_w4a8") * gy), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    ty = tlayers.qlinear(tx, tw, "qat_w4a8")
    (ty * _t(gy)).sum().backward()

    for a, bits, ax in ((w, 4, 1), (x, 8, None)):
        np.testing.assert_array_equal(
            _np(tq.fake_quant_ste(_t(a), bits, channel_axis=ax)),
            np.asarray(jq.fake_quant_ste(jnp.asarray(a), bits,
                                         channel_axis=ax)))
    want = np.asarray(jy)
    np.testing.assert_allclose(_np(ty), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    for got, ref in ((tx.grad, jgx), (tw.grad, jgw)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
    # the gate: 0.5 of the straight-through gradient on +-qmax
    xq = tq.fake_quant_ste(_t(x), 8)
    full = _np(xq.reshape(-1, 24).T @ _t(gy).reshape(-1, 16))
    on_max = np.abs(w) == np.abs(w).max(0, keepdims=True)
    assert on_max.sum() == 16
    np.testing.assert_allclose(_np(tw.grad)[on_max], 0.5 * full[on_max],
                               rtol=1e-6)
    np.testing.assert_allclose(_np(tw.grad)[~on_max], full[~on_max],
                               rtol=1e-5, atol=1e-6)


# --- lm_loss and its gradient ------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch, mode, mask):
    """Eager ``jax.value_and_grad(lm_loss)``: (loss, grads, sites)."""
    jcfg, _ = _cfgs(arch, mode)
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg, mask=mask).items()}
    with jax_sites() as sites:
        loss, grads = jax.value_and_grad(jtfm.lm_loss)(_jax_tree(arch), jcfg,
                                                       batch)
        grads = jax.tree.map(np.asarray, grads)
    return float(loss), grads, sites[0]


def _port_value_and_grad(arch, mode, mask, pin=None, remat=False):
    _, cfg = _cfgs(arch, mode, remat=remat)
    batch = {k: _t(v) for k, v in _batch(cfg, mask=mask).items()}
    params = lm_params_from_numpy(_jax_tree(arch), "cpu")
    with port_sites(pin) as sites:
        loss, grads = steps.lm_value_and_grad(params, cfg, batch)
    return float(loss), grads, sites


def _holds(loss, grads, want_loss, want_grads):
    gaps = _leaf_gaps(grads, want_grads)
    worst = max(gaps, key=gaps.get)
    rel = abs(loss - want_loss) / abs(want_loss)
    return rel <= LOSS_TOL and gaps[worst] <= GRAD_TOL, (rel, worst,
                                                         gaps[worst])


def port_spread(arch, mode, ref, pin=None):
    """{leaf: the largest gap from ``ref`` (the port's gradient tree at
    ``_batch``) of ``N_JITTERS`` more port runs with the embedding table
    moved an ulp up, down or not at all} (``tools.lm_train_gap``'s
    ``jitter_embed``, its QAT sites pinned to ``pin``): how far float32
    rounding alone moves each leaf."""
    _, cfg = _cfgs(arch, mode)
    batch = {k: _t(v) for k, v in _batch(cfg).items()}
    params = lm_params_from_numpy(_jax_tree(arch), "cpu")
    spread = {}
    for j in range(N_JITTERS):
        with port_sites(pin):
            _, g = steps.lm_value_and_grad(jitter_embed(params, j), cfg,
                                           batch)
        for k, v in tree_gaps(g, ref).items():
            spread[k] = max(spread.get(k, 0.0), v)
    return spread


def logits_hold(got, want, rerun, what, tol=1e-5):
    """Whether ``got`` (the port's float32 logits, numpy) lies within
    ``tol`` of ``want`` (JAX's) over the largest |want|, or, past it,
    within ``F32_GRAD_FACTOR`` x the spread of ``rerun(j)`` for j <
    ``N_JITTERS`` (the same port run with its embedding table moved an
    ulp, ``jitter_embed(params, j)``) from ``got``: float32 rounding
    alone, which moves the smoke SSM and xLSTM configs' logits ~1e-5
    from float64 in either package. Prints the gap and its bound."""
    gap = float(np.abs(got - want).max() / np.abs(want).max())
    if gap <= tol:
        return True
    spread = max(float(np.abs(rerun(j) - got).max())
                 for j in range(N_JITTERS)) / float(np.abs(got).max())
    bound = max(tol, F32_GRAD_FACTOR * spread)
    print(f"{what}: gap {gap:.3g} against max({tol:g}, {F32_GRAD_FACTOR:g} "
          f"x spread {spread:.3g})")
    return gap <= bound


def holds_within_spread(arch, mode, loss, grads, want_loss, want_grads,
                        pin=None):
    """``_holds`` with each leaf's bound raised to ``F32_GRAD_FACTOR`` x
    its float32 spread (:func:`port_spread`) where that is larger than
    ``GRAD_TOL``: the method and factor of ``chip_smoke.py`` phases 8 and
    11, for families whose float32 gradients sit further from float64
    than ``GRAD_TOL`` in either package. Prints the worst leaf."""
    spread = port_spread(arch, mode, grads, pin)
    gaps = _leaf_gaps(grads, want_grads)
    bound = {k: max(GRAD_TOL, F32_GRAD_FACTOR * spread[k]) for k in gaps}
    worst = max(gaps, key=lambda k: gaps[k] / bound[k])
    rel = abs(loss - want_loss) / abs(want_loss)
    what = (rel, worst, gaps[worst], bound[worst])
    print(f"{arch} {mode}: loss {rel:.3g} rel; worst leaf {worst} "
          f"{gaps[worst]:.3g} against max({GRAD_TOL:g}, {F32_GRAD_FACTOR:g} "
          f"x spread {spread[worst]:.3g})")
    return rel <= LOSS_TOL and gaps[worst] <= bound[worst], what


# one case weighs the tokens with a partial mask
CASES = ([(a, "none", False) for a in DENSE]
         + [(a, "qat_w4a8", a == "chameleon-34b") for a in DENSE])


@pytest.mark.parametrize("arch,mode,mask", CASES)
def test_loss_and_gradient_match_jax(arch, mode, mask):
    """Every gradient leaf of ``lm_loss`` against eager
    ``jax.value_and_grad``, the untied ``embed`` of the embedding
    frontends included (no path to the loss: zeros in both)."""
    want_loss, want, j_sites = _jax_value_and_grad(arch, mode, mask)
    loss, grads, p_sites = _port_value_and_grad(arch, mode, mask)
    assert set(dict(tree.items(grads))) == set(
        dict(tree.items(want)))
    _, cfg = _cfgs(arch)
    if cfg.frontend != "token" and not cfg.tie_embeddings:
        assert not grads["embed"].any() and not np.any(want["embed"])
        assert grads["embed"].shape == want["embed"].shape
    ok, what = _holds(loss, grads, want_loss, want)
    if mode == "none":
        assert not p_sites and not j_sites
        assert ok, what
        return
    assert len(p_sites) == len(j_sites) == 14 * cfg.n_layers - 2 * (
        cfg.mlp_kind == "squared_relu") * cfg.n_layers
    for (kind, a), (_, b) in zip(j_sites, p_sites):
        if kind == "w7":       # identical weights: identical W4 codes
            np.testing.assert_array_equal(_w4_codes(a), _w4_codes(b))
    if not ok:
        moved = moved_sites(j_sites, p_sites)
        print(f"{arch} {mode}: {what} with codes or gates moved per site "
              f"{moved}")
        assert sum(moved) > 0, f"{what} with no moved code or gate"
        loss, grads, _ = _port_value_and_grad(arch, mode, mask, pin=j_sites)
        ok, what = _holds(loss, grads, want_loss, want)
    assert ok, f"with JAX's sites pinned: {what}"


def test_remat_gradient_matches_jax_and_the_plain_forward():
    """With ``cfg.remat`` each layer is recomputed in the backward: the
    gradients equal the port's without remat bit for bit, and JAX's
    within the tolerance."""
    arch = "qwen2-0.5b"
    want_loss, want, _ = _jax_value_and_grad(arch, "none", False)
    loss, grads, _ = _port_value_and_grad(arch, "none", False, remat=True)
    loss0, grads0, _ = _port_value_and_grad(arch, "none", False)
    assert loss == loss0
    for (k, g), (_, g0) in zip(tree.items(grads), tree.items(grads0)):
        assert torch.equal(g, g0), k
    ok, what = _holds(loss, grads, want_loss, want)
    assert ok, what


def test_forward_splits_each_stacked_leaf_once(monkeypatch):
    """Under autograd the forward takes each layer's weights from one
    ``torch.unbind`` per stacked leaf, not an index per layer, whose
    backward would add a zero tensor of the whole leaf per layer."""
    _, cfg = _cfgs("qwen2-0.5b")
    params = lm_params_from_numpy(_jax_tree("qwen2-0.5b"), "cpu")
    n_leaves = len(tree.leaves(params["blocks"]))
    calls = []
    unbind = torch.unbind
    monkeypatch.setattr(torch, "unbind",
                        lambda t, *a, **k: calls.append(t) or unbind(t, *a,
                                                                    **k))
    batch = {k: _t(v) for k, v in _batch(cfg).items()}
    steps.lm_value_and_grad(params, cfg, batch)
    assert len(calls) == n_leaves


# --- AdamW over nested trees -------------------------------------------------

def test_adamw_nested_tree_matches_jax():
    """Identical nested gradients (stacked leaves, a tuple, a leaf whose
    gradient is zero), the clip active, weight decay, the cosine
    schedule's warm-up and decay: every leaf within 1e-6 relative over 3
    steps, the step count int32 as in JAX."""
    rng = np.random.default_rng(3)
    shapes = {"embed": (16, 8), "final_norm": (8,),
              "blocks": {"attn": {"wq": (2, 8, 8), "tau": (2,)},
                         "pair": ((2, 4), (3,))}}

    def draw(s, k=1.0):
        if isinstance(s, dict):
            return {n: draw(v, k) for n, v in s.items()}
        if isinstance(s[0], tuple):
            return tuple(draw(v, k) for v in s)
        return (rng.normal(size=s) * k).astype(np.float32)
    params = draw(shapes)
    grads = [draw(shapes, 3.0) for _ in range(3)]
    for g in grads:
        g["final_norm"][:] = 0.0
    jopt = JAdamW(lr=j_cosine(1e-2, 1, 3), weight_decay=0.1, grad_clip=1.0)
    topt = AdamW(lr=cosine_schedule(1e-2, 1, 3), weight_decay=0.1,
                 grad_clip=1.0)
    jp, js = params, jopt.init(params)
    tp = lm_params_from_numpy(params, "cpu")
    ts = topt.init(tp)
    assert ts.step.dtype == torch.int32 and js.step.dtype == jnp.int32
    update = jax.jit(jopt.update)
    for g in grads:
        jp, js = update(g, js, jp)
        tp, ts = topt.update(lm_params_from_numpy(g, "cpu"), ts, tp)
        for tr_, jr in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            want = dict(tree.items(jax.tree.map(np.asarray, jr)))
            for k, v in tree.items(tr_):
                np.testing.assert_allclose(_np(v), want[k], rtol=1e-6,
                                           atol=1e-7, err_msg=k)
    assert int(ts.step) == int(js.step) == 3
    assert not np.array_equal(_np(tp["final_norm"]), params["final_norm"])


# --- make_train_step ---------------------------------------------------------

def _port_steps(step, params, opt_state, batches, pins=None):
    """Run the port's ``step`` over ``batches``: the losses, and per step
    its quantization sites, with ``pins[i]`` pinned at step i."""
    losses, sites = [], []
    for i, batch in enumerate(batches):
        with port_sites(None if pins is None else pins[i]) as s:
            params, opt_state, loss = step(params, opt_state, {
                k: _t(v) for k, v in batch.items()})
        losses.append(float(loss))
        sites.append(s)
    return losses, sites


@pytest.mark.parametrize("arch,mode", [("qwen2-0.5b", "none"),
                                       ("qwen2-0.5b", "qat_w4a8"),
                                       ("musicgen-large", "none"),
                                       ("musicgen-large", "qat_w4a8")])
def test_make_train_step_matches_jax(arch, mode):
    """Three steps of the launcher's optimizer on three batches: each
    step's loss within 1e-4 relative of the JAX step's (jitted, its QAT
    sites recorded inside the program). In QAT a miss must come with
    moved codes or gates, and the port then runs the three steps again
    with JAX's sites pinned."""
    jcfg, cfg = _cfgs(arch, mode)
    jopt = JAdamW(lr=j_cosine(3e-3, 1, 3), weight_decay=0.1, grad_clip=1.0)
    topt = AdamW(lr=cosine_schedule(3e-3, 1, 3), weight_decay=0.1,
                 grad_clip=1.0)
    jp = _jax_tree(arch)
    batches = [_batch(cfg, seed=10 + i) for i in range(3)]
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt))
    want, js = [], jopt.init(jp)
    with jax_sites(runs=len(batches)) as j_sites:
        for batch in batches:
            jp, js, loss = jstep(jp, js, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
            want.append(float(loss))
    tstep = steps.make_train_step(cfg, topt)

    def port(pins=None):
        tp = lm_params_from_numpy(_jax_tree(arch), "cpu")
        return _port_steps(tstep, tp, topt.init(tp), batches, pins)
    got, p_sites = port()
    ok = all(g == pytest.approx(w, rel=1e-4) for g, w in zip(got, want))
    if mode != "none" and not ok:
        moved = [sum(moved_sites(j, p)) for j, p in zip(j_sites, p_sites)]
        print(f"{arch}: losses {got} against {want}, codes or gates moved "
              f"per step {moved}")
        assert sum(moved) > 0
        got, _ = port(pins=j_sites)
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=1e-4), (got, want)
    # gradient constraints leave a step on plain tensors as it was
    tp = lm_params_from_numpy(_jax_tree(arch), "cpu")
    b0 = {k: _t(v) for k, v in batches[0].items()}
    constrained = steps.make_train_step(
        cfg, topt, grad_specs=shd.param_specs(tp, cfg, _STAND_IN_MESH))
    assert torch.equal(constrained(tp, topt.init(tp), b0)[2],
                       tstep(tp, topt.init(tp), b0)[2])


# --- make_train_step on the local (1, 1) mesh --------------------------------

# one arch of each family: dense, MoE, Mamba2 hybrid, xLSTM
MESH_ARCHS = ("qwen2-0.5b", "qwen3-moe-30b-a3b", "zamba2-1.2b",
              "xlstm-1.3b")
_STAND_IN_MESH = SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(1, 1))


@pytest.fixture
def local_mesh():
    try:
        yield make_local_mesh("cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_train_step_on_the_local_mesh_equals_the_plain_step(arch,
                                                            local_mesh):
    """``make_train_step(grad_specs=param_specs)`` on DTensor parameters
    placed by ``param_specs`` on the (1, 1) gloo mesh (the batch by
    ``batch_specs``), under ``implicit_replication()``, against the plain
    step: the loss, every updated parameter and both AdamW moments bit
    for bit, each leaf keeping its placements."""
    cfg = _cfgs(arch)[1]
    opt = AdamW(lr=cosine_schedule(3e-3, 1, 3), weight_decay=0.1,
                grad_clip=1.0)
    params = lm_params_from_numpy(_jax_tree(arch), "cpu")
    batch = {k: _t(v) for k, v in _batch(cfg).items()}
    want = steps.make_train_step(cfg, opt)(params, opt.init(params), batch)
    specs = shd.param_specs(params, cfg, local_mesh)
    placed = shd.place(params, shd.to_shardings(specs, local_mesh))
    cell = ShapeCell("custom", S, B, "train")
    b_sh = shd.to_shardings(shd.batch_specs(cfg, cell, local_mesh),
                            local_mesh)
    on_mesh = {k: distribute_tensor(v, local_mesh, b_sh[k].placements)
               for k, v in batch.items()}
    with implicit_replication():
        got = steps.make_train_step(cfg, opt, grad_specs=specs)(
            placed, opt.init(placed), on_mesh)
    assert torch.equal(got[2].full_tensor(), want[2])
    for name, g, w in (("params", got[0], want[0]),
                       ("mu", got[1].mu, want[1].mu),
                       ("nu", got[1].nu, want[1].nu)):
        flat = dict(tree.items(g))
        for k, v in tree.items(w):
            assert isinstance(flat[k], DTensor), (name, k)
            assert flat[k].placements == shd.placements(
                dict(shd.spec_items(specs))[k], local_mesh), (name, k)
            assert torch.equal(flat[k].full_tensor(), v), (name, k)


# --- the abstract trees ------------------------------------------------------

def _spec(tree_):
    return [(k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items(tree_)]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_match_eval_shape(arch):
    """``abstract_params`` (none, and serve_w8a8 or serve_w4a8 by turns),
    ``abstract_opt_state`` and ``abstract_cache`` (every shape cell of
    the arch, int8 and float caches) of the full config: the shapes and
    dtypes of ``jax.eval_shape``'s, as meta tensors; and the smoke
    config's ``abstract_params`` has ``init_lm``'s shapes."""
    serve = "serve_w8a8" if ARCHS.index(arch) % 2 else "serve_w4a8"
    for mode in ("none", serve):
        cfg = configs.get_config(arch, quant_mode=mode)
        got = steps.abstract_params(cfg)
        assert {v.device.type for v in tree.leaves(got)} == {"meta"}
        assert _spec(got) == _spec(jsteps.abstract_params(
            jconfigs.get_config(arch, quant_mode=mode)))
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    st = steps.abstract_opt_state(cfg, AdamW())
    jst = jsteps.abstract_opt_state(jcfg, JAdamW())
    assert _spec(st) == _spec(tuple(jst))
    for cell, jcell in zip(configs.shapes_for(arch),
                           jconfigs.shapes_for(arch)):
        for kv in (False, True):
            c = steps.abstract_cache(dataclasses.replace(cfg, kv_quant=kv),
                                     cell)
            assert _spec(c) == _spec(jsteps.abstract_cache(
                dataclasses.replace(jcfg, kv_quant=kv), jcell))
    smoke = configs.get_smoke_config(arch)
    assert _spec(steps.abstract_params(smoke)) == _spec(
        tfm.init_lm(smoke, device="cpu"))
