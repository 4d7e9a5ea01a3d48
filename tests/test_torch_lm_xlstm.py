"""The port's xLSTM family (``models/lm/xlstm.py`` through
``transformer.py``'s xlstm pattern; xlstm-1.3b) against the JAX package
on the CPU.

Weights come from the JAX package (``init_lm`` / ``init_mlstm`` /
``init_slstm`` at ``PRNGKey(0)``) and cross over as numpy
(``weights.lm_params_from_numpy``); float32 unless a case says
otherwise.

Tolerances: the mLSTM and sLSTM blocks and their steps to 1e-5 of the
largest |y| (their states to 1e-5 of the largest |value|); the logits to
1e-5 of the largest |logit| in float32 and 6e-2 in bf16, the loss to
1e-5 / 2e-2 relative (``tests/test_torch_lm_prefill.py``'s bounds);
gradients to the ``_holds`` bounds of ``tests/test_torch_lm_train.py``;
the decode's logits per step to 1e-5 of the largest |logit|; the port's
decode against its own forward to ``TestDecodeConsistency``'s 5e-3.

Float32 itself: this family's float32 gradients sit up to 5.3e-5 of a
leaf's largest |g| from the port's float64 gradient, in either package
(JAX's up to 5.2e-5), and its logits up to ~1.2e-5 at other seeds. A
gradient leaf or float32 logits past their bound are held within
``F32_GRAD_FACTOR`` x the port's float32 spread (``N_JITTERS`` runs with
the embedding table moved an ulp: ``holds_within_spread``,
``logits_hold``; ``chip_smoke.py`` phases 8 and 11's method), printed.

Serve modes: the reference's quantization policy leaves the mLSTM's
``b/wif`` float and its serve-mode ``qlinear`` unpacks a float matrix as
``(codes, scale)``, so the JAX package cannot serve this family
quantized; the port raises ``ValueError`` naming ``b/wif``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.lm import transformer as jtfm
from repro.models.lm import xlstm as jxlstm
from repro.quant import apply as japply
from repro_torch import configs, tree
from repro_torch.launch import serve, steps, train
from repro_torch.models.lm import transformer as tfm
from repro_torch.models.lm import xlstm
from repro_torch.quant import apply
from repro_torch.tools.lm_train_gap import jitter_embed, moved_sites
from repro_torch.tools.lm_train_gap import qat_sites as port_sites
from repro_torch.weights import lm_params_from_numpy
from test_torch_lm_train import (_batch, _cfgs, _holds, _jax_tree,
                                 holds_within_spread, jax_sites, logits_hold)

ARCH = "xlstm-1.3b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# bf16 forward: a bound on the port's distance from JAX's float32 logits
# over JAX's own bf16 distance from them (measured 1.02 for xlstm,
# 1.04 for zamba2)
BF16_FACTOR = 1.25


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _lm_cfgs(dtype="f32", **extra):
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype=jdt,
                                **extra),
            dataclasses.replace(configs.get_smoke_config(ARCH), dtype=tdt,
                                **extra))


def _tokens(cfg, seed=1, n=16):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg.vocab, size=(2, n)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(2, n)).astype(np.int32)
    mask = (rng.random((2, n)) < 0.7).astype(np.float32)
    return x, labels, mask


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=tol * np.abs(np.asarray(want)).max())


# --- the blocks ---------------------------------------------------------------------

@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_block_and_its_step_match_jax(block):
    """``mlstm_forward`` (the chunked scan with v_aug = [v, 1], two chunks)
    or ``slstm_forward`` (a loop over time, m from -1e30), and six decode
    steps, against JAX's; each step writes its state into the cache it
    was given (the same tensors) and returns that cache. The mLSTM
    cache keeps its normalizer beside the (dk, dv) state."""
    jcfg, cfg = _lm_cfgs(ssm_chunk=8)
    init = getattr(jxlstm, f"init_{block}")
    jp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg))
    tp = lm_params_from_numpy(jp, "cpu")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (2, 16, cfg.d_model)))
    fwd, step = f"{block}_forward", f"{block}_step"
    _close(getattr(xlstm, fwd)(tp, _t(x), cfg),
           getattr(jxlstm, fwd)(jp, jnp.asarray(x), jcfg), 1e-5)
    jc = getattr(jxlstm, f"init_{block}_cache")(jcfg, 2, jnp.float32)
    tc = getattr(xlstm, f"init_{block}_cache")(cfg, 2, torch.float32, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in tc.items()} == {
        k: (v.shape, torch.float32) for k, v in jc.items()}
    if block == "slstm":
        assert bool((tc["m"] == np.float32(-1e30)).all())
    ptrs = {k: v.data_ptr() for k, v in tc.items()}
    for i in range(6):
        jy, jc = getattr(jxlstm, step)(jp, jnp.asarray(x[:, i:i + 1]), jcfg,
                                       jc)
        ty, out = getattr(xlstm, step)(tp, _t(x[:, i:i + 1]), cfg, tc)
        assert out is tc
        _close(ty, jy, 1e-5)
        for k in tc:
            _close(tc[k], jc[k], 1e-5)
    assert {k: v.data_ptr() for k, v in tc.items()} == ptrs


# --- forward, lm_loss, the gradient ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_forward(dtype):
    """JAX's jitted logits (numpy), aux and loss."""
    jcfg, _ = _lm_cfgs(dtype)
    x, labels, mask = _tokens(jcfg)
    jb = {"tokens": jnp.asarray(x), "labels": jnp.asarray(labels),
          "mask": jnp.asarray(mask)}
    want, aux = jax.jit(lambda p, t: jtfm.forward(p, jcfg, tokens=t))(
        _jax_tree(ARCH), jb["tokens"])
    loss = float(jax.jit(lambda p, b: jtfm.lm_loss(p, jcfg, b))(
        _jax_tree(ARCH), jb))
    return np.asarray(want), float(aux), loss


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_and_loss_match_jax(dtype):
    """``forward`` (one group of seven mLSTM blocks and one sLSTM block
    here; six groups in the full config) and ``lm_loss``, against JAX's,
    jitted."""
    jcfg, cfg = _lm_cfgs(dtype)
    x, labels, mask = _tokens(cfg)
    batch = {"tokens": x, "labels": labels, "mask": mask}
    want, want_aux, want_loss = _jax_forward(dtype)
    params = lm_params_from_numpy(_jax_tree(ARCH), "cpu")
    logits, aux = tfm.forward(params, cfg, tokens=_t(x))
    assert logits.dtype == torch.float32 and float(aux) == want_aux == 0
    loss = float(tfm.lm_loss(params, cfg, {k: _t(v) for k, v in
                                           batch.items()}))
    if dtype == "f32":
        assert logits_hold(_np(logits), want, lambda j: _np(tfm.forward(
            jitter_embed(params, j), cfg, tokens=_t(x))[0]), "forward")
        assert loss == pytest.approx(want_loss, rel=1e-5)
        return
    # bf16: within PR 22's bounds of JAX's bf16, or, where bf16 rounding
    # alone moves both packages further, no further from JAX's float32
    # logits and loss than BF16_FACTOR x JAX's own bf16 result is
    f32, _, f32_loss = _jax_forward("f32")
    gap = float(np.abs(_np(logits) - want).max() / np.abs(want).max())
    lgap = abs(loss - want_loss) / abs(want_loss)
    if gap > 6e-2 or lgap > 2e-2:
        own = float(np.abs(want - f32).max() / np.abs(f32).max())
        mine = float(np.abs(_np(logits) - f32).max() / np.abs(f32).max())
        own_l = abs(want_loss - f32_loss) / abs(f32_loss)
        mine_l = abs(loss - f32_loss) / abs(f32_loss)
        print(f"bf16: {gap:.3g} of the largest |logit| from JAX's bf16 "
              f"(loss {lgap:.3g}); from JAX's float32: the port {mine:.3g}, "
              f"JAX {own:.3g} (loss {mine_l:.3g}, {own_l:.3g})")
        assert mine <= BF16_FACTOR * own
        assert mine_l <= max(2e-2, BF16_FACTOR * own_l)


def _jax_value_and_grad(mode):
    jcfg, _ = _cfgs(ARCH, mode)
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    with jax_sites(groups=jtfm.n_groups(jcfg)) as sites:
        loss, grads = jax.value_and_grad(jtfm.lm_loss)(_jax_tree(ARCH), jcfg,
                                                       batch)
        grads = jax.tree.map(np.asarray, grads)
    return float(loss), grads, sites[0]


def _port_value_and_grad(mode, pin=None):
    _, cfg = _cfgs(ARCH, mode)
    batch = {k: _t(v) for k, v in _batch(cfg).items()}
    params = lm_params_from_numpy(_jax_tree(ARCH), "cpu")
    with port_sites(pin) as sites:
        loss, grads = steps.lm_value_and_grad(params, cfg, batch)
    return float(loss), grads, sites


@pytest.mark.parametrize("mode", ["none", "qat_w4a8"])
def test_loss_and_gradient_match_jax(mode):
    """Every gradient leaf of ``lm_loss`` against eager
    ``jax.value_and_grad`` (S = 64 over two chunks of 32; the sLSTM's
    recurrence ``r`` through 64 steps). In ``qat_w4a8`` every projection
    is fake-quantized (14 sites an mLSTM block, 4 the sLSTM block; ``r``
    is not a projection): the W4 codes equal JAX's, and where codes or
    gates moved the port runs again with JAX's sites pinned."""
    want_loss, want, j_sites = _jax_value_and_grad(mode)
    loss, grads, p_sites = _port_value_and_grad(mode)
    assert set(dict(tree.items(grads))) == set(dict(tree.items(want)))
    _, cfg = _cfgs(ARCH, mode)
    assert len(p_sites) == len(j_sites) == (
        tfm.n_groups(cfg) * (14 * cfg.xlstm_mlstm_per_slstm + 4)
        if mode != "none" else 0)
    for (kind, a), (_, b) in zip(j_sites, p_sites):
        if kind == "w7":
            np.testing.assert_array_equal(np.round(np.clip(a, -7, 7)),
                                          np.round(np.clip(_np(b), -7, 7)))
    ok, what = _holds(loss, grads, want_loss, want)
    pin = p_sites if mode != "none" else None
    if not ok and mode != "none":
        moved = moved_sites(j_sites, p_sites)
        print(f"{ARCH} {mode}: {what} with codes or gates moved {moved}")
        if sum(moved):
            pin = j_sites
            loss, grads, _ = _port_value_and_grad(mode, pin=pin)
            ok, what = _holds(loss, grads, want_loss, want)
    if not ok:
        ok, what = holds_within_spread(ARCH, mode, loss, grads, want_loss,
                                       want, pin)
    assert ok, what


# --- decode ---------------------------------------------------------------------

def test_decode_matches_jax():
    """Teacher-forced decode of both packages on the same weights, step
    by step (quant none, float32): seven mLSTM states and normalizers and
    the sLSTM's (h, c, n, m) per group."""
    jcfg, cfg = _lm_cfgs()
    tree_ = _jax_tree(ARCH)
    params = lm_params_from_numpy(tree_, "cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab, size=(8, 3, 1))
    jc = jtfm.init_cache(jcfg, 3, 8)
    assert jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")),
        tfm.init_cache(cfg, 3, 8, "cpu"),
        is_leaf=lambda a: isinstance(a, torch.Tensor)) == jax.tree.map(
            lambda a: (a.shape, str(a.dtype)), jc)
    jstep = jax.jit(lambda p, c, t, i: jtfm.decode_step(p, jcfg, c, t, i))
    jl = []
    for i in range(8):
        out, jc = jstep(tree_, jc, jnp.asarray(toks[i], jnp.int32),
                        jnp.asarray(i, jnp.int32))
        jl.append(np.asarray(out))
    jl = np.stack(jl)

    def port(p):
        cache = tfm.init_cache(cfg, 3, 8, "cpu")
        return np.stack([_np(tfm.decode_step(p, cfg, cache, _t(toks[i]),
                                             i)[0]) for i in range(8)]), cache
    tl, tc = port(params)
    assert np.isfinite(tl).all()
    for k, v in tree.items(tc):
        _close(v, dict(tree.items(jax.tree.map(np.asarray, jc)))[k], 1e-4)
    assert logits_hold(tl, jl, lambda j: port(jitter_embed(params, j))[0],
                       "decode")


def test_decode_matches_forward():
    """``TestDecodeConsistency``'s case on the port: feeding the sequence
    one token at a time through the serve step reproduces the prefill's
    logits."""
    _, cfg = _lm_cfgs(ssm_chunk=8)
    params = tfm.init_lm(cfg, 0, "cpu")
    x = _t(_tokens(cfg)[0])
    full, _ = tfm.forward(params, cfg, tokens=x)
    cache = tfm.init_cache(cfg, 2, 16, "cpu")
    step = steps.make_serve_step(cfg)
    dec = torch.stack([step(params, cache, x[:, i:i + 1], i)[0]
                       for i in range(16)], dim=1)
    np.testing.assert_allclose(_np(dec), _np(full), rtol=5e-3, atol=5e-3)


# --- serve modes, the launchers ---------------------------------------------------

@pytest.mark.parametrize("mode", ["serve_w8a8", "serve_w4a8"])
def test_serve_modes_raise_in_both_packages(mode):
    """The quantization policy leaves ``b/wif`` float in both packages;
    JAX's serve-mode ``qlinear`` then fails to unpack it (``ValueError``,
    its forward and its decode step alike), and the port refuses it
    naming the leaf."""
    jcfg, cfg = _lm_cfgs(quant_mode=mode)
    jq = japply.quantize_params_tree(_jax_tree(ARCH), jcfg)
    assert not isinstance(jq["blocks"]["mlstm"]["b"]["wif"], tuple)
    assert isinstance(jq["blocks"]["mlstm"]["b"]["wq"], tuple)
    tok = jnp.zeros((2, 1), jnp.int32)
    with pytest.raises(ValueError, match="unpack"):
        jtfm.forward(jq, jcfg, tokens=tok)
    with pytest.raises(ValueError, match="unpack"):
        jtfm.decode_step(jq, jcfg, jtfm.init_cache(jcfg, 2, 4), tok,
                         jnp.asarray(0, jnp.int32))
    tq = apply.quantize_params_tree(lm_params_from_numpy(_jax_tree(ARCH),
                                                         "cpu"), cfg)
    assert not isinstance(tq["blocks"]["mlstm"]["b"]["wif"], tuple)
    ttok = torch.zeros((2, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="b/wif"):
        tfm.forward(tq, cfg, tokens=ttok)
    with pytest.raises(ValueError, match="b/wif"):
        tfm.decode_step(tq, cfg, tfm.init_cache(cfg, 2, 4, "cpu"), ttok, 0)
    lm = serve.build_lm(serve.lm_config(ARCH, smoke=True, quant=mode),
                        device="cpu")
    with pytest.raises(ValueError, match="b/wif"):
        serve.greedy_decode(lm, 2, 4, 2)


def test_launchers_take_the_xlstm_arch(capsys, tmp_path):
    """``--arch xlstm-1.3b`` serves with ``--quant none`` (the loop keeps
    the cache it passes: every state is written in place) and trains."""
    cfg = serve.lm_config(ARCH, smoke=True)
    lm = serve.build_lm(cfg, device="cpu")
    cache = tfm.init_cache(cfg, 2, 4, "cpu")
    serve.greedy_decode(lm, 2, 4, 3, cache=cache)
    for k, v in tree.items(cache):
        assert v.any(), k
    serve.main(["--workload", "lm", "--arch", ARCH, "--smoke", "--tokens",
                "3", "--batch", "2", "--cache-len", "4", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("arch=xlstm-smoke quant=none")
    args = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "12", "--batch", "2", "--seq", "32",
                       "--lr", "3e-3", "--ckpt-every", "0", "--ckpt-dir",
                       str(tmp_path / "ckpt")])
    assert args._log[-1][1] < args._log[0][1]
