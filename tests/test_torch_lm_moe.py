"""The port's MoE family (``models/lm/moe.py`` through ``transformer.py``;
moonshot-v1-16b-a3b, qwen3-moe-30b-a3b) against the JAX package on the
CPU.

Weights come from the JAX package (``init_moe`` / ``init_lm`` at
``PRNGKey(0)``, random QKV biases and ``tau`` added with numpy) and cross
over as numpy (``weights.lm_params_from_numpy``); float32 unless a case
says otherwise.

Tolerances: ``moe_forward``'s output to 1e-5 of its largest |y|, the
balance loss to 1e-6 relative, the dispatch mask exactly and the combine
weights to 1e-6 (gate probabilities); the logits to 1e-5 of the largest
|logit| in float32 and 6e-2 in bf16, the loss to 1e-5 / 2e-2 relative
(``tests/test_torch_lm_prefill.py``'s bounds); gradients to the
``_holds`` bounds of ``tests/test_torch_lm_train.py``; the decode's
logits per step to 1e-5 of the largest |logit|.

Routing (``tools/moe_routing``): a router's float32 sums fall in another
order in each package, so a choice at a near tie can move, and through
the capacity's cumulative sum move the kept flags of later tokens. A gap
past its tolerance is accepted only with moved routing (JAX's choices,
recorded from inside its program by ``jax.debug.callback``, against the
port's); the port then runs again with JAX's choices pinned and must
hold the tolerance.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models.lm import moe as jmoe
from repro.models.lm import transformer as jtfm
from repro.quant import apply as japply
from repro_torch import configs, tree
from repro_torch.kernels.act_quant import kv_append_int8
from repro_torch.kernels.attention_int8kv import decode_attention_int8kv
from repro_torch.launch import serve, steps, train
from repro_torch.models.lm import moe
from repro_torch.models.lm import transformer as tfm
from repro_torch.quant import apply
from repro_torch.tools.lm_train_gap import moved_sites
from repro_torch.tools.lm_train_gap import qat_sites as port_sites
from repro_torch.tools.moe_routing import moved_routing, routing_sites
from repro_torch.weights import lm_params_from_numpy
from test_torch_lm_train import _batch, _cfgs, _holds, _jax_tree, jax_sites

ARCHS = ("moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))


@contextlib.contextmanager
def jax_routing():
    """While active, every ``jax.lax.top_k`` of the JAX package (its MoE
    router's) reports its chosen experts from inside the program that ran
    it; yields the list they are appended to, in call order."""
    calls, plain = [], jax.lax.top_k

    def top_k(x, k):
        vals, idx = plain(x, k)
        jax.debug.callback(lambda v: calls.append(np.array(v)), idx)
        return vals, idx
    jax.lax.top_k = top_k
    try:
        yield calls
    finally:
        jax.lax.top_k = plain


def _moe_cfgs(arch="qwen3-moe-30b-a3b", **extra):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch),
                                dtype=jnp.float32, **extra),
            dataclasses.replace(configs.get_smoke_config(arch),
                                dtype=torch.float32, **extra))


def _quantized_moe(params, mode):
    """The experts of a JAX ``init_moe`` tree quantized for ``mode`` by
    the JAX ``quantize_matrix``, the router left float (the policy)."""
    if mode == "none":
        return params
    return dict(params, **{k: tuple(np.asarray(a) for a in
                                    japply.quantize_matrix(params[k], mode))
                           for k in ("wg", "wu", "wd")})


# --- moe_forward ----------------------------------------------------------------

MOE_CASES = {
    "qwen3": ("qwen3-moe-30b-a3b", {}, (2, 32), "none"),
    "qwen3-cf2": ("qwen3-moe-30b-a3b", {"capacity_factor": 2.0}, (1, 64),
                  "none"),
    "moonshot": ("moonshot-v1-16b-a3b", {}, (2, 32), "none"),
    "two-groups": ("qwen3-moe-30b-a3b", {}, (2, 512), "none"),
    "serve_w8a8": ("qwen3-moe-30b-a3b", {}, (2, 32), "serve_w8a8"),
    "serve_w4a8": ("qwen3-moe-30b-a3b", {}, (2, 32), "serve_w4a8"),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_forward_matches_jax(case):
    """``moe_forward`` at ``TestMoE``'s inputs (``init_moe(PRNGKey(0))``,
    x ~ N(0, 1) from ``PRNGKey(1)``): y, the balance loss, and the
    dispatch and combine tensors of every routing group; with capacity
    factor 2, 64 experts top-6 (moonshot), two groups of 512 tokens, and
    experts served in int8 and int4."""
    arch, extra, shape, mode = MOE_CASES[case]
    jcfg, cfg = _moe_cfgs(arch, quant_mode=mode, **extra)
    jp = _quantized_moe(jax.tree.map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(0), jcfg)), mode)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     shape + (cfg.d_model,)))
    with jax_routing() as j_routing:
        want, want_aux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    want = np.asarray(want)
    T = shape[0] * shape[1]
    Tg = min(moe.MOE_GROUP, T)
    C = moe.capacity(cfg, Tg)
    assert C == max(int(Tg * cfg.top_k / cfg.n_experts
                        * cfg.capacity_factor), 1)
    jd, jcomb, _ = jmoe._route_group(
        jp, jnp.asarray(x).reshape(-1, Tg, cfg.d_model), jcfg, C)
    tp = lm_params_from_numpy(jp, "cpu")
    assert tp["router"].dtype == torch.float32

    def port(pin=None):
        with routing_sites(pin) as sites:
            y, aux = moe.moe_forward(tp, _t(x), cfg)
            d, comb, _ = moe._route_group(tp, _t(x).reshape(-1, Tg,
                                                            cfg.d_model),
                                          cfg, C)
        return _np(y), float(aux), _np(d), _np(comb), sites[:1]

    y, aux, d, comb, sites = port()
    ok = (np.array_equal(d, np.asarray(jd))
          and np.abs(y - want).max() <= 1e-5 * np.abs(want).max())
    if not ok:
        moved = moved_routing(j_routing, sites, cfg)
        print(f"{case}: routing moved (choices, kept) {moved}")
        assert sum(a + b for a, b in moved) > 0, "a gap with no moved routing"
        y, aux, d, comb, _ = port(pin=j_routing * 2)
    np.testing.assert_array_equal(d, np.asarray(jd))
    np.testing.assert_allclose(comb, np.asarray(jcomb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert aux == pytest.approx(float(want_aux), rel=1e-6)
    assert y.shape == x.shape and d.sum() <= d.shape[0] * cfg.n_experts * C


def test_top_k_ties_go_to_the_lower_expert():
    """A token whose router input is all zero has equal probabilities:
    ``jax.lax.top_k`` takes the lowest expert indices, and so does the
    port (``torch.topk`` promises no order among ties)."""
    jcfg, cfg = _moe_cfgs()
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0), jcfg))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                   (1, 32, cfg.d_model)))
    x[0, ::3] = 0.0
    C = moe.capacity(cfg, 32)
    jd, _, _ = jmoe._route_group(jp, jnp.asarray(x), jcfg, C)
    tp = lm_params_from_numpy(jp, "cpu")
    with routing_sites() as sites:
        d, _, _ = moe._route_group(tp, _t(x), cfg, C)
    np.testing.assert_array_equal(_np(d), np.asarray(jd))
    for t in range(0, 32, 3):
        assert sites[0][0, t].tolist() == list(range(cfg.top_k))
    with pytest.raises(ValueError, match="group"):
        moe.moe_forward(tp, torch.zeros((1, 600, cfg.d_model)), cfg)


# --- TestMoE's invariants on the port -------------------------------------------

def test_expert_outputs_combine_weighted():
    _, cfg = _moe_cfgs()
    params = moe.init_moe(cfg, 0, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 32, cfg.d_model)).astype(np.float32))
    y, aux = moe.moe_forward(params, x, cfg)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert float(aux) > 0.5      # balance loss ~1 for a near-uniform router


def test_capacity_drops_are_bounded():
    """With capacity factor >= 1 and a near-uniform router, most tokens
    are routed (the output norm not collapsed)."""
    _, cfg = _moe_cfgs(capacity_factor=2.0)
    params = moe.init_moe(cfg, 0, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 64, cfg.d_model)).astype(np.float32))
    y, _ = moe.moe_forward(params, x, cfg)
    routed = float((torch.linalg.norm(y[0], dim=-1) > 1e-6).float().mean())
    assert routed > 0.9


def test_router_fp32_under_quant():
    """Branch separation: the router is float32 whatever ``param_dtype``
    is, stays float under the serve quantization (the experts become
    codes), and routes bf16 activations in float32."""
    _, cfg = _moe_cfgs(param_dtype=torch.bfloat16)
    params = tfm.init_lm(cfg, 0, "cpu")
    assert params["blocks"]["moe"]["router"].dtype == torch.float32
    assert params["blocks"]["moe"]["wg"].dtype == torch.bfloat16
    served = apply.quantize_params_tree(params, dataclasses.replace(
        cfg, quant_mode="serve_w8a8"))
    m = served["blocks"]["moe"]
    assert m["router"].dtype == torch.float32
    assert m["wg"][0].dtype == torch.int8
    assert m["wg"][1].shape == (cfg.n_layers, cfg.n_experts, 1, cfg.d_ff)
    layer = {k: (v[0] if not isinstance(v, tuple) else (v[0][0], v[1][0]))
             for k, v in m.items()}
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0)).to(torch.bfloat16)
    y, aux = moe.moe_forward(layer, x, dataclasses.replace(
        cfg, quant_mode="serve_w8a8"))
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32


# --- forward, lm_loss ---------------------------------------------------------------

def _lm_cfgs(arch, dtype="f32", **extra):
    jdt, tdt = DTYPES[dtype]
    extra.setdefault("attn_chunk_q", 8)
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=jdt,
                                **extra),
            dataclasses.replace(configs.get_smoke_config(arch), dtype=tdt,
                                **extra))


def _tokens(cfg, seed=1, n=16):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg.vocab, size=(2, n)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(2, n)).astype(np.int32)
    mask = (rng.random((2, n)) < 0.7).astype(np.float32)
    return x, labels, mask


@functools.lru_cache(maxsize=None)
def _jax_forward(arch, dtype):
    """JAX's logits, aux, loss and per-layer routing (numpy)."""
    jcfg, _ = _lm_cfgs(arch, dtype)
    x, labels, mask = _tokens(jcfg)
    batch = {"tokens": jnp.asarray(x), "labels": jnp.asarray(labels),
             "mask": jnp.asarray(mask)}
    with jax_routing() as routing:
        logits, aux = jax.jit(lambda p, t: jtfm.forward(p, jcfg, tokens=t))(
            _jax_tree(arch), batch["tokens"])
        loss = jax.jit(lambda p, b: jtfm.lm_loss(p, jcfg, b))(
            _jax_tree(arch), batch)
        jax.block_until_ready(loss)
    return (np.asarray(logits), float(aux), float(loss),
            routing[:jcfg.n_layers])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch, dtype):
    """``forward`` (the logits and the balance loss summed over the layers
    and divided by their number), the prefill step and ``lm_loss`` (cross
    entropy + 0.01 aux)."""
    want, want_aux, want_loss, j_routing = _jax_forward(arch, dtype)
    _, cfg = _lm_cfgs(arch, dtype)
    x, labels, mask = _tokens(cfg)
    params = lm_params_from_numpy(_jax_tree(arch), "cpu")
    batch = {"tokens": _t(x), "labels": _t(labels), "mask": _t(mask)}
    tol, loss_tol = (1e-5, 1e-5) if dtype == "f32" else (6e-2, 2e-2)

    def port(pin=None):
        with routing_sites(pin) as sites:
            logits, aux = tfm.forward(params, cfg, tokens=_t(x))
        with routing_sites(pin):
            loss = float(tfm.lm_loss(params, cfg, batch))
            got = steps.make_prefill_step(cfg)(params, batch)
        assert torch.equal(got, logits)
        return _np(logits), float(aux), loss, sites

    logits, aux, loss, sites = port()
    assert len(sites) == cfg.n_layers and logits.shape == want.shape
    ok = (np.abs(logits - want).max() <= tol * np.abs(want).max()
          and loss == pytest.approx(want_loss, rel=loss_tol))
    if not ok:
        moved = moved_routing(j_routing, sites, cfg)
        print(f"{arch} {dtype}: routing moved (choices, kept) {moved}")
        assert sum(a + b for a, b in moved) > 0, "a gap with no moved routing"
        logits, aux, loss, _ = port(pin=j_routing)
    np.testing.assert_allclose(logits, want, rtol=0,
                               atol=tol * np.abs(want).max())
    assert loss == pytest.approx(want_loss, rel=loss_tol)
    assert aux > 0.5
    if dtype == "f32":
        assert aux == pytest.approx(want_aux, rel=1e-6)


# --- the gradient -------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch, mode):
    """Eager ``jax.value_and_grad(lm_loss)``: (loss, grads, QAT sites,
    routing)."""
    jcfg, _ = _cfgs(arch, mode)
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    with jax_sites() as sites, jax_routing() as routing:
        loss, grads = jax.value_and_grad(jtfm.lm_loss)(_jax_tree(arch), jcfg,
                                                       batch)
        grads = jax.tree.map(np.asarray, grads)
    return float(loss), grads, sites[0], routing[:jcfg.n_layers]


@pytest.mark.parametrize("mode", ["none", "qat_w4a8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_jax(arch, mode):
    """Every gradient leaf of ``lm_loss`` (the router's through the gate
    values and the balance loss, the experts' through the combine)
    against eager ``jax.value_and_grad``. In ``qat_w4a8`` the experts are
    not fake-quantized (the reference's ``_expert_w``): 8 sites a layer,
    the attention's; a miss must come with moved W4 or A8 sites or moved
    routing, and then holds with JAX's pinned."""
    want_loss, want, j_sites, j_routing = _jax_value_and_grad(arch, mode)
    _, cfg = _cfgs(arch, mode)
    batch = {k: _t(v) for k, v in _batch(cfg).items()}
    params = lm_params_from_numpy(_jax_tree(arch), "cpu")

    def port(pin_sites=None, pin_routing=None):
        with port_sites(pin_sites) as sites, \
                routing_sites(pin_routing) as routing:
            loss, grads = steps.lm_value_and_grad(params, cfg, batch)
        return float(loss), grads, sites, routing

    loss, grads, p_sites, p_routing = port()
    assert set(dict(tree.items(grads))) == set(dict(tree.items(want)))
    assert float(grads["blocks"]["moe"]["router"].abs().max()) > 0
    assert len(p_sites) == len(j_sites) == (8 * cfg.n_layers
                                            if mode != "none" else 0)
    ok, what = _holds(loss, grads, want_loss, want)
    if not ok:
        moved = (moved_sites(j_sites, p_sites),
                 moved_routing(j_routing, p_routing, cfg))
        print(f"{arch} {mode}: {what}; moved sites and routing {moved}")
        assert sum(moved[0]) + sum(a + b for a, b in moved[1]) > 0, \
            f"{what} with nothing moved"
        loss, grads, _, _ = port(j_sites if mode != "none" else None,
                                 j_routing)
        ok, what = _holds(loss, grads, want_loss, want)
    assert ok, f"with JAX's sites and routing pinned: {what}"


# --- decode -----------------------------------------------------------------------

@pytest.mark.parametrize("mode,kv_quant", [("none", False),
                                           ("serve_w8a8", False),
                                           ("serve_w8a8", True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch, mode, kv_quant):
    """Teacher-forced decode of both packages on the same weights, step
    by step (each step routes its B = 3 tokens as one group: C =
    max(int(3 k / E x 1.25), 1) = 1 here, so most choices drop, in both
    packages): a float cache, and the int8 cache through K5' and K6's
    plain versions on the CPU (no kernel launched)."""
    jcfg, cfg = _lm_cfgs(arch, quant_mode=mode, kv_quant=kv_quant)
    tree_ = _jax_tree(arch)
    if mode != "none":
        tree_ = jax.tree.map(np.asarray, japply.quantize_params_tree(
            tree_, jcfg))
    params = lm_params_from_numpy(tree_, "cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab, size=(8, 3, 1))
    jc, tc = jtfm.init_cache(jcfg, 3, 8), tfm.init_cache(cfg, 3, 8, "cpu")
    assert moe.capacity(cfg, 3) == 1
    before = (kv_append_int8.launches, decode_attention_int8kv.launches)
    with jax_routing() as j_routing:
        jstep = jax.jit(lambda p, c, t, i: jsteps.make_serve_step(jcfg)(
            p, c, t, i))
        jl = []
        for i in range(8):
            out, jc = jstep(tree_, jc, jnp.asarray(toks[i], jnp.int32),
                            jnp.asarray(i, jnp.int32))
            jl.append(np.asarray(out))
    jl = np.stack(jl)

    def port(pin=None):
        cache = tfm.init_cache(cfg, 3, 8, "cpu")
        step = steps.make_serve_step(cfg)
        with routing_sites(pin) as sites:
            tl = np.stack([_np(step(params, cache, _t(toks[i]), i)[0])
                           for i in range(8)])
        return tl, sites, cache

    tl, sites, tc = port()
    assert np.isfinite(tl).all() and len(sites) == 8 * cfg.n_layers
    if np.abs(tl - jl).max() > 1e-5 * np.abs(jl).max():
        moved = moved_routing(j_routing, sites, cfg)
        print(f"{arch} {mode} kv_quant={kv_quant}: routing moved {moved}")
        assert sum(a + b for a, b in moved) > 0, "a gap with no moved routing"
        tl, _, tc = port(pin=j_routing)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5 * np.abs(jl).max())
    if kv_quant:
        for name in ("k_q", "v_q"):
            np.testing.assert_array_equal(_np(tc["blocks"][name]),
                                          np.asarray(jc["blocks"][name]))
    assert (kv_append_int8.launches,
            decode_attention_int8kv.launches) == before


# --- the launchers ------------------------------------------------------------------

def test_serve_and_train_launchers_take_the_moe_archs(capsys, tmp_path):
    """``--arch`` takes the MoE ids: the serve CLI decodes the smoke
    config (serve_w8a8, int8 KV) and the training launcher's loss falls
    over a few steps."""
    for arch in ARCHS:
        serve.main(["--workload", "lm", "--arch", arch, "--smoke", "--quant",
                    "serve_w8a8", "--kv-quant", "--tokens", "3", "--batch",
                    "2", "--cache-len", "4", "--device", "cpu"])
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith(f"arch={configs.get_smoke_config(arch).name}")
        assert "ms/step" in out[3]
    args = train.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device",
                       "cpu", "--steps", "12", "--batch", "2", "--seq", "32",
                       "--lr", "3e-3", "--ckpt-every", "0", "--ckpt-dir",
                       str(tmp_path / "ckpt")])
    assert args._log[-1][1] < args._log[0][1]
