"""The port's LM prefill (causal attention, forward, lm_loss), its int4 KV
cache and its decode from embeddings, against the JAX package on the CPU.

Every tree is built by the JAX ``init_lm(PRNGKey(0))`` (random QKV
biases and per-layer ``tau`` added with numpy, so those paths carry
weight) and crosses over as numpy (``weights.lm_params_from_numpy``).
Every case is float32 unless it says otherwise.

Tolerances: ``causal_attention`` to rtol = atol = 1e-4, as
``tests/test_lm_correctness.py::TestChunkedAttention`` holds the JAX
one; logits to 1e-5 of the largest |logit| in float32 (the packages sum
their matmuls in other orders) and to 6e-2 in bf16 (the bound of the
bf16 decode tests in ``tests/test_torch_lm.py``: the packages round in
other places); the loss to 1e-5 relative in float32 and 2e-2 in bf16;
the port's teacher-forced decode against its own forward at rtol = atol
= 5e-3, as ``TestDecodeConsistency`` and ``TestKVReplication`` hold
JAX's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import so3krates_paper as jso3_paper
from repro.launch import steps as jsteps
from repro.models.lm import attention as jattn
from repro.models.lm import transformer as jtfm
from repro.models.lm.config import SHAPES as JSHAPES
from repro_torch import configs
from repro_torch.configs import so3krates_paper
from repro_torch.kernels.act_quant import act_quant, kv_append_int8
from repro_torch.kernels.attention_int8kv import decode_attention_int8kv
from repro_torch.launch import steps
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import transformer as tfm
from repro_torch.models.lm.config import SHAPES
from repro_torch.quant import apply
from repro_torch.weights import lm_params_from_numpy

# the transformer-pattern archs without MoE blocks; the other families:
# tests/test_torch_lm_{moe,ssm,xlstm}.py
ARCHS = tuple(a for a in configs.ARCH_IDS
              if configs.get_config(a).block_pattern == "transformer"
              and not configs.get_config(a).moe)
B, S = 2, 16
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch, dtype="f32", **extra):
    jdt, tdt = DTYPES[dtype]
    extra.setdefault("attn_chunk_q", 8)
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=jdt,
                                **extra),
            dataclasses.replace(configs.get_smoke_config(arch), dtype=tdt,
                                **extra))


@functools.lru_cache(maxsize=None)
def _jax_tree(arch, mode="none"):
    """The JAX ``init_lm(PRNGKey(0))`` tree of the smoke config, with
    random QKV biases and tau, as numpy; quantized for ``mode`` unless it
    is none (by the port's ``quantize_params_tree``, whose codes and
    scales equal the JAX one's bit for bit:
    ``tests/test_torch_lm.py::test_quantize_params_tree_matches_jax_exactly``).
    Shared by the tests, which never write to it."""
    if mode != "none":
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  quant_mode=mode)
        return jax.tree.map(_np, apply.quantize_params_tree(
            lm_params_from_numpy(_jax_tree(arch), "cpu"), cfg),
            is_leaf=lambda a: isinstance(a, torch.Tensor))
    params = jax.tree.map(np.asarray, jax.jit(
        jtfm.init_lm, static_argnums=1)(jax.random.PRNGKey(0),
                                        jconfigs.get_smoke_config(arch)))
    rng = np.random.default_rng(1)
    a = params["blocks"]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in a:
            a[name] = (rng.normal(size=a[name].shape) * 0.1).astype(
                np.float32)
    if "tau" in a:
        a["tau"] = rng.uniform(4.0, 12.0, a["tau"].shape).astype(np.float32)
    return params


def _inputs(cfg, seed=1, n=S):
    """(tokens or embeds as numpy, labels, a partial mask)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "token":
        x = rng.integers(0, cfg.vocab, size=(B, n)).astype(np.int32)
    else:
        x = rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, size=(B, n)).astype(np.int32)
    mask = (rng.random((B, n)) < 0.7).astype(np.float32)
    return x, labels, mask


def _key(cfg):
    return "tokens" if cfg.frontend == "token" else "embeds"


# --- causal attention -------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_causal_attention_matches_jax(chunk):
    jcfg, cfg = _cfgs("llama3.2-3b", attn_chunk_q=chunk)
    params = jax.tree.map(np.asarray,
                          jattn.init_attention(jax.random.PRNGKey(0), jcfg))
    x = np.random.default_rng(1).normal(size=(2, 64, cfg.d_model)).astype(
        np.float32)
    want = jattn.causal_attention(params, jnp.asarray(x), jcfg)
    got = attn.causal_attention(lm_params_from_numpy(params, "cpu"), _t(x),
                                cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="chunk"):
        attn.causal_attention(lm_params_from_numpy(params, "cpu"),
                              _t(x[:, :60]), dataclasses.replace(
                                  cfg, attn_chunk_q=16))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "chameleon-34b"])
def test_init_attention_has_the_jax_shapes(arch):
    jcfg, cfg = _cfgs(arch)
    want = jax.eval_shape(lambda k: jattn.init_attention(k, jcfg),
                          jax.random.PRNGKey(0))
    got = attn.init_attention(cfg, np.random.default_rng(3), "cpu")
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        assert tuple(got[name].shape) == spec.shape, name
        assert str(got[name].dtype) == "torch." + str(spec.dtype), name
    big = dataclasses.replace(cfg, d_model=512)
    assert abs(float(attn.init_attention(big, 0, "cpu")["wq"].std())
               - 512 ** -0.5) < 2e-3


# --- forward, lm_loss, the prefill step -----------------------------------

@functools.lru_cache(maxsize=None)
def _jax_forward_and_loss(arch, dtype):
    jcfg, _ = _cfgs(arch, dtype)
    x, labels, mask = _inputs(jcfg)
    batch = {_key(jcfg): jnp.asarray(x), "labels": jnp.asarray(labels),
             "mask": jnp.asarray(mask)}

    @jax.jit
    def run(p, b):
        return (jsteps.make_prefill_step(jcfg)(p, b),
                jtfm.lm_loss(p, jcfg, b))
    logits, loss = run(_jax_tree(arch), batch)
    return np.asarray(logits), float(loss)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch, dtype):
    jcfg, cfg = _cfgs(arch, dtype)
    want, want_loss = _jax_forward_and_loss(arch, dtype)
    x, labels, mask = _inputs(cfg)
    params = lm_params_from_numpy(_jax_tree(arch), "cpu")
    batch = {_key(cfg): _t(x), "labels": _t(labels), "mask": _t(mask)}
    got = steps.make_prefill_step(cfg)(params, batch)
    logits, aux = tfm.forward(params, cfg, **{_key(cfg): _t(x)})
    assert torch.equal(got, logits)
    assert got.dtype == torch.float32 and got.shape == (B, S, cfg.vocab)
    assert aux.shape == () and float(aux) == 0.0
    tol, loss_tol = (1e-5, 1e-5) if dtype == "f32" else (6e-2, 2e-2)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * np.abs(want).max())
    loss = float(tfm.lm_loss(params, cfg, batch))
    assert loss == pytest.approx(want_loss, rel=loss_tol)
    if dtype == "f32":
        # the mask weighs the tokens: all-ones and no mask agree, and an
        # all-zero mask divides by max(0, 1)
        nomask = {k: v for k, v in batch.items() if k != "mask"}
        ones = dict(nomask, mask=torch.ones(B, S))
        assert float(tfm.lm_loss(params, cfg, nomask)) == pytest.approx(
            float(tfm.lm_loss(params, cfg, ones)), rel=1e-6)
        zeros = dict(nomask, mask=torch.zeros(B, S))
        assert float(tfm.lm_loss(params, cfg, zeros)) == 0.0


# --- decode against the port's own forward ----------------------------------

@pytest.mark.parametrize("arch,extra", [(a, {}) for a in ARCHS]
                         + [("llama3.2-3b", {"kv_replicate": 3})])
def test_decode_matches_forward(arch, extra):
    """Feeding the sequence one token (or embedding) at a time through the
    serve step reproduces the prefill's logits (unquantized cache)."""
    _, cfg = _cfgs(arch, **extra)
    params = lm_params_from_numpy(_jax_tree(arch), "cpu")
    x = _t(_inputs(cfg)[0])
    full, _ = tfm.forward(params, dataclasses.replace(cfg, kv_replicate=1),
                          **{_key(cfg): x})
    cache = tfm.init_cache(cfg, B, S, "cpu")
    step = steps.make_serve_step(cfg)
    dec = torch.stack([step(params, cache, x[:, i:i + 1], i)[0]
                       for i in range(S)], dim=1)
    np.testing.assert_allclose(_np(dec), _np(full), rtol=5e-3, atol=5e-3)


# --- the int4 cache and the embedding decode against JAX ---------------------

@pytest.mark.parametrize("arch,kv,extra", [
    ("qwen2-0.5b", 4, {}), ("chameleon-34b", 4, {}),
    ("llama3.2-3b", 4, {"kv_replicate": 3}), ("musicgen-large", 8, {})])
def test_decode_matches_jax(arch, kv, extra):
    """Teacher-forced decode of both packages on the same served weights
    (serve_w8a8): the int4 cache (its packed bytes equal JAX's, its
    scales to float32 rounding; replicated kv heads repeated before the
    write, as JAX does) and the int8 cache, from tokens or from
    embeddings (qk-norm and image patches; audio frames); the int4 path
    launches no kernel."""
    jcfg, cfg = _cfgs(arch, kv_quant=True, kv_bits=kv,
                      quant_mode="serve_w8a8", **extra)
    tree = _jax_tree(arch, "serve_w8a8")
    params = lm_params_from_numpy(tree, "cpu")
    x = _inputs(cfg, seed=5, n=8)[0]
    jc, tc = jtfm.init_cache(jcfg, B, 8), tfm.init_cache(cfg, B, 8, "cpu")
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jc) == \
        jax.tree.map(lambda a: (tuple(a.shape),
                                str(a.dtype).replace("torch.", "")), tc,
                     is_leaf=lambda a: isinstance(a, torch.Tensor))
    jstep = jax.jit(lambda p, c, t, i: jsteps.make_serve_step(jcfg)(
        p, c, t, i))
    tstep = steps.make_serve_step(cfg)
    counters = (act_quant, kv_append_int8, decode_attention_int8kv)
    before = [c.launches for c in counters]
    jl, tl = [], []
    for i in range(8):
        out, jc = jstep(tree, jc, jnp.asarray(x[:, i:i + 1]),
                        jnp.asarray(i, jnp.int32))
        jl.append(np.asarray(out))
        tl.append(_np(tstep(params, tc, _t(x[:, i:i + 1]), i)[0]))
    jl, tl = np.stack(jl), np.stack(tl)
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5 * np.abs(jl).max())
    assert [c.launches for c in counters] == before
    if kv == 4:
        for name in ("k_q", "v_q"):
            assert tc["blocks"][name].dtype == torch.uint8
            np.testing.assert_array_equal(_np(tc["blocks"][name]),
                                          np.asarray(jc["blocks"][name]))
        for name in ("k_s", "v_s"):
            np.testing.assert_allclose(_np(tc["blocks"][name]),
                                       np.asarray(jc["blocks"][name]),
                                       rtol=1e-5, atol=0)
        with pytest.raises(ValueError, match="kv_bits"):
            tfm.init_cache(dataclasses.replace(cfg, kv_bits=2), B, 4, "cpu")


# --- registry and input specs ----------------------------------------------

def test_shapes_and_input_specs_match_jax():
    """Every arch of the JAX registry, in its order: ``shapes_for``
    (long_500k for the two sub-quadratic archs only) and each cell's
    input specs."""
    assert SHAPES == tuple(type(SHAPES[0])(**dataclasses.asdict(s))
                           for s in JSHAPES)
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert set(ARCHS) == {a for a in jconfigs.ARCH_IDS
                          if jconfigs.get_config(a).block_pattern
                          == "transformer" and not jconfigs.get_config(a).moe}
    long = [a for a in configs.ARCH_IDS
            if "long_500k" in [c.shape_name for c in configs.shapes_for(a)]]
    assert long == ["zamba2-1.2b", "xlstm-1.3b"]
    for arch in configs.ARCH_IDS:
        want = jconfigs.shapes_for(arch)
        got = configs.shapes_for(arch)
        assert [dataclasses.asdict(s) for s in got] == \
            [dataclasses.asdict(s) for s in want]
        jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
        for cell, jcell in zip(got, want):
            jspec = jsteps.input_specs(jcfg, jcell)
            spec = steps.input_specs(cfg, cell)
            assert list(spec) == list(jspec), (arch, cell.shape_name)
            for k, s in jspec.items():
                assert tuple(spec[k].shape) == s.shape
                assert str(spec[k].dtype) == "torch." + str(s.dtype)
                assert spec[k].device.type == "meta"


def test_so3krates_paper_config_matches_jax():
    assert "so3krates_paper" not in ARCHS
    for get, args in (("config", ()), ("config", ("naive_int8",)),
                      ("smoke", ())):
        j = getattr(jso3_paper, get)(*args)
        t = getattr(so3krates_paper, get)(*args)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
