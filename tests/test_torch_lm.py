"""The port's LM decode against the JAX package's, on the CPU.

Weights are drawn with numpy (the port's ``init_lm``, plus random QKV
biases so the bias path is exercised), quantized by the JAX
``quantize_params_tree`` and cross over as numpy
(``weights.lm_params_from_numpy``); both packages then
decode the same tokens (teacher forcing: a one-ulp logit difference could
flip a greedy argmax and send two free-running loops apart).

Tolerances: the layers to 1e-6; quantized weights exactly; the decode
logits in float32 to 1e-5 of the largest |logit| (the packages sum their
matmuls in other orders); in bf16 to 6e-2 of the largest |logit|,
measured: each package's bf16 decode sits 1.4-1.8% of the largest |logit|
from the float32 decode on these configs, and the two round in other
places (the JAX jnp path takes the dequantized K/V and the logits in
bf16, the port's kernel in float32; XLA keeps excess precision in the
jitted KV write), so they differ by up to 3.9% here.
"""
import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.lm import layers as jlayers
from repro.models.lm import transformer as jtfm
from repro.models.lm.config import LMConfig as JLMConfig
from repro.quant import apply as japply
from repro_torch import configs, tree
from repro_torch.kernels import ops
from repro_torch.kernels.act_quant import act_quant, kv_append_int8
from repro_torch.kernels.attention_int8kv import decode_attention_int8kv
from repro_torch.launch import serve
from repro_torch.models.lm import layers
from repro_torch.models.lm import transformer as tfm
from repro_torch.models.lm.config import LMConfig
from repro_torch.quant import apply
from repro_torch.weights import lm_params_from_numpy

ARCHS = ("qwen2-0.5b", "llama3.2-3b")
MODES = ("serve_w8a8", "serve_w4a8")


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- config ------------------------------------------------------------------

def test_config_fields_and_defaults_match_jax():
    j_fields = {f.name: f.default for f in dataclasses.fields(JLMConfig)}
    t_fields = {f.name: f.default for f in dataclasses.fields(LMConfig)}
    assert list(t_fields) == list(j_fields)
    for name, default in j_fields.items():
        if name == "dtype":
            assert t_fields[name] is torch.bfloat16
        elif name == "param_dtype":
            assert t_fields[name] is torch.float32
        else:
            assert t_fields[name] == default, name


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_arch_configs_match_jax(arch):
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jconfigs, get)(arch), getattr(configs, get)(arch)
        for f in dataclasses.fields(j):
            if f.name not in ("dtype", "param_dtype"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.hd == j.hd and t.param_count() == j.param_count()
    full = configs.get_config("qwen2-0.5b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.d_ff, full.vocab) == (24, 896, 14, 2, 64, 4864,
                                                151936)
    assert full.rope_theta == 500000.0          # the reference's default
    assert configs.get_config(arch, kv_quant=True).kv_quant


def test_unported_archs_raise():
    """Every arch of the JAX registry resolves, the MoE, Mamba2-hybrid
    and xLSTM ids included, to the JAX configs' fields; an unknown id
    raises."""
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in ("zamba2-1.2b", "xlstm-1.3b", "moonshot-v1-16b-a3b",
                 "qwen3-moe-30b-a3b"):
        for get in ("get_config", "get_smoke_config"):
            j, t = getattr(jconfigs, get)(arch), getattr(configs, get)(arch)
            for f in dataclasses.fields(j):
                if f.name not in ("dtype", "param_dtype"):
                    assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert [dataclasses.asdict(c) for c in configs.shapes_for(arch)] == \
            [dataclasses.asdict(c) for c in jconfigs.shapes_for(arch)]
    for get in (configs.get_config, configs.get_smoke_config,
                configs.shapes_for):
        with pytest.raises(KeyError, match="nope"):
            get("nope")


# --- layers --------------------------------------------------------------------

def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 4, 16)).astype(np.float32) * 3
    w = rng.normal(size=(16,)).astype(np.float32)
    pos = np.array([[0, 1, 7, 63, 1000]] * 3, np.int32)
    for f32_stats in (True, False):
        np.testing.assert_allclose(
            _np(layers.rmsnorm(_t(x), _t(w), f32_stats=f32_stats)),
            np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w),
                                       f32_stats=f32_stats)),
            rtol=1e-6, atol=1e-6)
    for theta in (500000.0, 10000.0):
        np.testing.assert_allclose(
            _np(layers.apply_rope(_t(x), _t(pos), theta)),
            np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                          theta)), rtol=1e-6, atol=1e-6)
    xb = layers.apply_rope(_t(x).to(torch.bfloat16), _t(pos), 500000.0)
    assert xb.dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ("none",) + MODES)
def test_qlinear_matches_jax(mode):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 1, 48)).astype(np.float32)
    w = rng.normal(size=(48, 32)).astype(np.float32) / 7
    b = rng.normal(size=(32,)).astype(np.float32)
    jw = (jnp.asarray(w) if mode == "none"
          else japply.quantize_matrix(jnp.asarray(w), mode))
    tw = _t(w) if mode == "none" else apply.quantize_matrix(_t(w), mode)
    want = jlayers.qlinear(jnp.asarray(x), jw, mode, jnp.asarray(b))
    got = layers.qlinear(_t(x), tw, mode, _t(b))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the QAT branch is ported (its gradients: tests/test_torch_lm_train.py)
    want = jlayers.qlinear(jnp.asarray(x), jnp.asarray(w), "qat_w4a8")
    np.testing.assert_allclose(_np(layers.qlinear(_t(x), _t(w), "qat_w4a8")),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_params_tree_matches_jax_exactly(mode):
    """Codes and per-matrix scales (over axis -2 of the stacked
    (depth, K, N) weights, not over the whole stack) equal JAX's."""
    cfg = dataclasses.replace(jconfigs.get_smoke_config("qwen2-0.5b"),
                              quant_mode=mode)
    jq = _jax_tree("qwen2-0.5b", mode)
    tq = apply.quantize_params_tree(
        lm_params_from_numpy(_jax_tree("qwen2-0.5b", "none"), "cpu"), cfg)
    j_leaves, j_def = jax.tree.flatten(jq)
    t_leaves, t_def = jax.tree.flatten(jax.tree.map(
        _np, tq, is_leaf=lambda a: isinstance(a, torch.Tensor)))
    assert j_def == t_def
    for a, b in zip(j_leaves, t_leaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    wq_scale = tq["blocks"]["attn"]["wq"][1]
    assert wq_scale.shape == (cfg.n_layers, 1, cfg.n_heads * cfg.hd)
    assert apply.quantized_bytes(tq) == sum(
        a.nbytes for a in jax.tree.leaves(jq))


def test_init_lm_has_the_jax_shapes_and_scales():
    cfg = configs.get_smoke_config("qwen2-0.5b")
    jcfg = jconfigs.get_smoke_config("qwen2-0.5b")
    want = jax.tree.map(lambda a: (a.shape, a.dtype), jax.eval_shape(
        lambda key: jtfm.init_lm(key, jcfg), jax.random.PRNGKey(0)))
    got = tfm.init_lm(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), got,
                        is_leaf=lambda a: isinstance(a, torch.Tensor)) == \
        jax.tree.map(lambda s: (s[0], "torch." + str(s[1])), want,
                     is_leaf=lambda s: isinstance(s, tuple))
    big = dataclasses.replace(cfg, d_model=256, d_ff=1024, vocab=4096)
    p = tfm.init_lm(big, seed=1, device="cpu")
    assert abs(float(p["embed"].std()) - 0.02) < 1e-3
    assert abs(float(p["blocks"]["mlp"]["wd"].std()) - 1024 ** -0.5) < 2e-3
    assert torch.equal(tfm.init_lm(big, seed=1, device="cpu")["embed"],
                       p["embed"])
    # the other block patterns build the JAX tree's keys and shapes
    for other in (dict(block_pattern="zamba2", n_layers=4),
                  dict(moe=True, n_experts=4, top_k=2)):
        jo = dataclasses.replace(jcfg, **other)
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jax.eval_shape(
            lambda key: jtfm.init_lm(key, jo), jax.random.PRNGKey(0)))
        got = tfm.init_lm(dataclasses.replace(cfg, **other), device="cpu")
        assert jax.tree.map(
            lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")),
            got, is_leaf=lambda a: isinstance(a, torch.Tensor)) == want


# sha256 (first 32 hex digits) over every (path, bytes) of the dense
# archs' seeded smoke trees, in JAX's leaf order, taken before the
# MoE, Mamba2-hybrid and xLSTM families joined init_lm
DENSE_INIT_SHA256 = {
    ("musicgen-large", 0): "235f2c55e919a9dadb554089a9bd01fe",
    ("musicgen-large", 3): "8c4ccf1c972a0af86373f96512af58c4",
    ("qwen1.5-110b", 0): "102d3e541fb1455c2d8ad12ce239f547",
    ("qwen1.5-110b", 3): "157e1fcb5826f766a37a53672441740d",
    ("llama3.2-3b", 0): "53b235566ee0195ffb7d2077fc6a06c3",
    ("llama3.2-3b", 3): "dc91ec05ed801a3ca5cf71ac44d6ba3c",
    ("nemotron-4-15b", 0): "ef7d7746777a5b6b1eaca483de772427",
    ("nemotron-4-15b", 3): "fc471be2caacec74dc9c98d2ebde1b43",
    ("qwen2-0.5b", 0): "a9503907720d663fdf65b585b09e3a4a",
    ("qwen2-0.5b", 3): "e80cade9ef9aca3ceb3ffc7a0279319c",
    ("chameleon-34b", 0): "b6e68ea364349c845ad72a74cfa2679d",
    ("chameleon-34b", 3): "42bd3475fe15c395c59a1f8309ccb894",
}


@pytest.mark.parametrize("arch,seed", sorted(DENSE_INIT_SHA256))
def test_dense_init_lm_draws_are_unchanged(arch, seed):
    """The six dense archs' seeded ``init_lm`` weights are bit for bit
    those drawn before the other families were ported, so every seeded
    gate built on them holds as before."""
    h = hashlib.sha256()
    params = tfm.init_lm(configs.get_smoke_config(arch), seed=seed,
                         device="cpu")
    for path, leaf in tree.items(params):
        h.update(path.encode())
        h.update(leaf.numpy().tobytes())
    assert h.hexdigest()[:32] == DENSE_INIT_SHA256[(arch, seed)]


# --- decode --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_tree(arch, mode):
    """Smoke-config weights from numpy (random QKV biases added),
    quantized by the JAX ``quantize_params_tree`` unless ``mode`` is none;
    as numpy. Shared by the tests, which never write to it."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               quant_mode=mode)
    if mode != "none":
        return jax.tree.map(np.asarray, japply.quantize_params_tree(
            _jax_tree(arch, "none"), jcfg))
    params = jax.tree.map(
        _np, tfm.init_lm(configs.get_smoke_config(arch), 0, "cpu"),
        is_leaf=lambda a: isinstance(a, torch.Tensor))
    rng = np.random.default_rng(1)
    for name in ("bq", "bk", "bv"):
        if name in params["blocks"]["attn"]:
            shape = params["blocks"]["attn"][name].shape
            params["blocks"]["attn"][name] = (
                rng.normal(size=shape) * 0.1).astype(np.float32)
    return params


def _both(arch, mode, kv_quant, dtype):
    """The same served weights in both packages, and both configs."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               quant_mode=mode, kv_quant=kv_quant, dtype=jdt)
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              quant_mode=mode, kv_quant=kv_quant, dtype=tdt)
    params = _jax_tree(arch, mode)
    return jcfg, params, cfg, lm_params_from_numpy(params, "cpu")


def _teacher_forced(arch, mode, kv_quant, dtype, B=3, S=16, n=8):
    jcfg, jp, cfg, tp = _both(arch, mode, kv_quant, dtype)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, size=(n, B, 1))
    jcache = jtfm.init_cache(jcfg, B, S)
    tcache = tfm.init_cache(cfg, B, S, "cpu")
    step = jax.jit(lambda p, c, t, i: jtfm.decode_step(p, jcfg, c, t, i))
    head = tfm.lm_head(tp, cfg)
    jl, tl = [], []
    for i in range(n):
        out, jcache = step(jp, jcache, jnp.asarray(toks[i], jnp.int32),
                           jnp.asarray(i, jnp.int32))
        jl.append(np.asarray(out))
        logits, _ = tfm.decode_step(tp, cfg, tcache, _t(toks[i]), i, head)
        tl.append(_np(logits))
    return np.stack(jl), np.stack(tl), jcache, tcache


@pytest.mark.parametrize("kv_quant", [True, False])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_f32(arch, mode, kv_quant):
    jl, tl, jcache, tcache = _teacher_forced(arch, mode, kv_quant, "f32")
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5 * np.abs(jl).max())
    if kv_quant:
        # the int8 codes equal JAX's; the scales differ in the last bits
        # (the K/V rows come out of matmuls summed in other orders; up to
        # 1.9e-6 relative measured on these configs)
        for name in ("k_q", "v_q"):
            np.testing.assert_array_equal(
                _np(tcache["blocks"][name]),
                np.asarray(jcache["blocks"][name]))
        for name in ("k_s", "v_s"):
            np.testing.assert_allclose(
                _np(tcache["blocks"][name]),
                np.asarray(jcache["blocks"][name]), rtol=1e-5, atol=0)
    assert act_quant.launches == 0 and decode_attention_int8kv.launches == 0
    assert kv_append_int8.launches == 0


@pytest.mark.parametrize("kv_quant", [True, False])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_bf16(arch, mode, kv_quant):
    jl, tl, _, tcache = _teacher_forced(arch, mode, kv_quant, "bf16")
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=6e-2 * np.abs(jl).max())
    if kv_quant:
        assert tcache["blocks"]["k_q"].dtype == torch.int8


def test_decode_write_index_past_the_cache_raises():
    """JAX's dynamic_update_index_in_dim would clamp the index to the last
    row; the port refuses it."""
    _, _, cfg, tp = _both("qwen2-0.5b", "serve_w8a8", True, "f32")
    cache = tfm.init_cache(cfg, 2, 4, "cpu")
    tok = torch.zeros((2, 1), dtype=torch.long)
    for bad in (4, 5, -1):
        with pytest.raises(ValueError, match="cur_index"):
            tfm.decode_step(tp, cfg, cache, tok, bad)
    assert not cache["blocks"]["k_q"].any()
    tfm.decode_step(tp, cfg, cache, tok, 3)
    assert cache["blocks"]["k_q"][:, :, :, 3].any()
    assert not cache["blocks"]["k_q"][:, :, :, :3].any()


def test_int4_kv_cache_decodes_without_kernels():
    """The int4 KV cache is served: ``serve.greedy_decode`` over a uint8
    cache of hd // 2 packed bytes per row runs with no
    ``NotImplementedError`` and no kernel launched, and its
    ``cache_bytes`` counts the packed rows and their scales. (Its
    numbers against JAX are ``tests/test_torch_lm_prefill.py``'s.)"""
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-0.5b"),
                              kv_quant=True, kv_bits=4,
                              quant_mode="serve_w8a8", dtype=torch.float32)
    cache = tfm.init_cache(cfg, 2, 4, "cpu")
    assert cache["blocks"]["k_q"].dtype == torch.uint8
    assert cache["blocks"]["k_q"].shape == (cfg.n_layers, 2, 1, 4,
                                            cfg.hd // 2)
    lm = serve.build_lm(cfg, device="cpu")
    before = (act_quant.launches, kv_append_int8.launches,
              decode_attention_int8kv.launches)
    run = serve.greedy_decode(lm, 2, 4, 4, cache=cache)
    assert run.tokens.shape == (2, 4)
    assert cache["blocks"]["k_q"].any() and cache["blocks"]["k_s"].all()
    assert run.cache_bytes == 2 * 2 * 2 * 4 * (8 // 2 + 4)
    assert (act_quant.launches, kv_append_int8.launches,
            decode_attention_int8kv.launches) == before


def test_qk_norm_and_kv_replicate_match_jax():
    """The robust-attention (l2-normalized q/k, tau) and replicated-KV
    variants of the decode, with the int8 cache, in float32."""
    extra = dict(qk_norm=True, kv_replicate=3)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("llama3.2-3b"),
                               quant_mode="serve_w8a8", kv_quant=True,
                               dtype=jnp.float32, **extra)
    cfg = dataclasses.replace(configs.get_smoke_config("llama3.2-3b"),
                              quant_mode="serve_w8a8", kv_quant=True,
                              dtype=torch.float32, **extra)
    params = japply.quantize_params_tree(jax.tree.map(
        _np, tfm.init_lm(dataclasses.replace(cfg, quant_mode="none"), 4,
                         "cpu"), is_leaf=lambda a: isinstance(a, torch.Tensor)),
        jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    jc, tc = jtfm.init_cache(jcfg, 2, 8), tfm.init_cache(cfg, 2, 8, "cpu")
    assert tc["blocks"]["k_q"].shape == jc["blocks"]["k_q"].shape
    step = jax.jit(lambda p, c, t, i: jtfm.decode_step(p, jcfg, c, t, i))
    for i, tok in enumerate((3, 17, 250, 9)):
        t = np.full((2, 1), tok, np.int32)
        jl, jc = step(params, jc, jnp.asarray(t), jnp.asarray(i, jnp.int32))
        tl, _ = tfm.decode_step(tp, cfg, tc, _t(t), i)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0,
                                   atol=1e-5 * float(np.abs(jl).max()))


def _stacked_kv_write(k_new, v_new, k_q, k_s, v_q, v_s, cur_index,
                      replicate=1):
    """The decode's int8 KV write as the port first wrote it: repeat the
    kv heads, quantize the stacked rows, write four slices."""
    if replicate > 1:
        k_new = torch.repeat_interleave(k_new, replicate, dim=1)
        v_new = torch.repeat_interleave(v_new, replicate, dim=1)
    kq, ks, vq, vs = ops.prepare_kv_int8(k_new, v_new)
    k_q[:, :, cur_index] = kq
    v_q[:, :, cur_index] = vq
    k_s[:, :, cur_index] = ks
    v_s[:, :, cur_index] = vs


@pytest.mark.parametrize("arch,extra,dtype", [
    ("qwen2-0.5b", {}, torch.bfloat16),
    ("llama3.2-3b", {"kv_replicate": 3, "qk_norm": True}, torch.float32),
    ("llama3.2-3b", {"kv_replicate": 3}, torch.bfloat16)])
def test_kv_write_leaves_the_cache_as_the_stacked_write(monkeypatch, arch,
                                                        extra, dtype):
    """On CPU tensors ``ops.append_kv_int8`` fills the int8 cache with the
    same bytes, step after step, as the stacked write it replaced (repeat,
    one act-quant of the stacked rows, four slice writes), and the logits
    are the same bits."""
    cfg = dataclasses.replace(
        serve.lm_config(arch, smoke=True, quant="serve_w8a8", kv_quant=True),
        dtype=dtype, **extra)
    lm = serve.build_lm(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(6, 2, 1)))

    def run():
        cache = tfm.init_cache(cfg, 2, 8, "cpu")
        out = [serve.decode(lm, cache, toks[i], i) for i in range(6)]
        return torch.stack(out), cache["blocks"]
    new_logits, new_cache = run()
    monkeypatch.setattr(ops, "append_kv_int8", _stacked_kv_write)
    old_logits, old_cache = run()
    assert torch.equal(new_logits, old_logits)
    for name in ("k_q", "v_q"):
        assert torch.equal(new_cache[name], old_cache[name])
        assert new_cache[name][:, :, :, :6].any()
    for name in ("k_s", "v_s"):
        assert torch.equal(new_cache[name].view(torch.int32),
                           old_cache[name].view(torch.int32))
    assert kv_append_int8.launches == 0


@pytest.mark.parametrize("arch", ["musicgen-large", "chameleon-34b"])
def test_serve_cli_decodes_non_token_frontends(capsys, arch):
    """Audio frames and image patches decode from zero (B, 1, d_model)
    embeddings at every step, as the JAX launcher feeds its frontend
    stub: every step's logits equal a decode of those embeddings."""
    serve.main(["--workload", "lm", "--arch", arch, "--smoke", "--quant",
                "serve_w8a8", "--kv-quant", "--tokens", "3", "--batch", "2",
                "--cache-len", "4", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch.split('-')[0]}-smoke ")
    lm = serve.build_lm(serve.lm_config(arch, smoke=True, quant="serve_w8a8",
                                        kv_quant=True), device="cpu")
    run = serve.greedy_decode(lm, 2, 4, 3)
    cache = tfm.init_cache(lm.cfg, 2, 4, "cpu")
    zeros = torch.zeros((2, 1, lm.cfg.d_model))
    want = torch.stack([serve.decode(lm, cache, zeros, i).argmax(-1)
                        for i in range(3)], dim=1)
    assert torch.equal(run.tokens, want)


def test_serve_cli_runs_on_the_cpu(capsys, monkeypatch, tmp_path):
    serve.main(["--workload", "lm", "--arch", "qwen2-0.5b", "--smoke",
                "--quant", "serve_w8a8", "--kv-quant", "--tokens", "4",
                "--batch", "2", "--cache-len", "8", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen2-smoke quant=serve_w8a8 "
                             "kv_quant=True")
    assert out[1].startswith("weights: fp32 ") and "-> served" in out[1]
    assert out[2].startswith("kv-cache: ") and "B=2 S=8" in out[2]
    assert out[3].startswith("decode: ") and "ms/step" in out[3]
    lm = serve.build_lm(serve.lm_config("qwen2-0.5b", smoke=True,
                                        quant="serve_w8a8", kv_quant=True),
                        device="cpu")
    a = serve.greedy_decode(lm, 2, 8, 5)
    b = serve.greedy_decode(lm, 2, 8, 5)
    assert a.tokens.shape == (2, 5) and torch.equal(a.tokens, b.tokens)
    assert a.cache_bytes == 2 * 2 * 2 * 8 * (8 + 4)   # L, k|v, B, S, hd+4
    # the obs flags run on the LM workload too: --metrics-out writes the
    # exposition (atomically, stamped); and the SO3 workload keeps the
    # device rule: no card and no --device cpu raises
    prom = tmp_path / "m.prom"
    serve.main(["--workload", "lm", "--arch", "qwen2-0.5b", "--smoke",
                "--tokens", "2", "--batch", "1", "--cache-len", "4",
                "--device", "cpu", "--metrics-out", str(prom)])
    assert prom.read_text().startswith("# exported_at ")
    assert not list(tmp_path.glob("*.tmp.*"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        serve.main(["--workload", "so3"])
