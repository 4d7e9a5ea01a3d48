"""Port twin of ``tests/test_arch_smoke.py``: every arch of the registry
(the JAX package's ten, dense, MoE, Mamba2-hybrid and xLSTM) on its
reduced config, on the CPU: a forward and a gradient, a decode step, the
quantized modes, the full configs' parameter counts; and ``init_cache``
against the JAX package's, shape for shape."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.lm import transformer as jtfm
from repro_torch import configs, tree
from repro_torch.launch import steps
from repro_torch.models.lm import transformer as tfm
from repro_torch.quant import apply

ARCHS = list(configs.ARCH_IDS)
B, S = 2, 64


def _cfg(arch, **extra):
    cfg = configs.get_smoke_config(arch)
    return dataclasses.replace(cfg, dtype=torch.float32, attn_chunk_q=32,
                               ssm_chunk=min(cfg.ssm_chunk, 32), **extra)


def _batch(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, cfg.vocab, (B, S), generator=g)
    if cfg.frontend == "token":
        return {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g),
                "labels": labels}
    # modality stub: precomputed frame/patch embeddings
    return {"embeds": torch.randn((B, S, cfg.d_model), generator=g),
            "labels": labels}


def _step_input(cfg):
    if cfg.frontend == "token":
        return torch.zeros((B, 1), dtype=torch.long)
    return torch.zeros((B, 1, cfg.d_model))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_grad(arch):
    cfg = _cfg(arch)
    params = tfm.init_lm(cfg, 0, "cpu")
    batch = _batch(cfg)
    logits, aux = tfm.forward(params, cfg, tokens=batch.get("tokens"),
                              embeds=batch.get("embeds"))
    assert logits.shape == (B, S, cfg.vocab)
    assert bool(torch.isfinite(logits).all()), f"{arch}: NaN logits"
    assert aux.shape == () and (float(aux) > 0) == cfg.moe
    loss, grads = steps.lm_value_and_grad(params, cfg, batch)
    assert np.isfinite(float(loss)), f"{arch}: NaN loss"
    gnorm = float(torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                                 for g in tree.leaves(grads))))
    assert np.isfinite(gnorm) and gnorm > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step(arch):
    cfg = _cfg(arch)
    params = tfm.init_lm(cfg, 0, "cpu")
    cache = tfm.init_cache(cfg, B, 32, "cpu")
    before = [(k, tuple(v.shape), v.dtype, v.data_ptr())
              for k, v in tree.items(cache)]
    logits, cache2 = tfm.decode_step(params, cfg, cache, _step_input(cfg), 3)
    assert logits.shape == (B, cfg.vocab)
    assert bool(torch.isfinite(logits).all()), f"{arch}: NaN decode"
    # cache structure preserved, updated in place
    assert cache2 is cache
    assert [(k, tuple(v.shape), v.dtype, v.data_ptr())
            for k, v in tree.items(cache2)] == before


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_modes(arch):
    """QAT, the int8 KV cache and serve W8A8 run and stay finite; the
    xLSTM family's serve mode raises in both packages (its ``b/wif``)."""
    cfg = _cfg(arch)
    params = tfm.init_lm(cfg, 0, "cpu")
    loss = tfm.lm_loss(params, dataclasses.replace(cfg, quant_mode="qat_w4a8"),
                       _batch(cfg))
    assert np.isfinite(float(loss))
    kv_cfg = dataclasses.replace(cfg, kv_quant=True)
    logits, _ = tfm.decode_step(params, kv_cfg,
                                tfm.init_cache(kv_cfg, B, 16, "cpu"),
                                _step_input(cfg), 0)
    assert bool(torch.isfinite(logits).all())
    sv = dataclasses.replace(kv_cfg, quant_mode="serve_w8a8")
    served = apply.quantize_params_tree(params, sv)

    def serve_step():
        return tfm.decode_step(served, sv, tfm.init_cache(sv, B, 16, "cpu"),
                               _step_input(cfg), 0)[0]
    if cfg.block_pattern == "xlstm":
        with pytest.raises(ValueError, match="b/wif"):
            serve_step()
    else:
        assert bool(torch.isfinite(serve_step()).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    """The decode state's tree, shapes and dtypes equal the JAX
    ``init_cache``'s, float and int8 KV, in float32 and bf16."""
    for kv, dt in ((False, "float32"), (True, "bfloat16")):
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                   kv_quant=kv, dtype=getattr(jnp, dt))
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  kv_quant=kv, dtype=getattr(torch, dt))
        want = jax.eval_shape(lambda: jtfm.init_cache(jcfg, 3, 8))
        got = tfm.init_cache(cfg, 3, 8, "cpu")
        assert jax.tree.map(
            lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")),
            got, is_leaf=lambda a: isinstance(a, torch.Tensor)) == \
            jax.tree.map(lambda a: (a.shape, str(a.dtype)), want)


def test_full_configs_param_counts():
    """Sanity: analytic param counts are in the advertised ballpark."""
    expect = {
        "zamba2-1.2b": (0.8e9, 1.8e9),
        "qwen1.5-110b": (90e9, 130e9),
        "llama3.2-3b": (2.5e9, 4.5e9),
        "qwen2-0.5b": (0.3e9, 0.7e9),
        "nemotron-4-15b": (12e9, 18e9),
        "musicgen-large": (2.5e9, 3.8e9),
        "qwen3-moe-30b-a3b": (25e9, 35e9),
        "moonshot-v1-16b-a3b": (24e9, 30e9),  # 48L assigned (published has 27L)
        "chameleon-34b": (30e9, 40e9),
        "xlstm-1.3b": (0.8e9, 1.6e9),
    }
    assert set(expect) == set(ARCHS)
    for arch, (lo, hi) in expect.items():
        n = configs.get_config(arch).param_count()
        assert lo <= n <= hi, f"{arch}: {n/1e9:.2f}B not in [{lo/1e9},{hi/1e9}]"
