"""The decode position on the device, and captured programs, on the CPU.

``decode_step`` takes its position as a Python int or, as the reference's
traced ``cur_index``, as a 0-d int32 tensor (what a captured step reads
from a device buffer). Here, on the CPU:

- per family (dense with an int8, an int4 and a float cache, MoE,
  zamba2, xLSTM), at the smoke config for 3 steps, a tensor position
  gives the int position's logits and cache bit for bit;
- qwen2-0.5b's smoke config (serve_w8a8, int8 KV) at a tensor position
  against the JAX package's jitted ``decode_step`` with a traced
  ``cur_index``, to 1e-5 of the largest |logit| (the tolerance of
  ``test_torch_lm.py::test_decode_matches_jax_f32``: the packages sum
  their matmuls in other orders);
- the plain versions of K5' and K6 give the same result with a tensor
  position as with an int, bit for bit;
- ``CapturedProgram`` raises on a CPU device, and on the CPU the engine's
  warmup, an MD run and a greedy decode capture nothing;
- a replay's launches reach the counts and the calling thread's role as
  the launches they stand for.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.lm import transformer as jtfm
from repro.quant import apply as japply
from repro_torch import configs
from repro_torch.captured import CapturedProgram
from repro_torch.kernels import _launch, ops, ref
from repro_torch.launch import serve
from repro_torch.md import MDConfig, MDEngine, pad_replicas
from repro_torch.models.lm import transformer as tfm
from repro_torch.models.so3krates import So3kratesConfig
from repro_torch.serving import QuantizedEngine, ServeConfig, random_graphs
from repro_torch.weights import lm_params_from_numpy

# (arch, quant mode, kv_quant, kv_bits): one case per cache and family
FAMILIES = [("qwen2-0.5b", "serve_w8a8", True, 8),
            ("qwen2-0.5b", "serve_w8a8", True, 4),
            ("qwen2-0.5b", "serve_w8a8", False, 8),
            ("qwen3-moe-30b-a3b", "serve_w8a8", True, 8),
            ("zamba2-1.2b", "serve_w8a8", True, 8),
            ("xlstm-1.3b", "none", False, 8)]


def _pos(i):
    return torch.tensor(i, dtype=torch.int32)


@pytest.mark.parametrize("arch,mode,kv_quant,kv_bits", FAMILIES)
def test_tensor_position_equals_int_position(arch, mode, kv_quant, kv_bits):
    cfg = dataclasses.replace(
        serve.lm_config(arch, smoke=True, quant=mode, kv_quant=kv_quant),
        kv_bits=kv_bits)
    lm = serve.build_lm(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, 3)))
    runs = []
    for position in (int, _pos):
        cache = tfm.init_cache(cfg, 2, 8, "cpu")
        logits = [tfm.decode_step(lm.params, cfg, cache, toks[:, i:i + 1],
                                  position(i), head=lm.head)[0]
                  for i in range(3)]
        runs.append((torch.stack(logits), cache))
    (a, cache_a), (b, cache_b) = runs
    assert torch.isfinite(a).all()
    assert torch.equal(a, b)
    for x, y in zip(jax.tree.leaves(cache_a), jax.tree.leaves(cache_b)):
        assert torch.equal(x, y)


def test_tensor_position_matches_jax_traced_cur_index():
    arch, mode = "qwen2-0.5b", "serve_w8a8"
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               quant_mode=mode, kv_quant=True,
                               dtype=jnp.float32)
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              quant_mode=mode, kv_quant=True,
                              dtype=torch.float32)
    plain = jax.tree.map(
        lambda t: np.asarray(t), tfm.init_lm(configs.get_smoke_config(arch),
                                             0, "cpu"),
        is_leaf=lambda a: isinstance(a, torch.Tensor))
    jp = jax.tree.map(np.asarray, japply.quantize_params_tree(plain, jcfg))
    tp = lm_params_from_numpy(jp, "cpu")
    B, S, n = 3, 16, 6
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
        logits, _ = tfm.decode_step(tp, cfg, tcache,
                                    torch.from_numpy(toks[i]), _pos(i), head)
        tl.append(logits.numpy())
    jl, tl = np.stack(jl), np.stack(tl)
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5 * np.abs(jl).max())
    for name in ("k_q", "v_q"):
        np.testing.assert_array_equal(tcache["blocks"][name].numpy(),
                                      np.asarray(jcache["blocks"][name]))


@pytest.mark.parametrize("cur,replicate", [(0, 1), (5, 1), (11, 3)])
def test_plain_kv_write_tensor_position(cur, replicate):
    rng = np.random.default_rng(cur)
    B, nkv, hd, S = 2, 2, 8, 12
    new = [torch.from_numpy(rng.normal(size=(B, nkv, hd))
                            .astype(np.float32)) for _ in range(2)]
    caches = []
    for pos in (cur, _pos(cur)):
        c = [torch.full((B, nkv * replicate, S, hd), -128, dtype=torch.int8),
             torch.zeros((B, nkv * replicate, S)),
             torch.full((B, nkv * replicate, S, hd), -128, dtype=torch.int8),
             torch.zeros((B, nkv * replicate, S))]
        ops.append_kv_int8(*new, c[0], c[1], c[2], c[3], pos, replicate)
        caches.append(c)
    for a, b in zip(*caches):
        assert torch.equal(a, b)
    assert (caches[0][0][:, :, cur] != -128).all()


@pytest.mark.parametrize("n_valid", [1, 17, 64])
def test_plain_decode_attention_tensor_position(n_valid):
    rng = np.random.default_rng(n_valid)
    bh, g, s, d = 4, 7, 64, 8
    q = torch.from_numpy(rng.normal(size=(bh, g, d)).astype(np.float32))
    kv = ops.prepare_kv_int8(
        *(torch.from_numpy(rng.normal(size=(bh, s, d)).astype(np.float32))
          for _ in range(2)))
    want = ops.decode_attention_int8kv(q, *kv, n_valid, d ** -0.5)
    # the decode's form: the position, attending to [0, p]
    got = ops.decode_attention_int8kv(q, *kv, _pos(n_valid - 1), d ** -0.5)
    assert torch.equal(got, want)
    sliced = ref.decode_attention_int8kv_ref(
        q, kv[0][:, :n_valid], kv[1][:, :n_valid], kv[2][:, :n_valid],
        kv[3][:, :n_valid], n_valid, d ** -0.5)
    torch.testing.assert_close(got, sliced, rtol=1e-6, atol=1e-6)


def test_captured_program_raises_on_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        CapturedProgram(lambda x: x + 1, {"x": torch.zeros(3)},
                        device="cpu", name="a CPU program")


def test_the_cpu_captures_nothing():
    cfg = So3kratesConfig(feat=16, vec_feat=4, n_layers=1, n_rbf=4,
                          dir_bits=4, cutoff=3.0)
    eng = QuantizedEngine.from_config(
        cfg, serve=ServeConfig(mode="w8a8", bucket_sizes=(8,), max_batch=2,
                               path="sparse"), device="cpu")
    eng.warmup()
    eng.infer_batch(random_graphs(3, 3, 8, cfg.n_species, seed=0))
    assert eng.shapes_seen and not eng.compiled_shapes
    assert not eng._programs
    md = MDEngine(cfg, md=MDConfig(mode="w8a8", record_every=2),
                  device="cpu")
    g = random_graphs(1, 6, 6, cfg.n_species, seed=1)[0]
    sp, co, mask = pad_replicas(g.species, g.coords, 2)
    masses = np.full(6, 12.0, np.float32)
    st = md.init_state(0, sp, co, mask, masses)
    md.run(st, sp, mask, masses, 3)
    assert not md._programs
    lm = serve.build_lm(serve.lm_config("qwen2-0.5b", smoke=True,
                                        quant="serve_w8a8", kv_quant=True),
                        device="cpu")
    run = serve.greedy_decode(lm, 2, 8, 4)
    assert run.tokens.shape == (2, 4) and not lm.programs
    assert torch.equal(run.tokens,
                       serve.greedy_decode_eager(lm, 2, 8, 4).tokens)


def test_replayed_launches_reach_counts_and_roles():
    def kernel():
        """A stand-in counter."""
    kernel.launches = 0
    _launch.reset_role_launches()
    with _launch.launch_role("flush:w4a8"):
        _launch.add_launches({(kernel, "launches"): 13})
        _launch.count_launch(kernel)
    assert kernel.launches == 14
    assert _launch.role_launches() == {"flush:w4a8": {"kernel": 14}}
    with _launch.capturing_launches(1234) as tally:
        with pytest.raises(RuntimeError, match="already open"):
            with _launch.capturing_launches(1234):
                pass
        with _launch.capturing_launches(5678) as other:
            pass
    assert tally == {} and other == {} and not _launch._CAPTURES
    _launch.reset_role_launches()


def test_greedy_decode_leaves_no_cycle_holding_the_model():
    """A served model is freed when its last reference goes, with the
    cyclic collector off (captures turn it off): the decode loop keeps
    no reference cycle through the model."""
    import gc
    import weakref
    lm = serve.build_lm(serve.lm_config("qwen2-0.5b", smoke=True,
                                        quant="serve_w8a8", kv_quant=True),
                        device="cpu")
    embed = weakref.ref(lm.params["embed"])
    enabled = gc.isenabled()
    gc.disable()
    try:
        serve.greedy_decode(lm, 2, 8, 4)
        serve.greedy_decode_eager(lm, 2, 8, 3)
        del lm
        assert embed() is None
    finally:
        if enabled:
            gc.enable()


def test_a_program_owns_the_ticket_buffer_made_on_its_stream(monkeypatch):
    """K6's tickets made while a program's store is open on a stream go
    to that store, which a later, larger per-stream buffer leaves alone
    (a graph holds the program's pointer); a second store on the same
    stream is refused."""
    from repro_torch.kernels import attention_int8kv
    monkeypatch.setattr(attention_int8kv, "_tickets", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    cpu, store = torch.device("cpu"), {}
    assert _launch.owned_buffers(7) is None
    with _launch.owning_buffers(7, store):
        assert _launch.owned_buffers(7) is store
        assert _launch.owned_buffers(8) is None
        with pytest.raises(RuntimeError, match="already open"):
            with _launch.owning_buffers(7, {}):
                pass
        own = attention_int8kv._ticket_buffer(cpu, 7, 16)
    assert _launch.owned_buffers(7) is None
    eager = attention_int8kv._ticket_buffer(cpu, 7, 16)
    bigger = attention_int8kv._ticket_buffer(cpu, 7, 512)
    assert store == {("tickets", None): own} and own.numel() == 256
    assert eager is not own and bigger.numel() == 512
    assert attention_int8kv._tickets == {(None, 7): bigger}
