"""The port's analytic cost model (``launch/costs.py``) against the JAX
package's (``repro/launch/costs.py``): for every arch and every ``SHAPES``
cell, in quant none / ``serve_w8a8`` / ``serve_w4a8`` and with the KV
cache float, int8 and int4, ``cell_flops``, ``model_flops`` and every key
of ``cell_hbm_bytes`` to 1e-12 relative (the same arithmetic in the same
order); then the assertions of ``tests/test_analysis.py::TestCostModel``
on the port."""
import dataclasses
import itertools

import pytest

from repro import configs as jconfigs
from repro.launch import costs as jcosts
from repro.models.lm.config import SHAPES as JSHAPES
from repro_torch import configs
from repro_torch.launch import costs
from repro_torch.models.lm.config import SHAPES

QUANTS = ("none", "serve_w8a8", "serve_w4a8")
KV = ({"kv_quant": False}, {"kv_quant": True, "kv_bits": 8},
      {"kv_quant": True, "kv_bits": 4})
REL = 1e-12


@pytest.mark.parametrize("cell", range(len(SHAPES)))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_costs_match_jax(arch, cell):
    for quant, kv in itertools.product(QUANTS, KV):
        jcfg = jconfigs.get_config(arch, quant_mode=quant, **kv)
        cfg = configs.get_config(arch, quant_mode=quant, **kv)
        jc, c = JSHAPES[cell], SHAPES[cell]
        assert costs.cell_flops(cfg, c) == pytest.approx(
            jcosts.cell_flops(jcfg, jc), rel=REL)
        assert costs.model_flops(cfg, c) == pytest.approx(
            jcosts.model_flops(jcfg, jc), rel=REL)
        want = jcosts.cell_hbm_bytes(jcfg, jc)
        got = costs.cell_hbm_bytes(cfg, c)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=REL), (quant, kv, k)


# --- tests/test_analysis.py::TestCostModel on the port ----------------------

@pytest.mark.parametrize("arch", list(configs.ARCH_IDS))
def test_flops_positive_and_ordered(arch):
    cfg = configs.get_config(arch)
    cells = {s.shape_name: s for s in SHAPES}
    f_train = costs.cell_flops(cfg, cells["train_4k"])
    f_prefill = costs.cell_flops(cfg, cells["prefill_32k"])
    f_decode = costs.cell_flops(cfg, cells["decode_32k"])
    assert f_train > 0 and f_prefill > 0 and f_decode > 0
    # training does 3x forward work per token; decode is one token
    assert f_train > f_decode * 1000


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-0.5b"])
def test_useful_ratio_sane(arch):
    cfg = configs.get_config(arch)
    for cell in SHAPES[:3]:
        impl = costs.cell_flops(cfg, cell)
        model = costs.model_flops(cfg, cell)
        assert impl >= model * 0.5, f"{arch}/{cell.shape_name}"
        assert impl <= model * 6, f"{arch}/{cell.shape_name}"


def test_quant_reduces_weight_bytes():
    cfg = configs.get_config("qwen1.5-110b")
    cell = SHAPES[2]  # decode
    base = costs.cell_hbm_bytes(cfg, cell)
    w8 = costs.cell_hbm_bytes(
        dataclasses.replace(cfg, quant_mode="serve_w8a8"), cell)
    w4 = costs.cell_hbm_bytes(
        dataclasses.replace(cfg, quant_mode="serve_w4a8"), cell)
    assert abs(base["weights"] / w8["weights"] - 4.0) < 0.01
    assert abs(base["weights"] / w4["weights"] - 8.0) < 0.01


def test_kv_quant_reduces_cache_bytes():
    cfg = configs.get_config("qwen1.5-110b")
    cell = SHAPES[2]
    base = costs.cell_hbm_bytes(cfg, cell)["cache"]
    kv8 = costs.cell_hbm_bytes(
        dataclasses.replace(cfg, kv_quant=True), cell)["cache"]
    kv4 = costs.cell_hbm_bytes(
        dataclasses.replace(cfg, kv_quant=True, kv_bits=4), cell)["cache"]
    assert 1.8 < base / kv8 < 2.1   # bf16 -> int8+scales
    assert 1.7 < kv8 / kv4 < 2.1


def test_moe_active_flops_much_less_than_dense_equiv():
    cfg = configs.get_config("qwen3-moe-30b-a3b")
    cell = SHAPES[0]
    impl = costs.cell_flops(cfg, cell)
    assert costs.model_flops(cfg, cell) / impl > 0.3
