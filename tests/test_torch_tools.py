"""The measurement helpers of ``repro_torch.tools.so3_grad_conditioning``
that ``chip_smoke.py`` phase 8 builds its float32 gradient gate from, on
the CPU at a small config: the ulp jitter, the quantization-site
recorder's pins, and the factor a probe needs over a spread."""
import numpy as np
import pytest
import torch

from repro_torch.core.codebook import make_codebook
from repro_torch.core.lee import random_rotations
from repro_torch.data.synthetic_md import sample_dataset
from repro_torch.models import so3krates as so3
from repro_torch.tools import so3_grad_conditioning as cond
from repro_torch.training import so3_trainer as tr

CFG_KW = dict(feat=16, vec_feat=4, n_layers=2, n_rbf=8, dir_bits=8)


def test_ulp_jitter_moves_each_entry_at_most_one_ulp():
    t = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 3)).astype(np.float32))
    j = cond.jittered(t, 0)
    up = torch.nextafter(t, torch.full_like(t, np.inf))
    down = torch.nextafter(t, torch.full_like(t, -np.inf))
    assert ((j == t) | (j == up) | (j == down)).all()
    assert (j == up).any() and (j == down).any() and (j == t).any()
    assert torch.equal(j, cond.jittered(t, 0))
    assert not torch.equal(j, cond.jittered(t, 1))


@pytest.mark.parametrize("quant", ["none", "gaq_w4a8"])
def test_pinned_sites_replay_the_step_and_jitter_moves_it_a_little(quant):
    """Pinned to its own sites, a step is bit for bit the same; with the
    coordinates jittered by an ulp and the sites pinned, every gradient
    leaf moves by rounding alone."""
    cfg = so3.So3kratesConfig(quant=quant, **CFG_KW)
    data = sample_dataset(0, 2, device="cpu")
    params = so3.init_params(cfg, 1, device="cpu")
    cb = (make_codebook(cfg.dir_bits, device="cpu") if quant != "none"
          else None)
    fn = tr.make_loss_fn(cfg, data["species"], cb, tr.TrainConfig(
        lee_weight=1.0, lee_rotations=2))
    batch = [data[k] for k in ("coords", "energy", "forces")]
    rots = random_rotations(1, 2)
    with cond.qat_sites() as sites:
        loss, _, grads = tr.loss_and_grads(fn, params, *batch, rots)
    assert bool(sites) == (quant != "none")
    with cond.qat_sites(pin=sites):
        loss_p, _, grads_p = tr.loss_and_grads(fn, params, *batch, rots)
    assert torch.equal(loss, loss_p)
    assert all(torch.equal(grads[k], grads_p[k]) for k in grads)
    gaps, g_a = cond.step_gaps(fn, params, batch, rots, 2)
    assert all(torch.equal(g_a[k], grads[k]) for k in grads)
    assert 0 < max(max(g.values()) for g in gaps.values()) < 1e-3


def test_factor_needed_counts_only_gaps_past_the_floor():
    spread = {"a": 1e-4, "b": 1e-6}
    assert cond.factor_needed({"a": 3e-4, "b": 9e-5}, spread) == \
        pytest.approx(3.0)
    assert cond.factor_needed({"a": 5e-5, "b": 9e-5}, spread) == 0.0
