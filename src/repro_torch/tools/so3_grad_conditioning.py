"""How far float32 rounding moves the SO3 training step's gradients, on
the CPU, and how far a second float32 evaluation of the same step lands
from the first.

    PYTHONPATH=src python -m repro_torch.tools.so3_grad_conditioning 0 1 2 3 4 5

For each seed given, samples the azobenzene MD set as the training
pipeline's --fast run does (``sample_dataset_md(seed, 128)``, 96 training
frames), trains fp32 for 15 epochs and then gaq_w4a8 QAT for 6 (2 of
them warm-up, LEE over 2 rotations) on the CPU, and at the QAT weights
takes one loss and gradient step of each kind that ``chip_smoke.py``
phase 8 holds the card to (fp32; gaq_w4a8 with LEE over the rotations
of seed 1) on the first batch of 32: in float32 (A), and again with
every coordinate moved one ulp up, down or not at all at random
(``jittered``, seeds 0 to 2 N_JITTERS - 1), so that every rounding
downstream falls elsewhere; the QAT step's quantization sites pinned to
A's (``qat_sites``). A run's gap on a leaf is its largest
distance from A over the leaf's largest |g|.

Phase 8 holds each float32 leaf of the card's step against the CPU's A
within ``max(FLOOR, F32_GRAD_FACTOR * spread)``, the spread being the
largest gap of the first ``N_JITTERS`` jittered runs on that leaf. To
size the factor, this prints the F that each further jittered run (a
probe, standing in for the card) needs over that spread: its largest
gap / spread over the leaves whose gap passes ``FLOOR``; and the three
leaves with the largest spread. For the fp32 step it also prints A's
three largest gaps to float64. Some first-layer gradients (``layer0/wq``,
``wk``, ``rbf_a``) are ill-conditioned in float32, so a fixed bound on
two float32 steps fails with nothing wrong. About 40 s per seed.
"""
from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from repro_torch.core import quantizers as q
from repro_torch.core.codebook import make_codebook
from repro_torch.core.lee import random_rotations
from repro_torch.core.mddq import fake_quant_from_codes, mddq_encode
from repro_torch.core.ste import round_ste
from repro_torch.data.synthetic_md import sample_dataset_md
from repro_torch.models import so3krates as so3
from repro_torch.training import pipeline
from repro_torch.training import so3_trainer as tr

FLOOR = 1e-4
N_JITTERS = 3


def leaf_gaps(grads, ref):
    """{leaf: |g - ref|max / |ref|max}."""
    return {k: float((grads[k].double() - ref[k].double()).abs().max()
                     / max(float(ref[k].abs().max()), 1e-30)) for k in ref}


def factor_needed(probe, spread):
    """The smallest F with probe <= max(FLOOR, F spread) on every leaf: 0
    when no probe gap passes ``FLOOR``."""
    return max([probe[k] / max(spread[k], 1e-30) for k in spread
                if probe[k] > FLOOR], default=0.0)


def ulp_jitter(t, rng):
    """``t`` with each entry moved one ulp up, down or not at all."""
    s = torch.from_numpy(rng.integers(-1, 2, tuple(t.shape))).to(t.device)
    up = torch.nextafter(t, torch.full_like(t, np.inf))
    down = torch.nextafter(t, torch.full_like(t, -np.inf))
    return torch.where(s > 0, up, torch.where(s < 0, down, t))


def jittered(coords, seed):
    """``coords`` with every entry jittered by ``ulp_jitter`` from numpy
    seed ``seed``. The weights stay: their fake quant's abs-max entry
    lands on qmax or an ulp off by the division's rounding (clip gate 0.5,
    1 or 0), a jump that another device's arithmetic on the same weights
    does not make."""
    return ulp_jitter(coords, np.random.default_rng(seed))


@contextlib.contextmanager
def qat_sites(pin=None):
    """Inside the block, every quantization site of the QAT model
    (``models/so3krates.py``) in call order, as CPU tensors: ("a8", x /
    scale) for A8 activations and the baselines' INT8 vectors, ("code",
    codes) for MDDQ's direction and magnitude codes. With ``pin`` (sites
    of another run of the same step, in the same order) each site takes
    the pinned x / scale or codes instead of its own, gradients as
    before: what is left of a gap between the runs is then arithmetic."""
    rec, pins = [], iter(pin or ())
    qact, qvec = so3._qact, so3._qvec

    def a8(x, scale, bits, nested):
        y = x / scale
        rec.append(("a8", y.detach().cpu()))
        if pin is None:
            return None
        y = y + (next(pins)[1].to(y.device) - y).detach()
        m = q.qmax(bits)
        return round_ste(q.clip(y, -m, m), nested) * scale

    def rec_act(x, cfg, degrees=None, nested=False):
        if cfg.quant != "none":
            out = a8(x, so3._act_scale(x, cfg, degrees), cfg.a_bits, nested)
            if out is not None:
                return out
        return qact(x, cfg, degrees, nested)

    def rec_vec(v, cfg, codebook, nested=False):
        if cfg.quant == "gaq_w4a8" and not cfg.freeze_vec_quant:
            mc = cfg.mddq()
            with torch.no_grad():
                rec.extend(("code", c.cpu()) for c in mddq_encode(
                    v.detach().float(), mc, codebook))
            if pin is not None:
                idx, mag = (next(pins)[1].to(v.device).long()
                            for _ in range(2))
                m_q = q.dequantize_log_magnitude(mag, mc.magnitude_bits,
                                                 mc.m_min, mc.m_max)
                return fake_quant_from_codes(v, mc, codebook[idx],
                                             m_q[..., None], nested)
        elif cfg.quant in ("naive_int8", "degree_quant"):
            out = a8(v, so3._mol_scale(v.detach(), 8, 3), 8, nested)
            if out is not None:
                return out
        return qvec(v, cfg, codebook, nested)
    so3._qact, so3._qvec = rec_act, rec_vec
    try:
        yield rec
    finally:
        so3._qact, so3._qvec = qact, qvec


def step_gaps(fn, params, batch, rots, n_runs):
    """({run: {leaf: gap to A}}, A's gradients) for the jittered runs
    "J0" ... of one step, the quantization sites pinned to A's."""
    with qat_sites() as sites:
        _, _, g_a = tr.loss_and_grads(fn, params, *batch, rots)
    gaps = {}
    for j in range(n_runs):
        with qat_sites(pin=sites):
            _, _, g = tr.loss_and_grads(fn, params, jittered(batch[0], j),
                                        *batch[1:], rots)
        gaps[f"J{j}"] = leaf_gaps(g, g_a)
    return gaps, g_a


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args(argv)
    cfg32 = so3.So3kratesConfig(**pipeline.BASE, **pipeline.METHODS["fp32"])
    cfgq = so3.So3kratesConfig(**pipeline.BASE,
                               **pipeline.METHODS["gaq_w4a8"])
    qcfg = tr.TrainConfig(epochs=6, warmup_epochs=2, batch_size=32, lr=1e-3,
                          lee_weight=1.0, lee_rotations=2)
    codebook = make_codebook(cfgq.dir_bits, device="cpu")
    rots = random_rotations(1, qcfg.lee_rotations)
    for seed in args.seeds:
        data, _ = pipeline._split_data(
            sample_dataset_md(seed, 128, device="cpu"), 96)
        p32, _ = tr.train(cfg32, data, tr.TrainConfig(
            epochs=15, warmup_epochs=0, batch_size=32, lr=5e-3),
            device="cpu")
        pq, _ = tr.train(cfgq, data, qcfg, init=p32, device="cpu")
        batch = [data[k][:32] for k in ("coords", "energy", "forces")]
        for name, cfg, cb in (("fp32", cfg32, None),
                              ("gaq_w4a8", cfgq, codebook)):
            fn = tr.make_loss_fn(cfg, data["species"], cb, qcfg)
            gaps, g_a = step_gaps(fn, pq, batch, rots, 2 * N_JITTERS)
            spread = {k: max(gaps[f"J{j}"][k] for j in range(N_JITTERS))
                      for k in g_a}
            probes = [f"J{j}" for j in range(N_JITTERS, 2 * N_JITTERS)]
            worst = sorted(spread.items(), key=lambda kv: -kv[1])[:3]
            line = (f"seed {seed}, {name} step: spread " + ", ".join(
                f"{k} {v:.3g}" for k, v in worst) + "; F needed "
                + ", ".join(f"{r} {factor_needed(gaps[r], spread):.3g}"
                            for r in probes))
            if cfg.quant == "none":
                _, _, g64 = tr.loss_and_grads(
                    fn, {k: v.double() for k, v in pq.items()},
                    *[t.double() for t in batch], None)
                e64 = leaf_gaps(g_a, g64)
                line += "; A against float64 " + ", ".join(
                    f"{k} {v:.3g}" for k, v in sorted(
                        e64.items(), key=lambda kv: -kv[1])[:3])
            print(line, flush=True)


if __name__ == "__main__":
    main()
