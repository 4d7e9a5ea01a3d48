"""How far float32 rounding moves one step of the LM's training launcher
on the CPU: the spread that ``chip_smoke.py`` phase 11 holds the card's
step against, and the factor over it that a further run needs.

    PYTHONPATH=src python -m repro_torch.tools.lm_train_gap 0 1 2

For each seed given, takes qwen2-0.5b at its published width (vocab
151,936, tied embeddings), ``GAP_LAYERS`` layers deep, float32, weights
from ``init_lm(seed)``, and the first batch of B=2, S=64 of
``synthetic_token_batches(seed=17 + seed)``, and runs one launcher step
(:func:`launcher_step`: ``lm_value_and_grad``, ``ef_compress`` under
ef8, the launcher's first ``AdamW`` update) in each mode phase 11 holds
the card to (``none``; ``qat_w4a8`` with ef8): in float32 (A), and again
with the embedding table moved one ulp up, down or not at all at random
(``jitter_embed``, seeds 0 to 2 N_JITTERS - 1): the float input of the
first layer (the tokens are integers) and, tied, the head, so every
rounding downstream falls elsewhere; the QAT step's quantization sites
(the A8 and W4 x / scale, the error-feedback codes) pinned to A's
(:func:`qat_sites`). A run's gap on a leaf is its largest distance from
A over the leaf's largest |value|, for the gradients and for the
parameters after the update.

Phase 11 holds each leaf of the card's step within ``max(FLOOR,
F32_GRAD_FACTOR * spread)``, the spread being the largest gap of the
first ``N_JITTERS`` jittered runs: the method and the factor of phase 8
(``so3_grad_conditioning``). This prints, per mode, the three leaves of
largest spread and the F that each further jittered run needs over it,
to check that factor on the LM. About two minutes a seed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch import configs, tree
from repro_torch.core import quantizers as q
from repro_torch.core.ste import round_ste
from repro_torch.data.tokens import synthetic_token_batches
from repro_torch.launch import steps
from repro_torch.models.lm import layers
from repro_torch.models.lm.transformer import init_lm
from repro_torch.optim import compression
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.optim.compression import ef_compress, ef_init
from repro_torch.tools.so3_grad_conditioning import (FLOOR, N_JITTERS,
                                                     factor_needed,
                                                     ulp_jitter)

__all__ = ["GAP_LAYERS", "GAP_BATCH", "GAP_SEQ", "gap_config",
           "launcher_optimizer", "qat_sites", "moved_sites",
           "launcher_step", "jitter_embed", "tree_gaps", "spread"]

GAP_LAYERS, GAP_BATCH, GAP_SEQ = 2, 2, 64


def gap_config(mode: str = "none"):
    """qwen2-0.5b's published config, GAP_LAYERS deep, float32."""
    return dataclasses.replace(configs.get_config("qwen2-0.5b"),
                               n_layers=GAP_LAYERS, dtype=torch.float32,
                               attn_chunk_q=GAP_SEQ, quant_mode=mode)


def launcher_optimizer(steps_: int = 100, lr: float = 3e-4) -> AdamW:
    """The training launcher's optimizer for ``--steps``/``--lr``."""
    return AdamW(lr=cosine_schedule(lr, steps_ // 10, steps_),
                 weight_decay=0.1, grad_clip=1.0)


def _kind(bits, channel_axis):
    return f"{'w' if channel_axis is not None else 'a'}{q.qmax(bits)}"


@contextlib.contextmanager
def qat_sites(pin=None):
    """Inside the block, every quantization site of the training step
    records (kind, value) in call order as CPU tensors: each
    ``fake_quant_ste`` of ``qlinear``'s QAT branch its x / scale, "w7"
    for a W4 weight (per output channel), "a127" for an A8 activation
    (per tensor); each leaf of ``ef_compress`` its int8 codes ("ef8").
    With ``pin`` (sites of another run of the same step, in the same
    order: numpy arrays or tensors) each site takes the pinned x / scale
    or codes instead of its own, gradients as before: what is left of a
    gap between the runs is then arithmetic. (An error-feedback code that
    moves at a rounding tie moves that entry's first AdamW update by the
    whole learning rate.)"""
    rec, pins = [], iter(pin or ())
    plain, plain_q = layers.fake_quant_ste, compression.quantize

    def fq(x, bits=8, channel_axis=None, scale=None, nested=False):
        if scale is None:
            scale = q.abs_max_scale(x.detach(), bits, channel_axis)
        y = x / scale
        rec.append((_kind(bits, channel_axis), y.detach().cpu()))
        if pin is not None:
            pinned = torch.as_tensor(next(pins)[1]).to(y.device)
            y = y + (pinned - y).detach()
        m = q.qmax(bits)
        return round_ste(q.clip(y, -m, m), nested) * scale

    def ef_codes(x, scale, bits):
        codes = plain_q(x, scale, bits)
        rec.append((f"ef{bits}", codes.cpu()))
        if pin is None:
            return codes
        return torch.as_tensor(next(pins)[1]).to(codes.device)

    layers.fake_quant_ste, compression.quantize = fq, ef_codes
    try:
        yield rec
    finally:
        layers.fake_quant_ste, compression.quantize = plain, plain_q


def moved_sites(a_sites, b_sites):
    """Per site, the entries whose code (the rounded clipped value) or
    clip gate (1 inside, 0.5 exactly on +-qmax, 0 beyond: the
    straight-through gradient) differ between two runs of one step; for
    an error-feedback site, its codes."""
    assert [k for k, _ in a_sites] == [k for k, _ in b_sites]
    moved = []
    for (kind, a), (_, b) in zip(a_sites, b_sites):
        if kind.startswith("ef"):
            moved.append(int((torch.as_tensor(np.asarray(a))
                              != torch.as_tensor(np.asarray(b))).sum()))
            continue
        m = int(kind[1:])

        def sig(y):
            y = torch.as_tensor(np.asarray(y))
            g = y.abs()
            return (y.clamp(-m, m).round(),
                    (g < m).float() + 0.5 * (g == m).float())
        (ca, ga), (cb, gb) = sig(a), sig(b)
        moved.append(int(((ca != cb) | (ga != gb)).sum()))
    return moved


def launcher_step(cfg, opt: AdamW, params, batch, use_ef: bool):
    """The training launcher's first step (``launch.train.make_step`` from
    fresh optimizer and error-feedback states), its parts kept: (loss,
    gradients, the gradients the update took (dequantized under ef8),
    the new parameters)."""
    loss, grads = steps.lm_value_and_grad(params, cfg, batch)
    taken = ef_compress(grads, ef_init(params))[0] if use_ef else grads
    new, _ = opt.update(taken, opt.init(params), params)
    return loss, grads, taken, new


def jitter_embed(params, seed: int):
    """``params`` with every entry of the embedding table moved one ulp
    up, down or not at all (numpy seed ``seed``); the other leaves
    shared."""
    return dict(params, embed=ulp_jitter(params["embed"],
                                         np.random.default_rng(seed)))


def tree_gaps(a, b):
    """{leaf: |a - b|max / |b|max} over two trees of one structure."""
    bs = dict(tree.items(b))
    return {k: float((v.double().cpu() - bs[k].double().cpu()).abs().max()
                     / max(float(bs[k].abs().max()), 1e-30))
            for k, v in tree.items(a)}


def spread(cfg, opt, params, batch, use_ef, ref, sites, runs):
    """({leaf: largest gradient gap}, {leaf: largest parameter gap}) of
    the jittered runs ``runs`` (seeds) of the step whose result ``ref``
    (:func:`launcher_step`'s) and quantization ``sites`` are given, the
    sites pinned; also each run's gaps, for probes."""
    per_run = []
    for j in runs:
        with qat_sites(pin=sites):
            _, g, _, p = launcher_step(cfg, opt, jitter_embed(params, j),
                                       batch, use_ef)
        per_run.append((tree_gaps(g, ref[1]), tree_gaps(p, ref[3])))
    grad = {k: max(r[0][k] for r in per_run) for k in per_run[0][0]}
    par = {k: max(r[1][k] for r in per_run) for k in per_run[0][1]}
    return grad, par, per_run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args(argv)
    opt = launcher_optimizer()
    for seed in args.seeds:
        for mode, use_ef in (("none", False), ("qat_w4a8", True)):
            cfg = gap_config(mode)
            params = init_lm(cfg, seed=seed, device="cpu")
            it = synthetic_token_batches(cfg, GAP_BATCH, GAP_SEQ,
                                         seed=17 + seed)
            batch = {k: torch.from_numpy(v) for k, v in next(it).items()}
            it.close()
            with qat_sites() as sites:
                ref = launcher_step(cfg, opt, params, batch, use_ef)
            g_sp, p_sp, _ = spread(cfg, opt, params, batch, use_ef, ref,
                                   sites, range(N_JITTERS))
            _, _, probes = spread(cfg, opt, params, batch, use_ef, ref,
                                  sites, range(N_JITTERS, 2 * N_JITTERS))
            line = [f"seed {seed}, {mode}{' + ef8' if use_ef else ''}:"]
            for what, sp, i in (("gradients", g_sp, 0),
                                ("parameters", p_sp, 1)):
                worst = sorted(sp.items(), key=lambda kv: -kv[1])[:3]
                line.append(f"{what} spread " + ", ".join(
                    f"{k} {v:.3g}" for k, v in worst) + "; F needed "
                    + ", ".join(f"{factor_needed(r[i], sp):.3g}"
                                for r in probes)
                    + f" (leaves over {FLOOR:g}: " + str(max(
                        sum(v > FLOOR for v in r[i].values())
                        for r in probes)) + ")")
            print(" ".join(line), flush=True)


if __name__ == "__main__":
    main()
