"""Quickstart on the PyTorch/CUDA port: the GAQ core in 60 lines.

The twin of ``examples/quickstart.py`` through ``repro_torch``. Shows
the paper's three ingredients on real tensors:
 1. MDDQ — magnitude-direction decoupled quantization of l=1 features,
    with its bounded-equivariance guarantee (Prop 3.4),
 2. Geometric STE — tangent-space gradients through the quantizer,
 3. robust cosine attention — bounded logits under low precision,
plus the W4A8 quantized matmul (``kernels.ops.matmul_w4a8``: the f32-A
W4A8 kernel on the card, its plain version on the CPU).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.attention_norm import robust_attention_weights
from repro_torch.core.codebook import covering_radius, quantize_direction
from repro_torch.core.lee import random_rotation
from repro_torch.core.mddq import MDDQConfig, mddq_fake_quant
from repro_torch.core.ste import geometric_ste_direction
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the current CUDA device by default; cpu runs "
                         "every kernel's plain PyTorch version")
    dev = resolve_device(ap.parse_args(argv).device)

    def normal(seed, shape):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(
            shape).astype(np.float32)).to(dev)

    def norm(x):
        return torch.linalg.vector_norm(x, dim=-1)

    # --- 1. MDDQ -----------------------------------------------------------
    cfg = MDDQConfig(direction_bits=12)          # 4096-point codebook
    codebook = cfg.codebook(dev)
    delta = covering_radius(codebook, n_samples=50_000)
    print(f"codebook: {codebook.shape[0]} points, covering radius "
          f"{delta:.4f} rad")

    v = normal(0, (1024, 3)) * 3.0               # a field of l=1 features
    v_q = mddq_fake_quant(v, cfg, codebook)
    ang = torch.arccos(torch.clamp((v * v_q).sum(-1) / (norm(v) * norm(v_q)),
                                   -1, 1))
    print(f"max angular error {float(ang.max()):.4f} rad <= delta ✓")

    # approximate equivariance: Q(Rv) vs R Q(v), bounded by 2 sin(delta/2)|v|
    R = torch.from_numpy(random_rotation(1)).to(dev)
    err = norm(mddq_fake_quant(v @ R.T, cfg, codebook)
               - mddq_fake_quant(v, cfg, codebook) @ R.T)
    bound = 2 * 2 * np.sin(delta / 2) * norm(v)
    within = float((err <= bound + 1e-5).float().mean()) * 100
    print(f"equivariance error: max {float(err.max()):.4f}, "
          f"bound {float(bound.max()):.4f} ✓ ({within:.0f}% within)")

    # --- 2. Geometric STE: direction gradients are tangent to the sphere ----
    u = (v / norm(v)[:, None]).requires_grad_()
    target = normal(9, (3,))
    q = geometric_ste_direction(u, quantize_direction(u.detach(), codebook))
    (g,) = torch.autograd.grad((q @ target).sum(), u)
    radial = (g * u.detach()).sum(-1).abs() / torch.clamp(norm(g), min=1e-9)
    print(f"direction-gradient radial fraction via Geometric STE: "
          f"{float(radial.max()):.2e} (tangent to S^2 ✓, Prop III.1)")

    # --- 3. robust attention: scale-invariant, bounded logits ---------------
    qa = normal(2, (4, 8, 32)) * 100.0
    ka = normal(3, (4, 8, 32)) * 0.01
    w = robust_attention_weights(qa, ka, tau=10.0)
    print(f"attention rows sum to {float(w.sum(-1).mean()):.4f}; outlier "
          f"scales neutralized (logits bounded by tau=10)")

    # --- 4. W4A8 quantized matmul -------------------------------------------
    x = normal(4, (64, 256))
    wmat = normal(5, (256, 128))
    w_packed, w_scale = ops.prepare_w4(wmat)
    y = ops.matmul_w4a8(x, w_packed, w_scale)
    ref = x @ wmat
    rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
    w_bytes = w_packed.numel() * w_packed.element_size()
    f_bytes = wmat.numel() * wmat.element_size()
    print(f"W4A8 matmul on {dev}: weight bytes {w_bytes} vs fp32 {f_bytes} "
          f"({f_bytes // w_bytes}x), rel err {rel:.3f}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
