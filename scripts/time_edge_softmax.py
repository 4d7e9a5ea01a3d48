#!/usr/bin/env python3
"""Time the edge-softmax kernel (K3) of the checkout at ROOT on one card.

    python3 scripts/time_edge_softmax.py ROOT

Builds ROOT's kernels and times ``edge_softmax_fused`` at two layouts of
ROOT's ``chip_smoke.py``: the serving batch (256 nodes, 8,192 slots) and
the every-pair one (four 64-atom molecules), F=64, W=112. Prints the
card, then the device time per call (median of five torch.profiler
windows) and the CUDA-event time per call of each. To compare two
versions of the kernel, run it for both checkouts in turns on one card,
within one command (A, B, B, A). Needs a CUDA card.
"""
import os
import statistics
import sys


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.edge_softmax import edge_softmax_fused
    from repro_torch.models.so3krates import So3kratesConfig
    from repro_torch.serving import random_graphs

    dev = torch.device("cuda", 0)
    cfg = So3kratesConfig(feat=64, vec_feat=16, n_layers=3, n_rbf=16,
                          cutoff=10.0, dir_bits=16)
    graphs = random_graphs(16, 9, 24, cfg.n_species, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    layouts = {"serving": (*cs.serving_edge_list(graphs, cfg.cutoff), 32),
               "every_pair": (*cs.every_pair_edge_list(cfg.cutoff), 64)}
    out = [cs.gpu_identity(), root]
    for name, (el, n, cap) in layouts.items():
        s, r, m = (torch.from_numpy(a).to(dev)
                   for a in (el.senders, el.receivers, el.edge_mask))
        F, W, E = cfg.feat, cfg.feat + 3 * cfg.vec_feat, s.shape[0]
        q = torch.randn(n, F, generator=gen, device=dev)
        k = torch.randn(n, F, generator=gen, device=dev)
        bias = torch.randn(E, generator=gen, device=dev)
        vals = torch.randn(E, W, generator=gen, device=dev)

        def fn():
            return edge_softmax_fused(q, k, bias, vals, s, r, m, cap)
        times = [t for t in (cs.device_profile(torch, fn)[0]
                             for _ in range(5)) if t is not None]
        device = statistics.median(times) if times else "not measured"
        out.append(f"{name}: device {device} ms, event "
                   f"{cs.time_ms(torch, fn)} ms")
    print(" | ".join(out))


if __name__ == "__main__":
    main()
