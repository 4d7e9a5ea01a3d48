"""The port's error-feedback gradient compression (``optim/compression``)
against the JAX package's, on the CPU: ``ef_compress`` bit for bit over
five steps of a nested tree, the cases of
``tests/test_distributed.py::TestGradientCompression`` on the port, and
``int8_psum`` over a gloo group of one process and of two, within world
x scale / 2 of the float sum (each rank's rounding error is at most half
the shared scale)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.distributed as dist

from repro.optim.compression import ef_compress as j_ef_compress
from repro.optim.compression import ef_init as j_ef_init
from repro_torch import tree
from repro_torch.optim.compression import (ef_compress, ef_init, int8_psum,
                                           int8_psum_tree)
from repro_torch.weights import lm_params_from_numpy

ROOT = Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def test_ef_compress_matches_jax_bit_for_bit():
    """Five steps of a nested tree (stacked leaves, an all-zero leaf,
    small and large magnitudes): the dequantized gradients and the
    residual equal eager JAX's bit for bit at every step. (The LM's
    trained tree is dicts only: the reference's ``ef_compress`` takes a
    tuple node for its own (dequantized, residual) pair, which
    :func:`test_ef_compress_keeps_tuple_nodes` checks the port does
    not.)"""
    rng = np.random.default_rng(0)

    def draw():
        return {"embed": rng.normal(size=(32, 8)).astype(np.float32),
                "zero": np.zeros((5,), np.float32),
                "blocks": {"w": (rng.normal(size=(2, 8, 8)) * 1e-3).astype(
                    np.float32),
                    "b": {"u": rng.normal(size=(2, 3)).astype(np.float32),
                          "v": (rng.normal(size=(7,)) * 50).astype(
                              np.float32)}}}
    grads = [draw() for _ in range(5)]
    js, ts = j_ef_init(grads[0]), ef_init(lm_params_from_numpy(grads[0],
                                                               "cpu"))
    for g in grads:
        jd, js = j_ef_compress(jax.tree.map(jnp.asarray, g), js)
        td, ts = ef_compress(lm_params_from_numpy(g, "cpu"), ts)
        for got, want in ((td, jd), (ts.residual, js.residual)):
            want = dict(tree.items(jax.tree.map(np.asarray, want)))
            for k, v in tree.items(got):
                np.testing.assert_array_equal(_np(v), want[k], err_msg=k)
    assert not ts.residual["zero"].any()


def test_ef_compress_keeps_tuple_nodes():
    """A tuple node stays a tuple of per-leaf results, each as a dict
    leaf of the same values would get."""
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.normal(size=n).astype(np.float32))
            for n in (6, 9))
    dq, st = ef_compress({"p": (a, b)}, ef_init({"p": (a, b)}))
    ref, ref_st = ef_compress({"a": a, "b": b}, ef_init({"a": a, "b": b}))
    assert isinstance(dq["p"], tuple) and isinstance(st.residual["p"], tuple)
    for i, k in enumerate("ab"):
        assert torch.equal(dq["p"][i], ref[k])
        assert torch.equal(st.residual["p"][i], ref_st.residual[k])


# --- tests/test_distributed.py::TestGradientCompression, on the port -------

class TestGradientCompression:
    def test_error_feedback_reduces_bias(self):
        """With EF, the accumulated update converges to the true sum."""
        g = {"w": torch.full((64,), 0.003)}
        state = ef_init(g)
        total = torch.zeros(64)
        for _ in range(50):
            dq, state = ef_compress(g, state)
            total = total + dq["w"]
        np.testing.assert_allclose(_np(total), np.full(64, 0.15), rtol=0.05)

    def test_compression_error_bounded(self):
        g = {"w": torch.from_numpy(
            np.random.default_rng(0).normal(size=128).astype(np.float32))}
        dq, state = ef_compress(g, ef_init(g))
        err = _np((dq["w"] - g["w"]).abs())
        scale = float(g["w"].abs().max()) / 127
        assert err.max() <= scale / 2 + 1e-6
        np.testing.assert_allclose(_np(state.residual["w"]),
                                   _np(g["w"] - dq["w"]), atol=1e-7)

    def test_int8_psum_one_process_group(self, tmp_path):
        """The int8 all-reduce over a group of one matches x within half
        its scale (the reference's one-device mesh axis)."""
        x = torch.from_numpy(
            np.random.default_rng(1).normal(size=16).astype(np.float32))
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                                world_size=1, rank=0)
        try:
            out = int8_psum(x)
            tree_out = int8_psum_tree({"a": x, "b": (x * 2,)})
        finally:
            dist.destroy_process_group()
        err = _np((out - x).abs())
        assert out.dtype == torch.float32
        assert err.max() <= float(x.abs().max()) / 127 / 2 + 1e-6
        assert torch.equal(tree_out["a"], out)
        assert isinstance(tree_out["b"], tuple)


_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.optim.compression import int8_psum
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=2, rank=rank)
x = np.random.default_rng(rank).normal(size=(33, 7)).astype(np.float32)
x *= (1.0, 40.0)[rank]
y = int8_psum(torch.from_numpy(x))
np.save(out, y.numpy())
dist.destroy_process_group()
"""


def test_int8_psum_two_process_gloo_group(tmp_path):
    """Two ranks with magnitudes 40x apart: every rank gets the same sum,
    within 2 x (the shared scale) / 2 of the float sum."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(tmp_path / "store"),
         str(tmp_path / f"out{r}.npy")], env=env) for r in range(2)]
    try:
        for p in procs:
            assert p.wait(timeout=60) == 0
    finally:
        for p in procs:
            p.kill()
    xs = [np.random.default_rng(r).normal(size=(33, 7)).astype(np.float32)
          * (1.0, 40.0)[r] for r in range(2)]
    want = xs[0] + xs[1]
    scale = max(np.abs(x).max() for x in xs) / 127
    outs = [np.load(tmp_path / f"out{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.abs(outs[0] - want).max() <= 2 * scale / 2 + 1e-5
