"""``models/lm/scan.py``: the port's counterpart of ``jax.lax.scan``, which
the sLSTM runs its loop over time through.

Outside the dry run the scan is the plain loop, and the sLSTM's outputs
and gradients are the old Python loop's bit for bit, in float32 and
bf16. Under the dry run (``launch/dryrun.py``) the scan charges the
steps after its first steady pair instead of running them; on xlstm's
smoke config at S = 32 (its ``ssm_chunk``), on a 2 x 2 and a 2 x 2 x 2
fake mesh, prefill_32k and train_4k under tp and fsdp, the record with
charging equals the record of the full loop (``full_loop=True``) key for
key on ``flops``, ``collective_bytes``, ``collective_counts``,
``argument_bytes``, ``output_bytes`` and the reshard totals, and on
``temp_bytes`` and ``peak_bytes`` within :func:`step_bytes`. A body
whose carry placement alternates never settles, and the scan runs (and
counts) its whole loop; a tail too short to settle the backward
rebuilds the charged steps until a pair agrees, and is still exact.

The 2 x 2 x 2 tp cells cost ~100-160 s each here on their first run in
a process: torch 2.13's graph-based redistribute planner, which DTensor
takes for a ``_StridedShard`` (the sLSTM's recurrence term) on a 3-D
mesh, searches ~40-100 s for each of the cell's first two ``add``s.
They are in ``tests/test_torch_3d_mesh_scan.py``, a file of their own
that sorts early, so that another worker starts them early.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import CollectiveCounter
from repro_torch.launch.reshard import ReshardMode, reshard_totals
from repro_torch.models.lm import scan as scan_lib
from repro_torch.models.lm import xlstm
from repro_torch.models.lm.layers import qlinear, rmsnorm

ARCH = "xlstm-1.3b"
SEQ = 32        # the smoke config's ssm_chunk: the mLSTM's scan needs it


def step_bytes(shape: str) -> int:
    """The bytes of one sLSTM step at global shapes: its float32 gates
    (B, 4d) and its new state (h, c, n, m), (B, d) each, float32 at most:
    32 * B * d. Memory may differ from the full loop's by this much."""
    cfg = configs.get_smoke_config(ARCH)
    B = next(s for s in dryrun.SHAPES if s.shape_name == shape).global_batch
    return 32 * B * cfg.d_model


def _loop_slstm_forward(params, x_res, cfg):
    """The sLSTM's forward as a Python loop over time, as the port ran it
    before ``scan``."""
    B, S, _ = x_res.shape
    x_in = qlinear(x_res, params["w_in"], cfg.quant_mode)
    state = xlstm._slstm_state0(cfg, B, x_res.dtype, x_res.device)
    hs = []
    for t in range(S):
        state = xlstm._slstm_cell(params, cfg, x_in[:, t], state)
        hs.append(state[0])
    h = rmsnorm(torch.stack(hs, dim=1), params["norm_w"])
    return qlinear(h, params["down"], cfg.quant_mode)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eager_scan_is_the_loop_bit_for_bit(dtype):
    cfg = configs.get_smoke_config(ARCH)
    rng = np.random.default_rng(0)
    arrays = xlstm.slstm_arrays(cfg, rng)
    x = torch.from_numpy(rng.standard_normal((3, 40, cfg.d_model)).astype(
        np.float32)).to(dtype)
    outs, grads = [], []
    for fn in (xlstm.slstm_forward, _loop_slstm_forward):
        params = {k: torch.from_numpy(v).to(dtype).requires_grad_()
                  for k, v in arrays.items()}
        xr = x.clone().requires_grad_()
        y = fn(params, xr, cfg)
        (y.float() ** 2).sum().backward()
        outs.append(y)
        grads.append([xr.grad] + [params[k].grad for k in sorted(params)])
    assert outs[0].dtype == dtype and torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def _records(mesh, shape, policy):
    got = {}
    for full in (False, True):
        notes = []
        rec, log = dryrun.run_cell_and_reshards(
            ARCH, shape, "single", mesh_shape=mesh, smoke=True,
            policy=policy, seq_len=SEQ, full_loop=full, scan_log=notes)
        assert not dist.is_initialized()
        assert "error" not in rec, rec.get("error")
        got[full] = (rec, log, notes)
    return got


def assert_charging_is_exact(mesh, shape, policy):
    """The record with the scan charging equals the full loop's."""
    got = _records(mesh, shape, policy)
    (rec, log, notes), (full, full_log, full_notes) = got[False], got[True]
    passes = ["forward"] + (["backward"] if shape == "train_4k" else [])
    assert [n["pass"] for n in notes] == passes and full_notes == []
    for n in notes:                  # the charging ran
        assert n["length"] == SEQ and n["charged"] > 0
        assert n["ran"] + n["charged"] == SEQ
    for key in ("flops", "collective_bytes", "collective_counts"):
        assert rec[key] == full[key], key
    for key in ("argument_bytes", "output_bytes"):
        assert rec["memory"][key] == full["memory"][key], key
    assert reshard_totals(log) == reshard_totals(full_log)
    for key in ("temp_bytes", "peak_bytes"):
        assert abs(rec["memory"][key] - full["memory"][key]) <= \
            step_bytes(shape), key


@pytest.mark.parametrize("mesh,shape,policy", [
    ((2, 2), "prefill_32k", "tp"), ((2, 2), "prefill_32k", "fsdp"),
    ((2, 2), "train_4k", "tp"), ((2, 2), "train_4k", "fsdp"),
    ((2, 2, 2), "prefill_32k", "fsdp"), ((2, 2, 2), "train_4k", "fsdp")])
def test_charging_equals_the_full_loop(mesh, shape, policy):
    assert_charging_is_exact(mesh, shape, policy)


def test_a_backward_the_tail_does_not_settle_is_rebuilt(monkeypatch):
    """With a tail of 2 steps the backward has no steady pair there (the
    last step's carry gets no gradient, the next one's only h's), so the
    charged steps are rebuilt until a pair agrees: still exact."""
    monkeypatch.setattr(scan_lib, "TAIL", 2)
    got = _records((2, 2), "train_4k", "fsdp")
    rec, full = got[False][0], got[True][0]
    back = got[False][2][1]
    assert back["pass"] == "backward" and back["charged"] > 0
    assert back["ran"] > 2 + 3            # the tail, rebuilt steps, head
    for key in ("flops", "collective_bytes", "collective_counts"):
        assert rec[key] == full[key], key
    assert reshard_totals(got[False][1]) == reshard_totals(got[True][1])
    for key in ("temp_bytes", "peak_bytes"):
        assert abs(rec["memory"][key] - full["memory"][key]) <= \
            step_bytes("train_4k"), key


def _alternating(carry, x_t):
    """A body whose carry is replicated after a sharded step and sharded
    after a replicated one."""
    (c,) = carry
    to = Replicate() if c.placements[0].is_shard() else Shard(0)
    c = c.redistribute(c.device_mesh, [to, Replicate()]) + x_t
    return (c,), c * 2


@pytest.mark.parametrize("grad", [False, True])
def test_a_carry_placement_that_alternates_runs_the_whole_loop(grad):
    S = 12
    with dryrun.fake_world((2, 2), ("data", "model")) as mesh:
        def meta(shape, placements):
            local = torch.empty(shape, device="meta")
            if placements[0].is_shard():
                local = torch.empty((shape[0] // 2,) + shape[1:],
                                    device="meta")
            return DTensor.from_local(local, mesh, placements,
                                      run_check=False, shape=shape,
                                      stride=torch.empty(shape).stride())
        rep = [Replicate(), Replicate()]
        xs = meta((8, S, 4), rep).requires_grad_(grad)
        c0 = meta((8, 4), [Shard(0), Replicate()])
        counts = []
        for meter_on in (True, False):
            coll, flops = CollectiveCounter(), dryrun._LocalFlops()
            reshards = ReshardMode(coll)
            meter = dryrun._Meter(flops, coll, reshards, None)
            with coll, flops, reshards:
                if meter_on:
                    with scan_lib.charging(meter):
                        _, ys = scan_lib.scan(_alternating, (c0,), xs)
                else:
                    _, ys = scan_lib.scan(_alternating, (c0,), xs)
                if grad:
                    ys.sum().backward()
            assert tuple(ys.shape) == (8, S, 4)
            counts.append((dict(coll.bytes), dict(coll.counts)))
            if meter_on:
                notes = meter.scans
    assert [n["pass"] for n in notes] == ["forward"] + (
        ["backward"] if grad else [])
    for n in notes:
        assert (n["ran"], n["charged"], n["steady_at"]) == (S, 0, None)
    assert counts[0] == counts[1] and counts[0][1]["all-gather"] >= S // 2


def test_the_probe_times_the_steady_step_three_ways():
    """``tools/dryrun_sweep.probe_slstm`` stops the cell at the scan's
    steady sLSTM step and times it on the DTensors under the dry run's
    modes, with the modes off, and on plain meta tensors."""
    from repro_torch.tools.dryrun_sweep import probe_slstm
    res = probe_slstm(ARCH, "prefill_32k", "single", "tp", reps=2,
                      smoke=True, mesh_shape=(2, 2), seq_len=SEQ)
    assert not dist.is_initialized() and res["error"] is None
    for key in ("dtensor_with_modes_s", "dtensor_s", "meta_s"):
        assert res[key] > 0, key
    assert res["dtensor_dispatch_s"] == res["dtensor_s"] - res["meta_s"]
    assert res["modes_s"] == res["dtensor_with_modes_s"] - res["dtensor_s"]
