"""``launch/reshard.ReshardMode`` on a fake 2 x 2 process group (this
process rank 0, meta shards): a view DTensor refuses (7 heads of 8 out of
a dim sharded over a model axis of 2) goes through after the smallest
reshard, the model dim replicated and nothing else, in the forward and
in a backward through the view; the collective counter entered before
the mode charges exactly the bytes the log states; an op that still
fails once its argument is fully replicated re-raises DTensor's
original exception; an exception raised outside DTensor (by a dispatch
mode beneath it) is not retried at all; an in-place op DTensor refuses
on a partial sum reshards its own argument in place; and a masked
partial sum (the vocab-sharded gather's) is reduced before an index
leaves its mask the wrong shape, which DTensor would fail on at the
reduction; an op DTensor has no rule for runs on the full tensors of its
replicated arguments; a refusal the mode gets past leaves no shard to
the cyclic collector (its traceback's frames held them, and the dry
run's memory tracker counted them until a collection).
"""
import gc

import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.hlo_analysis import CollectiveCounter
from repro_torch.launch.reshard import (ReshardMode, raised_by_dtensor,
                                        reshard_totals)

SHAPE, LOCAL = (32, 56), (16, 28)       # Shard(0) on data, Shard(1) on model


@pytest.fixture
def mesh():
    with fake_world((2, 2), ("data", "model")) as m:
        yield m


def _leaf(mesh, requires_grad=False):
    local = torch.empty(LOCAL, device="meta", requires_grad=requires_grad)
    return DTensor.from_local(local, mesh, [Shard(0), Shard(1)],
                              run_check=False, shape=torch.Size(SHAPE),
                              stride=(SHAPE[1], 1))


def _refusal(fn):
    with pytest.raises(RuntimeError) as info:
        fn()
    assert raised_by_dtensor(info.value)
    return info.value


def _only_the_model_dim(log):
    assert len(log) == 1
    (entry,) = log
    assert (entry["op"], entry["arg"], entry["shape"], entry["mesh_dim"],
            entry["n"]) == ("aten.view.default", 0, list(SHAPE), "model", 1)
    assert entry["from"] == str((Shard(0), Shard(1)))
    assert entry["to"] == str((Shard(0), Replicate()))
    # the model axis gathered: the (16, 56) float32 rows of this data rank
    assert entry["bytes"] == {"all-gather": 16 * 56 * 4}
    assert entry["counts"] == {"all-gather": 1}


def test_a_refused_view_goes_through_after_the_smallest_reshard(mesh):
    x = _leaf(mesh)
    _refusal(lambda: x.view(32, 7, 8))
    counter = CollectiveCounter()
    mode = ReshardMode(counter)
    with counter, mode:
        y = x.view(32, 7, 8)
    assert y.shape == (32, 7, 8)
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert tuple(y.to_local().shape) == (16, 7, 8)
    _only_the_model_dim(mode.log)
    n, nbytes, counts = reshard_totals(mode.log)
    assert n == 1
    assert {k: v for k, v in counter.bytes.items() if v} == nbytes
    assert {k: v for k, v in counter.counts.items() if v} == counts


def test_the_backward_through_a_resharded_view_runs(mesh):
    x = _leaf(mesh, requires_grad=True)
    counter = CollectiveCounter()
    mode = ReshardMode(counter)
    with counter, mode:
        y = x.view(32, 7, 8)
        (grad,) = torch.autograd.grad((y * 2).sum(), x)
    assert isinstance(grad, DTensor) and grad.shape == SHAPE
    _only_the_model_dim(mode.log)
    _, nbytes, counts = reshard_totals(mode.log)
    for kind in nbytes:
        assert counter.bytes[kind] >= nbytes[kind]
        assert counter.counts[kind] >= counts[kind]


def test_an_op_full_replication_cannot_cure_reraises_the_original(mesh):
    x = _leaf(mesh)
    want = _refusal(lambda: x.view(32, 7, 9))       # 1,792 != 2,016
    mode = ReshardMode()
    with pytest.raises(RuntimeError) as info:
        with mode:
            x.view(32, 7, 9)
    # DTensor's first refusal, on the placements the op was called with
    assert str(info.value) == str(want)
    assert "S(0)S(1)" in str(info.value)
    # both dims were replicated, model first, before it gave up
    assert [e["mesh_dim"] for e in mode.log] == ["model", "data"]


class _RaisesOnSum(TorchDispatchMode):
    """A mode beneath the reshard mode that raises on a DTensor's sum
    before DTensor sees it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.sum.default and any(
                issubclass(t, DTensor) for t in types):
            raise ValueError("raised outside DTensor")
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        return func(*args, **(kwargs or {}))


def test_an_exception_raised_outside_dtensor_is_not_retried(mesh):
    x = _leaf(mesh)
    mode = ReshardMode()
    with pytest.raises(ValueError, match="outside DTensor") as info:
        with _RaisesOnSum(), mode:
            x.sum()
    assert not raised_by_dtensor(info.value)
    assert mode.log == []


def _tensor(mesh, shape, placements, dtype=torch.float32):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(shape, mesh,
                                                     placements)
    return DTensor.from_local(
        torch.empty(local, device="meta", dtype=dtype), mesh, placements,
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def test_an_in_place_op_reshards_its_own_argument_in_place(mesh):
    x = _tensor(mesh, SHAPE, [Shard(0), Partial()])
    keep = _tensor(mesh, SHAPE, [Shard(0), Replicate()], torch.bool)
    _refusal(lambda: x.masked_fill_(keep, 0.0))
    counter = CollectiveCounter()
    mode = ReshardMode(counter)
    with counter, mode:
        y = x.masked_fill_(keep, 0.0)
    assert y is x and tuple(x.placements) == (Shard(0), Replicate())
    # the partial sum over the model axis reduced: (16, 56) float32
    assert {(e["arg"], e["mesh_dim"]): e["bytes"] for e in mode.log}[
        (0, "model")] == {"all-reduce": 16 * 56 * 4}
    _, nbytes, _ = reshard_totals(mode.log)
    assert {k: v for k, v in counter.bytes.items() if v} == nbytes


def test_a_masked_partial_is_reduced_before_an_index_breaks_its_mask(mesh):
    logits = _tensor(mesh, (4, 8, 32), [Shard(0), Shard(2)])
    labels = _tensor(mesh, (4, 8, 1), [Replicate(), Replicate()],
                     torch.long)

    def loss():
        gold = torch.gather(logits, -1, labels)[..., 0]
        return (torch.logsumexp(logits, -1) - gold).sum()
    mode = ReshardMode()
    with mode:
        out = loss()
    assert out.shape == ()
    with pytest.raises(IndexError):     # DTensor alone: the stale mask
        loss()
    (entry,) = [e for e in mode.log if e["op"] == "aten.select.int"]
    assert "MaskPartial" in entry["from"] and entry["mesh_dim"] == "model"
    # the gathered (2, 8, 1) float32 rows of this data rank, all-reduced
    assert entry["bytes"] == {"all-reduce": 2 * 8 * 1 * 4}


def test_an_op_dtensor_has_no_rule_for_runs_replicated(mesh):
    x = _leaf(mesh)
    with pytest.raises(NotImplementedError, match="sharding strategy"):
        torch.renorm(x, 2, 0, 1.0)
    counter = CollectiveCounter()
    mode = ReshardMode(counter)
    with counter, mode:
        y = torch.renorm(x, 2, 0, 1.0)
    assert isinstance(y, DTensor) and y.shape == SHAPE
    assert tuple(y.placements) == (Replicate(), Replicate())
    assert [e["mesh_dim"] for e in mode.log] == ["model", "data"]
    _, nbytes, _ = reshard_totals(mode.log)
    # (16, 56) then (32, 56) float32 gathered
    assert nbytes == {"all-gather": (16 * 56 + 32 * 56) * 4}
    assert {k: v for k, v in counter.bytes.items() if v} == nbytes


class _PadsOffTheMesh(TorchDispatchMode):
    """torch 2.11's rule for ``constant_pad_nd`` on a 2-D mesh: its output
    gets one placement."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        dt = any(issubclass(t, DTensor) for t in types)
        if dt and func is torch.ops.aten.constant_pad_nd.default:
            from torch.distributed.tensor._dtensor_spec import DTensorSpec
            out = func(*args, **(kwargs or {}))
            spec = DTensorSpec(out.device_mesh, (Replicate(),),
                               out._spec.tensor_meta)
            return DTensor(out.to_local(), spec, requires_grad=False)
        if dt:
            return NotImplemented
        return func(*args, **(kwargs or {}))


def test_an_output_placed_off_its_mesh_runs_replicated(mesh):
    x = _leaf(mesh)
    counter = CollectiveCounter()
    mode = ReshardMode(counter)
    with counter, _PadsOffTheMesh(), mode:
        y = torch.nn.functional.pad(x, (0, 0, 3, 0))
    assert y.shape == (35, 56) and y.to_local().shape == (35, 56)
    assert tuple(y.placements) == (Replicate(), Replicate())
    assert [e["mesh_dim"] for e in mode.log] == ["model", "data"]
    _, nbytes, _ = reshard_totals(mode.log)
    assert {k: v for k, v in counter.bytes.items() if v} == nbytes


def test_a_refusal_gone_past_leaves_no_shard_to_the_cyclic_collector(mesh):
    x = _leaf(mesh)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        with ReshardMode(CollectiveCounter()) as mode:
            y = x.view(32, 7, 8)
        assert tuple(y.shape) == (32, 7, 8) and mode.log[0]["n"] == 1
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
        assert held == []
        assert not any(isinstance(o, BaseException) for o in gc.garbage)
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
