"""``launch/hlo_analysis.CollectiveCounter`` on a fake process group of 4
ranks in this process (``torch.testing._internal.distributed.fake_pg``:
collectives move no data): each collective is counted once and charged
its result's bytes per device, the reference's convention, whether
DTensor issues it inside an op or a redistribution, or
``torch.distributed`` issues it in place (``int8_psum``). The fake group
is process-global, so the fixture destroys it in a ``finally``."""
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.launch.hlo_analysis import (COLLECTIVES, CollectiveCounter,
                                             analyze_collectives)
from repro_torch.optim.compression import int8_psum


@pytest.fixture
def mesh4():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (4,))
    finally:
        dist.destroy_process_group()


def _only(counter, kind, n_bytes):
    by, ct = analyze_collectives(counter)
    assert set(by) == set(ct) == set(COLLECTIVES)
    assert ct == {k: int(k == kind) for k in COLLECTIVES}
    assert by == {k: n_bytes if k == kind else 0 for k in COLLECTIVES}


def test_shard_to_replicate_is_one_all_gather_of_the_result(mesh4):
    x = DTensor.from_local(torch.randn(2, 8), mesh4, [Shard(0)],
                           run_check=False)
    with CollectiveCounter() as c:
        y = x.redistribute(mesh4, [Replicate()])
    assert y.to_local().shape == (8, 8)
    _only(c, "all-gather", 8 * 8 * 4)


def test_partial_sum_matmul_is_one_all_reduce_of_the_result(mesh4):
    a = DTensor.from_local(torch.randn(4, 2), mesh4, [Shard(1)],
                           run_check=False)
    b = DTensor.from_local(torch.randn(2, 3, dtype=torch.float32), mesh4,
                           [Shard(0)], run_check=False)
    with CollectiveCounter() as c:
        z = a @ b
        assert z.placements == (Partial(),)
        z = z.redistribute(mesh4, [Replicate()])
    _only(c, "all-reduce", 4 * 3 * 4)


def test_partial_to_shard_is_one_reduce_scatter_of_the_result(mesh4):
    p = DTensor.from_local(torch.randn(8, 6), mesh4, [Partial()],
                           run_check=False)
    with CollectiveCounter() as c:
        s = p.redistribute(mesh4, [Shard(0)])
    assert s.to_local().shape == (2, 6)
    _only(c, "reduce-scatter", 2 * 6 * 4)


def test_in_place_all_reduces_are_counted(mesh4):
    """``int8_psum``: an all-reduce MAX of the float32 scale, then an
    int32 SUM of the codes."""
    x = torch.randn(16)
    with CollectiveCounter() as c:
        int8_psum(x)
    by, ct = analyze_collectives(c)
    assert ct["all-reduce"] == 2 and sum(ct.values()) == 2
    assert by["all-reduce"] == 4 + 16 * 4
    assert [name for name, _ in c.ops] == ["c10d.allreduce_.default"] * 2
