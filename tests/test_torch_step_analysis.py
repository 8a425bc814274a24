"""The port's step analysis (``repro_torch.launch.step_analysis``), the
counterpart of ``tests/test_hlo_analysis.py``: the same collectives as
that test's HLO module, issued by a hand-written function on the fake
process group of 8 ranks over a (2, 4) mesh, give the same bytes a kind
(all-gather 65,536; all-reduce 12 x 16,384 + 512, the twelve in a Python
loop, which eager mode dispatches twelve times; collective-permute 256, a
send/recv pair counted once, as its receive); and ``cost_analysis`` of
one matrix product counts 2BKN flops and its operands' and result's
bytes.
"""

import pytest
import torch
import torch.distributed as dist

from repro.launch.hlo_analysis import collective_bytes
from repro_torch.launch import collectives as cc
from repro_torch.launch.dryrun import init_fake_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.step_analysis import KINDS, StepTrace, cost_analysis
from test_hlo_analysis import HLO


@pytest.fixture(scope="module")
def mesh():
    assert not dist.is_initialized()
    init_fake_group(8)
    try:
        yield make_mesh((2, 4), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def step(mesh):
    """The collectives of ``test_hlo_analysis.HLO``'s module."""
    a = torch.zeros((256, 64), dtype=torch.bfloat16)
    ag = cc.gather_rows(a, mesh, "data")  # bf16 [512, 64]
    x = torch.zeros((128, 64), dtype=torch.bfloat16)
    for _ in range(12):
        dist.all_reduce(x, group=cc.axis_groups(mesh, "model")[0])
    b = torch.zeros(64, dtype=torch.float32)
    dist.send(b, dst=1)
    dist.recv(b, src=1)
    c2 = torch.zeros((32, 8), dtype=torch.bfloat16)
    c2 = cc.psum(c2, mesh, "data")
    return ag, x, b, c2


def test_collective_bytes_match_jax_hlo_analysis(mesh):
    with StepTrace() as trace:
        ag, *_ = step(mesh)
    assert ag.shape == (512, 64)
    rep = trace.report
    want = collective_bytes(HLO)
    assert rep.by_kind == want.by_kind == {
        "all-gather": 65536, "all-reduce": 128 * 64 * 2 * 12 + 512,
        "collective-permute": 256}
    assert rep.total_bytes == want.total_bytes == 262912
    assert rep.unresolved_loops == 0
    assert rep.op_count == 1 + 12 + 1 + 1
    assert trace.comm_ops == {"all-reduce": 13, "all-gather": 1,
                              "reduce-scatter": 0, "all-to-all": 0,
                              "collective-permute": 1}
    assert set(trace.comm_ops) == set(KINDS)
    assert rep.as_dict() == {"total_bytes": 262912.0, "by_kind": rep.by_kind,
                             "op_count": 15, "unresolved_loops": 0}


def test_dtensor_redistribution_is_counted(mesh):
    """DTensor's functional collectives: Shard(0) over both axes gathered
    to Replicate is an all-gather on each axis, each counted with its
    result."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    local = torch.zeros((4, 16), dtype=torch.float32)
    dt = DTensor.from_local(local, mesh, (Shard(0), Shard(0)), shape=(32, 16),
                            stride=(16, 1))
    with StepTrace() as trace:
        full = dt.redistribute(mesh, (Replicate(), Replicate())).to_local()
    assert full.shape == (32, 16)
    assert trace.comm_ops["all-gather"] == 2
    # minor axis (model, 4 ranks) first: [16, 16], then data: [32, 16]
    assert trace.report.by_kind == {"all-gather": (16 * 16 + 32 * 16) * 4}


def test_unknown_collective_raises(mesh):
    t = torch.zeros(8)
    with pytest.raises(NotImplementedError, match="broadcast"):
        with StepTrace():
            dist.broadcast(t, src=0)


@pytest.mark.parametrize("B,K,N,dtype", [(8, 32, 16, torch.float32),
                                         (64, 128, 48, torch.bfloat16)])
def test_cost_analysis_of_a_matrix_product(B, K, N, dtype):
    a = torch.ones((B, K), dtype=dtype)
    b = torch.ones((K, N), dtype=dtype)
    cost = cost_analysis(torch.matmul, a, b)
    assert cost["flops"] == 2 * B * K * N
    assert cost["bytes accessed"] == (B * K + K * N + B * N) * a.element_size()


def test_live_memory_counts_arguments_once_and_frees():
    a = torch.zeros(1024, dtype=torch.float32)
    with StepTrace() as trace:
        trace.track((a, a[:10]))  # one storage
        y = a * 2  # +4096
        z = y + 1  # +4096, then y is freed
        del y
        w = z[:5]  # a view: nothing new
    assert trace.peak_bytes == 3 * 4096
    assert trace.live_bytes == 2 * 4096
    assert w.shape == (5,)
