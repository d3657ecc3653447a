"""The port's op counter and roofline (``repro_torch.roofline``) against
``tests/test_roofline.py``'s cases, adapted to what the port reports:
exact mm FLOPs, Python loops counted per iteration (no trip count to
multiply), an in-place slice write charged as the slice, collective wire
bytes by the reference's formulas with the group size read from the op's
group, and ``model_flops_*`` equal to the reference's for all ten archs x
four shapes.  The collectives run on a fake process group in a subprocess
(one default group per process, and xdist workers run several files).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import repro.configs as ref_configs
from repro.launch import specs as ref_specs
from repro.roofline import analysis as ref_analysis
from repro.roofline.analysis import roofline_terms as ref_roofline_terms
from repro_torch import configs
from repro_torch.launch import specs
from repro_torch.roofline import H100, OpCosts, count_ops, roofline_terms
from repro_torch.roofline import analysis

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_single_mm_flops_exact():
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    with count_ops() as counter:
        a @ b
    assert counter.costs.dot_flops == 2 * 64 * 128 * 32
    assert counter.costs.num_while_loops == 0


def test_python_loop_counts_every_iteration():
    x, w = torch.randn(16, 64), torch.randn(12, 64, 64)
    with count_ops() as counter:
        for wi in w:
            x = torch.einsum("bd,de->be", x, wi)
    assert counter.costs.dot_flops == 12 * 2 * 16 * 64 * 64


def test_nested_loops_multiply():
    x, w = torch.randn(8, 32), torch.randn(5, 32, 32)
    with count_ops() as counter:
        for wi in w:
            for _ in range(3):
                x = x @ wi
    assert counter.costs.dot_flops == 5 * 3 * 2 * 8 * 32 * 32


def test_in_place_cache_update_charges_slice_not_buffer():
    cache, upd = torch.zeros(4096, 256), torch.randn(1, 256)
    with count_ops() as counter:
        cache[0:1] = upd
    # the full buffer is 4 MB; the slice and the update are 1 KB each
    assert 0 < counter.costs.hbm_bytes < 4096 * 256 * 4 / 4
    assert counter.costs.temp_bytes == 0       # nothing allocated


def test_roofline_report_terms():
    rep = roofline_terms(arch="x", shape="train_4k", mesh_desc="m", chips=256,
                         costs=OpCosts(), model_flops=1e15)
    assert rep.compute_s == 0.0 and rep.dominant == "compute"
    ref = ref_roofline_terms(arch="x", shape="train_4k", mesh_desc="m", chips=256,
                             hlo_text="", model_flops=1e15)
    assert set(ref.as_dict()) <= set(rep.as_dict())
    a, b = torch.randn(1024, 1024), torch.randn(1024, 1024)
    with count_ops() as counter:
        a @ b
    rep2 = roofline_terms(arch="x", shape="s", mesh_desc="m", chips=2,
                          costs=counter.costs, model_flops=2.0 * 1024 ** 3)
    assert rep2.flops_per_chip == counter.costs.dot_flops_fp32 == 2 * 1024 ** 3
    # an fp32 product runs off the tensor cores (no TF32): the fp32 peak
    assert rep2.compute_s == 2 * 1024 ** 3 / H100.peak_flops_fp32
    assert rep2.memory_s == 3 * 1024 * 1024 * 4 / H100.hbm_bw
    assert 0 < rep2.roofline_fraction <= 1.0
    # mfu on the report's own hardware
    assert rep2.mfu == pytest.approx(
        rep2.model_flops / (rep2.chips * rep2.step_time_s) / H100.peak_flops, rel=1e-12)
    # a bf16 product at the tensor cores' peak, beside the fp32 one
    with count_ops() as counter:
        a @ b
        a.bfloat16() @ b.bfloat16()
    rep3 = roofline_terms(arch="x", shape="s", mesh_desc="m", chips=1, costs=counter.costs, model_flops=0.0)
    assert rep3.flops_per_chip == 2 * counter.costs.dot_flops_fp32 == 4 * 1024 ** 3
    assert rep3.compute_s == pytest.approx(2 * 1024 ** 3 / H100.peak_flops + 2 * 1024 ** 3 / H100.peak_flops_fp32,
                                           rel=1e-12)
    assert H100 == analysis.HwSpec("nvidia-h100-sxm5-80gb-700w", 989e12, 3.35e12, 450e9, 67e12)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_equal_reference(arch):
    ref_cfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    for shape, info in specs.SHAPES.items():
        assert info == ref_specs.SHAPES[shape]
        b, s = info["batch"], info["seq"]
        assert analysis.model_flops_train(cfg, b, s) == ref_analysis.model_flops_train(ref_cfg, b, s)
        assert analysis.model_flops_prefill(cfg, b, s) == ref_analysis.model_flops_prefill(ref_cfg, b, s)
        assert analysis.model_flops_decode(cfg, b, s) == ref_analysis.model_flops_decode(ref_cfg, b, s)


# -- collectives on a fake process group -------------------------------------

FAKE_WORKER = textwrap.dedent(
    """
    import json
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    import torch.testing._internal.distributed.fake_pg  # registers the "fake" backend
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.roofline import count_ops

    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=256)
    out = {}
    pair = dist.new_group([0, 1])
    x = torch.zeros(1024, 1024)                               # 4 MB
    with count_ops() as c:
        funcol.all_reduce(x, "sum", pair) + 0
    out["all_reduce"] = c.costs.as_dict()
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    with count_ops() as c:
        funcol.all_gather_tensor(torch.zeros(256, 256), 1, mesh.get_group(1)) + 0
    out["all_gather"] = c.costs.as_dict()
    # a column- then row-sharded pair of products on fake tensors: local
    # FLOPs, one all-reduce over "model", DTensor's global-shape runs unseen
    with FakeTensorMode():
        xs = distribute_tensor(torch.empty(64, 1024), mesh, [Replicate(), Replicate()], src_data_rank=None)
        w1 = distribute_tensor(torch.empty(1024, 4096), mesh, [Replicate(), Shard(1)], src_data_rank=None)
        w2 = distribute_tensor(torch.empty(4096, 1024), mesh, [Replicate(), Shard(0)], src_data_rank=None)
        with count_ops() as c:
            y = ((xs @ w1) @ w2).full_tensor()
        out["tp"] = dict(c.costs.as_dict(), temp_bytes=c.costs.temp_bytes)
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def fake_run():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", FAKE_WORKER], capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def test_all_reduce_wire_bytes(fake_run):
    got = fake_run["all_reduce"]
    # AR wire: 2 * 4 MB * (2 - 1) / 2 = 4 MB
    assert got["collective_wire_bytes"] == 4 * 1024 ** 2
    assert got["collective_by_type"] == {"all-reduce": 4 * 1024 ** 2}
    assert got["collective_count"] == {"all-reduce": 1}


def test_all_gather_group_size(fake_run):
    got = fake_run["all_gather"]
    # AG wire: result 4 MB * 15/16, the group size read from the op's group
    assert got["collective_wire_bytes"] == 256 * 4096 * 4 * 15 / 16


def test_sharded_products_count_per_chip(fake_run):
    got = fake_run["tp"]
    assert got["dot_flops"] == 2 * (2 * 64 * 1024 * 4096) / 16
    assert got["collective_count"] == {"all-reduce": 1}
    assert got["collective_wire_bytes"] == 2 * 64 * 1024 * 4 * 15 / 16
    # the largest live result is a (64, 256) or (64, 1024) fp32 block, not a global one
    assert got["temp_bytes"] < 64 * 4096 * 4
