"""The kernels as ``torch.library`` custom ops (``dhd_tpu_torch::``), on
the CPU: under a trace (``torch.compiler.is_compiling``) each wrapper's
card path checks its fake CUDA inputs without reading their memory and
records its op, whose registered fake gives the kernel's output shapes
and dtypes from the input shapes alone; no launch is counted.  The card
runs the ops' implementations (``chip_smoke.py`` phase 23)."""
from unittest import mock

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import dhd_tpu_torch.ops as O
from dhd_tpu_torch.ops.mghs_pool_cuda import pool_plan_cuda
from dhd_tpu_torch.ops.voxel_pool import PoolPlan
from dhd_tpu_torch.profiling import kernel_launches

BF16 = torch.bfloat16
OPS = ("mghs_pool", "pool_plan", "stereo_cost", "window_attention",
       "layer_norm")


def _empty(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="cuda")


def _layer_norm():
    return O.fused_layer_norm_cuda(_empty(10, 64, dtype=BF16), _empty(64),
                                   _empty(64)), ((10, 64), BF16)


def _window_attention():
    qkv = _empty(12, 144, 3 * 128, dtype=BF16)
    return O.window_attention_cuda(
        qkv, _empty(4, 144, 144, dtype=BF16), _empty(6, 144, 144, dtype=BF16),
        4), ((12, 144, 128), BF16)


def _stereo_cost():
    prev = _empty(6, 16, 44, 64, dtype=BF16)
    uf = _empty(6, 8, 16, 44)
    return O.stereo_cost_volume_cuda(prev, prev, uf, uf, 5.0), \
        ((6, 8, 16, 44), torch.float32)


def _plan(p=1000, grid=(2, 4, 4, 16)):
    key = _empty(p, dtype=torch.int32)
    n_vox = grid[0] * grid[1] * grid[2] * grid[3]
    return pool_plan_cuda(key, _empty(p, dtype=torch.int64), key, n_vox,
                          (grid[0], 6, 8, 4, 4), grid[3])


def _pool_plan():
    dix_s, z_s, starts, tasks, splits, n_slots = _plan()
    # 32 pillars, 1000 points: 32 + 1000 // 128 tasks, 7 splits
    assert (tasks.shape, splits.shape, n_slots) == ((39, 4), (7, 4), 14)
    assert tasks.dtype == splits.dtype == torch.int32
    return starts, ((33,), torch.int32)


def _mghs_pool():
    dix_s, z_s, starts, tasks, splits, n_slots = _plan()
    plan = PoolPlan(dix_s=dix_s, z_s=z_s, starts=starts, grid=(2, 4, 4, 16),
                    band_edges=(4, 8), tasks=tasks, splits=splits,
                    n_slots=n_slots)
    bev, vox = O.mghs_pool_cuda(_empty(2, 6, 4, 4, 8, dtype=BF16),
                                _empty(2, 6, 4, 4, 32, dtype=BF16),
                                _empty(2, 6, 4, 4, 3, dtype=BF16), plan)
    assert vox.shape == (2, 4, 4, 16, 32) and vox.dtype == BF16
    return bev, ((2, 4, 4, 32), BF16)


CASES = {"layer_norm": _layer_norm, "window_attention": _window_attention,
         "stereo_cost": _stereo_cost, "pool_plan": _pool_plan,
         "mghs_pool": _mghs_pool}


def test_every_kernel_is_an_op():
    for name in OPS:
        assert hasattr(torch.ops.dhd_tpu_torch, name), name


@pytest.mark.parametrize("name", OPS)
def test_a_trace_records_the_op_from_shapes_alone(name):
    before = kernel_launches()
    with FakeTensorMode(), mock.patch.object(torch.compiler,
                                             "is_compiling", lambda: True):
        out, (shape, dtype) = CASES[name]()
        assert out.device.type == "cuda"
        assert tuple(out.shape) == shape and out.dtype == dtype
    assert kernel_launches() == before


def test_a_wrong_input_is_refused_before_the_op():
    """The wrappers' shape and dtype checks hold under a trace too."""
    with FakeTensorMode(), mock.patch.object(torch.compiler,
                                             "is_compiling", lambda: True):
        with pytest.raises(ValueError, match="weight"):
            O.fused_layer_norm_cuda(_empty(10, 64, dtype=BF16), _empty(32),
                                    _empty(64))
        prev = _empty(6, 16, 44, 64, dtype=BF16)
        with pytest.raises(ValueError, match="uf"):
            O.stereo_cost_volume_cuda(prev, prev, _empty(6, 8, 16, 40),
                                      _empty(6, 8, 16, 44))
