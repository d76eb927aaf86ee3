"""The kernels as ``torch.library`` custom ops (``dhd_tpu_torch::``), on
the CPU: under a trace (``torch.compiler.is_compiling``) each wrapper's
card path checks its fake CUDA inputs without reading their memory and
records its op, whose registered fake gives the kernel's output shapes
and dtypes from the input shapes alone; no launch is counted.  The card
runs the ops' implementations in exported programs
(tests/test_torch_card_serve.py)."""
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
       "layer_norm", "unet_bn_relu", "unet_up_place", "swin_window_norm",
       "swin_residual_norm")


def _empty(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="cuda")


def _nhwc(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="cuda",
                       memory_format=torch.channels_last)


def _unet_bn_relu():
    cat = _nhwc(1, 128, 25, 25)
    out, pooled = O.bn_relu_cuda(_nhwc(1, 64, 25, 25), *[_empty(64)] * 4,
                                 1e-5, out=cat, pool=True)
    assert out is cat and pooled.is_contiguous(
        memory_format=torch.channels_last)
    return pooled, ((1, 64, 12, 12), BF16)


def _unet_up_place():
    cat = _nhwc(1, 128, 25, 25)
    assert O.up_place_cuda(_nhwc(1, 64, 24, 24), _empty(64, dtype=BF16),
                           cat) is cat
    return cat, ((1, 128, 25, 25), BF16)


def _layer_norm():
    return O.fused_layer_norm_cuda(_empty(10, 64, dtype=BF16), _empty(64),
                                   _empty(64)), ((10, 64), BF16)


def _swin_window_norm():
    # DHD-L's stage 3: 16 x 44 tokens padded to 24 x 48, windows of 12
    return O.swin_window_norm_cuda(
        _empty(6, 16 * 44, 1024, dtype=BF16), _empty(1024), _empty(1024),
        1e-6, (16, 44), 12, 6), ((6 * 24 * 48, 1024), BF16)


def _swin_residual_norm():
    x = _empty(6, 16 * 44, 1024, dtype=BF16)
    s, y = O.swin_residual_norm_cuda(
        x, _empty(6 * 8, 144, 1024, dtype=BF16), _empty(1024), _empty(1024),
        1e-6, (16, 44), 12, 6)
    assert s.shape == x.shape and s.dtype == BF16
    return y, ((6, 16 * 44, 1024), BF16)


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
         "mghs_pool": _mghs_pool, "unet_bn_relu": _unet_bn_relu,
         "unet_up_place": _unet_up_place,
         "swin_window_norm": _swin_window_norm,
         "swin_residual_norm": _swin_residual_norm}


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
        with pytest.raises(ValueError, match="channels-last"):
            O.bn_relu_cuda(_empty(1, 64, 25, 25, dtype=BF16),
                           *[_empty(64)] * 4, 1e-5)
        with pytest.raises(ValueError, match="out"):
            O.bn_relu_cuda(_nhwc(1, 64, 25, 25), *[_empty(64)] * 4, 1e-5,
                           out=_nhwc(1, 32, 25, 25))
        with pytest.raises(ValueError, match="out"):
            O.up_place_cuda(_nhwc(1, 64, 24, 24), _empty(64, dtype=BF16),
                            _nhwc(1, 128, 23, 23))
        with pytest.raises(ValueError, match="wins"):
            O.swin_residual_norm_cuda(
                _empty(6, 16 * 44, 64, dtype=BF16),
                _empty(6 * 16 * 44, 64, dtype=BF16), _empty(64), _empty(64),
                1e-6, (16, 44), 12, 6)
