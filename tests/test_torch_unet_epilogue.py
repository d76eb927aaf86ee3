"""The UNet's epilogue kernels (``ops/unet_epilogue.py``) and the path of
``nn/unet.py`` that takes them.

On the CPU: the plain versions are the module chain they replace (eval
BatchNorm, ReLU, max pool, the transposed conv's bias, pad and
concatenation) at every level shape of the UNets DHD-S, DHD-M and DHD-L
run at 200x200, NaNs included; the UNet's kernel path, run on the CPU
through the plain versions, is the modules' forward exactly; which calls
take the kernels.  On the card (``cuda``-marked): the kernels against the
chain bit for bit, per pass and for whole UNets at the three models' slab
shapes, in bf16 and fp32; their launches counted at a graph's capture and
not at its replays; ``cli/export``'s DHD-S program.  No JAX here: on the
GPU machine run ``python -m pytest --noconftest
tests/test_torch_unet_epilogue.py -q``."""
import contextlib

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from dhd_tpu_torch import profiling
from dhd_tpu_torch.config import get_config
from dhd_tpu_torch.nn.layers import BatchNorm2d
from dhd_tpu_torch.nn.unet import UNet, Up
from dhd_tpu_torch.ops.unet_epilogue import (COUNTER, bn_relu_cuda,
                                             bn_relu_plain, up_place_cuda,
                                             up_place_plain)

CL = torch.channels_last
BF16 = torch.bfloat16
# (channels, side) of every BatchNorm of a base-64 UNet at 200x200: the
# encoder's levels, which the decoder's DoubleConvs repeat
LEVELS = [(64, 200), (128, 100), (256, 50), (512, 25), (1024, 12)]
# (channels, side of the transposed conv's output, side of the skip) of
# each Up, 24 -> 25 the odd-size guard; and a pad split 1 above, 2 below
UPS = [(512, 24, 25), (256, 50, 50), (128, 100, 100), (64, 200, 200),
       (8, 8, 11)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test lane's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nhwc(*shape, dtype=torch.float32, device="cpu", seed=0, nan=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    if nan:
        x.view(-1)[::97] = float("nan")
    return x.to(device=device, dtype=dtype).contiguous(memory_format=CL)


def _bn(c, device="cpu", seed=1):
    """An eval BatchNorm whose statistics and affine are drawn away from
    their init."""
    bn = BatchNorm2d(c).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t, lo, hi in ((bn.running_mean, -1.0, 1.0),
                          (bn.running_var, 0.2, 2.0), (bn.weight, 0.5, 1.5),
                          (bn.bias, -0.5, 0.5)):
            t.copy_(torch.empty(c).uniform_(lo, hi, generator=g))
    return bn.to(device)


def _terms(bn):
    return bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps


def _same_bits(a, b):
    """Equal bit for bit, NaN where NaN (a NaN's payload aside)."""
    assert a.shape == b.shape and a.dtype == b.dtype
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    ints = torch.int16 if a.element_size() == 2 else torch.int32
    assert torch.equal(a.view(ints)[~nan], b.view(ints)[~nan])


def _chain(bn, x, pool):
    """The modules' chain: BatchNorm2d, ReLU(inplace), MaxPool2d(2)."""
    y = nn.Sequential(bn, nn.ReLU(inplace=True))(x)
    return y, (nn.MaxPool2d(2)(y) if pool else None)


def _check_bn_relu(fn, x, bn, variant):
    """``fn`` (a plain version or the kernel) against the chain: its own
    output, the skip half of a concatenation buffer, or that with the
    pool."""
    c = x.shape[1]
    want, want_pool = _chain(bn, x.clone(), variant == "slice_pool")
    if variant == "own":
        got, pooled = fn(x, *_terms(bn))
        assert pooled is None and got.is_contiguous(memory_format=CL)
        _same_bits(got, want)
        return
    up_half = _nhwc(x.shape[0], c, *x.shape[2:], dtype=x.dtype,
                    device=x.device, seed=5)
    buf = torch.empty((x.shape[0], 2 * c) + x.shape[2:], dtype=x.dtype,
                      device=x.device, memory_format=CL)
    buf[:, c:] = up_half
    out, pooled = fn(x, *_terms(bn), out=buf, pool=variant == "slice_pool")
    assert out is buf
    _same_bits(buf, torch.cat([want, up_half], dim=1))
    if variant == "slice_pool":
        assert pooled.is_contiguous(memory_format=CL)
        _same_bits(pooled, want_pool)


@pytest.mark.parametrize("variant", ["own", "slice", "slice_pool"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,side", LEVELS, ids=[f"{c}x{s}" for c, s in
                                                LEVELS])
def test_bn_relu_plain_is_the_module_chain(c, side, dtype, variant):
    _check_bn_relu(bn_relu_plain, _nhwc(1, c, side, side, dtype=dtype),
                   _bn(c), variant)


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
def test_nan_propagates_as_the_chain_propagates_it(dtype):
    """A NaN in the conv's output stays NaN through BN, ReLU and the pool
    (over the odd 25 -> 12 level)."""
    x = _nhwc(1, 16, 25, 25, dtype=dtype, nan=True)
    _check_bn_relu(bn_relu_plain, x, _bn(16), "slice_pool")
    got, pooled = bn_relu_plain(x, *_terms(_bn(16)), pool=True)
    assert torch.isnan(got).any() and torch.isnan(pooled).any()


def _up_chain(c, h, side, device="cpu", dtype=torch.float32):
    """An Up of c output channels, its transposed conv's input (2c
    channels at h/2) and the skip; returns the module, both inputs and the
    concatenation the module's own forward builds (taken by a hook on its
    DoubleConv)."""
    up = Up(2 * c, c).eval().to(device=device, dtype=dtype)
    x1 = _nhwc(1, 2 * c, h // 2, h // 2, dtype=dtype, device=device, seed=2)
    x2 = _nhwc(1, c, side, side, dtype=dtype, device=device, seed=3)
    seen = []
    hook = up.conv.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].clone()))
    with torch.no_grad():
        up(x1, x2)
    hook.remove()
    return up, x1, x2, seen[0]


def _place(fn, up, x1, x2):
    """``fn`` (the plain version or the kernel) filling a concatenation
    buffer whose skip half holds x2, from the bias-less transposed conv."""
    c = x2.shape[1]
    buf = torch.empty((1, 2 * c) + x2.shape[2:], dtype=x2.dtype,
                      device=x2.device, memory_format=CL)
    buf[:, :c] = x2
    with torch.no_grad():
        t = F.conv_transpose2d(x1, up.up.weight, None, 2).contiguous(
            memory_format=CL)
        assert fn(t, up.up.bias, buf) is buf
    return buf


@pytest.mark.parametrize("c,h,side", UPS,
                         ids=[f"{c}x{h}to{s}" for c, h, s in UPS])
def test_up_place_plain_is_the_module_chain(c, h, side):
    """fp32: on the CPU a bf16 transposed conv adds its bias inside
    (oneDNN), where cuDNN's chain adds it after as a bf16 add."""
    up, x1, x2, want = _up_chain(c, h, side)
    _same_bits(_place(up_place_plain, up, x1, x2), want)


def _init(m, seed=0):
    """Draw m's BatchNorms' statistics and affine away from their init."""
    for k, bn in enumerate(b for b in m.modules()
                           if isinstance(b, nn.BatchNorm2d)):
        fresh = _bn(bn.num_features, seed=seed + k)
        bn.load_state_dict(fresh.state_dict())
    return m


def test_a_whole_unet_in_eval_matches_the_modules_exactly():
    """The kernel path's control flow (buffers allocated ahead, skips and
    pools written beside each other, the Ups' placements) run on the CPU
    through the plain versions: the modules' forward bit for bit, over the
    200 -> 12 ladder and its 25 -> 12 guard."""
    m = _init(UNet(16, 24, base=8).eval())
    x = _nhwc(1, 16, 200, 200)
    with torch.no_grad():
        _same_bits(m._forward_fused(x), m(x))


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, for the engage rule."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("case,want", [
    ("eval", True), ("cpu", False), ("train", False), ("grad", False),
    ("narrow", False)])
def test_which_calls_take_the_kernels(case, want):
    """Eval on the card where autograd records nothing, at widths the
    kernels take; training, autograd, the CPU and base 4 keep the
    modules."""
    m = UNet(16, 24, base=4 if case == "narrow" else 8)
    m.train(case == "train")
    x = torch.zeros(1, 16, 8, 8)
    if case != "cpu":
        x = x.as_subclass(_OnCard)
    with contextlib.nullcontext() if case == "grad" else torch.no_grad():
        assert m._takes_kernels(x) is want


def test_training_takes_the_plain_path():
    """A train-mode forward normalises with batch statistics and steps the
    running ones, as the modules do, and the kernels count nothing."""
    m = UNet(16, 24, base=8).train()
    before = profiling.kernel_launches()[COUNTER]
    m(_nhwc(2, 16, 16, 16)).sum().backward()
    assert int(m.inc.double_conv[1].num_batches_tracked) == 1
    assert m.inc.double_conv[0].weight.grad is not None
    assert profiling.kernel_launches()[COUNTER] == before


def test_the_wrappers_take_the_plain_versions_on_the_cpu():
    x, bn = _nhwc(1, 16, 9, 9), _bn(16)
    got, pooled = bn_relu_cuda(x, *_terms(bn), pool=True)
    want, want_pool = bn_relu_plain(x, *_terms(bn), pool=True)
    _same_bits(got, want)
    _same_bits(pooled, want_pool)
    up, x1, x2, want = _up_chain(8, 8, 9)
    _same_bits(_place(up_place_cuda, up, x1, x2), want)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ulps(a, b):
    """The most bf16 or fp32 ulps between a and b (NaNs where both are),
    and the share of elements that differ."""
    ints = torch.int16 if a.element_size() == 2 else torch.int32
    nan = torch.isnan(a) & torch.isnan(b)

    def ordered(t):
        i = t.view(ints).to(torch.int64)
        return torch.where(i < 0, -(i & (2 ** (8 * t.element_size() - 1)
                                         - 1)), i)
    d = (ordered(a) - ordered(b)).abs().masked_fill(nan, 0)
    return int(d.max()), float((d > 0).float().mean())


def _report(got, want, what):
    ulps, share = _ulps(got, want)
    print(f"{what}: {ulps} ulps at most, {share:.3e} of the elements "
          f"differ")


def _cudnn_bound(x, bn):
    """What cuDNN's fp32 BatchNorm may differ from PyTorch's own by: four
    fp32 ulps of the magnitudes the output is computed from.  Where x
    lies near the mean the output cancels to a few of its own ulps' worth,
    so a bar in the output's ulps cannot hold."""
    mean, var, weight, bias, eps = _terms(bn)
    scale = (weight * torch.rsqrt(var + eps)).abs().view(1, -1, 1, 1)
    terms = (x.abs() + mean.abs().view(1, -1, 1, 1)) * scale \
        + bias.abs().view(1, -1, 1, 1)
    return 2.0 ** -21 * terms.nan_to_num(0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
def test_the_kernels_match_the_chain_on_the_card(cuda, dtype):
    """Every pass at every level shape of a 200x200 UNet, NaNs among the
    inputs, the pooled variant over the odd 25 -> 12 level; each call
    counted once.  bf16: bit for bit the chain.  fp32: bit for bit
    PyTorch's own BatchNorm (cuDNN off, the arithmetic the kernel repeats);
    the chain's default fp32 BatchNorm is cuDNN's, whose arithmetic is its
    own: held within :func:`_cudnn_bound`, its ulps and share printed."""
    for c, side in LEVELS:
        x = _nhwc(1, c, side, side, dtype=dtype, device=cuda, nan=True)
        bn = _bn(c, cuda)
        for pool in (False, True):
            with torch.backends.cudnn.flags(enabled=False):
                want, want_pool = bn_relu_plain(x, *_terms(bn), pool=pool)
            buf = torch.empty((1, 2 * c, side, side), dtype=dtype,
                              device=cuda, memory_format=CL).zero_()
            before = profiling.kernel_launches()[COUNTER]
            out, pooled = bn_relu_cuda(x, *_terms(bn), out=buf, pool=pool)
            torch.cuda.synchronize()
            assert profiling.kernel_launches()[COUNTER] == before + 1
            _same_bits(out[:, :c], want)
            assert not buf[:, c:].any()
            if pool:
                _same_bits(pooled, want_pool)
            if dtype == torch.float32:
                chain, _ = bn_relu_plain(x, *_terms(bn))
                _report(out[:, :c], chain,
                        f"fp32 {c}x{side} against cuDNN's BatchNorm")
                diff = (out[:, :c] - chain).abs().nan_to_num(0.0)
                assert (diff <= _cudnn_bound(x, bn)).all()
    for c, h, side in UPS:
        up, x1, x2, want = _up_chain(c, h, side, cuda, dtype)
        before = profiling.kernel_launches()[COUNTER]
        _same_bits(_place(up_place_cuda, up, x1, x2), want)
        assert profiling.kernel_launches()[COUNTER] == before + 1


def _unets(preset):
    """The (in, out) channels of each UNet of a preset at its BEV grid."""
    cfg = get_config(preset)
    c_bev = cfg.vt.out_channels * (cfg.num_frames - (1 if cfg.stereo
                                                     else 0))
    shapes = [(s * c_bev, out) for s, out in zip(cfg.vt.slab_sizes,
                                                  cfg.voxel_encoder_out)]
    if cfg.bev_encoder == "unet":
        shapes.append((c_bev, cfg.bev_unet_out))
    return cfg, shapes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("preset", ["dhd_s", "dhd_m", "dhd_l"])
def test_a_unet_matches_the_chain_on_the_card(cuda, preset, dtype):
    """Each slab UNet of the preset (and DHD-M's BEV encoder) at 200x200,
    channels-last as the frame hands it: the kernel path, 22 launches,
    against the modules' chain with the same weights, bit for bit (fp32
    with cuDNN off, whose convs and BatchNorm are then PyTorch's own: with
    cuDNN on the fp32 BatchNorms differ as the pass test shows, and the
    convs carry that on; the difference is printed).  Under autograd the
    UNet keeps the modules."""
    cfg, shapes = _unets(preset)
    side = cfg.vt.x.size
    torch.manual_seed(0)
    for k, (n_in, n_out) in enumerate(shapes):
        m = _init(UNet(n_in, n_out, base=cfg.unet_base), seed=10 * k)
        m = m.eval().to(device=cuda, dtype=dtype)
        x = _nhwc(1, n_in, side, side, dtype=dtype, device=cuda, seed=k)
        with torch.enable_grad():
            assert not m._takes_kernels(x)
        before = profiling.kernel_launches()[COUNTER]
        with torch.no_grad(), (torch.backends.cudnn.flags(enabled=False)
                               if dtype == torch.float32
                               else contextlib.nullcontext()):
            assert m._takes_kernels(x)
            got, want = m(x), m._forward_modules(x)
        torch.cuda.synchronize()
        assert profiling.kernel_launches()[COUNTER] == before + 22
        _same_bits(got, want)
        if dtype == torch.float32:
            with torch.no_grad():
                got, want = m(x), m._forward_modules(x)
            err = float((got - want).abs().max() / want.abs().max())
            print(f"{preset} UNet({n_in}, {n_out}) fp32 with cuDNN: "
                  f"{err:.3e} of the output's peak")
        del m


@pytest.mark.cuda
def test_launches_count_at_capture_not_at_replay(cuda):
    """dhd_tiny (base 8) served from CUDA graphs: its three slab UNets
    launch the kernels in the eager warm-up frame and in the capture, 22
    each, and none in the replays; each replayed frame equals an eager
    frame of the same weights."""
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.models import build_batch_pool_plan, build_model

    cfg = get_config("dhd_tiny")
    served = build_model(cfg, device=cuda,
                         generator=torch.Generator().manual_seed(1))
    eager = build_model(cfg, device=cuda)
    eager.load_state_dict(served.state_dict())
    eager._served = lambda *a, **kw: contextlib.nullcontext()
    batch = synthetic_batch(cfg, 1, seed=0, with_gt=False)
    rng = np.random.default_rng(3)
    frames = []
    for _ in range(5):
        f = {k: torch.as_tensor(v, device=cuda) for k, v in batch.items()}
        f["imgs"] = torch.as_tensor(rng.normal(0, 1, batch["imgs"].shape),
                                    dtype=torch.float32, device=cuda)
        frames.append(f)
    plan = build_batch_pool_plan(cfg, frames[0], device=cuda)
    profiling.reset()
    got = []
    with torch.no_grad():
        for f in frames:
            got.append(served(dict(f, pool_plan=plan))["occ_logits"])
        torch.cuda.synchronize()
        assert profiling.kernel_launches()[COUNTER] == 2 * 3 * 22
        assert profiling.counters()["graph_replays"] > 0
        for g, f in zip(got, frames):
            want = eager(dict(f, pool_plan=plan))["occ_logits"]
            assert (g - want).abs().max() <= 1e-5 * max(
                1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_cli_export_dhd_s_still_runs(cuda, tmp_path):
    """DHD-S exported in bf16 records the kernels as custom ops; the
    program loaded fresh launches them, 66 a frame, and serves the live
    model's classes."""
    from dhd_tpu_torch.cli import export
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.models import build_model

    path = str(tmp_path / "dhd_s.pt2")
    assert export.main(["--preset", "dhd_s", "--out", path, "--bf16"]) == 0
    fn, meta = export.load_program(path)
    cfg = get_config("dhd_s")
    batch = export.batch_inputs(synthetic_batch(cfg, 1, seed=7,
                                                with_gt=False),
                                meta["inputs"], cuda)
    live = build_model(cfg, dtype=BF16, device=cuda)
    profiling.reset()
    with torch.no_grad():
        got = fn(batch)
        torch.cuda.synchronize()
        assert profiling.kernel_launches()[COUNTER] == 66
        want = live(batch)["occ_logits"].argmax(-1).to(torch.uint8)
    assert float((got == want).float().mean()) >= 0.999
