"""int8 post-training quantization in the port (``dhd_tpu_torch.nn.quant``)
against the JAX package's (``dhd_tpu/nn/quant.py``) on the CPU.

The int32 sums of an int8 conv are exact, so on the same int8 inputs the
port's im2col + ``torch._int_mm`` equals JAX's ``conv_general_dilated``
(``preferred_element_type=int32``) bit for bit; a whole int8 conv from
the same float input and amax differs at most by the fp32 dequantization
(within 1e-6 of its peak).  Through dhd_tiny the scales (each conv input's
absmax) lie within 1e-6 relative of JAX's, and the int8 logits, from the
same scales, within the fp32 tolerance the model tests hold (2e-4 of the
peak).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dhd_tpu.config import get_config as j_config
from dhd_tpu.models import build_model as j_build_model
from dhd_tpu.nn.quant import calibrate_int8 as j_calibrate
from dhd_tpu.nn.quant import quantize_fn
from dhd_tpu_torch.config import get_config as t_config
from dhd_tpu_torch.data import synthetic_batch
from dhd_tpu_torch.io import build_rules, load_jax_variables
from dhd_tpu_torch.io.convert import CONV
from dhd_tpu_torch.models import build_model
from dhd_tpu_torch.nn.layers import Conv2d
from dhd_tpu_torch.nn.quant import (DEFAULT_PREFIXES, Int8Conv2d,
                                    calibrate_int8, int8_conv_int32,
                                    int8_conv_int32_plain, quantize_model,
                                    targeted_convs)

J_PREFIXES = ("img_encoder/backbone",)
FP32_PEAK_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: under the test lane's parallel
    workers the models' many small ops otherwise stall on the other
    workers' OpenMP threads (tests/test_torch_eval.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_to_peak(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1e-3, np.abs(b).max()))


class _JNet(fnn.Module):
    """JAX's two-conv test net (tests/test_quant.py)."""
    dtype: jnp.dtype = jnp.bfloat16

    @fnn.compact
    def __call__(self, x):
        x = fnn.Conv(8, (3, 3), strides=2, padding=1, use_bias=False,
                     dtype=self.dtype, name="c1")(x)
        x = fnn.relu(x)
        return fnn.Conv(4, (1, 1), dtype=self.dtype, name="c2")(x)


def _port_net(v):
    """The same net in the port's layers with JAX's weights."""
    c1 = Conv2d(3, 8, 3, 2, 1, bias=False)
    c2 = Conv2d(8, 4, 1)
    p = v["params"]
    with torch.no_grad():
        c1.weight.copy_(torch.from_numpy(np.asarray(
            p["c1"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        c2.weight.copy_(torch.from_numpy(np.asarray(
            p["c2"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        c2.bias.copy_(torch.from_numpy(np.asarray(p["c2"]["bias"]).copy()))

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.c1, self.c2 = c1, c2

        def forward(self, x):
            return self.c2(torch.relu(self.c1(x)))
    return Net()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_conv_matches_fp_small_net(dtype):
    """JAX's two-conv test: the scales of both convs equal JAX's (within a
    bf16 ulp in bf16), the int8 output lies within 3% of the fp output's
    peak, and (fp32) within 1e-6 of JAX's int8 output's peak."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    net = _JNet(jdt)
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 16, 16, 3))
    v = net.init(jax.random.PRNGKey(1), x)
    fp = lambda b: net.apply(v, b)                       # noqa: E731
    j_scales = j_calibrate(fp, [x], prefixes=("c",))
    j_q = np.asarray(jax.jit(quantize_fn(fp, j_scales, ("c",)))(x),
                     np.float32)

    port = _port_net(v).to(tdt)
    xt = torch.from_numpy(np.asarray(x).transpose(0, 3, 1, 2).copy()).to(tdt)
    scales = calibrate_int8(port, [xt], prefixes=("c",))
    assert set(scales) == {"c1", "c2"} == set(j_scales)
    # in bf16 XLA's CPU keeps c1's output in fp32 into the recorded absmax
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for k in scales:
        np.testing.assert_allclose(scales[k].numpy(), j_scales[k],
                                   rtol=rtol)
    q = quantize_model(port, scales, ("c",))
    assert isinstance(q.c1, Int8Conv2d) and not isinstance(port.c1,
                                                           Int8Conv2d)
    with torch.no_grad():
        y, yq = port(xt), q(xt)
    assert yq.dtype == tdt
    y, yq = (t.float().numpy().transpose(0, 2, 3, 1) for t in (y, yq))
    assert np.abs(yq - y).max() / np.abs(y).max() < 0.03
    if dtype == "float32":
        assert _rel_to_peak(yq, j_q) < 1e-6


@pytest.mark.parametrize("shape,stride,padding,dilation", [
    ((2, 5, 9, 11), (1, 1), (1, 1), (1, 1)),       # 3x3, K = 45 padded
    ((1, 16, 12, 10), (2, 2), (0, 0), (1, 1)),     # 1x1 stride 2
    ((1, 3, 21, 17), (2, 2), (3, 3), (1, 1)),      # 7x7 stem
    ((1, 8, 13, 13), (1, 1), (2, 2), (2, 2))])     # dilated 3x3
def test_int32_sums_equal_jax(shape, stride, padding, dilation):
    """int8 x int8 -> int32 on the same inputs: the port's im2col +
    ``torch._int_mm`` equals JAX's conv bit for bit (and the exact float64
    plain version)."""
    rng = np.random.default_rng(sum(shape))
    b, cin, h, w = shape
    k = 7 if padding == (3, 3) else (1 if padding == (0, 0) else 3)
    xq = rng.integers(-127, 128, shape, dtype=np.int8)
    wq = rng.integers(-127, 128, (12, cin, k, k), dtype=np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq.transpose(0, 2, 3, 1)),
        jnp.asarray(wq.transpose(2, 3, 1, 0)), stride,
        [(p, p) for p in padding], rhs_dilation=dilation,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    args = (torch.from_numpy(xq), torch.from_numpy(wq), stride, padding,
            dilation)
    got = int8_conv_int32(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(int8_conv_int32_plain(*args).numpy(),
                                  want)


def test_int8_conv_step_for_step_matches_the_interceptor():
    """One conv with a bias from the same fp32 input, weights and amax:
    JAX's ``int8_interceptor`` and :class:`Int8Conv2d`, within 1e-6 of the
    peak (the int32 sums equal; the dequantization is the same fp32
    arithmetic)."""
    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Conv(16, (3, 3), strides=1, padding=1,
                            name="conv")(x)

    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (2, 10, 10, 6)).astype(np.float32)
    net = Net()
    v = net.init(jax.random.PRNGKey(2), x)
    amax = np.float32(np.abs(x).max() * 0.8)      # some inputs clip
    fp = lambda b: net.apply(v, b)                       # noqa: E731
    want = np.asarray(jax.jit(quantize_fn(fp, {"conv": amax},
                                          ("conv",)))(x))
    assert _rel_to_peak(want, np.asarray(fp(x))) > 1e-3     # int8 ran
    port = Conv2d(6, 16, 3, 1, 1)
    p = v["params"]["conv"]
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.asarray(
            p["kernel"]).transpose(3, 2, 0, 1).copy()))
        port.bias.copy_(torch.from_numpy(np.asarray(p["bias"]).copy()))
    q = Int8Conv2d.from_conv(port, amax)
    with torch.no_grad():
        got = q(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert _rel_to_peak(got.numpy().transpose(0, 2, 3, 1), want) < 1e-6


@pytest.fixture(scope="module")
def tiny():
    """dhd_tiny from JAX's init: JAX's calibration over two batches, the
    port's model with the converted variables, and both int8 forwards
    from JAX's scales."""
    jcfg = j_config("dhd_tiny")
    cfg = t_config("dhd_tiny")
    batches = [synthetic_batch(cfg, 1, seed=s, with_gt=False,
                               varied_rig=True) for s in (1, 2)]
    jbs = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    jmodel = j_build_model(jcfg)
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), jbs[0])

    def logits(v, b):
        return jmodel.apply(v, b, train=False)["occ_logits"]
    j_scales = j_calibrate(logits, jbs, J_PREFIXES, variables=variables)
    j_int8 = np.asarray(jax.jit(quantize_fn(logits, j_scales, J_PREFIXES))(
        variables, jbs[0]))
    model = build_model(cfg, device="cpu")
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, variables),
                       cfg)
    names = {"/".join(fp): tp for tp, fp, kind in build_rules(cfg)
             if kind == CONV}
    return cfg, batches, model, j_scales, j_int8, names


def test_dhd_tiny_scales_equal_jax(tiny):
    """Every backbone conv's scale, over the same two batches, within
    1e-6 relative of JAX's for the same conv (flax paths mapped to the
    port's names by the converter's rule table)."""
    cfg, batches, model, j_scales, _, names = tiny
    scales = calibrate_int8(model, batches)
    assert set(scales) == set(targeted_convs(model, DEFAULT_PREFIXES))
    assert {names[k] for k in j_scales} == set(scales)
    for k, want in j_scales.items():
        np.testing.assert_allclose(scales[names[k]].numpy(), want,
                                   rtol=1e-6, err_msg=k)


def test_dhd_tiny_int8_logits_follow_jax(tiny):
    """The int8 model's logits, from JAX's scales, within the fp32
    tolerance of JAX's ``quantize_fn`` forward."""
    cfg, batches, model, j_scales, j_int8, names = tiny
    q = quantize_model(model, {names[k]: torch.tensor(v)
                               for k, v in j_scales.items()})
    assert sum(isinstance(m, Int8Conv2d) for m in q.modules()) == \
        len(j_scales)
    with torch.no_grad():
        got = q(batches[0])["occ_logits"].numpy()
    assert _rel_to_peak(got, j_int8) < FP32_PEAK_TOL


def test_dhd_tiny_int8_flip_rate_is_small(tiny):
    """The voxel argmax of the int8 model against the fp model's on three
    held-out batches: under 2% flip (JAX's own bound)."""
    cfg, batches, model, _, _, _ = tiny
    q = quantize_model(model, calibrate_int8(model, batches))
    assert q.state_dict().keys() == model.state_dict().keys()
    flips = []
    with torch.no_grad():
        for seed in (11, 12, 13):
            b = synthetic_batch(cfg, 1, seed=seed, with_gt=False)
            flips.append(float((q(b)["occ_logits"].argmax(-1)
                                != model(b)["occ_logits"].argmax(-1))
                               .float().mean()))
    assert max(flips) < 0.02, flips
