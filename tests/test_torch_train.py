"""The port's training path on the CPU in fp32, against the JAX package.

One whole train step of ``dhd_tiny`` (the DHD-S family at a small size,
ASPP dropout off in both packages) from the same converted weights and a
batch with a training batch's variety, against JAX's ``make_train_step``
(tests/torch_train_ref.py says what is compared and how closely); then
the parts held against JAX alone: BatchNorm's train-mode statistics
(flax's biased variance), the DCN HeightNet's gradients, and the eval
step.  tests/test_torch_train_steps.py holds the parts that need no JAX
step.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ref as R
from dhd_tpu.config import DepthNetConfig as JDepthNetConfig
from dhd_tpu.nn.depthnet import HeightNet as JHeightNet
from dhd_tpu_torch.config import DepthNetConfig
from dhd_tpu_torch.io import convert as C
from dhd_tpu_torch.models import build_model
from dhd_tpu_torch.nn import HeightNet
from dhd_tpu_torch.nn.layers import BatchNorm1d, BatchNorm2d
from dhd_tpu_torch.train import eval_step

PRESET = "dhd_tiny"


BARS = R.FP32_BARS[(PRESET, True)]


@pytest.fixture(scope="module")
def tiny():
    """JAX's step (compiled once) and the port's, from the same weights
    and batch."""
    batch = R.train_batch(PRESET)
    init, after = R.jax_steps(PRESET, batch)
    model, opt, ema, metrics = R.port_step(PRESET, init, batch)
    return R.port_cfg(PRESET), init, after[True], model, opt, ema, metrics


def test_losses_match_jax(tiny):
    cfg, _, after, _, _, _, metrics = tiny
    assert "loss_depth" not in metrics
    R.check_losses(metrics, after["metrics"])


def test_gradients_and_grad_norm_match_jax(tiny):
    cfg, _, after, model, _, _, metrics = tiny
    R.check_gradients(cfg, model, after, metrics, BARS)


def test_bn_running_stats_match_jax(tiny):
    """flax steps the running variance with the biased batch variance:
    the camera embedding's BN sees 12 rows at B=2, where torch's own
    unbiased step would be 12/11 of it."""
    cfg, _, after, model, _, _, _ = tiny
    R.check_bn_stats(cfg, model, after)


def test_adam_moments_match_jax(tiny):
    cfg, _, after, model, opt, _, _ = tiny
    R.check_moments(cfg, model, opt, after, BARS)
    assert opt.count == 1


def test_params_match_jax(tiny):
    cfg, init, after, model, _, _, _ = tiny
    R.check_params(cfg, model, after, init)


def test_ema_matches_jax(tiny):
    cfg, _, after, _, _, ema, _ = tiny
    R.check_ema(cfg, ema, after)


def test_fp64_step_matches_jax_per_element(tiny):
    """Both whole steps in float64 with no fp32 stage, at the full
    learning rate: gradients, moments, running statistics, params and EMA
    element by element (tests/torch_train_ref.py)."""
    cfg, init = tiny[:2]
    batch = R.train_batch(PRESET)
    after, port = R.fp64_steps(PRESET, init, batch)[True]
    R.check_fp64_step(R.full_rate(cfg), init, port, after)


# ------------------------------------------------------- modules alone

@pytest.mark.parametrize("rows,shape", [(6, (6, 27)), (1, (1, 27)),
                                        (2, (2, 5, 3, 4)), (1, (1, 5, 1, 1))],
                         ids=["embedding_b1", "one_row", "conv",
                              "one_value_per_channel"])
def test_batchnorm_train_matches_flax(rows, shape):
    """One train-mode call of the port's BatchNorm against flax's
    ``nn.BatchNorm`` as the JAX package builds it (momentum 0.9, eps
    1e-5): output, gradient and the stepped running statistics.  At one
    value per channel torch's own BatchNorm raises; flax gives the bias."""
    rng = np.random.default_rng(rows)
    x = rng.normal(3.0, 2.0, shape).astype(np.float32)
    c = shape[1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 1, c).astype(np.float32)
    mean0 = rng.normal(0, 1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)
    xj = np.moveaxis(x, 1, -1)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}

    def f(x, params):
        y, st = bn.apply({"params": params,
                          "batch_stats": v["batch_stats"]}, x,
                         mutable=["batch_stats"])
        return jnp.sum(y * jnp.cos(y)), (y, st["batch_stats"])
    (_, (yj, stj)), (gx, gp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(xj), v["params"])

    mod = (BatchNorm1d if len(shape) == 2 else BatchNorm2d)(c).train()
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        mod.running_mean.copy_(torch.from_numpy(mean0))
        mod.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = mod(xt)
    (y * torch.cos(y)).sum().backward()
    np.testing.assert_allclose(np.moveaxis(y.detach().numpy(), 1, -1), yj,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mod.running_mean.numpy(), stj["mean"],
                               rtol=1e-6)
    np.testing.assert_allclose(mod.running_var.numpy(), stj["var"],
                               rtol=1e-6)
    for got, want in ((np.moveaxis(xt.grad.numpy(), 1, -1), gx),
                      (mod.weight.grad.numpy(), gp["scale"]),
                      (mod.bias.grad.numpy(), gp["bias"])):
        R._close_to_peak(got, want, 1e-4, "grad")
    if np.prod(shape) // c == 1:
        with pytest.raises(ValueError):
            torch.nn.functional.batch_norm(
                torch.from_numpy(x), None, None, training=True)
    else:
        # the fault this class repairs: torch's own BatchNorm steps the
        # running variance with the unbiased batch variance
        native = (torch.nn.BatchNorm1d(c) if len(shape) == 2
                  else torch.nn.BatchNorm2d(c))
        with torch.no_grad():
            native.running_var.copy_(torch.from_numpy(var0))
        native.train()(torch.from_numpy(x))
        assert not np.allclose(native.running_var.numpy(), stj["var"],
                               rtol=1e-3)


def test_heightnet_dcn_forward_and_grads_match_jax():
    """DHD-S's HeightNet (ASPP and the deformable conv) at a small width
    in train mode, dropout off: the logits, the gradients of a loss in
    every parameter and the input, and the BN statistics, against flax's
    ``jax.grad``.  The offsets are nonzero, so the bilinear sampling's
    gradient in them is exercised."""
    cin, mid, bins = 8, 16, 12
    jcfg = JDepthNetConfig(use_dcn=True, use_aspp=True, aspp_mid_channels=8,
                           aspp_dropout=0.0)
    tcfg = DepthNetConfig(use_dcn=True, use_aspp=True, aspp_mid_channels=8,
                          aspp_dropout=0.0)
    fl = JHeightNet(mid_channels=mid, height_channels=bins, cfg=jcfg)
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (3, 6, 10, cin)).astype(np.float32)
    mlp = rng.normal(0, 1, (3, 27)).astype(np.float32)
    v = jax.jit(lambda r: fl.init(r, x, mlp, None, False))(
        jax.random.PRNGKey(4))
    v = jax.tree_util.tree_map(np.asarray, v)
    off = v["params"]["depth_conv"]["dcn"]["conv_offset"]
    off["kernel"] = rng.normal(0, 0.05, off["kernel"].shape).astype(
        np.float32)
    off["bias"] = rng.normal(0, 0.5, off["bias"].shape).astype(np.float32)
    target = rng.normal(0, 1, (3, 6, 10, bins)).astype(np.float32)

    def loss(params, x):
        y, st = fl.apply({"params": params, "batch_stats": v["batch_stats"]},
                         x, mlp, None, True, mutable=["batch_stats"])
        return jnp.sum((y - target) ** 2), (y, st["batch_stats"])
    (_, (yj, stj)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(v["params"], x)

    rules = C._heightnet("height_net", (), tcfg)
    mod = HeightNet(cin, mid, bins, tcfg)
    sd = C.variables_to_state_dict(v, rules)
    mod.load_state_dict({k.split(".", 1)[1]: torch.from_numpy(np.array(a))
                         for k, a in sd.items()}, strict=True)
    mod.train()
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy()).requires_grad_(True)
    y = mod(xt, torch.from_numpy(mlp))
    ((y - torch.from_numpy(np.moveaxis(target, -1, 1).copy())) ** 2
     ).sum().backward()
    R._close_to_peak(np.moveaxis(y.detach().numpy(), 1, -1), yj, 1e-5, "y")
    R._close_to_peak(np.moveaxis(xt.grad.numpy(), 1, -1), gx, 1e-4, "x")
    want = C.variables_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, gp), "batch_stats": v["batch_stats"]}, rules)
    zero = R.zero_gradient_params(mod)
    assert zero == ["reduce_conv.0.bias"]
    peak = max(float(p.grad.abs().max()) for p in mod.parameters())
    for k, p in mod.named_parameters():
        if k in zero:       # exactly 0: rounding noise on both sides
            assert float(p.grad.abs().max()) <= 1e-6 * peak
            continue
        R._close_to_peak(p.grad.numpy(), want[f"height_net.{k}"], 1e-4, k)
    assert float(mod.depth_conv[4].conv_offset.weight.grad.abs().max()) > 0
    stats = C.variables_to_state_dict({"params": v["params"],
                                       "batch_stats": jax.tree_util.tree_map(
                                           np.asarray, stj)}, rules)
    R.check_running_stats({f"height_net.{k}": b.numpy()
                           for k, b in mod.named_buffers()}, stats)


def test_eval_step_is_uint8_argmax_and_takes_the_ema(tiny):
    """eval_step: argmax of occ_logits as uint8, in eval mode; with the
    EMA it predicts with the EMA's weights and gives the live ones back."""
    cfg, _, _, model, _, ema, _ = tiny
    batch = R.train_batch(PRESET, seed=2, batch_size=1)
    live = {k: v.clone() for k, v in model.state_dict().items()}
    pred = eval_step(model, batch)
    assert pred.dtype == torch.uint8
    assert tuple(pred.shape) == (1, cfg.vt.x.size, cfg.vt.y.size,
                                 cfg.head_Dz)
    assert int(pred.max()) < cfg.num_classes
    assert torch.equal(pred, model(batch)["occ_logits"].argmax(-1).to(
        torch.uint8))
    pred_ema = eval_step(model, batch, ema, use_ema=True)
    shadow = build_model(cfg, device="cpu")
    shadow.load_state_dict(dict(live, **ema.shadow))
    assert torch.equal(pred_ema, shadow(batch)["occ_logits"].argmax(-1).to(
        torch.uint8))
    for k, v in model.state_dict().items():
        assert torch.equal(v, live[k]), k
