"""bf16 mixed-precision training in the port on the CPU: one train step
with the forward in bf16 over fp32 master weights
(``train_step(..., compute_dtype=torch.bfloat16)``) against the JAX
package's ``build_model(cfg, dtype=jnp.bfloat16)`` step from the same
weights and batch, at ``dhd_tiny`` and the tiny DHD-L-shaped
configuration (tests/test_torch_dhd_l.py); every stored tensor fp32; a
bf16 run's checkpoint in an fp32 model; ``cli/train --bf16``.

Two bf16 steps differ by bf16 rounding, which at these random tiny models
moves the gradient far more than fp32 rounding does: JAX's own bf16 step
lies 0.27 (dhd_tiny) and 0.45 (tiny DHD-L) in rel-L2 from its fp32 step,
its median tensor 0.57 and 0.92, and the port's bf16 step lies as far
from JAX's.  The whole step is held to a small multiple of that control,
JAX's bf16 step against its fp32 step (``torch_train_ref.bf16_readings``),
a bound an fp32 forward would meet too.  What tells a bf16 forward from
an fp32 one is the forward layer by layer, before the roundings of many
layers add up (``torch_train_ref.bf16_layer_readings``): there the port's
bf16 activations lie a few hundredths of the control from JAX's, where an
fp32 forward lies the whole control away.  ``python
tests/torch_train_ref.py PRESET bf16`` prints both readings.  The dtypes
are held exactly too: every conv and dense layer computes in bf16, the
fp32 islands stay fp32.
"""
import io
import json

import numpy as np
import pytest
import torch

import torch_train_ref as R
from dhd_tpu_torch.cli.train import main as train_main
from dhd_tpu_torch.io import load_checkpoint, save_checkpoint
from dhd_tpu_torch.models import build_model
from dhd_tpu_torch.nn.layers import Conv2d, ConvTranspose2d, Linear
from dhd_tpu_torch.train import AdamWSchedule, ModelEMA, train_step

PRESETS = ("dhd_tiny", "tiny_dhd_l")
# port (bf16 vs JAX bf16) / control (JAX bf16 vs JAX fp32), readings:
# dhd_tiny losses 7.0e-4 / 3.7e-4, grad_norm 3.6e-3 / 5.2e-3, grad whole
# 0.254 / 0.267, median tensor 0.542 / 0.566; tiny_dhd_l losses 6.8e-4 /
# 7.8e-4, grad_norm 8.3e-3 / 6.7e-3, grad 0.461 / 0.449, 0.918 / 0.920.
# The port may lie this many times the control's distance away.
LOSS_MULT = 4.0
GRAD_MULT = 1.5
# Layer by layer (torch_train_ref.BF16_LAYERS), the rel-L2 distance of the
# port's bf16 output from JAX's as a share of the control's (JAX's bf16
# output against its fp32 one; JAX compiled with XLA's excess precision
# off, each op rounded to its dtype).  Readings: dhd_tiny conv1 1.8e-3,
# bn1 1.9e-2, conv2 3.2e-2, block b0 3.8e-2, block b1 0.156; tiny DHD-L
# patch-embed conv 7.2e-3, its LayerNorm 6.0e-3, norm1 5.9e-3, qkv
# 1.04e-2, window attention (fp32 softmax, proj) 1.89e-2, fc1 2.48e-2.
# An fp32 forward reads 1.0 at every layer; BatchNorm or LayerNorm
# statistics in bf16 read 1.07-1.27 from that layer on, a softmax rounded
# op by op in bf16 0.56 at the attention.  The bars are ~3x the readings.
LAYER_BARS = {
    "img_backbone.b0.conv1": 0.01, "img_backbone.b0.bn1": 0.06,
    "img_backbone.b0.conv2": 0.1, "img_backbone.b0": 0.12,
    "img_backbone.b1": 0.45,
    "img_backbone.patch_embed.projection": 0.025,
    "img_backbone.patch_embed.norm": 0.02,
    "img_backbone.stages.0.blocks.0.norm1": 0.02,
    "img_backbone.stages.0.blocks.0.attn.w_msa.qkv": 0.03,
    "img_backbone.stages.0.blocks.0.attn.w_msa": 0.06,
    "img_backbone.stages.0.blocks.0.ffn.layers.0.0": 0.075}


@pytest.fixture(scope="module", params=PRESETS)
def bf16(request):
    (model, opt, ema, metrics), read, init = R.bf16_readings(request.param)
    return request.param, model, opt, ema, metrics, read, init


@pytest.fixture(scope="module")
def layers(bf16):
    preset, *_, init = bf16
    return R.bf16_layer_readings(preset, init)


def test_bf16_forward_follows_jax_layer_by_layer(layers):
    """The port's bf16 activations against JAX's, layer by layer, within
    LAYER_BARS of the control: the bf16 convs and dense layers, the fp32
    statistics of BatchNorm and LayerNorm and the attention's fp32
    softmax round where flax's do."""
    assert set(layers) <= set(LAYER_BARS)
    for name, r in layers.items():
        assert r["port_share"] <= LAYER_BARS[name], (name, r)


def test_an_fp32_forward_fails_the_layer_bars(layers):
    """The bars can fail: the port's forward in fp32 lies from JAX's bf16
    forward as far as JAX's own fp32 forward does, beyond every bar."""
    for name, r in layers.items():
        assert r["fp32_port_share"] > LAYER_BARS[name], (name, r)


def test_losses_within_the_bf16_control(bf16):
    _, _, _, _, metrics, read, _ = bf16
    assert all(np.isfinite(v) for v in metrics.values())
    port, control = read["port"], read["control"]
    assert port["losses"] <= LOSS_MULT * control["losses"], read
    assert port["grad_norm"] <= LOSS_MULT * control["grad_norm"], read


def test_gradients_within_the_bf16_control(bf16):
    """rel-L2 of the whole gradient and of the median tensor."""
    _, _, _, _, _, read, _ = bf16
    port, control = read["port"]["grad"], read["control"]["grad"]
    assert port[0] <= GRAD_MULT * control[0], read
    assert port[1] <= GRAD_MULT * control[1], read


def test_every_stored_tensor_stays_fp32(bf16):
    """Params, gradients, AdamW's moments, the BN running statistics and
    the EMA are fp32 after a bf16 step; no bf16 copy of a weight is
    kept."""
    _, model, opt, ema, _, _, _ = bf16
    for k, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, k
    for k, b in model.named_buffers():
        assert not b.is_floating_point() or b.dtype == torch.float32, k
    for st in opt.adamw.state.values():
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == \
            torch.float32
    assert len(opt.adamw.state) == len(list(model.parameters()))
    assert all(v.dtype == torch.float32 for v in ema.shadow.values())
    assert model.dtype == torch.float32 and model.compute_dtype is None


def test_bf16_forward_keeps_the_fp32_islands():
    """Inside ``computing_in(bf16)`` every conv and dense layer takes and
    gives bf16 (the images are bf16); the depth and height softmaxes and
    ``occ_logits`` come out fp32, as JAX's (dhd_tpu/models/dhd.py:175-176,
    319); the camera embedding's BatchNorm sees fp32."""
    cfg = R.get_config("tiny_dhd_l")
    model = build_model(cfg, device="cpu").train()
    seen = {}

    def spy(mod, args, out):
        seen.setdefault(type(mod).__name__, set()).add(
            (args[0].dtype, out.dtype))
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
            m.register_forward_hook(spy)
    bn = model.img_view_transformer.depth_net.bn
    bn.register_forward_hook(lambda m, a, o: seen.setdefault(
        "embedding_bn", set()).add((a[0].dtype, o.dtype)))
    with model.computing_in(torch.bfloat16):
        assert model.dtype == torch.bfloat16
        out = model(R.train_batch("tiny_dhd_l", seed=4),
                    generator=torch.Generator().manual_seed(0))
    assert model.dtype == torch.float32
    bf = (torch.bfloat16, torch.bfloat16)
    assert seen["Conv2d"] == seen["Linear"] == seen["ConvTranspose2d"] == {bf}
    assert seen["embedding_bn"] == {(torch.float32, torch.float32)}
    for k in ("depth", "height", "occ_logits", "occ_logits_flat"):
        assert out[k].dtype == torch.float32, k
    assert out["occ_logits"].requires_grad


def test_bf16_checkpoint_loads_into_an_fp32_model(bf16):
    """A bf16 run's checkpoint is an fp32 one: it strict-loads into a new
    model built in fp32, whose weights, moments and EMA equal the run's,
    and that model trains on in bf16."""
    preset, model, opt, ema, _, _, _ = bf16
    cfg = R.port_cfg(preset)
    buf = io.BytesIO()
    save_checkpoint(buf, model, opt, ema, step=opt.count)
    fresh = R.drop_path_off(build_model(cfg, device="cpu"))
    fopt = AdamWSchedule(fresh.parameters(), cfg.optim, R.STEPS_PER_EPOCH)
    fema = ModelEMA(fresh, cfg.optim.ema_init_updates, cfg.optim.ema_decay)
    buf.seek(0)
    assert load_checkpoint(buf, fresh, fopt, fema) == 1
    want = model.state_dict()
    for k, v in fresh.state_dict().items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    for k, v in fema.shadow.items():
        assert torch.equal(v, ema.shadow[k]), k
    metrics = train_step(fresh, fopt, fema, R.train_batch(preset, seed=2),
                         compute_dtype=torch.bfloat16)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert fopt.count == 2


def test_cli_train_bf16_writes_finite_losses(tmp_path):
    """``cli/train --bf16`` trains (it exited 1 before bf16 was ported)."""
    assert train_main(["--preset", "dhd_tiny", "--synthetic", "--steps", "2",
                       "--bf16", "--device", "cpu", "--log-interval", "1",
                       "--work-dir", str(tmp_path)]) == 0
    rows = [json.loads(ln) for ln in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert {"loss_total", "grad_norm"} <= set(rows[0])
