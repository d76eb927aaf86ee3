"""The port's F-frame training step of the temporal + stereo model on the
CPU in fp32, against the JAX package: ``dhd_micro_stereo`` (three frames:
the extra stereo reference, one history frame, the key frame), with and
without the history frames (``with_prev``), one whole train step each
against JAX's ``make_train_step`` from the same converted weights and
batch (tests/torch_train_ref.py says what is compared and how closely).
Then the stop-gradients alone: only the key frame's images get a
gradient, as JAX's ``stop_gradient``s on the history frames' grids and
stereo features and the cost volume's on its inputs give.
"""
import numpy as np
import pytest
import torch

import torch_train_ref as R
from dhd_tpu_torch.models import build_model
from dhd_tpu_torch.train import total_loss

PRESET = "dhd_micro_stereo"
CASES = (True, False)


@pytest.fixture(scope="module")
def micro():
    """JAX's step for each ``with_prev`` (one init, each step compiled
    once) and the port's, from the same weights and batch."""
    batch = R.train_batch(PRESET)
    init, after = R.jax_steps(PRESET, batch, CASES)
    runs = {p: R.port_step(PRESET, init, batch, with_prev=p) for p in CASES}
    return R.port_cfg(PRESET), init, after, runs


@pytest.mark.parametrize("with_prev", CASES)
def test_losses_match_jax(micro, with_prev):
    _, _, after, runs = micro
    metrics = runs[with_prev][3]
    assert "loss_depth" in metrics
    R.check_losses(metrics, after[with_prev]["metrics"])


@pytest.mark.parametrize("with_prev", CASES)
def test_gradients_and_grad_norm_match_jax(micro, with_prev):
    cfg, _, after, runs = micro
    model, _, _, metrics = runs[with_prev]
    R.check_gradients(cfg, model, after[with_prev], metrics,
                      R.FP32_BARS[(PRESET, with_prev)])


@pytest.mark.parametrize("with_prev", CASES)
def test_bn_running_stats_match_jax(micro, with_prev):
    """The image encoder's BatchNorms run once per processed frame (three
    with the history, one without), each step from the last, as flax's
    mutable batch_stats do."""
    cfg, _, after, runs = micro
    R.check_bn_stats(cfg, runs[with_prev][0], after[with_prev])


@pytest.mark.parametrize("with_prev", CASES)
def test_adam_moments_match_jax(micro, with_prev):
    cfg, _, after, runs = micro
    model, opt, _, _ = runs[with_prev]
    R.check_moments(cfg, model, opt, after[with_prev],
                    R.FP32_BARS[(PRESET, with_prev)])


@pytest.mark.parametrize("with_prev", CASES)
def test_params_and_ema_match_jax(micro, with_prev):
    cfg, init, after, runs = micro
    model, _, ema, _ = runs[with_prev]
    R.check_params(cfg, model, after[with_prev], init)
    R.check_ema(cfg, ema, after[with_prev])


@pytest.fixture(scope="module")
def micro64(micro):
    """Both packages' fp64 steps per ``with_prev`` case, from the same
    weights and batch as the fp32 ones."""
    return R.fp64_steps(PRESET, micro[1], R.train_batch(PRESET), CASES)


@pytest.mark.parametrize("with_prev", CASES)
def test_fp64_step_matches_jax_per_element(micro, micro64, with_prev):
    """Both whole steps in float64 with no fp32 stage, at the full
    learning rate: gradients, moments, running statistics, params and EMA
    element by element (tests/torch_train_ref.py)."""
    cfg, init = micro[:2]
    after, port = micro64[with_prev]
    R.check_fp64_step(R.full_rate(cfg), init, port, after)


def test_only_the_key_frame_gets_a_gradient():
    """d loss / d images: zero for the extra stereo frame and the history
    frame (their features, grids and the cost volume are detached, as JAX
    stops their gradients), nonzero for the key frame; the cost volume's
    stereo branch still trains through the key frame's features."""
    cfg = R.port_cfg(PRESET)
    batch = R.train_batch(PRESET, seed=3)
    model = build_model(cfg, device="cpu").train()
    imgs = torch.from_numpy(batch["imgs"]).requires_grad_(True)
    total_loss(cfg, model(dict(batch, imgs=imgs)), batch)[0].backward()
    per_frame = imgs.grad.abs().flatten(2).amax(-1).amax(0)   # (F,)
    assert float(per_frame[0]) > 0
    assert float(per_frame[1:].abs().max()) == 0.0
    cv = model.img_view_transformer.depth_net.cost_volumn_net[0].weight
    assert float(cv.grad.abs().max()) > 0
    assert np.isfinite(imgs.grad.numpy()).all()
