"""The port's training pieces on the CPU that need no JAX step: ResNet-50's
remat against the plain forward, the dropout generator, the lr schedule
against JAX's ``make_lr_schedule``, optax's clip rule, AdamW's steps
against optax's, and a checkpoint resume that gives the next step bit
for bit."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhd_tpu.config import OptimConfig as JOptimConfig
from dhd_tpu.train.optim import make_lr_schedule as j_schedule
from dhd_tpu_torch.config import OptimConfig, get_config
from dhd_tpu_torch.data import synthetic_batch
from dhd_tpu_torch.io import load_checkpoint, save_checkpoint
from dhd_tpu_torch.models import build_model
from dhd_tpu_torch.nn import ResNet50
from dhd_tpu_torch.nn.layers import Dropout
from dhd_tpu_torch.train import (AdamWSchedule, ModelEMA, make_lr_schedule,
                                 train_step)

PRESET = "dhd_tiny"


def test_resnet50_remat_on_and_off_agree():
    """ResNet-50 with each bottleneck recomputed in the backward gives the
    outputs, gradients and running statistics of the plain forward, and
    its BatchNorms step once (flax's remat is functional: one step)."""
    torch.manual_seed(0)
    nets = {r: ResNet50((2, 3), remat=r).train() for r in (False, True)}
    nets[True].load_state_dict(nets[False].state_dict())
    x = torch.randn(2, 3, 64, 96)
    got = {}
    for r, net in nets.items():
        xi = x.clone().requires_grad_(True)
        outs = net(xi)
        sum((o * o).mean() for o in outs).backward()
        got[r] = (outs, xi.grad, {k: p.grad for k, p in
                                  net.named_parameters()},
                  net.state_dict())
    for a, b in zip(got[False][0], got[True][0]):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    torch.testing.assert_close(got[True][1], got[False][1], rtol=1e-6,
                               atol=1e-9)
    for k, g in got[False][2].items():
        torch.testing.assert_close(got[True][2][k], g, rtol=1e-6,
                                   atol=1e-9)
    for k, s in got[False][3].items():
        torch.testing.assert_close(got[True][3][k], s, rtol=0, atol=0)
    assert int(got[True][3]["layer1.0.bn1.num_batches_tracked"]) == 1


def test_remat_applies_only_in_training():
    """Served (eval, no grad) the rematted ResNet-50 runs its blocks
    directly; the config's ``backbone_remat`` reaches it."""
    cfg = dataclasses.replace(get_config("dhd_s"), unet_base=4)
    from dhd_tpu_torch.models.dhd import build_image_backbone
    assert build_image_backbone(cfg).remat is True
    net = ResNet50((2, 3), remat=True).eval()
    calls = []
    import dhd_tpu_torch.nn.resnet as resnet_mod
    orig = resnet_mod.remat
    resnet_mod.remat = lambda *a: calls.append(1) or orig(*a)
    try:
        with torch.no_grad():
            net(torch.randn(1, 3, 32, 32))
        assert not calls
        net.train()(torch.randn(1, 3, 32, 32, requires_grad=True))
        assert len(calls) == 16
    finally:
        resnet_mod.remat = orig


def test_dropout_statistics_and_generator():
    """The mask keeps 1 - p of the elements, scaled by 1 / (1 - p); the
    same generator seed gives the same mask, another seed another; eval
    mode is the identity."""
    drop = Dropout(0.5).train()
    x = torch.ones(200_000)
    y = drop(x, torch.Generator().manual_seed(1))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    assert torch.equal(y, drop(x, torch.Generator().manual_seed(1)))
    assert not torch.equal(y, drop(x, torch.Generator().manual_seed(2)))
    assert torch.equal(drop.eval()(x, torch.Generator().manual_seed(1)), x)


def test_model_dropout_follows_the_generator():
    """dhd_tiny with its ASPP dropout of 0.5 in train mode: one generator
    seed reproduces the outputs, another changes them; eval calls are
    deterministic and record no graph."""
    cfg = get_config(PRESET)
    assert cfg.heightnet_cfg.aspp_dropout == 0.5
    model = build_model(cfg, device="cpu")
    batch = synthetic_batch(cfg, batch_size=1, seed=3)

    def height(seed):
        model.train()
        out = model(batch, generator=torch.Generator().manual_seed(seed))
        assert out["height"].requires_grad
        return out["height"].detach()
    h1 = height(5)
    assert torch.equal(h1, height(5))
    assert not torch.equal(h1, height(6))
    model.eval()
    e1, e2 = model(batch), model(batch)
    assert torch.equal(e1["height"], e2["height"])
    assert not any(v.requires_grad for v in e1.values())


@pytest.mark.parametrize("cfg_kw", [{}, {"step_epochs": (2, 3)}],
                         ids=["reference", "two_decays"])
def test_lr_schedule_matches_jax(cfg_kw):
    """mmcv's step policy at the warmup's edges and across each decay
    epoch, against ``make_lr_schedule``; step 0 runs at lr * 0.001."""
    spe = 100
    tcfg = dataclasses.replace(OptimConfig(), **cfg_kw)
    jcfg = dataclasses.replace(JOptimConfig(), **cfg_kw)
    got, want = make_lr_schedule(tcfg, spe), j_schedule(jcfg, spe)
    steps = [0, 1, 199, 200, 201]
    for e in tcfg.step_epochs:
        steps += [e * spe - 1, e * spe, e * spe + 1]
    for s in steps:
        np.testing.assert_allclose(got(s), float(want(jnp.int32(s))),
                                   rtol=1e-6, err_msg=str(s))
    assert got(0) == pytest.approx(2e-7)


def test_clip_keeps_a_small_gradient_and_scales_a_large_one():
    """optax's rule: g * max / |g| only when |g| > max (no 1e-6 added to
    the norm, as ``clip_grad_norm_`` adds)."""
    for scale, norm in ((1.0, 3.0), (4.0, 12.0)):
        p = torch.nn.Parameter(torch.zeros(2))
        opt = AdamWSchedule([p], OptimConfig())
        p.grad = torch.tensor([0.6, 0.8]) * norm
        got = opt.step()
        assert float(got) == pytest.approx(norm)
        want = torch.tensor([0.6, 0.8]) * min(norm, 5.0)
        torch.testing.assert_close(p.grad, want, rtol=1e-6, atol=0)


def test_adamw_steps_match_optax():
    """Four steps of ``AdamWSchedule`` against JAX's ``make_optimizer``
    on the same params and gradients (two gradients over the clip, two
    under), through the warmup into a decay epoch: every param within
    2^-22 of itself plus 1e-10.  A step of the full rate moves a weight
    by ~2e-4 and its weight decay by 2e-6 of the weight."""
    import optax
    from dhd_tpu.train.optim import make_optimizer

    kw = dict(warmup_iters=2, step_epochs=(1,))
    cfg, jcfg = OptimConfig(**kw), JOptimConfig(**kw)
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3, 3, 3), "b": (4,), "g": (5, 7)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    torch_p = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = AdamWSchedule(torch_p.values(), cfg, steps_per_epoch=3)
    tx = make_optimizer(jcfg, steps_per_epoch=3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for step, scale in enumerate((3.0, 0.1, 2.0, 0.2)):
        grads = {k: (scale * rng.normal(0, 1, s)).astype(np.float32)
                 for k, s in shapes.items()}
        for k, p in torch_p.items():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        updates, state = tx.update({k: jnp.asarray(g)
                                    for k, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in torch_p.items():
            want = np.asarray(jp[k], np.float64)
            np.testing.assert_array_less(
                np.abs(p.detach().numpy() - want),
                1e-10 + 2.0 ** -22 * np.abs(want), err_msg=f"step {step} {k}")
    assert opt.count == 4


def _fresh(cfg, seed=0):
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    return (model, AdamWSchedule(model.parameters(), cfg.optim, 4),
            ModelEMA(model, cfg.optim.ema_init_updates, cfg.optim.ema_decay))


def test_checkpoint_resume_is_bit_identical(tmp_path):
    """One step, a save, then the second step on the live objects and on
    a new model, optimiser, EMA and generator loaded from the save: the
    same bits in the metrics, weights, moments and EMA.  dhd_tiny keeps
    its ASPP dropout of 0.5, so the generator's state must come back
    too."""
    cfg = get_config(PRESET)
    batches = [synthetic_batch(cfg, 1, seed=s) for s in (0, 1)]
    model, opt, ema = _fresh(cfg)
    gen = torch.Generator().manual_seed(9)
    train_step(model, opt, ema, batches[0], gen)
    path = tmp_path / "epoch_1.pt"
    save_checkpoint(path, model, opt, ema, step=1, generator=gen)
    want = train_step(model, opt, ema, batches[1], gen)

    model2, opt2, ema2 = _fresh(cfg, seed=123)
    gen2 = torch.Generator().manual_seed(0)
    assert load_checkpoint(path, model2, opt2, ema2, gen2) == 1
    got = train_step(model2, opt2, ema2, batches[1], gen2)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k, v in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k
    for k, v in ema.shadow.items():
        assert torch.equal(ema2.shadow[k], v), k
    assert ema2.updates == ema.updates == cfg.optim.ema_init_updates + 2
    assert opt2.count == opt.count == 2
    s, s2 = opt.state_dict()["adamw"]["state"], \
        opt2.state_dict()["adamw"]["state"]
    for i, st in s.items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s2[i][k], st[k]), (i, k)
