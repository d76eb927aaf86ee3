"""DHD-L training in the port on the CPU: the train step of the tiny
DHD-L-shaped configuration (tests/test_torch_dhd_l.py: Swin-B-shaped
backbone with block remat, FPN_LSS neck, stereo cost volume, one history
frame) against JAX's ``make_train_step``, with and without the history
frames, in fp32 and in float64 (tests/torch_train_ref.py says what is
compared and how closely); the Swin's DropPath against JAX's; remat with
DropPath on; and the history frames run without autograd.

JAX's config has no DropPath rate (its Swin draws at 0.1 from flax's rng),
so the parity steps turn DropPath off in both packages
(``torch_train_ref.no_drop_path``, ``drop_path_off``).
"""
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_train_ref as R
from dhd_tpu.nn import swin as j_swin
from dhd_tpu_torch.models import build_model
from dhd_tpu_torch.nn.swin import DropPath, SwinTransformer

PRESET = "tiny_dhd_l"
CASES = (True, False)

# readings, tiny_dhd_l fp32 port vs JAX (``python tests/torch_train_ref.py
# tiny_dhd_l``): with history grad 4.7e-3 / 9.5e-3 / 2.9e-2, nu 7.8e-4 /
# 1.1e-2 / 5.1e-2, grad_norm 6.2e-5; without 1.1e-2 / 9.8e-3 / 2.6e-2, nu
# 1.3e-2 / 1.2e-2 / 3.6e-2, grad_norm 1.4e-3.  Bars about 3x.
FP32_BARS = {
    True: {"grad": (1.5e-2, 3e-2, 0.1), "nu": (3e-3, 3e-2, 0.15),
           "grad_norm": 2e-4},
    False: {"grad": (3e-2, 3e-2, 0.1), "nu": (4e-2, 4e-2, 0.12),
            "grad_norm": 5e-3},
}


@pytest.fixture(scope="module")
def tiny():
    """JAX's step for each ``with_prev`` (one init, each step compiled
    once) and the port's, from the same weights and batch."""
    batch = R.train_batch(PRESET)
    init, after = R.jax_steps(PRESET, batch, CASES)
    runs = {p: R.port_step(PRESET, init, batch, with_prev=p) for p in CASES}
    return R.port_cfg(PRESET), init, after, runs, batch


@pytest.mark.parametrize("with_prev", CASES)
def test_losses_match_jax(tiny, with_prev):
    _, _, after, runs, _ = tiny
    metrics = runs[with_prev][3]
    assert "loss_depth" in metrics
    R.check_losses(metrics, after[with_prev]["metrics"])


@pytest.mark.parametrize("with_prev", CASES)
def test_gradients_and_grad_norm_match_jax(tiny, with_prev):
    cfg, _, after, runs, _ = tiny
    model, _, _, metrics = runs[with_prev]
    R.check_gradients(cfg, model, after[with_prev], metrics,
                      FP32_BARS[with_prev])


@pytest.mark.parametrize("with_prev", CASES)
def test_bn_running_stats_match_jax(tiny, with_prev):
    """FPN_LSS's and the view transformer's BatchNorms step once per
    processed frame (the history frame under no_grad included)."""
    cfg, _, after, runs, _ = tiny
    R.check_bn_stats(cfg, runs[with_prev][0], after[with_prev])


@pytest.mark.parametrize("with_prev", CASES)
def test_adam_moments_match_jax(tiny, with_prev):
    cfg, _, after, runs, _ = tiny
    model, opt, _, _ = runs[with_prev]
    R.check_moments(cfg, model, opt, after[with_prev], FP32_BARS[with_prev])


@pytest.mark.parametrize("with_prev", CASES)
def test_params_and_ema_match_jax(tiny, with_prev):
    cfg, init, after, runs, _ = tiny
    model, _, ema, _ = runs[with_prev]
    R.check_params(cfg, model, after[with_prev], init)
    R.check_ema(cfg, ema, after[with_prev])


def test_fp64_step_matches_jax_per_element(tiny):
    """Both whole steps with the history frame in float64 with no fp32
    stage, at the full learning rate: gradients, moments, running
    statistics, params and EMA element by element
    (tests/torch_train_ref.py)."""
    cfg, init, _, _, batch = tiny
    after, port = R.fp64_steps(PRESET, init, batch)[True]
    R.check_fp64_step(R.full_rate(cfg), init, port, after)


def _swin(rate, remat=False, depths=(2, 2)):
    """A small Swin (embed 16, window 4) with seeded weights, in train
    mode."""
    torch.manual_seed(0)
    return SwinTransformer(16, depths, (2, 4, 8, 16)[:len(depths)], 4, (1,),
                           drop_path_rate=rate, remat=remat)


def test_drop_path_rates_match_jax():
    """Swin-B's 24 blocks drop at JAX's rates, 0.1 * i / 23
    (dhd_tpu/nn/swin.py:338-339), dp1 and dp2 alike."""
    seen = []

    def record(self, x, train=False):
        seen.append(self.rate)
        return x
    depths = (2, 2, 18, 2)
    fl = j_swin.SwinTransformer(embed_dims=16, depths=depths,
                                num_heads=(1, 2, 4, 8), window_size=4,
                                out_indices=(2, 3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_swin.DropPath, "__call__", record)
        jax.eval_shape(fl.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 64, 64, 3)))
    mod = SwinTransformer(16, depths, (1, 2, 4, 8), 4, (2, 3))
    got = [dp.rate for stage in mod.stages for blk in stage.blocks
           for dp in (blk.dp1, blk.dp2)]
    assert len(got) == len(seen) == 48
    assert got == seen
    assert got[-1] == 0.1 and got[0] == 0.0


def test_drop_path_keeps_or_drops_whole_images():
    """In training, one mask per image of the folded batch, drawn from the
    call's generator: each image's branch is 0 or x / keep; the
    generator steps once per draw."""
    dp = DropPath(0.4).train()
    x = torch.randn(64, 10, 8, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    mask = dp.draw(x, gen)
    want = torch.rand((64, 1, 1), generator=torch.Generator()
                      .manual_seed(2)) < 0.6
    assert mask.shape == (64, 1, 1) and torch.equal(mask, want)
    y = dp(x, mask)
    kept = mask[:, 0, 0]
    assert 0 < int(kept.sum()) < 64
    assert torch.equal(y[~kept], torch.zeros_like(y[~kept]))
    assert torch.equal(y[kept], x[kept] / 0.6)


@pytest.mark.parametrize("rate,train", [(0.4, False), (0.0, True)])
def test_drop_path_is_the_identity_in_eval_and_at_rate_zero(rate, train):
    mod = _swin(rate).train(train)
    x = torch.randn(2, 3, 32, 48, generator=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    assert all(dp.draw(x, gen) is None for dp in mod.modules()
               if isinstance(dp, DropPath))
    with torch.no_grad():
        got = mod(x, generator=gen)
        mod.eval()
        want = mod(x)
    assert torch.equal(gen.get_state(), state)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _grads_and_state(mod, x, r, seed):
    gen = torch.Generator().manual_seed(seed)
    out = mod(x, generator=gen)
    sum((o * w).sum() for o, w in zip(out, r)).backward()
    return ({k: p.grad.clone() for k, p in mod.named_parameters()},
            gen.get_state())


def test_remat_with_drop_path_gives_the_gradients_of_no_remat():
    """At rate 0.5 the rematerialised blocks' recomputation reuses the
    masks of the forward: the gradients equal those without remat within
    1e-6 of each tensor's peak, and the generator ends in the same state
    (it would step again, and the gradients move, if the recomputation
    drew its own masks)."""
    x = torch.randn(4, 3, 32, 48, generator=torch.Generator().manual_seed(6))
    plain = _swin(0.5)
    rematted = _swin(0.5, remat=True)
    rematted.load_state_dict(plain.state_dict())
    assert all(blk.remat for s in rematted.stages for blk in s.blocks)
    with torch.no_grad():
        r = [torch.randn(o.shape, generator=torch.Generator().manual_seed(7))
             for o in plain(x)]
    want, want_state = _grads_and_state(plain, x, r, 8)
    got, got_state = _grads_and_state(rematted, x, r, 8)
    assert torch.equal(got_state, want_state)
    for k, g in want.items():
        peak = max(float(g.abs().max()), 1e-30)
        assert float((got[k] - g).abs().max()) <= 1e-6 * peak, k
    # the masks dropped some images' branches and kept others'
    gen = torch.Generator().manual_seed(8)
    masks = [dp.draw(x, gen) for dp in plain.modules()
             if isinstance(dp, DropPath) and dp.rate > 0]
    assert len(masks) == 6
    masks = torch.cat([m.flatten() for m in masks])
    assert 0 < int(masks.sum()) < masks.numel()


@pytest.mark.parametrize("remat", [True, False])
def test_backbone_remat_reaches_the_swin(remat):
    import dataclasses
    cfg = dataclasses.replace(R.get_config(PRESET), backbone_remat=remat)
    model = build_model(cfg, device="cpu")
    blocks = [b for s in model.img_backbone.stages for b in s.blocks]
    assert blocks and all(b.remat == remat for b in blocks)
    assert blocks[-1].dp1.rate == 0.1


def test_history_frames_record_no_autograd():
    """In a grad-enabled train-mode F-frame forward only the key frame's
    backbone call records autograd; the history frames' BatchNorms step
    and the DropPath and dropout masks draw as in a forward with no
    autograd at all: the same running statistics and generator state."""
    cfg = R.get_config(PRESET)
    batch = R.train_batch(PRESET, seed=3)
    runs = []
    for grad in (True, False):
        model = build_model(cfg, device="cpu").train()
        seen = []
        model.img_backbone.register_forward_hook(
            lambda m, a, out, seen=seen: seen.append(
                (torch.is_grad_enabled(), m.stages[0].blocks[0].dp1.rate)))
        gen = torch.Generator().manual_seed(11)
        with torch.set_grad_enabled(grad):
            out = model(batch, generator=gen)
        stats = {k: v.clone() for k, v in model.state_dict().items()
                 if "running" in k or "num_batches" in k}
        runs.append((seen, gen.get_state(), stats, out))
    (seen, state, stats, out), (_, state0, stats0, out0) = runs
    # extra stereo reference, history frame, key frame
    assert [g for g, _ in seen] == [False, False, True]
    assert out["occ_logits"].requires_grad
    assert torch.equal(state, state0)
    neck = "img_neck.conv.1.num_batches_tracked"
    assert int(stats[neck]) == 2
    for k, v in stats0.items():
        assert torch.equal(stats[k], v), k
    assert torch.equal(out["occ_logits"].detach(), out0["occ_logits"])
