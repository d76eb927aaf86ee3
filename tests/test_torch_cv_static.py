"""The rig-static split of the stereo warp plan (dhd_tpu_torch.ops
.build_cv_static, cv_plan_from_static) and the streaming step that serves
with it, against the JAX package's and against the port's stepwise plan,
in fp32 on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhd_tpu.config import GridConfig as JGridConfig
from dhd_tpu.geometry import create_frustum as j_frustum
from dhd_tpu.ops.cost_volume import stereo_cost_volume as j_cost_volume
from dhd_tpu.ops.cost_volume_pallas import build_cv_static as j_static
from dhd_tpu.ops.cost_volume_pallas import cv_plan_from_static as j_plan
from dhd_tpu.ops.cost_volume_pallas import stereo_cost_volume_pallas
from dhd_tpu_torch.config import get_config
from dhd_tpu_torch.data import synthetic_batch
from dhd_tpu_torch.models import (build_model, build_stream_cv_static,
                                  build_stream_pool_plan)
from dhd_tpu_torch.ops import (build_cv_plan, build_cv_static,
                               cv_plan_from_static, stereo_cost_volume)

T = torch.from_numpy
B, N, CS, HS, WS = 1, 2, 8, 16, 48       # tests/test_cost_volume_pallas.py


def _geometry(seed, rot):
    """The rig of tests/test_cost_volume_pallas.py:_geometry: up to ~1 deg
    of yaw and a forward/sideways step between the frames."""
    rng = np.random.default_rng(seed)
    h_img, w_img = HS * 4, WS * 4
    intr = np.zeros((B, N, 3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = w_img * 0.8
    intr[..., 0, 2], intr[..., 1, 2], intr[..., 2, 2] = (w_img / 2.0,
                                                         h_img / 2.0, 1.0)
    post_rots = np.broadcast_to(np.eye(3, dtype=np.float32),
                                (B, N, 3, 3)).copy()
    post_trans = np.zeros((B, N, 3), np.float32)
    k2s = np.broadcast_to(np.eye(4, dtype=np.float32), (B, N, 4, 4)).copy()
    for ni in range(N):
        th = rng.uniform(-0.02, 0.02) if rot else 0.0
        c, s = np.cos(th), np.sin(th)
        k2s[0, ni, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                                      np.float32)
        k2s[0, ni, :3, 3] = rng.uniform(-0.3, 0.3, 3)
    return intr, post_rots, post_trans, k2s


def _case(name):
    """D = 16 bins over 16x48 stereo pixels, bias 5: the geometry of
    tests/test_cost_volume_pallas.py:212-240, with yaw or without, and one
    with an image aug (scale, crop shift) on the rig."""
    intr, post_rots, post_trans, k2s = _geometry(
        9 if name != "yaw" else 7, rot=name == "yaw")
    if name == "aug":
        post_rots[..., :2, :2] *= 0.9
        post_trans[..., :2] = [-6.0, 3.0]
    frustum = np.array(j_frustum(JGridConfig(1.0, 9.0, 0.5),
                                   (HS * 4, WS * 4), 4), np.float32)
    rng = np.random.default_rng(6)
    prev = rng.normal(0, 1, (B, N, HS, WS, CS)).astype(np.float32)
    curr = rng.normal(0, 1, (B, N, HS, WS, CS)).astype(np.float32)
    return prev, curr, frustum, k2s, intr, post_rots, post_trans


def _port_static_plan(case):
    _, _, frustum, k2s, intr, post_rots, post_trans = case
    static = build_cv_static(T(frustum), T(intr), T(post_rots),
                             T(post_trans), HS, WS)
    return cv_plan_from_static(static, T(k2s)), static


def _agree(got, want, share=1e-3, atol=1e-3):
    """uf/vf within ``atol`` grid units where both are valid; validity
    differs on at most ``share`` of the samples."""
    got, want = np.asarray(got), np.asarray(want)
    ok_g, ok_w = got > -1e3, want > -1e3
    assert (ok_g != ok_w).mean() <= share
    both = ok_g & ok_w
    assert both.mean() > 0.3
    np.testing.assert_allclose(got[both], want[both], atol=atol)


@pytest.mark.parametrize("name", ["no_yaw", "yaw", "aug"])
def test_static_plan_matches_jax(name):
    """JAX's (BN, H, T, D, 128) kernel-layout planes, mapped to (BN, D,
    Hs, Ws), against the port's."""
    case = _case(name)
    (uf, vf), _ = _port_static_plan(case)
    _, _, frustum, k2s, intr, post_rots, post_trans = map(jnp.asarray, case)
    js = jax.jit(j_static, static_argnames=("hs", "ws"))(
        frustum, intr, post_rots, post_trans, hs=HS, ws=WS)
    jp = j_plan(js, k2s)
    for got, want in ((uf, jp["uf"]), (vf, jp["vf"])):
        bn, h, t, d, lanes = want.shape
        want = np.transpose(np.asarray(want), (0, 3, 1, 2, 4)).reshape(
            bn, d, h, t * lanes)[..., :WS]
        assert got.shape == want.shape == (B * N, 16, HS, WS)
        _agree(got.numpy(), want)


@pytest.mark.parametrize("name", ["no_yaw", "yaw", "aug"])
def test_static_plan_matches_stepwise_plan(name):
    """The composed projective plan against the port's stepwise
    build_cv_plan on the same rig."""
    case = _case(name)
    (uf, vf), _ = _port_static_plan(case)
    _, _, frustum, k2s, intr, post_rots, post_trans = case
    su, sv = build_cv_plan(*map(T, (frustum, k2s, intr, post_rots,
                                    post_trans)), HS, WS)
    _agree(uf.numpy(), su.numpy())
    _agree(vf.numpy(), sv.numpy())


@pytest.mark.parametrize("name", ["no_yaw", "yaw"])
def test_cost_volume_with_static_matches_jax(name):
    """stereo_cost_volume(static=...) probabilities against JAX's Pallas
    path with its static plan in interpret mode (atol 2e-3, rtol 1e-3,
    JAX's own bar); method='xla' ignores static and gives the stepwise
    answer bit for bit."""
    case = _case(name)
    (_, static) = _port_static_plan(case)
    jargs = tuple(map(jnp.asarray, case))
    js = jax.jit(j_static, static_argnames=("hs", "ws"))(
        jargs[2], jargs[4], jargs[5], jargs[6], hs=HS, ws=WS)
    want = np.asarray(stereo_cost_volume_pallas(
        *jargs, bias=5.0, win_rows=HS, interpret=True, static=js))
    targs = tuple(map(T, case))
    got = stereo_cost_volume(*targs, bias=5.0, static=static)
    assert got.shape == want.shape == (B, N, 16, HS, WS)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-3)
    oracle = np.asarray(j_cost_volume(*jargs, bias=5.0, method="xla"))
    np.testing.assert_allclose(got.numpy(), oracle, atol=2e-3, rtol=1e-3)
    stepwise = stereo_cost_volume(*targs, bias=5.0, method="xla")
    forced = stereo_cost_volume(*targs, bias=5.0, method="xla",
                                static=static)
    np.testing.assert_array_equal(forced.numpy(), stepwise.numpy())


def _frames(cfg):
    """Two streamed frames of one rig, the ego 0.5 m further in the
    second."""
    rig = synthetic_batch(cfg, batch_size=1, seed=2, with_gt=False)
    first = {k: rig[k][:, 0] for k in ("imgs", "sensor2ego", "ego2global",
                                       "intrins", "post_rots", "post_trans")}
    first["bda"] = rig["bda"]
    second = dict(first, ego2global=first["ego2global"].copy(),
                  imgs=np.random.default_rng(3).normal(
                      0, 1, first["imgs"].shape).astype(np.float32))
    second["ego2global"][..., 0, 3] += 0.5
    return first, second


def test_stream_with_cv_static_matches_without():
    """dhd_micro_stereo in fp32, two streaming steps with the rig's
    cv_static (and pool plan) and without: occ_logits within 1e-4 of the
    peak; the forced plain cost volume ignores cv_static."""
    cfg = get_config("dhd_micro_stereo")
    model = build_model(cfg, device="cpu")
    f1, f2 = _frames(cfg)
    static = build_stream_cv_static(cfg, f1, device="cpu")
    plan = build_stream_pool_plan(cfg, f1, device="cpu")
    assert static["p0"].shape == (2, 3, cfg.vt.D * 8 * 24)
    outs = {}
    for name, extra in (("without", {}),
                        ("with", {"cv_static": static, "pool_plan": plan})):
        _, cache = model(dict(f1, **extra), cache={})
        outs[name] = model(dict(f2, **extra), cache=cache)[0]["occ_logits"]
    want = outs["without"]
    err = float((outs["with"] - want).abs().max() / want.abs().max())
    assert err < 1e-4
    plain = build_model(dataclasses.replace(cfg, cv_method="xla"),
                        device="cpu")
    plain.load_state_dict(model.state_dict())
    _, cache = plain(f1, cache={})
    a = plain(f2, cache=cache)[0]["occ_logits"]
    _, cache = plain(dict(f1, cv_static=static), cache={})
    b = plain(dict(f2, cv_static=static), cache=cache)[0]["occ_logits"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
