"""The port's temporal + stereo model (dhd_tpu_torch.models.DHDStereoNet)
and its parts against the JAX package's, in fp32 on the CPU, with the JAX
variables converted by ``dhd_tpu_torch.io.load_jax_variables``; and the
fp32 camera-embedding BatchNorm of a bf16 model."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhd_tpu.config import DepthNetConfig as JDepthNetConfig
from dhd_tpu.config import get_config as j_config
from dhd_tpu.data import synthetic_batch as j_batch
from dhd_tpu.io.convert import build_rules as j_build_rules
from dhd_tpu.models import build_model as j_build_model
from dhd_tpu.models.dhd_stereo import prepare_stereo_inputs as j_prepare
from dhd_tpu.models.dhd_stereo import shift_grid as j_shift_grid
from dhd_tpu.nn import DepthNet as JDepthNet
from dhd_tpu.nn import HeightNet as JHeightNet
from dhd_tpu_torch.config import DepthNetConfig
from dhd_tpu_torch.config import get_config as t_config
from dhd_tpu_torch.geometry import get_mlp_input
from dhd_tpu_torch.io import convert as C
from dhd_tpu_torch.io import load_jax_variables
from dhd_tpu_torch.models import (DHDNet, DHDStereoNet, build_model,
                                  build_stream_pool_plan,
                                  prepare_stereo_inputs, shift_grid)
from dhd_tpu_torch.nn import DepthNet

GEOM_KEYS = ("sensor2keyego", "intrins", "post_rots", "post_trans", "bda")
OUT_KEYS = ("occ_logits", "occ_logits_flat", "depth", "height")
STREAM_KEYS = ("imgs", "sensor2ego", "ego2global", "intrins", "post_rots",
               "post_trans")


def _rel_to_peak(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(1e-3, float(np.abs(b).max()))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stream_frames(batch):
    """Two streamed frames from the key frame of a temporal batch, the ego
    0.5 m further along +x in the second."""
    first = {k: batch[k][:, 0] for k in STREAM_KEYS}
    first["bda"] = batch["bda"]
    second = dict(first)
    second["ego2global"] = first["ego2global"].copy()
    second["ego2global"][..., 0, 3] += 0.5
    second["imgs"] = np.random.default_rng(9).normal(
        0, 1, first["imgs"].shape).astype(np.float32)
    return first, second


@pytest.fixture(scope="module")
def micro():
    """dhd_micro_stereo: one jitted JAX init, two streaming steps and the
    F-frame forward with and without the history frames, and with the
    alignment after the view transformation that evaluation turns on for
    temporal presets; the port with the converted variables."""
    cfg_j = j_config("dhd_micro_stereo")
    batch = j_batch(cfg_j, batch_size=1, seed=1, with_gt=False)
    jmodel = j_build_model(cfg_j)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), jb)
    s1, s2 = _stream_frames(batch)
    step = jax.jit(lambda v, b, c: jmodel.apply(v, b, train=False, cache=c))
    out1, cache1 = step(variables, {k: jnp.asarray(v) for k, v in s1.items()},
                        {})
    out2, cache2 = step(variables, {k: jnp.asarray(v) for k, v in s2.items()},
                        cache1)
    frames = jax.jit(lambda v, b, p: jmodel.apply(v, b, train=False,
                                                  with_prev=p),
                     static_argnums=2)
    want = {"stream1": out1, "stream2": out2,
            "frames": frames(variables, jb, True),
            "frames_no_prev": frames(variables, jb, False),
            "cache1": cache1, "cache2": cache2}
    jaavt = j_build_model(dataclasses.replace(
        cfg_j, align_after_view_transformation=True))
    want["frames_aavt"] = jax.jit(
        lambda v, b: jaavt.apply(v, b, train=False))(variables, jb)
    cfg = t_config("dhd_micro_stereo")
    model = build_model(cfg, device="cpu")
    load_jax_variables(model, _np(variables), cfg)
    return cfg, batch, (s1, s2), model, _np(want)


@pytest.fixture(scope="module")
def port_runs(micro):
    cfg, batch, (s1, s2), model, _ = micro
    out1, cache1 = model(s1, cache={})
    out2, cache2 = model(s2, cache=cache1)
    aavt = build_model(dataclasses.replace(
        cfg, align_after_view_transformation=True), device="cpu")
    aavt.load_state_dict(model.state_dict())
    return {"stream1": out1, "stream2": out2,
            "frames": model(batch), "frames_no_prev": model(
                batch, with_prev=False), "frames_aavt": aavt(batch),
            "cache1": cache1, "cache2": cache2}


@pytest.mark.parametrize("run", ["stream1", "stream2", "frames",
                                 "frames_no_prev", "frames_aavt"])
@pytest.mark.parametrize("key", OUT_KEYS)
def test_dhd_stereo_micro_matches_jax(micro, port_runs, run, key):
    """Same weights, images and rigs: every output of both streaming steps
    (the first with a zero cost volume and zero previous grids, the second
    through the cache, the cost volume and the BEV warp) and of the
    F-frame forward, also with the alignment after the view transformation
    (the history ego 0.5 m back), within 2e-4 of the JAX output's peak."""
    want = micro[-1][run][key]
    assert _rel_to_peak(port_runs[run][key].numpy(), want) < 2e-4


@pytest.mark.parametrize("run", ["cache1", "cache2"])
def test_stream_cache_matches_jax(micro, port_runs, run):
    """The same four cache keys with the same layouts and values: stereo
    features (B*N, Hs, Ws, Cs), pre-processed grids, camera->global."""
    want = micro[-1][run]
    got = port_runs[run]
    assert set(got) == set(want) == {"stereo_feat", "bev", "vox",
                                     "cam2global"}
    for k in want:
        assert _rel_to_peak(got[k].numpy(), want[k]) < 2e-4, k


def test_history_changes_the_prediction(port_runs):
    a = port_runs["frames"]["occ_logits"]
    b = port_runs["frames_no_prev"]["occ_logits"]
    assert a.shape == b.shape and not torch.allclose(a, b)


def test_alignment_after_view_transformation_changes_the_prediction(
        port_runs):
    """The eval default warps the history grids: the flag is not a no-op
    on this rig, so its parity test holds something."""
    a = port_runs["frames"]["occ_logits"]
    b = port_runs["frames_aavt"]["occ_logits"]
    assert a.shape == b.shape and not torch.allclose(a, b)


def test_cached_stream_plan_equals_no_plan(micro):
    """The fixed-rig serving mode: one plan from the rig serves every
    frame (the ego moves, the rig does not) and gives the plan-less
    output."""
    cfg, _, (s1, s2), model, _ = micro
    plan = build_stream_pool_plan(cfg, s1, device="cpu")
    ref1, c_ref = model(s1, cache={})
    out1, c_plan = model(dict(s1, pool_plan=plan), cache={})
    ref2, _ = model(s2, cache=c_ref)
    out2, _ = model(dict(s2, pool_plan=plan), cache=c_plan)
    for got, want in ((out1, ref1), (out2, ref2)):
        torch.testing.assert_close(got["occ_logits"], want["occ_logits"],
                                   rtol=1e-5, atol=1e-5)


def test_prepare_stereo_inputs_without_host_transforms():
    """Without the batch's host-fp64 transforms the fp32 composition from
    sensor2ego / ego2global matches JAX's (and the host values)."""
    batch = j_batch(j_config("dhd_micro_stereo"), batch_size=2, seed=5,
                    with_gt=False)
    batch["ego2global"][..., :3, 3] += np.array([1200.0, -800.0, 3.0],
                                                np.float32)
    raw = {k: v for k, v in batch.items()
           if k not in ("sensor2keyego", "curr2adjsensor")}
    s2k, c2a = prepare_stereo_inputs(raw, "cpu")
    js2k, jc2a = j_prepare({k: jnp.asarray(v) for k, v in raw.items()})
    np.testing.assert_allclose(s2k.numpy(), np.asarray(js2k), atol=1e-5)
    np.testing.assert_allclose(c2a.numpy(), np.asarray(jc2a), atol=1e-5)
    host = prepare_stereo_inputs(batch, "cpu")
    np.testing.assert_array_equal(host[0].numpy(), batch["sensor2keyego"])
    np.testing.assert_allclose(c2a.numpy(), batch["curr2adjsensor"],
                               atol=1e-4)


def test_shift_grid_matches_jax():
    cfg = t_config("dhd_m")
    rng = np.random.default_rng(4)
    th = rng.uniform(-0.05, 0.05, 2)
    curr = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    prev = curr.copy()
    prev[:, 0, :2] = np.stack([np.cos(th), -np.sin(th)], -1)
    prev[:, 1, :2] = np.stack([np.sin(th), np.cos(th)], -1)
    prev[:, :3, 3] = rng.uniform(-1, 1, (2, 3))
    bda = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    want = j_shift_grid(200, 200, jnp.asarray(curr), jnp.asarray(prev),
                        jnp.asarray(bda), cfg.vt.x, cfg.vt.y)
    got = shift_grid(200, 200, torch.from_numpy(curr),
                     torch.from_numpy(prev), torch.from_numpy(bda),
                     cfg.vt.x, cfg.vt.y)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _load_module(mod, rules, variables):
    """Strict-load one flax module's variables into a port module whose
    keys are the rules' torch prefixes with the module prefix dropped."""
    sd = C.variables_to_state_dict(_np(variables), rules)
    mod.load_state_dict({k.split(".", 1)[1]: torch.from_numpy(np.array(v))
                         for k, v in sd.items()}, strict=True)
    return mod.eval()


@torch.no_grad()
def test_depthnet_stereo_matches_jax():
    """The full DepthNet as DHD-M configures it (stereo cost-volume branch,
    ASPP with 96->8 mid channels, no DCN), context branch included."""
    cin, mid, ctx, d = 16, 16, 8, 12
    jcfg = JDepthNetConfig(stereo=True, use_dcn=False, aspp_mid_channels=8,
                           bias=5.0)
    tcfg = DepthNetConfig(stereo=True, use_dcn=False, aspp_mid_channels=8,
                          bias=5.0)
    fl = JDepthNet(mid_channels=mid, context_channels=ctx, depth_channels=d,
                   cfg=jcfg)
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (2, 6, 10, cin)).astype(np.float32)
    mlp = rng.normal(0, 1, (2, 27)).astype(np.float32)
    cv = rng.dirichlet(np.ones(d), (2, 24, 40)).astype(np.float32)
    v = jax.jit(fl.init)(jax.random.PRNGKey(3), x, mlp, cv)
    # non-trivial BN statistics on the cost-volume branch and the embedding
    for name in ("cv_bn0", "cv_bn1"):
        st = v["batch_stats"]["depth_conv"][name]
        v["batch_stats"]["depth_conv"][name] = {
            "mean": jnp.asarray(rng.normal(0, 0.1, st["mean"].shape)),
            "var": jnp.asarray(rng.uniform(0.5, 2.0, st["var"].shape))}
    want = np.asarray(fl.apply(v, x, mlp, cv))
    mod = _load_module(DepthNet(cin, mid, ctx, d, tcfg),
                       C._depthnet_full("depth_net", (), tcfg), v)
    got = mod(torch.from_numpy(np.moveaxis(x, -1, 1).copy()),
              torch.from_numpy(mlp),
              torch.from_numpy(np.moveaxis(cv, -1, 1).copy()))
    assert _rel_to_peak(np.moveaxis(got.numpy(), 1, -1), want) < 2e-4
    with pytest.raises(ValueError, match="cost volume"):
        mod(torch.from_numpy(np.moveaxis(x, -1, 1).copy()),
            torch.from_numpy(mlp))


@torch.no_grad()
def test_embedding_bn_stays_fp32_in_a_bf16_model():
    """With trained-like running statistics (mean a fraction of a pixel
    below the embedding's own value, variance 1e-2) the camera-embedding BN
    of a bf16 model must give JAX's fp32 ``mlp_bn`` answer.  The intrinsics
    are ~557 px, where a bf16 step is 4: a bf16 BN is off by tens of
    units."""
    cfg = t_config("dhd_tiny")
    model = DHDNet(cfg, dtype=torch.bfloat16, device="cpu")
    vt_mod = model.img_view_transformer
    bn = vt_mod.height_net.bn
    batch = j_batch(j_config("dhd_tiny"), batch_size=1, seed=2,
                    with_gt=False)
    batch["intrins"][..., 0, 0] = batch["intrins"][..., 1, 1] = 557.3
    batch["intrins"][..., 0, 2] = 351.7
    geom = {k: torch.from_numpy(batch[k]) for k in GEOM_KEYS}
    emb = get_mlp_input(*geom.values()).reshape(-1, 27)
    mean = emb[0] - 0.3
    var = torch.full((27,), 1e-2)
    bn.running_mean.copy_(mean)
    bn.running_var.copy_(var)
    seen = []
    bn.register_forward_hook(lambda m, i, o: seen.append(o))
    fh, fw = cfg.vt.feat_size
    x = torch.randn(1, cfg.num_cams, cfg.vt.in_channels, fh, fw,
                    generator=torch.Generator().manual_seed(0))
    vt_mod(x.to(torch.bfloat16), geom)

    jh = JHeightNet(mid_channels=cfg.vt.in_channels,
                    height_channels=cfg.vt.num_height_bins,
                    cfg=j_config("dhd_tiny").heightnet_cfg)
    xj = np.zeros((emb.shape[0], fh, fw, cfg.vt.in_channels), np.float32)
    v = jax.jit(jh.init)(jax.random.PRNGKey(0), xj, emb.numpy())
    v = dict(v, batch_stats=dict(v["batch_stats"], mlp_bn={
        "mean": jnp.asarray(mean.numpy()), "var": jnp.asarray(var.numpy())}))
    _, inter = jh.apply(v, xj, emb.numpy(), capture_intermediates=True)
    want = np.asarray(inter["intermediates"]["mlp_bn"]["__call__"][0])
    np.testing.assert_allclose(seen[0].float().numpy(), want, rtol=1e-3,
                               atol=5e-3)
    assert bn.weight.dtype == bn.running_mean.dtype == torch.float32
    assert vt_mod.height_net.depth_mlp.fc1.weight.dtype == torch.bfloat16


def test_dhd_m_key_space_is_the_rule_table():
    """DHD-M's structure (ResNet-50 with the stereo stage, stereo DepthNet,
    HeightNet with ASPP + DCN, the UNet BEV encoder, slab UNets over two
    frames, the pre-process nets) at a narrow UNet width: every module of
    the port's DHDStereoNet is reached by one rule, the rule table is the
    JAX package's, and the variables of the JAX model (shapes from an
    abstract init) strict-load."""
    cfg = dataclasses.replace(t_config("dhd_m"), unet_base=4)
    model = DHDStereoNet(cfg, device="cpu")
    modules = {k.rsplit(".", 1)[0] for k in model.state_dict()}
    rules = C.build_rules(cfg)
    assert len({tp for tp, _, _ in rules}) == len(rules)
    assert modules == {tp for tp, _, _ in rules}
    jcfg = dataclasses.replace(j_config("dhd_m"), unet_base=4)
    assert rules == j_build_rules(jcfg)

    s1, _ = _stream_frames(j_batch(jcfg, batch_size=1, with_gt=False))
    shapes = jax.eval_shape(
        lambda b: j_build_model(jcfg).init(jax.random.PRNGKey(0), b,
                                           train=False, cache={}),
        {k: jnp.asarray(v) for k, v in s1.items()})
    variables = jax.tree_util.tree_map(
        lambda s: np.full(s.shape, 0.5, s.dtype), shapes)
    load_jax_variables(model, variables, cfg)
    w = model.pre_process_net_3d.layers[0][0].conv1.weight
    assert bool((w == 0.5).all())


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_config("dhd_micro_stereo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DHDStereoNet(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    s1, _ = _stream_frames(j_batch(j_config("dhd_micro_stereo"),
                                   with_gt=False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_stream_pool_plan(cfg, s1)


def test_model_class_must_match_the_preset():
    with pytest.raises(ValueError, match="DHDStereoNet"):
        DHDNet(t_config("dhd_micro_stereo"), device="cpu")
    with pytest.raises(ValueError, match="DHDNet"):
        DHDStereoNet(t_config("dhd_micro"), device="cpu")
    assert isinstance(build_model(t_config("dhd_micro_stereo"),
                                  device="cpu"), DHDStereoNet)


def test_tiny_stereo_takes_jax_variables():
    """dhd_tiny_stereo's SFA takes the width flax infers (128), not the
    config's unused sfa_in_channels (192): JAX's variables, shapes from
    ``jax.eval_shape``, strict-load into the port's model."""
    cfg_j = j_config("dhd_tiny_stereo")
    batch = {k: jnp.asarray(v) for k, v in j_batch(
        cfg_j, batch_size=1, seed=1, with_gt=False).items()}
    shapes = jax.eval_shape(lambda b: j_build_model(cfg_j).init(
        jax.random.PRNGKey(0), b, train=False), batch)
    cfg = t_config("dhd_tiny_stereo")
    model = build_model(cfg, device="cpu")
    load_jax_variables(model, jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), cfg)
    assert model.mix.mix_shortcut[0].in_channels == 128
