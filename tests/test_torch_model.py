"""The port's DHDNet (dhd_tpu_torch.models) against the JAX package's, on
the CPU in fp32, with the JAX model's variables converted by
``dhd_tpu_torch.io.load_jax_variables``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhd_tpu import geometry as JG
from dhd_tpu.config import get_config as j_config
from dhd_tpu.data import synthetic_batch as j_batch
from dhd_tpu.models import DHDNet as JDHDNet
from dhd_tpu.models import band_masks_from_height as j_band_masks
from dhd_tpu.models import collapse_z as j_collapse_z
from dhd_tpu_torch import geometry as TG
from dhd_tpu_torch.config import get_config as t_config
from dhd_tpu_torch.data import synthetic_batch as t_batch
from dhd_tpu_torch.io import load_jax_variables
from dhd_tpu_torch.models import (DHDNet, band_masks_from_height,
                                  build_batch_pool_plan, collapse_z)

GEOM = ("sensor2keyego", "intrins", "post_rots", "post_trans", "bda")


def _rel_to_peak(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(1e-3, float(np.abs(b).max()))


@pytest.fixture(scope="module")
def tiny():
    """dhd_tiny at B=2 (two rigs, so pillar ids carry a batch offset):
    JAX init + forward, and the port with the converted variables."""
    batch = j_batch(j_config("dhd_tiny"), batch_size=2, seed=1)
    jmodel = JDHDNet(j_config("dhd_tiny"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), jb)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jb)
    cfg = t_config("dhd_tiny")
    model = DHDNet(cfg, device="cpu")
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, variables),
                       cfg)
    return cfg, batch, model, {k: np.asarray(v) for k, v in want.items()}


def test_synthetic_batch_is_a_copy():
    a = j_batch(j_config("dhd_tiny"), batch_size=2, seed=3)
    b = t_batch(t_config("dhd_tiny"), batch_size=2, seed=3)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)


def test_geometry_matches_jax():
    cfg = t_config("dhd_s")
    vt = cfg.vt
    batch = t_batch(cfg, batch_size=1, seed=2, with_gt=False)
    jf = JG.create_frustum(vt.depth, vt.input_size, vt.downsample, vt.sid)
    tf = TG.create_frustum(vt.depth, vt.input_size, vt.downsample, vt.sid)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    geom = [batch[k] for k in GEOM]
    want = JG.frustum_to_ego(jf, *map(jnp.asarray, geom))
    got = TG.frustum_to_ego(tf, *map(torch.from_numpy, geom))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(
        TG.get_mlp_input(*map(torch.from_numpy, geom)).numpy(),
        np.asarray(JG.get_mlp_input(*map(jnp.asarray, geom))), rtol=1e-6)


def test_band_masks_and_collapse_z_match_jax():
    cfg = t_config("dhd_tiny")
    logits = np.random.default_rng(0).normal(
        0, 1, (2, 4, 4, cfg.vt.num_height_bins)).astype(np.float32)
    prob = torch.softmax(torch.from_numpy(logits), dim=-1)
    np.testing.assert_array_equal(
        band_masks_from_height(prob, cfg.vt).numpy(),
        np.asarray(j_band_masks(jnp.asarray(prob.numpy()),
                                j_config("dhd_tiny").vt)))
    x = np.arange(2 * 2 * 2 * 3 * 4, dtype=np.float32).reshape(2, 2, 2, 3, 4)
    np.testing.assert_array_equal(collapse_z(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_collapse_z(jnp.asarray(x))))


@pytest.mark.parametrize("key", ["occ_logits", "occ_logits_flat", "depth",
                                 "height"])
def test_dhdnet_tiny_matches_jax(tiny, key):
    """Same weights, same images and rigs: every output within 2e-4 of the
    JAX output's peak.  Both sides compute the frustum geometry in fp32 with
    the same op order; a point moved across a voxel boundary by round-off
    would change the pooled grid by a whole point and fail this bound."""
    cfg, batch, model, want = tiny
    got = model(batch)[key].numpy()
    assert got.shape == want[key].shape
    assert _rel_to_peak(got, want[key]) < 2e-4


def test_cached_plan_equals_no_plan(tiny):
    """The serving mode: a plan built once from the rig gives the output of
    the per-frame path (plain pooling over sorted vs unsorted points)."""
    cfg, batch, model, _ = tiny
    plan = build_batch_pool_plan(cfg, batch, device="cpu")
    with_plan = model(dict(batch, pool_plan=plan))["occ_logits"]
    np.testing.assert_allclose(with_plan.numpy(),
                               model(batch)["occ_logits"].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_dhd_s_key_space_is_the_rule_table():
    """DHD-S's structure (ResNet-50, the (1024, 2048) FPN, HeightNet with
    ASPP + DCN, three slab UNets) at a narrow UNet width: every module of
    the port's DHDNet is reached by one rule of the converter, and every
    rule names a module with weights, so ``load_jax_variables`` loads a
    DHD-S checkpoint with ``strict=True``."""
    import dataclasses

    from dhd_tpu_torch.io import build_rules

    cfg = dataclasses.replace(t_config("dhd_s"), unet_base=4)
    model = DHDNet(cfg, device="cpu")
    modules = {k.rsplit(".", 1)[0] for k in model.state_dict()}
    prefixes = [tp for tp, _, _ in build_rules(cfg)]
    assert len(prefixes) == len(set(prefixes))
    assert modules == set(prefixes)
    # the rule table's flax side names the JAX modules of the same preset
    flax_roots = {fp[0] for _, fp, _ in build_rules(cfg)}
    assert flax_roots == {"img_encoder", "vt", "bev_encoder", "sfa",
                          "occ_head", "voxel_encoder0", "voxel_encoder1",
                          "voxel_encoder2"}


def test_entry_points_raise_without_gpu(monkeypatch):
    """Without ``device`` the port runs on the GPU; with none present it
    raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_config("dhd_tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DHDNet(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_batch_pool_plan(cfg, t_batch(cfg, with_gt=False))
