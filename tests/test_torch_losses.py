"""The port's losses (dhd_tpu_torch.losses, train.step.total_loss) against
the JAX package's, on the CPU in fp32: the same numpy inputs through both.

The ground truth is ``synthetic_batch(..., with_gt=True)`` (the port's copy
equals the JAX one, tests/test_torch_model.py); the occupancy logits are
random at DHD-S's head shape, (1, 200, 200, 16 * 18) packed.  Values agree
within rtol 1e-5 and gradients in the logits within 1e-5 of their peak:
the two sides sum the same fp32 terms in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhd_tpu import losses as JL
from dhd_tpu.config import class_weights as j_class_weights
from dhd_tpu.config import get_config as j_config
from dhd_tpu.train.step import total_loss as j_total_loss
from dhd_tpu_torch import losses as TL
from dhd_tpu_torch.config import class_weights, get_config
from dhd_tpu_torch.data import synthetic_batch
from dhd_tpu_torch.train import total_loss

N_CLS, FREE = 18, 17


def _grad_close(got, want, tol=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    assert peak > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * peak)


@pytest.fixture(scope="module")
def gt():
    """dhd_tiny's depth / height GT and DHD-S's voxel GT, seed 0."""
    tiny = synthetic_batch(get_config("dhd_tiny"), batch_size=2, seed=0)
    s = synthetic_batch(get_config("dhd_s"), batch_size=1, seed=0)
    return {"gt_depth": tiny["gt_depth"], "gt_height": tiny["gt_height"],
            "voxel_semantics": s["voxel_semantics"],
            "mask_camera": s["mask_camera"]}


def _logits(seed=0, shape=(1, 200, 200, 16 * N_CLS)):
    return np.random.default_rng(seed).normal(0, 2, shape).astype(
        np.float32)


def test_labels_and_fg_mask_match_jax(gt):
    """Min-pooled GT, shifted one-hot depth (0.5 m, D bins) and height
    labels and the fg mask: the same bits."""
    vt = get_config("dhd_tiny").vt
    args = (vt.downsample, vt.gt_depth, vt.D, vt.height_min,
            vt.height_interval, vt.num_height_bins)
    jvt = j_config("dhd_tiny").vt
    want = JL.depth_height_labels(
        jnp.asarray(gt["gt_depth"]), jnp.asarray(gt["gt_height"]),
        jvt.downsample, jvt.gt_depth, *args[2:])
    got = TL.depth_height_labels(torch.from_numpy(gt["gt_depth"]),
                                 torch.from_numpy(gt["gt_height"]), *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].any() and got[1].sum() > 0
    np.testing.assert_array_equal(
        TL.downsample_min_nonzero(torch.from_numpy(gt["gt_height"]),
                                  vt.downsample).numpy(),
        np.asarray(JL.downsample_min_nonzero(jnp.asarray(gt["gt_height"]),
                                             vt.downsample)))


@pytest.mark.parametrize("flavour", ["depth", "height"])
def test_bce_distribution_loss_and_grad_match_jax(gt, flavour):
    """BCE of a softmaxed distribution against the labels over the fg
    pixels: the value, and its gradient in the probabilities."""
    vt = get_config("dhd_tiny").vt
    d_lab, h_lab, fg = TL.depth_height_labels(
        torch.from_numpy(gt["gt_depth"]), torch.from_numpy(gt["gt_height"]),
        vt.downsample, vt.gt_depth, vt.D, vt.height_min, vt.height_interval,
        vt.num_height_bins)
    labels = d_lab if flavour == "depth" else h_lab
    rng = np.random.default_rng(5)
    prob = torch.softmax(torch.from_numpy(rng.normal(
        0, 3, tuple(labels.shape)).astype(np.float32)), -1).numpy()
    jv, jg = jax.value_and_grad(JL.bce_distribution_loss)(
        jnp.asarray(prob), jnp.asarray(labels.numpy()),
        jnp.asarray(fg.numpy()))
    p = torch.from_numpy(prob).requires_grad_(True)
    v = TL.bce_distribution_loss(p, labels, fg)
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5)
    _grad_close(p.grad.numpy(), jg)


def _occ_cases():
    """name -> (port fn, JAX fn), each (logits, labels, mask, cw) ->
    one scalar; the packed ones take the (1, 200, 200, Dz * n_cls) logits,
    the others the (..., n_cls) view."""
    def pick(i, f):
        return lambda *a: f(*a)[i]
    cases = {
        "ce": (TL.occ_ce_loss, JL.occ_ce_loss),
        "geo": (lambda x, y, m, w: TL.geo_scal_loss(x, y, m, FREE),
                lambda x, y, m, w: JL.geo_scal_loss(x, y, m, FREE)),
        "sem": (lambda x, y, m, w: TL.sem_scal_loss(x, y, m),
                lambda x, y, m, w: JL.sem_scal_loss(x, y, m))}
    for i, name in enumerate(("ce", "geo", "sem")):
        cases[f"fused_{name}"] = (
            pick(i, lambda x, y, m, w: TL.occ_losses_fused(x, y, m, w,
                                                           FREE)),
            pick(i, lambda x, y, m, w: JL.occ_losses_fused(x, y, m, w,
                                                           FREE)))
        cases[f"packed_{name}"] = (
            pick(i, lambda x, y, m, w: TL.occ_losses_fused_packed(
                x, y, m, w, N_CLS, FREE)),
            pick(i, lambda x, y, m, w: JL.occ_losses_fused_packed(
                x, y, m, w, N_CLS, FREE)))
    return cases


OCC = _occ_cases()


def _occ_check(name, logits, labels, mask):
    """The port's loss ``name`` and its gradient in the logits against
    JAX's (jitted ``value_and_grad``)."""
    tfn, jfn = OCC[name]
    if not name.startswith("packed"):
        logits = logits.reshape(logits.shape[:-1] + (-1, N_CLS))
    cw = np.asarray(class_weights(N_CLS), np.float32)
    jv, jg = jax.jit(jax.value_and_grad(jfn))(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
        jnp.asarray(cw))
    x = torch.from_numpy(logits).requires_grad_(True)
    v = tfn(x, torch.from_numpy(labels), torch.from_numpy(mask),
            torch.from_numpy(cw))
    v.backward()
    assert np.isfinite(float(v.detach())) and torch.isfinite(x.grad).all()
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5)
    _grad_close(x.grad.numpy(), jg)
    return x.grad


@pytest.mark.parametrize("name", sorted(OCC))
def test_occ_loss_and_grad_match_jax(gt, name):
    _occ_check(name, _logits(), gt["voxel_semantics"], gt["mask_camera"])


@pytest.mark.parametrize("name", ["packed_geo", "packed_sem", "sem"])
def test_absent_classes_give_finite_gradients(gt, name):
    """Classes 2-9 absent from the visible voxels (sum_t = 0, so their
    recall and the guards' unused branches are 0 / eps): the loss and its
    gradient stay finite and agree with JAX's."""
    labels = gt["voxel_semantics"].copy()
    labels[(labels >= 2) & (labels <= 9)] = FREE
    sem = torch.from_numpy(labels)
    assert not any(bool((sem == c).any()) for c in range(2, 10))
    _occ_check(name, _logits(3), labels, gt["mask_camera"])


@pytest.mark.parametrize("preset", ["dhd_tiny", "dhd_micro_stereo"])
def test_total_loss_matches_jax(preset):
    """The loss dict of random distributions and logits against the
    synthetic GT: DHD-S's family has no loss_depth, the stereo family
    does; every entry within rtol 1e-5, and the gradient of loss_total in
    each input within 1e-5 of its peak."""
    cfg, jcfg = get_config(preset), j_config(preset)
    vt = cfg.vt
    batch = synthetic_batch(cfg, batch_size=2, seed=2)
    rng = np.random.default_rng(7)
    fh, fw = vt.feat_size
    n = cfg.num_cams
    px = (2, n, fh, fw)

    def dist(k):
        return torch.softmax(torch.from_numpy(rng.normal(
            0, 2, px + (k,)).astype(np.float32)), -1).numpy()
    out = {"depth": dist(vt.D), "height": dist(vt.num_height_bins),
           "occ_logits_flat": _logits(
               8, (2, vt.x.size, vt.y.size, cfg.head_Dz * N_CLS))}
    _, jlosses = j_total_loss(jcfg, {k: jnp.asarray(v)
                                     for k, v in out.items()},
                              {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = jax.grad(lambda o: j_total_loss(
        jcfg, o, {k: jnp.asarray(v) for k, v in batch.items()})[0])(
        {k: jnp.asarray(v) for k, v in out.items()})
    tout = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in out.items()}
    total, losses = total_loss(cfg, tout, batch)
    total.backward()
    assert set(losses) == set(jlosses)
    assert ("loss_depth" in losses) == (cfg.depth_net == "full")
    for k, v in losses.items():
        np.testing.assert_allclose(float(v.detach()), float(jlosses[k]),
                                   rtol=1e-5,
                                   err_msg=k)
    for k, t in tout.items():
        if k == "depth" and cfg.depth_net != "full":
            assert t.grad is None
            continue
        _grad_close(t.grad.numpy(), jgrads[k])


def test_class_weights_are_the_jax_packages():
    np.testing.assert_array_equal(
        np.asarray(class_weights(N_CLS), np.float32),
        np.asarray(j_class_weights(N_CLS), np.float32))
