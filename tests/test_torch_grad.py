"""Gradients through the port's kernel wrappers on the CPU, against the JAX
package.

Kernels B4 and B5 have no backward: the Swin modules take their plain
versions wherever autograd records the call, as the JAX package runs its
kernels only when ``not train``.  Kernel B1 is an ``autograd.Function``
whose backward mirrors JAX's ``_dual_fused_bwd``; it is held against
``jax.grad`` of the JAX pooling on the same plan (the Pallas kernel in
interpret mode), in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhd_tpu.config import GridConfig as JGrid
from dhd_tpu.config import ViewTransformConfig as JVT
from dhd_tpu.nn.swin import SwinTransformer as JSwinTransformer
from dhd_tpu.ops import build_pool_plan as j_build_plan
from dhd_tpu.ops import compute_pool_indices as j_indices
from dhd_tpu.ops import mghs_pool_pallas as j_pool_pallas
from dhd_tpu_torch import get_config
from dhd_tpu_torch.config import GridConfig as TGrid
from dhd_tpu_torch.config import ViewTransformConfig as TVT
from dhd_tpu_torch.data import synthetic_batch
from dhd_tpu_torch.io import convert as C
from dhd_tpu_torch.models import DHDNet, build_batch_pool_plan
from dhd_tpu_torch.nn import swin as S
from dhd_tpu_torch.ops import (build_pool_plan, compute_pool_indices,
                               layer_norm_plain, mghs_pool, mghs_pool_cuda,
                               window_attention_plain)


def _rel_to_peak(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(1e-3, float(np.abs(b).max()))


# ------------------------------------------------------------ B1 (pooling)

def _tiny_vts():
    """dhd_tiny's view transform (D=11, C=16, fH x fW = 4 x 11, 64 x 64 x
    16 grid) in both packages."""
    t = get_config("dhd_tiny").vt
    grids = {k: getattr(t, k) for k in ("depth", "x", "y", "z_full",
                                        "z_fine")}
    kw = dict(input_size=t.input_size, downsample=t.downsample,
              out_channels=t.out_channels)
    return (JVT(**kw, **{k: JGrid(g.lower, g.upper, g.interval)
                         for k, g in grids.items()}),
            TVT(**kw, **{k: TGrid(g.lower, g.upper, g.interval)
                         for k, g in grids.items()}))


def _pool_inputs(vt, seed, b=1, n=6):
    """Points packed into a 15 x 15-pillar corner of the grid (so pillars
    and voxels sum many points), some above, below and outside it; random
    band gates with every band closed somewhere."""
    rng = np.random.default_rng(seed)
    fh, fw = vt.feat_size
    depth = rng.random((b, n, fh, fw, vt.D)).astype(np.float32)
    feat = rng.normal(0, 1, (b, n, fh, fw, vt.out_channels)).astype(
        np.float32)
    coords = rng.uniform(-3.3, 3.3, (b, n, vt.D, fh, fw, 3)).astype(
        np.float32)
    coords[..., 2] = rng.uniform(-2.0, 6.0, coords[..., 2].shape)
    band = rng.integers(0, 4, (b, n, fh, fw))
    band_mask = np.stack([band == k for k in range(3)], axis=-1).astype(
        np.float32)
    return depth, feat, coords, band_mask


LOSSES = {
    # name: (weight of sum(bev^2), weight of sum(vox^2))
    "both": (1.0, 1.0),
    "bev_only": (1.0, 0.0),
    "vox_only": (0.0, 1.0),
}


@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_mghs_pool_grads_match_jax(loss):
    """The port's B1 backward against ``jax.grad`` of the JAX pooling on
    the same points (its Pallas kernel in interpret mode with its plan):
    d depth and d feat in fp32 within rtol 1e-5 (the sums differ in order
    only).  With one output unused its gradient is None in torch."""
    jvt, tvt = _tiny_vts()
    wb, wv = LOSSES[loss]
    depth, feat, coords, band_mask = _pool_inputs(tvt, seed=21)
    jplan = j_build_plan(j_indices(jnp.asarray(coords), jvt), jvt,
                         np.moveaxis(depth, -1, 2).shape)
    bm = jnp.asarray(band_mask)

    def j_loss(depth_px, feat):
        bev, vox = j_pool_pallas(depth_px, feat, bm, None, jvt,
                                 interpret=True, plan=jplan)
        return wb * jnp.sum(bev ** 2) + wv * jnp.sum(vox ** 2)

    jd, jf = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(depth),
                                              jnp.asarray(feat))

    plan = build_pool_plan(compute_pool_indices(torch.from_numpy(coords),
                                                tvt), tvt,
                           np.moveaxis(depth, -1, 2).shape)
    d = torch.from_numpy(depth).requires_grad_(True)
    f = torch.from_numpy(feat).requires_grad_(True)
    bev, vox = mghs_pool_cuda(d, f, torch.from_numpy(band_mask), plan)
    (wb * (bev ** 2).sum() + wv * (vox ** 2).sum()).backward()
    for got, want in ((d.grad, jd), (f.grad, jf)):
        want = np.asarray(want)
        assert float(np.abs(want).max()) > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_mghs_pool_grads_match_autograd_of_plain():
    """The same gradients as torch's own autograd through the plain
    pooling over unsorted points (``mghs_pool``), which has no plan and no
    ``autograd.Function``; band masks and plan get none."""
    _, vt = _tiny_vts()
    depth, feat, coords, band_mask = _pool_inputs(vt, seed=22)
    idx = compute_pool_indices(torch.from_numpy(coords), vt)
    plan = build_pool_plan(idx, vt, np.moveaxis(depth, -1, 2).shape)
    rng = np.random.default_rng(23)
    grads = []
    for use_plan in (True, False):
        d = torch.from_numpy(depth).requires_grad_(True)
        f = torch.from_numpy(feat).requires_grad_(True)
        bm = torch.from_numpy(band_mask).requires_grad_(True)
        if use_plan:
            bev, vox = mghs_pool_cuda(d, f, bm, plan)
        else:
            bev, vox = mghs_pool(d.permute(0, 1, 4, 2, 3), f, bm, idx, vt)
        r_bev = torch.from_numpy(rng.normal(0, 1, bev.shape).astype(
            np.float32)) if use_plan else grads[0][2]
        r_vox = torch.from_numpy(rng.normal(0, 1, vox.shape).astype(
            np.float32)) if use_plan else grads[0][3]
        ((bev * r_bev).sum() + (vox * r_vox).sum()).backward()
        grads.append((d.grad, f.grad, r_bev, r_vox, bm.grad))
    (dp, fp, _, _, bmp), (dx, fx, _, _, _) = grads
    assert bmp is None
    torch.testing.assert_close(dp, dx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fp, fx, rtol=1e-5, atol=1e-5)


def test_mghs_pool_without_grad_records_nothing():
    """Under no_grad (serving) the wrapper returns plain tensors: no graph,
    no saved inputs."""
    _, vt = _tiny_vts()
    depth, feat, coords, band_mask = _pool_inputs(vt, seed=24)
    plan = build_pool_plan(compute_pool_indices(torch.from_numpy(coords),
                                                vt), vt,
                           np.moveaxis(depth, -1, 2).shape)
    d = torch.from_numpy(depth).requires_grad_(True)
    with torch.no_grad():
        bev, vox = mghs_pool_cuda(d, torch.from_numpy(feat),
                                  torch.from_numpy(band_mask), plan)
    assert bev.grad_fn is None and vox.grad_fn is None
    bev, _ = mghs_pool_cuda(d, torch.from_numpy(feat),
                            torch.from_numpy(band_mask), plan)
    assert bev.grad_fn is not None


def test_view_transformer_grads_with_and_without_plan():
    """dhd_tiny's view transformer under autograd: with the cached plan
    (B1's ``autograd.Function``) and without it (the plain pooling over
    unsorted points) the image features and every parameter get the same
    gradients."""
    cfg = get_config("dhd_tiny")
    model = DHDNet(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    vt_mod = model.img_view_transformer
    batch = synthetic_batch(cfg, batch_size=1, seed=6, with_gt=False)
    geom = model._geom(batch)
    plan = build_batch_pool_plan(cfg, batch, device="cpu")
    fh, fw = cfg.vt.feat_size
    x0 = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, (1, cfg.num_cams, cfg.vt.in_channels, fh, fw)).astype(
            np.float32))
    grads = []
    for p in (plan, None):
        model.zero_grad()
        x = x0.clone().requires_grad_(True)
        out = vt_mod(x, geom, p)
        (out["bev"].square().sum() + out["vox"].square().sum()).backward()
        grads.append([x.grad] + [q.grad for q in vt_mod.parameters()])
    assert float(grads[0][0].abs().max()) > 0
    n_grads = 0
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is not None:
            n_grads += 1
            assert _rel_to_peak(a.numpy(), b.numpy()) < 1e-5
    assert n_grads > 2


# --------------------------------------------------------- B4, B5 (Swin)

@pytest.fixture
def spies(monkeypatch):
    """Count the calls of the B4 and B5 wrappers that the Swin modules
    make (each spy runs the plain version, as the wrapper does on the
    CPU)."""
    calls = {"attn": 0, "ln": 0}

    def attn(*args):
        calls["attn"] += 1
        return window_attention_plain(*args)

    def ln(*args):
        calls["ln"] += 1
        return layer_norm_plain(*args)

    monkeypatch.setattr(S, "window_attention_cuda", attn)
    monkeypatch.setattr(S, "fused_layer_norm_cuda", ln)
    return calls


@pytest.mark.parametrize("mode,want_kernel", [
    ("train", False),          # grad mode on, parameters require grad
    ("input_grad", False),     # parameters frozen, the input requires grad
    ("frozen", True),          # grad mode on, nothing requires grad
    ("no_grad", True)])        # serving: the kernels
def test_swin_kernels_only_without_grad(spies, mode, want_kernel):
    """The Swin calls the kernel wrappers only where autograd records
    nothing, and then for every window attention and LayerNorm."""
    mod = S.SwinTransformer(16, (2, 2), (2, 4), 4, (1,))
    x = torch.randn(1, 3, 32, 48, generator=torch.Generator().manual_seed(1))
    if mode != "train":
        mod.requires_grad_(False)
    if mode == "input_grad":
        x.requires_grad_(True)
    with torch.no_grad() if mode == "no_grad" else torch.enable_grad():
        out = mod(x)
    if want_kernel:
        assert spies == {"attn": 4, "ln": 1 + 2 * 4 + 1 + 1}
        assert all(o.grad_fn is None for o in out)
    else:
        assert spies == {"attn": 0, "ln": 0}
        sum(o.sum() for o in out).backward()
        grad = (x.grad if mode == "input_grad"
                else mod.stages[0].blocks[0].attn.w_msa.qkv.weight.grad)
        assert grad is not None and float(grad.abs().max()) > 0


def test_swin_grads_match_jax():
    """A small Swin (embed 16, depths (2, 2), window 4) under training:
    every parameter's gradient, the qkv weights' included, against
    ``jax.grad`` of the JAX Swin with ``train=True`` on the same converted
    weights, within 2e-4 of its peak."""
    fl = JSwinTransformer(embed_dims=16, depths=(2, 2), num_heads=(2, 4),
                          out_indices=(1,), window_size=4,
                          return_stereo_feat=True, drop_path_rate=0.0)
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (2, 32, 48, 3)).astype(np.float32)
    variables = jax.jit(fl.init)(jax.random.PRNGKey(3), x)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + rng.normal(
            0, 0.05, a.shape).astype(np.float32), variables["params"])
    outs = fl.apply({"params": params}, x, train=True)
    r = [rng.normal(0, 1, o.shape).astype(np.float32) for o in outs]

    def j_loss(params):
        outs = fl.apply({"params": params}, x, train=True)
        return sum(jnp.sum(o * w) for o, w in zip(outs, r))

    j_grads = jax.jit(jax.grad(j_loss))(params)
    rules = C._swin("m", (), (2, 2), (1,))
    want = {k[2:]: np.asarray(v) for k, v in C.variables_to_state_dict(
        {"params": j_grads}, rules).items()}

    mod = S.SwinTransformer(16, (2, 2), (2, 4), 4, (1,), True,
                            drop_path_rate=0.0)
    mod.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                         for k, v in C.variables_to_state_dict(
                             {"params": params}, rules).items()},
                        strict=True)
    got = mod(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    sum((o.permute(0, 2, 3, 1) * torch.from_numpy(w)).sum()
        for o, w in zip(got, r)).backward()
    named = dict(mod.named_parameters())
    assert "stages.0.blocks.0.attn.w_msa.qkv.weight" in want
    assert set(want) == set(named)
    for name, g in want.items():
        assert named[name].grad is not None, name
        assert _rel_to_peak(named[name].grad.numpy(), g) < 2e-4, name
