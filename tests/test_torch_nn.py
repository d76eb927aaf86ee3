"""The port's nn modules (dhd_tpu_torch.nn) against the JAX package's flax
modules, in fp32 on the CPU.

Each test initialises the flax module, converts its variables with the
port's own rule table (dhd_tpu_torch.io.convert), loads them into the port
module under the reference's key prefix with ``strict=True``, and compares
activations on the same numpy inputs: max error relative to the output's
peak below 2e-4 (the ``_diff`` of tests/test_oracle_parity.py; what is
left is fp32 summation order between XLA and PyTorch's CPU kernels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dhd_tpu import nn as J
from dhd_tpu.config import DepthNetConfig as JDepthNetConfig
from dhd_tpu_torch import nn as T
from dhd_tpu_torch.config import DepthNetConfig as TDepthNetConfig
from dhd_tpu_torch.io import convert as C


def _diff(a, b, tol=2e-4):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1e-3, float(np.abs(b).max()))
    err = np.abs(a - b).max() / scale
    assert err < tol, f"max rel-to-peak err {err:.2e} (tol {tol})"


def _nest(path, tree):
    for p in reversed(path):
        tree = {p: tree}
    return tree


def _load(mod, prefix, fp, variables, rules):
    """Load flax ``variables`` of one module, converted by ``rules``, into
    the port module ``mod`` placed at ``prefix`` of the reference's key
    space; strict: every key on both sides is used."""
    holder = torch.nn.Module()
    node = holder
    parts = prefix.split(".")
    for p in parts[:-1]:
        node.add_module(p, torch.nn.Module())
        node = getattr(node, p)
    node.add_module(parts[-1], mod)
    wrapped = {"params": _nest(fp, variables["params"]),
               "batch_stats": _nest(fp, variables.get("batch_stats", {}))}
    sd = C.variables_to_state_dict(wrapped, rules)
    holder.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    return mod.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _init(fl, seed, *args):
    variables = jax.jit(fl.init)(jax.random.PRNGKey(seed),
                                 *[jnp.asarray(a) for a in args])
    return jax.tree_util.tree_map(np.asarray, variables)


@torch.no_grad()
def test_resnet50():
    fl = J.ResNet50(out_indices=(2, 3), remat=False)
    x = np.random.default_rng(0).normal(0, 1, (1, 64, 64, 3)
                                        ).astype(np.float32)
    v = _init(fl, 0, x)
    want = jax.jit(fl.apply)(v, jnp.asarray(x))
    mod = _load(T.ResNet50((2, 3)), "img_backbone",
                ("img_encoder", "backbone"), v,
                C._resnet50("img_backbone", ("img_encoder", "backbone")))
    got = mod(_nchw(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _diff(_nhwc(g), w)


@torch.no_grad()
def test_custom_fpn():
    """Top-down nearest resize 6 -> 11 columns: not an integer scale."""
    fl = J.CustomFPN(out_channels=24)
    rng = np.random.default_rng(1)
    feats = [rng.normal(0, 1, (2, 4, 11, 32)).astype(np.float32),
             rng.normal(0, 1, (2, 2, 6, 48)).astype(np.float32)]
    v = jax.tree_util.tree_map(np.asarray, fl.init(
        jax.random.PRNGKey(1), [jnp.asarray(f) for f in feats]))
    want = fl.apply(v, [jnp.asarray(f) for f in feats])
    mod = _load(T.CustomFPN((32, 48), 24), "img_neck",
                ("img_encoder", "neck"), v,
                C._custom_fpn("img_neck", ("img_encoder", "neck"), 2))
    _diff(_nhwc(mod([_nchw(f) for f in feats])), want)


@torch.no_grad()
def test_heightnet_aspp_dcn_nonzero_offsets():
    """HeightNet as DHD-S configures it (ASPP + DCN).  The DCN offset conv
    is zero-initialised, so its kernel is replaced by the same random
    values on both sides to make the sampling positions fractional."""
    cin, mid, bins = 32, 32, 65
    cfg = JDepthNetConfig()
    assert cfg.use_aspp and cfg.use_dcn
    fl = J.HeightNet(mid_channels=mid, height_channels=bins, cfg=cfg)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 8, 12, cin)).astype(np.float32)
    mlp = rng.normal(0, 1, (2, 27)).astype(np.float32)
    v = _init(fl, 2, x, mlp)
    v["params"]["depth_conv"]["dcn"]["conv_offset"]["kernel"] = rng.normal(
        0, 0.3, (3, 3, mid, 18)).astype(np.float32)
    want = fl.apply(v, jnp.asarray(x), jnp.asarray(mlp))
    mod = _load(T.HeightNet(cin, mid, bins, TDepthNetConfig()),
                "img_view_transformer.height_net", ("vt", "height_net"), v,
                C._heightnet("img_view_transformer.height_net",
                             ("vt", "height_net"), TDepthNetConfig()))
    offsets = []
    mod.depth_conv[4].conv_offset.register_forward_hook(
        lambda m, i, o: offsets.append(o))
    _diff(_nhwc(mod(_nchw(x), torch.from_numpy(mlp))), want)
    assert float(offsets[0].abs().max()) > 0.5   # multi-pixel, fractional


@torch.no_grad()
def test_custom_resnet_fpn_lss():
    """The DHD-S BEV encoder: CustomResNet stages + FPN_LSS with the x4
    align-corners upsample and the extra x2 head."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (1, 24, 32, 16)).astype(np.float32)
    ch = (16, 32, 64)

    class FlaxEnc(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            feats = J.CustomResNet(num_channels=ch, name="backbone")(x)
            return J.FPN_LSS(out_channels=24, name="neck")(feats)

    fl = FlaxEnc()
    v = _init(fl, 3, x)
    want = fl.apply(v, jnp.asarray(x))
    fp = ("bev_encoder",)
    v_bb = {k: {"backbone": t["backbone"]} for k, t in v.items()}
    v_nk = {k: {"neck": t["neck"]} for k, t in v.items()}
    bb = _load(T.CustomResNet(16, ch), "img_bev_encoder_backbone", fp, v_bb,
               C._custom_resnet("img_bev_encoder_backbone",
                                fp + ("backbone",), 3))
    nk = _load(T.FPN_LSS(ch[-1] + ch[0], 24), "img_bev_encoder_neck", fp,
               v_nk, C._fpn_lss("img_bev_encoder_neck", fp + ("neck",)))
    _diff(_nhwc(nk(bb(_nchw(x)))), want)


@torch.no_grad()
def test_unet_odd_size():
    """36x44 input: the decoder pads 4 -> 9 rows (the odd-size guard) and
    the ConvTranspose kernels go through the converter's spatial flip."""
    fl = J.UNet(n_classes=24, base=8)
    x = np.random.default_rng(4).normal(0, 1, (1, 36, 44, 20)
                                        ).astype(np.float32)
    v = _init(fl, 4, x)
    want = jax.jit(fl.apply)(v, jnp.asarray(x))
    mod = _load(T.UNet(20, 24, base=8), "img_voxel_encoder0",
                ("voxel_encoder0",), v,
                C._unet("img_voxel_encoder0", ("voxel_encoder0",)))
    _diff(_nhwc(mod(_nchw(x))), want)


@torch.no_grad()
def test_sfa():
    fl = J.SFA(out_channels=24)
    x = np.random.default_rng(5).normal(0, 1, (2, 10, 14, 64)
                                        ).astype(np.float32)
    v = _init(fl, 5, x)
    want = fl.apply(v, jnp.asarray(x))
    mod = _load(T.SFA(64, 24), "mix", ("sfa",), v, C._sfa("mix", ("sfa",)))
    _diff(_nhwc(mod(_nchw(x))), want)


@pytest.mark.parametrize("return_flat", [True, False])
@torch.no_grad()
def test_occ_head(return_flat):
    fl = J.OccHead(out_dim=16, Dz=4, num_classes=5, return_flat=return_flat)
    x = np.random.default_rng(6).normal(0, 1, (2, 6, 8, 32)
                                        ).astype(np.float32)
    v = _init(fl, 6, x)
    want = np.asarray(fl.apply(v, jnp.asarray(x)))
    mod = _load(T.OccHead(32, 16, 4, 5, True, return_flat=return_flat),
                "occ_head", ("occ_head",), v,
                C._occ_head("occ_head", ("occ_head",), True))
    got = mod(_nchw(x)).numpy()
    assert got.shape == want.shape == ((2, 8, 6, 20) if return_flat
                                       else (2, 8, 6, 4, 5))
    _diff(got, want)
