"""The port's DHD-L (Swin-B image backbone + FPN_LSS image neck on the
temporal + stereo model) against the JAX package's, in fp32 on the CPU, at
the tiny DHD-L-shaped configuration of tests/test_stereo_model.py: the JAX
variables converted by ``dhd_tpu_torch.io.load_jax_variables``; and
DHD-L's key space at full width."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhd_tpu.config import get_config as j_config
from dhd_tpu.data import synthetic_batch as j_batch
from dhd_tpu.io.convert import build_rules as j_build_rules
from dhd_tpu.models import build_model as j_build_model
from dhd_tpu_torch.config import get_config as t_config
from dhd_tpu_torch.io import convert as C
from dhd_tpu_torch.io import load_jax_variables
from dhd_tpu_torch.models import DHDStereoNet, build_model
from dhd_tpu_torch.nn import SwinTransformer
from torch_cases import tiny_dhd_l

OUT_KEYS = ("occ_logits", "depth", "height")
STREAM_KEYS = ("imgs", "sensor2ego", "ego2global", "intrins", "post_rots",
               "post_trans")


def _rel_to_peak(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(1e-3, float(np.abs(b).max()))


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
def tiny():
    """One jitted JAX init, two streaming steps and the F-frame forward;
    the port with the converted variables, run the same way."""
    cfg_j = tiny_dhd_l(j_config)
    batch = j_batch(cfg_j, batch_size=1, seed=1, with_gt=False)
    jmodel = j_build_model(cfg_j)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), jb)
    s1, s2 = _stream_frames(batch)
    step = jax.jit(lambda v, b, c: jmodel.apply(v, b, train=False, cache=c))
    out1, cache1 = step(variables, {k: jnp.asarray(v) for k, v in s1.items()},
                        {})
    out2, _ = step(variables, {k: jnp.asarray(v) for k, v in s2.items()},
                   cache1)
    frames = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jb)
    want = jax.tree_util.tree_map(np.asarray, {
        "stream1": out1, "stream2": out2, "frames": frames,
        "stereo_feat1": cache1["stereo_feat"]})

    cfg = tiny_dhd_l(t_config)
    model = build_model(cfg, device="cpu")
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, variables),
                       cfg)
    got1, gcache1 = model(s1, cache={})
    got2, _ = model(s2, cache=gcache1)
    got = {"stream1": got1, "stream2": got2, "frames": model(batch),
           "stereo_feat1": gcache1["stereo_feat"]}
    return got, want


@pytest.mark.parametrize("run", ["stream1", "stream2", "frames"])
@pytest.mark.parametrize("key", OUT_KEYS)
def test_tiny_dhd_l_matches_jax(tiny, run, key):
    """Same weights, images and rigs: both streaming steps (the second
    through the cache, the stereo cost volume on the Swin's stage-0
    feature and the BEV warp) and the F-frame forward (its extra reference
    frame through ``stage0_only``) within 2e-4 of the JAX output's peak."""
    got, want = tiny
    assert _rel_to_peak(got[run][key].numpy(), want[run][key]) < 2e-4


def test_tiny_dhd_l_stereo_feature(tiny):
    """The cached stereo feature is Swin stage 0 before the downsample,
    un-normed, channels-last (B*N, H/4, W/4, embed)."""
    got, want = tiny
    sf = got["stereo_feat1"]
    assert tuple(sf.shape) == (6, 16, 48, 16) and sf.is_contiguous()
    assert _rel_to_peak(sf.numpy(), want["stereo_feat1"]) < 2e-4


def test_dhd_l_key_space_is_the_rule_table():
    """DHD-L at full width (Swin-B with 24 blocks, the FPN_LSS image neck
    without its up2 head, the stereo DepthNet, the CustomResNet BEV
    encoder) at a narrow UNet width: every parameter of the port's model
    is reached by one rule, the rule table is the JAX package's, and the
    JAX model's variables (shapes from an abstract init at a small input,
    which no parameter depends on) strict-load."""
    cfg = dataclasses.replace(t_config("dhd_l"), unet_base=4)
    model = DHDStereoNet(cfg, device="cpu")
    assert isinstance(model.img_backbone, SwinTransformer)
    assert model.img_backbone.out_channels == (128, 512, 1024)
    assert not hasattr(model.img_neck, "up2")

    def owner(key):
        # the bias table is a bare parameter: its rule names it whole
        return key if key.endswith("relative_position_bias_table") \
            else key.rsplit(".", 1)[0]
    modules = {owner(k) for k in model.state_dict()}
    rules = C.build_rules(cfg)
    assert len({tp for tp, _, _ in rules}) == len(rules)
    assert modules == {tp for tp, _, _ in rules}
    jcfg = dataclasses.replace(j_config("dhd_l"), unet_base=4)
    assert rules == j_build_rules(jcfg)

    small = dataclasses.replace(
        jcfg, vt=dataclasses.replace(jcfg.vt, input_size=(64, 192)))
    s1, _ = _stream_frames(j_batch(small, batch_size=1, with_gt=False))
    shapes = jax.eval_shape(
        lambda b: j_build_model(small).init(jax.random.PRNGKey(0), b,
                                            train=False, cache={}),
        {k: jnp.asarray(v) for k, v in s1.items()})
    variables = jax.tree_util.tree_map(
        lambda s: np.full(s.shape, 0.5, s.dtype), shapes)
    load_jax_variables(model, variables, cfg)
    blk = model.img_backbone.stages[2].blocks[17]
    assert bool((blk.attn.w_msa.relative_position_bias_table == 0.5).all())
    assert bool((blk.norm2.weight == 0.5).all())


def test_dhd_l_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(t_config("dhd_l"), dtype=torch.bfloat16)
