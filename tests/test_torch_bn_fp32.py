"""BatchNorms stay fp32 in a bf16 model, as the JAX package keeps them
(``dhd_tpu/nn/layers.py:23-36``: flax's ``BatchNorm`` with
``param_dtype=float32`` normalises in fp32 and casts the output).

Random and converted init statistics (mean 0, variance 1, weight 1, bias
0) are exact in bf16, so every check here draws them away from init: a
BatchNorm holding bf16 statistics and affines is then up to 7 bf16 ulps
from flax's.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dhd_tpu.config import get_config as j_config
from dhd_tpu.models import build_model as j_build_model
from dhd_tpu_torch.config import get_config as t_config
from dhd_tpu_torch.data import synthetic_batch as t_batch
from dhd_tpu_torch.io import load_checkpoint, load_jax_variables
from dhd_tpu_torch.io import save_checkpoint
from dhd_tpu_torch.models import build_model
from dhd_tpu_torch.nn.depthnet import EmbeddingBN
from dhd_tpu_torch.nn.layers import BatchNorm2d, _FlaxTrainBN

# the port's bf16 logits against JAX's bf16 logits, rel-L2, as a share of
# JAX's own bf16-vs-fp32 distance (the control).  Readings: 0.678 with the
# BatchNorms in fp32, 1.190 with them in bf16.  Through dhd_tiny's ~100
# layers two bf16 forwards' roundings add up to most of the control (as
# tests/test_torch_train_bf16.py finds for the train step); the single
# BatchNorm above is the sharp check, this one the whole model's.
FORWARD_SHARE_BAR = 0.9


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: under the test lane's parallel
    workers the models' many small ops otherwise stall on the other
    workers' OpenMP threads (tests/test_torch_eval.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (the spacing of bf16 numbers there)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _bn_stats(rng, c):
    return {"mean": rng.uniform(-2, 2, c).astype(np.float32),
            "var": rng.uniform(0.1, 1, c).astype(np.float32),
            "scale": rng.uniform(0.5, 2, c).astype(np.float32),
            "bias": rng.uniform(-1, 1, c).astype(np.float32)}


def _bf16_batchnorm(module):
    """``module``'s BatchNorm tensors cast to bf16 the way ``.to()`` cast
    them before BatchNorms kept fp32 (all but the camera embedding's): the
    fault this file guards."""
    for m in module.modules():
        if isinstance(m, _FlaxTrainBN) and not isinstance(m, EmbeddingBN):
            for t in list(m.parameters()) + list(m.buffers()):
                if t.is_floating_point():
                    t.data = t.data.to(torch.bfloat16)
    return module


@torch.no_grad()
def test_one_batchnorm_within_one_bf16_ulp_of_flax():
    """C=64, running mean U(-2, 2), variance U(0.1, 1), scale U(0.5, 2),
    bias U(-1, 1), a bf16 input: the port's eval BN in a bf16 module lies
    within 1 bf16 ulp of flax's bf16 ``BatchNorm`` (param_dtype fp32)."""
    rng = np.random.default_rng(0)
    c = 64
    st = _bn_stats(rng, c)
    x = jnp.asarray(rng.normal(0, 3, (2, 8, 8, c)), jnp.bfloat16)
    bn = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.bfloat16, param_dtype=jnp.float32)
    want = np.asarray(bn.apply(
        {"params": {"scale": st["scale"], "bias": st["bias"]},
         "batch_stats": {"mean": st["mean"], "var": st["var"]}}, x),
        np.float32)

    mod = BatchNorm2d(c).eval()
    for name, key in (("weight", "scale"), ("bias", "bias"),
                      ("running_mean", "mean"), ("running_var", "var")):
        getattr(mod, name).copy_(torch.from_numpy(st[key]))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).permute(
        0, 3, 1, 2).to(torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        mod.to(dtype)
        assert {t.dtype for t in mod.state_dict().values()
                if t.is_floating_point()} == {torch.float32}
    got = mod(xt)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert (np.abs(got - want) <= _bf16_ulp(want)).all(), \
        float(np.abs(got - want).max())
    # the fault: bf16 statistics and affines miss the bar
    old = _bf16_batchnorm(BatchNorm2d(c).eval())
    old.load_state_dict({k: v for k, v in mod.state_dict().items()})
    bad = old(xt).float().permute(0, 2, 3, 1).numpy()
    assert (np.abs(bad - want) > _bf16_ulp(want)).any()


def test_no_batchnorm_tensor_of_a_bf16_model_is_bf16():
    """Every BatchNorm tensor of a bf16 dhd_tiny is fp32 (98 BatchNorms);
    its convs are bf16."""
    model = build_model(t_config("dhd_tiny"), dtype=torch.bfloat16,
                        device="cpu")
    bns = [m for m in model.modules() if isinstance(m, _FlaxTrainBN)]
    assert len(bns) == 98
    not_fp32 = [(n, t.dtype) for m in bns
                for n, t in list(m.named_parameters())
                + list(m.named_buffers())
                if t.is_floating_point() and t.dtype != torch.float32]
    assert not_fp32 == []
    assert model.occ_head.final_conv.conv.weight.dtype == torch.bfloat16
    assert model.dtype == torch.bfloat16


def _away_from_init(variables, seed=3):
    """``variables`` with every BatchNorm's statistics and affine drawn as
    in :func:`_bn_stats` (a trained model's, not init's)."""
    rng = np.random.default_rng(seed)

    def walk(params, stats):
        for k, v in stats.items():
            if "mean" in v and "var" in v:
                d = _bn_stats(rng, v["mean"].shape[0])
                stats[k] = {"mean": d["mean"], "var": d["var"]}
                params[k] = {"scale": d["scale"], "bias": d["bias"]}
            else:
                walk(params[k], v)
    out = jax.tree_util.tree_map(np.asarray, variables)
    walk(out["params"], out["batch_stats"])
    return out


@pytest.fixture(scope="module")
def tiny_bf16():
    """dhd_tiny's eval forward with trained-like BatchNorms: JAX in bf16
    and in fp32 (compiled with XLA's excess precision off, each op
    rounded to its dtype), and the port's bf16 model from the same
    variables."""
    jcfg = j_config("dhd_tiny")
    batch = t_batch(t_config("dhd_tiny"), batch_size=1, seed=4,
                    with_gt=False, varied_rig=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init = jax.jit(lambda r, b: j_build_model(jcfg).init(
        r, b, train=False))(jax.random.PRNGKey(0), jb)
    variables = _away_from_init(init)
    logits = {}
    for dt in (jnp.bfloat16, jnp.float32):
        model = j_build_model(jcfg, dtype=dt)
        run = jax.jit(lambda v, b, model=model: model.apply(
            v, b, train=False)["occ_logits"]).lower(variables, jb).compile(
            compiler_options={"xla_allow_excess_precision": False})
        logits[dt] = np.asarray(run(variables, jb), np.float64)
    cfg = t_config("dhd_tiny")
    port = build_model(cfg, dtype=torch.bfloat16, device="cpu")
    load_jax_variables(port, variables, cfg)
    return batch, logits, port, variables


def _share(got, logits):
    control = np.linalg.norm(logits[jnp.float32] - logits[jnp.bfloat16])
    return float(np.linalg.norm(np.asarray(got, np.float64)
                                - logits[jnp.bfloat16]) / control)


@torch.no_grad()
def test_dhd_tiny_bf16_forward_follows_jax(tiny_bf16):
    """The port's bf16 logits lie within FORWARD_SHARE_BAR of JAX's own
    bf16-vs-fp32 distance from JAX's bf16 logits; with its BatchNorms in
    bf16 the port lies farther than JAX's fp32 forward."""
    batch, logits, port, _ = tiny_bf16
    share = _share(port(batch)["occ_logits"].numpy(), logits)
    assert share <= FORWARD_SHARE_BAR, share
    bad = _share(_bf16_batchnorm(port)(batch)["occ_logits"].numpy(),
                 logits)
    assert bad > FORWARD_SHARE_BAR, bad
    # undo the fault for the module's other tests
    port.float().to(torch.bfloat16)


def test_checkpoints_of_either_batchnorm_dtype_load(tiny_bf16):
    """A bf16 model's checkpoint holds fp32 BatchNorm tensors now; one
    written before (bf16 BatchNorm tensors) loads too, into fp32."""
    _, _, port, _ = tiny_bf16
    buf = io.BytesIO()
    save_checkpoint(buf, port, step=3)
    state = torch.load(io.BytesIO(buf.getvalue()), weights_only=True)
    bn = "img_backbone.b0.bn1.running_var"
    assert state["model"][bn].dtype == torch.float32
    old = dict(state, model={k: (v.to(torch.bfloat16)
                                 if ".bn" in k and v.is_floating_point()
                                 else v) for k, v in state["model"].items()})
    assert old["model"][bn].dtype == torch.bfloat16
    for ckpt in (state, old):
        fresh = build_model(t_config("dhd_tiny"), dtype=torch.bfloat16,
                            device="cpu")
        f = io.BytesIO()
        torch.save(ckpt, f)
        assert load_checkpoint(f, fresh) == 3
        got = fresh.state_dict()[bn]
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, ckpt["model"][bn].float())
