"""One train step of the JAX package (``make_train_step``) and of the port
(``dhd_tpu_torch.train.train_step``) from the same weights and batch, on
the CPU, and the checks that hold them together.  Shared by
tests/test_torch_train.py (dhd_tiny) and tests/test_torch_train_stereo.py
(dhd_micro_stereo), which each run the JAX steps once per module.

The JAX variables reach the port through ``load_jax_variables``; every
JAX tree after the step (params, batch_stats, Adam's moments, the EMA) is
mapped into the port's state_dict keys by the converter's rule table
(its layout transforms are linear, so they carry gradients and moments
too).

Two steps are compared.  The JAX config has no DropPath rate, so both
packages' Swin DropPath is off here (:func:`no_drop_path`); the tests of
the port's DropPath are in tests/test_torch_train_dhd_l.py.

* **fp64** (:func:`fp64_steps`): both packages' whole step in float64,
  every fp32 cast of either widened to fp64 (:func:`fp64_everywhere`), at
  the full learning rate (the warmup's ratio set to 1 in both configs).
  Both models hold fp32 stages (the softmaxes, the pooling, the losses,
  the camera embedding's BatchNorm); left in, their fp32 rounding flips
  ReLU gates, and the two float64 gradients of dhd_tiny lie 6.1e-4 apart
  in rel-L2 (dhd_micro_stereo 4.2e-2).  Widened, they agree to 2.1e-8
  (1.2e-7), the worst tensor within 7.5e-8 (2.4e-7) of its peak.  So the
  fp64 step holds every tensor element by element
  (:func:`check_fp64_step`): the gradient and the moments within 1e-6 of
  each tensor's peak, the params after a full-rate AdamW step within
  1e-5, a twentieth of the step, where a flipped update sign moves a
  weight by 4e-4.
* **fp32** (:func:`jax_steps`, :func:`port_step`): the step as it trains,
  at step 0's learning rate.  The forward is held tightly (losses within
  rtol 1e-5, BN running variances within rtol 1e-5, params and EMA
  within atol 1e-6).  The gradient cannot be held per element: two fp32
  forwards flip a few ReLU gates (``dhd_tpu_torch/train/compare.py``), so
  it is held in rel-L2, as a whole and per tensor, against bars set from
  the readings (:data:`FP32_BARS`; ``python tests/torch_train_ref.py
  PRESET`` prints them).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dhd_tpu.config import get_config as j_get_config
from dhd_tpu.models import build_model as j_build_model
from dhd_tpu.nn import swin as j_swin
from dhd_tpu.train import (TrainState, create_train_state, ema_init,
                           make_optimizer, make_train_step)
from dhd_tpu_torch.config import get_config as t_get_config
from dhd_tpu_torch.data import synthetic_batch
from dhd_tpu_torch.io import build_rules, load_jax_variables
from dhd_tpu_torch.io.convert import variables_to_state_dict
from dhd_tpu_torch.models import build_model
from dhd_tpu_torch.nn.swin import DropPath
from dhd_tpu_torch.train import (AdamWSchedule, ModelEMA, gradient_errors,
                                 train_step, zero_gradient_params)

STEPS_PER_EPOCH = 10
B1 = 0.9                      # Adam's first-moment decay
STAT_KEYS = ("running_mean", "running_var", "num_batches_tracked")

# fp32 port vs fp32 JAX, by (preset, with_prev): rel-L2 bars (whole,
# median tensor, worst tensor) of the gradient and of AdamW's second
# moment, and grad_norm's rtol; each about 3x the reading beside it
# (``python tests/torch_train_ref.py PRESET`` on the CPU).  The micro
# preset's 4 x 4 maps make one flipped gate a large share of a tensor:
# there JAX's own fp32 gradient lies 3.8e-2 from its fp64 one.
FP32_BARS = {
    # readings: grad 1.7e-3 / 3.1e-3 / 5.7e-2; nu 3.0e-4 / 3.5e-3 /
    # 7.2e-2; grad_norm 6.0e-6
    ("dhd_tiny", True): {"grad": (5e-3, 1e-2, 0.2),
                         "nu": (1e-3, 1e-2, 0.2), "grad_norm": 2e-5},
    # readings: grad 3.6e-2 / 1.6e-2 / 1.0e-1; nu 3.7e-2 / 3.2e-2 /
    # 1.6e-1; grad_norm 1.5e-2
    ("dhd_micro_stereo", True): {"grad": (0.1, 0.05, 0.3),
                                 "nu": (0.1, 0.1, 0.5), "grad_norm": 5e-2},
    # readings: grad 3.5e-3 / 3.8e-3 / 2.5e-2; nu 4.1e-3 / 4.7e-3 /
    # 4.8e-2; grad_norm 1.1e-3
    ("dhd_micro_stereo", False): {"grad": (1e-2, 1e-2, 0.1),
                                  "nu": (1e-2, 1e-2, 0.15),
                                  "grad_norm": 5e-3},
}
# fp64 step, element by element.  Readings (dhd_tiny; dhd_micro_stereo
# with and without history): losses and grad_norm 1.6e-8, 1.2e-7, 1.1e-7
# relative; gradients and moments 1.1e-7, 2.5e-7, 3.4e-7 of a tensor's
# peak; params 6.2e-7, 1.0e-6, 3.3e-7 after a 2.0e-4 step (a weight whose
# gradient is near Adam's eps, 1e-8, takes any share of its step); EMA
# 2.4e-7, 1.1e-7, 5.9e-8 (the EMA's decay is fp32 in both packages' own
# code, and a BN running variance of ~10 carries its rounding).
FP64_TOL = 1e-6               # of each tensor's peak; losses' rtol
FP64_PARAM_ATOL = 1e-5        # params after the full-rate step
FP64_EMA_ATOL = 1e-6


def _config(get_config, preset):
    """``preset`` of either package's ``get_config``; ``"tiny_dhd_l"`` is
    tests/torch_cases.py's tiny DHD-L-shaped configuration."""
    if preset == "tiny_dhd_l":
        from torch_cases import tiny_dhd_l
        return tiny_dhd_l(get_config)
    return get_config(preset)


def j_config(preset):
    return _config(j_get_config, preset)


def get_config(preset):
    return _config(t_get_config, preset)


@contextlib.contextmanager
def no_drop_path():
    """Inside, the JAX package's Swin DropPath is the identity (its config
    has no rate; the Swin's default is 0.1, drawn from flax's rng)."""
    saved = j_swin.DropPath.__call__
    j_swin.DropPath.__call__ = lambda self, x, train=False: x
    try:
        yield
    finally:
        j_swin.DropPath.__call__ = saved


def drop_path_off(model):
    """``model`` with every DropPath of its Swin at rate 0."""
    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    return model


def no_dropout(cfg):
    """``cfg`` with the ASPP dropout off in both distribution nets (either
    package's config class)."""
    return dataclasses.replace(
        cfg, depthnet_cfg=dataclasses.replace(cfg.depthnet_cfg,
                                              aspp_dropout=0.0),
        heightnet_cfg=dataclasses.replace(cfg.heightnet_cfg,
                                          aspp_dropout=0.0))


def full_rate(cfg):
    """``cfg`` whose schedule starts at the full learning rate."""
    return dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, warmup_ratio=1.0))


def port_cfg(preset):
    return no_dropout(get_config(preset))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside the chained optimiser state."""
    if hasattr(opt_state, "mu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def _after(new, metrics):
    """A JAX state after the step, as numpy trees."""
    adam = _adam_state(new.opt_state)
    return {"params": _np(new.params), "batch_stats": _np(new.batch_stats),
            "mu": _np(adam.mu), "nu": _np(adam.nu),
            "ema": _np({"params": new.ema.params,
                        "batch_stats": new.ema.batch_stats}),
            "ema_updates": int(new.ema.updates),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _state(model, cfg, tx, variables):
    """A JAX TrainState over ``variables`` (as :func:`jax_steps` returns
    them), as ``create_train_state`` builds it."""
    return TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        ema=ema_init(variables["params"], variables["batch_stats"],
                     cfg.optim.ema_init_updates),
        tx=tx, apply_fn=model.apply)


def jax_steps(preset, batch, with_prev_cases=(True,), dtype=jnp.float32,
              init=None):
    """JAX init (unless ``init`` gives the variables) and one train step
    per ``with_prev`` case of ``build_model(cfg, dtype)``, each from the
    initial state.  Returns the initial variables and, per case, the
    state after the step and its metrics, as numpy trees."""
    cfg = no_dropout(j_config(preset))
    model = j_build_model(cfg, dtype=dtype)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = make_optimizer(cfg.optim, steps_per_epoch=STEPS_PER_EPOCH)
    after = {}
    with no_drop_path():
        if init is None:
            state = create_train_state(model, cfg, jax.random.PRNGKey(0),
                                       jb, tx, jit_init=True)
            init = _np({"params": state.params,
                        "batch_stats": state.batch_stats})
        else:
            state = _state(model, cfg, tx, jax.tree_util.tree_map(
                jnp.asarray, init))
        for with_prev in with_prev_cases:
            step = make_train_step(cfg, donate=False, with_prev=with_prev)
            after[with_prev] = _after(*step(state, jb,
                                            jax.random.PRNGKey(1)))
    return init, after


def port_step(preset, init, batch, with_prev=True, cfg=None,
              dtype=torch.float32, compute_dtype=None):
    """The port's model with the JAX variables (DropPath off) and one
    train step, its forward in ``compute_dtype``; returns the model,
    optimiser, EMA and metrics (floats)."""
    cfg = cfg or port_cfg(preset)
    model = drop_path_off(build_model(cfg, device="cpu", dtype=dtype))
    load_jax_variables(model, init, cfg)
    opt = AdamWSchedule(model.parameters(), cfg.optim, STEPS_PER_EPOCH)
    ema = ModelEMA(model, cfg.optim.ema_init_updates, cfg.optim.ema_decay)
    metrics = train_step(model, opt, ema, batch, with_prev=with_prev,
                         compute_dtype=compute_dtype)
    return model, opt, ema, {k: float(v) for k, v in metrics.items()}


@contextlib.contextmanager
def fp64_everywhere():
    """Inside, both packages' fp32 casts give float64: ``jnp.float32``
    and ``torch.float32`` name float64 and ``Tensor.float()`` keeps a
    wider type, so a float64 model holds no fp32 stage (run JAX in x64)."""
    saved = jnp.float32, torch.float32, torch.Tensor.float
    f32 = torch.float32
    jnp.float32 = jnp.float64
    torch.float32 = torch.float64
    torch.Tensor.float = lambda self, *a, **k: self.to(
        torch.promote_types(self.dtype, f32))
    try:
        yield
    finally:
        jnp.float32, torch.float32, torch.Tensor.float = saved


def fp64_steps(preset, init, batch, with_prev_cases=(True,)):
    """Both packages' whole train step in float64 (:func:`fp64_everywhere`)
    at the full learning rate, from ``init`` (the fp32 JAX variables,
    widened) on ``batch`` (its floats widened).  Returns per case JAX's
    state after the step (as :func:`jax_steps`) and the port's model,
    optimiser, EMA and metrics (as :func:`port_step`)."""
    from dhd_tpu.train.ema import EmaState  # noqa: F401 (pytree registry)

    jcfg = full_rate(no_dropout(j_config(preset)))
    cfg = full_rate(port_cfg(preset))
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in batch.items()}
    out = {}
    with jax.enable_x64(True), fp64_everywhere(), no_drop_path():
        wide = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float64), init)
        model = j_build_model(jcfg, dtype=jnp.float64)
        tx = make_optimizer(jcfg.optim, steps_per_epoch=STEPS_PER_EPOCH)
        state = _state(model, jcfg, tx, wide)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for with_prev in with_prev_cases:
            step = make_train_step(jcfg, donate=False, with_prev=with_prev)
            after = _after(*step(state, jb, jax.random.PRNGKey(1)))
            out[with_prev] = (after, port_step(preset, init, batch,
                                               with_prev, cfg,
                                               torch.float64))
    return out


def to_port(cfg, params, batch_stats):
    """A JAX params tree (or one shaped like it) and batch_stats in the
    port's state_dict keys."""
    return variables_to_state_dict({"params": params,
                                    "batch_stats": batch_stats},
                                   build_rules(cfg))


def check_losses(got, want, rtol=1e-5):
    """Every loss within ``rtol`` (``grad_norm`` is the gradient's:
    :func:`check_gradients`)."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, v in want.items():
        assert np.isfinite(got[k]), k
        if k != "grad_norm":
            np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)


def _within(got, want, zero, bars, what):
    whole, median, worst = gradient_errors(got, want, zero)
    assert whole <= bars[0] and median <= bars[1] and worst <= bars[2], \
        (what, whole, median, worst, bars)


def clipped_gradient(cfg, after):
    """The clipped gradient that entered JAX's AdamW: ``mu / (1 - b1)``,
    the first moment after one step from zero, in the port's keys."""
    return to_port(cfg, jax.tree_util.tree_map(
        lambda m: m / np.asarray(1.0 - B1, m.dtype), after["mu"]),
        after["batch_stats"])


def check_gradients(cfg, model, after, metrics, bars):
    """The port's ``.grad`` after the step (the clipped gradient) against
    JAX's (:func:`clipped_gradient`) within ``bars["grad"]``, and
    ``grad_norm`` within ``bars["grad_norm"]``.  The zero-gradient conv
    biases (:func:`zero_gradient_params`) hold rounding noise, which a
    BatchNorm over a constant channel (the zero cost volume without
    history frames) scales by 1 / sqrt(eps): they are only held finite."""
    want = clipped_gradient(cfg, after)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == {k for k in want if not k.endswith(STAT_KEYS)}
    zero = zero_gradient_params(model)
    _within(got, want, zero, bars["grad"], "grad")
    np.testing.assert_allclose(metrics["grad_norm"],
                               after["metrics"]["grad_norm"],
                               rtol=bars["grad_norm"])
    for k in zero:
        assert np.isfinite(got[k]).all(), k


def _moments(model, opt):
    names = {p: k for k, p in model.named_parameters()}
    return {m: {names[p]: st[m].numpy() for p, st in opt.adamw.state.items()}
            for m in ("exp_avg", "exp_avg_sq")}


def check_moments(cfg, model, opt, after, bars):
    """AdamW's exp_avg / exp_avg_sq against optax's mu / nu: the first as
    the gradient is held (``bars["grad"]``), the second, (1 - b2) g^2,
    within ``bars["nu"]``."""
    got = _moments(model, opt)
    zero = zero_gradient_params(model)
    for m, jax_key, key in (("exp_avg", "mu", "grad"),
                            ("exp_avg_sq", "nu", "nu")):
        want = to_port(cfg, after[jax_key], after["batch_stats"])
        assert set(got[m]) == {k for k, _ in model.named_parameters()}
        _within(got[m], want, zero, bars[key], m)


def check_running_stats(got, want, rtol=1e-5):
    """BN running statistics (dicts by state_dict key): each variance
    within ``rtol``, each mean within ``rtol`` of the square root of its
    variance (1e-4 of the step's scale, 0.1 of the channel's spread): a
    batch mean that nearly cancels is held to its data's scale."""
    keys = [k for k in want if k.endswith("running_var")]
    assert keys
    for k in keys:
        var = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(got[k], var, rtol=rtol, err_msg=k)
        m = k[:-len("running_var")] + "running_mean"
        np.testing.assert_array_less(
            np.abs(np.asarray(got[m], np.float64) - want[m]),
            rtol * np.sqrt(var), err_msg=m)


def check_bn_stats(cfg, model, after, rtol=1e-5):
    """The running statistics after the step (:func:`check_running_stats`)."""
    check_running_stats(
        {k: v.numpy() for k, v in model.state_dict().items()},
        to_port(cfg, after["params"], after["batch_stats"]), rtol)


def check_params(cfg, model, after, init, atol=1e-6):
    """Updated params within ``atol``; the step moved them."""
    want = to_port(cfg, after["params"], after["batch_stats"])
    before = to_port(cfg, init["params"], init["batch_stats"])
    moved = 0
    for k, p in model.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, want[k], rtol=0, atol=atol,
                                   err_msg=k)
        moved += int(not np.array_equal(got, before[k]))
    assert moved > 0


def check_ema(cfg, ema, after, atol=1e-6, rtol=1e-5):
    """The EMA within ``atol``, its BN variances also within ``rtol`` (the
    embedding's are ~100); the counter is 10560 + 1."""
    want = to_port(cfg, after["ema"]["params"], after["ema"]["batch_stats"])
    assert ema.updates == after["ema_updates"] == \
        cfg.optim.ema_init_updates + 1
    assert not any(k.endswith("num_batches_tracked") for k in ema.shadow)
    for k, v in ema.shadow.items():
        np.testing.assert_allclose(
            v.numpy(), want[k], atol=atol,
            rtol=rtol if k.endswith("running_var") else 0, err_msg=k)


def _close_to_peak(got, want, tol, name):
    """max |got - want| within ``tol`` of want's peak."""
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (name, err)


def check_fp64_step(cfg, init, port, after):
    """The fp64 steps (:func:`fp64_steps`) element by element: losses and
    grad_norm within rtol FP64_TOL; every gradient and both Adam moments
    within FP64_TOL of each tensor's peak (the zero-gradient biases,
    whose exact gradient is 0, within FP64_TOL of the whole gradient's
    peak); the running statistics within rtol FP64_TOL; the params after
    the full-rate AdamW step within FP64_PARAM_ATOL, the EMA within
    FP64_EMA_ATOL."""
    model, opt, ema, metrics = port
    check_losses(metrics, after["metrics"], rtol=FP64_TOL)
    np.testing.assert_allclose(metrics["grad_norm"],
                               after["metrics"]["grad_norm"], rtol=FP64_TOL)
    zero = set(zero_gradient_params(model))
    grads = clipped_gradient(cfg, after)
    peak = max(float(np.abs(v).max()) for v in grads.values())
    got = {"grad": {k: p.grad.numpy() for k, p in model.named_parameters()},
           **_moments(model, opt)}
    want = {"grad": grads,
            "exp_avg": to_port(cfg, after["mu"], after["batch_stats"]),
            "exp_avg_sq": to_port(cfg, after["nu"], after["batch_stats"])}
    for what in want:
        for k, g in got[what].items():
            assert g.dtype == np.float64, (what, k)
            if k in zero:
                assert np.abs(g - want[what][k]).max() <= FP64_TOL * (
                    peak if what != "exp_avg_sq" else peak ** 2), (what, k)
            else:
                _close_to_peak(g, want[what][k], FP64_TOL, f"{what} {k}")
    check_bn_stats(cfg, model, after, rtol=FP64_TOL)
    check_params(cfg, model, after, init, atol=FP64_PARAM_ATOL)
    check_ema(cfg, ema, after, atol=FP64_EMA_ATOL, rtol=FP64_TOL)


def train_batch(preset, seed=1, batch_size=2):
    """``synthetic_batch`` with the variety of a training batch
    (``varied_rig``): on the plain synthetic rig 21 of the 27
    camera-embedding features are the same in every row, and the
    train-mode BatchNorm over those rows (flax's as the reference's)
    normalises fp32 rounding noise by 1 / sqrt(1e-5), on which two
    implementations cannot agree."""
    return synthetic_batch(get_config(preset), batch_size=batch_size,
                           seed=seed, varied_rig=True)


def fp32_readings(preset):
    """The fp32 port-vs-JAX readings behind :data:`FP32_BARS`, per
    ``with_prev`` case: rel-L2 (whole, median, worst tensor) of the
    gradient and of the second moment, and grad_norm's relative
    difference."""
    cases = (True, False) if get_config(preset).temporal else (True,)
    batch = train_batch(preset)
    init, after = jax_steps(preset, batch, cases)
    cfg = port_cfg(preset)
    out = {}
    for with_prev in cases:
        model, opt, _, metrics = port_step(preset, init, batch, with_prev)
        a = after[with_prev]
        zero = zero_gradient_params(model)
        got = {k: p.grad.numpy() for k, p in model.named_parameters()}
        nu = to_port(cfg, a["nu"], a["batch_stats"])
        norm = a["metrics"]["grad_norm"]
        out[with_prev] = {
            "grad": gradient_errors(got, clipped_gradient(cfg, a), zero),
            "nu": gradient_errors(_moments(model, opt)["exp_avg_sq"], nu,
                                  zero),
            "grad_norm": abs(metrics["grad_norm"] - norm) / norm}
    return out


# The first layers of each preset's image backbone, the port's module and
# the JAX module's path in ``ImageEncoder``, whose bf16 outputs
# :func:`bf16_layer_readings` compares: convs and dense layers in bf16,
# BatchNorm and LayerNorm with fp32 statistics, the window attention's
# fp32 softmax.
BF16_LAYERS = {
    "dhd_tiny": (("img_backbone.b0.conv1", "backbone/b0/conv1"),
                 ("img_backbone.b0.bn1", "backbone/b0/bn1"),
                 ("img_backbone.b0.conv2", "backbone/b0/conv2"),
                 ("img_backbone.b0", "backbone/b0"),
                 ("img_backbone.b1", "backbone/b1")),
    "tiny_dhd_l": (
        ("img_backbone.patch_embed.projection", "backbone/patch_embed"),
        ("img_backbone.patch_embed.norm", "backbone/patch_norm"),
        ("img_backbone.stages.0.blocks.0.norm1",
         "backbone/stage0_block0/norm1"),
        ("img_backbone.stages.0.blocks.0.attn.w_msa.qkv",
         "backbone/stage0_block0/attn/qkv"),
        ("img_backbone.stages.0.blocks.0.attn.w_msa",
         "backbone/stage0_block0/attn"),
        ("img_backbone.stages.0.blocks.0.ffn.layers.0.0",
         "backbone/stage0_block0/fc1")),
}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _key_images(batch):
    """The key frame's (B*N, H, W, 3) images of ``batch``."""
    imgs = np.asarray(batch["imgs"])
    if imgs.ndim == 6:                              # (B, F, N, H, W, 3)
        imgs = imgs[:, 0]
    return imgs.reshape((-1,) + imgs.shape[-3:])


def jax_layers(preset, init, batch, dtype):
    """The outputs of :data:`BF16_LAYERS`' JAX modules in a train-mode
    forward of the image encoder of ``build_model(cfg, dtype)`` (its
    ``ImageEncoder``, from ``init``) over the key frame's images, as
    numpy fp32.  Compiled with XLA's excess precision off, so that every
    op rounds to its dtype as flax writes the model: on the CPU, XLA
    otherwise keeps some bf16 results in fp32 between ops (a conv's output
    into its BatchNorm)."""
    from dhd_tpu.models.dhd import ImageEncoder

    cfg = no_dropout(j_config(preset))
    encoder = ImageEncoder(cfg, dtype=dtype)
    variables = {"params": init["params"]["img_encoder"],
                 "batch_stats": init["batch_stats"].get("img_encoder", {})}
    imgs = jnp.asarray(_key_images(batch)).astype(dtype)
    paths = [path for _, path in BF16_LAYERS[preset]]

    def forward(v, x):
        return encoder.apply(
            v, x, train=True, stereo=cfg.stereo,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, method: (
                method == "__call__" and "/".join(mdl.path) in paths))
    with no_drop_path():
        run = jax.jit(forward).lower(variables, imgs).compile(
            compiler_options={"xla_allow_excess_precision": False})
        inter = run(variables, imgs)[1]["intermediates"]
    out = {}
    for path in paths:
        node = inter
        for key in path.split("/"):
            node = node[key]
        out[path] = np.asarray(node["__call__"][0], np.float32)
    return out


def port_layers(preset, init, batch, compute_dtype):
    """The outputs of :data:`BF16_LAYERS`' port modules in the port's
    train-mode image encoder (``DHDNet._encode``, from ``init``) over the
    key frame's images in ``compute_dtype``, channels last, as numpy
    fp32."""
    cfg = port_cfg(preset)
    model = drop_path_off(build_model(cfg, device="cpu"))
    load_jax_variables(model, init, cfg)
    model.train()
    out = {}

    def keep(path, y):
        out.setdefault(path, y.detach().float().numpy())
    for name, path in BF16_LAYERS[preset]:
        model.get_submodule(name).register_forward_hook(
            lambda mod, args, y, path=path: keep(path, y))
    imgs = torch.from_numpy(_key_images(batch)).permute(0, 3, 1, 2)
    with model.computing_in(compute_dtype):
        model._encode(imgs.to(model.dtype),
                      generator=torch.Generator().manual_seed(0))
    return {k: np.moveaxis(v, 1, -1) if v.ndim == 4 else v
            for k, v in out.items()}


def bf16_layer_readings(preset, init, batch=None):
    """Per layer of :data:`BF16_LAYERS`, the rel-L2 distance from JAX's
    bf16 output of the port's bf16 output (``port``), of the port's fp32
    output (``fp32_port``) and of JAX's fp32 output (``control``), the
    first two also as shares of the control."""
    batch = train_batch(preset) if batch is None else batch
    j16 = jax_layers(preset, init, batch, jnp.bfloat16)
    j32 = jax_layers(preset, init, batch, jnp.float32)
    p16 = port_layers(preset, init, batch, torch.bfloat16)
    p32 = port_layers(preset, init, batch, None)
    out = {}
    for name, path in BF16_LAYERS[preset]:
        control = _rel_l2(j32[path], j16[path])
        port, fp32 = (_rel_l2(p[path], j16[path]) for p in (p16, p32))
        out[name] = {"port": port, "fp32_port": fp32, "control": control,
                     "port_share": port / control,
                     "fp32_port_share": fp32 / control}
    return out


def bf16_readings(preset, batch=None):
    """One bf16 mixed-precision step (with history frames) of the port and
    of JAX (``build_model(cfg, dtype=bfloat16)``) from the same fp32
    weights, and JAX's fp32 step, the control.  Returns the port's
    model, optimiser, EMA and metrics, and for ``port`` (the port's bf16
    step against JAX's) and ``control`` (JAX's bf16 step against its
    fp32 one): the losses' largest relative difference, grad_norm's, and
    the gradient's rel-L2 (whole, median, worst tensor); and the initial
    variables."""
    batch = train_batch(preset) if batch is None else batch
    init, after32 = jax_steps(preset, batch)
    _, after16 = jax_steps(preset, batch, dtype=jnp.bfloat16, init=init)
    a32, a16 = after32[True], after16[True]
    cfg = port_cfg(preset)
    port = port_step(preset, init, batch, compute_dtype=torch.bfloat16)
    model, _, _, metrics = port
    zero = zero_gradient_params(model)

    def dist(got_metrics, got_grad, want):
        m = want["metrics"]
        return {"losses": max(abs(got_metrics[k] - v) / abs(v)
                              for k, v in m.items() if k != "grad_norm"),
                "grad_norm": abs(got_metrics["grad_norm"] - m["grad_norm"])
                / m["grad_norm"],
                "grad": gradient_errors(got_grad, clipped_gradient(cfg, want),
                                        zero)}
    j16 = {k: v for k, v in clipped_gradient(cfg, a16).items()
           if k in dict(model.named_parameters())}
    read = {"port": dist(metrics, {k: p.grad.numpy() for k, p in
                                   model.named_parameters()}, a16),
            "control": dist(a16["metrics"], j16, a32)}
    return port, read, init


if __name__ == "__main__":
    import sys
    if sys.argv[2:] == ["bf16"]:
        _, step_read, variables = bf16_readings(sys.argv[1])
        print(step_read)
        for layer, r in bf16_layer_readings(sys.argv[1], variables).items():
            print(f"{layer}: " + ", ".join(f"{k} {v:.2e}"
                                           for k, v in r.items()))
        raise SystemExit(0)
    for case, read in fp32_readings(sys.argv[1]).items():
        print(f"with_prev={case}: " + ", ".join(
            f"{k} {v:.2e}" if isinstance(v, float) else
            f"{k} " + " / ".join(f"{x:.2e}" for x in v)
            for k, v in read.items()))
