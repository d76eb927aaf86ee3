"""Training on the card: DHD-S and DHD-L at full width (losses finite,
each kernel's launches a step, the EMA counter, every stored tensor fp32,
a checkpoint resumed, the BatchNorms' statistics stepped once a frame),
each kernel held against its plain version at the inputs a train step
gives it, the small presets' step against the CPU's, the one-process NCCL
group and ``cli/train --ann-file``.  Every test needs a CUDA device and
skips without one.  No JAX here: on the GPU machine run ``python -m
pytest --noconftest tests/test_torch_card_train.py -q``."""
import dataclasses
import importlib
import io
import math
import re
import socket

import pytest
import torch

from dhd_tpu_torch import profiling
from dhd_tpu_torch.config import get_config
from dhd_tpu_torch.data import synthetic_batch
from dhd_tpu_torch.models import build_model
from dhd_tpu_torch.ops import layer_norm_plain, window_attention_plain
from dhd_tpu_torch.train import (AdamWSchedule, ModelEMA, gradient_errors,
                                 train_step, zero_gradient_params)
from torch_cases import (attention_share, chain_share, check_cost_volume,
                         check_plan, check_pool, check_pool_repeats,
                         full_fp32, launches, ln_share, residual_norm_chain,
                         swin_launches, tiny_dhd_l, window_norm_chain,
                         write_nuscenes_fixture)

pytestmark = pytest.mark.cuda
STEPS = 2
RESUME_NORM_TOL = 3e-5      # grad_norm of a resumed step vs the live one
#                             (the backward's atomics: 9.7e-8 to 6.9e-6)
RESUME_MOMENT_TOL = 1e-3    # exp_avg rel-L2 of a resumed step vs the live
#                             one (the backward's atomics: 1.8e-4)
LOSS_RTOL = 1e-4            # card vs CPU fp32 train-step losses
GRAD_TOLS = (1e-2, 1e-2, 1e-1)  # card vs CPU, rel-L2 of the gradient and
#                                 AdamW's first moment: whole, median
#                                 tensor, worst tensor (2.5-6x the card's
#                                 readings and a rounding control's)
SQ_TOLS = (1e-2, 2e-2, 1e-1)    # AdamW's second moment, ~g^2
UPDATE_LR_TOL = 1e-5        # the card's update against AdamW's formula on
#                             its own moments, in learning rates
DDP_SPREAD, DDP_FLOOR = 4.0, 1e-7   # see test_one_process_nccl_group
# the kernel wrappers of the training path, by the module that calls them
TRAIN_CALLS = (("dhd_tpu_torch.models.dhd", "build_pool_plan"),
               ("dhd_tpu_torch.models.dhd", "mghs_pool_cuda"),
               ("dhd_tpu_torch.ops.cost_volume", "stereo_cost_volume_cuda"),
               ("dhd_tpu_torch.nn.swin", "window_attention_cuda"),
               ("dhd_tpu_torch.nn.swin", "fused_layer_norm_cuda"),
               ("dhd_tpu_torch.nn.swin", "swin_window_norm_cuda"),
               ("dhd_tpu_torch.nn.swin", "swin_residual_norm_cuda"))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _on(batch, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _setup(cfg, dev, seed=0):
    """A model of ``cfg`` in fp32 with seeded weights, its AdamW schedule,
    EMA and dropout generator, as ``cli/train`` builds them."""
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(seed))
    return (model, AdamWSchedule(model.parameters(), cfg.optim, 1000),
            ModelEMA(model, cfg.optim.ema_init_updates, cfg.optim.ema_decay),
            torch.Generator(device=dev).manual_seed(seed + 1))


def _stored_dtypes(model, opt, ema) -> set:
    """The dtypes of everything a training run keeps: params, gradients,
    AdamW's moments, the floating buffers and the EMA."""
    out = {p.dtype for p in model.parameters()}
    out |= {p.grad.dtype for p in model.parameters() if p.grad is not None}
    out |= {b.dtype for b in model.buffers() if b.is_floating_point()}
    out |= {t.dtype for st in opt.adamw.state.values()
            for t in (st["exp_avg"], st["exp_avg_sq"])}
    return out | {t.dtype for t in ema.shadow.values()}


def _train(cfg, dev, b, compute_dtype=None, steps=STEPS):
    """``steps`` train steps of ``cfg`` at B=``b`` on one synthetic batch
    with GT from seed 0, the forward in ``compute_dtype``: every loss and
    grad_norm finite, AdamW's and the EMA's counters stepped, every
    stored tensor fp32.  Returns the run's state, with the kernels'
    launches over the steps."""
    batch = _on(synthetic_batch(cfg, b, seed=0, with_gt=True), dev)
    model, opt, ema, gen = _setup(cfg, dev)

    def step():
        return {k: float(v) for k, v in train_step(
            model, opt, ema, batch, gen,
            compute_dtype=compute_dtype).items()}
    profiling.reset()
    metrics = [step() for _ in range(steps)]
    torch.cuda.synchronize()
    counted = launches()
    assert all(math.isfinite(v) for m in metrics for v in m.values()), \
        metrics
    assert opt.count == steps
    assert ema.updates == cfg.optim.ema_init_updates + steps
    assert _stored_dtypes(model, opt, ema) == {torch.float32}
    return dict(model=model, opt=opt, ema=ema, gen=gen, batch=batch,
                step=step, launches=counted)


def _record(step, inline=None) -> dict:
    """Runs ``step()`` with each function of TRAIN_CALLS replaced, in the
    module that calls it, by one that calls it and keeps a copy of its
    arguments (``build_pool_plan``'s with its result, the plan); where
    ``inline`` names the function, ``inline[name](args, result)`` is
    called instead.  Returns the kept calls by name, in their order."""
    calls = {name: [] for _, name in TRAIN_CALLS}

    def keep(a):
        return a.detach().clone() if torch.is_tensor(a) else a

    def recorded(name, real):
        def call(*args):
            out = real(*args)
            if inline and name in inline:
                inline[name](args, out)
            else:
                calls[name].append((tuple(keep(a) for a in args),
                                    out if name == "build_pool_plan"
                                    else None))
            return out
        return call
    saved = []
    for mod_name, name in TRAIN_CALLS:
        mod = importlib.import_module(mod_name)
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, recorded(name, getattr(mod, name)))
    try:
        step()
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)
    return calls


def _pool_calls(calls) -> list:
    """B1's recorded calls: (depth, feat, band_mask, plan, the (vt,
    PoolIndices, cams shape) of the ``build_pool_plan`` call that made the
    plan)."""
    keys = {id(plan): (vt, idx, shape)
            for (idx, vt, shape), plan in calls["build_pool_plan"]}
    return [(*args[:4], keys[id(args[3])])
            for args, _ in calls["mghs_pool_cuda"]]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_dhd_s_trains_on_the_card(cuda, precision):
    """DHD-S at full width, B=4 (ResNet-50 with remat, HeightNet with DCN
    and ASPP dropout), fp32 or bf16 mixed precision over fp32 weights: B1
    and its plan kernels once a step, in the backward through B1's
    autograd Function; see :func:`_train`."""
    run = _train(get_config("dhd_s"), cuda, 4,
                 torch.bfloat16 if precision == "bf16" else None)
    assert run["launches"] == {"mghs_pool_cuda": STEPS,
                               "pool_plan_cuda": STEPS}


def _first_moments(model, opt) -> dict:
    names = {p: k for k, p in model.named_parameters()}
    return {names[p]: st["exp_avg"].clone()
            for p, st in opt.adamw.state.items()}


def test_a_dhd_s_checkpoint_resumes_on_the_card(cuda):
    """A checkpoint of a DHD-S fp32 run at B=4, loaded into a new model:
    its params bit for bit the saved ones, its counters the run's; its
    next step gives the live run's losses (the forward is deterministic),
    grad_norm within 3e-5 and AdamW's first moment within 1e-3 (rel-L2)
    of the live run's (the backward's atomics are not)."""
    from dhd_tpu_torch.io import load_checkpoint, save_checkpoint

    cfg = get_config("dhd_s")
    run = _train(cfg, cuda, 4)
    model, opt, ema, gen, batch = (run[k] for k in ("model", "opt", "ema",
                                                    "gen", "batch"))
    buf = io.BytesIO()
    save_checkpoint(buf, model, opt, ema, step=opt.count, generator=gen)
    saved = {k: p.detach().clone() for k, p in model.named_parameters()}
    live = run["step"]()
    live_avg = _first_moments(model, opt)
    del run, model, opt, ema
    torch.cuda.empty_cache()
    model, opt, ema, gen = _setup(cfg, cuda, seed=123)
    buf.seek(0)
    assert load_checkpoint(buf, model, opt, ema, gen) == STEPS
    assert all(torch.equal(p, saved[k]) for k, p in model.named_parameters())
    del saved
    resumed = {k: float(v) for k, v in train_step(
        model, opt, ema, batch, gen).items()}
    assert ema.updates == cfg.optim.ema_init_updates + STEPS + 1
    assert max(abs(resumed[k] - v) / abs(v) for k, v in live.items()
               if k != "grad_norm") <= 1e-6
    assert abs(resumed["grad_norm"] - live["grad_norm"]) \
        <= RESUME_NORM_TOL * live["grad_norm"]
    got = _first_moments(model, opt)
    err = math.sqrt(sum(float((got[k] - v).double().square().sum())
                        for k, v in live_avg.items())
                    / sum(float(v.double().square().sum())
                          for v in live_avg.values()))
    assert err <= RESUME_MOMENT_TOL


def test_b1_at_a_dhd_s_train_steps_inputs(cuda):
    """B1 and its plan kernels at the fp32 B=4 inputs and keys one DHD-S
    train step gives them: ``torch_cases.check_pool`` (fp32, against the
    exact sums), two calls bit-identical, ``check_plan``."""
    run = _train(get_config("dhd_s"), cuda, 4, steps=1)
    calls = _record(run["step"])
    del run
    torch.cuda.empty_cache()
    cases = _pool_calls(calls)
    assert len(cases) == 1
    *args, keys = cases[0]
    check_pool(*args)
    check_pool_repeats(*args)
    check_plan(keys, args[3])


def _adamw_update_error(cfg, before, after, moments, lr) -> float:
    """The largest distance, in learning rates, of AdamW's first step from
    zero moments (params ``before`` -> ``after``, by name) from the formula
    on its own moments: p (1 - lr wd) - lr m^ / (sqrt(v^) + eps), m^ = m /
    (1 - b1), v^ = v / (1 - b2); each element's own fp32 rounding, 2^-22
    of |p|, aside."""
    worst = 0.0
    for k, p0 in before.items():
        p0, m, v = (t.double() for t in (p0, moments["exp_avg"][k],
                                          moments["exp_avg_sq"][k]))
        want = p0 * (1 - lr * cfg.optim.weight_decay) - lr * (m / 0.1) / (
            (v / 1e-3).sqrt() + 1e-8)
        err = (after[k].double() - want).abs() - 2.0 ** -22 * p0.abs()
        worst = max(worst, float(err.max()) / lr)
    return worst


@pytest.mark.parametrize("name", ["dhd_tiny", "dhd_micro_stereo",
                                  "tiny_dhd_l"])
def test_a_small_train_step_on_the_card_follows_the_cpu(cuda, name):
    """One train step at the full learning rate (the schedule past its
    warmup) in fp32 without TF32, dropout and DropPath off, on the card
    and on the CPU from the same weights and batch: the losses within
    1e-4; the gradients and AdamW's moments within GRAD_TOLS and SQ_TOLS
    (rel-L2 of the whole, the median and the worst tensor: flipped ReLU
    gates move single tensors, ``train/compare.py``); the card's update
    within 1e-5 learning rates of AdamW's formula on its own moments; B1
    once a frame, B3 in a stereo model, B4 and B5 in tiny DHD-L's history
    and extra frames."""
    from dhd_tpu_torch.nn.swin import DropPath

    cfg = tiny_dhd_l(get_config) if name == "tiny_dhd_l" \
        else get_config(name)
    cfg = dataclasses.replace(
        cfg, heightnet_cfg=dataclasses.replace(cfg.heightnet_cfg,
                                               aspp_dropout=0.0),
        depthnet_cfg=dataclasses.replace(cfg.depthnet_cfg, aspp_dropout=0.0))
    batch = synthetic_batch(cfg, 2, seed=5, varied_rig=True)
    tols = {"grad": GRAD_TOLS, "exp_avg": GRAD_TOLS, "exp_avg_sq": SQ_TOLS}
    runs, weights = {}, None
    with full_fp32():
        for side in ("card", "cpu"):
            dev = cuda if side == "card" else torch.device("cpu")
            model, opt, ema, _ = _setup(cfg, dev, seed=7)
            for m in model.modules():
                if isinstance(m, DropPath):
                    m.rate = 0.0
            if weights is None:
                weights = {k: v.cpu().clone()
                           for k, v in model.state_dict().items()}
            else:
                model.load_state_dict(weights)
            init = {k: p.detach().cpu().clone()
                    for k, p in model.named_parameters()}
            opt.count = cfg.optim.warmup_iters      # the full rate from here
            lr = opt.schedule(opt.count)
            profiling.reset()
            m = train_step(model, opt, ema, _on(batch, dev))
            counted = launches()
            names = {p: k for k, p in model.named_parameters()}
            run = {"metrics": {k: float(v) for k, v in m.items()},
                   "grad": {k: p.grad.cpu().clone()
                            for k, p in model.named_parameters()},
                   "params": {k: p.detach().cpu().clone()
                              for k, p in model.named_parameters()}}
            for key in ("exp_avg", "exp_avg_sq"):
                run[key] = {names[p]: st[key].cpu().clone()
                            for p, st in opt.adamw.state.items()}
            runs[side] = run
            if side == "card":
                card_launches = counted
                update_err = _adamw_update_error(cfg, init, run["params"],
                                                 run, lr)
    want = {"mghs_pool_cuda": 2 if cfg.temporal else 1,
            "pool_plan_cuda": 2 if cfg.temporal else 1}
    if cfg.stereo:
        want["stereo_cost_volume_cuda"] = card_launches.get(
            "stereo_cost_volume_cuda", 0)
        assert want["stereo_cost_volume_cuda"] > 0
    if cfg.backbone == "swin_base":
        # the history frame's whole Swin and the extra stereo frame's stage
        # 0; the key frame takes the plain versions under autograd; with
        # the DropPath rates at 0 every block's LayerNorms take the fused
        # launches
        want.update(swin_launches(cfg, 1, 1))
    assert card_launches == want
    zero = zero_gradient_params(model)
    mg, mc = runs["card"]["metrics"], runs["cpu"]["metrics"]
    assert max(abs(mg[k] - v) / abs(v) for k, v in mc.items()
               if k != "grad_norm") <= LOSS_RTOL
    for key, tol in tols.items():
        read = gradient_errors(runs["card"][key], runs["cpu"][key], zero)
        assert all(r <= t for r, t in zip(read, tol)), (key, read)
    assert update_err <= UPDATE_LR_TOL


def _swin_holds(shares: dict):
    """``inline`` functions for :func:`_record` that hold B4 and B5
    against their plain versions at every call of a step, on the spot (a
    DHD-L step makes 85 of them, whose inputs would take GBs): the worst
    share of each call's bar (``torch_cases.attention_share``,
    ``ln_share``) gathered under ``shares[name]``; B5's two Swin block
    launches against their chain, bit for bit (``chain_share``)."""
    def attention(args, out_k):
        shares.setdefault("window_attention_cuda", []).append(
            attention_share(out_k, window_attention_plain(*args)))

    def layer_norm(args, y_k):
        x, w, b, eps = args
        shares.setdefault("fused_layer_norm_cuda", []).append(
            ln_share(y_k, layer_norm_plain(x, w, b, eps), x, w, b, eps))
    def chain(name, fn):
        def hold(args, out):
            shares.setdefault(name, []).append(chain_share(out, fn(*args)))
        return hold
    return {"window_attention_cuda": attention,
            "fused_layer_norm_cuda": layer_norm,
            "swin_window_norm_cuda": chain("swin_window_norm_cuda",
                                           window_norm_chain),
            "swin_residual_norm_cuda": chain("swin_residual_norm_cuda",
                                             residual_norm_chain)}


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_dhd_l_trains_on_the_card(cuda, precision):
    """DHD-L at full width (Swin-B at 512x1408 with block remat and
    DropPath 0.1, FPN_LSS, stereo, one history frame), B=2 (fp32 at B=1
    where B=2 does not fit): B1, its plan kernels and B3 twice a step
    (history and key frame), B4 and B5 in the history and extra frames;
    each BatchNorm steps its statistics once a frame it runs in (the image
    neck twice a step, the BEV encoder once); see :func:`_train`.  Then
    one more step with every kernel held against its plain version at the
    inputs the step gives it: B1, its plan kernels and B3 at the history
    and the key frame's, B4 and B5 at each of their calls (B5's fused
    launches against the block's chain, bit for bit)."""
    cfg = get_config("dhd_l")
    dtype = torch.bfloat16 if precision == "bf16" else None
    try:
        run = _train(cfg, cuda, 2, dtype)
    except torch.cuda.OutOfMemoryError:
        if dtype is not None:
            raise
        torch.cuda.empty_cache()
        run = _train(cfg, cuda, 1, dtype)
    # B4 and B5 in the history frame's whole Swin and the extra stereo
    # frame's stage 0, B5's fused launches in their first block (DropPath
    # rate 0); the key frame takes the plain versions under autograd
    swin = swin_launches(cfg, 1, 1, train=True)
    per_step = {"mghs_pool_cuda": 2, "pool_plan_cuda": 2,
                "stereo_cost_volume_cuda": 2, **swin}
    assert run["launches"] == {k: STEPS * v for k, v in per_step.items()}
    tracked = {k: int(v) for k, v in run["model"].state_dict().items()
               if k.endswith("num_batches_tracked")}
    assert tracked["img_neck.conv.1.num_batches_tracked"] == 2 * STEPS
    assert tracked["img_bev_encoder_neck.conv.1.num_batches_tracked"] \
        == STEPS
    assert set(tracked.values()) <= {STEPS, 2 * STEPS}

    shares = {}
    calls = _record(run["step"], _swin_holds(shares))
    del run
    torch.cuda.empty_cache()
    cases = _pool_calls(calls)
    assert len(cases) == 2 and len(calls["stereo_cost_volume_cuda"]) == 2
    assert {k: len(v) for k, v in shares.items()} == swin
    assert all(s <= 1 for v in shares.values() for s in v), shares
    for (*args, keys), (cv_args, _) in zip(
            cases, calls["stereo_cost_volume_cuda"]):
        check_pool(*args, loose=True)
        check_pool_repeats(*args)
        check_plan(keys, args[3])
        check_cost_volume(*cv_args)


def _steps_with_stats(cfg, dev, batch, steps=2):
    """``steps`` bf16 train steps of ``cfg`` from seed 0 on ``batch``:
    the metrics of each and the BatchNorm statistics after each."""
    model, opt, ema, gen = _setup(cfg, dev)
    out = []
    for _ in range(steps):
        m = train_step(model, opt, ema, batch, gen,
                       compute_dtype=torch.bfloat16)
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.clone() for k, v in model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}))
    return out


def _step_errors(run, ref):
    """Relative differences of two runs of :func:`_steps_with_stats`: the
    first step's grad_norm, the second step's metrics, and its BatchNorm
    statistics (of each tensor's peak)."""
    (a1, _), (a2, abn2) = run
    (b1, _), (b2, bbn2) = ref
    yield abs(a1["grad_norm"] - b1["grad_norm"]) / b1["grad_norm"]
    yield from (abs(a2[k] - v) / abs(v) for k, v in b2.items())
    yield from (float((abn2[k] - v).abs().max()
                      / v.abs().max().clamp_min(1e-12))
                for k, v in bbn2.items())


def test_one_process_nccl_group_on_the_card(cuda, capsys, monkeypatch):
    """``initialize_distributed`` starts a one-process NCCL group; two
    DHD-S bf16 train steps at B=4 on a varied rig through it (SyncBN, the
    losses' global sums, the gradients' all-reduce) against the same
    steps without a group, run twice: the first step's losses and
    BatchNorm statistics bit for bit (a forward is deterministic and a
    group of one sums nothing); grad_norm and the second step, which
    starts from the first's update, within 4x the spread of the two runs
    without a group (the backward's atomics) plus 1e-7.  ``cli/test
    --synthetic`` runs under the group.  The group is destroyed at the
    end, also on a failure."""
    from dhd_tpu_torch import parallel
    from dhd_tpu_torch.cli.test import main as evaluate

    cfg = get_config("dhd_s")
    # on the plain synthetic rig the camera embedding's BatchNorm
    # normalises rounding noise, and two runs of one step part by percents
    batch = _on(synthetic_batch(cfg, 4, seed=0, with_gt=True,
                                varied_rig=True), cuda)
    alone = _steps_with_stats(cfg, cuda, batch)
    control = _steps_with_stats(cfg, cuda, batch)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     WORLD_SIZE="1", RANK="0", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    try:
        assert parallel.initialize_distributed(cuda, always=True)
        assert parallel.is_distributed()
        profiling.reset()
        group = _steps_with_stats(cfg, cuda, batch)
        counted = launches()
        capsys.readouterr()
        assert evaluate(["--preset", "dhd_s", "--synthetic"]) == 0
        text = capsys.readouterr().out
        assert parallel.is_distributed()
    finally:
        parallel.shutdown()
    assert not parallel.is_distributed()
    assert counted == {"mghs_pool_cuda": 2, "pool_plan_cuda": 2}
    (m1, bn1), (p1, pbn1) = group[0], alone[0]
    assert {k: v for k, v in m1.items() if k != "grad_norm"} \
        == {k: v for k, v in p1.items() if k != "grad_norm"}
    assert all(torch.equal(bn1[k], pbn1[k]) for k in bn1)
    spread = max(_step_errors(control, alone))
    assert max(_step_errors(group, alone)) <= DDP_SPREAD * spread + DDP_FLOOR
    assert "evaluated 2 samples" in text and "===> mIoU: " in text


def test_train_cli_ann_file_on_the_card(cuda, capsys, tmp_path):
    """``cli/train --ann-file`` for 2 steps at B=2 on four samples in
    nuScenes' format, six 1600x900 JPEG cameras and a lidar sweep each:
    the train pipeline's augmentation and its lidar projection through
    ``native/`` (built with g++ on the card's host); B1 once a step,
    every logged loss finite."""
    from dhd_tpu_torch.cli.train import main as train

    pkl = write_nuscenes_fixture(str(tmp_path), 4)
    capsys.readouterr()
    profiling.reset()
    assert train(["--preset", "dhd_s", "--ann-file", pkl, "--steps", "2",
                  "--batch-size", "2", "--log-interval", "1"]) == 0
    text = capsys.readouterr().out
    assert profiling.kernel_launches()["mghs_pool_cuda"] == 2
    lines = [ln for ln in text.splitlines() if "loss_total=" in ln]
    assert len(lines) == 2, text
    losses = [float(v) for ln in lines
              for v in re.findall(r"=([-\d.e+naif]+)", ln)]
    assert losses and all(math.isfinite(v) for v in losses), lines
