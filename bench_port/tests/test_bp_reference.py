"""The frozen reference against the port, in fp32 on the CPU, with the
benchmark's seeded weights handed to both: a forward, a two-frame stream
and one train step's losses and updated weights."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import bp_helpers as H

from bench_port import inputs
from bench_port.reference import models as ref_models
from bench_port.reference import train as ref_train
from bench_port.weights import make_weights

TOL = 1e-5          # of the reference's peak: both run the same fp32 ops


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _pair(cfg, preset):
    import dataclasses

    from dhd_tpu_torch.models import build_model
    from bench_port.loops import _replace
    from dhd_tpu_torch import get_config
    port = build_model(_replace(get_config(preset),
                                dataclasses.asdict(cfg)), device=H.CPU)
    ref = ref_models.build_model(cfg, device=H.CPU)
    weights = make_weights(cfg, 11, H.CPU, gain=2.0)
    port.load_state_dict(weights)
    ref.load_state_dict(weights)
    return port, ref


def _close(a, b):
    a, b = a.float(), b.float()
    assert float((a - b).abs().max()) <= TOL * float(b.abs().max())


def test_forward_dhd_tiny():
    cfg = H.get_config("dhd_tiny")
    port, ref = _pair(cfg, "dhd_tiny")
    rig = inputs.on_device(inputs.rig(cfg, 3), H.CPU)
    frame = dict(rig, sensor2keyego=rig["sensor2ego"],
                 imgs=inputs.image_pool(cfg, 1, 4, H.CPU, torch.float32)[0])
    with torch.no_grad():
        _close(port(frame)["occ_logits"], ref(frame)["occ_logits"])


@pytest.mark.parametrize("make", [lambda: H.get_config("dhd_tiny_stereo"),
                                  H.tiny_dhd_l],
                         ids=["dhd_tiny_stereo", "tiny_dhd_l"])
def test_two_frame_stream(make):
    cfg = make()
    port, ref = _pair(cfg, "dhd_tiny_stereo")
    rig = inputs.rig(cfg, 5)
    geom = inputs.on_device({k: v for k, v in rig.items()
                             if k != "ego2global"}, H.CPU)
    poses = inputs.ego_poses(rig, 2, 0.5, H.CPU)
    pool = inputs.image_pool(cfg, 2, 6, H.CPU, torch.float32)
    c_port, c_ref = {}, {}
    with torch.no_grad():
        for i in range(2):
            frame = dict(geom, imgs=pool[i], ego2global=poses[i])
            o_port, c_port = port(frame, cache=c_port)
            o_ref, c_ref = ref(frame, cache=c_ref)
            _close(o_port["occ_logits"], o_ref["occ_logits"])
    _close(c_port["vox"], c_ref["vox"])


@pytest.mark.parametrize("make,preset", [
    (lambda: H.get_config("dhd_tiny"), "dhd_tiny"),
    (H.tiny_dhd_l, "dhd_tiny_stereo")], ids=["dhd_tiny", "tiny_dhd_l"])
def test_train_step(make, preset):
    from dhd_tpu_torch.train import AdamWSchedule, ModelEMA, train_step
    cfg = make()
    port, ref = _pair(cfg, preset)
    batch = inputs.train_batch(cfg, 2, 9, H.CPU)
    out = []
    for model, opt_cls, ema_cls, step in (
            (port, AdamWSchedule, ModelEMA, train_step),
            (ref, ref_train.AdamWSchedule, ref_train.ModelEMA,
             ref_train.train_step)):
        opt = opt_cls(model.parameters(), cfg.optim, 1000)
        ema = ema_cls(model, cfg.optim.ema_init_updates, cfg.optim.ema_decay)
        m = step(model, opt, ema, batch, torch.Generator().manual_seed(2))
        out.append(({k: float(v) for k, v in m.items()},
                    {k: p.detach().clone()
                     for k, p in model.named_parameters()}))
    (l_port, p_port), (l_ref, p_ref) = out
    assert set(l_port) == set(l_ref)
    for k in l_ref:
        assert l_port[k] == pytest.approx(l_ref[k], rel=1e-5), k
    worst = max(float((p_port[k] - v).abs().max()) for k, v in p_ref.items())
    assert worst <= 1e-6
    assert np.isfinite(l_ref["loss_total"])
