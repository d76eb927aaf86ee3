"""The three loop kinds a traffic mix names (``"loop"`` in its file).

* ``stream``: a car's rig served frame by frame through the port's
  ``DHDStereoNet.forward(frame, cache=...)``, one frame in flight (closed
  loop), B=1, the pool plan and ``cv_static`` built once per rig in set-up;
  a new image set each frame from a pool made on the card, the ego
  ``ego_step_m`` further along each frame.
* ``serve``: the same closed loop for a single-frame model,
  ``DHDNet.forward(batch)`` with the rig's cached ``pool_plan``.
* ``train``: the port's ``train_step`` back to back, AdamW and EMA, the
  forward in the configuration's precision over fp32 weights, on batches
  with ground truth drawn in turn from a pool made on the card.

A frame ends when its occupancy argmax is on the host; a step ends at a
synchronize.  Each loop keeps what the program produced for the check
against the plain reference (``check``), which runs once the window has
closed and the program's state is freed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench_port import flops, inputs
from bench_port.reference import fp32_exact
from bench_port.reference.config import ModelConfig, config_from_dict
from bench_port.reference.models import build_model as build_reference
from bench_port.reference.nn.layers import (compute_in_fp8,
                                            compute_operands_in_fp8)
from bench_port.weights import make_weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FAULTS = ("state_unchanged", "half_batch", "answer_altered")
MAX_FRAMES = 12_000     # poses made for a stream: 51 s at 4 ms a frame


def _replace(inst, d: dict):
    """``inst`` (a config dataclass) with the values of ``d`` (nested
    dicts for nested dataclasses, lists read as tuples)."""
    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v
    kw = {k: (_replace(getattr(inst, k), v) if isinstance(v, dict)
              else tup(v)) for k, v in d.items()}
    return dataclasses.replace(inst, **kw)


def port_config(config: dict):
    """The port's ModelConfig of a configuration file: its preset with
    every value of the file's ``model`` set."""
    from dhd_tpu_torch import get_config
    return _replace(get_config(config["preset"]), config["model"])


def _free():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Loop:
    """Set-up, the window, and the check of one cell."""
    kind = ""           # "serve" or "train": which metrics it reports

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, fault: Optional[str] = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.fault = seed, device, fault
        self.cfg: ModelConfig = config_from_dict(config["model"])
        self.dtype = DTYPES[config["precision"]]
        self.latencies: List[float] = []
        self.done = 0               # items finished in the window

    # the window --------------------------------------------------------
    def item(self) -> None:
        """One frame or step, to its end on the host."""
        raise NotImplementedError

    def run_until(self, deadline: float, min_items: int = 0) -> float:
        """Items back to back until one ends past ``deadline`` and at
        least ``min_items`` have run; returns the host time of the last
        end."""
        end = time.perf_counter()
        n = 0
        while end < deadline or n < min_items:
            n += 1
            t0 = time.perf_counter()
            self.item()
            end = time.perf_counter()
            self.latencies.append(end - t0)
            self.done += 1
        return end

    def run_traced(self, n: int, trace_fn: Callable, host: bool = False
                   ) -> object:
        """``n`` items under the profiler (with ``host``, the host's side
        and the loop's ranges too); they count as items of the window but
        not in its latencies."""
        def run():
            for _ in range(n):
                self.item()
        if host:
            with self.ranges():
                tr = trace_fn(run, n, host=True)
        else:
            tr = trace_fn(run, n)
        self.done += n
        return tr

    def ranges(self):
        raise NotImplementedError

    # after the window --------------------------------------------------
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        raise NotImplementedError

    def check(self, count_flops: bool = False) -> Dict[str, float]:
        """The numbers compared with the plain reference."""
        raise NotImplementedError

    def flops_per_item(self) -> Optional[float]:
        """The reference's model FLOPs of one frame or step, from the
        cache (counted by :meth:`check` with ``count_flops``)."""
        return flops.cached(self.flops_key())

    def flops_key(self) -> str:
        return flops.key(self.config, self.traffic, self.kind)

    def weights(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """The seed's weights in ``dtype``, at the mix's weight scale."""
        return make_weights(self.cfg, self.seed, self.device, dtype,
                            self.traffic.get("weight_gain", 1.0))

    def reference(self):
        """The plain reference in fp32 on the card with the seed's weights
        as the program got them (rounded to its type, then widened)."""
        ref = build_reference(self.cfg, device=self.device)
        ref.load_state_dict(self.weights(self.weight_dtype))
        return ref

    weight_dtype = torch.float32


class _Serving(Loop):
    kind = "serve"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.weight_dtype = self.dtype
        tr = self.traffic
        self.rig = inputs.rig(self.cfg, self.seed)
        self.pool = inputs.image_pool(self.cfg, tr["image_pool"],
                                      self.seed + 1, self.device, self.dtype)
        self.served: List[np.ndarray] = []      # argmax of every frame
        self.frame_no = 0

    def images(self, i: int) -> torch.Tensor:
        return self.pool[i % self.pool.shape[0]]

    def pool_geometry(self) -> Dict[str, torch.Tensor]:
        """The geometry the frame's pooling sees (sensor2keyego, intrins,
        post_rots, post_trans, bda), for the bounds of the kernels."""
        raise NotImplementedError

    def build_program(self):
        from dhd_tpu_torch.models import build_model
        model = build_model(port_config(self.config), dtype=self.dtype,
                            device=self.device,
                            generator=torch.Generator().manual_seed(0))
        model.load_state_dict(self.weights(self.dtype))
        return model

    def finish(self, out: Dict[str, torch.Tensor]) -> None:
        """The frame's argmax to the host: where a served frame ends."""
        cls = out["occ_logits"].argmax(dim=-1).to(torch.uint8).cpu().numpy()
        if self.fault == "answer_altered":     # the lowest layer moved
            cls = cls.copy()
            cls[..., 0] = (cls[..., 0] + self.cfg.num_classes // 2
                           ) % self.cfg.num_classes
        self.served.append(cls)
        self.frame_no += 1

    def setup(self) -> None:
        for _ in range(self.traffic["warm_frames"]):
            self.item()

    def ranges(self):
        from bench_port.trace import module_ranges
        return module_ranges(self.model, self.range_methods)

    range_methods: tuple = ()

    def release(self) -> None:
        del self.model
        _free()

    def sample(self) -> List[int]:
        """The frames compared: ``compared_frames`` of the window's, drawn
        from the seed (a run of consecutive frames for a stream)."""
        raise NotImplementedError

    def compare(self, ref_logits: torch.Tensor, served: np.ndarray,
                sums: Dict[str, float]) -> None:
        """Fold one frame into the serving numbers: the widest gap by which
        a served class's reference logit lies below the reference's best
        (in units of the reference logits' standard deviation), that gap's
        mean over every voxel, and the share of voxels served another
        class than the reference's argmax."""
        ref = ref_logits.float()
        c = torch.as_tensor(served, device=ref.device).long()
        gap = ref.max(dim=-1).values - ref.gather(-1, c[..., None])[..., 0]
        scale = float(ref.std())
        sums["worst_gap"] = max(sums.get("worst_gap", 0.0),
                                float(gap.max()) / scale)
        sums["gap"] = sums.get("gap", 0.0) + float(gap.sum()) / scale
        sums["flipped"] = sums.get("flipped", 0.0) + float((gap > 0).sum())
        sums["voxels"] = sums.get("voxels", 0.0) + gap.numel()

    @staticmethod
    def numbers(sums: Dict[str, float]) -> Dict[str, float]:
        return {"worst_gap": sums["worst_gap"],
                "mean_gap": sums["gap"] / sums["voxels"],
                "flip_share": sums["flipped"] / sums["voxels"]}


class StreamLoop(_Serving):
    """``stream``: DHDStereoNet's streaming step, one frame in flight."""
    range_methods = ("_cost_volume",)

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        dev = self.device
        self.geom = inputs.on_device(
            {k: v for k, v in self.rig.items() if k != "ego2global"}, dev)
        self.poses = inputs.ego_poses(self.rig, MAX_FRAMES,
                                      self.traffic["ego_step_m"], dev)
        self.cache: Dict = {}

    def setup(self) -> None:
        """The program with the seed's weights, the rig's pool plan and
        ``cv_static``, and the warm-up frames (the first a bootstrap)."""
        from dhd_tpu_torch.models import (build_stream_cv_static,
                                          build_stream_pool_plan)
        self.model = self.build_program()
        first = self.frame(0)
        self.fixed = {
            "pool_plan": build_stream_pool_plan(self.model.cfg, first,
                                                device=self.device),
            "cv_static": build_stream_cv_static(self.model.cfg, first,
                                                device=self.device)}
        super().setup()

    def frame(self, i: int) -> Dict[str, torch.Tensor]:
        return dict(self.geom, imgs=self.images(i),
                    ego2global=self.poses[i])

    def pool_geometry(self) -> Dict[str, torch.Tensor]:
        from bench_port.reference.models.dhd_stereo import stream_geometry
        frame = self.frame(0)
        s2k, _ = stream_geometry(frame["sensor2ego"].float(),
                                 frame["ego2global"].float())
        return dict(frame, sensor2keyego=s2k)

    def item(self) -> None:
        frame = dict(self.frame(self.frame_no), **self.fixed)
        out, cache = self.model(frame, cache=self.cache)
        if self.fault != "state_unchanged" or not self.cache:
            self.cache = cache
        self.finish(out)

    def sample(self) -> List[int]:
        first = self.traffic["warm_frames"]
        last = self.frame_no - self.traffic["compared_frames"]
        k0 = int(np.random.default_rng(self.seed).integers(first, last + 1))
        return list(range(k0, k0 + self.traffic["compared_frames"]))

    def check(self, count_flops: bool = False) -> Dict[str, float]:
        return self.check_frames(self.sample(), count_flops)

    def check_frames(self, frames: List[int], count_flops: bool = False,
                     fp8: bool = False) -> Dict[str, float]:
        """The reference streams from two frames before the first compared
        one, from an empty cache: a frame's output depends on its own
        images, the previous frame's grids and stereo features, and the
        stereo features of the one before."""
        ref = self.reference()
        ctrl = None
        if fp8:
            ctrl = self.reference()
            compute_operands_in_fp8(ctrl)
        sums: Dict[str, float] = {}
        cache: Dict = {}
        ctrl_cache: Dict = {}
        with torch.no_grad(), fp32_exact():
            for i in range(max(frames[0] - 2, 0), frames[-1] + 1):
                frame = self.frame(i)
                last = i == frames[-1]
                if count_flops and last:
                    out, cache = flops.count_into(
                        self.flops_key(), lambda: ref(frame, cache=cache))
                else:
                    out, cache = ref(frame, cache=cache)
                if i not in frames:
                    if ctrl is not None:
                        _, ctrl_cache = ctrl(frame, cache=ctrl_cache)
                    continue
                if ctrl is not None:
                    cout, ctrl_cache = ctrl(frame, cache=ctrl_cache)
                    served = cout["occ_logits"].argmax(-1).to(torch.uint8)
                else:
                    served = self.served[i]
                self.compare(out["occ_logits"], served, sums)
        del ref, ctrl, cache, ctrl_cache
        _free()
        return self.numbers(sums)


class ServeLoop(_Serving):
    """``serve``: DHDNet's single-frame forward with the cached pool
    plan."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.geom = inputs.on_device(
            {k: v for k, v in self.rig.items() if k != "ego2global"},
            self.device)
        self.geom["sensor2keyego"] = self.geom["sensor2ego"]

    def setup(self) -> None:
        """The program with the seed's weights, the rig's pool plan, and
        the warm-up frames."""
        from dhd_tpu_torch.models import build_batch_pool_plan
        self.model = self.build_program()
        self.fixed = {"pool_plan": build_batch_pool_plan(
            self.model.cfg, self.frame(0), device=self.device)}
        super().setup()

    def frame(self, i: int) -> Dict[str, torch.Tensor]:
        return dict(self.geom, imgs=self.images(i))

    def pool_geometry(self) -> Dict[str, torch.Tensor]:
        return self.frame(0)

    def item(self) -> None:
        out = self.model(dict(self.frame(self.frame_no), **self.fixed))
        self.finish(out)

    def sample(self) -> List[int]:
        first = self.traffic["warm_frames"]
        rng = np.random.default_rng(self.seed)
        n = min(self.traffic["compared_frames"], self.frame_no - first)
        return sorted(int(i) for i in rng.choice(
            np.arange(first, self.frame_no), n, replace=False))

    def check(self, count_flops: bool = False) -> Dict[str, float]:
        return self.check_frames(self.sample(), count_flops)

    def check_frames(self, frames: List[int], count_flops: bool = False,
                     fp8: bool = False) -> Dict[str, float]:
        ref = self.reference()
        if fp8:
            ctrl = self.reference()
            compute_operands_in_fp8(ctrl)
        sums: Dict[str, float] = {}
        with torch.no_grad(), fp32_exact():
            for n, i in enumerate(frames):
                frame = self.frame(i)
                if count_flops and n == 0:
                    out = flops.count_into(self.flops_key(),
                                           lambda: ref(frame))
                else:
                    out = ref(frame)
                served = (ctrl(frame)["occ_logits"].argmax(-1)
                          .to(torch.uint8) if fp8 else self.served[i])
                self.compare(out["occ_logits"], served, sums)
        del ref
        _free()
        return self.numbers(sums)


class TrainLoop(Loop):
    """``train``: the port's train step; set-up takes the first
    ``checked_steps`` steps, which the reference follows."""
    kind = "train"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        tr = self.traffic
        self.batch_size = self.config["train_batch"]
        self.batches = [inputs.train_batch(self.cfg, self.batch_size,
                                           self.seed + 10 + k, self.device)
                        for k in range(tr["batch_pool"])]
        self.step_no = 0
        self.losses: List[float] = []
        self.gnorms: List[float] = []

    def build_program(self) -> None:
        from dhd_tpu_torch.models import build_model
        from dhd_tpu_torch.train import AdamWSchedule, ModelEMA
        self.model = build_model(port_config(self.config),
                                 device=self.device,
                                 generator=torch.Generator().manual_seed(0))
        self.model.load_state_dict(self.weights(torch.float32))
        optim = self.model.cfg.optim
        self.opt = AdamWSchedule(self.model.parameters(), optim,
                                 self.traffic["steps_per_epoch"])
        self.ema = ModelEMA(self.model, optim.ema_init_updates,
                            optim.ema_decay)
        self.gen = torch.Generator(device=self.device).manual_seed(
            self.seed + 1)

    def item(self) -> None:
        self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def step(self) -> Dict[str, torch.Tensor]:
        from dhd_tpu_torch.train import train_step
        batch = self.batches[self.step_no % len(self.batches)]
        if self.fault == "half_batch":
            batch = {k: v[: self.batch_size // 2] for k, v in batch.items()}
        kept = ([p.detach().clone() for p in self.model.parameters()]
                if self.fault == "state_unchanged" else None)
        metrics = train_step(self.model, self.opt, self.ema, batch,
                             self.gen, compute_dtype=self.dtype)
        if kept is not None:
            with torch.no_grad():
                for p, k in zip(self.model.parameters(), kept):
                    p.copy_(k)
        self.step_no += 1
        return metrics

    def setup(self) -> None:
        """The first ``checked_steps`` steps, read for the check: each
        loss, the first step's gradient from AdamW's first moment, and
        each parameter's change over the steps."""
        self.build_program()
        params = dict(self.model.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        b1 = self.opt.adamw.param_groups[0]["betas"][0]
        for n in range(self.traffic["checked_steps"]):
            with _first_logits(self.model, n == 0) as seen:
                m = self.step()
            if n == 0:
                self.logits = seen[0].cpu()
            self.losses.append(float(m["loss_total"]))
            self.gnorms.append(float(m["grad_norm"]))
            if n == 0:
                state = self.opt.adamw.state
                self.grad_norms = {
                    k: float(state[p]["exp_avg"].norm()) / (1.0 - b1)
                    for k, p in params.items() if p in state}
        self.change_norms = {k: float((p.detach() - start[k]).norm())
                             for k, p in params.items()}
        del start
        _free()

    def ranges(self):
        return contextlib.nullcontext()

    def release(self) -> None:
        del self.model, self.opt, self.ema
        _free()

    def check(self, count_flops: bool = False) -> Dict[str, float]:
        return self.compare(self.follow(fp8=False), count_flops)

    def follow(self, fp8: bool) -> Dict:
        """The reference (fp32, TF32 off) through the same first steps:
        the same weights, batches and dropout draws.  With ``fp8`` it is
        the control: its forward in the configuration's precision with
        fp8 wherever that holds bf16 (:func:`compute_in_fp8`)."""
        from bench_port.reference.train import (AdamWSchedule, ModelEMA,
                                                train_step)
        ref = self.reference()
        if fp8:
            compute_in_fp8(ref)
        optim = self.cfg.optim
        opt = AdamWSchedule(ref.parameters(), optim,
                            self.traffic["steps_per_epoch"])
        ema = ModelEMA(ref, optim.ema_init_updates, optim.ema_decay)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        params = dict(ref.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        losses, gnorms, grads = [], [], {}
        with fp32_exact():
            for n in range(self.traffic["checked_steps"]):
                with _first_logits(ref, n == 0) as seen:
                    m = train_step(ref, opt, ema, self.batches[n], gen,
                                   compute_dtype=self.dtype if fp8 else None)
                if n == 0:
                    logits = seen[0]
                losses.append(float(m["loss_total"]))
                gnorms.append(float(m["grad_norm"]))
                if n == 0:
                    grads = {k: float(p.grad.norm())
                             for k, p in params.items()}
        change = {k: float((p.detach() - start[k]).norm())
                  for k, p in params.items()}
        self.ref_model = ref
        return {"losses": losses, "gnorms": gnorms, "grads": grads,
                "change": change, "logits": logits,
                "sizes": {k: p.numel() for k, p in params.items()}}

    def compare(self, ref: Dict, count_flops: bool) -> Dict[str, float]:
        """The first step's occupancy logits (the mean absolute gap over
        the reference logits' standard deviation), each step's loss (the
        worst relative gap, and the first step's), the first gradient and
        the change, each by its worst leaf and by its median leaf: the gap
        between the program's norm and the reference's, over the
        reference's norm of that leaf or of the median leaf, whichever is
        larger.  Leaves whose reference gradient is under a thousandth of
        the median leaf's move by round-off alone and are left out of the
        change."""
        gaps = [abs(a - b) / abs(b)
                for a, b in zip(self.losses, ref["losses"])]
        gnorm = [abs(a - b) / abs(b)
                 for a, b in zip(self.gnorms, ref["gnorms"])]
        g_ref = ref["grads"]
        g_med = float(np.median(list(g_ref.values())))
        grad = [abs(self.grad_norms.get(k, 0.0) - v) / max(v, g_med)
                for k, v in g_ref.items()]
        moving = [k for k, v in g_ref.items() if v >= 1e-3 * g_med]
        c_ref = ref["change"]
        c_med = float(np.median([c_ref[k] for k in moving]))
        change = [abs(self.change_norms[k] - c_ref[k]) / max(c_ref[k], c_med)
                  for k in moving]
        worst = sorted(zip(grad, g_ref), reverse=True)[:4]
        self.notes = [f"grad worst leaves {k}: gap {g:.4g}, norm "
                      f"{g_ref[k]:.4g} (program {self.grad_norms.get(k, 0):.4g})"
                      for g, k in worst]
        top = sorted(g_ref, key=g_ref.get, reverse=True)[:4]
        self.notes.append("grad largest leaves " + ", ".join(
            f"{k} {g_ref[k]:.4g} (program {self.grad_norms.get(k, 0):.4g})"
            for k in top))
        size = ref["sizes"]
        for c, k in sorted(zip(change, moving), reverse=True)[:4]:
            self.notes.append(
                f"change worst leaves {k}: gap {c:.4g}, change "
                f"{c_ref[k]:.4g} (program {self.change_norms[k]:.4g}, "
                f"median {c_med:.4g}), gradient {g_ref[k] / g_med:.4g} of "
                f"the median leaf's, {size[k]} elements")
        kept = set(moving)
        still = sorted((v / g_med, k) for k, v in g_ref.items()
                       if k not in kept)
        self.notes.append(
            f"change leaves left out: {len(still)} of {len(g_ref)}"
            + "".join(f", {k} gradient {r:.3g} of the median leaf's"
                      for r, k in still[-4:])
            + f"; the least kept {min(g_ref[k] for k in moving) / g_med:.3g}")
        if count_flops and flops.cached(self.flops_key()) is None:
            self.count_flops()
        self.ref_model = None
        _free()
        ref_logits = ref["logits"]
        mine = self.logits.to(ref_logits.device)
        logit_gap = float((mine - ref_logits[: mine.shape[0]]).abs().mean()
                          / ref_logits.std())
        return {"logit_gap": logit_gap,
                "loss_gap": max(gaps), "loss1_gap": gaps[0],
                "gnorm_gap": max(gnorm),
                "grad_gap": max(grad),
                "grad_gap_median": float(np.median(grad)),
                "change_gap": max(change),
                "change_gap_median": float(np.median(change))}

    def count_flops(self) -> None:
        """The model FLOPs of one step: forward and backward of the
        reference at one sample without recomputation, times the batch."""
        from bench_port.reference.train import total_loss
        ref = self.ref_model
        for m in ref.modules():
            if isinstance(getattr(m, "remat", None), bool):
                m.remat = False
        ref.train()
        one = {k: v[:1] for k, v in self.batches[0].items()}
        gen = torch.Generator(device=self.device).manual_seed(0)

        def step():
            ref.zero_grad(set_to_none=True)
            loss, _ = total_loss(ref.cfg, ref(one, generator=gen), one)
            loss.backward()
        with fp32_exact():
            flops.count_into(self.flops_key(), step, scale=self.batch_size)
        ref.zero_grad(set_to_none=True)


@contextlib.contextmanager
def _first_logits(model: torch.nn.Module, on: bool):
    """Inside, with ``on``, the occupancy logits of ``model``'s forward
    are put in the list it yields (fp32, detached)."""
    seen: List[torch.Tensor] = []
    handle = (model.register_forward_hook(
        lambda mod, args, out: seen.append(
            out["occ_logits"].detach().float())) if on else None)
    try:
        yield seen
    finally:
        if handle is not None:
            handle.remove()


LOOPS = {"stream": StreamLoop, "serve": ServeLoop, "train": TrainLoop}


def loop_for(config: dict, traffic: dict, seed: int, device: torch.device,
             fault: Optional[str] = None) -> Loop:
    return LOOPS[traffic["loop"]](config, traffic, seed, device, fault)

