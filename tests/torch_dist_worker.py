"""Worker processes of tests/test_torch_dist.py: one rank of a gloo group
on the CPU, started by ``torch.multiprocessing``."""
import os

import torch


def join(rank, world, port):
    """This process as ``rank`` of a ``world``-process job, described in
    the environment as torchrun describes it."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)


def train_state(preset, global_batch, steps, seed=0):
    """``steps`` train steps of ``preset`` over this process's rows of a
    global synthetic batch (the whole batch without a process group):
    the metrics of each step, and the parameters, BatchNorm buffers,
    AdamW moments and EMA after them."""
    from dhd_tpu_torch.config import get_config
    from dhd_tpu_torch.data import synthetic_batch
    from dhd_tpu_torch.models import build_model
    from dhd_tpu_torch.parallel import shard_batch
    from dhd_tpu_torch.train import AdamWSchedule, ModelEMA, train_step

    from dhd_tpu_torch.nn.layers import _FlaxTrainBN
    from dhd_tpu_torch.parallel import global_rand

    cfg = get_config(preset)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    # each BatchNorm's per-channel E[x^2] over this process's rows at the
    # first step: the size of the terms its one-pass variance subtracts
    second = {}

    def keep(name, x):
        if name not in second:
            dims = [0] + list(range(2, x.dim()))
            second[name] = (x.detach().float() ** 2).mean(dims)
    for name, mod in model.named_modules():
        if isinstance(mod, _FlaxTrainBN):
            mod.register_forward_pre_hook(
                lambda m, args, name=name: keep(name, args[0]))
    opt = AdamWSchedule(model.parameters(), cfg.optim, 10)
    ema = ModelEMA(model, cfg.optim.ema_init_updates, cfg.optim.ema_decay)
    gen = torch.Generator().manual_seed(seed + 1)
    metrics = []
    for i in range(steps):
        batch = shard_batch(synthetic_batch(cfg, global_batch, seed=i + 1,
                                            varied_rig=True))
        m = train_step(model, opt, ema, batch, gen)
        metrics.append({k: float(v) for k, v in m.items()})
    moments = {f"{k}.{m}": opt.adamw.state[p][m].clone()
               for k, p in model.named_parameters()
               for m in ("exp_avg", "exp_avg_sq")}
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    draw = global_rand((2, 3), torch.Generator().manual_seed(seed), "cpu")
    return {"metrics": metrics, "state": dict(model.state_dict()),
            "grads": grads, "moments": moments, "second": second,
            "ema": dict(ema.state_dict()["shadow"]), "draw": draw}


def run_train(rank, world, port, preset, global_batch, steps, out):
    join(rank, world, port)
    from dhd_tpu_torch.parallel import initialize_distributed, shutdown
    assert initialize_distributed("cpu")
    try:
        torch.save(train_state(preset, global_batch, steps),
                   f"{out}.{rank}")
    finally:
        shutdown()


def run_cli_test(rank, world, port, argv, out):
    """``cli/test``'s main on this rank, its printed text saved."""
    import contextlib
    import io
    join(rank, world, port)
    from dhd_tpu_torch.cli.test import main
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = main(argv)
    with open(f"{out}.{rank}", "w") as f:
        f.write(f"rc={rc}\n" + text.getvalue())


def run_cli_train(rank, world, port, argv, out):
    """``cli/train``'s main on this rank, its printed text saved."""
    import contextlib
    import io
    join(rank, world, port)
    from dhd_tpu_torch.cli.train import main
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = main(argv)
    with open(f"{out}.{rank}", "w") as f:
        f.write(f"rc={rc}\n" + text.getvalue())
