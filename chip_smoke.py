"""The port's on-card check: the ``cuda``-marked test lane over every test
module that holds the port on the card, without the JAX conftest (the GPU
machine has no JAX).  Run on the GPU machine from the repo root:

    python3 chip_smoke.py [pytest arguments, e.g. -k pool --durations=30]

It exits with pytest's code, nonzero on any failure.  The modules hold
every kernel against its plain version at the served shapes, and drive
the served frames, the CLIs, training, evaluation and exported programs
(README.md, "The port on the GPU").

The file also keeps :func:`tiny_dhd_m`, which the benchmark's tests
(``bench_port/tests/test_bp_dhd_m.py``) and tests/test_torch_dhd_m.py
import.
"""
import dataclasses
import sys

CARD_MODULES = ("tests/test_torch_cuda.py", "tests/test_torch_card_serve.py",
                "tests/test_torch_card_train.py", "tests/test_torch_graphs.py",
                "tests/test_torch_profiling.py",
                "tests/test_torch_unet_epilogue.py")


def tiny_dhd_m():
    """A tiny DHD-M-shaped config (tests/test_torch_dhd_m.py, the
    benchmark's ``dhd_m.stream`` tests): dhd_tiny_stereo with DHD-M's BEV
    side, the UNet BEV encoder (out 128, twice the tiny BEV neck's 64, as
    DHD-M's 512 is DHD-L's 256), slab UNets and SFA at twice the tiny
    widths, the head taking SFA's output.  A 40x40 grid takes the UNets
    through an odd size (40, 20, 10, 5, 2), as DHD-M's 200x200 grid does
    (25, 12)."""
    from dhd_tpu_torch import get_config
    from dhd_tpu_torch.config import GridConfig

    base = get_config("dhd_tiny_stereo")
    grid = GridConfig(-8.0, 8.0, 0.4)
    vox = tuple(2 * c for c in base.voxel_encoder_out)
    unet_out = 2 * base.bev_neck_out_channels
    return dataclasses.replace(
        base, name="tiny_dhd_m",
        vt=dataclasses.replace(base.vt, x=grid, y=grid),
        bev_encoder="unet", bev_unet_out=unet_out, voxel_encoder_out=vox,
        sfa_in_channels=unet_out + sum(vox),
        sfa_out_channels=2 * base.sfa_out_channels,
        head_in_dim=2 * base.sfa_out_channels)


def main(argv) -> int:
    import pytest

    return int(pytest.main(["--noconftest", "-m", "cuda", "-q",
                            *CARD_MODULES, *argv]))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
