"""The model's FLOPs over the measured window's time, as a share in % of
the H100's f32 peak (67 TFLOP/s outside the tensor cores; TF32 is off):
all the units of the window, all its time."""

from benchmark.counts import PEAK_F32_FLOPS


def read(ctx):
    win = ctx.get("window")
    if not win or not win["units"]:
        return None
    flops = ctx["counts"]["flops_per_unit"] * win["units"]
    return 100.0 * flops / win["seconds"] / PEAK_F32_FLOPS
