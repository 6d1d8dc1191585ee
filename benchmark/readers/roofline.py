"""The hand-written kernels' share of their roofline, in %: the least time
the card needs for the neighbourhood operations a unit of work holds
(`counts.py`, from the configuration's shapes) over the device time of
the kernels in class `cls`."""


def read(ctx, cls):
    prof = ctx.get("profile")
    if not prof or not prof["class_s"].get(cls):
        return None
    bound = ctx["counts"]["bound_s_per_unit"] * prof["iters"]
    return 100.0 * bound / prof["class_s"][cls]
