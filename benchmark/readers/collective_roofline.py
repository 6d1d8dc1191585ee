"""The collectives' share of their roofline, in %: the least time the
links need for the bytes a unit of work's collectives must move
(`counts()`'s `bus_bytes_per_unit`, from the shapes: `dp_counts.py`) at
`peak` bytes a second, over the device time of the operations in class
`cls` (the collectives' kernels).  None where the driver counts no bus
bytes or the class took no time."""


def read(ctx, cls, peak):
    prof = ctx.get("profile")
    nbytes = ctx.get("counts", {}).get("bus_bytes_per_unit")
    if not prof or not nbytes or not prof["class_s"].get(cls):
        return None
    return 100.0 * nbytes * prof["iters"] / peak / prof["class_s"][cls]
