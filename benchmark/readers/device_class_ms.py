"""Device milliseconds a unit of work (a batch, a step, a query) spent in
one class of device operations (`device_classes/*.json`)."""


def read(ctx, cls):
    prof = ctx.get("profile")
    if not prof or not prof["class_s"].get(cls):
        return None
    return prof["class_s"][cls] / prof["iters"] * 1e3
