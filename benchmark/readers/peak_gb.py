"""The run's peak of allocated device memory, in GB (1e9 bytes)."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9 if ctx.get("peak_bytes") else None
