"""The share of the profiled window, in %, in which no device operation
ran."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
