"""The median, in ms, of one of the benchmark's spans over the window."""

import statistics


def read(ctx, span):
    values = ctx.get("spans", {}).get(span)
    if not values:
        return None
    return statistics.median(values)
