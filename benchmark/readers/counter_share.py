"""A program counter's count over the measured window, in % of the
window's units of work: the driver's `counters` of the window (what the
program's `trace.counters()` gained while it ran).  None where the driver
reports no counters."""


def read(ctx, counter):
    win = ctx.get("window")
    if not win or not win["units"] or "counters" not in win:
        return None
    return 100.0 * win["counters"].get(counter, 0) / win["units"]
