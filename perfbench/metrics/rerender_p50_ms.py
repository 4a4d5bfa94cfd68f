"""Median over every tick of the window: host clock from the slider call
to the return of the synchronize after ``apply(FULL)``."""

from benchlib.stats import percentile


def read(ctx):
    return percentile(ctx["total_ms"], 50) if ctx.get("total_ms") else None
