"""Mean over every tick of the host's part: the slider call and
``apply(FULL)`` up to its return, before the wait for the card."""


def read(ctx):
    ms = ctx.get("host_ms")
    return sum(ms) / len(ms) if ms else None
