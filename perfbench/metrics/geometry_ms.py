"""Device time per tick of every traced op other than the develop kernel
and copies: the lens-distortion warp and the unsharp mask that a geometry
tick recomputes at full resolution, with the small ops around them."""


def read(ctx):
    tr = ctx.get("trace")
    ticks = len(ctx.get("total_ms") or [])
    if tr is None or ticks == 0:
        return None
    seconds, n = tr.seconds(lambda name, kind: "develop_kernel" not in name
                            and kind != "memcpy")
    return seconds * 1e3 / ticks if n else None
