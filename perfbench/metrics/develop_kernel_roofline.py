"""The develop kernel's share of its roofline: the least time one launch
of this edit can take on the H100 (the larger of its operations over
67 TFLOP/s and its bytes over 3.35 TB/s, counted by ``benchlib.opcount``)
over the kernel's mean device time per launch in the trace."""

from benchlib.opcount import develop_least_seconds


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    seconds, n = tr.seconds(lambda name, kind: "develop_kernel" in name)
    if n == 0 or seconds <= 0:
        return None
    least, _ = develop_least_seconds(ctx["develop_work"])
    return 100.0 * least / (seconds / n)
