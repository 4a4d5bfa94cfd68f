import pytest

from benchlib.trace import DeviceTrace

MS = 1_000_000  # ns


def _trace():
    ops = [("develop_kernel<true>", 10 * MS, 14 * MS, "kernel"),
           ("Memcpy HtoD (Pageable -> Device)", 13 * MS, 15 * MS, "memcpy"),
           ("develop_kernel<true>", 20 * MS, 24 * MS, "kernel"),
           ("elementwise_kernel", 30 * MS, 31 * MS, "kernel"),
           ("before the window", 0, 5 * MS, "kernel")]
    host = [("tick.render", 15 * MS, 20 * MS), ("tick.edit", 24 * MS, 26 * MS),
            ("tick.render", 26 * MS, 30 * MS)]
    return DeviceTrace(ops, host, (8 * MS, 38 * MS))


def test_busy_is_the_union_of_device_intervals_inside_the_window():
    tr = _trace()
    assert tr.window_s == pytest.approx(0.030)
    assert tr.busy_s == pytest.approx(0.005 + 0.004 + 0.001)


def test_idle_share_reader():
    from benchlib.spec import load_module
    from conftest import PERFBENCH

    read = load_module(PERFBENCH / "metrics" / "device_idle_pct.py").read
    assert read({"trace": _trace()}) == pytest.approx(100 * (1 - 0.010 / 0.030))
    assert read({}) is None


def test_gaps_are_named_by_the_host_span_at_their_middle():
    gaps = _trace().idle_gaps()
    assert gaps[0] == ["host:other", pytest.approx(0.007)]      # 31..38 ms
    assert ["host:tick.render", pytest.approx(0.005)] in gaps    # 15..20 ms
    assert ["host:tick.render", pytest.approx(0.006)] in gaps    # 24..30 ms: middle 27
    assert sum(g for _, g in gaps) == pytest.approx(0.030 - 0.010)


def test_seconds_and_top_ops():
    tr = _trace()
    assert tr.seconds(lambda n, k: "develop_kernel" in n) == (pytest.approx(0.008), 2)
    assert tr.seconds(lambda n, k: k == "memcpy") == (pytest.approx(0.002), 1)
    assert tr.top_ops()[0] == ["develop_kernel_true_", pytest.approx(0.008)]
