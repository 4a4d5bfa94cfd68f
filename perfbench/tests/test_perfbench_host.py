"""The readings logged beside a window."""

from benchlib import host


def test_probe_times_fixed_work():
    assert 0.0 < host.probe_ms(reps=2) < 10_000.0


def test_card_clocks_never_raises():
    assert isinstance(host.card_clocks(), str)
