import numpy as np
import pytest

from benchlib.stats import percentile, spread


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_is_over_every_sample(q):
    rng = np.random.default_rng(7)
    ticks = list(rng.gamma(3.0, 2.0, size=1237))
    assert percentile(ticks, q) == pytest.approx(float(np.percentile(ticks, q)), rel=1e-12)


def test_p95_of_all_ticks_is_not_a_median_of_chunk_p95s():
    # One slow stretch: the tail is the tail of all ticks.
    ticks = [1.0] * 900 + [10.0] * 100
    assert percentile(ticks, 95) == 10.0
    chunks = [percentile(ticks[i:i + 100], 95) for i in range(0, 1000, 100)]
    assert float(np.median(chunks)) == 1.0


def test_spread_is_quartile_distance_over_median():
    assert spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)
