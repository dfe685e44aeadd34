"""The downdate's roofline arithmetic against PERF.md's kernel table."""

import pytest

from vio_bench import roofline


@pytest.mark.parametrize("D, m, ms, by", [(120, 81, 4.60e-5, "bytes"),
                                          (270, 231, 2.52e-4, "operations")])
def test_downdate_bound(D, m, ms, by):
    t, what = roofline.bound_s(*roofline.downdate_work(D, m))
    assert what == by
    assert round(t * 1e3, 7) == pytest.approx(ms, rel=5e-3)
    tb, what_b = roofline.bound_s(*roofline.downdate_work(D, m, batch=1024))
    assert what_b == by and tb == pytest.approx(1024 * t, rel=1e-12)


def test_k_not_pht_counts_both_operands():
    f1, b1 = roofline.downdate_work(270, 231, same=True)
    f2, b2 = roofline.downdate_work(270, 231, same=False)
    assert f2 > f1 and b2 - b1 == 4 * 270 * 231
