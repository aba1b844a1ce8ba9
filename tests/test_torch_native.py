"""The port's native host helper (``kontiki_tpu_torch.native``,
``csrc/kontiki_host.cpp`` built with the host C++ compiler) against its
plain numpy versions (``*_plain``) and against ``kontiki_tpu.native`` on
the same numpy-seeded inputs: outputs equal exactly (integer masks,
indices and segments from the same double arithmetic), and the same span
errors raised. A build failure raises; nothing falls back to numpy."""
import numpy as np
import pytest

from kontiki_tpu import native as jn
from kontiki_tpu_torch import native as tn
from kontiki_tpu_torch.ops import build


def test_native_library_builds():
    assert tn.available()
    assert jn.available()


def _spans(n, seed, t_max=9.0, width=0.7):
    rng = np.random.default_rng(seed)
    t1 = np.sort(rng.uniform(0.0, t_max, n))
    return t1, t1 + rng.uniform(0.0, width, n)


@pytest.mark.parametrize("n,t0,dt,nknots", [(50, -0.3, 0.25, 60), (10_000, 0.0, 0.1, 100),
                                            (300, 1.0, 0.5, 10), (0, 0.0, 0.1, 5)])
def test_activate_spans_matches_plain_and_jax(n, t0, dt, nknots):
    t1, t2 = _spans(n, n)
    got = tn.activate_spans(t1, t2, t0, dt, nknots)
    np.testing.assert_array_equal(got, tn.activate_spans_plain(t1, t2, t0, dt, nknots))
    np.testing.assert_array_equal(got, jn.activate_spans(t1, t2, t0=t0, dt=dt, nknots=nknots))
    assert got.dtype == np.uint8 and len(got) == nknots
    # in place into an existing mask: a union
    base = np.zeros(nknots, dtype=np.uint8)
    base[-1] = 1
    out = tn.activate_spans(t1[: n // 2], t2[: n // 2], t0, dt, nknots, active=base)
    assert out is base
    want = tn.activate_spans_plain(t1[: n // 2], t2[: n // 2], t0, dt, nknots)
    want[-1] = 1
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("fn", ["native", "plain", "jax"])
def test_check_spans_errors(fn):
    check = {"native": tn.check_spans, "plain": tn.check_spans_plain,
             "jax": jn.check_spans}[fn]
    check([0.1, 0.2], [0.15, 0.3], 0.0, 1.0)
    check([], [], 0.0, 1.0)
    for t1, t2, msg in (([-0.1], [0.5], "out of range"), ([0.5], [1.0], "out of range"),
                        ([0.5], [0.4], "begins before it ends"),
                        ([0.5, 0.2], [0.6, 0.3], "not ordered")):
        with pytest.raises(ValueError, match=msg):
            check(t1, t2, 0.0, 1.0)


@pytest.mark.parametrize("fn", ["native", "plain"])
def test_check_spans_first_failing_span(fn):
    """The first failing span decides, each span's rules in order (range,
    then length, then order), as the C++ loop reads them."""
    check = {"native": tn.check_spans, "plain": tn.check_spans_plain}[fn]
    with pytest.raises(ValueError, match="begins before it ends"):
        check([0.5, -1.0], [0.4, 0.0], 0.0, 1.0)
    with pytest.raises(ValueError, match="not ordered"):
        check([0.5, 0.2, -1.0], [0.6, 0.3, 0.0], 0.0, 1.0)
    with pytest.raises(ValueError, match="out of range"):
        check([0.5, 0.6], [0.7, 1.5], 0.0, 1.0)


@pytest.mark.parametrize("slack", [0.0, 0.01, 0.3])
def test_activate_points_matches_spans(slack):
    t = np.sort(np.random.default_rng(1).uniform(0.5, 4.5, 200))
    got = tn.activate_points(t, slack, 0.0, 5.0, t0=0.0, dt=0.5, nknots=14)
    np.testing.assert_array_equal(got, tn.activate_spans(t - slack, t + slack, 0.0, 0.5, 14))
    np.testing.assert_array_equal(
        got, tn.activate_points_plain(t, slack, 0.0, 5.0, 0.0, 0.5, 14))
    np.testing.assert_array_equal(
        got, jn.activate_points(t, slack, 0.0, 5.0, t0=0.0, dt=0.5, nknots=14))


@pytest.mark.parametrize("fn", ["native", "plain", "jax"])
def test_activate_points_errors(fn):
    act = {"native": tn.activate_points, "plain": tn.activate_points_plain,
           "jax": jn.activate_points}[fn]
    with pytest.raises(ValueError, match="out of range"):
        act(np.array([0.5, 4.99]), 0.02, 0.0, 5.0, 0.0, 0.5, 14)
    with pytest.raises(ValueError, match="not ordered"):
        act(np.array([0.5, 0.4]), 0.0, 0.0, 5.0, 0.0, 0.5, 14)


def test_window_bases():
    t = np.array([-0.2, 0.0, 0.49, 0.51, 3.99, 5.0])
    out = tn.window_bases(t, t0=0.0, dt=0.5, nknots=10, W=4)
    np.testing.assert_array_equal(out, [0, 0, 0, 1, 6, 6])
    assert out.dtype == np.int32
    t = np.random.default_rng(2).uniform(-1.0, 1001.0, 10_000)
    out = tn.window_bases(t, 0.05, 0.1, 10_014, 4)
    np.testing.assert_array_equal(out, tn.window_bases_plain(t, 0.05, 0.1, 10_014, 4))
    np.testing.assert_array_equal(out, jn.window_bases(t, 0.05, 0.1, 10_014, 4))


@pytest.mark.parametrize("case", ["example", "random", "all", "none", "empty"])
def test_coalesce(case):
    active = {"example": np.array([0, 1, 1, 0, 0, 1, 0, 1, 1, 1]),
              "random": np.random.default_rng(3).integers(0, 2, 1001),
              "all": np.ones(7), "none": np.zeros(7), "empty": np.zeros(0)}[case]
    segs = tn.coalesce(active)
    assert segs == tn.coalesce_plain(active) == jn.coalesce(active)
    if case == "example":
        assert segs == [(1, 3), (5, 6), (7, 10)]


def test_argsort_times():
    t = np.array([3.0, 1.0, 2.0, 1.0])
    np.testing.assert_array_equal(tn.argsort_times(t), [1, 3, 2, 0])
    t = np.round(np.random.default_rng(4).uniform(0, 50, 20_000), 1)  # many ties
    out = tn.argsort_times(t)
    assert out.dtype == np.int64
    np.testing.assert_array_equal(out, tn.argsort_times_plain(t))
    np.testing.assert_array_equal(out, jn.argsort_times(t))


def test_build_failure_raises(monkeypatch):
    """A failed build raises from every entry point and ``available`` says
    so; there is no numpy fallback."""
    def broken(source):
        raise RuntimeError(f"c++ failed on {source}")

    tn._lib.cache_clear()
    monkeypatch.setattr(build, "build_host", broken)
    try:
        assert not tn.available()
        with pytest.raises(RuntimeError, match="kontiki_host.cpp"):
            tn.check_spans([0.1], [0.2], 0.0, 1.0)
        with pytest.raises(RuntimeError):
            tn.activate_points(np.array([0.5]), 0.0, 0.0, 1.0, 0.0, 0.1, 10)
    finally:
        monkeypatch.undo()
        tn._lib.cache_clear()
    assert tn.available()
