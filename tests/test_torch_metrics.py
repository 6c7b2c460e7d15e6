"""gofr_tpu_torch.metrics against gofr_tpu.metrics (host code, no device):
the same sequence of calls renders the same Prometheus and OpenMetrics
text from both managers (exact), and RollingWindow / summarize_window give
the same numbers on the same seeded observations (exact)."""

import numpy as np
import pytest

from gofr_tpu import metrics as JM
from gofr_tpu_torch import metrics as TM


def _drive(m, seed: int) -> None:
    """One seeded sequence of registrations and updates."""
    rng = np.random.default_rng(seed)
    m.new_counter("app_c_total", "a counter")
    m.new_gauge("app_g", "a gauge")
    m.new_updown_counter("app_ud", "")
    m.new_histogram("app_h_seconds", "a histogram", buckets=(0.01, 0.1, 1.0))
    m.new_histogram("app_d_seconds", "default buckets")
    for _ in range(int(rng.integers(20, 60))):
        op = int(rng.integers(0, 5))
        labels = {"model": f"m{int(rng.integers(0, 3))}", "class": str(rng.choice(["useful", "padding", 'q"x\\y']))}
        v = float(rng.random() * 2.0)
        if op == 0:
            m.increment_counter("app_c_total", by=v, **labels)
        elif op == 1:
            m.set_gauge("app_g", v, **labels)
        elif op == 2:
            m.delta_updown_counter("app_ud", v - 1.0, model=labels["model"])
        elif op == 3:
            m.record_histogram("app_h_seconds", v, exemplar={"trace_id": f"t{int(rng.integers(0, 9))}"}, **labels)
        else:
            m.record_histogram("app_d_seconds", v / 10)
    m.increment_counter("app_unregistered_total")  # logged and ignored by both


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_render_prometheus_equals_jax(seed, monkeypatch):
    monkeypatch.setattr(JM.time, "time", lambda: 1700000000.0)
    monkeypatch.setattr(TM.time, "time", lambda: 1700000000.0)
    j, t = JM.Manager(), TM.Manager()
    _drive(j, seed)
    _drive(t, seed)
    assert t.render_prometheus() == j.render_prometheus()
    assert t.render_openmetrics() == j.render_openmetrics()
    assert t.render_openmetrics().endswith("# EOF\n")
    assert t.gauge_total("app_g") == j.gauge_total("app_g")
    for q in (0.5, 0.99):
        assert t.histogram("app_h_seconds").percentile(q, model="m0", **{"class": "useful"}) == \
            j.histogram("app_h_seconds").percentile(q, model="m0", **{"class": "useful"})


def test_register_is_idempotent_and_has_is_silent():
    for mod in (JM, TM):
        m = mod.Manager()
        a = m.new_counter("x_total")
        assert m.new_counter("x_total") is a and m.has("x_total") and not m.has("y")
        assert m.gauge_total("missing") == 0.0


@pytest.mark.parametrize("max_age", [None, 5.0])
def test_rolling_window_equals_jax(max_age):
    clock = {"t": 0.0}
    rng = np.random.default_rng(11)
    j = JM.RollingWindow(size=16, max_age_s=max_age, clock=lambda: clock["t"])
    t = TM.RollingWindow(size=16, max_age_s=max_age, clock=lambda: clock["t"])
    for _ in range(50):
        v = float(rng.random())
        clock["t"] += float(rng.random())
        j.observe(v)
        t.observe(v)
        assert (len(t), t.mean(), t.values(), t.summary()) == (len(j), j.mean(), j.values(), j.summary())
    j.clear()
    t.clear()
    assert (len(t), t.mean()) == (len(j), j.mean()) == (0, 0.0)


def test_summarize_window_equals_jax():
    rng = np.random.default_rng(5)
    for n in (0, 1, 7, 100):
        xs = rng.random(n).tolist()
        assert TM.summarize_window(xs) == JM.summarize_window(xs)
