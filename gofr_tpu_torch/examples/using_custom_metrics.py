"""User-defined metrics for a store (counterpart of
examples/using-custom-metrics/main.py).

    python -m gofr_tpu_torch.examples.using_custom_metrics

A counter, an up-down counter, a gauge and a histogram registered at
start-up and written by ``POST /transaction`` and ``POST /return``; the
metrics server (port 9125) exports them beside the framework's. HTTP on
9124.
"""

from __future__ import annotations

import time

from ..app import App, new
from ..config import Config
from . import DefaultsConfig

DEFAULTS = {"APP_NAME": "using-custom-metrics", "HTTP_PORT": "9124", "METRICS_PORT": "9125", "LOG_LEVEL": "INFO"}

TRANSACTION_SUCCESS = "transaction_success"
TRANSACTION_TIME = "transaction_time"
TOTAL_CREDIT_DAY_SALES = "total_credit_day_sale"
PRODUCT_STOCK = "product_stock"


def transaction(ctx):
    start = time.perf_counter()
    ctx.metrics.increment_counter(TRANSACTION_SUCCESS)
    ctx.metrics.record_histogram(TRANSACTION_TIME, (time.perf_counter() - start) * 1e3)
    ctx.metrics.delta_updown_counter(TOTAL_CREDIT_DAY_SALES, 1000, sale_type="credit")
    ctx.metrics.set_gauge(PRODUCT_STOCK, 10)
    return "Transaction Successful"


def sales_return(ctx):
    ctx.metrics.delta_updown_counter(TOTAL_CREDIT_DAY_SALES, -1000, sale_type="credit_return")
    ctx.metrics.set_gauge(PRODUCT_STOCK, 50)
    return "Return Successful"


def build_app(config: Config | None = None) -> App:
    app = new(config=config or DefaultsConfig(DEFAULTS))
    m = app.container.metrics
    m.new_counter(TRANSACTION_SUCCESS, "count of successful transactions")
    m.new_updown_counter(TOTAL_CREDIT_DAY_SALES, "total credit sales in a day")
    m.new_gauge(PRODUCT_STOCK, "number of products in stock")
    m.new_histogram(TRANSACTION_TIME, "time taken by a transaction ms", (5, 10, 15, 20, 25, 35))
    app.post("/transaction", transaction)
    app.post("/return", sales_return)
    return app


if __name__ == "__main__":
    build_app().run()
