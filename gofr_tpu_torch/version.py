"""Framework version, stamped into logs, metrics and the health route
(counterpart of gofr_tpu/version.py: the JAX package's version, whose
wire format the port keeps)."""

FRAMEWORK = "0.4.0"
