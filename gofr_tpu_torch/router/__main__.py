"""``python -m gofr_tpu_torch.router``: a front-router process configured
from the environment (TPU_ROUTER_* knobs). Over fixed backends::

    TPU_ROUTER_BACKENDS=http://10.0.0.2:8000,http://10.0.0.3:8000 \\
        HTTP_PORT=8080 python -m gofr_tpu_torch.router

Over an autoscaled local fleet of engine processes::

    TPU_ROUTER_ENGINE_CMD='python -m gofr_tpu_torch.router.engine_stub \\
        --port {port} --metrics-port {metrics_port}' \\
        TPU_ROUTER_MIN_REPLICAS=2 TPU_ROUTER_MAX_REPLICAS=4 \\
        python -m gofr_tpu_torch.router
"""

from . import new_router_app

if __name__ == "__main__":
    new_router_app().run()
