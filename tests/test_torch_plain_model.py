"""The port's plain-model path (gofr_tpu_torch.models.mlp, the GPU
datasource's ``Batcher`` and ``register_model`` / ``infer`` /
``infer_async`` / ``infer_one``, ``serve_mnist``) against the JAX
package's (gofr_tpu.models.mlp, gofr_tpu.datasource.tpu,
examples/tpu-mnist) on the CPU: the same weights (JAX's, through numpy)
and inputs from numpy seeds give the same logits, each caller gets its
own row, waves pad to powers of two, and the MNIST apps answer alike over
sockets."""

import asyncio
import concurrent.futures
import http.client
import importlib.util
import json
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gofr_tpu
from gofr_tpu.config import new_mock_config as jax_mock_config
from gofr_tpu.datasource.tpu import TPURuntime
from gofr_tpu.models import mlp as JM
from gofr_tpu_torch import serve_mnist
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.datasource.gpu import Batcher, GPURuntime
from gofr_tpu_torch.models import mlp as TM

ROOT = pathlib.Path(__file__).resolve().parents[1]
# f32 forwards agree to rounding; bf16 ones to one bf16 step at |logit| ~1
# (JAX rounds the tanh GELU's inner steps in bf16, torch computes it in f32
# and rounds once): measured 0.0078 on the published widths
ATOL = {"f32": 1e-5, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
SMALL = dict(in_dim=16, hidden=(32,), out_dim=4)  # tests/test_tpu_datasource.py's MLP


def _weights(dtype: str = "f32", **widths):
    jd, td = DTYPES[dtype]
    jcfg, tcfg = JM.MLPConfig(dtype=jd, **widths), TM.MLPConfig(dtype=td, **widths)
    jp = JM.mlp_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, TM.mlp_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _x(seed: int, n: int, d: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


# -- the model ----------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 7, 64])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mlp_forward_matches_jax(dtype, batch):
    """784 -> (512, 256) -> 10 at the published widths."""
    _jcfg, jp, _tcfg, tp = _weights(dtype)
    x = _x(batch, batch, 784)
    want = np.asarray(JM.mlp_forward(jp, jnp.asarray(x)))
    got = TM.mlp_forward(tp, torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (batch, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL[dtype])


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu's default is the tanh approximation: the port matches it
    to f32 rounding, and the exact erf form misses the tolerance tenfold."""
    _jcfg, jp, _tcfg, tp = _weights("f32")
    x = _x(3, 32, 784) * 3
    want = np.asarray(JM.mlp_forward(jp, jnp.asarray(x)))
    np.testing.assert_allclose(TM.mlp_forward(tp, torch.from_numpy(x)).numpy(), want, rtol=0, atol=ATOL["f32"])
    h = torch.from_numpy(x)
    for i in range(3):
        h = h @ tp[f"w{i}"] + tp[f"b{i}"]
        if i < 2:
            h = torch.nn.functional.gelu(h)  # exact
    assert np.abs(h.numpy() - want).max() > 10 * ATOL["f32"]  # 7.4e-4 here


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mlp_init_matches_jax_shapes_and_scale(dtype):
    """Same leaves, shapes and dtypes as JAX's mlp_init; the weights'
    spread is 1 / sqrt(d_in) and the biases are zero (another RNG stream,
    so only the distribution compares)."""
    jcfg, jp, tcfg, _tp = _weights(dtype)
    got = TM.mlp_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert list(got) == list(jp)
    for k, v in got.items():
        assert tuple(v.shape) == jp[k].shape and v.dtype == DTYPES[dtype][1]
        if k.startswith("w"):
            assert abs(float(v.float().std()) * np.sqrt(v.shape[0]) - 1) < 0.05
        else:
            assert not v.any()
    again = TM.mlp_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)  # seeded


# -- the runtime --------------------------------------------------------------------


@pytest.fixture()
def runtime():
    rt = GPURuntime(new_mock_config({"TORCH_DEVICE": "cpu"}))
    yield rt
    rt.close()


def _register(rt, name="mnist", **kw):
    _jcfg, jp, _tcfg, tp = _weights("f32", **SMALL)
    rt.register_model(name, TM.mlp_forward, tp, example_args=(np.zeros(16, np.float32),), **kw)
    return jp, tp


def test_infer_direct_matches_jax(runtime):
    jp, _tp = _register(runtime)
    x = _x(0, 3, 16)
    out = runtime.infer("mnist", x)
    assert isinstance(out, np.ndarray) and out.shape == (3, 4)
    np.testing.assert_allclose(out, np.asarray(JM.mlp_forward(jp, jnp.asarray(x))), rtol=0, atol=ATOL["f32"])


def test_unknown_model_and_reregister(runtime):
    with pytest.raises(KeyError, match="not registered"):
        runtime.infer("nope", np.zeros((1, 16)))
    _register(runtime)
    old = runtime.model("mnist").batcher
    _register(runtime)
    assert runtime.model("mnist").batcher is not old and old._closed


@pytest.mark.parametrize("callers", [1, 8, 33, 100])
def test_infer_one_returns_each_callers_row(runtime, callers):
    """``callers`` threads at once, each its own example: every result is
    its own row of the JAX forward, and the waves' widths sum to the
    requests."""
    jp, _tp = _register(runtime, max_batch=16, max_delay_ms=5)
    xs = _x(callers, callers, 16)
    with concurrent.futures.ThreadPoolExecutor(callers) as ex:
        outs = list(ex.map(lambda x: runtime.infer_one("mnist", x, timeout=60), xs))
    want = np.asarray(JM.mlp_forward(jp, jnp.asarray(xs)))
    for got, row in zip(outs, want):
        assert got.shape == (4,)
        np.testing.assert_allclose(got, row, rtol=0, atol=ATOL["f32"])
    widths = runtime.model("mnist").batcher.widths
    assert sum(n * k for n, k in widths.items()) == callers and max(widths) <= 16


@pytest.mark.parametrize("callers", [1, 8, 64, 100])
def test_infer_async_returns_each_callers_row(runtime, callers):
    jp, _tp = _register(runtime, max_batch=64, max_delay_ms=20)
    xs = _x(callers + 1000, callers, 16)

    async def fire():
        return await asyncio.gather(*[runtime.infer_async("mnist", x) for x in xs])

    outs = asyncio.run(fire())
    np.testing.assert_allclose(np.stack(outs), np.asarray(JM.mlp_forward(jp, jnp.asarray(xs))), rtol=0,
                               atol=ATOL["f32"])
    if callers > 1:  # coalesced: fewer waves than requests
        assert sum(runtime.model("mnist").batcher.widths.values()) < callers


@pytest.mark.parametrize("max_batch", [4, 16, 64])
def test_waves_pad_to_powers_of_two(runtime, max_batch):
    """Warmup runs every power-of-two bucket up to max_batch; every served
    wave's batch axis is the next power of two of its request count, at
    most max_batch, padded with the last example (JAX's buckets)."""
    seen: list[int] = []

    def apply_fn(p, x):
        seen.append(x.shape[0])
        return x * p["s"]

    runtime.register_model("sq", apply_fn, {"s": torch.tensor(2.0)}, example_args=(np.zeros(4, np.float32),),
                           max_batch=max_batch, max_delay_ms=20)
    assert seen == [1 << i for i in range(max_batch.bit_length())]
    seen.clear()
    xs = _x(max_batch, 3 * max_batch + 3, 4)
    with concurrent.futures.ThreadPoolExecutor(len(xs)) as ex:
        outs = list(ex.map(lambda x: runtime.infer_one("sq", x, timeout=60), xs))
    np.testing.assert_array_equal(np.stack(outs), xs * 2)
    widths = runtime.model("sq").batcher.widths
    assert sorted(seen) == sorted(
        min(1 << (n - 1).bit_length(), max_batch) for n, k in widths.items() for _ in range(k))
    assert all(s <= max_batch and s & (s - 1) == 0 for s in seen)


def test_tree_args_and_outputs(runtime):
    """Examples of several args and a dict output scatter per leaf."""
    runtime.register_model("pair", lambda p, a, b: {"sum": a + b, "prod": (a * b, a.sum(-1))}, {},
                           example_args=(np.zeros(3, np.float32), np.zeros(3, np.float32)), max_batch=8)
    a, b = _x(1, 5, 3), _x(2, 5, 3)
    with concurrent.futures.ThreadPoolExecutor(5) as ex:
        outs = list(ex.map(lambda i: runtime.infer_one("pair", a[i], b[i], timeout=30), range(5)))
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o["sum"], a[i] + b[i], rtol=1e-6)
        np.testing.assert_allclose(o["prod"][0], a[i] * b[i], rtol=1e-6)
        assert o["prod"][1].shape == ()


# -- the batcher (tests/test_tpu_datasource.py's cases) -------------------------------


def test_close_fails_pending_futures():
    """A wave blocked in its launch, requests queued behind it: close()
    fails every queued future (none hangs), the running wave completes."""
    release, started = threading.Event(), threading.Event()

    def run_batch(stacked, n):
        started.set()
        release.wait(timeout=10)
        return stacked[0] * 2

    b = Batcher("t", run_batch, max_batch=2, max_delay_ms=1)
    first = b.submit((np.ones(4, np.float32),))
    assert started.wait(5)
    queued = [b.submit((np.full(4, i, np.float32),)) for i in range(6)]
    closer = threading.Thread(target=b.close)
    closer.start()
    release.set()
    closer.join(15)
    assert not closer.is_alive()
    np.testing.assert_allclose(first.result(timeout=5), 2.0)
    for f in queued:
        with pytest.raises(RuntimeError, match="closed"):
            f.result(timeout=5)
    with pytest.raises(RuntimeError, match="closed"):
        b.submit((np.ones(4),))


def test_batch_error_fans_out():
    def run_batch(stacked, n):
        raise ValueError("device on fire")

    b = Batcher("t", run_batch, max_batch=4, max_delay_ms=5)
    futs = [b.submit((np.ones(4, np.float32),)) for _ in range(3)]
    for f in futs:
        with pytest.raises(ValueError, match="device on fire"):
            f.result(timeout=5)
    b.close()


def test_cancelled_request_does_not_kill_the_wave():
    release = threading.Event()
    b = Batcher("t", lambda s, n: (release.wait(5), s[0] * 2)[1], max_batch=8, max_delay_ms=50)
    f1 = b.submit((np.ones(4, np.float32),))
    f2 = b.submit((np.full(4, 3.0, np.float32),))
    f1.cancel()
    release.set()
    np.testing.assert_allclose(f2.result(timeout=5), 6.0)
    b.close()


def test_health_check_lists_the_model_as_jax_does(runtime):
    """The model's entry has JAX's keys and values (bytes of the same f32
    leaves, batch knobs, queue depth) beside the device fields."""
    jp, _tp = _register(runtime)
    jrt = TPURuntime(None)
    try:
        jrt.register_model("mnist", lambda p, x: JM.mlp_forward(p, x), jp, example_args=(np.zeros(16, np.float32),))
        want = jrt.health_check()["details"]["models"]
    finally:
        jrt.close()
    h = runtime.health_check()
    assert h["status"] == "UP" and h["details"]["models"] == want
    assert h["details"]["models"]["mnist"]["params_bytes"] == 4 * (16 * 32 + 32 + 32 * 4 + 4)


def test_batch_knobs_from_config():
    rt = GPURuntime(new_mock_config({"TORCH_DEVICE": "cpu", "TPU_BATCH_MAX_SIZE": "8",
                                     "TPU_BATCH_MAX_DELAY_MS": "7", "TPU_BATCH_MAX_INFLIGHT": "3"}))
    try:
        _register(rt)
        m = rt.model("mnist")
        assert (m.meta["max_batch"], m.meta["max_delay_ms"], m.batcher.max_batch) == (8, 7.0, 8)
        assert m.batcher._completion._max_workers == 3
    finally:
        rt.close()


# -- the MNIST apps -------------------------------------------------------------------


def _example_module():
    spec = importlib.util.spec_from_file_location("tpu_mnist_main", ROOT / "examples/tpu-mnist/main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _call(app, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", app.http_server.port, timeout=60)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def mnist_apps():
    """The JAX example's handlers over JAX's MLP, and the port's app over
    the same weights (f32, so logits compare at the f32 tolerance)."""
    _jcfg, jp, _tcfg, tp = _weights("f32")
    example = _example_module()
    common = {"HTTP_PORT": "0", "METRICS_PORT": "0", "REQUEST_TIMEOUT": "30", "LOG_LEVEL": "ERROR"}
    japp = gofr_tpu.new(config=jax_mock_config({**common, "METRICS_PORT": "0", "TRACE_EXPORTER": "none"}))
    japp.container.tpu().register_model("mnist", lambda p, x: JM.mlp_forward(p, x), jp,
                                        example_args=(np.zeros(784, np.float32),))
    japp.post("/infer", example.infer)
    japp.get("/model", example.model_info)
    papp = serve_mnist.build_app(new_mock_config({**common, "TORCH_DEVICE": "cpu"}), params=tp)
    threads = [japp.run_in_background(), papp.run_in_background()]
    yield japp, papp
    for app, th in zip((japp, papp), threads):
        app.shutdown()
        th.join(timeout=10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mnist_infer_same_answer(mnist_apps, seed):
    image = _x(seed, 1, 784)[0].tolist()
    (sj, bj), (sp, bp) = (_call(a, "POST", "/infer", {"image": image}) for a in mnist_apps)
    assert sj == sp == 201
    assert bp["data"]["digit"] == bj["data"]["digit"]
    np.testing.assert_allclose(bp["data"]["logits"], bj["data"]["logits"], rtol=0, atol=ATOL["f32"])


def test_mnist_bad_image_same_envelope(mnist_apps):
    (sj, bj), (sp, bp) = (_call(a, "POST", "/infer", {"image": [0.0] * 5}) for a in mnist_apps)
    assert sj == sp == 400 and bp == bj


def test_mnist_model_route_lists_the_model(mnist_apps):
    (sj, bj), (sp, bp) = (_call(a, "GET", "/model") for a in mnist_apps)
    assert sj == sp == 200
    assert bp["data"]["details"]["models"] == bj["data"]["details"]["models"]
    assert bp["data"]["status"] == "UP" and bp["data"]["details"]["platform"] == "cpu"


def test_mnist_concurrent_clients_get_their_rows(mnist_apps):
    """64 clients at once over HTTP: each answer is its own image's."""
    _japp, papp = mnist_apps
    images = _x(99, 64, 784)
    want = np.asarray(JM.mlp_forward(_weights("f32")[1], jnp.asarray(images)))
    with concurrent.futures.ThreadPoolExecutor(64) as ex:
        answers = list(ex.map(lambda im: _call(papp, "POST", "/infer", {"image": im.tolist()}), images))
    for (status, body), row in zip(answers, want):
        assert status == 201
        np.testing.assert_allclose(body["data"]["logits"], row, rtol=0, atol=ATOL["f32"])
