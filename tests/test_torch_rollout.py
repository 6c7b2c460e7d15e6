"""Zero-downtime rollouts in gofr_tpu_torch (``resilience.rollout``, the
fleet's versions registry, ``ModelHandle``, the rollout routes) against
gofr_tpu's on the CPU, on the same tiny weights.

The two weight sets are the f32 tiny preset with an untied random head
under two seeds, asserted first to answer differently: the tied tiny
model answers the same repeated token under both seeds, so nothing could
tell v1 from v2 (tests/test_rollout.py:206). Greedy streams are held
against ``gofr_tpu.models.generate`` on the JAX copies of the weights;
state sequences, terminal states and ``error`` texts against the JAX
fleet's controller on the same sequence of faults."""

import json
import re
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.llm import ReplicatedLLMEngine as JFleet
from gofr_tpu.models import generate as j_generate
from gofr_tpu.models import transformer as JT
from gofr_tpu.models.checkpoint import CheckpointValidationError as JValidationError
from gofr_tpu.models.checkpoint import validate_params as j_validate
from gofr_tpu.resilience import FaultInjector as JInjector
from gofr_tpu.resilience import rollout as JR
from gofr_tpu_torch.llm import GenRequest, LLMEngine, ReplicatedLLMEngine, RequestFailed
from gofr_tpu_torch.models import transformer as TT
from gofr_tpu_torch.models.checkpoint import CheckpointValidationError
from gofr_tpu_torch.resilience import FaultInjector
from gofr_tpu_torch.resilience import rollout as TR

# tests/test_rollout.py's fleet shape: small chunks, so a stream spans many passes
KW = dict(slots=2, max_seq_len=128, prefill_buckets=(8,), prefill_chunk=4, step_token_budget=4, decode_chunk=2,
          lookahead=1)
PORT_KW = dict(KW, device="cpu")
JAX_KW = dict(KW, warmup=False)
PROMPT = list(range(1, 13))


def _weights(seed: int, head_seed: int):
    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, unembed=jax.random.normal(jax.random.PRNGKey(head_seed), (jcfg.vocab_size, jcfg.d_model),
                                            jnp.float32))
    tcfg = TT.TransformerConfig.tiny()
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def v1():
    return _weights(0, 9)


@pytest.fixture(scope="module")
def v2():
    return _weights(1, 10)


_REFS: dict = {}


def _ref(w, prompt, n: int) -> list[int]:
    """The JAX plain greedy ``generate`` (cached per weights, prompt, length)."""
    key = (id(w), tuple(prompt), n)
    if key not in _REFS:
        jcfg, jp = w[0], w[1]
        out = j_generate(jp, jcfg, jnp.asarray([list(prompt)], jnp.int32), jnp.asarray([len(prompt)], jnp.int32), n)
        _REFS[key] = [int(t) for t in np.asarray(out)[0]]
    return _REFS[key]


def _fleet(w, inj=None, *, replicas=2, supervise=False, **kw) -> ReplicatedLLMEngine:
    return ReplicatedLLMEngine(w[2], w[3], replicas=replicas, fault_injector=inj or FaultInjector(),
                               supervise=supervise, **{**PORT_KW, **kw})


def _wait(pred, timeout: float, what: str) -> None:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def _states(snapshot: dict) -> list[str]:
    """The state transitions of a rollout's history (timestamps dropped)."""
    return [h.split("state -> ", 1)[1] for h in snapshot["history"] if "state -> " in h]


class _Client:
    """Clients that generate PROMPT (8 tokens) until stopped; every answer
    must be exactly one of ``allowed`` (a spliced stream matches none)."""

    def __init__(self, fleet, allowed, n: int = 2):
        self.fleet, self.allowed, self.failures = fleet, allowed, []
        self.done = threading.Event()
        self.served = 0
        self.threads = [threading.Thread(target=self._run) for _ in range(n)]
        for t in self.threads:
            t.start()

    def _run(self) -> None:
        while not self.done.is_set():
            try:
                out = self.fleet.generate(PROMPT, max_new_tokens=8, eos_token=-1)
                self.served += 1
                if out not in self.allowed:
                    self.failures.append(("mixed", out))
            except Exception as e:  # noqa: BLE001 — failures ARE the assertion
                self.failures.append(("error", repr(e)))

    def stop(self) -> list:
        self.done.set()
        for t in self.threads:
            t.join(timeout=60)
        return self.failures


def test_the_two_versions_answer_differently(v1, v2):
    assert _ref(v1, PROMPT, 8) != _ref(v2, PROMPT, 8)


def test_deploy_validates_before_any_engine_change(v1):
    bad = {"embed": np.zeros((2, 2), np.float32)}
    with pytest.raises(JValidationError) as jerr:
        j_validate(bad, v1[0])
    rep = _fleet(v1)
    try:
        before = [id(e) for e in rep.engines]
        with pytest.raises(CheckpointValidationError) as err:
            rep.deploy(None, {"embed": torch.zeros(2, 2)}, version="vX")
        assert str(err.value) == str(jerr.value)
        assert rep._rollout is None and "vX" not in rep._versions
        assert [id(e) for e in rep.engines] == before
        with pytest.raises(TR.RolloutError, match="needs params"):
            rep.deploy(None, None)
    finally:
        rep.close()


def test_duplicate_version_and_concurrent_deploy(v1, v2):
    rep = _fleet(v1)
    try:
        assert rep.version_counts() == {"v1": 2} and rep.stats()["versions"] == {"v1": 2}
        assert rep.debug_state()["slot_versions"] == ["v1", "v1"]
        assert rep.debug_state()["versions_retained"] == ["v1"] and rep.rollout_state() is None
        with pytest.raises(TR.RolloutError) as dup:
            rep.deploy(None, v2[3], version="v1")
        assert dup.value.status_code == JR.RolloutError.status_code == 400
        assert str(dup.value) == "model version 'v1' already exists (known: ['v1'])"
        rep.deploy(None, v2[3], version="v2", bake_s=30.0, drain_timeout_s=30)
        with pytest.raises(TR.RolloutInProgress) as busy:
            rep.deploy(None, v2[3], version="v3")
        assert busy.value.status_code == JR.RolloutInProgress.status_code == 409
        assert re.fullmatch(r"rollout to 'v2' already in progress \(state \w+\)", str(busy.value))
        rep._rollout.close()
    finally:
        rep.close()


@pytest.mark.parametrize("versions", [["v1"], ["v1", "v2"], ["v1", "v7"], ["v1", "canary"], ["main", "v3"], ["a", "b"]])
def test_next_and_derived_version_match_jax(versions):
    for v in versions:
        assert TR._next_version(v) == JR._next_version(v)
    stub = SimpleNamespace(_versions={v: None for v in versions})
    assert ReplicatedLLMEngine._derive_version(stub) == JFleet._derive_version(stub)


@pytest.fixture(scope="module")
def jax_rollouts(v1, v2):
    """The JAX fleet's rollouts on these weights: a clean one, a canary
    fail and a bake regression, each with its state sequence, terminal
    state, error text and counters."""
    out = {}
    for name, point in (("completed", None), ("canary", "rollout_canary_fail"),
                        ("bake", "rollout_bake_regression")):
        inj = JInjector()
        rep = JFleet(v1[0], v1[1], replicas=2, fault_injector=inj, supervise=False, **JAX_KW)
        try:
            rep.generate(PROMPT, max_new_tokens=4, eos_token=-1)  # the shadow ring's prompt
            if point:
                inj.arm(point, count=1)
            rep.deploy(None, v2[1], version="v2", bake_s=0.3, drain_timeout_s=60)
            rep._rollout.wait(timeout=240)
            snap = rep.rollout_state()
            out[name] = {"state": snap["state"], "states": _states(snap), "error": snap["error"],
                         "canary_fails": snap["canary_fails"], "shadow_fails": snap["shadow_fails"],
                         "version": rep.version, "counts": rep.version_counts(), "retained": sorted(rep._versions)}
        finally:
            rep.close()
    return out


def test_shift_under_traffic_is_zero_downtime_and_matches_jax(v1, v2, jax_rollouts):
    rep = _fleet(v1)
    clients = None
    try:
        # a long v1 stream, decoding when the shift begins
        req = rep.submit(GenRequest(PROMPT, max_new_tokens=32, eos_token=-1))
        it = req.stream(timeout=60)
        got = [next(it) for _ in range(4)]
        clients = _Client(rep, (_ref(v1, PROMPT, 8), _ref(v2, PROMPT, 8)))
        rep.deploy(None, v2[3], version="v2", bake_s=0.3, drain_timeout_s=60)
        got.extend(it)
        # in-flight work finished on the old weights, token for token
        assert got == _ref(v1, PROMPT, 32) and req.finish_reason == "length"
        assert rep._rollout.wait(timeout=120) == "completed", rep.rollout_state()
        time.sleep(0.1)
        assert not clients.stop(), clients.failures[:5]
        assert clients.served > 0
        snap = rep.rollout_state()
        want = jax_rollouts["completed"]
        assert (snap["state"], _states(snap), snap["error"]) == (want["state"], want["states"], want["error"])
        assert snap["shifted"] == snap["total"] == 2
        assert rep.version == want["version"] == "v2"
        assert rep.version_counts() == want["counts"] == {"v2": 2}
        assert sorted(rep._versions) == want["retained"] == ["v2"]
        assert all(e.version == "v2" for e in rep.engines)
        assert rep.generate(PROMPT, max_new_tokens=8, eos_token=-1) == _ref(v2, PROMPT, 8)
        assert rep.params is v2[3] and rep.stats()["rollout"]["state"] == "completed"
    finally:
        if clients is not None:
            clients.stop()
        rep.close()


@pytest.mark.parametrize("kind", ["canary", "bake"])
def test_failed_rollout_rolls_back_fully_like_jax(v1, v2, jax_rollouts, kind):
    inj = FaultInjector()
    rep = _fleet(v1, inj)
    clients = _Client(rep, (_ref(v1, PROMPT, 8),) if kind == "canary" else (_ref(v1, PROMPT, 8), _ref(v2, PROMPT, 8)))
    try:
        inj.arm("rollout_canary_fail" if kind == "canary" else "rollout_bake_regression", count=1)
        rep.deploy(None, v2[3], version="v2", bake_s=0.3, drain_timeout_s=60)
        assert rep._rollout.wait(timeout=120) == "rolled_back", rep.rollout_state()
        assert not clients.stop(), clients.failures[:5]
        snap, want = rep.rollout_state(), jax_rollouts[kind]
        assert (snap["state"], _states(snap), snap["error"]) == (want["state"], want["states"], want["error"])
        assert (snap["canary_fails"], snap["shadow_fails"]) == (want["canary_fails"], want["shadow_fails"])
        assert rep.version == want["version"] == "v1"
        assert rep.version_counts() == want["counts"] == {"v1": 2}
        assert sorted(rep._versions) == want["retained"] == ["v1"]
        assert all(e.version == "v1" for e in rep.engines) and rep._rollout_hold == set()
        assert rep.generate(PROMPT, max_new_tokens=8, eos_token=-1) == _ref(v1, PROMPT, 8)
    finally:
        clients.stop()
        rep.close()


def test_rollback_with_live_supervisor_bills_no_quarantine(v1, v2, monkeypatch):
    """The supervisor leaves a held slot alone: a failed shift's slot stays
    dead until the rollback rebuilds it, and its deliberate close is never
    billed to the device ledger."""
    monkeypatch.setenv("TPU_LLM_SUPERVISOR_INTERVAL_S", "0.02")
    monkeypatch.setenv("TPU_LLM_RESTART_BACKOFF_S", "0.02")
    inj = FaultInjector()
    rep = _fleet(v1, inj, supervise=True)
    try:
        inj.arm("rollout_canary_fail", count=1)
        rep.deploy(None, v2[3], version="v2", bake_s=0.3, drain_timeout_s=60)
        assert rep._rollout.wait(timeout=120) == "rolled_back", rep.rollout_state()
        _wait(lambda: all(e.alive() for e in rep.engines), 30, "every replica alive")
        assert all(e.version == "v1" for e in rep.engines) and rep._rollout_hold == set()
        assert rep.health.quarantines == 0 and rep.supervisor.restarts == 0
        assert all(not d["by_reason"] for d in rep.health.snapshot()["devices"].values())
        assert rep.generate(PROMPT, max_new_tokens=8, eos_token=-1) == _ref(v1, PROMPT, 8)
    finally:
        rep.close()


@pytest.mark.parametrize("replicas", [2, 3])
def test_mid_decode_kill_pins_to_its_version(v1, v2, replicas):
    """Slot 0 moved to v2 by hand; a v1 stream on slot 1 whose replica is
    killed mid-decode continues on a v1 survivor token for token (three
    replicas), or, with none, ends "error" with a v1 prefix, never on v2."""
    inj = FaultInjector()
    rep = _fleet(v1, inj, replicas=replicas)
    try:
        rep._versions["v2"] = (v2[2], v2[3])
        old0 = rep.engines[0]
        old0.drain()
        _wait(old0.drained, 30, "replica 0 drained")
        old0.close()
        rep.engines[0] = rep._build_replica(0, version="v2")
        rep._slot_versions[0] = "v2"
        want = _ref(v1, PROMPT, 24)
        req = rep.engines[1].submit(GenRequest(PROMPT, max_new_tokens=24, eos_token=-1))
        toks = []
        try:
            for t in req.stream(timeout=60):
                toks.append(t)
                if len(toks) == 4:
                    inj.arm("replica_kill", label="/r1")
        except RequestFailed:  # the port's stream raises where JAX's ends quietly
            assert replicas == 2
        if replicas == 3:
            assert toks == want and req.finish_reason == "length" and rep.failovers == 1
        else:
            assert req.finish_reason == "error" and toks == want[: len(toks)] and len(toks) < 24
            assert rep.failover_errors == 1
    finally:
        rep.close()


def _handle(w, **kw):
    merged = dict(PORT_KW, **kw)
    eng = LLMEngine(w[2], w[3], **merged)
    return TR.ModelHandle("tiny", eng, build_kw=merged)


def test_swap_commits_with_zero_downtime(v1, v2):
    h = _handle(v1)
    try:
        assert h.generate(PROMPT, max_new_tokens=8, eos_token=-1) == _ref(v1, PROMPT, 8)
        old = h.engine
        snap = h.deploy(None, v2[3], bake_s=0.3)
        assert snap["to_version"] == "v2" and snap["from_version"] == "v1"
        while h._swap.active():  # submissions keep succeeding throughout
            assert len(h.generate(PROMPT, max_new_tokens=4, eos_token=-1)) == 4
        assert h._swap.state == "completed", h.rollout_state()
        assert _states(h.rollout_state()) == ["shifting", "baking", "completed"]
        assert h.version == "v2" and h.engine is not old and not old.alive()
        # neither the handle nor the ended swap pins a version's weights
        assert "_params" not in vars(h) and h._swap._params is None
        assert h.generate(PROMPT, max_new_tokens=8, eos_token=-1) == _ref(v2, PROMPT, 8)
        with pytest.raises(TR.RolloutError, match="already active"):
            h.deploy(None, v2[3], version="v2")
    finally:
        h.close()


@pytest.mark.parametrize("point", ["rollout_canary_fail", "rollout_bake_regression"])
def test_swap_failure_keeps_or_swaps_back_to_the_old_engine(v1, v2, point):
    inj = FaultInjector()
    h = _handle(v1, fault_injector=inj)
    try:
        old = h.engine
        inj.arm(point, count=1)
        h.deploy(None, v2[3], bake_s=5.0)
        assert h._swap.wait(timeout=120) == "rolled_back", h.rollout_state()
        want_states = ["shifting", "rolled_back"] if point == "rollout_canary_fail" else \
            ["shifting", "baking", "rolled_back"]
        assert _states(h.rollout_state()) == want_states
        assert h.rollout_state()["error"] == f"injected {point}"
        # the ORIGINAL engine serves (kept, or swapped back: not rebuilt)
        assert h.engine is old and old.accepting() and h.version == "v1"
        assert h.generate(PROMPT, max_new_tokens=8, eos_token=-1) == _ref(v1, PROMPT, 8)
    finally:
        h.close()


def test_adapter_gate_reject_keeps_the_old_binding(v1, monkeypatch):
    """The canary-gated adapter load on the port's handle beside the JAX
    handle: a rejected v2 is evicted and v1 serves on, token for token
    equal to the JAX engine's adapted stream; a passing v2 is published."""
    from gofr_tpu import lora as JL

    jcfg = v1[0]
    a1 = jax.tree.map(np.asarray, JL.init_adapter(jax.random.PRNGKey(7), jcfg, rank=4, scale=1.0))
    a2 = jax.tree.map(np.asarray, JL.init_adapter(jax.random.PRNGKey(11), jcfg, rank=4, scale=1.0))
    jh = JR.ModelHandle("tiny", JEngine(v1[0], v1[1], lora_slots=4, **JAX_KW), cfg=v1[0], params=v1[1])
    th = _handle(v1, lora_slots=4)
    try:
        streams = {}
        for name, h, mod, req in (("jax", jh, JR, None), ("port", th, TR, GenRequest)):
            h.register_adapter("acme", a1, shadow_probes=0)
            v1_toks = h.engine.generate(PROMPT, max_new_tokens=10, adapter="acme")
            # the shadow ring (fed by submit) holds a prompt
            h.generate(PROMPT, max_new_tokens=4)
            with monkeypatch.context() as m:
                m.setattr(mod, "shadow_probe", lambda *a, **k: (False, "injected reject"))
                with pytest.raises(mod.RolloutError, match="rejected by shadow gate: injected reject"):
                    h.register_adapter("acme", a2, version="v2")
            resident = h.engine.adapters()["resident"]
            assert "acme@v2" not in resident and resident["acme"]["version"] == "v1"
            assert h.engine.generate(PROMPT, max_new_tokens=10, adapter="acme") == v1_toks
            assert h.register_adapter("acme", a2, version="v2") == {"name": "acme", "version": "v2",
                                                                    "state": "published"}
            assert h.engine.adapters()["resident"]["acme"]["version"] == "v2"
            streams[name] = (v1_toks, h.engine.generate(PROMPT, max_new_tokens=10, adapter="acme"))
            h.retire_adapter("acme")
            assert "acme" not in h._adapters_host
        assert streams["port"] == streams["jax"] and streams["port"][0] != streams["port"][1]
    finally:
        jh.close()
        th.close()


def _hf_checkpoint(cfg, seed: int, path) -> str:
    """A random HF-layout (Gemma naming) safetensors file for ``cfg``."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    d, hd, hq, hkv, ff = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def r(*shape):
        return (0.3 * rng.normal(size=shape)).astype(np.float32)

    t = {"model.embed_tokens.weight": r(cfg.vocab_size, d), "model.norm.weight": r(d)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        t.update({p + "self_attn.q_proj.weight": r(hq * hd, d), p + "self_attn.k_proj.weight": r(hkv * hd, d),
                  p + "self_attn.v_proj.weight": r(hkv * hd, d), p + "self_attn.o_proj.weight": r(d, hq * hd),
                  p + "mlp.gate_proj.weight": r(ff, d), p + "mlp.up_proj.weight": r(ff, d),
                  p + "mlp.down_proj.weight": r(d, ff), p + "input_layernorm.weight": r(d),
                  p + "post_attention_layernorm.weight": r(d)})
    f = str(path / "model.safetensors")
    save_file(t, f)
    return f


def _post(port: int, body) -> tuple[int, dict]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/.well-known/debug/rollout", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get_view(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/.well-known/debug/rollout", timeout=10) as r:
        return json.loads(r.read())["data"]


def test_rollout_routes_match_the_jax_app(v1, tmp_path):
    """GET and POST /.well-known/debug/rollout on both apps over sockets:
    the same status for a bad path, an unknown model and a missing field,
    the same view; then the port's POST deploys a checkpoint to its fleet,
    which completes and serves the checkpoint's greedy stream (the JAX
    reference on the JAX loader's tree of the same file)."""
    from gofr_tpu import App as JApp
    from gofr_tpu.config import new_mock_config as jax_mock_config
    from gofr_tpu.models.checkpoint import load_checkpoint as j_load
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import new_mock_config

    common = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "ERROR", "REQUEST_TIMEOUT": "30"}
    japp = JApp(config=jax_mock_config({**common, "APP_NAME": "radm", "METRICS_PORT": "0",
                                        "TPU_TELEMETRY_INTERVAL_S": "0"}))
    japp.container.tpu().register_llm("tiny", v1[0], v1[1], **JAX_KW)
    papp = App(config=new_mock_config({**common, "TORCH_DEVICE": "cpu"}))
    handle = papp.container.tpu().register_llm("tiny", v1[2], v1[3], replicas=2, supervise=False,
                                                **{k: v for k, v in KW.items()})
    threads = [japp.run_in_background(), papp.run_in_background()]
    try:
        assert isinstance(handle, TR.ModelHandle) and papp.container.tpu().llm("tiny") is handle
        ports = (japp.http_server.port, papp.http_server.port)
        for body in ({"model": "tiny", "checkpoint": "/nope"}, {"model": "ghost", "checkpoint": "/nope"},
                     {"checkpoint": "/nope"}, {"model": "tiny"}):
            (jc, _jb), (pc, _pb) = (_post(p, body) for p in ports)
            assert pc == jc and pc in (400, 404), (body, jc, pc)
        jview, pview = (_get_view(p) for p in ports)
        assert jview["models"]["tiny"]["version"] == pview["models"]["tiny"]["version"] == "v1"
        assert jview["models"]["tiny"]["versions"] == {"v1": 1} and pview["models"]["tiny"]["versions"] == {"v1": 2}
        assert jview["models"]["tiny"]["rollout"] is pview["models"]["tiny"]["rollout"] is None

        ckpt = _hf_checkpoint(v1[2], 5, tmp_path)
        handle.generate(PROMPT, max_new_tokens=4, eos_token=-1)  # the shadow ring's prompt
        code, body = _post(ports[1], {"model": "tiny", "checkpoint": ckpt, "bake_s": 0.2})
        assert code == 201 and body["data"]["rollout"]["to_version"] == "v2", body
        code, body = _post(ports[1], {"model": "tiny", "checkpoint": ckpt, "version": "v9"})
        assert code == 409, body
        assert handle._rollout.wait(timeout=120) == "completed", handle.rollout_state()
        view = _get_view(ports[1])["models"]["tiny"]
        assert view["version"] == "v2" and view["versions"] == {"v2": 2} and view["rollout"]["state"] == "completed"
        jp2 = j_load(ckpt, v1[0], "gemma")
        out = j_generate(jp2, v1[0], jnp.asarray([PROMPT], jnp.int32), jnp.asarray([len(PROMPT)], jnp.int32), 8)
        want = [int(t) for t in np.asarray(out)[0]]
        assert handle.generate(PROMPT, max_new_tokens=8, eos_token=-1) == want
    finally:
        japp.shutdown()
        papp.shutdown()
        for t in threads:
            t.join(timeout=30)
