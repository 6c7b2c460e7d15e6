"""Training in the port (gofr_tpu_torch.parallel.train, models.transformer's
train_forward, the flash function's gradient, the MoE training half, the
training checkpoint and the train-lm example) against the JAX package on
the CPU: tiny float32 presets, weights and inputs from numpy seeds through
``params_from_jax`` / ``moe_params_from_jax``.

Tolerances: losses to 1e-5 and gradients to rtol 1e-4 / atol 1e-5 (f32,
summation order only); the flash backward to 1e-5 of ``jax.grad`` of JAX's
``mha_reference``. AdamW is held to optax at atol 1e-5 on the parameters
over 5 steps fed the same gradients. Five steps in which each side takes
its own gradients agree in loss to rtol 1e-5 and in the parameters to atol
1e-4: an Adam step divides by |g| + 1e-8, so a gradient element near 1e-8
(one in the embedding, 3.9e-8, at this seed) turns a 1e-10 summation-order
difference into 1.6e-5 of the parameter after the first step at lr 1e-2.
"""

import ast
import contextlib
import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gofr_tpu import parallel as JP
from gofr_tpu.models import moe as JM
from gofr_tpu.models import transformer as JT
from gofr_tpu.ops import attention as JA
from gofr_tpu.parallel import train as JTR
from gofr_tpu_torch import parallel as TP
from gofr_tpu_torch.models import moe as TM
from gofr_tpu_torch.models import transformer as TT
from gofr_tpu_torch.models.checkpoint import (
    SafetensorsFiles,
    load_train_state,
    save_safetensors,
    save_train_state,
)
from gofr_tpu_torch.ops import attention as TA
from gofr_tpu_torch.parallel import train as TTR
from gofr_tpu_torch.profiling import default_registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
LOSS_ATOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5
PARAM_ATOL = 1e-5  # AdamW against optax on the same gradients
TRAJ_PARAM_ATOL = 1e-4  # each side's own gradients (see the module docstring)

PRESETS = {
    "tiny": lambda m: m.TransformerConfig.tiny(),
    "tiny_llama": lambda m: m.TransformerConfig.tiny_llama(),
    "tiny_mistral": lambda m: m.TransformerConfig.tiny_mistral(),
    "tiny_qwen2": lambda m: m.TransformerConfig.tiny_qwen2(),
    "tiny_capped": lambda m: dataclasses.replace(m.TransformerConfig.tiny(), attn_logit_cap=5.0, final_logit_cap=8.0),
}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _leaves(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _pair(preset: str, seed: int = 0):
    """(jax cfg, jax params, port cfg, port params) of a tiny f32 preset."""
    jcfg, tcfg = PRESETS[preset](JT), PRESETS[preset](TT)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, tcfg, TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _batch(seed: int = 0, b: int = 2, s: int = 12, vocab: int = 512):
    """Seeded tokens and a mask with padding on the second row."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), bool)
    mask[1, s - 3:] = False
    return toks, mask


def _grads_as_port(jg, tcfg):
    return dict(_leaves(TT.params_from_jax(jax.tree.map(np.asarray, jg), tcfg, device="cpu")))


# -- the loss and its gradient ------------------------------------------------------

@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_lm_loss_matches_jax(preset):
    jcfg, jp, tcfg, tp = _pair(preset)
    toks, mask = _batch(1)
    want = float(JTR.lm_loss(jp, jcfg, jnp.asarray(toks), jnp.asarray(mask)))
    got = TTR.lm_loss(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) < LOSS_ATOL


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_every_gradient_matches_jax(preset):
    jcfg, jp, tcfg, tp = _pair(preset, seed=2)
    toks, mask = _batch(2)
    jl, jg = jax.value_and_grad(JTR.lm_loss)(jp, jcfg, jnp.asarray(toks), jnp.asarray(mask))
    loss, grads = TTR.value_and_grad(TTR.lm_loss, tp, tcfg, torch.from_numpy(toks), torch.from_numpy(mask))
    assert abs(float(loss) - float(jl)) < LOSS_ATOL
    want = _grads_as_port(jg, tcfg)
    got = dict(_leaves(grads))
    assert set(got) == set(want) and set(got) == {k for k, _ in _leaves(tp)}
    for path, w in want.items():
        torch.testing.assert_close(got[path], w, rtol=GRAD_RTOL, atol=GRAD_ATOL, msg=path)
    assert all(t.grad is None for _, t in _leaves(tp))  # nothing stored in .grad


def test_train_forward_is_the_oracle_forward():
    _, _, tcfg, tp = _pair("tiny_mistral", seed=3)
    toks, _ = _batch(3, s=20)
    t = torch.from_numpy(toks)
    pos = torch.arange(20)[None].expand(2, 20)
    torch.testing.assert_close(TT.train_forward(tp, tcfg, t, pos).detach(), TT.transformer_forward(tp, tcfg, t, pos),
                               rtol=0, atol=1e-5)


def test_train_forward_attends_through_the_override():
    _, _, tcfg, tp = _pair("tiny", seed=4)
    toks, _ = _batch(4)
    seen = []

    def attend(q, k, v):
        seen.append(q.shape)
        return TA.mha_reference(q, k, v, causal=True)

    pos = torch.arange(12)[None].expand(2, 12)
    out = TT.train_forward(tp, tcfg, torch.from_numpy(toks), pos, prefill_attn=attend)
    assert len(seen) == tcfg.n_layers and out.shape == (2, 12, tcfg.vocab_size)


@pytest.mark.parametrize("what", ["int8", "lora"])
def test_train_forward_refuses_int8_and_lora(what):
    from gofr_tpu_torch.models.quant import quantize_params

    _, _, tcfg, tp = _pair("tiny", seed=5)
    if what == "int8":
        tp = quantize_params(tp)
        err = TypeError
    else:
        tp = {**tp, "layers": {**tp["layers"], "lora_wq_a": torch.zeros(tcfg.n_layers, 2, tcfg.d_model, 4)}}
        err = ValueError
    toks, mask = _batch(5)
    with pytest.raises(err, match="train"):
        TTR.lm_loss(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(mask))


# -- the flash backward ---------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("logit_cap", [0.0, 3.0])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_flash_backward_matches_jax_grad_of_mha_reference(causal, window, logit_cap, group):
    rng = np.random.default_rng(group * 100 + window * 10 + int(logit_cap) + causal)
    b, s, hkv, d = 2, 16, 2, 16
    q = rng.standard_normal((b, s, hkv * group, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, logit_cap=logit_cap, window=window)
    out_j, vjp = jax.vjp(lambda q, k, v: JA.mha_reference(q, k, v, **kw), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = TA.flash_attention_plain(tq, tk, tv, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-5)
    got = TA.flash_attention_backward(tq, tk, tv, out, torch.from_numpy(dout), causal, None, logit_cap, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_train_autograd_on_cpu_is_the_plain_function(dtype, monkeypatch):
    """On a CPU tensor the forward is the plain version and the backward
    ``flash_attention_backward``, which never calls the plain forward."""
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(s, generator=g).to(dtype).requires_grad_() for s in ((2, 10, 4, 16), (2, 10, 1, 16),
                                                                              (2, 10, 1, 16)))
    out = TA.flash_attention_train(q, k, v, causal=True, window=4)
    assert torch.equal(out.detach(), TA.flash_attention_plain(q.detach(), k.detach(), v.detach(), window=4))
    dout = torch.randn(out.shape, generator=g).to(dtype)
    want = TA.flash_attention_backward(q.detach(), k.detach(), v.detach(), out.detach(), dout, True, None, 0.0, 4)
    monkeypatch.setattr(TA, "flash_attention_plain", lambda *a, **kw: pytest.fail("backward ran the plain forward"))
    got = torch.autograd.grad(out, (q, k, v), dout)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


# -- the optimizer and the step --------------------------------------------------------

def test_adamw_defaults_are_optax():
    opt = TP.AdamW(3e-4)
    assert (opt.learning_rate, opt.b1, opt.b2, opt.eps, opt.weight_decay) == (3e-4, 0.9, 0.999, 1e-8, 1e-4)
    defaults = optax.adamw.__defaults__  # b1, b2, eps, eps_root, mu_dtype, weight_decay, mask
    assert defaults[:3] == (0.9, 0.999, 1e-8) and defaults[3] == 0.0 and defaults[5] == 1e-4


def test_step_fn_matches_optax_adamw_on_the_same_gradients():
    """5 step_fn steps at lr 1e-2 against optax.adamw fed the port's
    gradients at the same parameters: parameters to atol 1e-5."""
    jcfg, jp, tcfg, tp = _pair("tiny", seed=6)
    toks, mask = _batch(6)
    tt, tm = torch.from_numpy(toks), torch.from_numpy(mask)
    _, init_opt, step = TP.make_train_step(tcfg, TP.make_mesh(devices=["cpu"]), learning_rate=1e-2)
    state = init_opt(tp)
    opt = optax.adamw(1e-2)
    jstate = opt.init(jp)
    jparams = jp
    for _ in range(5):
        _, grads = TTR.value_and_grad(TTR.lm_loss, tp, tcfg, tt, tm)  # what step_fn is about to use
        jg = jax.tree.map(lambda a: a, jparams)
        jg = _to_jax_tree(grads, jg)
        updates, jstate = opt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tp, state, _ = step(tp, state, tt, tm)
        want = dict(_leaves(TT.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")))
        for path, w in want.items():
            torch.testing.assert_close(dict(_leaves(tp))[path].detach(), w, rtol=0, atol=PARAM_ATOL, msg=path)
    assert int(state["count"]) == int(jstate[0].count) == 5
    for path, w in _leaves(TT.params_from_jax(jax.tree.map(np.asarray, jstate[0].mu), tcfg, device="cpu")):
        torch.testing.assert_close(dict(_leaves(state["mu"]))[path], w, rtol=1e-5, atol=1e-7, msg=path)


def _to_jax_tree(grads: dict, like):
    """The port's gradient tree as JAX arrays in ``like``'s structure."""
    if isinstance(like, dict):
        return {k: _to_jax_tree(grads[k], v) for k, v in like.items()}
    return jnp.asarray(grads.detach().numpy())


def test_five_steps_track_jax_with_their_own_gradients():
    jcfg, jp, tcfg, tp = _pair("tiny", seed=0)
    toks, mask = _batch(0)
    tt, tm = torch.from_numpy(toks), torch.from_numpy(mask)
    _, init_opt, step = TP.make_train_step(tcfg, TP.make_mesh(devices=["cpu"]), learning_rate=1e-2)
    state = init_opt(tp)
    opt = optax.adamw(1e-2)
    jstate = opt.init(jp)
    for _ in range(5):
        jl, jg = jax.value_and_grad(JTR.lm_loss)(jp, jcfg, jnp.asarray(toks), jnp.asarray(mask))
        updates, jstate = opt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tp, state, loss = step(tp, state, tt, tm)
        assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    want = dict(_leaves(TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")))
    for path, p in _leaves(tp):
        torch.testing.assert_close(p.detach(), want[path], rtol=0, atol=TRAJ_PARAM_ATOL, msg=path)


def test_step_records_registry_rows():
    _, _, tcfg, tp = _pair("tiny", seed=8)
    toks, mask = _batch(8)
    default_registry().remove_model("train")
    _, init_opt, step = TP.make_train_step(tcfg, TP.make_mesh(devices=["cpu"]))
    state = init_opt(tp)
    for _ in range(3):
        step(tp, state, torch.from_numpy(toks), torch.from_numpy(mask))
    rows = {e["program"]: e for e in default_registry().snapshot(model="train")["programs"]}
    assert set(rows) == {"parallel.init_opt", "parallel.train_step"}
    assert (rows["parallel.train_step"]["compiles"], rows["parallel.train_step"]["hits"]) == (1, 2)
    assert rows["parallel.train_step"]["measured"] == "first_call" and rows["parallel.train_step"]["backend"] == "cpu"
    assert "(2, 12):int32" in rows["parallel.train_step"]["arg_shapes"]
    default_registry().remove_model("train")


# -- meshes -----------------------------------------------------------------------------

@pytest.mark.parametrize("n,tp", [(1, None), (8, None), (8, 2), (8, 8), (6, 3)])
def test_mesh_shape_for_matches_jax(n, tp):
    assert TP.mesh_shape_for(n, tp) == JP.mesh_shape_for(n, tp)


def test_mesh_shape_for_refuses_like_jax():
    with pytest.raises(ValueError) as je:
        JP.mesh_shape_for(8, 3)
    with pytest.raises(ValueError) as te:
        TP.mesh_shape_for(8, 3)
    assert str(je.value) == str(te.value)


def test_make_mesh():
    mesh = TP.make_mesh(devices=["cpu"])
    assert mesh.shape == {"data": 1, "model": 1} and mesh.devices == (torch.device("cpu"),) and mesh.size == 1
    mesh = TP.make_mesh({"data": 2, "model": 1}, devices=["cpu", "cpu"])
    assert mesh.axis_names == ("data", "model") and mesh.sizes == (2, 1)
    with pytest.raises(ValueError, match="mesh shape"):
        TP.make_mesh({"data": 2}, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            TP.make_mesh()


@pytest.mark.parametrize("shape", [{"data": 2, "model": 1}, {"data": 1, "model": 2}, {"seq": 2}])
def test_make_train_step_refuses_a_multi_device_mesh(shape):
    mesh = TP.make_mesh(shape, devices=["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP ID 11"):
        TP.make_train_step(TT.TransformerConfig.tiny(), mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP ID 11"):
        TP.place_batch({"x": np.zeros(2)}, mesh)


def test_place_batch():
    mesh = TP.make_mesh(devices=["cpu"])
    out = TP.place_batch((np.arange(6).reshape(2, 3)[:, ::2], {"m": np.ones(2, bool)}), mesh)
    assert isinstance(out, tuple) and torch.equal(out[0], torch.tensor([[0, 2], [3, 5]]))
    assert out[1]["m"].dtype == torch.bool


def test_parallel_exports_only_what_is_ported():
    """The names of JAX's parallel.__all__ the port lacks are exactly ROADMAP
    ID 11's: tensor parallelism, the ring, the pipeline, multi-host."""
    id11 = {"init_distributed", "is_primary", "topology", "pipeline_layers", "pp_lm_loss", "pp_param_shardings",
            "make_pp_train_step", "param_specs", "mlp_param_specs", "batch_spec", "kv_specs", "replicate_gather",
            "tp_submeshes", "shard_params", "with_shardings", "ring_attention", "ring_prefill"}
    assert set(TP.__all__) <= set(JP.__all__)
    assert set(JP.__all__) - set(TP.__all__) == id11
    assert all(callable(getattr(TP, name)) for name in TP.__all__)


# -- MoE ---------------------------------------------------------------------------------

@pytest.mark.parametrize("experts,capacity", [(8, 1.25), (4, 2.0), (4, 0.5)])
def test_moe_loss_aux_and_gradients_match_jax(experts, capacity):
    jcfg = dataclasses.replace(JM.MoEConfig.tiny(experts), capacity_factor=capacity)
    tcfg = dataclasses.replace(TM.MoEConfig.tiny(experts), capacity_factor=capacity)
    jp = JM.moe_init(jax.random.PRNGKey(experts), jcfg)
    tp = TM.moe_params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks, mask = _batch(experts, s=16)
    jt = jnp.asarray(toks)
    logits_j, aux_j = JM.moe_transformer_forward(jp, jcfg, jt)
    logits_t, aux_t = TM.moe_transformer_forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), atol=1e-4)
    assert abs(float(aux_t) - float(aux_j)) < 1e-6
    jl, jg = jax.value_and_grad(JM.moe_lm_loss)(jp, jcfg, jt, jnp.asarray(mask))
    loss, grads = TTR.value_and_grad(TM.moe_lm_loss, tp, tcfg, torch.from_numpy(toks), torch.from_numpy(mask))
    assert abs(float(loss) - float(jl)) < LOSS_ATOL
    want = dict(_leaves(TM.moe_params_from_jax(jax.tree.map(np.asarray, jg), tcfg, device="cpu")))
    got = dict(_leaves(grads))
    assert set(got) == set(want)
    for path, w in want.items():
        torch.testing.assert_close(got[path], w, rtol=GRAD_RTOL, atol=GRAD_ATOL, msg=path)


def test_moe_init_tree_matches_jax():
    cfg_j, cfg_t = JM.MoEConfig.tiny(), TM.MoEConfig.tiny()
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(JM.moe_init(jax.random.PRNGKey(0), cfg_j))}
    got = TM.moe_init(torch.Generator().manual_seed(0), cfg_t, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in _leaves(got)} == want
    assert not got["final_norm"].any() and not got["layers"]["attn_norm"].any()
    # normal / sqrt(fan_in): the router's columns have unit-ish norm over d
    assert 0.5 < float(got["layers"]["w_router"].std() * cfg_t.d_model ** 0.5) < 1.5


def test_moe_training_steps_lower_the_loss():
    cfg = TM.MoEConfig.tiny(4)
    params = TM.moe_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    opt = TP.AdamW(1e-2)
    state = opt.init(params)
    toks, mask = (torch.from_numpy(x) for x in _batch(9, s=16))
    losses = []
    for _ in range(4):
        loss, grads = TTR.value_and_grad(TM.moe_lm_loss, params, cfg, toks, mask)
        opt.update(params, grads, state)
        losses.append(float(loss))
    assert losses[-1] < losses[0]


# -- the training checkpoint --------------------------------------------------------------

def test_train_state_round_trip_is_bitwise(tmp_path):
    cfg = TT.TransformerConfig.tiny()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params["embed"] = params["embed"].to(torch.bfloat16)
    state = TP.AdamW(1e-3).init(params)
    state["count"].fill_(7)
    state["mu"]["layers"]["wq"].normal_()
    path = str(tmp_path / "s.safetensors")
    save_train_state(path, params, state)
    p2, s2 = load_train_state(path, device="cpu")
    for (ka, a), (kb, b) in zip(_leaves({"params": params, "opt": state}), _leaves({"params": p2, "opt": s2})):
        assert ka == kb and a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), ka
    again = str(tmp_path / "again.safetensors")
    save_train_state(again, p2, s2)
    with open(path, "rb") as f1, open(again, "rb") as f2:
        assert f1.read() == f2.read()


def test_save_safetensors_is_read_by_the_safetensors_package(tmp_path):
    from safetensors.numpy import load_file

    tensors = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": torch.tensor(3, dtype=torch.int32),
               "c": torch.arange(5, dtype=torch.int64), "d": torch.ones(3, dtype=torch.int8) * -2,
               "e": torch.tensor([1.5, -2.0], dtype=torch.float16)}
    path = save_safetensors(tensors, str(tmp_path / "x.safetensors"))
    got = load_file(path)
    for k, t in tensors.items():
        np.testing.assert_array_equal(got[k], t.numpy())
    assert all(torch.equal(SafetensorsFiles([path])[k], t) for k, t in tensors.items())
    with open(path, "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0
    with pytest.raises(TypeError, match="not written"):
        save_safetensors({"x": torch.zeros(2, dtype=torch.bool)}, str(tmp_path / "y.safetensors"))


# -- the train-lm example -------------------------------------------------------------------

def _load_jax_example():
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_cmp_train_lm", os.path.join(EXAMPLES, "train-lm", "main.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(app, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = app.run(argv)
    assert rc == 0, buf.getvalue()
    return buf.getvalue().strip().splitlines()[-1]


@pytest.mark.parametrize("n", [1000, 50_000])
def test_example_corpus_bytes_equal_jax(tmp_path, monkeypatch, n):
    from gofr_tpu_torch.examples import train_lm

    monkeypatch.chdir(os.path.join(EXAMPLES, "train-lm"))
    jax_app, port_app = _load_jax_example().build_app(), train_lm.build_app()
    jp, tp = str(tmp_path / "j.tok"), str(tmp_path / "t.tok")
    assert _run(jax_app, ["encode", f"-out={jp}", f"-n={n}"]) == f"wrote {n} tokens to {jp}"
    assert _run(port_app, ["encode", f"-out={tp}", f"-n={n}"]) == f"wrote {n} tokens to {tp}"
    for suffix in ("", ".json"):
        with open(jp + suffix, "rb") as a, open(tp + suffix, "rb") as b:
            assert a.read() == b.read()


def test_example_resume_equals_a_straight_run(tmp_path, monkeypatch):
    """encode -> train 8 -> train 8 from the checkpoint equals 16 straight
    steps on the CPU: the loss, the iterator's position and every saved
    tensor, bitwise."""
    from gofr_tpu_torch.examples import train_lm

    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    app = train_lm.build_app()
    corpus = str(tmp_path / "c.tok")
    _run(app, ["encode", f"-out={corpus}", "-n=50000"])
    run = str(tmp_path / "run")
    first = ast.literal_eval(_run(app, ["train", f"-corpus={corpus}", "-steps=8", f"-ckpt={run}"]))
    second = ast.literal_eval(_run(app, ["train", f"-corpus={corpus}", "-steps=8", f"-ckpt={run}"]))
    straight = ast.literal_eval(_run(app, ["train", f"-corpus={corpus}", "-steps=16", f"-ckpt={tmp_path / 's'}"]))
    assert (first["global_step"], second["global_step"], straight["global_step"]) == (8, 16, 16)
    assert first["resumed"] == {"epoch": 0, "step": 0} and second["resumed"] == {"epoch": 0, "step": 8}
    assert second["loss_last"] == straight["loss_last"] and first["loss_first"] == straight["loss_first"]
    assert second["loss_last"] < first["loss_first"]
    a = SafetensorsFiles([os.path.join(run, train_lm.STATE_FILE)])
    b = SafetensorsFiles([str(tmp_path / "s" / train_lm.STATE_FILE)])
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert int(a["opt/count"]) == 16
