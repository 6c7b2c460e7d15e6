"""gofr_tpu_torch.models.checkpoint and .tokenizer against gofr_tpu's on
files the tests write themselves (CPU): the port's tree equals the JAX
loader's (through params_from_jax) on f32 files, bf16 files load bitwise,
the JAX messages word for word, Orbax refused by name, the HF tokenizer,
and the HTTP edge serving a checkpoint and a tokenizer from disk."""

import dataclasses
import http.client
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import save_file as save_torch

from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import checkpoint as JC
from gofr_tpu.models import tokenizer as JTok
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch import serve
from gofr_tpu_torch.config import new_mock_config
from gofr_tpu_torch.models import checkpoint as TC
from gofr_tpu_torch.models import tokenizer as TTok
from gofr_tpu_torch.models import transformer as TT

# (preset, mapper family, head): "untied" a distinct lm_head.weight, "alias"
# an lm_head.weight equal to the embedding (a tied model's state dict),
# None no lm_head at all
MODELS = {
    "gemma": ("tiny", "gemma", None),
    "llama_untied": ("tiny_llama", "llama", "untied"),
    "llama_alias": ("tiny_llama", "llama", "alias"),
    "qwen2": ("tiny_qwen2", "llama", "untied"),
}
LAYOUTS = ("file", "shards", "index")


def _hf_tensors(cfg, seed: int, head) -> dict[str, np.ndarray]:
    """A random HF-layout state dict for ``cfg`` (f32 numpy)."""
    rng = np.random.default_rng(seed)
    d, hd, hq, hkv, ff = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    t = {"model.embed_tokens.weight": r(cfg.vocab_size, d), "model.norm.weight": 1 + 0.1 * r(d)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        t.update({
            p + "self_attn.q_proj.weight": r(hq * hd, d),
            p + "self_attn.k_proj.weight": r(hkv * hd, d),
            p + "self_attn.v_proj.weight": r(hkv * hd, d),
            p + "self_attn.o_proj.weight": r(d, hq * hd),
            p + "mlp.gate_proj.weight": r(ff, d),
            p + "mlp.up_proj.weight": r(ff, d),
            p + "mlp.down_proj.weight": r(d, ff),
            p + "input_layernorm.weight": 1 + 0.1 * r(d),
            p + "post_attention_layernorm.weight": 1 + 0.1 * r(d),
        })
        if cfg.qkv_bias:
            t[p + "self_attn.q_proj.bias"] = r(hq * hd)
            t[p + "self_attn.k_proj.bias"] = r(hkv * hd)
            t[p + "self_attn.v_proj.bias"] = r(hkv * hd)
    if head == "untied":
        t["lm_head.weight"] = r(cfg.vocab_size, d)
    elif head == "alias":
        t["lm_head.weight"] = t["model.embed_tokens.weight"].copy()
    return t


def _write(tensors: dict, path, layout: str, save=save_numpy) -> str:
    """Write ``tensors`` as one file, as two shards, or as two shards with a
    model.safetensors.index.json; returns the path to load."""
    os.makedirs(path, exist_ok=True)
    if layout == "file":
        save(tensors, os.path.join(path, "model.safetensors"))
        return os.path.join(path, "model.safetensors")
    names = sorted(tensors)
    half = len(names) // 2
    shards = {"model-00001-of-00002.safetensors": names[:half], "model-00002-of-00002.safetensors": names[half:]}
    for fname, keys in shards.items():
        save({k: tensors[k] for k in keys}, os.path.join(path, fname))
    if layout == "index":
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": {k: fn for fn, ks in shards.items() for k in ks}}, f)
    return str(path)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _assert_trees_equal(got: dict, want: dict) -> None:
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# -- the loader against JAX's ---------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("model", list(MODELS))
def test_loader_matches_jax_on_f32_files(tmp_path, model, layout):
    preset, family, head = MODELS[model]
    jcfg, tcfg = getattr(JT.TransformerConfig, preset)(), getattr(TT.TransformerConfig, preset)()
    path = _write(_hf_tensors(tcfg, 3, head), tmp_path / "ckpt", layout)
    want = JC.load_checkpoint(path, jcfg, family=family)
    got = TC.load_checkpoint(path, tcfg, family=family, device="cpu")
    assert ("unembed" in got) == (head == "untied")
    _assert_trees_equal(got, TT.params_from_jax(jax.tree.map(np.asarray, want), tcfg, device="cpu"))
    TC.validate_params(got, tcfg)
    JC.validate_params(want, jcfg)


def test_loads_bf16_bitwise_as_jax(tmp_path):
    """A bf16 Llama-shaped checkpoint (Qwen2's bias too) written by
    safetensors.torch: every leaf of the port's tree is bitwise the JAX
    loader's. ROADMAP queue 3 item 10: the JAX loader reads it through
    safetensors.numpy, which knows bfloat16 only once ml_dtypes is imported
    (importing gofr_tpu imports jax, which imports it); a process that
    never imported ml_dtypes gets TypeError from the same call."""
    tcfg = dataclasses.replace(TT.TransformerConfig.tiny_qwen2(), dtype=torch.bfloat16)
    jcfg = dataclasses.replace(JT.TransformerConfig.tiny_qwen2(), dtype=jnp.bfloat16)
    src = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _hf_tensors(tcfg, 5, "untied").items()}
    path = _write(src, tmp_path / "bf16", "index", save=save_torch)
    got = TC.load_llama_checkpoint(path, tcfg, device="cpu")
    TC.validate_params(got, tcfg)
    want = JC.load_llama_checkpoint(path, jcfg)
    for k, leaf in _flat(want).items():
        g = _flat(got)[k]
        assert g.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(g.view(torch.int16).numpy(), np.asarray(leaf).view(np.int16), err_msg=k)
    # the raw leaves are the file's bytes
    assert torch.equal(got["embed"].view(torch.int16), src["model.embed_tokens.weight"].view(torch.int16))
    assert torch.equal(got["unembed"].view(torch.int16), src["lm_head.weight"].view(torch.int16))
    assert torch.equal(got["layers"]["wq"][1].T.contiguous().view(torch.int16),
                       src["model.layers.1.self_attn.q_proj.weight"].view(torch.int16))
    shard = os.path.join(path, "model-00001-of-00002.safetensors")
    code = ("import sys; from safetensors.numpy import load_file\n"
            "try:\n    load_file(sys.argv[1])\nexcept TypeError as e:\n    print('TypeError', e)\n"
            "print('ml_dtypes' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code, shard], capture_output=True, text=True, check=True).stdout
    assert out.split("\n")[:2] == ["TypeError data type 'bfloat16' not understood", "False"]


def test_reader_dtypes_and_lazy_access(tmp_path):
    """The port's own reader on every dtype it reads, against the files
    safetensors.torch wrote."""
    rng = np.random.default_rng(0)
    src = {
        "bf16": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)).to(torch.bfloat16),
        "f16": torch.from_numpy(rng.normal(size=(4,)).astype(np.float16)),
        "f32": torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(np.float32)),
        "i8": torch.from_numpy(rng.integers(-127, 128, (7, 2)).astype(np.int8)),
    }
    fp = tmp_path / "x.safetensors"
    save_torch(src, str(fp))
    files = TC.load_safetensors_dir(str(fp))
    assert sorted(files) == sorted(src) and len(files) == 4
    for k, v in src.items():
        assert files[k].dtype == v.dtype and torch.equal(files[k], v), k


# -- errors, word for word --------------------------------------------------------


def _trees():
    jcfg, tcfg = JT.TransformerConfig.tiny_qwen2(), TT.TransformerConfig.tiny_qwen2()
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, tcfg, TT.params_from_jax(jp, tcfg, device="cpu")


def _drop(tree, *keys):
    tree = dict(tree, layers=dict(tree["layers"]))
    for k in keys:
        (tree["layers"] if k in tree["layers"] else tree).pop(k)
    return tree


VALIDATION_CASES = {
    "not a dict": lambda j, t: ([j], [t]),
    "one missing": lambda j, t: (_drop(j, "bq"), _drop(t, "bq")),
    "several missing": lambda j, t: (_drop(j, "bq", "bkv", "wo"), _drop(t, "bq", "bkv", "wo")),
    "unexpected": lambda j, t: (dict(j, extra=j["final_norm"]), dict(t, extra=t["final_norm"])),
    "bad unembed": lambda j, t: (dict(j, unembed=j["final_norm"]), dict(t, unembed=t["final_norm"])),
    "shape": lambda j, t: (dict(j, final_norm=j["final_norm"][:-1]), dict(t, final_norm=t["final_norm"][:-1])),
    "dtype": lambda j, t: (dict(j, embed=j["embed"].astype(jnp.bfloat16)),
                           dict(t, embed=t["embed"].to(torch.bfloat16))),
}


@pytest.mark.parametrize("case", list(VALIDATION_CASES))
def test_validate_params_messages_match_jax(case):
    jcfg, jp, tcfg, tp = _trees()
    jtree, ttree = VALIDATION_CASES[case](jp, tp)
    with pytest.raises(JC.CheckpointValidationError) as want:
        JC.validate_params(jtree, jcfg)
    with pytest.raises(TC.CheckpointValidationError) as got:
        TC.validate_params(ttree, tcfg)
    assert str(got.value) == str(want.value)
    assert got.value.status_code == 400


def test_validate_params_accepts_an_untied_head():
    jcfg, jp, tcfg, tp = _trees()
    JC.validate_params(dict(jp, unembed=jp["embed"]), jcfg)
    TC.validate_params(dict(tp, unembed=tp["embed"]), tcfg)


@pytest.mark.parametrize("case", ["family", "empty dir", "no dir", "missing tensor", "bias mismatch"])
def test_load_checkpoint_error_mapping_matches_jax(tmp_path, case):
    cfg_name, family = "tiny_llama", "llama"
    path = str(tmp_path / "ckpt")
    os.makedirs(path)
    tensors = _hf_tensors(TT.TransformerConfig.tiny_llama(), 1, "untied")
    if case == "family":
        family = "gpt2"
    elif case == "no dir":
        path = str(tmp_path / "nowhere")
    elif case == "missing tensor":
        tensors.pop("model.layers.1.mlp.up_proj.weight")
        _write(tensors, path, "file")
    elif case == "bias mismatch":
        cfg_name = "tiny_qwen2"
        _write(tensors, path, "file")
    with pytest.raises(JC.CheckpointValidationError) as want:
        JC.load_checkpoint(path, getattr(JT.TransformerConfig, cfg_name)(), family=family)
    with pytest.raises(TC.CheckpointValidationError) as got:
        TC.load_checkpoint(path, getattr(TT.TransformerConfig, cfg_name)(), family=family, device="cpu")
    assert str(got.value) == str(want.value)


def test_missing_shard_and_orbax_refused(tmp_path):
    cfg = TT.TransformerConfig.tiny_llama()
    path = _write(_hf_tensors(cfg, 2, "untied"), tmp_path / "ckpt", "index")
    os.remove(os.path.join(path, "model-00002-of-00002.safetensors"))
    with pytest.raises(TC.CheckpointValidationError, match="model-00002-of-00002.safetensors .* is missing"):
        TC.load_checkpoint(path, cfg, family="llama", device="cpu")
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    for family in ("gemma", "llama"):
        with pytest.raises(TC.CheckpointValidationError, match="Orbax"):
            TC.load_checkpoint(str(orbax), cfg, family=family, device="cpu")


# -- the tokenizer ------------------------------------------------------------------

WORDS = ["<unk>", "<s>", "</s>"] + [f"w{i}" for i in range(60)] + ["hello", "world", "the", "port", "serves"]


@pytest.fixture(scope="module")
def tokenizer_json(tmp_path_factory):
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel(vocab={w: i for i, w in enumerate(WORDS)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    tok.save(str(path))
    return str(path)


def test_tokenizer_matches_jax(tokenizer_json):
    for path in (tokenizer_json, os.path.dirname(tokenizer_json)):
        want, got = JTok.load_tokenizer(path), TTok.load_tokenizer(path)
        assert (got.bos_id, got.eos_id, got.vocab_size) == (want.bos_id, want.eos_id, want.vocab_size) == (1, 2, 68)
        text = "hello world w7 the port serves w59 unknown"
        for add_bos in (True, False):
            assert got.encode(text, add_bos=add_bos) == want.encode(text, add_bos=add_bos)
        ids = [1, 63, 64, 10, 2, 65]
        assert got.decode(ids) == want.decode(ids)
    with pytest.raises(FileNotFoundError):
        TTok.load_tokenizer(os.path.dirname(os.path.dirname(tokenizer_json)))


# -- serving from disk ----------------------------------------------------------------


def test_serve_checkpoint_and_tokenizer_from_disk(tmp_path, tokenizer_json):
    """GEMMA_PRESET=tiny-llama, GEMMA_CKPT and GEMMA_TOKENIZER: POST
    /generate with a text prompt answers the tokens and text of the JAX
    engine over the JAX loader's tree and the JAX tokenizer."""
    jcfg = JT.TransformerConfig.tiny_llama()
    ckpt = _write(_hf_tensors(TT.TransformerConfig.tiny_llama(), 4, "untied"), tmp_path / "ckpt", "index")
    jtok = JTok.load_tokenizer(tokenizer_json)
    ref = JEngine(jcfg, JC.load_llama_checkpoint(ckpt, jcfg), warmup=False, kv_paged=True,
                  slots=4, max_seq_len=256, prefill_buckets=(16, 64, 128))
    app = serve.build_app(new_mock_config({
        "HTTP_PORT": "0", "METRICS_PORT": "0", "REQUEST_TIMEOUT": "30", "LOG_LEVEL": "ERROR", "TORCH_DEVICE": "cpu",
        "GEMMA_PRESET": "tiny-llama", "GEMMA_CKPT": ckpt, "GEMMA_TOKENIZER": tokenizer_json,
    }))
    th = app.run_in_background()
    try:
        eng = app.container.tpu().llm(serve.MODEL)
        assert "unembed" in eng.params
        for prompt in ("hello world the port serves", "w1 w2 w3 w4 w5 w6 w7 w8 w9 w10 w11 w12 w13 w14 w15 w16 w17"):
            want = ref.generate(jtok.encode(prompt), max_new_tokens=12, eos_token=jtok.eos_id)
            conn = http.client.HTTPConnection("127.0.0.1", app.http_server.port, timeout=120)
            conn.request("POST", "/generate", body=json.dumps({"prompt": prompt, "max_new_tokens": 12}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
            assert resp.status == 201
            assert body["data"] == {"tokens": want, "text": jtok.decode(want)}
    finally:
        ref.close()
        app.shutdown()
        th.join(timeout=10)
