"""Checkpoint loading: HF safetensors -> the port's parameter dictionary
(counterpart of gofr_tpu/models/checkpoint.py; its HF half).

Layout conversions (``transformer.param_specs`` is the contract), as in
the JAX loader:

- HF linear weights are [out_features, in_features]; ours are [in, out],
  transposed on load.
- Per-layer tensors are stacked on a leading [n_layers] axis.
- k_proj/v_proj pack into ``wkv`` with heads OUTERMOST ([hkv, 2, hd]
  column blocks); Qwen2's k/v biases pack into ``bkv`` the same way.
- gate_proj/up_proj stay separate (``w_gate`` / ``w_up``).
- Gemma ties the embedding; Llama-shaped checkpoints with a distinct
  ``lm_head.weight`` get an ``unembed`` leaf, and Llama's norms are stored
  as HF's scale minus 1 so the shared (1 + scale) RMSNorm is exact.

What differs from the JAX loader:

- The port reads the safetensors format itself (an 8-byte little-endian
  header length, a JSON header, then raw little-endian tensor bytes,
  memory-mapped and viewed with ``torch.frombuffer``): BF16, F16, F32 and
  I8 tensors, with no ``safetensors`` package. The JAX loader goes through
  ``safetensors.numpy``, which reads bfloat16 (the format these families
  are published in) only once ``ml_dtypes`` has registered the type with
  numpy, as importing jax does; the port needs neither.
- Tensors are read lazily, one at a time: each stacked leaf is made once
  in ``cfg.dtype`` on the target device (``cuda`` unless the caller passes
  ``device="cpu"``) and filled layer by layer, so host memory holds one
  source tensor at a time, never a stacked copy.
- A source tensor whose shape does not fit its leaf raises ``ValueError``
  naming it (the JAX loader fails in a reshape or later in
  ``validate_params``).
- An Orbax directory is refused by name with ``CheckpointValidationError``:
  Orbax needs JAX, which the port does not use.

Training checkpoints, where JAX's train-lm example saves to Orbax: the
port writes the format it reads (``save_safetensors``, BF16, F16, F32,
I8, I32 and I64 tensors), and ``save_train_state`` / ``load_train_state``
put the parameters and the AdamW state (``count``, ``mu``, ``nu``) in
one file as named tensors (``params/layers/wq``, ``opt/mu/embed``, ...);
a round trip is bitwise.
"""

from __future__ import annotations

import json
import mmap
import os
from collections.abc import Mapping
from typing import Any

import torch

from .. import resolve_device
from .transformer import param_specs

__all__ = [
    "CheckpointValidationError",
    "SafetensorsFiles",
    "gemma_params_from_hf",
    "llama_params_from_hf",
    "load_checkpoint",
    "load_gemma_checkpoint",
    "load_llama_checkpoint",
    "load_safetensors_dir",
    "load_train_state",
    "save_safetensors",
    "save_train_state",
    "validate_params",
]


class CheckpointValidationError(ValueError):
    """A loaded param tree does not match the engine config (wrong
    structure, shape or dtype), or a checkpoint could not be loaded.
    Raised by :func:`validate_params` before any engine is built, naming
    the first offending path: a bad checkpoint answers 4xx."""

    status_code = 400


def _dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``bfloat16``: the names JAX and numpy print."""
    return str(dtype).removeprefix("torch.")


def _tree_specs(tree: Any, prefix: str = "") -> dict[str, tuple]:
    """Flatten a params tree (nested dicts of tensors or arrays) into
    ``{"layers/wq": (shape, dtype name)}``."""
    out: dict[str, tuple] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_tree_specs(tree[k], f"{prefix}{k}/"))
        return out
    path = prefix[:-1] if prefix else "<root>"
    out[path] = (tuple(getattr(tree, "shape", ())), _dtype_name(getattr(tree, "dtype", "?")))
    return out


def _expected_specs(cfg, prefix: str = "", specs: dict | None = None) -> dict[str, tuple]:
    """What ``cfg`` requires, from ``transformer.param_specs``: zero FLOPs,
    no memory, and the same tree ``init_params`` builds."""
    specs = param_specs(cfg) if specs is None else specs
    out: dict[str, tuple] = {}
    for k in sorted(specs):
        if isinstance(specs[k], dict):
            out.update(_expected_specs(cfg, f"{prefix}{k}/", specs[k]))
        else:
            out[f"{prefix}{k}"] = (tuple(specs[k][0]), _dtype_name(cfg.dtype))
    return out


def validate_params(params: Any, cfg) -> None:
    """Verify a param tree's structure, shapes and dtypes against what
    ``cfg`` requires. Raises :class:`CheckpointValidationError` naming the
    first mismatching path, with the JAX loader's messages. An extra
    ``unembed`` leaf (untied head) is accepted when it matches the
    embedding's layout."""
    if not isinstance(params, dict):
        raise CheckpointValidationError(
            f"params must be a dict pytree, got {type(params).__name__}"
        )
    expected = _expected_specs(cfg)
    got = _tree_specs(params)
    embed_spec = expected.get("embed")
    if (
        "unembed" in got
        and "unembed" not in expected
        and embed_spec is not None
        and got["unembed"] == embed_spec
    ):
        expected = dict(expected, unembed=embed_spec)
    missing = sorted(set(expected) - set(got))
    if missing:
        raise CheckpointValidationError(
            f"checkpoint is missing param {missing[0]!r} "
            f"(and {len(missing) - 1} more)" if len(missing) > 1 else
            f"checkpoint is missing param {missing[0]!r}"
        )
    extra = sorted(set(got) - set(expected))
    if extra:
        raise CheckpointValidationError(
            f"checkpoint has unexpected param {extra[0]!r} "
            f"(config {type(cfg).__name__} does not use it)"
        )
    for path in sorted(expected):
        eshape, edtype = expected[path]
        gshape, gdtype = got[path]
        if gshape != eshape:
            raise CheckpointValidationError(
                f"param {path!r} has shape {tuple(gshape)}, config "
                f"requires {tuple(eshape)}"
            )
        if gdtype != edtype:
            raise CheckpointValidationError(
                f"param {path!r} has dtype {gdtype}, config requires "
                f"{edtype}"
            )


# -- the safetensors format ---------------------------------------------------

_ST_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "I8": torch.int8,
    "I32": torch.int32, "I64": torch.int64,
}
_ST_NAMES = {dtype: name for name, dtype in _ST_DTYPES.items()}


class SafetensorsFiles(Mapping):
    """Every tensor of one or more .safetensors files, by name, read on
    access: ``files[name]`` is a CPU tensor viewing the file's bytes
    (memory-mapped copy-on-write, so nothing is read before the caller
    copies it and the file is never written)."""

    def __init__(self, paths: list[str]):
        self._entries: dict[str, tuple[mmap.mmap, int, dict]] = {}
        for path in paths:
            with open(path, "rb") as f:
                n = int.from_bytes(f.read(8), "little")
                header = json.loads(f.read(n))
                buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
            header.pop("__metadata__", None)
            for name, entry in header.items():
                self._entries[name] = (buf, 8 + n, entry)

    def __getitem__(self, name: str) -> torch.Tensor:
        buf, base, entry = self._entries[name]
        dtype = _ST_DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"tensor {name!r}: safetensors dtype {entry['dtype']!r} is not read "
                             f"(one of {sorted(_ST_DTYPES)})")
        shape = tuple(entry["shape"])
        start, end = entry["data_offsets"]
        count = 1
        for s in shape:
            count *= s
        if end - start != count * dtype.itemsize:
            raise ValueError(f"tensor {name!r}: {end - start} bytes for shape {shape} of {entry['dtype']}")
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(buf, dtype=dtype, count=count, offset=base + start).reshape(shape)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)


def load_safetensors_dir(path: str) -> SafetensorsFiles:
    """Every tensor of a .safetensors file or a directory of shards (with or
    without a model.safetensors.index.json, whose shards must all exist),
    read lazily."""
    if os.path.isfile(path):
        return SafetensorsFiles([path])
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        files = sorted({os.path.join(path, v) for v in weight_map.values()})
        for fp in files:
            if not os.path.isfile(fp):
                raise FileNotFoundError(f"shard {os.path.basename(fp)} listed in {index} is missing")
    else:
        files = sorted(
            os.path.join(path, n)
            for n in os.listdir(path)
            if n.endswith(".safetensors")
        )
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    return SafetensorsFiles(files)


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> str:
    """Write ``tensors`` (name -> tensor, on any device) as one .safetensors
    file at ``path``: the 8-byte little-endian header length, the JSON
    header (padded with spaces to 8 bytes), then each tensor's bytes in
    order. Written to a temporary name and renamed into place.
    ``SafetensorsFiles`` reads it back."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        code = _ST_NAMES.get(t.dtype)
        if code is None:
            raise TypeError(f"tensor {name!r}: dtype {t.dtype} is not written (one of {sorted(_ST_NAMES.values())})")
        data = t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy()
        header[name] = {"dtype": code, "shape": list(t.shape), "data_offsets": [offset, offset + data.nbytes]}
        blobs.append(data)
        offset += data.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for data in blobs:
            f.write(memoryview(data))
    os.replace(tmp, path)
    return path


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """{"layers/wq": leaf, ...} of a nested dict of tensors, in order."""
    out: dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def save_train_state(path: str, params: Mapping, opt_state: Mapping) -> str:
    """Parameters and optimizer state as named tensors in one .safetensors
    file: ``params/<path>`` and ``opt/<path>`` (``opt/count``,
    ``opt/mu/...``, ``opt/nu/...`` for ``parallel.adamw``)."""
    return save_safetensors({**_flatten(params, "params/"), **_flatten(opt_state, "opt/")}, path)


def load_train_state(path: str, device=None) -> tuple[dict, dict]:
    """(params, opt_state) from ``save_train_state``'s file, each tensor a
    copy on ``device`` (``cuda`` by default) in its stored dtype."""
    dev = resolve_device(device)
    trees: dict = {"params": {}, "opt": {}}
    files = SafetensorsFiles([path])
    for name in files:
        node = trees
        *parents, leaf = name.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = files[name].to(dev, copy=True)
    return trees["params"], trees["opt"]


# -- HF layouts -> the port's tree ---------------------------------------------

def _get(tensors: Mapping, *names: str) -> torch.Tensor:
    for n in names:
        if n in tensors:
            return tensors[n]
    raise KeyError(f"none of {names} in checkpoint (have {len(tensors)} tensors)")


def gemma_params_from_hf(tensors: Mapping, cfg, device=None) -> dict:
    """Map an HF-layout Gemma checkpoint (model.layers.N.* naming) onto the
    port's tree on ``device``. Works for any TransformerConfig whose dims
    match the checkpoint (gemma_2b / gemma_7b / tiny test checkpoints)."""
    return _params_from_hf(tensors, cfg, norm_offset=0.0, allow_untied=False, device=device)


def llama_params_from_hf(tensors: Mapping, cfg, device=None) -> dict:
    """Map an HF-layout Llama-shaped checkpoint (Llama, Mistral, Qwen2)
    onto the port's tree on ``device``: norms stored as HF's scale minus 1,
    and a distinct ``lm_head.weight`` as an ``unembed`` leaf (one equal to
    the embedding, as tied models' state dicts hold, keeps the tied
    path). HF's rotate_half RoPE is the split-halves convention, so the
    projections load unpermuted."""
    return _params_from_hf(tensors, cfg, norm_offset=-1.0, allow_untied=True, device=device)


def _params_from_hf(tensors: Mapping, cfg, norm_offset: float, allow_untied: bool = False, device=None) -> dict:
    if getattr(cfg, "n_experts", 0) > 0:
        raise NotImplementedError(
            "mixture-of-experts checkpoints have no mapper (dense Gemma/Llama trees only, as in the JAX package)"
        )
    dev = resolve_device(device)
    d, hd, hkv, L = cfg.d_model, cfg.head_dim, cfg.n_kv_heads, cfg.n_layers

    # Qwen2 family: bias on the q/k/v projections (packed like the weights).
    # The checkpoint and the config must agree.
    has_bias = "model.layers.0.self_attn.q_proj.bias" in tensors
    cfg_bias = getattr(cfg, "qkv_bias", False)
    if has_bias != cfg_bias:
        raise ValueError(
            f"checkpoint {'has' if has_bias else 'lacks'} q/k/v projection "
            f"biases but cfg.qkv_bias={cfg_bias} — use a matching config "
            f"(e.g. TransformerConfig.qwen2_7b() for Qwen2 checkpoints)"
        )

    def take(name: str, shape, transpose: bool = False) -> torch.Tensor:
        """The named tensor on the device in its own dtype, checked against
        our ``shape`` (reversed as HF stores a linear weight), and
        transposed to [in, out] when asked."""
        x = _get(tensors, name)
        want = tuple(reversed(shape)) if transpose else tuple(shape)
        if tuple(x.shape) != want:
            raise ValueError(f"checkpoint tensor {name!r} has shape {tuple(x.shape)}, expected {want}")
        x = x.to(dev)
        return x.T if transpose else x

    specs = param_specs(cfg)
    layers = {k: torch.empty(shape, dtype=cfg.dtype, device=dev) for k, (shape, _f) in specs["layers"].items()}
    linear = {"wq": "self_attn.q_proj", "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj",
              "w_up": "mlp.up_proj", "w_down": "mlp.down_proj"}
    for i in range(L):
        p = f"model.layers.{i}."
        for leaf, hf in linear.items():  # HF [out, in] -> ours [in, out]
            layers[leaf][i].copy_(take(p + hf + ".weight", layers[leaf].shape[1:], transpose=True))
        # heads outermost: [d, hkv, hd] x2 -> [d, hkv, 2, hd] -> [d, 2*hkv*hd]
        wkv = layers["wkv"][i].view(d, hkv, 2, hd)
        for j, hf in enumerate(("self_attn.k_proj", "self_attn.v_proj")):
            wkv[:, :, j].copy_(take(p + hf + ".weight", (d, hkv * hd), transpose=True).reshape(d, hkv, hd))
        if has_bias:
            layers["bq"][i].copy_(take(p + "self_attn.q_proj.bias", layers["bq"].shape[1:]))
            bkv = layers["bkv"][i].view(hkv, 2, hd)
            for j, hf in enumerate(("self_attn.k_proj.bias", "self_attn.v_proj.bias")):
                bkv[:, j].copy_(take(p + hf, (hkv * hd,)).reshape(hkv, hd))
        for leaf, hf in (("attn_norm", "input_layernorm"), ("mlp_norm", "post_attention_layernorm")):
            layers[leaf][i].copy_(take(p + hf + ".weight", (d,)).float() + norm_offset)

    embed_src = take("model.embed_tokens.weight", specs["embed"][0])
    embed = torch.empty(specs["embed"][0], dtype=cfg.dtype, device=dev).copy_(embed_src)
    final_norm = torch.empty((d,), dtype=cfg.dtype, device=dev).copy_(
        take("model.norm.weight", (d,)).float() + norm_offset
    )

    out_extra = {}
    if allow_untied and "lm_head.weight" in tensors:
        # Untied head, embed layout [vocab, d]. torch state_dicts of TIED
        # models still hold lm_head.weight (an alias of the embedding): a
        # value-equal head keeps the tied path instead of duplicating the
        # vocab table in device memory. Compared as stored, as JAX does.
        head = _get(tensors, "lm_head.weight").to(dev)
        if head.shape != embed_src.shape or not torch.equal(head, embed_src):
            out_extra["unembed"] = torch.empty(tuple(head.shape), dtype=cfg.dtype, device=dev).copy_(head)
        del head
    del embed_src
    return {**out_extra, "embed": embed, "final_norm": final_norm, "layers": layers}


def _refuse_orbax(path: str) -> None:
    if os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA"))
        or os.path.exists(os.path.join(path, "_METADATA"))
    ):
        raise CheckpointValidationError(
            f"{path!r} is an Orbax checkpoint: Orbax needs JAX, which gofr_tpu_torch does not use; "
            f"convert it to HF safetensors"
        )


def load_gemma_checkpoint(path: str, cfg, device=None) -> dict:
    """HF safetensors checkpoint (file or directory) -> params on
    ``device``; an Orbax directory is refused by name."""
    _refuse_orbax(path)
    return gemma_params_from_hf(load_safetensors_dir(path), cfg, device=device)


def load_llama_checkpoint(path: str, cfg, device=None) -> dict:
    """Llama-shaped analogue of load_gemma_checkpoint (Llama, Mistral,
    Qwen2)."""
    _refuse_orbax(path)
    return llama_params_from_hf(load_safetensors_dir(path), cfg, device=device)


def load_checkpoint(path: str, cfg, family: str = "gemma", device=None) -> dict:
    """Family-dispatching loader: an HF safetensors checkpoint goes through
    the family's layout mapping. Loader failures (missing files, unknown
    tensors, layout mismatches) surface as :class:`CheckpointValidationError`
    with the JAX loader's message, so a route answers 4xx instead of a
    masked 500."""
    if family not in ("gemma", "llama"):
        raise CheckpointValidationError(
            f"unknown checkpoint family {family!r} (gemma | llama)"
        )
    loader = load_llama_checkpoint if family == "llama" else load_gemma_checkpoint
    try:
        return loader(path, cfg, device=device)
    except CheckpointValidationError:
        raise
    except (FileNotFoundError, KeyError, ValueError, OSError) as e:
        raise CheckpointValidationError(
            f"failed to load checkpoint at {path!r}: {e}"
        ) from e
