"""How strong a random adapter must be to move Gemma-2B's greedy tokens,
and what it costs the served path's agreement with the plain forward: for
adapters of rank 8 on all six targets at init scales 0.5-2.0, on three of
chip_smoke.py's burst prompts, the share of prompt positions whose argmax
leaves the base model's, the share with a top-2 gap under 0.25, and the
logit drift of the served chunked path (64-token prefill chunks through
the flash kernel, with the adapter's delta) from the plain forward. Needs
a CUDA device:

    PYTHONPATH=. python scripts/torch_lora_scale_sweep.py
"""
import torch
import chip_smoke as C
from gofr_tpu_torch.models import KVCache, prefill_append, transformer_forward
from gofr_tpu_torch.lora import init_adapter

dev = C.phase_device()
cfg, params = C.gemma_weights(0)
_pl, prompts = C._burst_prompts(cfg, 0)

def drift(p_ad, prompt):
    cap = 512
    k0 = torch.zeros((cfg.n_layers, 1, cap, cfg.n_kv_heads, cfg.head_dim), dtype=cfg.dtype, device="cuda")
    view = KVCache(k=k0, v=k0.clone(), length=torch.zeros(1, dtype=torch.int32, device="cuda"))
    cur = 0
    aids = torch.tensor([1], device="cuda")
    for c0 in range(0, len(prompt), 64):
        chunk = prompt[c0:c0 + 64]
        toks = torch.zeros((1, 64), dtype=torch.long, device="cuda")
        toks[0, :len(chunk)] = torch.tensor(chunk, device="cuda")
        lc, view = prefill_append(p_ad, cfg, toks, view, torch.tensor([cur], dtype=torch.int32, device="cuda"),
                                  torch.tensor([len(chunk)], dtype=torch.int32, device="cuda"), aids=aids)
        cur += len(chunk)
    plain = transformer_forward(p_ad, cfg, torch.tensor([prompt], device="cuda"),
                                torch.arange(len(prompt), device="cuda")[None], aids=aids)[0]
    return float((lc[0] - plain[-1]).abs().max()), plain

for s in (0.5, 1.0, 1.25, 1.5, 2.0):
    g = torch.Generator(device="cuda").manual_seed(13)
    ad = init_adapter(g, cfg, 8, scale=s)
    pa = C._adapter_params(params, cfg, {t: {"a": p["a"].cpu().numpy(), "b": p["b"].cpu().numpy()} for t, p in ad.items()})
    out = []
    for i in (1, 4, 6):
        p = prompts[i]
        d, plain = drift(pa, p)
        base = transformer_forward(params, cfg, torch.tensor([p], device="cuda"), torch.arange(len(p), device="cuda")[None])[0]
        moved = float((plain.argmax(-1) != base.argmax(-1)).float().mean())
        top2 = torch.topk(plain, 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1])
        out.append(f"prompt {len(p)}: drift {d:.3f}, moved {moved:.3f}, gap<0.25 {float((gaps < 0.25).float().mean()):.3f}, |logit| max {float(plain.abs().max()):.1f}")
    print(f"scale {s}: " + "; ".join(out))
