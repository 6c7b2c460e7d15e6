"""Device time of six formulations of the LoRA delta (the served one,
``models.transformer._lora_delta``; all G gids in one batched product
of r columns; the JAX form with per-row gathered copies; the side-by-side form written out; einsum; and A stored side by
side ahead of time) at Gemma-2B's widths (G = 5 gids, rank 8, 4 layers
timed and scaled to 18), for a decode step of 32 rows and a prefill chunk
of 8 x 64 rows, with each form's top kernels from torch.profiler. Needs a
CUDA device:

    PYTHONPATH=. python scripts/torch_lora_delta_forms.py
"""
import torch, time
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from gofr_tpu_torch.models import TransformerConfig
from gofr_tpu_torch.models import transformer as T
from gofr_tpu_torch.lora import zero_tables, target_dims

torch.backends.cuda.matmul.allow_tf32 = False
cfg = TransformerConfig.gemma_2b()
L = 4
cfg2 = type(cfg)(**{**cfg.__dict__, "n_layers": L})
tabs = zero_tables(cfg2, 4, 8, "cuda")
g = torch.Generator(device="cuda").manual_seed(0)
for v in tabs.values():
    v.normal_(generator=g)
layers = [{k: v[i] for k, v in tabs.items()} for i in range(L)]
dims = target_dims(cfg2)
G, r = 5, 8

def served(h, lp, n, sel, aids):
    return T._lora_delta(h, lp, n, sel)

def batched(h, lp, n, sel, aids):  # all G gids in one batched product of r columns
    a = lp["lora_" + n + "_a"]; b = lp["lora_" + n + "_b"]
    rows, s, d = h.shape
    t = torch.matmul(h.reshape(-1, d).float().expand(G, -1, -1), a)  # [G, N, r]
    t = t.view(G, rows, s, r) * sel.T[:, :, None, None]
    t = t.permute(1, 2, 0, 3).reshape(rows * s, G * r)
    return (t @ b.reshape(G * r, -1)).view(rows, s, -1)

def gather(h, lp, n, sel, aids):
    ag = lp["lora_" + n + "_a"][aids]; bg = lp["lora_" + n + "_b"][aids]
    return torch.bmm(torch.bmm(h.float(), ag), bg)

def acat(h, lp, n, sel, aids):  # first product against A laid side by side (copy per call)
    a = lp["lora_" + n + "_a"]; b = lp["lora_" + n + "_b"]
    rows, s, d = h.shape
    x = h.reshape(-1, d).float()
    t = x @ a.permute(1, 0, 2).reshape(d, G * r)
    t = (t.view(rows, s, G, r) * sel[:, None, :, None]).reshape(rows * s, G * r)
    return (t @ b.reshape(G * r, -1)).view(rows, s, -1)

def einsum(h, lp, n, sel, aids):
    a = lp["lora_" + n + "_a"]; b = lp["lora_" + n + "_b"]
    t = torch.einsum("bsd,gdr->bsgr", h.float(), a) * sel[:, None, :, None]
    return torch.einsum("bsgr,gro->bso", t, b)

def prepermuted(h, lp, n, sel, aids):  # A stored [d_in, G*r] (a second layout)
    a = lp["cat_" + n]; b = lp["lora_" + n + "_b"]
    rows, s, d = h.shape
    t = h.reshape(-1, d).float() @ a
    t = (t.view(rows, s, G, r) * sel[:, None, :, None]).reshape(rows * s, G * r)
    return (t @ b.reshape(G * r, -1)).view(rows, s, -1)

for lp in layers:
    for n in dims:
        lp["cat_" + n] = lp["lora_" + n + "_a"].permute(1, 0, 2).reshape(dims[n][0], G * r).contiguous()

forms = {"served": served, "batched": batched, "gather": gather, "acat": acat, "einsum": einsum, "prepermuted": prepermuted}
for label, rows, s in (("decode", 32, 1), ("prefill", 8, 64)):
    aids = torch.randint(0, G, (rows,), generator=g, device="cuda")
    sel = (aids[:, None] == torch.arange(G, device="cuda")[None]).float()
    hs = {n: torch.randn((rows, s, d), generator=g, device="cuda").to(torch.bfloat16) for n, (d, _) in dims.items()}
    ref = {n: gather(hs[n], layers[0], n, sel, aids) for n in dims}
    for fname, f in forms.items():
        err = max(float((f(hs[n], layers[0], n, sel, aids) - ref[n]).abs().max()) for n in dims)
        fn = lambda: [f(hs[n], lp, n, sel, aids) for lp in layers for n in dims]
        fn(); torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        tot = sum(e.self_device_time_total for e in ev) / 3 / 1e3 / L * 18
        print(f"{label} {fname}: {tot:.3f} ms device per 18 layers (err {err:.2e})")
        for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:4]:
            print(f"    {e.self_device_time_total / 3 / 1e3 / L * 18:8.3f} ms  {e.count // 3:5d}x per {L} layers  {e.key[:110]}")
