"""gofr_tpu_torch.ops._build's reader of a build's ptxas report: registers
and spills per kernel (chip_smoke.py fails a build whose bf16 flash kernel
spills). Pure Python, no compiler needed."""

from gofr_tpu_torch.ops import _build

_ANON = "_ZN51_GLOBAL__N__f03ba587_18_flash_attention_cu_fc75649f"
_MMA = _ANON + "16flash_mma_kernelILi256EEEvPK13__nv_bfloat16"
_FMA = _ANON + "12flash_kernelIfLi256EEEvPKT_"


def test_ptxas_kernels_reads_registers_and_spills():
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{_MMA}' for 'sm_90a'",
        f"ptxas info    : Function properties for {_MMA}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 244 registers, used 1 barriers, 432 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{_FMA}' for 'sm_90a'",
        f"ptxas info    : Function properties for {_FMA}",
        "    24 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 96 registers, 432 bytes cmem[0]",
    ])
    assert _build.ptxas_kernels(log) == {
        _MMA: {"registers": 244, "spill_bytes": 0},
        _FMA: {"registers": 96, "spill_bytes": 20},
    }
