"""The port's hand kernels (``csrc/``), their wrappers and plain versions."""


def wrappers() -> dict:
    """Every kernel wrapper, by name; each counts its launches in
    ``<wrapper>.launches``."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_adam import fused_adam
    from repro_torch.kernels.quant8 import (compress_q8, dequantize_q8,
                                            quantize_q8)
    from repro_torch.kernels.staleness_agg import staleness_agg
    from repro_torch.kernels.topk import block_topk
    return {"staleness_agg": staleness_agg, "fused_adam": fused_adam,
            "block_topk": block_topk, "quantize_q8": quantize_q8,
            "dequantize_q8": dequantize_q8, "compress_q8": compress_q8,
            "flash_attention": flash_attention}


def launch_counts() -> dict:
    """Each wrapper's launches so far, by name."""
    return {name: fn.launches for name, fn in wrappers().items()}
