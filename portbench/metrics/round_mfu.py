"""The whole round's share of the card's fp32 peak: the model FLOPs of the
window's useful local-training samples (each lane's steps x B, trained:
forward and backward) and of its evaluations' forwards, counted on the
plain reference, over the traced window's seconds x 67 TFLOP/s."""
import roofline


def read(ctx):
    flops = ctx.get("flops")
    if not flops or ctx["window_s"] <= 0:
        return None
    return 100.0 * flops / (ctx["window_s"] * roofline.FP32_FLOPS)
