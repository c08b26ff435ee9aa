"""Plain reference of the FEMNIST CNN (LEAF, Caldas et al. 2018, the CNN
that Apodotiko trains on FEMNIST): conv 5x5 x32 SAME, ReLU, max-pool 2;
conv 5x5 x64 SAME, ReLU, max-pool 2; fc 2048, ReLU; fc 62. 6,603,710 params.

Leaves in the published JAX layout the program stores its rows in: conv
weights HWIO, dense weights [in, out], images NHWC, the features
flattened in NHWC order before ``fc1``. Plain torch, fp32, no kernel of
the program.
"""
import torch.nn.functional as F

LEAVES = {
    "c1_w": ((5, 5, 1, 32), "normal"), "c1_b": ((32,), "zeros"),
    "c2_w": ((5, 5, 32, 64), "normal"), "c2_b": ((64,), "zeros"),
    "fc1_w": ((7 * 7 * 64, 2048), "normal"), "fc1_b": ((2048,), "zeros"),
    "fc2_w": ((2048, 62), "normal"), "fc2_b": ((62,), "zeros"),
}
PADDING = 2          # SAME for a 5x5 kernel at stride 1


def forward(p, x, cast=lambda t: t):
    """Logits [B, 62] of images ``x`` [B, 28, 28, 1]; ``cast`` rounds each
    product's inputs (the identity in fp32)."""
    h = x.permute(0, 3, 1, 2)
    for name in ("c1", "c2"):
        w = p[f"{name}_w"].permute(3, 2, 0, 1)
        h = F.max_pool2d(F.relu(F.conv2d(cast(h), cast(w), p[f"{name}_b"],
                                         padding=PADDING)), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(cast(h) @ cast(p["fc1_w"]) + p["fc1_b"])
    return cast(h) @ cast(p["fc2_w"]) + p["fc2_b"]
