"""Mamba2 (state-space duality) layer: the chunked SSD scan for train and
prefill, the O(1) recurrent step for decode (twin of
``repro.models.ssm``).

Follows the ssd_minimal discrete formulation of Dao & Gu
(arXiv:2405.21060): within a chunk the dual (attention-like) quadratic
form, across chunks the SSM state carried in fp32, ngroups = 1 (B and C
shared across heads) as in the published mamba2-370m config. The
reference computes all of it outside any Pallas kernel (einsums and
``lax.scan``); here its scan over chunks is a Python loop.

Where values could part from the reference's, this module copies it:
the causal conv is W shifted multiply-adds in the input's dtype, the bias
first (a cuDNN ``conv1d`` would accumulate in fp32 and round otherwise),
while the decode step's conv is an einsum over the window, as the
reference's (the two round apart in bf16); the segment sums are masked to
``-inf`` before ``exp`` (after it, ``inf * 0`` is NaN in the forward and
in the grads); softplus is ``logaddexp(x, 0)``, ``jax.nn.softplus``'s
form; ``dt`` is cast to ``x``'s dtype before the product, and each
chunk's output to it after the sum. The reference's sharding hints
(``shard_act``) change no value and have no twin here; the cache's logical
axes (``mamba2_cache_axes``) are the reference's.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamFactory, rms_norm


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_ssm_heads(cfg: ModelConfig) -> int:
    return d_inner(cfg) // cfg.ssm_headdim


def conv_dim(cfg: ModelConfig) -> int:
    return d_inner(cfg) + 2 * cfg.ssm_ngroups * cfg.ssm_state


def init_mamba2(pf: ParamFactory, cfg: ModelConfig) -> None:
    D, di, H = cfg.d_model, d_inner(cfg), n_ssm_heads(cfg)
    cd, W = conv_dim(cfg), cfg.ssm_conv
    d_proj = 2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state + H
    pf.param("in_proj", (D, d_proj), ("d_model", "ffn"))
    pf.param("conv_w", (W, cd), (None, "ffn"))
    pf.param("conv_b", (cd,), ("ffn",), init="zeros")
    pf.param("dt_bias", (H,), ("ssm_heads",), init="ssm_dt")
    pf.param("A_log", (H,), ("ssm_heads",), init="ssm_a")
    pf.param("D_skip", (H,), ("ssm_heads",), init="ones")
    pf.param("norm_w", (di,), ("ffn",), init="ones")
    pf.param("out_proj", (di, D), ("ffn", "d_model"))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns
    ``x`` itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, H, gn = d_inner(cfg), n_ssm_heads(cfg), cfg.ssm_ngroups * cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    assert dt.shape[-1] == H
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of window W, unrolled in ``xBC``'s dtype:
    the bias, then the W shifted products added in order. xBC [B,S,Cd]."""
    W = w.shape[0]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    S = xBC.shape[1]
    acc = torch.zeros_like(xBC) + b.to(xBC.dtype)
    for i in range(W):
        acc = acc + pad[:, i:i + S, :] * w[i].to(xBC.dtype)
    return F.silu(acc)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., Q] log-decays -> [..., Q, Q] lower-triangular segment sums,
    L[q, s] = sum_{j=s+1..q} a_j for q >= s, -inf above the diagonal."""
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(a.shape[-1], device=a.device)
    return torch.where(idx[:, None] >= idx[None, :], seg, -torch.inf)


def ssd_chunked(xd: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """xd [B,S,H,P] (already dt-discretized), a [B,S,H] log decay (dt*A),
    Bm/Cm [B,S,N] (ngroups=1). Returns (y [B,S,H,P] in xd's dtype, the
    final state [B,H,P,N] fp32); ``h0`` the state entering the first
    chunk (zeros by default)."""
    Bb, S, H, Pd = xd.shape
    N = Bm.shape[-1]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    r = lambda t: t.reshape(Bb, nc, chunk, *t.shape[2:])
    xd_c, a_c, B_c, C_c = r(xd), r(a), r(Bm), r(Cm)
    h = (h0 if h0 is not None
         else torch.zeros((Bb, H, Pd, N), dtype=torch.float32,
                          device=xd.device))
    ys = []
    for c in range(nc):
        a_i = a_c[:, c].to(torch.float32)              # [B,Q,H]
        cs = torch.cumsum(a_i, dim=1)
        L = torch.exp(_segsum(a_i.transpose(1, 2)))    # [B,H,Q,Q]
        xf = xd_c[:, c].to(torch.float32)              # [B,Q,H,P]
        bf = B_c[:, c].to(torch.float32)               # [B,Q,N]
        cf = C_c[:, c].to(torch.float32)
        y_diag = torch.einsum("bqn,bkn,bhqk,bkhp->bqhp", cf, bf, L, xf)
        decay_states = torch.exp(cs[:, -1:, :] - cs)   # [B,Q,H]
        state_c = torch.einsum("bkn,bkh,bkhp->bhpn", bf, decay_states, xf)
        y_off = torch.einsum("bqn,bhpn,bqh->bqhp", cf, h, torch.exp(cs))
        h = h * torch.exp(cs[:, -1, :])[:, :, None, None] + state_c
        ys.append((y_diag + y_off).to(xd.dtype))
    y = torch.stack(ys, dim=1).reshape(Bb, S, H, Pd)
    return y, h


def ssd_reference(xd, a, Bm, Cm) -> torch.Tensor:
    """O(S^2) dual-form oracle for tests:
    y_t = sum_{s<=t} C_t.B_s exp(sum a) x_s."""
    af = a.to(torch.float32).transpose(1, 2)           # [B,H,S]
    L = torch.exp(_segsum(af))                         # [B,H,S,S]
    return torch.einsum("bqn,bkn,bhqk,bkhp->bqhp",
                        Cm.to(torch.float32), Bm.to(torch.float32), L,
                        xd.to(torch.float32)).to(xd.dtype)


def chunk_for(cfg: ModelConfig, S: int) -> int:
    """The largest chunk at or below ``cfg.ssm_chunk`` that divides S (odd
    lengths degrade toward the pure recurrence, as the reference's)."""
    chunk = min(cfg.ssm_chunk, S)
    while S % chunk:
        chunk -= 1
    return chunk


def mamba2_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                   cache: Optional[dict] = None):
    """Full-sequence path (train / prefill). Returns (y, new cache or
    None). With ``cache`` (any dict, ``{}`` included) the final SSM state
    and the conv's raw input tail are returned, so decode can continue."""
    B, S, D = x.shape
    di, H, Pd, N = d_inner(cfg), n_ssm_heads(cfg), cfg.ssm_headdim, cfg.ssm_state
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"].to(x.dtype))
    z, xBC_raw, dt = _split_proj(zxbcdt, cfg)
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xs = xBC[..., :di].reshape(B, S, H, Pd)
    Bm = xBC[..., di:di + N]
    Cm = xBC[..., di + N:]
    dt = softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))
    a = dt * A                                         # [B,S,H] log decay
    xd = xs * dt.to(xs.dtype)[..., None]
    y, h_final = ssd_chunked(xd, a, Bm, Cm, chunk_for(cfg, S))
    y = y + xs * p["D_skip"].to(xs.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    new_cache = None
    if cache is not None:
        # the conv cache holds the raw (pre-activation) trailing inputs,
        # left-padded with zeros when S < W - 1
        W = cfg.ssm_conv
        conv_tail = xBC_raw[:, max(0, S - (W - 1)):, :]
        if conv_tail.shape[1] < W - 1:
            conv_tail = F.pad(conv_tail,
                              (0, 0, W - 1 - conv_tail.shape[1], 0))
        new_cache = {"h": h_final, "conv": conv_tail}
    return out, new_cache


def mamba2_decode_step(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       cache: dict):
    """x: [B, 1, D]; cache: {'h': [B,H,P,N] fp32, 'conv': [B, W-1, Cd]}.
    Returns (y, new cache); the caller's cache is not written."""
    B = x.shape[0]
    di, H, Pd, N = d_inner(cfg), n_ssm_heads(cfg), cfg.ssm_headdim, cfg.ssm_state
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"].to(x.dtype))
    z, xBC_raw, dt = _split_proj(zxbcdt, cfg)
    window = torch.cat([cache["conv"], xBC_raw], dim=1)        # [B, W, Cd]
    conv_out = torch.einsum("bwc,wc->bc", window,
                            p["conv_w"].to(x.dtype)) + p["conv_b"].to(x.dtype)
    xBC = F.silu(conv_out)                                     # [B, Cd]
    xs = xBC[..., :di].reshape(B, H, Pd)
    Bm = xBC[..., di:di + N]
    Cm = xBC[..., di + N:]
    dtv = softplus(dt[:, 0].to(torch.float32)
                   + p["dt_bias"].to(torch.float32))           # [B,H]
    A = -torch.exp(p["A_log"].to(torch.float32))
    decay = torch.exp(dtv * A)                                 # [B,H]
    xf = xs.to(torch.float32)
    h_new = cache["h"] * decay[:, :, None, None] + torch.einsum(
        "bn,bh,bhp->bhpn", Bm.to(torch.float32), dtv, xf)
    y = torch.einsum("bn,bhpn->bhp", Cm.to(torch.float32), h_new)
    y = (y + xf * p["D_skip"].to(torch.float32)[None, :, None]).to(x.dtype)
    y = y.reshape(B, 1, di)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    return out, {"h": h_new, "conv": window[:, 1:, :]}


def mamba2_cache_shape(cfg: ModelConfig, batch: int, dtype) -> dict:
    """The cache's leaves as ``meta`` tensors (the reference's
    ``ShapeDtypeStruct``s): the SSM state in fp32, the conv tail in
    ``dtype``."""
    H, Pd, N, W = n_ssm_heads(cfg), cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv
    return {"h": torch.empty((batch, H, Pd, N), dtype=torch.float32,
                             device="meta"),
            "conv": torch.empty((batch, W - 1, conv_dim(cfg)), dtype=dtype,
                                device="meta")}


def mamba2_cache_axes() -> dict:
    return {"h": ("batch", "ssm_heads", None, "state"),
            "conv": ("batch", None, "ffn")}
