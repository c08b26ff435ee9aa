"""The port's launch tooling against the reference's: the roofline
(twins of ``tests/test_roofline.py`` at the H100's constants), the
analytic counts of every cell, the meta trace (FLOPs by hand, a hand
kernel's bytes, the chunk loop counted whole, extrapolation), the dry
run's records, and the two small parts ported with this slice
(``incremental_aggregate``, ``LocalRunner(update_plane=)``)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import SHAPES as JSHAPES, get_config as jget
from repro.core import aggregation as jagg
from repro.launch import roofline as jroof
from repro.models import build_model as jbuild
from repro.sweep import grid as jgrid, runner as jrunner
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShapeConfig,
                                      get_config, shape_supported)
from repro_torch.core import aggregation
from repro_torch.kernels import _build
from repro_torch.kernels.ops import tree_leaves
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import (HBM_BW, ICI_BW, PEAK_FLOPS_BF16,
                                     make_card_mesh)
from repro_torch.launch.roofline import (MetaTrace, Roofline, _shape_bytes,
                                         active_params, analyze,
                                         collective_bytes_per_device,
                                         model_flops,
                                         ssd_inner_scan_correction)
from repro_torch.models import build_model, ssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import build_optimizer, optimizers
from repro_torch.sweep.grid import RunSpec, SweepScale
from repro_torch.sweep.runner import LocalRunner

HLO = """
ENTRY %main {
  %ar = bf16[16,1024]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[4,256]{1,0} all-gather(%y), replica_groups=[2,8]<=[16], dimensions={0}
  %rs = f32[2,256]{1,0} reduce-scatter(%z), replica_groups={{0,1}}, to_apply=%add
  %cp = bf16[8]{0} collective-permute(%w), source_target_pairs={{0,1}}
  %dot = f32[128,128]{1,0} dot(%a, %b)
}
"""

# The reference's ``model_flops(cfg, SHAPES[s], total)`` for every cell
# (fl_round over the [32, ...] stack), and its param counts: (params,
# active, train_4k, prefill_32k, decode_32k, long_500k or None, fl_round).
TABLE = {
    "qwen3-1.7b": (1_720_574_976, 1_720_574_976, 1.156e16, 5.579e15,
                   1.403e12, None, 1.101e11),
    "granite-8b": (8_254_689_280, 8_254_689_280, 5.383e16, 2.238e16,
                   4.587e12, None, 5.283e11),
    "yi-6b": (6_061_035_520, 6_061_035_520, 3.982e16, 1.721e16, 3.751e12,
              None, 3.879e11),
    "qwen3-4b": (4_022_468_096, 4_022_468_096, 2.721e16, 1.350e16,
                 3.504e12, None, 2.574e11),
    "llama-3.2-vision-11b": (9_775_157_256, 9_775_157_256, 6.319e16,
                             2.500e16, 4.701e12, None, 6.256e11),
    "zamba2-2.7b": (2_435_782_560, 2_435_782_560, 1.711e16, 9.858e15,
                    2.943e12, 2.948e11, 1.559e11),
    "deepseek-v2-lite-16b": (15_706_484_224, 2_661_150_208, 1.745e16,
                             7.481e15, 1.609e12, None, 1.005e12),
    "arctic-480b": (476_850_275_328, 15_584_314_368, 1.013e17, 4.130e16,
                    8.199e12, None, 3.052e13),
    "mamba2-370m": (368_338_432, 368_338_432, 2.317e15, 7.725e14, 9.429e10,
                    7.367e8, 2.357e10),
    "seamless-m4t-large-v2": (2_034_784_256, 2_034_784_256, 1.344e16,
                              5.956e15, 1.346e12, None, 1.302e11),
}
SHAPE_COLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k",
              "fl_round")


def _smoke_overrides(arch, **extra):
    smoke = get_config(arch, smoke=True)
    out = {f.name: getattr(smoke, f.name)
           for f in dataclasses.fields(smoke) if f.name != "name"}
    out.update(extra)
    return out


# -- roofline twins ----------------------------------------------------------------


def test_shape_bytes():
    assert _shape_bytes("bf16[16,1024]") == 16 * 1024 * 2
    assert _shape_bytes("f32[4,256]") == 4 * 256 * 4
    assert _shape_bytes("(f32[8], bf16[4])") == 8 * 4 + 4 * 2


def test_collective_parse_kinds_and_factors():
    out = collective_bytes_per_device(HLO, n_devices=16)
    assert out == jroof.collective_bytes_per_device(HLO, n_devices=16)
    assert out["all-reduce"] == pytest.approx(16 * 1024 * 2 * 2 * 3 / 4)
    assert out["all-gather"] == pytest.approx(4 * 256 * 4 * 7 / 8)
    assert out["reduce-scatter"] == pytest.approx(2 * 256 * 4 * 1 / 2)
    assert out["collective-permute"] == pytest.approx(8 * 2)
    assert out["total"] == pytest.approx(
        out["all-reduce"] + out["all-gather"] + out["reduce-scatter"]
        + out["all-to-all"] + out["collective-permute"])


def test_dot_ops_not_counted():
    out = collective_bytes_per_device("  %d = f32[8,8] dot(%a, %b)\n", 4)
    assert out["total"] == 0.0


def test_bottleneck_selection_at_the_h100s_constants():
    r = Roofline("a", "s", "m", 256, flops_per_device=PEAK_FLOPS_BF16,  # 1 s
                 bytes_per_device=HBM_BW * 0.5,                       # 0.5 s
                 coll_bytes_per_device=ICI_BW * 2,                    # 2 s
                 coll_breakdown={}, peak_memory_per_device=0,
                 model_flops_global=PEAK_FLOPS_BF16 * 256)
    assert r.bottleneck == "collective"
    assert r.step_time_s == pytest.approx(2.0)
    assert r.useful_ratio == pytest.approx(1.0)
    assert r.mfu == pytest.approx(0.5)
    ref = jroof.Roofline("a", "s", "m", 256, 1.0, 1.0, 1.0, {}, 0, 1.0)
    assert r.to_dict().keys() == ref.to_dict().keys()
    # a count the port cannot reckon per device: every term None
    none = Roofline("a", "s", "16x16", 256, None, None, None, None, None,
                    1e15)
    d = none.to_dict()
    assert d["compute_s"] is None and d["bottleneck"] is None
    assert d["step_time_s"] is None and d["mfu"] is None
    assert d["useful_ratio"] is None


def test_moe_active_params_smaller_than_total():
    act = active_params(get_config("arctic-480b"), 477_000_000_000)
    assert act < 477_000_000_000 / 10  # 2-of-128 experts active
    assert active_params(get_config("granite-8b"), 8_000_000_000) \
        == 8_000_000_000


def test_model_flops_monotone_in_tokens():
    cfg = get_config("granite-8b")
    t4k = model_flops(cfg, SHAPES["train_4k"], 8e9)
    pre = model_flops(cfg, SHAPES["prefill_32k"], 8e9)
    dec = model_flops(cfg, SHAPES["decode_32k"], 8e9)
    assert t4k > pre > dec > 0


def test_ssd_correction_only_for_ssm_families():
    mamba, dense = get_config("mamba2-370m"), get_config("granite-8b")
    for cfg, jcfg in ((mamba, jget("mamba2-370m")),
                      (dense, jget("granite-8b"))):
        for s in SHAPES:
            kind = SHAPES[s].kind
            assert ssd_inner_scan_correction(cfg, SHAPES[s], kind) == \
                jroof.ssd_inner_scan_correction(jcfg, JSHAPES[s], kind)
    assert ssd_inner_scan_correction(mamba, SHAPES["train_4k"], "train") > 0
    assert ssd_inner_scan_correction(dense, SHAPES["train_4k"], "train") == 0
    assert ssd_inner_scan_correction(mamba, SHAPES["decode_32k"],
                                     "decode") == 0


def test_the_meta_trace_counts_every_chunk_so_no_correction_is_added():
    """The reference adds the SSD chunk scan's missing bodies because XLA
    counts a while loop's body once; the port's chunk loop is Python, so a
    meta trace runs every chunk: four chunks count four times one, and
    ``analyze`` puts the trace's count in the record as it is."""
    m = lambda *s: torch.empty(s, device="meta")
    B, H, P, N, Q = 2, 4, 8, 16, 32
    flops = {}
    for nc in (1, 4):
        with MetaTrace() as t:
            ssm.ssd_chunked(m(B, Q * nc, H, P), m(B, Q * nc, H),
                            m(B, Q * nc, N), m(B, Q * nc, N), Q)
        flops[nc] = t.flops
    assert flops[1] > 0 and flops[4] == 4 * flops[1]
    cfg = get_config("mamba2-370m")
    shape = SHAPES["prefill_32k"]
    assert ssd_inner_scan_correction(cfg, shape, "prefill") > 0
    roof = analyze(123.0, 456.0, arch="mamba2-370m", shape=shape,
                   mesh_name="1x1", n_devices=1, cfg=cfg, total_params=1,
                   kind="prefill")
    assert roof.flops_per_device == 123.0 and roof.bytes_per_device == 456.0
    assert roof.coll_bytes_per_device == 0.0
    wide = analyze(123.0, 456.0, arch="mamba2-370m", shape=shape,
                   mesh_name="16x16", n_devices=256, cfg=cfg,
                   total_params=1, kind="prefill")
    assert wide.flops_per_device is None and wide.memory_s is None


# -- the analytic counts of every cell -------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_active_and_model_flops_are_the_references(arch):
    """Per arch: the param count of the port's ``meta`` init and
    ``active_params`` equal to the table (the reference's) to the
    integer; ``model_flops`` equal to the reference's formula on the
    reference's own count for every cell (exactly) and to the table's
    four digits; ``long_500k`` skipped where the reference skips it."""
    cfg, jcfg = get_config(arch), jget(arch)
    row = TABLE[arch]
    total = sum(t.numel() for t in tree_leaves(
        build_model(cfg).init(None, device="meta")))
    jtotal = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax.eval_shape(lambda r: jbuild(jcfg).init(r)[0],
                       jax.random.PRNGKey(0))))
    assert total == jtotal == row[0]
    assert active_params(cfg, total) == jroof.active_params(jcfg, total) \
        == row[1]
    for col, want in zip(SHAPE_COLS, row[2:]):
        ok = shape_supported(cfg, SHAPES[col])[0]
        assert ok == (want is not None), col
        if not ok:
            continue
        n = total * SHAPES[col].global_batch if col == "fl_round" else total
        got = model_flops(cfg, SHAPES[col], n)
        assert got == jroof.model_flops(jcfg, JSHAPES[col], n)
        assert float(f"{got:.3e}") == want, (col, got)


# -- the meta trace ------------------------------------------------------------------


def test_a_fused_adam_step_on_meta_counts_the_kernels_28_bytes_a_param():
    """The cohort step of ``build_optimizer("adam")`` on ``meta`` rows:
    one ``fused_adam`` launch reported, p, m, v, g read and p, m, v
    written (28 B a param, and the int32 steps), nothing built; the plain
    Adam's passes count several times more. The pytree form on ``meta``
    params runs on the CPU with no ``nvcc``."""
    Kp, W = 3, 4096
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    opt = build_optimizer("adam", 1e-3)
    flat = m(Kp, W)
    state = opt.cohort_init(flat)
    with MetaTrace() as t:
        opt.cohort_step(flat, state, m(Kp, W), m(Kp, dt=torch.int32), 0)
    assert t.kernels == {"fused_adam": {"launches": 1,
                                        "bytes": 28 * Kp * W + 4 * Kp}}
    assert t.bytes == 28 * Kp * W + 4 * Kp
    plain = optimizers.adam(1e-3)
    with MetaTrace() as tp:
        plain.cohort_step(flat, plain.cohort_init(flat), m(Kp, W),
                          m(Kp, dt=torch.int32), 0)
    assert tp.bytes > 3 * t.bytes and not tp.kernels
    params = build_model(get_config("qwen3-1.7b")).init(None, device="meta")
    state = opt.init(params)
    with MetaTrace() as tu:
        upd, state = opt.update(params, state, params)
    assert tu.kernels["fused_adam"]["launches"] == 1
    assert all(u.is_meta for u in tree_leaves(upd)) and state["t"] == 1
    assert not _build._LIBS            # nothing was built


def _layer_flops(cfg, B, S):
    """One dense GQA layer's forward matmul FLOPs (2 per multiply-add)."""
    d, H, K, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd(),
                       cfg.d_ff)
    proj = 2 * B * S * d * (H + 2 * K) * hd + 2 * B * S * H * hd * d
    attn = 2 * 2 * B * H * S * S * hd          # logits and probs @ v
    return proj + attn + 3 * 2 * B * S * d * ff


def test_a_dense_smoke_train_cells_flops_are_the_hand_count():
    """Qwen3's smoke train cell (remat on, as its config): every matmul
    once forward and twice backward (both operands need a grad), and once
    more recomputed inside each layer's checkpoint, but for the layer's
    last (``w_down``): a non-reentrant checkpoint stops recomputing once
    it has every tensor the backward saved. The tied head is not in a
    checkpoint. Without remat, three times the forward."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    assert cfg.remat and cfg.tie_embeddings
    B, S = 2, 16
    shape = ShapeConfig("x", S, B, "train")
    cell = steps.build_cell("qwen3-1.7b", shape, make_card_mesh(),
                            overrides=_smoke_overrides("qwen3-1.7b"))
    t = cell.trace()
    head = 2 * B * S * cfg.d_model * cfg.vocab_size
    w_down = 2 * B * S * cfg.d_ff * cfg.d_model
    assert t.flops == cfg.n_layers * (4 * _layer_flops(cfg, B, S) - w_down) \
        + 3 * head
    assert t.kernels["fused_adam"]["launches"] == 1
    nr = steps.build_cell("qwen3-1.7b", shape, make_card_mesh(),
                          overrides=_smoke_overrides("qwen3-1.7b",
                                                     remat=False)).trace()
    assert nr.flops == 3 * cfg.n_layers * _layer_flops(cfg, B, S) + 3 * head


def test_extrapolate_equals_unroll_at_a_dense_smoke_depth():
    """Qwen3's widths cut to the smoke config's, 12 layers: the counts
    extrapolated from the 4- and 8-layer traces equal the 12-layer
    trace's (FLOPs exactly; bytes within the Adam row's padding)."""
    ov = _smoke_overrides("qwen3-1.7b", n_layers=12)
    ext = dryrun.run_cell_extrapolated("qwen3-1.7b", "train_4k",
                                       overrides=ov, verbose=False)
    unr = dryrun.run_cell("qwen3-1.7b", "train_4k", multi_pod=False,
                          overrides=ov, verbose=False)
    assert ext["status"] == unr["status"] == "ok"
    assert ext["probe_depths"] == [4, 8]
    assert ext["flops_global"] == unr["flops_global"]
    assert ext["bytes_global"] == pytest.approx(unr["bytes_global"],
                                                rel=1e-6)
    assert ext["in_specs"] == unr["in_specs"]
    assert ext["model_flops_global"] == unr["model_flops_global"]


# -- the dry run -------------------------------------------------------------------


def _ref_keys(kind):
    """The reference's record keys (``dryrun.run_cell`` and
    ``run_cell_extrapolated``)."""
    roof = set(jroof.Roofline("a", "s", "m", 1, 1.0, 1.0, 1.0, {}, 0,
                              1.0).to_dict())
    if kind == "single":
        return roof | {"status", "kind", "total_params", "variant",
                       "unroll_compile_s"}
    if kind == "extrapolated":
        return roof | {"status", "kind", "total_params", "variant",
                       "cost_mode", "unroll_compile_s"}
    return {"arch", "shape", "mesh", "status", "kind", "total_params",
            "compile_s", "peak_memory_per_device"}


def test_dryrun_main_gives_the_references_record_keys(tmp_path,
                                                      monkeypatch):
    """The CLI on the CPU: single-pod, multi-pod and extrapolated records
    hold every key of the reference's, with ``cost_mode`` "meta-trace",
    the specs, the arguments' bytes a device, the trace's global counts
    and None for every per-device term; a full-attention arch's
    ``long_500k`` is skipped as the reference skips it; the card's mesh
    raises without a card."""
    out = tmp_path / "d.jsonl"
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                        "--multi-pod", "both", "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                        "--cost-mode", "extrapolate", "--out",
                        str(out)]) == 0
    assert dryrun.main(["--arch", "yi-6b", "--shape", "long_500k", "--out",
                        str(out)]) == 0
    single, multi, ext, skipped = [json.loads(l) for l in
                                   out.read_text().splitlines()]
    assert _ref_keys("single") <= single.keys()
    assert _ref_keys("multi") <= multi.keys()
    assert _ref_keys("extrapolated") <= ext.keys()
    for rec in (single, multi, ext):
        assert rec["status"] == "ok" and rec["cost_mode"] == "meta-trace"
        assert rec["flops_per_device"] is None and rec["mfu"] is None
        assert rec["flops_global"] > 0
        assert rec["argument_bytes_per_device"] > 0
    assert (single["mesh"], multi["mesh"]) == ("16x16", "2x16x16")
    # the SSM state [layers, batch, heads, P, N]: batch over data, heads
    # over model on 16x16, batch over the pods as well on 2x16x16
    assert single["in_specs"][1]["stack"]["h"] == [None, "data", "model"]
    assert multi["in_specs"][1]["stack"]["h"] == [None, ["pod", "data"],
                                                  "model"]
    assert single["argument_bytes_per_device"] > \
        multi["argument_bytes_per_device"]
    assert skipped["status"] == "skipped"
    assert "skipped per assignment" in skipped["reason"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--mesh", "card", "--arch", "qwen3-1.7b", "--shape",
                     "decode_32k"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.execute_cell("qwen3-1.7b", "decode_32k")


def test_execute_cell_record_on_the_callers_cpu():
    """``execute_cell`` asked for the CPU (the card's mesh, ``1x1``) at a
    smoke config: the run's FLOPs equal the meta trace's, the cut is
    named, the roofline has every term, a train step launches no kernel
    here (the plain version)."""
    ov = _smoke_overrides("qwen3-1.7b")
    rec = dryrun.execute_cell("qwen3-1.7b", "train_4k", global_batch=2,
                              seq_len=16, overrides=ov, device="cpu",
                              verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["cut"] == {"global_batch": [256, 2], "seq_len": [4096, 16]}
    assert rec["card_flops"] == rec["flops_global"] == \
        rec["flops_per_device"]
    assert rec["mesh"] == "1x1" and rec["coll_bytes_per_device"] == 0.0
    assert rec["bottleneck"] in ("compute", "memory")
    assert rec["kernel_launches"]["fused_adam"] == 0
    assert rec["kernel_traffic"]["fused_adam"]["launches"] == 1
    assert rec["finite"] and rec["step_s"] > 0
    assert np.isfinite(float(rec["outputs"][2]))


# -- the two small parts -------------------------------------------------------------


def test_incremental_aggregate_is_the_references():
    """A running fp32 sum of three weighted trees (bf16 and fp32 leaves,
    a list as the LM's ``first``), against the reference's on the same
    numpy trees and weights."""
    rng = np.random.default_rng(4)
    trees = [{"w": rng.normal(size=(5, 6)).astype(np.float32),
              "first": [{"b": rng.normal(size=(7,)).astype(np.float32)}]}
             for _ in range(3)]
    weights = [0.2, 0.5, 0.3]
    acc = jacc = None
    for tree, w in zip(trees, weights):
        port = params_from_numpy(tree, "cpu")
        port["w"] = port["w"].to(torch.bfloat16)
        acc = aggregation.incremental_aggregate(acc, port, w)
        jtree = jax.tree.map(jnp.asarray, tree)
        jtree["w"] = jtree["w"].astype(jnp.bfloat16)
        jacc = jagg.incremental_aggregate(jacc, jtree, w)
    for a, b in zip(tree_leaves(acc), jax.tree.leaves(jacc)):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("plane", ["blob", "device", None])
def test_local_runner_pins_the_update_plane_as_the_references(plane):
    """``LocalRunner(update_plane=)``: every cell's ``FLConfig`` carries
    the pinned plane (None keeps the default) and equals the reference
    runner's in every shared field, and the cell's cache key is the
    reference's (the port's path adds the device)."""
    scale = SweepScale(n_clients=6, clients_per_round=3, rounds=1,
                       data_scale=0.05, local_epochs=1)
    jscale = jgrid.SweepScale(**dataclasses.asdict(scale))
    port = LocalRunner(scale, update_plane=plane, device="cpu",
                       cache_dir="cache")
    ref = jrunner.LocalRunner(jscale, update_plane=plane, cache_dir="cache")
    for run in (RunSpec("mnist", "apodotiko"),
                RunSpec("shakespeare", "fedavg", seed=3)):
        jrun = jgrid.RunSpec(**dataclasses.asdict(run))
        a = dataclasses.asdict(port.config(run))
        b = dataclasses.asdict(ref.config(jrun))
        shared = a.keys() & b.keys()
        assert {k: a[k] for k in shared} == {k: b[k] for k in shared}
        assert a["update_plane"] == (plane or "auto")
        key = os.path.basename(ref._cache_path(jrun))[:-len(".json")]
        assert port.cache_key(run) == key
        assert os.path.basename(port._cache_path(run)) == f"{key}-cpu.json"
    assert port.engine(RunSpec("mnist", "apodotiko")).update_plane == (
        plane or "device")
