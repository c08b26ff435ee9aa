"""``chip_smoke.py``'s output contract, checked on the CPU: every line it
prints on stdout is one JSON object, the last two are the kernel list and
the result line, and without a card (or outside a checkout) it fails and
prints no result."""
import ast
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "chip_smoke.py"


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_ms(calls, **kw):
    """chip_smoke's ``device_ms`` on the CPU: each call run once, 0 ms."""
    return {name: (fn(), 0.0)[1] for name, fn in calls.items()}


def _entry(name):
    return {"name": name, "route": "cuda", "source": "src/x.cu",
            "replaces": "src/repro/kernels/x.py:1", "launches": 3,
            "launches_run": "main path: x, 1 rounds",
            "max_abs_err": 0.0, "ms": 0.5, "plain_ms": 1.0, "bound_ms": 0.1,
            "bound_by": "bytes", "library_ms": None, "shape": {"M": 8}}


def test_report_lines_are_the_kernel_list_then_the_result_line():
    cs = _load()
    lines = cs.report_lines([_entry("a"), _entry("b")], "NVIDIA H100", 1)
    assert len(lines) == 2
    kernels, result = (json.loads(l) for l in lines)
    assert [k["name"] for k in kernels["kernels"]] == ["a", "b"]
    assert set(kernels["kernels"][0]) == set(cs.KERNEL_KEYS)
    assert result == {"ok": True, "device": {"platform": "gpu",
                                             "kind": "NVIDIA H100",
                                             "count": 1}}


def test_report_lines_keep_device_and_composed_times():
    """An entry's ``device_ms``, ``composed_ms`` and ``fp32_fma_bound_ms``
    reach the kernel list where it has them; no other extra key does."""
    cs = _load()
    e = dict(_entry("scored_topk"), device_ms=0.01, composed_ms=0.4,
             fp32_fma_bound_ms=1.0, bytes=18, shape={"M": 1})
    kernels = json.loads(cs.report_lines([e, _entry("b")], "x", 1)[0])
    first, second = kernels["kernels"]
    assert set(first) == set(cs.KERNEL_KEYS) | {"device_ms", "composed_ms",
                                                "fp32_fma_bound_ms"}
    assert (first["device_ms"], first["composed_ms"]) == (0.01, 0.4)
    assert first["fp32_fma_bound_ms"] == 1.0
    assert set(second) == set(cs.KERNEL_KEYS)


def test_topk_entry_bound_is_the_functions_bytes(monkeypatch):
    """The top-k bound is the function's (read the scores once, write the
    top k; about one comparison per score), not a k-round extraction's
    k*M comparisons; the selection is one launch (no reduce passes), and
    the launch count is the one passed in with the run that counted it.
    CPU rehearsal: the timers and syncs are stubbed."""
    cs = _load()
    monkeypatch.setattr(cs, "time_ms", lambda fn: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "device_ms", _device_ms)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    m, k = 1 << 14, 100
    e = cs.topk_kernel_entry("block_topk[x]", m, k, 20, "fleet phase: x",
                             torch.device("cpu"))
    assert e["exact"] and e["max_abs_err"] == 0.0
    assert (e["launches"], e["launches_run"]) == (20, "fleet phase: x")
    assert e["shape"]["passes"] == 0
    assert e["device_ms"] == 0.0 and e["library_ms"] == 0.0
    assert e["bytes"] == 4 * m + 12 * k
    assert e["bound_by"] == "bytes"
    assert e["bound_ms"] == (4 * m + 12 * k) / cs.HBM_BYTES_PER_S * 1e3


def test_scored_topk_entry_is_exact_with_the_steps_bytes(monkeypatch):
    """CPU rehearsal of ``scored_topk[fleet]``: the fused step on a fleet
    store's device state, held to the plain composition to the bit (idx,
    valid, booster), the bound at 18 B a slot (num, den, booster, eligible,
    ever read, the new booster written) plus the k picks and flags, no
    library call and a composed time beside it."""
    from repro_torch.core.fleet_store import FleetStore

    cs = _load()
    monkeypatch.setattr(cs, "time_ms", lambda fn: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "device_ms", _device_ms)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    rng = np.random.default_rng(0)
    fs = FleetStore(capacity=4096, device="cpu")
    fs.add_batch(list(range(3000)), rng.integers(20, 200, 3000), 10, 5)
    fs.bulk_history(rng.gamma(2.0, 5.0, size=(2000, 4)))
    for cid in range(0, 3000, 7):
        fs.mark_running(cid, 0)
    fs._flush_device()
    e = cs.scored_topk_entry("scored_topk[fleet]", fs._dev, cs.FLEET_K,
                             cs.FLEET_BETA, 5, "fleet phase: x")
    m = fs.capacity
    assert set(cs.KERNEL_KEYS) <= set(e)
    assert e["name"] == "scored_topk[fleet]" and e["exact"]
    assert e["max_abs_err"] == 0.0
    assert (e["launches"], e["launches_run"]) == (5, "fleet phase: x")
    assert e["shape"]["M"] == m and e["shape"]["valid"] == cs.FLEET_K
    assert e["bytes"] == 18 * m + cs.FLEET_K * 9
    assert e["bound_by"] == "bytes"
    assert e["bound_ms"] == e["bytes"] / cs.HBM_BYTES_PER_S * 1e3
    assert e["library_ms"] is None and e["composed_ms"] == 0.0
    assert e["device_ms"] == 0.0


def _small_store(capacity=256, n=200, seed=0):
    from repro_torch.core.fleet_store import FleetStore

    rng = np.random.default_rng(seed)
    fs = FleetStore(capacity=capacity, device="cpu")
    fs.add_batch(list(range(n)), rng.integers(20, 200, n), 10, 5)
    fs.bulk_history(rng.gamma(2.0, 5.0, size=(n // 2, 4)))
    return fs


def test_scored_topk_main_path_entry_takes_the_runs_state(monkeypatch):
    """The ``scored_topk`` entry is the main path's own call: the
    ``apodotiko-topk`` engine's store state with its dirty slots flushed,
    at the run's k (clients per round) and beta (1 + adjustment rate),
    held to the plain composition to the bit. CPU rehearsal on a store of
    the main path's size, with an engine that carries only what is read."""
    from types import SimpleNamespace

    cs = _load()
    monkeypatch.setattr(cs, "time_ms", lambda fn: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "device_ms", _device_ms)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    fs = _small_store()
    fs._flush_device()
    for cid in range(0, 200, 3):
        fs.mark_running(cid, 0)
    engine = SimpleNamespace(
        db=SimpleNamespace(fleet=fs),
        cfg=SimpleNamespace(clients_per_round=100, adjustment_rate=0.2))
    state, k, beta = cs.main_path_selection(engine)
    assert not fs._dev_dirty and state is fs._dev
    assert (k, beta) == (100, 1.2)
    e = cs.scored_topk_entry("scored_topk", state, k, beta, 3,
                             "main path: apodotiko-topk, 3 rounds")
    assert set(cs.KERNEL_KEYS) <= set(e)
    assert e["name"] == "scored_topk" and e["exact"]
    assert e["shape"]["M"] == 256 and e["shape"]["k"] == 100
    assert e["shape"]["eligible"] == 200 - len(range(0, 200, 3))
    assert e["bytes"] == 18 * 256 + 100 * 9
    assert e["launches"] == 3


def test_flush_split_times_the_parts_of_one_flush(monkeypatch):
    """``flush_split`` repeats the flush of the same dirty slots, whole
    and in its three parts (host packing, copies, index writes), and
    leaves the device state as one flush does. CPU rehearsal."""
    cs = _load()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    fs, once = _small_store(), _small_store()
    for f in (fs, once):
        f._flush_device()
        for cid in range(0, 200, 4):
            f.mark_running(cid, 0)
            f.mark_complete(cid, 1.0 + cid % 9)
    r = cs.flush_split(fs, reps=3)
    once._flush_device()
    assert r["slots"] == 50 and r["reps"] == 3
    assert {"total_ms", "host_ms", "h2d_ms", "write_ms",
            "first_total_ms"} <= set(r)
    assert all(r[f"{p}_ms"] >= 0.0 for p in ("total", "host", "h2d", "write"))
    assert not fs._dev_dirty
    for col in ("num", "den", "booster", "eligible", "ever"):
        assert torch.equal(getattr(fs._dev, col), getattr(once._dev, col))


@pytest.mark.parametrize("rows_form", [False, True])
def test_agg_entry_reports_flushed_and_device_times(monkeypatch, rows_form):
    """CPU rehearsal of the two ``staleness_agg`` entries at a small store:
    held to the plain version, the kernel's column split on the card
    (``plan`` at the card's SM count), the warm event time beside the
    flushed one (the flush runs before each call, outside the events),
    the kernel's device time both ways (one profiler session each, the
    second with the flush before every call), the bound over the flushed
    device time, and the new keys kept in the kernel list."""
    import types
    cs = _load()
    flushed, sessions = [], []

    def time_ms(fn, before=None, **kw):
        if before is not None:
            before()
        fn()
        return 0.5

    def device_ms(calls, **kw):
        assert list(calls) == ["staleness_agg"]
        n = len(flushed)
        calls["staleness_agg"]()
        sessions.append(len(flushed) - n)        # flushes in this session
        return {"staleness_agg": 0.2 if len(sessions) == 1 else 0.25}

    monkeypatch.setattr(cs, "time_ms", time_ms)
    monkeypatch.setattr(cs, "device_ms", device_ms)
    monkeypatch.setattr(cs, "l2_flush",
                        lambda dev: lambda: flushed.append(dev))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    C, W, k = 24, 4096, 5
    record = {"strategy": "apodotiko", "row_width": W,
              "rounds": [{"store_capacity": C, "n_aggregated": k}],
              "launches": {"staleness_agg": 3}}
    e = cs.agg_kernel_entry("staleness_agg[x]", record, torch.device("cpu"),
                            rows_form=rows_form)
    assert set(cs.KERNEL_KEYS) <= set(e) and e["max_abs_err"] < 1e-6
    assert e["launches"] == 3 and e["launches_run"] == \
        "main path: apodotiko, 1 rounds"
    assert e["shape"]["K_padded"] == 8 and e["shape"]["ctas"] == 128
    assert e["shape"]["pieces_per_cta"] == 1
    assert e["shape"]["piece_bytes_max"] == 128      # one 128-byte unit
    assert e["bytes"] == ((k * W + W) * 4 + 8 * 12 if rows_form
                          else (C * W + C + W) * 4)
    assert (e["ms"], e["flushed_ms"]) == (0.5, 0.5)
    assert (e["device_ms"], e["flushed_device_ms"]) == (0.2, 0.25)
    assert sessions == [0, 1] and len(flushed) == 2   # + flushed_ms's one
    assert e["bound_share"] == e["bound_ms"] / 0.25
    line = json.loads(cs.report_lines([e], "x", 1)[0])["kernels"][0]
    assert set(line) == set(cs.KERNEL_KEYS) | {
        "device_ms", "flushed_ms", "flushed_device_ms", "bound_share"}


def test_every_kernel_wrapper_counts_its_launches():
    cs = _load()
    wrappers = cs.kernel_wrappers()
    assert set(wrappers) == {"staleness_agg", "fused_adam", "block_topk",
                             "quantize_q8", "dequantize_q8", "compress_q8",
                             "flash_attention"}
    assert all(isinstance(fn.launches, int) for fn in wrappers.values())


def test_quant8_entries_are_exact_with_byte_bounds(monkeypatch):
    """CPU rehearsal of the quant8 entries: the update padded as
    ``compress_update`` pads it, plain against plain (exact), no library
    call and the reason why, the bound in bytes (fp32 in, int8 codes and
    fp32 scales out), and the compress phase's launch counts (no
    ``quantize_q8`` there since ``compress_update`` runs the fused
    kernel, and the entry says so)."""
    cs = _load()
    monkeypatch.setattr(cs, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "device_ms", _device_ms)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    gen = torch.Generator().manual_seed(0)
    update = {"w": torch.randn(300, 70, generator=gen),
              "b": torch.randn(13, generator=gen)}
    q_e, dq_e = cs.quant8_kernel_entries(
        update, {"quantize_q8": 0, "dequantize_q8": 1}, "compress phase: x")
    n = 22_528                            # 21,013 params padded to 11 x 2048
    assert (q_e["launches"], dq_e["launches"]) == (0, 1)
    assert "compress_q8" in q_e["launches_note"]
    assert "launches_note" not in dq_e
    for e in (q_e, dq_e):
        assert set(cs.KERNEL_KEYS) <= set(e)
        assert e["shape"] == {"N": n, "blocks": n // 256}
        assert e["max_abs_err"] == 0.0 and e["exact"]
        assert e["bytes"] == 4 * n + n + 4 * (n // 256)
        assert e["bound_by"] == "bytes"
        assert e["bound_ms"] == e["bytes"] / cs.HBM_BYTES_PER_S * 1e3
    assert q_e["library_ms"] is None and "no single PyTorch call" in \
        q_e["library_note"]
    assert dq_e["library_ms"] == 0.0 and "torch.mul" in dq_e["library"]
    assert q_e["replaces"] == "src/repro/kernels/quant8.py:58"
    assert dq_e["replaces"] == "src/repro/kernels/quant8.py:89"


def _small_update():
    gen = torch.Generator().manual_seed(0)
    return {"w": torch.randn(300, 70, generator=gen) * 0.01,
            "b": torch.randn(13, generator=gen)}


def test_compress_entry_is_exact_with_the_fused_calls_bytes(monkeypatch):
    """CPU rehearsal of the ``compress_q8`` entry: the raveled update with
    its first round's error feedback, held to the plain version and to the
    stepwise path it replaces (exact), the bound at the fused call's bytes
    (flat, error feedback and error at 4 B a value, 1 B a padded code, 4 B
    a scale), no library call and why, and the stepwise path's event and
    device times beside the kernel's."""
    cs = _load()
    monkeypatch.setattr(cs, "time_ms", lambda fn, **kw: (fn(), 0.5)[1])
    monkeypatch.setattr(cs, "device_ms", _device_ms)
    monkeypatch.setattr(cs, "device_total_ms",
                        lambda fn, **kw: (fn(), 0.25)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    e = cs.compress_kernel_entry(_small_update(), 3, "compress phase: x")
    n, n_pad = 21_013, 22_528
    assert set(cs.KERNEL_KEYS) <= set(e)
    assert (e["name"], e["route"], e["launches"]) == ("compress_q8", "cuda",
                                                      3)
    assert e["replaces"] == "src/repro/kernels/quant8.py:58"
    assert "quant8.py:89" in e["replaces_also"]
    assert e["exact"] and e["max_abs_err"] == 0.0
    assert e["shape"] == {"N": n, "N_padded": n_pad, "blocks": n_pad // 256,
                          "error_feedback": True}
    assert e["bytes"] == 12 * n + n_pad + 4 * (n_pad // 256)
    assert e["bound_by"] == "bytes"
    assert e["bound_ms"] == e["bytes"] / cs.HBM_BYTES_PER_S * 1e3
    assert e["library_ms"] is None and "no single PyTorch call" in \
        e["library_note"]
    assert (e["ms"], e["plain_ms"], e["composed_ms"]) == (0.5, 0.5, 0.5)
    assert (e["device_ms"], e["composed_device_ms"]) == (0.0, 0.25)
    line = json.loads(cs.report_lines([e], "x", 1)[0])["kernels"][0]
    assert line["composed_device_ms"] == 0.25 and line["composed_ms"] == 0.5


def test_compress_phase_wants_one_fused_launch_a_compress(monkeypatch):
    """CPU rehearsal of the compress phase with wrappers that count one
    launch a call for the card run, as the card's do (the CPU copy counts
    nothing): three ``compress_q8``, one ``dequantize_q8`` and no
    ``quantize_q8`` pass, every round equal to the plain version; a
    compress that still went through the two kernels fails."""
    cs = _load()
    from repro_torch.kernels import ops, quant8
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    card = [True]
    read = cs.read_counts

    def read_counts():
        card[0] = False                 # counts are read after the card run
        return read()

    def counted(name, fn):
        def wrapper(*a, **k):
            getattr(quant8, name).launches += card[0]
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(cs, "read_counts", read_counts)
    monkeypatch.setattr(ops, "compress_q8",
                        counted("compress_q8", quant8.compress_q8))
    monkeypatch.setattr(ops, "dequantize_q8",
                        counted("dequantize_q8", quant8.dequantize_q8))
    r = cs.compress_phase(_small_update(), "x")
    assert r["launches"] == cs.COMPRESS_LAUNCHES == {
        "compress_q8": 3, "quantize_q8": 0, "dequantize_q8": 1}
    assert r["equal_to_plain_on_card"] and r["codes"] == 22_528

    def stepwise(flat, ef, n_pad):      # the two-kernel path, counted
        quant8.quantize_q8.launches += card[0]
        quant8.dequantize_q8.launches += card[0]
        return quant8.compress_q8(flat, ef, n_pad)

    card[0] = True
    monkeypatch.setattr(ops, "compress_q8", stepwise)
    with pytest.raises(AssertionError, match="compress launches"):
        cs.compress_phase(_small_update(), "x")


def test_topk_sort_route_phase_on_the_cpu(monkeypatch):
    """CPU rehearsal of the sort-route phase on a small fleet store, with
    the entry points sent to the sort route as a card tensor is for
    k > 1024: bit-equal to the plain versions, one sort a call, no kernel
    launch; the kernel route instead fails the phase."""
    cs = _load()
    from repro_torch.kernels import ops, topk
    monkeypatch.setattr(cs, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "FLEET_CAPACITY", 8192)
    fs = _small_store(capacity=8192, n=6000)
    fs._flush_device()
    monkeypatch.setattr(ops, "masked_topk", topk.sorted_topk)
    monkeypatch.setattr(ops, "scored_topk", topk.sorted_scored_topk)
    r = cs.topk_sort_route_phase(fs._dev, torch.device("cpu"))
    assert (r["sorts"], r["kernel_launches"]) == (2, 0) and r["exact"]
    assert (r["masked_k"], r["scored_k"]) == (4096, 1025)
    assert r["scored_valid"] == 1025
    assert (r["masked_bytes"], r["scored_bytes"]) == (4 * 8192 + 12 * 4096,
                                                      18 * 8192 + 9 * 1025)
    assert r["masked_bound_ms"] == r["masked_bytes"] / cs.HBM_BYTES_PER_S \
        * 1e3
    assert (r["masked_library_ms"], r["scored_library_ms"]) == (0.0, 0.0)
    monkeypatch.setattr(ops, "masked_topk", topk.masked_topk)
    with pytest.raises(AssertionError, match="one sort a call"):
        cs.topk_sort_route_phase(fs._dev, torch.device("cpu"))


def test_attention_bound_counts_causal_flops_at_the_bf16_rate():
    """4*B*H*D*S(S+1)/2 flops: 6.87e10 at [1,16,4096,128] (0.069 ms at 989
    TFLOP/s) and 4.40e12 at 32,768 tokens (4.45 ms); the bytes are far
    below."""
    cs = _load()
    flops, nbytes = cs.attention_work(1, 16, 4096, 128, 2)
    assert flops == 68_736_253_952 and nbytes == 4 * 16 * 4096 * 128 * 2
    ms, by = cs.bound(nbytes, flops, cs.BF16_FLOP_PER_S)
    assert by == "operations" and abs(ms - 0.0695) < 1e-3
    flops, nbytes = cs.attention_work(1, 16, 32768, 128, 2)
    assert abs(flops - 4.40e12) < 0.01e12
    ms, by = cs.bound(nbytes, flops, cs.BF16_FLOP_PER_S)
    assert by == "operations" and abs(ms - 4.45) < 0.01


def test_attention_entry_and_tail_rows_on_the_cpu(monkeypatch):
    """CPU rehearsal: ``plain_rows`` over any row range are those rows of
    the plain causal run; an entry carries the phase's check, and past the
    whole plain version's size its plain time is of ``plain_rows`` chunk
    by chunk, with the reason."""
    cs = _load()
    from repro_torch.kernels import ref
    monkeypatch.setattr(cs, "time_ms", lambda fn, **kw: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "device_ms", _device_ms)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    q, k, v = cs.attention_inputs(torch.device("cpu"), 256, heads=2, dim=64)
    whole = ref.flash_attention(q, k, v)
    for start, rows in ((192, 64), (0, 64), (64, 128)):
        torch.testing.assert_close(cs.plain_rows(q, k, v, start, rows),
                                   whole[:, :, start:start + rows],
                                   rtol=1e-5, atol=1e-6)
    qkv = tuple(t.to(torch.bfloat16) for t in (q, k, v))
    checked = cs.attention_check("x", ref.flash_attention(*qkv),
                                 ref.flash_attention(*qkv))
    assert checked["max_abs_err"] == 0.0 and checked["tol_ratio"] == 0.0
    full = cs.attention_kernel_entry("flash_attention", qkv, 1, "x", checked)
    assert full["max_abs_err"] == 0.0 and full["plain_ms"] == 0.0
    assert full["library_max_abs_diff"] < 3e-2 and "plain_note" not in full
    assert (full["route"], full["design"]) == ("cuda", "cuda-wgmma-tma")
    assert full["launches"] == 1
    monkeypatch.setattr(cs, "ATTN_SHORT", 128)
    monkeypatch.setattr(cs, "ATTN_CHUNK", 64)
    long = cs.attention_kernel_entry("flash_attention[prefill_32k]", qkv, 1,
                                     "x", dict(checked, max_abs_err=1e-3),
                                     reps=5)
    assert long["max_abs_err"] == 1e-3 and long["plain_ms"] == 0.0
    assert "plain_rows" in long["plain_note"]
    assert set(cs.KERNEL_KEYS) <= set(long)


def test_attention_fp32_entry_has_its_own_bound_and_rate(monkeypatch):
    """The fp32 route's entry: the design of three TF32 tensor-core
    products, the bound at three times the causal flops over the 495
    TFLOP/s TF32 rate (and, beside it, the flops at the 67 TFLOP/s fp32
    rate, the bound before this design), and the achieved TFLOP/s as the
    causal flops over the measured time (CPU rehearsal: every time stubbed
    to 2 ms)."""
    cs = _load()
    from repro_torch.kernels import ref
    monkeypatch.setattr(cs, "time_ms", lambda fn, **kw: (fn(), 2.0)[1])
    monkeypatch.setattr(cs, "device_ms",
                        lambda calls, **kw: {n: (f(), 2.0)[1]
                                             for n, f in calls.items()})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    qkv = cs.attention_inputs(torch.device("cpu"), 256, heads=2, dim=64)
    checked = cs.attention_check("x", ref.flash_attention(*qkv),
                                 ref.flash_attention(*qkv))
    e = cs.attention_kernel_entry("flash_attention[fp32]", qkv, 1,
                                  "attention phase: x", checked)
    assert (e["route"], e["design"]) == ("cuda", "cuda-mma-3xtf32")
    assert set(cs.KERNEL_KEYS) <= set(e)
    flops, nbytes = cs.attention_work(1, 2, 256, 64, 4)
    assert (e["flops"], e["bytes"]) == (flops, nbytes)
    assert e["bound_ms"] == max(3 * flops / cs.TF32_FLOP_PER_S,
                                nbytes / cs.HBM_BYTES_PER_S) * 1e3
    assert e["fp32_fma_bound_ms"] == max(flops / cs.FP32_FLOP_PER_S,
                                         nbytes / cs.HBM_BYTES_PER_S) * 1e3
    assert e["bound_ms"] < e["fp32_fma_bound_ms"]
    assert e["tflops"] == e["device_tflops"] == flops / 2.0 / 1e9
    assert e["shape"]["dtype"] == "torch.float32"


def test_attention_fp16_entry_takes_the_16_bit_kernel(monkeypatch):
    """The fp16 entry: the wgmma/TMA design, the bound at the 16-bit
    tensor rate, SDPA on the fp16 inputs as the library call, and no fp32
    FMA bound (CPU rehearsal, times stubbed)."""
    cs = _load()
    from repro_torch.kernels import ref
    monkeypatch.setattr(cs, "time_ms", lambda fn, **kw: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "device_ms", _device_ms)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    qkv = tuple(t.to(torch.float16) for t in cs.attention_inputs(
        torch.device("cpu"), 256, heads=2, dim=64))
    checked = cs.attention_check("x", ref.flash_attention(*qkv),
                                 ref.flash_attention(*qkv))
    assert checked["tol"] == 1e-2
    e = cs.attention_kernel_entry("flash_attention[fp16]", qkv, 1,
                                  "attention phase: x", checked)
    assert (e["route"], e["design"]) == ("cuda", "cuda-wgmma-tma")
    assert set(cs.KERNEL_KEYS) <= set(e) and "fp32_fma_bound_ms" not in e
    flops, nbytes = cs.attention_work(1, 2, 256, 64, 2)
    assert e["bound_ms"] == max(flops / cs.BF16_FLOP_PER_S,
                                nbytes / cs.HBM_BYTES_PER_S) * 1e3
    assert e["shape"]["dtype"] == "torch.float16"
    assert e["library_ms"] == 1.0 and e["library_max_abs_diff"] < 1e-2


def test_attention_phase_checks_every_route_and_the_padded_dim(monkeypatch):
    """CPU rehearsal of the attention phase at a small size, with a
    wrapper that counts one launch a call as the card's does: bf16, fp32
    and fp16 at the short length, bf16 and fp32 at the padded head dim,
    bf16 at the long length, each checked and counted once; the short
    runs' inputs come back for the kernel entries."""
    cs = _load()
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa
    plain = ops.flash_attention

    def counted(*args, **kw):
        fa.flash_attention.launches += 1
        return plain(*args, **kw)

    inputs = cs.attention_inputs
    monkeypatch.setattr(ops, "flash_attention", counted)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "attention_inputs",
                        lambda dev, seq, dim=64: inputs(dev, seq, heads=2,
                                                        dim=min(dim, 64)))
    for name, value in (("ATTN_SHORT", 256), ("ATTN_LONG", 512),
                        ("ATTN_CHUNK", 128), ("ATTN_PAD_SEQ", 128),
                        ("ATTN_PAD_DIM", 48)):
        monkeypatch.setattr(cs, name, value)
    record, qkv = cs.attention_phase(torch.device("cpu"))
    assert (record["launches_short"], record["launches_long"]) == (5, 1)
    for n in ("bf16", "fp32", "fp16"):
        assert record[f"launches_short_{n}"] == 1
        assert record[f"short_{n}"]["tol_ratio"] == 0.0
        assert qkv[f"short_{n}"][0].shape == (1, 2, 256, 64)
    assert qkv["short_fp16"][0].dtype == torch.float16
    assert record["shape_padded"] == [1, 2, 128, 48]
    assert {n: c["launches"] for n, c in record["padded"].items()} == \
        {"bf16": 1, "fp32": 1}
    assert record["tol"] == {"bf16": 1e-2, "fp16": 1e-2, "fp32": 2e-4}
    assert record["long_prefix_rows_equal"]
    assert record["long_rows"]["rows"] == 512


def _planted(kind, q, k, v, want):
    """``want`` (the plain causal output) with one kind of fault planted."""
    from repro_torch.kernels import ref
    S = q.shape[2]
    if kind == "one_bf16_ulp_everywhere":     # a right answer, 1 ulp off
        return (want.view(torch.int16) + 1).view(torch.bfloat16)
    if kind == "late_rows_halved":
        out = want.clone()
        out[:, :, S // 2:] /= 2
        return out
    if kind == "one_late_row_block_scaled_0.9":
        out = want.clone()
        out[:, :, S - 256:S - 128] *= 0.9
        return out
    if kind == "diagonal_kv_tile_dropped":   # loop bound one tile short
        s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()
                         ) * q.shape[-1] ** -0.5
        pos = torch.arange(S)[:, None]
        s = torch.where(torch.arange(S)[None] < pos // 64 * 64, s,
                        ref.NEG_INF)
        out = torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, -1),
                           v.float()).to(q.dtype)
        out[:, :, :64] = 0
        return out
    raise ValueError(kind)


@pytest.mark.parametrize("kind, passes", [
    ("one_bf16_ulp_everywhere", True),
    ("late_rows_halved", False),
    ("one_late_row_block_scaled_0.9", False),
    ("diagonal_kv_tile_dropped", False),
])
def test_attention_check_catches_planted_faults(kind, passes):
    """The attention check, limit scaled by each 128-row block's rms: a
    bf16 output one ulp off everywhere passes, a halved half, one row block
    10 % low or a causal loop one kv tile short fails."""
    cs = _load()
    from repro_torch.kernels import ref
    q, k, v = (t.to(torch.bfloat16) for t in
               cs.attention_inputs(torch.device("cpu"), 1024, heads=2,
                                   dim=64))
    want = ref.flash_attention(q, k, v)
    got = _planted(kind, q, k, v, want)
    if passes:
        assert cs.attention_check(kind, got, want)["tol_ratio"] <= 1.0
    else:
        with pytest.raises(AssertionError, match="x the tolerance"):
            cs.attention_check(kind, got, want)


@pytest.mark.parametrize("kind, passes", [
    ("plain", True),
    ("one_late_row_block_scaled_0.9", False),
    ("diagonal_kv_tile_dropped", False),
])
def test_long_rows_check_covers_every_row(monkeypatch, kind, passes):
    """The long run's check holds every row, chunk by chunk, against
    ``plain_rows``; a fault in any chunk fails it."""
    cs = _load()
    from repro_torch.kernels import ref
    monkeypatch.setattr(cs, "ATTN_CHUNK", 256)
    q, k, v = (t.to(torch.bfloat16) for t in
               cs.attention_inputs(torch.device("cpu"), 1024, heads=2,
                                   dim=64))
    want = ref.flash_attention(q, k, v)
    got = want if kind == "plain" else _planted(kind, q, k, v, want)
    if passes:
        c = cs.long_rows_check(got, q, k, v)
        assert c["rows"] == 1024 and c["tol_ratio"] <= 1.0
    else:
        with pytest.raises(AssertionError, match="x the tolerance"):
            cs.long_rows_check(got, q, k, v)


def test_every_stdout_print_is_json():
    """A bare text line (such as the raw ``nvidia-smi`` output) would break
    the one-JSON-object-per-line contract; the card's name and power limit
    travel inside the ``card`` phase line instead."""
    tree = ast.parse(SCRIPT.read_text())
    bad = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and getattr(node.func, "id", "")
                == "print"):
            continue
        if any(k.arg == "file" for k in node.keywords):
            continue                              # stderr diagnostics
        arg = node.args[0]
        is_dumps = (isinstance(arg, ast.Call)
                    and ast.unparse(arg.func) == "json.dumps")
        if not (is_dumps or ast.unparse(arg) == "line"):
            bad.append(ast.unparse(node))
    assert not bad
    assert "for line in report_lines(" in SCRIPT.read_text()


def test_fails_without_a_card_and_prints_no_result(monkeypatch, capsys):
    cs = _load()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main() != 0
    assert capsys.readouterr().out == ""


def test_fails_alone_outside_a_checkout(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
