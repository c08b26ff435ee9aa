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

from test_torch_client_store import one_torch_thread  # noqa: F401

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


def test_paper_kernel_entries_take_each_runs_own_shapes(monkeypatch):
    """CPU rehearsal of the paper_models runs' entries: ``fused_adam`` at
    each Adam run's [Kp, W] (none for Shakespeare's SGD) and
    ``staleness_agg`` in rows form at every run's width and last K, each
    held to its plain version, with that run's launches."""
    import types
    cs = _load()
    monkeypatch.setattr(cs, "time_ms", lambda fn, **kw: (fn(), 0.5)[1])
    monkeypatch.setattr(cs, "device_ms", _device_ms)
    monkeypatch.setattr(cs, "l2_flush", lambda dev: lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    shapes = {"femnist": (1, 5, 2304, [3]), "speech": (1, 7, 640, [3]),
              "shakespeare": (2, 6, 896, [3, 3])}
    records = {
        name: {"model": f"paper-{name}", "strategy": "apodotiko",
               "row_width": W, "cohort_sizes": sizes,
               "rounds": [{"store_capacity": 16, "n_aggregated": k}] * rounds,
               "launches": {"staleness_agg": rounds,
                            "fused_adam": 0 if name == "shakespeare" else 40}}
        for name, (rounds, k, W, sizes) in shapes.items()}
    entries = cs.paper_kernel_entries(records, torch.device("cpu"))
    assert [e["name"] for e in entries] == [
        "fused_adam[femnist]", "staleness_agg[femnist]", "fused_adam[speech]",
        "staleness_agg[speech]", "staleness_agg[shakespeare]"]
    by_name = {e["name"]: e for e in entries}
    for name, (rounds, k, W, sizes) in shapes.items():
        agg = by_name[f"staleness_agg[{name}]"]
        assert agg["shape"]["rows_form"] and agg["max_abs_err"] < 1e-6
        assert (agg["shape"]["W"], agg["shape"]["K"]) == (W, k)
        assert agg["launches"] == rounds
        assert agg["launches_run"] == \
            f"paper_models phase: paper-{name}: apodotiko, {rounds} rounds"
        if name != "shakespeare":
            adam = by_name[f"fused_adam[{name}]"]
            assert adam["shape"] == {"Kp": 4, "W": W,
                                     "active_lanes": max(sizes)}
            assert adam["launches"] == 40 and adam["max_abs_err"] < 1e-6
            assert set(cs.KERNEL_KEYS) <= set(adam)


def test_every_kernel_wrapper_counts_its_launches():
    from repro_torch.kernels import launch_counts, wrappers

    cs = _load()
    wrappers = wrappers()
    assert set(wrappers) == {"staleness_agg", "fused_adam", "block_topk",
                             "quantize_q8", "dequantize_q8", "compress_q8",
                             "flash_attention"}
    assert all(isinstance(fn.launches, int) for fn in wrappers.values())
    cs.zero_counts()
    assert cs.read_counts() == launch_counts() == dict.fromkeys(wrappers, 0)


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


def _count_plain_calls(monkeypatch):
    """On the CPU a wrapper takes its kernel's plain version and counts
    nothing: count each plain call of the megastep path's three kernels as
    the launch it stands for, so the phase's launch checks run here."""
    from repro_torch.kernels import fused_adam, ref, staleness_agg, topk
    for name, wrapper in (("staleness_agg", staleness_agg.staleness_agg),
                          ("fused_adam", fused_adam.fused_adam),
                          ("scored_topk", topk.block_topk)):
        def counted(*a, _plain=getattr(ref, name), _wrapper=wrapper, **k):
            _wrapper.launches += 1
            return _plain(*a, **k)
        monkeypatch.setattr(ref, name, counted)


def _megastep_rehearsal(cs, monkeypatch, **kw):
    """chip_smoke's megastep phase on the CPU at the reference's test size
    (ProxyCNN, 10 clients, 4 a round, 8 rounds, 3 of them bootstrap)."""
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.models.proxy_models import ProxyCNN

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _count_plain_calls(monkeypatch)
    data = make_federated_dataset("mnist", n_clients=10, scale=0.05, seed=0)
    return cs.megastep_phase(
        data, torch.device("cpu"), model=ProxyCNN(10), boot=3, n_clients=10,
        clients_per_round=4, rounds=8, local_epochs=1, batch_size=5,
        base_step_time=0.5, **kw)


def test_megastep_phase_on_the_cpu(monkeypatch, capsys):
    """The phase's output contract: the modes alternated (stepwise, fused,
    fused, stepwise), at least 3 fused rounds in each fused run, every run
    bit-equal to the first, every run's launches as wanted (one selection
    and one aggregate a round, one Adam step a local step), wall time a
    round per run, deterministic algorithms restored."""
    cs = _load()
    was = torch.are_deterministic_algorithms_enabled()
    rec = _megastep_rehearsal(cs, monkeypatch)
    assert torch.are_deterministic_algorithms_enabled() == was
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"phase": "megastep", **json.loads(json.dumps(rec))}
    assert rec["order"] == ["stepwise", "fused", "fused", "stepwise"]
    assert [r["megastep_rounds"] for r in rec["runs"]] == [0, 5, 5, 0]
    assert [r["megastep_fallback_reason"] for r in rec["runs"]] == [
        "unattempted", "eligible", "eligible", "unattempted"]
    assert all(all(e.values()) for e in rec["bit_equal"].values())
    assert len(rec["bit_equal"]) == 4
    want = rec["launches_wanted"]
    assert want["block_topk"] == want["staleness_agg"] == 8
    assert want["fused_adam"] >= 8
    assert all(r["launches"] == want for r in rec["runs"])
    assert {k: len(v) for k, v in rec["wall_s_per_round"].items()} == {
        "stepwise": 2, "fused": 2}
    assert rec["fused_over_stepwise"] > 0
    assert rec["agg_route"] == "sweep" and rec["deterministic_algorithms"]


def test_megastep_phase_fails_on_a_planted_difference(monkeypatch):
    """A fused aggregate one ulp-scale off the stepwise one fails the
    phase, as does a fused round that launches its selection twice."""
    from repro_torch.core import megastep

    cs = _load()
    agg = megastep.aggregate_rows_traced
    monkeypatch.setattr(megastep, "aggregate_rows_traced",
                        lambda *a, **k: agg(*a, **k) * (1 + 2 ** -20))
    with pytest.raises(AssertionError, match="fused differs from stepwise"):
        _megastep_rehearsal(cs, monkeypatch, order=("stepwise", "fused"))
    monkeypatch.setattr(megastep, "aggregate_rows_traced", agg)
    select = megastep.scored_topk
    monkeypatch.setattr(megastep, "scored_topk",
                        lambda *a: (select(*a), select(*a))[1])
    with pytest.raises(AssertionError, match="launched"):
        _megastep_rehearsal(cs, monkeypatch, order=("stepwise", "fused"))


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


def test_path_kernels_follow_the_optimizer():
    cs = _load()
    assert cs.path_kernels("apodotiko") == ("staleness_agg", "fused_adam")
    assert cs.path_kernels("apodotiko", "sgd") == ("staleness_agg",)
    assert cs.path_kernels("apodotiko-topk", "sgd") == ("staleness_agg",
                                                        "block_topk")
    assert cs.main_run({"model": "paper-femnist", "strategy": "apodotiko",
                        "rounds": [{}]}) == \
        "paper_models phase: paper-femnist: apodotiko, 1 rounds"


@pytest.mark.usefixtures("one_torch_thread")
def test_paper_models_phase_on_the_cpu(monkeypatch, capsys):
    """The phase's contract at 4 clients (2 a round) and a twentieth of the
    data: the paper's param counts and row widths, every round run, each
    Adam cohort's largest step budget as its ``fused_adam`` launches, none
    for Shakespeare's SGD, ``staleness_agg`` once a round, finite params;
    one JSON line per model."""
    cs = _load()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _count_plain_calls(monkeypatch)
    recs = cs.paper_models_phase(torch.device("cpu"), n_clients=4,
                                 clients_per_round=2, data_scale=0.05)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["model"] for l in lines] == [
        "paper-femnist", "paper-speech", "paper-shakespeare"]
    assert {k: r["n_params"] for k, r in recs.items()} == {
        "femnist": 6_603_710, "speech": 67_267, "shakespeare": 818_402}
    assert recs["femnist"]["row_width"] == 6_603_776
    for name, r in recs.items():
        run = cs.PAPER_RUNS[name]
        assert len(r["rounds"]) == run["rounds"] and r["params_finite"]
        assert r["launches"]["staleness_agg"] == run["rounds"]
        adam = r["launches"]["fused_adam"]
        assert adam == (sum(r["cohort_step_budgets"])
                        if run["optimizer"] == "adam" else 0)
        assert r["largest_step_budget"] == max(r["cohort_step_budgets"])
        assert r["launches"] == {**r["launches"], **r["launches_wanted"]}
    assert recs["shakespeare"]["X_dtype"] == "int32"
    assert recs["femnist"]["X"][2:] == [28, 28, 1]
    assert recs["speech"]["X"][2:] == [32, 32, 1]


@pytest.mark.usefixtures("one_torch_thread")
def test_paper_model_run_fails_without_its_launches(monkeypatch):
    """On the CPU no kernel launches: uncounted, the Adam path's missing
    ``fused_adam`` launches fail the run."""
    cs = _load()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with pytest.raises(AssertionError, match="launched 0 times"):
        cs.paper_model_run("speech", torch.device("cpu"), n_clients=4,
                           clients_per_round=2, data_scale=0.05)


def _sweep_rehearsal(cs, monkeypatch, plant=None):
    """chip_smoke's sweep phase with both its "card" and CPU sweeps on the
    CPU, ``chaos``, ``production_load`` and ``dataplane_ablation`` cut to
    2 rounds of 2 clients: the card sweeps (the first two of ``smoke``,
    then the first of each other preset) report launches, the CPU ones
    none; ``plant`` may alter a sweep's table by its call index."""
    import dataclasses
    orig, calls = cs.timed_sweep, []
    specs = cs.sweep_specs()

    def timed(spec, dev, workers=1):
        table, wall, launches = orig(spec, dev, workers)
        i = len(calls)
        calls.append(i)
        if plant:
            plant(i, table)
        card = i in (0, 1) or (i >= 3 and i % 2 == 1)
        return table, wall, {k: int(card) for k in launches}

    def cut(spec):
        return dataclasses.replace(spec, scale=dataclasses.replace(
            spec.scale, n_clients=4, clients_per_round=2, rounds=2,
            data_scale=0.05))

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "timed_sweep", timed)
    monkeypatch.setattr(cs, "sweep_specs", lambda: {
        name: (spec if name in ("smoke", "paper_tables") else cut(spec))
        for name, spec in specs.items()})
    return cs.sweep_phase(torch.device("cpu"))


@pytest.mark.usefixtures("one_torch_thread")
def test_sweep_phase_on_the_cpu(capsys):
    cs = _load()
    with pytest.MonkeyPatch.context() as mp:
        rec = _sweep_rehearsal(cs, mp)
    assert rec["smoke"]["serial_equals_2_workers"]
    assert {k: r["cells"] for k, r in rec.items()} == {
        "smoke": 2, "paper_tables": 8, "chaos": 8, "production_load": 12,
        "dataplane_ablation": 4}
    assert all(r["host_columns_equal"] for r in rec.values())
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    rows = {l["preset"]: l["rows"] for l in lines
            if l["phase"] == "sweep_rows"}
    assert {r["dataset"] for r in rows["paper_tables"]} == {
        "mnist", "femnist", "shakespeare", "speech"}
    for preset, axis in (("chaos", "fault_profile"),
                         ("production_load", "traffic_profile"),
                         ("dataplane_ablation", "data_plane")):
        assert len({r[axis] for r in rows[preset]}) > 1
    for r in sum(rows.values(), []):
        assert r["error"] is None and r["rounds"] > 0
        assert {"final_acc_card", "final_acc_cpu"} <= set(r)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("call, column, match", [
    (2, "cost_usd", "host columns differ"),        # the smoke CPU sweep
    (1, "final_acc", "1 and 2 workers"),           # the 2-worker sweep
    (0, "error", "cells failed"),
    (6, "n_failures", "host columns differ"),      # the chaos CPU sweep
])
def test_sweep_phase_fails_on_a_planted_difference(call, column, match):
    cs = _load()

    def plant(i, table):
        if i == call:
            table.rows[0][column] = ("boom" if column == "error"
                                     else table.rows[0][column] + 1)

    with pytest.MonkeyPatch.context() as mp, \
            pytest.raises(AssertionError, match=match):
        _sweep_rehearsal(cs, mp, plant)


# the rehearsal size's rounds are short in simulated time (a few local
# steps each), so longer steps place the profiles' events inside its runs
REHEARSAL_STEP_TIMES = {"recovery": 64.0, "faults": 64.0, "traffic": 128.0,
                        "trace_megastep": 32.0}


@pytest.mark.usefixtures("one_torch_thread")
def test_sweep_phase_fails_when_a_plane_twin_differs():
    """The same change to a host-plane cell on the card and on the CPU
    keeps the two sides equal and breaks the ablation's own claim."""
    cs = _load()
    last = len(cs.sweep_specs()) * 2 + 1     # smoke runs 3 sweeps

    def plant(i, table):
        if i in (last - 2, last - 1):        # dataplane_ablation's pair
            table.rows[-1]["cost_usd"] += 1

    with pytest.MonkeyPatch.context() as mp, \
            pytest.raises(AssertionError, match="device twin"):
        _sweep_rehearsal(cs, mp, plant)


def _profiles_rehearsal(cs, monkeypatch):
    """chip_smoke's profiles phase on the CPU at the reference's test size
    (ProxyCNN, 10 clients, 4 a round, E=1, B=5), plain calls counted."""
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.models.proxy_models import ProxyCNN

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _count_plain_calls(monkeypatch)
    data = make_federated_dataset("mnist", n_clients=10, scale=0.05, seed=0)
    return cs.profiles_phase(data, torch.device("cpu"), model=ProxyCNN(10),
                             step_times=REHEARSAL_STEP_TIMES,
                             n_clients=10, clients_per_round=4,
                             local_epochs=1, batch_size=5)


@pytest.mark.usefixtures("one_torch_thread")
def test_profiles_phase_on_the_cpu(monkeypatch, capsys):
    """The phase's contract: every fault profile with the recovery layer
    and on both engines, every traffic profile on both engines (bit-equal
    params, equal chaos traces), trace-demo fused against stepwise, the
    oracle planes against the device planes with their byte counters, one
    JSON line; and what the pytree entry needs from the plane run."""
    cs = _load()
    rec = _profiles_rehearsal(cs, monkeypatch)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["phase"] for l in lines] == ["profiles_trace_demo", "profiles"]
    assert set(rec["faults"]) == set(cs.FAULT_RUNS)
    assert set(rec["traffic"]) == set(cs.TRAFFIC_RUNS) | {"trace-demo[scaffold]"}
    assert rec["step_times_s"] == REHEARSAL_STEP_TIMES
    for name, f in rec["faults"].items():
        assert f["engines"]["engines_bit_equal"]
        assert f["recovery"]["rounds"] == cs.PROFILE_ROUNDS
        assert set(f["recovery"]["launches"]) == {"staleness_agg",
                                                  "fused_adam"}
        for run in f.values():
            assert sum(run["failures_by_phase"].get(p, 0)
                       for p in cs.FAULT_PHASES[name]) > 0
        assert f["recovery"]["n_retries"] + f["recovery"]["n_timeouts"] > 0
    for name, t in rec["traffic"].items():
        assert t["engines_bit_equal"]
        assert min(t["n_traffic_joins"], t["n_traffic_leaves"],
                   t["traffic_segments_applied"]) > 0
        assert "n_cancelled" in t
    assert rec["traffic"]["flash-crowd"]["n_traffic_dropped"] > 0
    scaffold = rec["traffic"]["trace-demo[scaffold]"]
    assert scaffold["strategy"] == "scaffold"
    assert scaffold["departed_variates_zeroed"] > 0
    assert rec["trace_demo_megastep"]["bit_equal"]
    assert rec["trace_demo_megastep"]["fused_rounds"][0] == 0
    assert rec["trace_demo_megastep"]["fused_rounds"][1] >= 3
    mega = rec["trace_demo_megastep"]["traffic"]
    assert mega[0] == mega[1] and mega[0]["n_traffic_leaves"] > 0
    planes = rec["planes"]
    assert planes["host_traces_equal"]
    assert planes["params_max_abs_diff"] <= planes["atol"]
    assert (planes["oracle_update_plane"], planes["oracle_data_plane"]) == (
        "blob", "host")
    assert planes["device_update_host_bytes"] == 0
    assert planes["oracle_update_host_bytes"] > 0
    run = rec["pytree_run"]
    assert run["rounds"][-1]["n_aggregated"] == planes["last_pending"]
    assert run["launches"]["staleness_agg"] == cs.PROFILE_ROUNDS
    assert lines[-1]["planes"] == json.loads(json.dumps(planes))


@pytest.mark.usefixtures("one_torch_thread")
def test_profiles_phase_fails_on_a_planted_difference(monkeypatch):
    """One ulp-scale change to the poll loop's params fails the engine
    pair."""
    from repro_torch.core.controller import Controller

    cs = _load()
    timed = cs.timed_run

    def plant(eng):
        out = timed(eng)
        if isinstance(eng, Controller):
            leaf = next(iter(eng.params))
            eng.params[leaf] = eng.params[leaf] * (1 + 2 ** -20)
        return out

    monkeypatch.setattr(cs, "timed_run", plant)
    with pytest.raises(AssertionError, match="differs across engines"):
        _profiles_rehearsal(cs, monkeypatch)


def _fault_free(monkeypatch):
    from repro_torch.faas.faults import FaultModel, FaultOutcome
    monkeypatch.setattr(FaultModel, "evaluate",
                        lambda self, *a, **kw: FaultOutcome())


def _traffic_free(monkeypatch):
    from repro_torch.core.services import FLRuntime
    monkeypatch.setattr(FLRuntime, "_apply_traffic_segment",
                        lambda self, seg: None)


def _variates_kept(monkeypatch):
    """Leaves go on, but the departed clients' variate rows survive."""
    from repro_torch.core.services import FLRuntime
    apply = FLRuntime._apply_traffic_segment

    def keep(self, seg):
        kept = None if self.c_buf is None else self.c_buf.clone()
        apply(self, seg)
        if kept is not None:
            self.c_buf.copy_(kept)

    monkeypatch.setattr(FLRuntime, "_apply_traffic_segment", keep)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("plant, match", [
    (_fault_free, "struck nothing"),
    (_traffic_free, "traffic applied"),
    (_variates_kept, "variate row is not zero"),
], ids=["faults", "traffic", "variates"])
def test_profiles_phase_fails_when_a_mechanism_does_nothing(
        monkeypatch, plant, match):
    """Fault injection, traffic application or the SCAFFOLD rows' zeroing
    wired to nothing: both engines still agree, and the phase still
    fails."""
    cs = _load()
    plant(monkeypatch)
    with pytest.raises(AssertionError, match=match):
        _profiles_rehearsal(cs, monkeypatch)


def test_pytree_entry_takes_the_plane_runs_k(monkeypatch):
    """CPU rehearsal of ``staleness_agg[pytree]``: K MnistCNN-shaped trees
    (K the plane run's last pending count), the stack padded to [Kp, N4]
    and timed apart, held to the plain version and to ``aggregate_pytree``,
    the bound over the K trees read and the result written."""
    cs = _load()
    monkeypatch.setattr(cs, "time_ms", lambda fn, before=None, **kw: (
        before and before(), fn(), 0.5)[2])
    monkeypatch.setattr(cs, "device_ms", _device_ms)
    monkeypatch.setattr(cs, "l2_flush", lambda dev: lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    run = {"rounds": [{"n_aggregated": 4}, {"n_aggregated": 3}],
           "launches": {"staleness_agg": 2}, "strategy": "apodotiko"}
    e = cs.pytree_agg_entry(run, torch.device("cpu"))
    assert e["name"] == "staleness_agg[pytree]"
    assert e["shape"] == {"K": 3, "K_padded": 8, "N": 582_026,
                          "N_padded": 582_028}
    assert e["launches"] == 2 and e["max_abs_err"] < 1e-6
    assert e["aggregate_pytree_max_abs_err"] < 1e-6
    assert e["bytes"] == (3 * 582_026 + 3 + 582_026) * 4
    assert e["bound_by"] == "bytes" and e["stack_ms"] == 0.5
    assert set(cs.KERNEL_KEYS) <= set(e)


def _durability_rehearsal(cs, monkeypatch):
    """chip_smoke's durability phase on the CPU at the reference's test size
    (ProxyCNN, 10 clients, 4 a round, E=1, B=5), plain calls counted."""
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.models.proxy_models import ProxyCNN

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _count_plain_calls(monkeypatch)
    data = make_federated_dataset("mnist", n_clients=10, scale=0.05, seed=0)
    return cs.durability_phase(data, torch.device("cpu"), model=ProxyCNN(10),
                               n_clients=10, clients_per_round=4,
                               local_epochs=1, batch_size=5)


@pytest.mark.usefixtures("one_torch_thread")
def test_durability_phase_on_the_cpu(monkeypatch, capsys):
    """The phase's contract: three crash points of the apodotiko run and
    one of the apodotiko-topk run resume bit-equal to their golden runs
    with the launches a re-executed round must make, the SIGKILL child
    resumes, the checkpoint resume restores what it saved, the overhead
    and the snapshot numbers are reported, one JSON line, and the
    deterministic-algorithms flag is restored."""
    cs = _load()
    was = torch.are_deterministic_algorithms_enabled()
    rec = _durability_rehearsal(cs, monkeypatch)
    assert torch.are_deterministic_algorithms_enabled() == was
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["phase"] for l in lines] == ["durability"]
    apo, topk = rec["apodotiko"], rec["apodotiko_topk"]
    assert set(apo["crashes"]) == {"mid_round_2", "after_round_close",
                                   "n_records_minus_1"}
    assert set(topk["crashes"]) == {"mid_round_2"}
    assert apo["rounds"] == cs.DUR_ROUNDS
    assert topk["rounds"] == cs.DUR_TOPK_ROUNDS
    n = apo["journal_records"]
    assert apo["crashes"]["n_records_minus_1"]["crash_after"] == n - 1
    for series in (apo, topk):
        assert series["n_snapshots"] == series["rounds"]
        assert series["snapshot_bytes"] and min(series["snapshot_bytes"]) > 0
        assert series["journal_fsyncs"] < series["journal_records"]
        for c in series["crashes"].values():
            assert c["differs"] == []
            assert c["launches"] == c["launches_wanted"]
            assert c["journal_replayed"] > 0 and c["resume_ms"] > 0
    mid = apo["crashes"]["mid_round_2"]
    assert mid["snapshot_round"] == 1
    assert mid["launches_wanted"]["staleness_agg"] == cs.DUR_ROUNDS - 1
    assert mid["launches_wanted"]["fused_adam"] > 0
    assert topk["crashes"]["mid_round_2"]["launches_wanted"][
        "block_topk"] == 1
    assert rec["sigkill"]["returncode"] == -9
    assert rec["sigkill"]["records_on_disk"] == cs.DUR_CHILD_CRASH
    assert rec["sigkill"]["differs"] == []
    ckpt = rec["checkpoint"]
    assert ckpt["cadence"] == [1, 2] and ckpt["live_rows"] > 0
    assert ckpt["differs"] == [] and ckpt["final_round"] == 3
    over = rec["overhead"]
    assert over["off_wall_s"] > 0 and over["journal_wall_s"] > 0
    assert over["reference_ci_limit"] == 0.05
    assert lines[0]["overhead"]["overhead"] == over["overhead"]


def _generator_not_restored(monkeypatch):
    """A snapshot that leaves out the generator state: the resumed trainer
    keeps the generator it was built with (seeded afresh)."""
    from repro_torch.durability import snapshot

    install = snapshot.install_snapshot

    def forgetful(rt, state, path):
        fresh = rt.trainer.generator.get_state()
        install(rt, state, path)
        rt.trainer.generator.set_state(fresh)

    monkeypatch.setattr(snapshot, "install_snapshot", forgetful)
    import repro_torch.durability as durability
    monkeypatch.setattr(durability, "install_snapshot", forgetful)


def _rows_not_written(monkeypatch):
    """A resume that reserves the live rows but skips writing them."""
    from repro_torch.core.update_store import UpdateStore

    def reserve_only(self, ids, rows):
        for i in ids:
            i = int(i)
            if i in self._free:
                self._free.remove(i)
            self._live.add(i)

    monkeypatch.setattr(UpdateStore, "write_at", reserve_only)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("plant", [_generator_not_restored,
                                   _rows_not_written],
                         ids=["generator", "write_at"])
def test_durability_phase_fails_on_a_planted_omission(monkeypatch, plant):
    """Each planted omission fails the phase: a resumed generator restarted
    at its seed draws other minibatches (the journal's round-close
    fingerprint of the generator diverges), and rows reserved but not
    written aggregate zeros into the params."""
    from repro_torch.durability import JournalDivergence

    cs = _load()
    plant(monkeypatch)
    with pytest.raises((AssertionError, JournalDivergence)):
        _durability_rehearsal(cs, monkeypatch)


# ----------------------------------------------------------------------- lm
LM_SMALL = dict(smoke=True, serve=dict(batch=2, prompt=16, cache=24),
                train=dict(steps=3, batch=2, seq=33),
                fl=dict(clients=6, rounds=2, data_vocab=64, full=False),
                trace_argv=("--clients", "6", "--rounds", "2"))


def _lm_rehearsal(cs, monkeypatch, count=True):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    if count:
        _count_plain_calls(monkeypatch)
    return cs.lm_phase(torch.device("cpu"), **LM_SMALL)


@pytest.mark.usefixtures("one_torch_thread")
def test_lm_phase_on_the_cpu(monkeypatch, capsys):
    """The phase's contract on the smoke config: serve (prefill, greedy
    decode to fill the cache, each decoded position against the full
    forward), train through ``launch.train.main`` (a finite loss a step,
    one ``fused_adam`` a step, the step-0 batch's loss lower after), and
    the federated example (one ``staleness_agg`` an aggregation, one
    ``fused_adam`` a local step of each cohort's largest budget; host
    trace card against CPU); one JSON line."""
    cs = _load()
    rec = _lm_rehearsal(cs, monkeypatch)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"phase": "lm", **json.loads(json.dumps(rec))}
    serve, train, fl = rec["serve"], rec["train"], rec["fl"]
    assert list(serve) == ["bfloat16", "float32"]
    for dt, s in serve.items():
        assert s["dtype"] == dt and s["decode_rtol"] == cs.LM_DECODE_RTOL[dt]
        assert s["decoded_tokens"] == 8 and s["decode_steps"] == 7
        assert s["n_params"] == 82_304 and s["logits_finite"]
        assert s["decode_rel_l2_max"] <= s["decode_rtol"]
    assert serve["float32"]["decode_rel_l2_max"] < 1e-5
    assert train["launches"]["fused_adam"] == 3 == len(train["losses"])
    assert train["step0_batch_loss_after"] < train["losses"][0]
    assert train["tokens_per_step"] == 2 * 32 and train["remat"]
    assert fl["launches"] == {**fl["launches"], **fl["launches_wanted"]}
    assert fl["launches_wanted"]["staleness_agg"] == 2
    assert fl["launches_wanted"]["fused_adam"] == \
        sum(fl["cohort_step_budgets"])
    assert fl["trace_equal"] and fl["trace_metrics_equal"]
    assert fl["params_finite"] and fl["agg_route"] == "sweep"
    assert fl["data_vocab"] == 64 and fl["n_params"] == 90_496
    assert cs.main_run(fl) == ("lm phase: qwen3-1.7b, 2 L, d 64, vocab 256: "
                               "apodotiko, 2 rounds")


@pytest.mark.usefixtures("one_torch_thread")
def test_lm_phase_fails_without_its_launches(monkeypatch):
    """On the CPU no kernel launches: uncounted, the training run's missing
    ``fused_adam`` launches fail the phase."""
    cs = _load()
    with pytest.raises(AssertionError, match="fused_adam launched 0 times"):
        _lm_rehearsal(cs, monkeypatch, count=False)


@pytest.mark.usefixtures("one_torch_thread")
def test_lm_serve_fails_on_a_planted_decode_fault(monkeypatch):
    """A decode step whose logits stray 10 % from the full forward's fails
    the serve check."""
    from repro_torch.models.lm import DecoderLM

    cs = _load()
    step = DecoderLM.decode_step
    monkeypatch.setattr(DecoderLM, "decode_step", lambda *a: (
        lambda out: (out[0] * 1.1, out[1]))(step(*a)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    from repro_torch.configs import get_config
    with pytest.raises(AssertionError, match="relative L2"):
        cs.lm_serve(torch.device("cpu"),
                    get_config("qwen3-1.7b", smoke=True),
                    **LM_SMALL["serve"])


def test_lm_full_fl_config_is_the_examples_100m():
    """The federated run's model is the example's ``--full`` config, at
    the width the kernel entries report."""
    from repro_torch.models.api import LMClientAdapter
    from repro_torch.models.common import count_params

    cs = _load()
    assert cs.LM_FL["full"] and cs.LM_FL["clients"] == 12
    cfg = cs.load_example(cs.LM_FL_EXAMPLE).lm_config(cs.LM_ARCH, True)
    assert count_params(LMClientAdapter(cfg).init(device="meta")) == \
        100_094_208


def _lm_record(cs):
    return {"train": {"arch": "qwen3-1.7b", "n_params": 82_302, "steps": 3,
                      "launches": {"fused_adam": 3}},
            "fl": {"model": "qwen3-1.7b, 12 L, d 768, vocab 32000",
                   "phase": "lm",
                   "strategy": "apodotiko", "row_width": 2048,
                   "cohort_sizes": [3, 4], "agg_route": "sweep",
                   "rounds": [{"store_capacity": 8, "n_aggregated": 3}] * 3,
                   "launches": {"staleness_agg": 3, "fused_adam": 20}}}


def _stub_entry_timers(cs, monkeypatch):
    import types
    monkeypatch.setattr(cs, "time_ms", lambda fn, **kw: (fn(), 0.5)[1])
    monkeypatch.setattr(cs, "device_ms", _device_ms)
    monkeypatch.setattr(cs, "l2_flush", lambda dev: lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(cs, "LM_CHECK_CHUNK", 1000)   # many chunks


def test_lm_kernel_entries_take_the_phases_shapes(monkeypatch):
    """CPU rehearsal: ``fused_adam`` at the training step's one lane of
    every param (padded to the kernel's 4) and at the federated run's
    largest cohort, ``staleness_agg`` at its last aggregate in the route it
    took (the sweep: 8 rows) and in the rows form; each held to its plain
    version (the Adam check a chunk of columns at a time), with its run's
    launches and the byte bound."""
    cs = _load()
    _stub_entry_timers(cs, monkeypatch)
    entries = cs.lm_kernel_entries(_lm_record(cs), torch.device("cpu"))
    assert [e["name"] for e in entries] == [
        "fused_adam[qwen3-1.7b]", "fused_adam[fl_lm]",
        "staleness_agg[fl_lm]", "staleness_agg[fl_lm,rows]"]
    big, adam, sweep, rows = entries
    assert big["shape"] == {"Kp": 1, "W": 82_304, "active_lanes": 1}
    assert big["launches"] == 3 and big["max_abs_err"] < 1e-6
    assert big["launches_run"] == "lm phase: qwen3-1.7b launch.train, 3 steps"
    assert big["bytes"] == 82_304 * 7 * 4 + 4 and big["bound_by"] == "bytes"
    assert adam["shape"] == {"Kp": 4, "W": 2048, "active_lanes": 4}
    assert adam["launches"] == 20
    assert adam["launches_run"] == \
        "lm phase: qwen3-1.7b, 12 L, d 768, vocab 32000: apodotiko, 3 rounds"
    assert not sweep["shape"]["rows_form"] and rows["shape"]["rows_form"]
    assert sweep["shape"]["C"] == 8 and rows["shape"]["K"] == 3
    for e in entries:
        assert set(cs.KERNEL_KEYS) <= set(e)
        assert e["library_ms"] == 0.5 and e["plain_ms"] == 0.5


def test_lm_adam_check_covers_every_chunk(monkeypatch):
    """A kernel output wrong in the last column only (the last chunk of the
    check) fails the entry."""
    from repro_torch.kernels import fused_adam as fa

    cs = _load()
    _stub_entry_timers(cs, monkeypatch)
    real = fa.fused_adam

    def planted(p, *a, **k):
        real(p, *a, **k)
        p[0, -1] += 1.0

    monkeypatch.setattr(fa, "fused_adam", planted)
    with pytest.raises(AssertionError, match="x the tolerance"):
        cs.adam_entry("fused_adam[x]", 1, 1, 8192, 1, "x", torch.device("cpu"))


def test_lm_phase_probe_fails_without_a_card():
    """``scripts/lm_phase_probe.py`` runs only on a card: with none visible
    it exits non-zero and prints no phase line."""
    import os
    proc = subprocess.run([sys.executable, "scripts/lm_phase_probe.py"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"phase"' not in proc.stdout and "no CUDA card" in proc.stderr


MOE_SMALL = dict(
    serve={"deepseek-v2-lite-16b": dict(layers=None, batch=2, prompt=16,
                                        cache=24, smoke=True,
                                        dtype="bfloat16"),
           "arctic-480b": dict(layers=1, batch=2, prompt=16, cache=24,
                               smoke=True, dtype="bfloat16")},
    fp32=dict(arch="deepseek-v2-lite-16b", layers=3, batch=2, prompt=16,
              cache=24, smoke=True),
    train=dict(arch="deepseek-v2-lite-16b", smoke=True, layers=3, steps=3,
               batch=2, seq=33),
    smoke_train=("--arch", "arctic-480b", "--smoke", "--steps", "3",
                 "--batch", "2", "--seq", "17"),
    fl=dict(arch="deepseek-v2-lite-16b", clients=6, rounds=2, data_vocab=64,
            full=False),
    trace_argv=("--arch", "deepseek-v2-lite-16b", "--clients", "6",
                "--rounds", "2"))


def _moe_rehearsal(cs, monkeypatch, count=True):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    if count:
        _count_plain_calls(monkeypatch)
    return cs.moe_phase(torch.device("cpu"), **MOE_SMALL)


@pytest.mark.usefixtures("one_torch_thread")
def test_moe_phase_on_the_cpu(monkeypatch, capsys):
    """The moe phase's contract on the smoke configs: each arch served in
    bf16 and DeepSeek's cut in fp32, timed at its capacity factor and
    checked at the no-drop one (every call's capacity holding its tokens;
    each decoded position against the full forward); DeepSeek's cut
    trained through ``launch.train`` (one ``fused_adam`` a step) and with
    Adafactor (no launch), both first-batch losses falling; Arctic's smoke
    run card against CPU from one checkpointed init; the federated MoE
    example's launches and host trace; one JSON line."""
    cs = _load()
    rec = _moe_rehearsal(cs, monkeypatch)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"phase": "moe", **json.loads(json.dumps(rec))}
    serve = rec["serve"]
    assert list(serve) == ["deepseek-v2-lite-16b", "arctic-480b", "float32"]
    for name, s in serve.items():
        dt = "float32" if name == "float32" else "bfloat16"
        assert s["dtype"] == dt and s["decode_rtol"] == cs.LM_DECODE_RTOL[dt]
        assert s["decode_rel_l2_max"] <= s["decode_rtol"]
        assert s["capacity_factor"] == 8.0
        assert s["check_capacity_factor"] == 4      # ceil(8 / 2)
        assert all(c["capacity"] >= c["tokens"]
                   for c in s["check_capacities"].values())
        assert s["decoded_tokens"] == 8 and s["logits_finite"]
    assert serve["arctic-480b"]["n_layers"] == 1
    assert serve["float32"]["decode_rel_l2_max"] < 1e-5
    train, ada = rec["train"], rec["adafactor"]
    assert train["launches"]["fused_adam"] == 3 == len(train["losses"])
    assert train["n_layers"] == 3 and train["optimizer"] == "adam"
    assert ada["optimizer"] == "adafactor" and ada["lr"] == 1e-3
    assert not any(ada["launches"].values())
    for r in (train, ada):
        assert r["step0_batch_loss_after"] < r["losses"][0]
    smoke = rec["smoke_train"]
    assert smoke["losses_card"] == smoke["losses_cpu"]
    assert len(smoke["losses_cpu"]) == 3
    assert smoke["opt_state_keys"] == ["s", "t"]
    fl = rec["fl"]
    assert fl["phase"] == "moe" and fl["trace_equal"]
    assert fl["launches"] == {**fl["launches"], **fl["launches_wanted"]}
    assert fl["launches_wanted"]["fused_adam"] == \
        sum(fl["cohort_step_budgets"])
    assert cs.main_run(fl).startswith(
        "moe phase: deepseek-v2-lite-16b, 3 L, d 64, vocab 256")


@pytest.mark.usefixtures("one_torch_thread")
def test_moe_phase_fails_without_its_launches(monkeypatch):
    """On the CPU no kernel launches: uncounted, the training run's missing
    ``fused_adam`` launches fail the phase."""
    cs = _load()
    with pytest.raises(AssertionError, match="fused_adam launched 0 times"):
        _moe_rehearsal(cs, monkeypatch, count=False)


@pytest.mark.usefixtures("one_torch_thread")
def test_moe_serve_refuses_a_check_that_can_drop(monkeypatch):
    """The serve check's capacity must hold every call's tokens: at the
    published 1.25 the full forward over 2 x 23 tokens of the smoke
    config can drop (capacity 16 < 46), and the check refuses to run."""
    from repro_torch.configs import get_config

    cs = _load()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cfg = get_config("deepseek-v2-lite-16b", smoke=True)
    assert cs.no_drop_cf(cfg) == 4
    assert cs.no_drop_cf(get_config("deepseek-v2-lite-16b")) == 11
    assert cs.no_drop_cf(get_config("arctic-480b")) == 64
    with pytest.raises(AssertionError, match="can drop tokens"):
        cs.lm_serve(torch.device("cpu"), cfg, 2, 16, 24,
                    check_cfg=cfg.with_(capacity_factor=1.25))


def test_moe_published_serve_calls_drop_nothing_at_the_check_capacity():
    """At the card's shapes every call of each serve check holds all its
    tokens at ``ceil(n_experts / top_k)``: DeepSeek's prefill of 2,048,
    full forward of 2,300 and decode of 4; Arctic's 512, 636 and 4."""
    from repro_torch.configs import get_config

    cs = _load()
    for arch, kw in cs.MOE_SERVE.items():
        cfg = get_config(arch)
        caps = cs.serve_capacities(cfg.with_(capacity_factor=cs.no_drop_cf(
            cfg)), kw["batch"], kw["prompt"], kw["cache"])
        assert all(c["capacity"] >= c["tokens"] for c in caps.values()), arch
    caps = cs.serve_capacities(get_config("deepseek-v2-lite-16b"), 4, 512,
                               576)
    assert caps["full"] == {"tokens": 2300, "capacity": 272}


def test_moe_kernel_entry_takes_the_training_steps_width(monkeypatch):
    """CPU rehearsal: ``fused_adam`` at the DeepSeek cut's one lane of
    every param (padded to the kernel's 4), with its run's launches,
    held to its plain version a chunk of columns at a time."""
    cs = _load()
    _stub_entry_timers(cs, monkeypatch)
    rec = {"train": {"arch": "deepseek-v2-lite-16b", "n_layers": 3,
                     "n_params": 216_094, "steps": 3,
                     "launches": {"fused_adam": 3}}}
    (entry,) = cs.moe_kernel_entries(rec, torch.device("cpu"))
    assert entry["name"] == "fused_adam[deepseek-v2-lite-16b]"
    assert entry["shape"] == {"Kp": 1, "W": 216_096, "active_lanes": 1}
    assert entry["launches"] == 3 and entry["max_abs_err"] < 1e-6
    assert entry["launches_run"] == ("moe phase: deepseek-v2-lite-16b "
                                     "(3 layers) launch.train, 3 steps")
    assert entry["bytes"] == 216_096 * 7 * 4 + 4
    assert set(cs.KERNEL_KEYS) <= set(entry)


SSM_ARCHS = ("mamba2-370m", "zamba2-2.7b")
SSM_SMALL = dict(
    serve={a: dict(layers=None, batch=2, prompt=16, cache=24, smoke=True)
           for a in SSM_ARCHS},
    fp32={a: dict(layers=None, batch=2, prompt=16, cache=24, smoke=True)
          for a in SSM_ARCHS},
    # 40 tokens prefill in chunks of 10; the full forward over 47 (prime)
    # runs the scan one token a chunk
    long=dict(arch="mamba2-370m", layers=None, batch=1, prompt=40, cache=48,
              smoke=True),
    train={"mamba2-370m": dict(smoke=True, layers=None, steps=3, batch=2,
                               seq=33),
           "zamba2-2.7b": dict(smoke=True, layers=2, steps=3, batch=2,
                               seq=33)},
    smoke_train=tuple(("--arch", a, "--smoke", "--steps", "3", "--batch",
                       "2", "--seq", "17") for a in SSM_ARCHS),
    fl=tuple(dict(arch=a, clients=6, rounds=2, data_vocab=64, full=False)
             for a in SSM_ARCHS),
    trace_argv=tuple(("--arch", a, "--clients", "6", "--rounds", "2")
                     for a in SSM_ARCHS))


def _ssm_rehearsal(cs, monkeypatch, count=True):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    if count:
        _count_plain_calls(monkeypatch)
    return cs.ssm_phase(torch.device("cpu"), **SSM_SMALL)


@pytest.mark.usefixtures("one_torch_thread")
def test_ssm_phase_on_the_cpu(monkeypatch, capsys):
    """The ssm phase's contract on the smoke configs: both archs served in
    bf16 and fp32 (each decoded position, the recurrent step from the
    prefill's state, against the full forward's chunked scan), Mamba2 at a
    long prompt whose full forward takes chunk 1; Mamba2 and Zamba2's cut
    trained through ``launch.train`` (one ``fused_adam`` a step, the first
    batch's loss falling); both smoke runs card against CPU from one
    checkpointed init; both federated examples' launches and host traces;
    one JSON line."""
    cs = _load()
    rec = _ssm_rehearsal(cs, monkeypatch)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"phase": "ssm", **json.loads(json.dumps(rec))}
    serve = rec["serve"]
    assert list(serve) == ["bfloat16", "float32"]
    for dt, runs in serve.items():
        assert list(runs) == list(SSM_ARCHS)
        for s in runs.values():
            assert s["dtype"] == dt
            assert s["decode_rtol"] == cs.SSM_DECODE_RTOL[dt]
            assert s["decode_rel_l2_max"] <= s["decode_rtol"]
            assert s["decoded_tokens"] == 8 and s["logits_finite"]
            assert (s["chunk_prefill"], s["chunk_full_forward"]) == (16, 1)
        if dt == "float32":
            assert max(s["decode_rel_l2_max"] for s in runs.values()) < 1e-5
    assert serve["bfloat16"]["zamba2-2.7b"]["n_layers"] == 4
    long = rec["long"]
    assert (long["prompt"], long["decode_steps"]) == (40, 7)
    assert (long["chunk_prefill"], long["chunk_full_forward"]) == (10, 1)
    assert long["decode_rel_l2_max"] <= long["decode_rtol"] == 0.15
    assert cs.SSM_DECODE_RTOL["float32"] == cs.LM_DECODE_RTOL["float32"]
    for arch, t in rec["train"].items():
        assert t["launches"]["fused_adam"] == 3 == len(t["losses"])
        assert t["optimizer"] == "adam" and t["remat"]
        assert t["step0_batch_loss_after"] < t["losses"][0]
    assert rec["train"]["zamba2-2.7b"]["n_layers"] == 2
    assert list(rec["smoke_train"]) == list(SSM_ARCHS)
    for smoke in rec["smoke_train"].values():
        assert smoke["losses_card"] == smoke["losses_cpu"]
        assert len(smoke["losses_cpu"]) == 3
        assert smoke["opt_state_keys"] == ["m", "t", "v"]
    assert list(rec["fl"]) == list(SSM_ARCHS)
    for arch, fl in rec["fl"].items():
        assert fl["phase"] == "ssm" and fl["trace_equal"]
        assert fl["trace_metrics_equal"] and fl["params_finite"]
        assert fl["launches"] == {**fl["launches"], **fl["launches_wanted"]}
        assert fl["launches_wanted"]["fused_adam"] == \
            sum(fl["cohort_step_budgets"])
        assert cs.main_run(fl).startswith(f"ssm phase: {arch}, ")


@pytest.mark.usefixtures("one_torch_thread")
def test_ssm_phase_fails_without_its_launches(monkeypatch):
    """On the CPU no kernel launches: uncounted, the first training run's
    missing ``fused_adam`` launches fail the phase."""
    cs = _load()
    with pytest.raises(AssertionError, match="fused_adam launched 0 times"):
        _ssm_rehearsal(cs, monkeypatch, count=False)


@pytest.mark.usefixtures("one_torch_thread")
def test_ssm_serve_fails_on_a_planted_state_fault(monkeypatch):
    """A decode step that drops the prefill's SSM state (zeros it) strays
    from the full forward and fails the serve check."""
    from repro_torch.models import ssm

    cs = _load()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    step = ssm.mamba2_decode_step
    monkeypatch.setattr(ssm, "mamba2_decode_step", lambda p, x, cfg, c: step(
        p, x, cfg, {"h": torch.zeros_like(c["h"]), "conv": c["conv"]}))
    with pytest.raises(AssertionError, match="relative L2"):
        cs.ssm_serve(torch.device("cpu"), "mamba2-370m", None, 2, 16, 24,
                     smoke=True)


def test_ssm_card_runs_take_the_published_shapes():
    """The card's runs: both archs uncut at 4 x 512 into 576, Mamba2's
    32,768-token prompt, the chunks each scan takes (575: 115; 32,775:
    115; 4,095: 195; 1,023: 93), Zamba2's 36-layer training cut and
    12-layer fp32 cut, whole chunks of its attn_period."""
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import chunk_for

    cs = _load()
    mamba, zamba = get_config("mamba2-370m"), get_config("zamba2-2.7b")
    assert all(kw == dict(layers=None, batch=4, prompt=512, cache=576)
               for kw in cs.SSM_SERVE.values())
    assert [chunk_for(mamba, n) for n in (512, 575, 32768, 32775, 4095,
                                          1023)] == [256, 115, 256, 115,
                                                     195, 93]
    assert chunk_for(zamba, 1023) == 93
    assert cs.SSM_LONG["prompt"] == 32768 and cs.SSM_LONG["cache"] == 32776
    assert cs.SSM_TRAIN["zamba2-2.7b"]["layers"] % zamba.attn_period == 0
    assert cs.SSM_FP32["zamba2-2.7b"]["layers"] % zamba.attn_period == 0
    assert cs.SSM_TRAIN["mamba2-370m"]["seq"] == 4096
    assert [a[1] for a in cs.SSM_SMOKE_TRAIN] == list(SSM_ARCHS)


def test_ssm_kernel_entry_takes_the_training_steps_width(monkeypatch):
    """CPU rehearsal: ``fused_adam`` at the Mamba2 step's one lane of every
    param (padded to the kernel's 4), with its run's launches, held to its
    plain version a chunk of columns at a time."""
    cs = _load()
    _stub_entry_timers(cs, monkeypatch)
    rec = {"train": {"mamba2-370m": {"arch": "mamba2-370m", "n_layers": 2,
                                     "n_params": 73_158, "steps": 3,
                                     "launches": {"fused_adam": 3}}}}
    (entry,) = cs.ssm_kernel_entries(rec, torch.device("cpu"))
    assert entry["name"] == "fused_adam[mamba2-370m]"
    assert entry["shape"] == {"Kp": 1, "W": 73_160, "active_lanes": 1}
    assert entry["launches"] == 3 and entry["max_abs_err"] < 1e-6
    assert entry["launches_run"] == ("ssm phase: mamba2-370m (2 layers) "
                                     "launch.train, 3 steps")
    assert entry["bytes"] == 73_160 * 7 * 4 + 4
    assert set(cs.KERNEL_KEYS) <= set(entry)


@pytest.mark.parametrize("script", ["ssm_phase_probe.py",
                                    "ssm_time_split.py"])
def test_ssm_phase_probe_fails_without_a_card(script):
    """``scripts/ssm_phase_probe.py`` and ``scripts/ssm_time_split.py`` run
    only on a card: with none visible each exits non-zero and prints no
    phase line."""
    import os
    proc = subprocess.run([sys.executable, f"scripts/{script}"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"phase"' not in proc.stdout and "no CUDA card" in proc.stderr


# -------------------------------------------------------------------- xattn
XATTN_ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-large-v2")
XATTN_SMALL = dict(
    serve={a: dict(layers=None, batch=2, prompt=16, cache=24, smoke=True)
           for a in XATTN_ARCHS},
    fp32={a: dict(layers=None, batch=2, prompt=16, cache=24, smoke=True)
          for a in XATTN_ARCHS},
    train={"llama-3.2-vision-11b": dict(smoke=True, layers=2, steps=3,
                                        batch=2, seq=33),
           "seamless-m4t-large-v2": dict(smoke=True, layers=None, steps=3,
                                         batch=2, seq=33)},
    smoke_train=tuple(("--arch", a, "--smoke", "--steps", "3", "--batch",
                       "2", "--seq", "17") for a in XATTN_ARCHS),
    cross_train=dict(arch="llama-3.2-vision-11b", steps=2, batch=2, seq=17))
XATTN_LEAVES = ["gate", "wk", "wo", "wq", "wv"]


def _xattn_rehearsal(cs, monkeypatch, count=True):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    if count:
        _count_plain_calls(monkeypatch)
    return cs.xattn_phase(torch.device("cpu"), **XATTN_SMALL)


@pytest.mark.usefixtures("one_torch_thread")
def test_xattn_phase_on_the_cpu(monkeypatch, capsys):
    """The xattn phase's contract on the smoke configs: both archs served
    in bf16 and fp32 over random patches (all positions, the VLM's gates
    at 1.0) or frames (the prompt's length), each decoded position against
    the full forward over the same inputs; the VLM's one-chunk cut and
    SeamlessM4T trained through ``launch.train`` (one ``fused_adam`` a
    step, the first batch's loss falling); both smoke runs card against
    CPU from one checkpointed init; the VLM's smoke config trained with
    its gates open over random patches, card against CPU, every
    cross-attention leaf taking a grad and moving; no federated run; one
    JSON line."""
    cs = _load()
    rec = _xattn_rehearsal(cs, monkeypatch)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"phase": "xattn", **json.loads(json.dumps(rec))}
    serve = rec["serve"]
    assert list(serve) == ["bfloat16", "float32"]
    for dt, runs in serve.items():
        assert list(runs) == list(XATTN_ARCHS)
        for arch, s in runs.items():
            assert s["dtype"] == dt and s["logits_finite"]
            assert s["decode_rtol"] == cs.LM_DECODE_RTOL[dt]
            assert s["decode_rel_l2_max"] <= s["decode_rtol"]
            assert s["decoded_tokens"] == 8 and s["decode_steps"] == 7
        vlm, encdec = runs["llama-3.2-vision-11b"], runs[
            "seamless-m4t-large-v2"]
        assert vlm["memory"] == {"patches": [2, 16, 64]}
        assert vlm["gate"] == cs.VLM_GATE == 1.0
        assert encdec["memory"] == {"frames": [2, 16, 64]}
        assert "gate" not in encdec
        assert (vlm["n_params"], encdec["n_params"]) == (238_402, 213_760)
    assert set(rec) == {"serve", "train", "smoke_train", "cross_train",
                        "wall_s"}
    cross = rec["cross_train"]
    assert cross["gate"] == cs.VLM_GATE and cross["steps"] == 2
    assert cross["losses_card"] == cross["losses_cpu"]
    assert cross["loss_rel_max"] == 0.0 and cross["rtol"] == 1e-4
    assert sorted(cross["moments_rel_l2"]) == XATTN_LEAVES
    assert all(v == {"m": 0.0, "v": 0.0}
               for v in cross["moments_rel_l2"].values())
    assert all(cross["m_norm_cpu"][k] > 0 and cross["moved_card"][k] > 0
               for k in XATTN_LEAVES)
    for arch, t in rec["train"].items():
        assert t["launches"]["fused_adam"] == 3 == len(t["losses"])
        assert t["optimizer"] == "adam" and t["remat"]
        assert t["step0_batch_loss_after"] < t["losses"][0]
    assert rec["train"]["llama-3.2-vision-11b"]["n_layers"] == 2
    assert list(rec["smoke_train"]) == list(XATTN_ARCHS)
    for smoke in rec["smoke_train"].values():
        assert smoke["losses_card"] == smoke["losses_cpu"]
        assert len(smoke["losses_cpu"]) == 3
        assert smoke["opt_state_keys"] == ["m", "t", "v"]


@pytest.mark.usefixtures("one_torch_thread")
def test_xattn_phase_fails_without_its_launches(monkeypatch):
    """On the CPU no kernel launches: uncounted, the first training run's
    missing ``fused_adam`` launches fail the phase."""
    cs = _load()
    with pytest.raises(AssertionError, match="fused_adam launched 0 times"):
        _xattn_rehearsal(cs, monkeypatch, count=False)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("arch", XATTN_ARCHS)
def test_xattn_serve_fails_when_decode_loses_the_memory(monkeypatch, arch):
    """A decode step whose cross attention reads zeroed K/V (the patches
    or the encoded frames lost between prefill and decode) strays from the
    full forward and fails the serve check; with the VLM's gates left at
    their drawn zeros the same fault would pass unseen."""
    from repro_torch.models import attention

    cs = _load()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    forward = attention.cross_forward

    def lossy(p, x, kv, gated=False):
        if x.shape[1] == 1:                        # a decode step
            kv = {k: torch.zeros_like(v) for k, v in kv.items()}
        return forward(p, x, kv, gated=gated)

    monkeypatch.setattr(attention, "cross_forward", lossy)
    with pytest.raises(AssertionError, match="relative L2"):
        cs.xattn_serve(torch.device("cpu"), arch, None, 2, 16, 24,
                       smoke=True)
    if arch == "llama-3.2-vision-11b":
        monkeypatch.setattr(cs, "VLM_GATE", 0.0)
        rec = cs.xattn_serve(torch.device("cpu"), arch, None, 2, 16, 24,
                             smoke=True, dtype="float32")
        assert rec["decode_rel_l2_max"] < 1e-5


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("fault", ["zero-memory-gates-shut",
                                   "card-backward-lost"])
def test_cross_train_fails_without_cross_attentions_grads(monkeypatch,
                                                          fault):
    """The cross-attention training check fails where cross attention
    takes no grad: over zero K/V (the launcher's zero patches) with the
    gates at their drawn zeros, where every cross-attention grad is 0 on
    both devices; or with the K/V's backward lost in the first (the
    card's) run alone (the forward unchanged), which leaves ``wk`` and
    ``wv`` unmoved there while the CPU's move and the runs part."""
    from repro_torch.launch import train
    from repro_torch.models import attention

    cs = _load()
    kw = XATTN_SMALL["cross_train"]
    calls, step, kv = [], train.train_step, attention.cross_kv

    def counted(*a):
        calls.append(1)
        return step(*a)

    def faulty(p, memory):
        out = kv(p, memory)
        if fault == "zero-memory-gates-shut":
            return {k: v * 0 for k, v in out.items()}
        if len(calls) <= kw["steps"]:
            return {k: v * 0 + v.detach() for k, v in out.items()}
        return out

    if fault == "zero-memory-gates-shut":
        monkeypatch.setattr(cs, "VLM_GATE", 0.0)
    monkeypatch.setattr(train, "train_step", counted)
    monkeypatch.setattr(attention, "cross_kv", faulty)
    # the lost backward shows first in the next step's loss, or else in
    # wk's and wv's moments and updates
    match = ("gate took no grad" if fault == "zero-memory-gates-shut" else
             r"card vs CPU losses|w[kv]('s moments| took no grad)")
    with pytest.raises(AssertionError, match=f"cross train: ({match})"):
        cs.cross_train_card_cpu(torch.device("cpu"), **kw)


def test_xattn_card_runs_take_the_published_shapes():
    """The card's runs: both archs uncut at 4 x 512 into 576, the VLM's
    fp32 check at 8 layers (2 chunks) and its training cut at 4 (1 chunk),
    SeamlessM4T uncut in every run, with the counts the meta device
    gives; the plain Adam timed in pieces that cover its width."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_depth
    from repro_torch.models import build_model
    from repro_torch.models.common import count_params

    cs = _load()
    assert all(kw == dict(layers=None, batch=4, prompt=512, cache=576)
               for kw in cs.XATTN_SERVE.values())
    assert list(cs.XATTN_SERVE) == list(XATTN_ARCHS)
    vlm = get_config("llama-3.2-vision-11b")
    assert vlm.n_patches == 1601
    counts = {}
    for table in (cs.XATTN_FP32, cs.XATTN_TRAIN):
        for arch, kw in table.items():
            cfg = get_config(arch)
            if kw["layers"]:
                assert kw["layers"] % vlm.cross_attn_period == 0
                cfg = cut_depth(cfg, kw["layers"])
            counts[(arch, kw["layers"])] = count_params(
                build_model(cfg).init(device="meta"))
    assert counts == {("llama-3.2-vision-11b", 8): 3_231_797_250,
                      ("llama-3.2-vision-11b", 4): 2_141_237_249,
                      ("seamless-m4t-large-v2", None): 2_034_784_256}
    assert all(kw["steps"] == 3 and kw["seq"] == 1024
               for kw in cs.XATTN_TRAIN.values())
    assert -(-2_141_237_252 // cs.ADAM_PLAIN_PIECE) == 4
    assert [a[1] for a in cs.XATTN_SMOKE_TRAIN] == list(XATTN_ARCHS)


def test_xattn_kernel_entries_take_the_training_steps_widths(monkeypatch):
    """CPU rehearsal: ``fused_adam`` at each centralized step's one lane of
    every param (padded to the kernel's 4), with its run's launches, held
    to its plain version a chunk of columns at a time, the plain version
    timed in pieces that cover the width."""
    cs = _load()
    _stub_entry_timers(cs, monkeypatch)
    monkeypatch.setattr(cs, "ADAM_PLAIN_PIECE", 50_000)
    rec = {"train": {
        "llama-3.2-vision-11b": {"arch": "llama-3.2-vision-11b",
                                 "n_layers": 2, "n_params": 127_425,
                                 "steps": 3, "launches": {"fused_adam": 3}},
        "seamless-m4t-large-v2": {"arch": "seamless-m4t-large-v2",
                                  "n_layers": 4, "n_params": 213_760,
                                  "steps": 3,
                                  "launches": {"fused_adam": 3}}}}
    entries = cs.xattn_kernel_entries(rec, torch.device("cpu"))
    assert [e["name"] for e in entries] == [
        "fused_adam[llama-3.2-vision-11b]", "fused_adam[seamless-m4t-large-v2]"]
    vlm, encdec = entries
    assert vlm["shape"] == {"Kp": 1, "W": 127_428, "active_lanes": 1}
    assert encdec["shape"]["W"] == 213_760
    assert (vlm["plain_pieces"], encdec["plain_pieces"]) == (3, 5)
    assert vlm["plain_ms"] == 3 * 0.5 and encdec["plain_ms"] == 5 * 0.5
    for e in entries:
        assert e["launches"] == 3 and e["max_abs_err"] < 1e-6
        assert set(cs.KERNEL_KEYS) <= set(e)
        assert e["bytes"] == e["shape"]["W"] * 7 * 4 + 4
    assert vlm["launches_run"] == ("xattn phase: llama-3.2-vision-11b (2 "
                                   "layers) launch.train, 3 steps")


def test_xattn_phase_probe_fails_without_a_card():
    """``scripts/xattn_phase_probe.py`` runs only on a card: with none
    visible it exits non-zero and prints no phase line."""
    import os
    proc = subprocess.run([sys.executable, "scripts/xattn_phase_probe.py"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"phase"' not in proc.stdout and "no CUDA card" in proc.stderr


# ------------------------------------------------------------------- launch
def _smoke_fields(arch, **extra):
    import dataclasses

    from repro_torch.configs import get_config

    smoke = get_config(arch, smoke=True)
    out = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
           if f.name != "name"}
    out.update(extra)
    return out


LAUNCH_SMALL = dict(
    cells=(("qwen3-1.7b", "train_4k", dict(global_batch=2, seq_len=16),
            _smoke_fields("qwen3-1.7b", remat=True)),
           ("qwen3-1.7b", "prefill_32k", dict(global_batch=1, seq_len=16),
            _smoke_fields("qwen3-1.7b")),
           ("qwen3-1.7b", "decode_32k", dict(global_batch=2, seq_len=16),
            _smoke_fields("qwen3-1.7b")),
           ("qwen3-1.7b", "fl_round", dict(global_batch=3),
            _smoke_fields("qwen3-1.7b", param_dtype="bfloat16")),
           ("mamba2-370m", "long_500k", {}, _smoke_fields("mamba2-370m"))),
    momentum=dict(shape=(6, 40), steps=3),
    sweep=dict(groups=(("yi-6b",), ("mamba2-370m",)), shapes=["long_500k"],
               extra=("--shape", "long_500k")))


def _launch_rehearsal(cs, monkeypatch, tmp_path, count=True):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    if count:
        _count_plain_calls(monkeypatch)
    return cs.launch_phase(torch.device("cpu"), sweep_dir=str(tmp_path),
                           **LAUNCH_SMALL)


@pytest.mark.usefixtures("one_torch_thread")
def test_launch_phase_on_the_cpu(monkeypatch, capsys, tmp_path):
    """The launch phase's contract at smoke configs: one line a cell
    (the run's FLOPs equal to the meta trace's, the cut named, the train
    step one ``fused_adam``, the bf16 aggregate within one ulp of the
    fp64 sum), the four smoke kinds card against CPU, momentum card
    against CPU with its idle lanes untouched, the meta sweep's children
    joined (a full-attention arch's ``long_500k`` skipped, Mamba2's
    traced), then the phase's line; the sweep's folder removed."""
    cs = _load()
    rec = _launch_rehearsal(cs, monkeypatch, tmp_path)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["phase"] for l in lines] == ["launch_cell"] * 5 + ["launch"]
    cells = {(c["arch"], c["shape"]): c for c in rec["cell_records"]}
    for c in cells.values():
        assert c["flops"] == c["meta_flops"]
        assert c["bound_ms"] > 0 and c["measured_mfu"] > 0
    train = cells[("qwen3-1.7b", "train_4k")]
    assert train["cut"] == {"global_batch": [256, 2], "seq_len": [4096, 16]}
    assert train["launches"]["fused_adam"] == 1
    assert train["kernel_traffic"]["fused_adam"]["launches"] == 1
    agg = cells[("qwen3-1.7b", "fl_round")]["aggregate_check"]
    assert agg["bound_ratio_max"] <= 1.0 and agg["n"] > 0
    assert cells[("qwen3-1.7b", "fl_round")]["flops"] == 0
    assert cells[("mamba2-370m", "long_500k")]["cut"] is None
    assert set(rec["smoke_card_cpu"]["kinds"]) == {"train", "prefill",
                                                   "decode", "flround"}
    assert rec["smoke_card_cpu"]["kinds"]["train"]["fused_adam"] == 1
    mom = rec["momentum"]
    assert mom["idle_untouched"] and mom["lanes_idle"] == 2
    assert mom["params"]["bit_equal"] and mom["m"]["bit_equal"]
    sweep = rec["meta_sweep"]
    assert (sweep["n_ok"], sweep["n_skipped"], sweep["n_error"]) == (1, 1, 0)
    assert sweep["skipped"] == ["yi-6b:long_500k"]
    assert sweep["cells"][0]["probe_depths"] == [4, 8]
    assert not tmp_path.exists()


@pytest.mark.usefixtures("one_torch_thread")
def test_launch_phase_fails_without_its_launches(monkeypatch, tmp_path):
    """On the CPU no kernel launches: uncounted, the train cell's missing
    ``fused_adam`` launch fails the phase before its sweep starts."""
    cs = _load()
    with pytest.raises(AssertionError, match="launches"):
        _launch_rehearsal(cs, monkeypatch, tmp_path, count=False)
    assert list(tmp_path.iterdir()) == []


def test_meta_sweep_join_fails_on_an_error_record(tmp_path):
    """A child whose record is an error exits 1 and fails the sweep; its
    folder is removed all the same."""
    cs = _load()
    with pytest.raises(AssertionError, match="exited 1"):
        cs.meta_sweep(str(tmp_path), groups=(("qwen3-1.7b",),),
                      shapes=["fl_round"], extra=(
                          "--shape", "fl_round", "--variant", "scatter_bf16"))
    assert not tmp_path.exists()
