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

import torch

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "chip_smoke.py"


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def test_topk_entry_bound_is_the_functions_bytes(monkeypatch):
    """The top-k bound is the function's (read the scores once, write the
    top k; about one comparison per score), not the k-round extraction's
    k*M comparisons, and the launch count is the one passed in with the run
    that counted it. CPU rehearsal: the timers and syncs are stubbed."""
    cs = _load()
    monkeypatch.setattr(cs, "time_ms", lambda fn: (fn(), 0.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    m, k = 1 << 14, 100
    e = cs.topk_kernel_entry("block_topk[x]", m, k, 20, "fleet phase: x",
                             torch.device("cpu"))
    assert e["exact"] and e["max_abs_err"] == 0.0
    assert (e["launches"], e["launches_run"]) == (20, "fleet phase: x")
    assert e["bytes"] == 4 * m + 12 * k
    assert e["bound_by"] == "bytes"
    assert e["bound_ms"] == (4 * m + 12 * k) / cs.HBM_BYTES_PER_S * 1e3


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
