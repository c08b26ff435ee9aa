"""The port's durable runs (``repro_torch.durability``) against the
reference's (``repro.durability``), and within the port.

Against the reference: for the same ``FLConfig`` and seed the port's
write-ahead journal equals the reference's record for record in ``q``,
``k``, ``t``, ``r``, ``p`` and ``g`` minus ``g["k"]`` (the generator
fingerprint: a JAX PRNG key there, a CRC of the ``torch.Generator`` state
here), the genesis config digest included; the two ``FLConfig`` dataclasses
have the same fields and defaults; and the framing functions agree byte for
byte.

Within the port (the twin of ``tests/test_durability.py`` over
``tests/chaos_harness.py``): a run killed at any journal boundary (every
boundary for Scheduler+columnar and Controller+object, a spread of points
elsewhere, the mid-quarantine and mid-traffic-window boundaries) resumes
to the same journal bytes, history, clock, params and generator state as
its golden run, and leaks nothing; a real SIGKILL of a child process
(``scripts/torch_durable_crash_child.py``) resumes the same way; torn,
garbage and missing files fall back; a config mismatch is refused and a
tampered record is detected; and the knobs (sync policy, snapshot cadence,
the megastep refusal strings, metrics, framing, the off path) behave as
the reference's. Everything runs on the CPU at the reference harness's size
(ProxyCNN, 10 clients, 4 a round, E=1, B=5)."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import journal as jjournal
from repro.core.scheduler import build_engine as jax_build_engine
from repro.core.services import FLConfig as JaxFLConfig
from repro.data.synthetic import make_federated_dataset as jax_dataset
from repro.durability import config_digest as jax_config_digest
from repro.faas.hardware import paper_fleet as jax_fleet
from repro.models.proxy_models import build_bench_model as jax_bench_model
from repro_torch.core.journal import (JOURNAL_NAME, MARKER_KINDS, Journal,
                                      decode_line, encode_event, encode_line)
from repro_torch.core.protocol import ResultLanded
from repro_torch.core.database import ResultRecord
from repro_torch.core.scheduler import build_engine
from repro_torch.core.services import (FLConfig, resolve_durability,
                                       resolve_durability_sync)
from repro_torch.data.synthetic import make_federated_dataset
from repro_torch.durability import (JournalDivergence, SimulatedCrash,
                                    config_digest, find_latest_snapshot,
                                    list_snapshots, resume_durable)
from repro_torch.faas.hardware import paper_fleet
from repro_torch.models.proxy_models import build_bench_model
from test_torch_client_store import one_torch_thread  # noqa: F401
from test_torch_faults import (assert_fleet_consistent, assert_no_leaks,
                               assert_params_equal, chaos_trace, det_fleet,
                               megastep_cfg)
from trace_harness import N_CLIENTS, base_cfg_kw

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "scripts", "torch_durable_crash_child.py")


@pytest.fixture(scope="module")
def data():
    return make_federated_dataset("mnist", n_clients=N_CLIENTS, scale=0.05,
                                  seed=0)


@pytest.fixture(scope="module")
def model():
    return build_bench_model("mnist")


# ------------------------------------------------ harness (port twin)
def durable_cfg(root, **cfg_kw) -> FLConfig:
    """``chaos_harness.durable_cfg``: a journal-armed config at ``root``."""
    kw = dict(cfg_kw)
    kw.setdefault("durability", "journal")
    kw["checkpoint_dir"] = str(root)
    return FLConfig(**kw)


def _fleet(kw, fleet=None):
    return list(fleet) if fleet is not None else \
        list(paper_fleet(kw.get("n_clients", N_CLIENTS)))


def _journal_bytes(root) -> bytes:
    with open(os.path.join(str(root), JOURNAL_NAME), "rb") as f:
        return f.read()


def golden_durable_run(kw, model, data, root, fleet=None):
    """The uncrashed run: (engine, metrics, journal bytes)."""
    eng = build_engine(durable_cfg(root, **kw), model, data,
                       _fleet(kw, fleet), device="cpu")
    m = eng.run()
    return eng, m, _journal_bytes(root)


def crashed_run(kw, model, data, root, k, fleet=None):
    """Kill a durable run right after journal record ``k``."""
    eng = build_engine(durable_cfg(root, **kw), model, data,
                       _fleet(kw, fleet), device="cpu")
    eng.durability.crash_after = k
    with pytest.raises(SimulatedCrash):
        eng.run()


def resumed_run(kw, model, data, root, fleet=None):
    """Resume from ``root`` and run to completion: (engine, metrics,
    journal bytes)."""
    eng = resume_durable(durable_cfg(root, **kw), model, data,
                         _fleet(kw, fleet), device="cpu")
    m = eng.run()
    return eng, m, _journal_bytes(root)


def crash_resume_trace(kw, model, data, root, k, fleet=None):
    crashed_run(kw, model, data, root, k, fleet)
    return resumed_run(kw, model, data, root, fleet)


def assert_resume_identical(gold_eng, gold_m, gold_bytes, eng, m, jbytes):
    """A crashed-and-resumed run is bit-identical to the uncrashed one:
    observable trace, params, generator, simulated clock and the journal
    itself, and leaks nothing."""
    assert chaos_trace(eng) == chaos_trace(gold_eng)
    assert m["history"] == gold_m["history"]
    assert m["total_time"] == gold_m["total_time"]
    assert jbytes == gold_bytes, "resumed journal differs from golden"
    assert_params_equal(eng.params, gold_eng.params)
    assert torch.equal(eng.trainer.generator.get_state(),
                       gold_eng.trainer.generator.get_state())
    if eng.store is not None:
        assert eng.store._free == gold_eng.store._free
    assert_no_leaks(eng)
    assert_fleet_consistent(eng)


def spot_ks(n_records, n_points=5):
    """``chaos_harness.spot_ks``: the first records, the middle, the tail."""
    ks = {1, 2, n_records // 2, n_records - 1, n_records}
    step = max(1, n_records // n_points)
    ks.update(range(1, n_records + 1, step))
    return sorted(k for k in ks if 1 <= k <= n_records)


def run_crash_sweep(kw, model, data, tmp_path, ks=None):
    gold = golden_durable_run(kw, model, data, tmp_path / "golden")
    n_records = gold[1]["journal_records"]
    ks = range(1, n_records + 1) if ks is None else ks
    ks = [k for k in ks if 1 <= k <= n_records]
    for k in ks:
        res = crash_resume_trace(kw, model, data, tmp_path / f"c{k}", k)
        assert_resume_identical(*gold, *res)
    return len(ks)


def _targeted_ks(root, kinds, pad=1):
    """Crash boundaries at (and right after) records of the given kinds."""
    records, _ = Journal.read(os.path.join(str(root), JOURNAL_NAME))
    ks = set()
    for r in records:
        if r["k"] in kinds:
            for d in range(pad + 1):
                ks.add(r["q"] + 1 + d)      # crash_after is 1-based
    return sorted(k for k in ks if 1 <= k <= len(records))


# ------------------------------------------------- against the reference
def _no_gen_key(records):
    out = []
    for r in records:
        r = json.loads(json.dumps(r))
        r["g"].pop("k", None)
        out.append(r)
    return out


@pytest.fixture(scope="module")
def jax_setup():
    return (jax_dataset("mnist", n_clients=N_CLIENTS, scale=0.05, seed=0),
            jax_bench_model("mnist"))


PARITY = {
    "apodotiko": dict(strategy="apodotiko"),
    "fedavg-legacy-object": dict(strategy="fedavg", engine="legacy",
                                 control_plane="object"),
    "scaffold": dict(strategy="scaffold"),
    "blob-plane": dict(strategy="fedavg", update_plane="blob"),
    "hedge": dict(strategy="apodotiko-hedge"),
    "crash-heavy-recovery": dict(strategy="apodotiko",
                                 fault_profile="crash-heavy",
                                 invocation_timeout=40.0, retry_budget=2,
                                 quarantine_threshold=2, quarantine_rounds=2),
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_journal_equals_the_references(name, tmp_path, data, model,
                                       jax_setup):
    kw = base_cfg_kw(**PARITY[name])
    jdata, jmodel = jax_setup
    ref = jax_build_engine(JaxFLConfig(durability="journal",
                                       checkpoint_dir=str(tmp_path / "ref"),
                                       **kw),
                           jmodel, jdata, list(jax_fleet(N_CLIENTS)))
    ref.run()
    _, m, _ = golden_durable_run(kw, model, data, tmp_path / "port")
    want, _ = jjournal.Journal.read(str(tmp_path / "ref" / JOURNAL_NAME))
    got, _ = Journal.read(str(tmp_path / "port" / JOURNAL_NAME))
    assert len(got) == len(want) == m["journal_records"] > 3
    assert _no_gen_key(got) == _no_gen_key(want)
    assert got[0]["k"] == "genesis" and got[-1]["k"] == "run_end"
    assert all(isinstance(r["g"]["k"], int) for r in got
               if r["k"] in ("genesis", "round_close", "run_end"))
    if name == "crash-heavy-recovery":
        kinds = {r["k"] for r in got}
        assert {"InvocationFailed", "InvocationTimedOut"} & kinds


def test_config_fields_digest_and_framing_equal_the_references():
    """The port's ``FLConfig`` has the reference's fields and defaults, so
    the genesis digest is the reference's; the framing functions agree."""
    ours = {f.name: f.default for f in dataclasses.fields(FLConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxFLConfig)}
    assert ours == theirs
    for kw in (dict(), dict(strategy="fedavg", seed=3),
               dict(fault_profile="crash-heavy", rounds=7)):
        assert config_digest(FLConfig(**kw)) == \
            jax_config_digest(JaxFLConfig(**kw))
    # the run's identity (where and how it is journaled) is not hashed
    assert config_digest(FLConfig(checkpoint_dir="a", durability="journal",
                                  durability_sync="event")) == \
        config_digest(FLConfig())
    rec = {"q": 3, "k": "ResultLanded", "t": 1.5, "r": 0,
           "p": {"x": [1, 2]}, "g": {"p": 7}}
    assert encode_line(rec) == jjournal.encode_line(rec)
    assert decode_line(encode_line(rec)[:-1]) == rec
    assert decode_line(b"garbage|0000zzzz") is None
    assert MARKER_KINDS == jjournal.MARKER_KINDS
    ev = ResultLanded(t=2.0, round=1, result=ResultRecord(
        client_id=4, round=1, n_samples=9, train_duration=1.25,
        t_available=2.0))
    kind, payload = encode_event(ev)
    assert kind == "ResultLanded" and "t" not in payload
    assert payload["result"]["client_id"] == 4


def test_a_reference_journal_resumes_in_the_port(tmp_path, data, model,
                                                 jax_setup):
    """Records the reference wrote read in the port: the reader finds the
    same consistent prefix, and its torn-tail repair is the same."""
    kw = base_cfg_kw(strategy="apodotiko")
    jdata, jmodel = jax_setup
    root = tmp_path / "ref"
    jax_build_engine(JaxFLConfig(durability="journal",
                                 checkpoint_dir=str(root), **kw),
                     jmodel, jdata, list(jax_fleet(N_CLIENTS))).run()
    path = str(root / JOURNAL_NAME)
    with open(path, "ab") as f:
        f.write(b'{"q": 99, "torn')
    want = jjournal.Journal.read(path)
    assert Journal.read(path) == want
    assert Journal.truncate_to_consistent(path) == (want[0], True)
    assert os.path.getsize(path) == want[1]


# --------------------------------------------------------------- off path
def test_off_path_draws_nothing_and_matches(tmp_path, data, model):
    """durability=off is the default, constructs nothing, and the
    journal-armed run produces the same observable trace, params and
    generator state."""
    kw = base_cfg_kw(strategy="apodotiko")
    off = build_engine(FLConfig(**kw), model, data, _fleet(kw), device="cpu")
    m_off = off.run()
    assert off.durability is None
    assert m_off["durability"] == "off"
    on, m_on, _ = golden_durable_run(kw, model, data, tmp_path / "on")
    assert chaos_trace(on) == chaos_trace(off)
    assert m_on["history"] == m_off["history"]
    assert m_on["total_time"] == m_off["total_time"]
    assert_params_equal(on.params, off.params)
    assert torch.equal(on.trainer.generator.get_state(),
                       off.trainer.generator.get_state())


def test_resolvers_read_no_environment(monkeypatch):
    monkeypatch.setenv("REPRO_DURABILITY", "journal")
    monkeypatch.setenv("REPRO_DURABILITY_SYNC", "event")
    assert resolve_durability("auto") == "off"
    assert resolve_durability("off") == "off"
    assert resolve_durability("journal") == "journal"
    with pytest.raises(ValueError):
        resolve_durability("bogus")
    assert resolve_durability_sync("auto") == "round"
    assert resolve_durability_sync("event") == "event"
    with pytest.raises(ValueError):
        resolve_durability_sync("bogus")


def test_journal_requires_checkpoint_dir(data, model):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        build_engine(FLConfig(durability="journal",
                              **base_cfg_kw(strategy="fedavg")),
                     model, data, list(paper_fleet(N_CLIENTS)), device="cpu")


# ----------------------------------------- crash-at-every-boundary sweeps
@pytest.mark.parametrize("kw", [
    dict(strategy="apodotiko"),
    dict(strategy="apodotiko", engine="legacy", control_plane="object"),
], ids=["scheduler-columnar", "legacy-object"])
def test_every_boundary(kw, tmp_path, data, model):
    assert run_crash_sweep(base_cfg_kw(**kw), model, data, tmp_path) >= 10


@pytest.mark.parametrize("kw", [
    dict(strategy="fedavg", engine="legacy", eval_every=2),
    dict(strategy="fedavg", update_plane="blob"),
    dict(strategy="apodotiko-hedge"),
    dict(strategy="apodotiko-adaptive"),
    dict(strategy="scaffold"),
    dict(strategy="apodotiko-topk"),
    dict(strategy="fedavg", data_plane="host"),
], ids=["legacy-eval-gap", "blob-plane", "hedge", "adaptive", "scaffold",
        "topk", "host-data-plane"])
def test_spot_boundaries(kw, tmp_path, data, model):
    kw = base_cfg_kw(**kw)
    gold = golden_durable_run(kw, model, data, tmp_path / "golden")
    for k in spot_ks(gold[1]["journal_records"]):
        res = crash_resume_trace(kw, model, data, tmp_path / f"c{k}", k)
        assert_resume_identical(*gold, *res)
        if kw["strategy"] == "scaffold":
            assert torch.equal(res[0].c_global, gold[0].c_global)
            assert torch.equal(res[0].c_buf, gold[0].c_buf)
        if kw["strategy"] == "apodotiko-topk":
            for eng in (res[0], gold[0]):
                eng.db.fleet._flush_device()
            assert torch.equal(res[0].db.fleet._dev.booster,
                               gold[0].db.fleet._dev.booster)


def test_mid_quarantine_crash_points(tmp_path, data, model):
    """Crash while retry timers are armed and quarantines are open: the
    recovery layer's RNG, attempt counts, budget and timer heap survive."""
    kw = base_cfg_kw(strategy="apodotiko", fault_profile="crash-heavy",
                     invocation_timeout=40.0, retry_budget=2,
                     quarantine_threshold=2, quarantine_rounds=2)
    gold = golden_durable_run(kw, model, data, tmp_path / "golden")
    assert gold[1]["n_timeouts"] + gold[1]["n_failures"] > 0
    ks = _targeted_ks(tmp_path / "golden",
                      ("InvocationFailed", "InvocationTimedOut"))
    assert ks, "no failure events to crash at"
    for k in ks:
        res = crash_resume_trace(kw, model, data, tmp_path / f"c{k}", k)
        assert_resume_identical(*gold, *res)


def test_mid_traffic_window_crash_points(tmp_path, data, model):
    """Crash right at membership-shift boundaries: the traffic cursor and
    the bulk join/leave effects replay identically."""
    kw = base_cfg_kw(strategy="apodotiko", traffic_profile="steady-churn",
                     rounds=3)
    gold = golden_durable_run(kw, model, data, tmp_path / "golden")
    ks = _targeted_ks(tmp_path / "golden", ("ClientsJoined", "ClientsLeft"))
    if not ks:          # schedule produced no mid-run churn at this scale
        ks = spot_ks(gold[1]["journal_records"])
    for k in ks:
        res = crash_resume_trace(kw, model, data, tmp_path / f"c{k}", k)
        assert_resume_identical(*gold, *res)


# ------------------------------------------------------ SIGKILL fuzzing
def test_sigkill_subprocess_resume(tmp_path, data, model):
    """A real SIGKILL mid-run (no atexit, no flush beyond os.write), then an
    in-process resume: trace, journal, params and generator match the
    uncrashed golden run."""
    sys.path.insert(0, os.path.dirname(CHILD))
    try:
        from torch_durable_crash_child import child_config, child_setup
    finally:
        sys.path.pop(0)
    c_model, c_data, c_fleet = child_setup()
    gold_dir = tmp_path / "golden"
    gold = build_engine(child_config(str(gold_dir)), c_model, c_data,
                        list(c_fleet), device="cpu")
    gold_m = gold.run()
    gold_bytes = _journal_bytes(gold_dir)
    for k in (3, 6):
        d = tmp_path / f"kill_{k}"
        env = {key: v for key, v in os.environ.items()
               if not key.startswith("REPRO_")}
        env["OMP_NUM_THREADS"] = "1"
        proc = subprocess.run(
            [sys.executable, CHILD, str(d), "--crash-after", str(k),
             "--crash-mode", "sigkill", "--device", "cpu"],
            env=env, capture_output=True, timeout=300)
        assert proc.returncode == -9, (proc.returncode, proc.stderr[-800:])
        records, _ = Journal.read(str(d / JOURNAL_NAME))
        assert len(records) == k, "os.write must persist every record"
        resumed = resume_durable(child_config(str(d)), c_model, c_data,
                                 list(c_fleet), device="cpu")
        m = resumed.run()
        assert m["history"] == gold_m["history"]
        assert m["total_time"] == gold_m["total_time"]
        assert _journal_bytes(d) == gold_bytes
        assert_params_equal(resumed.params, gold.params)
        assert torch.equal(resumed.trainer.generator.get_state(),
                           gold.trainer.generator.get_state())
        assert_no_leaks(resumed)


# --------------------------------------------------- torn-file recovery
def _resume_matches(kw, model, data, d, gold):
    res = resumed_run(kw, model, data, d)
    assert_resume_identical(*gold, *res)
    return res[1]


def test_torn_journal_tail_truncated_to_prefix(tmp_path, data, model):
    kw = base_cfg_kw(strategy="apodotiko")
    gold = golden_durable_run(kw, model, data, tmp_path / "golden")
    d = tmp_path / "crashed"
    crashed_run(kw, model, data, d, 8)
    jpath = d / JOURNAL_NAME
    size = os.path.getsize(jpath)
    with open(jpath, "r+b") as f:        # tear the last record mid-line
        f.truncate(size - 3)
    records, good = Journal.read(str(jpath))
    assert len(records) == 7 and good < size - 3
    _resume_matches(kw, model, data, d, gold)


def test_garbage_journal_tail_truncated(tmp_path, data, model):
    kw = base_cfg_kw(strategy="apodotiko")
    gold = golden_durable_run(kw, model, data, tmp_path / "golden")
    d = tmp_path / "crashed"
    crashed_run(kw, model, data, d, 6)
    with open(d / JOURNAL_NAME, "ab") as f:
        f.write(b'{"q": 6, "half a record and no frame')
    _resume_matches(kw, model, data, d, gold)


def test_corrupt_snapshot_falls_back(tmp_path, data, model):
    """A snapshot with a torn npz fails its manifest CRC and is skipped in
    favour of an older one; the resume replays more of the journal."""
    kw = base_cfg_kw(strategy="apodotiko", rounds=3)
    gold = golden_durable_run(kw, model, data, tmp_path / "golden")
    d = tmp_path / "crashed"
    crashed_run(kw, model, data, d, gold[1]["journal_records"] - 1)
    seqs = list_snapshots(str(d))
    assert len(seqs) >= 2
    target = os.path.join(str(d), f"snap_{seqs[-1]:010d}", "db", "blobs.npz")
    with open(target, "r+b") as f:       # partial npz: truncate mid-file
        f.truncate(max(os.path.getsize(target) // 2, 1))
    assert find_latest_snapshot(str(d)).seq == seqs[-2]
    m = _resume_matches(kw, model, data, d, gold)
    assert m["journal_replayed"] > 0


def test_manifestless_snapshot_ignored(tmp_path, data, model):
    kw = base_cfg_kw(strategy="apodotiko")
    gold = golden_durable_run(kw, model, data, tmp_path / "golden")
    d = tmp_path / "crashed"
    crashed_run(kw, model, data, d, gold[1]["journal_records"] - 1)
    seqs = list_snapshots(str(d))
    os.remove(os.path.join(str(d), f"snap_{seqs[-1]:010d}", "MANIFEST.json"))
    _resume_matches(kw, model, data, d, gold)


def test_resume_with_no_snapshot_replays_from_genesis(tmp_path, data, model):
    kw = base_cfg_kw(strategy="apodotiko")
    gold = golden_durable_run(kw, model, data, tmp_path / "golden")
    d = tmp_path / "crashed"
    crashed_run(kw, model, data, d, 3)        # before the first round close
    assert list_snapshots(str(d)) == []
    m = _resume_matches(kw, model, data, d, gold)
    assert m["journal_replayed"] == 3


# ------------------------------------------------------ guard behaviour
def test_config_mismatch_refused(tmp_path, data, model):
    kw = base_cfg_kw(strategy="apodotiko")
    d = tmp_path / "crashed"
    crashed_run(kw, model, data, d, 5)
    with pytest.raises(ValueError, match="different experiment config"):
        resume_durable(durable_cfg(d, **dict(kw, seed=1)), model, data,
                       list(paper_fleet(N_CLIENTS)), device="cpu")


def test_divergence_detected(tmp_path, data, model):
    """A journal record the replay cannot reproduce (tampered payload,
    valid CRC) aborts the resume instead of silently forking."""
    kw = base_cfg_kw(strategy="apodotiko")
    d = tmp_path / "crashed"
    crashed_run(kw, model, data, d, 7)        # past the first snapshot
    jpath = str(d / JOURNAL_NAME)
    records, _ = Journal.read(jpath)
    assert list_snapshots(str(d)), "need a snapshot so the tail validates"
    records[-1]["t"] += 1.0                   # plausible but wrong
    with open(jpath, "wb") as f:
        for r in records:
            f.write(encode_line(r))
    with pytest.raises(JournalDivergence):
        resume_durable(durable_cfg(d, **kw), model, data,
                       list(paper_fleet(N_CLIENTS)), device="cpu").run()


# ------------------------------------------------- sync/snapshot knobs
def test_sync_policies_same_bytes_different_fsyncs(tmp_path, data, model):
    kw = base_cfg_kw(strategy="fedavg")
    _, m_round, b_round = golden_durable_run(
        dict(kw, durability_sync="round"), model, data, tmp_path / "r")
    _, m_event, b_event = golden_durable_run(
        dict(kw, durability_sync="event"), model, data, tmp_path / "e")
    assert b_round == b_event, "sync policy must not change journal content"
    assert m_event["journal_fsyncs"] >= m_event["journal_records"]
    assert m_round["journal_fsyncs"] < m_round["journal_records"]
    assert (m_round["durability_sync"], m_event["durability_sync"]) == (
        "round", "event")


def test_snap_every_sparse_snapshots(tmp_path, data, model):
    kw = base_cfg_kw(strategy="apodotiko", rounds=4, durability_snap_every=2)
    gold = golden_durable_run(kw, model, data, tmp_path / "golden")
    assert gold[1]["n_snapshots"] == 2
    n = gold[1]["journal_records"]
    for k in (n // 2, n - 1):
        res = crash_resume_trace(kw, model, data, tmp_path / f"c{k}", k)
        assert_resume_identical(*gold, *res)


@pytest.mark.parametrize("knob, reason", [
    ("durability", "durability journal active"),
    ("checkpoint_every", "checkpointing enabled"),
])
def test_megastep_refused_with_the_references_reason(knob, reason, tmp_path,
                                                     data, model):
    """Fused rounds emit no events and pass no round boundary, so a journal
    or a database checkpoint gates fusion off with the reference's reason;
    the run still equals the fused run without the knob (fused ==
    stepwise)."""
    kw = megastep_cfg()
    fleet = det_fleet(N_CLIENTS)
    off = build_engine(FLConfig(**kw), model, data, list(fleet), device="cpu")
    m_off = off.run()
    assert m_off["megastep_rounds"] > 0
    extra = ({"durability": "journal"} if knob == "durability"
             else {"checkpoint_every": 1})
    on = build_engine(FLConfig(**kw, **extra,
                               checkpoint_dir=str(tmp_path / "on")),
                      model, data, list(fleet), device="cpu")
    m_on = on.run()
    assert m_on["megastep_rounds"] == 0
    assert m_on["megastep_fallback_reason"] == reason
    assert m_on["history"] == m_off["history"]
    assert m_on["total_time"] == m_off["total_time"]
    assert_params_equal(on.params, off.params)


def test_metrics_expose_journal_counters(tmp_path, data, model):
    _, m, _ = golden_durable_run(base_cfg_kw(strategy="fedavg"), model, data,
                                 tmp_path)
    assert m["durability"] == "journal"
    assert m["journal_records"] > 0
    assert m["journal_bytes"] > 0
    assert m["n_snapshots"] >= 1
    assert m["journal_replayed"] == 0
    assert m["snapshot_s"] > 0


def test_journal_record_framing(tmp_path, data, model):
    _, m, jbytes = golden_durable_run(base_cfg_kw(strategy="fedavg"),
                                      model, data, tmp_path)
    lines = jbytes.decode().strip().split("\n")
    assert len(lines) == m["journal_records"]
    for i, line in enumerate(lines):
        body, _, crc = line.rpartition("|")
        rec = json.loads(body)
        assert rec["q"] == i
        assert set(rec) == {"q", "k", "t", "r", "p", "g"}
    assert json.loads(lines[0].rpartition("|")[0])["k"] == "genesis"
    assert json.loads(lines[-1].rpartition("|")[0])["k"] == "run_end"


def test_snapshot_restores_params_and_rows_on_the_engines_device(
        tmp_path, data, model):
    """What a snapshot saves comes back as tensors on the engine's device
    (here the CPU), at the saved store capacity and free-list order, the
    live rows at their original ids."""
    kw = base_cfg_kw(strategy="apodotiko", rounds=3)
    gold = golden_durable_run(kw, model, data, tmp_path / "golden")
    d = tmp_path / "crashed"
    crashed_run(kw, model, data, d, gold[1]["journal_records"] - 1)
    eng = resume_durable(durable_cfg(d, **kw), model, data,
                         list(paper_fleet(N_CLIENTS)), device="cpu")
    snap = find_latest_snapshot(str(d))
    with open(os.path.join(snap.path, "runtime.json")) as f:
        state = json.load(f)
    st = state["store"]
    assert eng.store.capacity == st["capacity"]
    assert eng.store._free == st["free"]
    assert sorted(eng.store._live) == sorted(st["ids"])
    assert st["ids"], "the snapshot holds no live row"
    with np.load(os.path.join(snap.path, "rows.npz")) as z:
        np.testing.assert_array_equal(
            eng.store.gather(st["ids"]).numpy(), z["rows"])
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in eng.params.values())
    assert torch.equal(eng.trainer.generator.get_state(), torch.tensor(
        state["trainer_key"], dtype=torch.uint8))
