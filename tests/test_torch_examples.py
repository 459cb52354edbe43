"""The port's streaming, observability, recsys retrieval and LM training
examples, run on the CPU (the first two at a small size) as
``tests/test_torch_pipeline.py`` runs ``examples/async_serving_torch.py``:
each exits 0 and prints what its reference prints. One intra-op thread: the examples' threads and the
test workers would oversubscribe the CPU."""

import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(name, *args, **env_extra):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", **env_extra}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         *args], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_streaming_catalog_example_runs_on_cpu():
    """Six rounds of inserts, deletes and updates, every mid-stream query
    exact against a dense dump of the live rows, compactions without an
    engine compile."""
    out = _run("streaming_catalog_torch.py", "--targets", "4000")
    assert out.count("exact=True") == 6 and "exact=False" not in out
    assert "engine compiles per compaction: 0" in out
    assert "every mid-stream query matched a fresh full rebuild" in out


def test_observability_example_runs_on_cpu():
    """The span tree, the Prometheus excerpt, the journal with the failed
    then retried compaction, and a snapshot that validates."""
    out = _run("observability_torch.py", "--targets", "2000")
    assert "=== slowest request (span tree) ===" in out
    assert "repro_queries_total" in out
    assert "fault.fired point=compaction.build" in out
    assert "compaction.fail" in out and "compaction.success" in out
    assert "metrics snapshot validates against the checked-in schema" in out


def test_recsys_retrieval_example_runs_on_cpu():
    """DeepFM-demo trained for 150 steps through ``Trainer`` (its loss
    falls), the exact top-100 of 20,000 candidates through ``bta`` equal
    to ``naive``'s, re-ranked to 5 items for each of 4 queries."""
    out = _run("recsys_retrieval_torch.py")
    line = next(x for x in out.splitlines() if x.startswith("DeepFM"))
    first, last = (float(v) for v in
                   line.split("loss ")[1].split(" (")[0].split(" -> "))
    assert last < first
    assert "bta's top-100 equals naive's: True" in out
    assert sum(x.strip().startswith("query ") for x in out.splitlines()) \
        == 4


def test_train_lm_example_runs_on_cpu():
    """The tiny LM trained for 3 steps through ``Trainer`` (its losses
    finite; its checkpoint in a fresh temporary directory, here under a
    ``TMPDIR`` the test removes), then 8 greedy tokens through the exact
    top-8 head."""
    with tempfile.TemporaryDirectory() as tmp:
        out = _run("train_lm_torch.py", "--tiny", "--steps", "3", TMPDIR=tmp)
        ckpt = next(x for x in out.splitlines() if x.startswith("trained"))
        assert ckpt.split("checkpoints in ")[1].startswith(tmp)
        assert os.listdir(ckpt.split("checkpoints in ")[1]) == \
            ["step_0000000003"]
    assert "model: lm-tiny, " in out
    first, last = (float(v) for v in
                   ckpt.split("loss ")[1].split(";")[0].split(" -> "))
    assert math.isfinite(first) and math.isfinite(last)
    ids = out.split("last top-8 ids: ")[1].strip()
    assert len(json.loads(ids)) == 8
