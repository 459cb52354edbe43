"""The port's streaming, observability and recsys retrieval examples, run
on the CPU (the first two at a small size) as
``tests/test_torch_pipeline.py`` runs ``examples/async_serving_torch.py``:
each exits 0 and prints what its reference prints. One intra-op thread: the examples' threads and the
test workers would oversubscribe the CPU."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(name, *args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
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
