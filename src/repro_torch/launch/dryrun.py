"""Dry run: build every (arch x shape) cell on the production meshes from
meta-device stand-ins and record its shard memory and roofline.

Nothing is allocated and no step runs: the mesh repeats the ``meta``
device, the arguments are meta tensors, and the counts come from their
shapes and partition specs, so no card is needed. Run it as
``PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b
--shape train_4k`` (or ``--all``, ``--mesh both``).

Outputs one JSON per cell under --out (default results/dryrun_torch/),
with the reference's record keys. :data:`REPLACED` lists what the port
computes otherwise than the reference's compiled artifact, and why.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, NamedTuple, Optional

from repro_torch.configs import all_cells
from repro_torch.launch.cells import build_cell, device_bytes
from repro_torch.launch.mesh import MESHES
from repro_torch.roofline.analysis import from_cell


class Replaced(NamedTuple):
    port: Optional[str]   # what stands in its place ("module:name"), if any
    why: str


# reference name ("module:attribute") or record key ("record:key", a
# dotted path into the record; "file:suffix", a file it writes) -> what
# replaces it in the port, and why
REPLACED: Dict[str, Replaced] = {
    "repro.roofline.analysis:from_compiled": Replaced(
        "repro_torch.roofline.analysis:from_cell",
        "eager PyTorch has no compiled module, so no cost_analysis and no "
        "HLO to parse: flops are the cell's model_flops, hbm_bytes every "
        "argument read once, a parameter only where the step reads it (a "
        "serving step's tables at its ids' rows), plus the parameters and "
        "optimizer state written once for a *_train cell, no collective "
        "bytes (one process drives every shard), the peak of the compute "
        "dtype"),
    "repro.launch.dryrun:calibrated_roofline": Replaced(
        None,
        "it removes XLA's habit of counting a scan body once; analytic "
        "counts have no such bias, so roofline_scan_raw = roofline"),
    "repro.launch.cells:lm_family": Replaced(
        "repro_torch.configs:get_arch",
        "nothing calls it in either package; get_arch(arch_id).family == "
        "'lm' says the same"),
    "repro.models.transformer:TransformerConfig.unroll": Replaced(
        None, "its only reader in the reference is the calibration above"),
    "record:memory.argument_bytes": Replaced(
        "repro_torch.launch.cells:device_bytes",
        "the same quantity counted from specs: the bytes of one shard of "
        "args under in_shardings"),
    "record:memory.output_bytes": Replaced(
        "repro_torch.launch.cells:device_bytes",
        "no buffer assignment: a *_train cell's parameters and optimizer "
        "state under out_shardings; null for the other kinds, whose "
        "outputs are small beside their arguments"),
    "record:memory.temp_bytes": Replaced(
        None,
        "null: no buffer assignment; the peak measured on the card stands "
        "in wherever chip_smoke.py runs the cell, and "
        "peak_bytes_per_device is argument + output bytes"),
    "record:compile_s": Replaced(
        None, "no compile: the seconds to build the cell's stand-ins"),
    "record:hlo_lines": Replaced(None, "null: no HLO"),
    "file:.hlo.gz": Replaced(None, "no HLO, so no file"),
}


def _memory(cell, mesh) -> dict:
    args = device_bytes(cell.args, cell.in_shardings, mesh)
    out = (device_bytes(cell.args[:2], cell.out_shardings[:2], mesh)
           if cell.kind.endswith("_train") else None)
    return {"argument_bytes": args, "output_bytes": out, "temp_bytes": None,
            "peak_bytes_per_device": args + (out or 0)}


def run_cell(arch_id: str, shape_name: str, mesh_name: str,
             out_dir: str) -> dict:
    mesh = MESHES[mesh_name]("meta")
    n_chips = mesh.size
    record = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "n_chips": int(n_chips), "status": "unknown",
    }
    t0 = time.time()
    try:
        cell = build_cell(arch_id, shape_name, mesh)
        t_build = time.time() - t0
        roof = from_cell(cell, n_chips)
        record.update(
            status="ok",
            lower_s=0.0,
            compile_s=round(t_build, 2),
            memory=_memory(cell, mesh),
            roofline=roof.to_dict(),
            roofline_scan_raw=roof.to_dict(),
            meta=cell.meta,
            hlo_lines=None,
        )
        print(f"== {arch_id} x {shape_name} x {mesh_name} "
              f"({n_chips} chips) ==")
        print(f"memory: {record['memory']}")
        print("counts: flops=%.3e bytes=%.3e" % (roof.flops,
                                                 roof.hbm_bytes))
        print("roofline:", json.dumps(record["roofline"], indent=None))
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
        print(f"== {arch_id} x {shape_name} x {mesh_name} FAILED: "
              f"{record['error']}")
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch_id}__{shape_name}__{mesh_name}.json".replace("/", "_")
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(record, f, indent=2, default=str)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=list(MESHES) + ["both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    ok = err = 0
    records = []
    for arch_id, shape_name in cells:
        if arch_id is None or shape_name is None:
            raise SystemExit("--arch/--shape required unless --all")
        for mesh_name in meshes:
            rec = run_cell(arch_id, shape_name, mesh_name, args.out)
            records.append(rec)
            ok += rec["status"] == "ok"
            err += rec["status"] != "ok"
    print(f"\nDRYRUN DONE: {ok} ok, {err} failed")
    if err:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
