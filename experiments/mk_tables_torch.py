"""Regenerate the dry-run tables of the PyTorch port from its records.

    PYTHONPATH=src python experiments/mk_tables_torch.py

Reads ``experiments/dryrun_torch/*.json`` (written by
``python -m repro_torch.launch.dryrun``) and prints the tables of
``experiments/mk_tables.py``: the baseline roofline of every ok cell on
the single pod (16x16) and the multi-pod (2x16x16) mesh, the skipped
cells of the single pod with their reasons, and the variant measurements
(records named ``arch__shape__mesh__variant.json``, and q8-state records
under ``experiments/dryrun_torch_q8*/``) where any exist.  It reads
files only and needs no device.
"""

import argparse
import glob
import json
import os
from typing import List, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
RECORDS = os.path.join(HERE, "dryrun_torch")
MESHES = ("pod16x16", "pod2x16x16")


def fmt(recs, mesh, md) -> int:
    """Append the baseline table of ``mesh``'s ok records to ``md``;
    returns the number of rows."""
    md.append("| arch | shape | comp (ms) | mem (ms) | coll (ms) | dominant "
              "| MODEL/HLO | GiB/dev |")
    md.append("|---|---|---:|---:|---:|---|---:|---:|")
    n = 0
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if r["status"] != "ok" or r["mesh"] != mesh:
            continue
        rf = r["roofline"]
        u = rf["useful_ratio"]
        md.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']*1e3:.1f} "
            f"| {rf['memory_s']*1e3:.1f} | {rf['collective_s']*1e3:.1f} "
            f"| **{rf['dominant']}** | {u:.2f} "
            f"| {r['per_device_bytes']/2**30:.1f} |")
        n += 1
    return n


def main(argv: Optional[Sequence[str]] = None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]) \
        .parse_args(argv)
    # baseline vs variant records by the file name's convention
    base, variants = [], []
    for p in sorted(glob.glob(os.path.join(RECORDS, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        name = os.path.basename(p)
        if name.count("__") >= 3:
            r["variant"] = name.split("__")[3].replace(".json", "")
            variants.append(r)
        else:
            r["variant"] = "baseline"
            base.append(r)

    md: List[str] = ["<!-- generated by experiments/mk_tables_torch.py -->",
                     ""]
    ok = {}
    md.append("### Single-pod (16x16 = 256 chips) baseline roofline, all "
              "runnable cells")
    md.append("")
    ok[MESHES[0]] = fmt(base, MESHES[0], md)
    md.append("")
    md.append("### Multi-pod (2x16x16 = 512 chips) — compile proof + terms")
    md.append("")
    ok[MESHES[1]] = fmt(base, MESHES[1], md)
    md.append("")
    md.append("### Skipped cells (documented, per assignment)")
    md.append("")
    skipped = [r for r in base
               if r["status"] == "skip" and r["mesh"] == MESHES[0]]
    for r in skipped:
        md.append(f"- {r['arch']} / {r['shape']}: {r['why']}")
    md.append("")
    rows = []
    for r in variants:
        if r["status"] != "ok":
            continue
        rf = r["roofline"]
        rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                    f"| {r['variant']} | {rf['compute_s']*1e3:.1f} "
                    f"| {rf['memory_s']*1e3:.1f} "
                    f"| {rf['collective_s']*1e3:.1f} | {rf['dominant']} "
                    f"| {r['per_device_bytes']/2**30:.1f} |")
    for p in sorted(glob.glob(os.path.join(HERE, "dryrun_torch_q8*",
                                           "*.json"))):
        with open(p) as f:
            r = json.load(f)
        if r["status"] != "ok":
            continue
        rf = r["roofline"]
        tag = "q8-state" + ("+moe_ep" if "moe_ep" in p else "")
        args = r["memory"].get("argument_size_in_bytes", 0)/2**30
        rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {tag} "
                    f"| {rf['compute_s']*1e3:.1f} | {rf['memory_s']*1e3:.1f} "
                    f"| {rf['collective_s']*1e3:.1f} | {rf['dominant']} "
                    f"| {r['per_device_bytes']/2**30:.1f} (args {args:.1f}) |")
    md.append("### Variant (hillclimb) measurements")
    md.append("")
    md.append("| arch | shape | mesh | variant | comp | mem | coll (ms) "
              "| dom | GiB/dev |")
    md.append("|---|---|---|---|---:|---:|---:|---|---:|")
    md.extend(rows)
    text = "\n".join(md)
    print(text)
    return dict(markdown=text, ok_rows=ok,
                skipped=[(r["arch"], r["shape"], r["why"]) for r in skipped],
                variant_rows=len(rows))


if __name__ == "__main__":
    main()
