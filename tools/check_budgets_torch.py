"""Line-rate budget gate for the PyTorch port's stock operator suite.

Certifies every stock operator in ``repro_torch/core/operators.py`` (the
paper's workload suite) with ``repro_torch.core.wcet.certify`` via a
fresh ``verify()`` and enforces the two contracts of
``tools/check_budgets.py``:

  * **Budget admission** — every stock operator must certify within
    ``wcet.DEFAULT_BUDGET``.  A violation here means a stock workload
    would be *rejected at registration*.
  * **Certificate ratchet** — each operator's certified worst case must
    not grow past the committed snapshot in ``tools/wcet_baseline.json``:
    a bigger ``wcet_cycles`` / ``wire_bytes`` / ``memcpy_bytes`` /
    ``wcet_latency_us`` fails the gate; smaller values are reported.

The port's certificates are held to the same baseline as the reference
package's: the port's ``operators``, ``wcet``, ``program`` and
``verifier`` are copies, so any difference from the baseline is a parity
fault of a copy, to be repaired in the port.  This tool reads the
baseline and never writes it (``tools/check_budgets.py
--write-baseline`` owns it).  It needs no device: certification is host
code.

Usage:  python tools/check_budgets_torch.py
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import operators, wcet          # noqa: E402
from repro_torch.core.program import TiaraProgram     # noqa: E402
from repro_torch.core.verifier import verify          # noqa: E402

BASELINE = Path(__file__).resolve().parent / "wcet_baseline.json"

# the ratcheted certificate fields: sound worst-case figures that must
# only shrink (or hold) as the suite evolves
_RATCHETED = ("wcet_cycles", "wcet_latency_us", "wire_bytes",
              "memcpy_bytes", "words_read", "words_written")


def stock_programs() -> List[Tuple[str, TiaraProgram, object]]:
    """(name, program, region table) for every stock operator, built at
    each workload's default shape — the shapes the tests and benches
    register."""
    out: List[Tuple[str, TiaraProgram, object]] = []
    specs = [
        ("graph_walk", operators.GraphWalk()),
        ("page_table_walk", operators.PageTableWalk()),
        ("dist_lock", operators.DistLock()),
        ("paged_kv_fetch", operators.PagedKVFetch()),
        ("moe_expert_gather", operators.MoEExpertGather()),
        ("nsa_select", operators.NSASelect()),
    ]
    for name, w in specs:
        rt = w.regions()
        out.append((name, w.build(rt), rt))
    ptw = operators.PageTableWalk()
    rt = ptw.regions()
    out.append(("page_table_walk/translate_only",
                ptw.build_translate_only(rt), rt))
    return out


def certify_all() -> Dict[str, Dict[str, float]]:
    certs: Dict[str, Dict[str, float]] = {}
    for name, prog, rt in stock_programs():
        vop = verify(prog, regions=rt)
        cert = vop.certificate
        if cert is None:
            raise AssertionError(f"{name}: verify() gave no certificate")
        certs[name] = {k: float(getattr(cert, k)) for k in _RATCHETED}
        certs[name]["bottleneck"] = cert.bottleneck  # type: ignore[assignment]
    return certs


def main(argv: Optional[Sequence[str]] = None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]) \
        .parse_args(argv)

    fails: List[str] = []
    shrinkable: List[str] = []
    certs = certify_all()

    # contract 1: every stock operator fits the default budget
    for name, prog, rt in stock_programs():
        vop = verify(prog, regions=rt)
        if vop.certificate is None:
            raise AssertionError(f"{name}: verify() gave no certificate")
        for v in wcet.DEFAULT_BUDGET.violations(vop.certificate):
            fails.append(f"{name}: over budget: {v}")

    # contract 2: shrink-only vs the committed baseline
    if not BASELINE.exists():
        fails.append(f"{BASELINE.name} missing — run "
                     f"tools/check_budgets.py --write-baseline and commit "
                     f"it")
        base: Dict[str, Dict[str, float]] = {}
    else:
        base = json.loads(BASELINE.read_text())
    for name, cur in certs.items():
        b = base.get(name)
        if b is None:
            if base:
                fails.append(f"{name}: new stock operator not in "
                             f"{BASELINE.name} — regenerate the baseline")
            continue
        for k in _RATCHETED:
            bv, cv = float(b[k]), float(cur[k])
            if cv > bv:
                fails.append(
                    f"{name}: certified {k} grew {bv:.0f} -> {cv:.0f} "
                    f"(shrink-only ratchet; if intentional, regenerate "
                    f"{BASELINE.name} and justify in the PR)")
            elif cv < bv:
                shrinkable.append(f"{name}.{k}: {bv:.0f} -> {cv:.0f}")
    for name in base:
        if name not in certs:
            fails.append(f"{name}: in {BASELINE.name} but no longer a "
                         f"stock operator — regenerate the baseline")

    if shrinkable:
        print("certificates shrank — regenerate the baseline to ratchet:")
        for s in shrinkable:
            print(f"  {s}")
    if fails:
        print(f"{len(fails)} budget/ratchet failure(s):")
        for f in fails:
            print(f"  {f}")
        print("::error::line-rate budget gate failed")
        return 1
    print(f"budget gate passed ({len(certs)} stock operators within "
          f"DEFAULT_BUDGET, ratchet held)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
