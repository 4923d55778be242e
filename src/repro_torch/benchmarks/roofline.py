"""Roofline of each dry-run cell on the card (§Roofline deliverable).

Port of `benchmarks/roofline.py`, with the H100's published peaks.  Per
(arch x shape x mesh) cell of `repro_torch.launch.dryrun`'s records:

  compute term    = dot_flops / peak FLOP/s      (per card, every layer,
                                                  microbatch and
                                                  recomputation as run)
  memory term     = dot_bytes / HBM bytes/s      (the matmuls' operands
                                                  and results; else 2 x
                                                  every op's result bytes)
  collective term = wire bytes / link bytes/s    (by the link each
                                                  collective's group rides)

The dominant term is the bottleneck; beside it MODEL_FLOPS / dot_flops
(the useful-compute ratio) and the roofline fraction, model-flops time
over the dominant term's time.

The card's constants: 989 TFLOP/s bf16 dense, 3.35 TB/s of HBM; NVLink at
450 GB/s a direction for a group inside one node of 8 consecutive ranks,
else 50 GB/s a card (400 Gb/s InfiniBand).  Each row names the links that
applied.  These are arithmetic from published peaks, not a measurement.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Mapping, Optional

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
#: bytes/s a card by link: NVLink inside a node, InfiniBand across nodes
#: (`launch.mesh.RecordingMesh` names the link of each collective)
LINKS = {"nvlink": 450e9, "ib": 50e9}
#: device memory of one card
CARD_BYTES = 80e9
#: where `launch.dryrun` writes its records
DRYRUN_DIR = os.path.join("build", "repro_torch", "dryrun")


def load_cells(dryrun_dir: str = DRYRUN_DIR,
               tag: str = "baseline") -> List[Dict]:
    """Every record with ``status`` ok under ``dryrun_dir``."""
    cells = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir,
                                              f"*.{tag}.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("status") == "ok":
            cells.append(r)
    return cells


def roofline_row(rec: Dict, *, peak_flops: float = PEAK_FLOPS,
                 hbm_bw: float = HBM_BW,
                 links: Mapping[str, float] = LINKS,
                 card_bytes: float = CARD_BYTES) -> Optional[Dict]:
    """One cell's terms.  A record without ``wire_bytes_by_link`` (the
    reference's) puts all its wire bytes on the slowest link."""
    if "dot_flops" not in rec:
        return None
    chips = rec["chips"]
    flops = rec["dot_flops"]
    hbm = rec.get("dot_bytes", 0) or 2.0 * rec.get("result_bytes", 0)
    by_link = rec.get("wire_bytes_by_link") or {
        min(links, key=links.get): rec.get("total_wire_bytes", 0.0)}
    t_compute = flops / peak_flops
    t_memory = hbm / hbm_bw
    t_coll = sum(b / links[k] for k, b in by_link.items())
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    model_flops = rec.get("model_flops_global", 0.0) / chips
    useful = model_flops / flops if flops else 0.0
    t_model = model_flops / peak_flops
    frac = t_model / max(terms[dominant], 1e-30)
    peak = rec.get("per_device_peak_bytes", 1 << 62)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "links": "+".join(sorted(k for k, b in by_link.items() if b)) or "-",
        "model_flops_per_chip": model_flops,
        "hlo_flops_per_chip": flops,
        "useful_compute_ratio": useful,
        "roofline_fraction": frac,
        "peak_gb": rec.get("per_device_peak_bytes", 0) / 1e9,
        "fits_80g": peak <= card_bytes,
    }


def table(dryrun_dir: str = DRYRUN_DIR, tag: str = "baseline",
          mesh: str = "single") -> List[Dict]:
    rows = []
    for rec in load_cells(dryrun_dir, tag):
        if rec["mesh"] != mesh:
            continue
        row = roofline_row(rec)
        if row:
            rows.append(row)
    return rows


def run(csv, dryrun_dir: str = DRYRUN_DIR) -> List[Dict]:
    """A row a dry-run cell of the single mesh (none without records)."""
    rows = table(dryrun_dir)
    for r in rows:
        dom_t = r[f"t_{r['dominant']}_s"]
        csv.add(f"roofline.{r['arch']}.{r['shape']}", dom_t * 1e6,
                f"dom={r['dominant']} frac={r['roofline_fraction']:.3f} "
                f"useful={r['useful_compute_ratio']:.2f} "
                f"peak={r['peak_gb']:.1f}GB links={r['links']}")
    return rows
