"""Render the dry run's tables (Markdown) from its JSON records.

Port of `benchmarks/render_experiments.py`, with the card's constants
(`benchmarks.roofline`): arithmetic from the H100's published peaks, not
a measurement.

    PYTHONPATH=src python -m repro_torch.benchmarks.render_experiments \\
        [--dir build/repro_torch/dryrun] [--tag baseline] [--mesh single]
"""

from __future__ import annotations

import argparse

from repro_torch.benchmarks.roofline import (CARD_BYTES, DRYRUN_DIR, HBM_BW,
                                             LINKS, PEAK_FLOPS, load_cells,
                                             roofline_row)


def dryrun_table(cells, mesh):
    print(f"\n### Dry-run ({mesh} mesh)\n")
    print("| arch | shape | layout | mb | lower s | peak GB/card | fits 80G | "
          "wire GB | dot TFLOP/card |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in cells:
        if r["mesh"] != mesh:
            continue
        peak = r.get("per_device_peak_bytes", 0)
        print(f"| {r['arch']} | {r['shape']} | {r.get('layout', '-')} "
              f"| {r.get('microbatches', '-')} "
              f"| {r.get('lower_s', '-')} | {peak / 1e9:.1f} "
              f"| {'Y' if peak <= CARD_BYTES else 'N'} "
              f"| {r.get('total_wire_bytes', 0) / 1e9:.2f} "
              f"| {r.get('dot_flops', 0) / 1e12:.2f} |")


def roofline_table(cells, mesh):
    links = ", ".join(f"{k} {v / 1e9:.0f} GB/s" for k, v in LINKS.items())
    print(f"\n### Roofline ({mesh} mesh; H100: {PEAK_FLOPS / 1e12:.0f} "
          f"TF/s, {HBM_BW / 1e12:.2f} TB/s HBM, {links})\n")
    print("| arch | shape | t_comp ms | t_mem ms | t_coll ms | links | "
          "dominant | useful | roofline frac |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in cells:
        if r["mesh"] != mesh:
            continue
        row = roofline_row(r)
        if not row:
            continue
        print(f"| {row['arch']} | {row['shape']} "
              f"| {row['t_compute_s'] * 1e3:.1f} "
              f"| {row['t_memory_s'] * 1e3:.1f} "
              f"| {row['t_collective_s'] * 1e3:.1f} | {row['links']} "
              f"| {row['dominant']} "
              f"| {row['useful_compute_ratio']:.2f} "
              f"| {row['roofline_fraction']:.3f} |")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--dir", default=DRYRUN_DIR)
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    cells = load_cells(args.dir, args.tag)
    dryrun_table(cells, args.mesh)
    roofline_table(cells, args.mesh)
    if args.mesh == "single":
        dryrun_table(cells, "multi")


if __name__ == "__main__":
    main()
