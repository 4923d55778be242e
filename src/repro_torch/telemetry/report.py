"""Render a telemetry JSONL capture:
``python -m repro_torch.telemetry.report CAPTURE``.

Port of `repro.telemetry.report`.

Three sections — event counts with numeric-field aggregates (a replayed
:class:`~repro_torch.telemetry.core.Counters` sink), the cost-model drift table
(`telemetry.drift.summarize`), and the proposed `HardwareSpec` correction
(`fit_spec_update`) when any selector tier shows enough drift samples.
``--json`` emits the same content as one machine-readable object.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from repro_torch.telemetry import drift as drift_lib
from repro_torch.telemetry.core import Counters, read_jsonl


def build_report(events: List[Dict[str, Any]], *, spec=None,
                 fit: bool = True) -> Dict[str, Any]:
    """The report as data: ``{events: Counters.summary(), drift: [rows],
    spec_update: {field: {...}}}`` — the JSON the CLI prints/renders."""
    counters = Counters()
    for ev in events:
        counters.emit(ev)
    stats = drift_lib.aggregate(events)
    out: Dict[str, Any] = {"n_events": len(events),
                           "events": counters.summary(),
                           "drift": drift_lib.summarize(stats),
                           "contention": _contention_rows(events),
                           "analysis": _analysis_rows(events)}
    if fit:
        fitted = drift_lib.fit_spec_update(stats, spec)
        out["spec_update"] = fitted["fields"]
        out["spec_update_skipped"] = fitted["skipped"]
    return out


def _contention_rows(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """``contention.stats`` events (the `collect_stats=` observatory)
    aggregated by (tier, op): batch count, mean distinct slots, the worst
    max-occupancy, the summed log2-bucket occupancy histogram, the hottest
    slots merged across batches, and per-exchange-level combining
    efficiency (total ops in vs representatives out)."""
    agg: Dict[tuple, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("event") != "contention.stats":
            continue
        key = (str(ev.get("tier")), str(ev.get("op")))
        a = agg.setdefault(key, {
            "tier": key[0], "op": key[1], "batches": 0, "n_ops": 0,
            "distinct_sum": 0, "max_occupancy": 0, "occupancy_hist": [],
            "hot": {}, "level_ops_in": [], "level_ops_out": []})
        a["batches"] += 1
        a["n_ops"] += int(ev.get("n_ops") or 0)
        a["distinct_sum"] += int(ev.get("distinct_slots") or 0)
        a["max_occupancy"] = max(a["max_occupancy"],
                                 int(ev.get("max_occupancy") or 0))
        hist = [int(h) for h in (ev.get("occupancy_hist") or [])]
        if len(hist) > len(a["occupancy_hist"]):
            a["occupancy_hist"] += [0] * (len(hist) - len(a["occupancy_hist"]))
        for i, h in enumerate(hist):
            a["occupancy_hist"][i] += h
        for s, c in zip(ev.get("topk_slots") or [],
                        ev.get("topk_counts") or []):
            if int(s) >= 0:
                a["hot"][int(s)] = max(a["hot"].get(int(s), 0), int(c))
        for fld in ("level_ops_in", "level_ops_out"):
            lv = [int(x) for x in (ev.get(fld) or [])]
            if len(lv) > len(a[fld]):
                a[fld] += [0] * (len(lv) - len(a[fld]))
            for i, x in enumerate(lv):
                a[fld][i] += x
    rows = []
    for a in agg.values():
        hot = sorted(a.pop("hot").items(), key=lambda kv: -kv[1])[:8]
        a["mean_distinct"] = round(a.pop("distinct_sum")
                                   / max(1, a["batches"]), 1)
        a["hot_slots"] = [{"slot": s, "count": c} for s, c in hot]
        a["level_efficiency"] = [
            round(o / i, 4) if i else None
            for i, o in zip(a["level_ops_in"], a["level_ops_out"])]
        rows.append(a)
    rows.sort(key=lambda r: (r["tier"], r["op"]))
    return rows


def _analysis_rows(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """``analysis.finding`` events -> lint-result rows (both packages'
    contract linters write them)."""
    rows = []
    for ev in events:
        if ev.get("event") != "analysis.finding":
            continue
        rows.append({k: ev.get(k) for k in
                     ("rule", "severity", "file", "line", "entry",
                      "suppressed", "message")})
    return rows


def _fmt_s(v: float) -> str:
    if v != v:                       # NaN
        return "-"
    for unit, scale in (("s", 1.0), ("ms", 1e-3), ("us", 1e-6)):
        if abs(v) >= scale:
            return f"{v / scale:.3g}{unit}"
    return f"{v / 1e-9:.3g}ns"


def render_text(report: Dict[str, Any]) -> str:
    lines = [f"telemetry report — {report['n_events']} events", ""]
    lines.append(f"{'event':<28}{'count':>8}  numeric fields (mean)")
    for name in sorted(report["events"]):
        info = report["events"][name]
        means = "  ".join(
            f"{k}={_fmt_s(v['mean']) if k.endswith('_s') else round(v['mean'], 3)}"
            for k, v in sorted(info["fields"].items()))
        lines.append(f"{name:<28}{info['count']:>8}  {means}")
    rows = report["drift"]
    lines += ["", "cost-model drift (measured / predicted, geometric mean)"]
    if rows:
        lines.append(f"{'tier':<11}{'choice':<14}{'op':<6}{'size':<7}"
                     f"{'n':>5}{'ratio':>10}{'min':>10}{'max':>10}"
                     f"{'pred':>9}{'meas':>9}")
        for r in rows:
            lines.append(
                f"{r['tier']:<11}{r['choice']:<14}{r['op']:<6}"
                f"{r['size_bucket']:<7}{r['n']:>5}{r['ratio']:>10.3g}"
                f"{r['min_ratio']:>10.3g}{r['max_ratio']:>10.3g}"
                f"{_fmt_s(r['mean_predicted_s']):>9}"
                f"{_fmt_s(r['mean_measured_s']):>9}")
    else:
        lines.append("  (no (predicted_s, measured_s) pairs in the capture)")
    cont = report.get("contention") or []
    lines += ["", "contention (contention.stats events, collect_stats=)"]
    if cont:
        lines.append(f"{'tier':<11}{'op':<6}{'batches':>8}{'ops':>8}"
                     f"{'distinct':>9}{'max_occ':>8}  occupancy 2^k hist"
                     f" | hot slots | level in->out")
        for r in cont:
            hist = r["occupancy_hist"]
            top = max((i for i, h in enumerate(hist) if h), default=0)
            hist_s = " ".join(str(h) for h in hist[:top + 1])
            hot_s = ",".join(f"{h['slot']}x{h['count']}"
                             for h in r["hot_slots"][:4]) or "-"
            lvl_s = " ".join(
                f"{i}->{o}" for i, o in zip(r["level_ops_in"],
                                            r["level_ops_out"])) or "-"
            lines.append(
                f"{r['tier']:<11}{r['op']:<6}{r['batches']:>8}"
                f"{r['n_ops']:>8}{r['mean_distinct']:>9}"
                f"{r['max_occupancy']:>8}  [{hist_s}] | {hot_s} | {lvl_s}")
    else:
        lines.append("  (no contention.stats events in the capture)")
    lint = report.get("analysis") or []
    lines += ["", "static analysis (analysis.finding events)"]
    if lint:
        for r in lint:
            where = (f"{r['file']}:{r['line']}" if r.get("file")
                     else "<unknown>")
            sup = " [suppressed]" if r.get("suppressed") else ""
            entry = f" [{r['entry']}]" if r.get("entry") else ""
            sev = (r.get("severity") or "?").upper()
            lines.append(f"  {where}: {sev} {r.get('rule')}{sup}{entry}")
    else:
        lines.append("  (no analysis.finding events in the capture)")
    upd = report.get("spec_update") or {}
    lines += ["", "proposed HardwareSpec correction (fit_spec_update)"]
    if upd:
        for name, f in sorted(upd.items()):
            lines.append(f"  {name}: {f['current']:.3g} -> "
                         f"{f['proposed']:.3g}  (drift x{f['ratio']:.2f}, "
                         f"n={f['n']})")
    else:
        lines.append("  (not enough drift samples)")
    skipped = report.get("spec_update_skipped") or {}
    if skipped:
        # no silent caps: fields with drift evidence below their sample
        # floor are listed, not dropped
        for name, s in sorted(skipped.items()):
            why = s.get("reason") or (f"n={s['n']} < "
                                      f"min_samples={s['min_samples']}")
            lines.append(f"  {name}: skipped ({why})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report",
        description="Render a repro_torch.telemetry JSONL capture.")
    ap.add_argument("capture", help="JSONL file written by JsonlWriter "
                                    "(e.g. REPRO_TELEMETRY=out.jsonl)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as one JSON object")
    ap.add_argument("--no-fit", action="store_true",
                    help="skip the HardwareSpec correction section")
    args = ap.parse_args(argv)
    events = read_jsonl(args.capture)
    report = build_report(events, fit=not args.no_fit)
    if args.json:
        json.dump(report, sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        print(render_text(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
