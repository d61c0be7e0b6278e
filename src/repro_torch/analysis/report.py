"""Render the dry-run and roofline tables (the port of
``repro.analysis.report``).

``python -m repro_torch.analysis.report rows.jsonl`` prints a rows file's
tables: one JSON object per line with ``arch``, ``shape``, ``mesh``,
``ok``, ``roofline`` (a :meth:`~repro_torch.analysis.roofline.Roofline.row`)
and ``memory`` (``peak_gb``).  Rows of the production meshes
(``launch/dryrun.py``'s records) give the §Dry-run table and a roofline
table per mesh, as the reference prints them; rows of one card (mesh
``"1xH100"``, ``chip_smoke.py``'s counted steps) its roofline table.
"""

from __future__ import annotations

import json
import sys

MESH = "1xH100"


def load(path):
    rows = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            key = (r["arch"], r["shape"], r["mesh"])
            rows[key] = r  # last write wins (reruns override)
    return rows


def fmt_seconds(x):
    return f"{x:.2e}"


def roofline_table(rows, mesh=MESH):
    out = [
        "| arch | shape | t_compute (s) | t_memory (s) | t_collective (s) | "
        "bottleneck | MODEL_FLOPS | counted FLOPs | useful ratio | roofline frac | peak GB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (a, s, m), r in sorted(rows.items()):
        if m != mesh or not r.get("ok"):
            continue
        rf = r["roofline"]
        out.append(
            f"| {a} | {s} | {fmt_seconds(rf['t_compute_s'])} | "
            f"{fmt_seconds(rf['t_memory_s'])} | {fmt_seconds(rf['t_collective_s'])} | "
            f"**{rf['bottleneck']}** | {rf['model_flops']:.2e} | {rf['hlo_flops']:.2e} | "
            f"{min(rf['flops_ratio'], 99.0):.3f} | {rf['roofline_fraction']:.4f} | "
            f"{r['memory']['peak_gb']:.1f} |"
        )
    return "\n".join(out)


def dryrun_table(rows):
    out = [
        "| arch | shape | 16x16 | 2x16x16 | peak GB/dev (pod/multi) | collectives/dev GB (pod) "
        "| fake run s |",
        "|---|---|---|---|---|---|---|",
    ]
    pairs = {}
    for (a, s, m), r in rows.items():
        pairs.setdefault((a, s), {})[m] = r
    for (a, s), d in sorted(pairs.items()):
        p = d.get("16x16", {})
        q = d.get("2x16x16", {})
        ok_p = "✓" if p.get("ok") else "✗"
        ok_q = "✓" if q.get("ok") else "✗"
        out.append(
            f"| {a} | {s} | {ok_p} | {ok_q} | "
            f"{p.get('memory', {}).get('peak_gb', float('nan')):.1f} / "
            f"{q.get('memory', {}).get('peak_gb', float('nan')):.1f} | "
            f"{p.get('collective_gb_per_device', 0):.3f} | "
            f"{p.get('compile_s', 0)} |"
        )
    return "\n".join(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro_torch.analysis.report rows.jsonl", file=sys.stderr)
        return 2
    rows = load(argv[0])
    meshes = {m for _, _, m in rows}
    if meshes - {MESH}:
        n_ok = sum(1 for r in rows.values() if r.get("ok"))
        print(f"### Dry-run matrix — {n_ok}/{len(rows)} cells ran\n")
        print(dryrun_table(rows))
        print("\n### Roofline baseline (single-pod 16x16, 256 chips)\n")
        print(roofline_table(rows, "16x16"))
        print("\n### Roofline (multi-pod 2x16x16, 512 chips)\n")
        print(roofline_table(rows, "2x16x16"))
    if MESH in meshes:
        n_ok = sum(1 for r in rows.values() if r.get("ok") and r["mesh"] == MESH)
        print(f"### Roofline (one card, {MESH}) — {n_ok} counted steps\n")
        print(roofline_table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
