"""Render the roofline table of counted steps (the port of
``repro.analysis.report``).

``python -m repro_torch.analysis.report rows.jsonl`` prints the
§Roofline markdown table of a rows file: one JSON object per line with
``arch``, ``shape``, ``mesh``, ``ok``, ``roofline`` (a
:meth:`~repro_torch.analysis.roofline.Roofline.row`) and ``memory``
(``peak_gb``).  The port's rows are one card's, mesh ``"1xH100"``.
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


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro_torch.analysis.report rows.jsonl", file=sys.stderr)
        return 2
    rows = load(argv[0])
    n_ok = sum(1 for r in rows.values() if r.get("ok") and r["mesh"] == MESH)
    print(f"### Roofline (one card, {MESH}) — {n_ok} counted steps\n")
    print(roofline_table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
