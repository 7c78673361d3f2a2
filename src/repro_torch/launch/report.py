"""The dry-run, roofline and hill-climb tables (PyTorch port of
``repro/launch/report.py``), from the port's ``results/torch_dryrun.json``,
``results/torch_roofline.json`` and ``results/torch_perf_iterations.json``.

    PYTHONPATH=src python -m repro_torch.launch.report > results/torch_tables.md
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

__all__ = ["fmt_bytes", "dryrun_table", "roofline_table", "perf_table", "main", "ROOT"]

ROOT = Path(__file__).resolve().parents[3]


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def _load(name: str, path: Optional[Path]):
    return json.loads((path or ROOT / "results" / name).read_text())


def dryrun_table(path: Optional[Path] = None) -> str:
    data = _load("torch_dryrun.json", path)
    lines = [
        "| arch | shape | mesh | trace s | flops/dev | bytes/dev | coll bytes/dev | "
        "network bytes/dev | peak mem/dev | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(data):
        r = data[key]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['trace_s']} "
            f"| {r['flops_per_device']:.2e} | {fmt_bytes(r['bytes_per_device'])} "
            f"| {fmt_bytes(r['collectives']['total_bytes'])} "
            f"| {fmt_bytes(r['collectives']['by_link']['network'])} "
            f"| {fmt_bytes(r['peak_bytes'])} | {'yes' if r['fits'] else 'NO'} |"
        )
    n = len(data)
    return f"{n} cells, every step traced.\n\n" + "\n".join(lines)


def roofline_table(path: Optional[Path] = None) -> str:
    data = _load("torch_roofline.json", path)
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | useful-FLOPs frac |",
        "|---|---|---|---|---|---|---|",
    ]
    for key in sorted(data):
        r = data[key]
        uf = r.get("useful_flops_fraction")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} "
            f"| {r['memory_s']:.4f} | {r['collective_s']:.4f} "
            f"| **{r['dominant']}** | {uf:.3f} |" if uf else
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} "
            f"| {r['memory_s']:.4f} | {r['collective_s']:.4f} "
            f"| **{r['dominant']}** | - |"
        )
    return "\n".join(lines)


def perf_table(path: Optional[Path] = None) -> str:
    data = _load("torch_perf_iterations.json", path)
    out = []
    for cell in sorted(data):
        out.append(f"\n### {cell}\n")
        out.append("| step | compute s | memory s | collective s | dominant | useful |")
        out.append("|---|---|---|---|---|---|")
        for e in data[cell]:
            uf = e.get("useful_flops_fraction") or 0
            out.append(
                f"| {e['step']} | {e['compute_s']:.3f} | {e['memory_s']:.3f} "
                f"| {e['collective_s']:.3f} | {e['dominant']} | {uf:.3f} |"
            )
    return "\n".join(out)


def main() -> None:
    print("## Dry-run table\n")
    try:
        print(dryrun_table())
    except FileNotFoundError:
        print("(results/torch_dryrun.json missing — run repro_torch.launch.dryrun)")
    print("\n## Roofline table\n")
    try:
        print(roofline_table())
    except FileNotFoundError:
        print("(results/torch_roofline.json missing — run repro_torch.launch.roofline_run)")
    print("\n## Perf iterations (hillclimb)\n")
    try:
        print(perf_table())
    except FileNotFoundError:
        print("(results/torch_perf_iterations.json missing — run repro_torch.launch.hillclimb)")


if __name__ == "__main__":
    main()
