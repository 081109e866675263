"""Summarize the campaign's records into a paired table (the twin of the JAX
tool ``tools/quality_campaign_report.py``).

    python -m salience_detr_torch.tools.quality_campaign_report [RECORDS.jsonl]

Reads the lines ``tools/quality_campaign.py`` appends (by default
``docs/quality_torch_h100.jsonl``; one a run: variant,
seed, AP curve, and for a hybrid run the int8 overlay's curve) and prints,
as the JAX tool does, per seed the final AP of exact and hybrid sampling,
the hybrid's int8-overlay AP and the paired deltas, their means, then the
other variants of the same seed against bf16 hybrid ResNet-18 (fp16, the
ResNet-50 backbone), and every run's AP curve.

What differs from the JAX tool: a run is keyed by its variant, mixed
precision and backbone (the JAX tool keys by variant and seed, so the port's
fp16 and ResNet-50 hybrids would overwrite the bf16 hybrid); the extra
variants' table; and every variant run with a single seed says "one seed"
beside its curve (its AP gaps to the others are single draws: no spread is
known); a curve's points name their step in full (the JAX tool prints
``step // 1000`` thousands, so 1500 reads "1k").  On lines in the JAX
tool's format (no precision or backbone) the paired table and its means are
the JAX tool's, line for line.  Imports the standard library only."""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

RECORDS = Path(__file__).resolve().parents[2] / "docs" / "quality_torch_h100.jsonl"
BASE = ("bf16", "resnet18")  # the precision and backbone of the paired exact / hybrid rows


def label(r: Dict) -> Tuple[str, str, str]:
    return r["variant"], r.get("mixed_precision") or BASE[0], r.get("backbone") or BASE[1]


def name(key: Tuple[str, str, str]) -> str:
    variant, precision, backbone = key
    extras = [x for x, base in zip((precision, backbone), BASE) if x != base]
    return " ".join([variant, *extras])


def load(path: str) -> Dict[Tuple[Tuple[str, str, str], int], Dict]:
    runs = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                r = json.loads(line)
                runs[(label(r), r["seed"])] = r
    return runs


def final_ap(r) -> float:
    return r["curve"][-1]["ap"] if r else float("nan")


def report(path: str) -> List[str]:
    runs = load(path)
    out: List[str] = []
    seeds = sorted({s for (_, s) in runs})
    exact_key, hybrid_key = ("exact", *BASE), ("hybrid", *BASE)
    out.append(f"{len(runs)} runs, seeds {seeds}")
    out.append(f"{'seed':>4} {'exact AP':>9} {'hybrid AP':>9} {'h-e delta':>9} "
               f"{'int8 AP':>8} {'i8-h delta':>10} {'steps':>6}")
    deltas, i8deltas = [], []
    for s in seeds:
        e, h = runs.get((exact_key, s)), runs.get((hybrid_key, s))
        e_ap, h_ap = final_ap(e), final_ap(h)
        i8 = (h or {}).get("int8_curve")
        i8_ap = i8[-1]["ap"] if i8 else float("nan")
        d = h_ap - e_ap if e and h else float("nan")
        d8 = i8_ap - h_ap if i8 else float("nan")
        if d == d:
            deltas.append(d)
        if d8 == d8:
            i8deltas.append(d8)
        steps = (h or e or {}).get("steps", "?")
        out.append(f"{s:>4} {e_ap:>9.3f} {h_ap:>9.3f} {d:>+9.3f} {i8_ap:>8.3f} {d8:>+10.3f} {steps:>6}")
    if deltas:
        out.append("")
        out.append(f"mean hybrid-exact delta: {sum(deltas)/len(deltas):+.4f} over {len(deltas)} paired seeds")
    if i8deltas:
        out.append(f"mean int8-bf16 eval delta: {sum(i8deltas)/len(i8deltas):+.4f}")

    n_seeds = defaultdict(set)
    for key, s in runs:
        n_seeds[key].add(s)
    others = sorted({k for (k, _) in runs} - {exact_key, hybrid_key})
    if others:
        out.append("")
        out.append("other variants against bf16 hybrid resnet18 of the same seed:")
        for key in others:
            for s in seeds:
                r, h = runs.get((key, s)), runs.get((hybrid_key, s))
                if r:
                    delta = f"{final_ap(r) - final_ap(h):+.3f}" if h else "no hybrid run"
                    single = "; one seed" if len(n_seeds[key]) == 1 else ""
                    out.append(f"  {name(key):>22} s{s}: AP {final_ap(r):.3f} ({delta}{single})")
    out.append("")
    out.append("AP curves:")
    for (key, s), r in sorted(runs.items()):
        curve = " ".join(f"{p['step']}:{p['ap']:.3f}" for p in r["curve"])
        single = "; one seed" if len(n_seeds[key]) == 1 else ""
        out.append(f"  {name(key):>22} s{s}: {curve}  (train {r.get('img_s', '?')} img/s{single})")
        if r.get("int8_curve"):
            curve = " ".join(f"{p['step']}:{p['ap']:.3f}" for p in r["int8_curve"])
            out.append(f"  {name(key) + ' int8':>22} s{s}: {curve}  (the eval overlay{single})")
    return out


def main(argv=None) -> List[str]:
    argv = sys.argv[1:] if argv is None else argv
    lines = report(argv[0] if argv else str(RECORDS))
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
