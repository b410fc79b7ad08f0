"""Regenerate the port's robustness table in README.md from
artifacts/ate_clone_*_torch.json (the counterpart of
examples/make_readme_table.py): one row a profile with its conditions, the
outcome, the post-init ATE, the loops closed and the frame rate with the
card it was measured on. The table replaces the one after the
`<!-- ROBUSTNESS_TABLE_TORCH -->` marker; the JAX package's table after its
own marker is left alone.

    python3 -m mc_slam_tpu_torch.tools.make_readme_table [--readme README.md]
        [--artifacts artifacts]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

MARKER = "<!-- ROBUSTNESS_TABLE_TORCH -->"
PROFILES = [
    ("euroc", "baseline circuit, 120 s, full texture"),
    ("loopdemo", "euroc with drift injected over 20-50 s after VI init, loop closing on"),
    ("loopdemo_noloops", "the same with loop closing off"),
    ("mid", "baseline circuit, 768 features, 4 levels, 8192 points"),
    ("small", "baseline circuit, 512 features, 3 levels, 64 keyframes, 4096 points"),
    ("loops", "2 laps, 6x IMU noise, weak-texture sectors (drift+closure)"),
    ("hard", "2x speed, 1.6x yaw, 25 ms blur, 0.55x contrast (V1_03 analog)"),
]


def row(d, name, desc):
    """One table row from a result of tools/eval_clone.py (the JAX script's
    keys, or the port's own where an older result lacks them)."""
    n = max(d.get("frames", 1), 1)
    lost = d.get("n_lost", d.get("lost_frames", 0))
    ok = d.get("tracking_finished_ok", not d.get("lost", False))
    if lost == 0:
        outcome = "good (tracked throughout)"
    elif ok and d.get("n_relocs", 0) > 0:
        outcome = f"marginal (lost {100.0 * lost / n:.0f}% of frames, relocalized x{d['n_relocs']})"
    else:
        outcome = "fails (lost)"
    ate = d.get("ate_rmse_post_init", d.get("ate_post_rmse_m"))
    fps = d.get("e2e_fps_amortized")
    if fps is None and d.get("frame_ms_mean"):
        fps = 1e3 / d["frame_ms_mean"]
    ate_s = f"{1e3 * ate:.1f} mm" if ate is not None and ate >= 0 else "n/a"
    fps_s = f"{fps:.2f} ({d.get('card', 'card not recorded')})" if fps else "n/a"
    cells = (name, desc, d.get("frames", "?"), outcome, ate_s, d.get("loops_closed", 0), fps_s)
    return "| " + " | ".join(str(c) for c in cells) + " |"


def table(art_dir):
    lines = ["| profile | conditions | frames | outcome | ATE (post-init) | loops closed "
             "| frames/s (card) |", "|---|---|---|---|---|---|---|"]
    for name, desc in PROFILES:
        p = os.path.join(art_dir, f"ate_clone_{name}_torch.json")
        if os.path.exists(p):
            with open(p) as f:
                lines.append(row(json.load(f), name, desc))
    return "\n".join(lines)


def replace_table(text, tab, marker=MARKER):
    """`text` with the table lines (and blank lines) right after `marker`
    replaced by `tab`; None when the marker is missing."""
    if marker not in text:
        return None
    head, rest = text.split(marker, 1)
    rest_lines = rest.splitlines()
    i = 0
    while i < len(rest_lines) and (not rest_lines[i].strip()
                                   or rest_lines[i].lstrip().startswith("|")):
        i += 1
    tail = "\n".join(rest_lines[i:])
    return head + marker + "\n" + tab + "\n" + ("\n" + tail if tail else "") + (
        "\n" if tail and text.endswith("\n") else "")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--readme", default="README.md")
    ap.add_argument("--artifacts", default="artifacts")
    args = ap.parse_args(argv)
    tab = table(args.artifacts)
    with open(args.readme) as f:
        text = f.read()
    new = replace_table(text, tab)
    if new is None:
        print(f"marker {MARKER} missing in {args.readme}", file=sys.stderr)
        sys.exit(1)
    with open(args.readme, "w") as f:
        f.write(new)
    print(tab)
    return tab


if __name__ == "__main__":
    main()
