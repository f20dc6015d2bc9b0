#!/usr/bin/env python
"""Container-layout figure generators — the ``data_example_image`` analogue.

The reference ships hand-drawn matplotlib diagrams of its formats
(``plots/data_example_image/base_structure.py:25-28`` hardcodes the CSP/CSN/
RIP/RIN arrays of a 4x4 example). Here the diagrams are generated *from the
format classes themselves*: a tiny ternary matrix is packed by the real
``from_dense`` and the resulting arrays are rendered, so the figures cannot
rot out of sync with the layouts.

Usage:
    python tools/format_diagram.py [--outdir docs/figures]

Generates:
    tcsc_structure.png      — split-sign TCSC streams (TCSC.h:41-48 analogue)
    bitplane_structure.png  — TiledBitplane bit deposit (the round-2 flagship)
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

POS, NEG, ZERO = "#f4a6a6", "#a9c6ea", "#f2f2f2"
CELL = 1.0


def _grid(ax, data, x0, y0, color_fn, fmt=str, cell=CELL, fs=9):
    from matplotlib.patches import Rectangle
    data = np.atleast_2d(np.asarray(data))
    for r in range(data.shape[0]):
        for c in range(data.shape[1]):
            v = data[r, c]
            ax.add_patch(Rectangle((x0 + c * cell, y0 - (r + 1) * cell),
                                   cell, cell, facecolor=color_fn(v),
                                   edgecolor="black", linewidth=0.8))
            ax.text(x0 + (c + 0.5) * cell, y0 - (r + 0.5) * cell, fmt(v),
                    ha="center", va="center", fontsize=fs)
    return data.shape


def _tern_color(v):
    return POS if v > 0 else NEG if v < 0 else ZERO


def draw_tcsc(outdir: str) -> str:
    """Split-sign TCSC streams of a real 6x6 example (TCSC.h:41-48)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ternary_spgemm_tpu.formats import TCSC, generate_ternary

    W = generate_ternary(6, 6, 2, seed=7)
    f = TCSC.from_dense(W)
    fig, ax = plt.subplots(figsize=(11, 7))
    _grid(ax, W, 0, 0, _tern_color)
    ax.text(3, 0.6, "W (ternary, K x N)", ha="center", fontsize=11)
    rows = [("col_start_pos (CSP)", f.col_start_pos, POS),
            ("row_index_pos (RIP)", f.row_index_pos, POS),
            ("col_start_neg (CSN)", f.col_start_neg, NEG),
            ("row_index_neg (RIN)", f.row_index_neg, NEG)]
    y = -7.5
    for label, arr, color in rows:
        _grid(ax, arr, 0, y, lambda v, c=color: c)
        ax.text(len(arr) * CELL + 0.4, y - 0.5, label, va="center", fontsize=10)
        y -= 1.6
    ax.set_xlim(-0.5, 14); ax.set_ylim(y - 0.5, 1.2)
    ax.set_aspect("equal"); ax.axis("off")
    path = os.path.join(outdir, "tcsc_structure.png")
    fig.savefig(path, dpi=120, bbox_inches="tight"); plt.close(fig)
    return path


def draw_bitplane(outdir: str) -> str:
    """TiledBitplane: dense rows -> pos/neg bit planes (formats/bitplane.py)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ternary_spgemm_tpu.formats import TiledBitplane, generate_ternary

    W = generate_ternary(8, 8, 2, seed=3)          # one block: tkb=1, B=8 rows
    f = TiledBitplane.from_dense(W, tkb=1, tile_n=128)
    pos, neg = f.plane[0, 0, 0, :8], f.plane[0, 0, 1, :8]
    fig, ax = plt.subplots(figsize=(11, 6))
    _grid(ax, W, 0, 0, _tern_color)
    ax.text(4, 0.6, "W (one 8-row block, 8 cols shown)", ha="center",
            fontsize=11)
    _grid(ax, pos, 0, -9.2, lambda v: POS, fmt=lambda v: f"{v:08b}")
    ax.text(8.4, -9.7, "pos plane byte-row (bit j = row-j flag)",
            va="center", fontsize=10)
    _grid(ax, neg, 0, -10.8, lambda v: NEG, fmt=lambda v: f"{v:08b}")
    ax.text(8.4, -11.3, "neg plane byte-row", va="center", fontsize=10)
    ax.text(0, -14.0,
            "kernel decode: widen byte-row to int32, deposit bits to bytes\n"
            "((x & 0xF) * 0x00204081) & 0x01010101, bitcast int32->4x int8 "
            "rows,\nmerge signs: pos | (neg * 0xFF); one MXU dot consumes "
            "the plane", fontsize=9, va="top", family="monospace")
    ax.set_xlim(-0.5, 14); ax.set_ylim(-16.5, 1.2)
    ax.set_aspect("equal"); ax.axis("off")
    path = os.path.join(outdir, "bitplane_structure.png")
    fig.savefig(path, dpi=120, bbox_inches="tight"); plt.close(fig)
    return path


def draw_blocked(outdir: str) -> str:
    """BlockedTCSC: per-K-block column pointers (BlockedTCSC.h:6-49 analogue,
    reference figure plots/data_example_image)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ternary_spgemm_tpu.formats import BlockedTCSC, generate_ternary

    W = generate_ternary(8, 6, 2, seed=5)
    f = BlockedTCSC.from_dense(W, block_size=4)     # 2 K-blocks
    fig, ax = plt.subplots(figsize=(11, 8))
    _grid(ax, W, 0, 0, _tern_color)
    ax.text(3, 0.6, "W (K=8 x N=6, two K-blocks of 4)", ha="center",
            fontsize=11)
    ax.plot([-0.3, 6.3], [-4, -4], color="black", linewidth=1.5,
            linestyle="--")
    rows = [("col_start_pos ((K/B)*N+1, block-major)", f.col_start_pos, POS),
            ("row_index_pos (global row ids)", f.row_index_pos, POS),
            ("col_start_neg", f.col_start_neg, NEG),
            ("row_index_neg", f.row_index_neg, NEG)]
    y = -9.5
    for label, arr, color in rows:
        _grid(ax, arr, 0, y, lambda v, c=color: c, fs=7)
        ax.text(len(arr) * CELL + 0.4, y - 0.5, label, va="center", fontsize=9)
        y -= 1.6
    ax.set_xlim(-0.5, 20); ax.set_ylim(y - 0.5, 1.2)
    ax.set_aspect("equal"); ax.axis("off")
    path = os.path.join(outdir, "blocked_tcsc_structure.png")
    fig.savefig(path, dpi=120, bbox_inches="tight"); plt.close(fig)
    return path


def draw_ell_deposit(outdir: str) -> str:
    """TiledEllDeposit: per-slot local offsets feeding the bit-deposit decode
    (formats/ell_deposit.py; net-new, no reference analogue)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ternary_spgemm_tpu.formats import TiledEllDeposit, generate_ternary

    W = generate_ternary(12, 6, 3, seed=11)
    f = TiledEllDeposit.from_dense(W, tile_n=128)
    fig, ax = plt.subplots(figsize=(12, 9))
    _grid(ax, W, 0, 0, _tern_color)
    ax.text(3, 0.6, "W (K=12 x N=6; one superblock, all rows in word 0)",
            ha="center", fontsize=11)
    cp, cn = int(f.cap_pos[0, 0]), int(f.cap_neg[0, 0])
    dot = lambda v: "·" if v == 31 else str(v)
    # word 0 of each slot (rows 0..30 live there for K<=31; words 1-7 are
    # all-sentinel for this small example and are omitted)
    pos = f.plane[0, 0, 0:8 * cp:8, :6]
    neg = f.plane[0, 0, 8 * f.cap_p_max:8 * f.cap_p_max + 8 * cn:8, :6]
    y = -13.5
    _grid(ax, pos, 0, y, lambda v: POS, fmt=dot)
    ax.text(6.4, y - 0.5 * cp,
            f"pos offset slots (word 0 of each of {cp} slots;\n"
            "value = dense-row bit index deposited, · = sentinel 31)",
            va="center", fontsize=9)
    y -= cp + 1.2
    _grid(ax, neg, 0, y, lambda v: NEG, fmt=dot)
    ax.text(6.4, y - 0.5 * cn, f"neg offset slots ({cn})",
            va="center", fontsize=9)
    y -= cn + 1.4
    ax.text(0, y,
            "kernel: word |= 1 << offset   (lane-wise variable shift, 2 VPU "
            "ops/nonzero)\nthen the bitplane magic-multiply decode + ONE "
            "stacked int8 MXU dot;\nsentinel 31 decodes to a row facing an "
            "(a,r)=(0,0) activation column -> contributes 0",
            fontsize=9, va="top", family="monospace")
    ax.set_xlim(-0.5, 16); ax.set_ylim(y - 3.5, 1.2)
    ax.set_aspect("equal"); ax.axis("off")
    path = os.path.join(outdir, "ell_deposit_structure.png")
    fig.savefig(path, dpi=120, bbox_inches="tight"); plt.close(fig)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="docs/figures")
    args = p.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    for fn in (draw_tcsc, draw_bitplane, draw_blocked, draw_ell_deposit):
        print(fn(args.outdir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
