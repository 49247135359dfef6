#!/usr/bin/env python3
"""Where the card's tree bispectrum parts from the CPU's, triple by triple.

On a machine with one CUDA card, from the repository root:

    python3 scripts/tree_bispectrum_residual.py

At the gpu test's size (32^3) and chip_smoke's phase-2 size (64^3), both
at 16 Mpc/h with nbins = 4, it computes ``predicted_tree_bispectrum`` on the
card and on the CPU, and a float64 reference on the CPU: the same shells,
masks, float32 power grid and triples, each synthesis a float64
``torch.fft.irfftn`` of its weight (a c2r keeps the Hermitian part of the
kz = 0 and Nyquist planes, as the JAX package's does) and the triple sums
in float64.  For each triple it prints |B| over the largest |B|, its
triangle count ntri (closed triads over the cells) and the relative
differences |a - b| / |b| of card vs CPU, card vs float64 and CPU
vs float64, then their maxima; and the card against the CPU with the odd
syntheses' Hermitian projection taken out (``transform.hermitian_part_reim``
replaced by the identity: K4's half-pack then reads planes that are not
Hermitian), the fault a bar on the card's tree must catch.  Without a card
it prints the CPU's lines only.  It never imports JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.models import spt  # noqa: E402
from randomfield_tpu_torch.ops import grid, transform  # noqa: E402

SHAPES = ((32, 32, 32), (64, 64, 64))
SPACING = 16.0
NBINS = 4


class _Grids64(spt._TreeGrids):
    """The tree's syntheses in float64 on the CPU: the float32 masks and
    power grid of the port, the k vectors, 1/k^2, weights and transforms in
    float64."""

    def __init__(self, pgrid, shape, spacing):
        super().__init__(pgrid, shape, spacing)
        kx, ky, kz = grid.kvectors(shape, spacing, torch.float64, "cpu")
        self.kvec = (kx[:, None, None], ky[None, :, None], kz[None, None, :])
        k2 = grid.ksq(shape, spacing, torch.float64, "cpu")
        self.inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0),
                                  0.0)
        self.pgrid = pgrid.to(torch.float64)

    def synth(self, w, odd):
        w = w.to(torch.float64)
        zero = torch.zeros_like(w)
        c = (torch.complex(zero, torch.where(self.odd_ok, w, 0.0)) if odd
             else torch.complex(w, zero))
        return torch.fft.irfftn(c, s=self.shape, norm="forward")


def _tree(shape, device):
    return spt.predicted_tree_bispectrum(rft.load_default_power(), shape,
                                         SPACING, nbins=NBINS, device=device)


def _tree64(shape):
    kept = spt._TreeGrids
    spt._TreeGrids = _Grids64
    try:
        return _tree(shape, "cpu")
    finally:
        spt._TreeGrids = kept


def _unprojected(shape, device):
    kept = transform.hermitian_part_reim
    transform.hermitian_part_reim = lambda re, im, nz: (re, im)
    try:
        return _tree(shape, device)
    finally:
        transform.hermitian_part_reim = kept


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.where(want != 0, np.abs(want), 1.0)


def main() -> int:
    torch.set_num_threads(4)
    card = torch.cuda.is_available()
    if card:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip())
    for shape in SHAPES:
        _, tri, b_cpu, ntri = _tree(shape, "cpu")
        _, tri64, b64, _ = _tree64(shape)
        if not np.array_equal(tri, tri64):
            raise AssertionError("the float64 reference has other triples")
        cols = {"cpu-f64": _rel(b_cpu, b64)}
        if card:
            _, tri_c, b_card, _ = _tree(shape, "cuda")
            _, tri_u, b_fault, _ = _unprojected(shape, "cuda")
            if not (np.array_equal(tri, tri_c) and np.array_equal(tri, tri_u)):
                raise AssertionError("the card's tree has other triples")
            cols = {"card-cpu": _rel(b_card, b_cpu),
                    "card-f64": _rel(b_card, b64), **cols,
                    "unprojected card-cpu": _rel(b_fault, b_cpu)}
        print(f"{shape}, {SPACING:g} Mpc/h, nbins {NBINS}: {len(tri)} triples")
        print("triple      |B|/max|B|  ntri       "
              + "  ".join(f"{k:>20}" for k in cols))
        scale = np.abs(b64) / np.abs(b64).max()
        for t in range(len(tri)):
            print(f"{str(tuple(int(v) for v in tri[t])):11} {scale[t]:.3e}   "
                  f"{ntri[t]:<10.4g} "
                  + "  ".join(f"{v[t]:20.3e}" for v in cols.values()))
        print("max per triple: " + ", ".join(
            f"{k} {v.max():.3e}" for k, v in cols.items()))
        if card:
            print(f"max |card - cpu| / max |B|: "
                  f"{np.abs(b_card - b_cpu).max() / np.abs(b_cpu).max():.3e}; "
                  f"unprojected "
                  f"{np.abs(b_fault - b_cpu).max() / np.abs(b_cpu).max():.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
