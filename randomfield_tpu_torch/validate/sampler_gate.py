"""Statistical gate of the ``sampler='pallas'`` streams (K1, and v6's K10).

Port of ``scripts/validate_pallas_sampler.py:run_checks``, the JAX
package's hardware gate of its fused sampler.  With a flat sigma table
(sigma0 at every k, zero at DC) and a Gaussian filter, over ``n_seeds``
spectra of the port's :func:`~randomfield_tpu_torch.ops.sampler.sample_spectrum`
(``stream='modes'``) or of the staged v6 render's
:func:`~randomfield_tpu_torch.ops.genfft.sample_fftx` with its x transform
undone (``stream='genfft'``):

* determinism: the same seed reproduces the spectrum, another seed differs;
* the kz = 0 / Nyquist planes are Hermitian (a numpy projection);
* the DC mode is exactly zero (v6: zero in the planes the kernel loads,
  and zero to rounding after its x transform and back);
* per-mode <|c|^2> / (sigma0^2 exp(-k^2 s^2)) - 1 within 6 sqrt(2/n) + 0.02;
* pooled per-|k|-shell variance ratios within 6 / sqrt(M n) + 0.01;
* skew and kurtosis of the re/im components of interior modes within
  6 sqrt(15/N) + 0.01 and 6 sqrt(96/N) + 0.05 of 0 and 3.

Moments accumulate in float64 on the table's device; only the six
accumulated lattices come to the host.  Run on the card with
``python -m randomfield_tpu_torch.validate.sampler_gate [modes|genfft]``.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops import genfft as _genfft
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import sampler as _sampler

__all__ = ["run_checks", "hermitian_projection"]


def hermitian_projection(c, nz):
    """Numpy projection of the kz = 0 / Nyquist planes of a complex 'xyz'
    half-spectrum onto Hermitian ones (no sqrt(2) rescale): each mode's
    canonical partner wins, self-conjugate modes keep their real part."""
    c = np.array(c, copy=True)
    nx, ny = c.shape[0], c.shape[1]
    i = np.arange(nx)[:, None]
    j = np.arange(ny)[None, :]
    ni, nj = (-i) % nx, (-j) % ny
    self_conj = (i == ni) & (j == nj)
    canonical = (i < ni) | ((i == ni) & (j <= nj))
    for p in _grid.self_conjugate_kz_planes(nz):
        z = c[:, :, p]
        partner = np.conj(z[(-np.arange(nx)) % nx][:, (-np.arange(ny)) % ny])
        out = np.where(canonical, z, partner)
        c[:, :, p] = np.where(self_conj, z.real + 0j, out)
    return c


def _require(ok, what):
    """Fail the gate (an explicit raise: ``python -O`` keeps it)."""
    if not ok:
        raise AssertionError(what)


def _flat_table(shape, sigma0, device):
    n_knots = _sampler.table_knot_count(shape)
    knots = torch.full((n_knots,), sigma0, dtype=torch.float32, device=device)
    return _sampler.SigmaTable(-3.0, 6.0 / (n_knots - 1), knots)


def _complex(re, im):
    return re.cpu().numpy().astype(np.float64) + 1j * im.cpu().numpy()


def _genfft_spectrum(seed, table, shape, spacing, s):
    """The v6 stream's 'xyz' spectrum: K10's (nzh * ny, nx) output through a
    float64 forward x-FFT (which undoes its unnormalized inverse up to the
    kernel's own float32 rounding), as float64 (re, im) (nx, ny, nzh)."""
    nx, ny, nz = shape
    re, im = _genfft.sample_fftx(seed, table, shape, spacing, s)
    lines = torch.complex(re.to(torch.float64), im.to(torch.float64))
    spec = torch.fft.fft(lines.view(nz // 2 + 1, ny, nx), dim=-1) / nx
    spec = spec.permute(2, 1, 0)
    return spec.real, spec.imag


def run_checks(n_seeds=2000, shape=(16, 16, 16), device="cuda",
               stream="modes"):
    """Run the gate on K1's stream (``stream='modes'``) or on the v6
    stream of K10 (``'genfft'``); raise AssertionError on a failed check,
    else return its figures (per-mode max and bar, pooled shell max, skew,
    kurtosis)."""
    if stream not in ("modes", "genfft"):
        raise ValueError(f"unknown stream {stream!r}")
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    sigma0, smoothing, spacing = 2.0, 1.5, 1.0
    table = _flat_table(shape, sigma0, torch.device(device))
    # the x transform and back leaves float32 rounding on every mode
    atol, dc_tol = (1e-6, 0.0) if stream == "modes" else (1e-5, 1e-10)

    def draw(seed, s=0.0):
        if stream == "genfft":
            return _genfft_spectrum(seed, table, shape, spacing, s)
        return _sampler.sample_spectrum(seed, table, shape, spacing, s)

    a, b, c = _complex(*draw(7)), _complex(*draw(7)), _complex(*draw(8))
    _require(np.array_equal(a, b), "same seed must reproduce")
    _require(not np.allclose(a, c), "different seeds must differ")
    proj = hermitian_projection(a, nz)
    _require(np.allclose(a, proj, rtol=1e-5, atol=atol), "Hermitian planes")
    if stream == "genfft":
        pre, pim = _genfft.plane_spectra(7, table, shape, spacing)
        _require(float(pre[0, 0]) == 0.0 and float(pim[0, 0]) == 0.0,
                 "the loaded planes' DC must be exactly zero")

    acc = torch.zeros((6, nx, ny, nzh), dtype=torch.float64,
                      device=table.knots.device)
    for seed in range(n_seeds):
        re, im = (t.to(torch.float64) for t in draw(seed, smoothing))
        re2, im2 = re * re, im * im
        acc[0] += re
        acc[1] += im
        acc[2] += re2
        acc[3] += im2
        acc[4] += re2 * re + im2 * im
        acc[5] += re2 * re2 + im2 * im2
    s1r, s1i, s2r, s2i, s3, s4 = acc.cpu().numpy()
    n = float(n_seeds)
    var = (s2r + s2i) / n
    mean = np.abs(s1r + 1j * s1i) / n

    km = _grid.kmag(shape, spacing).numpy().astype(np.float64)
    expected = np.where(km > 0, sigma0 ** 2, 0.0) * np.exp(-((km * smoothing) ** 2))
    _require(np.abs(var[km == 0]).max() <= dc_tol * sigma0 ** 2,
             "DC must be zero")
    mask = expected > 1e-10 * sigma0 ** 2
    rel = var[mask] / expected[mask] - 1
    # per mode, |c|^2 / sigma^2 has unit relative std per complex draw
    tol = 6.0 * np.sqrt(2.0 / n) + 0.02
    _require(np.abs(rel).max() < tol, f"per-mode variance {np.abs(rel).max()} >= {tol}")
    _require(mean[mask].max() < 6 * sigma0 / np.sqrt(n), "per-mode mean")

    ratio = np.zeros_like(var)
    ratio[mask] = var[mask] / expected[mask]
    edges = np.linspace(km[mask].min(), km.max() * (1 + 1e-6), 9)
    shell_rel = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = mask & (km >= lo) & (km < hi)
        m = int(sel.sum())
        if m == 0:
            continue
        r = ratio[sel].mean() - 1.0
        stol = 6.0 / np.sqrt(m * n) + 0.01
        _require(abs(r) < stol, f"shell [{lo}, {hi}) of {m} modes: {r} >= {stol}")
        shell_rel.append(abs(r))

    # Box-Muller Gaussianity over interior modes; per component the
    # variance is sigma^2 f / 2
    kz_idx = np.broadcast_to(np.arange(nzh)[None, None, :], km.shape)
    interior = mask & ~np.isin(kz_idx, _grid.self_conjugate_kz_planes(nz))
    var_c = expected[interior] / 2.0
    ncomp = 2.0 * interior.sum() * n
    skew = ((s3[interior] / n) / var_c ** 1.5).mean() / 2.0
    kurt = ((s4[interior] / n) / var_c ** 2).mean() / 2.0
    skew_tol = 6.0 * np.sqrt(15.0 / ncomp) + 0.01
    kurt_tol = 6.0 * np.sqrt(96.0 / ncomp) + 0.05
    _require(abs(skew) < skew_tol, f"skew {skew} outside {skew_tol}")
    _require(abs(kurt - 3.0) < kurt_tol, f"kurtosis {kurt} outside 3 +- {kurt_tol}")
    return {
        "per_mode_max": float(np.abs(rel).max()), "per_mode_tol": float(tol),
        "pooled_shell_max": float(max(shell_rel)), "skew": float(skew),
        "kurtosis": float(kurt), "n_seeds": int(n_seeds), "stream": stream,
    }


if __name__ == "__main__":
    import sys

    print(run_checks(stream=sys.argv[1] if len(sys.argv) > 1 else "modes"))
