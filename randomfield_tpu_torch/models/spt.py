"""One-loop standard perturbation theory (SPT) matter power spectrum.

Port of ``randomfield_tpu/models/spt.py`` with its names, arguments and
returns:

    P_1loop(k) = P_lin(k) + P22(k) + P13(k)

(Makino, Sasaki & Suto 1992; Jain & Bertschinger 1994; conventions of
Carlson, White & Padmanabhan 2009), the theory counterpart of the measured
nonlinear statistics.  :func:`p13_kernel`, :func:`sigma_v2`,
:func:`oneloop_terms` and :func:`oneloop_power` are host float64 numpy,
copies of the reference's quadratures.

The grid operators run on the field's (or ``device``'s) device:

* :func:`second_order_density`: delta2 = F2[delta, delta] by the discrete
  Galileon decomposition, one forward transform (K6, K3 x2) and 12
  inverse ones (K3 x2, K4: psi_i and d_i delta for each axis, six t_ij;
  the JAX docstring's 13 counts one more); the spectral factors are KD
  (:func:`..ops.derived.apply_kernel`): 'grad' for psi_i = i k_i delta /
  k^2, 'deriv' for d_i delta = i k_i delta, 'tidal' (Nyquist-zeroed
  diagonals too) for t_ij = k_i k_j delta / k^2.
* :func:`predicted_tree_bispectrum`: the exactly binned tree-level
  bispectrum.  The JAX package holds the 13 syntheses of every bin at once
  (104 fields at nbins = 8: 447 GB at 1024^3); here only the nbins unit
  shells are held: each bin pair's field S_ab is built once, term by term,
  from syntheses made and dropped on the fly (26 a pair), and sum_x S_ab u_c
  (float64) is added into every triple that has (a, b) as one of its three
  pairs.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from randomfield_tpu_torch.ops import derived as _derived
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import transform as _transform
from randomfield_tpu_torch.ops.fftlog import log_grid, resample_loglog
from randomfield_tpu_torch.ops.power import PowerTable, validate_power

__all__ = [
    "SPTResult",
    "p13_kernel",
    "sigma_v2",
    "oneloop_terms",
    "oneloop_power",
    "second_order_density",
    "predicted_tree_bispectrum",
]


class SPTResult(typing.NamedTuple):
    """One-loop SPT decomposition at wavenumbers ``k`` [h/Mpc]."""

    k: np.ndarray
    p_lin: np.ndarray
    p22: np.ndarray
    p13: np.ndarray

    @property
    def total(self) -> np.ndarray:
        return self.p_lin + self.p22 + self.p13


def p13_kernel(r):
    """The P13 radial kernel f13(r), float64, stable for all r > 0: the
    direct form between 3e-3 and 20, its exact series outside."""
    r = np.asarray(r, np.float64)
    out = np.empty(r.shape, np.float64)
    big = r > 20.0
    small = r < 3e-3
    mid = ~(big | small)
    rm = r[mid]
    r2 = rm * rm
    one = np.abs(rm - 1.0) < 1e-12
    safe = np.where(one, 0.5, np.minimum(rm, 1.0 / rm))
    ell = np.where(one, 0.0, 2.0 * np.arctanh(safe))
    poly = ((7.0 * r2 - 19.0) * r2 + 15.0) * r2 * r2 - r2 - 2.0
    out[mid] = (
        12.0 / r2 - 158.0 + 100.0 * r2 - 42.0 * r2 * r2
        + 3.0 / (r2 * rm) * poly * ell
    )
    s2 = r[small] * r[small]
    out[small] = -168.0 + s2 * (
        928.0 / 5.0 + s2 * (-4512.0 / 35.0 + s2 * (416.0 / 21.0))
    )
    t2 = 1.0 / (r[big] * r[big])
    out[big] = (
        -488.0 / 5.0
        + t2 * (96.0 / 5.0 + t2 * (-160.0 / 21.0 + t2 * (-1376.0 / 1155.0)))
    )
    return out


def _power_interp(power, qmin, qmax, nq):
    """Log-spaced q grid and table values with end-slope power-law tails."""
    k_t, p_t = validate_power(power)
    k_t = np.asarray(k_t, np.float64)
    p_t = np.asarray(p_t, np.float64)
    q = log_grid(qmin, qmax, nq)
    pq = resample_loglog(k_t, p_t, q)
    return k_t, p_t, q, pq


def sigma_v2(power, qmin=None, qmax=None, nq=4096):
    """1-D displacement dispersion sigma_v^2 = (1/6 pi^2) int P(q) dq."""
    k_t, _ = validate_power(power)
    qmin = float(k_t[0]) / 10.0 if qmin is None else float(qmin)
    qmax = float(k_t[-1]) * 10.0 if qmax is None else float(qmax)
    _, _, q, pq = _power_interp(power, qmin, qmax, int(nq))
    return float(np.trapezoid(pq * q, np.log(q)) / (6.0 * np.pi**2))


def oneloop_terms(power, k=None, z=0.0, cosmology=None,
                  nq=2048, nx=128, qmin=None, qmax=None) -> SPTResult:
    """P_lin, P22 and P13 at wavenumbers ``k`` (host float64).

    ``power`` is a z = 0 linear table (k in h/Mpc, P in (Mpc/h)^3).  With
    ``z`` and a ``cosmology`` the linear term scales by D(z)^2 and both
    loops by D(z)^4.  The q integral runs over [``qmin``, ``qmax``]
    (default one decade past the table at both ends) with ``nq``
    log-trapezoid nodes; P22's inner integral takes ``nx`` log-spaced
    y = |k - q| / k nodes a (k, q).
    """
    k_t, p_t = validate_power(power)
    k_t = np.asarray(k_t, np.float64)
    if k is None:
        lo = k_t[0] * 10.0 ** 0.5
        hi = k_t[-1] * 10.0 ** -0.5
        k = log_grid(lo, hi, 128)
    k = np.atleast_1d(np.asarray(k, np.float64))
    if np.any(k <= 0):
        raise ValueError("k must be positive")
    qmin = float(k_t[0]) / 10.0 if qmin is None else float(qmin)
    qmax = float(k_t[-1]) * 10.0 if qmax is None else float(qmax)
    if not (0.0 < qmin < qmax):
        raise ValueError("need 0 < qmin < qmax")
    _, _, q, pq = _power_interp(power, qmin, qmax, int(nq))
    lnq = np.log(q)
    # trapezoid weights in ln q
    w = np.empty_like(lnq)
    w[1:-1] = 0.5 * (lnq[2:] - lnq[:-2])
    w[0] = 0.5 * (lnq[1] - lnq[0])
    w[-1] = 0.5 * (lnq[-1] - lnq[-2])
    wqp = w * q * pq  # integral dr P(kr) g(r) = (1/k) sum wqp * g(q/k)

    p_lin = resample_loglog(k_t, p_t, k)

    # P13: one radial integral per k
    r = q[None, :] / k[:, None]
    f13 = p13_kernel(r)
    p13 = (k**2 / (1008.0 * np.pi**2)) * p_lin * (f13 @ wqp)

    # P22: the angular integral through y = |k - q| / k on log-spaced nodes
    ny = int(nx)
    p22 = np.empty_like(k)
    u = np.linspace(0.0, 1.0, ny)
    chunk = max(1, int(2e7 // (len(q) * ny)))
    for i0 in range(0, len(k), chunk):
        kc = k[i0:i0 + chunk, None, None]
        rc = q[None, :, None] / kc
        ymin = np.maximum(np.abs(1.0 - rc), 1e-10 * (1.0 + rc))
        ymax = 1.0 + rc
        lny = np.log(ymin) + (np.log(ymax) - np.log(ymin)) * u
        y = np.exp(lny)
        x = (1.0 + rc * rc - y * y) / (2.0 * rc)
        num = 3.0 * rc + 7.0 * x - 10.0 * rc * x * x
        pky = resample_loglog(k_t, p_t, (kc * y).ravel()).reshape(y.shape)
        f = num * num * pky / (rc * y * y)  # integrand * y (log measure)
        dln = (np.log(ymax) - np.log(ymin))[..., 0] / (ny - 1)
        inner = (f.sum(-1) - 0.5 * (f[..., 0] + f[..., -1])) * dln
        p22[i0:i0 + chunk] = (
            k[i0:i0 + chunk] ** 2 / (392.0 * np.pi**2) * (inner @ wqp)
        )

    if z != 0.0 or cosmology is not None:
        if cosmology is None:
            raise ValueError("scaling to z != 0 requires a cosmology")
        from randomfield_tpu_torch.models.cosmology import create_cosmology

        d = float(create_cosmology(cosmology).growth_function(float(z)))
        p_lin = d * d * p_lin
        p22 = d**4 * p22
        p13 = d**4 * p13
    return SPTResult(k, p_lin, p22, p13)


def oneloop_power(power, k=None, z=0.0, cosmology=None, **kw) -> PowerTable:
    """One-loop total P(k) as a :class:`PowerTable`; raises where the loops
    drive P <= 0."""
    res = oneloop_terms(power, k=k, z=z, cosmology=cosmology, **kw)
    total = res.total
    if np.any(total <= 0):
        bad = res.k[total <= 0]
        raise ValueError(
            "one-loop P(k) is non-positive at k >= %.3g h/Mpc; restrict the "
            "requested k range (SPT is invalid there)" % bad.min()
        )
    return PowerTable(res.k, total)


def second_order_density(delta, spacing):
    """Second-order SPT density delta2(x) = F2[delta, delta] on the grid.

    F2(q1, q2) = 5/7 + (q1.q2 / 2)(1/q1^2 + 1/q2^2) + (2/7)(q1.q2)^2 /
    (q1 q2)^2 becomes (5/7) delta^2 - psi . grad delta + (2/7) sum_ij
    t_ij^2: one forward transform and 12 inverse ones on ``delta``'s
    device, each spectral factor a KD launch on a copy of the spectrum (the
    last on the spectrum itself).  Returns a float32 (nx, ny, nz) field.
    """
    delta = torch.as_tensor(delta)
    shape = tuple(int(s) for s in delta.shape[-3:])
    spacing = float(spacing)
    re, im = _transform.rfftn(delta)
    inv_n = 1.0 / (shape[0] * shape[1] * shape[2])

    def inverse(kind, comp, last=False, **kw):
        r, i = (re, im) if last else (re.clone(), im.clone())
        _derived.apply_kernel(r, i, shape, spacing, kind, comp, inv_n, **kw)
        return _transform.irfftn_reim(r, i, shape)

    out = (5.0 / 7.0) * delta * delta
    for m in range(3):
        psi = inverse("grad", m)
        psi.mul_(inverse("deriv", m))
        out.sub_(psi)
        del psi
    for n, (i, j) in enumerate(_derived.TIDAL_PAIRS):
        t = inverse("tidal", n, last=n == 5, grad_diag=True)
        out.add_(((2.0 / 7.0) * (1.0 if i == j else 2.0)) * t * t)
        del t
    return out


# ---------------------------------------------------------------------------
# Tree-level (F2) bispectrum, exactly binned on this grid
# ---------------------------------------------------------------------------

# the 2 T contraction: the diagonal once, the off-diagonal pairs twice
_T_PAIRS = [(m, n) for m in range(3) for n in range(m, 3)]
_T_WEIGHTS = [1.0 if m == n else 2.0 for (m, n) in _T_PAIRS]


class _TreeGrids:
    """The packed-grid factors of the tree bispectrum's syntheses, float32
    on the power grid's device: |k| (sqrt of ksq, as the JAX package takes
    it), 1/k^2 (0 at DC), the k vectors and the odd weights' mask (0 on
    the self-conjugate lattice points)."""

    def __init__(self, pgrid, shape, spacing):
        dev = pgrid.device
        self.shape = shape
        self.pgrid = pgrid
        kx, ky, kz = _grid.kvectors(shape, spacing, torch.float32, dev)
        self.kvec = (kx[:, None, None], ky[None, :, None], kz[None, None, :])
        k2 = _grid.ksq(shape, spacing, torch.float32, dev)
        self.kmag = torch.sqrt(k2)
        self.inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0),
                                  0.0)
        del k2
        nx, ny, nz = shape
        sc_xy, _ = _grid.hermitian_plane_masks(nx, ny)
        odd_ok = np.ones(_grid.half_shape(shape), bool)
        for zp in _grid.self_conjugate_kz_planes(nz):
            odd_ok[:, :, zp] &= ~sc_xy
        self.odd_ok = torch.as_tensor(odd_ok, device=dev)

    def shell(self, lo, hi):
        """(mask, P masked) of the shell lo <= |k| < hi (DC out)."""
        lo, hi = float(np.float32(lo)), float(np.float32(hi))
        mask = (self.kmag >= lo) & (self.kmag < hi) & (self.kmag > 0)
        return mask, torch.where(mask, self.pgrid, 0.0)

    def synth(self, w, odd):
        """The real field of the weight grid ``w`` (consumed): w itself
        (even) or i w with the self-conjugate points zeroed (odd), through
        K3, K3, K4.  A Nyquist entry of a k vector keeps its sign under
        k -> -k, so an odd weight, and an even one whose k_m k_n pairs a
        Nyquist component with another, is not Hermitian on the Nyquist
        lines of the kz = 0 and Nyquist planes; those two planes are
        replaced by their Hermitian parts first, which is what a c2r keeps
        of them (numpy's, and so the JAX package's) and what K4's
        half-pack reads."""
        if odd:
            re = torch.zeros_like(w)
            im = torch.where(self.odd_ok, w, 0.0)
            del w
        else:
            re, im = w, torch.zeros_like(w)
        _transform.hermitian_part_reim(re, im, self.shape[2])
        return _transform.irfftn_reim(re, im, self.shape)

    def term(self, p, what, m=0, n=0):
        """One synthesis of a shell's masked power ``p``: 'a' (P), 'v'
        (P k_m, odd), 'g' (P k_m / k^2, odd) or 't' (P k_m k_n / k^2)."""
        if what == "a":
            return self.synth(p.clone(), False)
        w = p * self.kvec[m]
        if what == "v":
            return self.synth(w, True)
        if what == "g":
            return self.synth(w.mul_(self.inv_k2), True)
        return self.synth(w.mul_(self.kvec[n]).mul_(self.inv_k2), False)

    def pair_field(self, pa, pb):
        """S_ab(x) = sum_{k1 in S_a, k2 in S_b} 2 F2(k1, k2) P1 P2
        e^{i(k1+k2).x}: (10/7) A_a A_b - sum_m (V_a G_b + G_a V_b) + (4/7)
        sum_mn w_mn T_a T_b (odd x odd products carry i^2 = -1), each
        synthesis made when its term is added and dropped after it."""
        s = self.term(pa, "a").mul_(10.0 / 7.0)
        s.mul_(self.term(pb, "a"))
        for m in range(3):
            x = self.term(pa, "v", m)
            x.mul_(self.term(pb, "g", m))
            ga = self.term(pa, "g", m)
            x.addcmul_(ga, self.term(pb, "v", m))
            del ga
            s.sub_(x)
            del x
        for (m, n), w in zip(_T_PAIRS, _T_WEIGHTS):
            ta = self.term(pa, "t", m, n).mul_((4.0 / 7.0) * w)
            ta.mul_(self.term(pb, "t", m, n))
            s.add_(ta)
            del ta
        return s


def _tree_triple_sums(pgrid, shape, spacing, edges, triples):
    """sum_x [S_ij u_l + S_jl u_i + S_li u_j] for every triple (i, j, l),
    host float64: the nbins unit shells held, each pair field S_ab built
    once and summed (float64, x-slab by x-slab) against the unit shell of
    every triple's third bin where (a, b) is one of its pairs."""
    from randomfield_tpu_torch.validate.bispectrum import _dot64

    grids = _TreeGrids(pgrid, shape, spacing)
    nb = len(edges) - 1
    units = [grids.synth(grids.shell(edges[b], edges[b + 1])[0].to(
        torch.float32), False) for b in range(nb)]
    uses = {}
    for t, (i, j, l) in enumerate(triples):
        for a, b, c in ((i, j, l), (j, l, i), (l, i, j)):
            uses.setdefault((min(a, b), max(a, b)), []).append((t, c))
    sums = np.zeros(len(triples))
    for (a, b), entries in sorted(uses.items()):
        pa = grids.shell(edges[a], edges[a + 1])[1]
        pb = grids.shell(edges[b], edges[b + 1])[1]
        s = grids.pair_field(pa, pb)
        del pa, pb
        dots = {}
        for t, c in entries:
            if c not in dots:
                dots[c] = float(_dot64((s, units[c])))
            sums[t] += dots[c]
        del s
    return sums


def predicted_tree_bispectrum(power, shape, spacing, nbins=8, kmin=None,
                              kmax=None, smoothing_length=0.0,
                              interpolation="log10k", device=None):
    """Exact binned tree-level gravity bispectrum on this grid.

    B_tree(k1, k2, k3) = 2 F2(k1, k2) P(k1) P(k2) + cyclic, averaged over
    exactly the lattice-closed triads, shells, bins and masks of
    ``validate.bispectrum.calculate_bispectrum``, P the render's discrete
    spectrum (same interpolation and optional Gaussian smoothing); on even
    grids the odd weights' self-conjugate modes are projected to zero, as in
    the JAX package.  Runs on ``device`` (default "cuda").  Returns
    ``(k_centers, triples, B_pred, ntri)`` aligned with the estimator's
    output on the same arguments.
    """
    from randomfield_tpu_torch.ops import power as _power
    from randomfield_tpu_torch.validate import bispectrum as _bisp

    dev = torch.device("cuda" if device is None else device)
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, spacing)
    kmag = _grid.kmag(shape, spacing, torch.float32, dev)
    peff = _power.interpolate_power(table, kmag, interpolation)
    sm = float(smoothing_length)
    if sm:
        peff = peff * torch.exp(-(kmag * kmag) * sm * sm)
    peff = torch.where(kmag > 0, peff, 0.0)
    del kmag

    edges, triples = _bisp.bispectrum_bins(shape, spacing, nbins, kmin, kmax)
    tri = [tuple(int(v) for v in row) for row in triples]
    num = _tree_triple_sums(peff, shape, spacing, edges, tri)
    del peff
    den = _bisp.triangle_counts(shape, spacing, edges, triples, dev)
    ncells = shape[0] * shape[1] * shape[2]
    ntri = den / ncells
    keep = ntri > 0.5
    with np.errstate(invalid="ignore", divide="ignore"):
        pred = num / den
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, triples[keep], pred[keep], ntri[keep]
