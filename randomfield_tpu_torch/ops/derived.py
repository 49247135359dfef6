"""Derived fields: potential, displacement (1LPT, 2LPT), velocity, tidal, Kaiser.

Port of ``randomfield_tpu/ops/derived.py``, with its Fourier conventions
(:mod:`.transform`):

* potential:      Phi_k / c^2 = -(3/2) Om (1+z) delta_k / (k D_H)^2
                  (comoving Poisson equation, D_H = c/H0 = 2997.92 Mpc/h)
* displacement:   psi_k = +i k / k^2 delta_k   (Zel'dovich; x = q + D psi)
* velocity:       v_k = i a H(a) f(a) delta_k k / k^2  [km/s]
* tidal tensor:   T_ij,k = k_i k_j / k^2 delta_k  (grad^2 phi = delta)
* Kaiser:         (b + f mu^2) delta_k, mu = k_los / |k|
* gradient:       i k delta_k (the second-order SPT source, models/spt.py)
* reconstruction: i k / k^2 S(k) delta_k / (b + f mu^2) (models/reconstruction.py)

DC modes are zero in every case.  Each is one elementwise spectral kernel
on a packed spectrum: KD, :func:`apply_kernel` (``csrc/spectral_kernel.cu``,
counter ``KD_LAUNCHES``), beside its plain version
:func:`apply_kernel_plain`, in the same float32 operations and order.  The
Generator applies it to a seed's sampled spectrum before the inverse
transforms (seed-direct, no forward FFT); the field-first helpers here
(``delta_to_*``) start from a rendered field and pay a forward
:func:`.transform.rfftn` first (2LPT: 11 transforms).

KD builds the k vectors in the thread from the axis indices, as numpy's
``fftfreq`` makes them (:func:`kernel_vectors` is that construction on the
host); the odd kernels take them with each even axis' Nyquist entry zeroed
(:func:`grad_kvectors`).
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.models.cosmology import create_cosmology
from randomfield_tpu_torch.ops import _build
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import transform as _transform

__all__ = [
    "TIDAL_PAIRS",
    "D_H_MPC_H",
    "KINDS",
    "KD_LAUNCHES",
    "kernel_vectors",
    "grad_kvectors",
    "apply_kernel",
    "apply_kernel_plain",
    "delta_to_potential",
    "delta_to_displacement",
    "delta_to_displacement_2lpt",
    "delta_to_velocity",
    "delta_to_tidal",
    "potential_prefactor",
    "velocity_prefactor",
    "fields_from_spectrum",
]

# component order of the packed symmetric tidal tensor: xx, yy, zz, xy, xz, yz
TIDAL_PAIRS = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))

D_H_MPC_H = 2997.92458  # Hubble distance in Mpc/h (c / (100 km/s/Mpc))

# KD's kinds, as csrc/spectral_kernel.cu numbers them
KINDS = {"scalar": 0, "grad": 1, "tidal": 2, "kaiser": 3, "deriv": 4,
         "recon": 5}

# kernel launches by apply_kernel (the CPU path does not count)
KD_LAUNCHES = 0

# x planes per step of the plain version (bounds its temporaries)
_X_CHUNK = 64


def kernel_vectors(shape, spacing, zero_nyquist=False):
    """(kx, ky, kz) float32 as KD builds them in the thread: index s of an
    axis of length n (signed from (n + 1) / 2 on; the kz axis unsigned)
    times 1 / (n d), times 2 pi, in float64, rounded to float32, and with
    ``zero_nyquist`` 0 at index n / 2 of an even axis.  Equal to
    :func:`.grid.kvectors` (and :func:`grad_kvectors`) bit for bit."""
    out = []
    for axis, n in enumerate(shape):
        val = 1.0 / (n * float(spacing))
        i = np.arange(n // 2 + 1 if axis == 2 else n)
        s = i if axis == 2 else np.where(i < (n + 1) // 2, i, i - n)
        k = (2.0 * np.pi) * (s.astype(np.float64) * val)
        if zero_nyquist and n % 2 == 0:
            k[n // 2] = 0.0
        out.append(torch.as_tensor(k.astype(np.float32)))
    return tuple(out)


def grad_kvectors(shape, spacing, dtype=torch.float32, device="cpu"):
    """(kx, ky, kz) with each even axis' Nyquist entry zeroed: an odd
    spectral derivative of a Nyquist mode has no real-field representation
    (the packed c2r would drop it and break delta = -div(psi))."""
    out = []
    for k, n in zip(_grid.kvectors(shape, spacing, dtype, device), shape):
        k = k.clone()
        if n % 2 == 0:
            k[n // 2] = 0.0
        out.append(k)
    return tuple(out)


def _check(kind, component):
    if kind not in KINDS:
        raise ValueError(f"unknown derived-field kind {kind!r}")
    limit = 6 if kind == "tidal" else 3
    if kind != "scalar" and not 0 <= int(component) < limit:
        raise ValueError(f"{kind} component must be in [0, {limit}), got "
                         f"{component!r}")


def _axes(kind, component, los_axis=2):
    """(a, b) axes of KD's kernel for this kind and component (recon: the
    component's axis and the line of sight)."""
    if kind == "tidal":
        return TIDAL_PAIRS[int(component)]
    if kind == "recon":
        return int(component), int(los_axis)
    if kind in ("grad", "kaiser", "deriv"):
        return int(component), 0
    return 0, 0


def _prefactors(kind, prefactor):
    """KD's (p0, p1, p2, p3) as float32 values: (b, f) for 'kaiser',
    (prefactor, b, f, sigma^2) for 'recon', else (prefactor,)."""
    vals = [float(np.float32(v)) for v in np.ravel(prefactor)]
    if kind == "recon":
        # the smoothing length squared in float32, as jnp squares it
        vals[3] = float(np.float32(vals[3]) * np.float32(vals[3]))
    return tuple(vals + [0.0] * (4 - len(vals)))


def apply_kernel_plain(re, im, shape, spacing, kind, component=0,
                       prefactor=1.0, grad_diag=False, los_axis=2):
    """:func:`apply_kernel` in plain PyTorch, IN PLACE, x-slab by x-slab:
    the float32 operations of ``csrc/spectral_kernel.cu`` in its order.
    Returns (re, im)."""
    _check(kind, component)
    dev = re.device
    full = _grid.kvectors(shape, spacing, torch.float32, dev)
    zeroed = grad_kvectors(shape, spacing, torch.float32, dev)
    a, b = _axes(kind, component, los_axis)
    p0, p1, p2, p3 = _prefactors(kind, prefactor)
    bcast = ((slice(None), None, None), (None, slice(None), None),
             (None, None, slice(None)))
    kx2 = full[0] * full[0]
    ky2 = (full[1] * full[1])[None, :, None]
    kz2 = (full[2] * full[2])[None, None, :]
    for x0 in range(0, re.shape[0], _X_CHUNK):
        rows = slice(x0, x0 + _X_CHUNK)

        def vec(axis, vectors):
            v = vectors[axis]
            return v[rows][:, None, None] if axis == 0 else v[bcast[axis]]

        k2 = (kx2[rows][:, None, None] + ky2) + kz2
        inv = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
        r, i = re[rows], im[rows]
        if kind in ("grad", "deriv"):
            g = p0 * vec(a, zeroed)
            if kind == "grad":
                g = g * inv
            new_re = -(i * g)
            i.copy_(r * g)
            r.copy_(new_re)
            continue
        if kind == "recon":
            kl = vec(b, full)
            smooth = torch.exp((-0.5 * k2) * p3)
            mu2 = torch.where(k2 > 0, (kl * kl) / torch.where(k2 > 0, k2, 1.0),
                              0.0)
            den = p1 + p2 * mu2
            g = (p0 * vec(a, zeroed)) * inv
            new_re = -(((i * smooth) / den) * g)
            i.copy_(((r * smooth) / den) * g)
            r.copy_(new_re)
            continue
        if kind == "scalar":
            g = p0 * inv
        elif kind == "tidal":
            vectors = zeroed if (a != b or grad_diag) else full
            g = ((p0 * vec(a, vectors)) * vec(b, vectors)) * inv
        else:
            kl = vec(a, full)
            g = p0 + p1 * ((kl * kl) * inv)
        r.mul_(g)
        i.mul_(g)
    return re, im


def apply_kernel(re, im, shape, spacing, kind, component=0, prefactor=1.0,
                 grad_diag=False, los_axis=2):
    """KD: a derived field's spectral kernel on a packed spectrum, IN PLACE.

    ``re``/``im``: float32 (nx, ny, nz//2+1) 'xyz' lattices of an ``shape``
    scene.  ``kind`` (with ``component``): 'scalar', c -> prefactor c / k^2;
    'grad' (axis), c -> i prefactor k_a c / k^2; 'tidal' (an index of
    :data:`TIDAL_PAIRS`), c -> prefactor k_a k_b c / k^2; 'kaiser' (the
    line-of-sight axis, ``prefactor`` = (b, f)), c -> (b + f k_a^2 / k^2) c;
    'deriv' (axis), c -> i prefactor k_a c; 'recon' (axis; ``prefactor`` =
    (p, b, f, sigma), ``los_axis``), c -> i p k_a / k^2 exp(-k^2 sigma^2 /
    2) c / (b + f mu^2).  DC maps to 0 (Kaiser: to b c).  The odd kernels
    (grad, deriv, recon's k_a), and with ``grad_diag`` the tidal diagonals
    too (the 2LPT source), take :func:`grad_kvectors`; the others the full
    vectors.  On CUDA this launches
    ``csrc/spectral_kernel.cu``; on the CPU it runs
    :func:`apply_kernel_plain`.  Returns (re, im).
    """
    global KD_LAUNCHES
    _check(kind, component)
    nx, ny, nz = shape
    want = (nx, ny, nz // 2 + 1)
    if (tuple(re.shape) != want or tuple(im.shape) != want
            or re.dtype != torch.float32 or im.dtype != torch.float32
            or re.device != im.device):
        raise ValueError(f"re/im must be float32 {want} lattices on one "
                         f"device, got {tuple(re.shape)} {re.dtype} and "
                         f"{tuple(im.shape)} {im.dtype}")
    if re.device.type == "cpu":
        return apply_kernel_plain(re, im, shape, spacing, kind, component,
                                  prefactor, grad_diag, los_axis)
    if re.device.type != "cuda":
        raise ValueError(f"apply_kernel runs on cpu or cuda, not {re.device}")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("apply_kernel's CUDA kernel needs contiguous tensors")
    a, b = _axes(kind, component, los_axis)
    vals = [1.0 / (n * float(spacing)) for n in shape]
    status = _build.library().rf_spectral_kernel(
        re.data_ptr(), im.data_ptr(), nx, ny, nz, *vals, KINDS[kind], a, b,
        int(bool(grad_diag)), *_prefactors(kind, prefactor),
        _build.current_stream(re))
    _build.check(status, "apply_kernel")
    KD_LAUNCHES += 1
    return re, im


def potential_prefactor(cosmology, z=0.0):
    """-(3/2) Om (1 + z) / D_H^2: the potential's kernel prefactor."""
    return -1.5 * cosmology.Om0 * (1.0 + float(z)) / D_H_MPC_H**2


def velocity_prefactor(cosmology, z=0.0):
    """a H(a) f(a) / h [km/s per Mpc/h]: velocity = this times psi."""
    z = float(z)
    a = 1.0 / (1.0 + z)
    hubble = cosmology.H0 * float(cosmology.efunc(z))
    return a * hubble * float(cosmology.growth_rate(z)) / cosmology.h


# ---- field-first helpers: a forward transform, kernels, inverse transforms ----

def _spectrum(delta):
    """(shape, re, im, 1/N): the field's unnormalized packed spectrum; the
    JAX package's ``norm='forward'`` spectrum is it times 1/N, which the
    callers fold into the kernels' prefactor."""
    delta = torch.as_tensor(delta)
    shape = tuple(int(s) for s in delta.shape[-3:])
    re, im = _transform.rfftn(delta)
    return shape, re, im, 1.0 / (shape[0] * shape[1] * shape[2])


def fields_from_spectrum(re, im, shape, spacing, kind, comps, prefactor,
                         grad_diag=False):
    """One field per component of ``kind``: KD (:func:`apply_kernel`) on a
    copy of the (re, im) spectrum for each component but the last, which
    consumes the spectrum itself, then K3, K3 and K4 with unit weights
    (:func:`.transform.irfftn_reim`).  Returns a list of float32 (nx, ny,
    nz) fields."""
    out = []
    for n, comp in enumerate(comps):
        last = n == len(comps) - 1
        r, i = (re, im) if last else (re.clone(), im.clone())
        apply_kernel(r, i, shape, spacing, kind, comp, prefactor, grad_diag)
        out.append(_transform.irfftn_reim(r, i, shape))
    return out


def delta_to_potential(delta, spacing, cosmology, z=0.0):
    """Dimensionless peculiar potential Phi/c^2 of a density field: the
    comoving Poisson equation grad^2 Phi = (3/2) Om H0^2 (1+z) delta solved
    spectrally."""
    shape, re, im, inv_n = _spectrum(delta)
    pref = potential_prefactor(create_cosmology(cosmology), z) * inv_n
    return fields_from_spectrum(re, im, shape, spacing, "scalar", [0], pref)[0]


def delta_to_displacement(delta, spacing):
    """Zel'dovich displacement psi [Mpc/h], (3, nx, ny, nz): psi_k = i k
    delta_k / k^2, so delta = -div(psi)."""
    shape, re, im, inv_n = _spectrum(delta)
    return torch.stack(fields_from_spectrum(re, im, shape, spacing, "grad",
                                            range(3), inv_n))


def delta_to_velocity(delta, spacing, cosmology, z=0.0):
    """Linear peculiar velocity [km/s], (3, nx, ny, nz): a H(a) f(a) psi."""
    pref = velocity_prefactor(create_cosmology(cosmology), z)
    return delta_to_displacement(delta, spacing) * float(np.float32(pref))


def delta_to_tidal(delta, spacing, component=None):
    """Tidal tensor T_ij = d_i d_j phi, grad^2 phi = delta: one component
    (an index of :data:`TIDAL_PAIRS`), or all six stacked (6, nx, ny, nz).
    The diagonal sums to delta."""
    shape, re, im, inv_n = _spectrum(delta)
    comps = range(6) if component is None else [int(component)]
    out = fields_from_spectrum(re, im, shape, spacing, "tidal", comps, inv_n)
    return out[0] if component is not None else torch.stack(out)


def delta_to_displacement_2lpt(delta, spacing):
    """Second-order (2LPT) displacement correction psi(2) [Mpc/h], (3, nx,
    ny, nz), of the same realization as :func:`delta_to_displacement`.

    With phi,ij the tidal tensor on Nyquist-zeroed vectors (diagonals
    included), S2 = sum_{i<j} [phi,ii phi,jj - phi,ij^2] and psi(2)_k =
    (3/7) i k S2_k / k^2, so div psi(2) = -(3/7) S2 (Scoccimarro 1998; the
    Einstein-de Sitter D2 = -(3/7) D^2 folded in).  One forward transform,
    six tidal inverses, one forward and three gradient inverses: 11.
    """
    shape, re, im, inv_n = _spectrum(delta)
    d00, d11, d22, d01, d02, d12 = fields_from_spectrum(
        re, im, shape, spacing, "tidal", range(6), inv_n, grad_diag=True)
    s2 = (d00 * d11 + d00 * d22 + d11 * d22
          - d01 * d01 - d02 * d02 - d12 * d12)
    del d00, d11, d22, d01, d02, d12
    shape, re, im, inv_n = _spectrum(s2)
    del s2
    return torch.stack(fields_from_spectrum(re, im, shape, spacing, "grad",
                                            range(3), (3.0 / 7.0) * inv_n))
