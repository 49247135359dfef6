"""KH: Poisson counts that replay ``jax.random.poisson`` cell by cell.

The JAX package draws halo counts (``randomfield_tpu/models/halos.py:155``)
and tracer counts (``randomfield_tpu/models/zeldovich.py:114``) with
``jax.random.poisson``, which XLA runs as two whole-array while loops
(``jax/_src/random.py``: ``_poisson_knuth`` for lambda < 10 and NaN,
``_poisson_rejection``, Hormann's transformed rejection, for the rest),
each iteration drawing one uniform array from a key chain that does not
depend on the data.  Both loops can be replayed one cell at a time:

* Knuth: iteration i draws ``uniform(subkey_i)`` with ``(rng_{i+1},
  subkey_i) = split(rng_i)``; a cell's count is the number of iterations
  whose running sum of logs is still above -lambda, less one.  The sum
  never rises (the log of every uniform is <= 0), so a cell stops at its
  first sum <= -lambda and later iterations change nothing.
* Rejection: iteration i draws two uniforms from ``(key_{i+1}, s0, s1) =
  split(key_i, 3)``; ``k_out = select(accept, k, k_out)`` keeps the LAST
  accepting iteration below the loop's end, and the loop runs until every
  cell has accepted once -- the Knuth cells too, at lambda = 1e5.  So one
  maximum over the cells' first acceptances gives the loop's count N, and a
  second walk takes each cell's last acceptance below N.  Where every
  lambda is below 10 the rejection results are discarded (JAX's select),
  and neither walk runs.

The loops' log, exp and lgamma are XLA's CPU float32 functions as
:mod:`.xla_math` repeats them, so the counts here equal
``jax.random.poisson``'s on the JAX package's CPU backend;
``csrc/poisson.cu`` repeats the same operations, so the kernel equals its
plain version bit for bit.

On CUDA tensors :func:`poisson_counts` launches ``csrc/poisson.cu`` (KH,
counter ``KH_LAUNCHES``, one a call: a Knuth pass over every bin and
cell, then a first-acceptance pass and a replay pass that return at once
where no lambda reached 10, all on the stream with no host read); on CPU
tensors it runs :func:`poisson_counts_plain`, a transcription of the two
loops over whole chunks of cells.

Two intensity forms, each in the JAX package's float32 order:

* ``'lognormal'`` (halos): lambda_b = lam0_b exp(b_b g - c_b) with
  c_b = ((0.5 b_b) b_b) sigma_g2, one intensity a mass bin b;
* ``'linear'`` (``poisson_sample``): lambda = max((1 + delta) s, 0).
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops import _build
from randomfield_tpu_torch.ops import threefry as _threefry
from randomfield_tpu_torch.ops.xla_math import (_F32, _div, _f32, _flush,
                                                _fma, xla_exp, xla_lgamma,
                                                xla_log)

__all__ = ["KH_LAUNCHES", "FORMS", "TABLE", "poisson_counts",
           "poisson_counts_plain", "poisson_plain", "intensity",
           "key_tables", "lognormal_constants", "uniform_at",
           "kernel_attributes"]

# kernel launches by poisson_counts (the CPU path does not count)
KH_LAUNCHES = 0

# the intensity forms, as csrc/poisson.cu numbers them
FORMS = {"lognormal": 0, "linear": 1}

# iterations of each loop whose subkeys the host tabulates for the kernel
# (a thread derives further ones from the chain key after them)
TABLE = 64

# cells a step of the plain version (bounds its int64 temporaries)
_CHUNK = 1 << 24


# ---- the two loops ----------------------------------------------------

def uniform_at(key, idx: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` at the flat indices
    ``idx`` of its shape: the mantissa of the cell's bits over [1, 2), less
    one."""
    bits = _threefry.bits_at(key, idx)
    return (((bits >> 9) | 0x3F800000).to(torch.int32).view(_F32) - 1.0)


def _knuth(key, lam, idx):
    """The Knuth loop on cells of intensities ``lam`` at flat indices
    ``idx``: each iteration draws the uniforms of the cells whose running
    sum is still above -lambda (the others are done: the sum never rises).
    Returns count - 1 for every cell, as the loop's k - 1."""
    k = torch.zeros(lam.shape, dtype=torch.int32, device=lam.device)
    log_prod = torch.zeros_like(lam)
    live = torch.nonzero(log_prod > -lam).reshape(-1)
    rng = key
    while live.numel():
        rng, sub = _threefry.split(rng)
        k[live] += 1
        log_prod[live] += xla_log(uniform_at(sub, idx[live]))
        live = live[log_prod[live] > -lam[live]]
    return k - 1


def _rejection_constants(lam):
    log_lam = xla_log(lam)
    b = _fma(torch.sqrt(lam), _f32(2.53), _f32(0.931))
    a = _fma(b, _f32(0.02483), _f32(-0.059))
    inv_alpha = _f32(1.1239) + _div(_f32(1.1328), b - _f32(3.4))
    v_r = _f32(0.9277) - _div(_f32(3.6224), b - 2.0)
    return log_lam, b, a, inv_alpha, v_r


def _rejection_step(keys, lam, consts, idx):
    """One iteration on the subkeys ``keys`` = (s0, s1): (k, accept)."""
    log_lam, b, a, inv_alpha, v_r = consts
    u = uniform_at(keys[0], idx) - 0.5
    v = uniform_at(keys[1], idx)
    us = 0.5 - u.abs()
    k = torch.floor(_fma((2.0 * a) / us + b, u, lam) + _f32(0.43))
    s = xla_log((v * inv_alpha) / (a / (us * us) + b))
    t = _fma(k, log_lam, -lam) - xla_lgamma(k + 1.0)
    accept1 = (us >= _f32(0.07)) & (v <= v_r)
    reject = (k < 0) | ((us < _f32(0.013)) & (v > us))
    return k, accept1 | (~reject & (s <= t))


def _first_acceptances(key, lam, idx):
    """The iterations the rejection loop needs until every cell of ``lam``
    has accepted once (each iteration evaluates the cells still waiting)."""
    waiting = torch.arange(lam.numel(), device=lam.device)
    consts = _rejection_constants(lam)
    n = 0
    while waiting.numel():
        key, s0, s1 = _threefry.split(key, 3)
        _, accept = _rejection_step(
            (s0, s1), lam[waiting], [c[waiting] for c in consts],
            idx[waiting])
        waiting = waiting[~accept]
        n += 1
    return n


def _rejection(key, lam, idx, iters):
    """The rejection loop's k_out after ``iters`` iterations: the k of each
    cell's last acceptance (-1 where none)."""
    consts = _rejection_constants(lam)
    k_out = torch.full_like(lam, -1.0)
    for _ in range(iters):
        key, s0, s1 = _threefry.split(key, 3)
        k, accept = _rejection_step((s0, s1), lam, consts, idx)
        k_out = torch.where(accept, k, k_out)
    return k_out


def poisson_plain(key, lam: torch.Tensor, chunk: int = _CHUNK,
                  offset: int = 0) -> torch.Tensor:
    """``jax.random.poisson(key, lam, dtype=int32)`` for float32 ``lam``, in
    plain PyTorch on ``lam``'s device, a chunk of ``chunk`` cells at a
    time: the Knuth loop on the lambda < 10 cells; where a lambda reached
    10, the rejection loop's count (the most iterations any cell, the Knuth
    cells at lambda = 1e5, needs for its first acceptance) and the
    lambda >= 10 cells' walks of that many iterations.  ``offset``: the
    flat index of ``lam``'s first cell in a larger draw (a Knuth cell
    replays alone; a rejection cell then takes the count of ``lam``'s own
    loop)."""
    key = _threefry.as_key(key)
    flat = lam.reshape(-1).to(_F32)
    n = flat.numel()
    use_knuth = torch.isnan(flat) | (flat < 10.0)
    out = torch.empty(n, dtype=torch.int32, device=flat.device)
    spans = [(c, min(n, c + chunk)) for c in range(0, n, chunk)]

    def idx(c0, c1):
        return torch.arange(offset + c0, offset + c1, dtype=torch.int64,
                            device=flat.device)

    for c0, c1 in spans:
        lk = torch.where(use_knuth[c0:c1], flat[c0:c1], 0.0)
        out[c0:c1] = _knuth(key, lk, idx(c0, c1))
    if not bool(use_knuth.all()):
        lam_rej = torch.where(use_knuth, 1e5, flat)
        total = max(_first_acceptances(key, lam_rej[c0:c1], idx(c0, c1))
                    for c0, c1 in spans)
        for c0, c1 in spans:
            cells = torch.nonzero(~use_knuth[c0:c1]).reshape(-1)
            k_rej = _rejection(key, lam_rej[c0:c1][cells],
                               idx(c0, c1)[cells], total)
            out[c0 + cells] = k_rej.to(torch.int32)
    out = torch.where(flat == 0, 0, out)
    return out.reshape(lam.shape)


# ---- intensities, keys, the wrapper ----------------------------------------

def lognormal_constants(lam0, bias, sigma_g2):
    """float32 (lam0_b, b_b, c_b) of the 'lognormal' form, c_b = ((0.5 b_b)
    b_b) sigma_g2 as the JAX package's scan body rounds it."""
    lam0 = np.asarray(lam0, np.float32).reshape(-1)
    b = np.asarray(bias, np.float32).reshape(-1)
    c = (np.float32(0.5) * b * b) * np.float32(sigma_g2)
    return lam0, b, c.astype(np.float32)


def intensity(g, form, b=0, lam0=None, bias=None, sigma_g2=0.0, scale=1.0):
    """float32 lambda of bin ``b`` on ``g``'s device, as the kernel forms it
    (:data:`FORMS`)."""
    g = g.to(_F32)
    if form == "lognormal":
        l0, bb, c = lognormal_constants(lam0, bias, sigma_g2)
        return _flush(float(l0[b])
                      * xla_exp(_fma(g, float(bb[b]), -float(c[b]))))
    if form == "linear":
        return _flush(torch.clamp_min((1.0 + g) * _f32(scale), 0.0))
    raise ValueError(f"unknown intensity form {form!r}; use {sorted(FORMS)}")


def _keys(keys):
    return [_threefry.as_key(k) for k in keys]


def poisson_counts_plain(g, keys, form="lognormal", lam0=None, bias=None,
                         sigma_g2=0.0, scale=1.0):
    """:func:`poisson_counts` in plain PyTorch on ``g``'s device."""
    keys = _keys(keys)
    out = torch.empty((len(keys), *g.shape), dtype=torch.int32,
                      device=g.device)
    for b, key in enumerate(keys):
        out[b] = poisson_plain(key, intensity(g, form, b, lam0, bias,
                                              sigma_g2, scale))
    return out


def key_tables(keys, table=TABLE):
    """The kernel's key table, uint32 words as int32, (nbins, 6 table + 4):
    for each bin the Knuth subkeys of iterations 0..table-1 (2 words each)
    and the chain key after them (2), then the rejection subkey pairs
    (s0, s1) of the same iterations (4 words each) and their chain key."""
    rows = []
    for key in _keys(keys):
        row = []
        rng = key
        for _ in range(table):
            rng, sub = _threefry.split(rng)
            row += sub
        row += rng
        rng = key
        for _ in range(table):
            rng, s0, s1 = _threefry.split(rng, 3)
            row += s0 + s1
        row += rng
        rows.append(row)
    return np.asarray(rows, np.uint32).view(np.int32)


def kernel_attributes(mode):
    """(registers a thread, blocks an SM, threads a block) of KH's pass
    ``mode`` (0 Knuth, 1 first acceptance, 2 replay) as
    ``cudaFuncGetAttributes`` and the occupancy calculator report them;
    builds the library."""
    import ctypes

    out = [ctypes.c_int() for _ in range(3)]
    status = _build.library().rf_poisson_attributes(
        int(mode), *[ctypes.byref(v) for v in out])
    _build.check(status, "poisson attributes")
    return tuple(v.value for v in out)


def poisson_counts(g, keys, form="lognormal", lam0=None, bias=None,
                   sigma_g2=0.0, scale=1.0, out=None, table=TABLE):
    """KH: ``jax.random.poisson(keys[b], lambda_b, dtype=int32)`` for every
    bin b of one field ``g``, as an int32 (nbins, *g.shape) tensor on its
    device.

    ``g``: float32; ``keys``: one key a bin (a seed or a pair of uint32
    words, :func:`.threefry.as_key`); ``form`` 'lognormal' (``lam0``,
    ``bias`` a bin and ``sigma_g2``) or 'linear' (``scale``, one key).  On
    CUDA it launches ``csrc/poisson.cu`` (g read once for every bin), its
    threads reading the first ``table`` subkeys of each chain from
    :func:`key_tables` and deriving the rest; on the CPU it runs
    :func:`poisson_counts_plain`.
    """
    global KH_LAUNCHES
    if form not in FORMS:
        raise ValueError(f"unknown intensity form {form!r}; use {sorted(FORMS)}")
    g = torch.as_tensor(g)
    if g.dtype != _F32:
        raise ValueError(f"poisson_counts takes a float32 field, got {g.dtype}")
    keys = _keys(keys)
    nbins = len(keys)
    if form == "lognormal":
        l0, bb, c = lognormal_constants(lam0, bias, sigma_g2)
        if not (l0.size == bb.size == nbins):
            raise ValueError(f"{nbins} keys need {nbins} lam0 and bias "
                             f"values, got {l0.size} and {bb.size}")
    elif nbins != 1:
        raise ValueError("the 'linear' form takes one key")
    if table < 0:
        raise ValueError(f"the key table takes table >= 0, got {table}")
    if out is not None and (
            out.dtype != torch.int32 or tuple(out.shape) != (nbins, *g.shape)
            or not out.is_contiguous() or out.device != g.device):
        raise ValueError("out must be a contiguous int32 (nbins, *g.shape) "
                         "tensor on g's device")
    if g.device.type == "cpu":
        res = poisson_counts_plain(g, keys, form, lam0, bias, sigma_g2,
                                   scale)
        return res if out is None else out.copy_(res)
    if g.device.type != "cuda":
        raise ValueError(f"poisson_counts runs on cpu or cuda, not {g.device}")
    g = g.contiguous()
    n = g.numel()
    if out is None:
        out = torch.empty((nbins, *g.shape), dtype=torch.int32,
                          device=g.device)
    dev = g.device
    if form == "lognormal":
        params = torch.as_tensor(np.stack([l0, bb, c]), device=dev)
    else:
        params = torch.tensor([[_f32(scale)], [0.0], [0.0]], dtype=_F32,
                              device=dev)
    words = torch.as_tensor(key_tables(keys, table), device=dev)
    # per bin: the flag "a lambda >= 10 was seen" and the rejection loop's
    # iteration count
    state = torch.zeros((2, nbins), dtype=torch.int32, device=dev)
    status = _build.library().rf_poisson_counts(
        g.data_ptr(), out.data_ptr(), n, nbins, FORMS[form],
        params.data_ptr(), words.data_ptr(), table, state.data_ptr(),
        _build.current_stream(g))
    _build.check(status, "poisson_counts")
    KH_LAUNCHES += 1
    return out
