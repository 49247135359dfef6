"""Pod-scale survey workflow: sharded mocks -> sharded painting -> FKP.

Port of ``examples/pod_survey_catalog.py``.  Every rank of a slab mesh
runs it: the density field, the painted survey grids and the estimator's
spectrum stay in x slabs, and only the halo catalog and the bins are whole
on every rank.

1. a biased lognormal tracer intensity from a sharded render
   (``HaloGenerator(mesh=)``: each rank's count slab equals the single
   device's rows bit for bit),
2. the counts gathered and compacted to (3, N) positions on every rank,
3. sharded TSC painting + FKP against a uniform randoms catalog
   (``validate/fkp.py`` with ``mesh=``: KP on each rank's x window),
4. the deconvolved, shot-subtracted P(k) vs the halo model expectation.

Rank 0 prints the JAX script's lines.  On one process it runs on a
one-rank mesh; under ``torchrun`` (one GPU a rank)

    torchrun --nproc-per-node 2 -m randomfield_tpu_torch.examples.pod_survey_catalog --multihost

joins the NCCL group first and runs on a mesh of every rank.
"""

import argparse

import numpy as np

from randomfield_tpu_torch.models.halos import HaloGenerator
from randomfield_tpu_torch.parallel import mesh as pmesh
from randomfield_tpu_torch.validate.fkp import fkp_power


def main(device=None, n=None, mesh=None):
    """The workflow on ``mesh`` (this rank's slab mesh; by default one over
    the joined process group, or this process alone on ``device``)."""
    n = n or 64
    spacing = 8.0
    if mesh is None:
        mesh = pmesh.make_mesh(device=device)
    box = n * spacing

    def say(text):
        if mesh.rank == 0:
            print(text)

    hg = HaloGenerator(n, n, n, grid_spacing=spacing, mmin=1e13, mmax=1e15,
                       nbins_mass=2, fit="st", mesh=mesh)
    positions, masses = hg.generate_halo_catalog(seed=1)
    expected = float(hg.expected_counts().sum())
    say(f"catalog: {len(masses)} halos "
        f"(expected {expected:.0f}), "
        f"biases {np.round(hg.bias, 2)}")

    rng = np.random.RandomState(99)
    randoms = rng.uniform(0, box, size=(3, 20 * len(masses))).astype(
        np.float32)

    est = fkp_power(
        positions.astype(np.float32).T, randoms, spacing, (n, n, n),
        nbins=10, window="tsc", mesh=mesh,
    )
    k_exp, p_exp, cnt = hg.predicted_combined_power(nbins=10,
                                                    shot_noise=False)
    p_exp = np.asarray(p_exp)

    say(f"alpha {est.alpha:.4f}, shot noise {est.shot_noise:.1f} (Mpc/h)^3")
    say("bin  k          P_FKP        P_model")
    rows = [i for i in range(len(est.k))
            if est.n_modes[i] > 0 and np.isfinite(est.p[i])]
    for i in rows:
        say(f"{i:3d}  {est.k[i]:8.4f}  {est.p[i]:11.1f}  {p_exp[i]:11.1f}")
    return dict(halos=len(masses), halos_expected=expected,
                alpha=est.alpha, shot_noise=est.shot_noise,
                p_fkp=np.asarray(est.p)[rows], p_model=p_exp[rows])


def _cli(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, choices=["cuda", "cpu"])
    p.add_argument("--n", type=int, default=None,
                   help="grid size (default: the example's own)")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group torchrun describes first "
                        "(NCCL; gloo with --device cpu)")
    args = p.parse_args(argv)
    if args.multihost:
        from randomfield_tpu_torch.parallel import multihost

        multihost.initialize("gloo" if args.device == "cpu" else "nccl")
        try:
            main(device=args.device, n=args.n)
        finally:
            multihost.shutdown()
    else:
        main(device=args.device, n=args.n)


if __name__ == "__main__":
    _cli()
