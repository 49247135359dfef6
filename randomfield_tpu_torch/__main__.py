"""Command-line interface: render fields and report statistics.

    python -m randomfield_tpu_torch --nx 128 --spacing 4.0 --seed 0 \
        --smoothing 2.0 --out field.npz --stats

Port of ``randomfield_tpu/__main__.py``: the same flags, defaults,
choices, usage errors and printed lines, on the port's hand kernels, and
``.npz`` files in the JAX package's format.  One flag is new: ``--device``
(``cuda`` by default; ``cpu`` runs every kernel's plain version and must
be asked for).  Without a card the default refuses to run.  On a slab
mesh (``--mesh 1,P``, one process per rank, ``--multihost`` to join them)
each rank renders its x slab and ``--out`` writes its own chunk; what the
port does not run on a mesh raises the library's own NotImplementedError.
"""

from __future__ import annotations

import argparse
import sys
import time


def _catalog_mode(args, p, ny, nz, cosmology, power, device):
    """--catalog branch: halo / HOD-galaxy catalogs per seed."""
    import numpy as np
    import torch

    if args.catalog == "halos":
        from randomfield_tpu_torch.models.halos import HaloGenerator

        gen = HaloGenerator(
            args.nx, ny, nz, grid_spacing=args.spacing, cosmology=cosmology,
            power=power, mmin=args.mmin, mmax=args.mmax,
            nbins_mass=args.mass_bins, fit=args.fit, device=device,
        )
        if not args.quiet:
            print("bin  <M> [Msun/h]   nbar [(Mpc/h)^-3]   b")
            for i in range(len(gen.nbar)):
                print(f"  {i}  {gen.mass_centers[i]:12.3e}  "
                      f"{gen.nbar[i]:17.3e}  {gen.bias[i]:5.2f}")
    else:
        from randomfield_tpu_torch.models.hod import HODGenerator

        gen = HODGenerator(
            args.nx, ny, nz, grid_spacing=args.spacing, cosmology=cosmology,
            power=power, mmin=args.mmin, mmax=args.mmax,
            nbins_mass=args.mass_bins, fit=args.fit, device=device,
        )
        if not args.quiet:
            print(f"n_g = {gen.galaxy_density:.3e} (Mpc/h)^-3, "
                  f"b_g = {gen.galaxy_bias:.2f}, "
                  f"expected {gen.expected_galaxies():.0f} galaxies")

    for seed in args.seed:
        t0 = time.perf_counter()
        if args.catalog == "halos":
            pos, mass = gen.generate_halo_catalog(
                seed, smoothing_length=args.smoothing)
            n = pos.shape[0]
            note = f"{n} halos (expected {gen.expected_counts().sum():.0f})"
        else:
            pos, is_cen = gen.generate_galaxy_catalog(
                seed, smoothing_length=args.smoothing,
                rsd=args.catalog == "galaxies-rsd",
            )
            n = pos.shape[0]
            note = (f"{n} galaxies ({int(is_cen.sum())} centrals, "
                    f"{int((~is_cen).sum())} satellites)")
        if not args.quiet:
            print(f"seed {seed}: {note} in {time.perf_counter() - t0:.2f}s")
        if args.stats and n:
            from randomfield_tpu_torch.models.zeldovich import catalog_power

            shape = (args.nx, ny, nz)
            # the (3, N) float32 positions go to the scene's device once,
            # so KP paints them there
            k, ph, nm = catalog_power(
                torch.as_tensor(np.asarray(pos, np.float32).T, device=device),
                args.spacing, shape=shape, nbins=args.nbins)
            if args.catalog == "halos":
                k_e, p_exp, _ = gen.predicted_combined_power(
                    nbins=args.nbins, shot_noise=False)
            else:
                k_e, p_exp, _ = gen.predicted_galaxy_power(
                    nbins=args.nbins, shot_noise=False)
                if args.catalog == "galaxies-rsd":
                    # Kaiser monopole boost (linear; FOG damps high k)
                    beta = float(gen.cosmology.growth_rate(gen.z)) \
                        / gen.galaxy_bias
                    p_exp = p_exp * (1.0 + 2.0 * beta / 3.0 + beta**2 / 5.0)
            for i in range(len(k)):
                if nm[i] > 0:
                    print(f"  k = {k[i]:9.4f}  P^ = {ph[i]:12.2f}  "
                          f"(exp {p_exp[i]:12.2f})  ({nm[i]:8.0f} modes)")
        if args.out:
            path = args.out.replace("{seed}", str(seed))
            extra = dict(seed=seed, spacing=args.spacing,
                         catalog=args.catalog, fit=args.fit,
                         mmin=args.mmin, mmax=args.mmax)
            if args.catalog == "halos":
                np.savez(path, positions=pos, masses=mass, **extra)
            else:
                np.savez(path, positions=pos, is_central=is_cen, **extra)
            if not args.quiet:
                print(f"  wrote {path}")
    return 0


def _parser():
    p = argparse.ArgumentParser(
        prog="randomfield_tpu_torch", description=__doc__.splitlines()[0]
    )
    p.add_argument("--nx", type=int, default=128)
    p.add_argument("--ny", type=int, default=None)
    p.add_argument("--nz", type=int, default=None)
    p.add_argument("--spacing", type=float, required=True,
                   help="grid spacing in Mpc/h")
    p.add_argument("--seed", type=int, nargs="+", default=[0])
    p.add_argument("--smoothing", type=float, default=0.0,
                   help="Gaussian smoothing length in Mpc/h")
    p.add_argument("--cosmology", default="Planck13",
                   choices=["Planck13", "Planck15", "Planck18"])
    p.add_argument("--w0", type=float, default=None,
                   help="CPL dark-energy w0 override (default -1)")
    p.add_argument("--wa", type=float, default=None,
                   help="CPL dark-energy wa override (default 0)")
    p.add_argument("--ok0", type=float, default=None,
                   help="curvature Omega_k0 override (default 0, flat)")
    p.add_argument("--power", default=None,
                   help="a model name (default|eh98|bbks|halofit) or a "
                        "CAMB-style "
                        "text file (k [h/Mpc], P [(Mpc/h)^3], '#' comments, "
                        "extra columns ignored); default: built-in EH98 "
                        "Planck13 table")
    p.add_argument("--lognormal", action="store_true",
                   help="render lognormal mock fields (Coles-Jones "
                        "Gaussianized spectrum) instead of Gaussian ones")
    p.add_argument("--fixed", action="store_true",
                   help="variance-suppressed 'fixed' realizations "
                        "(|c_k| pinned to sigma(k); Angulo-Pontzen)")
    p.add_argument("--flip", action="store_true",
                   help="with --fixed: render the paired (phase-"
                        "conjugate) realization of each seed")
    p.add_argument("--bias", type=float, default=None,
                   help="with --lognormal: render biased tracer fields "
                        "exp(b g - b^2 sigma_G^2/2) - 1; with --rsd: the "
                        "linear Kaiser tracer bias b (linear bias b)")
    p.add_argument("--rsd", nargs="?", const="auto", default=None,
                   metavar="F",
                   help="render linear Kaiser redshift-space fields "
                        "(b + f mu^2) delta_k along the z axis (snapshot: "
                        "needs --no-lightcone); optional F overrides the "
                        "growth rate (default cosmology.growth_rate(0)); "
                        "--bias sets b; --stats prints P_0/P_2/P_4 against "
                        "their exact expectations")
    p.add_argument("--xi", action="store_true",
                   help="with --stats: also print the measured two-point "
                        "correlation xi(r) per seed")
    p.add_argument("--minkowski", action="store_true",
                   help="print Minkowski functionals v0..v3 per seed "
                        "(with exact Gaussian predictions for plain "
                        "Gaussian renders; requires --no-lightcone)")
    p.add_argument("--voids", type=str, default=None, metavar="R1,R2,..",
                   help="find SO voids with this ascending radius ladder "
                        "(same units as --spacing); prints the catalog "
                        "summary and the void size function")
    p.add_argument("--void-threshold", type=float, default=-0.4,
                   help="enclosed-density threshold for --voids")
    p.add_argument("--peaks", action="store_true",
                   help="print lattice peak counts by height per seed "
                        "(with BBKS predictions for plain Gaussian "
                        "renders; requires --no-lightcone)")
    p.add_argument("--catalog", default=None,
                   choices=["halos", "galaxies", "galaxies-rsd"],
                   help="draw object catalogs instead of fields: 'halos' "
                        "(mass-function + PBS-bias Poisson halos), "
                        "'galaxies' (Zheng05 HOD on those halos), "
                        "'galaxies-rsd' (same, redshift-space along z); "
                        "--stats prints the catalog P(k) vs its "
                        "expectation, --out saves positions (+masses / "
                        "is_central)")
    p.add_argument("--mmin", type=float, default=1e13,
                   help="with --catalog: minimum halo mass [Msun/h]")
    p.add_argument("--mmax", type=float, default=1e15,
                   help="with --catalog: maximum halo mass [Msun/h]")
    p.add_argument("--mass-bins", type=int, default=4,
                   help="with --catalog: number of log-uniform mass bins")
    p.add_argument("--fit", default="st", choices=["ps", "st", "tinker08"],
                   help="with --catalog: mass-function fit (bias follows)")
    p.add_argument("--no-lightcone", action="store_true")
    p.add_argument("--out", default=None,
                   help="output .npz path ({seed} is substituted; a "
                        "directory of chunks on a mesh)")
    p.add_argument("--stats", action="store_true",
                   help="print realized P(k) and moments per seed")
    p.add_argument("--nbins", type=int, default=16)
    p.add_argument("--sample-power", action="store_true",
                   help="FFT-free spectrum-space P(k) per seed (config-4 "
                        "ensemble mode: no field is rendered; O(1) memory)")
    p.add_argument("--checkpoint", default=None,
                   help="with --sample-power: persist per-seed spectra to "
                        "this .npz and resume interrupted ensembles")
    p.add_argument("--mesh", default=None, metavar="DATA,SPACE",
                   help="('data','space') slab mesh over the process "
                        "group, e.g. '1,4': the grid slab-decomposes over "
                        "'space' (one process per rank; a 'data' axis is "
                        "not ported)")
    p.add_argument("--pencil", default=None, metavar="DATA,SPX,SPY",
                   help="('data','spx','spy') pencil mesh (not ported: "
                        "refused)")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group first (NCCL under "
                        "torchrun; gloo with --device cpu)")
    p.add_argument("--sampler", default="threefry",
                   choices=["threefry", "pallas", "nested"],
                   help="mode sampler: the Threefry stream (default; the "
                        "JAX package's, bit for bit), 'pallas' (the fused "
                        "counter-based sampler K1: its own stream family), "
                        "or 'nested' (resolution-nested zoom stream)")
    p.add_argument("--pipeline", default="auto",
                   choices=["auto", "fused", "staged"],
                   help="render pipeline (engine/staged.py)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the CUDA card (default) or the CPU, "
                        "every kernel's plain version (asked for "
                        "explicitly)")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None):
    """Run the command line ``argv`` (``sys.argv[1:]`` by default); returns
    the exit code.  Usage errors exit with code 2."""
    p = _parser()
    args = p.parse_args(argv)

    import numpy as np
    import torch

    import randomfield_tpu_torch as rft
    from randomfield_tpu_torch.utils.io import save_field

    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda (the default) needs a CUDA card and "
                "torch.cuda.is_available() is False; pass --device cpu to "
                "run on the CPU")
    device = torch.device(args.device)

    if args.multihost:
        from randomfield_tpu_torch.parallel.multihost import initialize

        device = initialize("nccl" if device.type == "cuda" else "gloo")

    # the mesh is built once every flag has been checked
    mesh_shape = None
    if args.mesh and args.pencil:
        p.error("--mesh and --pencil are mutually exclusive")
    if args.mesh:
        try:
            mesh_shape = tuple(int(v) for v in args.mesh.split(","))
            data, space = mesh_shape
        except ValueError:
            p.error("--mesh takes 'DATA,SPACE' integers, e.g. '2,4'")
    elif args.pencil:
        try:
            mesh_shape = tuple(int(v) for v in args.pencil.split(","))
            data, spx, spy = mesh_shape
        except ValueError:
            p.error("--pencil takes 'DATA,SPX,SPY' integers, e.g. '1,2,4'")

    power = None
    if args.power:
        if args.power.lower() in ("default", "eh98", "eisenstein_hu",
                                  "bbks", "halofit"):
            power = args.power.lower()
        else:
            from randomfield_tpu_torch.models.powerspec import load_camb_power

            power = load_camb_power(args.power)

    cosmology = args.cosmology
    overrides = {
        k: v for k, v in
        (("w0", args.w0), ("wa", args.wa), ("Ok0", args.ok0))
        if v is not None
    }
    if overrides:
        import dataclasses

        from randomfield_tpu_torch.models.cosmology import create_cosmology

        cosmology = dataclasses.replace(
            create_cosmology(cosmology), name="custom", **overrides
        )

    if args.fixed and args.sample_power:
        p.error("--fixed renders fields (its sampled P(k) is exact by "
                "construction); drop --sample-power")
    if args.flip and not args.fixed:
        p.error("--flip only applies to --fixed (paired realizations)")
    if args.bias is not None:
        if not (args.lognormal or args.rsd is not None):
            p.error("--bias needs --lognormal (the deterministic lognormal "
                    "bias model) or --rsd (linear Kaiser bias)")
        if args.fixed:
            p.error("--bias composes with random-phase fields only; drop "
                    "--fixed")
    if args.rsd is not None:
        for flag, name in ((args.lognormal, "--lognormal"),
                           (args.fixed, "--fixed"),
                           (args.sample_power, "--sample-power"),
                           (args.minkowski, "--minkowski"),
                           (args.peaks, "--peaks"), (args.xi, "--xi")):
            if flag:
                p.error(f"--rsd renders anisotropic snapshot fields; drop "
                        f"{name}")
        if not args.no_lightcone:
            p.error("--rsd is a snapshot model (redshift enters through "
                    "the growth rate only); add --no-lightcone")
    if (args.minkowski or args.peaks) and not args.no_lightcone:
        p.error("--minkowski/--peaks measure homogeneous-field "
                "morphology; render with --no-lightcone")
    if (args.minkowski or args.peaks) and args.sample_power:
        p.error("--minkowski/--peaks need rendered fields; drop "
                "--sample-power")
    if args.xi and not args.stats:
        p.error("--xi prints alongside --stats; add --stats")
    ny = args.ny or args.nx
    nz = args.nz or args.nx
    if args.catalog:
        for flag, name in ((args.lognormal, "--lognormal"),
                           (args.fixed, "--fixed"),
                           (args.rsd is not None, "--rsd"),
                           (args.sample_power, "--sample-power"),
                           (args.minkowski, "--minkowski"),
                           (args.peaks, "--peaks"), (args.xi, "--xi"),
                           (mesh_shape is not None, "--mesh/--pencil")):
            if flag:
                p.error(f"--catalog draws object catalogs (single-device, "
                        f"host compaction); drop {name}")
        return _catalog_mode(args, p, ny, nz, cosmology, power, device)
    if args.lognormal and args.sample_power:
        p.error("--lognormal is field-space only (the sampled spectrum "
                "would be the Gaussianized one, not the target); drop "
                "--sample-power")
    mesh = None
    if args.mesh:
        from randomfield_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(data=data, space=space, device=device)
    elif args.pencil:
        from randomfield_tpu_torch.parallel.mesh import make_pencil_mesh

        mesh = make_pencil_mesh(data=data, spx=spx, spy=spy)
    if args.lognormal:
        from randomfield_tpu_torch.models.lognormal import LognormalGenerator

        gen = LognormalGenerator(
            args.nx, ny, nz, grid_spacing=args.spacing, cosmology=cosmology,
            power=power, mesh=mesh, device=device,
        )
    else:
        gen = rft.Generator(
            args.nx, ny, nz, grid_spacing=args.spacing, cosmology=cosmology,
            power=power, mesh=mesh, sampler=args.sampler,
            pipeline=args.pipeline, device=device,
        )
    if args.sample_power:
        from randomfield_tpu_torch.validate.ensemble import (
            power_covariance, sample_power_ensemble,
        )

        t0 = time.perf_counter()
        k, p_hat, nm = sample_power_ensemble(
            gen, args.seed, smoothing_length=args.smoothing,
            nbins=args.nbins, checkpoint_path=args.checkpoint,
        )
        if not args.quiet:
            print(f"{len(args.seed)} seeds in {time.perf_counter() - t0:.2f}s"
                  + (f" (checkpoint: {args.checkpoint})" if args.checkpoint
                     else ""))
        mean_p = np.nanmean(p_hat, axis=0)
        std_p = np.nanstd(p_hat, axis=0) if len(args.seed) > 1 else None
        for i in range(len(k)):
            if nm[i] > 0:
                line = f"  k = {k[i]:9.4f}  <P^> = {mean_p[i]:12.2f}"
                if std_p is not None:
                    line += f"  scatter = {std_p[i]:10.2f}"
                print(line + f"  ({nm[i]:8.0f} modes)")
        if args.out and len(args.seed) > 1:
            cov = power_covariance(p_hat)
            np.savez(args.out.replace("{seed}", "ensemble"),
                     k=k, p_hat=p_hat, n_modes=nm, covariance=cov,
                     seeds=np.asarray(args.seed))
            if not args.quiet:
                print(f"  wrote {args.out.replace('{seed}', 'ensemble')}")
        return 0

    for seed in args.seed:
        t0 = time.perf_counter()
        if args.fixed:
            delta = gen.generate_fixed_field(
                seed, smoothing_length=args.smoothing,
                apply_lightcone=not args.no_lightcone, flip=args.flip,
            )
        elif args.rsd is not None:
            delta = gen.generate_kaiser_field(
                seed, bias=1.0 if args.bias is None else args.bias,
                f=None if args.rsd == "auto" else float(args.rsd),
                smoothing_length=args.smoothing,
            )
        elif args.bias is not None:
            delta = gen.generate_biased_field(
                seed, bias=args.bias, smoothing_length=args.smoothing,
                apply_lightcone=not args.no_lightcone,
            )
        else:
            delta = gen.generate_delta_field(
                seed, smoothing_length=args.smoothing,
                apply_lightcone=not args.no_lightcone,
            )
        if delta.is_cuda:
            torch.cuda.synchronize(delta.device)
        if not args.quiet:
            print(f"seed {seed}: rendered in {time.perf_counter() - t0:.3f}s")
        if args.stats and args.rsd is not None:
            from randomfield_tpu_torch.validate.stats import (
                calculate_power_multipoles,
            )

            k, pl, nm = calculate_power_multipoles(
                delta, args.spacing, nbins=args.nbins, mesh=mesh
            )
            _, pp, _ = gen.predicted_kaiser_multipoles(
                bias=1.0 if args.bias is None else args.bias,
                f=None if args.rsd == "auto" else float(args.rsd),
                nbins=args.nbins, smoothing_length=args.smoothing,
            )
            for i in range(len(k)):
                if nm[i] > 0:
                    print(f"  k = {k[i]:9.4f}  P0 = {pl[0][i]:12.2f} "
                          f"(exp {pp[0][i]:12.2f})  P2 = {pl[1][i]:+12.2f} "
                          f"(exp {pp[1][i]:+12.2f})  P4 = {pl[2][i]:+11.2f} "
                          f"(exp {pp[2][i]:+11.2f})  ({nm[i]:8.0f} modes)")
        elif args.stats:
            from randomfield_tpu_torch.validate.stats import field_moments

            mean, var = field_moments(delta, mesh=mesh)
            pv = (gen.predicted_variance(args.smoothing, bias=args.bias)
                  if args.bias is not None
                  else gen.predicted_variance(args.smoothing))
            print(f"  mean = {mean:+.3e}  var = {var:.5f} "
                  f"(predicted {pv:.5f} before lightcone weighting)")
            k, ph, nm = gen.calculate_power(delta, nbins=args.nbins)
            for i in range(len(k)):
                if nm[i] > 0:
                    print(f"  k = {k[i]:9.4f}  P^ = {ph[i]:12.2f}  "
                          f"({nm[i]:8.0f} modes)")
            if args.xi:
                from randomfield_tpu_torch.validate.stats import (
                    calculate_correlation,
                )

                r, xi, nc = calculate_correlation(
                    delta, args.spacing, nbins=args.nbins, mesh=mesh
                )
                for i in range(len(r)):
                    if nc[i] > 0:
                        print(f"  r = {r[i]:9.3f}  xi = {xi[i]:+.5e}  "
                              f"({nc[i]:10.0f} cells)")
        if args.minkowski or args.peaks:
            # exact Gaussian predictions only apply to the plain render
            gaussian = not (args.lognormal or args.bias is not None
                            or args.fixed)
            sig0 = (np.sqrt(gen.predicted_variance(args.smoothing))
                    if gaussian else None)
        if args.minkowski:
            from randomfield_tpu_torch.validate.minkowski import (
                minkowski_functionals,
            )

            nu, v0, v1, v2, v3 = minkowski_functionals(
                delta, args.spacing, nbins=args.nbins, sigma0=sig0,
                mesh=mesh,
            )
            preds = (gen.predicted_minkowski(nu, args.smoothing)
                     if gaussian else None)
            for i in range(len(nu)):
                line = (f"  nu = {nu[i]:+6.2f}  v0 = {v0[i]:.4f}  "
                        f"v1 = {v1[i]:.3e}  v2 = {v2[i]:+.3e}  "
                        f"v3 = {v3[i]:+.3e}")
                if preds is not None:
                    line += (f"   [exp v3 = {preds[3][i]:+.3e}]")
                print(line)
        if args.peaks:
            from randomfield_tpu_torch.validate.peaks import peak_statistics

            nu_c, counts, total = peak_statistics(
                delta, args.spacing, sigma0=sig0, mesh=mesh,
            )
            exp = (gen.predicted_peaks(smoothing_length=args.smoothing)
                   if gaussian else None)
            print(f"  peaks: {total} lattice maxima"
                  + (f" (BBKS expects {exp[2]:.1f})" if exp else ""))
            for i in range(len(nu_c)):
                if counts[i] or (exp is not None and exp[1][i] >= 0.5):
                    line = f"  nu = {nu_c[i]:+6.2f}  n = {counts[i]:6d}"
                    if exp is not None:
                        line += f"  (exp {exp[1][i]:8.1f})"
                    print(line)
        if args.voids:
            from randomfield_tpu_torch.models.voids import (
                find_voids, void_size_function,
            )

            radii = tuple(float(r) for r in args.voids.split(","))
            pos, rv = find_voids(
                delta, args.spacing, radii,
                threshold=args.void_threshold, mesh=mesh,
            )
            box_vol = (ny * nz * args.nx) * args.spacing**3
            print(f"  voids: {pos.shape[0]} non-overlapping "
                  f"(threshold {args.void_threshold:+.2f})")
            if pos.shape[0]:
                edges = np.asarray(
                    [radii[0] * 0.999] + [r * 1.001 for r in radii]
                )
                _, dn, nb_ = void_size_function(rv, box_vol, edges)
                for i, r in enumerate(radii):
                    print(f"  R_v = {r:8.2f}  n = {int(nb_[i]):5d}  "
                          f"dn/dlnR = {dn[i]:.3e}")
        if args.out:
            path = args.out.replace("{seed}", str(seed))
            extra = {}
            if args.lognormal:
                extra["model"] = "lognormal"
            if args.rsd is not None:
                extra["model"] = "kaiser"
                extra["growth_rate_f"] = float(
                    gen.cosmology.growth_rate(0.0) if args.rsd == "auto"
                    else float(args.rsd)
                )
            if args.bias is not None:
                extra["bias"] = float(args.bias)
            if args.fixed:
                extra.update(fixed=True, flip=bool(args.flip))
            extra = extra or None
            if mesh is None:
                save_field(path, delta, generator=gen, seed=seed, extra=extra)
            else:
                # each rank writes the chunk of its own slab
                from randomfield_tpu_torch.utils.io import save_field_sharded

                path = save_field_sharded(path, delta, generator=gen,
                                          seed=seed, extra=extra, mesh=mesh)
            if not args.quiet:
                print(f"  wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
