"""Worked examples of the port, one module each.

Ports of the JAX package's single-device ``examples/`` scripts.  Each
module has ``main(device=None, n=None)``: it runs the script's workflow on
``device`` ("cuda" by default, "cpu" asked for explicitly) at the script's
own grid size (``n`` overrides it; the grid spacing stays the script's,
except where the script's positions fix the box), prints the script's comparisons and
returns the numbers it printed as a dict.  Run one with

    python -m randomfield_tpu_torch.examples.quickstart [--device cpu] [--n N]

``pod_survey_catalog`` runs on a slab mesh: ``main(device, n, mesh)`` on
every rank, rank 0 printing (``--multihost`` joins a ``torchrun`` group).
``sharded_field`` and ``pencil_multihost`` wait for the mesh's 'data' axis
and pencil mesh, ``pod_voids_knn`` for the mesh versions of the item-9
estimators (ROADMAP.md, Queue 1 items 5 and 8b).
"""

import argparse


def cli(main, argv=None):
    """Run an example's ``main`` from the command line."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, choices=["cuda", "cpu"])
    p.add_argument("--n", type=int, default=None,
                   help="grid size (default: the example's own)")
    args = p.parse_args(argv)
    main(device=args.device, n=args.n)
