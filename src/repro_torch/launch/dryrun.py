"""Multi-pod dry-run CLI — a thin shim over
:meth:`repro_torch.api.Session.run_dryrun`.

Counterpart of ``repro/launch/dryrun.py``.  For every (architecture x input
shape x mesh) cell it traces one device of the reference's ``16x16`` pod
(``--mesh single``) or ``2x16x16`` pair of pods (``--mesh multi``) under
``FakeTensorMode`` (nothing allocated, no process group: one traced device
a cell, its model group a stand-in, :func:`repro_torch.launch.mesh.trace_axis_ctx`),
prints the trace's memory and collective breakdowns and derives the
roofline terms on one H100 (:mod:`repro_torch.roofline`).  A cell that
cannot be traced is a ``FAIL`` row with its error.  ``--device`` is the fake
tensors' device: CUDA unless ``--device cpu``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --arch yi-6b \
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        --out results/torch/dryrun.json
"""

from __future__ import annotations

import argparse
import json
import traceback

MESHES = {False: "16x16", True: "2x16x16"}


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, verbose=True,
             variant: dict | None = None, precision=None, device=None):
    """Trace and price one cell through the Session facade."""
    from repro_torch.api import PrecisionPolicy, RunSpec, Session

    variant = dict(variant or {})
    if precision is None:
        # the bit knobs may ride in the variant dict, as in the reference
        precision = PrecisionPolicy(
            weights=int(variant.get("serve_bits") or 32),
            comm=int(variant.get("grad_bits") or 32))
    spec = RunSpec(
        arch=arch, workload="dryrun", mesh=MESHES[bool(multi_pod)], smoke=False,
        precision=precision, options={"shape": shape_name, "variant": variant})
    return Session(spec, device=device).run_dryrun(verbose=verbose)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--gather-bf16", action="store_true")
    ap.add_argument("--grad-bits", type=int, default=0)
    ap.add_argument("--capacity", type=float, default=0.0)
    ap.add_argument("--serve-bits", type=int, default=0)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device (default: cuda; raises without a card)")
    args = ap.parse_args(argv)

    from repro_torch.api import PrecisionPolicy
    from repro_torch.api.session import resolve_device
    from repro_torch.configs import ARCH_NAMES, get_config, shapes_for

    device = resolve_device(args.device)
    # the bit knobs fold into one PrecisionPolicy; the cfg knobs stay a
    # variant dict (recorded in the output rows)
    precision = PrecisionPolicy(
        weights=args.serve_bits if args.serve_bits else 32,
        comm=args.grad_bits or 32)
    variant = {k: v for k, v in dict(
        gather_bf16=args.gather_bf16, capacity=args.capacity,
        no_remat=args.no_remat, grad_bits=args.grad_bits,
        serve_bits=args.serve_bits).items() if v}

    archs = list(ARCH_NAMES) if (args.all or not args.arch) else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results = []
    for arch in archs:
        shapes = [s.name for s in shapes_for(get_config(arch))]
        if args.shape:
            shapes = [s for s in shapes if s == args.shape]
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(run_cell(arch, shape, mp, variant=variant,
                                            precision=precision, device=device))
                except Exception as e:                  # noqa: BLE001
                    traceback.print_exc()
                    results.append(dict(arch=arch, shape=shape, mesh=MESHES[mp],
                                        status="FAIL", error=str(e)[-2000:]))
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    n_ok = sum(r.get("status") == "ok" for r in results)
    print(f"\n{n_ok}/{len(results)} cells OK")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
