"""Time the port's dry run of one train cell on meshes of growing batch axes.

A traced train step is one device of the mesh; this script prints how long
``Session.run_dryrun`` takes to trace and price full-width yi-6b
``train_4k`` on each mesh, so two trees (``PYTHONPATH`` names the port's
``src``) compare on one host.  Each line is a JSON object with the mesh,
the seconds and the per-device FLOPs.  From the repository root::

    PYTHONPATH=src python tests/dryrun_trace_times.py --device cpu --meshes 1x1,4x1,16x1
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--meshes", default="1x1,4x1,16x1")
    ap.add_argument("--device", default="cuda", help="the fake tensors' device")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.api import RunSpec, Session

    Session(RunSpec(args.arch, workload="dryrun", smoke=True),
            device=args.device).run_dryrun(shape="decode_32k", verbose=False)  # imports, caches
    for mesh in args.meshes.split(","):
        t0 = time.perf_counter()
        d = Session(RunSpec(args.arch, workload="dryrun", mesh=mesh, smoke=False),
                    device=args.device).run_dryrun(shape=args.shape, verbose=False)
        print(json.dumps({"arch": args.arch, "shape": args.shape, "mesh": mesh,
                          "device": args.device, "torch": torch.__version__,
                          "trace_s": time.perf_counter() - t0,
                          "flops_per_device": d["flops_per_device"],
                          "n_devices": d["n_devices"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
