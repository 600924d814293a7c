"""Rerun the JAX reference's dry run on the CPU for the model families'
smoke cells on meshes with a model axis (``1x2``, ``2x2``, ``2x1x2``) and
record its roofline figures (``tests/fixtures/roofline_pod_reference.json``).

``tests/test_torch_dryrun_pod.py`` holds the port's traced device
(:meth:`repro_torch.api.session.Session.run_dryrun` on a pod mesh) to these
figures, and reruns the cheapest entry with the reference to pin them.
Each entry is :func:`roofline_reference.reference_cell`'s: the report's
figures and the dot FLOPs and bytes of the functions named in ROADMAP §3.
The script forces four host devices, so run it in a fresh process from the
repository root (a few seconds a cell)::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/roofline_pod_reference.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "roofline_pod_reference.json")
#: the families beside yi-6b (whose 1x2 cells the test reruns live)
ARCHS = ("olmoe-1b-7b", "mamba2-780m", "jamba-1.5-large-398b", "seamless-m4t-large-v2",
         "llama-3.2-vision-90b")
#: ``key -> (arch, kind, mesh, global batch)``: every family's train, prefill
#: and decode cell on 1x2, and a train cell each on 2x2 and 2x1x2
ENTRIES = {f"{arch}|{kind}|1x2": (arch, kind, "1x2", 2)
           for arch in ARCHS for kind in ("train", "prefill", "decode")}
ENTRIES.update({"yi-6b|train|2x2": ("yi-6b", "train", "2x2", 4),
                "olmoe-1b-7b|train|2x1x2": ("olmoe-1b-7b", "train", "2x1x2", 4)})
#: the entry the test reruns (the cheapest)
CHEAPEST = "mamba2-780m|decode|1x2"


def entry(key: str) -> dict:
    """The reference's figures of one fixture entry (one compile)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from roofline_reference import reference_cell

    arch, kind, mesh, batch = ENTRIES[key]
    return reference_cell(arch, kind, mesh, batch=batch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", default=",".join(ENTRIES))
    ap.add_argument("--out", default=FIXTURE)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro  # noqa: F401  (the jax shims first)

    out = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)
    for key in args.keys.split(","):
        out[key] = entry(key)
        print(f"{key}: {out[key]}", flush=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
