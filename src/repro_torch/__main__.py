"""``python -m repro_torch`` — one dispatcher for the port's workload CLIs.

Usage::

    python -m repro_torch train   --arch yi-6b --smoke --rounds 5 --device cpu
    python -m repro_torch serve   --arch yi-6b --smoke --steps 16 --device cpu
    python -m repro_torch fl      --model mobilenet --rounds 10 --device cpu
    python -m repro_torch sweep   run grad-comm-wire --device cpu
    python -m repro_torch analyze --preset ci-tiny --fail-on error

Each subcommand is the port's CLI over :class:`repro_torch.api.Session`
(``sweep`` drives grids of them through :mod:`repro_torch.sweep`); every one
runs on the card unless ``--device cpu`` is given.  ``dryrun`` is the
reference's pod-mesh dry-run CLI, which the port has not ported (ROADMAP
queue 1, item 14); a ``Dx1`` cell dry-runs through ``Session.run_dryrun``.
Counterpart of ``repro/__main__.py``; ``pyproject.toml``'s console scripts
name the reference's mains.
"""

from __future__ import annotations

import sys

_COMMANDS = {
    "train": "repro_torch.launch.train",
    "serve": "repro_torch.launch.serve",
    "dryrun": None,
    "fl": "repro_torch.launch.fl",
    "sweep": "repro_torch.sweep.cli",
    "analyze": "repro_torch.analyze.cli",
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}; options: {', '.join(_COMMANDS)}", file=sys.stderr)
        return 2
    if _COMMANDS[cmd] is None:
        raise NotImplementedError(
            "python -m repro_torch dryrun: the pod meshes' dry-run CLI is not ported "
            "(ROADMAP queue 1, item 14); dry-run a Dx1 cell with Session.run_dryrun")
    import importlib

    mod = importlib.import_module(_COMMANDS[cmd])
    rc = mod.main(rest)
    # launcher mains return run artifacts (history dicts); only int is a code
    return rc if isinstance(rc, int) else 0


if __name__ == "__main__":
    sys.exit(main())
