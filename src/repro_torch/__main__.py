"""``python -m repro_torch`` — one dispatcher for the port's workload CLIs.

Usage::

    python -m repro_torch train   --arch yi-6b --smoke --rounds 5 --device cpu
    python -m repro_torch serve   --arch yi-6b --smoke --steps 16 --device cpu
    python -m repro_torch fl      --model mobilenet --rounds 10 --device cpu
    python -m repro_torch sweep   run grad-comm-wire --device cpu
    python -m repro_torch analyze --preset ci-tiny --fail-on error
    python -m repro_torch dryrun  --arch yi-6b --shape decode_32k --device cpu

Each subcommand is the port's CLI over :class:`repro_torch.api.Session`
(``sweep`` drives grids of them through :mod:`repro_torch.sweep`); every one
runs on the card unless ``--device cpu`` is given (``dryrun``: its fake
tensors' device).  Counterpart of ``repro/__main__.py``; ``pyproject.toml``'s console scripts
name the reference's mains.
"""

from __future__ import annotations

import sys

_COMMANDS = {
    "train": "repro_torch.launch.train",
    "serve": "repro_torch.launch.serve",
    "dryrun": "repro_torch.launch.dryrun",
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
    import importlib

    mod = importlib.import_module(_COMMANDS[cmd])
    rc = mod.main(rest)
    # launcher mains return run artifacts (history dicts); only int is a code
    return rc if isinstance(rc, int) else 0


if __name__ == "__main__":
    sys.exit(main())
