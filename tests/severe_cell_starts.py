"""Run the sweep's severe-fault cell (``fl-fault-grid`` unified_q, the one
phase ``grids`` of ``chip_smoke.py`` reruns) in both packages from one start,
the port drawing the reference's SR uniforms, and print each round's gate
decisions and each package's rejected updates (ROADMAP §3, D2).

The start is the reference's own init (the committed row's), the port's
(seed 0 on the CPU), or the port's flat parameters saved at a path.  On a
machine with a card, ``--save-init`` saves the port's own CUDA-drawn init
(what the cell starts from there)::

    python tests/severe_cell_starts.py --save-init chiprun_out/resnet_cuda_init_seed0.pt
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/severe_cell_starts.py \\
        --start chiprun_out/resnet_cuda_init_seed0.pt --rounds 24
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def save_init(path: str) -> None:
    """The port's resnet init as ``FLSimulation`` draws it on the card."""
    import torch

    from repro_torch.api.session import resolve_device
    from repro_torch.models.cnn import resnet

    dev = resolve_device(None)
    params = resnet(depth_blocks=(1, 1), width=8).init(
        torch.Generator(device=dev).manual_seed(0), dev)
    torch.save({k: v.cpu() for k, v in params.items()}, path)
    print(f"saved the port's {dev} init ({torch.__version__}) to {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--start", default="reference",
                    help="reference, port, or a path to saved port parameters")
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--save-init", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]
    if args.save_init:
        save_init(args.save_init)
        return 0
    import numpy as np

    import test_torch_fl as T

    ref, port, _rec, gates = T._severe_cell_runs(args.start, args.rounds)
    for r, ((_jn, _jf, ja), (_tn, _tf, ta)) in enumerate(zip(gates["jax"], gates["torch"])):
        print(f"round {r}: accepted reference {ja.astype(int)} port {ta.astype(int)}"
              f"{'' if np.array_equal(ja, ta) else '  DIFFER'}")
    print(f"start {args.start}, {args.rounds} rounds: rejected updates reference "
          f"{ref['total_rejected']}, port {port['total_rejected']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
