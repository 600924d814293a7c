"""Paper-scale federated-simulation CLI (fl-sim workload) — a thin shim over
:class:`repro_torch.api.Session`.

Runs Algorithm 1 (CIFAR-class CNN, non-iid clients, one K1 launch a round)
with the GBD co-design choosing per-device bit-widths each round, on CUDA
unless ``--device cpu`` is given::

    PYTHONPATH=src python -m repro_torch.launch.fl --model mobilenet --rounds 10
    PYTHONPATH=src python -m repro_torch.launch.fl --device cpu --model mobilenet \
        --rounds 3 --clients 4 --batch 4
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mobilenet",
                    choices=["mobilenet", "resnet"])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--scheme", default="fwq",
                    choices=["fwq", "full_precision", "unified_q", "rand_q"])
    ap.add_argument("--lr", type=float, default=0.08)
    ap.add_argument("--error-tolerance", type=float, default=4.5)
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faults", default="",
                    help="JSON FaultPlan dict, e.g. "
                    '\'{"packet_loss": 0.1, "dropout_prob": 0.05}\' — '
                    "runs the resilient round executor")
    ap.add_argument("--resolve-drift-db", type=float, default=0.0,
                    help="warm GBD re-solve when measured gains drift past "
                    "this many dB (0 = disabled)")
    ap.add_argument("--precision-program", default="",
                    help="adaptive precision controller: a kind name "
                    "(constant | energy_budget | channel_gbd) or a JSON "
                    'config, e.g. \'{"kind": "energy_budget", '
                    '"budget_j": 120}\'')
    ap.add_argument("--ckpt-dir", default="",
                    help="round-level checkpoints; a rerun resumes from the latest")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from repro_torch.api import RunSpec, Session

    options = {"scheme": args.scheme, "n_clients": args.clients,
               "lr": args.lr, "error_tolerance": args.error_tolerance,
               "eval_every": args.eval_every}
    if args.faults:
        options["faults"] = json.loads(args.faults)
    if args.resolve_drift_db:
        options["resolve_drift_db"] = args.resolve_drift_db
    if args.precision_program:
        pp = args.precision_program
        options["precision_program"] = (json.loads(pp)
                                        if pp.lstrip().startswith("{") else pp)
    if args.ckpt_dir:
        options["ckpt_dir"] = args.ckpt_dir
        options["ckpt_every"] = args.ckpt_every
    spec = RunSpec(
        arch=args.model, workload="fl-sim", seed=args.seed,
        batch=args.batch, rounds=args.rounds, options=options)
    out = Session(spec, device=args.device).run()

    print(f"\n{'round':>5} {'loss':>8} {'energy(J)':>10} {'bits chosen':>16}")
    for h, e in zip(out["history"], out["energy_log"]):
        print(f"{h['round']:>5} {h['loss']:>8.4f} {e['energy_round']:>10.3f} "
              f"{str(sorted(set(h['bits'].tolist()))):>16}")
    print(f"\ntotal energy: {out['total_energy_j']:.2f} J over "
          f"{out['total_time_s']:.1f} s (simulated wall time)")
    if "program" in out:
        print("precision program:", json.dumps(out["program"]))
    if "total_retransmissions" in out:
        print(f"faults: {out['total_retransmissions']} retransmissions "
              f"({out['total_retx_energy_j']:.3f} J), "
              f"{out['total_rejected']} rejected updates, "
              f"{out['total_undelivered']} undelivered, "
              f"{out['total_dropped_midround']} mid-round dropouts")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"total_energy_j": out["total_energy_j"],
                       "total_time_s": out["total_time_s"],
                       "losses": [h["loss"] for h in out["history"]],
                       "evals": out["evals"],
                       **{k: out[k] for k in
                          ("total_retransmissions", "total_retx_energy_j",
                           "total_rejected", "total_undelivered",
                           "total_dropped_midround") if k in out}},
                      f, indent=1)
    return out


if __name__ == "__main__":
    main()
