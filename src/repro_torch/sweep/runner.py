"""Sweep executor: cells -> Session runs -> a resumable JSONL store.

Execution model
---------------
* ``fl-sim`` cells run **in-process** (the simulator is small and shares the
  process's kernel library across cells).
* ``serve`` / ``train`` / ``fl-orchestrate`` cells run in a **subprocess
  with a timeout** (``python -m repro_torch.sweep.runner --one``): the
  decode driver and the pod trainer hold a model's weights and caches on the
  card that should not accumulate across a grid, and a wedged cell must not
  wedge the sweep.  A ``Dx1`` mesh runs its D clients in a loop on one
  device (``launch/mesh.py``), so a child needs one card whatever its mesh.
* ``dryrun`` cells run **in-process** too: a traced step allocates nothing
  and starts no process group, on any mesh (the presets' ``16x16`` and
  ``2x16x16`` pods included: one traced device,
  :meth:`repro_torch.api.session.Session.run_dryrun`).

Every cell runs on the runner's ``device``: ``None`` means CUDA, and a run
without a card raises rather than falling back to the CPU; ``"cpu"`` runs
the kernels' plain versions.

Resumability
------------
Every finished cell is appended to a :class:`ResultsStore` JSONL file keyed
by the cell's content hash (:func:`repro_torch.sweep.grid.cell_key`).
Re-running a sweep skips every key already recorded with ``status == "ok"``
— an interrupted grid resumes exactly where it stopped, and a completed grid
is a no-op.  The store is append-only (last record per key wins), so a crash
mid-write loses at most the in-flight cell.  The port's stores live under
``results/torch/`` and never in the JAX package's ``results/sweep_*.jsonl``.
Beside the reference's fields, a row records the kernel launches its cell
made (``launches``, by name; none on the CPU, where the plain versions run).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

from repro_torch.api.spec import RunSpec
from repro_torch.kernels._build import LAUNCHES
from repro_torch.sweep.grid import Sweep

#: Workloads isolated in a subprocess (with timeout) rather than in-process.
SUBPROCESS_WORKLOADS = ("serve", "train", "fl-orchestrate")

#: Where the port's stores live (the JAX package's are in ``results/``).
DEFAULT_STORE_DIR = os.path.join("results", "torch")


def git_sha() -> str:
    """Short commit hash of the working tree, or "unknown" outside git."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        return out.stdout.strip() or "unknown"
    except Exception:
        return "unknown"


# ---------------------------------------------------------------------------
# Per-workload execution + metric extraction
# ---------------------------------------------------------------------------


def _plain(x):
    """Plain-Python form of a metrics value: tensors and numpy scalars and
    arrays become numbers and lists, so ``json.dumps`` takes the result."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "tolist"):            # torch.Tensor, np.ndarray, np.generic
        return _plain(x.tolist())
    return x


def execute_cell(spec: RunSpec, device=None) -> dict:
    """Run one cell in this process; return its JSON-safe metrics dict."""
    from repro_torch.api.session import Session

    wl = spec.workload
    sess = Session(spec, device=device)
    if wl == "dryrun":
        return _plain(sess.run_dryrun(verbose=False))
    if wl == "fl-sim":
        out = sess.run()
        evals = out.get("evals") or []
        energy = out.get("energy_log") or []
        return _plain({
            "rounds": len(out["history"]),
            "final_loss": float(out["history"][-1]["loss"]),
            "final_acc": float(evals[-1]["acc"]) if evals else None,
            "total_energy_j": float(out["total_energy_j"]),
            "total_time_s": float(out["total_time_s"]),
            "mean_cohort": (sum(h.get("cohort_size", 0) for h in out["history"])
                            / max(len(out["history"]), 1)),
            "losses": [float(h["loss"]) for h in out["history"]],
            "evals": [{"round": int(e["round"]),
                       **{k: float(v) for k, v in e.items() if k != "round"}}
                      for e in evals],
            "bits_mix": sorted({int(b) for e in energy for b in e["q"]}),
            # resilient-round accounting (0 when no fault plan was active)
            "retransmissions": int(out.get("total_retransmissions", 0)),
            "retx_energy_j": float(out.get("total_retx_energy_j", 0.0)),
            "rejected_updates": int(out.get("total_rejected", 0)),
            "undelivered": int(out.get("total_undelivered", 0)),
            "dropped_midround": int(out.get("total_dropped_midround", 0)),
            # adaptive-precision controller summary (absent for the default
            # constant program) + the wire widths the schedule visited
            "program": out.get("program"),
            "comm_bits_mix": sorted({int(e.get("comm_bits", 32))
                                     for e in energy}),
        })
    if wl == "serve":
        return _plain(dataclasses.asdict(sess.serve()))
    # train / fl-orchestrate: federated rounds on the pod trainer
    history = sess.run()
    return _plain({
        "rounds": len(history),
        "final_loss": float(history[-1]["loss"]),
        "total_energy_j": float(sum(h["energy_j"] for h in history)),
        "bits_last": history[-1]["bits"],
        "wire": sess.comm_report(),
    })


# ---------------------------------------------------------------------------
# Results store
# ---------------------------------------------------------------------------


class ResultsStore:
    """Append-only JSONL of finished cells, keyed by content hash."""

    def __init__(self, path: str):
        self.path = path
        self._rows: dict[str, dict] = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        row = json.loads(line)
                    except json.JSONDecodeError:
                        continue            # torn tail write: drop the line
                    if "key" in row:
                        self._rows[row["key"]] = row

    @classmethod
    def for_sweep(cls, sweep: Sweep, store_dir: str = DEFAULT_STORE_DIR):
        os.makedirs(store_dir, exist_ok=True)
        return cls(os.path.join(store_dir, f"sweep_{sweep.name}.jsonl"))

    def has_ok(self, key: str) -> bool:
        return self._rows.get(key, {}).get("status") == "ok"

    def get(self, key: str) -> dict | None:
        return self._rows.get(key)

    def rows(self) -> list[dict]:
        return list(self._rows.values())

    def append(self, row: dict) -> None:
        row = _json_sanitize(row)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            # allow_nan=False: the store must stay strict JSON (readable by
            # jq / pandas / non-Python consumers); non-finite floats were
            # already mapped to null above
            f.write(json.dumps(row, allow_nan=False) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._rows[row["key"]] = row


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SweepRunner:
    sweep: Sweep
    store: ResultsStore
    timeout_s: float = 1800.0
    subprocess_workloads: tuple = SUBPROCESS_WORKLOADS
    quiet: bool = False
    device: str | None = None       # None: CUDA (raises without a card)

    def _say(self, msg: str) -> None:
        if not self.quiet:
            print(msg, flush=True)

    def run(self, *, max_cells: int | None = None,
            rerun_failed: bool = True, force: bool = False) -> dict:
        """Execute every cell not already in the store; return a summary.

        ``max_cells`` bounds how many cells EXECUTE this call (skips are
        free) — the hook the resumability test uses to interrupt a grid
        deterministically.  ``rerun_failed=False`` also skips cells whose
        last record is an error/timeout.  ``force=True`` re-executes every
        cell regardless of the store (benchmark mode: the store becomes a
        recording, not a cache).
        """
        cells = self.sweep.cells()
        ran, skipped, failed = [], [], []
        for i, cell in enumerate(cells):
            prior = None if force else self.store.get(cell.key)
            if prior is not None and (prior.get("status") == "ok"
                                      or not rerun_failed):
                skipped.append(cell.key)
                self._say(f"[{self.sweep.name} {i + 1}/{len(cells)}] "
                          f"skip {cell.label} ({cell.key}: "
                          f"{prior.get('status')})")
                continue
            if max_cells is not None and len(ran) + len(failed) >= max_cells:
                self._say(f"[{self.sweep.name}] stopping after "
                          f"{max_cells} executed cells (resume to finish)")
                break
            self._say(f"[{self.sweep.name} {i + 1}/{len(cells)}] "
                      f"run {cell.label} ({cell.key})")
            row = self._run_cell(cell)
            self.store.append(row)
            (ran if row["status"] == "ok" else failed).append(cell.key)
            self._say(f"    -> {row['status']} ({row['wall_s']:.1f}s)")
        return {"sweep": self.sweep.name, "n_cells": len(cells),
                "ran": ran, "skipped": skipped, "failed": failed}

    def _run_cell(self, cell) -> dict:
        t0 = time.time()
        base = {"key": cell.key, "sweep": cell.sweep,
                "spec": cell.spec.to_dict(), "git_sha": git_sha()}
        launches: dict = {}
        try:
            if cell.spec.workload in self.subprocess_workloads:
                status, metrics = self._run_subprocess(cell, launches)
            else:
                before = dict(LAUNCHES)
                status, metrics = "ok", execute_cell(cell.spec, self.device)
                launches.update({k: n - before[k] for k, n in LAUNCHES.items()})
        except Exception as e:                      # noqa: BLE001
            # an in-process cell crash becomes an explicit failed row (with
            # enough traceback to diagnose), never a dead grid: later cells
            # still run, and a resumed sweep can deterministically skip or
            # retry this key (rerun_failed)
            import traceback

            status = "error"
            metrics = {"error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
        if isinstance(metrics, dict) and metrics.get("status") == "FAIL":
            status = "error"
        return {**base, "status": status, "metrics": metrics,
                "wall_s": round(time.time() - t0, 2),
                "launches": {k: n for k, n in launches.items() if n}}

    def _run_subprocess(self, cell, launches: dict) -> tuple[str, dict]:
        """Run ``cell`` in a child process; its kernel launches go into
        ``launches``."""
        from repro_torch.api.session import resolve_device

        if resolve_device(self.device).type == "cuda":
            # build the kernel library here, once, so a child only loads it
            from repro_torch.kernels import _build

            _build.build()
        with tempfile.TemporaryDirectory(prefix="repro-torch-sweep-") as td:
            in_path = os.path.join(td, "cell.json")
            out_path = os.path.join(td, "metrics.json")
            launches_path = os.path.join(td, "launches.json")
            with open(in_path, "w") as f:
                json.dump(cell.spec.to_dict(), f)
            env = dict(os.environ)
            env["PYTHONPATH"] = _src_pythonpath(env.get("PYTHONPATH", ""))
            cmd = [sys.executable, "-m", "repro_torch.sweep.runner",
                   "--one", in_path, "--out", out_path, "--launches", launches_path]
            if self.device is not None:
                cmd += ["--device", str(self.device)]
            try:
                proc = subprocess.run(cmd, env=env, capture_output=True,
                                      text=True, timeout=self.timeout_s)
            except subprocess.TimeoutExpired as e:
                stderr = e.stderr or b""
                if isinstance(stderr, bytes):
                    stderr = stderr.decode(errors="replace")
                return "timeout", {"timeout_s": self.timeout_s,
                                   "stderr": stderr[-2000:]}
            if proc.returncode != 0 or not os.path.exists(out_path):
                return "error", {"returncode": proc.returncode,
                                 "stderr": proc.stderr[-2000:]}
            with open(launches_path) as f:
                launches.update(json.load(f))
            with open(out_path) as f:
                return "ok", json.load(f)


def _json_sanitize(x):
    """Strict-JSON form of a result row: non-finite floats become null."""
    if isinstance(x, dict):
        return {k: _json_sanitize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_sanitize(v) for v in x]
    if isinstance(x, float) and (x != x or x in (float("inf"), float("-inf"))):
        return None
    return x


def _src_pythonpath(existing: str) -> str:
    """Ensure the subprocess can import ``repro_torch`` from this checkout."""
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parts = [pkg_root] + [p for p in existing.split(os.pathsep) if p]
    return os.pathsep.join(dict.fromkeys(parts))


def _one_main(argv=None) -> int:
    """``python -m repro_torch.sweep.runner --one cell.json --out metrics.json
    [--device cpu] [--launches launches.json]``."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--one", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, raising without a card)")
    ap.add_argument("--launches", default=None,
                    help="where to write the cell's kernel launches by name")
    args = ap.parse_args(argv)
    with open(args.one) as f:
        spec = RunSpec.from_dict(json.load(f))
    metrics = execute_cell(spec, args.device)
    with open(args.out, "w") as f:
        json.dump(metrics, f)
    if args.launches:
        with open(args.launches, "w") as f:
            json.dump(LAUNCHES, f)
    return 0


if __name__ == "__main__":
    sys.exit(_one_main())
