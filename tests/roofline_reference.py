"""Rerun the JAX reference's dry run on the CPU for the model families'
smoke cells and record its roofline figures
(``tests/fixtures/roofline_reference.json``).

``tests/test_torch_roofline.py`` holds the port's traced steps
(:meth:`repro_torch.api.session.Session.run_dryrun`) to these figures, and
reruns the cheapest entry with the reference to pin them.  Beside the
report's figures, each entry keeps the dot FLOPs and bf16-equivalent bytes
that the compiled program spends in the functions where the two packages'
counts differ (ROADMAP §3, D3 and D4): the attribution reads each dot's
innermost source function from the HLO's stack-frame tables.  Run from the
repository root (a few seconds a cell)::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/roofline_reference.py
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "roofline_reference.json")
#: the families beside yi-6b, a train and a decode cell each (1x1, smoke)
ARCHS = ("olmoe-1b-7b", "mamba2-780m", "jamba-1.5-large-398b", "seamless-m4t-large-v2",
         "llama-3.2-vision-90b")
#: (kind, seq_len, global batch) of the smoke cells
CELLS = {"train": ("train", 16, 2), "prefill": ("prefill", 16, 2), "decode": ("decode", 32, 2)}
#: the report fields held to the port's
FIELDS = ("flops_per_device", "bytes_per_device", "bytes_per_device_raw", "collective_bytes",
          "collective_breakdown", "model_flops_global", "useful_flops_ratio", "dominant",
          "compute_s", "memory_s", "collective_s")
#: functions whose dots differ between the packages (ROADMAP §3, D3 and D4)
NAMED = ("fused_vocab_xent", "_ssd_scan")


def _section(txt: str, name: str) -> dict:
    m = re.search(rf"^{name}\n(.*?)(?:\n\n|\n[A-Z]\w+\n)", txt, re.S | re.M)
    out = {}
    for line in (m.group(1).splitlines() if m else ()):
        i, rest = line.split(" ", 1)
        out[int(i)] = rest
    return out


def dots_by_function(txt: str, prefixes=NAMED) -> dict:
    """``{prefix: [flops, bf16-equivalent dot bytes]}`` of the dots whose
    innermost source function starts with ``prefix``, loop-multiplied as
    ``repro.roofline.hlo_parse.parse_module`` multiplies them."""
    from repro.roofline import hlo_parse as hp

    fn = {k: v.strip('"') for k, v in _section(txt, "FunctionNames").items()}
    loc = {k: dict(re.findall(r"(\w+)=(\d+)", v))
           for k, v in _section(txt, "FileLocations").items()}
    fr = {k: dict(re.findall(r"(\w+)=(\d+)", v)) for k, v in _section(txt, "StackFrames").items()}

    def function_of(line: str) -> str:
        m = re.search(r"stack_frame_id=(\d+)", line)
        if not m:
            return "?"
        return fn[int(loc[int(fr[int(m.group(1))]["file_location_id"])]["function_name_id"])]

    txt16 = txt.replace("f32[", "bf16[")
    comps, shapes, cur = {}, {}, None
    for raw in txt16.splitlines():
        line = raw.rstrip()
        mc = hp._COMP_RE.match(line)
        if mc and line.endswith("{"):
            cur = mc.group(1)
            comps[cur] = []
            for pname, ptype in re.findall(r"([\w\.\-]+)\s*:\s*([^,()]*(?:\([^)]*\))?[^,]*)",
                                           mc.group(2)):
                ms = hp._SHAPE_RE.search(ptype)
                if ms:
                    shapes["%" + pname] = (ms.group(1), ms.group(2))
            continue
        if cur is None:
            continue
        if line.strip() == "}":
            cur = None
            continue
        comps[cur].append(line)
        md = hp._DEF_RE.match(line)
        if md:
            ms = hp._SHAPE_RE.search(md.group(2))
            if ms:
                shapes[md.group(1)] = (ms.group(1), ms.group(2))
    local, edges = {}, {}
    for name, lines in comps.items():
        found, calls = [], []
        for line in lines:
            mo = hp._OPCODE_RE.search(line)
            if not mo:
                continue
            op, md = mo.group(1), hp._DEF_RE.match(line)
            if op == "dot":
                res = hp._SHAPE_RE.findall(md.group(2))[0]
                refs = re.findall(r"(%[\w\.\-]+)", line[mo.end():].split(")")[0])
                lhs, rhs = shapes[refs[0]], shapes[refs[1]]
                k = 1
                dims = [int(x) for x in lhs[1].split(",") if x]
                for c in (int(x) for x in hp._LHS_CDIMS_RE.search(line).group(1).split(",")
                          if x):
                    k *= dims[c]
                flops = 2.0 * hp._shape_bytes(*res)[1] * k
                nbytes = sum(hp._shape_bytes(*s)[0] for s in (res, lhs, rhs))
                found.append((function_of(line), flops, nbytes))
            elif op == "while":
                mt = hp._TRIP_RE.search(line)
                for rx in (hp._BODY_RE, hp._COND_RE):
                    mm = rx.search(line)
                    if mm:
                        calls.append((mm.group(1), int(mt.group(1)) if mt else 1))
            elif op in ("fusion", "call", "conditional", "async-start"):
                for rx in (hp._CALLS_RE, hp._TOAPPLY_RE):
                    mm = rx.search(line)
                    if mm:
                        calls.append((mm.group(1), 1))
        local[name], edges[name] = found, calls
    entry = [n for n in comps if ".main" in n or n.endswith("main") or "main." in n][-1]
    out = defaultdict(lambda: [0.0, 0.0])

    def walk(name, mult, stack=()):
        if name in stack or name not in local:
            return
        for func, flops, nbytes in local[name]:
            for p in prefixes:
                if func.startswith(p):
                    out[p][0] += mult * flops
                    out[p][1] += mult * nbytes
        for callee, m in edges[name]:
            walk(callee, mult * m, stack + (name,))

    walk(entry, 1.0)
    return {p: out[p] for p in prefixes}


def reference_cell(arch: str, kind: str, mesh: str = "1x1", precision=None,
                   seq_len: int | None = None, batch: int | None = None) -> dict:
    """The reference's dry run of one smoke cell: the report's figures and
    :func:`dots_by_function` of its compiled program (one compile)."""
    from repro.api import PrecisionPolicy, RunSpec, Session
    from repro.configs.base import ShapeSpec
    from repro.roofline.analysis import analyze_compiled, model_flops

    k, s, b = CELLS[kind]
    cell = ShapeSpec(f"smoke_{kind}", seq_len or s, batch or b, k)
    sess = Session(RunSpec(arch=arch, workload="dryrun", mesh=mesh, smoke=True,
                           precision=precision or PrecisionPolicy()))
    compiled, _lowered, meta = sess.lower(cell)
    rep = analyze_compiled(compiled, arch=arch, shape=cell.name, mesh_name=mesh,
                           n_devices=meta["n_devices"],
                           model_flops_global=model_flops(sess.cfg, k, cell.seq_len,
                                                          cell.global_batch)).to_dict()
    out = {f: rep[f] for f in FIELDS}
    out["by_function"] = dots_by_function(compiled.as_text())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--out", default=FIXTURE)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro  # noqa: F401  (the jax shims first)

    out = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)
    for arch in args.archs.split(","):
        for kind in ("train", "decode"):
            out[f"{arch}|{kind}"] = reference_cell(arch, kind)
            print(f"{arch} {kind}: {out[f'{arch}|{kind}']}", flush=True)
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
