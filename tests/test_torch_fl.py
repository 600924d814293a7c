"""Parity of the port's fl-sim slice with the JAX reference on the CPU.

* The host modules the port copies (channel, energy, GBD, baselines, data,
  faults, wire accounting) give exactly equal outputs on the same seeds.
* One FWQ round and short ``Session`` runs: both packages start from the
  same numpy parameters, and the port's SR uniforms are replaced by the
  reference's own draws (``FLSimulation.round_uniforms`` is the seam; the
  generators cannot match bit for bit).  Quantized parameters, energy logs,
  bit choices, cohorts and simulated time are then exactly equal, and losses
  and parameters agree to 1e-5.
"""

import contextlib
import dataclasses
import functools
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JSpec
from repro.api import Session as JSession
from repro.core import quantization as jq
from repro.models import cnn as jcnn
from repro_torch.api import RunSpec as TSpec
from repro_torch.api import Session as TSession
from repro_torch.core import quantization as tq
from repro_torch.fed.simulation import FLSimulation as TSim
from repro_torch.models import cnn as tcnn
from repro_torch.models.convert import cnn_params_from_jax

FL_MODELS = {"resnet": dict(depth_blocks=(1, 1), width=8),
             "mobilenet": dict(width=8, n_stages=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- host modules
def _eq(a, b):
    """Exact equality of nested host values (numpy arrays, dataclasses, dicts)."""
    if dataclasses.is_dataclass(a):
        return type(a).__name__ == type(b).__name__ and _eq(vars(a), vars(b))
    if isinstance(a, dict):
        return set(a) == set(b) and all(_eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, np.random.Generator):
        return True
    a, b = np.asarray(a), np.asarray(b)
    return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def test_fleet_channel_and_data_are_equal():
    from repro.core import channel as jch
    from repro.core import energy as jen
    from repro.data import ClientBatcher as JB
    from repro.data import SyntheticImages as JImg
    from repro.data import dirichlet_partition as jdp
    from repro_torch.core import channel as tch
    from repro_torch.core import energy as ten
    from repro_torch.data import ClientBatcher as TB
    from repro_torch.data import SyntheticImages as TImg
    from repro_torch.data import dirichlet_partition as tdp

    for n, seed in ((4, 0), (8, 3)):
        assert _eq(jen.heterogeneous_fleet(n, seed=seed, group_step_mhz=5.0),
                   ten.heterogeneous_fleet(n, seed=seed, group_step_mhz=5.0))
        assert _eq(jen.memory_capacities(n, lo_mb=2.0, hi_mb=8.0),
                   ten.memory_capacities(n, lo_mb=2.0, hi_mb=8.0))
        jc, tc = jch.ChannelModel(n_devices=n, seed=seed), tch.ChannelModel(n_devices=n, seed=seed)
        assert _eq(jc.gain_matrix(6), tc.gain_matrix(6))
        assert jch.gain_drift_db(jc.gains(0), jc.gains(3)) == \
            tch.gain_drift_db(tc.gains(0), tc.gains(3))
        ji, jl = JImg(n=256, hw=16, seed=seed).generate()
        ti, tl = TImg(n=256, hw=16, seed=seed).generate()
        assert _eq((ji, jl), (ti, tl))
        jp, tp = jdp(jl, n, alpha=0.5, seed=seed), tdp(tl, n, alpha=0.5, seed=seed)
        assert _eq(jp, tp)
        cohort = np.arange(n)[::2]
        for r in range(3):
            assert _eq(JB(ji, jl, jp, batch=4, seed=seed).sample_round(r, cohort),
                       TB(ti, tl, tp, batch=4, seed=seed).sample_round(r, cohort))


def test_faults_and_wire_are_equal():
    from repro.dist.collectives import code_bound as jcb
    from repro.dist.collectives import wire_dtype as jwd
    from repro.dist.wire import wire_scale as jws
    from repro.faults import FaultPlan as JPlan
    from repro.faults import transmit_update as jtx
    from repro_torch.dist.collectives import code_bound as tcb
    from repro_torch.dist.collectives import wire_dtype as twd
    from repro_torch.dist.wire import wire_scale as tws
    from repro_torch.faults import FaultPlan as TPlan
    from repro_torch.faults import transmit_update as ttx

    severe = {"dropout_prob": 0.15, "fade_prob": 0.3, "packet_loss": 0.2,
              "corrupt_prob": 0.1, "slowdown_prob": 0.1}
    jplan, tplan = JPlan.from_dict(severe), TPlan.from_dict(severe)
    assert jplan.to_dict() == tplan.to_dict()
    js, ts = jplan.schedule(7, 6), tplan.schedule(7, 6)
    for r in range(5):
        assert _eq(js.round_faults(r), ts.round_faults(r))
        for dev in range(6):
            assert _eq(js.corrupt_rng(r, dev).random(4), ts.corrupt_rng(r, dev).random(4))
            a = jtx(8e6, 2e6, 0.2, 0.2, js.chunk_rng(r, dev), jplan, budget_s=5.0)
            b = ttx(8e6, 2e6, 0.2, 0.2, ts.chunk_rng(r, dev), tplan, budget_s=5.0)
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
    for bits in (2, 4, 7, 8, 12, 16, 32):
        for n in (1, 4, 8, 300):
            assert jws(bits, n) == tws(bits, n)
            if bits < 32:
                assert jcb(bits) == tcb(bits)
                try:
                    want = np.dtype(jwd(bits, n))
                except ValueError:
                    with pytest.raises(ValueError):
                        twd(bits, n)
                else:
                    assert np.dtype(twd(bits, n)) == want


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("sgd", {"momentum": 0.9, "weight_decay": 0.01}),
                                     ("adamw", {"weight_decay": 0.01})])
def test_optimizers_match_reference(name, kw):
    from repro.optim import build_optimizer as jbuild
    from repro.optim import warmup_cosine as jwc
    from repro_torch.optim import build_optimizer as tbuild
    from repro_torch.optim import warmup_cosine as twc

    rng = np.random.default_rng(len(kw))
    params = {"a/w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    jopt = jbuild(name, jwc(0.1, 2, 6), **kw)
    topt = tbuild(name, twc(0.1, 2, 6), **kw)
    jp = {"a": {"w": jnp.asarray(params["a/w"])}, "b": jnp.asarray(params["b"])}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    assert set(js) == set(ts)
    for _ in range(4):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        ju, js = jopt.update({"a": {"w": jnp.asarray(g["a/w"])}, "b": jnp.asarray(g["b"])},
                             js, jp)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tp = {k: v + tu[k] for k, v in tp.items()}
    assert int(ts["step"]) == int(js["step"])
    np.testing.assert_allclose(tp["a/w"].numpy(), np.asarray(jp["a"]["w"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp["b"].numpy(), np.asarray(jp["b"]), rtol=1e-6, atol=1e-6)


# ------------------------------------------------ reference draws and params
@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    """numpy parameters with the reference CNN's structure (fl-sim sizes)."""
    shapes = jax.eval_shape(getattr(jcnn, arch)(**FL_MODELS[arch]).init,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(len(arch))

    def draw(path, sd):
        base = 1.0 if str(path[-1].key).endswith("_s") else 0.0
        return jnp.asarray((base + 0.2 * rng.standard_normal(sd.shape)).astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.partial(jax.jit, static_argnames=("n",))
def _ref_client_uniforms(params, seed, round_idx, n):
    """Every leaf's SR uniforms of every client, as the reference's round
    draws them: fold_in(PRNGKey(seed), round) -> fold_in(., i) -> split ->
    qkey -> fold_in(qkey, leaf_idx).  Mapped over the clients, as the
    reference's round maps its client function."""
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), round_idx)
    _paths, leaves, treedef = jq._flatten_with_paths(params)

    def client(i):
        qkey, _lkey = jax.random.split(jax.random.fold_in(rng, i))
        return [jax.random.uniform(jax.random.fold_in(qkey, idx), leaf.shape, jnp.float32)
                for idx, leaf in enumerate(leaves)]

    draws = jax.vmap(client)(jnp.arange(n))
    return [jax.tree_util.tree_unflatten(treedef, [d[i] for d in draws]) for i in range(n)]


def _port_uniforms(ref_params, seed, round_idx, n):
    """The reference's draws as the port's ``(n, P)`` uniforms."""
    port = cnn_params_from_jax(ref_params)
    qpaths = [p for _i, p in tq.quantizable_paths(port)]
    rows = []
    # client i's draws do not depend on the cohort's size: one compile serves all
    for tree in _ref_client_uniforms(ref_params, seed, round_idx, max(n, 8))[:n]:
        conv = cnn_params_from_jax(tree)
        rows.append(torch.cat([conv[p].reshape(-1) for p in qpaths]))
    return torch.stack(rows)


def _ref_seam(ref_params_of):
    """A ``round_uniforms`` that returns the reference's draws."""
    def round_uniforms(self, round_idx, n_clients):
        u = _port_uniforms(ref_params_of(self), self.cfg.seed, round_idx, n_clients)
        return u.to(self.device)
    return round_uniforms


@contextlib.contextmanager
def _shared_start(arch: str, ref=None):
    """Both packages' fl-sim models start from ``ref`` (by default
    ``_ref_params(arch)``), and the port draws the reference's SR uniforms."""
    ref = _ref_params(arch) if ref is None else ref
    jfac, tfac = getattr(jcnn, arch), getattr(tcnn, arch)

    def jfactory(**kw):
        return dataclasses.replace(jfac(**kw), init=lambda key: ref)

    def tfactory(**kw):
        return dataclasses.replace(tfac(**kw),
                                   init=lambda gen, device=None: cnn_params_from_jax(ref, device=device))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcnn, arch, jfactory)
        mp.setattr(tcnn, arch, tfactory)
        mp.setattr(TSim, "round_uniforms", _ref_seam(lambda sim: ref))
        yield ref


def test_elastic_cohorts_and_policy_bits():
    """The round is sized by its batch: cohorts of 3 then 1 clients."""
    from repro_torch.api.precision import PrecisionPolicy
    from repro_torch.fed.simulation import SimConfig

    m = tcnn.resnet(**FL_MODELS["resnet"])
    sim = TSim(tcnn.xent_loss(m), m.init, SimConfig(n_clients=3, seed=0), device="cpu")
    rng = np.random.default_rng(0)
    for n in (3, 1):
        batch = {"x": torch.from_numpy(rng.standard_normal((n, 2, 16, 16, 3)).astype(np.float32)),
                 "y": torch.from_numpy(rng.integers(0, 10, (n, 2)).astype(np.int32))}
        rec = sim.run_round(batch, PrecisionPolicy(weights=(8,) * n, comm=16))
        assert rec["client_loss"].shape == (n,) and np.isfinite(rec["loss"])
        assert rec["comm_bits"] == 16
    with pytest.raises(ValueError, match="per-device bits"):
        sim.run_round(batch, PrecisionPolicy(weights=(8, 8)))


# ---------------------------------------------------------- Session runs
@contextlib.contextmanager
def _recorded():
    """Record every GBD solve and the parameters after every round, in both
    packages, while their Sessions run."""
    import repro.fed.orchestrator as jorch
    import repro_torch.fed.orchestrator as torch_orch
    from repro.fed.simulation import FLSimulation as JSim

    rec = {"jax": {"gbd": [], "params": []}, "torch": {"gbd": [], "params": []}}

    def gbd(mod, pkg):
        real = mod.run_gbd

        def run_gbd(*a, **kw):
            rec[pkg]["gbd"].append(real(*a, **kw))
            return rec[pkg]["gbd"][-1]
        return run_gbd

    def rounds(cls, pkg, copy):
        real = cls.run_round

        def run_round(self, *a, **kw):
            out = real(self, *a, **kw)
            rec[pkg]["params"].append(copy(self.params))
            return out
        return run_round

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jorch, "run_gbd", gbd(jorch, "jax"))
        mp.setattr(torch_orch, "run_gbd", gbd(torch_orch, "torch"))
        mp.setattr(JSim, "run_round", rounds(JSim, "jax", cnn_params_from_jax))
        mp.setattr(TSim, "run_round", rounds(
            TSim, "torch", lambda p: {k: v.detach().clone() for k, v in p.items()}))
        yield rec


def _run_pair(arch, **options):
    spec = dict(arch=arch, workload="fl-sim", seed=0, batch=4, rounds=3,
                options={"n_clients": 4, "lr": 0.08, **options})
    with _shared_start(arch), _recorded() as rec:
        ref = JSession(JSpec(**spec)).run()
        port = TSession(TSpec(**spec), device="cpu").run()
    return ref, port, rec


@functools.lru_cache(maxsize=None)
def _fwq_runs(arch):
    return _run_pair(arch, scheme="fwq")


def _same_host_record(ref, port):
    assert len(ref["energy_log"]) == len(port["energy_log"])
    for je, te in zip(ref["energy_log"], port["energy_log"]):
        assert set(je) == set(te)
        for k in je:
            if k == "policy":
                assert je[k].to_dict() == te[k].to_dict()
            else:
                assert _eq(je[k], te[k]), k
    for key in ("total_energy_j", "total_time_s"):
        assert ref[key] == port[key], key
    for jh, th in zip(ref["history"], port["history"]):
        for k in ("round", "bits", "comm_bits", "energy", "t_round", "cohort_size"):
            assert _eq(jh[k], th[k]), k


@pytest.mark.parametrize("arch", sorted(FL_MODELS))
def test_session_host_math_is_equal(arch):
    """Energy log, bit choices, cohorts, simulated time and every GBD solve
    (primal, cuts, master) exactly equal."""
    ref, port, rec = _fwq_runs(arch)
    _same_host_record(ref, port)
    assert len(port["history"]) == 3
    assert len(rec["jax"]["gbd"]) == len(rec["torch"]["gbd"]) == 1
    for a, b in zip(rec["jax"]["gbd"], rec["torch"]["gbd"]):
        assert _eq(vars(a), vars(b))


@pytest.mark.parametrize("arch", sorted(FL_MODELS))
def test_session_losses_match(arch):
    ref, port, _rec = _fwq_runs(arch)
    for jh, th in zip(ref["history"], port["history"]):
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(th["client_loss"], jh["client_loss"], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", sorted(FL_MODELS))
def test_fwq_round_matches_reference(arch):
    """Round 0 with shared uniforms: every client's quantized parameters are
    bit-equal, and the parameters after each round agree to 1e-5."""
    from repro.core.fwq import delta_for_clients as jdelta
    from repro_torch.core.fwq import delta_for_clients as tdelta

    ref, port, rec = _fwq_runs(arch)
    params = _ref_params(arch)
    bits = port["history"][0]["bits"]
    n = len(bits)
    qs = tq.quantize_clients(cnn_params_from_jax(params), tdelta(bits),
                             _port_uniforms(params, 0, 0, n))
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    dj = jdelta(bits)
    for i in range(n):
        qkey, _ = jax.random.split(jax.random.fold_in(rng, i))
        want = cnn_params_from_jax(_jit_quantize_tree(params, dj[i], qkey))
        for p, q in qs.items():
            np.testing.assert_array_equal(q[i].numpy(), want[p].numpy(), err_msg=p)
    assert len(rec["jax"]["params"]) == len(rec["torch"]["params"]) == 3
    for after_j, after_t in zip(rec["jax"]["params"], rec["torch"]["params"]):
        for p, v in after_t.items():
            np.testing.assert_allclose(v.numpy(), after_j[p].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=p)


_jit_quantize_tree = jax.jit(jq.quantize_tree)


def test_faulty_session_counts_are_equal():
    ref, port, _rec = _run_pair("mobilenet", scheme="unified_q", faults={"packet_loss": 0.2})
    _same_host_record(ref, port)
    for key in ("total_retransmissions", "total_retx_energy_j", "total_rejected",
                "total_undelivered", "total_dropped_midround"):
        assert ref[key] == port[key], key
    assert port["total_retransmissions"] > 0
    for jh, th in zip(ref["history"], port["history"]):
        assert _eq(jh["accepted"], th["accepted"])
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5, atol=1e-5)


#: The committed severe-fault cell of ``fl-fault-grid`` (resnet, 6 clients,
#: unified_q): round 10 keeps two updates, one damaged by 2^106, and the gate
#: admits it (the median of two is their mean).
SEVERE_CELL = "51d4d2daf3b3aa9c"
_PRIMAL: dict = {}


def _committed_spec(key: str) -> dict:
    path = os.path.join(os.path.dirname(__file__), "..", "results", "sweep_fl-fault-grid.jsonl")
    with open(path) as f:
        return next(r["spec"] for r in map(json.loads, f) if r["key"] == key)


def _jax_tree(flat: dict):
    """The port's flat CNN parameters as the reference's nested tree (HWIO)."""
    out: dict = {}
    for path, t in flat.items():
        a = t.numpy()
        *heads, last = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a)
    return out


@contextlib.contextmanager
def _primal_solved_once():
    """Both packages' baselines take each primal solve from one memo, keyed
    by its inputs.  The solves are equal (``test_session_host_math_is_equal``)
    and the severe cell's re-solves are most of its time on the CPU."""
    import repro.core.baselines as jbase
    import repro_torch.core.baselines as tbase
    from repro.core.primal import PrimalSolution as JSol
    from repro_torch.core.primal import PrimalSolution as TSol

    def memo(real, sol_type):
        def solve_primal(data, q):
            key = pickle.dumps(([np.asarray(v) for v in vars(data).values()],
                                np.asarray(q, np.float64)))
            if key not in _PRIMAL:
                _PRIMAL[key] = vars(real(data, q))
            return sol_type(**_PRIMAL[key])
        return solve_primal

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbase, "solve_primal", memo(jbase.solve_primal, JSol))
        mp.setattr(tbase, "solve_primal", memo(tbase.solve_primal, TSol))
        yield


@contextlib.contextmanager
def _gates_recorded(gates: dict):
    """Record each round's gate inputs and decision: (norms, finite, accept)."""
    import repro.fed.simulation as jsim
    import repro_torch.fed.simulation as tsim

    def wrap(mod, pkg):
        real = mod.gate_mask

        def gate_mask(norms_sq, finite, factor):
            accept = real(norms_sq, finite, factor)
            gates[pkg].append((np.sqrt(np.asarray(norms_sq, np.float64)),
                               np.asarray(finite).copy(), accept.copy()))
            return accept
        return gate_mask

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsim, "gate_mask", wrap(jsim, "jax"))
        mp.setattr(tsim, "gate_mask", wrap(tsim, "torch"))
        yield


@functools.lru_cache(maxsize=None)
def _severe_cell_runs(start: str, rounds: int = 12):
    """The committed severe-fault cell's first ``rounds`` rounds in both
    packages, from one start: the reference's own init (the committed
    row's), the port's (seed 0 on the CPU) or the port's flat parameters
    saved at a path (``tests/severe_cell_starts.py --save-init``); the port
    draws the reference's SR uniforms."""
    spec = dict(_committed_spec(SEVERE_CELL), rounds=rounds)
    model = FL_MODELS[spec["arch"]]
    if start == "reference":
        ref = jcnn.resnet(**model).init(jax.random.PRNGKey(spec["seed"]))
    elif start == "port":
        ref = _jax_tree(tcnn.resnet(**model).init(
            torch.Generator().manual_seed(spec["seed"]), "cpu"))
    else:
        ref = _jax_tree(torch.load(start))
    gates = {"jax": [], "torch": []}
    with _primal_solved_once(), _gates_recorded(gates), \
            _shared_start(spec["arch"], ref), _recorded() as rec:
        ref_run = JSession(JSpec.from_dict(spec)).run()
        port_run = TSession(TSpec.from_dict(spec), device="cpu").run()
    return ref_run, port_run, rec, gates


@pytest.mark.parametrize("start", ["reference", "port"])
def test_severe_fault_cell_gates_alike(start):
    """At the sweep's severe-fault cell, from one start with the same draws,
    the two packages meet the same gate inputs and decide alike in every
    round: both admit the 2^106-damaged update in round 10, and what follows
    agrees too (fault F3, the group norm's variance, is closed).  Which
    updates the damaged model makes non-finite depends on the start, in the
    reference as in the port (``test_severe_fault_cell_rejections_follow_the_start``)."""
    ref, port, rec, gates = _severe_cell_runs(start)
    _same_host_record(ref, port)
    assert len(gates["jax"]) == len(gates["torch"]) == 12
    for r, ((jn, jf, ja), (tn, tf, ta)) in enumerate(zip(gates["jax"], gates["torch"])):
        assert _eq(ja, ta) and _eq(jf, tf), r
        np.testing.assert_allclose(tn, jn, rtol=1e-5, err_msg=f"round {r}")
    for jh, th in zip(ref["history"], port["history"]):
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5, atol=1e-5)
    assert ref["total_rejected"] == port["total_rejected"]
    for pkg in ("jax", "torch"):
        size = [max(float(v.abs().max()) for v in p.values()) for p in rec[pkg]["params"]]
        assert max(size[:10]) < 1e3 < 1e20 < min(size[10:]), (pkg, size)


def test_severe_fault_cell_rejections_follow_the_start():
    """The reference itself rejects a different number of updates at this
    cell from another start: after the damaged update, which clients'
    gradients come out non-finite is decided by the model's values.  So the
    port, which starts from its own init, is not held to the committed count
    (ROADMAP §3, D2)."""
    counts = {start: _severe_cell_runs(start)[0]["total_rejected"]
              for start in ("reference", "port")}
    assert counts["reference"] != counts["port"], counts


def test_reference_rerun_fixture_is_the_reference_here():
    """The sweep check's yardstick for fl-sim facts
    (``tests/fixtures/sweep_reference_rerun.json``): the reference reruns the
    cheapest fl cell here and gives its fixture entry bit for bit, where the
    committed row differs in the last bits of its float sums (ROADMAP §3, D1)."""
    from repro.sweep import get_preset
    from repro.sweep.runner import _json_sanitize, execute_cell

    key = "0215eb4072937384"                       # fl-fault-grid, unified_q, no faults
    cell = next(c for c in get_preset("fl-fault-grid").cells() if c.key == key)
    here = os.path.dirname(__file__)
    with open(os.path.join(here, "fixtures", "sweep_reference_rerun.json")) as f:
        want = json.load(f)[key]
    with open(os.path.join(here, "..", "results", "sweep_fl-fault-grid.jsonl")) as f:
        committed = next(r for r in map(json.loads, f) if r["key"] == key)["metrics"]
    got = _json_sanitize(execute_cell(cell.spec))
    assert {k: got[k] for k in want if k != "sweep"} == {k: v for k, v in want.items()
                                                         if k != "sweep"}
    assert committed["total_energy_j"] != got["total_energy_j"]
    assert abs(committed["total_energy_j"] - got["total_energy_j"]) < 1e-12


def test_entry_points_need_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from repro_torch.launch import fl

    spec = TSpec(arch="mobilenet", workload="fl-sim", rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSession(spec).run()
    with pytest.raises(RuntimeError, match="CUDA"):
        fl.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TSession(TSpec(arch="yi-6b", workload="train", mesh="2x1")).run()
    with pytest.raises(ValueError, match="'shape' option"):     # a dry run names its cell
        TSession(TSpec(arch="yi-6b", workload="dryrun"), device="cpu").run()
