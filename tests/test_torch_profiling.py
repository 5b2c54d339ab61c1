"""The port's spans (sparse_matrix_tpu_torch/utils/profiling.py) at its
layer boundaries, on the CPU with small inputs:

* off (the default), ``span`` hands out one shared null context, reads no
  clock and never enters ``torch.profiler.record_function``, and nothing
  is recorded; on with no profiler active, spans are recorded in memory
  and ``record_function`` is not entered;
* on, every site records its spans with their parents and counts: the
  solve, its outer matvecs, its ``M^-1`` and its host reads in CG, PCG,
  mixed-precision CG, the multi-RHS CG and PCG, BiCGSTAB with the fused
  ILU sweeps, GMRES and AMG-PCG (V-cycle levels ``0..L-1`` nested, then
  the coarse solve); the refresh of ``EscSpgemm`` with its expansion and
  reduction; the plans of the operator, the ILU preconditioner, the ESC
  engine and each AMG set-up phase;
* results are bit-equal with the spans on and off;
* ``amg_setup`` calls ``on_phase`` in the same sequence either way, each
  call just after its ``spmx.plan.amg.<phase>`` span closed;
* no span opens inside a span of the same name;
* ``trace(path)`` writes a Chrome trace holding the spans.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparse_matrix_tpu_torch.bench.corpus import fem_like, with_dominant_diagonal  # noqa: E402
from sparse_matrix_tpu_torch.ops.device_sorted import EscSpgemm  # noqa: E402
from sparse_matrix_tpu_torch.ops.operator import SpmvOperator  # noqa: E402
from sparse_matrix_tpu_torch.solvers import amg, bicgstab, cg, gmres, ilu  # noqa: E402
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402
from sparse_matrix_tpu_torch.utils import profiling  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with the spans off and none recorded."""
    profiling.disable()
    profiling.take()
    yield
    profiling.disable()
    profiling.take()


def _rhs(n, seed, k=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if k is None else (n, k)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _poisson(n=20):
    return poisson_2d_csr(n, dtype=np.float32)


def _unsymmetric():
    return with_dominant_diagonal(fem_like(np.random.default_rng(3), 16, 1), shift=2.0)


# -- the cases: each builds its plans, then runs one request ------------------


def _cg():
    a = _poisson()
    op = SpmvOperator(a, device=CPU)
    return lambda: cg.cg_solve(op, _rhs(a.rows, 1), tol=1e-5, maxiter=500)


def _pcg():
    a = _poisson()
    op = SpmvOperator(a, device=CPU)
    m = cg.jacobi_preconditioner(a, CPU)
    return lambda: cg.pcg_solve(op, _rhs(a.rows, 2), m, tol=1e-5, maxiter=500)


def _cg_ir():
    a = _poisson(12)
    op = SpmvOperator(a, device=CPU)
    return lambda: cg.cg_solve_ir(op, op, _rhs(a.rows, 3), tol=1e-5, maxiter=500,
                                  inner_tol=1e-2, inner_maxiter=50)


def _cg_multi():
    a = _poisson()
    op = SpmvOperator(a, device=CPU)
    return lambda: cg.cg_solve_multi(op.matmat, _rhs(a.rows, 4, k=3), tol=1e-5, maxiter=500)


def _pcg_multi():
    a = _poisson()
    op = SpmvOperator(a, device=CPU)
    m = cg.jacobi_preconditioner(a, CPU)
    return lambda: cg.pcg_solve_multi(op.matmat, _rhs(a.rows, 5, k=3), m, tol=1e-5,
                                      maxiter=500)


def _bicgstab_ilu():
    a = _unsymmetric()
    op = SpmvOperator(a, device=CPU)
    m = ilu.ilu_preconditioner(a, device=CPU, sweeps=4, fused=True)
    return lambda: bicgstab.bicgstab_solve(op, _rhs(a.rows, 6), tol=1e-6, maxiter=200,
                                           m_inv=m)


def _gmres_ilu():
    a = _unsymmetric()
    op = SpmvOperator(a, device=CPU)
    m = ilu.ilu_preconditioner(a, device=CPU, sweeps=3)
    return lambda: gmres.gmres_solve(op, _rhs(a.rows, 7), restart=8, tol=1e-6, maxiter=200,
                                     m_inv=m)


def _amg_pcg():
    a = poisson_2d_csr(32, dtype=np.float32)
    h = amg.amg_setup(a, device=CPU, coarse_size=50)
    assert len(h.levels) >= 2
    return lambda: amg.amg_pcg_solve(a, _rhs(a.rows, 8), hierarchy=h, tol=1e-6, maxiter=100)


def _esc(reduce):
    def make():
        a = _poisson(16)
        eng = EscSpgemm(a, a, device=CPU, reduce=reduce)
        assert eng.engine == "pallas"
        v = _rhs(a.nnz(), 9)
        return lambda: eng.multiply_device(lhs_vals=v, rhs_vals=v)
    return make


SOLVES = {"cg": _cg, "pcg": _pcg, "cg_ir": _cg_ir, "cg_multi": _cg_multi,
          "pcg_multi": _pcg_multi, "bicgstab_ilu": _bicgstab_ilu, "gmres_ilu": _gmres_ilu,
          "amg_pcg": _amg_pcg}
CASES = dict(SOLVES, esc_sort=_esc("sort"), esc_spmv=_esc("spmv"))


def _result_tensors(out):
    if isinstance(out, cg.CgResult):
        return [out.x, out.residual_norm], out.iterations
    return [out.row, out.col, out.val, out.nnz], None


def _names(spans):
    return [s.name for s in spans]


def _count(spans, name, parent=None):
    """Spans named ``name`` (whose parent is named ``parent``, if given)."""
    return sum(1 for s in spans if s.name == name
               and (parent is None or (s.parent >= 0 and spans[s.parent].name == parent)))


# -- off ---------------------------------------------------------------------


def test_off_is_one_shared_null_context():
    assert not profiling.enabled()
    assert profiling.span("spmx.solve") is profiling.span("spmx.amg.level1")
    with profiling.span("spmx.solve") as s:
        assert s is None


@pytest.mark.parametrize("case", sorted(CASES))
def test_off_records_nothing_reads_no_clock_enters_no_profiler(case, monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("the off path entered the profiler or read a clock")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(profiling, "time", type("Clock", (), {"perf_counter_ns": boom}))
    CASES[case]()()
    assert profiling.take() == []


# -- on ----------------------------------------------------------------------


def _profiled_on(case):
    """Build the case and run its request with the spans on; returns the
    request's spans and its output."""
    run = CASES[case]()
    profiling.take()
    profiling.enable()
    out = run()
    profiling.disable()
    return profiling.take(), out


@pytest.mark.parametrize("case", sorted(CASES))
def test_results_bit_equal_on_and_off(case):
    run = CASES[case]()
    off, it_off = _result_tensors(run())
    profiling.enable()
    on, it_on = _result_tensors(run())
    profiling.disable()
    assert it_on == it_off
    for a, b in zip(off, on):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_solve_spans_nest_under_one_solve(case):
    spans, out = _profiled_on(case)
    k = out.iterations
    assert 0 < k < 500
    assert _count(spans, "spmx.solve") == 1
    assert spans[0].name == "spmx.solve" and spans[0].parent == -1
    for s in spans[1:]:
        assert s.parent >= 0
    for name in ("spmx.krylov.matvec", "spmx.krylov.precond", "spmx.krylov.sync"):
        assert _count(spans, name) == _count(spans, name, "spmx.solve")
    matvec, precond = _count(spans, "spmx.krylov.matvec"), _count(spans, "spmx.krylov.precond")
    sync = _count(spans, "spmx.krylov.sync")
    if case in ("cg", "pcg", "amg_pcg"):
        # the initial residual and one an iteration; tol^2, then a read an
        # iteration and the last, failing one
        assert matvec == k + 1 and sync == k + 2
        assert precond == (0 if case == "cg" else k + 1)
    elif case in ("cg_multi", "pcg_multi"):
        # tol^2 stays on the device
        assert matvec == k + 1 and sync == k + 1
        assert precond == (0 if case == "cg_multi" else k + 1)
    elif case == "bicgstab_ilu":
        assert matvec == 2 * k + 1 and precond == 2 * k and sync == k + 1
        # the two fused triangular sweeps of each M^-1
        assert _count(spans, "spmx.ilu.sweep") == 4 * k
        assert _count(spans, "spmx.ilu.sweep", "spmx.krylov.precond") == 4 * k
    elif case == "gmres_ilu":
        assert precond >= 2 and matvec >= precond and sync >= 3
        assert _count(spans, "spmx.ilu.sweep") == 2 * precond
    elif case == "cg_ir":
        # the inner loops' reads and their tol^2 reads lie under the solve
        assert matvec > k and sync > k
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_vcycle_levels_nest_one_inside_the_next():
    spans, out = _profiled_on("amg_pcg")
    vcycles = _count(spans, "spmx.krylov.precond")
    assert vcycles == out.iterations + 1
    levels = sorted({s.name for s in spans if s.name.startswith("spmx.amg.level")})
    nlev = len(levels)
    assert levels == [f"spmx.amg.level{i}" for i in range(nlev)] and nlev >= 2
    assert _count(spans, "spmx.amg.level0", "spmx.krylov.precond") == vcycles
    for i in range(1, nlev):
        assert _count(spans, f"spmx.amg.level{i}", f"spmx.amg.level{i - 1}") == vcycles
    assert _count(spans, "spmx.amg.coarse", f"spmx.amg.level{nlev - 1}") == vcycles
    assert _count(spans, "spmx.amg.coarse") == vcycles


def test_vcycle_block_has_the_same_levels():
    a = poisson_2d_csr(32, dtype=np.float32)
    h = amg.amg_setup(a, device=CPU, coarse_size=50)
    profiling.enable()
    h.vcycle(_rhs(a.rows, 10, k=4))
    profiling.disable()
    spans = profiling.take()
    assert _names(spans) == [f"spmx.amg.level{i}" for i in range(len(h.levels))] + [
        "spmx.amg.coarse"]
    assert [s.parent for s in spans] == list(range(-1, len(h.levels)))


@pytest.mark.parametrize("case", ["esc_sort", "esc_spmv"])
def test_esc_refresh_spans(case):
    spans, _ = _profiled_on(case)
    assert _names(spans) == ["spmx.esc.multiply", "spmx.esc.expand", "spmx.esc.reduce"]
    assert [s.parent for s in spans] == [-1, 0, 0]
    assert spans[1].end_ns <= spans[2].start_ns


@pytest.mark.parametrize("reduce", ["sort", "spmv"])
def test_esc_plan_span(reduce):
    a = _poisson(16)
    profiling.enable()
    EscSpgemm(a, a, device=CPU, reduce=reduce)
    profiling.disable()
    spans = profiling.take()
    assert spans[0].name == "spmx.plan.esc" and spans[0].parent == -1
    # the selection operator of the SpMV reduction is an operator plan
    ops = _count(spans, "spmx.plan.operator", "spmx.plan.esc")
    assert ops == (1 if reduce == "spmv" else 0)
    assert len(spans) == 1 + ops


def test_operator_and_ilu_plan_spans():
    a = _unsymmetric()
    profiling.enable()
    SpmvOperator(a, device=CPU)
    ilu.ilu_preconditioner(a, device=CPU, sweeps=4, fused=True)
    ilu.ic_preconditioner(_poisson(), device=CPU, sweeps=2)
    profiling.disable()
    spans = profiling.take()
    tops = [s.name for s in spans if s.parent == -1]
    assert tops == ["spmx.plan.operator", "spmx.plan.ilu", "spmx.plan.ilu"]
    # each preconditioner plans one operator for each of its two factors
    assert _count(spans, "spmx.plan.operator", "spmx.plan.ilu") == 4
    assert len(spans) == 7


def _phase_sequence(n_levels):
    """``on_phase``'s names in order for a hierarchy of ``n_levels``, as
    ``amg_setup`` has called them since it took ``on_phase``."""
    seq = []
    for level in range(n_levels):
        seq += [(level, "strength_aggregate"), (level, "smooth"), (level, "galerkin"),
                (level, "galerkin")]
    seq += [(level, "plan") for level in range(n_levels)]
    return seq + [(n_levels, "pinv"), (n_levels, "upload")]


KEYS = {"strength_aggregate": set(), "smooth": {"p_nnz"}, "galerkin": {"engine", "products"},
        "plan": {"n", "nnz", "formats"}, "pinv": {"coarse_n"}, "upload": set()}


@pytest.mark.parametrize("on", [False, True])
def test_amg_setup_on_phase_sequence_and_spans(on):
    a = poisson_2d_csr(32, dtype=np.float32)
    calls = []

    def on_phase(level, name, **info):
        calls.append((level, name, info, list(profiling._OPEN)))

    if on:
        profiling.enable()
    h = amg.amg_setup(a, device=CPU, coarse_size=50, on_phase=on_phase)
    profiling.disable()
    spans = profiling.take()
    assert [(lv, n) for lv, n, _i, _o in calls] == _phase_sequence(len(h.levels))
    for _lv, name, info, open_spans in calls:
        assert set(info) == KEYS[name]
        assert open_spans == []  # the phase's span closed before its call
    plan_fmts = [i["formats"] for _lv, n, i, _o in calls if n == "plan"]
    assert plan_fmts == [(lv.a_op.format, lv.p_op.format, lv.pt_op.format) for lv in h.levels]
    if not on:
        assert spans == []
        return
    phases = [s for s in spans if s.name.startswith("spmx.plan.amg.")]
    assert [s.name for s in phases] == ["spmx.plan.amg." + n for _lv, n, _i, _o in calls]
    assert all(s.parent == -1 for s in phases)
    # each level's plan phase holds the plans of A, P and P^T
    assert _count(spans, "spmx.plan.operator", "spmx.plan.amg.plan") == 3 * len(h.levels)
    assert len(spans) == len(phases) + 3 * len(h.levels)


def test_galerkin_without_a_callback_still_records_its_spans():
    a = poisson_2d_csr(16, dtype=np.float32)
    profiling.enable()
    levels, _ = amg.amg_coarsen(a, coarse_size=20, device=CPU)
    assert levels
    profiling.disable()
    names = _names(profiling.take())
    assert names.count("spmx.plan.amg.galerkin") == 2 * len(levels)
    assert names.count("spmx.plan.amg.smooth") == len(levels)


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_span_opens_inside_one_of_its_name(case):
    spans, _ = _profiled_on(case)
    assert spans
    for s in spans:
        p = s.parent
        while p >= 0:
            assert spans[p].name != s.name, s
            p = spans[p].parent


def test_on_without_a_profiler_records_in_memory_alone(monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("record_function entered with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    spans, out = _profiled_on("pcg")
    assert _count(spans, "spmx.krylov.precond") == out.iterations + 1


def test_take_refuses_inside_an_open_span():
    profiling.enable()
    with profiling.span("spmx.solve"):
        with pytest.raises(RuntimeError, match="spmx.solve"):
            profiling.take()
    assert _names(profiling.take()) == ["spmx.solve"]
    assert profiling.take() == []


def test_span_closes_on_an_exception():
    profiling.enable()
    with pytest.raises(ValueError):
        with profiling.span("spmx.solve"):
            with profiling.span("spmx.krylov.matvec"):
                raise ValueError("inside")
    spans = profiling.take()
    assert _names(spans) == ["spmx.solve", "spmx.krylov.matvec"]
    assert [s.parent for s in spans] == [-1, 0]
    assert all(s.end_ns >= s.start_ns > 0 for s in spans)


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    run = CASES["pcg"]()
    path = tmp_path / "pcg.json"
    with profiling.trace(path):
        assert profiling.enabled()
        out = run()
    assert not profiling.enabled()
    assert profiling.take() == []  # spans were off before: memory dropped, the file holds them
    profiling.enable()
    run()
    profiling.disable()
    recorded = profiling.take()
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    ranges = [e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("spmx.")]
    names = [e["name"] for e in ranges]
    assert names.count("spmx.solve") == 1
    assert names.count("spmx.krylov.matvec") == out.iterations + 1
    assert names.count("spmx.krylov.precond") == out.iterations + 1
    assert sorted(names) == sorted(_names(recorded))
    # a span's range holds its children's on the trace's one clock
    solve = next(e for e in ranges if e["name"] == "spmx.solve")
    for e in ranges:
        assert solve["ts"] <= e["ts"] and e["ts"] + e["dur"] <= solve["ts"] + solve["dur"] + 1


def test_trace_keeps_spans_on_that_were_on(tmp_path):
    profiling.enable()
    with profiling.span("spmx.solve"):
        pass
    with profiling.trace(tmp_path / "t.json"):
        with profiling.span("spmx.krylov.sync"):
            pass
    assert profiling.enabled()
    assert _names(profiling.take()) == ["spmx.solve", "spmx.krylov.sync"]
