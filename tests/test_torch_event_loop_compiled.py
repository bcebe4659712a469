"""The compiled circuit event loop against its numpy twin and the
reference, bit for bit.

``core.engine._event_loop`` runs ``kernels/csrc/event_loop_host.cpp``,
built by the host compiler on first use (``kernels/_build.py``).
``_event_loop_plain`` below is its numpy twin: the reference's
``repro.core.engine._event_loop`` with the work counts added. On every
table here the compiled loop and the twin give the same establishment
times, compared as float64 bits, the same ``events`` and ``flows``, or
the same error; and wherever the twin returns establishment times, the
reference returns them too, bit for bit. Under the guard ``tested`` is
the twin's too. Work-conserving, the compiled loop merges each event's
lists by index and stops reading a list at its first row that can start,
so ``tested`` is its own count (the rows whose two resources it checked):
at least the flows started and at most the twin's. The reference is left
out only for the other dtypes
(``test_other_dtypes_are_read_as_the_numpy_loop_reads_them``), for inputs
outside the domain (``INVALID``) and where the loops deadlock. The tables
are seeded and random, in every mode the loop has: work-conserving and
priority-guard, releases, seeded horizons, per-flow delays, ``t0``, exact
ties and service times below the time's ulp. The compiled loop's own
counts, ``visited`` (the flow rows it read), ``unread`` (the rows left
behind its cursors) and ``unreleased`` (the pending rows it read before
their release), hold on every table: ``visited`` is at least ``tested +
unreleased`` (equal under the guard, where ``unreleased`` is the twin's),
``unread`` is at least 0 and ``unreleased`` is 0 without releases. An
integer ``t0`` is a declared difference: the compiled loop reads
it as a float, where the reference deadlocks.
"""
import heapq

import numpy as np
import pytest

import repro.core.engine as ref_engine
import repro_torch.core as port
import repro_torch.core.engine as port_engine
from repro_torch import obs
from repro_torch.core.engine import _add_counts
from repro_torch.kernels import _build, event_loop


# -- the numpy twin ----------------------------------------------------------

def _first_occurrence(vals: np.ndarray, scratch: np.ndarray) -> np.ndarray:
    """Boolean mask marking the first occurrence of each value, in order.

    Writing positions in reverse leaves each slot of ``scratch`` holding the
    *first* position of its value (numpy's fancy assignment keeps the last
    write), so a flow is first on its resource iff the slot points back at
    it. ``scratch`` is int64 with at least ``vals.max() + 1`` entries.
    """
    n = vals.size
    scratch[vals[::-1]] = np.arange(n - 1, -1, -1)
    return scratch[vals] == np.arange(n)


def _by_resource(res_ids: np.ndarray, n_res: int) -> list[np.ndarray]:
    """Flow indices using each resource, in priority (index) order."""
    order = np.argsort(res_ids, kind="stable")
    counts = np.bincount(res_ids, minlength=n_res)
    return np.split(order, np.cumsum(counts)[:-1])


def _pop_next_event(events: list[float], t: float) -> float:
    """Earliest completion strictly after t (``events`` is a heap)."""
    while events and events[0] <= t:
        heapq.heappop(events)
    if not events:
        raise RuntimeError("scheduler deadlock: pending flows but no events")
    return heapq.heappop(events)


def _event_loop_plain(
    rin: np.ndarray,    # (F,) int64 ingress resource ids (core*N + i)
    rout: np.ndarray,   # (F,) int64 egress resource ids (core*N + j)
    srv: np.ndarray,    # (F,) float64 service times size/rate[core]
    core: np.ndarray,   # (F,) int64
    delta: float | np.ndarray,
    n_res: int,
    n_ports: int,
    t0: float = 0.0,
    guard: bool = False,
    release: np.ndarray | None = None,
    free_in0: np.ndarray | None = None,
    free_out0: np.ndarray | None = None,
    stats: dict | None = None,
) -> np.ndarray:
    """Merged event loop over all cores in numpy; flows in priority order.
    The twin the compiled ``core.engine._event_loop`` is held to.

    Returns t_establish per flow, exactly as the reference's sequential
    list scan: at each event the started set is {flows whose two resources
    are free and which are the first pending user of both}, iterated to a
    fixed point for ``guard=False`` (work-conserving), single-pass for
    ``guard=True`` (priority-guard: a pending higher-priority flow holds
    both its resources whether or not it starts).

    Work-conserving: after each event's fixed point every pending flow has
    a busy resource or an unreached release, so only flows on resources
    freed exactly at the next event, or released exactly then, can start;
    candidates come from those resources' flow lists and the release lists.
    ``release`` (per flow) gates eligibility by the exact comparison
    ``release <= t``; an unreleased flow never protects its ports under
    ``guard=True``. Event times are copied verbatim from completion and
    release times, so the exact float comparisons below are the convention,
    not a hazard. ``t0`` is the time the resources free (the sunflow
    barrier). ``delta`` is a scalar or a per-flow array (drifted cores).

    ``free_in0``/``free_out0`` (per resource, both or neither) seed the port
    horizons from circuits already committed by earlier service ticks
    (``fabric.FabricState``): every horizon strictly after ``t0`` goes into
    the event heap, so the loop wakes when a committed circuit tears down;
    ``+inf`` horizons (a failed core's resources) are never seeded. With
    ``None`` this is the from-scratch loop.

    ``stats`` (a dict) gets the loop's work added under ``events`` (the
    times it woke at an event time, the start at ``t0`` included),
    ``tested`` (the candidate rows that entered the feasibility test: the
    work-conserving candidates before the free-resource filter, the
    guarded pending rows after the release filter, once an event) and
    ``flows`` (the flows started, ``F``); under the guard with ``release``
    also ``unreleased`` (the pending rows the release filter drops).
    Counting changes no comparison.
    """
    F = rin.size
    t_est = np.full(F, -1.0)
    if F == 0:
        _add_counts(stats, 0, 0, 0)
        return t_est
    d_vec = None if np.ndim(delta) == 0 else np.asarray(delta, dtype=np.float64)
    if free_in0 is None:
        free_in = np.full(n_res, t0)
        free_out = np.full(n_res, t0)
    else:
        free_in = np.asarray(free_in0, dtype=np.float64).copy()
        free_out = np.asarray(free_out0, dtype=np.float64).copy()
    done = np.zeros(F, dtype=bool)
    scratch = np.empty(n_res, dtype=np.int64)
    events: list[float] = []  # heap of future completion and release times
    if free_in0 is not None:
        seed_in = free_in[(free_in > t0) & np.isfinite(free_in)]
        seed_out = free_out[(free_out > t0) & np.isfinite(free_out)]
        events = np.unique(np.concatenate([seed_in, seed_out])).tolist()
    remaining = F
    t = t0
    n_events = 1
    n_tested = 0
    n_unreleased = 0
    if release is not None:
        rel_uniq, rel_inv = np.unique(release, return_inverse=True)
        events.extend(rel_uniq.tolist())
        heapq.heapify(events)
        # flow indices grouped by release value, in priority order
        rel_lists = np.split(np.argsort(rel_inv, kind="stable"),
                             np.cumsum(np.bincount(rel_inv))[:-1])
        rel_map = {float(v): lst for v, lst in zip(rel_uniq, rel_lists)}

    if guard:
        pending = np.arange(F)
        first_event = True
        while remaining:
            if first_event:
                pend = pending
                first_event = False
            else:
                # Only cores with a completion (or a release) at t can
                # start flows now.
                act = np.zeros(n_res // n_ports, dtype=bool)
                act[np.nonzero(free_in == t)[0] // n_ports] = True
                act[np.nonzero(free_out == t)[0] // n_ports] = True
                if release is not None:
                    act[core[pending[release[pending] == t]]] = True
                pend = pending[act[core[pending]]]
            if release is not None and pend.size:
                n_unreleased += pend.size
                pend = pend[release[pend] <= t]
                n_unreleased -= pend.size
            n_tested += pend.size
            if pend.size:
                ri, rj = rin[pend], rout[pend]
                feas = ((free_in[ri] <= t) & (free_out[rj] <= t)
                        & _first_occurrence(ri, scratch)
                        & _first_occurrence(rj, scratch))
                start = pend[feas]
                if start.size:
                    tc = (t + (delta if d_vec is None else d_vec[start])) \
                        + srv[start]
                    free_in[rin[start]] = tc
                    free_out[rout[start]] = tc
                    t_est[start] = t
                    done[start] = True
                    remaining -= start.size
                    for v in tc.tolist():
                        heapq.heappush(events, v)
                    pending = pending[~done[pending]]
                    if not remaining:
                        break
            t = _pop_next_event(events, t)
            n_events += 1
        _add_counts(stats, n_events, n_tested, F,
                    unreleased=None if release is None else n_unreleased)
        return t_est

    in_lists = _by_resource(rin, n_res)
    out_lists = _by_resource(rout, n_res)
    cand = np.arange(F)  # at t0 every (released) flow is a candidate
    if release is not None:
        cand = cand[release[cand] <= t]
    while remaining:
        n_tested += cand.size
        cand = cand[(free_in[rin[cand]] <= t) & (free_out[rout[cand]] <= t)]
        while cand.size:
            safe = _first_occurrence(rin[cand], scratch) \
                & _first_occurrence(rout[cand], scratch)
            start = cand[safe]
            tc = (t + (delta if d_vec is None else d_vec[start])) + srv[start]
            free_in[rin[start]] = tc
            free_out[rout[start]] = tc
            t_est[start] = t
            done[start] = True
            remaining -= start.size
            for v in tc.tolist():
                heapq.heappush(events, v)
            cand = cand[~safe]
            cand = cand[(free_in[rin[cand]] <= t) & (free_out[rout[cand]] <= t)]
        if not remaining:
            break
        t = _pop_next_event(events, t)
        n_events += 1
        pool = [in_lists[r] for r in np.nonzero(free_in == t)[0]]
        pool += [out_lists[r] for r in np.nonzero(free_out == t)[0]]
        if release is not None:
            pool.append(rel_map.get(t, np.empty(0, np.int64)))
        cand = np.unique(np.concatenate(pool)) if pool else np.empty(0, np.int64)
        cand = cand[~done[cand]]
        if release is not None:
            cand = cand[release[cand] <= t]
    _add_counts(stats, n_events, n_tested, F)
    return t_est


# -- the compiled loop against the twin and the reference --------------------

GUARDS = pytest.mark.parametrize("guard", [False, True],
                                 ids=["work-conserving", "priority-guard"])


def _outcome(fn):
    """``(t_est as int64 bits, stats)`` of a loop call, or its error."""
    stats = {}
    try:
        t_est = fn(stats)
    except (RuntimeError, IndexError) as exc:
        return type(exc).__name__, str(exc)
    return t_est.view(np.int64).tolist(), stats


def _assert_counts(got: dict, want: dict, guard: bool,
                   released: bool) -> None:
    """The compiled loop's counts ``got`` against the twin's ``want``:
    ``events`` and ``flows`` equal, ``tested`` equal under the guard and
    between the flows started and the twin's work-conserving, where the
    merge stops reading a list early; ``unread >= 0`` (0 under the guard,
    which reads whole lists); ``unreleased`` 0 without releases and the
    twin's under the guard; ``visited >= tested + unreleased``, equal
    under the guard, which tests every released row it reads."""
    assert set(got) == {"events", "tested", "flows", "visited", "unread",
                        "unreleased"}
    assert (got["events"], got["flows"]) == (want["events"], want["flows"])
    if guard:
        assert got["tested"] == want["tested"]
        assert got["unread"] == 0
        assert got["visited"] == got["tested"] + got["unreleased"]
        assert got["unreleased"] == want.get("unreleased", 0)
    else:
        assert want["flows"] <= got["tested"] <= want["tested"]
        assert got["unread"] >= 0
        assert got["visited"] >= got["tested"] + got["unreleased"]
    if not released:
        assert got["unreleased"] == 0


def _assert_same(rin, rout, srv, core, delta, n_res, n_ports,
                 reference=True, **kw):
    """The compiled loop gives the plain loop's establishment times bit for
    bit (or its error), called directly and through ``_event_loop``, with
    the counts ``_assert_counts`` allows; with ``reference``, the
    reference's loop gives the plain loop's establishment times bit for
    bit wherever the plain loop returns them. Returns the plain loop's
    outcome."""
    args = (rin, rout, srv, core, delta, n_res, n_ports)
    kw.setdefault("t0", 0.0)
    kw.setdefault("guard", False)

    def compiled(stats):
        out = event_loop.event_loop_compiled(
            *args, kw["t0"], kw["guard"], kw.get("release"),
            kw.get("free_in0"), kw.get("free_out0"))
        _add_counts(stats, *out[1])
        return out[0]

    got = _outcome(compiled)
    want = _outcome(lambda st: _event_loop_plain(*args, stats=st, **kw))
    assert got[0] == want[0]
    assert isinstance(got[1], dict) == isinstance(want[1], dict)
    if isinstance(want[1], dict):
        _assert_counts(got[1], want[1], kw["guard"],
                       kw.get("release") is not None)
    else:
        assert got == want
    if reference and isinstance(want[1], dict):
        ref_t = ref_engine._event_loop(*args, **kw)
        assert ref_t.view(np.int64).tolist() == want[0]
    via_dispatch = _outcome(
        lambda st: port_engine._event_loop(*args, stats=st, **kw))
    assert via_dispatch == got
    return want


def _table(seed, *, K=3, N=5, F=80, srv="exp", rates=None):
    """Random flows on K cores of N ports: ``(rin, rout, srv, core)``."""
    rng = np.random.default_rng(seed)
    core = rng.integers(0, K, F)
    rin = core * N + rng.integers(0, N, F)
    rout = core * N + rng.integers(0, N, F)
    if srv == "exp":
        s = rng.exponential(4.0, F)
    else:  # integer sizes over per-core rates: completions tie exactly
        size = rng.integers(1, 6, F).astype(np.float64) * 10.0
        s = size / np.asarray(rates, dtype=np.float64)[core]
    return rin, rout, s, core


@GUARDS
@pytest.mark.parametrize("seed", range(4))
def test_random_tables(seed, guard):
    rin, rout, srv, core = _table(seed)
    out = _assert_same(rin, rout, srv, core, 8.0, 15, 5, guard=guard)
    assert out[1]["flows"] == rin.size


@GUARDS
@pytest.mark.parametrize("t0", [0.0, 3.0, 12.5])
@pytest.mark.parametrize("seed", range(3))
def test_releases(seed, t0, guard):
    """Release times on a grid, so some equal each other, ``t0`` and the
    completion times exactly."""
    rin, rout, srv, core = _table(seed + 10, srv="ints",
                                  rates=[10.0, 10.0, 10.0])
    rel = np.random.default_rng(seed).integers(0, 30, rin.size) * 1.0
    _assert_same(rin, rout, srv, core, 2.0, 15, 5, guard=guard, t0=t0,
                 release=rel)


@GUARDS
@pytest.mark.parametrize("with_release", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_seeded_horizons(seed, with_release, guard):
    """Horizons after ``t0`` wake the loop; ``+inf`` (a failed core, no
    flow on it) and those at or before ``t0`` do not."""
    rng = np.random.default_rng(seed + 20)
    K, N, t0 = 3, 5, 10.0
    rin, rout, srv, core = _table(seed + 20, K=K, N=N)
    keep = core != 0
    rin, rout, srv, core = rin[keep], rout[keep], srv[keep], core[keep]
    fin = np.where(rng.random(K * N) < 0.5, rng.integers(0, 40, K * N), 0.0)
    fout = np.where(rng.random(K * N) < 0.5, rng.integers(0, 40, K * N), 0.0)
    fin[:N] = np.inf
    fout[:N] = np.inf
    fin[N] = t0  # a horizon at t0 exactly
    fout[N + 1] = 5.0  # and one before it
    rel = (rng.integers(10, 50, rin.size) * 1.0) if with_release else None
    _assert_same(rin, rout, srv, core, 8.0, K * N, N, guard=guard, t0=t0,
                 release=rel, free_in0=fin, free_out0=fout)


@GUARDS
@pytest.mark.parametrize("t0", [0.0, 7.5])
@pytest.mark.parametrize("seed", range(3))
def test_per_flow_delays(seed, t0, guard):
    rin, rout, srv, core = _table(seed + 30)
    d_f = np.random.default_rng(seed).uniform(0.0, 10.0, rin.size)
    _assert_same(rin, rout, srv, core, d_f, 15, 5, guard=guard, t0=t0)


@GUARDS
@pytest.mark.parametrize("seed", range(3))
def test_equal_rate_cores_tie_exactly(seed, guard):
    """Equal rates and integer sizes: many flows complete at one time, on
    several cores at once."""
    rin, rout, srv, core = _table(seed + 40, K=4, N=4, F=120, srv="ints",
                                  rates=[10.0] * 4)
    out = _assert_same(rin, rout, srv, core, 8.0, 16, 4, guard=guard)
    t_est = np.asarray(out[0]).view(np.float64)
    assert np.unique(t_est).size < t_est.size  # ties happened


@GUARDS
@pytest.mark.parametrize("share", [0.1, 0.6])
@pytest.mark.parametrize("seed", range(3))
def test_service_below_the_ulp_of_t(seed, share, guard):
    """delta 0 and a share of service times far below ``ulp(t)``: such a
    completion time equals its establishment time, so the flow frees its
    resources at the event it starts in. Under the guard that is often a
    deadlock (nothing else wakes the loop), which both loops raise."""
    rng = np.random.default_rng(seed + 50)
    rin, rout, _, core = _table(seed + 50, K=2, N=3, F=40)
    srv = np.where(rng.random(rin.size) < share, 1e-12, 1.0)
    t0 = 1e6
    assert t0 + 1e-12 == t0
    _assert_same(rin, rout, srv, core, 0.0, 6, 3, guard=guard, t0=t0)


@GUARDS
@pytest.mark.parametrize("F", [0, 1, 2])
def test_tiny_tables(F, guard):
    rin, rout, srv, core = _table(60 + F, F=F)
    out = _assert_same(rin, rout, srv, core, 8.0, 15, 5, guard=guard)
    assert out[1]["flows"] == F
    if F == 0:
        assert out == ([], {"events": 0, "tested": 0, "flows": 0})


@GUARDS
@pytest.mark.parametrize("with_release", [False, True])
def test_one_resource(with_release, guard):
    """Every flow on the one ingress and the one egress resource."""
    F = 12
    srv = np.random.default_rng(70).exponential(2.0, F)
    zero = np.zeros(F, dtype=np.int64)
    rel = np.arange(F, dtype=np.float64)[::-1] * 1.5 if with_release else None
    out = _assert_same(zero, zero, srv, zero, 1.0, 1, 1, guard=guard,
                       release=rel)
    assert out[1]["events"] >= F


@GUARDS
def test_deadlock_raises_as_the_numpy_loop(guard):
    """Seeded horizons all ``+inf`` never wake the loop: both raise."""
    rin, rout, srv, core = _table(80)
    inf = np.full(15, np.inf)
    out = _assert_same(rin, rout, srv, core, 8.0, 15, 5, guard=guard,
                       free_in0=inf, free_out0=inf.copy())
    assert out == ("RuntimeError",
                   "scheduler deadlock: pending flows but no events")


@pytest.fixture(scope="module")
def plan_m48_table():
    """A ``plan_m48``-sized table (about 38,000 flows): 48 trace coflows
    at N=150 on ``fb150_k16``'s rates, built as
    ``test_counts_bound_the_work_of_a_plan_m48_shaped_instance`` builds
    its instance."""
    K, N = 16, 150
    inst = port.sample_instance(port.synth_fb_trace(526, seed=2026), N=N,
                                M=48, rates=[10.0, 20.0, 30.0] * 5 + [10.0],
                                delta=8.0, seed=7, device="cpu")
    table = port.build_flow_table(inst, port.order_coflows(inst), "ours")
    core = table.core.numpy()
    srv = (table.size / inst.rates[table.core]).numpy()
    return ((core * N + table.fi.numpy(), core * N + table.fj.numpy(), srv,
             core, 8.0, K * N, N))


def test_a_plan_m48_sized_table(plan_m48_table):
    out = _assert_same(*plan_m48_table)
    assert out[1]["flows"] > 30_000
    assert out[1]["events"] <= out[1]["flows"] <= out[1]["tested"]


LONG_LISTS = {"K1-N4-F400": (1, 4, 400), "K3-N6-F900": (3, 6, 900)}


@pytest.mark.parametrize("mode", ["plain", "releases", "seeded"])
@pytest.mark.parametrize("srv", ["exp", "ints"])
@pytest.mark.parametrize("shape", list(LONG_LISTS))
def test_long_lists_compacted_many_times(shape, srv, mode):
    """Work-conserving on long per-port lists (100 flows a port), where
    backfill starts flows behind pending ones: each list is read and
    compacted at many events, with exact ties under integer sizes, with
    releases, and with seeded horizons and releases."""
    K, N, F = LONG_LISTS[shape]
    rin, rout, s, core = _table(100 + K, K=K, N=N, F=F, srv=srv,
                                rates=[10.0, 20.0, 30.0][:K])
    rng = np.random.default_rng(F)
    kw = {}
    if mode != "plain":
        kw["release"] = rng.integers(0, 60, F) * 1.0
    if mode == "seeded":
        kw["t0"] = 4.0
        kw["free_in0"] = rng.integers(0, 30, K * N) * 1.0
        kw["free_out0"] = rng.integers(0, 30, K * N) * 1.0
    out = _assert_same(rin, rout, s, core, 2.0, K * N, N, **kw)
    assert out[1]["flows"] == F
    assert out[1]["tested"] > 5 * F  # each freed port offers many rows


def test_the_offline_k3_cells_shape():
    """A table shaped as ``offline_k3``'s: trace coflows at N=150 on the
    paper's 3-core fabric (16 of them here, so the numpy twin stays
    quick). Each freed port's list holds many rows blocked behind the one
    that can take the port, and the merge stops reading a list there: it
    tests at most three quarters of the rows the twin tests, and leaves
    rows unread."""
    K, N = 3, 150
    inst = port.sample_instance(port.synth_fb_trace(526, seed=2026), N=N,
                                M=16, rates=[10.0, 20.0, 30.0], delta=8.0,
                                seed=2 ** 31 + 11, device="cpu")
    table = port.build_flow_table(inst, port.order_coflows(inst), "ours")
    core = table.core.numpy()
    srv = (table.size / inst.rates[table.core]).numpy()
    args = (core * N + table.fi.numpy(), core * N + table.fj.numpy(), srv,
            core, 8.0, K * N, N)
    out = _assert_same(*args)
    assert out[1]["flows"] > 5_000
    stats = {}
    port_engine._event_loop(*args, stats=stats)
    assert stats["tested"] <= 0.75 * out[1]["tested"]
    assert stats["unread"] > 0


def test_a_list_is_read_up_to_the_row_that_takes_its_port():
    """One core of 6 ports, delta 1, work-conserving. At 0, 1->1 and
    2->2 start (until 11) and so does 0->3 (until 2). Ingress 0's list is
    then [0->3, 0->1, 0->2, 0->4, 0->5, 0->3]: at 2 the merge reads 0->3
    (finished), 0->1 and 0->2 (blocked on egress 1 and 2) and 0->4, which
    starts and takes the port, so 0->5 and the second 0->3 are left unread
    (2 rows); egress 3's list is read whole (2 rows), and passes the second
    0->3 untested, as ingress 0's list holds it. At 4 and 6 the list is
    read up to 0->5, then 0->3 (1 row unread at 4); at 8 the two blocked
    rows are tested again; at 11 egress 1 and 2 free, 0->1 starts from
    egress 1's list and takes ingress 0, so 0->2 waits until 13. Rows
    tested: 8 + 3 + 3 + 3 + 2 + 2 + 1; read: 8 + 6 + 4 + 4 + 3 + 6 + 2."""
    flows = [(1, 1), (2, 2), (0, 3), (0, 1), (0, 2), (0, 4), (0, 5), (0, 3)]
    rin = np.array([i for i, _ in flows], dtype=np.int64)
    rout = np.array([j for _, j in flows], dtype=np.int64)
    srv = np.array([10.0, 10.0] + [1.0] * 6)
    core = np.zeros(rin.size, dtype=np.int64)
    args = (rin, rout, srv, core, 1.0, 6, 6)
    out = _assert_same(*args)
    counts = {}
    t_est = port_engine._event_loop(*args, stats=counts)
    np.testing.assert_array_equal(t_est, [0, 0, 0, 11, 13, 2, 4, 6])
    assert t_est.view(np.int64).tolist() == out[0]
    assert counts == {"events": 7, "tested": 22, "flows": 8, "visited": 33,
                      "unread": 3, "unreleased": 0}
    assert out[1]["tested"] > counts["tested"]


@GUARDS
def test_rows_read_before_their_release_are_counted(guard):
    """One core of 3 ports, delta 1: 0->0 (2 long) and 0->2 released at
    0, 0->1 and 1->0 (1 long each) at 5. At 0 all four rows are read and
    the two unreleased passed; 0->0 starts (until 3), 0->2 waits on
    ingress 0. At 3 work-conserving reads ingress 0's list [0->0, 0->1,
    0->2] and egress 0's [0->0, 1->0], passing 0->1 and 1->0 unreleased,
    and starts 0->2 (until 5); the guard reads its three pending rows and
    passes the same two. At 5 both start: work-conserving from ingress
    0's list and the release group (which passes 0->1 untested, as
    ingress 0's list tests it); the guard from its two pending rows. So
    2 + 2 rows passed unreleased in both modes; read: work-conserving 4 +
    5 + 4, the guard 4 + 3 + 2."""
    rin = np.array([0, 0, 0, 1], dtype=np.int64)
    rout = np.array([0, 1, 2, 0], dtype=np.int64)
    srv = np.array([2.0, 1.0, 1.0, 1.0])
    core = np.zeros(4, dtype=np.int64)
    release = np.array([0.0, 5.0, 0.0, 5.0])
    args = (rin, rout, srv, core, 1.0, 3, 3)
    out = _assert_same(*args, guard=guard, release=release)
    counts = {}
    t_est = port_engine._event_loop(*args, guard=guard, release=release,
                                    stats=counts)
    np.testing.assert_array_equal(t_est, [0.0, 5.0, 3.0, 5.0])
    assert t_est.view(np.int64).tolist() == out[0]
    assert counts == {"events": 3, "tested": 5, "flows": 4,
                      "visited": 9 if guard else 13, "unread": 0,
                      "unreleased": 4}
    if guard:
        assert out[1]["unreleased"] == 4


FREE_AFTER_START = {
    "zero service": (0.0, 0.0, False),
    "service below the ulp of t": (1e6, 1e-12, False),
    "zero service, releases tied to completions": (0.0, 0.0, True),
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", list(FREE_AFTER_START))
def test_a_port_a_start_leaves_free_is_read_on(case, seed):
    """delta 0 and a share of service times that leave the completion
    time equal to the start: such a start keeps its ports free at t, so
    the merge reads on past it on the same list, as the twin's next round
    does. Integer sizes make completions (and releases, on the same grid)
    tie exactly. Some two flows of one ingress resource start at one
    time."""
    t0, tiny, with_release = FREE_AFTER_START[case]
    rng = np.random.default_rng(seed + 130)
    rin, rout, s, core = _table(seed + 130, K=2, N=3, F=60, srv="ints",
                                rates=[10.0, 10.0])
    srv = np.where(rng.random(rin.size) < 0.4, tiny, s)
    assert t0 + tiny == t0
    kw = {"t0": t0}
    if with_release:
        kw["release"] = t0 + rng.integers(0, 12, rin.size) * 1.0
    out = _assert_same(rin, rout, srv, core, 0.0, 6, 3, **kw)
    t_est = np.asarray(out[0]).view(np.float64)
    pairs = {(int(r), float(te)) for r, te in zip(rin, t_est)}
    assert len(pairs) < rin.size


@GUARDS
@pytest.mark.parametrize("seed", range(2))
def test_an_integer_t0_is_read_as_a_float(seed, guard):
    """A declared difference: the compiled loop reads ``t0=3`` as ``3.0``
    and gives its establishment times bit for bit, where the reference
    (and the twin with it) keeps int64 free times from an integer ``t0``
    and deadlocks. No caller passes an int: sunflow's barrier is a
    float."""
    rin, rout, srv, core = _table(seed + 110)
    args = (rin, rout, srv, core, 8.0, 15, 5)
    want = _assert_same(*args, t0=3.0, guard=guard)
    got = port_engine._event_loop(*args, t0=3, guard=guard)
    assert got.view(np.int64).tolist() == want[0]
    for loop in (ref_engine._event_loop, _event_loop_plain):
        with pytest.raises(RuntimeError, match="scheduler deadlock"):
            loop(*args, t0=3, guard=guard)


# -- inputs outside the loop's domain, and other dtypes ----------------------

def _small():
    return _table(90, K=2, N=3, F=20)


def _with(base, at, value):
    """A copy of ``base`` with ``value`` at ``at``."""
    a = base.copy()
    a[at] = value
    return a


INVALID = {
    "a NaN service time": lambda r, o, s, c: (
        (r, o, _with(s, 7, np.nan), c, 8.0, 6, 3), {}),
    "a NaN delay": lambda r, o, s, c: ((r, o, s, c, np.nan, 6, 3), {}),
    "a NaN release": lambda r, o, s, c: (
        (r, o, s, c, 8.0, 6, 3), {"release": _with(np.zeros(20), 5, np.nan)}),
    "a resource id out of range": lambda r, o, s, c: (
        (r, _with(o, 3, 6), s, c, 8.0, 6, 3), {}),
    "a negative resource id": lambda r, o, s, c: (
        (_with(r, 0, -1), o, s, c, 8.0, 6, 3), {}),
    "a negative t0": lambda r, o, s, c: ((r, o, s, c, 8.0, 6, 3),
                                         {"t0": -4.0}),
}


@GUARDS
@pytest.mark.parametrize("case", list(INVALID))
def test_inputs_outside_the_domain_raise(case, guard):
    """An id out of range, a NaN or a negative ``t0`` is refused with a
    ``ValueError``, by the loop and through ``_event_loop``."""
    args, kw = INVALID[case](*_small())
    with pytest.raises(ValueError, match="out of range, a NaN, or a "
                                         "negative t0"):
        port_engine._event_loop(*args, guard=guard, **kw)


def test_a_core_out_of_range_raises_under_the_guard():
    r, o, s, c = _small()
    args = (r, o, s, _with(c, 2, 5), 8.0, 6, 3)
    with pytest.raises(ValueError, match="out of range"):
        port_engine._event_loop(*args, guard=True)


OTHER_DTYPES = {
    "uint16 ids": lambda r, o, s, c: ((r.astype(np.uint16),
                                       o.astype(np.uint16), s,
                                       c.astype(np.uint16), 8.0, 6, 3), {}),
    "integer delay": lambda r, o, s, c: ((r, o, s, c, 8, 6, 3), {}),
    "int32 ids": lambda r, o, s, c: ((r.astype(np.int32), o.astype(np.int32),
                                      s, c.astype(np.int32), 8.0, 6, 3), {}),
}


@GUARDS
@pytest.mark.parametrize("case", list(OTHER_DTYPES))
def test_other_dtypes_are_read_as_the_numpy_loop_reads_them(case, guard):
    """Integer ids of another width and an integer delay give the numpy
    loop's outcome bit for bit: both compute in int64 and float64."""
    args, kw = OTHER_DTYPES[case](*_small())
    _assert_same(*args, reference=False, guard=guard, **kw)


# -- the build and the dispatch ------------------------------------------------

def test_the_host_target_is_keyed_on_source_and_flags(tmp_path, monkeypatch):
    (tmp_path / "k.cpp").write_text("// k\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._sources("k") == [tmp_path / "k.cpp"]
    before = _build._target("k")
    assert _build._target("k") == before
    (tmp_path / "k.cpp").write_text("// k, edited\n")
    edited = _build._target("k")
    assert edited != before
    monkeypatch.setattr(_build, "HOST_FLAGS", _build.HOST_FLAGS + ("-g",))
    assert _build._target("k") != edited


def test_the_host_flags_round_as_numpy_does():
    flags = _build.flags(event_loop.SOURCE)
    assert flags == _build.HOST_FLAGS
    assert "-ffp-contract=off" in flags
    assert not {"-ffast-math", "-Ofast", "-funsafe-math-optimizations"} \
        & set(flags)
    assert _build._source(event_loop.SOURCE).suffix == ".cpp"


def _loop_attrs(scheduling):
    inst = port.sample_instance(port.synth_fb_trace(120, seed=11), N=8, M=10,
                                rates=[10.0, 20.0, 30.0], delta=8.0, seed=5,
                                device="cpu")
    tr = obs.Tracer()
    prev = obs.set_tracer(tr)
    try:
        s = port.run_fast(inst, scheduling=scheduling)
    finally:
        obs.set_tracer(prev)
    loop = next(r for r in tr.records if r["kind"] == "span"
                and r["name"] == "fast/event_loop")
    return s, loop["attrs"]


@pytest.fixture
def fresh_entry():
    event_loop.entry.cache_clear()
    yield
    event_loop.entry.cache_clear()


@pytest.mark.parametrize("scheduling", ["work-conserving", "priority-guard",
                                        "sunflow", "reserving"])
def test_the_span_says_which_loop_ran(scheduling, fresh_entry):
    _, attrs = _loop_attrs(scheduling)
    want = "numpy" if scheduling == "reserving" else "compiled"
    assert attrs["impl"] == want


@pytest.mark.parametrize("scheduling", ["work-conserving", "priority-guard",
                                        "sunflow"])
def test_a_failed_build_raises(scheduling, monkeypatch, fresh_entry):
    """A build that fails stops the schedule, as a failed kernel build
    does; no other loop stands in."""
    def fail(name):
        raise RuntimeError("c++ failed to build " + name)

    monkeypatch.setattr(_build, "load", fail)
    with pytest.raises(RuntimeError, match="failed to build event_loop_host"):
        _loop_attrs(scheduling)
