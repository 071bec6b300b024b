"""Bounded model checking of the SSP/managed-communication protocol (the
port's copy of ``poseidon_tpu/analysis/model_check.py``: the port's async
tier speaks the same protocol, so the same model checks it, and the port
keeps its own copy rather than import the JAX package).

The async-SSP tier's correctness story now spans four interacting
mechanisms — durable-clock read gates, magnitude-prioritized
partial pushes with a residual force-flushed every ``staleness+1``
clocks, elastic admit/retire, and exactly-once replay over a
per-worker seq high-water mark — and its hardest bugs are
*interleaving* bugs chaos tests sample but never enumerate. This module
states the protocol as a small pure-Python transition system and
EXHAUSTIVELY explores every interleaving for bounded configurations
(2–3 workers x staleness 0–2 x one admit + one retire + a crash/rejoin,
lost-ack and leader-failover schedule), checking on every edge:

- **No deadlock**: in every reachable non-terminal state some action is
  enabled (a gate that can never unblock is found, with its trace).
- **Durable-clock sandwich**: ``durable <= raw <= durable + s + 1`` for
  every member, always — the bound the partial-push machinery promises.
- **Exactly-once**: a (worker, clock) delta is applied at most once; a
  replayed push whose ack was lost must dedup, never re-apply.
- **Read-gate safety**: whenever a gate ADMITS a reader at clock ``c``,
  every gated-on peer's DURABLE clock is ``>= c - s - 1`` — the SSP
  contract stated over bytes actually in the anchor, not raw clocks.
- **Failover completeness** (two-tier fabric, parallel/fabric.py): a
  worker here is granularity-agnostic — under ``max_failovers > 0`` it
  models a whole SPMD slice whose LEADER process dies mid-window. A
  correct successor re-derives the acked floor from the service and
  carries the ledgered residual; the seeded mutations drop the residual
  (``leader_failover_loses_residual`` — caught by the completeness
  monitor at the next full flush) or restart the seq stream
  (``double_apply_across_leaders`` — caught by the exactly-once
  monitor).

The gate *predicate* and the invariant *monitor* are deliberately
separate code paths, so a seeded mutation of the predicate (gate on raw
clocks instead of durable — exactly the bug the durable gates exist to prevent) is
CAUGHT by the monitor rather than silently agreed with. ``selftest``
verifies every seeded mutation is caught; a mutation the checker stops
catching is a regression in the checker itself.

Model states are canonical tuples, hashed into a visited set; DFS visits
each state once, so the reported ``states`` count is the exact size of
the reachable state space — a regression pin in its own right (a model
edit that silently prunes interleavings shows up as a count change).

**Scope / non-goals** (kept honest by the trace-conformance harness
below): the model abstracts payload *values* away (a delta is a token),
models the network as atomic request/reply with at most one outstanding
lost ack per worker, does not model the adarevision server rule, and
bounds elasticity to one admit + one retire per run. It is a model of
the PROTOCOL, not the numerics — the bitwise parity suites
(tests/test_managed_comm.py) own the values. ``conform_service_events``
replays a REAL tier's recorded event log (``ParamService(record_events=
True)``) through the same service-state rules, failing if the
implementation ever takes a step the model calls illegal — the standard
defense against verifying a fiction.

Everything here is stdlib-only (no torch): the checker runs in CI on
CPU in seconds (`--model-check smoke`).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

__all__ = [
    "Config", "Result", "Violation", "explore", "smoke_configs",
    "run_level", "selftest_mutations", "MUTATIONS",
    "conform_service_events", "conform_gate_events", "is_boundary",
]

# worker status values (kept as small ints for cheap state tuples)
UNJOINED, ACTIVE, CRASHED, DONE, RETIRED = range(5)
_STATUS = ("unjoined", "active", "crashed", "done", "retired")
# phases
IDLE, GATED = 0, 1

MUTATIONS = ("gate_on_raw", "no_boundary_flush", "replay_reapplies",
             "retire_stays_member", "leader_failover_loses_residual",
             "double_apply_across_leaders")


@dataclass(frozen=True)
class Config:
    """One bounded configuration of the protocol model."""

    name: str
    n_workers: int = 2
    staleness: int = 1
    n_clocks: int = 3            # clocks each worker trains (0..n_clocks-1)
    managed: bool = True         # partial pushes enabled off-boundary
    admit_id: Optional[int] = None   # one elastic admission of this id
    retire_worker: Optional[int] = None
    retire_after: int = 0        # retire once its flushed clock >= this
    max_crashes: int = 0         # crash/rejoin episodes (worker 0 only)
    max_lost_acks: int = 0       # pushes whose ack is lost then replayed
    # leader-failover episodes (two-tier fabric, parallel/fabric.py): the
    # worker IS a slice, its leader dies mid-window, a survivor re-elects
    # and resumes the push stream from the replicated ledger with the
    # acked floor re-derived from the service. 0 keeps the family off —
    # pre-fabric configs explore byte-identical state spaces.
    max_failovers: int = 0


@dataclass(frozen=True)
class Violation:
    invariant: str
    detail: str
    trace: Tuple[str, ...]


@dataclass
class Result:
    config: Config
    mutation: Optional[str]
    states: int
    transitions: int
    violations: List[Violation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def render(self) -> str:
        status = ("ok" if self.ok else
                  f"VIOLATED ({self.violations[0].invariant}: "
                  f"{self.violations[0].detail})")
        mut = f" [mutation={self.mutation}]" if self.mutation else ""
        return (f"model-check {self.config.name}{mut}: "
                f"{self.states} states, {self.transitions} transitions — "
                f"{status}")


def is_boundary(clock: int, staleness: int) -> bool:
    """SSP window boundaries — clocks whose flush MUST be full (mirrors
    AsyncSSPClient._is_boundary; at s=0 every clock is a boundary)."""
    return (clock + 1) % (staleness + 1) == 0


# --------------------------------------------------------------------------- #
# state
# --------------------------------------------------------------------------- #
# worker tuple: (status, clock, phase, residual, replay_clock, lost)
#   clock        — last flushed clock (client-side raw), -1 before any
#   replay_clock — a pushed clock whose ack was lost, awaiting replay (-1)
#   lost         — a leader failover DROPPED this worker's residual (the
#                  seeded loses-residual mutation); the next full flush
#                  claims completeness the anchor can never have, and the
#                  _apply_push monitor flags it. Constant False on every
#                  correct path, so pre-fabric state counts are unchanged.
# service tuple: (raw, durable, seq) each a per-universe-id tuple, plus
#   members / failed frozensets
# budgets: (crashes_left, lost_acks_left, admits_left, failovers_left)

W_STATUS, W_CLOCK, W_PHASE, W_RESID, W_REPLAY, W_LOST = range(6)


@dataclass(frozen=True)
class State:
    workers: Tuple[Tuple[int, int, int, bool, int, bool], ...]
    raw: Tuple[int, ...]
    durable: Tuple[int, ...]
    seq: Tuple[int, ...]
    members: FrozenSet[int]
    failed: FrozenSet[int]
    budgets: Tuple[int, int, int, int]


def _initial(cfg: Config) -> State:
    universe = cfg.n_workers + (1 if cfg.admit_id is not None else 0)
    workers = []
    for w in range(universe):
        joined = w < cfg.n_workers
        workers.append((ACTIVE if joined else UNJOINED, -1, IDLE, False,
                        -1, False))
    return State(
        workers=tuple(workers),
        raw=tuple([-1] * universe),
        durable=tuple([-1] * universe),
        seq=tuple([-1] * universe),
        members=frozenset(range(cfg.n_workers)),
        failed=frozenset(),
        budgets=(cfg.max_crashes, cfg.max_lost_acks,
                 1 if cfg.admit_id is not None else 0,
                 cfg.max_failovers),
    )


def _tset(t: Tuple, i: int, v) -> Tuple:
    return t[:i] + (v,) + t[i + 1:]


def _wset(st: State, w: int, **kw) -> Tuple:
    rec = list(st.workers[w])
    names = ("status", "clock", "phase", "residual", "replay", "lost")
    for k, v in kw.items():
        rec[names.index(k)] = v
    return _tset(st.workers, w, tuple(rec))


def _gate_peers(st: State, w: int) -> List[int]:
    """The ids a gate at worker ``w`` waits on: current members minus
    failed, done, and self (mirrors _min_other_clock)."""
    out = []
    for v in st.members:
        if v == w or v in st.failed:
            continue
        if st.workers[v][W_STATUS] == DONE:
            continue
        out.append(v)
    return out


# --------------------------------------------------------------------------- #
# transition relation
# --------------------------------------------------------------------------- #

def _apply_push(st: State, cfg: Config, w: int, clock: int, full: bool,
                viol: List[Tuple[str, str]],
                mutation: Optional[str],
                fresh_seq: bool = False) -> State:
    """The service side of one push RPC (ParamService._serve 'push'):
    seq-dedup, raw-clock bump, durable bump on full flushes.
    ``fresh_seq`` models a buggy failover successor that restarts its
    seq stream instead of re-deriving the high-water mark — the push
    bypasses dedup (the double-apply-across-leaders mutation)."""
    dup = clock <= st.seq[w]
    if full and not dup and st.workers[w][W_LOST]:
        # completeness monitor: this full flush claims every byte
        # through ``clock`` is in the anchor, but a leader failover
        # dropped the slice's parked residual — the durable clock would
        # advance over bytes that died with the old leader
        viol.append(("failover_completeness",
                     f"worker {w} full flush at clock {clock} after a "
                     f"failover that lost its residual — durable would "
                     f"cover bytes the dead leader never shipped"))
    if dup and mutation != "replay_reapplies" and not fresh_seq:
        return st
    if dup:
        # the seeded no-dedup mutations: apply anyway — the monitor
        # below flags the double application
        viol.append(("exactly_once",
                     f"worker {w} clock {clock} applied twice "
                     f"(seq high-water {st.seq[w]})"))
    raw = _tset(st.raw, w, max(st.raw[w], clock))
    seq = _tset(st.seq, w, max(st.seq[w], clock))
    durable = st.durable
    if full:
        durable = _tset(st.durable, w, max(st.durable[w], clock))
    return replace(st, raw=raw, seq=seq, durable=durable)


def _check_global(st: State, cfg: Config) -> Optional[Tuple[str, str]]:
    """The durable-clock sandwich, over every member, after every edge."""
    bound = cfg.staleness + 1
    for w in st.members:
        if st.durable[w] > st.raw[w]:
            return ("durable_sandwich",
                    f"worker {w}: durable {st.durable[w]} > raw "
                    f"{st.raw[w]}")
        if st.raw[w] - st.durable[w] > bound:
            return ("durable_sandwich",
                    f"worker {w}: raw {st.raw[w]} - durable "
                    f"{st.durable[w]} > staleness+1 ({bound})")
    return None


def _successors(st: State, cfg: Config, mutation: Optional[str]):
    """Yield (label, next_state, [violations]) for every enabled action."""
    s = cfg.staleness
    crashes_left, acks_left, admits_left, failovers_left = st.budgets

    for w, rec in enumerate(st.workers):
        status, clock, phase, residual, replay, lost = rec
        target_clocks = cfg.n_clocks

        if status == ACTIVE and replay >= 0:
            # sender-thread replay of the un-acked flush — checked FIRST
            # so a retiring/finishing worker's drain (which waits for the
            # replay's ack) always has this action available; the
            # service's seq high-water dedups it
            viol: List[Tuple[str, str]] = []
            nst = _apply_push(st, cfg, w, replay, True, viol, mutation)
            nst = replace(nst, workers=_wset(nst, w, replay=-1))
            yield (f"replay({w},{replay})", nst, viol)

        if status == ACTIVE and phase == IDLE:
            k = clock + 1
            retiring = (cfg.retire_worker == w
                        and clock >= cfg.retire_after and clock >= 0)
            if retiring:
                # leave(): flush residual (one forced-full clock), drain
                # (replay must be resolved), then retire the slot
                if replay == -1:
                    if residual:
                        viol = []
                        nst = _apply_push(st, cfg, w, k, True, viol,
                                          mutation)
                        nst = replace(nst, workers=_wset(
                            nst, w, clock=k, residual=False))
                        yield (f"retire_flush({w},{k})", nst, viol)
                    else:
                        members = st.members - {w}
                        if mutation == "retire_stays_member":
                            members = st.members
                        nst = replace(st, members=members,
                                      workers=_wset(st, w, status=RETIRED))
                        yield (f"retire({w})", nst, [])
                continue
            if k >= target_clocks:
                # mark_done(): flush residual, drain, then done
                if replay == -1:
                    if residual:
                        viol = []
                        nst = _apply_push(st, cfg, w, k, True, viol,
                                          mutation)
                        nst = replace(nst, workers=_wset(
                            nst, w, clock=k, residual=False))
                        yield (f"done_flush({w},{k})", nst, viol)
                    else:
                        nst = replace(st, workers=_wset(st, w, status=DONE))
                        yield (f"done({w})", nst, [])
            else:
                # gate(k): the PREDICATE (seedable) decides admission;
                # the MONITOR (fixed) checks the durable contract
                peers = _gate_peers(st, w)
                need = k - s - 1
                vec = st.raw if mutation == "gate_on_raw" else st.durable
                if all(vec[v] >= need for v in peers):
                    viol = []
                    bad = [v for v in peers if st.durable[v] < need]
                    if bad:
                        viol.append((
                            "gate_safety",
                            f"worker {w} admitted at clock {k} but peer"
                            f"(s) {bad} have durable "
                            f"{[st.durable[v] for v in bad]} < {need} — "
                            f"the staleness bound is widened by "
                            f"un-flushed residuals"))
                    nst = replace(st, workers=_wset(st, w, phase=GATED))
                    yield (f"gate({w},{k})", nst, viol)
                # else: blocked — not enabled (deadlock detection covers
                # the case where EVERYONE is blocked)

            # crash/rejoin schedule (worker 0 only, bounded)
            if w == 0 and crashes_left > 0 and clock >= 0:
                nst = replace(
                    st,
                    workers=_wset(st, w, status=CRASHED, residual=False,
                                  replay=-1),
                    failed=st.failed | {w},
                    budgets=(crashes_left - 1, acks_left, admits_left,
                             failovers_left))
                yield (f"crash({w})", nst, [])

            # leader failover (two-tier fabric): the worker is a SLICE;
            # its leader process dies between flushes, a survivor
            # re-elects and resumes from the replicated ledger. The
            # CORRECT successor re-derives the acked floor from the
            # service — entries at or below the service's applied clock
            # are NOT resent (resume_oplog's ``c > applied`` filter), so
            # an outstanding ack-lost replay is dropped, and the
            # residual carries over verbatim. The seeded mutations break
            # exactly one of those two obligations each.
            if failovers_left > 0 and clock >= 0:
                nb = (crashes_left, acks_left, admits_left,
                      failovers_left - 1)
                if mutation == "leader_failover_loses_residual":
                    # the successor resumes the clock/seq stream but the
                    # parked residual died with the old leader; the next
                    # full flush trips the completeness monitor
                    nst = replace(st, workers=_wset(
                        st, w, residual=False, replay=-1,
                        lost=lost or residual), budgets=nb)
                    yield (f"failover({w})", nst, [])
                elif (mutation == "double_apply_across_leaders"
                        and replay >= 0):
                    # the successor restarts its seq stream instead of
                    # re-deriving the high-water mark: the ledgered
                    # entry whose ack was lost re-applies under a fresh
                    # seq — the exactly-once monitor flags it
                    viol = []
                    nst = _apply_push(st, cfg, w, replay, True, viol,
                                      mutation, fresh_seq=True)
                    nst = replace(nst, workers=_wset(nst, w, replay=-1),
                                  budgets=nb)
                    yield (f"failover({w})", nst, viol)
                else:
                    # correct failover: acked floor from the service, so
                    # the already-applied ack-lost entry is dropped (the
                    # service seq dedup would absorb it anyway — this is
                    # the no-resend fast path), residual survives in the
                    # ledger
                    nst = replace(st, workers=_wset(st, w, replay=-1),
                                  budgets=nb)
                    yield (f"failover({w})", nst, [])

        elif status == ACTIVE and phase == GATED:
            k = clock + 1
            boundary = is_boundary(k, s)
            must_full = boundary or not cfg.managed
            if mutation == "no_boundary_flush":
                must_full = not cfg.managed
            # full flush (always an option: budget was comfortable)
            viol = []
            nst = _apply_push(st, cfg, w, k, True, viol, mutation)
            nst = replace(nst, workers=_wset(
                nst, w, clock=k, phase=IDLE, residual=False))
            yield (f"push_full({w},{k})", nst, viol)
            if acks_left > 0 and replay == -1:
                # same flush, ack lost: service applied, client will
                # replay — the exactly-once schedule
                viol = []
                nst = _apply_push(st, cfg, w, k, True, viol, mutation)
                nst = replace(
                    nst,
                    workers=_wset(nst, w, clock=k, phase=IDLE,
                                  residual=False, replay=k),
                    budgets=(crashes_left, acks_left - 1, admits_left,
                             failovers_left))
                yield (f"push_full_acklost({w},{k})", nst, viol)
            if not must_full:
                # partial flush: raw advances, durable does not, the
                # complement parks in the residual
                viol = []
                nst = _apply_push(st, cfg, w, k, False, viol, mutation)
                nst = replace(nst, workers=_wset(
                    nst, w, clock=k, phase=IDLE, residual=True))
                yield (f"push_partial({w},{k})", nst, viol)

        elif status == CRASHED:
            # rejoin(): resume at the service's applied clock; pending
            # and residual are gone (the failure model's bounded loss).
            # No durable re-anchoring is needed: boundary positions are
            # GLOBAL clock positions, so the next boundary (<= s clocks
            # away) force-flushes full and the sandwich holds — a fact
            # this checker verifies rather than assumes.
            nst = replace(
                st,
                workers=_wset(st, w, status=ACTIVE, clock=st.raw[w],
                              phase=IDLE, residual=False, replay=-1,
                              lost=False),
                failed=st.failed - {w})
            yield (f"rejoin({w})", nst, [])

    # elastic admission of the configured extra id
    if admits_left > 0 and cfg.admit_id is not None:
        a = cfg.admit_id
        live = [st.raw[v] for v in st.members
                if v not in st.failed
                and st.workers[v][W_STATUS] not in (DONE,)]
        join = min(live) if live else -1
        join = max(join, st.raw[a], st.seq[a])
        nst = replace(
            st,
            workers=_wset(st, a, status=ACTIVE, clock=join, phase=IDLE,
                          residual=False, replay=-1),
            raw=_tset(st.raw, a, join),
            durable=_tset(st.durable, a, max(st.durable[a], join)),
            seq=_tset(st.seq, a, max(st.seq[a], join)),
            members=st.members | {a},
            budgets=(crashes_left, acks_left, 0, failovers_left))
        yield (f"admit({a},{join})", nst, [])


def _terminal(st: State) -> bool:
    """Every worker that ever joined is done or retired (crashed workers
    must rejoin and finish — a run abandoned mid-crash is not success)."""
    for rec in st.workers:
        if rec[W_STATUS] in (ACTIVE, CRASHED):
            return False
        if rec[W_STATUS] == UNJOINED:
            return False           # the configured admit never happened
    return True


# --------------------------------------------------------------------------- #
# exhaustive exploration
# --------------------------------------------------------------------------- #

def explore(cfg: Config, mutation: Optional[str] = None,
            max_states: int = 2_000_000,
            stop_at_first: bool = True) -> Result:
    """DFS over every interleaving, hashing states so each is visited
    once. Violations carry the action trace that reached them."""
    if mutation is not None and mutation not in MUTATIONS:
        raise ValueError(f"unknown mutation {mutation!r}; "
                         f"choose from {MUTATIONS}")
    init = _initial(cfg)
    visited = {init}
    res = Result(config=cfg, mutation=mutation, states=1, transitions=0)
    stack: List[Tuple[State, Tuple[str, ...]]] = [(init, ())]
    while stack:
        st, path = stack.pop()
        succs = list(_successors(st, cfg, mutation))
        if not succs and not _terminal(st):
            res.violations.append(Violation(
                "deadlock",
                f"non-terminal state with no enabled action "
                f"(workers: "
                f"{[(_STATUS[r[W_STATUS]], r[W_CLOCK]) for r in st.workers]}, "
                f"durable: {list(st.durable)})",
                path))
            if stop_at_first:
                return res
        for label, nst, viols in succs:
            res.transitions += 1
            npath = path + (label,)
            for inv, detail in viols:
                res.violations.append(Violation(inv, detail, npath))
                if stop_at_first:
                    return res
            g = _check_global(nst, cfg)
            if g is not None:
                res.violations.append(Violation(g[0], g[1], npath))
                if stop_at_first:
                    return res
            if nst not in visited:
                if len(visited) >= max_states:
                    raise RuntimeError(
                        f"state-space bound {max_states} exceeded for "
                        f"{cfg.name} — shrink the config")
                visited.add(nst)
                res.states += 1
                stack.append((nst, npath))
    return res


# --------------------------------------------------------------------------- #
# levels + self-test
# --------------------------------------------------------------------------- #

def tiny_config() -> Config:
    # n_clocks=3 matters: the first BINDING gate (need >= 0) appears at
    # clock 2, and a binding gate is what the seeded gate-on-raw
    # mutation needs to be expressible
    return Config(name="2w-s1-plain", n_workers=2, staleness=1, n_clocks=3,
                  managed=True)


def smoke_configs() -> List[Config]:
    """The acceptance set: every 2-worker staleness {0,1,2} config with
    one admit AND one retire event, crash/rejoin and a lost-ack replay
    in the schedule — plus the two-tier fabric configs, where a worker
    IS a slice (the model is granularity-agnostic by construction, so
    slice-level admit/retire is a relabeling) and the leader-failover
    transition family interleaves with lost acks and partial pushes."""
    out = []
    for s in (0, 1, 2):
        out.append(Config(
            name=f"2w-s{s}-admit-retire-crash", n_workers=2, staleness=s,
            n_clocks=3, managed=True, admit_id=2, retire_worker=1,
            retire_after=1, max_crashes=1, max_lost_acks=1))
    # slice granularity: one slice admitted mid-run, one retired — the
    # same elastic machinery the per-process tier uses, exercised under
    # the fabric's labels (a slice id is just a worker id on the wire)
    out.append(Config(
        name="2slice-s1-admit-retire", n_workers=2, staleness=1,
        n_clocks=3, managed=True, admit_id=2, retire_worker=1,
        retire_after=1, max_failovers=1))
    # leader failover mid-window: the failover family crossed with an
    # ack-lost replay (the exactly-once-across-leaders schedule) and
    # managed partial pushes (the residual-carryover schedule)
    out.append(Config(
        name="2slice-s1-leader-failover", n_workers=2, staleness=1,
        n_clocks=3, managed=True, max_lost_acks=1, max_failovers=2))
    return out


def full_configs() -> List[Config]:
    return smoke_configs() + [
        Config(name="3w-s1-admit-retire", n_workers=3, staleness=1,
               n_clocks=3, managed=True, admit_id=3, retire_worker=2,
               retire_after=0, max_crashes=1, max_lost_acks=1),
        Config(name="2w-s2-deep-clocks", n_workers=2, staleness=2,
               n_clocks=5, managed=True, max_crashes=1, max_lost_acks=1),
    ]


def selftest_mutations(cfg: Optional[Config] = None) -> Dict[str, bool]:
    """Every seeded mutation must be CAUGHT (produce a violation) on a
    config rich enough to express it; a mutation the checker agrees with
    means the checker itself regressed. Returns {mutation: caught}."""
    base = cfg or Config(name="selftest", n_workers=2, staleness=1,
                         n_clocks=3, managed=True, max_crashes=1,
                         max_lost_acks=1)
    out: Dict[str, bool] = {}
    for m in MUTATIONS:
        c = base
        if m == "retire_stays_member":
            # needs a retire event and a survivor training past it
            c = replace(base, name="selftest-retire", retire_worker=1,
                        retire_after=0, n_clocks=4, max_crashes=0,
                        max_lost_acks=0)
        elif m in ("leader_failover_loses_residual",
                   "double_apply_across_leaders"):
            # needs the failover family enabled: a partial push parks a
            # residual before the failover (loses_residual), and an
            # ack-lost flush leaves a ledgered entry the buggy successor
            # re-applies under a fresh seq (double_apply)
            c = replace(base, name="selftest-failover", max_crashes=0,
                        max_failovers=1)
        out[m] = not explore(c, mutation=m).ok
    return out


def run_level(level: str) -> Tuple[List[Result], Dict[str, bool]]:
    """One CLI invocation's worth of checking. ``tiny`` = one plain
    config + the gate mutation (subprocess-pinned in tests); ``smoke`` =
    the acceptance set + every mutation self-test (the CI gate);
    ``full`` adds the 3-worker and deep-clock configs."""
    if level == "tiny":
        results = [explore(tiny_config())]
        caught = {"gate_on_raw":
                  not explore(replace(tiny_config(), name="tiny-mut"),
                              mutation="gate_on_raw").ok}
        return results, caught
    if level == "smoke":
        return [explore(c) for c in smoke_configs()], selftest_mutations()
    if level == "full":
        return [explore(c) for c in full_configs()], selftest_mutations()
    raise ValueError(f"unknown model-check level {level!r}; "
                     f"choose tiny, smoke or full")


# --------------------------------------------------------------------------- #
# trace conformance: the model vs the real tier
# --------------------------------------------------------------------------- #

class TraceConformanceError(AssertionError):
    """The real tier took a step the model calls illegal (or vice
    versa) — either the implementation or the model is wrong, and the
    difference is the finding."""


def conform_service_events(events: Sequence[Tuple], staleness: int,
                           n_workers: int) -> Dict[str, int]:
    """Replay a ParamService event log (``record_events=True``) through
    the model's service-state rules. Checks, per event:

    - push: the dup verdict matches the model's seq high-water dedup;
      boundary clocks arrive with ``full=True`` (the force-flush
      contract); the durable sandwich holds after the apply.
    - admit: the join clock equals the service's rendezvous rule
      EXACTLY — ``max(min live raw clock, the id's own historical
      raw/seq high-water)``, where "live" is members minus done (the
      `_admit_locked` computation; a re-admitted retiree resumes past
      its own clocks, never behind them). Scope: failure-free runs
      (evictions are not in the event vocabulary).
    - done: the worker leaves the gate-relevant set (and the admit
      rendezvous denominator).
    - retire: the id was a member and leaves the gate denominator.

    Returns counters (events checked per kind) for the test to pin."""
    raw: Dict[int, int] = {w: -1 for w in range(n_workers)}
    durable: Dict[int, int] = {w: -1 for w in range(n_workers)}
    seq: Dict[int, int] = {w: -1 for w in range(n_workers)}
    members = set(range(n_workers))
    done: set = set()
    counts = {"push": 0, "admit": 0, "retire": 0, "done": 0}
    bound = staleness + 1
    for i, ev in enumerate(events):
        kind = ev[0]
        if kind == "push":
            _, w, clock, full, dup = ev
            if w not in raw:
                raise TraceConformanceError(
                    f"event {i}: push from unknown worker {w}")
            expected_dup = clock <= seq[w]
            if bool(dup) != expected_dup:
                raise TraceConformanceError(
                    f"event {i}: push(w={w}, clock={clock}) dup="
                    f"{dup} but model's seq high-water {seq[w]} says "
                    f"dup={expected_dup} — exactly-once dedup diverged")
            if is_boundary(clock, staleness) and not full and not dup:
                raise TraceConformanceError(
                    f"event {i}: boundary clock {clock} (staleness "
                    f"{staleness}) pushed with full=False — the residual "
                    f"force-flush contract is broken")
            if not expected_dup:
                raw[w] = max(raw[w], clock)
                seq[w] = max(seq[w], clock)
                if full:
                    durable[w] = max(durable[w], clock)
            if durable[w] > raw[w] or raw[w] - durable[w] > bound:
                raise TraceConformanceError(
                    f"event {i}: worker {w} raw {raw[w]} / durable "
                    f"{durable[w]} outside the staleness+1 sandwich")
            counts["push"] += 1
        elif kind == "admit":
            _, w, join = ev
            # mirror _admit_locked exactly: rendezvous at the min LIVE
            # (member, not done) raw clock, and a returning id resumes
            # past everything it ever flushed
            live = [raw[v] for v in members if v not in done]
            expected = min(live) if live else -1
            expected = max(expected, raw.get(w, -1), seq.get(w, -1))
            if join != expected:
                raise TraceConformanceError(
                    f"event {i}: admit(w={w}) at join clock {join} but "
                    f"the rendezvous rule says {expected} (min live "
                    f"{min(live) if live else -1}, own high-water "
                    f"{max(raw.get(w, -1), seq.get(w, -1))})")
            members.add(w)
            done.discard(w)
            raw[w] = max(raw.get(w, -1), join)
            durable[w] = max(durable.get(w, -1), join)
            seq[w] = max(seq.get(w, -1), join)
            counts["admit"] += 1
        elif kind == "done":
            _, w = ev
            done.add(w)
            counts["done"] += 1
        elif kind == "retire":
            _, w = ev
            if w not in members:
                raise TraceConformanceError(
                    f"event {i}: retire of non-member {w}")
            members.discard(w)
            counts["retire"] += 1
        else:
            raise TraceConformanceError(
                f"event {i}: unknown event kind {kind!r}")
    return counts


def conform_gate_events(events: Sequence[Tuple],
                        staleness: int) -> Dict[str, int]:
    """Check a client's recorded gate admissions
    (``AsyncSSPClient(record_events=True)``): every pass must have seen
    ``min(peer durable) >= clock - s - 1`` — the read-gate safety
    property, asserted on what the REAL gate actually observed."""
    n = 0
    for i, ev in enumerate(events):
        if ev[0] != "gate":
            continue
        _, w, clock, min_other = ev
        if min_other < clock - staleness - 1:
            raise TraceConformanceError(
                f"gate event {i}: worker {w} admitted at clock {clock} "
                f"with min peer durable {min_other} < "
                f"{clock - staleness - 1} — staleness bound violated")
        n += 1
    return {"gate": n}
