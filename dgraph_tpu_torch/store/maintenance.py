"""Background maintenance scheduler: paced, budget-bounded jobs.

Port of `dgraph_tpu/store/maintenance.py`. Each job's start and
outcome is a `maintenance.job` event in the flight recorder's ring, and
`progress` is its watchdog's stall signal. Like the reference, the
scheduler yields to queued foreground traffic: while the Alpha's
admission controller (server/admission.py) reports waiters, policy jobs
are not started and a running job parks at its tablet boundary (at most
`LOAD_YIELD_MAX_S` per boundary). Reference parity: the
reference runs rollups, snapshots, and backups as
background Badger jobs WHILE serving (posting/mvcc.go's rollup ticker,
worker/snapshot.go, ee/backup) — a serving system cannot stop the world
to compact. This scheduler is that loop for the TPU build: a daemon
thread on Alpha that runs

    rollup       when the delta-layer stack is `rollup_after` deep
                 (keeps read-path folds shallow; on an out-of-core base
                 it streams the fold to disk, store/stream.py)
    checkpoint   every `checkpoint_every_s` seconds (fold + WAL truncate)
    backup       on request (admin trigger / request_backup)
    export       on request (RDF/JSON dump at the newest fold)

with strict priorities (requested jobs first), pacing between tablets
(`pacing_ms` — the serving path gets the disk/CPU back between
tablets), retry-with-backoff on transient failure (a FoldRaced straggler
race, a full disk that got cleaned), and a pause/drain gate: `pause()`
parks the running job at the next tablet boundary, so commits and
reads never contend with maintenance for more than one tablet's work; `drain()` finishes the in-flight job and stops — the
shutdown path runs it before the final checkpoint.

Observability: every job runs inside a
`maintenance.job` span (tablet spans nest under it via the streaming
layer), outcomes land in `maintenance_jobs_total{job=,outcome=}`,
residency in the `maintenance_resident_bytes` gauge +
`maintenance_evictions_total`, pauses in `maintenance_pauses_total` and
`maintenance_pause_wait_us`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from dgraph_tpu_torch.utils import flightrec, locks, tracing
from dgraph_tpu_torch.utils import logging as xlog
from dgraph_tpu_torch.utils.metrics import METRICS

# priorities: lower runs first
PRIO_REQUESTED = 0   # operator-triggered backup/export/checkpoint
PRIO_ROLLUP = 1      # delta stack too deep: read-path folds get slow
PRIO_CHECKPOINT = 2  # periodic durability sweep

MAX_ATTEMPTS = 4
BACKOFF_S = 0.25     # doubles per attempt, capped
BACKOFF_CAP_S = 5.0


@dataclass
class Job:
    """One maintenance work item (requested or policy-scheduled)."""

    name: str                 # rollup | checkpoint | backup | export
    fn: object                # () -> result; may raise (retried)
    priority: int = PRIO_REQUESTED
    attempts: int = 0
    not_before: float = 0.0   # monotonic backoff gate
    seq: int = 0              # FIFO tiebreak within a priority
    done: threading.Event = field(default_factory=threading.Event)
    result: object = None
    error: BaseException | None = None
    # trace id of the request that triggered this job ("" for policy
    # jobs): _run re-establishes it, so an operator-initiated backup's
    # maintenance.job span JOINS the admin request's trace instead of
    # starting an anonymous one on the scheduler thread
    trace_id: str = ""

    def wait(self, timeout: float | None = None):
        """Block until the job finished; re-raise its terminal error."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"maintenance job {self.name} still "
                               f"running after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result


class MaintenanceScheduler:
    """Daemon-thread job runner over one Alpha (see module docstring)."""

    def __init__(self, alpha, p_dir: str, *, rollup_after: int = 0,
                 checkpoint_every_s: float = 0.0, pacing_ms: float = 0.0):
        self.alpha = alpha
        self.p_dir = p_dir
        self.rollup_after = int(rollup_after)
        self.checkpoint_every_s = float(checkpoint_every_s)
        self.pacing_ms = float(pacing_ms)
        self._log = xlog.get("maintenance")
        self._queue: list[Job] = []
        self._seq = 0
        self._cv = locks.make_condition("maintenance.cv")
        self._resume = threading.Event()
        self._resume.set()              # not paused
        self._stop = False
        self._thread: threading.Thread | None = None
        self._running: str | None = None
        self._last_checkpoint = time.monotonic()
        self.jobs_done = 0
        self.jobs_failed = 0
        # tablet-boundary progress counter: bumped only by the single
        # scheduler thread (at job start and every _pace call) — a
        # RUNNING job whose progress stops advancing is stalled
        self.progress = 0
        locks.guarded(self, "maintenance.cv")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MaintenanceScheduler":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dgraph-maintenance")
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the loop. With `drain`, the in-flight job and every
        already-REQUESTED job finish first (policy jobs are dropped) —
        the shutdown hook (`Alpha.shutdown` / cli SIGINT) uses this so a
        triggered backup is never half-written."""
        if drain:
            self.drain(timeout)
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._resume.set()  # a paused job must observe the stop
        if self._thread is not None:
            self._thread.join(timeout)

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait for the queue of requested jobs + the running job to
        finish. Returns False on timeout."""
        deadline = time.monotonic() + timeout
        self._resume.set()
        while time.monotonic() < deadline:
            with self._cv:
                idle = (self._running is None
                        and not any(j.priority == PRIO_REQUESTED
                                    for j in self._queue))
            if idle:
                return True
            time.sleep(0.02)
        return False

    # -- pause gate ----------------------------------------------------------
    def pause(self) -> None:
        """Park the running job at its next tablet boundary (the pace
        hook blocks) — a heavy foreground phase (bulk apply, tablet
        move) takes the machine for itself without killing the job."""
        self._resume.clear()

    def resume(self) -> None:
        self._resume.set()

    @property
    def paused(self) -> bool:
        return not self._resume.is_set()

    # longest a job yields to queued foreground traffic per tablet
    # boundary: bounded so a permanently saturated server still makes
    # maintenance progress (one tablet per window)
    LOAD_YIELD_MAX_S = 2.0

    def _pace(self) -> None:
        """Between-tablet hook handed to the streaming layer: apply the
        configured pacing, honor the pause gate, then YIELD to queued
        foreground traffic: while the admission controller reports
        waiters (`saturated()`), the job parks at this tablet boundary
        (bounded by LOAD_YIELD_MAX_S)."""
        self.progress += 1
        if self.pacing_ms > 0:
            time.sleep(self.pacing_ms / 1e3)
        if not self._resume.is_set():
            METRICS.inc("maintenance_pauses_total")
            t0 = time.perf_counter()
            with tracing.span("maintenance.pause", job=self._running or ""):
                self._resume.wait()
            METRICS.observe("maintenance_pause_wait_us",
                            (time.perf_counter() - t0) * 1e6)
        adm = getattr(self.alpha, "admission", None)
        if adm is not None and adm.saturated():
            METRICS.inc("maintenance_load_pauses_total")
            t0 = time.perf_counter()
            with tracing.span("maintenance.load_pause",
                              job=self._running or ""):
                limit = t0 + self.LOAD_YIELD_MAX_S
                while (adm.saturated() and self._resume.is_set()
                       and not self._stopping()
                       and time.perf_counter() < limit):
                    time.sleep(0.01)
            METRICS.observe("maintenance_pause_wait_us",
                            (time.perf_counter() - t0) * 1e6)

    def _stopping(self) -> bool:
        """`_stop` read under the cv (the yield loop above polls it)."""
        with self._cv:
            return self._stop

    # -- requests ------------------------------------------------------------
    def _submit(self, job: Job) -> Job:
        with self._cv:
            job.seq = self._seq = self._seq + 1
            self._queue.append(job)
            self._cv.notify_all()
        return job

    def request_backup(self, dest: str, force_full: bool = False) -> Job:
        from dgraph_tpu_torch.server.backup import backup_alpha
        return self._submit(Job("backup", lambda: backup_alpha(
            self.alpha, self.p_dir, dest, force_full=force_full),
            trace_id=tracing.current_trace_id()))

    def request_export(self, out_path: str, format: str = "rdf") -> Job:
        return self._submit(Job("export", lambda: self.alpha.export_to(
            out_path, format=format, pace=self._pace),
            trace_id=tracing.current_trace_id()))

    def request_checkpoint(self) -> Job:
        return self._submit(Job("checkpoint", self._run_checkpoint,
                                trace_id=tracing.current_trace_id()))

    def status(self) -> dict:
        with self._cv:
            queued = [{"job": j.name, "priority": j.priority,
                       "attempts": j.attempts} for j in self._queue]
            running = self._running
        return {"running": running, "paused": self.paused,
                "queued": queued, "jobs_done": self.jobs_done,
                "jobs_failed": self.jobs_failed,
                "progress": self.progress,
                "rollup_after": self.rollup_after,
                "checkpoint_every_s": self.checkpoint_every_s,
                "pacing_ms": self.pacing_ms}

    # -- policy jobs ---------------------------------------------------------
    def _run_checkpoint(self):
        ts = self.alpha.checkpoint_to(self.p_dir, pace=self._pace)
        self._last_checkpoint = time.monotonic()
        return ts

    def _run_rollup(self):
        return self.alpha.maintenance_rollup(self.p_dir, pace=self._pace)

    def _due_policy_job(self, exclude=()) -> Job | None:
        """Policy triggers (called with no locks): rollup when the delta
        stack is deep, checkpoint on the period. `exclude` names jobs
        currently backing off in the queue — a failed rollup must not
        bypass its backoff via a fresh policy twin, nor starve the
        periodic checkpoint behind it.

        A due checkpoint outranks a due rollup: a checkpoint folds the
        same layers AND truncates the WAL, and under a constant write
        load the rollup trigger re-arms instantly — rollup-first would
        starve the durability sweep forever."""
        if "checkpoint" not in exclude and self.checkpoint_every_s > 0 \
                and time.monotonic() - self._last_checkpoint \
                >= self.checkpoint_every_s:
            return Job("checkpoint", self._run_checkpoint,
                       priority=PRIO_CHECKPOINT)
        if "rollup" not in exclude and self.rollup_after > 0 and \
                self.alpha.mvcc.pending_layer_count() >= self.rollup_after:
            return Job("rollup", self._run_rollup, priority=PRIO_ROLLUP)
        return None

    # -- loop ----------------------------------------------------------------
    def _next_job(self) -> Job | None:
        now = time.monotonic()
        with self._cv:
            ready = [j for j in self._queue if j.not_before <= now]
            if ready:
                job = min(ready, key=lambda j: (j.priority, j.seq))
                self._queue.remove(job)
                return job
            # a failed job backing off blocks its policy twin — spawning
            # a fresh rollup every tick would bypass the backoff
            backing_off = {j.name for j in self._queue}
        # queued foreground traffic defers policy jobs entirely (a
        # REQUESTED job still runs): starting a rollup while the
        # admission queue is non-empty would hand the machine to
        # background work exactly when it is scarcest
        adm = getattr(self.alpha, "admission", None)
        if adm is not None and adm.saturated():
            return None
        if not self.paused:
            return self._due_policy_job(exclude=backing_off)
        return None

    def _loop(self) -> None:
        while True:
            with self._cv:
                if self._stop:
                    return
            job = None if self.paused else self._next_job()
            if job is None:
                with self._cv:
                    if not self._stop:
                        self._cv.wait(0.05)
                continue
            self._run(job)

    def _run(self, job: Job) -> None:
        with self._cv:
            self._running = job.name
        self.progress += 1  # a fresh job is progress (scheduler thread)
        flightrec.emit("maintenance.job", job=job.name,
                       outcome="started", attempt=job.attempts)
        t0 = time.perf_counter()
        try:
            # re-join the triggering request's trace (attach is a
            # no-op for policy jobs, whose trace_id is empty)
            with tracing.attach(job.trace_id), \
                    tracing.span("maintenance.job", job=job.name,
                                 attempt=job.attempts) as sp:
                job.result = job.fn()
                sp.attrs["outcome"] = "ok"
            METRICS.inc("maintenance_jobs_total", job=job.name,
                        outcome="ok")
            flightrec.emit("maintenance.job", job=job.name,
                           outcome="ok", attempt=job.attempts)
            METRICS.observe("maintenance_job_us",
                            (time.perf_counter() - t0) * 1e6,
                            job=job.name)
            self.jobs_done += 1
            job.done.set()
        except Exception as e:  # noqa: BLE001 — retried below
            job.attempts += 1
            flightrec.emit("maintenance.job", job=job.name,
                           outcome=("failed" if job.attempts
                                    >= MAX_ATTEMPTS else "retry"),
                           attempt=job.attempts, error=str(e)[:200])
            if job.attempts >= MAX_ATTEMPTS:
                METRICS.inc("maintenance_jobs_total", job=job.name,
                            outcome="failed")
                self.jobs_failed += 1
                job.error = e
                job.done.set()
                self._log.exception(
                    "maintenance %s failed permanently after %d attempts",
                    job.name, job.attempts)
            else:
                METRICS.inc("maintenance_jobs_total", job=job.name,
                            outcome="retry")
                backoff = min(BACKOFF_S * (2 ** (job.attempts - 1)),
                              BACKOFF_CAP_S)
                job.not_before = time.monotonic() + backoff
                self._log.warning(
                    "maintenance %s attempt %d failed (%s); retrying "
                    "in %.2fs", job.name, job.attempts, e, backoff)
                self._submit(job)
        finally:
            with self._cv:
                self._running = None
                self._cv.notify_all()
