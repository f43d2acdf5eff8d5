"""Job ``mma_outer``: `FusedMMA.solve` from a seeded start design, timed by
its outer iterations.

The solve runs as users who keep every iterate run it: the problem's
``write_output(k, x)`` at frequency 1, at the boundary of every outer
iteration (``chunk=1``).  That hook is where the harness reads its clock
(the hook's read of ``k`` has waited for the device), copies the iterate
to the host for the check, and ends the window: at the first boundary
after ``--seconds``.  A solve that reaches its iteration cap before then
is started again from the same design.

The problem's evaluations are wrapped on the instance to keep the
program's own objective and gradient at the iterates the check samples
(references only: no copy, no read).

Traffic keys: ``start`` (`generate.start`'s scales), ``profile_from`` and
``profile_outer_iterations`` (the traced sub-window, in boundaries of the
window), ``check`` (``sample`` steps drawn among the first ``among``,
besides the window's last).

Set-up: the model and the solver from the configuration, on the card,
and one outer iteration from the window's start design.

An iterate that does not come within `GRACE` seconds of the window's close
(a step that never advances the count, say) is an answer that never came:
a watchdog interrupts the solve, and the run counts it as failed.
"""

from __future__ import annotations

import _thread
import threading

import torch

from .. import generate
from ..harness import PROCESS_START, Run, clock, phases
from ..reference._plain import rel_gap
from ..trace import Profiler


GRACE = 60.0


class _Stop(Exception):
    """Raised from the write-output hook to end a solve at a boundary."""


class _Recorder:
    """The write-output hook and the evaluation wrappers of one run."""

    def __init__(self, keep_eval):
        self.keep_eval = keep_eval
        self.deadline = None      # (t0, seconds) of the window, or None
        self.stop_after = None    # boundaries before the warm-up stops
        self.on_boundary = None   # profiling hook(count)
        self.pending_f = None
        self.hold = False         # the profiler is on: no stop yet
        self.reset()

    def reset(self):
        self.times = []           # clock at each boundary
        self.xs = []              # host copies: x_0 (start), x_1, ...
        self.evals = {}           # j -> (f, g) of the program at x_j
        self.nevals = 0
        self.prev = None

    def evaluated(self, f, g):
        j = self.nevals
        self.nevals += 1
        if self.prev is not None and self.prev[0] not in self.keep_eval:
            self.evals.pop(self.prev[0], None)
        self.evals[j] = (f, g)
        self.prev = (j, (f, g))

    def boundary(self, k, x):
        t = clock()
        self.times.append(t)
        self.xs.append(x.detach().to("cpu", copy=True))
        n = len(self.times)
        if self.on_boundary is not None:
            self.on_boundary(n)
        if self.stop_after is not None and n >= self.stop_after:
            raise _Stop
        if self.deadline is not None and not self.hold and \
                t - self.deadline[0] >= self.deadline[1]:
            raise _Stop


def run(config, traffic, seed, seconds, trace, device, tf32=False) -> Run:
    from paropt_torch import models
    from paropt_torch.mma import FusedMMA

    parts = {"imports": clock()}
    dtype = getattr(torch, config["dtype"])
    spec = dict(config["problem"])
    prob = getattr(models, spec.pop("model"))(**spec, dtype=dtype,
                                             device=device.name)
    parts["problem"] = clock()
    nominal, lb, ub = prob.get_vars_and_bounds()
    x0 = generate.start(nominal, lb, ub, traffic["start"], seed, 0)
    # the start design, where users set theirs: the problem's
    # get_vars_and_bounds, which FusedMMA reads once
    prob.get_vars_and_bounds = lambda: (x0, lb, ub)

    sample = generate.sample(seed, traffic["check"]["among"],
                             traffic["check"]["sample"])
    rec = _Recorder(sample)
    prob.write_output = rec.boundary
    evaluate, gradient = prob.eval_obj_con, prob.eval_obj_con_gradient
    prob.eval_obj_con = lambda x: _note_f(rec, evaluate(x))
    prob.eval_obj_con_gradient = lambda x: _note_g(rec, gradient(x))
    opts = dict(config["solver"], mma_output_file=None,
                write_output_frequency=1, dtype=config["dtype"])
    solver = FusedMMA(prob, opts)
    parts["solver"] = clock()
    if tf32:
        # the control of `correct`: the program's own float32 products in
        # TF32, switched on after the constructors turned it off
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    # warm-up: one outer iteration from the window's start design
    rec.stop_after = 1
    _solve(solver)
    device.sync()
    setup_peak = device.peak_bytes()
    device.reset_peak()
    rec.stop_after = None
    rec.reset()
    rec.xs.append(x0.detach().to("cpu", copy=True))

    tr = {}
    if trace:
        first = traffic["profile_from"]
        last = first + traffic["profile_outer_iterations"]
        prof = Profiler(clock, device)

        def on_boundary(n):
            if n == first:
                rec.hold = True
                prof.start()
            elif n == last:
                rec.hold = False
                tr["trace"] = prof.stop()
                tr["trace"].units = {"outer_iterations": last - first}
        rec.on_boundary = on_boundary

    t0 = clock()
    setup_s = t0 - PROCESS_START
    reads0 = solver.syncs.count
    rec.deadline = (t0, seconds)
    restarts, first_end = 0, None
    closed, expired = threading.Event(), threading.Event()

    def watch():
        while not closed.wait(1.0):
            if clock() - max([t0 + seconds] + rec.times[-1:]) > GRACE:
                expired.set()
                _thread.interrupt_main()
                return

    threading.Thread(target=watch, daemon=True).start()
    try:
        while _solve(solver):
            # the cap came first: again from the start, and the check keeps
            # to the first solve's steps
            restarts += 1
            first_end = first_end or len(rec.times)
    except KeyboardInterrupt:
        if not expired.is_set():
            raise
    finally:
        closed.set()
    end = first_end or len(rec.times)
    window = (clock() if expired.is_set() else rec.times[-1]) - t0
    outer = len(rec.times) + expired.is_set()
    failed = (sum(not bool(torch.isfinite(x).all()) for x in rec.xs[1:])
              + expired.is_set())
    return Run(setup_s=setup_s, window_s=window,
               peak_bytes=device.peak_bytes(),
               process_peak_bytes=max(setup_peak, device.peak_bytes()),
               attempted=outer, failed=failed, trace=tr.get("trace"),
               units={"outer_iterations": outer,
                      "host_reads": solver.syncs.count - reads0,
                      "restarts": restarts},
               answers={"xs": rec.xs, "evals": rec.evals,
                        "steps": sorted(j for j in sample | {end - 1}
                                        if j < end and j in rec.evals)},
               setup_parts=phases(dict(parts, warmup=t0)))


def _note_f(rec, out):
    rec.pending_f = out[0]
    return out


def _note_g(rec, out):
    rec.evaluated(rec.pending_f, out[0])
    return out


def _solve(solver) -> bool:
    """One `FusedMMA.solve` from the start design: True if it reached its
    cap, False if the hook ended it."""
    try:
        solver.solve(chunk=1)
    except _Stop:
        return False
    return True


def check(run, config, traffic, reference, seed, device,
          control=False) -> dict:
    """The sampled outer steps j -> j + 1 against the plain reference in
    float64: ``fem_gap``, the wider of the program's objective and
    gradient at x_j against the reference's (relative to its largest
    entry); ``step_gap``, the distance from the program's x_{j+1} to the
    exact solution of the MMA subproblem the reference builds at x_j, over
    the length of that step.  The largest over the sampled steps (none
    where no step came).
    ``control``: the reference in TF32 takes the program's place at the
    same iterates: its evaluation at x_j, and its exact step from x_j on
    its own gradient."""
    if not run.answers["steps"]:
        return {}
    spec = dict(config["problem"])
    spec.pop("model")
    keys = ("nex", "ney", "nez", "volume_fraction", "penal")
    dims = {k: spec[k] for k in keys if k in spec}
    ref = reference.Cantilever3D(**dims, device=device.name)
    low = (reference.Cantilever3D(**dims, precision="tf32",
                                  device=device.name) if control else None)
    xs = [x.to(device.name, torch.float64) for x in run.answers["xs"]]
    lu = reference.asymptotes(xs[:max(run.answers["steps"]) + 1],
                              config["solver"])
    fem_gap = step_gap = 0.0
    for j in run.answers["steps"]:
        f, g, vol, relres = ref.evaluate(xs[j])
        if relres > reference.TRUST:
            raise RuntimeError(f"the reference's state solve at step {j} "
                               f"reached a relative residual of {relres}")
        y = reference.mma_step(xs[j], *lu[j], g, vol, config["solver"])
        if control:
            f_got, g_got, vol_got, _ = low.evaluate(xs[j].float())
            nxt = reference.mma_step(
                xs[j].float(), *(t.float() for t in lu[j]), g_got, vol_got,
                config["solver"]).double()
        else:
            f_got, g_got = run.answers["evals"][j]
            nxt = xs[j + 1]
        fem_gap = max(fem_gap, abs(float(f_got) - f) / abs(f),
                      rel_gap(g_got, g))
        step_gap = max(step_gap, float(torch.linalg.norm(nxt - y)
                                       / torch.linalg.norm(y - xs[j])))
    return {"fem_gap": fem_gap, "step_gap": step_gap}
