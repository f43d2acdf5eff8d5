"""Job ``ip_solves``: whole `FusedIP.solve` calls, one after another, each
from its own seeded start, each to convergence (the default per-step host
loop).

Traffic keys: ``start`` (`generate.start`'s scales), ``warmup_steps``,
``profile_solve`` (the index of the solve the traced run profiles, whole),
``check`` (``sample`` solves drawn among the first ``among``, besides the
window's last and every solve that stopped at or above the tolerance).

The problem's instance (a model's ``seed``, where the configuration sets
none) and every start come from ``--seed``.  The window opens after set-up
and closes when the solve in flight at ``--seconds`` ends; it counts every
solve that ran in it.  A solve that ends without the program's
``converged`` is an attempted answer that failed.  One that converged by
ParOpt's no-improvement exit (two line searches without progress once
the barrier is at its floor) with its residual at or above the tolerance
is a design like the others, and the check always compares it with the
reference.  The final states the check compares are copied to the host
as their solves end, so that the window's memory peak is the program's
own.

Set-up: the problem and the solver from the configuration, on the card;
the warm-up runs `FusedIP.solve` from a start no window solve uses for
``warmup_steps`` steps, which launches every kernel and shape of a step
(and builds the CUDA kernels on a checkout's first run).
"""

from __future__ import annotations

import inspect
import sys

from .. import generate
from ..harness import PROCESS_START, Run, clock, phases
from ..reference._plain import rel_gap
from ..trace import Profiler

# the final state's fields the check reads (the rest, the QN history above
# all, is let go as each solve ends)
KEPT = ("x", "z", "zl", "zu", "s", "t", "zs", "zt", "zw", "sw", "tw", "zsw",
        "ztw")


def build(config, seed, torch, device="cuda", parts=None):
    """(problem, FusedIP, data, nominal start, QN state) on the card;
    ``parts`` gets the clock at the end of the imports and of the
    problem's construction."""
    from paropt_torch import ip_fused, models
    from paropt_torch.ops import qn

    parts = {} if parts is None else parts
    parts["imports"] = clock()
    dtype = getattr(torch, config["dtype"])
    spec = dict(config["problem"])
    cls = getattr(models, spec.pop("model"))
    if "seed" in inspect.signature(cls).parameters and "seed" not in spec:
        spec["seed"] = generate.key(seed)
    prob = cls(**spec, dtype=dtype, device=device)
    parts["problem"] = clock()
    sol = dict(config["solver"])
    msub = sol.pop("qn_subspace_size")
    fused = ip_fused.FusedIP(ip_fused.model_from_problem(prob), prob.nvars,
                             prob.ncon, prob.nwcon, prob.nwblock,
                             ip_fused.FusedIPOptions(**sol), dtype=dtype)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    qn0 = qn.qn_init(msub, prob.nvars, dtype=dtype,
                     storage_dtype=qn.default_storage_dtype(dtype),
                     device=x0.device)
    return prob, fused, data, x0, qn0


def _kept(state):
    """The final state's fields the check reads, copied to the host."""
    out = {k: getattr(state.vars, k) for k in KEPT}
    out.update(mu=state.mu, fobj=state.fobj, g=state.g, c=state.c,
               cw=state.cw)
    return {k: v.to("cpu", copy=True) for k, v in out.items()}


def run(config, traffic, seed, seconds, trace, device, tf32=False) -> Run:
    import torch

    parts = {}
    prob, fused, data, nominal, qn0 = build(config, seed, torch, device.name,
                                            parts)
    if tf32:
        # the control of `correct`: the program's own float32 products in
        # TF32, switched on after the constructors turned it off
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    tol = config["solver"]["abs_res_tol"]

    def draw(i):
        return generate.start(nominal, data.lb, data.ub, traffic["start"],
                              seed, i)

    parts["solver"] = clock()
    fused.solve(draw(generate.WARMUP), data, (), qn0, None,
                max_iters=traffic["warmup_steps"])
    device.sync()
    setup_peak = device.peak_bytes()
    device.reset_peak()
    sample = generate.sample(seed, traffic["check"]["among"],
                             traffic["check"]["sample"])

    t0 = clock()
    setup_s = t0 - PROCESS_START
    reads0 = fused.syncs.count
    kept = {}
    iters, failed, stalled, tr = [], 0, 0, None
    i = 0
    while True:
        x0 = draw(i)
        prof = None
        if trace and i == traffic["profile_solve"]:
            prof = Profiler(clock, device)
            prof.start()
        st = fused.solve(x0, data, (), qn0, None)
        k, conv, res = torch.stack([st.k.double(), st.converged.double(),
                                    st.res_norm.double()]).tolist()
        if prof is not None:
            tr = prof.stop()
            tr.units = {"ip_steps": int(k)}
        iters.append(int(k))
        failed += not conv
        stalled += bool(conv) and res >= tol
        if not conv or res >= tol:
            print(f"portbench: solve {i} ended at step {int(k)}, converged "
                  f"{bool(conv)}, residual {res!r} (tolerance {tol})",
                  file=sys.stderr)
        window = clock() - t0
        last = window >= seconds and (tr is not None or not trace)
        if i in sample or last or res >= tol:
            kept[i] = _kept(st)
        del st
        i += 1
        if last:
            break
    return Run(setup_s=setup_s, window_s=window,
               peak_bytes=device.peak_bytes(),
               process_peak_bytes=max(setup_peak, device.peak_bytes()),
               attempted=len(iters), failed=failed, trace=tr,
               units={"designs": len(iters) - failed, "solves": len(iters),
                      "stalled": stalled, "ip_steps": sum(iters),
                      "host_reads": fused.syncs.count - reads0},
               per_design_iters=iters, answers={"kept": kept},
               setup_parts=phases(dict(parts, warmup=t0)))


def check(run, config, traffic, reference, seed, device,
          control=False) -> dict:
    """The kept solves' final iterates against the plain reference in
    float64, on the card: ``eval_gap``, the widest gap of the program's
    own evaluations at its final x (objective and gradient relative to the
    reference's largest entry, the constraints absolute); ``kkt_res``, the
    reference's KKT residual of the final iterate.  The largest over the
    kept solves.  ``control``: the reference in TF32 takes the program's
    place as the evaluation judged (``eval_gap`` only: ``kkt_res`` reads
    the program's iterate and the reference's evaluation either way)."""
    import torch
    spec = dict(config["problem"])
    spec.pop("model")
    spec.setdefault("seed", generate.key(seed))
    ref = reference.SyntheticTopology(**spec, device=device.name)
    low = (reference.SyntheticTopology(**spec, precision="tf32",
                                       device=device.name)
           if control else None)
    eval_gap = kkt_res = 0.0
    for i, kept in sorted(run.answers["kept"].items()):
        a = {k: v.to(device.name) for k, v in kept.items()}
        f, g, c, cw = ref.evaluate(a["x"])
        got = (low.evaluate(a["x"]) if control
               else (a["fobj"], a["g"], a["c"], a["cw"]))
        eval_gap = max(eval_gap, rel_gap(got[0], f), rel_gap(got[1], g),
                       float(torch.max(torch.abs(got[2].double() - c))),
                       float(torch.max(torch.abs(got[3].double() - cw))))
        if not control:
            vars_ = {k: a[k] for k in KEPT}
            res = ref.kkt_residual(vars_, g, c, cw, float(a["mu"]))
            kkt_res = max(kkt_res, res)
            print(f"portbench: check of solve {i}: kkt_res {res!r}",
                  file=sys.stderr)
    return {"eval_gap": eval_gap} if control else \
        {"eval_gap": eval_gap, "kkt_res": kkt_res}
