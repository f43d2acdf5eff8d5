"""Shared helpers of tests/test_torch_examples_*.py: run one of the repo's
example scripts (``examples/<name>.py``, paropt_tpu) in-process and its
port (``paropt_torch.examples.<name>``) with ``--device cpu``, at the same
arguments in a temporary working directory, and compare the numbers each
prints.

The comparison reads the printed text from the script's summary on (the
first line matching ``start``; solver logs above it carry timings), drops
timings (``wall``, seconds, iterations per second) and white space, and
holds the number
tokens pairwise: integers (iteration counts, sizes, material counts)
equal, every other number within one unit of its last printed digit or
1e-8 relative, and numbers below 1e-9 in size (roundoff-level residuals
and violations) within 1e-9 absolute.  The words between the numbers
(converged flags among them) are equal."""

import os
import re
import runpy
import sys
import types
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-8
FLOOR = 1e-9

_TIMING = re.compile(r"wall[= ]\s*[\d.]+s|[\d.]+\s*(?:outer-)?it/s|"
                     r"\b[\d.]+s\b|incl\. [a-z -]+")
_NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _isolate(monkeypatch, tmp_path):
    """The working directory, sys.path and the variables the JAX scripts
    set are restored after the test."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "path", list(sys.path))
    for var in ("JAX_COMPILATION_CACHE_DIR", "PAROPT_TPU_NO_X64"):
        if var in os.environ:
            monkeypatch.setenv(var, os.environ[var])
        else:
            monkeypatch.setenv(var, "")
            monkeypatch.delenv(var)


def run_jax(name, argv, monkeypatch, tmp_path, capsys):
    """stdout (and the SystemExit message, if any) of examples/<name>.py
    run in-process with ``sys.argv`` set."""
    _isolate(monkeypatch, tmp_path)
    monkeypatch.setattr(sys, "argv", [f"examples/{name}.py"] + list(argv))
    capsys.readouterr()
    message = None
    try:
        runpy.run_path(str(REPO / "examples" / f"{name}.py"),
                       run_name="__main__")
    except SystemExit as e:
        message = e.code
    return capsys.readouterr().out, message


def run_port(name, argv, monkeypatch, tmp_path, capsys):
    """(stdout, SystemExit message or None, main's return value) of
    ``paropt_torch.examples.<name>.main(argv + ['--device', 'cpu'])``."""
    import importlib
    _isolate(monkeypatch, tmp_path)
    mod = importlib.import_module(f"paropt_torch.examples.{name}")
    capsys.readouterr()
    message, out = None, None
    try:
        out = mod.main(list(argv) + ["--device", "cpu"])
    except SystemExit as e:
        message = e.code
    return capsys.readouterr().out, message, out


def summary(text, start=None):
    """The printed text from the first line matching ``start`` on, with
    timings removed."""
    lines = text.splitlines()
    if start is not None:
        first = next(i for i, line in enumerate(lines)
                     if re.search(start, line))
        lines = lines[first:]
    return [_TIMING.sub("", line) for line in lines if line.strip()]


def _unit(token):
    """One unit of the last printed digit of a number token."""
    mant, _, exp = token.lower().partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** (-decimals) * 10.0 ** (int(exp) if exp else 0)


def assert_same_numbers(got_lines, want_lines, name=""):
    assert len(got_lines) == len(want_lines), (name, got_lines, want_lines)
    for got, want in zip(got_lines, want_lines):
        words = [[re.sub(r"\s+", "", w) for w in _NUMBER.split(line)]
                 for line in (got, want)]
        assert words[0] == words[1], (name, got, want)
        gt, wt = _NUMBER.findall(got), _NUMBER.findall(want)
        for g, w in zip(gt, wt):
            if not re.search(r"[.eE]", g + w):
                assert g == w, (name, got, want)
                continue
            a, b = float(g), float(w)
            tol = max(_unit(w) * (1 + 1e-9), RTOL * max(abs(a), abs(b)))
            if max(abs(a), abs(b)) < FLOOR:
                tol = FLOOR
            assert abs(a - b) <= tol, (name, g, w, got, want)


def compare(name, argv, monkeypatch, tmp_path, capsys, start=None):
    """Run both, compare their summaries; returns the port's return
    value."""
    jtext, jmsg = run_jax(name, argv, monkeypatch, tmp_path / "jax",
                          capsys)
    ttext, tmsg, out = run_port(name, argv, monkeypatch, tmp_path / "torch",
                                capsys)
    assert tmsg == jmsg
    want = summary(jtext, start)
    assert want or jmsg, f"{name} printed nothing to compare"
    assert_same_numbers(summary(ttext, start), want, name)
    return out


def fake_openmdao(monkeypatch):
    """``openmdao.api`` with the surface examples/openmdao_paraboloid.py
    uses (Problem, IndepVarComp, ExecComp) over tests/_fake_openmdao.py's
    Driver: scalar components evaluated from their expressions in the
    order they were added, totals by complex step."""
    from . import _fake_openmdao as fake_om

    class IndepVarComp:
        def __init__(self):
            self.outputs = {}

        def add_output(self, name, val):
            self.outputs[name] = float(val)

    class ExecComp:
        def __init__(self, expr):
            self.out, self.rhs = (s.strip() for s in expr.split("="))

    class Model:
        def __init__(self):
            self.subs, self.conns, self.dvs, self.cons = {}, {}, {}, {}
            self.obj = None

        def add_subsystem(self, name, comp):
            self.subs[name] = comp
            return comp

        def connect(self, src, tgt):
            self.conns[tgt] = src

        def add_design_var(self, name, lower=None, upper=None):
            self.dvs[name] = {"size": 1, "lower": lower, "upper": upper}

        def add_objective(self, name):
            self.obj = name

        def add_constraint(self, name, equals=None, lower=None, upper=None):
            self.cons[name] = {"size": 1, "equals": equals, "lower": lower,
                               "upper": upper}

    class Problem:
        def __init__(self):
            self.model = Model()
            self.driver = None

        def setup(self):
            m = self.model
            self.vals = {f"{n}.{k}": np.atleast_1d(v)
                         for n, c in m.subs.items()
                         if isinstance(c, IndepVarComp)
                         for k, v in c.outputs.items()}
            self._dv_meta, self._con_meta = m.dvs, m.cons
            self._obj_names = [m.obj]
            self.driver._setup_driver(self)

        def _evaluate(self, vals):
            out = dict(vals)
            for n, c in self.model.subs.items():
                if isinstance(c, ExecComp):
                    env = {t.split(".", 1)[1]: out[s][0]
                           for t, s in self.model.conns.items()
                           if t.startswith(n + ".")}
                    out[f"{n}.{c.out}"] = np.atleast_1d(eval(c.rhs, {}, env))
            return out

        def run_model(self):
            self.outputs = self._evaluate(self.vals)

        def compute_totals(self, of, wrt, return_format="array"):
            h = 1e-30
            J = np.zeros((len(of), len(wrt)))
            for j, w in enumerate(wrt):
                vals = {k: v.astype(complex) for k, v in self.vals.items()}
                vals[w] = vals[w] + 1j * h
                out = self._evaluate(vals)
                for i, o in enumerate(of):
                    J[i, j] = out[o][0].imag / h
            return J

        def run_driver(self):
            return self.driver.run()

        def get_val(self, name):
            return self.vals[name] if name in self.vals else \
                self.outputs[name]

    api = types.ModuleType("openmdao.api")
    api.Driver, api.Problem = fake_om.Driver, Problem
    api.IndepVarComp, api.ExecComp = IndepVarComp, ExecComp
    pkg = types.ModuleType("openmdao")
    pkg.api = api
    monkeypatch.setitem(sys.modules, "openmdao", pkg)
    monkeypatch.setitem(sys.modules, "openmdao.api", api)
    for mod in ("paropt_tpu.drivers.openmdao_driver",
                "paropt_torch.drivers.openmdao_driver"):
        monkeypatch.delitem(sys.modules, mod, raising=False)
