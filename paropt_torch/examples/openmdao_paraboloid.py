"""OpenMDAO paraboloid driven by the port's ParOptDriver
(examples/openmdao_paraboloid.py on the port):

    min  (x-3)^2 + x y + (y+4)^2 - 3
    s.t. x^2 + y^2 = 27

Requires the real `openmdao` package; without it the program ends with a
message (tests/test_torch_drivers.py covers the driver through a
stand-in).

    python -m paropt_torch.examples.openmdao_paraboloid [--algorithm ip|tr|mma]
"""

import argparse
import sys

from ._common import add_device, host


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--algorithm", default="ip", choices=["ip", "tr", "mma"])
    add_device(ap)
    args = ap.parse_args(argv)

    try:
        import openmdao.api as om
    except ImportError:
        sys.exit("openmdao is not installed — see tests/test_drivers.py "
                 "for the stand-in-driven coverage of ParOptDriver")

    from ..drivers.openmdao_driver import ParOptDriver

    prob = om.Problem()
    indeps = prob.model.add_subsystem("indeps", om.IndepVarComp())
    indeps.add_output("x", 3.0)
    indeps.add_output("y", -4.0)
    prob.model.add_subsystem(
        "paraboloid", om.ExecComp("f = (x-3)**2 + x*y + (y+4)**2 - 3"))
    prob.model.add_subsystem("con", om.ExecComp("c = x**2 + y**2"))
    prob.model.connect("indeps.x", "paraboloid.x")
    prob.model.connect("indeps.y", "paraboloid.y")
    prob.model.connect("indeps.x", "con.x")
    prob.model.connect("indeps.y", "con.y")
    prob.model.add_design_var("indeps.x", lower=-50, upper=50)
    prob.model.add_design_var("indeps.y", lower=-50, upper=50)
    prob.model.add_objective("paraboloid.f")
    prob.model.add_constraint("con.c", equals=27.0)

    prob.driver = ParOptDriver()
    prob.driver.options["algorithm"] = args.algorithm
    prob.driver.options["device"] = args.device
    prob.setup()
    prob.run_driver()

    x, y = prob.get_val("indeps.x"), prob.get_val("indeps.y")
    f, c = prob.get_val("paraboloid.f"), prob.get_val("con.c")
    print("x =", x, " y =", y)
    print("f =", f, " c =", c)
    return {name: float(host(v).ravel()[0])
            for name, v in (("x", x), ("y", y), ("f", f), ("c", c))}


if __name__ == "__main__":
    main()
