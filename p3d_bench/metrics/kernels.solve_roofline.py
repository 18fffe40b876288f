"""The solve's kernels against their roofline (%): the frozen work bound
of the configuration's solve stage (``work.solve_work``: operations over
the fp32 peak or compulsory bytes over the memory rate, whichever is
larger) over the summed device time of every kernel inside one traced
cube's solve, whatever their names."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["solve_kernel_s"] <= 0:
        return None
    return 100.0 * ctx["work"]["bound_s"] / tr["solve_kernel_s"], "%"
