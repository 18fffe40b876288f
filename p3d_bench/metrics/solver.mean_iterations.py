"""The solver's mean iterations a slice (the result's
``pocs_mean_iterations``). Only a configuration that stops early (eps
above 0) has anything to read: otherwise every slice runs niter."""


def read(ctx):
    if ctx["config"]["eps"] == 0:
        return None
    return ctx["mean_iterations"], "iters"
