"""The process's builds (s): the host seconds of every build span the
process recorded up to the window's last cube (``timings["process"]``:
kernels built and loaded, the process group joined and connected, the
transform's plans and device copies), nested builds counted once."""


def read(ctx):
    process = ctx["cubes"][-1].get("process")
    if process is None:
        return None
    return sum(v["host_s"] for v in process.values()), "s"
