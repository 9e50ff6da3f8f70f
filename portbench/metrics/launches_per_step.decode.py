"""launches_per_step.decode: the profiler's kernel records over the traced
decode steps, divided by the number of steps. Nothing where the profiler
saw no kernel."""


def read(ctx):
    kernels, steps = ctx["trace"]["kernels"], ctx["slice"]["steps"]
    return kernels / steps if kernels and steps else None
