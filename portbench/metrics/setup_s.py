"""From process start to the first timed request: imports, the CUDA context,
the inputs from the seed, the system's build and its warm-up."""


def read(ctx):
    return ctx.setup_s
