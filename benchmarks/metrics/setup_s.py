"""Set-up time: from the process's start to the first timed call (imports,
the card's context, the K1 build or load, the inputs, the program's
objects, and the warm-up call)."""


def read(ctx):
    return ctx.setup_s
