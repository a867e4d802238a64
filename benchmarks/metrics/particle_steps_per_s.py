"""Particle-steps per second: K x T of every filter completed in the window
over the window's length, from its first call's start to its last call's
end (host clock)."""


def read(ctx):
    return ctx.work["units_per_call"] * ctx.window.calls / ctx.window.seconds
