"""Set-up seconds: process start to the first timed call, on the host
clock (the port built or loaded, the inputs made, every shape the window
uses run once)."""


def read(ctx):
    return ctx.setup_s
