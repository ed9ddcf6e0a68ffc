"""setup_s: process start to the start of the window (s)."""


def read(ctx):
    return ctx["setup_s"]
