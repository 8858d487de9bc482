"""``setup_s``: seconds from the process's start to the window's: imports,
the kernel library's load (and, in a fresh checkout, its build), the
weights and the warm-up calls."""


def read(ctx):
    return ctx.setup_s
