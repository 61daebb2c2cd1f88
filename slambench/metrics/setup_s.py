"""setup_s (s): the program's set-up, from the start of the run to the
start of the measured window less the native build (a checkout's first run
only) and the rendering of the lap (the benchmark's input): imports,
building the program's state and one untimed lap (host clock)."""


def read(ctx):
    return ctx["setup_s"]
