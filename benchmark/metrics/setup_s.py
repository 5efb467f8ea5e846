"""setup_s: seconds from the process's start to the window's start (the
interpreter, the imports, the seeded input, the kernels' build or load,
the graph's capture, the stream's first blocks)."""


def read(run):
    return run.setup_s
