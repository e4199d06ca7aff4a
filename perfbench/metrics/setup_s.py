"""Set-up seconds: from the start of the process to the window (loading,
building the program's state, the reference's inputs, one warm request)."""


def read(run):
    return run.setup_s
