"""setup_s: from the process's start to the window's opening: imports,
the native builds (compiling only on a checkout's first run), rendering
the traffic and the warm-up."""


def read(run):
    return run.setup.get("total_s")
