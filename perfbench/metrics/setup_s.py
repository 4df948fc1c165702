"""From the process's start to the first timed step's dispatch: imports,
the kernels built or loaded, the state drawn, the batch pool and the
checked warm-up steps."""


def read(ctx):
    return ctx["setup_s"]
