"""Host-clock seconds from the start of the benchmark's process to the first
timed window or step: imports, the CUDA context, the kernel libraries (built
on a checkout's first run), weights and inputs from the seed, and warm-up at
the cell's own shapes."""


def read(run):
    return run["setup_s"]
